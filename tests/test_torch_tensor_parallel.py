"""Weights cut by the rule tables on the serving path
(``repro_torch.dist.sharding.shard_params``): every rank of a mesh holds
its ``shard_shape`` share of each weight, and prefill and the serve step
on those shards give the global logits, against the JAX package.

One spawned world of 8 gloo ranks (``dist.world.run_world``) on a (data 2,
model 4) mesh, its rank body ``tests/torch_mesh_ranks.py``'s
``tensor_parallel_world``:

* the SMOKE f32 config of every arch under ``SERVE_RULES`` (the heads,
  ``ff``, the experts, the SSM heads and the vocab over `model`; the
  cache's sequence over `model`, its batch over `data`), prefill and the
  serve step in synopsis and exact mode (mamba2, which has no attention,
  exact only); llama3-8b under ``LONG_RULES`` (the sequence over (data,
  model)); deepseek-v2 and jamba with ``embed -> ("data",)`` (FSDP: every
  leaf with an ``embed`` dim gathered layer by layer); llama3-8b's exact
  step on a prompt of 66 tokens, whose cache the rules keep whole (66 % 4)
  so that each rank attends on its own heads directly;
* the gathered logits against the JAX package's single-device
  ``make_prefill_step`` / ``make_serve_step`` (``impl="xla"``, as its own
  tests run them on the CPU) on the same global weights and cache, within
  4e-5 of max|ref| (whisper's causal "cross" prefill of the loop path
  2.5e-4, the bound ROADMAP C measured for it), and against the port's
  one-rank step on the whole weights (4e-5 of max|ref|);
* every rank's shard shapes against ``shard_shape(mesh_axes_for(...))``,
  including the divisibility fallbacks: smollm's 3 heads stay whole
  (and take no collective), mamba2's 320 conv channels cut into 4 x 80,
  the last block straddling x and B;
* the whole weights' serve step under an installed ``TRAIN_RULES``
  equal, bit for bit, to the step with no mesh: the model code reads each
  leaf's cut from the tree, never from the installed rules.

Every rank holds fewer query heads than a KV head's group in llama3-8b's
SMOKE config (8 heads, G = 4, 2 a rank) and in deepseek's (4 heads, one a
rank, G = 4 over the latent).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import synopsis_kv as jskv
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch.configs.registry import list_archs
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.models import common as cm

TOL = 4e-5           # of max|ref|: the f32 floor of the port's parity tests
WHISPER_TOL = 2.5e-4  # whisper's loop path (ROADMAP C)
JOIN_S = 240.0
B, S = 2, 128
I_MAX = 2


def _modes(arch):
  return ("exact",) if arch == "mamba2-370m" else ("synopsis", "exact")


# name: (arch, rules, embed -> data, prompt length, modes)
CASES = {f"{a}-serve": (a, "SERVE_RULES", False, S, _modes(a))
         for a in list_archs()}
CASES.update({
    "llama3-8b-long": ("llama3-8b", "LONG_RULES", False, S,
                       ("synopsis", "exact")),
    "deepseek-v2-236b-fsdp": ("deepseek-v2-236b", "SERVE_RULES", True, S,
                              ("synopsis", "exact")),
    "jamba-v0.1-52b-fsdp": ("jamba-v0.1-52b", "SERVE_RULES", True, S,
                            ("synopsis", "exact")),
    "llama3-8b-whole-cache": ("llama3-8b", "SERVE_RULES", False, 66,
                              ("exact",)),
})


def _batch_rows(a, rows):
  """Rows ``rows`` of a cache leaf: its batch axis is the third (nb, na,
  B, ...) of the stacked leaves, the first of ``pos`` / ``recent_len``."""
  return a[:, :, rows]


def _case_inputs(arch, S_, modes, per_row):
  jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype=jnp.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  prompt = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S_)).astype(
      np.int32)
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
  tok = np.array([[5], [77]], np.int32)
  steps, refs = {}, {"prefill": np.asarray(logits)}
  for mode in modes:
    jc = cache
    if mode == "synopsis":
      jc = jskv.build(cache, jcfg, impl="xla")
      jc["recent_len"] = jc["recent_len"] + 3     # a partly filled ring
    step = jax.jit(j_make_serve_step(jcfg, mode=mode, i_max=I_MAX,
                                     impl="xla"))
    # Under SERVE_RULES the batch is cut over `data`, one row a shard, and
    # the reference routes an MoE's tokens per data-parallel shard
    # (``repro.models.moe._dp_size``): the single-device step a row.
    groups = [slice(b, b + 1) for b in range(B)] if per_row else [
        slice(None)]
    lg = [step(jparams, jax.tree.map(lambda a, g=g: a[g] if a.ndim == 1
                                     else _batch_rows(a, g), jc),
               jnp.asarray(tok[g]))[0] for g in groups]
    steps[mode] = {"cache": to_np(jc), "tok": tok, "i_max": I_MAX}
    refs[mode] = np.concatenate([np.asarray(x) for x in lg], 0)
  return to_np(jparams), prompt, steps, refs


@pytest.fixture(scope="module")
def tp_run():
  cases, refs = [], {}
  for name, (arch, rules, fsdp, S_, modes) in CASES.items():
    params, prompt, steps, refs[name] = _case_inputs(
        arch, S_, modes, per_row=rules == "SERVE_RULES")
    cases.append({"arch": arch, "rules": rules, "fsdp": fsdp,
                  "params": params, "prompt": prompt, "steps": steps,
                  "train_rules": name == "llama3-8b-serve"})
  got = world.run_world(ranks.tensor_parallel_world, 8, (cases,),
                        timeout_s=JOIN_S)
  return got, refs


def _tol(arch):
  return WHISPER_TOL if arch == "whisper-medium" else TOL


def _close(got, want, rel):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (got.shape, want.shape)
  err = np.abs(got - want).max()
  assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _assemble(per_rank, pick):
  """The global rows from the ranks' row ranges; every rank of a batch
  group returns the same bits."""
  by_rows = {}
  for r in per_rank:
    rows, x = pick(r)
    if rows in by_rows:
      np.testing.assert_array_equal(by_rows[rows], x)
    by_rows[rows] = x
  return np.concatenate([by_rows[k] for k in sorted(
      by_rows, key=lambda k: k[0] or 0)], 0)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_on_cut_weights(tp_run, name):
  """Every rank's prefill logits on its shard are the global (B, V), the
  same on every rank: against JAX's single-device prefill and the port's
  one-rank prefill on the whole weights; the prompt KV is global."""
  got, refs = tp_run
  i = list(CASES).index(name)
  arch = CASES[name][0]
  first = got[0]["cases"][i]
  for r in got:
    c = r["cases"][i]
    np.testing.assert_array_equal(c["prefill"].numpy(),
                                  first["prefill"].numpy())
    if c["prefill_k"] is not None:
      np.testing.assert_array_equal(c["prefill_k"].numpy(),
                                    first["prefill_k"].numpy())
  _close(first["prefill"].numpy(), refs[name]["prefill"], _tol(arch))
  _close(first["prefill"].numpy(), first["prefill_one"].numpy(), TOL)


@pytest.mark.parametrize("name,mode", [(n, m) for n, c in CASES.items()
                                       for m in c[4]])
def test_serve_step_on_cut_weights(tp_run, name, mode):
  """The serve step on each rank's shard of the weights and of the cache:
  the ranks' rows of the logits against JAX's step on the global cache
  and the port's one-rank step on the whole weights."""
  arch = CASES[name][0]
  got, refs = tp_run
  i = list(CASES).index(name)
  out = _assemble(got, lambda r: (tuple(r["cases"][i]["steps"][mode][
      "rows"]), r["cases"][i]["steps"][mode]["logits"].numpy()))
  one = _assemble(got, lambda r: (tuple(r["cases"][i]["steps"][mode][
      "rows"]), r["cases"][i]["steps"][mode]["one"].numpy()))
  _close(out, refs[name][mode], _tol(arch))
  _close(out, one, TOL)


def _fake_mesh():
  return type("M", (), {"shape": {"data": 2, "model": 4}})()


@pytest.mark.parametrize("name", list(CASES))
def test_shard_shapes_follow_the_rules(tp_run, name):
  """Every leaf a rank holds has ``shard_shape(mesh_axes_for(...))``: the
  rule table's cut of ``param_axes`` (the f32 unembedding as (embed,
  vocab)), the divisibility fallbacks included."""
  from repro_torch.configs.registry import get_config
  arch, rules, fsdp, _, _ = CASES[name]
  cfg = get_config(arch, smoke=True)
  table = ranks._rules(rules, fsdp)
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  shapes["unembed"], axes["unembed"] = (cfg.d_model, cfg.vocab), (
      "embed", "vocab")
  mesh = _fake_mesh()
  got, _ = tp_run
  i = list(CASES).index(name)
  for r in got:
    c = r["cases"][i]
    assert set(c["shapes"]) == set(shapes)
    for path, shape in shapes.items():
      spec = shd.mesh_axes_for(axes[path], mesh, table, shape=shape)
      assert c["specs"][path] == spec, path
      assert c["shapes"][path] == shd.shard_shape(shape, spec, mesh), path


def test_divisibility_fallbacks(tp_run):
  """smollm's 3 heads do not divide over 4: its attention stays whole
  (its ff and vocab are cut); mamba2's conv channels (256 of x, 32 of B,
  32 of C) cut into 4 x 80, the last block straddling x and B, and its
  cache's conv state and SSD heads are cut as its weights."""
  got, _ = tp_run
  i = list(CASES).index("smollm-135m-serve")
  c = got[0]["cases"][i]
  assert c["specs"]["blocks/pos0/attn/wq"] == (None, None, None, None)
  assert c["specs"]["blocks/pos0/attn/wo"] == (None, None, None, None)
  assert c["specs"]["blocks/pos0/mlp/w1"] == (None, None, "model")
  assert c["specs"]["embed"] == ("model", None)
  i = list(CASES).index("mamba2-370m-serve")
  for r in got:
    c = r["cases"][i]
    assert c["shapes"]["blocks/pos0/ssm/conv_w"] == (2, 4, 80)
    assert c["shapes"]["blocks/pos0/ssm/in_proj"] == (2, 128, 146)
    assert c["shapes"]["blocks/pos0/ssm/A_log"] == (2, 2)
    st = c["steps"]["exact"]
    assert st["cache_shapes"]["conv_state"][-1] == 80
    assert st["cache_shapes"]["ssd_state"][-3] == 2
    assert st["state_shapes"] == {k: (2, 1) + v[2:] for k, v in
                                  st["cache_shapes"].items()}


def test_fsdp_gathers_and_cuts(tp_run):
  """With ``embed -> data`` every leaf with an ``embed`` dim is cut over
  `data` too (the norm gains included), and the prefill gathers them."""
  got, _ = tp_run
  i = list(CASES).index("deepseek-v2-236b-fsdp")
  c = got[0]["cases"][i]
  assert c["specs"]["blocks/pos0/ln1"] == (None, "data")
  assert c["specs"]["blocks/pos0/attn/wq_b"] == (None, None, "model", None)
  assert c["specs"]["blocks/pos0/attn/wq_a"] == (None, "data", None)
  assert c["specs"]["blocks/pos0/moe/w1"] == (None, "model", "data", None)
  assert c["specs"]["unembed"] == ("data", "model")
  assert c["prefill_stats"]["all-gather"] > 0
  j = list(CASES).index("deepseek-v2-236b-serve")
  assert got[0]["cases"][j]["specs"]["blocks/pos0/ln1"] == (None, None)


def test_whole_weights_under_train_rules_are_todays_step(tp_run):
  """The whole weights' serve step with TRAIN_RULES installed equals the
  step with no mesh, bit for bit, in both modes."""
  got, _ = tp_run
  i = list(CASES).index("llama3-8b-serve")
  for r in got:
    for mode in ("synopsis", "exact"):
      assert r["cases"][i]["steps"][mode]["train_rules_equal"], mode


def test_cache_layouts(tp_run):
  """The sequence is cut over `model` (SERVE) or (data, model) (LONG);
  the 66-token prompt's exact cache is kept whole (66 % 4), so that its
  step attends on each rank's own heads."""
  got, _ = tp_run
  lay = lambda n, m: got[0]["cases"][list(CASES).index(n)]["steps"][m][  # noqa: E731
      "layout"]
  assert lay("llama3-8b-serve", "synopsis")["seq_axes"] == ("model",)
  assert lay("llama3-8b-long", "exact")["seq_axes"] == ("data", "model")
  assert lay("llama3-8b-whole-cache", "exact")["seq_axes"] == ()
