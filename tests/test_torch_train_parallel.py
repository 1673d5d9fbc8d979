"""The train step on a state cut by the rule tables
(``repro_torch.train.train_step.shard_train_state``): tensor-parallel over
`model`, FSDP (the weights' ``embed`` dim) over `data`, a backward for
every hand-written collective (``repro_torch.dist.sharding``), against the
port's one-rank step and the JAX package's single-device gradients.

Spawned gloo worlds (``dist.world.run_world``), rank bodies in
``tests/torch_mesh_ranks.py``:

* one world of 8 ranks on (data 2, model 4) under ``TRAIN_RULES``: the f32
  SMOKE configs from JAX's init of smollm, llama3, gemma2, deepseek (MLA
  and MoE), mamba2 (SSD), jamba (experts and SSM heads cut), command-r
  (a parallel block), pixtral (a patch prefix) and arctic (experts beside
  a dense MLP), and whisper (the encoder's self-attention and the
  decoder's cross-attention on the rank's heads, from frames) with its
  forward in float64, each with FSDP; llama3 with ``embed -> None`` (TP
  only) and llama3 with ``microbatches=2``;
* a second world of 8 on (pod 2, data 2, model 2) with ``compress_pods``
  (llama3, jamba);
* a world of 4 on (data 2, model 2): each autograd collective alone on a
  scalar loss, one cut step's backward on a fresh thread with no mesh
  installed, and the first world's checkpoint restored onto (model 2).

Per case: every rank's state leaf has its ``shard_shape``; the gradients
and the loss of one step, assembled from the ranks, lie within 4e-5 of
max|ref| (the port's f32 floor; 1e-6 for a float64 forward, whose
gradients come back in f32) of the port's one-rank ``loss_and_grads``
over the same shares (its microbatches: the reference routes an MoE per
data-parallel shard), and within ``test_torch_train_grads``'s bound of
``jax.value_and_grad`` of JAX's ``forward_loss`` (the mean over the data
shards for an MoE); the state after the step within 1e-6 of max|ref| of
the one-rank AdamW (after ``local_quantise_feedback`` to compress) on the
assembled gradients (only the global norm's order of summation differs);
``grad_norm`` the same on every rank.  The archs that are not in
``test_torch_train_grads`` have their bounds measured here against the
port's float64 gradient (``WITNESSED``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch.configs.registry import get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.models import common as cm
from repro_torch.models.common import leaves
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, tree_map)
from repro_torch.train.train_step import loss_and_grads

TOL = 4e-5             # of max|ref|: the port's f32 floor
# A float64 forward, against the one-rank float64 step: the gradients come
# back in f32 (the master's type), two roundings apart at most.  whisper's
# f32 gradient is too ill-conditioned for TOL: its one-rank f32 step lies
# 7.5e-4 of max from float64 on an attention bias, so its case runs in
# float64, where a fault still shows.
F64_TOL = 1e-6
STATE_TOL = 1e-6       # the state after AdamW on the same gradients
# test_torch_train_grads' bounds against JAX (its float64 witness), and
# those of the archs it lacks, witnessed here (WITNESSED): JAX's f32
# gradient lies from the port's float64 gradient, of max, up to 5.6e-4
# (jamba's A_log), more than 4e-5 (command-r), 1.2e-4 (pixtral), 2.1e-4
# (arctic) and 5.7e-3 (whisper's cross-attention wk); the port's f32 up
# to 1.8e-4 (jamba).
JAX_TOL = {"smollm-135m": 5e-4, "llama3-8b": 5e-4, "mamba2-370m": 1e-4,
           "jamba-v0.1-52b": 1e-3, "command-r-plus-104b": 1e-4,
           "pixtral-12b": 5e-4, "arctic-480b": 5e-4,
           "whisper-medium": 1e-2}
WITNESSED = ("jamba-v0.1-52b", "command-r-plus-104b", "pixtral-12b",
             "arctic-480b", "whisper-medium")
# A leaf whose cut gradient lies past TOL of the one-rank one (an SSM's
# A_log: the order of the ranks' partial sums) is held instead within
# WITNESS times the one-rank f32 gradient's distance from its float64
# witness, a bound that may not pass WITNESS_CAP.
WITNESS, WITNESS_CAP = 2.0, 5e-4
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
B, S = 4, 64
JOIN_S = 300.0

# name: (arch, embed rule, microbatches, the forward's dtype)
CASES = {a: (a, ("data",), 1, "float32") for a in (
    "smollm-135m", "llama3-8b", "gemma2-2b", "deepseek-v2-236b",
    "mamba2-370m", "jamba-v0.1-52b", "command-r-plus-104b",
    "pixtral-12b", "arctic-480b")}
CASES["whisper-medium"] = ("whisper-medium", ("data",), 1, "float64")
CASES["llama3-8b-tp"] = ("llama3-8b", None, 1, "float32")
CASES["llama3-8b-mb2"] = ("llama3-8b", ("data",), 2, "float32")
POD_CASES = {f"{a}-pods": (a, ("data",), 1, "float32")
             for a in ("llama3-8b", "jamba-v0.1-52b")}


def _np(tree):
  return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_inputs(arch):
  jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype=jnp.float32)
  jstate, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptConfig())
  tokens, labels = jdata.TokenStream(
      jdata.DataConfig(jcfg.vocab, S, B, seed=1)).batch_at(0)
  batch = {"tokens": tokens, "labels": labels}
  # whisper's encoder frames, pixtral's patch embeddings (the stubs).
  frames = (jcfg.encoder.source_len if jcfg.encoder is not None
            else jcfg.frontend_tokens if jcfg.frontend == "vision_stub"
            else 0)
  if frames:
    batch["frontend_embeds"] = np.random.default_rng(2).standard_normal(
        (B, frames, jcfg.frontend_dim)).astype(np.float32)
  return jcfg, jstate["params"], batch


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
  return jax.jit(jax.value_and_grad(
      lambda p, t, l, f=None: jtf.forward_loss(p, jcfg, t, l, f),
      has_aux=True))


def _jax_grads(jcfg, jparams, batch, shards):
  """JAX's loss and gradients: of the global batch, or the mean over
  ``shards`` contiguous row groups (the reference's per-shard MoE)."""
  fn = _jax_value_and_grad(jcfg)
  n = B // shards
  outs = [fn(jparams, *(jnp.asarray(batch[k][i * n:(i + 1) * n])
                        for k in ("tokens", "labels", "frontend_embeds")
                        if k in batch))
          for i in range(shards)]
  loss = sum(float(o[0][0]) for o in outs) / shards
  grads = jax.tree.map(lambda *xs: sum(xs[1:], xs[0]) / shards,
                       *[_np(o[1]) for o in outs])
  return loss, grads


def _inputs(cases, compress):
  out, refs = [], {}
  for name, (arch, embed, mb, dtype) in cases.items():
    jcfg, jparams, batch = _jax_inputs(arch)
    out.append({"arch": arch, "embed": embed, "mb": mb, "dtype": dtype,
                "compress": compress, "params": _np(jparams),
                "batch": batch, "opt_cfg": OPT})
    refs[name] = (jcfg, jparams, batch)
  return out, refs


def _tensors(tree):
  return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _one_rank(arch, params_np, batch, shards, dtype=torch.float32):
  """The port's one-rank loss and gradients over the same shares (its
  microbatches), in ``dtype`` (the f32 master cast to it)."""
  cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
  params = _tensors(params_np)
  b = {k: torch.from_numpy(v) for k, v in batch.items()}
  loss, _, grads = loss_and_grads(
      cfg, tree_map(lambda x: x.to(dtype), params), b, microbatches=shards)
  return params, loss, grads


def _rel(got, want):
  want = np.asarray(want, np.float64)
  return float(np.abs(np.asarray(got, np.float64) - want).max()
               / max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
  return str(tmp_path_factory.mktemp("cut_ckpt"))


@pytest.fixture(scope="module")
def dm_run(ckpt_dir):
  cases, refs = _inputs(CASES, False)
  got = world.run_world(ranks.cut_train_world, 8,
                        ((2, 4), ("data", "model"), cases, ckpt_dir),
                        timeout_s=JOIN_S)
  return got, cases, refs


@pytest.fixture(scope="module")
def pod_run():
  cases, refs = _inputs(POD_CASES, True)
  got = world.run_world(ranks.cut_train_world, 8,
                        ((2, 2, 2), ("pod", "data", "model"), cases),
                        timeout_s=JOIN_S)
  return got, cases, refs


def _close(got, want, tol, what=""):
  want = np.asarray(want, np.float64)
  scale = max(float(np.abs(want).max()), 1e-30)
  err = float(np.abs(np.asarray(got, np.float64) - want).max())
  assert err <= tol * scale, (what, err / scale, tol)
  return err / scale


def _fake(mesh_shape):
  return type("M", (), {"shape": dict(mesh_shape)})()


def _check_case(got, case, ref, mesh_shape, dp):
  arch, mb = case["arch"], case["mb"]
  rules = dict(shd.TRAIN_RULES, embed=case["embed"])
  # Every rank's shards: the rule table's cut of each leaf.
  cfg = get_config(arch, smoke=True)
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  mesh = _fake(mesh_shape)
  for r in got:
    for part, sh in r["shapes"].items():
      assert set(sh) == set(shapes), part
      for path, shape in shapes.items():
        spec = shd.mesh_axes_for(axes[path], mesh, rules, shape=shape)
        assert sh[path] == shd.shard_shape(shape, spec, mesh), (part, path)
  # Every rank assembles the same gradients and reports the same norm.
  first = got[0]
  for r in got[1:]:
    for (path, a), (_, b) in zip(leaves(r["grads"]), leaves(first["grads"])):
      assert torch.equal(a, b), path
    assert r["loss"] == first["loss"]
    assert r["step_metrics"]["grad_norm"] == \
        first["step_metrics"]["grad_norm"]
  # Against the port's one-rank step over the same shares; a leaf past
  # TOL against its float64 witness.
  jcfg, jparams, batch = ref
  dtype = getattr(torch, case["dtype"])
  tol = F64_TOL if dtype == torch.float64 else TOL
  params, loss, grads = _one_rank(arch, case["params"], batch, dp * mb,
                                  dtype)
  _close(first["loss"], float(loss), tol, "loss")
  want = dict(leaves(grads))
  assert set(dict(leaves(first["grads"]))) == set(want)
  w64 = {}

  def witness():
    if not w64:
      w64.update(leaves(_one_rank(arch, case["params"], batch, dp * mb,
                                  torch.float64)[2]))
    return w64
  for path, g in leaves(first["grads"]):
    err = _rel(g.numpy(), want[path].numpy())
    if err > tol:
      x = witness()[path].numpy()
      bound = max(tol, WITNESS * _rel(want[path].numpy(), x))
      assert bound <= WITNESS_CAP, (path, bound)
      assert err <= bound and _rel(g.numpy(), x) <= bound, (path, err,
                                                             bound)
  # Against JAX's single-device gradients (per data shard for an MoE),
  # and where the bound is above TOL for an arch of WITNESSED, both
  # packages against the float64 witness.
  shards = dp if cfg.moe is not None else 1
  jloss, jgrads = _jax_grads(jcfg, jparams, batch, shards)
  jtol = JAX_TOL.get(arch, TOL)
  _close(first["loss"], jloss, TOL, "loss vs jax")
  jwant = dict(leaves(jgrads))
  for path, g in leaves(first["grads"]):
    _close(g.numpy(), jwant[path], jtol, f"jax {path}")
  if arch in WITNESSED:                 # the shares' mean: the batch's
    floor = 0.0
    for path, g in leaves(first["grads"]):
      x = witness()[path].numpy()
      _close(g.numpy(), x, jtol, f"port {path} vs float64")
      floor = max(floor, _close(jwant[path], x, jtol, f"jax {path}"))
    assert floor > TOL, floor
  # The state after the step: the one-rank AdamW on the same gradients.
  g = {k: v for k, v in first["grads"].items()}
  state = {"params": params, "opt": init_opt_state(params)}
  if case["compress"]:
    g, err = comp.local_quantise_feedback(
        g, comp.init_error_feedback(params))
  new_p, new_opt, om = adamw_update(g, state["opt"], params,
                                    OptConfig(**OPT))
  for r in got:
    st = r["state"]
    for part, tree in (("params", new_p), ("m", new_opt["m"]),
                       ("v", new_opt["v"])) + (
                           (("err", err),) if case["compress"] else ()):
      have = dict(leaves(st["opt"][part] if part in ("m", "v")
                         else st[part]))
      for path, x in leaves(tree):
        _close(have[path].numpy(), x.numpy(), STATE_TOL, f"{part} {path}")
    assert int(st["opt"]["step"]) == 1
    _close(r["step_metrics"]["grad_norm"], float(om["grad_norm"]),
           STATE_TOL, "grad_norm")


@pytest.mark.parametrize("name", list(CASES))
def test_cut_train_step_data2_model4(dm_run, name):
  got, cases, refs = dm_run
  i = list(CASES).index(name)
  _check_case([r["cases"][i] for r in got], cases[i], refs[name],
              {"data": 2, "model": 4}, 2)


@pytest.mark.parametrize("name", list(POD_CASES))
def test_cut_train_step_pods_compressed(pod_run, name):
  got, cases, refs = pod_run
  i = list(POD_CASES).index(name)
  _check_case([r["cases"][i] for r in got], cases[i], refs[name],
              {"pod": 2, "data": 2, "model": 2}, 4)


def test_every_cut_applies(dm_run):
  """The cuts the cases rely on: llama3's heads (2 a rank) with its 2 KV
  heads whole, gemma2's one head a rank, smollm's 3 heads whole (the
  divisibility fallback) with its ff and vocab cut, deepseek's experts
  and MLA heads, mamba2's SSM heads, every ``embed`` dim over `data`
  under FSDP and none with ``embed -> None``; each step gathers (its FSDP
  leaves, the reduce-scatters of their gradients)."""
  got, _, _ = dm_run
  spec = lambda n, p: got[0]["cases"][list(CASES).index(n)]["specs"][p]  # noqa: E731
  assert spec("llama3-8b", "blocks/pos0/attn/wq") == (None, "data", "model",
                                                      None)
  assert spec("llama3-8b", "blocks/pos0/attn/wk") == (None, "data", None,
                                                      None)
  assert spec("gemma2-2b", "blocks/pos0/attn/wq")[2] == "model"
  assert spec("smollm-135m", "blocks/pos0/attn/wq") == (None, "data", None,
                                                        None)
  assert spec("smollm-135m", "blocks/pos0/mlp/w1") == (None, "data",
                                                       "model")
  assert spec("smollm-135m", "embed") == ("model", "data")
  assert spec("deepseek-v2-236b", "blocks/pos0/moe/w1") == (
      None, "model", "data", None)
  assert spec("deepseek-v2-236b", "blocks/pos0/attn/wq_b") == (
      None, None, "model", None)
  assert spec("mamba2-370m", "blocks/pos0/ssm/A_log") == (None, "model")
  assert spec("jamba-v0.1-52b", "blocks/pos1/moe/router") == (
      None, "data", "model")
  assert spec("llama3-8b-tp", "blocks/pos0/attn/wq") == (None, None,
                                                         "model", None)
  for name in CASES:
    stats = got[0]["cases"][list(CASES).index(name)]["stats"]
    assert (stats["reduce-scatter"] > 0) == (CASES[name][1] is not None), \
        name


@pytest.fixture(scope="module")
def small_run(dm_run, ckpt_dir):
  rng = np.random.default_rng(5)
  f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
  ops_in = {"x": f(4, 8), "w_rows": f(8, 6), "w_cols": f(8, 6),
            "c": f(4, 6), "p": f(8), "xb": f(4, 8)}
  _, cases, _ = dm_run
  trap = dict(cases[list(CASES).index("jamba-v0.1-52b")])
  got = world.run_world(ranks.collective_grads_world, 4,
                        (ops_in, trap, {"dir": ckpt_dir, "step": 1,
                                        "arch": cases[0]["arch"]}),
                        timeout_s=JOIN_S)
  return got, {k: torch.from_numpy(v) for k, v in ops_in.items()}


def _grad(fn, *xs):
  xs = [x.clone().requires_grad_(True) for x in xs]
  return torch.autograd.grad(fn(*xs), xs)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "enter",
                                "gather_fsdp"])
def test_each_collective_backward_is_the_one_rank_gradient(small_run, op):
  """A scalar loss computed on every rank of a line through one autograd
  collective: each rank's gradient is its block of the one-rank gradient
  (a doubled or a partial gradient is 2x or 1/2 of it and fails):
  the all-reduce of a row-cut product's partials (identity backward), the
  all-gather over `model` (the rank's block), :func:`shd.enter` before a
  column-cut product (the partial cotangents summed) and ``gather_fsdp``
  over `data` with each data rank's own rows (a reduce-scatter)."""
  got, t = small_run
  x, c = t["x"], t["c"]
  if op == "all_reduce":
    (want,) = _grad(lambda w: ((x @ w) * c).sum(), t["w_rows"])
    block = lambda r: want.chunk(2, 0)[r["rank"] % 2]  # noqa: E731
  elif op == "all_gather":
    (want,) = _grad(lambda w: ((x @ w) ** 2 * c).sum(), t["w_cols"])
    block = lambda r: want.chunk(2, 1)[r["rank"] % 2]  # noqa: E731
  elif op == "enter":
    dp, dw = _grad(lambda p, w: (torch.tanh((x * p) @ w) * c).sum(),
                   t["p"], t["w_cols"])
    want = (dp, dw)
    block = lambda r: (dp, dw.chunk(2, 1)[r["rank"] % 2])  # noqa: E731
  else:
    (want,) = _grad(lambda w: ((t["xb"] @ w) ** 2).sum(), t["w_cols"])
    block = lambda r: want.chunk(2, 0)[r["rank"] // 2]  # noqa: E731
  for r in got:
    have, w = r[op], block(r)
    for a, b in (zip(have, w) if op == "enter" else [(have, w)]):
      _close(a.numpy(), b.numpy(), 1e-6, op)


def test_backward_on_a_thread_with_no_mesh(small_run):
  """jamba's cut step (FSDP, TP, experts and SSM heads) with its backward
  run on a fresh thread where no mesh is installed, as autograd runs it
  on CUDA (and the recompute of each checkpointed layer with it): the
  same gradients, bit for bit, as the backward on the calling thread."""
  got, _ = small_run
  for r in got:
    assert r["trap"]["mesh_on_thread"] is None
    assert r["trap"]["error"] is None, r["trap"]["error"]
    assert r["trap"]["equal"]


def test_cut_checkpoint_restores_onto_any_mesh(dm_run, small_run, ckpt_dir):
  """smollm's state after its cut step on (data 2, model 4), checkpointed
  whole (``launch.train.save_state``: gathered, rank 0 writes), restored
  on one rank and onto (model 2) (``checkpoint.restore``), where it is
  cut again by the rules (``shard_train_state``) and gathered back: bit
  for bit the state the ranks held."""
  got, _, _ = dm_run
  held = got[0]["cases"][0]["state"]
  small, _ = small_run
  one, step, _ = ck.restore(ckpt_dir)
  assert step == 1

  def equal(a, b):
    pa, pb = dict(leaves(a)), dict(leaves(b))
    assert set(pa) == set(pb)
    for k in pa:
      assert pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]), k
  equal(one, held)
  restored = [r["restored"] for r in small if "restored" in r]
  assert len(restored) == 2
  for r in restored:
    assert r["step"] == 1
    assert r["specs"]["blocks/pos0/mlp/w1"] == (None, None, "model")
    equal(r["state"], held)
