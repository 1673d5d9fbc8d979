"""smollm-135m, and what it shares with pixtral-12b, in the port against the
JAX package on the CPU (f32 SMOKE configs; the JAX weights bridged over).

smollm-135m SMOKE: 2 layers, d 96, 3/3 heads of 32 (G = 1), tied
embeddings.  pixtral-12b SMOKE: 2 layers, d 128, 4/2 heads of 32, untied,
rope 1e6, the vision stub (8 patches of 32).  Both: C 16, i_max 2, recent
16.  The tests both archs run are parametrised over the arch; pixtral's
own (the patch prefix) are in ``tests/test_torch_pixtral.py``.

Tolerance: 4e-5 of max|reference|, not gemma2's 1e-5.  Under the JAX
init's scales the SMOKE models attend with logits of order 100, which
amplifies f32 rounding; gemma2's softcaps bound its logits, these two
archs (like llama3-8b, whose file holds 2e-5 / 1e-4) have none.  At prompt
64 each package's f32 prefill logits lie up to 1.9e-5 of max from a
float64 evaluation of the same model (``test_f32_prefill_against_float64``
holds both within the bound), so two right f32 evaluations can differ by
their sum, and do: up to 1.8e-5 here.  A step in bf16 misses by far more.
The random init attends nearly one-hot, so ids repeat; every test that
decodes holds every step's logits.

* The config (full and SMOKE) against the JAX one, the registry, and the
  parameter count (the port counts the norm gains, neither counts
  ``frontend_proj``).
* The prefill step at prompt 64: last-token logits, ``k`` / ``v``, ``pos``;
  both packages' logits against a float64 evaluation of the same model.
* One serve step on the JAX synopsis cache at budgets 0, 1 and M, and in
  exact mode.
* The loop: 18 tokens (one absorb), every step's logits.
* The engine: ids and every step's logits under ``fixed`` 1 and ``basic``.
* ``supports_delta``: True for smollm, False for pixtral (a frontend), as
  in the JAX package; smollm's delta replay (``make_extend_step`` and
  ``extend_synopsis``) against the JAX one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import corpus_cache as jccache
from repro.serve import prefill as jpf
from repro.serve import synopsis_kv as jskv
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import serve as launch
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.engine import EngineConfig, ServingEngine, make_requests
from repro_torch.serve.prefill import make_extend_step, make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

ARCHS = ("smollm-135m", "pixtral-12b")
B, S = 2, 64
REL = 4e-5
# Budgets 0..2 in a fixed order: every step kind, and one absorb at 16.
BUDGETS = [2, 1, 0, 2, 2, 1, 0, 2, 1, 2, 0, 1, 2, 2, 1, 0, 2, 1]
N_SLOTS, NEW = 2, 4
ARRIVALS = [0.0, 1.0, 2.0, 3.0]
CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "rope_theta", "norm_eps", "tie_embeddings",
                 "scale_embed", "sandwich_norm", "attn_softcap",
                 "logit_softcap", "frontend", "frontend_tokens",
                 "frontend_dim")


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def load(arch):
  """(JAX cfg, JAX params, port cfg, port params, prompt, PCA basis) of
  the arch's f32 SMOKE config."""
  jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config(arch, smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32), basis


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
  return load(request.param)


def _close(got, want, rel=REL):
  got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def _torch_cache(jc):
  return {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


def _prefill_jax(jcfg, jparams, prompt):
  return jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))


# -- config and model ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
  for smoke in (False, True):
    got, want = get_config(arch, smoke=smoke), j_get_config(arch,
                                                             smoke=smoke)
    for name in CONFIG_FIELDS:
      assert getattr(got, name) == getattr(want, name), (smoke, name)
    assert [(s.kind, s.local) for s in got.block_pattern] == \
        [(s.kind, s.local) for s in want.block_pattern] == [("attn", False)]
    assert dataclasses.asdict(got.synopsis) == {
        k: v for k, v in dataclasses.asdict(want.synopsis).items()
        if k in ("cluster_size", "i_max", "recent", "quant")}
    # The port counts the norm gains (final + two a layer), JAX does not.
    assert got.param_count() - want.param_count() == (
        got.d_model * (1 + 2 * got.n_layers))
  assert arch in list_archs()
  full = get_config(arch)
  assert full.dtype == torch.bfloat16 and full.n_blocks == full.n_layers
  if arch == "smollm-135m":
    assert (full.hd, full.n_heads // full.n_kv_heads) == (64, 3)
    assert full.tie_embeddings and full.frontend is None
    assert abs(full.param_count() / 1e9 - 0.1345) < 0.0001
    assert get_config(arch, smoke=True).n_heads == get_config(
        arch, smoke=True).n_kv_heads                   # SMOKE: G = 1
  else:
    assert full.n_heads * full.hd == 4096 != full.d_model
    assert (full.frontend, full.frontend_tokens, full.frontend_dim) == (
        "vision_stub", 256, 1024)
    assert not full.tie_embeddings
    assert abs(full.param_count() / 1e9 - 12.248) < 0.001


def test_parameter_tree_and_count(model):
  """The port's init draws the JAX tree's leaves at their shapes;
  ``param_count`` counts every leaf but ``frontend_proj``."""
  from repro_torch.models import transformer as tf
  _, jparams, cfg, params, _, _ = model
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  n = 0
  for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
    node = mine
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
    if path[0].key != "frontend_proj":
      n += leaf.size
  assert cfg.param_count() == n
  assert ("unembed" in jparams) == (not cfg.tie_embeddings)
  for p in (mine, params):
    assert p["unembed"].dtype == torch.float32


def test_prefill_matches_jax(model):
  jcfg, jparams, cfg, params, prompt, _ = model
  lg_j, cache_j = _prefill_jax(jcfg, jparams, prompt)
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  _close(lg, lg_j)
  for name in ("k", "v"):
    _close(cache[name], cache_j[name])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))


def _f64_logits(jparams, cfg, tokens):
  """Last-token logits of a plain float64 forward pass of the same model
  (no kernel, no cache; rope, causal softmax and SwiGLU written out)."""
  P = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float64)),
                   jparams)
  x = P["embed"][torch.from_numpy(tokens).long()]
  pos = torch.arange(x.shape[1], dtype=torch.float64)
  half, G = cfg.hd // 2, cfg.n_heads // cfg.n_kv_heads

  def rms(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps) \
        * (1 + w)

  def rope(x):
    ang = pos[:, None] * cfg.rope_theta ** (
        -torch.arange(half, dtype=torch.float64) / half)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

  causal = torch.ones(x.shape[1], x.shape[1], dtype=torch.bool).tril()
  for b in range(cfg.n_blocks):
    lp = jax.tree.map(lambda a, b=b: a[b], P["blocks"]["pos0"])
    a, m = lp["attn"], lp["mlp"]
    h = rms(x, lp["ln1"])
    q = rope(torch.einsum("bsd,dhk->bshk", h, a["wq"]))
    k = rope(torch.einsum("bsd,dhk->bshk", h, a["wk"])).repeat_interleave(
        G, 2)
    v = torch.einsum("bsd,dhk->bshk", h, a["wv"]).repeat_interleave(G, 2)
    lg = torch.einsum("bqhk,bshk->bhqs", q, k) * cfg.hd ** -0.5
    w = torch.softmax(lg.masked_fill(~causal, -torch.inf), -1)
    x = x + torch.einsum("bhqs,bshk,hkd->bqd", w, v, a["wo"])
    h = rms(x, lp["ln2"])
    x = x + (torch.nn.functional.silu(h @ m["w1"]) * (h @ m["w3"])) @ m["w2"]
  h = rms(x, P["final_norm"])[:, -1]
  return h @ (P["embed"].T if cfg.tie_embeddings else P["unembed"])


def test_f32_prefill_against_float64(model):
  """Both packages' f32 prefill logits within the bound of a float64
  evaluation: the bound is what f32 can hold here (module doc)."""
  jcfg, jparams, cfg, params, prompt, _ = model
  want = _f64_logits(jparams, cfg, prompt).numpy()
  lg_j, _ = _prefill_jax(jcfg, jparams, prompt)
  lg, _ = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  for got in (lg.numpy(), np.asarray(lg_j)):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


# -- decode ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def synopsis_cache(model):
  jcfg, jparams, _, _, prompt, _ = model
  _, cache = _prefill_jax(jcfg, jparams, prompt)
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3     # a partly filled ring
  return cache, jc


@pytest.mark.parametrize("mode,budget", [("synopsis", 0), ("synopsis", 1),
                                         ("synopsis", S // 16),
                                         ("exact", 0)])
def test_serve_step_matches_jax(model, synopsis_cache, mode, budget):
  jcfg, jparams, cfg, params, _, _ = model
  exact_cache, jc = synopsis_cache
  jc = jc if mode == "synopsis" else exact_cache
  tok = np.array([[5], [77]], np.int32)
  kw = dict(mode=mode, i_max=budget)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, impl="xla", **kw))(
      jparams, jc, jnp.asarray(tok))
  lg, st = make_serve_step(cfg, **kw)(params, _torch_cache(jc),
                                      torch.from_numpy(tok).long())
  _close(lg, lg_j)
  for name in ("k_delta", "v_delta"):
    _close(st[name], st_j[name])
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))


def _jax_loop(jcfg, jparams, prompt, budgets):
  """The JAX single-batch loop with fixed budgets; every step's logits."""
  logits, cache = _prefill_jax(jcfg, jparams, prompt)
  cache = jskv.build(cache, jcfg, impl="xla")
  steps, out = {}, [np.asarray(logits)]
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  ids = [tok]
  for b in budgets:
    if b not in steps:
      steps[b] = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=b,
                                           impl="xla"))
    logits, st = steps[b](jparams, cache, tok)
    cache = jskv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if int(cache["recent_len"][0]) >= jcfg.synopsis.recent:
      cache = jskv.absorb_recent(cache, jcfg, impl="xla")
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ids.append(tok)
    out.append(np.asarray(logits))
  return np.asarray(jnp.concatenate(ids, 1)), out, cache


def test_loop_matches_jax_logits_every_step(model):
  jcfg, jparams, cfg, params, prompt, basis = model
  want_ids, want_logits, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=len(BUDGETS),
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(), budgets=BUDGETS,
                   pca_basis=torch.from_numpy(basis), keep_logits=True,
                   log=lambda _: None)
  assert out["absorbs"] == 1
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  assert len(out["step_logits"]) == len(want_logits) == len(BUDGETS) + 1
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)
  for name in ("k", "k_syn", "counts", "recent_k", "recent_len"):
    assert tuple(out["cache"][name].shape) == jcache[name].shape, name
  _close(out["cache"]["k"], jcache["k"])


# -- the engine --------------------------------------------------------------------

def _record_port(eng, log):
  """Each decode step's (active lanes, their logits)."""
  inner = eng._decode_step

  def step(active, *a, **kw):
    inner(active, *a, **kw)
    log.append(eng.step_out["logits"][list(active)].numpy().copy())
  eng._decode_step = step


def _record_jax(eng, log):
  inner_step, inner_fn = eng._decode_step, eng._step_fn
  active_now = []

  def step_fn(budget):
    fn = inner_fn(budget)

    def run(*a):
      logits, st = fn(*a)
      log.append(np.asarray(logits)[active_now[-1]])
      return logits, st
    return run

  def step(active, *a, **kw):
    active_now.append(list(active))
    inner_step(active, *a, **kw)
  eng._step_fn, eng._decode_step = step_fn, step


@pytest.mark.parametrize("arm", [dict(policy="fixed", fixed_budget=1),
                                 dict(policy="basic")],
                         ids=["fixed1", "basic"])
def test_engine_matches_jax_ids_and_logits(model, arm):
  jcfg, jparams, cfg, params, _, basis = model
  kw = dict(prompt_len=S, max_new_tokens=NEW, overlap_admission=False,
            **arm)
  jeng = JServingEngine(jcfg, JEngineConfig(n_slots=N_SLOTS, impl="xla",
                                            **kw), params=jparams)
  eng = ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, **kw),
                      params=params, pca_basis=torch.from_numpy(basis),
                      device="cpu")
  jlog, log = [], []
  _record_jax(jeng, jlog)
  _record_port(eng, log)
  jreqs = j_make_requests(ARRIVALS, S, NEW, cfg.vocab, seed=13)
  jeng.run(jreqs)
  reqs = make_requests(ARRIVALS, S, NEW, cfg.vocab, seed=13)
  eng.run(reqs)
  key = lambda r: r.rid  # noqa: E731
  assert [r.tokens for r in sorted(reqs, key=key)] == \
      [r.tokens for r in sorted(jreqs, key=key)]
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  assert len(log) == len(jlog) >= NEW
  for got, want in zip(log, jlog):
    _close(got, want)


# -- delta replay ------------------------------------------------------------------

def test_supports_delta_as_jax(model):
  jcfg, _, cfg, params, _, _ = model
  want = cfg.frontend is None                 # smollm yes, pixtral no
  assert jccache.supports_delta(jcfg) == ccache.supports_delta(cfg) == want
  eng = ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, prompt_len=S,
                                        max_new_tokens=NEW),
                      params=params, device="cpu")
  assert eng._delta_ok == want and (eng._extend is None) == (not want)
  if not want:
    with pytest.raises(NotImplementedError, match="frontend"):
      make_extend_step(cfg)


def test_smollm_delta_replay_matches_jax():
  """A 32-token prefix's arena extended by 32 tokens: the extension's KV
  and last logits, then ``extend_synopsis``'s arena, against the JAX
  package's on the same arena."""
  jcfg, jparams, cfg, params, _, basis = load("smollm-135m")
  P = E = 32
  toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, P + E), 0,
                                     cfg.vocab), np.int32)
  _, jpre = jpf.make_prefill_step(jcfg, impl="xla")(
      jparams, jnp.asarray(toks[:, :P]))
  jarena = jskv.build(jpre, jcfg, impl="xla")
  jlogits, (jk, jv) = jpf.make_extend_step(jcfg)(
      jparams, jnp.asarray(toks[:, P:]), jarena["k"], jarena["v"],
      jnp.int32(P))
  arena = bridge.arena_from_numpy(jax.tree.map(np.asarray, jarena), "cpu")
  logits, (k, v) = make_extend_step(cfg)(
      params, torch.from_numpy(toks[:, P:]).long(), arena["k"], arena["v"],
      P)
  _close(logits, jlogits)
  _close(k, jk)
  _close(v, jv)
  want = jskv.extend_synopsis(jarena, jk, jv, jcfg, impl="xla")
  got = skv.extend_synopsis(arena, torch.from_numpy(np.array(jk)),
                            torch.from_numpy(np.array(jv)), cfg,
                            basis=torch.from_numpy(basis))
  for name in kvc.ARENA_LEAVES:
    if name in want:
      _close(got[name], want[name])
  np.testing.assert_array_equal(got["counts"].numpy(),
                                np.asarray(want["counts"]))
  assert int(got["pos"][0]) == P + E
