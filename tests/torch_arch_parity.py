"""What tests/test_torch_arctic.py, tests/test_torch_command_r.py and
tests/test_torch_deepseek.py hold alike: an arch's f32 SMOKE config in the port against the JAX package on
the CPU, the JAX weights bridged over (not a test module: each of those
files calls these checks from its own tests).

Tolerance: 4e-5 of max|reference| throughout, the floor ROADMAP.md §C sets
for an arch without a softcap; each check takes another only where its
caller states one with a float64 witness.
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
from repro.serve import kv_cache as jkvc
from repro.serve import prefill as jpf
from repro.serve import synopsis_kv as jskv
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import serve as launch
from repro_torch.models.common import kv_dims
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import EngineConfig, ServingEngine, make_requests
from repro_torch.serve.prefill import make_extend_step, make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

B, S = 2, 64
REL = 4e-5
# Budgets 0..2 in a fixed order: every step kind, and one absorb at 16.
BUDGETS = [2, 1, 0, 2, 2, 1, 0, 2, 1, 2, 0, 1, 2, 2, 1, 0, 2, 1]
NEW = 4
ARRIVALS = [0.0, 1.0, 2.0, 3.0]
CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "rope_theta", "norm_eps", "tie_embeddings",
                 "parallel_block", "sandwich_norm", "attn_softcap",
                 "logit_softcap", "frontend")


def load(arch):
  """(JAX cfg, JAX params, port cfg, port params, prompt, PCA basis) of the
  arch's f32 SMOKE config; the params' numpy tree is ``jparams``'s."""
  jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config(arch, smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  Hkv, D = kv_dims(cfg)
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (Hkv * D, 3), jnp.float32))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32), basis


def close(got, want, rel=REL):
  got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def torch_cache(jc):
  return {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


def prefill_jax(jcfg, jparams, prompt):
  return jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))


def layer_slice(tree, i=0):
  """Layer i of a stacked JAX (or numpy) subtree."""
  return jax.tree.map(lambda a: a[i], tree)


# -- config and parameters ----------------------------------------------------

def check_config(arch):
  """Full and SMOKE configs equal the JAX ones field by field (the MoE's
  too), and the arch is registered."""
  for smoke in (False, True):
    got, want = get_config(arch, smoke=smoke), j_get_config(arch,
                                                             smoke=smoke)
    for name in CONFIG_FIELDS:
      assert getattr(got, name) == getattr(want, name), (smoke, name)
    for name in ("moe", "mla"):
      a, b = getattr(got, name), getattr(want, name)
      assert (a is None) == (b is None), (smoke, name)
      if a is not None:
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (smoke, name)
    assert [(s.kind, s.use_moe, s.local) for s in got.block_pattern] == \
        [(s.kind, s.use_moe, s.local) for s in want.block_pattern]
    assert dataclasses.asdict(got.synopsis) == {
        k: v for k, v in dataclasses.asdict(want.synopsis).items()
        if k in ("cluster_size", "i_max", "recent", "quant")}
  assert arch in list_archs()


def norm_gains(cfg):
  """The norm gains of the port's tree, which the JAX count leaves out."""
  per = 1 + ("ln2" in _first_layer_keys(cfg))
  return (per * cfg.n_layers + 1) * cfg.d_model


def _first_layer_keys(cfg):
  from repro_torch.models.common import param_shapes
  return set(param_shapes(cfg)["blocks"]["pos0"])


def check_tree(model, keys):
  """The port's init tree has the JAX tree's leaves at their shapes, its
  count is the JAX leaves' count, and a layer holds ``keys``."""
  from repro_torch.models import transformer as tf
  _, jparams, cfg, _, _, _ = model
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  n = 0
  for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
    node = mine
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
    n += leaf.size
  assert cfg.param_count() == n
  assert set(mine["blocks"]["pos0"]) == set(jparams["blocks"]["pos0"]) == \
      keys


def check_bridge_refuses(model, missing, extra):
  """A tree that lacks the leaf at path ``missing`` or holds one more at
  path ``extra`` (a leaf the config's tree lacks) raises, naming it."""
  _, jparams, cfg, _, _, _ = model
  tree = jax.tree.map(np.asarray, jparams)
  *head, leaf = missing.split("/")
  node = tree
  for key in head:
    node = node[key]
  del node[leaf]
  with pytest.raises(KeyError, match=missing):
    bridge.params_from_numpy(tree, cfg, "cpu")
  tree = jax.tree.map(np.asarray, jparams)
  *head, leaf = extra.split("/")
  node = tree
  for key in head:
    node = node.setdefault(key, {})
  node[leaf] = np.zeros((cfg.n_layers, cfg.d_model), np.float32)
  with pytest.raises(KeyError, match=extra):
    bridge.params_from_numpy(tree, cfg, "cpu")


# -- prefill, steps and the loop ----------------------------------------------

def check_prefill(model):
  jcfg, jparams, cfg, params, prompt, _ = model
  lg_j, cache_j = prefill_jax(jcfg, jparams, prompt)
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  assert set(cache) == set(cache_j) == {"k", "v", "pos"}
  close(lg, lg_j)
  close(cache["k"], cache_j["k"])
  close(cache["v"], cache_j["v"])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))


def synopsis_cache(model):
  """(the JAX prefill's exact cache, its JAX synopsis cache with a partly
  filled ring)."""
  jcfg, jparams, _, _, prompt, _ = model
  _, cache = prefill_jax(jcfg, jparams, prompt)
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3
  return cache, jc


def check_step(model, caches, mode, budget):
  jcfg, jparams, cfg, params, _, _ = model
  exact_cache, jc = caches
  jc = jc if mode == "synopsis" else exact_cache
  tok = np.array([[5], [77]], np.int32)
  kw = dict(mode=mode, i_max=budget)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, impl="xla", **kw))(
      jparams, jc, jnp.asarray(tok))
  lg, st = make_serve_step(cfg, **kw)(params, torch_cache(jc),
                                      torch.from_numpy(tok).long())
  close(lg, lg_j)
  assert set(st) == set(st_j)
  close(st["k_delta"], st_j["k_delta"])
  close(st["v_delta"], st_j["v_delta"])
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))


def _jax_loop(jcfg, jparams, prompt, budgets, mode):
  """The JAX loop with fixed budgets (exact: no build, only ``pos``
  advancing): ids, every step's logits, the final cache."""
  logits, cache = prefill_jax(jcfg, jparams, prompt)
  if mode == "synopsis":
    cache = jskv.build(cache, jcfg, impl="xla")
  steps, out = {}, [np.asarray(logits)]
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  ids = [tok]
  for b in budgets:
    b = b if mode == "synopsis" else 0
    if b not in steps:
      steps[b] = jax.jit(j_make_serve_step(jcfg, mode=mode, i_max=b,
                                           impl="xla"))
    logits, st = steps[b](jparams, cache, tok)
    if mode == "synopsis":
      cache = jskv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if mode == "synopsis" and \
        int(cache["recent_len"][0]) >= jcfg.synopsis.recent:
      cache = jskv.absorb_recent(cache, jcfg, impl="xla")
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ids.append(tok)
    out.append(np.asarray(logits))
  return np.asarray(jnp.concatenate(ids, 1)), out, cache


def check_loop(model, mode):
  """The port's loop (18 steps, one absorb in synopsis mode): the JAX
  loop's ids and every step's logits."""
  jcfg, jparams, cfg, params, prompt, basis = model
  want_ids, want_logits, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS,
                                            mode)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=len(BUDGETS),
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(),
                   budgets=BUDGETS if mode == "synopsis" else None,
                   mode=mode, pca_basis=torch.from_numpy(basis),
                   keep_logits=True, log=lambda _: None)
  assert out["absorbs"] == (1 if mode == "synopsis" else 0)
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  assert len(out["step_logits"]) == len(want_logits) == len(BUDGETS) + 1
  for got, want in zip(out["step_logits"], want_logits):
    close(got, want)
  if mode == "synopsis":
    for name in ("k", "k_syn", "counts", "recent_k", "recent_len"):
      assert tuple(out["cache"][name].shape) == jcache[name].shape, name
    close(out["cache"]["k"], jcache["k"])


# -- the engine ---------------------------------------------------------------

def check_pool(model, synopsis):
  jcfg, _, cfg, _, _, _ = model
  want = jkvc.cache_struct(jcfg, 3, S, synopsis=synopsis)
  got = kvc.cache_struct(cfg, 3, S, synopsis=synopsis)
  assert list(got) == list(want)
  for name, (shape, dt, axes) in got.items():
    assert shape == want[name][0], name
    assert axes == want[name][2], name
    assert str(dt).split(".")[-1] == np.dtype(want[name][1]).name, name


def _record_port(eng, log):
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


def engines(model, n_slots, **kw):
  jcfg, jparams, cfg, params, _, basis = model
  jeng = JServingEngine(jcfg, JEngineConfig(n_slots=n_slots, impl="xla",
                                            **kw), params=jparams)
  eng = ServingEngine(cfg, EngineConfig(n_slots=n_slots, **kw),
                      params=params, pca_basis=torch.from_numpy(basis),
                      device="cpu")
  return jeng, eng


def check_engine(model, policy, overlap=False, **ekw):
  """Same weights, basis and requests: the JAX engine's events, ids,
  budgets and every step's logits under ``policy`` ("accuracytrader",
  "basic", or "fixed" with ``fixed_budget`` in ``ekw``).  The deadline is one no step of either engine misses, so
  that accuracytrader's controller picks the largest bucket every step in
  both packages, whatever their host clocks (on which they differ: a
  deadline either engine can miss gives budgets, and so ids, that follow
  each engine's own speed)."""
  kw = dict(prompt_len=S, max_new_tokens=NEW, overlap_admission=overlap,
            policy=policy, deadline_ms=1e6, **ekw)
  jeng, eng = engines(model, 2, **kw)
  jlog, log = [], []
  _record_jax(jeng, jlog)
  _record_port(eng, log)
  vocab = model[2].vocab
  jreqs = j_make_requests(ARRIVALS, S, NEW, vocab, seed=13)
  jeng.run(jreqs)
  reqs = make_requests(ARRIVALS, S, NEW, vocab, seed=13)
  eng.run(reqs)
  assert [ev[:3] for ev in eng.events] == [ev[:3] for ev in jeng.events]
  assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  assert len(log) == len(jlog) >= NEW
  for got, want in zip(log, jlog):
    close(got, want)


# -- the corpus cache ---------------------------------------------------------

def check_delta_replay(model):
  """supports_delta is True in both packages; a 32-token prefix's arena
  extended by 32 tokens: the extension's KV and last logits, then
  ``extend_synopsis``'s arena, against the JAX package's on the same
  arena."""
  jcfg, jparams, cfg, params, _, basis = model
  assert jccache.supports_delta(jcfg) is ccache.supports_delta(cfg) is True
  eng = ServingEngine(cfg, EngineConfig(n_slots=2, prompt_len=S,
                                        max_new_tokens=NEW),
                      params=params, device="cpu")
  assert eng._delta_ok and eng._extend is not None
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
  close(logits, jlogits)
  close(k, jk)
  close(v, jv)
  want = jskv.extend_synopsis(jarena, jk, jv, jcfg, impl="xla")
  got = skv.extend_synopsis(arena, torch.from_numpy(np.array(jk)),
                            torch.from_numpy(np.array(jv)), cfg,
                            basis=torch.from_numpy(basis))
  for name in kvc.ARENA_LEAVES:
    if name in want:
      close(got[name], want[name])
  np.testing.assert_array_equal(got["counts"].numpy(),
                                np.asarray(want["counts"]))
  assert int(got["pos"][0]) == P + E


def check_corpus_hit(model):
  """One corpus three times, one slot: the first admission misses and
  publishes its arena, the others hit, and all three give the ids of the
  same trace with the cache off, which the JAX engine gives too."""
  cfg = model[2]
  kw = dict(prompt_len=S, max_new_tokens=NEW, policy="fixed",
            fixed_budget=1)
  jeng, off = engines(model, 1, **kw)
  _, on = engines(model, 1, cache=CacheConfig(capacity=4), **kw)
  prompt = np.random.default_rng(7).integers(0, cfg.vocab, S).astype(
      np.int32)

  def trace(mk):
    reqs = mk([0.0, 0.0, 0.0], S, NEW, cfg.vocab, seed=0)
    for r in reqs:
      r.prompt = prompt
    return reqs
  ids = {}
  for name, eng, mk in (("jax", jeng, j_make_requests),
                        ("off", off, make_requests),
                        ("on", on, make_requests)):
    reqs = trace(mk)
    eng.run(reqs)
    ids[name] = [r.tokens for r in reqs]
  assert ids["on"] == ids["off"] == ids["jax"]
  s = on.summary()
  assert (s["cache_hits"], s["cache_misses"], s["prefills"]) == (2, 1, 1)
