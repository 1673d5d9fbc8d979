"""The port's corpus cache, delta replay and the loop's --batches /
--pipeline against the JAX package's, on the CPU.

* The cache core: one random sequence of lookups, publishes, acquires and
  releases gives the same kinds, entry keys, stats and evictions in both
  packages (the same fingerprint string, so the same keys); refcount
  conservation and no eviction of a mapped entry under hypothesis.
* ``make_extend_step`` against the JAX one (f32, P = 32, E = 32, C = 16):
  the extension's KV within 1e-5 of max|ref|, the last token's logits
  within 1e-5 of max|ref|.
* The port's extension KV against the port's own full prefill of the
  whole prompt, within 1e-5 of max|ref| (f32 sums in another order: the
  JAX package's own check of this is an absolute 1e-5 at |k| ~ 15).
* ``extend_synopsis`` against the JAX one on the same arena and KV: every
  ``ARENA_LEAVES`` entry within 1e-5 of max|ref| (counts equal).
* The engine: on a 100%-repeat trace under ``fixed`` the cache on and off
  give the same ids, and one prefill serves the whole window with it on;
  a hit's lane equals the miss's lane; a prompt extending a cached one is
  admitted by delta replay (no prefill) with the cache-off ids under
  ``basic``, and never under ``int8+kv``.
* The loop: ``run(batches=3, pipeline=True)`` gives the serial lane's ids
  and batch-0 cache, and those of a one-batch run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import corpus_cache as jcc
from repro.serve import kv_cache as jkvc
from repro.serve import prefill as jpf
from repro.serve import synopsis_kv as jskv
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch
from repro_torch.launch.serve import apply_quant
from repro_torch.serve import corpus_cache as cc
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import prefill as pf
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                      make_requests, make_zipf_requests)

REL = 1e-5          # f32 bound, relative to max|ref|


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _rel_err(got, want):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the cache core ------------------------------------------------------------

def _arenas(n):
  """A port arena (tensors) and a JAX-side one (numpy) of the same bytes."""
  rng = np.random.default_rng(n)
  a = {name: rng.normal(size=(n,)).astype(np.float32)
       for name in kvc.ARENA_LEAVES}
  return {k: torch.from_numpy(v) for k, v in a.items()}, a


def test_arena_leaves_match_jax():
  assert kvc.ARENA_LEAVES == jkvc.ARENA_LEAVES
  assert set(kvc.PRIVATE_LEAVES) <= set(jkvc.PRIVATE_LEAVES)
  t, a = _arenas(6)
  t["recent_k"] = torch.zeros(100)              # private: not counted
  assert kvc.arena_nbytes(t) == jkvc.arena_nbytes(a) == 9 * 6 * 4


@pytest.mark.parametrize("capacity,unit", [(2, 0), (3, 4), (5, 2)])
def test_cache_sequence_matches_jax(capacity, unit):
  cfg = dict(capacity=capacity, delta_unit=unit, capacity_bytes=400)
  got = cc.CorpusCache(cc.CacheConfig(**cfg), fingerprint="f")
  want = jcc.CorpusCache(jcc.CacheConfig(**cfg), fingerprint="f")
  rng = np.random.default_rng(capacity)
  base = rng.integers(0, 50, 16, dtype=np.int32)
  pool = [base[:n] for n in (4, 8, 12, 16)] + \
      [rng.integers(0, 50, 8, dtype=np.int32) for _ in range(3)]
  live = []
  for step in range(150):
    if live and rng.integers(0, 3) == 0:
      key = live.pop(int(rng.integers(0, len(live))))
      got.release(key)
      want.release(key)
    else:
      t = pool[int(rng.integers(0, len(pool)))]
      kind, e = got.lookup(t, allow_extend=bool(step % 2))
      jkind, je = want.lookup(t, allow_extend=bool(step % 2))
      assert kind == jkind
      assert (e is None) == (je is None) and (e is None or e.key == je.key)
      if kind == "hit":
        got.acquire(e)
        want.acquire(je)
      else:
        ta, ja = _arenas(len(t) + step % 3)
        e = got.publish(t, ta, None)
        je = want.publish(t, ja, None)
        assert e.key == je.key and e.nbytes == je.nbytes
      live.append(e.key)
    assert got.stats() == want.stats()
    assert list(got.entries) == list(want.entries)
    assert [e.refcount for e in got.entries.values()] == \
        [e.refcount for e in want.entries.values()]
  assert got.stats()["evictions"] > 0
  got.clear()
  want.clear()
  assert list(got.entries) == list(want.entries)
  assert cc.corpus_key(base, "x") == jcc.corpus_key(base, "x")


def _drive(seed, n_ops=150, capacity=3, n_corpora=6):
  """Random admit / retire interleaving: each entry's refcount is its live
  mappings, no mapped entry is evicted, and after a publish the cache is
  within capacity or wholly mapped."""
  rng = np.random.default_rng(seed)
  cache = cc.CorpusCache(cc.CacheConfig(capacity=capacity))
  pool = [np.arange(i + 1, dtype=np.int32) for i in range(n_corpora)]
  live = []
  for _ in range(n_ops):
    published = False
    if live and rng.integers(0, 2):
      cache.release(live.pop(int(rng.integers(0, len(live)))))
    else:
      t = pool[int(rng.integers(0, n_corpora))]
      kind, e = cache.lookup(t)
      if kind == "hit":
        cache.acquire(e)
      else:
        e = cache.publish(t, _arenas(int(t.shape[0]))[0], None)
        published = True
      live.append(e.key)
    expect = {}
    for k in live:
      expect[k] = expect.get(k, 0) + 1
    for k, n in expect.items():
      assert cache.entries[k].refcount == n, "mapped entry lost or evicted"
    assert sum(e.refcount for e in cache.entries.values()) == len(live)
    if published and len(cache.entries) > capacity:
      assert all(e.refcount > 0 for e in cache.entries.values())
  for k in live:
    cache.release(k)
  cache.publish(np.full((99,), 7, np.int32), _arenas(99)[0], None)
  assert len(cache.entries) <= capacity
  with pytest.raises(ValueError, match="pins"):
    e = next(iter(cache.entries.values()))
    cache.release(e.key, e.refcount + 1)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000))
def test_refcount_conservation_hypothesis(seed):
  _drive(seed)


def test_fingerprint_names_the_device():
  cfg = get_config("llama3-8b", smoke=True)
  keys = {cc.corpus_fingerprint(cfg, d, 64, 0) for d in ("cpu", "cuda")}
  assert len(keys) == 2
  assert cc.corpus_fingerprint(apply_quant(cfg, "int8"), "cpu", 64, 0) \
      != cc.corpus_fingerprint(cfg, "cpu", 64, 0)
  assert cc.supports_delta(cfg)


# -- delta replay -------------------------------------------------------------

P, E = 32, 32


@pytest.fixture(scope="module")
def llama():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  basis = torch.from_numpy(np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32)))
  return jcfg, jparams, cfg, params, basis


@pytest.fixture(scope="module")
def delta(llama):
  """One prompt of P + E tokens: the JAX prefix arena and extension, and
  the port's extension from the same arena."""
  jcfg, jparams, cfg, params, _ = llama
  toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, P + E), 0,
                                     cfg.vocab), np.int32)
  prefill = jpf.make_prefill_step(jcfg, impl="xla")
  _, jcache_pre = prefill(jparams, jnp.asarray(toks[:, :P]))
  jarena = jskv.build(jcache_pre, jcfg, impl="xla")
  jlogits, (jk, jv) = jpf.make_extend_step(jcfg)(
      jparams, jnp.asarray(toks[:, P:]), jarena["k"], jarena["v"],
      jnp.int32(P))
  arena = bridge.arena_from_numpy(jax.tree.map(np.asarray, jarena), "cpu")
  logits, (k, v) = pf.make_extend_step(cfg)(
      params, torch.from_numpy(toks[:, P:]).long(), arena["k"], arena["v"],
      P)
  return dict(toks=toks, jarena=jarena, arena=arena, jlogits=jlogits,
              jk=jk, jv=jv, logits=logits, k=k, v=v)


def test_make_extend_step_matches_jax(delta):
  assert tuple(delta["k"].shape) == delta["jk"].shape
  assert _rel_err(delta["k"], delta["jk"]) < REL
  assert _rel_err(delta["v"], delta["jv"]) < REL
  assert _rel_err(delta["logits"], delta["jlogits"]) < REL


def test_extension_kv_matches_the_full_prefill(llama, delta):
  """The port's answer to the JAX package's red delta-replay test: the
  extension's KV and logits against the port's own prefill of all P + E
  tokens, relative to max|ref| (the prefix's sorted order does not change
  the extension's attention)."""
  _, _, cfg, params, _ = llama
  logits, full = pf.make_prefill_step(cfg)(
      params, torch.from_numpy(delta["toks"]).long())
  assert _rel_err(delta["k"], full["k"][..., P:, :]) < REL
  assert _rel_err(delta["v"], full["v"][..., P:, :]) < REL
  assert _rel_err(delta["logits"], logits) < REL
  assert int(delta["logits"].argmax()) == int(logits.argmax())


def test_extend_synopsis_matches_jax(llama, delta):
  jcfg, _, cfg, _, basis = llama
  want = jskv.extend_synopsis(delta["jarena"], delta["jk"], delta["jv"],
                              jcfg, impl="xla")
  got = skv.extend_synopsis(delta["arena"], torch.from_numpy(
      np.array(delta["jk"])), torch.from_numpy(np.array(delta["jv"])),
      cfg, basis=basis)
  assert set(got) == set(want)
  for name in kvc.ARENA_LEAVES:
    if name in want:
      assert tuple(got[name].shape) == want[name].shape, name
      assert _rel_err(got[name], want[name]) < REL, name
  np.testing.assert_array_equal(got["counts"].numpy(),
                                np.asarray(want["counts"]))
  assert int(got["pos"][0]) == P + E
  # The prefix half is untouched.
  assert torch.equal(got["k"][..., :P, :], delta["arena"]["k"])


# -- the engine ------------------------------------------------------------------

def _engine(llama, cfg=None, **kw):
  _, _, tcfg, params, basis = llama
  kw.setdefault("max_new_tokens", 3)
  return ServingEngine(cfg or tcfg, EngineConfig(n_slots=2, **kw),
                       params=params, pca_basis=basis, device="cpu")


def test_repeat_trace_cache_on_and_off(llama):
  """One corpus, every request the same prompt: the same ids with the
  cache on and off, one prefill with it on, and a hit's lane equal to the
  miss's lane it copies."""
  ids, summaries = {}, {}
  arrivals = [0.0, 0.0, 1.0, 2.0, 3.0]
  for on in (False, True):
    eng = _engine(llama, prompt_len=64, policy="fixed", fixed_budget=1,
                  cache=cc.CacheConfig(capacity=2 if on else 0,
                                       delta_unit=16))
    reqs = make_zipf_requests(arrivals, 64, 3, llama[2].vocab, n_corpora=1,
                              seed=3)
    summaries[on] = eng.run(reqs)
    ids[on] = [r.tokens for r in reqs]
    if on:
      # Lanes 0 and 1 were last written by a miss (rid 0) and a hit.
      entry = next(iter(eng.corpus_cache.entries.values()))
      for name in kvc.ARENA_LEAVES:
        if name in entry.arena:
          for lane in (0, 1):
            assert torch.equal(eng.cache[name].narrow(eng._bx[name], lane, 1),
                               entry.arena[name]), name
  assert ids[True] == ids[False]
  on, off = summaries[True], summaries[False]
  assert on["prefills"] == 1 and off["prefills"] == len(arrivals)
  assert on["cache_hits"] == len(arrivals) - 1 and on["cache_misses"] == 1
  assert on["cache_hit_rate"] == pytest.approx(0.8)
  assert "cache_hits" not in off
  assert on["cache_entries"] == 1 and on["cache_bytes"] > 0


def test_zipf_requests_match_jax():
  from repro.serve.engine import make_zipf_requests as j_make_zipf
  got = make_zipf_requests([0.0, 1.0, 5.0, 9.0] * 5, 16, 2, 100,
                           n_corpora=4, seed=9)
  want = j_make_zipf([0.0, 1.0, 5.0, 9.0] * 5, 16, 2, 100, n_corpora=4,
                     seed=9)
  assert [r.prompt.tolist() for r in got] == [r.prompt.tolist() for r in want]
  assert len({r.prompt.tobytes() for r in got}) <= 4


@pytest.mark.parametrize("quant", ["none", "int8+kv"])
def test_engine_delta_replay(llama, quant):
  """A 16-token prefix published, then its 32-token extension admitted:
  by delta replay (no prefill) with the cache-off engine's ids under
  basic (full refinement: exact attention whatever the clustering), and
  as a plain miss under int8+kv, whose sorted cache is quantized."""
  _, _, cfg, params, basis = llama
  qcfg = apply_quant(cfg, quant)
  prompt = np.random.default_rng(4).integers(0, cfg.vocab, 32, np.int32)
  _, pre = pf.make_prefill_step(qcfg)(
      params, torch.from_numpy(prompt[None, :16]).long())
  arena = skv.build(pre, qcfg, basis=basis)
  ids = {}
  for on in (False, True):
    eng = _engine(llama, cfg=qcfg, prompt_len=32, policy="basic",
                  cache=cc.CacheConfig(capacity=4 if on else 0,
                                       delta_unit=16))
    if on:
      e = eng.corpus_cache.publish(prompt[:16], arena, torch.zeros(1).long())
      eng.corpus_cache.release(e.key)          # published, not mapped
    reqs = make_requests([0.0], 32, 3, cfg.vocab)
    reqs[0].prompt = prompt
    s = eng.run(reqs)
    ids[on] = reqs[0].tokens
  assert eng._delta_ok == (quant == "none")
  if quant == "none":
    assert s["prefills"] == 0 and s["cache_delta_hits"] == 1
    assert s["cache_entries"] == 2     # the prefix and its extension
    assert ids[True] == ids[False]
  else:
    assert s["prefills"] == 1 and s["cache_delta_hits"] == 0
    assert s["cache_misses"] == 1


# -- the loop's --batches / --pipeline ---------------------------------------------

def test_pipelined_batches_equal_serial():
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  outs = {}
  for name, kw in (("one", dict(batches=1)), ("serial", dict(batches=3)),
                   ("pipelined", dict(batches=3, pipeline=True))):
    outs[name] = launch.run(cfg, batch=2, prompt_len=64, tokens=3,
                            device="cpu", budgets=[1, 0, 2], log=lambda _: 0,
                            **kw)
  for name in ("serial", "pipelined"):
    assert torch.equal(outs[name]["tokens"], outs["one"]["tokens"]), name
    for leaf, t in outs["one"]["cache"].items():
      assert torch.equal(outs[name]["cache"][leaf], t), (name, leaf)
  assert outs["pipelined"]["prefill_ms"] == 0.0
  assert outs["serial"]["prefill_ms"] > 0 and outs["serial"]["build_ms"] > 0
  assert outs["pipelined"]["prefill_build_ms"] > 0


def test_cli_batches_pipeline(capsys):
  launch.main(["--device", "cpu", "--prompt-len", "32", "--tokens", "2",
               "--batches", "2", "--pipeline"])
  assert "2 batch(es)" in capsys.readouterr().out
