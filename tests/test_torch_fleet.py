"""The port's fleet tier (stacked path) against the JAX package's, on the
CPU; the JAX side is built with ``use_mesh=False`` (its CLI forces the
sharded path, which fails on jax 0.9.0: ROADMAP C).

* ``kv_cache.replicate_leaf`` against JAX's and ``shard_grid`` (exact).
* ``make_fleet_attention``: the output and ``fe_cover`` for any
  ``fe_replica`` equal to the all-primary ones bit for bit
  (``torch.equal``), on ``tests/test_fleet.py``'s cases and an int8+kv
  arena, and within 4e-5 of max|ref| of JAX's stacked body.  Since that
  would also hold if the selection were ignored, a pool whose replica
  copies are made to differ: the output must equal the cluster tier's
  attention over the selected lanes, bit for bit, and differ from the
  all-primary one.  The row map (``fleet_rows``) entry by entry.
* ``FleetStepBackend``: the slot write's leaves equal to JAX's (exact,
  after the layout's permutation), routes fixed and rotate, an int8+kv
  arena; R corpus-cache pins a slot on a miss and on a hit, all released
  at retire; the resilience knobs and a mesh refused; ``plan_step`` /
  ``account`` equal to JAX's on scripted walls (exact: numpy float64) and
  never worse than the cluster tier's modelled hedge under the same
  draws.
* The fleet engine's ids, budgets and every step's logits (4e-5 of
  max|ref|) equal to the JAX fleet engine's under ``basic`` and
  ``fixed`` (SMOKE llama3-8b in f32, deadline 1e6 ms); ``--fleet`` and
  ``--autoscale`` through the port's CLI.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.control import DeadlineBudgetPolicy as JPolicy
from repro.dist import topology as jtopo
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import cluster as jcl
from repro.serve import fleet as jfl
from repro.serve import kv_cache as jkvc
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serve.resilience import FaultSpec as JFaultSpec
from repro.serving.service import _default_concentration
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.control import DeadlineBudgetPolicy, MODE_FULL, MODE_STAGE1
from repro_torch.dist import topology
from repro_torch.launch import serve as launch
from repro_torch.serve import cluster as cl
from repro_torch.serve import fleet as fl
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                      make_requests)
from repro_torch.serve.resilience import FaultSpec

B, Hkv, G, C, D = 2, 2, 2, 16, 16
SM = float(1.0 / np.sqrt(D))
TOL = 4e-5          # of max|ref|: the f32 floor of the port's parity tests


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- the grid ------------------------------------------------------------------

@pytest.mark.parametrize("N,R,axis", [(4, 3, 2), (3, 2, 1), (2, 1, 0)])
def test_replicate_leaf_matches_jax_and_the_grid(N, R, axis):
  shape = [2, 3, 4, 5]
  shape[axis] = N
  x = np.random.default_rng(N).normal(size=shape).astype(np.float32)
  got = kvc.replicate_leaf(torch.from_numpy(x), R, axis=axis)
  want = np.asarray(jkvc.replicate_leaf(jnp.asarray(x), R, axis=axis))
  assert torch.equal(got, torch.from_numpy(want.copy()))
  grid = topology.plan_2d(4 * N, N, R).shard_grid()
  np.testing.assert_array_equal(grid, jtopo.plan_2d(4 * N, N, R).shard_grid())
  moved = np.moveaxis(got.numpy(), (axis, axis + 1), (0, 1))
  for r in range(R):
    for j in range(N):
      np.testing.assert_array_equal(moved[r, j],
                                    np.moveaxis(x, axis, 0)[grid[r, j]])
  with pytest.raises(ValueError):
    kvc.replicate_leaf(torch.from_numpy(x), 0, axis=axis)


def test_row_map_names_the_selected_lanes():
  R, N, Bq = 3, 4, 2
  sel = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
  rows = fl.fleet_rows(sel, Bq, R, N)
  for b in range(Bq):
    for c in range(N):
      s = int(sel[c])
      assert int(rows[b * N + c]) == (b * R + s) * N + (c + s) % N
  # Each shard's selected lane holds that shard (shard_grid).
  grid = topology.plan_2d(16, N, R).shard_grid()
  for c in range(N):
    r, j = divmod(int(rows[c]), N)
    assert grid[r, j] == c


# -- the attention body ----------------------------------------------------------

def _fleet_cache(topo, seed, quant=None):
  """JAX's fleet layout of one layer (``tests/test_fleet.py``'s synthetic
  cache; int8+kv: JAX's build oracle's arena), the query and the self
  KV."""
  M = topo.m_total
  S = M * C
  ks = jax.random.split(jax.random.PRNGKey(seed), 8)
  k = jax.random.normal(ks[0], (B, Hkv, S, D), jnp.float32)
  v = jax.random.normal(ks[1], (B, Hkv, S, D), jnp.float32)
  cache = {"recent_k": jax.random.normal(ks[2], (B, Hkv, 16, D)),
           "recent_v": jax.random.normal(ks[3], (B, Hkv, 16, D)),
           "recent_len": jnp.full((B,), 5, jnp.int32)}
  if quant is None:
    arena = dict(k=k, v=v, counts=jnp.full((B, M), float(C)),
                 k_syn=k.reshape(B, Hkv, M, C, D).mean(3),
                 v_syn=v.reshape(B, Hkv, M, C, D).mean(3))
  else:
    perm = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    arena = jref.synopsis_build_quant_ref(k, v, perm, cluster_size=C,
                                          qc=jquant.parse_qconfig(quant))
  Mp = topo.m_max
  for name, x in arena.items():
    unit = C if name in ("k", "v") else 1
    axis = 1 if name == "counts" else 2
    parts = []
    for c in range(topo.n_components):
      off, cnt = topo.offsets[c] * unit, topo.counts[c] * unit
      sl = jax.lax.slice_in_dim(x, off, off + cnt, axis=axis)
      widths = [(0, 0)] * sl.ndim
      widths[axis] = (0, Mp * unit - cnt)
      parts.append(jnp.pad(sl, widths))
    cache[name] = jkvc.replicate_leaf(jnp.stack(parts, axis=axis),
                                      topo.replicas, axis=axis)
  kd = jax.random.normal(ks[4], (B, Hkv, 1, D), jnp.float32)
  q = jax.random.normal(ks[5], (B, Hkv * G, D), jnp.float32)
  return q, cache, (kd, kd)


def _port_layer(csl):
  """JAX's fleet layer -> the port's: (B, Hkv, R, N, ...) -> (B, R, N, Hkv,
  ...), contiguous as the pool holds it."""
  out = {}
  for name, x in csl.items():
    t = bridge.arena_from_numpy({name: np.asarray(x)}, "cpu")[name]
    if name not in ("counts", "recent_k", "recent_v", "recent_len",
                    "fe_mode", "fe_replica"):
      t = t.movedim(1, 3).contiguous()
    out[name] = t
  return out


def _t(x):
  return torch.from_numpy(np.array(x))


CASES = [(0.0, "mass", None), (1.1, "topk", None), (1.1, "gain", None),
         (0.0, "mass", "int8+kv")]


@pytest.mark.parametrize("skew,alloc,quant", CASES,
                         ids=[f"{s}-{a}-{q}" for s, a, q in CASES])
def test_stacked_gather_invariant_to_selection(skew, alloc, quant):
  """Whatever ``fe_replica`` says, with a STAGE1 shard and a skewed padded
  partition, the output and ``fe_cover`` equal the all-primary ones
  exactly, and the all-primary output lies within 4e-5 of max|ref| of
  JAX's stacked body."""
  jt = jtopo.plan_2d(16, 4, 3, skew=skew)
  topo = topology.plan_2d(16, 4, 3, skew=skew)
  N, R = topo.n_components, topo.replicas
  q, csl, (kd, vd) = _fleet_cache(jt, int(skew * 10), quant)
  mode = np.full((N,), MODE_FULL, np.int32)
  mode[1] = MODE_STAGE1
  attn = fl.make_fleet_attention(topo, alloc=alloc)
  jattn = jfl.make_fleet_attention(jt, alloc=alloc, mesh=None)
  port = _port_layer(csl)

  def run(sel):
    c = dict(port, fe_mode=torch.from_numpy(mode),
             fe_replica=torch.from_numpy(sel))
    out, aux = attn(_t(q), c, i_max=4, cluster_size=C, sm_scale=SM,
                    self_kv=(_t(kd), _t(vd)))
    return out, aux["fe_cover"]

  ref_out, ref_cover = run(np.zeros(N, np.int32))
  want, jaux = jattn(q, dict(csl, fe_mode=jnp.asarray(mode),
                             fe_replica=jnp.zeros(N, jnp.int32)),
                     i_max=4, cluster_size=C, sm_scale=SM,
                     self_kv=(kd, vd), impl="xla")
  want = np.asarray(want)
  assert np.abs(ref_out.numpy() - want).max() <= TOL * np.abs(want).max()
  np.testing.assert_array_equal(ref_cover.numpy(),
                                np.asarray(jaux["fe_cover"]))
  rng = np.random.default_rng(7)
  for _ in range(4):
    sel = rng.integers(0, R, N).astype(np.int32)
    out, cover = run(sel)
    assert torch.equal(out, ref_out), sel
    assert torch.equal(cover, ref_cover), sel


def test_output_follows_the_selected_lane_where_copies_differ():
  """A pool whose replica rows hold different data (each row's copies a
  corpus of its own): the fleet output for a selection equals the cluster
  tier's attention over the selected lanes bit for bit, so the row map
  (stage 2) and the gathered tables (stage 1) read the selected holder's
  shard, and it differs from the all-primary output."""
  topo = topology.plan_2d(16, 4, 2, skew=1.1)
  N, R = topo.n_components, topo.replicas
  rows = [_port_layer(_fleet_cache(jtopo.plan_2d(16, 4, 2, skew=1.1),
                                   seed)[1]) for seed in (3, 4)]
  q, _, (kd, vd) = _fleet_cache(jtopo.plan_2d(16, 4, 2, skew=1.1), 3)
  pool = dict(rows[0])
  for name in ("k", "v", "k_syn", "v_syn", "counts"):
    pool[name] = torch.stack([rows[0][name][:, 0], rows[1][name][:, 1]], 1)
  mode = torch.full((N,), MODE_FULL, dtype=torch.int32)
  kw = dict(i_max=4, cluster_size=C, sm_scale=SM, self_kv=(_t(kd), _t(vd)))
  fleet = fl.make_fleet_attention(topo, alloc="mass")
  cluster = cl.make_cluster_attention(topo, alloc="mass")
  primary, _ = fleet(_t(q), dict(pool, fe_mode=mode,
                                 fe_replica=torch.zeros(N, dtype=torch.int32)),
                     **kw)
  rng = np.random.default_rng(5)
  seen_diff = 0
  for _ in range(6):
    sel = torch.from_numpy(rng.integers(0, R, N).astype(np.int32))
    got, aux = fleet(_t(q), dict(pool, fe_mode=mode, fe_replica=sel), **kw)
    lanes = {kk: vv for kk, vv in pool.items()}
    for name in ("k", "v", "k_syn", "v_syn", "counts"):
      x = pool[name]
      lanes[name] = torch.stack(
          [x[:, int(sel[c]), (c + int(sel[c])) % N] for c in range(N)],
          1).contiguous()
    want, waux = cluster(_t(q), dict(lanes, fe_mode=mode), **kw)
    assert torch.equal(got, want), sel
    assert torch.equal(aux["fe_cover"], waux["fe_cover"])
    seen_diff += int(bool(sel.any())) and not torch.equal(got, primary)
  assert seen_diff > 0


def test_mesh_and_a_bad_alloc_are_refused():
  """A mesh that is not the port's ``Mesh`` is a ``TypeError`` (the
  sharded path runs on ranks: ``tests/test_torch_mesh_tiers.py``)."""
  topo = topology.plan_2d(16, 2, 2)
  with pytest.raises(TypeError, match="Mesh"):
    fl.make_fleet_attention(topo, mesh=object())
  with pytest.raises(ValueError, match="alloc"):
    fl.make_fleet_attention(topo, alloc="nope")


# -- the backend ---------------------------------------------------------------

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


def _quant(cfg, spec):
  if spec is None:
    return cfg
  return dataclasses.replace(cfg, synopsis=dataclasses.replace(
      cfg.synopsis, quant=spec))


def _bound(llama, kw, *, policy="basic", n_slots=2, quant=None,
           cluster=False):
  """The port's and JAX's fleet (or cluster) backends bound to a stand-in
  engine, the policy sharing the backend's predictor as the engines
  build it."""
  jcfg, _, cfg, _, _ = llama
  out = []
  for mod, Policy, c, extra in (
      (cl if cluster else fl, DeadlineBudgetPolicy, _quant(cfg, quant),
       {"dev": torch.device("cpu")}),
      (jcl if cluster else jfl, JPolicy, _quant(jcfg, quant),
       {"impl": "xla"})):
    conf = mod.ClusterConfig if cluster else mod.FleetConfig
    backend_cls = mod.ClusterStepBackend if cluster else \
        mod.FleetStepBackend
    ckw = dict(kw, use_mesh=False) if mod in (jcl, jfl) else dict(kw)
    backend = backend_cls(conf(**ckw))
    M_ = 64 // c.synopsis.cluster_size
    eng = types.SimpleNamespace(
        cfg=c, M=M_, accuracy_fn=_default_concentration,
        ecfg=types.SimpleNamespace(n_slots=n_slots, prompt_len=64,
                                   contract="deadline"), **extra)
    backend.bind(eng)
    eng.controller = Policy(policy=policy, buckets=(0, 1, 2, 4),
                            i_max_cap=M_, predictor=backend.predictor)
    out.append(backend)
  return out


def _syn(cfg_j, seed):
  """A drawn B = 1 synopsis cache in JAX's pre-scatter layout."""
  rng = np.random.default_rng(seed)
  out = {}
  for name, leaf in jkvc.zeros_cache(cfg_j, 1, 64, synopsis=True).items():
    a = np.asarray(leaf)
    if a.dtype == np.int8:
      out[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
    elif name == "counts":
      out[name] = rng.integers(1, 9, a.shape).astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
      out[name] = rng.integers(0, 5, a.shape).astype(a.dtype)
    else:
      out[name] = rng.standard_normal(a.shape).astype(a.dtype)
  return out


@pytest.mark.parametrize("route,skew,R,quant", [
    ("fixed", 0.0, 2, None), ("rotate", 1.2, 3, None),
    ("fixed", 1.2, 2, "int8+kv")])
def test_write_slot_matches_jax(llama, route, skew, R, quant):
  backend, jbackend = _bound(llama, dict(n_components=4, skew=skew,
                                         route=route, replicas=R),
                             quant=quant)
  assert backend.replica_mappings == jbackend.replica_mappings == R
  pool, jpool = backend.zeros_cache(), jbackend.zeros_cache()
  assert set(pool) == set(jpool)
  for slot, seed in ((0, 1), (1, 2), (0, 3)):     # slot 0 written twice
    syn = _syn(_quant(llama[0], quant), seed)
    jpool = jbackend.write_slot(jpool, {k: jnp.asarray(v)
                                        for k, v in syn.items()}, slot)
    backend.write_slot(pool, bridge.arena_from_numpy(syn, "cpu"), slot)
  for name, leaf in pool.items():
    want = torch.from_numpy(np.asarray(jpool[name]))
    if name in kvc.ARENA_LEAVES and name != "counts":
      want = want.movedim(3, 5)      # JAX: (nb, na, B, Hkv, R, N, ...)
    assert leaf.shape == want.shape, name
    assert torch.equal(leaf, want.to(leaf.dtype)), name


def _port_engine(llama, backend, **kw):
  _, _, cfg, params, basis = llama
  return ServingEngine(cfg, EngineConfig(**kw), params=params,
                       pca_basis=basis, device="cpu", backend=backend)


def test_admission_pins_the_arena_per_replica(llama):
  """One admission maps the arena onto R rows and holds R pins, on a miss
  and on a hit; retirement releases all R; the lanes hold bit-identical
  copies at every (replica, column) of the grid."""
  cfg = llama[2]
  backend = fl.FleetStepBackend(fl.FleetConfig(n_components=2, replicas=2))
  eng = _port_engine(llama, backend, n_slots=2, prompt_len=64,
                     max_new_tokens=2, policy="fixed", fixed_budget=1,
                     cache=CacheConfig(capacity=4, delta_unit=16))
  assert eng._map_count == 2
  eng.reset()
  reqs = make_requests([0.0, 0.0], 64, 2, cfg.vocab, seed=9)
  reqs[1].prompt = reqs[0].prompt.copy()
  eng._admit(reqs[0], 0)                          # miss
  entry = eng.corpus_cache.entries[eng._slot_entry[0]]
  assert entry.refcount == 2
  eng._admit(reqs[1], 1)                          # hit
  assert entry.refcount == 4
  grid = backend.topo.shard_grid()
  for name in kvc.ARENA_LEAVES:
    if name not in eng.cache:
      continue
    x = eng.cache[name]
    assert x.abs().sum() > 0
    for r in range(backend.topo.replicas):
      for j in range(backend.topo.n_components):
        assert torch.equal(x[:, :, :, r, j], x[:, :, :, 0, grid[r, j]])
  eng._retire(0)
  assert entry.refcount == 2
  eng._retire(1)
  assert entry.refcount == 0


def test_resilience_knobs_are_refused(llama):
  cfg, params = llama[2], llama[3]
  for ccfg, err, match in (
      (dict(faults=FaultSpec(crash_rate=0.1)), ValueError, "non-resilient"),
      (dict(retries=2), ValueError, "non-resilient"),
      (dict(recovery=False), ValueError, "non-resilient"),
      # No (replica, component) mesh of 4 ranks in a world of one: JAX's
      # error with fewer devices.
      (dict(use_mesh=True), RuntimeError,
       "use_mesh=True but the world has 1 < 4 ranks")):
    with pytest.raises(err, match=match):
      ServingEngine(cfg, EngineConfig(n_slots=1, prompt_len=64,
                                      max_new_tokens=2), params=params,
                    device="cpu", backend=fl.FleetStepBackend(
                        fl.FleetConfig(n_components=2, replicas=2, **ccfg)))
  with pytest.raises(ValueError, match="non-resilient"):
    JServingEngine(llama[0], JEngineConfig(
        n_slots=1, prompt_len=64, max_new_tokens=2, impl="xla"),
        params=llama[1], backend=jfl.FleetStepBackend(jfl.FleetConfig(
            n_components=2, replicas=2, use_mesh=False,
            faults=JFaultSpec(crash_rate=0.1))))


@pytest.mark.parametrize("kw,policy", [
    (dict(n_components=4, replicas=2, skew=1.2), "accuracytrader"),
    (dict(n_components=4, replicas=3, route="rotate"), "partial"),
    (dict(n_components=2, replicas=2, alloc="gain"), "basic")])
def test_plan_and_account_match_jax(llama, kw, policy):
  backend, jbackend = _bound(llama, kw, policy=policy)
  rng = np.random.default_rng(kw["replicas"])
  for b in (backend, jbackend):
    b.reseed(7)
  N = kw["n_components"]
  for step in range(40):
    budget = (0, 1, 2, 4)[step % 4]
    deadline = float("inf") if step % 5 == 0 else float(
        rng.uniform(0.2, 3.0))
    plan, jplan = backend.plan_step(budget, deadline), \
        jbackend.plan_step(budget, deadline)
    np.testing.assert_array_equal(np.stack([plan.mode, plan.sel]),
                                  np.asarray(jplan.fe_mode))
    for name in ("mode", "sel", "noise", "noise2", "hedged", "b_est"):
      np.testing.assert_array_equal(getattr(plan, name),
                                    getattr(jplan, name), err_msg=name)
    wall = float(rng.uniform(1.0, 6.0))
    st = {"fe_cover": rng.uniform(0.0, 3.0, (2, 1, N)),
          "fe_mass": rng.dirichlet(np.ones(N), (2, 1))}
    got = backend.account(budget, wall, plan, st, warming=step < 2)
    want = jbackend.account(budget, wall, jplan, st, warming=step < 2)
    assert set(got) == set(want)
    for k in got:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  np.testing.assert_array_equal(backend.mass_ewma, jbackend.mass_ewma)


def test_fleet_never_worse_than_the_modelled_hedge(llama):
  """Under the same seeds and draws the fleet's per-step parallel time is
  at most the cluster tier's modelled-hedge time, and equal where the
  cluster hedges every shard (a deadline of ~0)."""
  fb, _ = _bound(llama, dict(n_components=2, replicas=2), n_slots=1)
  cb, _ = _bound(llama, dict(n_components=2, replicas=2), n_slots=1,
                 cluster=True)
  for deadline, must_equal in ((1e-6, True), (4.0, False)):
    fb.reseed(1234)
    cb.reseed(1234)
    equal = 0
    for _ in range(32):
      af = fb.account(1, 10.0, fb.plan_step(1, deadline), {}, warming=True)
      ac = cb.account(1, 10.0, cb.plan_step(1, deadline), {}, warming=True)
      assert af["parallel_ms"] <= ac["parallel_ms"] + 1e-9
      equal += abs(af["parallel_ms"] - ac["parallel_ms"]) <= 1e-9
    if must_equal:
      assert equal == 32


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


ENGINES = [
    (dict(n_components=2, replicas=2), dict(policy="basic")),
    (dict(n_components=4, replicas=2, skew=1.2, route="rotate",
          alloc="topk"), dict(policy="fixed", fixed_budget=2)),
]


@pytest.mark.parametrize("engine", ENGINES,
                         ids=[e["policy"] for _, e in ENGINES])
def test_fleet_engine_generates_jax_ids(llama, engine):
  """Same weights, basis, requests and seeds: the same ids, budgets and
  replica selections, and every step's logits within 4e-5 of max|ref|."""
  ccfg, ekw = engine
  jcfg, jparams, cfg, params, basis = llama
  kw = dict(n_slots=2, prompt_len=64, max_new_tokens=3, deadline_ms=1e6,
            **ekw)
  jback = jfl.FleetStepBackend(jfl.FleetConfig(use_mesh=False, seed=0,
                                               **ccfg))
  jeng = JServingEngine(jcfg, JEngineConfig(impl="xla", **kw),
                        params=jparams, backend=jback)
  back = fl.FleetStepBackend(fl.FleetConfig(seed=0, **ccfg))
  eng = _port_engine(llama, back, **kw)
  sels = {}
  for b, key in ((back, "port"), (jback, "jax")):
    inner = b.account
    log = sels[key] = []

    def account(budget, wall, plan, st, warming=False, _inner=inner,
                _log=log):
      if not warming:
        _log.append(np.asarray(plan.sel).tolist())
      return _inner(budget, wall, plan, st, warming=warming)
    b.account = account
  jlog, log = [], []
  _record_jax(jeng, jlog)
  _record_port(eng, log)
  # Arrivals at 0: the queue, not the host clock, orders the admissions;
  # the draws restart from one seed after each engine's warm-up.
  arrivals = [0.0] * 4
  back.reseed(5)
  jback.reseed(5)
  jreqs = j_make_requests(arrivals, 64, 3, cfg.vocab, seed=3)
  jeng.run(jreqs)
  reqs = make_requests(arrivals, 64, 3, cfg.vocab, seed=3)
  eng.run(reqs)
  assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  assert sels["port"] == sels["jax"]
  assert len(log) == len(jlog) >= 3
  for got, want in zip(log, jlog):
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_fleet_and_autoscale_cli_on_cpu(tmp_path, capsys):
  """``--cluster 2 --fleet --replicas 2 --autoscale``: the engine window on
  the fleet tier, then 24 hours sized and simulated, with the JAX
  launcher's JSON keys."""
  out = launch.main(["--device", "cpu", "--smoke", "--cluster", "2",
                     "--fleet", "--replicas", "2", "--autoscale",
                     "--duration", "0.5", "--trace", "sogou_hourly",
                     "--hours", "21", "--rate-scale", "0.2", "--json",
                     str(tmp_path / "f.json")])
  text = capsys.readouterr().out
  assert "[fleet] N=2 (stacked" in text and "[hour23]" in text
  js = json.loads((tmp_path / "f.json").read_text())
  auto = js["autoscale"]
  assert set(auto) == {"p99_target_ms", "windows", "component_hours",
                       "component_hours_static"}
  assert len(auto["windows"]) == 24 and auto["component_hours_static"] == 96
  assert all(1 <= w["n"] <= 2 and 1 <= w["r"] <= 2
             for w in auto["windows"])
  assert out["results"]["hour21"]["n"] > 0
  for argv, match in ((["--fleet"], "--fleet needs --cluster"),
                      (["--cluster", "2", "--fleet", "--faults",
                        "crash=1@2"], "non-resilient"),
                      (["--autoscale"], "--autoscale requires")):
    with pytest.raises(SystemExit):
      launch.main(["--device", "cpu", *argv])
    assert match in capsys.readouterr().err
