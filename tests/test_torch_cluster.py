"""The port's scatter-gather cluster tier (stacked path) against the JAX
package's, on the CPU.

* ``dist.topology``: ``ComponentTopology.plan`` and ``plan_2d`` field by
  field over N in {1, 2, 4, 8}, skew in {0, 1.2}, R in {1, 2, 3} (R > N
  refused by both), and ``select_replica`` (exact: numpy).
* ``control.allocate_budget`` (torch, on the device in the step) gives
  JAX's integers on drawn masses with repeated values and zero caps, and
  keeps the conservation, cap and monotonicity laws of
  ``tests/test_control.py`` (exact).
* The frontend's ranking (``_frontend_rank``, ``gain_rank``,
  ``gain_budgets``, ``_select_local``) on score tables that hold repeated
  values: JAX's ``top_k`` breaks ties by the lower index, and so does the
  port's stable sort (exact).
* ``make_cluster_attention`` on the stacked path against JAX's (``impl=
  "xla"``), within 4e-5 of max|ref| in f32: every alloc, N in {1, 2, 4},
  skew, budgets 0 and 5, gather-mode vectors mixing FULL, STAGE1 and DROP,
  mode-aware caps, the contracts' telemetry, and an int8+kv arena; the
  per-layer telemetry ``fe_cover`` / ``fe_mass`` / ``est_profile`` too.
  The port's layout holds the component axis before the heads
  (``serve.cluster`` module doc): JAX's leaves are permuted first.
* ``ClusterStepBackend.write_slot``: the same B = 1 cache scattered by
  both backends gives the same pool (exact, after the permutation), for
  routes ``fixed`` and ``rotate`` and an int8+kv arena; a corpus-cache hit
  scatters its shared arena as a private build does.
* ``plan_step`` / ``account`` of both backends on the same scripted wall
  times and telemetry: equal plans (modes, hedges, retries, draws, fault
  worlds) and equal accounts (``parallel_ms``, ``step_acc``,
  ``drop_share``), with faults and without (exact: numpy float64); the
  measured export and the simulator it feeds, too.
* The cluster engine generates the JAX cluster engine's ids and budgets
  under ``basic`` and ``fixed`` at a 1e6 ms deadline (SMOKE llama3-8b in
  f32), a crash from step 0 included; the CLI's ``--cluster`` run.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.configs.registry import get_config as j_get_config
from repro.control import DeadlineBudgetPolicy as JPolicy
from repro.control import allocate_budget as j_allocate_budget
from repro.dist import topology as jtopo
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import cluster as jcl
from repro.serve import kv_cache as jkvc
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import run_open_loop as j_run_open_loop
from repro.serve.resilience import parse_fault_spec as j_parse_fault_spec
from repro.serving.service import ScatterGatherService as JService
from repro.serving.service import ServiceConfig as JServiceConfig
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.control import DeadlineBudgetPolicy, allocate_budget
from repro_torch.dist import topology
from repro_torch.launch import serve as launch
from repro_torch.serve import cluster as cl
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                      make_requests, run_open_loop)
from repro_torch.serve.resilience import parse_fault_spec
from repro_torch.serving.service import ScatterGatherService, ServiceConfig

B, Hkv, G, D, S, C = 2, 2, 2, 16, 256, 16
H, M = Hkv * G, S // C
SM = float(1.0 / np.sqrt(D))
TOL = 4e-5          # of max|ref|: the f32 floor of the port's parity tests


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- topology ------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("skew", [0.0, 1.2])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_topology_plans_match_jax(n, skew, R):
  for m_total in (16, 64):
    for plan, jplan in ((topology.ComponentTopology.plan,
                         jtopo.ComponentTopology.plan),
                        (topology.plan_2d, jtopo.plan_2d)):
      args = (m_total, n, skew, R) if plan is not topology.plan_2d \
          else (m_total, n, R, skew)
      if R > n:
        for fn in (plan, jplan):
          with pytest.raises(ValueError):
            fn(*args)
        continue
      got, want = plan(*args), jplan(*args)
      assert (got.n_components, got.m_total, got.counts, got.skew,
              got.replicas, got.m_max, got.offsets) == \
          (want.n_components, want.m_total, want.counts, want.skew,
           want.replicas, want.m_max, want.offsets)
      np.testing.assert_array_equal(got.shares, want.shares)
      np.testing.assert_array_equal(got.cluster_owner(),
                                    want.cluster_owner())
      np.testing.assert_array_equal(got.replica_owners(),
                                    want.replica_owners())
      np.testing.assert_array_equal(got.shard_grid(), want.shard_grid())
      for c in range(n):
        for r in range(R):
          assert got.replica_owner(c, r) == want.replica_owner(c, r)
          assert got.shard_at(r, c) == want.shard_at(r, c)
  np.testing.assert_array_equal(topology.zipf_weights(n, skew),
                                jtopo.zipf_weights(n, skew))


def test_select_replica_matches_jax():
  rng = np.random.default_rng(0)
  for _ in range(20):
    t = rng.uniform(1.0, 5.0, (3, 4)).round(1)     # ties included
    alive = rng.random((3, 4)) > 0.3
    alive[0] = True
    np.testing.assert_array_equal(topology.select_replica(t),
                                  jtopo.select_replica(t))
    np.testing.assert_array_equal(topology.select_replica(t, alive),
                                  jtopo.select_replica(t, alive))
  with pytest.raises(ValueError):
    topology.select_replica(np.ones((2, 2)), np.zeros((2, 2), bool))


# -- allocate_budget -----------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(n=hst.integers(1, 8), total=hst.integers(0, 40),
       recirc=hst.booleans(), data=hst.data())
def test_allocate_budget_matches_jax(n, total, recirc, data):
  """Equal integers on masses drawn from a few values (repeated masses
  tie the largest-remainder ranks) and caps with zeros; the laws."""
  rows = data.draw(hst.integers(1, 3))
  vals = data.draw(hst.lists(hst.sampled_from(
      [0.0, 0.25, 1.0, 1.0, 3.0, 7.5, 1e-20]), min_size=rows * n,
      max_size=rows * n))
  caps = np.asarray(data.draw(hst.lists(hst.integers(0, 9),
                                        min_size=rows * n,
                                        max_size=rows * n)),
                    np.int32).reshape(rows, n)
  mass = np.asarray(vals, np.float32).reshape(rows, n)
  got = allocate_budget(torch.from_numpy(mass), total,
                        torch.from_numpy(caps), recirculate=recirc).numpy()
  want = np.asarray(j_allocate_budget(jnp.asarray(mass), total,
                                      jnp.asarray(caps), recirculate=recirc))
  np.testing.assert_array_equal(got, want)
  assert (got >= 0).all() and (got <= caps).all()
  if recirc:
    np.testing.assert_array_equal(got.sum(-1),
                                  np.minimum(total, caps.sum(-1)))


def test_allocate_budget_laws():
  rng = np.random.default_rng(3)
  for _ in range(20):
    mass = rng.uniform(0.1, 10.0, (1, 6)).astype(np.float32)
    out = allocate_budget(torch.from_numpy(mass), 12,
                          torch.full((1, 6), 4)).numpy()[0]
    order = np.argsort(mass[0])
    assert (np.diff(out[order]) >= 0).all(), (mass, out)  # monotone in mass
  out = allocate_budget(torch.tensor([[10.0, 1.0, 1.0]]), 9,
                        torch.tensor([[2, 8, 8]]), recirculate=False)
  assert out.tolist() == [[2, 1, 1]]          # cap-and-drop strands 5
  out = allocate_budget(torch.tensor([[10.0, 1.0, 1.0]]), 9,
                        torch.tensor([[2, 8, 8]]))
  assert out.sum() == 9 and out[0, 0] == 2
  out = allocate_budget(torch.tensor([[5.0, 0.0]]), 6, torch.tensor([[1, 10]]))
  assert out.tolist() == [[1, 5]]
  out = allocate_budget(torch.tensor([[1.0, 2.0, 1.0]]), 8,
                        torch.full((1, 3), 8))
  assert out.tolist() == [[2, 4, 2]]          # proportional when it divides


# -- the frontend's ranking, ties included -------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_frontend_ranking_ties_match_jax(seed):
  rng = np.random.default_rng(seed)
  N, Mp = int(rng.integers(1, 5)), int(rng.integers(2, 7))
  sc = rng.choice(np.asarray([-1.0, 0.0, 0.5, 2.0], np.float32),
                  (B, Hkv, N, Mp))
  sc[:, :, :, Mp - 1] = jref.NEG_INF if Mp > 2 else sc[:, :, :, Mp - 1]
  counts = rng.choice(np.asarray([0.0, 4.0, 16.0], np.float32), (B, N, Mp))
  st, ct = torch.from_numpy(sc), torch.from_numpy(counts)
  for i_max in (0, 1, 3, N * Mp + 2):
    gsel, mass = cl._frontend_rank(st, i_max)
    jgsel, jmass = jcl._frontend_rank(jnp.asarray(sc), i_max)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-6)
    if i_max == 0:
      assert gsel is None and jgsel is None
      continue
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(jgsel))
    g = cl.gain_rank(st, ct, i_max)
    jg = jcl.gain_rank(jnp.asarray(sc), jnp.asarray(counts), i_max)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(cl.gain_budgets(g, Mp, N).numpy(),
                                  np.asarray(jcl.gain_budgets(jg, Mp, N)))
    caps = (st > jref.NEG_INF / 2).sum(-1)
    budgets = allocate_budget(mass, i_max, caps)
    jbudgets = j_allocate_budget(jmass, i_max, jnp.asarray(caps.numpy()))
    np.testing.assert_array_equal(budgets.numpy(), np.asarray(jbudgets))
    for alloc in ("mass", "topk", "gain"):
      gs = g if alloc == "gain" else gsel
      got = cl._select_local(st.permute(0, 2, 1, 3), gs, budgets, alloc,
                             i_max, Mp)
      for c in range(N):
        want = jcl._select_local(c, jnp.asarray(sc[:, :, c]),
                                 jnp.asarray(gs.numpy()), jbudgets, alloc,
                                 i_max, Mp)
        np.testing.assert_array_equal(got[:, c].numpy(), np.asarray(want))


# -- the attention body --------------------------------------------------------

def _inputs(seed, quant=None):
  """JAX inputs of one layer: the query, a cluster-contiguous cache slice
  (int8+kv: the quantized arena of JAX's build oracle) and the self KV."""
  ks = jax.random.split(jax.random.PRNGKey(seed), 8)
  q = jax.random.normal(ks[0], (B, H, D), jnp.float32)
  k = jax.random.normal(ks[1], (B, Hkv, S, D), jnp.float32)
  v = jax.random.normal(ks[2], (B, Hkv, S, D), jnp.float32)
  cache = {
      "recent_k": jax.random.normal(ks[3], (B, Hkv, 16, D), jnp.float32),
      "recent_v": jax.random.normal(ks[4], (B, Hkv, 16, D), jnp.float32),
      "recent_len": jnp.asarray([5, 11], jnp.int32),
  }
  if quant is None:
    cache.update(k=k, v=v, counts=jnp.full((B, M), float(C)),
                 k_syn=k.reshape(B, Hkv, M, C, D).mean(3),
                 v_syn=v.reshape(B, Hkv, M, C, D).mean(3))
  else:
    perm = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cache.update(jref.synopsis_build_quant_ref(
        k, v, perm, cluster_size=C, qc=jquant.parse_qconfig(quant)))
  kd = jax.random.normal(ks[5], (B, Hkv, 1, D), jnp.float32)
  vd = jax.random.normal(ks[6], (B, Hkv, 1, D), jnp.float32)
  return q, cache, (kd, vd)


def _scatter(cache, topo):
  """JAX's component layout of one layer's slice (B, Hkv, N, m_max*, ...),
  padded with zeros (counts 0 on the pads)."""
  Mp = topo.m_max
  out = {n: cache[n] for n in ("recent_k", "recent_v", "recent_len")}
  for name in ("k", "v", "k_syn", "v_syn", "counts", "k_syn_scale",
               "v_syn_scale", "k_scale", "v_scale"):
    if name not in cache:
      continue
    unit = C if name in ("k", "v") else 1
    axis = 1 if name == "counts" else 2
    parts = []
    for c in range(topo.n_components):
      off, cnt = topo.offsets[c] * unit, topo.counts[c] * unit
      sl = jax.lax.slice_in_dim(cache[name], off, off + cnt, axis=axis)
      widths = [(0, 0)] * sl.ndim
      widths[axis] = (0, Mp * unit - cnt)
      parts.append(jnp.pad(sl, widths))
    out[name] = jnp.stack(parts, axis=axis)
  return out


def _port_slice(csl):
  """JAX's layer slice -> the port's: the component axis before the heads
  (contiguous, as the pool holds it)."""
  out = {}
  for name, x in csl.items():
    t = bridge.arena_from_numpy({name: np.asarray(x)}, "cpu")[name]
    if name not in ("counts", "recent_k", "recent_v", "recent_len",
                    "fe_mode"):
      t = t.movedim(2, 1).contiguous()
    out[name] = t
  return out


def _modes(kind, n):
  if kind == "full":
    return np.full((n,), cl.MODE_FULL, np.int32)
  if kind == "drop":
    return np.full((n,), cl.MODE_DROP, np.int32)
  # A mix: FULL, STAGE1 and DROP in turn from component 1 on.
  return np.asarray([cl.MODE_FULL] + [(cl.MODE_STAGE1, cl.MODE_DROP,
                                       cl.MODE_FULL)[i % 3]
                                      for i in range(n - 1)], np.int32)


CASES = [
    # (alloc, n, skew, modes, i_max, mode_caps, telemetry, quant)
    ("topk", 1, 0.0, "full", 5, False, False, None),
    ("topk", 2, 0.0, "full", 5, False, False, None),
    ("topk", 4, 1.2, "mixed", 5, False, True, None),
    ("mass", 1, 0.0, "full", 5, False, False, None),
    ("mass", 2, 1.2, "mixed", 5, False, False, None),
    ("mass", 4, 0.0, "full", 5, False, True, None),
    ("mass", 4, 1.2, "mixed", 5, True, False, None),
    ("gain", 2, 0.0, "full", 5, False, True, None),
    ("gain", 4, 1.2, "mixed", 5, False, False, None),
    ("mass", 4, 1.2, "mixed", 0, False, True, None),
    ("topk", 4, 0.0, "drop", 5, False, False, None),
    ("mass", 4, 1.2, "mixed", 5, True, True, "int8+kv"),
    ("topk", 2, 0.0, "full", 5, False, False, "int8+kv"),
    ("gain", 4, 0.0, "mixed", 5, False, False, "int8"),
]


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_cluster_attention_matches_jax(case):
  alloc, n, skew, modes, i_max, mode_caps, tele, quant = case
  q, cache, (kd, vd) = _inputs(n + int(skew * 10), quant)
  topo = jtopo.ComponentTopology.plan(M, n, skew)
  csl = _scatter(cache, topo)
  csl["fe_mode"] = jnp.asarray(_modes(modes, n))
  jattn = jcl.make_cluster_attention(topo, alloc=alloc, mesh=None,
                                     mode_caps=mode_caps, telemetry=tele)
  want, jaux = jattn(q, csl, i_max=i_max, cluster_size=C, sm_scale=SM,
                     self_kv=(kd, vd), impl="xla")
  attn = cl.make_cluster_attention(topology.ComponentTopology.plan(
      M, n, skew), alloc=alloc, mode_caps=mode_caps, telemetry=tele)
  t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
  got, aux = attn(t(q), _port_slice(csl), i_max=i_max, cluster_size=C,
                  sm_scale=SM, self_kv=(t(kd), t(vd)))
  want = np.asarray(want)
  err = np.abs(got.numpy() - want).max()
  assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())
  np.testing.assert_array_equal(aux["fe_cover"].numpy(),
                                np.asarray(jaux["fe_cover"]))
  np.testing.assert_allclose(aux["fe_mass"].numpy(),
                             np.asarray(jaux["fe_mass"]), atol=1e-6)
  assert set(aux) == set(jaux)
  if tele:
    np.testing.assert_allclose(aux["est_profile"].numpy(),
                               np.asarray(jaux["est_profile"]), atol=1e-6)


def test_topk_full_gather_is_the_single_component_attention():
  """alloc="topk" with every component FULL is the single-component
  synopsis attention over the concatenated corpus (the port's own)."""
  from repro_torch.serve.serve_step import synopsis_decode_attention
  q, cache, (kd, vd) = _inputs(0)
  t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
  ref = synopsis_decode_attention(
      t(q), {k: t(x) for k, x in cache.items()}, i_max=4, cluster_size=C,
      sm_scale=SM, self_kv=(t(kd), t(vd)))
  for n, skew in ((2, 0.0), (4, 1.2)):
    topo = topology.ComponentTopology.plan(M, n, skew)
    csl = _scatter(cache, topo)
    csl["fe_mode"] = jnp.asarray(_modes("full", n))
    got, aux = cl.make_cluster_attention(topo, alloc="topk")(
        t(q), _port_slice(csl), i_max=4, cluster_size=C, sm_scale=SM,
        self_kv=(t(kd), t(vd)))
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    assert float(aux["fe_cover"].sum()) == pytest.approx(4.0)


def test_sharded_path_and_strided_shards_are_refused():
  """A mesh that is not the port's ``Mesh`` is a ``TypeError`` (the
  sharded path runs on ranks; ``tests/test_torch_mesh_tiers.py`` drives
  it on a spawned world); a bad alloc and a strided shard are refused."""
  topo = topology.ComponentTopology.plan(M, 2)
  with pytest.raises(TypeError, match="Mesh"):
    cl.make_cluster_attention(topo, mesh=object())
  with pytest.raises(ValueError, match="alloc"):
    cl.make_cluster_attention(topo, alloc="nope")
  # A shard in JAX's layout (heads before components) is not a view of
  # B*N rows: the body refuses it instead of copying it.
  q, cache, kv = _inputs(1)
  csl = _scatter(cache, jtopo.ComponentTopology.plan(M, 2))
  csl["fe_mode"] = jnp.asarray(_modes("full", 2))
  port = _port_slice(csl)
  port["k"] = port["k"].transpose(1, 2).contiguous().transpose(1, 2)
  with pytest.raises(RuntimeError, match="view"):
    cl.make_cluster_attention(topo)(
        torch.from_numpy(np.array(q)), port, i_max=4, cluster_size=C,
        sm_scale=SM)


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


def _bound(llama, ccfg_kw, *, policy="accuracytrader", n_slots=2,
           prompt_len=64, contract="deadline", quant=None):
  """Both backends bound to a stand-in engine (the attributes ``bind``
  and ``plan_step`` read), with the policy sharing the backend's
  predictor as the engines build it."""
  jcfg, _, cfg, _, _ = llama
  jcfg, cfg = _quant(jcfg, quant), _quant(cfg, quant)
  out = []
  for mod, Policy, c, extra in ((cl, DeadlineBudgetPolicy, cfg,
                                 {"dev": torch.device("cpu")}),
                                (jcl, JPolicy, jcfg, {"impl": "xla"})):
    kw = dict(ccfg_kw)
    if mod is jcl:
      kw["use_mesh"] = False
      if "faults" in kw:
        kw["faults"] = j_parse_fault_spec(kw["faults"])
    elif "faults" in kw:
      kw["faults"] = parse_fault_spec(kw["faults"])
    backend = mod.ClusterStepBackend(mod.ClusterConfig(**kw))
    M_ = prompt_len // c.synopsis.cluster_size
    eng = types.SimpleNamespace(
        cfg=c, M=M_, accuracy_fn=None, ecfg=types.SimpleNamespace(
            n_slots=n_slots, prompt_len=prompt_len, contract=contract),
        **extra)
    from repro.serving.service import _default_concentration
    eng.accuracy_fn = _default_concentration
    backend.bind(eng)
    buckets = (0, 1, 2, 4)
    eng.controller = Policy(policy=policy, buckets=buckets, i_max_cap=M_,
                            predictor=backend.predictor)
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


@pytest.mark.parametrize("route,skew,quant", [
    ("fixed", 0.0, None), ("rotate", 1.2, None), ("fixed", 1.2, "int8+kv"),
    ("rotate", 0.0, "int8+kv")])
def test_write_slot_scatter_matches_jax(llama, route, skew, quant):
  backend, jbackend = _bound(llama, dict(n_components=4, skew=skew,
                                         route=route), quant=quant)
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
      want = want.movedim(4, 3)         # JAX: (nb, na, B, Hkv, N, ...)
    assert leaf.shape == want.shape, name
    assert torch.equal(leaf, want.to(leaf.dtype)), name


def _port_engine(llama, backend, **kw):
  _, _, cfg, params, basis = llama
  return ServingEngine(cfg, EngineConfig(**kw), params=params,
                       pca_basis=basis, device="cpu", backend=backend)


def test_cache_shared_arena_shards_as_a_private_build(llama):
  """A corpus-cache hit scatters the shared (pre-scatter) arena into its
  lane as the miss's private build was scattered: equal lanes, and equal
  to a cache-off engine's two private builds."""
  cfg = llama[2]
  lanes = {}
  for cache_on in (True, False):
    eng = _port_engine(
        llama, cl.ClusterStepBackend(cl.ClusterConfig(n_components=2,
                                                      skew=1.2)),
        n_slots=2, prompt_len=64, max_new_tokens=2, policy="fixed",
        fixed_budget=1, cache=CacheConfig(capacity=8, delta_unit=16)
        if cache_on else None)
    reqs = make_requests([0.0, 0.0], 64, 2, cfg.vocab, seed=9)
    reqs[1].prompt = reqs[0].prompt.copy()
    eng._admit(reqs[0], 0)
    eng._admit(reqs[1], 1)
    if cache_on:
      st = eng.corpus_cache.stats()
      assert st["misses"] == 1 and st["hits"] == 1 and eng.prefills == 1
    lanes[cache_on] = {name: eng.cache[name].clone()
                       for name in kvc.ARENA_LEAVES if name in eng.cache}
  for name, leaf in lanes[True].items():
    assert torch.equal(leaf[:, :, 0], leaf[:, :, 1]), name
    assert torch.equal(leaf, lanes[False][name]), name
    # Every cluster routed once: M clusters of C tokens a lane.
  counts = lanes[True]["counts"]
  assert float(counts[0, 0, 0].sum()) == 64.0
  assert int((counts[0, 0, 0] > 0).sum()) == 4


SCRIPTS = [
    # (backend config, policy)
    (dict(n_components=4, skew=1.2, replicas=2), "accuracytrader"),
    (dict(n_components=4, skew=1.2, route="rotate"), "partial"),
    (dict(n_components=4, replicas=3, retries=3,
          faults="crash=1@3+2@9,stall_rate=0.1,slow_rate=0.05,seed=3"),
     "accuracytrader"),
    (dict(n_components=2, faults="crash=1@2,seed=1", recovery=False),
     "partial"),
    (dict(n_components=4, replicas=2, alloc="gain",
          faults="crash_rate=0.05,down_steps=3,seed=2"), "basic"),
]


@pytest.mark.parametrize("script", SCRIPTS,
                         ids=[f"{i}-{p}" for i, (_, p) in enumerate(SCRIPTS)])
def test_plan_and_account_match_jax(llama, script):
  ccfg, policy = script
  backend, jbackend = _bound(llama, ccfg, policy=policy)
  rng = np.random.default_rng(len(ccfg))
  for b in (backend, jbackend):
    b.reseed(7)
  N = ccfg["n_components"]
  for step in range(40):
    budget = (0, 1, 2, 4)[step % 4]
    deadline = float("inf") if step % 5 == 0 else float(
        rng.uniform(0.2, 3.0))
    plan, jplan = backend.plan_step(budget, deadline), \
        jbackend.plan_step(budget, deadline)
    np.testing.assert_array_equal(plan.mode, jplan.mode)
    np.testing.assert_array_equal(plan.mode, np.asarray(jplan.fe_mode))
    for name in ("noise", "noise2", "hedged", "b_est", "retries",
                 "noise_r", "delays", "alive", "slow"):
      g, w = getattr(plan, name), getattr(jplan, name)
      assert (g is None) == (w is None), name
      if g is not None:
        np.testing.assert_array_equal(g, w, err_msg=name)
    wall = float(rng.uniform(1.0, 6.0))
    st = {"fe_cover": rng.uniform(0.0, 3.0, (2, 1, N)),
          "fe_mass": rng.dirichlet(np.ones(N), (2, 1))}
    warming = step < 2
    got = backend.account(budget, wall, plan, st, warming=warming)
    want = jbackend.account(budget, wall, jplan, st, warming=warming)
    assert set(got) == set(want)
    for k in got:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  assert backend.fault_stats == jbackend.fault_stats
  np.testing.assert_array_equal(backend.mass_ewma, jbackend.mass_ewma)
  exp, jexp = backend.export(), jbackend.export()
  for budget in (0, 13, 50, 100):
    np.testing.assert_array_equal(exp.step_ms_per_component(budget),
                                  jexp.step_ms_per_component(budget))
    assert exp.step_ms(budget) == jexp.step_ms(budget)
  kw = dict(n_components=N, technique="accuracytrader", deadline_ms=30.0,
            seed=0)
  assert ScatterGatherService(ServiceConfig(**kw), step_backend=exp) \
      .run_open_loop(40.0, 1.0) == JService(
          JServiceConfig(**kw), step_backend=jexp).run_open_loop(40.0, 1.0)


ENGINES = [
    (dict(n_components=2), dict(policy="basic")),
    (dict(n_components=4, skew=1.2, route="rotate", alloc="topk"),
     dict(policy="fixed", fixed_budget=2)),
    (dict(n_components=4, skew=1.2, alloc="gain", replicas=2),
     dict(policy="fixed", fixed_budget=1)),
    (dict(n_components=2, faults="crash=1@0,seed=4"), dict(policy="basic")),
    (dict(n_components=4, skew=1.2), dict(policy="fixed", fixed_budget=2,
                                          contract="deadline_with_bound")),
]


@pytest.mark.parametrize("engine", ENGINES,
                         ids=[f"{i}-{e['policy']}"
                              for i, (_, e) in enumerate(ENGINES)])
def test_cluster_engine_generates_jax_ids(llama, engine):
  """Same weights, basis, requests and seeds: the same ids and budgets,
  every request, every step.  A crash from step 0 drops component 1 on
  every step in both (basic has no fallback: nothing answers for it)."""
  ccfg, ekw = engine
  jcfg, jparams, cfg, params, basis = llama
  kw = dict(n_slots=2, prompt_len=64, max_new_tokens=3, deadline_ms=1e6,
            **ekw)
  jfaults = dict(ccfg)
  if "faults" in ccfg:
    jfaults["faults"] = j_parse_fault_spec(ccfg["faults"])
    ccfg = dict(ccfg, faults=parse_fault_spec(ccfg["faults"]))
  jeng = JServingEngine(jcfg, JEngineConfig(impl="xla", **kw),
                        params=jparams, backend=jcl.ClusterStepBackend(
                            jcl.ClusterConfig(use_mesh=False, **jfaults)))
  js = j_run_open_loop(jeng, 6.0, 1.0, seed=3)
  eng = _port_engine(llama, cl.ClusterStepBackend(cl.ClusterConfig(**ccfg)),
                     **kw)
  s = run_open_loop(eng, 6.0, 1.0, seed=3)
  reqs = sorted(eng.completed, key=lambda r: r.rid)
  jreqs = sorted(jeng.completed, key=lambda r: r.rid)
  assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  # The gather modes (hence the dropped mass) are the same; a step's
  # accuracy is not compared: its coverage is a mean over every lane of
  # the step, so it follows which requests shared it, which the host
  # clock decides.
  assert [r.step_drop for r in reqs] == [r.step_drop for r in jreqs]
  assert set(s) == set(js)
  for k in ("n", "served_n", "prefills", "availability_pct",
            "mean_budget"):
    assert s[k] == js[k], k


def test_cluster_engine_serves_and_exports(llama):
  """accuracytrader at a tight deadline: every step reports a corpus-
  share-weighted accuracy, the shared predictor is calibrated by the
  backend alone, and the export feeds the simulator."""
  backend = cl.ClusterStepBackend(cl.ClusterConfig(n_components=2, seed=0))
  eng = _port_engine(llama, backend, n_slots=2, prompt_len=64,
                     max_new_tokens=3, deadline_ms=60.0)
  assert eng.controller.predictor is backend.predictor
  s = run_open_loop(eng, rate_per_s=30.0, duration_s=0.4, seed=5)
  assert s["n"] > 0 and s["n"] == len(eng.completed)
  for r in eng.completed:
    assert len(r.step_acc) == len(r.budgets)
    assert all(0.0 <= a <= 1.0 for a in r.step_acc)
    assert r.accuracy == pytest.approx(float(np.mean(r.step_acc)))
  assert backend.predictor.table()
  exp = backend.export()
  vec = exp.step_ms_per_component(50)
  assert vec.shape == (2,) and (vec > 0).all()
  svc = ScatterGatherService(ServiceConfig(
      n_components=2, deadline_ms=100.0, seed=0), step_backend=exp)
  assert svc.run_open_loop(20.0, 1.0)["n"] > 0
  assert eng.probe_step_ms(eng.buckets[-1], iters=1) > 0.0


def test_backend_refusals(llama):
  cfg, params = llama[2], llama[3]
  for ccfg, err, match in (
      (dict(n_components=2, alloc="nope"), ValueError, "alloc"),
      (dict(n_components=2, route="nope"), ValueError, "route"),
      (dict(n_components=8), ValueError, "n_components"),
      (dict(n_components=2, replicas=3), ValueError, "replicas"),
      # A world of one rank has no mesh of 2: JAX's error with fewer
      # devices.
      (dict(n_components=2, use_mesh=True), RuntimeError,
       "use_mesh=True but the world has 1 < 2 ranks")):
    with pytest.raises(err, match=match):
      ServingEngine(cfg, EngineConfig(n_slots=1, prompt_len=64,
                                      max_new_tokens=2), params=params,
                    device="cpu",
                    backend=cl.ClusterStepBackend(cl.ClusterConfig(**ccfg)))


def test_cluster_cli_on_cpu(tmp_path, capsys):
  """``--cluster 2`` alone takes the engine path on the stacked tier, with
  the ``[cluster]`` and ``[faults]`` lines and the JAX launcher's JSON
  keys."""
  out = launch.main(["--device", "cpu", "--smoke", "--cluster", "2",
                     "--faults", "crash=1@2", "--replicas", "2",
                     "--duration", "1", "--trace", "sogou_hourly",
                     "--hours", "21", "--rate-scale", "0.2", "--json",
                     str(tmp_path / "c.json")])
  text = capsys.readouterr().out
  assert "[cluster] N=2 (stacked" in text and "  [faults] {" in text
  assert "[cluster] measured per-component ms at full budget" in text
  js = json.loads((tmp_path / "c.json").read_text())
  assert set(js["cluster"]) == {"n_components", "skew", "alloc", "route",
                                "counts", "comp_ms_full"}
  assert js["cluster"]["counts"] == [8, 8] and out["results"]["hour21"]["n"]
