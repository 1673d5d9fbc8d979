"""The port's sharded cluster and fleet tiers and its mesh train step, each
on a world of 4 spawned gloo ranks (``dist.world.run_world``; the rank
bodies are ``tests/torch_mesh_ranks.py``, which import no JAX), against
the JAX package's stacked computations of the same functions and the
port's own stacked path, on the CPU.

The JAX package's sharded tier tests are red on this JAX version
(``shard_map`` raises on ``axis_names``, ROADMAP C), so the port holds its
sharded tiers to what those tests assert the sharded paths equal: JAX's
stacked ``make_cluster_attention(mesh=None)`` / ``make_fleet_attention(
mesh=None)``.

* Cluster tier, N = 4 (one rank a component): ``make_cluster_attention(
  mesh=...)`` under ``mass``, ``topk`` and ``gain`` with a FULL / STAGE1 /
  DROP mix and the contracts' telemetry, mode-aware caps on an int8+kv
  arena, and budget 0: the context within 4e-5 of max|ref| of JAX's
  stacked body and equal to the port's stacked body bit for bit
  (``torch.equal``: the plain versions give the same bits on B rows as on
  the stacked path's B*N), ``fe_cover`` equal, ``fe_mass`` and
  ``est_profile`` within 1e-6; every rank returns the same bits.  The
  SMOKE cluster engine (llama3-8b, f32, ``use_mesh=True``, eager steps,
  rank 0's plans and walls broadcast) gives the stacked engine's ids,
  budgets and dropped mass under ``basic`` and ``fixed``.
* Fleet tier, R = 2, N = 2 (one rank a lane): every replica selection's
  output equal to the all-primary one bit for bit, and that within 4e-5
  of max|ref| of JAX's stacked fleet body and equal to the port's stacked
  one; the SMOKE fleet engine's ids as the stacked fleet engine's.
* Train step on (pod 2, data 2) with ``compress_pods=True``: two steps
  equal to the port's one-rank step over the same shares as microbatches
  followed by ``local_quantise_feedback`` (itself held to JAX's in
  ``tests/test_torch_train.py``), within 4e-5 of max|ref| in parameters,
  moments and error buffers; ``compressed_pod_psum`` alone equal to
  ``local_quantise_feedback``; deepseek's SMOKE MoE gradients on the mesh
  within 4e-5 of max|ref| of the mean of JAX's per-shard gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs.registry import get_config as j_get_config
from repro.dist import topology as jtopo
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import cluster as jcl
from repro.serve import fleet as jfl
from repro.serve import kv_cache as jkvc
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.control import MODE_DROP, MODE_FULL, MODE_STAGE1
from repro_torch.dist import topology, world
from repro_torch.models.common import leaves
from repro_torch.serve import cluster as cl
from repro_torch.serve import fleet as fl
from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                      run_open_loop)
from repro_torch.train import compression as comp
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import OptConfig, adamw_update, tree_map
from repro_torch.train.train_step import init_train_state, loss_and_grads

B, Hkv, G, D, C = 2, 2, 2, 16, 16
H, M = Hkv * G, 16
S = M * C
SM = float(1.0 / np.sqrt(D))
TOL = 4e-5          # of max|ref|: the f32 floor of the port's parity tests
JOIN_S = 120.0
ARENA = ("k", "v", "k_syn", "v_syn", "counts", "k_syn_scale", "v_syn_scale",
         "k_scale", "v_scale")


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(x):
  return torch.from_numpy(np.array(x))


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _arena(seed, quant):
  """One layer's cluster-contiguous arena (JAX's build oracle under a
  quant spec), the recent ring, the query and the self KV."""
  ks = jax.random.split(jax.random.PRNGKey(seed), 8)
  k = jax.random.normal(ks[1], (B, Hkv, S, D), jnp.float32)
  v = jax.random.normal(ks[2], (B, Hkv, S, D), jnp.float32)
  ring = {"recent_k": jax.random.normal(ks[3], (B, Hkv, 16, D)),
          "recent_v": jax.random.normal(ks[4], (B, Hkv, 16, D)),
          "recent_len": jnp.asarray([5, 11], jnp.int32)}
  if quant is None:
    arena = dict(k=k, v=v, counts=jnp.full((B, M), float(C)),
                 k_syn=k.reshape(B, Hkv, M, C, D).mean(3),
                 v_syn=v.reshape(B, Hkv, M, C, D).mean(3))
  else:
    perm = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    arena = jref.synopsis_build_quant_ref(k, v, perm, cluster_size=C,
                                          qc=jquant.parse_qconfig(quant))
  q = jax.random.normal(ks[0], (B, H, D), jnp.float32)
  kd = jax.random.normal(ks[5], (B, Hkv, 1, D), jnp.float32)
  vd = jax.random.normal(ks[6], (B, Hkv, 1, D), jnp.float32)
  return q, arena, ring, (kd, vd)


def _components(arena, topo):
  """JAX's component layout of the arena leaves: (B, Hkv, N, m_max*, ...)
  and counts (B, N, m_max), zero on the pads."""
  Mp, out = topo.m_max, {}
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
    out[name] = jnp.stack(parts, axis=axis)
  return out


def _port_layout(csl, lead):
  """JAX's layout -> the port's stacked pool layout: the component (and
  replica) axes before the heads; ``lead`` of them."""
  out = {}
  for name, x in csl.items():
    t = bridge.arena_from_numpy({name: np.asarray(x)}, "cpu")[name]
    if name in ARENA and name != "counts":
      t = t.movedim(1, 1 + lead).contiguous()
    out[name] = t
  return out


def _host(tree):
  """Port tensors -> numpy (int8 and f32 leaves) for the ranks."""
  return {k: v.numpy() for k, v in tree.items()}


# -- the cluster tier -----------------------------------------------------------------

def _modes(kind, n=4):
  if kind == "full":
    return np.full((n,), MODE_FULL, np.int32)
  return np.asarray([MODE_FULL, MODE_STAGE1, MODE_FULL, MODE_DROP][:n],
                    np.int32)


CL_CASES = [
    # (alloc, skew, modes, i_max, mode_caps, telemetry, quant)
    ("mass", 1.2, "mixed", 5, False, True, None),
    ("topk", 0.0, "mixed", 5, False, True, None),
    ("gain", 1.2, "mixed", 5, False, True, None),
    ("topk", 0.0, "full", 5, False, False, None),
    ("mass", 1.2, "mixed", 5, True, True, "int8+kv"),
    ("mass", 0.0, "mixed", 0, False, True, None),
]
CL_ENGINES = [
    (dict(n_components=4, skew=1.2), dict(policy="basic")),
    (dict(n_components=4, alloc="topk"), dict(policy="fixed",
                                              fixed_budget=2)),
]
FL_CASES = [(0.0, "mass", None), (1.2, "topk", None), (1.2, "gain", None),
            (0.0, "mass", "int8+kv")]
FL_SELECTIONS = [[0, 0], [1, 0], [0, 1], [1, 1]]
FL_ENGINES = [
    (dict(n_components=2, replicas=2), dict(policy="basic")),
    (dict(n_components=2, replicas=2, skew=1.2, route="rotate",
          alloc="gain"), dict(policy="fixed", fixed_budget=2)),
]
ENGINE_KW = dict(n_slots=2, prompt_len=64, max_new_tokens=3,
                 deadline_ms=1e6)
ENGINE_WINDOW = (6.0, 1.0, 3)       # rate, seconds, seed


@pytest.fixture(scope="module")
def llama():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params_np = _np(jparams)
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32))
  return cfg, params_np, basis


def _stacked_engines(llama, engines, backend_of):
  """The port's stacked engines (a world of one) on the same windows."""
  cfg, params_np, basis = llama
  params = bridge.params_from_numpy(params_np, cfg, "cpu")
  out = []
  for ccfg, ekw in engines:
    eng = ServingEngine(cfg, EngineConfig(**ENGINE_KW, **ekw), params=params,
                        pca_basis=torch.from_numpy(basis), device="cpu",
                        backend=backend_of(ccfg))
    assert eng.backend.mesh is None
    run_open_loop(eng, *ENGINE_WINDOW[:2], seed=ENGINE_WINDOW[2])
    reqs = sorted(eng.completed, key=lambda r: r.rid)
    out.append({"tokens": [r.tokens for r in reqs],
                "budgets": [r.budgets for r in reqs],
                "step_drop": [r.step_drop for r in reqs]})
  return out


@pytest.fixture(scope="module")
def cluster_run(llama):
  cases, want = [], []
  for i, (alloc, skew, modes, i_max, caps, tele, quant) in \
      enumerate(CL_CASES):
    q, arena, ring, (kd, vd) = _arena(10 + i, quant)
    jt = jtopo.ComponentTopology.plan(M, 4, skew)
    csl = dict(_components(arena, jt), **ring)
    csl["fe_mode"] = jnp.asarray(_modes(modes))
    jctx, jaux = jcl.make_cluster_attention(
        jt, alloc=alloc, mesh=None, mode_caps=caps, telemetry=tele)(
            q, csl, i_max=i_max, cluster_size=C, sm_scale=SM,
            self_kv=(kd, vd), impl="xla")
    port = _port_layout(csl, 1)
    topo = topology.ComponentTopology.plan(M, 4, skew)
    sctx, saux = cl.make_cluster_attention(
        topo, alloc=alloc, mode_caps=caps, telemetry=tele)(
            _t(q), port, i_max=i_max, cluster_size=C, sm_scale=SM,
            self_kv=(_t(kd), _t(vd)))
    want.append({"jax": (np.asarray(jctx), _np(jaux)),
                 "stacked": (sctx, saux)})
    cases.append({"M": M, "skew": skew, "alloc": alloc, "mode_caps": caps,
                  "tele": tele, "i_max": i_max, "C": C, "sm": SM,
                  "q": np.asarray(q), "self_kv": (np.asarray(kd),
                                                  np.asarray(vd)),
                  "csl": _host(port)})
  got = world.run_world(ranks.cluster_world, 4,
                        (cases, [(c, dict(ENGINE_KW, **e), ENGINE_WINDOW)
                                 for c, e in CL_ENGINES], *llama[1:]),
                        timeout_s=JOIN_S)
  stacked = _stacked_engines(llama, CL_ENGINES, lambda kw: cl.ClusterStepBackend(
      cl.ClusterConfig(**kw)))
  return got, want, stacked


def _check_attention(results, ref, tele):
  ctx, aux = results[0]
  for other in results[1:]:                      # every rank the same bits
    assert torch.equal(other[0], ctx)
    for k in aux:
      assert torch.equal(other[1][k], aux[k]), k
  jctx, jaux = ref["jax"]
  err = np.abs(ctx.numpy() - jctx).max()
  assert err <= TOL * np.abs(jctx).max(), (err, np.abs(jctx).max())
  sctx, saux = ref["stacked"]
  assert torch.equal(ctx, sctx), float((ctx - sctx).abs().max())
  assert set(aux) == set(jaux) == set(saux)
  np.testing.assert_array_equal(aux["fe_cover"].numpy(), jaux["fe_cover"])
  assert torch.equal(aux["fe_cover"], saux["fe_cover"])
  np.testing.assert_allclose(aux["fe_mass"].numpy(), jaux["fe_mass"],
                             atol=1e-6)
  if tele:
    np.testing.assert_allclose(aux["est_profile"].numpy(),
                               jaux["est_profile"], atol=1e-6)


@pytest.mark.parametrize("i", range(len(CL_CASES)),
                         ids=["-".join(map(str, c)) for c in CL_CASES])
def test_sharded_cluster_attention_equals_stacked(cluster_run, i):
  got, want, _ = cluster_run
  _check_attention([r["cases"][i] for r in got], want[i], CL_CASES[i][5])


@pytest.mark.parametrize("i", range(len(CL_ENGINES)),
                         ids=[e["policy"] for _, e in CL_ENGINES])
def test_mesh_cluster_engine_gives_the_stacked_ids(cluster_run, i):
  got, _, stacked = cluster_run
  for r in got:
    e = r["engines"][i]
    assert e["mesh"] == {"component": 4} and e["captures"] is False
    for key in ("tokens", "budgets", "step_drop"):
      assert e[key] == stacked[i][key], key
    assert e["tokens"] and e["summary"]["n"] == len(e["tokens"])
  assert all(r["stats"]["bytes"] > 0 for r in got)


# -- the fleet tier ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_run(llama):
  cases, want = [], []
  for i, (skew, alloc, quant) in enumerate(FL_CASES):
    q, arena, ring, (kd, vd) = _arena(20 + i, quant)
    jt = jtopo.plan_2d(M, 2, 2, skew=skew)
    comps = _components(arena, jt)
    csl = dict({n: jkvc.replicate_leaf(x, 2, axis=1 if n == "counts" else 2)
                for n, x in comps.items()}, **ring)
    mode = np.asarray([MODE_FULL, MODE_STAGE1], np.int32)
    jctx, jaux = jfl.make_fleet_attention(jt, alloc=alloc, mesh=None,
                                          telemetry=True)(
        q, dict(csl, fe_mode=jnp.asarray(mode),
                fe_replica=jnp.zeros(2, jnp.int32)),
        i_max=4, cluster_size=C, sm_scale=SM, self_kv=(kd, vd), impl="xla")
    port = _port_layout(dict(csl, fe_mode=mode), 2)
    topo = topology.plan_2d(M, 2, 2, skew=skew)
    sctx, saux = fl.make_fleet_attention(topo, alloc=alloc, telemetry=True)(
        _t(q), dict(port, fe_replica=torch.zeros(2, dtype=torch.int32)),
        i_max=4, cluster_size=C, sm_scale=SM, self_kv=(_t(kd), _t(vd)))
    want.append({"jax": (np.asarray(jctx), _np(jaux)),
                 "stacked": (sctx, saux)})
    cases.append({"M": M, "skew": skew, "alloc": alloc, "tele": True,
                  "i_max": 4, "C": C, "sm": SM, "q": np.asarray(q),
                  "self_kv": (np.asarray(kd), np.asarray(vd)),
                  "csl": _host(port), "selections": FL_SELECTIONS})
  got = world.run_world(ranks.fleet_world, 4,
                        (cases, [(c, dict(ENGINE_KW, **e), ENGINE_WINDOW)
                                 for c, e in FL_ENGINES], *llama[1:]),
                        timeout_s=JOIN_S)
  stacked = _stacked_engines(llama, FL_ENGINES, lambda kw: fl.FleetStepBackend(
      fl.FleetConfig(**kw)))
  return got, want, stacked


@pytest.mark.parametrize("i", range(len(FL_CASES)),
                         ids=["-".join(map(str, c)) for c in FL_CASES])
def test_sharded_fleet_attention_equals_stacked(fleet_run, i):
  got, want, _ = fleet_run
  per_sel = [[r["cases"][i][s] for r in got]
             for s in range(len(FL_SELECTIONS))]
  _check_attention(per_sel[0], want[i], True)
  primary = per_sel[0][0]
  for results in per_sel[1:]:            # any selection: the same bits
    for ctx, aux in results:
      assert torch.equal(ctx, primary[0])
      assert torch.equal(aux["fe_cover"], primary[1]["fe_cover"])


@pytest.mark.parametrize("i", range(len(FL_ENGINES)),
                         ids=[e["policy"] for _, e in FL_ENGINES])
def test_mesh_fleet_engine_gives_the_stacked_ids(fleet_run, i):
  got, _, stacked = fleet_run
  for r in got:
    e = r["engines"][i]
    assert e["mesh"] == {"replica": 2, "component": 2}
    assert e["captures"] is False
    for key in ("tokens", "budgets", "step_drop"):
      assert e[key] == stacked[i][key], key


# -- the mesh train step -----------------------------------------------------------------

OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)


def _close_rel(got, want, tol=TOL, what=""):
  want = np.asarray(want, np.float32)
  scale = max(float(np.abs(want).max()), 1e-30)
  np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                             atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module")
def train_run():
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  opt_cfg = OptConfig(**OPT)
  state = init_train_state(cfg, opt_cfg, device="cpu", compress=True,
                           generator=torch.Generator().manual_seed(0))
  to_np = lambda tree: tree_map(lambda x: x.numpy(), tree)  # noqa: E731
  data = TokenStream(DataConfig(cfg.vocab, 32, 8, seed=1))
  batches = [data.batch_at(i) for i in range(2)]
  rng = np.random.default_rng(4)
  psum = {"grads": {"a": rng.standard_normal((64,)).astype(np.float32),
                    "b": {"c": rng.standard_normal((3, 5)).astype(
                        np.float32)}},
          "err": {"a": 1e-3 * rng.standard_normal((64,)).astype(np.float32),
                  "b": {"c": np.zeros((3, 5), np.float32)}}}
  dense = {"arch": "llama3-8b", "opt_cfg": OPT, "batches": batches,
           "params": to_np(state["params"]),
           "opt": to_np(state["opt"]), "err": to_np(state["err"]),
           "psum": psum}
  # The MoE: deepseek's SMOKE config from JAX's init, one row a rank.
  jcfg = dataclasses.replace(j_get_config("deepseek-v2-236b", smoke=True),
                             dtype=jnp.float32)
  jstate, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptConfig())
  tokens, labels = jdata.TokenStream(
      jdata.DataConfig(jcfg.vocab, 32, 4, seed=2)).batch_at(0)
  moe = {"arch": "deepseek-v2-236b", "params": _np(jstate["params"]),
         "tokens": tokens, "labels": labels}
  got = world.run_world(ranks.train_world, 4, (dense, moe),
                        timeout_s=JOIN_S)
  # The one-rank references.
  ref_states = []
  for tokens_, labels_ in batches:
    b = {"tokens": torch.from_numpy(tokens_),
         "labels": torch.from_numpy(labels_)}
    _, _, g = loss_and_grads(cfg, state["params"], b, microbatches=4)
    deq, err = comp.local_quantise_feedback(g, state["err"])
    params, opt, _ = adamw_update(deq, state["opt"], state["params"],
                                  opt_cfg)
    state = {"params": params, "opt": opt, "err": err}
    ref_states.append(state)
  jgrads = []
  for i in range(4):
    (_, _), g = jax.value_and_grad(
        lambda p, i=i: jtf.forward_loss(
            p, jcfg, jnp.asarray(tokens[i:i + 1]),
            jnp.asarray(labels[i:i + 1])), has_aux=True)(jstate["params"])
    jgrads.append(_np(g))
  jmean = jax.tree.map(lambda *xs: sum(xs[1:], xs[0]) / 4.0, *jgrads)
  return got, ref_states[-1], psum, jmean


def test_mesh_train_step_equals_one_rank_with_quantise_feedback(train_run):
  got, ref, _, _ = train_run
  for r in got:
    assert set(r["state"]) == {"params", "opt", "err"}
    for part in ("params", "err"):
      want = dict(leaves(ref[part]))
      for path, x in leaves(r["state"][part]):
        _close_rel(x.numpy(), want[path].numpy(), what=f"{part} {path}")
    for mom in ("m", "v"):
      want = dict(leaves(ref["opt"][mom]))
      for path, x in leaves(r["state"]["opt"][mom]):
        _close_rel(x.numpy(), want[path].numpy(), what=f"{mom} {path}")
    assert int(r["state"]["opt"]["step"]) == 2
    assert r["metrics"] == got[0]["metrics"]
  assert [r["coords"] for r in got] == [
      {"pod": p, "data": d} for p in range(2) for d in range(2)]


def test_compressed_pod_psum_is_local_quantise_feedback(train_run):
  got, _, psum, _ = train_run
  grads = tree_map(torch.from_numpy, psum["grads"])
  err = tree_map(torch.from_numpy, psum["err"])
  deq, new_err = comp.local_quantise_feedback(grads, err)
  for r in got:
    summed, e = r["psum"]
    for (path, s), (_, want) in zip(leaves(summed), leaves(deq)):
      assert torch.equal(s / 2, want), path
    for (path, x), (_, want) in zip(leaves(e), leaves(new_err)):
      assert torch.equal(x, want), path


def test_mesh_moe_grads_equal_the_mean_of_jax_per_shard_grads(train_run):
  got, _, _, jmean = train_run
  want = dict(leaves(jmean))
  for r in got:
    g = dict(leaves(r["moe"]["grads"]))
    assert set(g) == set(want)
    for path, x in g.items():
      _close_rel(x.numpy(), want[path], what=path)
    assert r["moe"]["loss"] == got[0]["moe"]["loss"]
