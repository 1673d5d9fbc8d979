"""Rank bodies of the sharded-path tests (``tests/test_torch_sharding.py``,
``tests/test_torch_mesh_tiers.py``); not a test module.

Each function runs on every rank of a world that
``repro_torch.dist.world.run_world`` spawned, imports no JAX (the JAX side
runs in the test's own process), takes numpy inputs and returns CPU
tensors and plain values, which the test holds against the JAX package
and the port's stacked path.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.topology import ComponentTopology, plan_2d


def _f32(arch):
  return dataclasses.replace(get_config(arch, smoke=True),
                             dtype=torch.float32)


def _tensors(tree):
  return bridge.arena_from_numpy(tree, "cpu")


# -- sharded synopsis attention ------------------------------------------------

def synopsis_world(cases, step):
  """(data 2, model 4) mesh: each case's global layer cache cut by
  ``shard_cache`` under its rule table, ``sharded_synopsis_attention`` on
  the rank's shard; then the SMOKE serve step through the per-layer
  dispatch on the rank's shard of a whole cache, under both tables."""
  from repro_torch.serve import serve_step as ss
  mesh = shd.Mesh((2, 4), ("data", "model"))
  out = {"coords": mesh.coords, "cases": [], "step": {}}
  for case in cases:
    cache = _tensors(case["cache"])
    q = torch.from_numpy(case["q"])
    kd, vd = (torch.from_numpy(x) for x in case["self_kv"])
    rules = getattr(shd, case["rules"])
    loc = ss.shard_cache(cache, mesh, rules)
    lay = loc["layout"]
    rows = slice(None)
    if lay.dp_n > 1:
      n = lay.batch // lay.dp_n
      b0 = mesh.index(lay.dp_axes) * n
      rows = slice(b0, b0 + n)
    with shd.use_mesh(mesh, rules):
      got = ss.sharded_synopsis_attention(
          q[rows], loc, i_max=case["i_max"], cluster_size=case["C"],
          sm_scale=case["sm"], cap=case["cap"], self_kv=(kd[rows], vd[rows]))
    out["cases"].append({"out": got, "rows": (rows.start, rows.stop),
                         "layout": dataclasses.asdict(lay),
                         "shapes": {k: tuple(v.shape) for k, v in loc.items()
                                    if k != "layout"}})
  cfg = _f32("llama3-8b")
  params = bridge.params_from_numpy(step["params"], cfg, "cpu")
  cache = _tensors(step["cache"])
  tok = torch.from_numpy(step["tok"]).long()
  step_fn = ss.make_serve_step(cfg, i_max=step["i_max"])
  for name in ("SERVE_RULES", "LONG_RULES"):
    rules = getattr(shd, name)
    loc = ss.shard_cache(cache, mesh, rules)
    lay = loc["layout"]
    rows = slice(None)
    if lay.dp_n > 1:
      n = lay.batch // lay.dp_n
      b0 = mesh.index(lay.dp_axes) * n
      rows = slice(b0, b0 + n)
    with shd.use_mesh(mesh, rules):
      logits, st = step_fn(params, loc, tok[rows])
    out["step"][name] = {"logits": logits, "k_delta": st["k_delta"],
                         "rows": (rows.start, rows.stop),
                         "layout": dataclasses.asdict(lay)}
  out["stats"] = dict(mesh.stats)
  x = all_reduce_operand(mesh.rank)
  out["all_reduce"] = {(axes, op): mesh.all_reduce(x, axes, op=op)
                       for axes in ALL_REDUCE_AXES for op in ("sum", "mean")}
  return out


# Mesh.all_reduce over one axis and over both in either order, on an
# operand whose size is not a multiple of the ranks (the padded piece).
ALL_REDUCE_AXES = ("model", ("data", "model"), ("model", "data"))


def all_reduce_operand(rank):
  return torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
      (7, 3)).astype(np.float32))


# -- the cluster tier ----------------------------------------------------------

def _engine_ids(eng, run_open_loop, rate, duration, seed):
  s = run_open_loop(eng, rate, duration, seed=seed)
  reqs = sorted(eng.completed, key=lambda r: r.rid)
  return {"tokens": [r.tokens for r in reqs],
          "budgets": [r.budgets for r in reqs],
          "step_drop": [r.step_drop for r in reqs],
          "summary": {k: s[k] for k in ("n", "served_n", "prefills",
                                        "mean_budget", "steps")},
          "captures": eng.programs.captures}


def _engine_world(engines, params_np, basis_np, backend_of):
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  cfg = _f32("llama3-8b")
  params = bridge.params_from_numpy(params_np, cfg, "cpu")
  basis = torch.from_numpy(basis_np)
  out = []
  for ccfg, ekw, (rate, duration, seed) in engines:
    backend = backend_of(ccfg)
    eng = ServingEngine(cfg, EngineConfig(**ekw), params=params,
                        pca_basis=basis, device="cpu", backend=backend)
    res = _engine_ids(eng, run_open_loop, rate, duration, seed)
    res["mesh"] = None if backend.mesh is None else dict(backend.mesh.shape)
    out.append(res)
  return out


def cluster_world(cases, engines, params_np, basis_np):
  """("component", 4) mesh: each attention case on the rank's component of
  the stacked layout, then SMOKE cluster engines with use_mesh=True."""
  from repro_torch.serve import cluster as cl
  from repro_torch.dist.topology import make_component_mesh
  mesh = make_component_mesh(4)
  sid = mesh.axis_index("component")
  out = {"cases": []}
  for case in cases:
    topo = ComponentTopology.plan(case["M"], 4, case["skew"])
    csl = {}
    for name, x in case["csl"].items():
      t = _tensors({name: x})[name]
      if name in ("k", "v", "k_syn", "v_syn", "counts", "k_syn_scale",
                  "v_syn_scale", "k_scale", "v_scale"):
        t = t[:, sid].contiguous()        # this rank's component
      csl[name] = t
    attn = cl.make_cluster_attention(
        topo, alloc=case["alloc"], mesh=mesh, mode_caps=case["mode_caps"],
        telemetry=case["tele"])
    kd, vd = (torch.from_numpy(x) for x in case["self_kv"])
    ctx, aux = attn(torch.from_numpy(case["q"]), csl, i_max=case["i_max"],
                    cluster_size=case["C"], sm_scale=case["sm"],
                    self_kv=(kd, vd))
    out["cases"].append((ctx, aux))
  out["stats"] = dict(mesh.stats)
  out["engines"] = _engine_world(
      engines, params_np, basis_np,
      lambda kw: cl.ClusterStepBackend(cl.ClusterConfig(use_mesh=True,
                                                        **kw)))
  return out


# -- the fleet tier ------------------------------------------------------------

def fleet_world(cases, engines, params_np, basis_np):
  """(replica 2, component 2) mesh: each attention case on the rank's lane
  (r, j) of the stacked fleet layout under several replica selections,
  then SMOKE fleet engines with use_mesh=True."""
  from repro_torch.dist.topology import make_fleet_mesh
  from repro_torch.serve import fleet as fl
  mesh = make_fleet_mesh(2, 2)
  r, j = mesh.axis_index("replica"), mesh.axis_index("component")
  out = {"cases": []}
  for case in cases:
    topo = plan_2d(case["M"], 2, 2, skew=case["skew"])
    base = {}
    for name, x in case["csl"].items():
      t = _tensors({name: x})[name]
      if name in ("k", "v", "k_syn", "v_syn", "counts", "k_syn_scale",
                  "v_syn_scale", "k_scale", "v_scale"):
        t = t[:, r, j].contiguous()        # this rank's lane
      base[name] = t
    attn = fl.make_fleet_attention(topo, alloc=case["alloc"], mesh=mesh,
                                   telemetry=case["tele"])
    kd, vd = (torch.from_numpy(x) for x in case["self_kv"])
    res = []
    for sel in case["selections"]:
      csl = dict(base, fe_replica=torch.tensor(sel, dtype=torch.int32))
      res.append(attn(torch.from_numpy(case["q"]), csl, i_max=case["i_max"],
                      cluster_size=case["C"], sm_scale=case["sm"],
                      self_kv=(kd, vd)))
    out["cases"].append(res)
  out["engines"] = _engine_world(
      engines, params_np, basis_np,
      lambda kw: fl.FleetStepBackend(fl.FleetConfig(use_mesh=True, **kw)))
  return out


# -- the train step ------------------------------------------------------------

def train_world(dense, moe):
  """(pod 2, data 2) mesh: two compressed train steps of a dense SMOKE
  config from the given state on the global batches; ``compressed_pod_
  psum`` alone on a drawn tree; one MoE SMOKE config's mesh gradients."""
  from repro_torch.train import compression as comp
  from repro_torch.train.optimizer import OptConfig
  from repro_torch.train.train_step import (make_train_step,
                                            mesh_loss_and_grads)
  mesh = shd.Mesh((2, 2), ("pod", "data"))
  out = {"coords": mesh.coords}
  cfg = _f32(dense["arch"])
  state = {"params": _tensors_tree(dense["params"]),
           "opt": _tensors_tree(dense["opt"]),
           "err": _tensors_tree(dense["err"])}
  step = make_train_step(cfg, OptConfig(**dense["opt_cfg"]),
                         compress_pods=True, mesh=mesh)
  metrics = []
  for tokens, labels in dense["batches"]:
    state, m = step(state, {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(labels)})
    metrics.append({k: float(v) for k, v in m.items()})
  out["state"], out["metrics"] = state, metrics
  grads = _tensors_tree(dense["psum"]["grads"])
  err = _tensors_tree(dense["psum"]["err"])
  out["psum"] = comp.compressed_pod_psum(grads, err, "pod", mesh=mesh)
  mcfg = _f32(moe["arch"])
  loss, mets, g = mesh_loss_and_grads(
      mcfg, _tensors_tree(moe["params"]),
      {"tokens": torch.from_numpy(moe["tokens"]),
       "labels": torch.from_numpy(moe["labels"])}, mesh)
  out["moe"] = {"loss": float(loss), "metrics": {k: float(v)
                                                 for k, v in mets.items()},
                "grads": g}
  out["stats"] = dict(mesh.stats)
  return out


def _tensors_tree(tree):
  if isinstance(tree, dict):
    return {k: _tensors_tree(v) for k, v in tree.items()}
  return torch.from_numpy(np.array(tree))


# -- on the card ---------------------------------------------------------------

def card_synopsis_world(seed):
  """(model 4) mesh of ranks sharing the card: the sharded synopsis
  attention on each rank's shard (the kernels) against the one-rank
  kernels on the global cache, f32; with each rank's stage 1 / stage 2
  launches."""
  from repro_torch.kernels import _build
  from repro_torch.serve import serve_step as ss
  dev = torch.device("cuda", torch.cuda.current_device())
  mesh = shd.Mesh((4,), ("model",))
  rng = np.random.default_rng(seed)
  B, Hkv, G, D, C, M = 2, 2, 4, 64, 32, 16

  def f(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)
  k, v = f(B, Hkv, M * C, D), f(B, Hkv, M * C, D)
  cache = {"k": k, "v": v, "recent_k": f(B, Hkv, 16, D),
           "recent_v": f(B, Hkv, 16, D),
           "recent_len": torch.tensor([7, 16], dtype=torch.int32,
                                      device=dev),
           "counts": torch.full((B, M), float(C), device=dev),
           "k_syn": k.view(B, Hkv, M, C, D).mean(3),
           "v_syn": v.view(B, Hkv, M, C, D).mean(3)}
  q, kd, vd = f(B, Hkv * G, D), f(B, Hkv, 1, D), f(B, Hkv, 1, D)
  kw = dict(i_max=4, cluster_size=C, sm_scale=D ** -0.5, self_kv=(kd, vd))
  one = ss.synopsis_decode_attention(q, cache, **kw)
  loc = ss.shard_cache(cache, mesh, shd.SERVE_RULES)
  _build.reset_launches()
  with shd.use_mesh(mesh, shd.SERVE_RULES):
    got = ss.sharded_synopsis_attention(q, loc, **kw)
  torch.cuda.synchronize()
  counts = _build.launch_counts()
  return {"err_one_rank": float((got - one).abs().max()),
          "scale": float(one.abs().max()),
          "launches": {k_: counts[k_] for k_ in (
              "fused_synopsis_score_attention", "block_gather_attention")}}
