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


def _batch_rows(mesh, lay):
  """This rank's batch rows of a shard's layout."""
  if lay.dp_n > 1:
    n = lay.batch // lay.dp_n
    b0 = mesh.index(lay.dp_axes) * n
    return slice(b0, b0 + n)
  return slice(None)


def exact_world(cases, steps):
  """(data 2, model 4) mesh: each case's global exact layer cache cut by
  ``shard_cache`` under its rule table and ``sharded_exact_decode_
  attention`` on the rank's shard (with a window where the case has one);
  then each SMOKE config's exact serve step (f32) on the rank's shard of a
  whole exact cache under both tables, beside the one-rank step on the
  whole cache, and the same sharded step once more on an
  ``AbstractMesh`` of the same shape and rank, whose collectives' results
  and tallies are held to the real mesh's."""
  from repro_torch.serve import serve_step as ss
  mesh = shd.Mesh((2, 4), ("data", "model"))
  out = {"coords": mesh.coords, "cases": [], "steps": {}}
  for case in cases:
    cache = _tensors(case["cache"])
    q = torch.from_numpy(case["q"])
    kd, vd = (torch.from_numpy(x) for x in case["self_kv"])
    rules = getattr(shd, case["rules"])
    loc = ss.shard_cache(cache, mesh, rules)
    lay = loc["layout"]
    rows = _batch_rows(mesh, lay)
    with shd.use_mesh(mesh, rules):
      got = ss.sharded_exact_decode_attention(
          q[rows], loc["k"], loc["v"], lay, sm_scale=case["sm"],
          cap=case["cap"], self_kv=(kd[rows], vd[rows]),
          window=case["window"])
    out["cases"].append({"out": got, "rows": (rows.start, rows.stop),
                         "layout": dataclasses.asdict(lay),
                         "k_rows": loc["k"].shape[2]})
  amesh = shd.AbstractMesh((2, 4), ("data", "model"), rank=mesh.rank)
  for arch, step in steps.items():
    cfg = _f32(arch)
    params = bridge.params_from_numpy(step["params"], cfg, "cpu")
    cache = _tensors(step["cache"])
    tok = torch.from_numpy(step["tok"]).long()
    step_fn = ss.make_serve_step(cfg, mode="exact")
    one, _ = step_fn(params, cache, tok)
    for name in ("SERVE_RULES", "LONG_RULES"):
      rules = getattr(shd, name)
      res = {}
      for m in (mesh, amesh):
        m.reset_stats()
        loc = ss.shard_cache(cache, m, rules)
        rows = _batch_rows(m, loc["layout"])
        with shd.use_mesh(m, rules):
          logits, st = step_fn(params, loc, tok[rows])
        res[m.backend == "abstract"] = (
            logits, st, {k: v for k, v in m.stats.items() if k != "ms"})
      (logits, st, stats), (alog, ast, astats) = res[False], res[True]
      out["steps"][(arch, name)] = {
          "logits": logits, "k_delta": st["k_delta"], "one": one[rows],
          "rows": (rows.start, rows.stop), "stats": stats,
          "abstract_stats": astats,
          "abstract_shapes": (tuple(alog.shape), tuple(ast["k_delta"].shape)),
          "layout": dataclasses.asdict(loc["layout"])}
  x = all_reduce_operand(mesh.rank)
  out["collectives"] = {}
  for axes in ALL_REDUCE_AXES:
    for m in (mesh, amesh):
      m.reset_stats()
      res = (m.all_reduce(x, axes).shape,
             m.all_gather(x, axes, dim=1).shape,
             m.all_gather(x, axes, dim=0, tiled=False).shape,
             {k: v for k, v in m.stats.items() if k != "ms"})
      out["collectives"][(axes, m.backend == "abstract")] = res
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
                                            mesh_loss_and_grads, shard_batch)
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
    state, m = step(state, shard_batch({"tokens": torch.from_numpy(tokens),
                                        "labels": torch.from_numpy(labels)},
                                       mesh))
    metrics.append({k: float(v) for k, v in m.items()})
  out["state"], out["metrics"] = state, metrics
  grads = _tensors_tree(dense["psum"]["grads"])
  err = _tensors_tree(dense["psum"]["err"])
  out["psum"] = comp.compressed_pod_psum(grads, err, "pod", mesh=mesh)
  mcfg = _f32(moe["arch"])
  loss, mets, g = mesh_loss_and_grads(
      mcfg, _tensors_tree(moe["params"]),
      shard_batch({"tokens": torch.from_numpy(moe["tokens"]),
                   "labels": torch.from_numpy(moe["labels"])}, mesh), mesh)
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


def card_exact_world(seed):
  """(model 4) mesh of ranks sharing the card: exact decode on each rank's
  quarter of the sequence (``flash_decode`` over its rows, of a window
  that crosses from shard 2 into shard 3 too) against the one-rank kernel
  on the global cache, f32, with each rank's ``flash_decode`` launches."""
  from repro_torch.kernels import _build
  from repro_torch.serve import serve_step as ss
  dev = torch.device("cuda", torch.cuda.current_device())
  mesh = shd.Mesh((4,), ("model",))
  rng = np.random.default_rng(seed)
  B, Hkv, G, D, S = 2, 2, 4, 64, 1024

  def f(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)
  cache = {"k": f(B, Hkv, S, D), "v": f(B, Hkv, S, D)}
  q, kd, vd = f(B, Hkv * G, D), f(B, Hkv, 1, D), f(B, Hkv, 1, D)
  loc = ss.shard_cache(cache, mesh, shd.SERVE_RULES)
  out = {}
  for window in (None, 384):
    kw = dict(sm_scale=D ** -0.5, self_kv=(kd, vd), window=window)
    one = ss.exact_decode_attention(q, cache["k"], cache["v"], **kw)
    _build.reset_launches()
    with shd.use_mesh(mesh, shd.SERVE_RULES):
      got = ss.sharded_exact_decode_attention(q, loc["k"], loc["v"],
                                              loc["layout"], **kw)
    torch.cuda.synchronize()
    out[window] = {"err_one_rank": float((got - one).abs().max()),
                   "scale": float(one.abs().max()),
                   "launches": _build.launch_counts()["flash_decode"]}
  return {"rank": mesh.rank, "cases": out}


# -- weights cut by the rule tables ---------------------------------------------

def _rules(name, fsdp):
  rules = dict(getattr(shd, name))
  if fsdp:
    rules["embed"] = ("data",)
  return rules


def _leaf_shapes(tree, prefix=""):
  """{path: shape} of a cut tree's tensors (its ``_cut`` entries left
  out)."""
  out = {}
  for k, v in tree.items():
    if k == shd.CUT_KEY:
      continue
    if isinstance(v, dict):
      out.update(_leaf_shapes(v, f"{prefix}{k}/"))
    else:
      out[f"{prefix}{k}"] = tuple(v.shape)
  return out


def _rows_of(cache, rows):
  """Batch rows ``rows`` of a global cache (each leaf along its batch
  axis)."""
  from repro_torch.serve import serve_step as ss
  if rows.start is None:
    return cache
  return {k: v.narrow(ss._SHARD_AXES[k][0], rows.start,
                      rows.stop - rows.start) for k, v in cache.items()}


def tensor_parallel_world(cases):
  """(data 2, model 4) mesh: each case's SMOKE config (f32) with its
  weights cut by ``shard_params`` under its rule table: the prefill of the
  global prompt on every rank, then per mode the serve step on the rank's
  shard of the global cache (``shard_cache``); beside each, the port's
  one-rank step on the whole weights and cache.  Also the shards' shapes
  and specs, and the whole weights' step under an installed TRAIN_RULES
  against the step with no mesh, bit for bit."""
  from repro_torch.models import common as cm
  from repro_torch.serve import serve_step as ss
  from repro_torch.serve.prefill import make_prefill_step
  mesh = shd.Mesh((2, 4), ("data", "model"))
  out = {"coords": mesh.coords, "cases": []}
  for case in cases:
    cfg = _f32(case["arch"])
    rules = _rules(case["rules"], case["fsdp"])
    whole = bridge.params_from_numpy(case["params"], cfg, "cpu")
    local, specs = bridge.shard_params_from_numpy(case["params"], cfg, "cpu",
                                                  mesh, rules)
    prompt = torch.from_numpy(case["prompt"]).long()
    prefill = make_prefill_step(cfg)
    mesh.reset_stats()
    with shd.use_mesh(mesh, rules):
      logits, cache = prefill(local, prompt)
    res = {"prefill": logits, "prefill_one": prefill(whole, prompt)[0],
           "prefill_k": cache.get("k"), "prefill_stats": dict(mesh.stats),
           "shapes": _leaf_shapes(local),
           "specs": dict(cm.leaves(specs)), "steps": {}}
    for mode, step_in in case["steps"].items():
      jc = _tensors(step_in["cache"])
      tok = torch.from_numpy(step_in["tok"]).long()
      step = ss.make_serve_step(cfg, mode=mode, i_max=step_in["i_max"])
      loc = ss.shard_cache(jc, mesh, rules)
      rows = _batch_rows(mesh, loc["layout"])
      with shd.use_mesh(mesh, rules):
        got, st = step(local, loc, tok[rows])
      # The one-rank step on the rank's rows: an MoE routes the tokens of
      # a data-parallel shard together (the reference's per-shard routing).
      one, _ = step(whole, _rows_of(jc, rows), tok[rows])
      res["steps"][mode] = {
          "logits": got, "one": one, "rows": (rows.start, rows.stop),
          "layout": dataclasses.asdict(loc["layout"]),
          "state_shapes": {k: tuple(st[k].shape) for k in
                           ("conv_state", "ssd_state") if k in st},
          "cache_shapes": {k: tuple(loc[k].shape) for k in
                           ("conv_state", "ssd_state") if k in loc}}
      if case.get("train_rules"):
        plain, _ = step(whole, jc, tok)
        with shd.use_mesh(mesh, shd.TRAIN_RULES):
          again, _ = step(whole, jc, tok)
        res["steps"][mode]["train_rules_equal"] = torch.equal(again, plain)
    out["cases"].append(res)
  return out


def card_tp_world(archs):
  """(model 4) mesh of ranks sharing the card: each SMOKE config (f32, the
  port's own random weights) with its weights cut under SERVE_RULES:
  prefill, one synopsis and one exact step on the rank's shard against
  the one-rank calls on the whole weights, and the kernels each rank
  launched on its cut path."""
  from repro_torch.kernels import _build
  from repro_torch.models import transformer as tf
  from repro_torch.serve import serve_step as ss
  from repro_torch.serve import synopsis_kv as skv
  from repro_torch.serve.prefill import make_prefill_step
  dev = torch.device("cuda", torch.cuda.current_device())
  mesh = shd.Mesh((4,), ("model",))
  out = {"rank": mesh.rank, "cases": {}}
  for arch in archs:
    cfg = _f32(arch)
    whole = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    local, _ = shd.shard_params(whole, cfg, mesh, shd.SERVE_RULES)
    prompt = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    prefill = make_prefill_step(cfg)
    _build.reset_launches()
    with shd.use_mesh(mesh, shd.SERVE_RULES):
      logits, cache = prefill(local, prompt)
    syn = skv.build(cache, cfg)
    launches = dict(_build.launch_counts())
    one, _ = prefill(whole, prompt)
    res = {"prefill": (float((logits - one).abs().max()),
                       float(one.abs().max()))}
    tok = one.argmax(-1, keepdim=True)
    for mode, glob in (("synopsis", syn), ("exact", cache)):
      step = ss.make_serve_step(cfg, mode=mode, i_max=2)
      loc = ss.shard_cache(glob, mesh, shd.SERVE_RULES)
      _build.reset_launches()
      with shd.use_mesh(mesh, shd.SERVE_RULES):
        got, _ = step(local, loc, tok)
      for k, n in _build.launch_counts().items():
        launches[k] = launches.get(k, 0) + n
      ref, _ = step(whole, glob, tok)
      res[mode] = (float((got - ref).abs().max()), float(ref.abs().max()))
    torch.cuda.synchronize()
    res["launches"] = {k: n for k, n in launches.items() if n}
    out["cases"][arch] = res
  return out


# -- the train step on a cut state ----------------------------------------------

def _leaf_specs(tree, prefix=""):
  """{path: spec} of a cut tree's leaves."""
  out = {}
  cuts = tree.get(shd.CUT_KEY, {})
  for k, v in tree.items():
    if k == shd.CUT_KEY:
      continue
    if isinstance(v, dict):
      out.update(_leaf_specs(v, f"{prefix}{k}/"))
    else:
      out[f"{prefix}{k}"] = cuts[k].spec
  return out


def _train_state_of(case, cfg, compress):
  from repro_torch.train import compression as comp
  from repro_torch.train.optimizer import init_opt_state
  params = _tensors_tree(case["params"])
  state = {"params": params, "opt": init_opt_state(params)}
  if compress:
    state["err"] = comp.init_error_feedback(params)
  return state


def cut_train_world(shape, names, cases, ckpt_dir=None):
  """A mesh of ``shape`` over ``names``: each case's SMOKE state (JAX's
  init, the forward in the case's dtype) cut by ``shard_train_state``
  under its rule table; the cut
  gradients of the rank's share of the global batch
  (``mesh_loss_and_grads``) and one cut
  train step (``make_train_step``), each assembled whole
  (``unshard_train_state``), with the shards' shapes and specs and the
  collectives' tally.  With ``ckpt_dir``, the first case's state after
  its step checkpointed whole (``launch.train.save_state``)."""
  from repro_torch.launch import train as launch_train
  from repro_torch.train import checkpoint as ck
  from repro_torch.train.optimizer import OptConfig
  from repro_torch.train.train_step import (make_train_step,
                                            mesh_loss_and_grads, shard_batch,
                                            shard_train_state,
                                            unshard_train_state)
  mesh = shd.Mesh(shape, names)
  out = {"coords": mesh.coords, "cases": []}
  for i, case in enumerate(cases):
    cfg = dataclasses.replace(_f32(case["arch"]),
                              dtype=getattr(torch, case["dtype"]))
    rules = _rules("TRAIN_RULES", False)
    rules["embed"] = case["embed"]
    compress = case["compress"]
    cut = shard_train_state(_train_state_of(case, cfg, compress), cfg, mesh,
                            rules)
    batch = shard_batch({k: torch.from_numpy(v)
                         for k, v in case["batch"].items()}, mesh)
    mesh.reset_stats()
    loss, metrics, grads = mesh_loss_and_grads(
        cfg, cut["params"], batch, mesh, microbatches=case["mb"])
    stats = dict(mesh.stats)
    step = make_train_step(cfg, OptConfig(**case["opt_cfg"]),
                           microbatches=case["mb"], compress_pods=compress,
                           mesh=mesh)
    new, m = step(cut, batch)
    res = {"loss": float(loss), "metrics": {k: float(v) for k, v in
                                            metrics.items()},
           "grads": shd.unshard_tree(grads, mesh), "stats": stats,
           "state": unshard_train_state(new, mesh),
           "step_metrics": {k: float(v) for k, v in m.items()},
           "shapes": {part: _leaf_shapes(t) for part, t in (
               ("params", new["params"]), ("m", new["opt"]["m"]),
               ("v", new["opt"]["v"])) + ((("err", new["err"]),)
                                          if compress else ())},
           "specs": _leaf_specs(new["params"])}
    if ckpt_dir is not None and i == 0:
      saver = ck.AsyncCheckpointer()
      launch_train.save_state(saver, ckpt_dir, 1, new, mesh)
      saver.wait()
    out["cases"].append(res)
  return out


def collective_grads_world(ops_in, trap, ckpt):
  """(data 2, model 2) mesh: a scalar loss on every rank through each
  autograd collective alone, its gradients returned (the test holds them
  to the one-rank gradients); one cut train step's backward run on a
  fresh thread with no mesh installed, against the same backward on the
  calling thread; then a whole checkpoint restored onto (model 2), cut
  there and gathered whole again."""
  import threading
  from repro_torch.models import transformer as tf
  from repro_torch.train import checkpoint as ck
  from repro_torch.train.optimizer import tree_leaves, tree_map
  from repro_torch.train.train_step import (shard_batch, shard_train_state,
                                            unshard_train_state)
  mesh = shd.Mesh((2, 2), ("data", "model"))
  d, m = mesh.index("data"), mesh.index("model")
  t = {k: torch.from_numpy(v) for k, v in ops_in.items()}
  out = {"rank": mesh.rank}
  with shd.use_mesh(mesh, shd.TRAIN_RULES):
    # A row-cut product: the partials' all-reduce.
    w = t["w_rows"].chunk(2, 0)[m].clone().requires_grad_(True)
    y = shd.all_reduce_over(t["x"].chunk(2, 1)[m] @ w, ("model",))
    out["all_reduce"] = torch.autograd.grad((y * t["c"]).sum(), w)[0]
    # The rank's columns, all-gathered over `model`.
    w = t["w_cols"].chunk(2, 1)[m].clone().requires_grad_(True)
    y = shd.all_gather_over(t["x"] @ w, ("model",), -1)
    out["all_gather"] = torch.autograd.grad((y * y * t["c"]).sum(), w)[0]
    # A replicated activation entering the rank's columns.
    p = t["p"].clone().requires_grad_(True)
    w = t["w_cols"].chunk(2, 1)[m].clone().requires_grad_(True)
    y = shd.all_gather_over(torch.tanh(shd.enter(t["x"] * p, ("model",))
                                       @ w), ("model",), -1)
    out["enter"] = torch.autograd.grad((y * t["c"]).sum(), (p, w))
    # An FSDP weight: each data rank's rows of the batch.
    cut = shd.Cut(("embed", "ff"), ("data", None))
    w = t["w_cols"].chunk(2, 0)[d].clone().requires_grad_(True)
    wg, _ = shd.gather_fsdp(w, cut)
    xr = t["xb"].chunk(2, 0)[d]
    out["gather_fsdp"] = torch.autograd.grad(((xr @ wg) ** 2).sum(), w)[0]
  # The device-thread trap: the backward where no mesh is installed.
  cfg = _f32(trap["arch"])
  state = shard_train_state(_train_state_of(trap, cfg, False), cfg, mesh,
                            shd.TRAIN_RULES)
  batch = shard_batch({k: torch.from_numpy(v) for k, v in
                       trap["batch"].items()}, mesh)

  def forward():
    masters = tree_map(lambda x: x.detach().requires_grad_(True),
                       state["params"])
    with shd.use_mesh(mesh, shd.TRAIN_RULES):
      loss, _ = tf.forward_loss(masters, cfg, batch["tokens"],
                                batch["labels"])
    return loss, tree_leaves(masters)
  loss, leaves = forward()
  here = torch.autograd.grad(loss, leaves)
  loss, leaves = forward()
  box = {}

  def backward():
    box["mesh"] = shd.current_mesh()
    try:
      box["grads"] = torch.autograd.grad(loss, leaves)
    except BaseException as e:              # noqa: BLE001: reported
      box["error"] = repr(e)
  th = threading.Thread(target=backward)
  th.start()
  th.join()
  out["trap"] = {"mesh_on_thread": box["mesh"], "error": box.get("error"),
                 "equal": "grads" in box and all(
                     torch.equal(a, b) for a, b in zip(here, box["grads"]))}
  # A whole checkpoint restored onto (model 2), the first two ranks, and
  # cut there by the rules.
  line = shd.Mesh((2,), ("model",))
  if line.member:
    whole, step, _ = ck.restore(ckpt["dir"], ckpt["step"], device="cpu")
    cut = shard_train_state(whole, _f32(ckpt["arch"]), line,
                            shd.TRAIN_RULES)
    out["restored"] = {"step": step,
                       "state": unshard_train_state(cut, line),
                       "specs": _leaf_specs(cut["params"])}
  return out


def card_train_world(archs):
  """2 ranks sharing the card: each SMOKE config (f32, the port's own
  random init) with its train state cut by TRAIN_RULES on a (model 2) and
  a (data 2) mesh (tensor-parallel, then FSDP): one cut step's assembled
  gradients and state against the one-rank step on the whole state (the
  data shares as its microbatches), with the kernels each rank launched.
  On CUDA autograd runs the backward, and each layer's recompute, on a
  thread of its own, where no mesh is installed."""
  from repro_torch.kernels import _build
  from repro_torch.models.common import leaves
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig, adamw_update
  from repro_torch.train.train_step import (init_train_state,
                                            loss_and_grads, make_train_step,
                                            mesh_loss_and_grads, shard_batch,
                                            shard_train_state,
                                            unshard_train_state)
  dev = torch.device("cuda", torch.cuda.current_device())
  torch.backends.cuda.matmul.allow_tf32 = False
  meshes = {"model2": shd.Mesh((2,), ("model",)),
            "data2": shd.Mesh((2,), ("data",))}
  opt_cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
  out = {"rank": meshes["model2"].rank, "cases": {}}
  for arch in archs:
    cfg = _f32(arch)
    whole = init_train_state(cfg, opt_cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
    tokens, labels = TokenStream(DataConfig(cfg.vocab, 64, 4, seed=1)
                                 ).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    for label, mesh in meshes.items():
      dp = mesh.shape.get("data", 1)
      state = shard_train_state(whole, cfg, mesh, shd.TRAIN_RULES)
      _build.reset_launches()
      share = shard_batch(batch, mesh)
      loss, _, grads = mesh_loss_and_grads(cfg, state["params"], share, mesh)
      new, _ = make_train_step(cfg, opt_cfg, mesh=mesh)(state, share)
      torch.cuda.synchronize()
      launched = {k: n for k, n in _build.launch_counts().items() if n}
      assembled = shd.unshard_tree(grads, mesh)
      got_p = dict(leaves(unshard_train_state(new, mesh)["params"]))
      l1, _, g1 = loss_and_grads(cfg, whole["params"], batch,
                                 microbatches=dp)
      # AdamW on one rank from the assembled gradients: only the global
      # norm's order of summation differs.
      with torch.no_grad():
        ref_p, _, _ = adamw_update(assembled, whole["opt"], whole["params"],
                                   opt_cfg)

      def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
      got_g = dict(leaves(assembled))
      out["cases"][(arch, label)] = {
          "loss": rel(loss, l1), "launched": launched,
          "grads": max(rel(got_g[p], g) for p, g in leaves(g1)),
          "params": max(rel(got_p[p], x) for p, x in leaves(ref_p))}
  return out
