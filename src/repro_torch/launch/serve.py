"""Serving driver: prefill -> synopsis build -> deadline-budgeted decode
(counterpart of the single-batch loop of ``repro.launch.serve``).

Each decode step picks its refinement budget from the calibrated latency
model and the deadline; new tokens accumulate in the recent ring and are
absorbed into the synopsis when it fills (the paper's incremental update).
``--mode exact`` is the paper's exact baseline: prefill, then every step
attends over the whole prompt cache (no build, budget 0 recorded).
``--quant`` stores the synopsis arena quantized (int8 / fp8 centroids with
per-row scales; the ``+kv`` specs also the sorted cache, per cluster
block).  ``--batches N`` prefills and builds N prompt batches, serially
or, with ``--pipeline``, each prefill launched before the previous batch's
build; decode runs on batch 0.  All stages run on the port's kernels when
the device is a GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --no-smoke --prompt-len 8192 --tokens 130 [--mode exact] \\
      [--quant {none,int8,fp8,int8+kv,fp8+kv}] [--batches 2 --pipeline]
  # gemma2-2b: local (window 4096) and global layers, softcaps, sandwich
  # norms, tied embeddings; the loop, --mode exact and --engine alike
  # (on the card --quant int8 / fp8 only: the +kv specs would hand its
  # local layers' flash_decode int8 / fp8 codes, and are refused)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --no-smoke --prompt-len 8192 --tokens 130 [--mode exact]
  # smollm-135m (9/3 heads of 64) and pixtral-12b (the vision stub's
  # backbone; as in the JAX launcher, no patch input: text prompts only)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --no-smoke --prompt-len 8192 --tokens 130 [--mode exact | --engine]
  # whisper-medium: as in the JAX launcher no frames, so each layer's cross
  # block reads the decoder's own prompt KV; both modes and every --quant
  # spec (--engine is refused: the JAX engine fails on whisper)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --no-smoke --prompt-len 8192 --tokens 130 [--mode exact]
  # mamba2-370m: no attention, so exact mode whatever --mode says, and
  # --budget, --quant and --engine are refused, as in the JAX launcher
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --no-smoke --prompt-len 8192 --tokens 130
  # jamba-v0.1-52b: mamba, attention and MoE layers; the loop, --mode
  # exact and --engine alike (the full config does not fit one card: the
  # card runs it at 16 of its 32 layers, from chip_smoke.py)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --engine --device cpu --prompt-len 64 --tokens 4 --rate-scale 0.1

``--device cpu`` runs the plain PyTorch versions of the kernels (tests);
without it the driver needs a CUDA device and refuses to run otherwise.

With ``--engine`` the launcher instead runs the deadline-driven
continuous-batching engine (``repro_torch.serve.engine``) over an arrival
trace: requests admit and retire in shared slots mid-flight, each decode
step is a replay of its budget bucket's CUDA graph, and every budget
decision is calibrated by measured step times.  ``--contract`` /
``--epsilon`` set the serving contract, ``--admission`` /
``--slo-classes`` / ``--shed-margin`` / ``--no-shed`` the admission
policy, ``--cache-capacity`` / ``--no-cache`` / ``--zipf-corpora`` the
corpus cache and the repeating prompts it serves.

``--cluster N`` (which implies ``--engine``) runs the decode steps on the
N-component scatter-gather tier (``serve.cluster``), stacked on one device:
``--skew`` (Zipf exponent over the components' corpus shares), ``--alloc``
(mass | topk | gain), ``--route`` (fixed | rotate), ``--replicas`` (R >= 2
hedges stragglers onto ring replicas), ``--faults`` (an injected fault
world, e.g. ``crash=1@8,seed=3``), ``--no-recovery`` and ``--retries``
(the recovery ladder); ``--predictor`` defaults to ewma there.  The
``[cluster]`` line gives the partition, ``[faults]`` each window's fault
counters, and the JSON's ``cluster`` entry the measured per-component step
times at full budget.  ``--fleet`` (with ``--cluster N``) runs the fleet
tier instead (``serve.fleet``): ``--replicas R`` rows of materialized
shard copies, each step reading every shard from its fastest-predicted
holder (the faults and the retry ladder stay with ``--cluster`` alone).
``--autoscale`` then sizes the (components, replicas) grid hour by hour
over the 24 Sogou hours against ``--p99-target`` from the window's
measured export, and replays each hour at that size in the simulator
(``[hourHH]`` lines, component-hours against static peak sizing).

Started under a world of at least N ranks (R*N with ``--fleet``), for
example ``torchrun --nproc-per-node 4 -m repro_torch.launch.serve
--device cpu --cluster 4 ...``, the tier runs on its mesh, one rank a
component (``serve.cluster`` / ``serve.fleet``): every rank runs the
engine, rank 0's host decisions are broadcast, the steps run eagerly, and
rank 0 alone prints and writes the JSON.  The backend is ``gloo`` where
ranks share a card or on the CPU and ``nccl`` where each rank has a card
of its own (``dist.world.backend_for``); ranks past N (R*N) take part in
building the mesh and then idle.  With fewer ranks the tier runs stacked.
The ``[cluster]`` / ``[fleet]`` line says which, with the rank count.

  # the paper's Tables 1-2 load sweep, SMOKE model on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --engine --device cpu \
      --prompt-len 64 --tokens 4 --rate-scale 0.1
  # diurnal Sogou-shaped hours (Fig 7a) at full width on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --engine --no-smoke \
      --prompt-len 8192 --tokens 32 --n-slots 4 --trace sogou_hourly \
      --hours 21 --rate-scale 0.04 --deadline-ms 2000
  # the contracts, admission and the cache, SMOKE model on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --engine --device cpu \
      --prompt-len 64 --tokens 4 --rate-scale 0.1 \
      --contract error_bounded --epsilon 0.02 --admission edf \
      --slo-classes interactive:200,batch:800 --cache-capacity 4 \
      --zipf-corpora 4
  # the scatter-gather tier over 2 components with a crash and replicas:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --cluster 2 --faults crash=1@2 --replicas 2 --duration 1
  # the fleet tier (2 x 2 grid) and the 24-hour autoscaler:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --cluster 2 --fleet --replicas 2 --autoscale --duration 0.5 \
      --trace sogou_hourly --hours 21 --rate-scale 0.2
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.control import BudgetController, make_predictor
from repro_torch.dist import world
from repro_torch.kernels import quant as qt
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, n_attn_positions
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import check_quant_device, make_serve_step

BUCKETS = (0, 1, 2, 4, 8, 16, 32)


def apply_quant(cfg: ModelConfig, quant: str) -> ModelConfig:
  """The config with the synopsis arena's quant spec swapped in; "none"
  returns ``cfg`` unchanged (the unquantized path)."""
  qc = qt.parse_qconfig(quant)
  if not qc.enabled:
    return cfg
  return dataclasses.replace(
      cfg, synopsis=dataclasses.replace(cfg.synopsis, quant=qc.spec))


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run(cfg: ModelConfig, *, batch: int, prompt_len: int, tokens: int,
        deadline_ms: float = 50.0, device="cuda", seed: int = 0,
        params: Optional[Dict] = None,
        prompt: Optional[torch.Tensor] = None,
        budgets: Optional[Sequence[int]] = None,
        pca_basis: Optional[torch.Tensor] = None, mode: str = "synopsis",
        batches: int = 1, pipeline: bool = False,
        keep_logits: bool = False, log=print) -> Dict:
  """Prefill ``batch`` prompts, build the synopsis, decode ``tokens``
  greedy tokens.  ``params``/``prompt`` default to random ones drawn from
  ``seed``; ``budgets`` fixes the budget of each step instead of the
  deadline controller (parity tests); ``pca_basis`` is the clustering's
  PCA start (``core.cluster.initial_basis``).

  ``batches`` > 1 prefills and builds that many prompt batches (batch 0
  is ``prompt``, the others drawn from ``seed`` after it); decode consumes
  batch 0 and the other batches' caches are freed.  Serially each batch
  is waited for; with ``pipeline`` batch i+1's prefill is launched before
  batch i's build, all on the one stream, with no wait until every stage
  is queued (the JAX loop's dispatch order).

  ``cfg.synopsis.quant`` selects the quantized synopsis arena
  (:func:`apply_quant`); exact mode builds no arena and refuses it, and a
  CUDA device refuses a ``+kv`` spec for a config with local layers
  (``serve_step.check_quant_device``).

  ``mode="exact"`` skips the build and the controller and records budget
  0 for every step.  Like the JAX loop it only advances ``pos``: the new
  tokens' KV is never appended, so every exact step attends over the
  prompt plus its own token.  A config with no attention position
  (mamba2) runs in exact mode whatever ``mode`` says, as the JAX loop
  does, and so refuses ``budgets`` and a quant spec.  Like the JAX loop,
  in either mode, the loop never writes a step's SSM state back: every
  step of a hybrid decodes from the prefill's ``conv_state`` /
  ``ssd_state`` (the engine advances them).

  Returns the generated ids (B, 1 + tokens), the last step's logits, the
  budget and wall time of every step, prefill and build times (ms, host
  clock around synchronised work, summed over the batches; build 0 in
  exact mode; both 0 when pipelined), the wall of all batches' prefill and
  build (``prefill_build_ms``), the number of absorbs and the final
  cache; with ``keep_logits`` also every step's logits (``step_logits``,
  the prefill's first)."""
  check_quant_device(cfg, device)
  if mode not in ("synopsis", "exact"):
    raise ValueError(f"mode={mode!r}: expected 'synopsis' or 'exact'")
  if not n_attn_positions(cfg):
    mode = "exact"                # nothing to synopsize
  if mode == "exact" and budgets is not None:
    raise ValueError("budgets fix the synopsis refinement; exact mode "
                     "has none")
  if mode == "exact" and qt.parse_qconfig(cfg.synopsis.quant).enabled:
    raise ValueError("quant sets the synopsis arena; exact mode builds "
                     "none")
  dev = resolve_device(device)
  gen = torch.Generator(dev).manual_seed(seed)
  if params is None:
    params = tf.init_model(cfg, gen, dev)
  if prompt is None:
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
  prompts = [prompt.to(dev)] + [
      torch.randint(0, cfg.vocab, tuple(prompt.shape), generator=gen,
                    device=dev) for _ in range(batches - 1)]
  if budgets is not None and len(budgets) < tokens:
    raise ValueError(f"{len(budgets)} budgets for {tokens} steps")
  if batches < 1:
    raise ValueError(f"batches={batches}: at least one batch")

  prefill = make_prefill_step(cfg)
  build = functools.partial(skv.build, cfg=cfg, basis=pca_basis)
  synopsis = mode == "synopsis"
  pipelined = pipeline and synopsis
  logits_b, caches = [], []               # per batch
  prefill_ms = build_ms = 0.0
  _sync(dev)
  t_all = time.perf_counter()
  if pipelined:
    pending = None
    for p in prompts:
      lg, c = prefill(params, p)
      if pending is not None:
        caches.append(build(pending))      # queued behind the next prefill
      logits_b.append(lg)
      pending = c
    caches.append(build(pending))
    _sync(dev)
  else:
    for p in prompts:
      t0 = time.perf_counter()
      lg, c = prefill(params, p)
      _sync(dev)
      prefill_ms += (time.perf_counter() - t0) * 1e3
      if synopsis:
        t0 = time.perf_counter()
        c = build(c)
        _sync(dev)
        build_ms += (time.perf_counter() - t0) * 1e3
      logits_b.append(lg)
      caches.append(c)
  prefill_build_ms = (time.perf_counter() - t_all) * 1e3
  # Decode consumes batch 0 only: the other batches' caches are freed.
  logits, cache = logits_b[0], caches[0]
  del logits_b, caches
  stages = "prefill+build" if synopsis else "prefill"
  log(f"[{stages}] {batches} batch(es) x {tuple(prompt.shape)} tokens in "
      f"{prefill_build_ms:.1f}ms ({'pipelined' if pipelined else 'serial'})"
      + ("" if pipelined else f": prefill {prefill_ms:.1f}ms"
         + (f", build {build_ms:.1f}ms" if synopsis else "")))
  if synopsis:
    log(f"[synopsis] M={cache['k_syn'].shape[4]} clusters of "
        f"C={cfg.synopsis.cluster_size}, quant={cfg.synopsis.quant}")

  ctrl = BudgetController(
      make_predictor("affine", base=5.0, slope=1.0, alpha=0.1),
      buckets=BUCKETS, i_max_cap=cfg.synopsis.i_max or BUCKETS[-1])
  steps = {}
  tok = logits.argmax(-1, keepdim=True)
  out_tokens = [tok]
  step_logits = [logits] if keep_logits else None
  step_ms, chosen, absorbs = [], [], 0
  for i in range(tokens):
    if mode == "exact":
      budget = 0
    elif budgets is not None:
      budget = int(budgets[i])
    else:
      budget = ctrl.budget_for(deadline_ms)
    if budget not in steps:
      steps[budget] = make_serve_step(cfg, mode=mode, i_max=budget)
    t0 = time.perf_counter()
    logits, st = steps[budget](params, cache, tok)
    _sync(dev)
    dt = (time.perf_counter() - t0) * 1e3
    cache["pos"] = st["pos"]      # st's SSM state is dropped, as in JAX
    if mode == "synopsis":
      ctrl.observe(budget, dt)
      cache = skv.append_recent(cache, st["k_delta"], st["v_delta"])
      if int(cache["recent_len"][0]) >= cfg.synopsis.recent:
        cache = skv.absorb_recent(cache, cfg)
        absorbs += 1
        log(f"[update] absorbed recent buffer -> "
            f"M={cache['k_syn'].shape[4]}")
    tok = logits.argmax(-1, keepdim=True)
    out_tokens.append(tok)
    if keep_logits:
      step_logits.append(logits)
    step_ms.append(dt)
    chosen.append(budget)
    log(f"[decode {i:3d}] budget={budget:3d} {dt:7.1f}ms")
  generated = torch.cat(out_tokens, 1)
  log(f"generated: {generated[0].tolist()}")
  return {"tokens": generated, "logits": logits, "budgets": chosen,
          "step_ms": step_ms, "step_logits": step_logits,
          "prefill_ms": prefill_ms, "build_ms": build_ms,
          "prefill_build_ms": prefill_build_ms, "absorbs": absorbs,
          "cache": cache}


def _refuse_unported(ap, args) -> None:
  """What the engine and the tiers do not take."""
  if args.fleet and not args.cluster:
    ap.error("--fleet needs --cluster N (the component count; --replicas R "
             "sets the replica rows)")
  if args.fleet and (args.faults or args.no_recovery or args.retries != 1):
    ap.error("--fleet takes no --faults, --no-recovery or --retries: the "
             "fleet tier is non-resilient (they ride --cluster alone)")
  if args.autoscale and not args.cluster:
    ap.error("--autoscale requires --fleet (or --cluster N)")
  if args.cluster < 0:
    ap.error(f"--cluster {args.cluster}: a component count >= 1")
  if (args.engine or args.cluster) and (args.mode != "synopsis"
                                        or args.budget is not None):
    ap.error("--engine takes neither --mode exact nor --budget: the engine "
             "has no exact arm (--policy basic is its full-budget "
             "comparison), and --policy sets its budgets")


def engine_main(args, device: torch.device) -> Dict:
  """The continuous-batching engine over an arrival trace: one
  measurement window of Poisson arrivals per rate point."""
  from repro_torch.control import AdmissionConfig, parse_slo_classes
  from repro_torch.serve.corpus_cache import CacheConfig
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.resilience import parse_fault_spec
  from repro_torch.serving.workload import CF_RATES, hour_rate
  cfg = apply_quant(get_config(args.arch, smoke=args.smoke), args.quant)
  C = cfg.synopsis.cluster_size
  prompt_len = max(C, (args.prompt_len // C) * C)
  max_new = min(args.tokens, cfg.synopsis.recent)
  admission = None
  if args.admission != "off":
    admission = AdmissionConfig(
        order=args.admission, shed=not args.no_shed,
        shed_margin=args.shed_margin,
        classes=parse_slo_classes(args.slo_classes))
  cache = None
  if args.cache_capacity > 0 and not args.no_cache:
    cache = CacheConfig(capacity=args.cache_capacity, delta_unit=C)
  # A world from the launcher (torchrun): the tier's mesh over its first
  # N (R*N) ranks; rank 0 alone prints.
  comm = world.init_from_env(device) if args.cluster else None
  ranks, rank = world.world_size(), world.rank()
  if comm == "nccl":
    device = world.rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                          rank)), comm)
    torch.cuda.set_device(device)
  need = args.cluster * (max(1, args.replicas) if args.fleet else 1)
  say = print if rank == 0 else (lambda *a, **k: None)
  if args.cluster and ranks > need and rank >= need:
    from repro_torch.dist import topology  # noqa: PLC0415
    if args.fleet:
      topology.make_fleet_mesh(args.cluster, max(1, args.replicas))
    else:
      topology.make_component_mesh(args.cluster)
    return {"rank": rank, "idle": True}
  backend = None
  if args.fleet:
    from repro_torch.serve.fleet import (  # noqa: PLC0415
        FleetConfig, FleetStepBackend)
    backend = FleetStepBackend(FleetConfig(
        n_components=args.cluster, skew=args.skew, alloc=args.alloc,
        route=args.route, replicas=max(1, args.replicas),
        predictor=args.predictor or "ewma"))
  elif args.cluster:
    from repro_torch.serve.cluster import (  # noqa: PLC0415
        ClusterConfig, ClusterStepBackend)
    backend = ClusterStepBackend(ClusterConfig(
        n_components=args.cluster, skew=args.skew, alloc=args.alloc,
        route=args.route, replicas=args.replicas,
        predictor=args.predictor or "ewma",
        faults=parse_fault_spec(args.faults),
        recovery=not args.no_recovery, retries=args.retries))
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=args.n_slots, prompt_len=prompt_len, max_new_tokens=max_new,
      deadline_ms=args.deadline_ms, policy=args.policy,
      predictor=args.predictor or "affine", seed=args.seed,
      admission=admission, cache=cache, contract=args.contract,
      epsilon=args.epsilon), backend=backend, device=device)
  kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")
  say(f"[engine] {cfg.name} on {kind} policy={args.policy} "
      f"slots={args.n_slots} prompt={prompt_len} tokens={max_new} "
      f"M={eng.M} buckets={eng.buckets} deadline={args.deadline_ms}ms "
      f"quant={cfg.synopsis.quant} graphs={len(eng.programs.graphs)}"
      + (f" contract={args.contract} eps={args.epsilon}"
         if args.contract != "deadline" else "")
      + (f" admission={args.admission}" if admission is not None else "")
      + (f" cache={args.cache_capacity}" if cache is not None else ""))
  if backend is not None:
    where = (f"mesh, {ranks} ranks, {comm}, eager steps"
             if backend.mesh is not None else
             f"stacked, {ranks} rank{'s' * (ranks > 1)}")
    say(f"[{'fleet' if args.fleet else 'cluster'}] N={args.cluster} "
        f"({where}) counts={backend.topo.counts} "
        f"alloc={args.alloc} route={args.route} skew={args.skew} "
        f"R={backend.topo.replicas if args.fleet else args.replicas}"
        f"{' replica rows' if args.fleet else ''} "
        f"predictor={args.predictor or 'ewma'}")
  if args.trace == "cf_rates":
    points = [(f"rate{r}", r * args.rate_scale) for r in CF_RATES]
  else:
    points = [(f"hour{int(h):02d}", hour_rate(int(h)) * args.rate_scale)
              for h in args.hours.split(",")]
  slo_of = None
  if admission is not None and admission.classes:
    names = [c.name for c in admission.classes]
    slo_of = lambda rid: names[rid % len(names)]  # noqa: E731
  results = {}
  for name, rate in points:
    s = run_open_loop(eng, rate_per_s=rate, duration_s=args.duration,
                      seed=0, slo_of=slo_of, zipf_corpora=args.zipf_corpora)
    results[name] = {
        "rate_per_s": rate,
        **{k: round(float(v), 3) for k, v in s.items()
           if not isinstance(v, dict)},
        **({"classes": s["classes"]} if "classes" in s else {})}
    say(f"[{name}] rate={rate:6.1f}/s n={s['n']:4.0f} "
        f"p50={s['p50']:7.1f}ms p99={s['p99']:7.1f}ms "
        f"p999={s['p999']:7.1f}ms loss={s['accuracy_loss_pct']:5.2f}% "
        f"miss={s['deadline_miss_pct']:5.1f}% "
        f"budget={s['mean_budget']:.2f} "
        f"shed={s['shed_pct']:.1f}% goodput={s['goodput_per_s']:.1f}/s"
        + (f" hit_rate={s['cache_hit_rate']:.2f}"
           if "cache_hit_rate" in s else "")
        + (f" pred={s['pred_loss_mean']:.4f} "
           f"band_cov={s['band_cover_pct']:.0f}% "
           f"freed={s['freed_budget_mean']:.2f}"
           if "pred_loss_mean" in s else ""))
    if backend is not None and any(backend.fault_stats.values()):
      say(f"  [faults] {backend.fault_stats}")
  out = {"trace": args.trace, "policy": args.policy, "device": kind,
         "results": results}
  if backend is not None:
    exp = backend.export()
    out["cluster"] = {
        "n_components": args.cluster, "skew": args.skew,
        "alloc": args.alloc, "route": args.route,
        "counts": list(backend.topo.counts),
        "comp_ms_full": [round(float(v), 4)
                         for v in exp.step_ms_per_component(100)],
    }
    say(f"[cluster] measured per-component ms at full budget: "
        f"{out['cluster']['comp_ms_full']}")
  if rank != 0:
    return out
  if args.autoscale:
    out["autoscale"] = autoscale_main(args, backend)
  if args.json:
    with open(args.json, "w") as f:
      json.dump(out, f, indent=1, sort_keys=True)
    print(f"# wrote {args.json}")
  return out


def autoscale_main(args, backend) -> Dict:
  """Elastic sizing over the 24-hour Sogou trace: each hour the autoscaler
  decides the (components, replicas) grid from the backend's measured
  export (rescaled by ``ScaledFleetExport``), and the discrete-event
  simulator replays the hour's window at that size.  Host only: no step
  runs on the device."""
  from repro_torch.control import Autoscaler, AutoscalerConfig
  from repro_torch.serving.service import (ScaledFleetExport,
                                           ScatterGatherService,
                                           ServiceConfig)
  from repro_torch.serving.workload import hour_rate
  exp = backend.export()
  n_max, r_max = args.cluster, max(1, args.replicas)
  asc = Autoscaler(AutoscalerConfig(
      p99_target_ms=args.p99_target, max_components=n_max,
      max_replicas=r_max, slots=args.n_slots),
      ScaledFleetExport(exp, n_max, r_max).step_model)
  print(f"[autoscale] p99 target {args.p99_target}ms, grid up to "
        f"{n_max}x{r_max}, 24 sogou hours x rate_scale={args.rate_scale}")
  size = None
  windows = []
  cost_auto = cost_static = 0
  for h in range(24):
    rate = hour_rate(h) * args.rate_scale
    size = asc.decide(rate, size)
    sim = ScatterGatherService(
        ServiceConfig(n_components=size.n_components,
                      deadline_ms=args.deadline_ms, seed=h),
        step_backend=ScaledFleetExport(exp, size.n_components,
                                       size.replicas))
    s = sim.run_open_loop(rate, args.duration)
    cost_auto += size.devices
    cost_static += n_max * r_max
    windows.append({"hour": h, "rate_per_s": round(rate, 2),
                    "n": size.n_components, "r": size.replicas,
                    "p99_ms": round(float(s["p99"]), 2)})
    print(f"[hour{h:02d}] rate={rate:6.1f}/s grid="
          f"{size.n_components}x{size.replicas} p99={s['p99']:7.1f}ms")
  print(f"[autoscale] component-hours: autoscaled={cost_auto} "
        f"static-peak={cost_static}")
  return {"p99_target_ms": args.p99_target, "windows": windows,
          "component_hours": cost_auto,
          "component_hours_static": cost_static}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
  ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                  default=True,
                  help="the arch's small test config (--no-smoke: full "
                       "width and depth)")
  ap.add_argument("--batch", type=int, default=2)
  ap.add_argument("--prompt-len", type=int, default=256)
  ap.add_argument("--tokens", type=int, default=32)
  ap.add_argument("--batches", type=int, default=1,
                  help="prompt batches to prefill and build (decode "
                       "consumes batch 0)")
  ap.add_argument("--pipeline", action="store_true",
                  help="launch batch i+1's prefill before batch i's build, "
                       "with no wait until all are queued (one stream)")
  ap.add_argument("--mode", default="synopsis",
                  choices=["exact", "synopsis"],
                  help="synopsis: AccuracyTrader decode; exact: the exact "
                       "baseline over the whole cache")
  ap.add_argument("--quant", default="none", choices=list(qt.QSPECS),
                  help="quantize the synopsis arena: int8/fp8 centroids "
                       "with per-centroid scales; the '+kv' specs also the "
                       "sorted cache with per-cluster-block scales (synopsis "
                       "mode only)")
  ap.add_argument("--deadline-ms", type=float, default=50.0)
  ap.add_argument("--budget", type=int, default=None,
                  help="fix every step's refinement budget (clusters) "
                       "instead of the deadline controller")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default; required unless cpu is asked for) "
                       "or cpu (the kernels' plain PyTorch versions)")
  ap.add_argument("--seed", type=int, default=0)
  eng = ap.add_argument_group("engine (--engine)")
  eng.add_argument("--engine", action="store_true",
                   help="run the continuous-batching engine over an "
                        "arrival trace instead of the single-batch loop")
  eng.add_argument("--trace", default="cf_rates",
                   choices=["cf_rates", "sogou_hourly"],
                   help="arrival-rate source")
  eng.add_argument("--policy", default="accuracytrader",
                   choices=["basic", "partial", "accuracytrader", "fixed"])
  eng.add_argument("--n-slots", type=int, default=2,
                   help="batch lanes (max resident requests)")
  eng.add_argument("--duration", type=float, default=1.0,
                   help="seconds of arrivals per measurement window")
  eng.add_argument("--rate-scale", type=float, default=1.0,
                   help="multiplies every arrival rate of the trace")
  eng.add_argument("--hours", default="3,9,21",
                   help="hours of day of --trace sogou_hourly")
  eng.add_argument("--predictor", default=None,
                   help="affine | ewma | quantile[:pct] (default: affine, "
                        "ewma with --cluster)")
  eng.add_argument("--contract", default="deadline",
                   choices=["deadline", "error_bounded",
                            "deadline_with_bound"],
                   help="serving contract: error_bounded answers early "
                        "once the online estimator predicts loss <= "
                        "--epsilon; deadline_with_bound attaches a loss "
                        "band to every answer")
  eng.add_argument("--epsilon", type=float, default=0.02,
                   help="error_bounded's loss target (0: full budget)")
  eng.add_argument("--admission", default="off",
                   choices=["off", "fifo", "edf", "slack"],
                   help="queue-aware admission: ready-queue order (edf: "
                        "earliest deadline first, slack: least predicted "
                        "slack) with predictive shedding; off: the FIFO "
                        "queue, no shedding")
  eng.add_argument("--slo-classes", default=None, metavar="SPEC",
                   help="SLO classes for --admission, "
                        "'name:deadline_ms[@rate_per_s[/burst]]' joined by "
                        "commas, e.g. 'interactive:80@60,batch:400'; "
                        "requests take the classes in turn")
  eng.add_argument("--shed-margin", type=float, default=1.0,
                   help="shed at admission when the predicted completion "
                        "exceeds deadline * margin")
  eng.add_argument("--no-shed", action="store_true",
                   help="keep the admission order but never shed")
  eng.add_argument("--cache-capacity", type=int, default=0, metavar="K",
                   help="corpus cache: resident arenas (0: off); an "
                        "admission whose prompt is cached skips prefill "
                        "and build")
  eng.add_argument("--no-cache", action="store_true",
                   help="the cache off whatever --cache-capacity says")
  eng.add_argument("--zipf-corpora", type=int, default=0, metavar="K",
                   help="draw the prompts from K corpora of Zipf "
                        "popularity (0: a fresh prompt per request)")
  eng.add_argument("--json", default=None, metavar="PATH",
                   help="write the sweep's results as JSON")
  tier = ap.add_argument_group("scatter-gather tier (--cluster N)")
  tier.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="run the decode steps on the N-component "
                         "scatter-gather tier, stacked on one device "
                         "(implies --engine)")
  tier.add_argument("--skew", type=float, default=0.0,
                    help="Zipf exponent over the components' corpus shares")
  tier.add_argument("--alloc", default="mass",
                    choices=["mass", "topk", "gain"],
                    help="the frontend's budget split: by relevance mass, "
                         "global top-k, or global top-k by marginal gain")
  tier.add_argument("--route", default="fixed", choices=["fixed", "rotate"],
                    help="per-slot cluster -> component routing (rotate "
                         "spreads skewed ranges over the components)")
  tier.add_argument("--replicas", type=int, default=1, metavar="R",
                    help="shard copies on the component ring (R >= 2 hedges "
                         "a predicted straggler onto its replica); with "
                         "--fleet the replica rows of materialized copies")
  tier.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject component faults: key=value pairs joined "
                         "by commas, e.g. 'crash=1@8,stall_rate=0.02,seed=3'"
                         " (crash entries comp@step joined by +)")
  tier.add_argument("--no-recovery", action="store_true",
                    help="no retry to a replica and no stage-1 fallback: a "
                         "dead shard stalls the gather and is dropped")
  tier.add_argument("--retries", type=int, default=1, metavar="K",
                    help="retries per component per step over the replica "
                         "ring, with exponential backoff (1: one hedge)")
  fleet = ap.add_argument_group("fleet tier (--fleet, with --cluster N)")
  fleet.add_argument("--fleet", action="store_true",
                     help="run the fleet tier: --replicas rows of "
                          "materialized copies of every shard, each step "
                          "reading every shard from its fastest-predicted "
                          "holder (needs --cluster N)")
  fleet.add_argument("--autoscale", action="store_true",
                     help="after the sweep, size the (components, "
                          "replicas) grid hour by hour over the 24 sogou "
                          "hours against --p99-target from the measured "
                          "export, replaying each hour in the simulator")
  fleet.add_argument("--p99-target", type=float, default=50.0,
                     help="the autoscaler's latency target (ms)")
  args = ap.parse_args(argv)
  _refuse_unported(ap, args)
  try:
    device = resolve_device(args.device)
  except RuntimeError as e:
    ap.error(str(e))
  if args.engine or args.cluster:
    return engine_main(args, device)
  cfg = get_config(args.arch, smoke=args.smoke)
  if not n_attn_positions(cfg):
    args.mode = "exact"           # no attention: nothing to synopsize
  if args.mode == "exact" and args.budget is not None:
    ap.error("--budget sets the synopsis refinement; --mode exact has none")
  if args.mode == "exact" and args.quant != "none":
    ap.error("--quant sets the synopsis arena; --mode exact builds none")
  cfg = apply_quant(cfg, args.quant)
  budgets = None if args.budget is None else [args.budget] * args.tokens
  return run(cfg, batch=args.batch, prompt_len=args.prompt_len,
             tokens=args.tokens, deadline_ms=args.deadline_ms,
             device=device, seed=args.seed, budgets=budgets, mode=args.mode,
             batches=args.batches, pipeline=args.pipeline)


if __name__ == "__main__":
  main()
