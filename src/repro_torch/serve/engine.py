"""Deadline-driven continuous-batching serving engine (counterpart of
``repro.serve.engine``).

Requests from an arrival trace (``serving.workload``) occupy slots in a
shared synopsis-KV slot pool, and each decode step picks its refinement
budget with the deadline controller (``control.DeadlineBudgetPolicy`` over
a pluggable predictor), calibrated by measured step wall times.

Slot lifecycle: a request is admitted to a free lane (prefill -> synopsis
build -> ``kv_cache.write_slot``), decodes through budgeted serve steps
shared with the other resident slots (stage 1 always runs; stage 2 refines
the budget's clusters), appends its new tokens to its own recent-ring
position (``synopsis_kv.append_recent_slots``), and retires when its token
target is reached, freeing the lane mid-flight.  A slot never absorbs:
``max_new_tokens <= recent``, so the pool's shapes never change.

Programs: the JAX engine jits one serve step per budget bucket and one
append program; here each is a program of ``serve.graphs.Programs``, one
captured CUDA graph on the card and an eager call on the CPU.  The step is
read-only: it reads the pool and the token column and writes static
outputs (logits, the new token's per-layer KV, ``pos``); the append
program writes the ring, ``pos`` and the token column of the active lanes
only.  Every graph is captured in ``_warmup`` and replayed from the first
measured step on.  Prefill, build and the slot write stay eager: each runs
once an admission, and their kernels are long.  Everything runs on one
stream (the decode kernels' merge tickets assume it); admission overlaps
decode through asynchronous launches, as the JAX engine's through
asynchronous dispatch.

Policies (the simulator's techniques, in measured time):

  * ``basic``          full budget every step, nothing dropped.
  * ``partial``        full budget, but a request still resident at its
                       deadline is dropped mid-flight, and one finishing
                       late scores 0 (the paper's skipped partial results).
  * ``accuracytrader`` per-step bucketed budget from the deadline
                       controller against the most urgent resident
                       request's remaining time; stage 1 always lands.
  * ``fixed``          constant budget (parity runs).

The engine has no exact arm: ``basic`` (budget M every step) is its
full-budget comparison, and the exact baseline is
``launch.serve.run(mode="exact")``.  The corpus cache (ROADMAP A.5),
queue-aware admission (A.4), the ε-or-deadline contracts (A.3) and the
multi-component step backends (A.7) are not ported: asking for one raises.

:class:`MeasuredStepBackend` exports the measured per-bucket step times to
the simulator (``serving.service.ScatterGatherService(step_backend=...)``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.control import (POLICIES, DeadlineBudgetPolicy, TailTracker,
                                 make_predictor)
from repro_torch.control.policy import check_contract
from repro_torch.core import cluster as cl
from repro_torch.kernels import _build
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.graphs import Programs
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.serving.service import _default_concentration
from repro_torch.serving.workload import poisson_arrivals


@dataclasses.dataclass
class EngineConfig:
  """Engine knobs (the model's shape comes from the ModelConfig)."""
  n_slots: int = 4                 # batch lanes == max resident requests
  prompt_len: int = 128            # tokens per admitted prompt
  max_new_tokens: int = 8          # decode steps per request (<= recent)
  deadline_ms: float = 80.0        # per-request service deadline
  policy: str = "accuracytrader"
  fixed_budget: int = 0            # for policy="fixed"
  buckets: Optional[Sequence[int]] = None   # None -> {0, 1, 2, 4, ..., M}
  # Latency-predictor spec of the budget controller: "affine", "ewma" or
  # "quantile[:pct]".
  predictor: str = "affine"
  seed: int = 0
  # Dispatch the admissions of an iteration and the residents' decode
  # step without a wait between them, so that the device runs them back
  # to back.
  overlap_admission: bool = True
  admission: Optional[object] = None   # ROADMAP A.4: must stay None
  cache: Optional[object] = None       # ROADMAP A.5: must stay None
  contract: str = "deadline"           # ROADMAP A.3: "deadline" only


@dataclasses.dataclass
class EngineRequest:
  rid: int
  arrival_ms: float
  prompt: np.ndarray               # (prompt_len,) int32
  max_new_tokens: int
  # Filled by the engine:
  admit_ms: float = -1.0
  finish_ms: float = -1.0
  # Measured wall of this request's own (blocking) admission; 0.0 on the
  # overlapped path, where admissions share one wait with the decode step.
  admit_wall_ms: float = 0.0
  tokens: List[int] = dataclasses.field(default_factory=list)
  budgets: List[int] = dataclasses.field(default_factory=list)
  accuracy: float = 0.0
  dropped: bool = False            # shed mid-flight (partial execution)

  @property
  def latency_ms(self) -> float:
    return self.finish_ms - self.arrival_ms

  @property
  def queue_ms(self) -> float:
    return self.admit_ms - self.arrival_ms


@dataclasses.dataclass
class _Slot:
  req: EngineRequest
  remaining: int


def _refuse_off_forms(ecfg: EngineConfig, backend) -> None:
  """The features whose modules the port has not ported raise; none is
  ignored."""
  if backend is not None:
    raise NotImplementedError(
        "multi-component step backends (scatter-gather cluster, fleet) are "
        "not ported yet (ROADMAP A.7)")
  if ecfg.cache is not None:
    raise NotImplementedError("the corpus cache is not ported yet "
                              "(ROADMAP A.5)")
  if ecfg.admission is not None:
    raise NotImplementedError("queue-aware admission is not ported yet "
                              "(ROADMAP A.4)")
  check_contract(ecfg.contract)


class ServingEngine:
  """Continuous-batching AccuracyTrader engine over the kernel serve path.

  ``params`` and ``pca_basis`` (the clustering's PCA start,
  ``core.cluster.initial_basis``) default to ones drawn from
  ``ecfg.seed``.  ``accuracy_fn`` maps the fraction of ranked clusters
  refined in a step to result accuracy (default: the simulator's fig-4
  concentration curve).  ``device`` is ``"cuda"`` unless the CPU is asked
  for."""

  def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params=None,
               pca_basis: Optional[torch.Tensor] = None,
               accuracy_fn: Optional[Callable[[float], float]] = None,
               backend=None, device="cuda"):
    _refuse_off_forms(ecfg, backend)
    tf.check_supported(cfg)
    C = cfg.synopsis.cluster_size
    if ecfg.prompt_len % C != 0:
      raise ValueError(f"prompt_len {ecfg.prompt_len} % cluster_size {C}")
    if ecfg.max_new_tokens > cfg.synopsis.recent:
      raise ValueError(
          f"max_new_tokens {ecfg.max_new_tokens} > recent ring "
          f"{cfg.synopsis.recent}: a slot's decode residency must fit the "
          "ring (the engine never absorbs)")
    if ecfg.policy not in POLICIES:
      raise ValueError(f"policy {ecfg.policy!r} not in {POLICIES}")
    self.cfg = cfg
    self.ecfg = ecfg
    self.M = ecfg.prompt_len // C
    if ecfg.buckets is not None:
      buckets = tuple(sorted({int(b) for b in ecfg.buckets}))
    else:
      buckets = [0]
      b = 1
      while b < self.M:
        buckets.append(b)
        b *= 2
      buckets = tuple(buckets + [self.M])
    if any(b < 0 or b > self.M for b in buckets):
      raise ValueError(f"buckets {buckets} outside [0, M={self.M}]")
    self.buckets = buckets
    if ecfg.policy == "fixed" and ecfg.fixed_budget not in buckets:
      self.buckets = tuple(sorted(set(buckets) | {ecfg.fixed_budget}))
    self.accuracy_fn = accuracy_fn or _default_concentration
    self.controller = self._make_policy()

    dev = resolve_device(device)
    if params is None:
      params = tf.init_model(cfg, torch.Generator(dev).manual_seed(ecfg.seed),
                             dev)
    self.params = params
    if pca_basis is None:
      pca_basis = cl.initial_basis(cfg.n_kv_heads * cfg.hd, seed=ecfg.seed)
    # On the device once: a host tensor would be copied (and the stream
    # waited for) at every admission's build.
    basis = torch.as_tensor(pca_basis, dtype=torch.float32).to(dev)
    self._prefill = make_prefill_step(cfg)
    self._build = lambda c: skv.build(c, cfg, basis=basis)
    n, P = ecfg.n_slots, ecfg.prompt_len
    self._bx = kvc.slot_batch_axes(cfg, n, P, synopsis=True)
    # The slot pool and the programs' static buffers: allocated once and
    # written in place from here on (the graphs read fixed addresses).
    self.cache = kvc.zeros_cache(cfg, n, P, synopsis=True, device=dev)
    self.tok = torch.zeros((n, 1), dtype=torch.long, device=dev)
    self.dev = self.tok.device                 # with its index
    self._amask = torch.zeros((n,), dtype=torch.bool, device=dev)
    # Its host side, pinned on the card so that the copy does not wait
    # for the work queued ahead (the admissions of an overlapped step).
    self._amask_host = torch.zeros((n,), dtype=torch.bool,
                                   pin_memory=dev.type == "cuda")
    self._new_tok = torch.zeros((n,), dtype=torch.long, device=dev)
    delta = (cfg.n_blocks, len(cfg.block_pattern), n, cfg.n_kv_heads, 1,
             cfg.hd)
    self.step_out = {
        "logits": torch.zeros((n, cfg.vocab), dtype=torch.float32,
                              device=dev),
        "k_delta": torch.zeros(delta, dtype=cfg.dtype, device=dev),
        "v_delta": torch.zeros(delta, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((n,), dtype=torch.int32, device=dev),
    }
    self.programs = Programs(self.dev)
    for b in self.buckets:
      self.programs.add(("step", b), self._step_program(b))
    self.programs.add("append", self._append_program())
    self._warming = False

    self.reset()
    self._warmup()

  def _make_policy(self) -> DeadlineBudgetPolicy:
    """The engine's slice of the control plane: one DeadlineBudgetPolicy
    whose predictor is calibrated by measured step wall times."""
    e = self.ecfg
    kw = {"base": 2.0, "slope": 0.5, "alpha": 0.1} \
        if e.predictor.startswith("affine") else {}
    return DeadlineBudgetPolicy(
        policy=e.policy, buckets=self.buckets, i_max_cap=self.M,
        predictor=make_predictor(e.predictor, **kw),
        fixed_budget=e.fixed_budget, contract=e.contract)

  # -- programs -------------------------------------------------------------
  # The programs close over the tensors they read and write, not over the
  # engine, so that an engine is freed (its pool and graphs with it) as
  # soon as its last reference goes.
  def _step_program(self, budget: int) -> Callable[[], None]:
    """The read-only serve step at ``budget``: pool + token column ->
    ``step_out``."""
    step = make_serve_step(self.cfg, mode="synopsis", i_max=budget)
    params, cache, tok, out = self.params, self.cache, self.tok, self.step_out

    def program():
      logits, st = step(params, cache, tok)
      out["logits"].copy_(logits)
      for name in ("k_delta", "v_delta", "pos"):
        out[name].copy_(st[name])

    return program

  def _append_program(self) -> Callable[[], None]:
    """``step_out`` -> the active lanes' ring row, ``pos`` and token; the
    argmax of every lane into ``_new_tok``.  With no lane active it
    changes nothing (the capture's warm-up calls rely on that)."""
    cache, tok, out, m = self.cache, self.tok, self.step_out, self._amask
    new_tok = self._new_tok

    def program():
      skv.append_recent_slots(cache, out["k_delta"], out["v_delta"], m)
      pos = cache["pos"]
      pos.copy_(torch.where(m, out["pos"], pos))
      new = out["logits"].argmax(-1)
      new_tok.copy_(new)
      tok.copy_(torch.where(m[:, None], new[:, None], tok))

    return program

  def _sync(self) -> None:
    if self.dev.type == "cuda":
      torch.cuda.synchronize(self.dev)

  # -- state ----------------------------------------------------------------
  def reset(self) -> None:
    """Fresh slots, pool and clock for a new measurement window; the pool
    is zeroed in place.  The latency model persists across windows by
    default (as in the simulator's ``run_open_loop``)."""
    for leaf in self.cache.values():
      leaf.zero_()
    self.tok.zero_()
    self._amask.zero_()
    self.slots: List[Optional[_Slot]] = [None] * self.ecfg.n_slots
    self.now_ms = 0.0
    self.completed: List[EngineRequest] = []
    self.events = []                 # (kind, rid, slot, now_ms)
    self.step_log = []               # (budget, ms, active)
    self.prefills = 0

  def _warm_buckets(self) -> Sequence[int]:
    p = self.ecfg.policy
    if p == "accuracytrader":
      return self.buckets
    if p == "fixed":
      return (self.ecfg.fixed_budget,)
    return (self.M,)

  def _warmup(self) -> None:
    """Admit a dummy request (the kernels' library loads, prefill and
    build run once), capture the graph of every bucket the run can
    dispatch and of the append program, and replay each once, so that the
    first measured step is a replay; then discard the state.  The decode
    kernels' merge tickets are allocated before any capture, at the
    largest row count a step gives them, so that they do not land in the
    graphs' pool."""
    self._warming = True
    if self.dev.type == "cuda":
      _build.tickets(self.dev, self.ecfg.n_slots * self.cfg.n_heads)
    warm = self._warm_buckets()
    req = EngineRequest(rid=-1, arrival_ms=0.0,
                        prompt=np.zeros((self.ecfg.prompt_len,), np.int32),
                        max_new_tokens=len(warm) + 1)
    self._admit(req, 0)
    self._amask.zero_()
    for b in warm:
      self.programs.capture(("step", b))
    self.programs.capture("append")
    for b in warm:
      self._decode_step([0], budget=b)
    self._warming = False
    self.reset()

  # -- scheduling -----------------------------------------------------------
  def _dispatch_admission(self, req: EngineRequest,
                          slot: int) -> torch.Tensor:
    """Launch one admission's prefill -> build -> slot write without
    waiting; returns the first token (1,) on the device."""
    prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long)[None]
    if self.dev.type == "cuda":
      # Pinned, so that the copy does not wait for the work queued ahead.
      prompt = prompt.pin_memory().to(self.dev, non_blocking=True)
    self.prefills += 1
    logits, cache1 = self._prefill(self.params, prompt)
    kvc.write_slot(self.cache, self._build(cache1), slot, self._bx)
    return logits.argmax(-1)

  def _admit(self, req: EngineRequest, slot: int) -> None:
    # queue_ms measures pure waiting: the clock *before* this request's
    # own prefill+build advances it.
    req.admit_ms = self.now_ms
    t0 = time.perf_counter()
    first = self._dispatch_admission(req, slot)
    self.tok[slot, 0] = first[0]
    first_id = int(first[0])             # waits for the admission
    dt = (time.perf_counter() - t0) * 1e3
    self.now_ms += dt
    req.admit_wall_ms = dt
    req.tokens.append(first_id)
    self.slots[slot] = _Slot(req, req.max_new_tokens)
    self.events.append(("admit", req.rid, slot, self.now_ms))

  def _pick_budget(self, active: Sequence[int],
                   extra: Sequence[EngineRequest] = ()) -> int:
    """``extra``: requests admitted concurrently with this step (admission
    overlap): the step stands between them and their first decode, so
    their deadlines clamp the budget as on the serial path."""
    remaining = 0.0
    if self.ecfg.policy == "accuracytrader":
      remaining = min(
          [self._abs_deadline(self.slots[i].req) - self.now_ms
           for i in active] +
          [self._abs_deadline(r) - self.now_ms for r in extra])
    return self.controller.budget_for(max(remaining, 0.0))

  def _abs_deadline(self, req: EngineRequest) -> float:
    return req.arrival_ms + self.ecfg.deadline_ms

  def _retire(self, slot: int) -> None:
    s = self.slots[slot]
    req = s.req
    req.finish_ms = self.now_ms
    req.dropped = s.remaining > 0      # shed mid-flight, not finished
    policy = self.ecfg.policy
    if policy == "basic":
      req.accuracy = 1.0
    elif policy == "partial":
      # Partial execution: a result missing at the deadline is skipped;
      # its entire accuracy contribution is lost (paper §5).
      late = req.dropped or req.latency_ms > self.ecfg.deadline_ms
      req.accuracy = 0.0 if late else 1.0
    else:
      # Stage 1 always landed; each step covered budget/M of the ranked
      # clusters exactly plus the synopsis estimate of the rest.
      fr = [min(b, self.M) / self.M for b in req.budgets] or [0.0]
      req.accuracy = float(np.mean([self.accuracy_fn(f) for f in fr]))
    self.slots[slot] = None
    self.completed.append(req)
    self.events.append(("retire", req.rid, slot, self.now_ms))

  def _decode_step(self, active: Sequence[int],
                   budget: Optional[int] = None,
                   admitted_at: Optional[float] = None) -> None:
    """One budgeted decode step for the ``active`` slots: the step's
    graph, then the append's, then one wait.  ``admitted_at`` (admission
    overlap): the host clock at which this iteration's admissions were
    dispatched; the measured window starts there, since their eager
    launches are host work the window pays for, and the controller does
    not observe it."""
    if budget is None:
      budget = self._pick_budget(active)
    t0 = time.perf_counter() if admitted_at is None else admitted_at
    mask = self._amask_host      # the last step's copy has completed
    mask.zero_()
    mask[list(active)] = True
    self._amask.copy_(mask, non_blocking=True)
    self.programs.run(("step", budget))
    self.programs.run("append")
    toks = self._new_tok.cpu().numpy()  # waits for the step
    dt = (time.perf_counter() - t0) * 1e3
    self.now_ms += dt
    if self.ecfg.policy == "accuracytrader" and not self._warming \
        and admitted_at is None:
      self.controller.observe(budget, dt)
    self.step_log.append((budget, dt, len(active)))
    for i in active:
      s = self.slots[i]
      s.req.tokens.append(int(toks[i]))
      s.req.budgets.append(budget)
      s.remaining -= 1
      if s.remaining <= 0:
        self._retire(i)

  # -- driving --------------------------------------------------------------
  def run(self, requests: Sequence[EngineRequest]) -> Dict[str, float]:
    """Drive the engine over an arrival trace; returns the window summary.

    The clock is hybrid: arrivals advance on the trace's clock, service
    advances by the measured wall time of each step and admission, so
    queueing delay under load is real, not modelled."""
    pending = collections.deque(
        sorted(requests, key=lambda r: (r.arrival_ms, r.rid)))
    while pending or any(s is not None for s in self.slots):
      if self.ecfg.policy == "partial":
        # Partial execution sheds unfinished work at the deadline: the
        # result is skipped (accuracy 0 via _retire) and the lane frees.
        for i, s in enumerate(self.slots):
          if s is not None and self.now_ms >= self._abs_deadline(s.req):
            self._retire(i)
      # Every arrived request that fits a free lane is admitted this
      # iteration: overlapped with the residents' decode step when there
      # are residents, else serially.
      free = [i for i, s in enumerate(self.slots) if s is None]
      admissions = []
      while free and pending and pending[0].arrival_ms <= self.now_ms:
        admissions.append((pending.popleft(), free.pop(0)))
      active = [i for i, s in enumerate(self.slots) if s is not None]
      if admissions and active and self.ecfg.overlap_admission:
        self._admit_overlapped(admissions, active)
        continue
      for req, slot in admissions:
        self._admit(req, slot)
      active = [i for i, s in enumerate(self.slots) if s is not None]
      if not active:
        if not pending:
          break
        # Idle: jump to the next arrival.
        self.now_ms = max(self.now_ms, pending[0].arrival_ms)
        continue
      self._decode_step(active)
    return self.summary()

  def _admit_overlapped(self, admissions, active: Sequence[int]) -> None:
    """Launch the admitted requests' prefill + build + slot writes, then
    the residents' decode step behind them, and wait once.  The writes
    land in lanes the step reads but does not decode (the admitted lanes
    are inactive in it), so the residents' tokens are those of the serial
    order; the JAX engine's step reads the pre-admission cache instead."""
    t_admit = self.now_ms
    budget = self._pick_budget(active, extra=[r for r, _ in admissions])
    t0 = time.perf_counter()
    firsts = []
    for req, slot in admissions:
      req.admit_ms = t_admit
      firsts.append(self._dispatch_admission(req, slot))
    self._decode_step(active, budget=budget, admitted_at=t0)
    for (req, slot), first in zip(admissions, firsts):
      self.tok[slot, 0] = first[0]
      req.tokens.append(int(first[0]))
      self.slots[slot] = _Slot(req, req.max_new_tokens)
      self.events.append(("admit", req.rid, slot, self.now_ms))

  def _class_stats(self, reqs: Sequence[EngineRequest]) -> Dict[str, float]:
    """Accounting over one request subset.  Every request is served here
    (no admission policy sheds one), so the admission-shed counts are 0
    and every request has a service latency."""
    tracker = TailTracker()
    for r in reqs:
      tracker.observe(r.latency_ms)
    s = tracker.summary()
    accs = [r.accuracy for r in reqs]
    s["accuracy_loss_pct"] = 100.0 * (1.0 - float(np.mean(accs))) \
        if accs else 0.0
    s["deadline_miss_pct"] = 100.0 * float(np.mean(
        [r.latency_ms > self.ecfg.deadline_ms for r in reqs])) \
        if reqs else 0.0
    s["queue_p99"] = float(np.percentile(
        [r.queue_ms for r in reqs], 99)) if reqs else 0.0
    s["shed_pct"] = 100.0 * float(np.mean(
        [r.dropped for r in reqs])) if reqs else 0.0
    s["shed_admission_n"] = 0
    s["served_n"] = len(reqs)
    # Goodput: requests actually answered within their own deadline.
    s["goodput_n"] = sum(1 for r in reqs if not r.dropped
                         and r.latency_ms <= self.ecfg.deadline_ms)
    # Availability: a request answered in full (not dropped mid-flight).
    s["availability_pct"] = 100.0 * float(np.mean(
        [not r.dropped for r in reqs])) if reqs else 100.0
    for p in (10, 50, 90):
      s[f"acc_p{p}"] = float(np.percentile(accs, p)) if accs else 0.0
    return s

  def summary(self) -> Dict[str, float]:
    s = self._class_stats(self.completed)
    s["mean_budget"] = float(np.mean([b for b, _, _ in self.step_log])) \
        if self.step_log else 0.0
    s["steps"] = len(self.step_log)
    s["prefills"] = self.prefills
    # Per-request admission wall percentiles (serial admissions only: the
    # overlapped path shares one wait with the decode step).
    walls = [r.admit_wall_ms for r in self.completed if r.admit_wall_ms > 0]
    s["admission_p50"] = float(np.percentile(walls, 50)) if walls else 0.0
    s["admission_p99"] = float(np.percentile(walls, 99)) if walls else 0.0
    s["goodput_per_s"] = s["goodput_n"] / (self.now_ms / 1e3) \
        if self.now_ms > 0 else 0.0
    return s

  # -- probes ---------------------------------------------------------------
  def probe_step_ms(self, budget: int, iters: int = 3) -> float:
    """Median host-clock latency of one bucketed serve step on the current
    pool, each replay waited for (the step is read-only: no state
    changes); the calibration source of :class:`MeasuredStepBackend`.  A
    bucket the run never dispatches is captured here first."""
    if budget not in self.buckets:
      raise ValueError(f"budget {budget} not a bucket {self.buckets}")
    key = ("step", budget)
    if self.programs.captures and key not in self.programs.graphs:
      self.programs.capture(key)
    self.programs.run(key)
    self._sync()
    ts = []
    for _ in range(iters):
      t0 = time.perf_counter()
      self.programs.run(key)
      self._sync()
      ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


class MeasuredStepBackend:
  """Measured per-bucket step latencies for the discrete-event simulator
  (``ScatterGatherService(step_backend=...)``): a component processing i
  ranked clusters costs what the engine measured for the corresponding
  bucket.  The simulator budgets clusters out of ``full_items`` (default
  100), the engine out of its M: a simulator budget ``i`` costs the bucket
  nearest ``i / full_items * M``."""

  def __init__(self, engine: ServingEngine, iters: int = 3,
               full_items: int = 100):
    self.buckets = engine.buckets
    self.M = engine.M
    self.full_items = full_items
    self.table = {b: engine.probe_step_ms(b, iters=iters)
                  for b in self.buckets}

  def step_ms(self, budget: int) -> float:
    scaled = budget / max(self.full_items, 1) * self.M
    nearest = min(self.buckets, key=lambda b: abs(b - scaled))
    return self.table[nearest]


def make_requests(arrivals_ms: Sequence[float], prompt_len: int,
                  max_new_tokens: int, vocab: int,
                  seed: int = 0) -> List[EngineRequest]:
  """Random-prompt requests at the given arrival offsets (ms); the same
  prompts as the JAX package's for the same seed."""
  rng = np.random.default_rng(seed)
  return [EngineRequest(rid=i, arrival_ms=float(t),
                        prompt=rng.integers(0, vocab, prompt_len,
                                            dtype=np.int32),
                        max_new_tokens=max_new_tokens)
          for i, t in enumerate(arrivals_ms)]


def run_open_loop(engine: ServingEngine, rate_per_s: float,
                  duration_s: float, seed: int = 0) -> Dict[str, float]:
  """One measurement window of Poisson arrivals at ``rate_per_s``; the
  arrivals and prompts derive from ``seed``."""
  engine.reset()
  arrivals = poisson_arrivals(rate_per_s, duration_s, seed=seed)
  reqs = make_requests(arrivals, engine.ecfg.prompt_len,
                       engine.ecfg.max_new_tokens, engine.cfg.vocab,
                       seed=seed)
  return engine.run(reqs)
