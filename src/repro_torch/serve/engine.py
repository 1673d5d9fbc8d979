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
outputs (logits, the new token's per-layer KV, ``pos``, and on a hybrid
the mamba layers' new ``conv_state`` / ``ssd_state``); the append program
writes the ring, ``pos``, the SSM state and the token column of the
active lanes only (the JAX engine's per-slot masked write of the SSM
state after each step).  A config with no attention position (mamba2)
is refused with ``ValueError``, as the JAX engine refuses it: there is
nothing to synopsize.  On an MoE layer the step's rows share the
experts' capacity (1 at decode for jamba), so the inactive lanes' rows
take part in the routing, as in the JAX engine.  Every graph is captured
in ``_warmup`` and replayed from the first measured step on.  Prefill,
build and the slot write stay eager: each runs once an admission, and
their kernels are long.  Everything runs on one
stream (the decode kernels' merge tickets assume it); admission overlaps
decode through asynchronous launches, as the JAX engine's through
asynchronous dispatch: the step's graph, then the admissions, then the
append's graph, so that the step reads the pool as it was before the
admissions, as the JAX step reads the pre-admission cache.

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
``launch.serve.run(mode="exact")``.

Serving contracts (``EngineConfig.contract``): under ``"deadline"`` the
step programs are the plain ones.  Under ``"error_bounded"`` and
``"deadline_with_bound"`` each step's attention also computes the stage-1
coverage profile (``control.estimator.coverage_profile``, from the scores
stage 1 already gave) and every bucket's graph writes its layer mean into
one more static output, read to the host after the step's wait; the
online estimator turns it into a per-request loss estimate and band, and
``error_bounded`` answers at the smallest bucket predicted to meet ε.

Queue-aware admission (``EngineConfig.admission``,
``control.admission``): arrivals wait in a ready queue ordered FIFO, EDF
or by least slack, rate-gated per SLO class, and a request predicted to
miss its deadline is shed before it costs a prefill.  Without a config the
queue is FIFO and sheds nothing.

The corpus cache (``EngineConfig.cache``, ``serve.corpus_cache``): an
admission whose prompt is cached copies the cached arena into its lane
(no prefill, no build); one that extends a cached prompt runs only the
extension (``prefill.make_extend_step`` and
``synopsis_kv.extend_synopsis``); a miss publishes its arena.

The scatter-gather cluster tier (``backend=serve.cluster.
ClusterStepBackend``, the stacked path): the backend owns the pool's
component layout (``zeros_cache``) and the admissions' scatter
(``write_slot``, corpus-cache hits included), each bucket's step program
(``step_fn``: one graph per bucket, the gather modes a static buffer
loaded before each replay), the gather decision before each step
(``plan_step``) and the accounting after it (``account``, from the step's
per-component telemetry ``fe_cover`` / ``fe_mass`` read after the wait):
the clock advances by the modelled *parallel* completion, each request's
accuracy is the mean of its steps' corpus-share-weighted accuracy, and a
step that dropped shard mass costs the request its availability.  The
engine's policy shares the backend's wall predictor, which only the
backend observes; admissions are serial (no overlap: the parallel clock
would hide their wall).  The fleet tier (``serve.fleet.FleetStepBackend``,
a cluster backend with R materialized replica rows) plugs in the same
way; each admission then pins its corpus-cache arena once for each of
the backend's ``replica_mappings``, and retirement releases them all.
Any other backend raises.

A backend on a mesh (one rank a component, ``dist.sharding.Mesh``): every
rank runs the engine, and its host decisions must be the same on every
rank, or the collectives' shapes differ and the ranks hang.  So the
measured walls (which move the clock, the admissions and the predictor)
and each step's budget and plan are rank 0's, broadcast before they are
used (:meth:`ServingEngine._agree`), and the programs run eagerly
(``Programs(capture=False)``: gloo collectives cannot be captured in a
CUDA graph).

:class:`MeasuredStepBackend` exports the measured per-bucket step times to
the simulator (``serving.service.ScatterGatherService(step_backend=...)``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.control import (POLICIES, AccuracyEstimator, AdmissionConfig,
                                 AdmissionPolicy, DeadlineBudgetPolicy,
                                 TailTracker, coverage_profile, make_predictor)
from repro_torch.control.policy import check_contract
from repro_torch.core import cluster as cl
from repro_torch.kernels import _build
from repro_torch.kernels import quant as qt
from repro_torch.models import transformer as tf
from repro_torch.models.common import (ModelConfig, kv_dims,
                                       n_attn_positions)
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.cluster import ClusterStepBackend
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.graphs import Programs
from repro_torch.serve.prefill import make_extend_step, make_prefill_step
from repro_torch.serve.serve_step import (check_quant_device,
                                          global_positions, make_serve_step,
                                          synopsis_decode_attention)
from repro_torch.serving.service import _default_concentration
from repro_torch.serving.workload import poisson_arrivals


# The mamba layers' decode state: a step's output the append writes back.
SSM_LEAVES = ("conv_state", "ssd_state")


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
  # Queue-aware admission; None: the FIFO queue, no shedding.
  admission: Optional[AdmissionConfig] = None
  # The corpus cache; None (or capacity 0): off.
  cache: Optional[CacheConfig] = None
  # Serving contract (control.policy.CONTRACTS); "deadline" runs no
  # telemetry.  epsilon: error_bounded's loss target; band_conf: the
  # loss bands' nominal coverage.
  contract: str = "deadline"
  epsilon: float = 0.02
  band_conf: float = 0.9


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
  # Per-step accuracy contributions and dropped shard-mass fractions from
  # a cluster backend (empty on the single-component path).
  step_acc: List[float] = dataclasses.field(default_factory=list)
  step_drop: List[float] = dataclasses.field(default_factory=list)
  accuracy: float = 0.0
  dropped: bool = False            # shed mid-flight (partial execution)
  slo: str = "default"             # SLO class name (admission policy)
  deadline_ms: Optional[float] = None   # per-request deadline override
  shed_admission: bool = False     # refused at admission (no prefill)
  # Contract telemetry (empty under contract="deadline"): the per-step
  # raw loss estimates and spread proxies, and at retirement the
  # calibrated predicted loss and its band.
  est_raw: List[float] = dataclasses.field(default_factory=list)
  est_spread: List[float] = dataclasses.field(default_factory=list)
  pred_loss: float = -1.0
  band_lo: float = 0.0
  band_hi: float = 0.0

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


def _refuse_backend(backend) -> None:
  """The step backends the port has: the scatter-gather cluster tier
  (``serve.cluster.ClusterStepBackend``) and its fleet tier
  (``serve.fleet.FleetStepBackend``, a subclass); any other raises rather
  than being ignored."""
  if backend is not None and not isinstance(backend, ClusterStepBackend):
    raise NotImplementedError(
        f"step backend {type(backend).__name__}: only the scatter-gather "
        "cluster tier (ClusterStepBackend) and the fleet tier "
        "(FleetStepBackend) are ported")


def _telemetry_attention(q, cache_sl, *, i_max, cluster_size, sm_scale,
                         cap, self_kv):
  """The synopsis decode attention (the same stage 1, top-k, stage 2 and
  merge) with stage 1's scores (B, Hkv, M) as telemetry: the coverage
  profile comes from them, with no extra pass over the KV.  The step
  program computes it once for all layers (the same per-layer profiles,
  in one batch of ops instead of one a layer)."""
  ctx, scores = synopsis_decode_attention(
      q, cache_sl, i_max=i_max, cluster_size=cluster_size,
      sm_scale=sm_scale, cap=cap, self_kv=self_kv, return_scores=True)
  return ctx, {"stage1_scores": scores}


class ServingEngine:
  """Continuous-batching AccuracyTrader engine over the kernel serve path.

  ``params`` and ``pca_basis`` (the clustering's PCA start,
  ``core.cluster.initial_basis``) default to ones drawn from
  ``ecfg.seed``.  ``accuracy_fn`` maps the fraction of ranked clusters
  refined in a step to result accuracy (default: the simulator's fig-4
  concentration curve).  ``estimator`` (the contracts' online accuracy
  estimator) defaults to an uncalibrated one; pass one to share its
  calibration across engines.  ``device`` is ``"cuda"`` unless the CPU is
  asked for.  An encoder-decoder (whisper) is refused, as the JAX engine
  fails on it (ROADMAP C)."""

  def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params=None,
               pca_basis: Optional[torch.Tensor] = None,
               accuracy_fn: Optional[Callable[[float], float]] = None,
               backend=None, estimator: Optional[AccuracyEstimator] = None,
               device="cuda"):
    _refuse_backend(backend)
    check_contract(ecfg.contract)
    tf.check_supported(cfg)
    if n_attn_positions(cfg) == 0:
      raise ValueError(f"{cfg.name}: no attention positions, nothing to "
                       "synopsize; run the loop (exact mode)")
    if tf.has_cross(cfg):
      raise NotImplementedError(
          f"{cfg.name}: the engine does not serve an encoder-decoder with "
          "cross attention, as the JAX engine does not: its slot pool "
          "sizes cross_k / cross_v by the encoder's source_len while the "
          "prefill emits them at prompt length, and its first admission "
          "fails in write_slot's dynamic_update_slice (update shape larger "
          "than the operand); run the loop")
    check_quant_device(cfg, device)
    dev = resolve_device(device)
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
    self.contract = ecfg.contract
    self.estimator = estimator if estimator is not None else \
        AccuracyEstimator(
            floor=max(1.0 - float(self.accuracy_fn(0.0)), 0.0),
            conf=ecfg.band_conf)
    # The coverage profile runs in the step only under the two new
    # contracts: under "deadline" the step programs are the plain ones.
    self._telemetry = self.contract != "deadline"
    self._profile_prior: Optional[np.ndarray] = None
    # The device with its index (the merge tickets are keyed by it).
    self.dev = torch.empty((0,), device=dev).device
    # The step backend is bound before the policy is built: the policy
    # shares its wall predictor.
    self.backend = backend
    if backend is not None:
      backend.bind(self)
    # Corpus-cache pins a slot's admission holds: one, or one for each of
    # a fleet backend's replica mappings.
    self._map_count = int(getattr(backend, "replica_mappings", 1))
    self.controller = self._make_policy()
    # One admission policy always: with no config it is the FIFO queue
    # with no shedding and no classes.  It reaches the demand estimate
    # through a weak reference: a bound method would make the engine a
    # reference cycle, freed only by the cyclic collector, whose release
    # of the graphs can land inside another engine's capture.
    demand = weakref.WeakMethod(self._demand_ms)
    self.admission = AdmissionPolicy(
        ecfg.admission or AdmissionConfig(order="fifo", shed=False),
        ecfg.deadline_ms, lambda req: demand()(req))
    self._admit_ms_ewma = 0.0

    self.corpus_cache = ccache.CorpusCache(
        ecfg.cache, fingerprint=ccache.corpus_fingerprint(
            cfg, dev, ecfg.prompt_len, ecfg.seed))
    # Delta replay re-attends over the cached sorted KV, which a "+kv"
    # arena stores as int8 / fp8 blocks: extensions are off there (plain
    # hits and misses only).
    self._delta_ok = (ccache.supports_delta(cfg) and not
                      qt.parse_qconfig(cfg.synopsis.quant).sorted_kv)
    if params is None:
      params = tf.init_model(cfg, torch.Generator(dev).manual_seed(ecfg.seed),
                             dev)
    self.params = params
    if pca_basis is None:
      pca_basis = cl.initial_basis(math.prod(kv_dims(cfg)), seed=ecfg.seed)
    # On the device once: a host tensor would be copied (and the stream
    # waited for) at every admission's build.
    basis = torch.as_tensor(pca_basis, dtype=torch.float32).to(dev)
    self._prefill = make_prefill_step(cfg)
    self._build = lambda c: skv.build(c, cfg, basis=basis)
    self._extend = make_extend_step(cfg) if self._delta_ok else None
    self._extend_build = lambda a, k, v: skv.extend_synopsis(
        a, k, v, cfg, basis=basis)
    n, P = ecfg.n_slots, ecfg.prompt_len
    self._bx = kvc.slot_batch_axes(cfg, n, P, synopsis=True)
    # The slot pool and the programs' static buffers: allocated once and
    # written in place from here on (the graphs read fixed addresses).
    self.cache = (backend.zeros_cache() if backend is not None else
                  kvc.zeros_cache(cfg, n, P, synopsis=True, device=dev))
    self.tok = torch.zeros((n, 1), dtype=torch.long, device=dev)
    self._amask = torch.zeros((n,), dtype=torch.bool, device=dev)
    # Its host side, pinned on the card so that the copy does not wait
    # for the work queued ahead (the admissions of an overlapped step).
    self._amask_host = torch.zeros((n,), dtype=torch.bool,
                                   pin_memory=dev.type == "cuda")
    self._new_tok = torch.zeros((n,), dtype=torch.long, device=dev)
    Hkv, D = kv_dims(cfg)
    delta = (cfg.n_blocks, n_attn_positions(cfg), n, Hkv, 1, D)
    self.step_out = {
        "logits": torch.zeros((n, cfg.vocab), dtype=torch.float32,
                              device=dev),
        "k_delta": torch.zeros(delta, dtype=cfg.dtype, device=dev),
        "v_delta": torch.zeros(delta, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((n,), dtype=torch.int32, device=dev),
    }
    # A hybrid's new SSM state, the pool's shapes: the step's whole output.
    for name in SSM_LEAVES:
      if name in self.cache:
        self.step_out[name] = torch.zeros_like(self.cache[name])
    n_ranked = self.M
    if backend is not None:
      # The backend's per-layer telemetry, read after each step.
      tele = (cfg.n_blocks, n_attn_positions(cfg), backend.n_components)
      for name in ("fe_cover", "fe_mass"):
        self.step_out[name] = torch.zeros(tele, dtype=torch.float32,
                                          device=dev)
      n_ranked = backend.n_components * backend.topo.m_max
    if self._telemetry:
      # The layer-mean coverage profile of each lane (over the global
      # ranking of every component's padded clusters with a backend).
      self.step_out["est_profile"] = torch.zeros(
          (n, n_ranked + 1), dtype=torch.float32, device=dev)
    # A backend on a mesh: its host decisions are rank 0's, and its steps
    # run eagerly (their collectives cannot be captured).
    self.mesh = getattr(backend, "mesh", None)
    self.programs = Programs(self.dev, capture=self.mesh is None)
    for b in self.buckets:
      self.programs.add(("step", b), self._step_program(b))
    self.programs.add("append", self._append_program())
    self._warming = False

    self.reset()
    self._warmup()

  def _make_policy(self) -> DeadlineBudgetPolicy:
    """The engine's slice of the control plane: one DeadlineBudgetPolicy
    whose predictor is calibrated by measured step wall times.  With a
    cluster backend it is the backend's predictor, observed by the backend
    alone (the raw program wall per bucket, in ``account``)."""
    e = self.ecfg
    if self.backend is not None:
      pred = self.backend.predictor
    else:
      kw = {"base": 2.0, "slope": 0.5, "alpha": 0.1} \
          if e.predictor.startswith("affine") else {}
      pred = make_predictor(e.predictor, **kw)
    return DeadlineBudgetPolicy(
        policy=e.policy, buckets=self.buckets, i_max_cap=self.M,
        predictor=pred,
        fixed_budget=e.fixed_budget, contract=e.contract, epsilon=e.epsilon,
        estimator=self.estimator)

  # -- programs -------------------------------------------------------------
  # The programs close over the tensors they read and write, not over the
  # engine, so that an engine is freed (its pool and graphs with it) as
  # soon as its last reference goes.
  def _step_program(self, budget: int) -> Callable[[], None]:
    """The read-only serve step at ``budget``: pool + token column ->
    ``step_out`` (with the contracts' telemetry, the layer-mean coverage
    profile too).  A cluster backend's step reads its gather modes from
    the backend's static buffer and adds its per-layer ``fe_cover`` /
    ``fe_mass``; its attention gives each layer's profile itself."""
    if self.backend is not None:
      step = self.backend.step_fn(budget)
    else:
      step = make_serve_step(
          self.cfg, mode="synopsis", i_max=budget,
          attention_fn=_telemetry_attention if self._telemetry else None)
    params, cache, tok, out = self.params, self.cache, self.tok, self.step_out
    n = self.ecfg.n_slots
    # The pattern positions whose layers run the synopsis (and report its
    # scores): gemma2's local layers decode exactly and have no profile.
    glob = torch.tensor(global_positions(self.cfg), device=self.dev)

    def program():
      logits, st = step(params, cache, tok)
      out["logits"].copy_(logits)
      for name in ("k_delta", "v_delta", "pos", "fe_cover",
                   "fe_mass") + SSM_LEAVES:
        if name in out:
          out[name].copy_(st[name])
      if "est_profile" in out:
        # Every synopsis layer's profile (nb * n_glob * n, M+1), then
        # their mean.
        prof = st.get("est_profile")
        if prof is None:
          prof = coverage_profile(
              st["stage1_scores"].flatten(0, 2),
              cache["counts"].index_select(1, glob).flatten(0, 2))
        out["est_profile"].copy_(prof.view(-1, n, prof.shape[-1]).mean(0))

    return program

  def _append_program(self) -> Callable[[], None]:
    """``step_out`` -> the active lanes' ring row, ``pos``, SSM state and
    token; the argmax of every lane into ``_new_tok``.  With no lane
    active it changes nothing (the capture's warm-up calls rely on
    that)."""
    cache, tok, out, m = self.cache, self.tok, self.step_out, self._amask
    new_tok = self._new_tok
    # The active mask along each SSM leaf's slot axis.
    ssm_masks = {}
    for name in SSM_LEAVES:
      if name in out:
        shape = [1] * out[name].ndim
        shape[self._bx[name]] = -1
        ssm_masks[name] = m.view(shape)

    def program():
      skv.append_recent_slots(cache, out["k_delta"], out["v_delta"], m)
      pos = cache["pos"]
      pos.copy_(torch.where(m, out["pos"], pos))
      for name, mask in ssm_masks.items():
        cache[name].copy_(torch.where(mask, out[name], cache[name]))
      new = out["logits"].argmax(-1)
      new_tok.copy_(new)
      tok.copy_(torch.where(m[:, None], new[:, None], tok))

    return program

  def _sync(self) -> None:
    if self.dev.type == "cuda":
      torch.cuda.synchronize(self.dev)

  def _agree(self, value):
    """Rank 0's ``value`` on every rank of the backend's mesh (a measured
    wall, a step's budget and plan); ``value`` itself without a mesh."""
    return value if self.mesh is None else self.mesh.broadcast_object(value)

  # -- state ----------------------------------------------------------------
  def reset(self) -> None:
    """Fresh slots, pool and clock for a new measurement window; the pool
    is zeroed in place.  The latency model, the corpus cache's entries,
    the estimator's calibration and the coverage-profile prior persist
    across windows; the cache's counters and the lanes' pins reset."""
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
    for key in getattr(self, "_slot_entry", []):
      if key is not None:
        self.corpus_cache.release(key, self._map_count)
    self._slot_entry: List[Optional[str]] = [None] * self.ecfg.n_slots
    self.corpus_cache.reset_stats()
    self._slot_profile: List[Optional[np.ndarray]] = \
        [None] * self.ecfg.n_slots
    self._freed_log: List[int] = []
    self.admission.reset()

  def _warm_buckets(self) -> Sequence[int]:
    p = self.ecfg.policy
    # error_bounded may answer at any bucket (the estimator's choice under
    # the policy's), so every bucket's graph must be captured.
    if p == "accuracytrader" or self.contract == "error_bounded":
      return self.buckets
    if p == "fixed":
      return (self.ecfg.fixed_budget,)
    return (self.M,)

  def _warmup(self) -> None:
    """Admit a dummy request (the kernels' library loads, prefill and
    build run once; the corpus cache is bypassed), capture the graph of
    every bucket the run can dispatch and of the append program, and
    replay each once, so that the first measured step is a replay; then
    discard the state.  The decode kernels' merge tickets are allocated
    before any capture, at the largest row count a step gives them, so
    that they do not land in the graphs' pool."""
    self._warming = True
    if self.dev.type == "cuda":
      # A cluster step runs its stages over n_slots * N rows.
      fold = self.backend.n_components if self.backend is not None else 1
      _build.tickets(self.dev, self.ecfg.n_slots * fold * self.cfg.n_heads)
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
  def _stage(self, tokens) -> torch.Tensor:
    """Token ids (L,) -> (1, L) long on the device; pinned on the card, so
    that the copy does not wait for the work queued ahead."""
    t = torch.as_tensor(np.asarray(tokens), dtype=torch.long)[None]
    if self.dev.type == "cuda":
      t = t.pin_memory().to(self.dev, non_blocking=True)
    return t

  def _dispatch_admission(self, req: EngineRequest,
                          slot: int) -> torch.Tensor:
    """Launch one admission without waiting; returns the first token (1,)
    on the device.  With the corpus cache on, a hit copies the cached
    arena into the lane (no prefill, no build), an extension replays only
    the extension's tokens, and a miss runs prefill -> build -> slot write
    and publishes its arena.  The warm-up bypasses the cache (its dummy
    prompts would alias one corpus)."""
    cc = self.corpus_cache
    use_cache = cc.enabled and not self._warming
    if use_cache:
      kind, entry = cc.lookup(req.prompt, allow_extend=self._delta_ok)
      if kind != "miss":
        if kind == "hit":
          cc.acquire(entry, self._map_count)
        else:                 # "extend": publishing pins the new entry once
          entry = self._delta_admit(entry, req.prompt)
          self._pin_mappings(entry)
        self._slot_entry[slot] = entry.key
        self._write_slot(entry.arena, slot)
        return entry.first_token
    self.prefills += 1
    logits, cache1 = self._prefill(self.params, self._stage(req.prompt))
    syn = self._build(cache1)
    first = logits.argmax(-1)
    if use_cache:
      entry = cc.publish(req.prompt, syn, first)  # pins once
      self._pin_mappings(entry)
      self._slot_entry[slot] = entry.key
    self._write_slot(syn, slot)
    return first

  def _pin_mappings(self, entry: ccache.CacheEntry) -> None:
    """The pins of a published entry's other replica mappings (the fleet
    tier maps one admission's arena onto R rows, each holding its own pin,
    so that retiring one mapping never frees an arena another reads)."""
    if self._map_count > 1:
      self.corpus_cache.acquire(entry, self._map_count - 1)

  def _write_slot(self, syn, slot: int) -> None:
    """One request's built (or cached) B = 1 cache into lane ``slot``: the
    cluster backend scatters its arena over the components."""
    if self.backend is not None:
      self.backend.write_slot(self.cache, syn, slot)
    else:
      kvc.write_slot(self.cache, syn, slot, self._bx)

  def _delta_admit(self, entry: ccache.CacheEntry,
                   prompt) -> ccache.CacheEntry:
    """Prefix-extension replay: only the extension's tokens run, against
    the cached arena's sorted prefix KV, the synopsis grows by the
    extension's clusters, and the extended corpus is published as its own
    entry (``prefills`` does not move; the cache counts a delta hit)."""
    t = np.asarray(prompt, np.int32)
    L = int(entry.tokens.shape[0])
    logits, (k_new, v_new) = self._extend(
        self.params, self._stage(t[L:]), entry.arena["k"],
        entry.arena["v"], L)
    arena = self._extend_build(entry.arena, k_new, v_new)
    return self.corpus_cache.publish(t, arena, logits.argmax(-1))

  def _admit(self, req: EngineRequest, slot: int) -> None:
    # queue_ms measures pure waiting: the clock *before* this request's
    # own admission advances it.
    req.admit_ms = self.now_ms
    t0 = time.perf_counter()
    first = self._dispatch_admission(req, slot)
    self.tok[slot, 0] = first[0]
    first_id = int(first[0])             # waits for the admission
    dt = self._agree((time.perf_counter() - t0) * 1e3)
    self.now_ms += dt
    req.admit_wall_ms = dt
    # The admission-cost EWMA: the fixed part of the demand estimate the
    # predictive shed uses (_demand_ms).
    if not self._warming:
      self._admit_ms_ewma = dt if self._admit_ms_ewma == 0.0 \
          else 0.7 * self._admit_ms_ewma + 0.3 * dt
    req.tokens.append(first_id)
    self._slot_profile[slot] = None
    self.slots[slot] = _Slot(req, req.max_new_tokens)
    self.events.append(("admit", req.rid, slot, self.now_ms))

  def _pick_budget(self, active: Sequence[int],
                   extra: Sequence[EngineRequest] = ()) -> int:
    """``extra``: requests admitted concurrently with this step (admission
    overlap): the step stands between them and their first decode, so
    their deadlines clamp the budget as on the serial path.  Under
    ``error_bounded`` the budget is the contract's grant, and the budget
    it frees is logged."""
    remaining = 0.0
    if self.ecfg.policy == "accuracytrader":
      remaining = min(
          [self._abs_deadline(self.slots[i].req) - self.now_ms
           for i in active] +
          [self._abs_deadline(r) - self.now_ms for r in extra])
    if self.contract == "error_bounded":
      granted, base = self.controller.budget_for_contract(
          max(remaining, 0.0),
          profiles=[self._request_profile(i) for i in active])
      if not self._warming:
        self._freed_log.append(base - granted)
      return granted
    return self.controller.budget_for(max(remaining, 0.0))

  def _request_profile(self, slot: int) -> np.ndarray:
    """The latest coverage profile of the request in ``slot``: its own
    last step's, else the EWMA prior over recent steps (a request just
    admitted has not scored its synopsis yet), else the uniform profile
    (every cluster equally useful: the most conservative)."""
    p = self._slot_profile[slot]
    if p is not None:
      return p
    if self._profile_prior is not None:
      return self._profile_prior
    return np.linspace(0.0, 1.0, self.M + 1)

  def _deadline_of(self, req: EngineRequest) -> float:
    """Per-request deadline: its override, else its SLO class's, else the
    engine's (one rule for the budget, the partial shed and the
    summary)."""
    return self.admission.deadline_for(req)

  def _abs_deadline(self, req: EngineRequest) -> float:
    return req.arrival_ms + self._deadline_of(req)

  def _demand_ms(self, req: EngineRequest) -> float:
    """Lower bound of a request's service demand at arrival (the
    predictive shed's input): the admission-cost EWMA plus one
    smallest-bucket step per decode token.  Real steps only refine more,
    so at low load no feasible request is shed."""
    floor = self.controller.predictor.predict(self.buckets[0])
    return self._admit_ms_ewma + req.max_new_tokens * floor

  def _retire(self, slot: int) -> None:
    s = self.slots[slot]
    req = s.req
    req.finish_ms = self.now_ms
    # Unpin the lane's cache entry (it stays resident, warm for the next
    # admission, until capacity pressure evicts it).
    if self._slot_entry[slot] is not None:
      self.corpus_cache.release(self._slot_entry[slot], self._map_count)
      self._slot_entry[slot] = None
    req.dropped = s.remaining > 0      # shed mid-flight, not finished
    policy = self.ecfg.policy
    # With a cluster backend each step reported the corpus-share-weighted
    # accuracy of its gather (refined / stage-1 floor / skipped).
    stepwise = float(np.mean(req.step_acc)) if req.step_acc else None
    if policy == "basic":
      req.accuracy = stepwise if stepwise is not None else 1.0
    elif policy == "partial":
      # Partial execution: a result missing at the deadline is skipped;
      # its entire accuracy contribution is lost (paper §5).
      late = req.dropped or req.latency_ms > self._deadline_of(req)
      req.accuracy = 0.0 if late else (
          stepwise if stepwise is not None else 1.0)
    elif stepwise is not None:
      req.accuracy = stepwise
    else:
      # Stage 1 always landed; each step covered budget/M of the ranked
      # clusters exactly plus the synopsis estimate of the rest.
      fr = [min(b, self.M) / self.M for b in req.budgets] or [0.0]
      req.accuracy = float(np.mean([self.accuracy_fn(f) for f in fr]))
    # The contract's outputs: the calibrated loss prediction and its band
    # from the request's own step telemetry.
    if self._telemetry and req.est_raw:
      raw = float(np.mean(req.est_raw))
      req.pred_loss = float(self.estimator.predict(raw))
      req.band_lo, req.band_hi = self.estimator.band(
          raw, spread=float(np.mean(req.est_spread)))
    self._slot_profile[slot] = None
    self.slots[slot] = None
    self.completed.append(req)
    self.events.append(("retire", req.rid, slot, self.now_ms))

  def _step_deadline(self, active: Sequence[int]) -> float:
    """The cluster frontend's per-step deadline: the most urgent resident
    request's remaining time spread over its remaining decode steps."""
    vals = [max(self._abs_deadline(self.slots[i].req) - self.now_ms,
                0.0) / max(self.slots[i].remaining, 1) for i in active]
    return min(vals) if vals else float("inf")

  def _decode_step(self, active: Sequence[int],
                   budget: Optional[int] = None,
                   admit: Optional[Callable[[], None]] = None) -> None:
    """One budgeted decode step for the ``active`` slots: the step's
    graph, then the append's, then one wait.  ``admit`` (admission
    overlap) dispatches this iteration's admissions between the two, so
    that the step reads the pre-admission pool, as the JAX engine's step
    does; the measured window then holds the admissions' eager launches
    (host work it pays for), and the controller does not observe it."""
    if budget is None:
      budget = self._pick_budget(active)
    plan = None
    if self.backend is not None:
      deadline = self._step_deadline(active) if not self._warming \
          else float("inf")
      plan = self.backend.plan_step(budget, deadline)
    if self.mesh is not None:
      budget, plan = self._agree((budget, plan))
    t0 = time.perf_counter()
    mask = self._amask_host      # the last step's copy has completed
    mask.zero_()
    mask[list(active)] = True
    self._amask.copy_(mask, non_blocking=True)
    if plan is not None:
      self.backend.load_plan(plan)
    self.programs.run(("step", budget))
    if admit is not None:
      admit()
    self.programs.run("append")
    toks = self._new_tok.cpu().numpy()  # waits for the step
    dt = self._agree((time.perf_counter() - t0) * 1e3)
    step_acc = step_drop = None
    if plan is not None:
      st = {name: self.step_out[name].cpu().numpy()
            for name in ("fe_cover", "fe_mass")}
      info = self.backend.account(budget, dt, plan, st,
                                  warming=self._warming)
      dt = info["parallel_ms"]       # the frontend-observed completion
      step_acc, step_drop = info["step_acc"], info["drop_share"]
    self.now_ms += dt
    # With a backend its predictor was observed in account.
    if self.ecfg.policy == "accuracytrader" and not self._warming \
        and admit is None and self.backend is None:
      self.controller.observe(budget, dt)
    self.step_log.append((budget, dt, len(active)))
    # The contracts' telemetry: this step's layer-mean coverage profile per
    # lane, the signal of the next step's ε decision and of each
    # request's running loss estimate.
    prof = None
    if self._telemetry:
      prof = self.step_out["est_profile"].cpu().numpy().astype(np.float64)
      for i in active:
        self._slot_profile[i] = prof[i]
      mean_prof = prof[list(active)].mean(0)
      self._profile_prior = mean_prof if self._profile_prior is None \
          else 0.7 * self._profile_prior + 0.3 * mean_prof
    for i in active:
      s = self.slots[i]
      s.req.tokens.append(int(toks[i]))
      s.req.budgets.append(budget)
      if step_acc is not None:
        s.req.step_acc.append(step_acc)
        s.req.step_drop.append(step_drop)
      if prof is not None:
        s.req.est_raw.append(self.estimator.raw_loss(prof[i], budget))
        s.req.est_spread.append(
            self.estimator.spread_from_profile(prof[i], budget))
      s.remaining -= 1
      if s.remaining <= 0:
        self._retire(i)

  # -- driving --------------------------------------------------------------
  def run(self, requests: Sequence[EngineRequest]) -> Dict[str, float]:
    """Drive the engine over an arrival trace; returns the window summary.

    The clock is hybrid: arrivals advance on the trace's clock, service
    advances by the measured wall time of each step and admission, so
    queueing delay under load is real, not modelled.  Each iteration moves
    the arrived requests into the ready queue, rate-gates them per SLO
    class (an over-rate request waits), sheds the predicted-dead, orders
    the rest (FIFO, EDF or least slack) and admits into the free lanes:
    beside the residents' decode step when there are residents, else
    serially."""
    pending = collections.deque(
        sorted(requests, key=lambda r: (r.arrival_ms, r.rid)))
    ready: List[EngineRequest] = []
    adm = self.admission
    while pending or ready or any(s is not None for s in self.slots):
      if self.ecfg.policy == "partial":
        # Partial execution sheds unfinished work at the deadline: the
        # result is skipped (accuracy 0 via _retire) and the lane frees.
        for i, s in enumerate(self.slots):
          if s is not None and self.now_ms >= self._abs_deadline(s.req):
            self._retire(i)
      while pending and pending[0].arrival_ms <= self.now_ms:
        ready.append(pending.popleft())
      kept, gated = [], []
      for r in ready:
        if not adm.rate_admit(r, self.now_ms):
          gated.append(r)           # waits for its class's token bucket
        elif adm.predicted_dead(r, self.now_ms):
          self._shed(r)
        else:
          kept.append(r)
      kept.sort(key=lambda r: adm.key(r, self.now_ms))
      free = [i for i, s in enumerate(self.slots) if s is None]
      admissions = []
      while free and kept:
        admissions.append((kept.pop(0), free.pop(0)))
      ready = kept + gated
      active = [i for i, s in enumerate(self.slots) if s is not None]
      if admissions and active and self.ecfg.overlap_admission \
          and self.backend is None:
        self._admit_overlapped(admissions, active)
        continue
      for req, slot in admissions:
        self._admit(req, slot)
      active = [i for i, s in enumerate(self.slots) if s is not None]
      if not active:
        if ready:
          # Only rate-gated requests wait (every lane is free): advance
          # until their bucket refills, in 1 ms quanta.
          self.now_ms += 1.0
        elif pending:
          # Idle: jump to the next arrival.
          self.now_ms = max(self.now_ms, pending[0].arrival_ms)
        else:
          break
        continue
      self._decode_step(active)
    return self.summary()

  def _shed(self, req: EngineRequest) -> None:
    """Refuse a request at admission (predicted to miss its deadline): no
    prefill, no decode step, accuracy 0, counted as dropped."""
    req.finish_ms = max(self.now_ms, req.arrival_ms)
    req.dropped = True
    req.shed_admission = True
    req.accuracy = 0.0
    self.completed.append(req)
    self.events.append(("shed", req.rid, -1, self.now_ms))

  def _admit_overlapped(self, admissions, active: Sequence[int]) -> None:
    """Launch the residents' decode step, the admitted requests'
    admissions behind it, then the append, and wait once.  The step reads
    the pre-admission pool, as in the JAX engine: on an MoE layer (jamba)
    the inactive lanes' rows share the experts' capacity with the active
    ones, so what an admitted lane holds during the step moves the
    residents' outputs.  The append writes the active lanes only, so the
    admissions' lane writes stand."""
    t_admit = self.now_ms
    budget = self._pick_budget(active, extra=[r for r, _ in admissions])
    firsts = []

    def admit():
      for req, slot in admissions:
        req.admit_ms = t_admit
        firsts.append(self._dispatch_admission(req, slot))

    self._decode_step(active, budget=budget, admit=admit)
    for (req, slot), first in zip(admissions, firsts):
      self.tok[slot, 0] = first[0]
      req.tokens.append(int(first[0]))
      self._slot_profile[slot] = None
      self.slots[slot] = _Slot(req, req.max_new_tokens)
      self.events.append(("admit", req.rid, slot, self.now_ms))

  def _class_stats(self, reqs: Sequence[EngineRequest]) -> Dict[str, float]:
    """Accounting over one request subset: latency percentiles and
    accuracy over the requests served (one shed at admission has no
    service latency), shed counts and goodput over all of them, so that
    the per-class stats sum to the aggregate."""
    served = [r for r in reqs if not r.shed_admission]
    tracker = TailTracker()
    for r in served:
      tracker.observe(r.latency_ms)
    s = tracker.summary()
    accs = [r.accuracy for r in served]
    s["accuracy_loss_pct"] = 100.0 * (1.0 - float(np.mean(accs))) \
        if accs else 0.0
    s["deadline_miss_pct"] = 100.0 * float(np.mean(
        [r.latency_ms > self._deadline_of(r) for r in served])) \
        if served else 0.0
    s["queue_p99"] = float(np.percentile(
        [r.queue_ms for r in served], 99)) if served else 0.0
    s["shed_pct"] = 100.0 * float(np.mean(
        [r.dropped for r in reqs])) if reqs else 0.0
    s["shed_admission_n"] = sum(r.shed_admission for r in reqs)
    s["served_n"] = len(served)
    # Goodput: requests actually answered within their own deadline.
    s["goodput_n"] = sum(1 for r in served if not r.dropped
                         and r.latency_ms <= self._deadline_of(r))
    # Availability: a served request answered in full: not dropped
    # mid-flight, and no step of it dropped shard mass (a stage-1
    # fallback still answers).
    s["availability_pct"] = 100.0 * float(np.mean(
        [not r.dropped and all(d <= 0.0 for d in r.step_drop)
         for r in served])) if served else 100.0
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
    walls = [r.admit_wall_ms for r in self.completed
             if not r.shed_admission and r.admit_wall_ms > 0]
    s["admission_p50"] = float(np.percentile(walls, 50)) if walls else 0.0
    s["admission_p99"] = float(np.percentile(walls, 99)) if walls else 0.0
    if self.corpus_cache.enabled:
      cst = self.corpus_cache.stats()
      for name in ("hits", "misses", "delta_hits", "evictions", "entries",
                   "bytes"):
        s[f"cache_{name}"] = float(cst[name])
      s["cache_hit_rate"] = float(cst["hit_rate"])
    s["goodput_per_s"] = s["goodput_n"] / (self.now_ms / 1e3) \
        if self.now_ms > 0 else 0.0
    # The contracts: prediction against the measured loss, band coverage
    # at the stated confidence, and the budget error_bounded freed a step.
    if self._telemetry:
      served = [r for r in self.completed
                if not r.shed_admission and r.est_raw]
      preds = np.asarray([r.pred_loss for r in served], np.float64)
      meas = np.asarray([1.0 - r.accuracy for r in served], np.float64)
      s["pred_loss_mean"] = float(preds.mean()) if len(preds) else 0.0
      s["pred_loss_mae"] = float(np.abs(preds - meas).mean()) \
          if len(preds) else 0.0
      s["band_cover_pct"] = 100.0 * float(np.mean(
          [r.band_lo - 1e-9 <= m <= r.band_hi + 1e-9
           for r, m in zip(served, meas)])) if served else 0.0
      s["freed_budget_mean"] = float(np.mean(self._freed_log)) \
          if self._freed_log else 0.0
    # Per-SLO-class breakdown: the classes partition the completed
    # requests.
    names = sorted({r.slo for r in self.completed})
    if names and names != ["default"]:
      s["classes"] = {name: self._class_stats(
          [r for r in self.completed if r.slo == name]) for name in names}
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
    if self.backend is not None:
      self.backend.load_mode(self.backend.full_mode())
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
    return self._agree(float(np.median(ts)))


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


def make_zipf_requests(arrivals_ms: Sequence[float], prompt_len: int,
                       max_new_tokens: int, vocab: int,
                       n_corpora: int = 8, alpha: float = 1.1,
                       seed: int = 0) -> List[EngineRequest]:
  """Requests whose prompts repeat: each arrival draws its prompt from a
  pool of ``n_corpora`` corpora with Zipf(``alpha``) popularity (the
  shared-index / per-tenant-document traffic the corpus cache serves).
  ``n_corpora=1`` is the 100%-repeat arm.  The same prompts as the JAX
  package's for the same seed."""
  rng = np.random.default_rng(seed)
  pool = [rng.integers(0, vocab, prompt_len, dtype=np.int32)
          for _ in range(n_corpora)]
  w = np.arange(1, n_corpora + 1, dtype=np.float64) ** -alpha
  picks = rng.choice(n_corpora, size=len(arrivals_ms), p=w / w.sum())
  return [EngineRequest(rid=i, arrival_ms=float(t), prompt=pool[picks[i]],
                        max_new_tokens=max_new_tokens)
          for i, t in enumerate(arrivals_ms)]


def run_open_loop(engine: ServingEngine, rate_per_s: float,
                  duration_s: float, seed: int = 0,
                  slo_of: Optional[Callable[[int], str]] = None,
                  zipf_corpora: int = 0,
                  service_seed: Optional[int] = None) -> Dict[str, float]:
  """One measurement window of Poisson arrivals at ``rate_per_s``; the
  arrivals and prompts derive from ``seed``.  ``slo_of(rid)`` assigns each
  request its SLO class; ``zipf_corpora`` > 0 draws the prompts from that
  many Zipf-popular corpora (:func:`make_zipf_requests`).  A cluster
  backend's interference draws and fault world reseed from
  ``service_seed`` (default ``seed``), so a window's draws are a pure
  function of its seeds, whatever ran before."""
  engine.reset()
  if engine.backend is not None:
    engine.backend.reseed(seed if service_seed is None else service_seed)
  arrivals = poisson_arrivals(rate_per_s, duration_s, seed=seed)
  e = engine.ecfg
  if zipf_corpora > 0:
    reqs = make_zipf_requests(arrivals, e.prompt_len, e.max_new_tokens,
                              engine.cfg.vocab, n_corpora=zipf_corpora,
                              seed=seed)
  else:
    reqs = make_requests(arrivals, e.prompt_len, e.max_new_tokens,
                         engine.cfg.vocab, seed=seed)
  if slo_of is not None:
    for r in reqs:
      r.slo = slo_of(r.rid)
  return engine.run(reqs)
