"""Scatter-gather online service with the paper's techniques, as a
discrete-event simulation (the port's own copy of
``repro.serving.service``).

One request fans out to ``n_components`` parallel components; it completes
when the composer has what it needs, so the tail of component latency is
the service latency (paper §1).  Techniques:

  * ``basic``          exact processing on every component.
  * ``reissue``        exact + request reissue: a component slower than the
                       p95 of its class is replicated on the least-loaded
                       component and the quicker wins.
  * ``partial``        exact everywhere, but results missing at the
                       deadline are skipped (their accuracy is lost).
  * ``accuracytrader`` stage 1 on the synopsis, then the top-ranked
                       clusters within the controller's budget.

``step_backend`` closes the loop with the real kernel path: the
``accuracytrader`` components then serve in the engine's measured
per-bucket step time (``repro_torch.serve.engine.MeasuredStepBackend``),
or in the cluster tier's measured per-component time
(``serve.cluster.ClusterMeasuredExport``, one entry per component),
instead of the modelled ``base + slope * items``; :class:`ScaledFleetExport`
rescales such an export onto a counterfactual fleet size (the fleet
autoscaler's round trip).

``faults`` injects the cluster tier's seed-deterministic fault world
(``serve.resilience``), keyed by request id: a dead component's shard
fails over to its ring replica under ``accuracytrader`` with ``replicas``
>= 2 (queueing behind the replica's own work), else falls back to the
frontend's stage-1 synopsis; the exact techniques have no ladder, wait out
a hard timeout and lose the shard (``availability_pct``).

The ε-or-deadline contracts: under ``error_bounded`` the budget is clamped
to the smallest bucket the accuracy model says meets ``epsilon``; under
both new contracts the predicted loss is tracked (``pred_loss_mean``).
Here the accuracy model is the truth (there are no stage-1 scores to
read), so the prediction is exact by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.control import AffinePredictor, BudgetController, TailTracker
from repro_torch.control.policy import check_contract
from repro_torch.dist.topology import zipf_weights
from repro_torch.serve.resilience import FaultPlan
from repro_torch.serving.latency import ComponentModel


@dataclasses.dataclass
class Request:
  rid: int
  arrival_ms: float


@dataclasses.dataclass
class ServiceConfig:
  n_components: int = 108
  technique: str = "accuracytrader"
  deadline_ms: float = 100.0
  full_items: int = 100            # clusters per component (exact = all)
  i_max_cap: int = 40              # paper: top-40% ranked sets
  reissue_pct: float = 95.0
  # Zipf exponent over per-component work: skew > 0 makes low-rank
  # components "hot" (they own more of the corpus and serve slower).
  skew: float = 0.0
  seed: int = 0
  faults: Optional[object] = None  # serve.resilience.FaultSpec
  replicas: int = 1            # >= 2: a dead component's shard is served
                               # by its ring replica
  shed: bool = False           # predictive shed-at-admission
  shed_margin: float = 1.0     # shed when backlog+service > ddl*margin
  contract: str = "deadline"   # control.policy.CONTRACTS
  epsilon: float = 0.02        # error_bounded's loss target


class ScatterGatherService:
  def __init__(self, cfg: ServiceConfig,
               accuracy_fn: Optional[Callable[[float], float]] = None,
               step_backend=None):
    check_contract(cfg.contract)
    self.cfg = cfg
    self.pred_tracker: List[float] = []
    self.step_backend = step_backend
    self.per_component_ms = step_backend is not None and hasattr(
        step_backend, "step_ms_per_component")
    # A per-component measured export already holds the tier's skew, so
    # the modelled multiplier stays 1 then.
    if cfg.skew and not self.per_component_ms:
      scales = zipf_weights(cfg.n_components, cfg.skew) * cfg.n_components
    else:
      scales = np.ones((cfg.n_components,))
    self.components = [
        ComponentModel(seed=cfg.seed * 1000 + i, comp_id=i,
                       work_scale=float(scales[i]),
                       full_items=cfg.full_items)
        for i in range(cfg.n_components)
    ]
    self.tracker = TailTracker()
    self.acc_tracker: List[float] = []
    self.controller = BudgetController(
        AffinePredictor(base=2.0, slope=0.15),
        buckets=tuple(sorted({0, 1, 2, 4, 8, 16, 24, 32, 40,
                              cfg.i_max_cap})),
        i_max_cap=cfg.i_max_cap)
    self.class_latencies: List[float] = []
    # fraction of ranked clusters processed -> accuracy in [0, 1]; default
    # the fig-4-style concentration curve.
    self.accuracy_fn = accuracy_fn or _default_concentration
    self.rng = np.random.default_rng(cfg.seed)
    # The cluster tier's fault world, keyed here by request id.
    self.fault_plan = FaultPlan(cfg.faults, cfg.n_components)
    self.shed_n = 0
    self.total_n = 0
    self.avail_tracker: List[float] = []

  # -- one request -----------------------------------------------------------
  def submit(self, req: Request) -> Dict[str, float]:
    cfg = self.cfg
    tech = cfg.technique
    done_times = []
    processed_frac = []
    self.total_n += 1
    fstate = self.fault_plan.at(req.rid)

    queue_delay = float(np.mean([
        max(0.0, c.busy_until - req.arrival_ms) for c in self.components]))
    if cfg.shed:
      # Predictive shed-at-admission: the mean backlog plus the
      # predictor's stage-1 floor already misses the deadline.
      demand = queue_delay + self.controller.model.predict(0)
      if demand > cfg.deadline_ms * cfg.shed_margin:
        self.shed_n += 1
        self.acc_tracker.append(0.0)
        return {"latency_ms": 0.0, "accuracy": 0.0, "shed": True}
    if tech == "accuracytrader":
      budget = self.controller.budget_for(cfg.deadline_ms, queue_delay)
      if cfg.contract == "error_bounded":
        budget = min(budget, self._epsilon_budget())
      measured = None
      if self.step_backend is not None:
        # Each component indexes its own entry of a per-component vector.
        measured = (self.step_backend.step_ms_per_component(budget)
                    if self.per_component_ms
                    else self.step_backend.step_ms(budget))
    lost_mass = 0
    for i, comp in enumerate(self.components):
      if tech in ("basic", "partial", "reissue"):
        items = cfg.full_items
        service_ms = None
      else:
        items = budget
        service_ms = measured
      if not fstate.alive[i]:
        # AccuracyTrader's ladder fails a dead component's shard over to
        # its ring replica (queueing behind the replica's own work), else
        # falls back to the frontend's stage-1 synopsis; the exact
        # techniques wait out a hard timeout and lose the shard.
        j = (i + 1) % cfg.n_components
        if tech == "accuracytrader" and cfg.replicas > 1 \
            and fstate.alive[j]:
          done_times.append(self.components[j].submit(
              req.arrival_ms, items, service_ms=service_ms,
              scale=float(fstate.slow[j])))
          processed_frac.append(items / cfg.full_items)
        elif tech == "accuracytrader":
          done_times.append(req.arrival_ms + comp.base_ms)
          processed_frac.append(0.0)
        else:
          done_times.append(req.arrival_ms + 3.0 * cfg.deadline_ms)
          processed_frac.append(0.0)
          lost_mass += 1
        continue
      done_times.append(comp.submit(req.arrival_ms, items,
                                    service_ms=service_ms,
                                    scale=float(fstate.slow[i])))
      processed_frac.append(items / cfg.full_items)

    if tech == "reissue" and self.class_latencies:
      thresh = np.percentile(self.class_latencies, cfg.reissue_pct)
      order = np.argsort([c.busy_until for c in self.components])
      spare = list(order)
      budget_replicas = max(1, cfg.n_components // 10)
      for i, t_done in enumerate(done_times):
        lat_i = t_done - req.arrival_ms
        if lat_i > thresh and spare and budget_replicas > 0:
          # replica on the least-loaded component, issued when the
          # straggler is detected; only if expected to finish sooner
          j = int(spare.pop(0))
          est = self.components[j].peek_completion(
              req.arrival_ms + thresh, cfg.full_items)
          if est < t_done:
            t_replica = self.components[j].submit(
                req.arrival_ms + thresh, cfg.full_items)
            done_times[i] = min(t_done, t_replica)
            budget_replicas -= 1

    lat = [t - req.arrival_ms for t in done_times]
    for v in lat:
      self.class_latencies.append(v)
    if len(self.class_latencies) > 5000:
      del self.class_latencies[:1000]

    deadline_abs = req.arrival_ms + cfg.deadline_ms
    if tech == "partial":
      # Components missing the deadline are skipped: their subset's
      # accuracy contribution is lost (paper §5).
      acc = float(np.mean([1.0 if t <= deadline_abs else 0.0
                           for t in done_times]))
      comp_lat = min(max(lat), cfg.deadline_ms)
    elif tech == "accuracytrader":
      comp_lat = max(lat)
      self.controller.observe(budget, comp_lat)
      acc = float(np.mean([self.accuracy_fn(u) for u in processed_frac]))
      if cfg.contract != "deadline":
        # The model is the truth here: predicted == realized loss.
        self.pred_tracker.append(1.0 - acc)
    else:
      # Exact techniques: a lost shard's contribution is missing.
      acc = 1.0 - lost_mass / cfg.n_components
      comp_lat = max(lat)

    self.tracker.observe(comp_lat)
    self.acc_tracker.append(acc)
    self.avail_tracker.append(0.0 if lost_mass else 1.0)
    return {"latency_ms": comp_lat, "accuracy": acc}

  def _epsilon_budget(self) -> int:
    """Smallest controller bucket whose modelled loss meets ε; ε <= 0
    demands exactness, which only the full ``i_max_cap`` spend gives (the
    rule of ``AccuracyEstimator.bucket_for_epsilon``)."""
    cfg = self.cfg
    if cfg.epsilon <= 0.0:
      return cfg.i_max_cap
    for b in self.controller.buckets:
      if 1.0 - self.accuracy_fn(b / cfg.full_items) <= cfg.epsilon:
        return int(b)
    return cfg.i_max_cap

  def run_open_loop(self, arrival_rate_per_s: float,
                    duration_s: float) -> Dict[str, float]:
    """Poisson arrivals for one measurement window.  Queues and the
    calibrated latency model persist across windows; the percentile
    tracker resets (each call = one reported session, as in Fig 5)."""
    self.tracker = TailTracker()
    self.acc_tracker = []
    self.avail_tracker = []
    self.pred_tracker = []
    self.shed_n = 0
    self.total_n = 0
    t = max((c.busy_until for c in self.components), default=0.0)
    end = t + duration_s * 1000.0
    rid = 0
    while t < end:
      gap = self.rng.exponential(1000.0 / arrival_rate_per_s)
      t += gap
      self.submit(Request(rid, t))
      rid += 1
    s = self.tracker.summary()
    s["accuracy_loss_pct"] = 100.0 * (1.0 - float(np.mean(self.acc_tracker)))
    s["shed_pct"] = 100.0 * self.shed_n / max(1, self.total_n)
    s["availability_pct"] = (100.0 * float(np.mean(self.avail_tracker))
                             if self.avail_tracker else 0.0)
    if self.cfg.contract != "deadline":
      s["pred_loss_mean"] = float(np.mean(self.pred_tracker)) \
          if self.pred_tracker else 0.0
    return s


class ScaledFleetExport:
  """A fleet tier's measured per-component export rescaled onto a
  counterfactual (n, r) size: the autoscaler's simulator round trip.

  The export was measured at ``n0`` components each owning ~1/n0 of every
  corpus; at ``n`` components each owns ~1/n, so the per-component time
  is the measured total over n.  Replica selection serves every shard from
  the fastest of its ``r`` holders, which trims the measured excess over
  the mean (imbalance and stragglers) by 1/r; the mean work stays.  A
  drop-in ``step_ms_per_component`` backend for
  ``ScatterGatherService(step_backend=...)``; :meth:`step_model` is the
  ``step_ms_fn(n, r)`` that ``control.Autoscaler`` scans."""

  def __init__(self, export, n_components: int, replicas: int = 1,
               model_budget: int = 8):
    if n_components < 1 or replicas < 1:
      raise ValueError(f"fleet size ({n_components}, {replicas}) invalid")
    self.export = export
    self.n_components = int(n_components)
    self.replicas = int(replicas)
    self.model_budget = int(model_budget)    # the operating point

  def step_ms_per_component(self, budget: int) -> np.ndarray:
    v0 = np.asarray(self.export.step_ms_per_component(budget), np.float64)
    total = float(v0.sum())
    mean = total / self.n_components
    imbalance = float(v0.max()) / max(total / max(v0.size, 1), 1e-30) - 1.0
    per = mean * (1.0 + max(imbalance, 0.0) / self.replicas)
    return np.full(self.n_components, per)

  def step_ms(self, budget: int) -> float:
    return float(self.step_ms_per_component(budget).max())

  def step_model(self, n_components: int, replicas: int) -> float:
    """The predicted step wall at a candidate size (the frontend waits on
    the slowest component, so the per-component time is the wall)."""
    return ScaledFleetExport(self.export, n_components,
                             replicas).step_ms(self.model_budget)


def _default_concentration(frac: float) -> float:
  """Fig-4-style curve, calibrated to the paper's operating points: the
  synopsis stage alone recovers ~93 % of result accuracy, and the top-40 %
  ranked clusters recover ~99.9 %."""
  if frac <= 0.0:
    return 0.93
  return 0.93 + 0.07 * min(1.0, (frac / 0.45) ** 0.6)
