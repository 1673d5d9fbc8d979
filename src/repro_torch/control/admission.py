"""Queue-aware predictive admission (the port's own copy of
``repro.control.admission``; host code, no tensors).

:class:`AdmissionPolicy` owns every queue decision of one engine:

  * **ordering**: ``fifo`` (arrival), ``edf`` (earliest absolute deadline
    first) or ``slack`` (least laxity: deadline minus now minus the
    predicted demand);
  * **predictive shedding**: a request whose predicted completion ``now +
    demand`` already exceeds ``arrival + deadline * shed_margin`` is
    refused at admission (no prefill, no decode step).  The engine's
    demand estimate is a lower bound (admission cost plus one
    smallest-bucket step per token), so at low load no feasible request is
    shed;
  * **SLO classes**: named classes with their own deadlines and an
    optional token-bucket rate each.

``EngineConfig.admission = None`` is the plain FIFO queue.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

__all__ = ["SLOClass", "TokenBucket", "AdmissionConfig", "AdmissionPolicy",
           "parse_slo_classes"]

ORDERS = ("fifo", "edf", "slack")


@dataclasses.dataclass(frozen=True)
class SLOClass:
  """One service-level class: its own deadline and (optionally) its own
  admission rate.  ``rate_per_s=inf`` = no rate limit."""
  name: str
  deadline_ms: float
  rate_per_s: float = math.inf
  burst: float = 4.0

  def __post_init__(self):
    if self.deadline_ms <= 0.0:
      raise ValueError(f"class {self.name!r}: deadline {self.deadline_ms}")
    if self.rate_per_s <= 0.0:
      raise ValueError(f"class {self.name!r}: rate {self.rate_per_s}")


@dataclasses.dataclass
class TokenBucket:
  """Continuous-refill token bucket on the engine's ms clock."""
  rate_per_s: float
  burst: float = 4.0

  def __post_init__(self):
    self.tokens = float(self.burst)
    self.last_ms = 0.0

  def take(self, now_ms: float) -> bool:
    now_ms = max(now_ms, self.last_ms)
    self.tokens = min(self.burst, self.tokens + (now_ms - self.last_ms)
                      * self.rate_per_s / 1000.0)
    self.last_ms = now_ms
    if self.tokens >= 1.0:
      self.tokens -= 1.0
      return True
    return False


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
  """Admission knobs (`EngineConfig.admission`; None = plain FIFO)."""
  order: str = "edf"             # fifo | edf | slack
  shed: bool = True              # predictive shed-at-admission
  shed_margin: float = 1.0       # shed when now+demand > arrival+ddl*margin
  classes: Tuple[SLOClass, ...] = ()

  def __post_init__(self):
    if self.order not in ORDERS:
      raise ValueError(f"order {self.order!r} not in {ORDERS}")
    if self.shed_margin <= 0.0:
      raise ValueError(f"shed_margin {self.shed_margin} <= 0")
    names = [c.name for c in self.classes]
    if len(names) != len(set(names)):
      raise ValueError(f"duplicate SLO class names {names}")


class AdmissionPolicy:
  """Queue decisions for one engine: deadline resolution, rate limiting,
  predictive shedding and ordering, per the :class:`AdmissionConfig`.

  ``demand_fn(req) -> ms`` is supplied by the engine: its lower-bound
  estimate of the request's total service demand (admission cost + steps
  at the predictor's smallest-bucket wall)."""

  def __init__(self, cfg: AdmissionConfig, default_deadline_ms: float,
               demand_fn: Callable[[object], float]):
    self.cfg = cfg
    self.default_deadline_ms = float(default_deadline_ms)
    self.demand_fn = demand_fn
    self._classes: Dict[str, SLOClass] = {c.name: c for c in cfg.classes}
    self._buckets: Dict[str, TokenBucket] = {
        c.name: TokenBucket(c.rate_per_s, c.burst)
        for c in cfg.classes if math.isfinite(c.rate_per_s)}

  def reset(self) -> None:
    for b in self._buckets.values():
      b.__post_init__()

  def deadline_for(self, req) -> float:
    """Per-request deadline: explicit override > SLO class > engine
    default."""
    if getattr(req, "deadline_ms", None) is not None:
      return float(req.deadline_ms)
    cls = self._classes.get(getattr(req, "slo", "default"))
    return cls.deadline_ms if cls is not None else self.default_deadline_ms

  def rate_admit(self, req, now_ms: float) -> bool:
    """Token-bucket gate for the request's class (True = may proceed)."""
    bucket = self._buckets.get(getattr(req, "slo", "default"))
    return bucket is None or bucket.take(now_ms)

  def predicted_dead(self, req, now_ms: float,
                     demand_ms: Optional[float] = None) -> bool:
    """True when the predicted completion already misses the deadline —
    the request would burn a prefill and decode steps only to score 0."""
    if not self.cfg.shed:
      return False
    demand = self.demand_fn(req) if demand_ms is None else demand_ms
    ddl = req.arrival_ms + self.deadline_for(req) * self.cfg.shed_margin
    return now_ms + demand > ddl

  def key(self, req, now_ms: float):
    """Queue-ordering key (smaller = first).  FIFO ties on arrival order
    via rid, as the plain queue does."""
    if self.cfg.order == "fifo":
      return (req.arrival_ms, req.rid)
    ddl = req.arrival_ms + self.deadline_for(req)
    if self.cfg.order == "edf":
      return (ddl, req.rid)
    return (ddl - now_ms - self.demand_fn(req), req.rid)   # least slack


def parse_slo_classes(text: Optional[str]) -> Tuple[SLOClass, ...]:
  """CLI spec -> SLO classes: ``name:deadline_ms[@rate_per_s[/burst]]``
  comma-separated, e.g. ``interactive:80@60,batch:400``."""
  if not text:
    return ()
  out = []
  for part in text.split(","):
    name, _, rest = part.strip().partition(":")
    if not rest:
      raise ValueError(f"SLO class {part!r}: want name:deadline[@rate]")
    ddl, _, rate = rest.partition("@")
    kw = {"name": name, "deadline_ms": float(ddl)}
    if rate:
      r, _, burst = rate.partition("/")
      kw["rate_per_s"] = float(r)
      if burst:
        kw["burst"] = float(burst)
    out.append(SLOClass(**kw))
  return tuple(out)
