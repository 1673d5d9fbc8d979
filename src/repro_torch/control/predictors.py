"""Per-component latency predictors (the port's own copy of
``repro.control.predictors``).

Every place the serving stack predicts a response time consumes one of
these objects behind one duck-typed interface:

    observe(budget, latency_ms)   fold one measured (budget, wall) pair
    predict(budget) -> float      expected latency of that budget bucket
    table() -> {bucket: ms}       snapshot over the observed buckets

* :class:`AffinePredictor`: exponentially weighted least-squares fit of
  ``lat(i) = base + slope * i``.
* :class:`EwmaPredictor`: one EWMA cell per budget bucket with
  nearest-bucket fallback.
* :class:`QuantilePredictor`: a sliding window per bucket; ``predict``
  returns a configured percentile of it, so deadlines can target e.g. the
  p90 step time instead of the mean.

:func:`make_predictor` builds one from a spec string (``"affine"`` |
``"ewma"`` | ``"quantile"`` | ``"quantile:95"``).  :class:`TailTracker`
and :func:`percentile` are the latency percentiles the engine and the
simulator report.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import ClassVar, Dict, List, Sequence

import numpy as np


def percentile(xs: Sequence[float], p: float) -> float:
  if len(xs) == 0:
    return 0.0
  return float(np.percentile(np.asarray(xs), p))


class TailTracker:
  """Streaming latency percentiles per window (p50/p99/p99.9)."""

  def __init__(self):
    self.samples: List[float] = []

  def observe(self, latency: float) -> None:
    self.samples.append(latency)

  def p(self, q: float) -> float:
    return percentile(self.samples, q)

  def summary(self) -> dict:
    return {"p50": self.p(50), "p99": self.p(99), "p999": self.p(99.9),
            "mean": float(np.mean(self.samples)) if self.samples else 0.0,
            "n": len(self.samples)}


@dataclasses.dataclass
class AffinePredictor:
  """Exponentially weighted least-squares fit of lat(i) = base + slope*i.

  Sufficient statistics decay by (1 - alpha) per observation, so the model
  tracks drifting service times (load changes, interference)."""
  base: float = 1.0
  slope: float = 0.1
  alpha: float = 0.05          # forgetting rate
  # The fitted line extrapolates soundly to budgets never tried (cost
  # grows with the positive slope); bucketed predictors do not.
  extrapolates: ClassVar[bool] = True

  def __post_init__(self):
    self._sw = self._sb = self._sl = self._sbb = self._sbl = 0.0
    self._seen: set = set()

  def observe(self, budget: int, latency: float) -> None:
    g = 1.0 - self.alpha
    b = float(budget)
    self._seen.add(int(budget))
    self._sw = self._sw * g + 1.0
    self._sb = self._sb * g + b
    self._sl = self._sl * g + latency
    self._sbb = self._sbb * g + b * b
    self._sbl = self._sbl * g + b * latency
    det = self._sw * self._sbb - self._sb * self._sb
    if det > 1e-9 and self._sw > 3.0:
      slope = (self._sw * self._sbl - self._sb * self._sl) / det
      base = (self._sl - slope * self._sb) / self._sw
      self.slope = max(slope, 1e-6)
      self.base = max(base, 1e-6)
    else:
      self.base = max(self._sl / max(self._sw, 1e-9), 1e-6)

  def predict(self, budget: int) -> float:
    return self.base + self.slope * budget

  def observed_buckets(self):
    return sorted(self._seen)

  def table(self) -> Dict[int, float]:
    return {b: self.predict(b) for b in sorted(self._seen)}


@dataclasses.dataclass
class EwmaPredictor:
  """One EWMA cell per budget bucket; unobserved buckets fall back to the
  nearest observed bucket, then to ``prior_ms``."""
  beta: float = 0.3            # weight on the newest observation
  prior_ms: float = 5.0
  # Nearest-bucket fallback makes untried budgets look as cheap as the
  # nearest tried one: the budget controller must ramp, not trust it.
  extrapolates: ClassVar[bool] = False

  def __post_init__(self):
    self._t: Dict[int, float] = {}

  def observe(self, budget: int, latency: float) -> None:
    b = int(budget)
    prev = self._t.get(b)
    self._t[b] = latency if prev is None \
        else (1.0 - self.beta) * prev + self.beta * latency

  def predict(self, budget: int) -> float:
    b = int(budget)
    if b in self._t:
      return self._t[b]
    if self._t:
      nearest = min(self._t, key=lambda x: abs(x - b))
      return self._t[nearest]
    return self.prior_ms

  def observed_buckets(self):
    return sorted(self._t)

  def table(self) -> Dict[int, float]:
    return dict(self._t)


@dataclasses.dataclass
class QuantilePredictor:
  """Sliding-window quantile digest per budget bucket.

  ``predict`` returns the ``pct`` percentile over the last ``window``
  observations of that bucket (nearest observed bucket, then ``prior_ms``,
  when unobserved), so a high percentile target makes the deadline
  controller conservative exactly when step times are heavy-tailed."""
  pct: float = 90.0
  window: int = 64
  prior_ms: float = 5.0
  extrapolates: ClassVar[bool] = False   # same fallback rule as EWMA

  def __post_init__(self):
    if not 0.0 <= self.pct <= 100.0:
      raise ValueError(f"pct {self.pct} outside [0, 100]")
    if self.window < 1:
      raise ValueError(f"window {self.window} < 1")
    self._w: Dict[int, collections.deque] = {}

  def observe(self, budget: int, latency: float) -> None:
    self._w.setdefault(
        int(budget), collections.deque(maxlen=self.window)).append(latency)

  def predict(self, budget: int, pct: float | None = None) -> float:
    b = int(budget)
    if b not in self._w:
      if not self._w:
        return self.prior_ms
      b = min(self._w, key=lambda x: abs(x - budget))
    return percentile(self._w[b], self.pct if pct is None else pct)

  def observed_buckets(self):
    return sorted(self._w)

  def table(self) -> Dict[int, float]:
    return {b: self.predict(b) for b in sorted(self._w)}


def make_predictor(spec: str, **kw):
  """Build a predictor from a spec string: ``"affine"``, ``"ewma"``,
  ``"quantile"`` or ``"quantile:<pct>"``.  ``kw`` forwards to the class
  (``base=/slope=/alpha=`` for affine, ``prior_ms=`` for the bucketed
  ones)."""
  name, _, arg = str(spec).partition(":")
  if name in ("affine", "ewma") and arg:
    raise ValueError(f"predictor spec {spec!r}: only quantile takes a "
                     ":<pct> argument; pass keyword overrides for "
                     f"{name} instead")
  if name == "affine":
    return AffinePredictor(**kw)
  if name == "ewma":
    return EwmaPredictor(**kw)
  if name == "quantile":
    if arg:
      kw.setdefault("pct", float(arg))
    return QuantilePredictor(**kw)
  raise ValueError(f"unknown predictor spec {spec!r} "
                   "(want affine | ewma | quantile[:pct])")
