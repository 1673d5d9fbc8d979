"""Latency predictors (the port's own copy of the part of
``repro.control.predictors`` that the serving loop uses; numpy-free plain
Python).

A predictor folds measured (budget, latency) pairs with ``observe`` and
answers ``predict(budget)``; :class:`~repro_torch.control.policy
.BudgetController` turns that into a refinement budget per step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class AffinePredictor:
  """Exponentially weighted least-squares fit of lat(i) = base + slope*i.

  Sufficient statistics decay by (1 - alpha) per observation, so the model
  tracks drifting service times (load changes, interference)."""
  base: float = 1.0
  slope: float = 0.1
  alpha: float = 0.05          # forgetting rate

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


def make_predictor(spec: str, **kw):
  """Build a predictor from a spec string.  The port has ``"affine"``;
  the JAX package's ``ewma`` and ``quantile`` predictors are not ported
  yet."""
  if spec != "affine":
    raise NotImplementedError(f"predictor {spec!r} is not ported "
                              "(the port has 'affine')")
  return AffinePredictor(**kw)
