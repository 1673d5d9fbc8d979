"""Deadline -> budget mapping (the port's own copy of
``repro.control.policy.BudgetController``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.control.predictors import AffinePredictor


@dataclasses.dataclass
class BudgetController:
  """Maps (deadline, queue delay) -> the largest static budget bucket the
  predictor expects to finish in time (always at least the smallest
  bucket: stage 1 runs no matter what)."""
  model: AffinePredictor
  buckets: Sequence[int] = (0, 1, 2, 4, 8, 16, 32, 64, 128)
  i_max_cap: Optional[int] = None   # paper's i_max

  def budget_for(self, deadline: float, queue_delay: float = 0.0) -> int:
    slack = deadline - queue_delay
    chosen = self.buckets[0]
    for b in self.buckets:
      if self.i_max_cap is not None and b > self.i_max_cap:
        continue
      if self.model.predict(b) <= slack and b > chosen:
        chosen = b
    return chosen

  def observe(self, budget: int, latency: float) -> None:
    self.model.observe(budget, latency)
