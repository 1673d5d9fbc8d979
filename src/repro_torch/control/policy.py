"""Deadline -> budget policy (the port's own copy of the parts of
``repro.control.policy`` that the single-component engine uses).

:class:`BudgetController` maps (deadline, queue delay) to the largest
bucketed refinement budget its latency predictor expects to finish in
time.  :class:`DeadlineBudgetPolicy` dispatches on the technique
(``basic`` / ``partial`` / ``accuracytrader`` / ``fixed``) and composes it
with the serving contract: under ``error_bounded`` the step budget is the
smaller of the deadline's and the one the accuracy estimator
(``control.estimator``) predicts meets ε.  ``allocate_budget``,
``gather_modes`` and ``recover_modes`` wait for the multi-component tiers
(ROADMAP A.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.control.predictors import AffinePredictor

POLICIES = ("basic", "partial", "accuracytrader", "fixed")

# Serving contracts, orthogonal to the policies:
#   "deadline"            whatever the policy says;
#   "error_bounded"       refine until the online estimator predicts loss
#                         <= ε and answer early; the freed budget is
#                         accounted per step;
#   "deadline_with_bound" the policy's budgets, and a calibrated loss band
#                         on every answer.
CONTRACTS = ("deadline", "error_bounded", "deadline_with_bound")


def check_contract(contract: str) -> None:
  """Raise unless ``contract`` is one of :data:`CONTRACTS`."""
  if contract not in CONTRACTS:
    raise ValueError(f"contract {contract!r} not in {CONTRACTS}")


@dataclasses.dataclass
class BudgetController:
  """Maps (deadline, queue delay) -> the largest static budget bucket the
  predictor expects to finish in time (always at least the smallest
  bucket: stage 1 runs no matter what)."""
  model: AffinePredictor         # any control.predictors implementation
  buckets: Sequence[int] = (0, 1, 2, 4, 8, 16, 32, 64, 128)
  i_max_cap: Optional[int] = None   # paper's i_max

  def budget_for(self, deadline: float, queue_delay: float = 0.0) -> int:
    slack = deadline - queue_delay
    candidates = self.buckets
    if not getattr(self.model, "extrapolates", True):
      # A bucketed predictor guesses an untried budget from the nearest
      # tried one, so a cold controller would see the largest bucket as
      # cheap as the smallest.  Slow start: trust tried buckets and
      # explore at most one bucket above the largest tried so far.
      seen = self.model.observed_buckets()
      top = max(seen) if seen else -1
      untried = [b for b in self.buckets if b > top]
      candidates = [b for b in self.buckets
                    if b <= top or b in untried[:1]]
    chosen = self.buckets[0]
    for b in candidates:
      if self.i_max_cap is not None and b > self.i_max_cap:
        continue
      if self.model.predict(b) <= slack and b > chosen:
        chosen = b
    return chosen

  def observe(self, budget: int, latency: float) -> None:
    self.model.observe(budget, latency)


@dataclasses.dataclass
class DeadlineBudgetPolicy:
  """Technique-aware budget decisions on one predictor.

  ``basic``/``partial`` always spend the full budget (``i_max_cap``);
  ``fixed`` always spends ``fixed_budget``; ``accuracytrader`` asks the
  controller for the largest bucket predicted to make the deadline."""
  policy: str
  buckets: Tuple[int, ...]
  i_max_cap: int
  predictor: AffinePredictor = dataclasses.field(
      default_factory=AffinePredictor)
  fixed_budget: int = 0
  # ``estimator`` is a ``control.estimator.AccuracyEstimator`` (only its
  # ``bucket_for_epsilon`` is called here); error_bounded needs one.
  contract: str = "deadline"
  epsilon: float = 0.0
  estimator: Optional[object] = None

  def __post_init__(self):
    if self.policy not in POLICIES:
      raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
    check_contract(self.contract)
    if self.contract == "error_bounded" and self.estimator is None:
      raise ValueError("contract='error_bounded' needs an estimator")
    self.controller = BudgetController(
        self.predictor, buckets=self.buckets, i_max_cap=self.i_max_cap)

  def budget_for(self, deadline: float, queue_delay: float = 0.0) -> int:
    if self.policy in ("basic", "partial"):
      return self.i_max_cap
    if self.policy == "fixed":
      return self.fixed_budget
    return self.controller.budget_for(deadline, queue_delay)

  def budget_for_contract(self, deadline: float, queue_delay: float = 0.0,
                          profiles: Sequence = ()) -> Tuple[int, int]:
    """(granted, base): ``base`` is the policy's deadline budget; under
    ``error_bounded`` ``granted`` is the smaller of it and the smallest
    bucket the estimator predicts meets ε for every profile in
    ``profiles`` (the most demanding resident binds: a step is shared).
    ``base - granted`` is the budget freed."""
    base = self.budget_for(deadline, queue_delay)
    if self.contract != "error_bounded" or not len(profiles):
      return base, base
    need = max(self.estimator.bucket_for_epsilon(p, self.buckets,
                                                 self.epsilon)
               for p in profiles)
    return min(need, base), base

  def observe(self, budget: int, latency: float) -> None:
    self.predictor.observe(budget, latency)
