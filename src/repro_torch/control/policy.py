"""Deadline -> budget policy (the port's own copy of the parts of
``repro.control.policy`` that the single-component engine uses).

:class:`BudgetController` maps (deadline, queue delay) to the largest
bucketed refinement budget its latency predictor expects to finish in
time.  :class:`DeadlineBudgetPolicy` dispatches on the technique
(``basic`` / ``partial`` / ``accuracytrader`` / ``fixed``).  The port runs
the ``"deadline"`` serving contract only: the ε-or-deadline contracts
wait for the accuracy estimator (ROADMAP A.3), and ``allocate_budget``,
``gather_modes`` and ``recover_modes`` for the multi-component tiers
(ROADMAP A.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.control.predictors import AffinePredictor

POLICIES = ("basic", "partial", "accuracytrader", "fixed")

# Serving contracts (the JAX package's names); the port runs "deadline".
CONTRACTS = ("deadline", "error_bounded", "deadline_with_bound")


def check_contract(contract: str) -> None:
  """Raise unless ``contract`` is the one the port runs."""
  if contract not in CONTRACTS:
    raise ValueError(f"contract {contract!r} not in {CONTRACTS}")
  if contract != "deadline":
    raise NotImplementedError(
        f"contract {contract!r} needs the accuracy estimator, which the "
        "port has not ported yet (ROADMAP A.3); the port runs 'deadline'")


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
  contract: str = "deadline"

  def __post_init__(self):
    if self.policy not in POLICIES:
      raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
    check_contract(self.contract)
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
    """(granted, base) under the serving contract: under ``"deadline"``,
    the only one the port runs, both are the policy's budget."""
    check_contract(self.contract)
    base = self.budget_for(deadline, queue_delay)
    return base, base

  def observe(self, budget: int, latency: float) -> None:
    self.predictor.observe(budget, latency)
