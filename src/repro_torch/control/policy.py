"""Deadline -> budget policy (the port's own copy of
``repro.control.policy``).

:class:`BudgetController` maps (deadline, queue delay) to the largest
bucketed refinement budget its latency predictor expects to finish in
time.  :class:`DeadlineBudgetPolicy` dispatches on the technique
(``basic`` / ``partial`` / ``accuracytrader`` / ``fixed``) and composes it
with the serving contract: under ``error_bounded`` the step budget is the
smaller of the deadline's and the one the accuracy estimator
(``control.estimator``) predicts meets ε.  For the scatter-gather tier
(``serve.cluster``) it also owns the per-component FULL / STAGE1 / DROP
decision (:meth:`DeadlineBudgetPolicy.gather_modes`, with the hedged
replica reissue, and its fault-aware generalization
:meth:`DeadlineBudgetPolicy.recover_modes`), in numpy on the host, and
:func:`allocate_budget` splits a step's budget over the components in
torch on the device, inside the step's captured graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.control.predictors import AffinePredictor

# Per-component gather modes (the fe_mode vector fed into the step).
MODE_DROP, MODE_STAGE1, MODE_FULL = 0, 1, 2

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


def _largest_remainder_rank(rem: torch.Tensor) -> torch.Tensor:
  """Each entry's rank in descending ``rem`` order, ties by index (the
  double stable argsort of ``jnp.argsort(-rem)``)."""
  order = torch.argsort(-rem, dim=-1, stable=True)
  return torch.argsort(order, dim=-1, stable=True)


def allocate_budget(mass: torch.Tensor, total: int, caps: torch.Tensor,
                    recirculate: bool = True) -> torch.Tensor:
  """Split ``total`` refinement clusters over components in proportion to
  relevance mass, on the device with no host sync (the step's graph runs
  it).

  ``mass`` (..., N) non-negative; ``caps`` (..., N) per-component valid
  cluster counts.  Largest-remainder rounding on top of the proportional
  floor; monotone in mass.  A budget covering the whole corpus saturates
  every cap exactly (the ``basic`` full gather stays exact).

  ``recirculate``: budget a binding cap would strand is respent over the
  still-unsaturated components, two rounds in proportion to mass, then one
  in proportion to the remaining capacity, which drains whatever is left
  (when ``left <= sum(caps - alloc)`` every capacity share fits under its
  cap).  So ``sum(alloc) == min(total, sum(caps))``, also where the
  unsaturated components carry zero mass; three fixed rounds, not N.
  With every cap 0 the final guard pins the allocation to ``caps``.
  Returns int32 (..., N)."""
  caps = caps.to(torch.int32)
  mass = mass.float()
  share = total * mass / torch.clamp_min(mass.sum(-1, keepdim=True), 1e-30)
  floor = torch.floor(share)
  base = torch.minimum(floor, caps.float()).to(torch.int32)
  rem = share - floor
  left = total - base.sum(-1, keepdim=True)
  extra = (_largest_remainder_rank(rem) < left).to(torch.int32)
  alloc = torch.minimum(base + extra, caps)

  if recirculate:
    def respend(alloc, weights):
      """One largest-remainder round of the residue in proportion to
      ``weights`` (zero-weight components sort last for the integer
      units)."""
      left = (total - alloc.sum(-1, keepdim=True)).float()
      share = left * weights / torch.clamp_min(
          weights.sum(-1, keepdim=True), 1e-30)
      floor = torch.floor(share)
      rem = torch.where(weights > 0, share - floor, -1.0)
      ints = left - floor.sum(-1, keepdim=True)
      extra = floor.to(torch.int32) + (
          _largest_remainder_rank(rem) < ints).to(torch.int32)
      return torch.minimum(alloc + extra, caps)

    for _ in range(2):
      alloc = respend(alloc, torch.where(alloc < caps, mass, 0.0))
    alloc = respend(alloc, (caps - alloc).float())

  capsum = caps.sum(-1, keepdim=True)
  return torch.where(total >= capsum, caps, alloc)


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

  def gather_modes(self, t_pred, deadline_ms: float, t_hedged=None):
    """Per-component gather decision from predicted completion times.

    ``t_pred`` (N,): each component's predicted completion for this step.
    ``t_hedged`` (N,) or None: the predicted completion of the same
    shard's reissue on its replica; where given, a component flagged as
    likely to miss is hedged and the earlier of the two completions
    decides (and later prices) its gather.

    Returns ``(mode, hedged)``: the int32 FULL/STAGE1/DROP vector fed to
    the device step, and the bool mask of components whose reissue was
    dispatched."""
    t_pred = np.asarray(t_pred, np.float64)
    hedged = np.zeros(t_pred.shape, bool)
    eff = t_pred
    if t_hedged is not None:
      hedged = t_pred > deadline_ms
      eff = np.where(hedged, np.minimum(t_pred, t_hedged), t_pred)
    if self.policy == "partial":
      mode = np.where(eff <= deadline_ms, MODE_FULL, MODE_DROP)
    elif self.policy == "accuracytrader":
      mode = np.where(eff <= deadline_ms, MODE_FULL, MODE_STAGE1)
    else:                       # basic / fixed: always full gather
      mode = np.full(t_pred.shape, MODE_FULL)
    return mode.astype(np.int32), hedged

  def recover_modes(self, t_pred, deadline_ms: float, t_retry=None,
                    alive=None, retry_alive=None):
    """Fault-aware generalization of :meth:`gather_modes`: the recovery
    ladder FULL -> retry on a replica -> STAGE1 -> DROP
    (``control.recovery``).  ``t_retry`` (K, N) carries the predicted
    completion of each bounded backoff retry; ``alive`` / ``retry_alive``
    the fault world's liveness.  Returns ``(mode, retries, eff)``; with
    one zero-delay retry and every component alive, this is the hedged
    ``gather_modes`` decision."""
    from repro_torch.control.recovery import plan_recovery  # noqa: PLC0415
    return plan_recovery(self.policy, t_pred, deadline_ms, t_retry=t_retry,
                         alive=alive, retry_alive=retry_alive)
