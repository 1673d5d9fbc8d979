"""Gather-side recovery ladder: timeout -> bounded retry -> stage-1
fallback (the port's own copy of ``repro.control.recovery``).

The one-shot hedge (``DeadlineBudgetPolicy.gather_modes``) reissues a
component predicted to miss the step deadline to the shard's ring
replica, immediately, once.  This module generalizes it into the recovery
ladder a fault-tolerant scatter-gather frontend runs (Tail-Tolerant
Distributed Search, arXiv 1707.07426):

  FULL  -> retry on replica (bounded, exponential backoff)
        -> STAGE1 (the frontend's cached synopsis answer stands in)
        -> DROP   (partial execution only: the shard's mass is skipped)

  * the per-component **timeout** is the control-plane predictor's
    expected completion of the primary (not a static constant), so slow
    shards get proportionally more patience than fast ones;
  * **retry r** dispatches after an exponential backoff delay
    ``timeout * backoff_base * backoff_mult^(r-1)`` (retry 0 is the
    legacy immediate hedge at delay 0) to the shard's next ring-replica
    holder, and the earliest live completion counts;
  * a component with **no live path** (primary and every tried replica
    crashed) terminally degrades by policy: ``accuracytrader`` serves
    the stage-1 synopsis (a dead component costs accuracy, never
    availability), ``partial`` drops the shard, ``basic``/``fixed``
    drop only when nothing can answer at all.

Everything here is pure array math over *predicted or realized*
completion times — the cluster backend supplies the times (with its
interference draws and fault world), `DeadlineBudgetPolicy.recover_modes`
supplies the technique dispatch, and the same functions price both the
plan-time decision and the account-time realization so they can never
drift apart (the same one-expression discipline as
``ClusterStepBackend._hedge_time``).

With ``max_retries=1``, no faults and zero delay this reproduces the
legacy ``gather_modes`` hedging decision exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.control.policy import MODE_DROP, MODE_FULL, MODE_STAGE1, POLICIES

__all__ = ["RetryPolicy", "plan_recovery", "realized_recovery"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """Bounded retry with exponential backoff.

  ``max_retries`` caps the reissues per shard per step; ``delays``
  converts a per-component timeout (the predictor's expected primary
  completion) into each retry's dispatch offset.  Retry 0 is the legacy
  immediate hedge (delay 0); retry r >= 1 waits
  ``timeout * backoff_base * backoff_mult^(r-1)`` — monotone
  non-decreasing for ``backoff_mult >= 1`` (asserted in tests)."""
  max_retries: int = 1
  backoff_base: float = 0.5
  backoff_mult: float = 2.0

  def __post_init__(self):
    if self.max_retries < 0:
      raise ValueError(f"max_retries {self.max_retries} < 0")
    if self.backoff_base < 0.0 or self.backoff_mult < 1.0:
      raise ValueError("backoff_base must be >= 0 and backoff_mult >= 1 "
                       f"(got {self.backoff_base}, {self.backoff_mult})")

  def delays(self, timeout_ms) -> np.ndarray:
    """Dispatch offsets of retries 0..max_retries-1: (K,) for a scalar
    timeout, (K, N) for a per-component timeout vector."""
    t = np.asarray(timeout_ms, np.float64)
    k = np.arange(self.max_retries, dtype=np.float64)
    fac = np.where(k == 0, 0.0,
                   self.backoff_base * self.backoff_mult ** (k - 1.0))
    return fac.reshape((self.max_retries,) + (1,) * t.ndim) * t[None]


def plan_recovery(policy: str, t_pred, deadline_ms: float,
                  t_retry=None, alive=None, retry_alive=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Pre-dispatch recovery decision for one step.

  ``t_pred`` (N,): predicted primary completions.  ``t_retry`` (K, N):
  predicted completion of retry r on its replica holder (backoff delay
  included).  ``alive`` / ``retry_alive``: fault-world liveness of the
  primary / each retry's holder (None = all alive).  Retries dispatch
  only while a component still has no live completion inside
  ``deadline_ms`` (dead primaries always retry — even under an infinite
  deadline there is nothing to wait for), and the earliest live
  completion decides the mode.

  Returns ``(mode, retries, eff)``: the int32 FULL/STAGE1/DROP vector,
  how many reissues each component actually dispatched (<= K, the
  bounded-retry invariant), and the effective decision time."""
  if policy not in POLICIES:
    raise ValueError(f"policy {policy!r} not in {POLICIES}")
  t_pred = np.asarray(t_pred, np.float64)
  n = t_pred.shape[0]
  alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
  eff = np.where(alive, t_pred, np.inf)
  retries = np.zeros(n, np.int64)
  k = 0 if t_retry is None else len(t_retry)
  if k:
    t_retry = np.asarray(t_retry, np.float64)
    retry_alive = np.ones((k, n), bool) if retry_alive is None \
        else np.asarray(retry_alive, bool)
  for r in range(k):
    need = ~(np.isfinite(eff) & (eff <= deadline_ms))
    if not need.any():
      break
    cand = np.where(retry_alive[r], t_retry[r], np.inf)
    eff = np.where(need, np.minimum(eff, cand), eff)
    retries = retries + need
  ok = np.isfinite(eff) & (eff <= deadline_ms)
  if policy == "partial":
    mode = np.where(ok, MODE_FULL, MODE_DROP)
  elif policy == "accuracytrader":
    mode = np.where(ok, MODE_FULL, MODE_STAGE1)
  else:
    # basic/fixed have no deadline semantics: FULL whenever any live
    # path exists, DROP only when nothing can answer at all.
    mode = np.where(np.isfinite(eff), MODE_FULL, MODE_DROP)
  return mode.astype(np.int32), retries, eff


def realized_recovery(t_real, t_retry_real, retries, alive=None,
                      retry_alive=None) -> np.ndarray:
  """Account-time twin of :func:`plan_recovery`: the realized completion
  of each component given the retries the plan actually dispatched
  (``retries`` from ``plan_recovery`` — retry r participates only where
  ``retries > r``).  Components with no live dispatched path realize
  ``inf`` (the caller's mode already degraded them to STAGE1/DROP)."""
  t_real = np.asarray(t_real, np.float64)
  n = t_real.shape[0]
  alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
  eff = np.where(alive, t_real, np.inf)
  k = 0 if t_retry_real is None else len(t_retry_real)
  if k:
    t_retry_real = np.asarray(t_retry_real, np.float64)
    retry_alive = np.ones((k, n), bool) if retry_alive is None \
        else np.asarray(retry_alive, bool)
  for r in range(k):
    m = retries > r
    cand = np.where(retry_alive[r], t_retry_real[r], np.inf)
    eff = np.where(m, np.minimum(eff, cand), eff)
  return eff
