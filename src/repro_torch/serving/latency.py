"""Component behaviour model of the discrete-event simulator (the port's
own copy of ``repro.serving.latency``).

A component's service time follows the two-part form the deadline
controller assumes, ``base + per_item * items``, or a measured duration
(the engine's per-bucket step time, or the cluster tier's per-component
vector), times an injected fault slowdown, lognormal interference noise
and an occasional straggler slowdown, behind a FIFO queue.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ComponentModel:
  """Service-time model of one parallel component.  ``comp_id`` names
  this component inside its service: a measured ``service_ms`` may be a
  per-component vector (``ClusterMeasuredExport.step_ms_per_component``),
  from which the component picks its own entry.  ``work_scale``
  multiplies the service time (the Zipf component-skew knob)."""
  base_ms: float = 2.0            # synopsis / fixed overhead
  per_item_ms: float = 0.15       # per refined cluster (or per data part)
  full_items: int = 100           # items for exact full computation
  interference: float = 0.35      # lognormal sigma (co-located jobs)
  straggler_prob: float = 0.02    # chance of a severe slowdown
  straggler_scale: float = 8.0
  seed: int = 0
  comp_id: int = 0
  work_scale: float = 1.0

  def __post_init__(self):
    self.rng = np.random.default_rng(self.seed)
    self.busy_until = 0.0

  def _resolve_base(self, base_ms) -> Optional[float]:
    if base_ms is None:
      return None
    arr = np.asarray(base_ms, dtype=np.float64).ravel()
    if arr.size == 1:
      return float(arr[0])
    return float(arr[self.comp_id % arr.size])

  def service_time(self, items: int, base_ms=None,
                   scale: float = 1.0) -> float:
    """Service time for ``items``; ``base_ms`` replaces the modelled
    ``base + per_item * items`` with a measured duration (a scalar, or a
    per-component vector indexed by ``comp_id``); the noise and stragglers
    still apply.  ``scale`` multiplies the pre-noise time (an injected
    fault slowdown)."""
    base = self._resolve_base(base_ms)
    t = base if base is not None \
        else self.base_ms + self.per_item_ms * items
    t *= self.work_scale * scale
    t *= float(self.rng.lognormal(0.0, self.interference))
    if self.rng.random() < self.straggler_prob:
      t *= self.straggler_scale
    return t

  def submit(self, arrival_ms: float, items: int, service_ms=None,
             scale: float = 1.0) -> float:
    """FIFO queue: returns the completion time.  ``service_ms`` pins the
    pre-noise duration (scalar or per-component vector); ``scale`` injects
    a fault slowdown on this submission."""
    start = max(arrival_ms, self.busy_until)
    done = start + self.service_time(items, base_ms=service_ms, scale=scale)
    self.busy_until = done
    return done

  def peek_completion(self, arrival_ms: float, items: int,
                      quantile_extra: float = 0.0) -> float:
    start = max(arrival_ms, self.busy_until)
    return start + self.base_ms + self.per_item_ms * items + quantile_extra
