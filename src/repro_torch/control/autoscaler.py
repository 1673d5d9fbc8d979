"""The fleet autoscaler over the diurnal trace (counterpart of
``repro.control.autoscaler``; numpy and Python only).

The fleet tier's capacity knob is its grid: ``n`` active components (each
owning 1/n of every resident corpus: more components, shorter steps)
times ``r`` materialized replica rows (a deeper replica-selection min over
the per-step straggler draws: a shorter tail, not a shorter mean).  The
autoscaler resizes per measurement window against a p99 target from the
fleet's measured step walls.

Sizing is a scan over an analytic queueing model (:meth:`Autoscaler.p99_of`):

  service  = steps_per_request * step_ms(n, r)
  capacity = slots * 1000 / service          requests per second
  rho      = rate / capacity
  p99      = service * (1 + (tail / r) * rho / (1 - rho))

``step_ms(n, r)`` is the fleet's measured export rescaled to a
counterfactual size (``serving.service.ScaledFleetExport.step_model``).
The model falls in n and r and rises in the rate, so the scan (smallest n,
then smallest r, that meets the target) gives a component count that never
decreases with load.

``decide`` adds hysteresis: scaling up is immediate, scaling down waits
for ``cooldown_windows`` consecutive windows in which the smaller size
meets the target with ``headroom`` to spare.  A scale-down drains first
(:func:`drain`): the engine steps its resident slots to retirement
without admitting new work, so resizing never drops a request in flight.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

__all__ = ["FleetSize", "AutoscalerConfig", "Autoscaler", "drain"]


@dataclasses.dataclass(frozen=True)
class FleetSize:
  """One fleet sizing: ``n_components`` columns x ``replicas`` rows."""
  n_components: int
  replicas: int = 1

  @property
  def devices(self) -> int:
    """Cost unit: machines held for the window (component-hours/window)."""
    return self.n_components * self.replicas


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
  """Decision-rule knobs.  ``tail_factor`` is the queueing model's
  straggler multiplier at rho -> 1 for an unreplicated row (calibrated
  loosely from the cluster tier's lognormal interference world; the
  simulator round-trip, not this constant, is the measured truth)."""
  p99_target_ms: float = 50.0
  min_components: int = 1
  max_components: int = 8
  min_replicas: int = 1
  max_replicas: int = 2
  slots: int = 2                 # concurrent decode lanes per fleet
  steps_per_request: float = 4.0
  tail_factor: float = 3.0
  headroom: float = 0.15         # shrink only if target met with margin
  cooldown_windows: int = 2      # consecutive qualifying windows to shrink


class Autoscaler:
  """Per-window fleet sizing against a p99 target.

  ``step_ms_fn(n, r)`` maps a candidate size to the predicted step wall
  (ms) — typically `ScaledFleetExport.step_model` over the fleet's
  measured export.  The instance carries the hysteresis state; one
  autoscaler per fleet, ``decide`` called once per measurement window.
  """

  def __init__(self, cfg: AutoscalerConfig,
               step_ms_fn: Callable[[int, int], float]):
    if cfg.min_components < 1 or cfg.max_components < cfg.min_components:
      raise ValueError(f"component bounds [{cfg.min_components}, "
                       f"{cfg.max_components}] invalid")
    if cfg.min_replicas < 1 or cfg.max_replicas < cfg.min_replicas:
      raise ValueError(f"replica bounds [{cfg.min_replicas}, "
                       f"{cfg.max_replicas}] invalid")
    self.cfg = cfg
    self.step_ms_fn = step_ms_fn
    self._shrink_streak = 0
    self.log: List[dict] = []

  # -- the analytic model ----------------------------------------------------
  def p99_of(self, rate_per_s: float, size: FleetSize) -> float:
    """Predicted window p99 at ``size`` (see module docstring).  Returns
    ``inf`` at or beyond saturation (rho >= 1)."""
    cfg = self.cfg
    service = cfg.steps_per_request * float(
        self.step_ms_fn(size.n_components, size.replicas))
    if service <= 0.0:
      return 0.0
    capacity = cfg.slots * 1000.0 / service
    rho = float(rate_per_s) / capacity
    if rho >= 1.0:
      return float("inf")
    tail = cfg.tail_factor / size.replicas
    return service * (1.0 + tail * rho / (1.0 - rho))

  def size_for(self, rate_per_s: float) -> FleetSize:
    """Smallest feasible size: scan n ascending, then r ascending, and
    take the first (n, r) whose predicted p99 meets the target.  p99 is
    monotone decreasing in both dims and increasing in rate, so the
    chosen n never decreases as the rate grows; nothing feasible =
    saturation -> the max grid (documented saturation window)."""
    cfg = self.cfg
    for n in range(cfg.min_components, cfg.max_components + 1):
      for r in range(cfg.min_replicas, cfg.max_replicas + 1):
        size = FleetSize(n, r)
        if self.p99_of(rate_per_s, size) <= cfg.p99_target_ms:
          return size
    return FleetSize(cfg.max_components, cfg.max_replicas)

  # -- the windowed decision rule --------------------------------------------
  def decide(self, rate_per_s: float,
             current: Optional[FleetSize] = None) -> FleetSize:
    """One measurement window's sizing decision with hysteresis:
    scale-up is immediate (elementwise max, so growing one dimension
    never silently shrinks the other), scale-down requires
    ``cooldown_windows`` consecutive windows in which the smaller target
    also meets the p99 target with ``headroom`` to spare."""
    cfg = self.cfg
    target = self.size_for(rate_per_s)
    if current is None:
      self._shrink_streak = 0
      self._record(rate_per_s, target, target, "init")
      return target
    if target.n_components > current.n_components \
        or target.replicas > current.replicas:
      self._shrink_streak = 0
      up = FleetSize(max(target.n_components, current.n_components),
                     max(target.replicas, current.replicas))
      self._record(rate_per_s, target, up, "up")
      return up
    if target == current:
      self._shrink_streak = 0
      self._record(rate_per_s, target, current, "hold")
      return current
    # target strictly within current: shrink only after the cooldown,
    # and only if the smaller size clears the target with headroom.
    margin_ok = self.p99_of(rate_per_s, target) \
        <= cfg.p99_target_ms * (1.0 - cfg.headroom)
    self._shrink_streak = self._shrink_streak + 1 if margin_ok else 0
    if self._shrink_streak >= cfg.cooldown_windows:
      self._shrink_streak = 0
      self._record(rate_per_s, target, target, "down")
      return target
    self._record(rate_per_s, target, current, "cooldown")
    return current

  def _record(self, rate, target, chosen, action) -> None:
    self.log.append({"rate": float(rate), "action": action,
                     "target": (target.n_components, target.replicas),
                     "chosen": (chosen.n_components, chosen.replicas)})


def drain(engine) -> int:
  """Drain-before-retire: step the engine's resident slots to completion
  WITHOUT admitting new work, so a scale-down never drops an in-flight
  request (every retirement happens with ``remaining == 0``, hence
  ``dropped`` False).  Returns the number of requests retired by the
  drain."""
  before = len(engine.completed)
  while True:
    active = [i for i, s in enumerate(engine.slots) if s is not None]
    if not active:
      break
    engine._decode_step(active)
  return len(engine.completed) - before
