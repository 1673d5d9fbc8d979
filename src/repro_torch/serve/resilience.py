"""Deterministic component fault injection for the serving stack (the
port's own copy of ``repro.serve.resilience``).

AccuracyTrader's premise is graceful degradation — every component can
always answer from its synopsis — yet a serving tier that only degrades
along the refinement-budget axis silently assumes components never
*fail*.  This module provides the fault model both the cluster tier
(``serve.cluster.ClusterStepBackend``) and the discrete-event
simulator (``serving.service``) inject:

  * **crash** — the component stops serving (its primary shard and any
    replica shard it holds) either forever or for ``down_steps`` steps;
    scheduled deterministically (``FaultSpec.crash``) or drawn at a
    per-component per-step rate (``crash_rate``);
  * **transient stall** — one step where the component's completion is
    multiplied by ``stall_scale`` (a GC pause, a page fault storm);
  * **persistent slowdown** — ``slow_scale`` × for ``slow_steps``
    consecutive steps (a co-located job landing on the machine).

Everything is **seed-deterministic**: the fault state of step ``t`` is a
pure function of ``(spec.seed, window_seed, t)`` — each step's draws come
from their own ``SeedSequence([seed, window, step])`` stream, so replays,
warmup length, and query order cannot shift the injected faults, and a
re-run of a benchmark window reproduces the same fault world
(``FaultPlan.reseed`` is called per measurement window exactly like the
backend's interference stream).

``FaultPlan(None, n)`` is the **disabled** plan: ``enabled`` is False,
``at(step)`` returns the all-alive state, and callers guard their fault
branches on ``enabled`` so the disabled path is bit-identical to a stack
without fault injection at all.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["FaultSpec", "FaultState", "FaultPlan", "parse_fault_spec"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
  """Declarative fault world for one serving run.

  ``crash`` schedules deterministic crashes as ``(step, component)``
  pairs (the component is dead from that step on, or for ``down_steps``
  steps when > 0); the ``*_rate`` knobs draw additional faults per
  component per step.  All randomness is derived from ``seed`` (plus the
  per-window reseed), never from the backend's interference stream."""
  crash: Tuple[Tuple[int, int], ...] = ()   # (step, component) schedule
  crash_rate: float = 0.0                   # per component per step
  down_steps: int = 0                       # 0 = crashed forever
  stall_rate: float = 0.0                   # transient one-step stall
  stall_scale: float = 25.0
  slow_rate: float = 0.0                    # persistent slowdown onset
  slow_scale: float = 4.0
  slow_steps: int = 16
  seed: int = 0

  def __post_init__(self):
    for name in ("crash_rate", "stall_rate", "slow_rate"):
      v = getattr(self, name)
      if not 0.0 <= v <= 1.0:
        raise ValueError(f"{name} {v} outside [0, 1]")
    for s, c in self.crash:
      if s < 0 or c < 0:
        raise ValueError(f"crash entry ({s}, {c}) must be non-negative")


@dataclasses.dataclass(frozen=True)
class FaultState:
  """One step's injected world: ``alive[c]`` is False while component c
  is crashed; ``slow[c]`` multiplies its completion time (1.0 = clean)."""
  alive: np.ndarray            # (N,) bool
  slow: np.ndarray             # (N,) float64

  @property
  def clean(self) -> bool:
    return bool(self.alive.all() and (self.slow == 1.0).all())


class FaultPlan:
  """Seed-deterministic fault schedule over ``n_components``.

  ``at(step)`` returns the :class:`FaultState` of that step.  States are
  derived sequentially (a crash at step t shadows steps t..t+down) but
  each step's *draws* are a pure function of ``(seed, window, step)``,
  so the schedule is independent of when or how often it is queried.
  ``FaultPlan(None, n)`` is the disabled no-op plan."""

  def __init__(self, spec: Optional[FaultSpec], n_components: int):
    self.spec = spec
    self.n = int(n_components)
    self.enabled = spec is not None
    self._window = 0
    self._reset()

  def _reset(self) -> None:
    self._states: List[FaultState] = []
    self._down_until = np.full(self.n, -1, np.int64)   # last dead step
    self._slow_until = np.full(self.n, -1, np.int64)

  def reseed(self, window_seed: int) -> None:
    """New measurement window: fresh fault world keyed by the window seed
    (mirrors ``ClusterStepBackend.reseed`` — the engine's ``run_open_loop``
    calls both, so a window's faults regenerate bit-identically)."""
    self._window = int(window_seed) & 0x7FFFFFFF
    self._reset()

  def _advance(self) -> FaultState:
    step = len(self._states)
    sp = self.spec
    rng = np.random.default_rng(
        np.random.SeedSequence([int(sp.seed), self._window, step]))
    # Scheduled crashes fire regardless of rates.
    for s, c in sp.crash:
      if s == step and c < self.n:
        self._down_until[c] = (step + sp.down_steps - 1) if sp.down_steps \
            else np.iinfo(np.int64).max
    # Drawn faults: one uniform vector per fault kind per step, so the
    # kinds' draws never alias each other.
    if sp.crash_rate > 0.0:
      hit = rng.random(self.n) < sp.crash_rate
      until = (step + sp.down_steps - 1) if sp.down_steps \
          else np.iinfo(np.int64).max
      self._down_until = np.where(hit, np.maximum(self._down_until, until),
                                  self._down_until)
    slow = np.ones(self.n, np.float64)
    if sp.slow_rate > 0.0:
      onset = rng.random(self.n) < sp.slow_rate
      self._slow_until = np.where(
          onset, np.maximum(self._slow_until, step + sp.slow_steps - 1),
          self._slow_until)
    slow = np.where(self._slow_until >= step, sp.slow_scale, slow)
    if sp.stall_rate > 0.0:
      slow = np.where(rng.random(self.n) < sp.stall_rate,
                      slow * sp.stall_scale, slow)
    alive = self._down_until < step
    state = FaultState(alive=alive, slow=slow)
    self._states.append(state)
    return state

  def at(self, step: int) -> FaultState:
    if not self.enabled:
      return FaultState(alive=np.ones(self.n, bool),
                        slow=np.ones(self.n, np.float64))
    step = int(step)
    while len(self._states) <= step:
      self._advance()
    return self._states[step]


def parse_fault_spec(text: Optional[str]) -> Optional[FaultSpec]:
  """CLI spec -> :class:`FaultSpec` (None / "" / "none" -> None).

  Comma-separated ``key=value`` pairs; ``crash`` takes ``comp@step``
  entries joined by ``+``:

      crash=1@8,down_steps=0,stall_rate=0.02,seed=3
      crash=0@4+3@10,slow_rate=0.01,slow_scale=6
  """
  if not text or text.lower() == "none":
    return None
  kw = {}
  for part in text.split(","):
    key, _, val = part.partition("=")
    key = key.strip()
    if key == "crash":
      entries = []
      for ent in val.split("+"):
        comp, _, step = ent.partition("@")
        entries.append((int(step), int(comp)))
      kw["crash"] = tuple(entries)
    elif key in ("down_steps", "slow_steps", "seed"):
      kw[key] = int(val)
    elif key in ("crash_rate", "stall_rate", "slow_rate",
                 "stall_scale", "slow_scale"):
      kw[key] = float(val)
    else:
      raise ValueError(f"unknown fault spec key {key!r} in {text!r}")
  return FaultSpec(**kw)
