"""Arrival-rate sources of the paper's two evaluations (the port's own copy
of the parts of ``repro.serving.workload`` that the engine uses).

* ``CF_RATES``: the synthetic recommender workload's constant arrival
  rates {20, 40, 60, 80, 100} req/s (Tables 1-2).
* ``SOGOU_HOURLY``: a 24-hour diurnal rate profile shaped like the Sogou
  query log (Fig 7a), indexed by 0-based hour of day (21 = 21:00, the
  peak); :func:`hour_rate` also takes the 1-based 1..24 (24 == 0)
  (:func:`canonical_hour`), :func:`hour_trend` names an hour's trend and
  :func:`hour_trace` draws its per-minute rates (the fleet autoscaler's
  24-hour workload).
* :func:`poisson_arrivals`: arrival offsets of one open-loop window, the
  same draws as the JAX package's for the same seed.
"""
from __future__ import annotations

from typing import List

import numpy as np

CF_RATES = (20, 40, 60, 80, 100)

# req/s at 0-based hour-of-day h (peak ~ 90 req/s at 21:00, Fig 7a).
SOGOU_HOURLY: List[float] = [
    35, 22, 14, 10, 8, 8, 10, 16, 28, 45, 55, 60,
    62, 58, 56, 58, 60, 62, 66, 74, 84, 90, 70, 50,
]


def canonical_hour(hour: int) -> int:
  """An hour in either the 0-based (0..23) or the 1-based (1..24)
  convention -> the 0-based index into ``SOGOU_HOURLY``; 24 == 0."""
  return hour % 24


def hour_rate(hour: int) -> float:
  """Arrival rate (req/s) at the given hour of day (0..23 or 1..24)."""
  return SOGOU_HOURLY[canonical_hour(hour)]


def hour_trend(hour: int) -> str:
  """The hour's trend: the 09:00 ramp, the 23:00 decay into midnight
  (hour 24 == hour 0), else steady."""
  h = canonical_hour(hour)
  if h == 9:
    return "increasing"
  if h in (23, 0):
    return "decreasing"
  return "steady"


def hour_trace(hour: int, sessions: int = 60, seed: int = 0) -> np.ndarray:
  """Per-minute arrival rates (req/s) of one hour: the hour's rate shaped
  by its trend, times lognormal noise drawn from ``seed + hour`` (the
  JAX package's draws).  ``hour_trace(0)`` and ``hour_trace(24)`` are the
  same trace."""
  h = canonical_hour(hour)
  rng = np.random.default_rng(seed + h)
  t = np.linspace(0, 1, sessions)
  trend = hour_trend(h)
  if trend == "increasing":
    shape = 0.55 + 0.9 * t
  elif trend == "decreasing":
    shape = 1.25 - 0.75 * t
  else:
    shape = np.ones_like(t)
  return SOGOU_HOURLY[h] * shape * rng.lognormal(0, 0.08, sessions)


def poisson_arrivals(rate_per_s: float, duration_s: float,
                     seed: int = 0) -> np.ndarray:
  """Arrival offsets (ms, sorted, starting at 0) of an open-loop Poisson
  process at ``rate_per_s`` over one ``duration_s`` window."""
  rng = np.random.default_rng(seed)
  out, t = [], 0.0
  end = duration_s * 1000.0
  while True:
    t += rng.exponential(1000.0 / max(rate_per_s, 1e-9))
    if t >= end:
      break
    out.append(t)
  return np.asarray(out)
