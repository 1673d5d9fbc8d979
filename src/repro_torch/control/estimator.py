"""Online per-request accuracy-loss estimation (the port's own copy of
``repro.control.estimator``).

* :func:`coverage_profile` is torch: it runs on the device inside the
  engine's decode step (a captured CUDA graph on the card), from the
  stage-1 ``scores`` and ``counts`` the fused kernel already gave, with no
  host read.  Entry ``b`` of the profile is the fraction of the stage-1
  probability mass (``exp(score) * count``) that the first ``b`` clusters
  in refinement order cover.
* The rest is host code on numpy, as in the JAX package:
  :class:`AccuracyEstimator` turns a profile into a raw loss estimate
  (``floor * (1 - profile[b])``) and a Verdict-style spread, calibrates the
  raw estimate onto measured loss (isotonic, affine below 8 pairs) and
  gives confidence bands; :func:`spearman`, :func:`isotonic_fit` and
  :func:`calibration_pairs` serve the calibration.

The two ε-or-deadline contracts (``control.policy.CONTRACTS``) consume it:
``error_bounded`` refines until the predicted loss is at most ε, and
``deadline_with_bound`` attaches a band to every answer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def coverage_profile(scores: torch.Tensor, counts: torch.Tensor,
                     rank: str = "score") -> torch.Tensor:
  """Cumulative covered-mass profile from stage-1 outputs, on the device.

  ``scores`` (B, Hkv, M) stage-1 centroid scores (NEG_INF on invalid
  slots); ``counts`` (B, M) cluster token counts.  Returns (B, M+1) f32:
  the covered fraction after the first ``b`` clusters in ``rank`` order
  (``"score"``: the top-k order of stage 2; ``"mass"``: by weight),
  averaged over the kv heads.  ``profile[0] == 0`` and ``profile[M] ==
  1`` wherever any valid mass exists."""
  scores = scores.float()
  valid = scores > NEG_INF / 2
  smax = torch.where(valid, scores, NEG_INF).amax(-1, keepdim=True)
  smax = smax.clamp_min(NEG_INF / 4)             # all-invalid row guard
  w = torch.where(valid, torch.exp(scores - smax), 0.0)
  w = w * counts.float().clamp_min(0.0)[:, None, :]
  key = scores if rank == "score" else w
  # Descending order, ties by index (argsort of the negated key, as
  # ``jnp.argsort(-key)``).
  order = torch.argsort(-key, dim=-1, stable=True)
  cum = torch.cumsum(torch.gather(w, -1, order), dim=-1)
  tot = cum[..., -1:].clamp_min(1e-30)
  prof = torch.cat([torch.zeros_like(cum[..., :1]), cum / tot], dim=-1)
  return prof.mean(dim=1).clamp(0.0, 1.0)                  # (B, M+1)


def _ranks(x: np.ndarray) -> np.ndarray:
  """Average ranks (ties share their mean rank), 1-based."""
  x = np.asarray(x, np.float64)
  order = np.argsort(x, kind="mergesort")
  sx = x[order]
  ranks = np.empty(len(x), np.float64)
  i = 0
  while i < len(x):
    j = i
    while j + 1 < len(x) and sx[j + 1] == sx[i]:
      j += 1
    ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
    i = j + 1
  return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
  """Spearman rank correlation (average ranks on ties; no scipy)."""
  ra, rb = _ranks(np.asarray(a)), _ranks(np.asarray(b))
  ra = ra - ra.mean()
  rb = rb - rb.mean()
  den = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
  if den <= 0.0:
    return 0.0
  return float((ra * rb).sum() / den)


def isotonic_fit(x, y) -> Tuple[np.ndarray, np.ndarray]:
  """Monotone non-decreasing least-squares fit of y on x
  (pool-adjacent-violators).  Returns knots ``(xk, yk)`` with strictly
  increasing ``xk`` (duplicate x collapse to their block mean) and
  non-decreasing ``yk``."""
  x = np.asarray(x, np.float64)
  y = np.asarray(y, np.float64)
  order = np.argsort(x, kind="mergesort")
  xs, ys = x[order], y[order]
  vals: List[float] = []
  wts: List[float] = []
  for yi in ys:
    vals.append(float(yi))
    wts.append(1.0)
    while len(vals) > 1 and vals[-2] > vals[-1]:
      y2, w2 = vals.pop(), wts.pop()
      y1, w1 = vals.pop(), wts.pop()
      vals.append((y1 * w1 + y2 * w2) / (w1 + w2))
      wts.append(w1 + w2)
  fitted = np.concatenate(
      [np.full(int(c), v) for v, c in zip(vals, wts)]) \
      if vals else np.zeros((0,))
  ux, inv = np.unique(xs, return_inverse=True)
  uy = np.array([fitted[inv == i].mean() for i in range(len(ux))])
  return ux, np.maximum.accumulate(uy)


def calibration_pairs(requests) -> Tuple[List[float], List[float]]:
  """(raw estimate, measured loss) pairs of the completed engine requests
  that were served to the end (a shed or dropped request's accuracy is
  the policy's, not the estimator's target)."""
  raws, measured = [], []
  for r in requests:
    if getattr(r, "est_raw", None) and not r.shed_admission \
        and not r.dropped:
      raws.append(float(np.mean(r.est_raw)))
      measured.append(1.0 - float(r.accuracy))
  return raws, measured


@dataclasses.dataclass
class AccuracyEstimator:
  """Per-request online loss estimate, held-out calibration and bands.

  ``floor`` is the loss of the synopsis answer alone (``1 -
  accuracy_fn(0)``).  ``conf`` is both the residual quantile kept as the
  band's half-width and the band's nominal coverage."""
  floor: float = 0.07
  conf: float = 0.9
  _iso_x: Optional[np.ndarray] = dataclasses.field(
      default=None, repr=False)
  _iso_y: Optional[np.ndarray] = dataclasses.field(
      default=None, repr=False)
  _resid_q: float = dataclasses.field(default=0.0, repr=False)

  @property
  def calibrated(self) -> bool:
    return self._iso_x is not None

  # -- raw signals (host, once per slot per decode step) ---------------------
  def raw_loss(self, profile, budget: int) -> float:
    """Raw predicted loss at ``budget`` refined clusters: the floor scaled
    by the uncovered mass; in [0, 1], ``floor`` at budget 0."""
    p = profile if isinstance(profile, np.ndarray) \
        else np.asarray(profile, np.float64)
    idx = min(max(int(budget), 0), p.shape[-1] - 1)
    return min(max(self.floor * (1.0 - float(p[..., idx])), 0.0), 1.0)

  def spread_from_profile(self, profile, budget: int) -> float:
    """Error propagation on the unrefined remainder: ``floor * residual /
    sqrt(n_eff)`` with ``n_eff = (sum d)^2 / sum d^2`` the effective number
    of unrefined clusters."""
    p = profile if isinstance(profile, np.ndarray) \
        else np.asarray(profile, np.float64)
    idx = min(max(int(budget), 0), p.shape[-1] - 1)
    tail = p[idx:]
    d = tail[1:] - tail[:-1]
    tot = float(tail[-1] - tail[0])
    if tot <= 0.0:
      return 0.0
    n_eff = tot * tot / max(float(d @ d), 1e-30)
    return self.floor * tot / max(math.sqrt(n_eff), 1.0)

  # -- calibration -----------------------------------------------------------
  def fit(self, raws, measured) -> Dict[str, float]:
    """Fit the calibration from (raw, measured-loss) pairs: isotonic with
    >= 8 pairs, affine (slope clipped at 0) below, identity when the raw
    signal is degenerate.  The band's half-width is the ``conf`` quantile
    of |residual|, on a held-out interleaved quarter from 16 pairs on.
    Returns the fit's stats, Spearman's correlation among them."""
    raws = np.asarray(raws, np.float64)
    meas = np.clip(np.asarray(measured, np.float64), 0.0, 1.0)
    if len(raws) >= 2 and float(np.ptp(raws)) > 1e-12:
      if len(raws) >= 8:
        resid = self._holdout_resid(raws, meas) if len(raws) >= 16 \
            else None
        self._iso_x, self._iso_y = isotonic_fit(raws, meas)
        if resid is None:
          resid = np.abs(self.predict(raws) - meas)
      else:
        slope, icept = np.polyfit(raws, meas, 1)
        slope = max(float(slope), 0.0)
        lo, hi = float(raws.min()), float(raws.max())
        self._iso_x = np.array([lo, hi])
        self._iso_y = np.clip(
            np.array([icept + slope * lo, icept + slope * hi]), 0.0, 1.0)
        resid = np.abs(self.predict(raws) - meas)
    else:
      resid = np.abs(self.predict(raws) - meas) if len(raws) \
          else np.zeros(1)
    self._resid_q = float(np.quantile(resid, self.conf))
    return {"n": int(len(raws)),
            "spearman": spearman(raws, meas) if len(raws) > 1 else 0.0,
            "resid_q": self._resid_q}

  @staticmethod
  def _holdout_resid(raws, meas) -> np.ndarray:
    """Fit on an interleaved 3/4 of the raw-sorted pairs, score the held-out
    quarter (deterministic, rank-balanced)."""
    order = np.argsort(raws, kind="stable")
    held = np.zeros(len(raws), bool)
    held[order[::4]] = True
    kx, ky = isotonic_fit(raws[~held], meas[~held])
    pred = np.clip(np.interp(raws[held], kx, ky), 0.0, 1.0)
    return np.abs(pred - meas[held])

  def predict(self, raw):
    """Calibrated loss prediction (identity before :meth:`fit`)."""
    raw = np.asarray(raw, np.float64)
    if not self.calibrated or len(self._iso_x) < 2:
      out = np.clip(raw, 0.0, 1.0)
    else:
      out = np.clip(np.interp(raw, self._iso_x, self._iso_y), 0.0, 1.0)
    return float(out) if out.ndim == 0 else out

  def band(self, raw, spread: float = 0.0) -> Tuple[float, float]:
    """Confidence band around the calibrated prediction: the residual
    quantile widened by the spread proxy; uncalibrated, half the floor."""
    pred = float(self.predict(raw))
    half = (self._resid_q if self.calibrated else 0.5 * self.floor) \
        + max(float(spread), 0.0)
    return max(pred - half, 0.0), min(pred + half, 1.0)

  # -- contract support ------------------------------------------------------
  def bucket_for_epsilon(self, profile, buckets: Sequence[int],
                         epsilon: float) -> int:
    """Smallest bucket whose calibrated predicted loss is <= ε; ε <= 0
    (exactness, which no estimate certifies) and no satisfying bucket give
    the largest."""
    if epsilon <= 0.0:
      return int(buckets[-1])
    p = profile if isinstance(profile, np.ndarray) \
        else np.asarray(profile, np.float64)
    last = p.shape[-1] - 1
    idx = [min(max(int(b), 0), last) for b in buckets]
    raw = self.floor * (1.0 - p[..., idx])
    if self.calibrated and len(self._iso_x) >= 2:
      pred = np.interp(raw, self._iso_x, self._iso_y)
    else:
      pred = raw
    for i, ok in enumerate(pred <= epsilon):
      if ok:
        return int(buckets[i])
    return int(buckets[-1])
