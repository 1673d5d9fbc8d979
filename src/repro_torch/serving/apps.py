"""The paper's two example services on top of the generic synopsis
(counterpart of ``repro.serving.apps``; paper §3.2).

* :class:`CFRecommender`: user-based collaborative filtering on a
  user-item rating matrix.  Synopsis = aggregated users (masked mean
  ratings per cluster); correlation c_i = |Pearson weight| between the
  active user and the aggregated user; refinement processes the original
  users of the top-ranked clusters.  Accuracy = RMSE against the exact
  full computation.
* :class:`SearchEngine`: document retrieval over term-frequency vectors.
  Synopsis = aggregated documents; correlation = the aggregated page's
  score for the query; accuracy = overlap of the retrieved top-10 with the
  exact top-10.

Plain PyTorch on any device, as the reference is plain JAX; every ranking
breaks ties to the lower index, as ``jax.lax.top_k`` does.  Two quirks of
the reference are kept: :meth:`CFRecommender.predict` adds the selected
clusters' members on top of every centroid's term, so at full budget it
is not the exact prediction; and :meth:`SearchEngine.search` at budget 0
gives every page its cluster's score, so the pages of the best cluster
tie and the lowest ids win.

Both classes build their synopsis from PCA's start ``basis`` (default
``core.cluster.initial_basis``), which parity tests set to the
reference's JAX-drawn one.  :func:`movielens_like` and
:func:`webpages_like` are the reference's numpy generators, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import synopsis as syn_lib
from repro_torch.core.cluster import top_k as _top_k


def _pearson_rows(rows: torch.Tensor, row_mask: torch.Tensor,
                  q: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
  """Pearson correlation of each row with q over co-rated items."""
  both = row_mask * q_mask[None, :]
  n = both.sum(1).clamp_min(1.0)
  rm = (rows * both).sum(1) / n
  qm = (q[None] * both).sum(1) / n
  dr = (rows - rm[:, None]) * both
  dq = (q[None] - qm[:, None]) * both
  cov = (dr * dq).sum(1)
  var = torch.sqrt((dr * dr).sum(1) * (dq * dq).sum(1))
  return torch.where(var > 1e-9, cov / var.clamp_min(1e-9),
                     torch.zeros_like(cov))


def _user_mean(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  return (rows * mask).sum(1) / mask.sum(1).clamp_min(1.0)


def _q_mean(q: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
  return (q * q_mask).sum() / q_mask.sum().clamp_min(1.0)


@dataclasses.dataclass
class CFRecommender:
  ratings: torch.Tensor       # (n_users, n_items), 0 where unrated
  mask: torch.Tensor          # (n_users, n_items) in {0, 1}
  num_clusters: int = 64
  basis: Optional[torch.Tensor] = None    # PCA start (n_items, 3)

  def __post_init__(self):
    self.syn = syn_lib.build(self.ratings, self.num_clusters,
                             mask=self.mask, basis=self.basis)

  def _centroid_mask(self) -> torch.Tensor:
    return (self.syn.centroid_weight > 0).to(self.ratings.dtype)

  def correlations(self, q, q_mask) -> torch.Tensor:
    """c_i per aggregated user (paper: |Pearson weight|)."""
    return _pearson_rows(self.syn.centroids, self._centroid_mask(), q,
                         q_mask).abs()

  def predict(self, q: torch.Tensor, q_mask: torch.Tensor,
              items: torch.Tensor, budget: int) -> torch.Tensor:
    """Predict q's ratings on ``items`` from the synopsis plus the original
    users of the top-``budget`` clusters (Algorithm 1)."""
    c = self.correlations(q, q_mask)
    cm = self._centroid_mask()
    cents = self.syn.centroids
    w_syn = _pearson_rows(cents, cm, q, q_mask)
    num = w_syn @ ((cents - _user_mean(cents, cm)[:, None]) * cm)
    den = w_syn.abs() @ cm
    if budget > 0:
      sel = _top_k(c, budget)[1]
      rows_idx = self.syn.member_idx[sel].reshape(-1)
      safe = rows_idx.clamp_min(0).long()
      rows = self.ratings[safe]
      rmask = self.mask[safe] * (rows_idx >= 0).to(self.ratings.dtype)[:,
                                                                       None]
      w = _pearson_rows(rows, rmask, q, q_mask)
      dev = (rows - _user_mean(rows, rmask)[:, None]) * rmask
      num = num + w @ dev
      den = den + w.abs() @ rmask
    pred = _q_mean(q, q_mask) + num / den.clamp_min(1e-6)
    return pred[items]

  def predict_exact(self, q, q_mask, items) -> torch.Tensor:
    """The exact prediction over every user ("Basic")."""
    w = _pearson_rows(self.ratings, self.mask, q, q_mask)
    dev = (self.ratings - _user_mean(self.ratings, self.mask)[:, None]) \
        * self.mask
    num = w @ dev
    den = w.abs() @ self.mask
    return (_q_mean(q, q_mask) + num / den.clamp_min(1e-6))[items]


@dataclasses.dataclass
class SearchEngine:
  docs: torch.Tensor          # (n_docs, vocab) tf vectors, l2-normalised
  num_clusters: int = 64      # in __post_init__
  top_k: int = 10
  basis: Optional[torch.Tensor] = None    # PCA start (vocab, 3)

  def __post_init__(self):
    # The field is replaced by its normalised copy, as in the reference;
    # the caller's tensor is not written.
    norm = torch.linalg.norm(self.docs, dim=1, keepdim=True)
    self.docs = self.docs / norm.clamp_min(1e-9)
    self.syn = syn_lib.build(self.docs, self.num_clusters, basis=self.basis)

  def search(self, query_vec: torch.Tensor, budget: int) -> torch.Tensor:
    """Approximate top-k doc ids via Algorithm 1."""
    scores_syn = self.syn.centroids @ query_vec                # c_i (m,)
    if budget > 0:
      sel = _top_k(scores_syn, budget)[1]
      idx = self.syn.member_idx[sel].reshape(-1)
      safe = idx.clamp_min(0).long()
      sc = self.docs[safe] @ query_vec
      sc = torch.where(idx >= 0, sc, torch.full_like(sc, -torch.inf))
      doc_scores = torch.full((self.docs.shape[0],), -torch.inf,
                              dtype=sc.dtype, device=sc.device)
      doc_scores.scatter_reduce_(0, safe, sc, reduce="amax")
    else:
      # stage 1 only: every doc inherits its aggregated page's score
      doc_scores = scores_syn[self.syn.row_cluster.long()]
    return _top_k(doc_scores, self.top_k)[1]

  def search_exact(self, query_vec: torch.Tensor) -> torch.Tensor:
    return _top_k(self.docs @ query_vec, self.top_k)[1]

  def accuracy(self, query_vec: torch.Tensor, budget: int) -> float:
    """Fraction of the true top-10 present in the retrieved top-10."""
    approx = set(self.search(query_vec, budget).tolist())
    exact = set(self.search_exact(query_vec).tolist())
    return len(approx & exact) / max(len(exact), 1)


# -- synthetic datasets shaped like the paper's (MovieLens / Sogou pages) ----

def movielens_like(n_users=4000, n_items=1000, density=0.0675, seed=0,
                   n_taste=8):
  """Low-rank user-taste structure + noise, ~0.27M ratings at the
  defaults (one component's subset).  Returns (ratings, mask) f32 on the
  CPU."""
  rng = np.random.default_rng(seed)
  u = rng.normal(0, 1, (n_users, n_taste))
  v = rng.normal(0, 1, (n_items, n_taste))
  full = u @ v.T
  full = 3.0 + 1.2 * (full / full.std())
  full = np.clip(np.round(full * 2) / 2, 0.5, 5.0)
  mask = (rng.random((n_users, n_items)) < density).astype(np.float32)
  return (torch.from_numpy((full * mask).astype(np.float32)),
          torch.from_numpy(mask))


def webpages_like(n_docs=20000, vocab=2000, n_topics=32, seed=0):
  """Topic-mixture term frequencies (n_docs, vocab) f32 on the CPU."""
  rng = np.random.default_rng(seed)
  topics = rng.dirichlet(np.full(vocab, 0.05), n_topics)
  doc_topic = rng.dirichlet(np.full(n_topics, 0.2), n_docs)
  tf = doc_topic @ topics
  tf += rng.gamma(0.3, 0.02, tf.shape)
  return torch.from_numpy(tf.astype(np.float32))
