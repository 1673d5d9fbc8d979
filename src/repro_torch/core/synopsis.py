"""Offline synopsis management over generic data (counterpart of
``repro.core.synopsis``; paper §2.2): creation and incremental update.

A synopsis holds one aggregated data point per cluster of similar original
points (the masked mean: the paper's CF example, "the aggregated user's
rating on item i is users' average rating on i in set U_i").  The index is
a static-shape ``member_idx`` table (m clusters x cap members, -1 padded)
plus the inverse ``row_cluster`` map.

Incremental updating covers the paper's two change situations:
  * :func:`update_changed`: existing points changed, so only the affected
    clusters are aggregated again;
  * :func:`insert`: new points arrive and go to the nearest cluster in PCA
    space, into its slack capacity, with a running-mean centroid update.
:func:`needs_rebuild` signals that the slack is used up.

PCA starts from ``basis`` (``core.cluster.initial_basis`` by default):
torch cannot replay the reference's ``jax.random.normal(PRNGKey(0))``
start, so parity tests pass that basis in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import cluster as _cluster


@dataclasses.dataclass
class Synopsis:
  """Aggregated data points + index for one component's data subset."""
  centroids: torch.Tensor        # (m, v)   masked mean of members
  centroid_weight: torch.Tensor  # (m, v)   observed entries per attribute
  member_idx: torch.Tensor       # (m, cap) int32 row ids, -1 padded
  counts: torch.Tensor           # (m,)     int32 valid members per cluster
  row_cluster: torch.Tensor      # (n_cap,) int32 cluster of each row, -1 free
  pca_centers: torch.Tensor      # (m, j)   cluster centers in PCA space
  proj: torch.Tensor             # (v, j)   PCA projection for new points
  mean: torch.Tensor             # (1, v)   data mean used by the projection

  @property
  def num_clusters(self) -> int:
    return self.centroids.shape[0]

  @property
  def capacity(self) -> int:
    return self.member_idx.shape[1]

  def to(self, device) -> "Synopsis":
    """The same synopsis with every tensor on ``device``."""
    return Synopsis(**{f.name: getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)})


def _members(data: torch.Tensor, mask: torch.Tensor,
             member_idx: torch.Tensor):
  """Rows and masks of the members of ``member_idx`` (..., cap): pads read
  row 0 with a zero mask."""
  safe = member_idx.clamp_min(0).long()
  ok = (member_idx >= 0).to(mask.dtype)[..., None]
  return data[safe], mask[safe] * ok


def _masked_mean(rows: torch.Tensor, mask: torch.Tensor):
  """Mean over dim -2 counting only mask == 1 entries, 0 where none; and
  the counts."""
  w = mask.sum(-2)
  s = (rows * mask).sum(-2)
  return torch.where(w > 0, s / w.clamp_min(1), torch.zeros_like(s)), w


def build(data: torch.Tensor, num_clusters: int, *,
          mask: Optional[torch.Tensor] = None, method: str = "kd",
          pca_dim: int = 3, pca_iters: int = 8, slack: float = 0.5,
          basis: Optional[torch.Tensor] = None) -> Synopsis:
  """Create a synopsis for ``data`` (n, v), steps 1-3 of paper §2.2.
  Cluster c owns ``perm[c*base:(c+1)*base]`` with base = n // m; the n % m
  leftover rows go one each to the last clusters, so counts differ by at
  most 1.  Each cluster has room for ``base + max(1, slack * base)``
  members."""
  n, v = data.shape
  if mask is None:
    mask = torch.ones_like(data)
  masked = data * mask
  coords, proj = _cluster.pca_project(masked, pca_dim, pca_iters,
                                      basis=basis)
  mean = masked.mean(0, keepdim=True)
  perm = _cluster.cluster(coords, num_clusters, method=method)

  m = num_clusters
  base = n // m
  cap = int(base + max(1, int(slack * base)))
  dev = data.device
  counts = torch.full((m,), base, dtype=torch.int32, device=dev)
  extra = n - base * m
  if extra:
    counts[m - extra:] += 1

  starts = torch.cumsum(counts, 0) - counts
  offs = torch.arange(cap, device=dev)[None, :]
  take = starts[:, None] + offs                             # (m, cap)
  valid = offs < counts[:, None]
  member_idx = torch.where(valid, perm[take.clamp(0, n - 1)],
                           -1).to(torch.int32)

  centroids, weight = _masked_mean(*_members(data, mask, member_idx))
  return Synopsis(
      centroids=centroids, centroid_weight=weight, member_idx=member_idx,
      counts=counts, row_cluster=_row_cluster_from_members(member_idx, n),
      pca_centers=_segment_mean_coords(coords, member_idx), proj=proj,
      mean=mean)


def _row_cluster_from_members(member_idx: torch.Tensor, n: int):
  m, cap = member_idx.shape
  flat = member_idx.reshape(-1).long()
  cids = torch.arange(m, dtype=torch.int32,
                      device=flat.device).repeat_interleave(cap)
  safe = torch.where(flat >= 0, flat, n)          # park -1 pads off-array
  out = torch.full((n + 1,), -1, dtype=torch.int32, device=flat.device)
  out[safe] = cids
  return out[:n]


def _segment_mean_coords(coords: torch.Tensor, member_idx: torch.Tensor):
  ok = (member_idx >= 0).to(coords.dtype)[..., None]        # (m, cap, 1)
  rows = coords[member_idx.clamp_min(0).long()] * ok
  return rows.sum(1) / ok.sum(1).clamp_min(1.0)


# -- incremental updating (paper: two situations) -----------------------------

def update_changed(syn: Synopsis, data: torch.Tensor, mask: torch.Tensor,
                   changed_rows: torch.Tensor) -> Synopsis:
  """Situation 2: attributes of existing rows changed (``data`` already
  holds the new values).  Aggregates again only the clusters that hold
  ``changed_rows``: O(k * cap * v), independent of n."""
  affected = syn.row_cluster[changed_rows.long()].long()     # (k,), repeats
  cents, w = _masked_mean(*_members(data, mask, syn.member_idx[affected]))
  centroids = syn.centroids.clone()
  weight = syn.centroid_weight.clone()
  centroids[affected] = cents
  weight[affected] = w
  return dataclasses.replace(syn, centroids=centroids, centroid_weight=weight)


def insert(syn: Synopsis, data: torch.Tensor, mask: torch.Tensor,
           new_rows: torch.Tensor) -> Synopsis:
  """Situation 1: new rows appended to ``data`` (``row_cluster`` already
  has their slots); each goes to its nearest cluster in PCA space, into
  the next free column, and that cluster's aggregate moves by a running
  mean.  A row past its cluster's capacity is dropped (its row_cluster
  -1), as in the reference, whose drop-mode scatter parks such rows on
  cell (0, 0) with that cell's own value."""
  new_rows = new_rows.long()
  x = data[new_rows] * mask[new_rows]
  assign = _cluster.assign_to_nearest((x - syn.mean) @ syn.proj,
                                      syn.pca_centers)
  # Rank of each new row within its assigned cluster, for simultaneous
  # inserts into one cluster.
  order = torch.argsort(assign, stable=True)
  sorted_assign = assign[order].contiguous()
  ranks_sorted = torch.arange(assign.shape[0], device=assign.device) \
      - torch.searchsorted(sorted_assign, sorted_assign, side="left")
  ranks = torch.zeros_like(ranks_sorted)
  ranks[order] = ranks_sorted
  slots = syn.counts[assign].long() + ranks

  in_cap = slots < syn.capacity
  member_idx = syn.member_idx.clone()
  member_idx[torch.where(in_cap, assign, 0),
             torch.where(in_cap, slots, 0)] = torch.where(
                 in_cap, new_rows.to(torch.int32), syn.member_idx[0, 0])

  ones = in_cap.to(torch.int32)
  counts = syn.counts.index_add(0, assign, ones)
  row_cluster = syn.row_cluster.clone()
  row_cluster[new_rows] = torch.where(in_cap, assign.to(torch.int32), -1)

  # Running-mean centroid update: w' = w + mask; c' = (c w + x) / w'.
  keep = ones[:, None].to(mask.dtype)
  m = syn.num_clusters
  dw = torch.zeros((m, mask.shape[1]), dtype=mask.dtype,
                   device=mask.device).index_add_(0, assign,
                                                  mask[new_rows] * keep)
  dx = torch.zeros((m, x.shape[1]), dtype=x.dtype,
                   device=x.device).index_add_(0, assign, x * keep)
  new_w = syn.centroid_weight + dw
  new_c = torch.where(new_w > 0, (syn.centroids * syn.centroid_weight + dx)
                      / new_w.clamp_min(1), torch.zeros_like(dx))
  return dataclasses.replace(
      syn, centroids=new_c, centroid_weight=new_w, member_idx=member_idx,
      counts=counts, row_cluster=row_cluster)


def needs_rebuild(syn: Synopsis, headroom: int = 1) -> torch.Tensor:
  """True when any cluster is within ``headroom`` slots of capacity."""
  return torch.any(syn.counts + headroom > syn.capacity)
