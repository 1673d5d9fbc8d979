"""Component topology: partitioning the corpus over parallel components
(the port's own copy of the numpy part of ``repro.dist.topology``).

The paper's service tier fans one request out to ``n`` parallel components,
each owning a *subset of the input data* (paper §1).  For the serving tier
(``repro_torch.serve.cluster``) a component owns a contiguous range of the
M synopsis clusters of every resident request's corpus:

  * :meth:`ComponentTopology.plan` sizes the ranges: uniform, or skewed by
    a Zipf law so "hot" components own more of the corpus;
  * per-component ranges are padded to a common ``m_max`` so the component
    axis is a regular array dim; padded clusters carry ``counts == 0`` and
    are masked out of stage 1 (``ops.synopsis_stage1(valid=...)``);
  * a replication factor ``replicas`` places each shard on R components:
    ``replica_owner(c, r)`` names the r-th holder of shard ``c`` (ring
    placement: component ``(c + r) % N``), so the frontend can hedge a
    gather predicted to straggle by reissuing the shard's refinement to
    its replica and taking the earlier completion.

:func:`plan_2d` validates the fleet tier's (R, N) grid, where replica row
``r`` holds, in column ``j``, a copy of shard ``shard_at(r, j) = (j - r) %
N``, and :func:`select_replica` picks, per shard, the live holder predicted
to finish first.  :func:`make_component_mesh` and :func:`make_fleet_mesh`
lay the sharded path's components (and replica rows) over the ranks of
the ``torch.distributed`` world, one rank a component.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def zipf_weights(n: int, s: float) -> np.ndarray:
  """Normalised Zipf(s) weights over ``n`` ranks (s=0 -> uniform)."""
  ranks = np.arange(1, n + 1, dtype=np.float64)
  w = ranks ** (-float(s))
  return w / w.sum()


@dataclasses.dataclass(frozen=True)
class ComponentTopology:
  """Static partition of ``m_total`` corpus clusters over components.

  ``counts[c]`` clusters live on component ``c`` as the contiguous range
  ``[offsets[c], offsets[c] + counts[c])`` of the cluster-contiguous
  corpus; every component's slice is padded to ``m_max`` slots.
  ``replicas`` R >= 2 additionally places a copy of each shard on the
  next R-1 components of the ring (see :meth:`replica_owner`)."""
  n_components: int
  m_total: int
  counts: Tuple[int, ...]
  skew: float = 0.0
  replicas: int = 1

  def __post_init__(self):
    assert len(self.counts) == self.n_components
    assert sum(self.counts) == self.m_total, (self.counts, self.m_total)
    assert all(c >= 1 for c in self.counts), self.counts
    if not 1 <= self.replicas <= self.n_components:
      raise ValueError(f"replicas {self.replicas} outside "
                       f"[1, n_components={self.n_components}]")

  @property
  def m_max(self) -> int:
    return max(self.counts)

  @property
  def offsets(self) -> Tuple[int, ...]:
    return tuple(int(x) for x in
                 np.concatenate([[0], np.cumsum(self.counts)[:-1]]))

  @property
  def shares(self) -> np.ndarray:
    """Fraction of the corpus each component owns (accuracy weights)."""
    return np.asarray(self.counts, np.float64) / float(self.m_total)

  def cluster_owner(self) -> np.ndarray:
    """(m_total,) component id owning each global cluster index."""
    return np.repeat(np.arange(self.n_components), self.counts)

  def replica_owner(self, c: int, r: int = 1) -> int:
    """Component holding the r-th copy of shard ``c`` (r=0: the primary).
    Ring placement: copies go to the next components, so any R
    consecutive failures still leave R-1 shards each with a live holder
    and hedged reissue never targets the straggler itself."""
    if not 0 <= r < self.replicas:
      raise ValueError(f"replica index {r} outside [0, {self.replicas})")
    return (int(c) + r) % self.n_components

  def replica_owners(self) -> np.ndarray:
    """(n_components, replicas) holders of each shard; column 0 is the
    primary."""
    base = np.arange(self.n_components)[:, None]
    return (base + np.arange(self.replicas)[None, :]) % self.n_components

  def shard_at(self, r: int, j: int) -> int:
    """Shard held at 2-D mesh coordinate (replica row ``r``, component
    column ``j``) — the inverse of :meth:`replica_owner`: row r is row 0
    rolled right by r, so ``shard_at(r, replica_owner(c, r)) == c``."""
    if not 0 <= r < self.replicas:
      raise ValueError(f"replica row {r} outside [0, {self.replicas})")
    return (int(j) - int(r)) % self.n_components

  def shard_grid(self) -> np.ndarray:
    """(replicas, n_components) shard id at each 2-D mesh coordinate."""
    r = np.arange(self.replicas)[:, None]
    j = np.arange(self.n_components)[None, :]
    return (j - r) % self.n_components

  @staticmethod
  def plan(m_total: int, n_components: int, skew: float = 0.0,
           replicas: int = 1) -> "ComponentTopology":
    """Largest-remainder partition of ``m_total`` clusters by Zipf(skew)
    weights; every component owns at least one cluster."""
    n = int(n_components)
    if n < 1 or n > m_total:
      raise ValueError(f"n_components {n} outside [1, m_total={m_total}]")
    r = int(replicas)
    if not 1 <= r <= n:
      # Validated HERE, before any layout is built, with the CLI spelled
      # out: ring placement puts the R copies of a shard on R *distinct*
      # consecutive components, so R > N would silently wrap copies back
      # onto their own primary (--replicas composed with --cluster).
      raise ValueError(
          f"replicas {r} outside [1, n_components={n}]: each shard's R "
          f"ring copies need R distinct components — pass --replicas <= "
          f"--cluster")
    w = zipf_weights(n, skew)
    ideal = w * m_total
    counts = np.maximum(np.floor(ideal).astype(int), 1)
    # Largest-remainder (then lowest rank) for the leftover clusters;
    # steal from the biggest owners if the min-1 floor oversubscribed.
    while counts.sum() < m_total:
      rem = ideal - counts
      counts[int(np.argmax(rem))] += 1
    while counts.sum() > m_total:
      over = np.where(counts > 1, counts - ideal, -np.inf)
      counts[int(np.argmax(over))] -= 1
    return ComponentTopology(n, int(m_total), tuple(int(c) for c in counts),
                             skew=float(skew), replicas=int(replicas))


def plan_2d(m_total: int, n_components: int, replicas: int,
            skew: float = 0.0) -> ComponentTopology:
  """Plan the fleet tier's (R, N) grid: same largest-remainder Zipf
  partition as :meth:`ComponentTopology.plan`, but ``replicas`` is a
  required grid dimension (R >= 1) rather than an accounting factor —
  the caller owns R*N devices and every replica row holds materialized
  shards (see ``repro.serve.fleet``)."""
  r = int(replicas)
  if r < 1:
    raise ValueError(f"fleet replicas must be >= 1, got {r}")
  return ComponentTopology.plan(m_total, n_components, skew=skew, replicas=r)


def select_replica(t_pred, alive=None) -> np.ndarray:
  """Per-shard replica selection (Tail-Tolerant Distributed Search,
  arxiv 1707.07426): pick, for each shard, the live holder predicted to
  finish first.

  ``t_pred`` is the (R, N) predicted completion time of shard ``c``
  served from its r-th holder (column = shard id, NOT mesh column).
  ``alive``, if given, is an (R, N) boolean mask of holders considered
  usable; dead holders are never selected.  Ties break toward the
  lowest r — the primary — so a uniform prediction degenerates to the
  plain 1-D gather.  Returns (N,) int32 replica indices."""
  t = np.asarray(t_pred, np.float64)
  if t.ndim != 2:
    raise ValueError(f"t_pred must be (replicas, n_components), got {t.shape}")
  if alive is not None:
    mask = np.asarray(alive, bool)
    if mask.shape != t.shape:
      raise ValueError(f"alive {mask.shape} != t_pred {t.shape}")
    if not mask.any(axis=0).all():
      dead = np.where(~mask.any(axis=0))[0]
      raise ValueError(f"shards {dead.tolist()} have no live holder")
    t = np.where(mask, t, np.inf)
  # np.argmin takes the first minimum, i.e. the lowest replica index.
  return np.argmin(t, axis=0).astype(np.int32)


def make_component_mesh(n_components: int):
  """1-axis ``("component",)`` mesh over the first ``n`` ranks of the
  world, or ``None`` when the world has fewer ranks or none was started
  (the tier then runs its stacked path).  Building it is collective over
  the world."""
  from repro_torch.dist import world  # noqa: PLC0415
  from repro_torch.dist.sharding import Mesh  # noqa: PLC0415
  if not world.started() or world.world_size() < n_components:
    return None
  return Mesh((n_components,), ("component",))


def make_fleet_mesh(n_components: int, replicas: int):
  """2-axis ``("replica", "component")`` mesh over the first R*N ranks of
  the world: replica rows are the *leading* axis, so a row is a contiguous
  block of ranks.  ``None`` when the world has fewer than R*N ranks (the
  fleet tier then runs the stacked path of the same math), as when no
  world was started."""
  from repro_torch.dist import world  # noqa: PLC0415
  from repro_torch.dist.sharding import Mesh  # noqa: PLC0415
  n, r = int(n_components), int(replicas)
  if not world.started() or world.world_size() < r * n:
    return None
  return Mesh((r, n), ("replica", "component"))
