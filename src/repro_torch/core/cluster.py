"""Similarity clustering for synopsis creation (counterpart of
``repro.core.cluster``; paper §2.2 steps 1-2).

Step 1 is PCA by subspace power iteration; step 2 splits the points into
equal-size clusters, either by recursive median splits along each
segment's widest dimension ("balanced kd", the quality path) or by sorting
on Morton (Z-order) codes of the PCA coordinates ("morton", one sort).
Both take a leading batch of point sets, where the JAX package ``vmap``s
over them.  :func:`assign_to_nearest` places new points into existing
clusters (the generic synopsis' incremental insert).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def initial_basis(v: int, out_dim: int = 3, seed: int = 0) -> torch.Tensor:
  """The default random start of :func:`pca_project`, (v, out_dim) f32.

  The JAX package draws ``jax.random.normal(PRNGKey(0), (v, out_dim))``;
  torch cannot replay that, so parity tests pass the JAX-drawn basis in
  explicitly."""
  g = torch.Generator().manual_seed(seed)
  return torch.randn((v, out_dim), generator=g, dtype=torch.float32)


def pca_project(
    data: torch.Tensor,            # (..., n, v)
    out_dim: int = 3,
    num_iters: int = 8,
    *,
    basis: Optional[torch.Tensor] = None,   # (v, out_dim) starting basis
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Project ``data`` to its top-``out_dim`` principal subspace.

  Returns (coords (..., n, out_dim), projection (..., v, out_dim)), f32.
  ``basis`` is the random start (default :func:`initial_basis`)."""
  x = data.float()
  xc = x - x.mean(dim=-2, keepdim=True)
  if basis is None:
    basis = initial_basis(x.shape[-1], out_dim)
  q = torch.linalg.qr(basis.to(device=x.device, dtype=torch.float32))[0]
  q = q.expand(*x.shape[:-2], *q.shape)
  for _ in range(num_iters):
    # One subspace iteration: q <- orth(Cov @ q) without forming Cov.
    q = torch.linalg.qr(xc.transpose(-1, -2) @ (xc @ q))[0]
  return xc @ q, q


def balanced_kd_cluster(coords: torch.Tensor,
                        num_clusters: int) -> torch.Tensor:
  """Equal-size clusters via recursive median splits; ``num_clusters``
  must be a power of two.  coords (..., n, j) -> perm (..., n) int64, the
  row indices in cluster-contiguous order (cluster c owns
  ``perm[..., c*C:(c+1)*C]``).  Sorts are stable, as ``jnp.argsort``."""
  *lead, n, j = coords.shape
  levels = int(num_clusters).bit_length() - 1
  if (1 << levels) != num_clusters:
    raise ValueError(f"num_clusters={num_clusters} must be a power of two")
  x = coords.float()
  perm = torch.arange(n, device=x.device).expand(*lead, n).contiguous()
  for level in range(levels):
    seg = 1 << level
    seg_len = n // seg
    used = seg * seg_len
    xs = torch.gather(x, -2, perm[..., :used, None].expand(*lead, used, j))
    xs = xs.reshape(*lead, seg, seg_len, j)
    var = xs.var(dim=-2, correction=0)                        # (..., seg, j)
    dim = var.argmax(dim=-1)                                  # (..., seg)
    key_vals = torch.gather(
        xs, -1, dim[..., None, None].expand(*lead, seg, seg_len, 1))[..., 0]
    order = torch.argsort(key_vals, dim=-1, stable=True)
    head = perm[..., :used].reshape(*lead, seg, seg_len)
    head = torch.gather(head, -1, order).reshape(*lead, used)
    perm = torch.cat([head, perm[..., used:]], dim=-1)
  return perm


# The reference runs without 64-bit types, so its codes are int32: at most
# 30 interleaved bits.  The port stores them in int64 with the same cap, so
# that the sort order is the same.
CODE_BITS = 30


def morton_codes(coords: torch.Tensor, bits: int = 10) -> torch.Tensor:
  """Interleave ``bits`` quantised bits of each of the j <= 5 dimensions
  into a Z-order code.  coords (..., n, j) -> codes (..., n) int64; each
  dimension is scaled to [0, 2^bits - 1] over its own set's min / max
  (dim -2) and truncated, and ``bits`` is capped at ``30 // j``, as the
  reference's int32 codes are."""
  j = coords.shape[-1]
  x = coords.float()
  lo = x.amin(dim=-2, keepdim=True)
  hi = x.amax(dim=-2, keepdim=True)
  scale = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
  q = ((x - lo) / scale * (2 ** bits - 1)).clamp(0, 2 ** bits - 1)
  if bits * j > CODE_BITS:
    bits = CODE_BITS // j
    q = q.clamp(0, 2 ** bits - 1)
  q = q.to(torch.int64)
  code = torch.zeros(q.shape[:-1], dtype=torch.int64, device=q.device)
  for b in range(bits):
    for d in range(j):
      code |= ((q[..., d] >> b) & 1) << (b * j + d)
  return code


def morton_cluster(coords: torch.Tensor, num_clusters: int) -> torch.Tensor:
  """Equal-size clusters by a stable sort on Morton codes (codes tie
  often, and ``jnp.argsort`` is stable): perm (..., n) int64 in
  cluster-contiguous order, chunked by the caller as for
  :func:`balanced_kd_cluster` (``num_clusters`` does not change the
  order)."""
  del num_clusters
  return torch.argsort(morton_codes(coords), dim=-1, stable=True)


def cluster(coords: torch.Tensor, num_clusters: int,
            method: str = "kd") -> torch.Tensor:
  """Dispatch: 'kd' (quality, power-of-two clusters) or 'morton' (one
  sort)."""
  if method == "kd":
    return balanced_kd_cluster(coords, num_clusters)
  if method == "morton":
    return morton_cluster(coords, num_clusters)
  raise ValueError(f"unknown cluster method {method!r}")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """(values, indices) of the ``k`` largest entries along the last axis,
  in descending order, ties to the lower index (``jax.lax.top_k``'s rule;
  ``torch.topk`` promises no tie order)."""
  vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
  return vals[..., :k], idx[..., :k]


def assign_to_nearest(new_coords: torch.Tensor,
                      cluster_centers: torch.Tensor) -> torch.Tensor:
  """Nearest center of each new point in PCA space: new_coords (b, j),
  cluster_centers (m, j) -> (b,) int64, ties to the lower index (squared
  distances expanded as |x|^2 - 2 x.c + |c|^2, as in the reference)."""
  d2 = ((new_coords ** 2).sum(1)[:, None]
        - 2.0 * new_coords @ cluster_centers.T
        + (cluster_centers ** 2).sum(1)[None, :])
  return d2.argmin(dim=1)
