"""Similarity clustering for synopsis creation (counterpart of
``repro.core.cluster``; paper §2.2 steps 1-2).

Step 1 is PCA by subspace power iteration; step 2 splits the points into
equal-size clusters by recursive median splits along each segment's widest
dimension ("balanced kd").  Both take a leading batch of point sets, where
the JAX package ``vmap``s over them.
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


def cluster(coords: torch.Tensor, num_clusters: int,
            method: str = "kd") -> torch.Tensor:
  """Dispatch on the clustering method; the port runs 'kd'."""
  if method == "kd":
    return balanced_kd_cluster(coords, num_clusters)
  raise NotImplementedError(f"cluster method {method!r} is not ported")
