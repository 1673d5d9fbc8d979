"""Synopsis construction and update over decode KV caches (counterpart of
``repro.serve.synopsis_kv``) — the paper's offline module.

* :func:`build`: cluster each (block, layer, sequence)'s S cached tokens
  into M = S/C equal-size clusters (PCA -> balanced kd over the
  concatenated kv-head key features), then permute the cache
  cluster-contiguous and aggregate the mean centroids in one pass of the
  ``segment_build`` kernel.
* :func:`append_recent`: write one decode step's new KV into the recent
  ring.  Unlike the JAX version it writes in place (the cache dict is the
  loop's own state, so no copy of the ring is needed).
* :func:`absorb_recent`: the paper's "situation 1" update — the full ring
  becomes R/C new clusters appended to the originals and centroid tables,
  through the same kernel with the identity permutation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import cluster as cl
from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig


def cluster_perms(k: torch.Tensor, num_clusters: int, *,
                  basis: Optional[torch.Tensor] = None) -> torch.Tensor:
  """k (N, Hkv, S, D) -> one permutation (N, S) per sequence, clustering
  tokens on their keys with all kv heads concatenated as features."""
  N, Hkv, S, D = k.shape
  feats = k.permute(0, 2, 1, 3).reshape(N, S, Hkv * D)
  coords, _ = cl.pca_project(feats, out_dim=3, num_iters=4, basis=basis)
  return cl.cluster(coords, num_clusters)


def build(cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
          basis: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
  """Exact cache -> synopsis cache.  cache: k/v (nb, na, B, Hkv, S, D) and
  pos (B,).  ``basis`` is PCA's starting basis (see
  ``core.cluster.initial_basis``)."""
  k, v = cache["k"], cache["v"]
  nb, na, B, Hkv, S, D = k.shape
  C = cfg.synopsis.cluster_size
  if S % C:
    raise ValueError(f"prompt length {S} is not a multiple of C={C}")
  M = S // C
  N = nb * na * B
  k = k.reshape(N, Hkv, S, D)
  v = v.reshape(N, Hkv, S, D)
  perms = cluster_perms(k, M, basis=basis)
  k_sorted, v_sorted, k_syn, v_syn, counts = ops.synopsis_build(
      k, v, perms, cluster_size=C)
  R = cfg.synopsis.recent
  return {
      "k": k_sorted.reshape(nb, na, B, Hkv, S, D),
      "v": v_sorted.reshape(nb, na, B, Hkv, S, D),
      "k_syn": k_syn.reshape(nb, na, B, Hkv, M, D),
      "v_syn": v_syn.reshape(nb, na, B, Hkv, M, D),
      "counts": counts.reshape(nb, na, B, M),
      "recent_k": k.new_zeros((nb, na, B, Hkv, R, D)),
      "recent_v": v.new_zeros((nb, na, B, Hkv, R, D)),
      "recent_len": torch.zeros((B,), dtype=torch.int32, device=k.device),
      "pos": cache["pos"],
  }


def append_recent(cache: Dict[str, torch.Tensor], k_delta, v_delta):
  """Write one step's new kv (nb, na, B, Hkv, 1, D) into the ring at
  ``recent_len`` (the same slot for every sequence: a batch advances in
  lockstep), in place.  Returns the cache."""
  rl = int(cache["recent_len"][0])
  if rl >= cache["recent_k"].shape[4]:
    raise ValueError(f"recent ring is full ({rl}); absorb it first")
  cache["recent_k"][:, :, :, :, rl:rl + 1] = k_delta
  cache["recent_v"][:, :, :, :, rl:rl + 1] = v_delta
  cache["recent_len"] += 1
  return cache


def absorb_recent(cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, torch.Tensor]:
  """Ring tokens -> R/C new clusters appended to the originals and the
  centroid tables (the ring is time-contiguous, so the permutation is the
  identity); the ring resets.  Returns a new cache dict."""
  rk, rv = cache["recent_k"], cache["recent_v"]
  nb, na, B, Hkv, R, D = rk.shape
  C = cfg.synopsis.cluster_size
  if R % C:
    raise ValueError(f"recent ring {R} is not a multiple of C={C}")
  newM = R // C
  N = nb * na * B
  ident = torch.arange(R, dtype=torch.int32, device=rk.device).expand(N, R)
  _, _, k_new, v_new, cnt_new = ops.synopsis_build(
      rk.reshape(N, Hkv, R, D), rv.reshape(N, Hkv, R, D), ident,
      cluster_size=C)
  cat = torch.cat
  return {
      **cache,
      "k": cat([cache["k"], rk], dim=4),
      "v": cat([cache["v"], rv], dim=4),
      "k_syn": cat([cache["k_syn"],
                    k_new.reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "v_syn": cat([cache["v_syn"],
                    v_new.reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "counts": cat([cache["counts"],
                     cnt_new.reshape(nb, na, B, newM)], dim=3),
      "recent_k": torch.zeros_like(rk),
      "recent_v": torch.zeros_like(rv),
      "recent_len": torch.zeros_like(cache["recent_len"]),
  }
