"""Synopsis construction and update over decode KV caches (counterpart of
``repro.serve.synopsis_kv``) — the paper's offline module.

* :func:`build`: cluster each (block, layer, sequence)'s S cached tokens
  into M = S/C equal-size clusters (PCA -> balanced kd, or Morton order
  with ``method="morton"``, over the concatenated kv-head key features),
  then permute the cache
  cluster-contiguous and aggregate the mean centroids in one pass of the
  ``segment_build`` kernel.
* :func:`append_recent`: write one decode step's new KV into the recent
  ring.  Unlike the JAX version it writes in place (the cache dict is the
  loop's own state, so no copy of the ring is needed).
  :func:`append_recent_slots` is the engine's per-slot form, also in
  place.
* :func:`absorb_recent`: the paper's "situation 1" update — the full ring
  becomes R/C new clusters appended to the originals and centroid tables,
  through the same kernel with the identity permutation.
* :func:`extend_synopsis`: the corpus cache's delta build, the clusters
  of a prompt's extension appended to a cached arena's.

Under ``cfg.synopsis.quant`` (``kernels/quant.py``) the build and the
absorb emit the quantized tables and the scale leaves (nb, na, B, Hkv, M)
f32; under ``+kv`` the sorted cache, and the ring rows appended to it, are
quantized codes too.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import cluster as cl
from repro_torch.kernels import ops
from repro_torch.kernels import quant as qt
from repro_torch.models.common import ModelConfig


def _build_arena(k, v, perm, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
  """``ops.synopsis_build`` under the config's quant spec, as a dict with
  the arena's leaf names (flat (N, ...) shapes)."""
  built = ops.synopsis_build(k, v, perm,
                             cluster_size=cfg.synopsis.cluster_size,
                             qconfig=cfg.synopsis.quant)
  if isinstance(built, dict):
    return built
  return dict(zip(("k", "v", "k_syn", "v_syn", "counts"), built))


def cluster_perms(k: torch.Tensor, num_clusters: int, *,
                  basis: Optional[torch.Tensor] = None,
                  method: str = "kd") -> torch.Tensor:
  """k (N, Hkv, S, D) -> one permutation (N, S) per sequence, clustering
  tokens on their keys with all kv heads concatenated as features
  (``core.cluster.cluster``'s ``method``: "kd" or "morton")."""
  N, Hkv, S, D = k.shape
  feats = k.permute(0, 2, 1, 3).reshape(N, S, Hkv * D)
  coords, _ = cl.pca_project(feats, out_dim=3, num_iters=4, basis=basis)
  return cl.cluster(coords, num_clusters, method=method)


def build(cache: Dict[str, torch.Tensor], cfg: ModelConfig, *,
          basis: Optional[torch.Tensor] = None,
          method: str = "kd") -> Dict[str, torch.Tensor]:
  """Exact cache -> synopsis cache.  cache: k/v (nb, na, B, Hkv, S, D) and
  pos (B,).  ``basis`` is PCA's starting basis (see
  ``core.cluster.initial_basis``), ``method`` the clustering ("kd" or
  "morton").  The cross blocks' ``cross_k`` /
  ``cross_v`` (whisper) and the mamba layers' ``conv_state`` /
  ``ssd_state`` (jamba) pass through untouched, as in the JAX build, and
  so through :func:`absorb_recent`'s ``**cache``."""
  k, v = cache["k"], cache["v"]
  nb, na, B, Hkv, S, D = k.shape
  C = cfg.synopsis.cluster_size
  if S % C:
    raise ValueError(f"prompt length {S} is not a multiple of C={C}")
  M = S // C
  N = nb * na * B
  k = k.reshape(N, Hkv, S, D)
  v = v.reshape(N, Hkv, S, D)
  perms = cluster_perms(k, M, basis=basis, method=method)
  built = _build_arena(k, v, perms, cfg)
  R = cfg.synopsis.recent
  out = {
      "k": built["k"].reshape(nb, na, B, Hkv, S, D),
      "v": built["v"].reshape(nb, na, B, Hkv, S, D),
      "k_syn": built["k_syn"].reshape(nb, na, B, Hkv, M, D),
      "v_syn": built["v_syn"].reshape(nb, na, B, Hkv, M, D),
      "counts": built["counts"].reshape(nb, na, B, M),
      "recent_k": k.new_zeros((nb, na, B, Hkv, R, D)),
      "recent_v": v.new_zeros((nb, na, B, Hkv, R, D)),
      "recent_len": torch.zeros((B,), dtype=torch.int32, device=k.device),
      "pos": cache["pos"],
  }
  for name in qt.SCALE_LEAVES:
    if name in built:
      out[name] = built[name].reshape(nb, na, B, Hkv, M)
  for name in ("cross_k", "cross_v", "conv_state", "ssd_state"):
    if name in cache:                       # carried as they are
      out[name] = cache[name]
  return out


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


def append_recent_slots(cache: Dict[str, torch.Tensor], k_delta, v_delta,
                        active: torch.Tensor):
  """Per-slot ring write of the continuous-batching engine, in place: slot
  ``b``'s new kv (nb, na, B, Hkv, 1, D) lands at its own
  ``recent_len[b]`` and only ``active`` (B,) bool slots advance.  A slot
  whose ring is full neither writes nor advances (the engine bounds
  residency so that this cannot happen; the guard keeps the op total).

  Tensor ops only, with no read on the host, so that a CUDA graph can
  capture it: every lane writes at its (clamped) ring position, an
  inactive or full lane writing back the row it read."""
  rl = cache["recent_len"]                                    # (B,)
  R = cache["recent_k"].shape[4]
  ok = (active & (rl < R)).view(1, 1, -1, 1, 1, 1)
  at = rl.clamp(max=R - 1).long().view(1, 1, -1, 1, 1, 1)
  for name, delta in (("recent_k", k_delta), ("recent_v", v_delta)):
    ring = cache[name]
    idx = at.expand(*delta.shape)
    ring.scatter_(4, idx, torch.where(ok, delta.to(ring.dtype),
                                      ring.gather(4, idx)))
  rl += ok.view(-1).to(rl.dtype)
  return cache


def absorb_recent(cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, torch.Tensor]:
  """Ring tokens -> R/C new clusters appended to the originals and the
  centroid tables (the ring is time-contiguous, so the permutation is the
  identity); the ring resets.  The rows appended to the cache are the
  build's sorted output: the ring itself, or its codes under ``+kv``, whose
  scales extend the scale leaves with the centroids'.  Returns a new cache
  dict.  A rank's shard of a cache cut over a mesh (its ``layout``,
  ``serve_step.shard_cache``) is refused: the absorbed clusters would land
  on one shard and move the others' ranges (ROADMAP A.7d)."""
  if "layout" in cache:
    raise NotImplementedError(
        "absorb on a cache sharded over a mesh is not implemented (ROADMAP "
        "A.7d): the ring's new clusters would land on one shard and move "
        "every other shard's cluster range")
  rk, rv = cache["recent_k"], cache["recent_v"]
  nb, na, B, Hkv, R, D = rk.shape
  C = cfg.synopsis.cluster_size
  if R % C:
    raise ValueError(f"recent ring {R} is not a multiple of C={C}")
  newM = R // C
  N = nb * na * B
  ident = torch.arange(R, dtype=torch.int32, device=rk.device).expand(N, R)
  built = _build_arena(rk.reshape(N, Hkv, R, D), rv.reshape(N, Hkv, R, D),
                       ident, cfg)
  cat = torch.cat
  out = {
      **cache,
      "k": cat([cache["k"], built["k"].reshape(nb, na, B, Hkv, R, D)], dim=4),
      "v": cat([cache["v"], built["v"].reshape(nb, na, B, Hkv, R, D)], dim=4),
      "k_syn": cat([cache["k_syn"],
                    built["k_syn"].reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "v_syn": cat([cache["v_syn"],
                    built["v_syn"].reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "counts": cat([cache["counts"],
                     built["counts"].reshape(nb, na, B, newM)], dim=3),
      "recent_k": torch.zeros_like(rk),
      "recent_v": torch.zeros_like(rv),
      "recent_len": torch.zeros_like(cache["recent_len"]),
  }
  for name in qt.SCALE_LEAVES:
    if name in cache:
      out[name] = cat([cache[name],
                       built[name].reshape(nb, na, B, Hkv, newM)], dim=4)
  return out


def extend_synopsis(arena: Dict[str, torch.Tensor], ext_k: torch.Tensor,
                    ext_v: torch.Tensor, cfg: ModelConfig, *,
                    basis: Optional[torch.Tensor] = None,
                    method: str = "kd") -> Dict[str, torch.Tensor]:
  """Prefix-extension delta build: append E prefill tokens' KV to a built
  arena without rebuilding the prefix.  The extension gets its own
  similarity clustering (PCA from ``basis``, then ``method``: balanced
  kd, E/C clusters, a power of two, or Morton order, over the extension
  alone), built by ``segment_build``
  and appended after the prefix's M clusters; the prefix's sorted KV,
  centroids and counts are untouched.

  ext_k/ext_v: (nb, na, B, Hkv, E, D) from ``prefill.make_extend_step``.
  Returns a new arena (``pos`` advanced by E, the ring passed through)."""
  nb, na, B, Hkv, E, D = ext_k.shape
  C = cfg.synopsis.cluster_size
  if E % C:
    raise ValueError(f"extension length {E} is not a multiple of C={C}")
  newM = E // C
  N = nb * na * B
  k = ext_k.reshape(N, Hkv, E, D)
  v = ext_v.reshape(N, Hkv, E, D)
  built = _build_arena(k, v, cluster_perms(k, newM, basis=basis,
                                           method=method), cfg)
  cat = torch.cat
  out = {
      **arena,
      "k": cat([arena["k"], built["k"].reshape(nb, na, B, Hkv, E, D).to(
          arena["k"].dtype)], dim=4),
      "v": cat([arena["v"], built["v"].reshape(nb, na, B, Hkv, E, D).to(
          arena["v"].dtype)], dim=4),
      "k_syn": cat([arena["k_syn"],
                    built["k_syn"].reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "v_syn": cat([arena["v_syn"],
                    built["v_syn"].reshape(nb, na, B, Hkv, newM, D)], dim=4),
      "counts": cat([arena["counts"],
                     built["counts"].reshape(nb, na, B, newM)], dim=3),
      "pos": arena["pos"] + E,
  }
  for name in qt.SCALE_LEAVES:
    if name in arena:
      out[name] = cat([arena[name],
                       built[name].reshape(nb, na, B, Hkv, newM)], dim=4)
  return out
