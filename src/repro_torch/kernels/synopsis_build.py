"""Synopsis-build wrapper: fused permute + segment mean, optionally
quantized (CUDA kernel ``csrc/segment_build.cu``; replaces
``repro/kernels/synopsis_build.py``).

Given the cluster-contiguous permutation from the clustering stage, the
kernel writes the cache in cluster order and each C-row cluster's mean
centroid in one pass.  Under a quantizing spec it also quantizes the
centroids from their f32 means (one scale per row) and, with ``+kv``, the
sorted cache per C-row cluster block.  The absorb of the recent ring
reuses it with the identity permutation.  The kernel stages each cluster's
rows in shared memory as 16-byte vectors, so D is a multiple of 16.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant as qt
from repro_torch.kernels import ref

NAME = "segment_build"


def segment_build(
    k: torch.Tensor,          # (N, Hkv, S, D)
    v: torch.Tensor,          # (N, Hkv, S, D)
    perm: torch.Tensor,       # (N, S): row s of the output reads perm[n, s]
    *,
    cluster_size: int,
    quant: Optional[str] = None,   # quant spec ("int8", "fp8+kv", ...)
):
  """Returns (k_sorted, v_sorted, k_syn, v_syn, counts (N, M) f32), or,
  with a quantizing ``quant`` spec, the arena dict {k, v, k_syn, v_syn,
  counts, k_syn_scale, v_syn_scale[, k_scale, v_scale]} (scales (N, Hkv,
  M) f32).

  CPU tensors run the plain version; CUDA tensors launch the kernel; meta
  tensors allocate its outputs and launch nothing."""
  qc = qt.parse_qconfig(quant)
  if k.device.type == "cpu":
    if qc.enabled:
      return ref.synopsis_build_quant_ref(k, v, perm,
                                          cluster_size=cluster_size, qc=qc)
    return ref.synopsis_build_ref(k, v, perm, cluster_size=cluster_size)
  N, Hkv, S, D = k.shape
  C = cluster_size
  if S % C or v.shape != k.shape or perm.shape != (N, S):
    raise ValueError(f"{NAME}: bad shapes k{tuple(k.shape)} "
                     f"perm{tuple(perm.shape)} C={C}")
  code = _build.dtype_code(NAME, k, v)
  if D % 16:
    raise ValueError(f"{NAME}: head dim {D} not built (the kernel stages "
                     "and stores rows of 16-byte vectors: D % 16 == 0)")
  _build.check_aligned(NAME, k, v)
  M = S // C
  perm = perm.to(device=k.device, dtype=torch.int32).contiguous()
  qdt = qt.qdtype(qc.kind) if qc.enabled else k.dtype
  kvdt = qdt if qc.sorted_kv else k.dtype
  k_sorted = torch.empty(k.shape, dtype=kvdt, device=k.device)
  v_sorted = torch.empty_like(k_sorted)
  k_syn = torch.empty((N, Hkv, M, D), dtype=qdt, device=k.device)
  v_syn = torch.empty_like(k_syn)
  counts = torch.empty((N, M), dtype=torch.float32, device=k.device)
  n_scales = (2 if qc.enabled else 0) + (2 if qc.sorted_kv else 0)
  scales = [torch.empty((N, Hkv, M), dtype=torch.float32, device=k.device)
            for _ in range(n_scales)] + [None] * (4 - n_scales)
  if not _build.is_meta(k):
    P = _build.ptr
    err = _build.library().segment_build_launch(
        P(k), P(v), P(perm), P(k_sorted), P(v_sorted), P(k_syn), P(v_syn),
        P(counts), *map(P, scales), N, Hkv, S, D, C, code,
        _build.code_of(qdt) if qc.enabled else 0,
        int(qc.sorted_kv), _build.stream_ptr(k))
    _build.check(err, NAME)
    _build.LAUNCHES[_build.branch(NAME, qc.spec)] += 1
  if not qc.enabled:
    return k_sorted, v_sorted, k_syn, v_syn, counts
  out = {"k": k_sorted, "v": v_sorted, "k_syn": k_syn, "v_syn": v_syn,
         "counts": counts}
  out.update(zip(qt.SCALE_LEAVES, scales[:n_scales]))
  return out
