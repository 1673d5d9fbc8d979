"""Synopsis-build wrapper: fused permute + segment mean (CUDA kernel
``csrc/segment_build.cu``; replaces ``repro/kernels/synopsis_build.py``).

Given the cluster-contiguous permutation from the clustering stage, the
kernel writes the cache in cluster order and each C-row cluster's mean
centroid in one pass.  The absorb of the recent ring reuses it with the
identity permutation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "segment_build"


def segment_build(
    k: torch.Tensor,          # (N, Hkv, S, D)
    v: torch.Tensor,          # (N, Hkv, S, D)
    perm: torch.Tensor,       # (N, S): row s of the output reads perm[n, s]
    *,
    cluster_size: int,
):
  """Returns (k_sorted, v_sorted, k_syn, v_syn, counts (N, M) f32).

  CPU tensors run the plain version; CUDA tensors launch the kernel."""
  if k.device.type == "cpu":
    return ref.synopsis_build_ref(k, v, perm, cluster_size=cluster_size)
  N, Hkv, S, D = k.shape
  C = cluster_size
  if S % C or v.shape != k.shape or perm.shape != (N, S):
    raise ValueError(f"{NAME}: bad shapes k{tuple(k.shape)} "
                     f"perm{tuple(perm.shape)} C={C}")
  code = _build.dtype_code(NAME, k, v)
  M = S // C
  perm = perm.to(device=k.device, dtype=torch.int32).contiguous()
  k_sorted = torch.empty_like(k)
  v_sorted = torch.empty_like(v)
  k_syn = torch.empty((N, Hkv, M, D), dtype=k.dtype, device=k.device)
  v_syn = torch.empty_like(k_syn)
  counts = torch.empty((N, M), dtype=torch.float32, device=k.device)
  P = _build.ptr
  err = _build.library().segment_build_launch(
      P(k), P(v), P(perm), P(k_sorted), P(v_sorted), P(k_syn), P(v_syn),
      P(counts), N, Hkv, S, D, C, code, _build.stream_ptr(k))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return k_sorted, v_sorted, k_syn, v_syn, counts
