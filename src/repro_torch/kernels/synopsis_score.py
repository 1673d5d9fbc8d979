"""Score wrapper: per-cluster correlation of the unfused synopsis op
(CUDA kernel ``csrc/synopsis_score.cu``; replaces
``repro/kernels/synopsis_score.py``).

The score of cluster m for kv head h is the max over the GQA group's query
heads of the centroid logit ``q . k_syn[m] * sm_scale``; ``top_k`` over it
picks the clusters that stage 2 refines.  The kernel reads q and k_syn as
16-byte vectors, so both must be 16-byte aligned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "synopsis_score"


def synopsis_score(
    q: torch.Tensor,         # (B, H, D)
    k_syn: torch.Tensor,     # (B, Hkv, M, D)
    *,
    sm_scale: float = 1.0,
) -> torch.Tensor:
  """Returns scores (B, Hkv, M) f32.

  CPU tensors run the plain version; CUDA tensors launch the kernel; meta
  tensors allocate its output and launch nothing."""
  if q.device.type == "cpu":
    return ref.synopsis_score_ref(q, k_syn, sm_scale=sm_scale)
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  if H != Hkv * G or M < 1 or k_syn.shape != (B, Hkv, M, D):
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k_syn{tuple(k_syn.shape)}")
  if _build.is_latent(D):
    return _latent(q, k_syn, sm_scale)
  code = _build.dtype_code(NAME, q, k_syn)
  _build.check_rows(NAME, D, G, q, k_syn)
  scores = torch.empty((B, Hkv, M), dtype=torch.float32, device=q.device)
  if _build.is_meta(q):
    return scores
  err = _build.library().synopsis_score_launch(
      _build.ptr(q), _build.ptr(k_syn), _build.ptr(scores), B, Hkv, G, M, D,
      float(sm_scale), code, _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return scores


def _latent(q, k_syn, sm_scale):
  """The latent core's scores (``csrc/latent_decode.cu``): an f32 query of
  up to 128 heads over f32 or bf16 centroids; one block a (b, hkv) and 16
  rows, looping over the head tiles."""
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  code = _build.latent_codes(NAME, D, G, q, k_syn)
  scores = torch.empty((B, Hkv, M), dtype=torch.float32, device=q.device)
  if _build.is_meta(q):
    return scores
  err = _build.library().synopsis_score_latent_launch(
      _build.ptr(q), _build.ptr(k_syn), _build.ptr(scores), B, Hkv, G, M, D,
      float(sm_scale), code, _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(NAME, _build.LATENT)] += 1
  return scores
