"""Stage-1 wrapper: fused centroid scoring + count-biased synopsis
attention (CUDA kernel ``csrc/fused_synopsis.cu``; replaces
``repro/kernels/fused_synopsis.py``).

One pass over the centroid tables gives both the group-max correlation
scores that rank clusters for refinement (uncapped: the softcap is
monotone) and the online-softmax partials over ALL centroids with the
``log(count)`` bias; stage 2 subtracts the selected centroids' terms.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "fused_synopsis_score_attention"


def fused_synopsis_score_attention(
    q: torch.Tensor,         # (B, H, D)
    k_syn: torch.Tensor,     # (B, Hkv, M, D)
    v_syn: torch.Tensor,     # (B, Hkv, M, D)
    cbias: torch.Tensor,     # (B, M) f32 log(count) bias
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
):
  """Returns (scores (B,Hkv,M) f32, (o (B,H,D) f32, m (B,H), l (B,H))).

  CPU tensors run the plain version; CUDA tensors launch the kernel."""
  if q.device.type == "cpu":
    return ref.fused_synopsis_score_attention_ref(
        q, k_syn, v_syn, cbias, sm_scale=sm_scale, cap=cap)
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  if (H != Hkv * G or k_syn.shape != (B, Hkv, M, D)
      or v_syn.shape != k_syn.shape or cbias.shape != (B, M)):
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k_syn{tuple(k_syn.shape)} v_syn{tuple(v_syn.shape)} "
                     f"cbias{tuple(cbias.shape)}")
  code = _build.dtype_code(NAME, q, k_syn, v_syn)
  cbias = cbias.to(device=q.device, dtype=torch.float32).contiguous()
  f32 = dict(dtype=torch.float32, device=q.device)
  scores = torch.empty((B, Hkv, M), **f32)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  P = _build.ptr
  err = _build.library().fused_synopsis_launch(
      P(q), P(k_syn), P(v_syn), P(cbias), P(scores), P(o), P(m), P(l),
      B, Hkv, G, M, D, float(sm_scale), float(cap or 0.0), code,
      _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return scores, (o, m, l)
