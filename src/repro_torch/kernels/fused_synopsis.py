"""Stage-1 wrapper: fused centroid scoring + count-biased synopsis
attention (CUDA kernel ``csrc/fused_synopsis.cu``; replaces
``repro/kernels/fused_synopsis.py``).

One pass over the centroid tables gives both the group-max correlation
scores that rank clusters for refinement (uncapped: the softcap is
monotone) and the online-softmax partials over ALL centroids with the
``log(count)`` bias; stage 2 subtracts the selected centroids' terms.
Quantized tables (int8 / fp8 codes) come with one f32 scale per centroid
row, which the kernel folds into the logits and into p entering p.V.

The kernel runs on the split-and-merge decode core: M is cut into chunks
by flash_decode's rule (``flash_decode._chunk``: one chunk at the loop's
M = 64 / 65, so no merge and no scratch there; 8 chunks of 128 rows at M
= 1024 in bf16, which measured as fast as 16 and faster than 4 on the
H100), and the last block of each (b, hkv) row merges the chunks'
partials (scratch allocated here).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant as qt
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import _chunk

NAME = "fused_synopsis_score_attention"


def fused_synopsis_score_attention(
    q: torch.Tensor,         # (B, H, D)
    k_syn: torch.Tensor,     # (B, Hkv, M, D)
    v_syn: torch.Tensor,     # (B, Hkv, M, D)
    cbias: torch.Tensor,     # (B, M) f32 log(count) bias
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # (B, Hkv, M) f32 per row
    v_scale: Optional[torch.Tensor] = None,
):
  """Returns (scores (B,Hkv,M) f32, (o (B,H,D) f32, m (B,H), l (B,H))).

  CPU tensors run the plain version; CUDA tensors launch the kernel; meta
  tensors allocate its outputs and its scratch and launch nothing."""
  if q.device.type == "cpu":
    return ref.fused_synopsis_score_attention_ref(
        q, k_syn, v_syn, cbias, sm_scale=sm_scale, cap=cap, k_scale=k_scale,
        v_scale=v_scale)
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  if (H != Hkv * G or k_syn.shape != (B, Hkv, M, D)
      or v_syn.shape != k_syn.shape or cbias.shape != (B, M)):
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k_syn{tuple(k_syn.shape)} v_syn{tuple(v_syn.shape)} "
                     f"cbias{tuple(cbias.shape)}")
  if _build.is_latent(D):
    return _latent(q, k_syn, v_syn, cbias, sm_scale, cap, k_scale, v_scale)
  code = _build.dtype_code(NAME, q)
  storage = _build.storage_code(NAME, q, k_syn, v_syn)
  quantized = k_syn.dtype in qt.QDTYPES
  ks, vs = _build.scale_tensors(NAME, quantized, (B, Hkv, M), q.device,
                                k_scale, v_scale)
  _build.check_rows(NAME, D, G, k_syn, v_syn)
  cbias = cbias.to(device=q.device, dtype=torch.float32).contiguous()
  chunk = _chunk(M, D, k_syn.element_size(), B * Hkv,
                 _build.sm_count(q.device))
  nsplit = -(-M // chunk)
  f32 = dict(dtype=torch.float32, device=q.device)
  scores = torch.empty((B, Hkv, M), **f32)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nsplit, D) if nsplit > 1
          else (None,) * 4)
  if _build.is_meta(q):
    return scores, (o, m, l)
  P = _build.ptr
  err = _build.library().fused_synopsis_launch(
      P(q), P(k_syn), P(v_syn), P(cbias), P(ks), P(vs), P(scores), P(o),
      P(m), P(l), *map(P, part), B, Hkv, G, M, D, chunk, float(sm_scale),
      float(cap or 0.0), code, storage, _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(
      NAME, qt.kind_of(k_syn.dtype) if quantized else "none")] += 1
  return scores, (o, m, l)


def _latent(q, k_syn, v_syn, cbias, sm_scale, cap, k_scale, v_scale):
  """The latent core's stage 1 (``csrc/latent_decode.cuh``): an f32 query
  of up to 128 heads over f32 or bf16 tables, or a quantized arena's int8
  / fp8 tables with one f32 scale per row (``has_scale``).  The grid is
  (chunks of M, head tiles of 16, B * Hkv); each tile leaves its heads'
  max of every row in a scratch row, and the last block of a (b, hkv)
  takes the max over the tiles (tickets past the tiles' merge tickets)."""
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  quantized = k_syn.dtype in qt.QDTYPES
  code = _build.latent_codes(NAME, D, G, q, k_syn, v_syn,
                             allowed=qt.QDTYPES if quantized else None)
  ks, vs = _build.scale_tensors(NAME, quantized, (B, Hkv, M), q.device,
                                k_scale, v_scale)
  cbias = cbias.to(device=q.device, dtype=torch.float32).contiguous()
  ntiles = _build.latent_tiles(G)
  chunk = _build.latent_chunk(
      M, B * Hkv * ntiles, _build.sm_count(q.device))
  nsplit = -(-M // chunk)
  f32 = dict(dtype=torch.float32, device=q.device)
  scores = torch.empty((B, Hkv, M), **f32)
  score_part = torch.empty((B * Hkv, ntiles, M), **f32)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nsplit, D)[:3] if nsplit > 1
          else (None,) * 3)
  tickets = _build.tickets(q.device, B * Hkv * (ntiles + 1))
  if _build.is_meta(q):
    return scores, (o, m, l)
  P = _build.ptr
  err = _build.library().fused_synopsis_latent_launch(
      P(q), P(k_syn), P(v_syn), P(cbias), P(ks), P(vs), P(scores),
      P(score_part), P(o), P(m), P(l), *map(P, part), P(tickets), B, Hkv, G,
      M, D, chunk, float(sm_scale), float(cap or 0.0), code,
      _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(NAME, _build.latent_branch(
      qt.kind_of(k_syn.dtype) if quantized else "none"))] += 1
  return scores, (o, m, l)
