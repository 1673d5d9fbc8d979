"""Plain PyTorch versions of the port's kernels (the counterparts of
``repro.kernels.ref``).

Every kernel wrapper runs these on CPU tensors, and the chip checks hold
each CUDA kernel against them on the card.  Attention functions return
*partials* ``(out (B,H,D), m (B,H), l (B,H))`` that merge exactly through
:func:`merge_partials`.

``NEG_INF = -1e30`` is a finite sentinel, on purpose: a fully masked row
gives ``exp(NEG_INF - NEG_INF) = 1`` garbage that a later finite maximum
wipes out through ``alpha = exp(m_prev - m_new) = 0``; with ``-inf`` the
same row would produce NaN.  The kernels use the same sentinel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

NEG_INF = -1e30


def apply_softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
  if cap is None:
    return logits
  return cap * torch.tanh(logits / cap)


def flash_prefill_ref(
    q: torch.Tensor,             # (B, S, H, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,             # (B, S, Hkv, D)
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    window: Optional[int] = None,
    q_chunk: int = 512,
) -> torch.Tensor:
  """Causal GQA prefill attention, chunked over query blocks so the
  (S, S) logits never materialise; f32 math, output in ``q.dtype``."""
  B, S, H, D = q.shape
  Hkv = k.shape[2]
  G = H // Hkv
  qg = q.reshape(B, S, Hkv, G, D)
  kf = k.float()
  vf = v.float()
  kpos = torch.arange(S, device=q.device)
  out = torch.empty_like(q)
  for q0 in range(0, S, q_chunk):
    q1 = min(S, q0 + q_chunk)
    qpos = torch.arange(q0, q1, device=q.device)
    logits = apply_softcap(
        torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1].float(), kf)
        * sm_scale, cap)
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
      mask &= (qpos[:, None] - kpos[None, :]) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    oi = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    out[:, q0:q1] = oi.reshape(B, q1 - q0, H, D).to(q.dtype)
  return out


def synopsis_build_ref(
    k: torch.Tensor,             # (N, Hkv, S, D)
    v: torch.Tensor,             # (N, Hkv, S, D)
    perm: torch.Tensor,          # (N, S) int cluster-contiguous permutation
    *,
    cluster_size: int,
):
  """Permute the cache into cluster order and take each cluster's mean.
  Returns (k_sorted, v_sorted, k_syn, v_syn, counts (N, M) f32)."""
  N, Hkv, S, D = k.shape
  C = cluster_size
  M = S // C
  idx = perm.long()[:, None, :, None].expand(N, Hkv, S, D)
  k_sorted = torch.gather(k, 2, idx)
  v_sorted = torch.gather(v, 2, idx)
  k_syn = k_sorted.float().reshape(N, Hkv, M, C, D).mean(3).to(k.dtype)
  v_syn = v_sorted.float().reshape(N, Hkv, M, C, D).mean(3).to(v.dtype)
  counts = torch.full((N, M), float(C), dtype=torch.float32,
                      device=k.device)
  return k_sorted, v_sorted, k_syn, v_syn, counts


def fused_synopsis_score_attention_ref(
    q: torch.Tensor,             # (B, H, D)
    k_syn: torch.Tensor,         # (B, Hkv, M, D)
    v_syn: torch.Tensor,         # (B, Hkv, M, D)
    cbias: torch.Tensor,         # (B, M) f32 log(count) bias
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
) -> Tuple[torch.Tensor, Partials]:
  """Centroid logits computed once and used twice: the group-max scores
  (uncapped) and the count-biased stage-1 partials over ALL centroids."""
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  qg = q.reshape(B, Hkv, G, D).float()
  raw = torch.einsum("bhgd,bhmd->bhgm", qg, k_syn.float()) * sm_scale
  scores = raw.amax(dim=2)                                    # (B, Hkv, M)
  logits = apply_softcap(raw, cap) + cbias[:, None, None, :].float()
  m = logits.amax(dim=-1).clamp_min(NEG_INF)
  p = torch.exp(logits - m[..., None])
  l = p.sum(-1)
  out = torch.einsum("bhgs,bhsd->bhgd", p, v_syn.float())
  out = out / l.clamp_min(1e-30)[..., None]
  return scores, (out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H))


def fused_gather_attention_ref(
    q: torch.Tensor,             # (B, H, D)
    k: torch.Tensor,             # (B, Hkv, S, D) cluster-contiguous
    v: torch.Tensor,
    selected: torch.Tensor,      # (B, Hkv, I) int cluster ids (pad: -1)
    *,
    cluster_size: int,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    k_sel: Optional[torch.Tensor] = None,        # (B, Hkv, I, D)
    v_sel: Optional[torch.Tensor] = None,
    sel_bias: Optional[torch.Tensor] = None,     # (B, Hkv, I)
    extras_k: Optional[torch.Tensor] = None,     # (B, Hkv, E, D)
    extras_v: Optional[torch.Tensor] = None,
    extras_bias: Optional[torch.Tensor] = None,  # (B, E)
) -> Partials:
  """Stage 2 in one signed softmax accumulation: the selected clusters'
  tokens (+), their centroid stage-1 terms (-, decremental masking) and
  the recent/self extras (+).  The flush divides by ``l`` only where
  ``|l| > 1e-30`` (``l`` may cancel or go negative)."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  C = cluster_size
  G = H // Hkv
  qg = q.reshape(B, Hkv, G, D).float()
  selected = selected.long()
  starts = selected.clamp_min(0) * C                          # (B,Hkv,I)
  idx = (starts[..., None] + torch.arange(C, device=q.device)).reshape(
      B, Hkv, -1)
  kg = torch.gather(k, 2, idx[..., None].expand(-1, -1, -1, D))
  vg = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, D))
  valid = torch.repeat_interleave(selected >= 0, C, dim=-1)   # (B,Hkv,I*C)
  neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
  lt = apply_softcap(torch.einsum("bhgd,bhsd->bhgs", qg, kg.float())
                     * sm_scale, cap)
  lt = torch.where(valid[:, :, None, :], lt, neg)

  pieces = [(lt, vg, 1.0)]
  if k_sel is not None:
    lc = apply_softcap(torch.einsum("bhgd,bhid->bhgi", qg, k_sel.float())
                       * sm_scale, cap)
    lc = lc + sel_bias[:, :, None, :].float()
    lc = torch.where((selected >= 0)[:, :, None, :], lc, neg)
    pieces.append((lc, v_sel, -1.0))
  if extras_k is not None:
    le = apply_softcap(torch.einsum("bhgd,bhed->bhge", qg,
                                    extras_k.float()) * sm_scale, cap)
    le = le + extras_bias[:, None, None, :].float()
    pieces.append((le, extras_v, 1.0))

  m = pieces[0][0].amax(-1)
  for logits, _, _ in pieces[1:]:
    m = torch.maximum(m, logits.amax(-1))
  m = m.clamp_min(NEG_INF)
  l = torch.zeros_like(m)
  acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
  for logits, values, sign in pieces:
    p = torch.exp(logits - m[..., None])
    l = l + sign * p.sum(-1)
    acc = acc + sign * torch.einsum("bhgs,bhsd->bhgd", p, values.float())
  safe = torch.where(l.abs() > 1e-30, l, torch.ones_like(l))
  out = acc / safe[..., None]
  return (out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H))


def merge_partials(a: Partials, b: Partials) -> Partials:
  """Exact online-softmax merge of two disjoint-key partials."""
  oa, ma, la = a
  ob, mb, lb = b
  m = torch.maximum(ma, mb)
  wa = la * torch.exp(ma - m)
  wb = lb * torch.exp(mb - m)
  l = wa + wb
  o = (oa * wa[..., None] + ob * wb[..., None]) / l.clamp_min(1e-30)[..., None]
  return (o.to(oa.dtype), m, l)


def exact_decode_ref(q, k, v, *, sm_scale: float = 1.0,
                     cap: Optional[float] = None) -> torch.Tensor:
  """Exact GQA decode over the whole key set (B, H, D) f32 — the
  full-budget yardstick of the synopsis path."""
  B, H, D = q.shape
  Hkv = k.shape[1]
  qg = q.reshape(B, Hkv, H // Hkv, D).float()
  logits = apply_softcap(
      torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sm_scale, cap)
  p = torch.softmax(logits, dim=-1)
  return torch.einsum("bhgs,bhsd->bhgd", p, v.float()).reshape(B, H, D)
