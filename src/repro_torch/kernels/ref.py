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

from repro_torch.kernels import quant as qt

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

NEG_INF = -1e30


def acc_dtype(x: torch.Tensor) -> torch.dtype:
  """The dtype the plain versions compute in for data like ``x``: f32, as
  the kernels accumulate, or float64 for float64 data, so that a float64
  run (``repro_torch.launch.parity``'s reference) stays in float64."""
  return torch.float64 if x.dtype == torch.float64 else torch.float32


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
  f = acc_dtype(q)
  kf = k.to(f)
  vf = v.to(f)
  kpos = torch.arange(S, device=q.device)
  out = torch.empty_like(q)
  for q0 in range(0, S, q_chunk):
    q1 = min(S, q0 + q_chunk)
    qpos = torch.arange(q0, q1, device=q.device)
    logits = apply_softcap(
        torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1].to(f), kf)
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
  f = acc_dtype(k)
  k_syn = k_sorted.to(f).reshape(N, Hkv, M, C, D).mean(3).to(k.dtype)
  v_syn = v_sorted.to(f).reshape(N, Hkv, M, C, D).mean(3).to(v.dtype)
  counts = torch.full((N, M), float(C), dtype=torch.float32,
                      device=k.device)
  return k_sorted, v_sorted, k_syn, v_syn, counts


def synopsis_build_quant_ref(
    k: torch.Tensor,             # (N, Hkv, S, D)
    v: torch.Tensor,             # (N, Hkv, S, D)
    perm: torch.Tensor,          # (N, S) int cluster-contiguous permutation
    *,
    cluster_size: int,
    qc: qt.QuantConfig,          # with qc.enabled
):
  """The quantized build: the same permute and segment mean, with the
  centroids quantized from their *f32* means (one scale per centroid row)
  and, under ``qc.sorted_kv``, the sorted cache quantized per C-row cluster
  block.  Returns the arena dict {k, v, k_syn, v_syn, counts, k_syn_scale,
  v_syn_scale[, k_scale, v_scale]}."""
  N, Hkv, S, D = k.shape
  C = cluster_size
  M = S // C
  idx = perm.long()[:, None, :, None].expand(N, Hkv, S, D)
  k_sorted = torch.gather(k, 2, idx)
  v_sorted = torch.gather(v, 2, idx)
  k_mean = k_sorted.float().reshape(N, Hkv, M, C, D).mean(3)
  v_mean = v_sorted.float().reshape(N, Hkv, M, C, D).mean(3)
  out = {"counts": torch.full((N, M), float(C), dtype=torch.float32,
                              device=k.device)}
  out["k_syn"], out["k_syn_scale"] = qt.quantize_rows(k_mean, qc.kind)
  out["v_syn"], out["v_syn_scale"] = qt.quantize_rows(v_mean, qc.kind)
  if qc.sorted_kv:
    out["k"], out["k_scale"] = qt.quantize_rows(k_sorted, qc.kind, block=C)
    out["v"], out["v_scale"] = qt.quantize_rows(v_sorted, qc.kind, block=C)
  else:
    out["k"], out["v"] = k_sorted, v_sorted
  return out


def fused_synopsis_score_attention_ref(
    q: torch.Tensor,             # (B, H, D)
    k_syn: torch.Tensor,         # (B, Hkv, M, D)
    v_syn: torch.Tensor,         # (B, Hkv, M, D)
    cbias: torch.Tensor,         # (B, M) f32 log(count) bias
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,      # (B, Hkv, M) f32
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Partials]:
  """Centroid logits computed once and used twice: the group-max scores
  (uncapped) and the count-biased stage-1 partials over ALL centroids.

  With ``k_scale``/``v_scale`` the tables hold quantized codes: the
  k-scale multiplies the raw logits before ``sm_scale``, the v-scale the
  weights ``p`` entering p.V (``l`` stays unscaled)."""
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  f = acc_dtype(q)
  qg = q.reshape(B, Hkv, G, D).to(f)
  raw = torch.einsum("bhgd,bhmd->bhgm", qg, k_syn.to(f))
  if k_scale is not None:
    raw = raw * k_scale[:, :, None, :].to(f)
  raw = raw * sm_scale
  scores = raw.amax(dim=2)                                    # (B, Hkv, M)
  logits = apply_softcap(raw, cap) + cbias[:, None, None, :].to(f)
  m = logits.amax(dim=-1).clamp_min(NEG_INF)
  p = torch.exp(logits - m[..., None])
  l = p.sum(-1)
  pv = p if v_scale is None else p * v_scale[:, :, None, :].to(f)
  out = torch.einsum("bhgs,bhsd->bhgd", pv, v_syn.to(f))
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
    kv_k_scale: Optional[torch.Tensor] = None,   # (B, Hkv, M) f32
    kv_v_scale: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,         # (B,) int rows of k / v
) -> Partials:
  """Stage 2 in one signed softmax accumulation: the selected clusters'
  tokens (+), their centroid stage-1 terms (-, decremental masking) and
  the recent/self extras (+).  The flush divides by ``l`` only where
  ``|l| > 1e-30`` (``l`` may cancel or go negative).

  With ``kv_k_scale``/``kv_v_scale`` k/v hold the quantized sorted arena:
  each selected cluster's scale (read through the clamped id) multiplies
  its raw logits and its value rows; the decrement and the extras take no
  scale.  ``rows`` (the fleet tier's row map) reads batch row b's clusters
  from row ``rows[b]`` of k / v's leading axis; the scales and the rest
  stay indexed by b."""
  if rows is not None:
    rows = rows.to(device=k.device, dtype=torch.long)
    k, v = qt.select_rows(k, rows), qt.select_rows(v, rows)
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  C = cluster_size
  G = H // Hkv
  f = acc_dtype(q)
  qg = q.reshape(B, Hkv, G, D).to(f)
  selected = selected.long()
  starts = selected.clamp_min(0) * C                          # (B,Hkv,I)
  idx = (starts[..., None] + torch.arange(C, device=q.device)).reshape(
      B, Hkv, -1)
  kg = qt.gather_rows(k, 2, idx[..., None].expand(-1, -1, -1, D))
  vg = qt.gather_rows(v, 2, idx[..., None].expand(-1, -1, -1, D))
  valid = torch.repeat_interleave(selected >= 0, C, dim=-1)   # (B,Hkv,I*C)
  neg = torch.tensor(NEG_INF, dtype=f, device=q.device)
  raw = torch.einsum("bhgd,bhsd->bhgs", qg, kg.to(f))
  safe = selected.clamp_min(0)
  if kv_k_scale is not None:
    ksc = torch.gather(kv_k_scale.to(f), 2, safe)           # (B,Hkv,I)
    raw = raw * torch.repeat_interleave(ksc, C, dim=-1)[:, :, None, :]
  if kv_v_scale is not None:
    vsc = torch.gather(kv_v_scale.to(f), 2, safe)
    vg = vg.to(f) * torch.repeat_interleave(vsc, C, dim=-1)[..., None]
  lt = apply_softcap(raw * sm_scale, cap)
  lt = torch.where(valid[:, :, None, :], lt, neg)

  pieces = [(lt, vg, 1.0)]
  if k_sel is not None:
    lc = apply_softcap(torch.einsum("bhgd,bhid->bhgi", qg, k_sel.to(f))
                       * sm_scale, cap)
    lc = lc + sel_bias[:, :, None, :].to(f)
    lc = torch.where((selected >= 0)[:, :, None, :], lc, neg)
    pieces.append((lc, v_sel, -1.0))
  if extras_k is not None:
    le = apply_softcap(torch.einsum("bhgd,bhed->bhge", qg,
                                    extras_k.to(f)) * sm_scale, cap)
    le = le + extras_bias[:, None, None, :].to(f)
    pieces.append((le, extras_v, 1.0))

  m = pieces[0][0].amax(-1)
  for logits, _, _ in pieces[1:]:
    m = torch.maximum(m, logits.amax(-1))
  m = m.clamp_min(NEG_INF)
  l = torch.zeros_like(m)
  acc = torch.zeros((B, Hkv, G, D), dtype=f, device=q.device)
  for logits, values, sign in pieces:
    p = torch.exp(logits - m[..., None])
    l = l + sign * p.sum(-1)
    acc = acc + sign * torch.einsum("bhgs,bhsd->bhgd", p, values.to(f))
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


def flash_decode_ref(
    q: torch.Tensor,             # (B, H, D)
    k: torch.Tensor,             # (B, Hkv, S, D)
    v: torch.Tensor,             # (B, Hkv, S, D)
    bias: Optional[torch.Tensor] = None,   # (B, Hkv, S) additive, log-space
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
) -> Partials:
  """GQA decode attention over the whole key set; the bias is added after
  the softcap (the unfused stage 1 passes log(count), or -1e30 for the
  selected clusters)."""
  B, H, D = q.shape
  Hkv = k.shape[1]
  f = acc_dtype(q)
  qg = q.reshape(B, Hkv, H // Hkv, D).to(f)
  logits = apply_softcap(
      torch.einsum("bhgd,bhsd->bhgs", qg, k.to(f)) * sm_scale, cap)
  if bias is not None:
    logits = logits + bias[:, :, None, :].to(f)
  m = logits.amax(dim=-1).clamp_min(NEG_INF)
  p = torch.exp(logits - m[..., None])
  l = p.sum(-1)
  out = torch.einsum("bhgs,bhsd->bhgd", p, v.to(f))
  out = out / l.clamp_min(1e-30)[..., None]
  return (out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H))


def synopsis_score_ref(
    q: torch.Tensor,             # (B, H, D)
    k_syn: torch.Tensor,         # (B, Hkv, M, D)
    *,
    sm_scale: float = 1.0,
) -> torch.Tensor:
  """Correlation of every cluster to the query (paper line 1): the max over
  the GQA group's query heads of the centroid logit, (B, Hkv, M) f32."""
  B, H, D = q.shape
  Hkv = k_syn.shape[1]
  f = acc_dtype(q)
  qg = q.reshape(B, Hkv, H // Hkv, D).to(f)
  logits = torch.einsum("bhgd,bhmd->bhgm", qg, k_syn.to(f))
  return logits.amax(dim=2) * sm_scale


def synopsis_attention_ref(q, k, v, k_syn, v_syn, counts, *, i_max: int,
                           sm_scale: float = 1.0):
  """The paper's two-stage algebra, unfused: each unselected centroid
  stands in for its cluster with weight count * exp(logit) (stage 1, the
  selected ones masked with -1e30), the top-``i_max`` clusters contribute
  their tokens exactly (stage 2, :func:`fused_gather_attention_ref` with
  neither epilogue).  Returns (out (B,H,D), scores, selected (B,Hkv,I))."""
  M = k_syn.shape[2]
  scores = synopsis_score_ref(q, k_syn, sm_scale=sm_scale)
  selected = torch.topk(scores, i_max, dim=-1).indices.to(torch.int32)
  chosen = torch.zeros(scores.shape, dtype=torch.bool, device=q.device)
  chosen.scatter_(2, selected.long(), True)
  cbias = torch.log(counts.float().clamp_min(1.0))[:, None, :]
  syn_bias = torch.where(chosen, torch.tensor(NEG_INF, device=q.device),
                         cbias)
  part_syn = flash_decode_ref(q, k_syn, v_syn, syn_bias, sm_scale=sm_scale)
  part_ref = fused_gather_attention_ref(
      q, k, v, selected, cluster_size=k.shape[2] // M, sm_scale=sm_scale)
  out, _, _ = merge_partials(part_syn, part_ref)
  return out, scores, selected


def exact_attention_ref(q, k, v, *, sm_scale: float = 1.0,
                        cap: Optional[float] = None) -> torch.Tensor:
  """Exact GQA decode over the whole key set (B, H, D) f32 — the
  full-budget yardstick of the synopsis path."""
  return flash_decode_ref(q, k, v, sm_scale=sm_scale, cap=cap)[0]
