"""Public ops over the port's kernels (counterpart of ``repro.kernels.ops``).

There is no ``impl`` switch: each kernel wrapper launches its CUDA kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors, so the
JAX package's ``_scores`` / ``_decode`` / ``_gather`` dispatchers are the
wrappers themselves (``flash_decode`` masks a ragged S in the kernel, so
no tile size that divides S is searched for).

Decode attention is the fused two-stage pipeline:
:func:`synopsis_stage1` (one pass over ``k_syn``/``v_syn`` gives scores
AND count-biased partials), ``torch.topk``, :func:`refine_stage2`
(selected clusters' tokens + decremental centroid masking + recent/self
extras in one kernel), one :func:`merge_partials`.  The prefill half is
:func:`prefill_attention` and :func:`synopsis_build`.

The exact baseline is :func:`exact_decode_attention` /
:func:`decode_partials` (``flash_decode`` over the whole cache), and
:func:`synopsis_attention` keeps the unfused composition (score kernel,
masked decode over the centroids, block gather, merge) as the paper-algebra
oracle and the baseline the fused pipeline is measured against;
:func:`synopsis_attention_fused` is the fused pipeline under the same
contract.

Quantized arenas (``kernels/quant.py``): :func:`synopsis_build` with a
``qconfig`` spec returns the arena dict with int8 / fp8 tables and their
scales; the decode ops take the four scale tensors, which ride into the
kernels (stage 1: per centroid row; stage 2: per cluster block).  The I
gathered centroid rows of stage 2's decrement are dequantized to f32 here,
outside the kernel.  All-``None`` scales are the unquantized path, bit for
bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import quant as qt
from repro_torch.kernels import ref
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build
from repro_torch.kernels.synopsis_score import synopsis_score

NEG_INF = ref.NEG_INF
merge_partials = ref.merge_partials


def pack_partials(p) -> torch.Tensor:
  """Partials (o (..., D), m (...), l (...)) -> one f32 tensor (..., D + 2):
  one collective moves all three (the sharded paths' result composer)."""
  o, m, l = p
  return torch.cat([o.float(), m[..., None].float(), l[..., None].float()],
                   -1)


def unpack_partials(x: torch.Tensor):
  """The inverse of :func:`pack_partials`."""
  D = x.shape[-1] - 2
  return x[..., :D], x[..., D], x[..., D + 1]


def count_bias(counts: torch.Tensor) -> torch.Tensor:
  """log(count) stand-in weight of an unselected cluster's centroid."""
  return torch.log(counts.float().clamp_min(1.0))


def prefill_attention(q, k, v, *, sm_scale: float = 1.0,
                      cap: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
  """Causal GQA prefill attention, with an optional logit softcap and
  sliding window; (B, S, H, D) in ``q.dtype``."""
  return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                       sm_scale=sm_scale, cap=cap, window=window)


def synopsis_build(k, v, perm, *, cluster_size: int,
                   qconfig: Optional[str] = None):
  """Permute the cache cluster-contiguous and aggregate mean centroids in
  one pass: (k_sorted, v_sorted, k_syn, v_syn, counts (N, M)), or, with a
  quantizing ``qconfig`` spec, the arena dict with the quantized tables
  and their scales, from the same pass."""
  qc = qt.parse_qconfig(qconfig)
  return segment_build(k.contiguous(), v.contiguous(), perm,
                       cluster_size=cluster_size,
                       quant=qc.spec if qc.enabled else None)


ScalePair = Optional[Tuple[torch.Tensor, torch.Tensor]]


def synopsis_stage1(q, k_syn, v_syn, counts, *, sm_scale: float,
                    cap: Optional[float] = None,
                    syn_scales: ScalePair = None,
                    valid: Optional[torch.Tensor] = None):
  """One pass over the synopsis: (scores (B,Hkv,M), partials over ALL
  centroids with log-count bias).  ``syn_scales`` = (k_syn_scale,
  v_syn_scale) (B, Hkv, M) when the synopsis is quantized.

  ``valid`` (B, M) bool masks padding centroid slots (the cluster tier
  pads every component's shard to a common ``m_max``): a NEG_INF bias
  keeps them out of the partial, and NEG_INF scores out of any ranking.
  It is a bias, not a kernel branch, as in the JAX wrapper."""
  ks, vs = syn_scales if syn_scales is not None else (None, None)
  cbias = count_bias(counts)
  if valid is not None:
    cbias = torch.where(valid, cbias, NEG_INF)
  scores, part = fused_synopsis_score_attention(
      q.contiguous(), k_syn.contiguous(), v_syn.contiguous(), cbias,
      sm_scale=sm_scale, cap=cap, k_scale=ks, v_scale=vs)
  if valid is not None:
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
  return scores, part


def refine_stage2(q, k, v, selected, k_syn, v_syn, counts, *,
                  cluster_size: int, sm_scale: float,
                  cap: Optional[float] = None,
                  extras: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = None,
                  syn_scales: ScalePair = None, kv_scales: ScalePair = None,
                  valid: Optional[torch.Tensor] = None,
                  kv_rows: Optional[torch.Tensor] = None):
  """Selected clusters' original tokens (+), their centroid stage-1 terms
  (-), and the recent/self extras (+) — one fused partial.  The I centroid
  rows of the decrement are gathered here (tiny: I rows, not I*C), and
  dequantized to f32 under ``syn_scales``; ``kv_scales`` = (k_scale,
  v_scale) (B, Hkv, M) ride into the kernel with a quantized cache.
  ``valid`` (B, Hkv, I) bool turns entries of ``selected`` into -1 pads
  (skipped), as the JAX wrapper's.  ``kv_rows`` (B,) is the row map of
  ``block_gather_attention``: k / v are then a larger stack of rows (the
  fleet pool's replica lanes) read in place at those rows."""
  B, Hkv, _, D = k_syn.shape
  if valid is not None:
    selected = torch.where(valid, selected, -1)
  safe = selected.long().clamp_min(0)                         # (B,Hkv,I)
  rows = safe[..., None].expand(-1, -1, -1, D)
  k_sel = qt.gather_rows(k_syn, 2, rows)
  v_sel = qt.gather_rows(v_syn, 2, rows)
  if syn_scales is not None:
    ks, vs = syn_scales
    f = ref.acc_dtype(q)
    k_sel = k_sel.to(f) * torch.gather(ks.to(f), 2, safe)[..., None]
    v_sel = v_sel.to(f) * torch.gather(vs.to(f), 2, safe)[..., None]
  cb = count_bias(counts)                                     # (B, M)
  sel_bias = torch.gather(cb[:, None, :].expand(B, Hkv, cb.shape[-1]), 2,
                          safe)
  ek, ev, eb = extras if extras is not None else (None, None, None)
  kq, vq = kv_scales if kv_scales is not None else (None, None)
  return block_gather_attention(
      q.contiguous(), k.contiguous(), v.contiguous(), selected,
      cluster_size=cluster_size, sm_scale=sm_scale, cap=cap, k_sel=k_sel,
      v_sel=v_sel, sel_bias=sel_bias,
      extras_k=None if ek is None else ek.contiguous(),
      extras_v=None if ev is None else ev.contiguous(), extras_bias=eb,
      kv_k_scale=kq, kv_v_scale=vq, rows=kv_rows)


def _pairs(k_syn_scale, v_syn_scale, kv_k_scale, kv_v_scale):
  """The four scale tensors -> (syn_scales, kv_scales), None where absent."""
  syn = None if k_syn_scale is None else (k_syn_scale, v_syn_scale)
  kv = None if kv_k_scale is None else (kv_k_scale, kv_v_scale)
  return syn, kv


def build_extras(recent_k=None, recent_v=None, recent_len=None,
                 self_kv=None):
  """Concatenate the recent ring buffer and the new token's self-KV into
  one (B, Hkv, E, D) extras block + (B, E) validity bias.  Unlike the JAX
  version, E is not padded to a multiple of 16 (the TPU tile): the CUDA
  kernel masks a ragged tail itself.  Returns None when there is nothing
  to fold in."""
  ks, vs, biases = [], [], []
  if recent_k is not None:
    B, _, R, _ = recent_k.shape
    ks.append(recent_k)
    vs.append(recent_v)
    if recent_len is None:
      biases.append(torch.zeros((B, R), dtype=torch.float32,
                                device=recent_k.device))
    else:
      # No host-to-device copy (a scalar tensor would be one), so that a
      # CUDA graph can capture the step.
      pos = torch.arange(R, device=recent_k.device)[None, :]
      biases.append(torch.zeros((B, R), dtype=torch.float32,
                                device=recent_k.device).masked_fill_(
          pos >= recent_len.to(recent_k.device)[:, None], NEG_INF))
  if self_kv is not None:
    k1, v1 = self_kv                                          # (B,Hkv,1,D)
    ks.append(k1)
    vs.append(v1)
    biases.append(torch.zeros((k1.shape[0], k1.shape[2]),
                              dtype=torch.float32, device=k1.device))
  if not ks:
    return None
  return (torch.cat(ks, dim=2), torch.cat(vs, dim=2),
          torch.cat(biases, dim=1).float())


def synopsis_cache_attention(
    q: torch.Tensor,        # (B, H, D) one decode step's queries
    k: torch.Tensor,        # (B, Hkv, S, D) cluster-contiguous keys
    v: torch.Tensor,
    k_syn: torch.Tensor,    # (B, Hkv, M, D)
    v_syn: torch.Tensor,
    counts: torch.Tensor,   # (B, M)
    recent_k: Optional[torch.Tensor] = None,   # (B, Hkv, R, D)
    recent_v: Optional[torch.Tensor] = None,
    recent_len: Optional[torch.Tensor] = None,  # (B,)
    self_k: Optional[torch.Tensor] = None,      # (B, Hkv, 1, D)
    self_v: Optional[torch.Tensor] = None,
    k_syn_scale: Optional[torch.Tensor] = None,  # (B, Hkv, M): quantized
    v_syn_scale: Optional[torch.Tensor] = None,  # synopsis
    kv_k_scale: Optional[torch.Tensor] = None,   # (B, Hkv, M): quantized
    kv_v_scale: Optional[torch.Tensor] = None,   # sorted KV
    *,
    i_max: int,
    cluster_size: int,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    return_scores: bool = False,
):
  """End-to-end fused AccuracyTrader decode attention over a serve-step
  cache slice; returns the normalised output (B, H, D) f32, and with
  ``return_scores`` also stage 1's scores (B, Hkv, M) (the same ops: the
  scores are stage 1's own output).  All-None scales keep the unquantized
  path."""
  B = q.shape[0]
  Hkv, M = k_syn.shape[1], k_syn.shape[2]
  syn_scales, kv_scales = _pairs(k_syn_scale, v_syn_scale, kv_k_scale,
                                 kv_v_scale)
  scores, p_syn = synopsis_stage1(q, k_syn, v_syn, counts,
                                  sm_scale=sm_scale, cap=cap,
                                  syn_scales=syn_scales)
  if i_max > 0:
    selected = torch.topk(scores, min(i_max, M), dim=-1).indices
    selected = selected.to(torch.int32)
  else:
    selected = torch.full((B, Hkv, 1), -1, dtype=torch.int32,
                          device=q.device)
  self_kv = (self_k, self_v) if self_k is not None else None
  extras = build_extras(recent_k, recent_v, recent_len, self_kv)
  p_ref = refine_stage2(q, k, v, selected, k_syn, v_syn, counts,
                        cluster_size=cluster_size, sm_scale=sm_scale,
                        cap=cap, extras=extras, syn_scales=syn_scales,
                        kv_scales=kv_scales)
  out, _, _ = merge_partials(p_syn, p_ref)
  return (out, scores) if return_scores else out


def synopsis_attention_fused(q, k, v, k_syn, v_syn, counts,
                             k_syn_scale=None, v_syn_scale=None,
                             kv_k_scale=None, kv_v_scale=None, *,
                             i_max: int, sm_scale: float = 1.0,
                             return_diag: bool = False):
  """Fused drop-in for :func:`synopsis_attention` (same contract): one
  synopsis pass + decremental refinement instead of score + masked decode
  + gather + merge.  The scales (quantized arena) are optional."""
  M = k_syn.shape[2]
  syn_scales, kv_scales = _pairs(k_syn_scale, v_syn_scale, kv_k_scale,
                                 kv_v_scale)
  scores, p_syn = synopsis_stage1(q, k_syn, v_syn, counts,
                                  sm_scale=sm_scale, syn_scales=syn_scales)
  selected = torch.topk(scores, min(i_max, M), dim=-1).indices
  selected = selected.to(torch.int32)
  p_ref = refine_stage2(q, k, v, selected, k_syn, v_syn, counts,
                        cluster_size=k.shape[2] // M, sm_scale=sm_scale,
                        syn_scales=syn_scales, kv_scales=kv_scales)
  out, m, l = merge_partials(p_syn, p_ref)
  if return_diag:
    return out, (scores, selected, m, l)
  return out


def synopsis_attention(
    q: torch.Tensor,        # (B, H, D) one decode step's queries
    k: torch.Tensor,        # (B, Hkv, S, D) cluster-contiguous keys
    v: torch.Tensor,
    k_syn: torch.Tensor,    # (B, Hkv, M, D)
    v_syn: torch.Tensor,
    counts: torch.Tensor,   # (B, M)
    *,
    i_max: int,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    return_diag: bool = False,
):
  """AccuracyTrader attention, unfused: O(M + i_max*C) instead of O(S).

  Unselected clusters contribute count-weighted centroid terms (stage 1,
  ``flash_decode`` over the centroids with a log(count) bias, -1e30 on the
  selected ones); the top-``i_max`` clusters contribute their original
  tokens exactly (stage 2, ``block_gather_attention`` with neither
  epilogue).  The synopsis is read twice and three partials merge
  separately.  With ``i_max == M`` this equals exact attention.  ``cap``
  softcaps the attention logits (the scores stay uncapped, as stage 1's
  do)."""
  B, Hkv, M, _ = k_syn.shape
  scores = synopsis_score(q.contiguous(), k_syn.contiguous(),
                          sm_scale=sm_scale)
  selected = torch.topk(scores, i_max, dim=-1).indices.to(torch.int32)
  chosen = torch.zeros((B, Hkv, M), dtype=torch.bool, device=q.device)
  chosen.scatter_(2, selected.long(), True)
  syn_bias = torch.where(chosen, torch.tensor(NEG_INF, device=q.device),
                         count_bias(counts)[:, None, :])
  part_syn = decode_partials(q, k_syn, v_syn, syn_bias, sm_scale=sm_scale,
                              cap=cap)
  part_ref = block_gather_attention(
      q.contiguous(), k.contiguous(), v.contiguous(), selected,
      cluster_size=k.shape[2] // M, sm_scale=sm_scale, cap=cap)
  out, m, l = merge_partials(part_syn, part_ref)
  if return_diag:
    return out, (scores, selected, m, l)
  return out


def decode_partials(q, k, v, bias=None, *, sm_scale: float = 1.0,
                    cap: Optional[float] = None):
  """Decode attention over all of k/v: partials (out, m, l) for merging.
  k/v may be views with the batch and head strides of a larger cache (a
  sliding window's last rows): ``flash_decode`` reads them in place."""
  return flash_decode(q.contiguous(), k, v, bias, sm_scale=sm_scale,
                      cap=cap)


def exact_decode_attention(q, k, v, bias=None, *, sm_scale: float = 1.0,
                           cap: Optional[float] = None) -> torch.Tensor:
  """Exact GQA decode (the baseline); the normalised output only."""
  return decode_partials(q, k, v, bias, sm_scale=sm_scale, cap=cap)[0]
