"""Public ops over the port's kernels (counterpart of ``repro.kernels.ops``,
fused pipeline only).

There is no ``impl`` switch: each kernel wrapper launches its CUDA kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors.

Decode attention is the fused two-stage pipeline:
:func:`synopsis_stage1` (one pass over ``k_syn``/``v_syn`` gives scores
AND count-biased partials), ``torch.topk``, :func:`refine_stage2`
(selected clusters' tokens + decremental centroid masking + recent/self
extras in one kernel), one :func:`merge_partials`.  The prefill half is
:func:`prefill_attention` and :func:`synopsis_build`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build

NEG_INF = ref.NEG_INF
merge_partials = ref.merge_partials


def count_bias(counts: torch.Tensor) -> torch.Tensor:
  """log(count) stand-in weight of an unselected cluster's centroid."""
  return torch.log(counts.float().clamp_min(1.0))


def prefill_attention(q, k, v, *, sm_scale: float = 1.0) -> torch.Tensor:
  """Causal GQA prefill attention; (B, S, H, D) in ``q.dtype``."""
  return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                       sm_scale=sm_scale)


def synopsis_build(k, v, perm, *, cluster_size: int):
  """Permute the cache cluster-contiguous and aggregate mean centroids in
  one pass: (k_sorted, v_sorted, k_syn, v_syn, counts (N, M))."""
  return segment_build(k.contiguous(), v.contiguous(), perm,
                       cluster_size=cluster_size)


def synopsis_stage1(q, k_syn, v_syn, counts, *, sm_scale: float):
  """One pass over the synopsis: (scores (B,Hkv,M), partials over ALL
  centroids with log-count bias)."""
  return fused_synopsis_score_attention(
      q.contiguous(), k_syn.contiguous(), v_syn.contiguous(),
      count_bias(counts), sm_scale=sm_scale)


def refine_stage2(q, k, v, selected, k_syn, v_syn, counts, *,
                  cluster_size: int, sm_scale: float,
                  extras: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = None):
  """Selected clusters' original tokens (+), their centroid stage-1 terms
  (-), and the recent/self extras (+) — one fused partial.  The I centroid
  rows of the decrement are gathered here (tiny: I rows, not I*C)."""
  B, Hkv, _, D = k.shape
  safe = selected.long().clamp_min(0)                         # (B,Hkv,I)
  k_sel = torch.gather(k_syn, 2, safe[..., None].expand(-1, -1, -1, D))
  v_sel = torch.gather(v_syn, 2, safe[..., None].expand(-1, -1, -1, D))
  cb = count_bias(counts)                                     # (B, M)
  sel_bias = torch.gather(cb[:, None, :].expand(B, Hkv, cb.shape[-1]), 2,
                          safe)
  ek, ev, eb = extras if extras is not None else (None, None, None)
  return block_gather_attention(
      q.contiguous(), k.contiguous(), v.contiguous(), selected,
      cluster_size=cluster_size, sm_scale=sm_scale, k_sel=k_sel,
      v_sel=v_sel, sel_bias=sel_bias,
      extras_k=None if ek is None else ek.contiguous(),
      extras_v=None if ev is None else ev.contiguous(), extras_bias=eb)


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
      pos = torch.arange(R, device=recent_k.device)[None, :]
      biases.append(torch.where(
          pos < recent_len.to(recent_k.device)[:, None],
          torch.tensor(0.0, device=recent_k.device),
          torch.tensor(NEG_INF, device=recent_k.device)))
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
    *,
    i_max: int,
    cluster_size: int,
    sm_scale: float = 1.0,
) -> torch.Tensor:
  """End-to-end fused AccuracyTrader decode attention over a serve-step
  cache slice; returns the normalised output (B, H, D) f32."""
  B = q.shape[0]
  Hkv, M = k_syn.shape[1], k_syn.shape[2]
  scores, p_syn = synopsis_stage1(q, k_syn, v_syn, counts,
                                  sm_scale=sm_scale)
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
                        extras=extras)
  out, _, _ = merge_partials(p_syn, p_ref)
  return out
