"""Stage-2 wrapper: exact attention over the selected clusters with the
fused decrement and extras epilogues (CUDA kernel ``csrc/block_gather.cu``;
replaces ``repro/kernels/block_gather_attention.py``).

The cache is cluster-contiguous (cluster c = rows [c*C, (c+1)*C)), so the
kernel streams each selected cluster as C consecutive rows, one block a
cluster, and the extras in chunks of at most EXTRAS_ROWS rows, one block
each; the last block of each (b, hkv) row to finish merges the blocks'
partials (scratch allocated here).  ``selected``
may hold ``-1`` padding (masked with the -1e30 sentinel).  With
``k_sel/v_sel/sel_bias`` each selected centroid's stage-1 term is
accumulated with weight -1; with ``extras_*`` the recent ring and the new
token's self-KV fold in after the clusters.  A quantized cache (int8 /
fp8 codes) comes with one f32 scale per cluster block
(``kv_k_scale``/``kv_v_scale``); under a quantized synopsis the decrement
rows arrive dequantized in f32 beside a bf16 query.

``rows`` (B,) int32, the fleet tier's row map: batch row b's clusters are
read in place from row ``rows[b]`` of k / v's leading axis (the selected
replica lane of a shard, in the ``B*R*N``-row view of the fleet pool),
with no gathered copy; the selection, the scales, the decrement rows and
the extras stay indexed by b.  None is the identity.

A bf16 query, cache and extras read by a group in the head bucket of 16
(command-r-plus's G = 12) go to the decode core's tensor-core stream
(``csrc/decode_mma.cuh``, chosen here by ``_build.decode_mma``), counted
under ``block_gather_attention[g16]``; f32 rows, quantized caches and G <=
8 keep the CUDA-core loops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant as qt
from repro_torch.kernels import ref

NAME = "block_gather_attention"
# Rows of the extras (recent ring + self-KV) one block takes at most: E =
# 129 is two chunks of 65 and 64, each about one cluster's bytes.
EXTRAS_ROWS = 128


def _parts(I: int, E: int, has_ext: bool, most: int = EXTRAS_ROWS):
  """(rows of an extras chunk, parts): one part a selected cluster, one an
  extras chunk of at most ``most`` rows."""
  xrows = -(-E // -(-E // most)) if E else 1
  return xrows, I + (-(-E // xrows) if has_ext else 0)


def block_gather_attention(
    q: torch.Tensor,            # (B, H, D)
    k: torch.Tensor,            # (B, Hkv, S, D) cluster-contiguous
    v: torch.Tensor,            # (B, Hkv, S, D)
    selected: torch.Tensor,     # (B, Hkv, I) cluster ids, -1 padded
    *,
    cluster_size: int,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    k_sel: Optional[torch.Tensor] = None,        # (B, Hkv, I, D)
    v_sel: Optional[torch.Tensor] = None,        # (B, Hkv, I, D)
    sel_bias: Optional[torch.Tensor] = None,     # (B, Hkv, I)
    extras_k: Optional[torch.Tensor] = None,     # (B, Hkv, E, D)
    extras_v: Optional[torch.Tensor] = None,     # (B, Hkv, E, D)
    extras_bias: Optional[torch.Tensor] = None,  # (B, E)
    kv_k_scale: Optional[torch.Tensor] = None,   # (B, Hkv, M) f32 per block
    kv_v_scale: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,         # (B,) int32 rows of k / v
):
  """Returns partials (o (B,H,D) f32, m (B,H), l (B,H)).

  CPU tensors run the plain version; CUDA tensors launch the kernel; meta
  tensors allocate its outputs and its scratch and launch nothing."""
  if q.device.type == "cpu":
    return ref.fused_gather_attention_ref(
        q, k, v, selected, cluster_size=cluster_size, sm_scale=sm_scale,
        cap=cap, k_sel=k_sel, v_sel=v_sel, sel_bias=sel_bias,
        extras_k=extras_k, extras_v=extras_v, extras_bias=extras_bias,
        kv_k_scale=kv_k_scale, kv_v_scale=kv_v_scale, rows=rows)
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  C = cluster_size
  I = selected.shape[-1]
  has_dec = k_sel is not None
  has_ext = extras_k is not None
  E = extras_k.shape[2] if has_ext else 0
  bad = (H != Hkv * G or S % C or I < 1 or v.shape != k.shape
         or (k.shape[0] != B if rows is None else rows.shape != (B,))
         or selected.shape != (B, Hkv, I)
         or (has_dec and (k_sel.shape != (B, Hkv, I, D)
                          or v_sel.shape != k_sel.shape
                          or sel_bias.shape != (B, Hkv, I)))
         or (has_ext and (extras_k.shape != (B, Hkv, E, D)
                          or extras_v.shape != extras_k.shape
                          or extras_bias.shape != (B, E))))
  if bad:
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k{tuple(k.shape)} selected{tuple(selected.shape)} "
                     f"C={C}")
  if _build.is_latent(D):
    return _latent(q, k, v, selected, C, sm_scale, cap, k_sel, v_sel,
                   sel_bias, extras_k, extras_v, extras_bias, kv_k_scale,
                   kv_v_scale, _row_map(rows, q))
  code = _build.dtype_code(NAME, q, *([extras_k, extras_v] if has_ext
                                       else []))
  storage = _build.storage_code(NAME, q, k, v)
  quantized = k.dtype in qt.QDTYPES
  kq, vq = _build.scale_tensors(NAME, quantized, (B, Hkv, S // C), q.device,
                                kv_k_scale, kv_v_scale)
  # The decrement rows: the query's type, or f32 (dequantized centroids).
  dec = (_build.dtype_code(NAME, k_sel, v_sel, allowed=(q.dtype,
                                                         torch.float32))
         if has_dec else code)
  if has_dec and k_sel.device != q.device:
    raise ValueError(f"{NAME}: k_sel on {k_sel.device}, q on {q.device}")
  _build.check_rows(NAME, D, G, k, v, *([extras_k, extras_v] if has_ext
                                        else []))
  sel = selected.to(device=q.device, dtype=torch.int32).contiguous()
  rmap = _row_map(rows, q)
  f32 = dict(dtype=torch.float32, device=q.device)
  sb = sel_bias.to(**f32).contiguous() if has_dec else None
  eb = extras_bias.to(**f32).contiguous() if has_ext else None
  xrows, nparts = _parts(I, E, has_ext)
  # The tensor-core stream takes the cache in the query's type, not codes,
  # and stages the query 16 bytes a copy.
  mma = k.dtype == q.dtype and _build.decode_mma(NAME, k.dtype, G)
  if mma:
    _build.check_aligned(NAME, q)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nparts, D) if nparts > 1
          else (None,) * 4)
  if _build.is_meta(q):
    return o, m, l
  P = _build.ptr
  err = _build.library().block_gather_launch(
      P(q), P(k), P(v), P(sel), P(k_sel), P(v_sel), P(sb), P(extras_k),
      P(extras_v), P(eb), P(kq), P(vq), P(rmap), P(o), P(m), P(l),
      *map(P, part), B, Hkv, G, S, D, C, I, E, xrows, float(sm_scale),
      float(cap or 0.0), code, storage, dec, int(mma), _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(
      NAME, qt.kind_of(k.dtype) if quantized
      else _build.DECODE_MMA if mma else "none")] += 1
  return o, m, l


def _row_map(rows, q):
  """The row map as the kernels read it: int32, contiguous, on q's device
  (None stays None)."""
  if rows is None:
    return None
  if rows.device != q.device:
    raise ValueError(f"{NAME}: rows on {rows.device}, q on {q.device}")
  return rows.to(torch.int32).contiguous()


def _latent(q, k, v, selected, C, sm_scale, cap, k_sel, v_sel, sel_bias,
            extras_k, extras_v, extras_bias, kv_k_scale, kv_v_scale, rmap):
  """The latent core's stage 2: an f32 query of up to 128 heads; the cache
  f32 or bf16, or a quantized arena's int8 / fp8 codes with one f32 scale
  per cluster block (``has_kq``); the extras f32 or bf16 (the cache's type
  when it is unquantized); the decrement rows the cache's type or f32 (f32
  beside a quantized cache).  A bf16 / int8 / fp8 cache beside bf16 extras
  (or none) goes to the tensor cores (``csrc/latent_mma.cuh``: grid
  (parts, head tiles of 64, B * Hkv), the extras in chunks of at most
  LATENT_MMA_EXTRAS_ROWS, the parts merged by a second launch); f32 rows
  to the CUDA cores (``csrc/latent_decode.cuh``: head tiles of 16)."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G, I = H // Hkv, selected.shape[-1]
  has_dec, has_ext = k_sel is not None, extras_k is not None
  E = extras_k.shape[2] if has_ext else 0
  quantized = k.dtype in qt.QDTYPES
  storage = _build.latent_codes(NAME, D, G, q, k, v,
                                allowed=qt.QDTYPES if quantized else None)
  kq, vq = _build.scale_tensors(NAME, quantized, (B, Hkv, S // C), q.device,
                                kv_k_scale, kv_v_scale)
  if quantized:
    code = (_build.latent_codes(NAME, D, G, q, extras_k, extras_v)
            if has_ext else 0)
  else:
    code = _build.latent_codes(NAME, D, G, q, k, v, *(
        [extras_k, extras_v] if has_ext else []))
  dec = 0
  if has_dec:
    dec = _build.dtype_code(NAME, k_sel, v_sel, allowed=(
        (torch.float32,) if quantized else (k.dtype, torch.float32)))
    _build.check_aligned(NAME, k_sel, v_sel)
    if k_sel.device != q.device:
      raise ValueError(f"{NAME}: k_sel on {k_sel.device}, q on {q.device}")
  sel = selected.to(device=q.device, dtype=torch.int32).contiguous()
  f32 = dict(dtype=torch.float32, device=q.device)
  sb = sel_bias.to(**f32).contiguous() if has_dec else None
  eb = extras_bias.to(**f32).contiguous() if has_ext else None
  mma = _build.latent_mma(k, extras_k)
  xrows, nparts = _parts(I, E, has_ext, _build.LATENT_MMA_EXTRAS_ROWS
                         if mma else EXTRAS_ROWS)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nparts, D) if nparts > 1
          else (None,) * 4)
  if _build.is_meta(q):
    return o, m, l
  P = _build.ptr
  err = _build.library().block_gather_latent_launch(
      P(q), P(k), P(v), P(sel), P(k_sel), P(v_sel), P(sb), P(extras_k),
      P(extras_v), P(eb), P(kq), P(vq), P(rmap), P(o), P(m), P(l),
      *map(P, part), B, k.shape[0], Hkv, G, S, D, C, I, E, xrows,
      float(sm_scale), float(cap or 0.0), code, storage, dec, int(mma),
      _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(NAME, _build.latent_branch(
      qt.kind_of(k.dtype) if quantized else "none"))] += 1
  return o, m, l
