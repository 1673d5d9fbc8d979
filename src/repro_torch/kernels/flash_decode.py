"""Decode wrapper: GQA attention of one new query token over S keys, with
an optional additive bias and softcap (CUDA kernel ``csrc/flash_decode.cu``;
replaces ``repro/kernels/flash_decode.py``).

It serves the exact baseline (the whole cache, then the one-token self
partial) and the unfused synopsis op's stage 1 (the centroid tables with a
log(count) bias, -1e30 on the selected clusters).  The kernel splits S
across blocks (chunks of whole tiles of the decode core, sized here so the
grid fills the card about once) and merges the chunks' partials, so a
ragged S (8320 after an absorb, 65 centroids, 1 self token) needs no tile
that divides it.

K and V may be views into a larger cache, as a sliding window's last rows
``k[:, :, -window:]`` are (gemma2's local layers): the kernel takes their
batch and head strides, so the window runs in place, with no copy (a copy
of a 4096-row window at gemma2-2b's width moves 33.5 MB a layer at B = 2).
Each row's D elements must be contiguous and the rows D apart, and K and V
must share their strides.

bf16 rows read by a group in the head bucket of 16 (command-r-plus's G =
12) go to the decode core's tensor-core stream (``csrc/decode_mma.cuh``:
logits and P.V on mma.sync, in the same grid, chunks and merge), counted
under ``flash_decode[g16]``; f32 rows and G <= 8 keep the CUDA-core loops
(``_build.decode_mma``).  The exact loop's self token (S = 1) takes the
tensor-core stream too: no rule sends short spans back, as that stream
measured faster there (0.0047 ms of device time against the CUDA-core
bucket's 0.0103 at command-r-plus's (2, 96, 128) over one row, one H100
80GB HBM3 at 700 W, ``tools/kernel_times.py --only g16``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "flash_decode"
# Blocks of the grid for each SM: 2 measured fastest at the exact path's
# shape on the H100 (chunks of 512 rows; 1, 3, 4 and 6 were slower; an SM
# holds 5 blocks of ~37 KB of shared memory at D = 128 in bf16); and the
# fewest rows a chunk: the self token and the 64 / 65 centroid tables are
# one chunk, with no merge.
BLOCKS_PER_SM = 2
MIN_CHUNK = 128


def _chunk(S: int, D: int, itemsize: int, blocks: int, sms: int) -> int:
  """Rows per block: enough chunks for BLOCKS_PER_SM blocks on each SM,
  none shorter than MIN_CHUNK, rounded to whole rounds of one tile for
  each warp of the block."""
  rnd = _build.DECODE_WARPS * _build.decode_tile_rows(D, itemsize)
  nsplit = max(1, min(-(-S // max(MIN_CHUNK, rnd)),
                      -(-BLOCKS_PER_SM * sms // blocks)))
  rows = -(-S // nsplit)
  return -(-rows // rnd) * rnd


def _row_strides(k: torch.Tensor, v: torch.Tensor):
  """(batch, head) strides in elements of the K/V views the kernel takes:
  rows of D contiguous elements, D apart, every head 16-byte aligned; K
  and V alike.  A dimension of size 1 takes its contiguous stride."""
  B, Hkv, S, D = k.shape

  def strides(t):
    if (D > 1 and t.stride(3) != 1) or (S > 1 and t.stride(2) != D):
      return None
    return (t.stride(0) if B > 1 else Hkv * S * D,
            t.stride(1) if Hkv > 1 else S * D)
  sk = strides(k)
  if (sk is None or strides(v) != sk or max(sk) >= 2 ** 31 or min(sk) < 0
      or any(x * k.element_size() % 16 for x in sk)):
    raise ValueError(f"{NAME}: K/V strides {k.stride()} / {v.stride()} not "
                     "taken: rows of D contiguous elements, D apart, heads "
                     "16-byte aligned, K and V alike")
  return sk


def flash_decode(
    q: torch.Tensor,                       # (B, H, D)
    k: torch.Tensor,                       # (B, Hkv, S, D), rows contiguous
    v: torch.Tensor,                       # (B, Hkv, S, D)
    bias: Optional[torch.Tensor] = None,   # (B, Hkv, S) f32, after the cap
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
):
  """Returns partials (o (B,H,D) f32 normalised, m (B,H), l (B,H)).

  CPU tensors run the plain version; CUDA tensors launch the kernel; meta
  tensors allocate its outputs and its chunks' scratch and launch
  nothing."""
  if q.device.type == "cpu":
    return ref.flash_decode_ref(q, k, v, bias, sm_scale=sm_scale, cap=cap)
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  if (H != Hkv * G or S < 1 or k.shape != (B, Hkv, S, D)
      or v.shape != k.shape
      or (bias is not None and bias.shape != (B, Hkv, S))):
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k{tuple(k.shape)} v{tuple(v.shape)} bias"
                     f"{None if bias is None else tuple(bias.shape)}")
  if _build.is_latent(D):
    return _latent(q, k, v, bias, sm_scale, cap)
  code = _build.dtype_code(NAME, q, views=(k, v))
  kv_sb, kv_sh = _row_strides(k, v)
  _build.check_rows(NAME, D, G, k, v)
  f32 = dict(dtype=torch.float32, device=q.device)
  if bias is not None:
    bias = bias.to(**f32).contiguous()
  mma = _build.decode_mma(NAME, q.dtype, G)
  if mma:  # the tensor-core stream stages the query 16 bytes a copy
    _build.check_aligned(NAME, q)
  chunk = _chunk(S, D, k.element_size(), B * Hkv,
                 _build.sm_count(q.device))
  nsplit = -(-S // chunk)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nsplit, D) if nsplit > 1
          else (None,) * 4)
  if _build.is_meta(q):
    return o, m, l
  P = _build.ptr
  err = _build.library().flash_decode_launch(
      P(q), P(k), P(v), P(bias), P(o), P(m), P(l), *map(P, part), B, Hkv,
      G, S, D, chunk, kv_sb, kv_sh, float(sm_scale), float(cap or 0.0), code,
      int(mma), _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.decode_branch(NAME, q.dtype, G)] += 1
  return o, m, l


def _latent(q, k, v, bias, sm_scale, cap):
  """The latent core's flash_decode: an f32 query of up to 128 heads over
  one wide K/V head (MLA's absorbed decode), with the same strides and
  partials as above.  bf16 K/V go to the tensor cores
  (``csrc/latent_mma.cuh``: grid (chunks of S, head tiles of 64, B *
  Hkv), the chunks merged by a second launch), f32 K/V to the CUDA cores
  (``csrc/latent_decode.cu``: head tiles of 16, a ticketed merge)."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  code = _build.latent_codes(NAME, D, G, q, views=(k, v))
  kv_sb, kv_sh = _row_strides(k, v)
  f32 = dict(dtype=torch.float32, device=q.device)
  if bias is not None:
    bias = bias.to(**f32).contiguous()
  mma = _build.latent_mma(k)
  if mma:
    chunk = _build.latent_mma_chunk(
        S, B * Hkv * _build.latent_mma_tiles(G), _build.sm_count(q.device))
  else:
    chunk = _build.latent_chunk(
        S, B * Hkv * _build.latent_tiles(G), _build.sm_count(q.device))
  nsplit = -(-S // chunk)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nsplit, D) if nsplit > 1
          else (None,) * 4)
  if _build.is_meta(q):
    return o, m, l
  P = _build.ptr
  err = _build.library().flash_decode_latent_launch(
      P(q), P(k), P(v), P(bias), P(o), P(m), P(l), *map(P, part), B, Hkv,
      G, S, D, chunk, kv_sb, kv_sh, float(sm_scale), float(cap or 0.0), code,
      int(mma), _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[_build.branch(NAME, _build.LATENT)] += 1
  return o, m, l
