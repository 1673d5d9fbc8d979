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


def flash_decode(
    q: torch.Tensor,                       # (B, H, D)
    k: torch.Tensor,                       # (B, Hkv, S, D)
    v: torch.Tensor,                       # (B, Hkv, S, D)
    bias: Optional[torch.Tensor] = None,   # (B, Hkv, S) f32, after the cap
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
):
  """Returns partials (o (B,H,D) f32 normalised, m (B,H), l (B,H)).

  CPU tensors run the plain version; CUDA tensors launch the kernel."""
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
  code = _build.dtype_code(NAME, q, k, v)
  _build.check_rows(NAME, D, G, k)
  f32 = dict(dtype=torch.float32, device=q.device)
  if bias is not None:
    bias = bias.to(**f32).contiguous()
  chunk = _chunk(S, D, k.element_size(), B * Hkv,
                 torch.cuda.get_device_properties(q.device)
                 .multi_processor_count)
  nsplit = -(-S // chunk)
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  part = (_build.partials(q.device, B * H, nsplit, D) if nsplit > 1
          else (None,) * 4)
  P = _build.ptr
  err = _build.library().flash_decode_launch(
      P(q), P(k), P(v), P(bias), P(o), P(m), P(l), *map(P, part), B, Hkv,
      G, S, D, chunk, float(sm_scale), float(cap or 0.0), code,
      _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return o, m, l
