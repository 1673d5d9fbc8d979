"""Prefill wrapper: causal GQA flash attention over the prompt, with
optional softcap and sliding window (CUDA kernel ``csrc/flash_prefill.cu``;
replaces ``repro/kernels/flash_prefill.py``).

Takes the model layout directly — q (B, S, H, D), k/v (B, S, Hkv, D) — and
returns (B, S, H, D) in ``q.dtype``; the kernel masks the ragged query
tile and bounds each tile's KV loop by the causal frontier.

bf16 runs the tensor-core (wgmma) kernel, built for the head dims in
``WGMMA_HEAD_DIMS`` and GQA groups up to ``_build.GMAX``; f32 runs the
CUDA-core kernel at any D.  A bf16 shape the wgmma kernel does not take
raises: nothing falls back to the CUDA-core kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "flash_prefill"
# D = 192 (deepseek-v2's MLA prefill) and 256 (gemma2) run K/V tiles of 64
# keys instead of 128: their O accumulators take 96 and 128 f32 registers a
# thread, and the S / P fragment of a 64-key tile 64 more
# (csrc/flash_prefill.cu).
WGMMA_HEAD_DIMS = (16, 32, 64, 128, 192, 256)


def flash_prefill(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, S, Hkv, D)
    v: torch.Tensor,          # (B, S, Hkv, D)
    *,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
  """CPU tensors run the plain version; CUDA tensors launch the kernel;
  meta tensors allocate its output and launch nothing."""
  if q.device.type == "cpu":
    return ref.flash_prefill_ref(q, k, v, sm_scale=sm_scale, cap=cap,
                                 window=window)
  B, S, H, D = q.shape
  Hkv = k.shape[2]
  if H % Hkv or k.shape != (B, S, Hkv, D) or v.shape != k.shape:
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k{tuple(k.shape)} v{tuple(v.shape)}")
  if window is not None and window < 1:
    raise ValueError(f"{NAME}: window {window} < 1")
  code = _build.dtype_code(NAME, q, k, v)
  if q.dtype == torch.bfloat16:
    G = H // Hkv
    if D not in WGMMA_HEAD_DIMS or G > _build.GMAX:
      raise ValueError(
          f"{NAME}: the bf16 (wgmma) kernel is built for head dims "
          f"{WGMMA_HEAD_DIMS} and GQA groups up to {_build.GMAX}, got D={D}, "
          f"G={G}")
    _build.check_aligned(NAME, q, k, v)
  out = torch.empty_like(q)
  if _build.is_meta(q):
    return out
  P = _build.ptr
  err = _build.library().flash_prefill_launch(
      P(q), P(k), P(v), P(out), B, S, H, Hkv, D, float(sm_scale),
      float(cap or 0.0), int(window or 0), code, _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return out
