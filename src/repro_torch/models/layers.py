"""Shared neural building blocks (counterpart of ``repro.models.layers``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import acc_dtype


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
  """RMS norm with a zero-initialised gain: ``x * rsqrt(mean x^2) * (1 + w)``
  in f32 (float64 for float64 ``x``), cast back to ``x.dtype``."""
  dt, f = x.dtype, acc_dtype(x)
  xf = x.to(f)
  xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
  return (xf * (1.0 + w.to(f))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
  """Half-split rotary embedding.  x (..., S, H, D), positions (..., S);
  ``freq_i = theta^(-i / half)``."""
  d = x.shape[-1]
  half = d // 2
  f = acc_dtype(x)
  freq = theta ** (-torch.arange(0, half, dtype=f, device=x.device) / half)
  ang = positions[..., None].to(f) * freq                     # (..., S, half)
  cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
  x1, x2 = x[..., :half].to(f), x[..., half:].to(f)
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
  if cap is None:
    return x
  return cap * torch.tanh(x / cap)


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
  """SwiGLU MLP: ``(silu(x w1) * (x w3)) w2`` with the gate in f32."""
  f = acc_dtype(x)
  h = torch.matmul(x, w1.to(x.dtype)).to(f)
  g = torch.matmul(x, w3.to(x.dtype)).to(f)
  h = (torch.nn.functional.silu(h) * g).to(x.dtype)
  return torch.matmul(h, w2.to(x.dtype))


def gelu_mlp(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
  """GELU MLP with biases: ``gelu(x w1 + b1) w2 + b2``, each product and
  sum in ``x.dtype``, the GELU in f32 with the tanh approximation
  (``jax.nn.gelu``'s default; torch's default is the erf form)."""
  dt = x.dtype
  h = torch.matmul(x, w1.to(dt)) + b1.to(dt)
  h = torch.nn.functional.gelu(h.to(acc_dtype(h)), approximate="tanh").to(dt)
  return torch.matmul(h, w2.to(dt)) + b2.to(dt)
