"""Shared neural building blocks (counterpart of ``repro.models.layers``)."""
from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
  """RMS norm with a zero-initialised gain: ``x * rsqrt(mean x^2) * (1 + w)``
  in f32, cast back to ``x.dtype``."""
  dt = x.dtype
  xf = x.float()
  xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
  return (xf * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
  """Half-split rotary embedding.  x (..., S, H, D), positions (..., S);
  ``freq_i = theta^(-i / half)``."""
  d = x.shape[-1]
  half = d // 2
  freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) / half)
  ang = positions[..., None].float() * freq                   # (..., S, half)
  cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
  x1, x2 = x[..., :half].float(), x[..., half:].float()
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
  if cap is None:
    return x
  return cap * torch.tanh(x / cap)


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
  """SwiGLU MLP: ``(silu(x w1) * (x w3)) w2`` with the gate in f32."""
  h = torch.matmul(x, w1.to(x.dtype)).float()
  g = torch.matmul(x, w3.to(x.dtype)).float()
  h = (torch.nn.functional.silu(h) * g).to(x.dtype)
  return torch.matmul(h, w2.to(x.dtype))
