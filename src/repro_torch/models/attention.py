"""GQA attention blocks (counterpart of ``repro.models.attention``, dense
GQA with rope, an optional logit softcap and, on local layers, a sliding
window).  Weights keep the JAX layouts: wq (d, H, hd),
wk/wv (d, Hkv, hd), wo (H, hd, d)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rope


def causal_mix(q, k, v, *, sm_scale: float, window: Optional[int] = None,
               cap: Optional[float] = None) -> torch.Tensor:
  """Causal self-attention over the prompt: the flash prefill kernel on
  CUDA tensors, its plain version on CPU tensors."""
  return ops.prefill_attention(q, k, v, sm_scale=sm_scale, cap=cap,
                               window=window)


def _proj(x, w):
  """x (..., d) @ w (d, *rest) -> (..., *rest) in x.dtype."""
  y = torch.matmul(x, w.reshape(w.shape[0], -1).to(x.dtype))
  return y.reshape(*x.shape[:-1], *w.shape[1:])


def qkv(x, p, cfg: ModelConfig, positions):
  """x (B, S, d) -> rope'd q (B,S,H,hd), rope'd k (B,S,Hkv,hd) and v."""
  q = rope(_proj(x, p["wq"]), positions, cfg.rope_theta)
  k = rope(_proj(x, p["wk"]), positions, cfg.rope_theta)
  v = _proj(x, p["wv"])
  return q, k, v


def out_proj(o, p, x_dtype):
  """o (B, S, H, hd) -> (B, S, d) in ``x_dtype``."""
  wo = p["wo"]
  H, hd, d = wo.shape
  return torch.matmul(o.to(x_dtype).reshape(*o.shape[:-2], H * hd),
                      wo.reshape(H * hd, d).to(x_dtype))


def attention_train(x, p, cfg: ModelConfig, positions, *,
                    local: bool = False):
  """Full-sequence causal self-attention (the prefill branch), over the
  last ``cfg.sliding_window`` positions on a ``local`` layer.  Returns
  (y (B, S, d), (k, v)) with k/v in the decode layout (B, Hkv, S, D)."""
  q, k, v = qkv(x, p, cfg, positions)
  o = causal_mix(q, k, v, sm_scale=cfg.hd ** -0.5,
                 window=cfg.sliding_window if local else None,
                 cap=cfg.attn_softcap)
  y = out_proj(o, p, x.dtype)
  return y, (k.transpose(1, 2), v.transpose(1, 2))
