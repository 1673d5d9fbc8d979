"""GQA attention blocks (counterpart of ``repro.models.attention``, dense
GQA with rope, an optional logit softcap and, on local layers, a sliding
window; whisper's attention biases and its non-causal cross attention).
Weights keep the JAX layouts: wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H,
hd, d), and with ``cfg.attn_bias`` bq (H, hd) and bo (d,)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import acc_dtype
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


def query(x, p):
  """x (B, S, d) -> q (B, S, H, hd), plus ``bq`` where the params have
  it; no rope."""
  q = _proj(x, p["wq"])
  return q + p["bq"].to(x.dtype) if "bq" in p else q


def qkv(x, p, cfg: ModelConfig, positions):
  """x (B, S, d) -> rope'd q (B,S,H,hd) (``bq`` added before rope), rope'd
  k (B,S,Hkv,hd) and v."""
  q = rope(query(x, p), positions, cfg.rope_theta)
  k = rope(_proj(x, p["wk"]), positions, cfg.rope_theta)
  v = _proj(x, p["wv"])
  return q, k, v


def out_proj(o, p, x_dtype):
  """o (B, S, H, hd) -> (B, S, d) in ``x_dtype``, plus ``bo`` where the
  params have it."""
  wo = p["wo"]
  H, hd, d = wo.shape
  y = torch.matmul(o.to(x_dtype).reshape(*o.shape[:-2], H * hd),
                   wo.reshape(H * hd, d).to(x_dtype))
  return y + p["bo"].to(x_dtype) if "bo" in p else y


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


# Query rows per chunk of :func:`cross_attention`: at whisper-medium's
# width (B = 2, 16 heads) 1024 queries against 1500 frames are 197 MB of
# f32 logits, where all 8192 of a prompt at once would be 1.57 GB.
CROSS_Q_CHUNK = 1024


def cross_attention(x, p, cfg: ModelConfig, src):
  """Non-causal attention of x (B, S, d) over src (B, T, d), the JAX
  ``attention_train`` branch with ``enc_out`` (whisper's cross attention,
  and its encoder with ``src = x``): no rope and no ``bq`` (the reference
  adds neither there), logits in f32 from q and k rounded to ``x.dtype``,
  softmax and p.v in f32, then ``out_proj`` with ``bo``.  Plain
  ``torch.matmul``, as the JAX package computes it outside any kernel,
  over chunks of :data:`CROSS_Q_CHUNK` query rows.  Returns (y (B, S, d),
  (k, v) in the decode layout (B, Hkv, T, D))."""
  q = _proj(x, p["wq"])
  k = _proj(src, p["wk"]).transpose(1, 2)                     # (B,Hkv,T,D)
  v = _proj(src, p["wv"]).transpose(1, 2)
  B, S, H, D = q.shape
  Hkv = k.shape[1]
  f = acc_dtype(x)
  kf, vf = k.to(f), v.to(f)
  qg = q.transpose(1, 2).reshape(B, Hkv, H // Hkv, S, D)
  o = torch.empty((B, Hkv, H // Hkv, S, D), dtype=x.dtype, device=x.device)
  for s0 in range(0, S, CROSS_Q_CHUNK):
    qc = qg[:, :, :, s0:s0 + CROSS_Q_CHUNK].to(f)
    w = torch.softmax(torch.einsum("bhgsd,bhtd->bhgst", qc, kf)
                      * cfg.hd ** -0.5, dim=-1)
    o[:, :, :, s0:s0 + CROSS_Q_CHUNK] = torch.einsum("bhgst,bhtd->bhgsd", w,
                                                     vf)
  o = o.reshape(B, H, S, D).transpose(1, 2)
  return out_proj(o, p, x.dtype), (k, v)
