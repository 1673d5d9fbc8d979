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
  (``jax.nn.gelu``'s default; torch's default is the erf form).  ``b2``
  None leaves it out (a row-cut ``w2`` adds it after its all-reduce)."""
  dt = x.dtype
  h = torch.matmul(x, w1.to(dt)) + b1.to(dt)
  h = torch.nn.functional.gelu(h.to(acc_dtype(h)), approximate="tanh").to(dt)
  y = torch.matmul(h, w2.to(dt))
  return y if b2 is None else y + b2.to(dt)


# Query rows per chunk of :func:`causal_attention`, as the reference's.
Q_CHUNK = 512


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     sm_scale: float, window: Optional[int] = None,
                     attn_softcap: Optional[float] = None,
                     q_chunk: int = Q_CHUNK,
                     causal_skip: bool = False) -> torch.Tensor:
  """Blockwise causal GQA attention, differentiable (the training path's,
  ``repro.models.layers.causal_attention``): q (B, S, H, D), k / v (B, S,
  Hkv, D) -> (B, S, H, D) in q's dtype.  Per chunk of ``q_chunk`` queries,
  logits in f32 from q and k cast to f32, the softcap, the causal (and
  sliding-window) mask as -1e30, softmax, and p.v in f32; never the whole
  S x S matrix at once.  The training forward recomputes each layer in
  the backward, so the chunks' softmaxes live only while their layer's
  backward runs (B * H * S^2 f32 words: 1.2 GB at smollm-135m's 8 x 2048);
  the reference also remats each chunk, which would run the attention's
  forward a third time.  ``causal_skip`` restricts each chunk's keys to
  [hi - span, hi)."""
  B, S, H, D = q.shape
  Hkv = k.shape[2]
  q_chunk = min(q_chunk, S)
  if S % q_chunk:
    raise ValueError(f"sequence length {S} is not a multiple of the query "
                     f"chunk {q_chunk}")
  nq = S // q_chunk
  f = acc_dtype(q)
  qg = q.reshape(B, S, Hkv, H // Hkv, D)
  pos = torch.arange(S, device=q.device)

  def one_chunk(i):
    qi = qg[:, i * q_chunk:(i + 1) * q_chunk]
    qpos = pos[i * q_chunk:(i + 1) * q_chunk]
    if causal_skip:
      hi = (i + 1) * q_chunk
      span = S if window is None else min(
          S, ((window + q_chunk - 1) // q_chunk + 1) * q_chunk)
      lo = max(hi - span, 0)
      ki, vi, kpos = k[:, lo:lo + span], v[:, lo:lo + span], \
          pos[lo:lo + span]
    else:
      ki, vi, kpos = k, v, pos
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qi.to(f), ki.to(f)) * sm_scale
    logits = softcap(logits, attn_softcap)
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
      mask &= (qpos[:, None] - kpos[None, :]) < window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    oi = torch.einsum("bhgqk,bkhd->bqhgd", p, vi.to(f))
    return oi.reshape(B, q_chunk, H, D).to(q.dtype)

  if nq == 1:
    return one_chunk(0)
  return torch.cat([one_chunk(i) for i in range(nq)], dim=1)
