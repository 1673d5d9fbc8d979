"""Mamba-2 SSD sequence mixer (counterpart of ``repro.models.ssm``;
state-space duality, arXiv:2405.21060).

The prefill runs the chunked SSD algorithm: quadratic within chunks of
``cfg.ssm.chunk`` tokens, linear state passing between chunks (a Python
loop over the chunks in place of ``lax.scan``).  Decode (S = 1) is the
O(1)-state recurrence on ``(conv_state, ssd_state)``.

Layout: d_inner = expand * d_model; h = d_inner / head_dim heads, state n
per head.  Weights keep the JAX layouts: in_proj (d, 2 d_inner + 2 n + h)
splitting into [z, x, B, C, dt], conv_w (d_conv, conv_dim), conv_b, A_log
/ D / dt_bias (h,), norm (d_inner,), out_proj (d_inner, d).

Plain PyTorch on every device, as the reference is plain JAX (no Pallas
kernel).  The scan, the conv and the state update compute in f32 (float64
for float64 activations, ``kernels.ref.acc_dtype``).  Those f32 products
must not run in TF32 on the card: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` False (torch's default).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import acc_dtype
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
  """(..., 2 d_in + 2 n + h) -> z, x, B, C, dt, d_in, h."""
  s = cfg.ssm
  d_in = s.expand * cfg.d_model
  h = d_in // s.head_dim
  z, x, Bs, Cs, dt = torch.split(
      zxbcdt, [d_in, d_in, s.d_state, s.d_state, h], dim=-1)
  return z, x, Bs, Cs, dt, d_in, h


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
  """Depthwise causal conv1d.  u (B, S, C), w (K, C), b (C,) in the
  compute dtype.  Returns (silu(y) in w's dtype, new state): the state is
  the last K-1 inputs, in u's dtype (zeros before the prompt)."""
  K, S = w.shape[0], u.shape[1]
  if state is None:
    state = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
  ext = torch.cat([state.to(u.dtype), u], dim=1)            # (B, S+K-1, C)
  y = ext[:, 0:S] * w[0]
  for i in range(1, K):
    y = y + ext[:, i:i + S] * w[i]
  return F.silu(y + b), ext[:, S:]


def ssd_chunked(x, dt, A, Bs, Cs, chunk: int):
  """Chunked SSD scan.  x (b, s, h, p), dt (b, s, h) [post-softplus], A
  (h,) [negative], Bs / Cs (b, s, n), all in one float dtype.  Returns y
  (b, s, h, p) and the final state (b, h, p, n).

  The future pairs' mask goes into the exponent (-inf) before ``exp``, as
  in the reference: their exponents are positive and would overflow."""
  b, s, h, p = x.shape
  n = Bs.shape[-1]
  L = min(chunk, s)
  if s % L:
    raise ValueError(f"sequence length {s} is not a multiple of the chunk "
                     f"{L}")
  nc = s // L
  xc = x.reshape(b, nc, L, h, p)
  dtc = dt.reshape(b, nc, L, h)
  Bc = Bs.reshape(b, nc, L, n)
  Cc = Cs.reshape(b, nc, L, n)

  cum = torch.cumsum(dtc * A, dim=2)                         # (b,nc,L,h)
  total = cum[:, :, -1]                                      # (b,nc,h)

  # Intra-chunk: y_ij = C_i . B_j exp(cum_i - cum_j) dt_j x_j, j <= i.  The
  # (b, nc, L, L, h) weights are built in one buffer, in place, unless
  # autograd records the scan (training), which needs each intermediate.
  w = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (b,nc,L,L,h)
  future = ~torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
  cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
  if torch.is_grad_enabled():
    w = w.masked_fill(future[:, :, None], float("-inf")).exp() * cb \
        * dtc[:, :, None]
  else:
    w.masked_fill_(future[:, :, None], float("-inf")).exp_()
    w.mul_(cb)
    w.mul_(dtc[:, :, None])
  y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
  del w

  # Chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j x_j.
  sdec = torch.exp(total[:, :, None] - cum) * dtc            # (b,nc,L,h)
  states = torch.einsum("bcln,bclhp->bchpn", Bc, sdec[..., None] * xc)

  # Inter-chunk recurrence: the state entering chunk c, then the final.
  st = x.new_zeros((b, h, p, n))
  prevs = []
  for c in range(nc):
    prevs.append(st)
    st = st * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
  prev = torch.stack(prevs, dim=1)                           # (b,nc,h,p,n)
  y += torch.einsum("bcln,bchpn->bclhp", Cc, prev) * torch.exp(cum)[..., None]
  return y.reshape(b, s, h, p), st


def ssm_forward(x: torch.Tensor, p, cfg: ModelConfig, *,
                decode_state: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None):
  """x (B, S, d) -> (y (B, S, d) in x's dtype, (conv_state (B, K-1,
  conv_dim) in x's dtype, ssd_state (B, h, p, n) in the compute dtype)).
  Without ``decode_state`` the prefill (the chunked scan from a zero
  state); with it, S = 1 incremental decode from that state."""
  s = cfg.ssm
  f = acc_dtype(x)
  zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
  z, xin, Bs, Cs, dt, d_in, h = _split_proj(zxbcdt, cfg)

  conv_state = decode_state[0] if decode_state is not None else None
  conv_out, new_conv = _causal_conv(torch.cat([xin, Bs, Cs], dim=-1),
                                    p["conv_w"].to(f), p["conv_b"].to(f),
                                    conv_state)
  xin, Bs, Cs = torch.split(conv_out, [d_in, s.d_state, s.d_state], dim=-1)

  B_, S_ = x.shape[:2]
  xh = xin.reshape(B_, S_, h, s.head_dim)
  A = -torch.exp(p["A_log"].to(f))                           # (h,)
  dt = dt.to(f) + p["dt_bias"].to(f)
  dt = torch.logaddexp(dt, torch.zeros_like(dt))             # softplus

  if decode_state is None:
    y, ssd_state = ssd_chunked(xh, dt, A, Bs, Cs, s.chunk)
  else:
    st = decode_state[1].to(f)                               # (B,h,p,n)
    dA = torch.exp(dt[:, 0] * A)                             # (B,h)
    dBx = (dt[:, 0, :, None] * xh[:, 0])[..., None] * Bs[:, 0, None, None]
    ssd_state = st * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cs[:, 0], ssd_state)[:, None]

  y = y + xh * p["D"].to(f)[:, None]
  y = y.reshape(B_, S_, d_in) * F.silu(z.to(f))
  y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
  out = torch.matmul(y, p["out_proj"].to(x.dtype))
  return out, (new_conv, ssd_state)
