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

On a rank's shard (``dist.sharding.shard_params``) every leaf is held as
the rule table cuts it over ``ssm_heads``, evenly, not by segment:
``in_proj``'s 2 d_in + 2 n + h columns, the conv's d_in + 2 n channels
(a block may straddle x and B), the heads of ``A_log`` / ``D`` /
``dt_bias``, and d_in of ``norm`` and ``out_proj``.  So the mixer
all-gathers ``in_proj``'s output, runs the depthwise conv on the rank's
channel block (with its block of ``conv_state``) and all-gathers that,
runs the SSD for the rank's heads (its block of ``ssd_state``), sums the
gated norm's squares over all of d_in with one all-reduce, and row-cut
``out_proj`` ends in one all-reduce.  A leaf the rule leaves whole (the
divisibility fallback) takes no collective: the rank computes all of it,
or slices what its neighbours' cuts need.  The prefill's state comes out
global (every rank's cache is the whole prompt's); a decode step's is the
rank's block, as ``serve_step.shard_cache`` cuts the cache.  In the
training backward each replicated tensor that the rank's block reads
(``x`` into ``in_proj``'s columns, the projection into the conv's
channels and the heads, the conv's output, the norm's squares summed)
enters it through ``dist.sharding.enter``, which sums the ranks' partial
cotangents.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
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
  state); with it, S = 1 incremental decode from that state.  Whole
  weights or a rank's shard (see the module doc): with every cut axis ()
  each collective is the identity and each block the whole leaf."""
  s = cfg.ssm
  f = acc_dtype(x)
  B_, S_ = x.shape[:2]
  i_axes = shd.cut_axes(p, "in_proj", 1)
  zxbcdt = shd.all_gather_over(torch.matmul(
      shd.enter(x, i_axes), p["in_proj"].to(x.dtype)), i_axes, -1)
  c_axes = shd.cut_axes(p, "conv_w", 1)
  h_axes = shd.cut_axes(p, "A_log", 0)
  z, _, _, _, dt, d_in, h = _split_proj(shd.enter(zxbcdt, h_axes), cfg)
  _, xin, Bs, Cs, _, _, _ = _split_proj(shd.enter(zxbcdt, c_axes), cfg)
  xbc = torch.cat([xin, Bs, Cs], dim=-1)

  # The depthwise conv on the rank's channel block.
  n_ch = p["conv_w"].shape[1]
  c0 = shd.block_start(c_axes, n_ch)
  conv_state = decode_state[0] if decode_state is not None else None
  if conv_state is not None and conv_state.shape[-1] != n_ch:
    raise ValueError(f"conv_state holds {conv_state.shape[-1]} channels, "
                     f"the rank's conv {n_ch}: cut the cache with "
                     "serve_step.shard_cache under the same rules")
  conv_out, new_conv = _causal_conv(xbc[..., c0:c0 + n_ch],
                                    p["conv_w"].to(f), p["conv_b"].to(f),
                                    conv_state)
  conv_out = shd.all_gather_over(conv_out, c_axes, -1)
  if decode_state is None and c_axes:        # the prompt's whole state
    K = p["conv_w"].shape[0]
    new_conv = torch.cat([xbc.new_zeros((B_, K - 1, xbc.shape[-1])), xbc],
                         dim=1)[:, S_:]
  xin, Bs, Cs = torch.split(shd.enter(conv_out, h_axes),
                            [d_in, s.d_state, s.d_state], dim=-1)

  # The SSD for the rank's heads.
  hl = p["A_log"].shape[0]
  h0 = shd.block_start(h_axes, hl)
  P = s.head_dim
  xh = xin.reshape(B_, S_, h, P)[:, :, h0:h0 + hl]
  A = -torch.exp(p["A_log"].to(f))
  dt = dt[..., h0:h0 + hl].to(f) + p["dt_bias"].to(f)
  dt = torch.logaddexp(dt, torch.zeros_like(dt))             # softplus
  if decode_state is not None and decode_state[1].shape[1] != hl:
    raise ValueError(f"ssd_state holds {decode_state[1].shape[1]} heads, "
                     f"the rank's SSD {hl}: cut the cache with "
                     "serve_step.shard_cache under the same rules")
  y, ssd_state = _ssd(xh, dt, A, Bs, Cs, s, decode_state)
  if decode_state is None:
    ssd_state = shd.all_gather_over(ssd_state, h_axes, 1)
  y = y + xh * p["D"].to(f)[:, None]
  y = y.reshape(B_, S_, hl * P) * F.silu(z[..., h0 * P:(h0 + hl) * P].to(f))

  # The gated norm over all of d_in: where the rank holds some heads, its
  # squares summed by one all-reduce.
  n_axes = shd.cut_axes(p, "norm", 0)
  w = p["norm"]
  if not (n_axes and n_axes == h_axes):     # not already the rank's block
    w = shd.enter(shd.all_gather_over(w, n_axes, 0),
                  h_axes)[h0 * P:(h0 + hl) * P]
  if not h_axes:
    y = rms_norm(y.to(x.dtype), w, cfg.norm_eps)
  else:
    # The sum is replicated, and each rank's heads read it: its backward
    # sums the ranks' partial cotangents too.
    yf = y.to(x.dtype).to(f)
    sq = shd.enter(shd.all_reduce_over(yf.pow(2).sum(-1, keepdim=True),
                                       h_axes), h_axes)
    yf = yf * torch.rsqrt(sq / d_in + cfg.norm_eps)
    y = (yf * (1.0 + w.to(f))).to(x.dtype)

  # out_proj: row-cut, or the rank's y gathered where it is whole.
  o_axes = shd.cut_axes(p, "out_proj", 0)
  if o_axes and o_axes != h_axes:
    y = shd.enter(shd.all_gather_over(y, h_axes, -1), o_axes)
    rows = p["out_proj"].shape[0]
    o0 = shd.block_start(o_axes, rows)
    y = y[..., o0:o0 + rows]
  elif not o_axes:
    y = shd.all_gather_over(y, h_axes, -1)
  out = torch.matmul(y, p["out_proj"].to(x.dtype))
  return shd.all_reduce_over(out, o_axes), (new_conv, ssd_state)


def _ssd(xh, dt, A, Bs, Cs, s, decode_state):
  """The SSD over xh's heads: the chunked scan (prefill) or one step from
  ``decode_state[1]``; (y (B, S, h, p), the new state (B, h, p, n))."""
  f = xh.dtype

  if decode_state is None:
    return ssd_chunked(xh, dt, A, Bs, Cs, s.chunk)
  st = decode_state[1].to(f)                                 # (B,h,p,n)
  dA = torch.exp(dt[:, 0] * A)                               # (B,h)
  dBx = (dt[:, 0, :, None] * xh[:, 0])[..., None] * Bs[:, 0, None, None]
  ssd_state = st * dA[:, :, None, None] + dBx
  y = torch.einsum("bn,bhpn->bhp", Cs[:, 0], ssd_state)[:, None]
  return y, ssd_state
