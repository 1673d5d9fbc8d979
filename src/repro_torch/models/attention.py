"""Attention blocks (counterpart of ``repro.models.attention``): dense GQA
with rope, an optional logit softcap and, on local layers, a sliding
window; whisper's attention biases and its non-causal cross attention;
deepseek's multi-head latent attention (MLA).  Weights keep the JAX
layouts: wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d), and with
``cfg.attn_bias`` bq (H, hd) and bo (d,); MLA's wq_a (d, q_lora), q_norm
(q_lora,), wq_b (q_lora, H, nope + rope), wkv_a (d, kv_lora + rope),
kv_norm (kv_lora,), wk_b (kv_lora, H, nope), wv_b (kv_lora, H, v_dim), wo
(H, v_dim, d).

MLA's latent cache is itself a learned synopsis: the decode cache holds
one row of kv_lora + rope (576 at deepseek-v2's width) a token, shared by
every head, and AccuracyTrader's clusters stack on top of it.

On a rank's shard (``dist.sharding.shard_params``) the query side is cut
over ``heads``: ``wq`` and ``bq`` (MLA: ``wq_b``, ``wk_b``, ``wv_b``) hold
the rank's query heads, ``wo`` their rows, and :func:`out_proj` sums the
ranks' partial outputs with one all-reduce before ``bo``.  ``wk`` and
``wv`` stay whole under the serving tables (``kv_heads`` is None there):
every rank computes every KV head, so the prompt's KV comes out global
with no collective, and each rank attends with the KV heads of its own
query heads' groups (:func:`kv_heads_for`).  The training table cuts
``kv_heads`` too where they divide: the rank's KV heads are then those of
its query heads, and the training path (``train=True``) attends with them
directly.  Where a replicated activation enters the rank's heads,
``dist.sharding.enter`` sums the ranks' partial cotangents in the
backward."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import acc_dtype
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import causal_attention, rms_norm, rope


def causal_mix(q, k, v, *, sm_scale: float, window: Optional[int] = None,
               cap: Optional[float] = None, train: bool = False,
               causal_skip: bool = False) -> torch.Tensor:
  """Causal self-attention over the prompt: the flash prefill kernel on
  CUDA tensors, its plain version on CPU tensors.  ``train`` takes the
  training path's differentiable ``layers.causal_attention`` on any device
  instead (the reference's ``impl=None``): the kernel has no backward, so
  its output would carry no gradient to q, k and v."""
  if train:
    return causal_attention(q, k, v, sm_scale=sm_scale, window=window,
                            attn_softcap=cap, causal_skip=causal_skip)
  return ops.prefill_attention(q, k, v, sm_scale=sm_scale, cap=cap,
                               window=window)


def heads_cut(p, name: str = "wq", kv_cut: bool = False):
  """(mesh axes, first global head) of the query heads a rank's shard
  holds: ``name``'s heads dim (``wq``; MLA ``wq_b``) cut over the axes, or
  ((), 0) where the heads are whole.  A cut ``wk`` (a table that cuts
  ``kv_heads``: the training table) is refused unless ``kv_cut``: no
  serving table cuts it, and the prompt's KV would come out cut."""
  kv_axes = shd.cut_axes(p, "wk", 1)
  if kv_axes and not kv_cut:
    raise NotImplementedError("kv_heads cut over the mesh: the serving "
                              "tables keep wk / wv whole")
  axes = shd.cut_axes(p, name, 1)
  if kv_axes and kv_axes != axes:
    raise NotImplementedError(f"kv_heads cut over {kv_axes}, the query "
                              f"heads over {axes}: a rank's KV heads must be "
                              "those of its query heads")
  return axes, shd.block_start(axes, p[name].shape[1])


def kv_heads_for(k, v, h0: int, n_heads: int, group: int, dim: int):
  """The KV heads of the query heads [h0, h0 + n_heads) (G = ``group``
  query heads a KV head) along ``dim`` of k and v: a slice where the heads
  are whole groups or lie in one group, else each query head's KV head
  gathered (G = 1)."""
  if (n_heads % group == 0 and h0 % group == 0) or \
      h0 // group == (h0 + n_heads - 1) // group:
    n = max(n_heads // group, 1)
    return k.narrow(dim, h0 // group, n), v.narrow(dim, h0 // group, n)
  idx = torch.arange(h0, h0 + n_heads, device=k.device) // group
  return k.index_select(dim, idx), v.index_select(dim, idx)


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
  params have it; a row-cut ``wo`` (the rank's H heads) sums the ranks'
  partial products with one all-reduce first."""
  wo = p["wo"]
  H, hd, d = wo.shape
  y = torch.matmul(o.to(x_dtype).reshape(*o.shape[:-2], H * hd),
                   wo.reshape(H * hd, d).to(x_dtype))
  y = shd.all_reduce_over(y, shd.cut_axes(p, "wo", 0))
  return y + p["bo"].to(x_dtype) if "bo" in p else y


def attention_train(x, p, cfg: ModelConfig, positions, *,
                    local: bool = False, train: bool = False,
                    causal_skip: bool = False):
  """Full-sequence causal self-attention (the prefill branch, or with
  ``train`` the training path's: :func:`causal_mix`), over the last
  ``cfg.sliding_window`` positions on a ``local`` layer.  Returns (y (B,
  S, d), (k, v)) with k/v in the decode layout (B, Hkv, S, D): on the
  training path with cut KV heads, the rank's."""
  axes, h0 = heads_cut(p, kv_cut=train)
  xq = shd.enter(x, axes)
  q = rope(query(xq, p), positions, cfg.rope_theta)
  own_kv = bool(shd.cut_axes(p, "wk", 1))       # the rank's KV heads
  xk = xq if own_kv else x
  k = rope(_proj(xk, p["wk"]), positions, cfg.rope_theta)
  v = _proj(xk, p["wv"])
  kq, vq = k, v
  if axes and not own_kv:
    kq, vq = kv_heads_for(shd.enter(k, axes), shd.enter(v, axes), h0,
                          q.shape[2], cfg.n_heads // cfg.n_kv_heads, 2)
  o = causal_mix(q, kq, vq, sm_scale=cfg.hd ** -0.5,
                 window=cfg.sliding_window if local else None,
                 cap=cfg.attn_softcap, train=train, causal_skip=causal_skip)
  y = out_proj(o, p, x.dtype)
  return y, (k.transpose(1, 2), v.transpose(1, 2))


# Query rows per chunk of :func:`cross_attention`: at whisper-medium's
# width (B = 2, 16 heads) 1024 queries against 1500 frames are 197 MB of
# f32 logits, where all 8192 of a prompt at once would be 1.57 GB.
CROSS_Q_CHUNK = 1024


def cross_attention(x, p, cfg: ModelConfig, src, *, train: bool = False):
  """Non-causal attention of x (B, S, d) over src (B, T, d), the JAX
  ``attention_train`` branch with ``enc_out`` (whisper's cross attention,
  and its encoder with ``src = x``): no rope and no ``bq`` (the reference
  adds neither there), logits in f32 from q and k rounded to ``x.dtype``,
  softmax and p.v in f32, then ``out_proj`` with ``bo``.  Plain
  ``torch.matmul``, as the JAX package computes it outside any kernel,
  over chunks of :data:`CROSS_Q_CHUNK` query rows.  Returns (y (B, S, d),
  (k, v) in the decode layout (B, Hkv, T, D)); ``train`` takes cut KV
  heads, as :func:`attention_train`."""
  axes, h0 = heads_cut(p, kv_cut=train)
  own_kv = bool(shd.cut_axes(p, "wk", 1))
  q = _proj(shd.enter(x, axes), p["wq"])
  src = shd.enter(src, axes) if own_kv else src
  k = _proj(src, p["wk"]).transpose(1, 2)                     # (B,Hkv,T,D)
  v = _proj(src, p["wv"]).transpose(1, 2)
  B, S, H, D = q.shape
  kq, vq = k, v
  if axes and not own_kv:
    kq, vq = kv_heads_for(shd.enter(k, axes), shd.enter(v, axes), h0, H,
                          cfg.n_heads // cfg.n_kv_heads, 1)
  Hkv = kq.shape[1]
  f = acc_dtype(x)
  kf, vf = kq.to(f), vq.to(f)
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


# -- MLA (deepseek-v2) ---------------------------------------------------------

def mla_latent(x, p, cfg: ModelConfig, positions):
  """The latent cache entries of x (B, S, d): (c_kv (B, S, kv_lora),
  rms-normed with ``kv_norm``; k_pe (B, S, rope), rope'd at
  ``positions``), in x's dtype."""
  m = cfg.mla
  kv = _proj(x, p["wkv_a"])
  c_kv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
  k_pe = rope(kv[..., m.kv_lora_rank:][:, :, None, :], positions,
              cfg.rope_theta)[:, :, 0]
  return c_kv, k_pe


def mla_queries(x, p, cfg: ModelConfig, positions):
  """(q_nope (B, S, H, nope), q_pe (B, S, H, rope) rope'd): x through the
  ``wq_a`` bottleneck, ``q_norm``, then ``wq_b``, in x's dtype."""
  m = cfg.mla
  ql = rms_norm(_proj(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
  q = _proj(shd.enter(ql, shd.cut_axes(p, "wq_b", 1)), p["wq_b"])
  return q[..., :m.qk_nope_dim], rope(q[..., m.qk_nope_dim:], positions,
                                      cfg.rope_theta)


def v_pad(v, dim: int):
  """v (..., Dv) zero-padded to (..., dim), so that q, k and v share the
  prefill kernel's head dim."""
  if v.shape[-1] == dim:
    return v
  return torch.nn.functional.pad(v, (0, dim - v.shape[-1]))


def mla_train(x, p, cfg: ModelConfig, positions, *, train: bool = False,
              causal_skip: bool = False):
  """MLA over the prompt, not absorbed (the JAX ``mla_train``): per-head
  keys [c_kv wk_b, k_pe] and values c_kv wv_b, causal attention through
  :func:`causal_mix` at D = nope + rope (192 at full width) with G = 1, v
  zero-padded to D and sliced back to ``v_head_dim``, the softmax scale
  (nope + rope)^-0.5; then ``wo``.  Returns (y (B, S, d), (lat, lat)):
  the latent [c_kv, k_pe] as the decode cache's one key/value head (B,
  1, S, kv_lora + rope), given as both k and v, as in JAX.  ``train``
  and ``causal_skip`` as in :func:`attention_train`."""
  m = cfg.mla
  axes = shd.cut_axes(p, "wq_b", 1)
  q_nope, q_pe = mla_queries(x, p, cfg, positions)
  c_kv, k_pe = mla_latent(x, p, cfg, positions)
  ce = shd.enter(c_kv, axes)
  k_nope = _proj(ce, p["wk_b"])                               # (B,S,H,nope)
  v = _proj(ce, p["wv_b"])                                    # (B,S,H,vd)
  q = torch.cat([q_nope, q_pe], dim=-1)
  k = torch.cat([k_nope, shd.enter(k_pe, axes)[:, :, None].expand(
      *q_pe.shape)], dim=-1)
  del k_nope
  o = causal_mix(q, k, v_pad(v, q.shape[-1]),
                 sm_scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5,
                 train=train, causal_skip=causal_skip)
  del q, k, v
  y = out_proj(o[..., :m.v_head_dim], p, x.dtype)
  lat = torch.cat([c_kv, k_pe], dim=-1)[:, None]              # (B,1,S,Dk)
  return y, (lat, lat)
