"""Decode (serve) step: one new token against a synopsis KV cache
(counterpart of ``repro.serve.serve_step``, ``mode="synopsis"``).

Per attention layer the AccuracyTrader decode attention runs the fused
two-stage pipeline of ``kernels.ops.synopsis_cache_attention``: stage-1
centroid scoring plus the count-biased initial result, ``top_k`` over the
scores, stage-2 exact refinement over the selected clusters with the
recent ring and the new token's self-KV folded in, one merge.  The cache is
read-only inside the step; the new token's per-layer KV comes back as
``k_delta``/``v_delta`` for the loop to append.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu

LAYER_LEAVES = ("k", "v", "k_syn", "v_syn", "counts", "recent_k",
                "recent_v")


def synopsis_decode_attention(
    q: torch.Tensor,                      # (B, H, D) rope'd queries
    cache: Dict[str, torch.Tensor],       # this layer's slice
    *,
    i_max: int,
    cluster_size: int,
    sm_scale: float,
    self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
  """AccuracyTrader Algorithm 1 on a KV cache; returns (B, H, D) f32."""
  self_k, self_v = self_kv if self_kv is not None else (None, None)
  return ops.synopsis_cache_attention(
      q, cache["k"], cache["v"], cache["k_syn"], cache["v_syn"],
      cache["counts"], cache.get("recent_k"), cache.get("recent_v"),
      cache.get("recent_len"), self_k, self_v, i_max=i_max,
      cluster_size=cluster_size, sm_scale=sm_scale)


def _attn_decode_layer(x, lp, cfg: ModelConfig, cache_sl, pos, i_max: int):
  """x (B, 1, d) -> (y (B, 1, d), (k, v) of the new token (B, Hkv, 1, D))."""
  q, k_new, v_new = attn_lib.qkv(x, lp, cfg, pos[:, None])
  kd = k_new.transpose(1, 2)                                  # (B,Hkv,1,D)
  vd = v_new.transpose(1, 2)
  ctx = synopsis_decode_attention(
      q[:, 0], cache_sl, i_max=i_max,
      cluster_size=cfg.synopsis.cluster_size, sm_scale=cfg.hd ** -0.5,
      self_kv=(kd, vd))
  y = attn_lib.out_proj(ctx[:, None].to(x.dtype), lp, x.dtype)
  return y, (kd, vd)


def make_serve_step(cfg: ModelConfig, *, mode: str = "synopsis",
                    i_max: Optional[int] = None):
  """Returns serve_step(params, cache, tokens (B, 1)) -> (logits (B, V)
  f32, {"k_delta", "v_delta" (nb, na, B, Hkv, 1, D), "pos" (B,)})."""
  if mode != "synopsis":
    raise NotImplementedError(f"mode={mode!r}: the port runs the synopsis "
                              "decode only")
  tf.check_supported(cfg)
  i_max = cfg.synopsis.i_max if i_max is None else i_max

  @torch.no_grad()
  def serve_step(params, cache, tokens):
    x = tf.embed_tokens(params, cfg, tokens[:, :1])           # (B, 1, d)
    pos = cache["pos"]
    k_delta, v_delta = [], []
    for b in range(cfg.n_blocks):
      ks, vs = [], []
      for i, _ in enumerate(cfg.block_pattern):
        lp = tf.layer_params(params["blocks"][f"pos{i}"], b)
        layer_cache = {kk: cache[kk][b, i] for kk in LAYER_LEAVES}
        layer_cache["recent_len"] = cache["recent_len"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, (kd, vd) = _attn_decode_layer(h, lp["attn"], cfg, layer_cache,
                                           pos, i_max)
        x = x + mix
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        mp = lp["mlp"]
        x = x + swiglu(h2, mp["w1"], mp["w3"], mp["w2"])
        ks.append(kd)
        vs.append(vd)
      k_delta.append(torch.stack(ks))
      v_delta.append(torch.stack(vs))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, 0]
    logits = tf.logits_fn(params, h)
    return logits, {"k_delta": torch.stack(k_delta),
                    "v_delta": torch.stack(v_delta), "pos": pos + 1}

  return serve_step
