"""Prefill step (counterpart of ``repro.serve.prefill.make_prefill_step``):
run the full prompt and emit (last-token logits, decode cache).

The cache comes out in the decode layout (nb, na, B, Hkv, S, D) with
``pos`` (B,) (MLA: the latent, Hkv = 1 and D = kv_lora + rope, as both
``k`` and ``v``), S the prompt's tokens plus the vision stub's patch prefix
where ``frontend_embeds`` is given (the loop and the engine give none, as
in the JAX package); ``serve.synopsis_kv.build`` then clusters it into the
synopsis.  A config with cross blocks (whisper) also emits
``cross_k``/``cross_v`` (nb, na, B, Hkv, T, D): with the audio stub's
frames the encoder's T frames, without them (the loop) the decoder's own S
tokens from the causal "cross" prefill.  Causal attention runs through
``kernels.ops.prefill_attention`` (the flash prefill kernel on CUDA
tensors).

On a rank's shard (``dist.sharding.shard_params``, under ``use_mesh``)
causal attention runs on the rank's own query heads against their KV
heads, so ``flash_prefill`` launches at the rank's head count; ``wk`` and
``wv`` are whole under the serving tables, so every rank ends with the
global prompt KV (and the mamba layers' global state) with no collective
of its own, and the logits come out global (``transformer.logits_fn``).

:func:`make_extend_step` is the corpus cache's delta prefill: the tokens
that extend a cached corpus, against the cached arena's sorted KV.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm, softcap


def make_prefill_step(cfg: ModelConfig):
  tf.check_supported(cfg)

  @torch.no_grad()
  def prefill_step(params, tokens, frontend_embeds=None):
    h, kv = tf.hidden_states(params, cfg, tokens, collect_kv=True,
                             frontend_embeds=frontend_embeds)
    logits = tf.logits_fn(params, cfg, h[:, -1])             # (B, V) f32
    B, S = h.shape[:2]
    cache = {**kv, "pos": torch.full((B,), S, dtype=torch.int32,
                                     device=tokens.device)}
    return logits, cache

  return prefill_step


def _extend_layer(x, lp, cfg: ModelConfig, spec, positions, pk, pv):
  """One decoder layer over E extension tokens attending [prefix; ext]:
  the prefix half of the KV is the cached arena's sorted ``pk``/``pv``
  (B, Hkv, P, D), not recomputed.  Sound because softmax over the cached
  keys does not depend on their order and rope was applied at their true
  positions before caching.  Plain f32 attention, as the JAX package's
  (no kernel); then the FFN as in :func:`transformer._layer_forward`
  (beside the attention in a parallel block).  Returns (x, k_new, v_new),
  the new KV (B, Hkv, E, D)."""
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  q, k, v = attn_lib.qkv(h, lp["attn"], cfg, positions)
  k_new = k.transpose(1, 2)                                   # (B,Hkv,E,D)
  v_new = v.transpose(1, 2)
  k_all = torch.cat([pk.to(k_new.dtype), k_new], dim=2).float()
  B, E, H, D = q.shape
  Hkv, P = pk.shape[1], pk.shape[2]
  qg = q.transpose(1, 2).reshape(B, Hkv, H // Hkv, E, D).float()
  logits = softcap(torch.einsum("bhged,bhsd->bhges", qg, k_all)
                   * cfg.hd ** -0.5, cfg.attn_softcap)
  del k_all
  # Every prefix key (any sorted order) is visible to every extension
  # query; among the extension's keys plain causality applies.
  s = torch.arange(P + E, device=x.device)
  vis = (s[None, :] - P) <= torch.arange(E, device=x.device)[:, None]
  w = torch.softmax(logits.masked_fill_(~vis, -1e30), dim=-1)
  del logits               # (B, Hkv, G, E, P+E) f32: free it before p.V
  v_all = torch.cat([pv.to(v_new.dtype), v_new], dim=2).float()
  o = torch.einsum("bhges,bhsd->bhged", w, v_all)
  del w, v_all
  o = o.reshape(B, H, E, D).transpose(1, 2).to(x.dtype)
  mix = attn_lib.out_proj(o, lp["attn"], x.dtype)
  if cfg.parallel_block:
    return tf.parallel_residual(x, mix, h, lp, cfg, spec), k_new, v_new
  x = x + tf.post_norm(mix, lp, "ln1_post", cfg)
  return tf.mlp_block(x, lp, cfg, spec), k_new, v_new


def make_extend_step(cfg: ModelConfig):
  """Delta prefill for a corpus that extends a cached one: only the E
  extension tokens run, against the cached arena's sorted prefix KV.

  extend_step(params, ext_tokens (B, E), prefix_k, prefix_v (nb, na, B,
  Hkv, P, D), pos0) -> (last-token logits (B, V) f32, (k_new, v_new)
  (nb, na, B, Hkv, E, D)); feed the KV to ``synopsis_kv.extend_synopsis``.
  Gate on ``corpus_cache.supports_delta``.  Each layer's f32 logits (B,
  Hkv, G, E, P+E) are transient (4.3 GB a layer at llama3-8b's width for
  P = E = 4096) and freed before the next layer.  A sliding-window layer
  would couple the extension to the prefix's order, a cross block or a
  frontend to inputs the arena does not hold, and a mamba layer to the
  prefix's SSM state, and MLA caches a latent, not per-head keys, so a
  config with any of them is refused (``corpus_cache.supports_delta`` is
  False for it)."""
  tf.check_supported(cfg)
  if any(s.kind != "attn" for s in cfg.block_pattern):
    raise NotImplementedError(f"{cfg.name}: no delta prefill over mamba "
                              "layers (the arena holds no prefix SSM state "
                              "to extend from)")
  if any(s.local for s in cfg.block_pattern):
    raise NotImplementedError(f"{cfg.name}: no delta prefill over "
                              "sliding-window layers")
  if tf.has_cross(cfg):
    raise NotImplementedError(f"{cfg.name}: no delta prefill over "
                              "cross-attention layers")
  if cfg.frontend:
    raise NotImplementedError(f"{cfg.name}: no delta prefill behind a "
                              "frontend prefix")
  if cfg.mla is not None:
    raise NotImplementedError(f"{cfg.name}: no delta prefill over MLA's "
                              "latent cache (the reference has none)")

  @torch.no_grad()
  def extend_step(params, ext_tokens, prefix_k, prefix_v, pos0: int):
    if shd.is_cut(params):
      raise NotImplementedError(f"{cfg.name}: the delta prefill takes whole "
                                "parameters")
    x = tf.embed_tokens(params, cfg, ext_tokens)
    E = x.shape[1]
    positions = pos0 + torch.arange(E, device=x.device)
    shape = (*prefix_k.shape[:4], E, prefix_k.shape[5])
    k_new = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    v_new = torch.empty(shape, dtype=cfg.dtype, device=x.device)
    for b in range(cfg.n_blocks):
      for i, spec in enumerate(cfg.block_pattern):
        lp = tf.layer_params(params["blocks"][f"pos{i}"], b)
        x, k_new[b, i], v_new[b, i] = _extend_layer(
            x, lp, cfg, spec, positions, prefix_k[b, i], prefix_v[b, i])
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tf.logits_fn(params, cfg, h[:, -1]), (k_new, v_new)

  return extend_step
