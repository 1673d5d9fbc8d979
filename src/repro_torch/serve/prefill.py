"""Prefill step (counterpart of ``repro.serve.prefill.make_prefill_step``):
run the full prompt and emit (last-token logits, decode cache).

The cache comes out in the decode layout (nb, na, B, Hkv, S, D) with
``pos`` (B,); ``serve.synopsis_kv.build`` then clusters it into the
synopsis.  Causal attention runs through ``kernels.ops.prefill_attention``
(the flash prefill kernel on CUDA tensors).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig):
  tf.check_supported(cfg)

  @torch.no_grad()
  def prefill_step(params, tokens):
    h, kv = tf.hidden_states(params, cfg, tokens, collect_kv=True)
    logits = tf.logits_fn(params, h[:, -1])                  # (B, V) f32
    B, S = tokens.shape
    cache = {"k": kv["k"], "v": kv["v"],
             "pos": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return logits, cache

  return prefill_step
