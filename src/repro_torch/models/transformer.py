"""Dense GQA decoder (counterpart of ``repro.models.transformer`` for the
architectures the port runs).

Parameters are a nested dict with the JAX tree's keys and layouts, stacked
per pattern position with a leading layer axis:
``{"embed" (V, d), "final_norm" (d,), "unembed" (d, V), "blocks": {"pos0":
{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "mlp": {"w1", "w3",
"w2"}}}}``.  A Python loop over layers takes the place of ``lax.scan``.

Logits are taken in f32 (``h.float() @ unembed.float()``, as the JAX serve
step does).  So that a bf16 model does not re-cast its unembedding on every
step, :func:`finish_params` replaces ``"unembed"`` by its f32 cast once:
the values stay those of the bf16 weights, and no bf16 copy is kept (at
llama3-8b width the f32 table is 2.1 GB, where both would be 3.2 GB).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu


def check_supported(cfg: ModelConfig) -> None:
  """The port runs dense GQA attention layers only (for now)."""
  if any(s.kind != "attn" for s in cfg.block_pattern):
    raise NotImplementedError(f"{cfg.name}: the port runs attention layers "
                              "only")


def _trunc_normal(shape, scale, generator, device, dtype):
  """``scale * truncated_normal(-2, 2)`` drawn in f32, stored in ``dtype``
  (the init of ``repro.models.common.param``: ``scale=None`` is
  ``fan_in^-0.5`` with fan_in = ``shape[-2]``, as there)."""
  if scale is None:
    scale = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
  t = torch.empty(shape, dtype=torch.float32, device=device)
  torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
  return (t * scale).to(dtype)


def _stacked(n, shape, scale, generator, device, dtype):
  """n layers of one weight, drawn layer by layer to bound the f32 peak."""
  out = torch.empty((n, *shape), dtype=dtype, device=device)
  for i in range(n):
    out[i] = _trunc_normal(shape, scale, generator, device, dtype)
  return out


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict:
  """Random weights with the JAX init's scales: truncated normal (+-2
  sigma), by default times ``shape[-2]^-0.5``, embed scale 1.0, ``wo`` scale
  (H*hd)^-0.5, norm gains zero (the norm is ``x * (1 + w)``).  The
  numbers differ from the JAX init's: torch cannot replay JAX's RNG (use
  ``repro_torch.bridge.params_from_numpy`` to load the same weights)."""
  check_supported(cfg)
  d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
  n = cfg.n_blocks
  kw = dict(generator=generator, device=device, dtype=cfg.dtype)
  zeros = dict(dtype=cfg.dtype, device=device)
  blocks = {}
  for i, _ in enumerate(cfg.block_pattern):
    blocks[f"pos{i}"] = {
        "ln1": torch.zeros((n, d), **zeros),
        "attn": {
            "wq": _stacked(n, (d, H, hd), None, **kw),
            "wk": _stacked(n, (d, Hkv, hd), None, **kw),
            "wv": _stacked(n, (d, Hkv, hd), None, **kw),
            "wo": _stacked(n, (H, hd, d), (H * hd) ** -0.5, **kw),
        },
        "ln2": torch.zeros((n, d), **zeros),
        "mlp": {
            "w1": _stacked(n, (d, f), None, **kw),
            "w3": _stacked(n, (d, f), None, **kw),
            "w2": _stacked(n, (f, d), None, **kw),
        },
    }
  params = {
      "embed": _trunc_normal((cfg.vocab, d), 1.0, **kw),
      "final_norm": torch.zeros((d,), **zeros),
      "blocks": blocks,
      "unembed": _trunc_normal((d, cfg.vocab), None, **kw),
  }
  return finish_params(params)


def finish_params(params: Dict) -> Dict:
  """Cast the unembedding the logits read to f32 (see the module doc)."""
  params["unembed"] = params["unembed"].float()
  return params


def layer_params(stacked: Dict, i: int) -> Dict:
  """Layer ``i``'s slice of a stacked parameter subtree."""
  return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
          for k, v in stacked.items()}


def embed_tokens(params, cfg: ModelConfig, tokens):
  return params["embed"][tokens].to(cfg.dtype)


def _layer_forward(x, lp, cfg: ModelConfig, positions):
  """One pre-norm layer: attention + SwiGLU.  Returns (x, (k, v)) with the
  layer's k/v in the decode layout (B, Hkv, S, D)."""
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  mix, kv = attn.attention_train(h, lp["attn"], cfg, positions)
  x = x + mix
  h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
  mp = lp["mlp"]
  return x + swiglu(h2, mp["w1"], mp["w3"], mp["w2"]), kv


def hidden_states(params, cfg: ModelConfig, tokens,
                  collect_kv: bool = False):
  """Token ids (B, S) -> final hidden states (B, S, d); with
  ``collect_kv`` also {"k", "v"} in the cache layout (nb, na, B, Hkv, S,
  D), written layer by layer into one preallocated tensor each."""
  check_supported(cfg)
  x = embed_tokens(params, cfg, tokens)
  B, S = tokens.shape
  positions = torch.arange(S, device=x.device)
  kv: Optional[Dict] = None
  if collect_kv:
    shape = (cfg.n_blocks, len(cfg.block_pattern), B, cfg.n_kv_heads, S,
             cfg.hd)
    kv = {"k": torch.empty(shape, dtype=cfg.dtype, device=x.device),
          "v": torch.empty(shape, dtype=cfg.dtype, device=x.device)}
  for b in range(cfg.n_blocks):
    for i, _ in enumerate(cfg.block_pattern):
      lp = layer_params(params["blocks"][f"pos{i}"], b)
      x, (k, v) = _layer_forward(x, lp, cfg, positions)
      if kv is not None:
        kv["k"][b, i] = k
        kv["v"][b, i] = v
  h = rms_norm(x, params["final_norm"], cfg.norm_eps)
  return (h, kv) if collect_kv else h


def logits_fn(params, h):
  """(..., d) -> f32 logits (..., V)."""
  return torch.matmul(h.float(), params["unembed"])
