"""Dense GQA decoder (counterpart of ``repro.models.transformer`` for the
architectures the port runs: llama3's global layers, and gemma2's
alternating local (sliding-window) and global layers with attention and
final-logit softcaps, sandwich norms, a sqrt(d) embedding scale and tied
embeddings; pixtral's vision stub, whose projected patch embeddings
prefix the text embeddings).

Parameters are a nested dict with the JAX tree's keys and layouts, stacked
per pattern position with a leading layer axis:
``{"embed" (V, d), "final_norm" (d,), "unembed" (d, V), "blocks": {"pos0":
{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "mlp": {"w1", "w3",
"w2"}}}}``; with sandwich norms each layer also has ``ln1_post`` and
``ln2_post``, with tied embeddings the JAX tree has no ``unembed``, and
with the vision stub it has ``frontend_proj`` (frontend_dim, d).
A Python loop over layers takes the place of ``lax.scan``.

Logits are taken in f32 (``h.float() @ unembed.float()``, or
``embed.T.float()`` when tied, then the logit softcap, as the JAX serve
step does).  So that a bf16 model does not re-cast its unembedding on
every step, :func:`finish_params` sets ``"unembed"`` to that f32 table
once: untied, the f32 cast replaces the bf16 weights (at llama3-8b width
the f32 table is 2.1 GB, where both would be 3.2 GB); tied, it is the f32
cast of ``embed``, seen transposed, and the bf16 ``embed`` stays for the
lookups (at gemma2-2b width 2.36 GB beside the 1.18 GB table).  Either way
the values are those of the bf16 weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import LayerSpec, ModelConfig
from repro_torch.models.layers import rms_norm, softcap, swiglu


def check_supported(cfg: ModelConfig) -> None:
  """The port runs dense GQA attention layers, global or local (for now),
  and the vision stub's patch prefix: no SSM, MoE, MLA, cross-attention or
  encoder layers, and no other frontend."""
  if any(s.kind != "attn" for s in cfg.block_pattern):
    raise NotImplementedError(f"{cfg.name}: the port runs attention layers "
                              "only")
  if cfg.frontend not in (None, "vision_stub"):
    raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r}; the "
                              "port runs the vision stub only")


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
  sigma), by default times ``shape[-2]^-0.5`` (``frontend_proj`` too),
  embed scale 1.0, ``wo`` scale (H*hd)^-0.5, norm gains zero (the norm is
  ``x * (1 + w)``).  The numbers differ from the JAX init's: torch cannot
  replay JAX's RNG (use ``repro_torch.bridge.params_from_numpy`` to load
  the same weights)."""
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
    if cfg.sandwich_norm:
      blocks[f"pos{i}"]["ln1_post"] = torch.zeros((n, d), **zeros)
      blocks[f"pos{i}"]["ln2_post"] = torch.zeros((n, d), **zeros)
  params = {
      "embed": _trunc_normal((cfg.vocab, d), 1.0, **kw),
      "final_norm": torch.zeros((d,), **zeros),
      "blocks": blocks,
  }
  if not cfg.tie_embeddings:
    params["unembed"] = _trunc_normal((d, cfg.vocab), None, **kw)
  if cfg.frontend:
    params["frontend_proj"] = _trunc_normal((cfg.frontend_dim, d), None, **kw)
  return finish_params(params, cfg)


def finish_params(params: Dict, cfg: ModelConfig) -> Dict:
  """Set the f32 unembedding the logits read (see the module doc): the
  f32 cast of ``unembed``, or of ``embed`` seen transposed when tied."""
  if cfg.tie_embeddings:
    if "unembed" in params:
      raise KeyError(f"{cfg.name}: tied embeddings take no 'unembed'")
    params["unembed"] = params["embed"].float().t()
  else:
    params["unembed"] = params["unembed"].float()
  return params


def layer_params(stacked: Dict, i: int) -> Dict:
  """Layer ``i``'s slice of a stacked parameter subtree."""
  return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
          for k, v in stacked.items()}


def embed_scale(cfg: ModelConfig) -> Optional[float]:
  """The sqrt(d) embedding scale as ``cfg.dtype`` holds it (the JAX model
  multiplies by ``asarray(d ** 0.5, cfg.dtype)``), or None.  A Python
  float, so that a captured step copies nothing from the host."""
  if not cfg.scale_embed:
    return None
  return float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))


def embed_tokens(params, cfg: ModelConfig, tokens, frontend_embeds=None):
  """Token ids (B, S) -> (B, S, d) in ``cfg.dtype``; with the vision stub's
  ``frontend_embeds`` (B, P, frontend_dim) -> (B, P + S, d), the projected
  patches first (the product in the promoted dtype, then cast, as the JAX
  einsum does)."""
  x = params["embed"][tokens].to(cfg.dtype)
  scale = embed_scale(cfg)
  x = x if scale is None else x * scale
  if frontend_embeds is None:
    return x
  if cfg.frontend != "vision_stub":
    raise ValueError(f"{cfg.name} has no vision stub to take "
                     "frontend_embeds")
  proj = params["frontend_proj"]
  dt = torch.promote_types(frontend_embeds.dtype, proj.dtype)
  prefix = torch.matmul(frontend_embeds.to(dt), proj.to(dt)).to(cfg.dtype)
  return torch.cat([prefix, x], dim=1)


def post_norm(y, lp, name: str, cfg: ModelConfig):
  """A sandwich norm (``ln1_post`` after attention, ``ln2_post`` after the
  MLP) where the config has them; else ``y``."""
  return rms_norm(y, lp[name], cfg.norm_eps) if cfg.sandwich_norm else y


def mlp_block(x, lp, cfg: ModelConfig):
  """x + the (sandwich-normed) SwiGLU MLP of the pre-normed ``x``."""
  mp = lp["mlp"]
  h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
  return x + post_norm(swiglu(h2, mp["w1"], mp["w3"], mp["w2"]), lp,
                       "ln2_post", cfg)


def _layer_forward(x, lp, cfg: ModelConfig, spec: LayerSpec, positions):
  """One pre-norm layer: attention (sliding-window on a local layer) +
  SwiGLU, each output normed again under sandwich norms.  Returns (x, (k,
  v)) with the layer's k/v in the decode layout (B, Hkv, S, D)."""
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  mix, kv = attn.attention_train(h, lp["attn"], cfg, positions,
                                 local=spec.local)
  x = x + post_norm(mix, lp, "ln1_post", cfg)
  return mlp_block(x, lp, cfg), kv


def hidden_states(params, cfg: ModelConfig, tokens,
                  collect_kv: bool = False, frontend_embeds=None):
  """Token ids (B, T) -> final hidden states (B, S, d), S = T plus the
  patch prefix of ``frontend_embeds`` (rope positions run over both); with
  ``collect_kv`` also {"k", "v"} in the cache layout (nb, na, B, Hkv, S,
  D), written layer by layer into one preallocated tensor each."""
  check_supported(cfg)
  x = embed_tokens(params, cfg, tokens, frontend_embeds)
  B, S = x.shape[:2]
  positions = torch.arange(S, device=x.device)
  kv: Optional[Dict] = None
  if collect_kv:
    shape = (cfg.n_blocks, len(cfg.block_pattern), B, cfg.n_kv_heads, S,
             cfg.hd)
    kv = {"k": torch.empty(shape, dtype=cfg.dtype, device=x.device),
          "v": torch.empty(shape, dtype=cfg.dtype, device=x.device)}
  for b in range(cfg.n_blocks):
    for i, spec in enumerate(cfg.block_pattern):
      lp = layer_params(params["blocks"][f"pos{i}"], b)
      x, (k, v) = _layer_forward(x, lp, cfg, spec, positions)
      if kv is not None:
        kv["k"][b, i] = k
        kv["v"][b, i] = v
  h = rms_norm(x, params["final_norm"], cfg.norm_eps)
  return (h, kv) if collect_kv else h


def logits_fn(params, cfg: ModelConfig, h):
  """(..., d) -> f32 logits (..., V), softcapped where the config caps
  them."""
  return softcap(torch.matmul(h.float(), params["unembed"]),
                 cfg.logit_softcap)
