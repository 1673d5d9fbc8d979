"""Dense GQA decoder (counterpart of ``repro.models.transformer`` for the
architectures the port runs: llama3's global layers, and gemma2's
alternating local (sliding-window) and global layers with attention and
final-logit softcaps, sandwich norms, a sqrt(d) embedding scale and tied
embeddings; pixtral's vision stub, whose projected patch embeddings
prefix the text embeddings; whisper's encoder over the audio stub's
frames, a cross block on every decoder layer, GELU MLPs and attention
biases; mamba2's SSD layers (``models.ssm``), with no FFN where d_ff = 0;
jamba's pattern of attention and mamba layers with an MoE FFN
(``models.moe``) on every other one; arctic's MoE with a dense MLP added
beside the experts; command-r's parallel blocks, ``x + attn(h) + ffn(h)``
with ``h`` the ``ln1``-normed input and no ``ln2``; deepseek's MLA
attention (``attention.mla_train`` at prefill, its latent ``[c_kv, k_pe]``
as the cache's one key/value head) and shared experts beside the routed
ones).  :func:`check_supported` refuses what none of these is.

Parameters are a nested dict with the JAX tree's keys and layouts, stacked
per pattern position with a leading layer axis; ``common.param_shapes``
spells the tree out: ``{"embed" (V, d), "final_norm" (d,), "unembed" (d,
V), "blocks": {"pos0": {"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2",
"mlp": {"w1", "w3", "w2"}}}}``; with sandwich norms each layer also has
``ln1_post`` and ``ln2_post``, with tied embeddings the JAX tree has no
``unembed``, with a stub frontend it has ``frontend_proj`` (frontend_dim,
d); whisper adds ``bq``/``bo`` to every attention, ``ln_cross`` and
``cross`` to every layer, a GELU ``mlp: {w1, b1, w2, b2}`` and ``encoder:
{blocks, final_norm}``; a mamba layer has ``ssm`` in place of ``attn``,
an MoE layer ``moe: {router, w1, w3, w2}`` in place of ``mlp`` (arctic's
both; deepseek's with ``shared: {w1, w3, w2}``), MLA's ``attn`` {wq_a,
q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b, wo}, and a layer with neither
MLP nor MoE (mamba2), or a parallel block (command-r), no ``ln2``.  A Python loop over
layers takes the place of ``lax.scan``.

Logits are taken in f32 (``h.float() @ unembed.float()``, or
``embed.T.float()`` when tied, then the logit softcap, as the JAX serve
step does).  So that a bf16 model does not re-cast its unembedding on
every step, :func:`finish_params` sets ``"unembed"`` to that f32 table
once: untied, the f32 cast replaces the bf16 weights (at llama3-8b width
the f32 table is 2.1 GB, where both would be 3.2 GB); tied, it is the f32
cast of ``embed``, seen transposed, and the bf16 ``embed`` stays for the
lookups (at gemma2-2b width 2.36 GB beside the 1.18 GB table).  Either way
the values are those of the bf16 weights.

The training path (:func:`train_hidden_states`, :func:`chunked_loss`,
:func:`forward_loss`) runs the same layers with the differentiable
``layers.causal_attention`` in place of the prefill kernel, each layer
recomputed in the backward, and adds the MoE aux loss; its parameters are
the raw tree of :func:`init_params`, without the f32 unembedding, whole or
a rank's shard of it (``train.train_step.shard_train_state``): every
collective of a cut leaf has its backward (``dist.sharding``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.dist import sharding as shd
from repro_torch.kernels.ref import acc_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (LayerSpec, ModelConfig,
                                       encoder_config, kv_dims,
                                       n_attn_positions, n_ssm_positions,
                                       param_shapes, ssm_state_shapes)
from repro_torch.models.layers import gelu_mlp, rms_norm, softcap, swiglu


FRONTENDS = (None, "vision_stub", "audio_stub")
MLP_TYPES = ("swiglu", "gelu")
LAYER_KINDS = ("attn", "mamba")
# Leaves the init leaves at zero: the norm gains (the norm is x * (1 + w))
# and the biases, as in the JAX init (the SSM's conv bias, dt bias and
# gated-norm gain too).
ZERO_LEAVES = frozenset(("ln1", "ln2", "ln1_post", "ln2_post", "ln_cross",
                         "final_norm", "bq", "bo", "b1", "b2", "conv_b",
                         "dt_bias", "norm", "q_norm", "kv_norm"))
# conv_w's init scale (the other weights draw at fan-in), as in JAX.
CONV_SCALE = 0.5
# Elements of one f32 draw at most (4 GB); a weight under it is drawn whole.
DRAW_ELEMS = 1 << 30


def check_supported(cfg: ModelConfig) -> None:
  """The port runs dense GQA attention layers, global or local, or MLA
  layers (deepseek: global, no softcap, no cross block, no bias), with a
  SwiGLU or GELU MLP or an MoE FFN (routed experts, with or without a
  dense MLP or shared experts beside them), sequential or parallel
  blocks; mamba (SSD) layers; the vision stub's patch prefix; whisper's
  encoder behind the audio stub, with a cross block on every decoder
  layer.  No other frontend."""
  kinds = {s.kind for s in cfg.block_pattern}
  if not kinds <= set(LAYER_KINDS):
    raise NotImplementedError(f"{cfg.name}: layer kinds {sorted(kinds)}; "
                              f"the port runs {LAYER_KINDS}")
  if "mamba" in kinds and cfg.ssm is None:
    raise NotImplementedError(f"{cfg.name}: mamba layers without an "
                              "SSMConfig")
  if cfg.mla is not None and (
      any(s.local or s.cross_attn for s in cfg.block_pattern)
      or cfg.attn_softcap is not None or cfg.attn_bias
      or cfg.parallel_block or cfg.encoder is not None):
    raise NotImplementedError(f"{cfg.name}: MLA runs on global layers with "
                              "no softcap, bias, cross block or parallel "
                              "block, as the reference's MLA branch does")
  if cfg.frontend not in FRONTENDS:
    raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r}; the "
                              f"port runs {FRONTENDS[1:]}")
  if (cfg.frontend == "audio_stub") != (cfg.encoder is not None):
    raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} with "
                              f"encoder {cfg.encoder}; the audio stub feeds "
                              "an encoder, and only it")
  if cfg.mlp_type not in MLP_TYPES:
    raise NotImplementedError(f"{cfg.name}: mlp_type {cfg.mlp_type!r}; the "
                              f"port runs {MLP_TYPES}")
  cross = {s.cross_attn for s in cfg.block_pattern}
  if len(cross) > 1 or cross != {cfg.encoder is not None}:
    raise NotImplementedError(f"{cfg.name}: cross attention on layers "
                              f"{[s.cross_attn for s in cfg.block_pattern]}"
                              f" with encoder {cfg.encoder}; the port runs a "
                              "cross block on every layer of an encoder's "
                              "decoder, and none without one")


def has_cross(cfg: ModelConfig) -> bool:
  """Whether the decoder layers have cross blocks (whisper; by
  ``check_supported``, every layer or none)."""
  return any(s.cross_attn for s in cfg.block_pattern)


def _trunc_normal(shape, scale, generator, device, dtype):
  """``scale * truncated_normal(-2, 2)`` drawn in f32, stored in ``dtype``
  (the init of ``repro.models.common.param``: ``scale=None`` is
  ``fan_in^-0.5`` with fan_in = ``shape[-2]``, as there).  A weight of
  more than :data:`DRAW_ELEMS` elements is drawn in slices of its first
  axis, so that its f32 draw never holds more than that: one layer's 128
  experts of arctic-480b would be 17.8 GB of f32, command-r's tied
  embedding 12.6 GB."""
  if scale is None:
    scale = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
  rows = max(1, DRAW_ELEMS // math.prod(shape[1:]))
  if len(shape) > 1 and shape[0] > rows:
    out = torch.empty(shape, dtype=dtype, device=device)
    for r0 in range(0, shape[0], rows):
      n = min(rows, shape[0] - r0)
      out[r0:r0 + n] = _trunc_normal((n, *shape[1:]), scale, generator,
                                     device, dtype)
    return out
  t = torch.empty(shape, dtype=torch.float32, device=device)
  torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
  return (t * scale).to(dtype)


def _stacked(n, shape, scale, generator, device, dtype):
  """n layers of one weight, drawn layer by layer to bound the f32 peak."""
  out = torch.empty((n, *shape), dtype=dtype, device=device)
  for i in range(n):
    out[i] = _trunc_normal(shape, scale, generator, device, dtype)
  return out


def _init_leaf(name, shape, stacked, **kw):
  if name in ZERO_LEAVES:
    return torch.zeros(shape, dtype=kw["dtype"], device=kw["device"])
  if name == "D":
    return torch.ones(shape, dtype=kw["dtype"], device=kw["device"])
  if name == "A_log":                   # A = -(1 .. 16) over the heads
    a = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32,
                       device=kw["device"]).log()
    return a.expand(shape).to(kw["dtype"]).clone()
  scale = None                          # fan-in
  if name == "embed":
    scale = 1.0
  elif name == "conv_w":
    scale = CONV_SCALE
  elif name == "wo":
    scale = (shape[-3] * shape[-2]) ** -0.5
  if stacked:
    return _stacked(shape[0], shape[1:], scale, **kw)
  return _trunc_normal(shape, scale, **kw)


def _init_tree(shapes: Dict, stacked: bool, **kw) -> Dict:
  return {name: _init_tree(sh, stacked or name == "blocks", **kw)
          if isinstance(sh, dict) else _init_leaf(name, sh, stacked, **kw)
          for name, sh in shapes.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype: Optional[torch.dtype] = None) -> Dict:
  """The random parameter tree of :func:`init_model` in ``dtype`` (default
  ``cfg.dtype``), without the f32 unembedding that serving adds: the
  trainer's f32 master weights."""
  check_supported(cfg)
  return _init_tree(param_shapes(cfg), False, generator=generator,
                    device=device, dtype=dtype or cfg.dtype)


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device) -> Dict:
  """Random weights of :func:`common.param_shapes` with the JAX init's
  scales: truncated normal (+-2 sigma), by default times
  ``shape[-2]^-0.5`` of one layer's weight (``frontend_proj``, the MoE
  experts and MLA's leaves too: H for ``wq_b``, ``wk_b`` and ``wv_b``),
  embed scale 1.0, ``wo`` scale (H*hd)^-0.5 (MLA: H*v_head_dim), ``conv_w``
  0.5, norm gains (MLA's ``q_norm`` and ``kv_norm`` too) and biases zero
  (the norm is ``x * (1 + w)``); the
  SSM's ``A_log`` log(linspace(1, 16, h)) and ``D`` ones.  Drawn leaf by
  leaf in the tree's order, the blocks first.  The numbers differ from
  the JAX init's: torch cannot replay JAX's RNG (use
  ``repro_torch.bridge.params_from_numpy`` to load the same weights)."""
  return finish_params(init_params(cfg, generator, device), cfg)


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
  """Layer ``i``'s slice of a stacked parameter subtree.  A rank's shard
  (``dist.sharding.shard_params``) comes with its FSDP cut undone, leaf by
  leaf (``gather_fsdp``: the reference's ``_gather_fsdp`` before the
  layer runs; the gathered leaves are freed with the slice), and its
  ``model`` cuts kept in the slice's :data:`~repro_torch.dist.sharding.
  CUT_KEY` entries."""
  if not shd.is_cut(stacked):
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}
  cuts = {}
  out = {shd.CUT_KEY: cuts}
  for k, v in stacked.items():
    if k == shd.CUT_KEY:
      continue
    if isinstance(v, dict):
      out[k] = layer_params(v, i)
      continue
    out[k], cuts[k] = shd.gather_fsdp(v[i], stacked[shd.CUT_KEY][k].layer())
  return out


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
  table = shd.leaf(params, "embed")
  vocab_axes = shd.cut_axes(params, "embed", 0)
  x = (_embed_cut(table, tokens, vocab_axes) if vocab_axes
       else table[tokens]).to(cfg.dtype)
  scale = embed_scale(cfg)
  x = x if scale is None else x * scale
  if frontend_embeds is None:
    return x
  if cfg.frontend != "vision_stub":
    raise ValueError(f"{cfg.name} has no vision stub to take "
                     "frontend_embeds")
  proj = shd.leaf(params, "frontend_proj")
  dt = torch.promote_types(frontend_embeds.dtype, proj.dtype)
  prefix = torch.matmul(frontend_embeds.to(dt), proj.to(dt)).to(cfg.dtype)
  return torch.cat([prefix, x], dim=1)


def _embed_cut(table, tokens, axes):
  """The lookup of ``tokens`` in a table whose vocab rows are cut over
  ``axes``: each rank looks up the ids in its block (zero rows for the
  others), and one all-reduce sums the blocks; every sum adds one row to
  zeros, so the result is the whole table's rows exactly."""
  rows = table.shape[0]
  local = tokens - shd.block_start(axes, rows)
  own = (local >= 0) & (local < rows)
  x = table[local.clamp(0, rows - 1)]
  x = torch.where(own[..., None], x, torch.zeros_like(x))
  return shd.all_reduce_over(x, axes)


def post_norm(y, lp, name: str, cfg: ModelConfig):
  """A sandwich norm (``ln1_post`` after attention, ``ln2_post`` after the
  MLP) where the config has them; else ``y``."""
  return rms_norm(y, lp[name], cfg.norm_eps) if cfg.sandwich_norm else y


def mlp(x, mp, cfg: ModelConfig):
  """The config's MLP: SwiGLU, or GELU with biases.  Cut over ``ff`` (a
  rank's shard): ``w1``, ``w3`` and ``b1`` column-cut, ``w2`` row-cut,
  one all-reduce of the partial outputs, ``b2`` added after it."""
  axes = shd.cut_axes(mp, "w2", 0)
  x = shd.enter(x, axes)
  if cfg.mlp_type == "gelu":
    if not axes:
      return gelu_mlp(x, mp["w1"], mp["b1"], mp["w2"], mp["b2"])
    y = gelu_mlp(x, mp["w1"], mp["b1"], mp["w2"], None)
    return shd.all_reduce_over(y, axes) + mp["b2"].to(x.dtype)
  return shd.all_reduce_over(swiglu(x, mp["w1"], mp["w3"], mp["w2"]), axes)


def ffn(x, lp, cfg: ModelConfig, spec: LayerSpec, aux=None):
  """The layer's FFN: the MoE on an MoE layer, plus the dense MLP of
  ``lp["mlp"]`` where the MoE has ``dense_parallel`` (arctic); else the
  config's MLP.  The MoE's load-balance loss is appended to the list
  ``aux`` where one is given (the training loss), else dropped (nothing on
  the serve path reads it)."""
  if spec.use_moe and cfg.moe is not None:
    y, a = moe_lib.moe_ffn(x, lp["moe"], cfg)
    if aux is not None:
      aux.append(a)
    return y + mlp(x, lp["mlp"], cfg) if cfg.moe.dense_parallel else y
  return mlp(x, lp["mlp"], cfg)


def mlp_block(x, lp, cfg: ModelConfig, spec: LayerSpec, aux=None):
  """x + the (sandwich-normed) FFN of the pre-normed ``x``; ``x`` as it is
  where the layer has no FFN (no ``ln2``: mamba2's layers).  A parallel
  block has no ``ln2`` either but an FFN: it goes through
  :func:`parallel_residual` and never comes here."""
  if cfg.parallel_block:
    raise ValueError(f"{cfg.name}: a parallel block's FFN reads the "
                     "ln1-normed input, not ln2's")
  if "ln2" not in lp:
    return x
  h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
  return x + post_norm(ffn(h2, lp, cfg, spec, aux), lp, "ln2_post", cfg)


def parallel_residual(x, mix, h, lp, cfg: ModelConfig, spec: LayerSpec,
                      aux=None):
  """A parallel block's output (command-r): ``x + mix + ffn(h)``, with
  ``h`` the ``ln1``-normed input the mixer read and ``mix`` normed again
  under sandwich norms, as the reference's parallel branch (which skips
  any cross block)."""
  return x + post_norm(mix, lp, "ln1_post", cfg) + ffn(h, lp, cfg, spec, aux)


def _layer_forward(x, lp, cfg: ModelConfig, spec: LayerSpec, positions,
                   enc_out=None, *, train: bool = False,
                   causal_skip: bool = False, aux=None):
  """One pre-norm layer: attention (sliding-window on a local layer) or
  the SSD mixer, the cross block where the layer has one, then the FFN,
  each output normed again under sandwich norms; in a parallel block the
  FFN of the same normed input, added beside the mixer's output; an MLA
  layer (deepseek) runs ``attention.mla_train``.  Returns (x, the layer's
  decode-cache leaves): {"k", "v"} in the decode layout (B, Hkv, S, D)
  (MLA: the latent, (B, 1, S, kv_lora + rope), as both),
  with a cross block also {"cross_k", "cross_v"} (B, Hkv, S or T, D); on
  a mamba layer {"conv_state", "ssd_state"}.

  The cross block (whisper) attends over ``enc_out`` where it is given
  (``attention.cross_attention``); without it, as in the JAX loop, which
  passes no frames, the reference runs causal self attention with rope
  and ``bq`` on the cross weights, and so does this: through
  ``ops.prefill_attention`` (the flash prefill kernel on the card), where
  JAX computes the same function in XLA (``layers.causal_attention``).

  With ``train`` every causal attention takes the training path's
  differentiable ``layers.causal_attention`` (``attention.causal_mix``),
  with ``causal_skip``; the MoE's aux loss goes to the list ``aux``."""
  mixer = dict(train=train, causal_skip=causal_skip)
  h = rms_norm(x, lp["ln1"], cfg.norm_eps)
  if spec.kind == "mamba":
    mix, (conv, ssd) = ssm_lib.ssm_forward(h, lp["ssm"], cfg)
    out = {"conv_state": conv, "ssd_state": ssd}
  elif cfg.mla is not None:
    mix, (k, v) = attn.mla_train(h, lp["attn"], cfg, positions, **mixer)
    out = {"k": k, "v": v}
  else:
    mix, (k, v) = attn.attention_train(h, lp["attn"], cfg, positions,
                                       local=spec.local, **mixer)
    out = {"k": k, "v": v}
  if cfg.parallel_block:
    return parallel_residual(x, mix, h, lp, cfg, spec, aux), out
  x = x + post_norm(mix, lp, "ln1_post", cfg)
  if spec.cross_attn:
    hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    if enc_out is not None:
      y, (ck, cv) = attn.cross_attention(hc, lp["cross"], cfg, enc_out,
                                         train=train)
    else:
      y, (ck, cv) = attn.attention_train(hc, lp["cross"], cfg, positions,
                                         **mixer)
    out.update(cross_k=ck, cross_v=cv)
    x = x + y
  return mlp_block(x, lp, cfg, spec, aux), out


def encode(params, cfg: ModelConfig, frames, train: bool = False):
  """The encoder over the audio stub's frame embeddings (B, T,
  frontend_dim) -> (B, T, d) in ``cfg.dtype``: ``frontend_proj`` (the
  product in the promoted dtype, as the JAX einsum), then per layer ln1,
  bidirectional ``cross_attention`` of the layer over itself (no rope: the
  reference adds none, whatever its docstring says), ln2 and the GELU MLP,
  then the encoder's ``final_norm``; ``train`` as in
  :func:`attention.cross_attention`."""
  ecfg = encoder_config(cfg)
  proj = shd.leaf(params, "frontend_proj")
  dt = torch.promote_types(frames.dtype, proj.dtype)
  x = torch.matmul(frames.to(dt), proj.to(dt)).to(cfg.dtype)
  enc = params["encoder"]
  for i in range(ecfg.n_layers):
    lp = layer_params(enc["blocks"], i)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.cross_attention(h, lp["attn"], ecfg, h, train=train)[0]
    x = x + mlp(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], ecfg)
  return rms_norm(x, shd.leaf(enc, "final_norm"), cfg.norm_eps)


def hidden_states(params, cfg: ModelConfig, tokens,
                  collect_kv: bool = False, frontend_embeds=None):
  """Token ids (B, T) -> final hidden states (B, S, d), S = T plus the
  patch prefix of ``frontend_embeds`` under the vision stub (rope
  positions run over both); under the audio stub ``frontend_embeds`` are
  frames for :func:`encode`, never prefixed to the text.  With
  ``collect_kv`` also the decode cache's per-layer leaves, written layer
  by layer into one preallocated tensor each: {"k", "v"} (nb, na, B, Hkv,
  S, D) over the na attention positions of the pattern, with cross blocks
  {"cross_k", "cross_v"} (nb, na, B, Hkv, S or T, D) beside them, and over
  the ns mamba positions {"conv_state" (nb, ns, B, d_conv-1, conv_dim) in
  ``cfg.dtype``, "ssd_state" (nb, ns, B, h, head_dim, d_state) in f32
  (float64 in a float64 run)}."""
  check_supported(cfg)
  x, enc_out = _inputs(params, cfg, tokens, frontend_embeds)
  B, S = x.shape[:2]
  positions = torch.arange(S, device=x.device)
  kv: Optional[Dict] = None
  if collect_kv:
    kv = {name: torch.empty(shape, dtype=dt, device=x.device)
          for name, (shape, dt) in _cache_leaves(
              cfg, B, S, S if enc_out is None else enc_out.shape[1]).items()}
  for b in range(cfg.n_blocks):
    ai = si = 0                  # attention / mamba position in the stacks
    for i, spec in enumerate(cfg.block_pattern):
      lp = layer_params(params["blocks"][f"pos{i}"], b)
      x, leaves = _layer_forward(x, lp, cfg, spec, positions, enc_out)
      if kv is not None:
        for name, t in leaves.items():
          kv[name][b, si if spec.kind == "mamba" else ai] = t
      ai += spec.kind == "attn"
      si += spec.kind == "mamba"
  h = rms_norm(x, shd.leaf(params, "final_norm"), cfg.norm_eps)
  return (h, kv) if collect_kv else h


def _inputs(params, cfg: ModelConfig, tokens, frontend_embeds,
            train: bool = False):
  """(the decoder's input embeddings, the encoder's output or None): the
  audio stub's frames go through :func:`encode`, the vision stub's patches
  prefix the text."""
  if cfg.encoder is None:
    return embed_tokens(params, cfg, tokens, frontend_embeds), None
  enc_out = (None if frontend_embeds is None
             else encode(params, cfg, frontend_embeds, train))
  return embed_tokens(params, cfg, tokens), enc_out


def _cache_leaves(cfg: ModelConfig, B: int, S: int, T: int) -> Dict:
  """{leaf: (shape, dtype)} of the prefill's per-layer cache leaves for a
  batch of B sequences of S positions (T cross rows)."""
  out = {}
  if n_attn_positions(cfg):
    Hkv, D = kv_dims(cfg)
    lead = (cfg.n_blocks, n_attn_positions(cfg), B, Hkv)
    out["k"] = out["v"] = ((*lead, S, D), cfg.dtype)
    if has_cross(cfg):
      out["cross_k"] = out["cross_v"] = ((*lead, T, cfg.hd), cfg.dtype)
  if n_ssm_positions(cfg):
    shapes = ssm_state_shapes(cfg, B)
    out["conv_state"] = (shapes["conv_state"], cfg.dtype)
    out["ssd_state"] = (shapes["ssd_state"], torch.float64
                        if cfg.dtype == torch.float64 else torch.float32)
  return out


def logits_fn(params, cfg: ModelConfig, h):
  """(..., d) -> logits (..., V) in the unembedding's dtype (f32; float64
  in a float64 run), softcapped where the config caps them.  On a rank's
  shard the unembedding's vocab columns are cut: the rank's logits, capped
  elementwise, then one all-gather gives every rank all V."""
  unembed = shd.leaf(params, "unembed")
  return shd.all_gather_over(
      softcap(torch.matmul(h.to(unembed.dtype), unembed), cfg.logit_softcap),
      shd.cut_axes(params, "unembed", 1), -1)


# -- the training path ---------------------------------------------------------

def train_hidden_states(params, cfg: ModelConfig, tokens,
                        frontend_embeds=None, causal_skip: bool = False):
  """The training forward (the reference's ``hidden_states`` with
  ``impl=None``): token ids (B, T) -> (final hidden states (B, S, d), the
  MoE aux loss summed over the layers, f32 0-d).  Differentiable on every
  device: causal attention is ``layers.causal_attention``, never the
  prefill kernel.  Each layer is recomputed in the backward
  (``torch.utils.checkpoint``, non-reentrant) where autograd is on, as the
  reference remats each scanned block.

  Whole parameters, or a rank's shard (``dist.sharding.shard_tree`` under
  a rule table, with the mesh installed): a layer's FSDP leaves are
  gathered inside its checkpointed function (``layer_params``), so that
  they are freed after its forward and gathered again in the backward's
  recompute, as the reference gathers inside its remat'd scan body; the
  recompute runs under the mesh its forward ran under, on whatever thread
  autograd runs it (``dist.sharding.under_current_mesh``)."""
  check_supported(cfg)
  x, enc_out = _inputs(params, cfg, tokens, frontend_embeds, train=True)
  positions = torch.arange(x.shape[1], device=x.device)
  remat = torch.is_grad_enabled()

  @shd.under_current_mesh
  def layer(x, stacked, b, spec):
    acc = []
    x, _ = _layer_forward(x, layer_params(stacked, b), cfg, spec, positions,
                          enc_out, train=True, causal_skip=causal_skip,
                          aux=acc)
    return x, sum(acc, torch.zeros((), dtype=torch.float32,
                                   device=x.device))

  aux = torch.zeros((), dtype=torch.float32, device=x.device)
  for b in range(cfg.n_blocks):
    for i, spec in enumerate(cfg.block_pattern):
      stacked = params["blocks"][f"pos{i}"]
      if remat:
        x, a = torch.utils.checkpoint.checkpoint(
            layer, x, stacked, b, spec, use_reentrant=False,
            preserve_rng_state=False)
      else:
        x, a = layer(x, stacked, b, spec)
      aux = aux + a
  return rms_norm(x, shd.leaf(params, "final_norm"), cfg.norm_eps), aux


# Sequence positions per chunk of :func:`chunked_loss`, as the reference's.
LOSS_CHUNK = 1024


def chunked_loss(params, cfg: ModelConfig, h, labels,
                 chunk: int = LOSS_CHUNK):
  """Mean cross entropy of h (B, S, d) against labels (B, S) without the
  whole (B, S, vocab) logits: per chunk of sequence positions (the largest
  divisor of S at most ``chunk``), f32 logits from h and the unembedding
  (``embed`` transposed when tied) cast to f32 (float64 in a float64
  run), the logit softcap,
  logsumexp minus the gold logit; each chunk recomputed in the backward
  where autograd is on.  On a rank's shard the unembedding's FSDP cut is
  gathered, and its vocab cut is vocab-parallel: each rank takes the
  logsumexp of its own logits, one all-gather gives every rank the ranks'
  (the logsumexp of those is the whole one), and the gold logit comes from
  the rank that holds it through one all-reduce."""
  B, S, _ = h.shape
  chunk = min(chunk, S)
  while S % chunk:
    chunk -= 1
  if cfg.tie_embeddings:
    w, axes = shd.leaf(params, "embed").t(), shd.cut_axes(params, "embed", 0)
  else:
    w, axes = shd.leaf(params, "unembed"), shd.cut_axes(params, "unembed", 1)

  @shd.under_current_mesh
  def one(hc, lc, w):
    f = acc_dtype(hc)
    lg = softcap(torch.matmul(shd.enter(hc, axes).to(f), w.to(f)),
                 cfg.logit_softcap)
    if not axes:
      gold = lg.gather(-1, lc[..., None].long())[..., 0]
      return (torch.logsumexp(lg, dim=-1) - gold).sum()
    rows = lg.shape[-1]
    local = lc.long() - shd.block_start(axes, rows)
    own = (local >= 0) & (local < rows)
    gold = lg.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    gold = shd.all_reduce_over(torch.where(own, gold, torch.zeros_like(gold)),
                               axes)
    lse = torch.logsumexp(shd.all_gather_over(
        torch.logsumexp(lg, dim=-1, keepdim=True), axes, -1), dim=-1)
    return (lse - gold).sum()

  remat = torch.is_grad_enabled()
  total = []
  for i in range(S // chunk):
    hc, lc = h[:, i * chunk:(i + 1) * chunk], labels[:, i * chunk:(i + 1)
                                                      * chunk]
    total.append(torch.utils.checkpoint.checkpoint(
        one, hc, lc, w, use_reentrant=False, preserve_rng_state=False)
                 if remat else one(hc, lc, w))
  return torch.stack(total).sum() / (B * S)


def forward_loss(params, cfg: ModelConfig, tokens, labels,
                 frontend_embeds=None, causal_skip: bool = False):
  """The training loss: cross entropy + 0.01 * the MoE aux loss, on the
  text positions (the vision stub's patch prefix sliced off).  Returns
  (loss, {"ce", "aux"})."""
  h, aux = train_hidden_states(params, cfg, tokens, frontend_embeds,
                               causal_skip)
  if cfg.frontend == "vision_stub" and frontend_embeds is not None:
    h = h[:, frontend_embeds.shape[1]:]
  loss = chunked_loss(params, cfg, h, labels)
  return loss + 0.01 * aux, {"ce": loss, "aux": aux}
