"""Model configs: the port's own copy of ``repro.models.common``'s config
dataclasses, cut to what the serving path reads (llama3's global
attention; gemma2's local layers, softcaps, sandwich norms, embedding
scale and tied embeddings; pixtral's vision-stub patch prefix; whisper's
encoder, cross attention, GELU MLPs and attention biases; mamba2's SSD
layers; jamba's and arctic's MoE FFNs, arctic's with a dense MLP beside
the experts; command-r's parallel attention-and-FFN blocks; deepseek's
MLA attention and shared experts).  ``dtype`` is a torch dtype.

:func:`param_shapes` is the parameter tree's layout, which the init, the
bridge's check and :meth:`ModelConfig.param_count` all read;
:func:`param_axes` is the same tree with each leaf's logical axes (the JAX
tree's ``Box`` axes), which the rule tables of ``dist.sharding`` resolve."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
  kind: str = "attn"              # "attn" | "mamba"
  local: bool = False             # sliding-window attention (gemma2)
  use_moe: bool = False           # an MoE FFN in place of the MLP (jamba)
  cross_attn: bool = False        # a cross block after attention (whisper)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
  num_experts: int
  top_k: int
  d_ff_expert: int
  num_shared: int = 0             # always-on shared experts (deepseek)
  dense_parallel: bool = False    # dense MLP residual in parallel (arctic)
  capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
  """Multi-head latent attention (deepseek-v2): queries through a
  ``q_lora_rank`` bottleneck, keys and values from one shared latent of
  ``kv_lora_rank`` plus a rope'd key part of ``qk_rope_dim``."""
  q_lora_rank: int = 1536
  kv_lora_rank: int = 512
  qk_nope_dim: int = 128
  qk_rope_dim: int = 64
  v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
  d_state: int = 128
  d_conv: int = 4
  expand: int = 2
  head_dim: int = 64
  chunk: int = 128


@dataclasses.dataclass(frozen=True)
class SynopsisConfig:
  """AccuracyTrader serving config for this model."""
  cluster_size: int = 128         # C: original tokens per aggregated point
  i_max: int = 32                 # default refinement budget (clusters)
  recent: int = 128               # exact-attention ring buffer (new tokens)
  # Synopsis arena quantization (kernels/quant.py): "none" | "int8" | "fp8"
  # | "int8+kv" | "fp8+kv"; "none" is the unquantized path, bit for bit.
  quant: str = "none"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
  n_layers: int
  n_heads: int
  d_ff: int
  source_len: int = 1500          # whisper: 30 s of 20 ms frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  name: str
  n_layers: int
  d_model: int
  n_heads: int
  n_kv_heads: int
  d_ff: int
  vocab: int
  head_dim: int = 0               # 0 -> d_model // n_heads
  rope_theta: float = 1e4
  norm_eps: float = 1e-6
  block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
  sliding_window: int = 4096
  logit_softcap: Optional[float] = None   # gemma2 final-logit softcap
  attn_softcap: Optional[float] = None    # gemma2 attention softcap
  parallel_block: bool = False            # attn + ffn in parallel (command-r)
  sandwich_norm: bool = False             # post-block norms (gemma2)
  scale_embed: bool = False               # sqrt(d) embedding scale (gemma2)
  tie_embeddings: bool = False            # logits read embed.T (gemma2)
  mlp_type: str = "swiglu"                # "swiglu" | "gelu" (whisper)
  attn_bias: bool = False                 # bq / bo (whisper)
  moe: Optional[MoEConfig] = None
  mla: Optional[MLAConfig] = None         # deepseek's latent attention
  ssm: Optional[SSMConfig] = None
  encoder: Optional[EncoderConfig] = None  # whisper
  # Precomputed embeddings projected by ``frontend_proj`` (frontend_dim,
  # d): "vision_stub" (pixtral) patches prefix the prompt's text;
  # "audio_stub" (whisper) frames feed the encoder.
  frontend: Optional[str] = None
  frontend_tokens: int = 0                # prefix tokens from the frontend
  frontend_dim: int = 0                   # the stub embedding's width
  synopsis: SynopsisConfig = SynopsisConfig()
  dtype: Any = torch.bfloat16

  @property
  def hd(self) -> int:
    return self.head_dim or self.d_model // self.n_heads

  @property
  def n_blocks(self) -> int:
    if self.n_layers % len(self.block_pattern):
      raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a "
                       f"multiple of the pattern {len(self.block_pattern)}")
    return self.n_layers // len(self.block_pattern)

  def param_count(self, active: bool = False) -> int:
    """Every weight of :func:`param_shapes` but the stub's
    ``frontend_proj``.  Against the JAX count this adds the norm gains,
    the biases, the SSM's conv, ``A_log``, ``D`` and ``dt_bias`` and the
    dt columns of ``in_proj``, and charges a GELU MLP 2 d d_ff (JAX: 3 d
    d_ff).  ``active=True`` counts only ``top_k`` of each MoE layer's
    experts (the weights a token's FFN reads)."""
    n = 0
    for path, shape in leaves(param_shapes(self)):
      if path == "frontend_proj":
        continue
      if active and "/moe/w" in path:
        shape = (shape[0], self.moe.top_k, *shape[2:])
      n += math.prod(shape)
    return n


def _attn_shapes(c: ModelConfig, n: int, H: int, Hkv: int, hd: int) -> Dict:
  d = c.d_model
  p = {"wq": (n, d, H, hd), "wk": (n, d, Hkv, hd), "wv": (n, d, Hkv, hd),
       "wo": (n, H, hd, d)}
  if c.attn_bias:
    p["bq"] = (n, H, hd)
    p["bo"] = (n, d)
  return p


def _mla_shapes(c: ModelConfig, n: int) -> Dict:
  """MLA's attention leaves in the JAX layouts
  (``repro.models.attention.init_mla``)."""
  d, H, m = c.d_model, c.n_heads, c.mla
  return {"wq_a": (n, d, m.q_lora_rank), "q_norm": (n, m.q_lora_rank),
          "wq_b": (n, m.q_lora_rank, H, m.qk_nope_dim + m.qk_rope_dim),
          "wkv_a": (n, d, m.kv_lora_rank + m.qk_rope_dim),
          "kv_norm": (n, m.kv_lora_rank),
          "wk_b": (n, m.kv_lora_rank, H, m.qk_nope_dim),
          "wv_b": (n, m.kv_lora_rank, H, m.v_head_dim),
          "wo": (n, H, m.v_head_dim, d)}


def kv_dims(c: ModelConfig) -> Tuple[int, int]:
  """(Hkv, D) of the decode cache's rows: MLA's one latent head of
  kv_lora + rope (key and value leaves alike, as in JAX's ``_kv_dims``),
  else the config's kv heads of ``hd``."""
  if c.mla is not None:
    return 1, c.mla.kv_lora_rank + c.mla.qk_rope_dim
  return c.n_kv_heads, c.hd


def _mlp_shapes(c: ModelConfig, n: int, f: int) -> Dict:
  d = c.d_model
  if c.mlp_type == "gelu":
    return {"w1": (n, d, f), "b1": (n, f), "w2": (n, f, d), "b2": (n, d)}
  return {"w1": (n, d, f), "w3": (n, d, f), "w2": (n, f, d)}


def ssm_dims(c: ModelConfig) -> Tuple[int, int, int]:
  """(d_inner, SSM heads, conv channels) of a mamba layer."""
  s = c.ssm
  d_in = s.expand * c.d_model
  return d_in, d_in // s.head_dim, d_in + 2 * s.d_state


def _ssm_shapes(c: ModelConfig, n: int) -> Dict:
  d, s = c.d_model, c.ssm
  d_in, h, conv_dim = ssm_dims(c)
  return {"in_proj": (n, d, 2 * d_in + 2 * s.d_state + h),
          "conv_w": (n, s.d_conv, conv_dim), "conv_b": (n, conv_dim),
          "A_log": (n, h), "D": (n, h), "dt_bias": (n, h), "norm": (n, d_in),
          "out_proj": (n, d_in, d)}


def _moe_shapes(c: ModelConfig, n: int) -> Dict:
  d, m = c.d_model, c.moe
  e, f = m.num_experts, m.d_ff_expert
  p = {"router": (n, d, e), "w1": (n, e, d, f), "w3": (n, e, d, f),
       "w2": (n, e, f, d)}
  if m.num_shared:
    fs = f * m.num_shared
    p["shared"] = {"w1": (n, d, fs), "w3": (n, d, fs), "w2": (n, fs, d)}
  return p


def ssm_state_shapes(c: ModelConfig, B: int) -> Dict[str, Tuple[int, ...]]:
  """The mamba layers' decode state for a batch of B, stacked over the
  blocks and the pattern's mamba positions: ``conv_state`` (nb, ns, B,
  d_conv-1, conv_dim), the last inputs of the causal conv, and
  ``ssd_state`` (nb, ns, B, h, head_dim, d_state)."""
  s = c.ssm
  lead = (c.n_blocks, n_ssm_positions(c), B)
  _, h, conv_dim = ssm_dims(c)
  return {"conv_state": (*lead, s.d_conv - 1, conv_dim),
          "ssd_state": (*lead, h, s.head_dim, s.d_state)}


def _has_ffn(c: ModelConfig, spec: LayerSpec) -> bool:
  """Whether the layer has an FFN (and, unless the block is parallel, its
  ``ln2``): an MLP (d_ff > 0) or an MoE; mamba2's layers (d_ff = 0) have
  none."""
  return c.d_ff > 0 or (spec.use_moe and c.moe is not None)


def n_attn_positions(c: ModelConfig) -> int:
  """Attention positions of the pattern: the k / v and synopsis leaves are
  stacked over these only."""
  return sum(s.kind == "attn" for s in c.block_pattern)


def n_ssm_positions(c: ModelConfig) -> int:
  """Mamba positions of the pattern: the SSM state leaves' stack."""
  return sum(s.kind == "mamba" for s in c.block_pattern)


def param_shapes(c: ModelConfig) -> Dict:
  """The parameter tree's leaf shapes, with the JAX tree's keys: per
  pattern position ``blocks/pos<i>`` stacked over the ``n_blocks`` layers
  ({ln1, attn: {wq, wk, wv, wo[, bq, bo]} or ssm: {in_proj, conv_w,
  conv_b, A_log, D, dt_bias, norm, out_proj}, [ln_cross, cross: {...},]
  [ln2, mlp: {w1, w3, w2} or {w1, b1, w2, b2} or moe: {router, w1, w3,
  w2},] [ln1_post, ln2_post]}; a layer with no FFN, mamba2's, has no
  ``ln2``), then ``embed``, ``final_norm``, ``unembed`` (untied),
  ``frontend_proj`` (a stub) and ``encoder: {blocks: {ln1, attn, ln2,
  mlp} stacked over its layers, final_norm}``.  A parallel block
  (command-r) has no ``ln2``: its FFN reads the ``ln1``-normed input; an
  MoE layer with ``dense_parallel`` (arctic) has both ``moe`` and
  ``mlp``; with shared experts (deepseek) ``moe`` also holds ``shared:
  {w1, w3, w2}`` of width ``d_ff_expert * num_shared``; under MLA
  (deepseek) ``attn`` is {wq_a, q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b,
  wo}."""
  d, n = c.d_model, c.n_blocks
  blocks = {}
  for i, spec in enumerate(c.block_pattern):
    lp = {"ln1": (n, d)}
    if spec.kind == "attn" and c.mla is not None:
      lp["attn"] = _mla_shapes(c, n)
    elif spec.kind == "attn":
      lp["attn"] = _attn_shapes(c, n, c.n_heads, c.n_kv_heads, c.hd)
    else:
      lp["ssm"] = _ssm_shapes(c, n)
    if spec.cross_attn:
      lp["ln_cross"] = (n, d)
      lp["cross"] = _attn_shapes(c, n, c.n_heads, c.n_kv_heads, c.hd)
    ffn = _has_ffn(c, spec)
    if ffn and not c.parallel_block:
      lp["ln2"] = (n, d)
    if spec.use_moe and c.moe is not None:
      lp["moe"] = _moe_shapes(c, n)
      if c.moe.dense_parallel:
        lp["mlp"] = _mlp_shapes(c, n, c.d_ff)
    elif c.d_ff > 0:
      lp["mlp"] = _mlp_shapes(c, n, c.d_ff)
    if c.sandwich_norm:
      lp["ln1_post"] = (n, d)
      if ffn:
        lp["ln2_post"] = (n, d)
    blocks[f"pos{i}"] = lp
  out = {"blocks": blocks, "embed": (c.vocab, d), "final_norm": (d,)}
  if not c.tie_embeddings:
    out["unembed"] = (d, c.vocab)
  if c.frontend:
    out["frontend_proj"] = (c.frontend_dim, d)
  if c.encoder:
    ec = encoder_config(c)
    ne = ec.n_layers
    out["encoder"] = {
        "blocks": {"ln1": (ne, d),
                   "attn": _attn_shapes(ec, ne, ec.n_heads, ec.n_heads,
                                        ec.hd),
                   "ln2": (ne, d), "mlp": _mlp_shapes(ec, ne, ec.d_ff)},
        "final_norm": (d,)}
  return out


# Each leaf's logical axes (without the leading "layers" of a stacked
# leaf), by the dict that holds it: an attention's (``attn`` / ``cross``,
# MLA's leaves too), an MLP's (``mlp`` / ``moe/shared``), the MoE's, the
# SSM's; a layer's norm gains are ("embed",).
_LEAF_AXES = {
    "attn": {"wq": ("embed", "heads", None),
             "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None),
             "wo": ("heads", None, "embed"), "bq": ("heads", None),
             "bo": ("embed",), "wq_a": ("embed", "qlora"),
             "q_norm": ("qlora",), "wq_b": ("qlora", "heads", None),
             "wkv_a": ("embed", "kvlora"), "kv_norm": ("kvlora",),
             "wk_b": ("kvlora", "heads", None),
             "wv_b": ("kvlora", "heads", None)},
    "mlp": {"w1": ("embed", "ff"), "w3": ("embed", "ff"),
            "w2": ("ff", "embed"), "b1": ("ff",), "b2": ("embed",)},
    "moe": {"router": ("embed", "expert"), "w1": ("expert", "embed", "ff"),
            "w3": ("expert", "embed", "ff"), "w2": ("expert", "ff", "embed")},
    "ssm": {"in_proj": ("embed", "ssm_heads"),
            "conv_w": (None, "ssm_heads"), "conv_b": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "dt_bias": ("ssm_heads",), "norm": ("ssm_heads",),
            "out_proj": ("ssm_heads", "embed")},
}
_LEAF_AXES["cross"] = _LEAF_AXES["attn"]
_LEAF_AXES["shared"] = _LEAF_AXES["mlp"]
_TOP_AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
             "final_norm": ("embed",), "frontend_proj": (None, "embed")}


def param_axes(c: ModelConfig) -> Dict:
  """:func:`param_shapes`' tree with each leaf's logical axes in place of
  its shape: a stacked leaf (``blocks`` and ``encoder/blocks``) leads with
  "layers", then the axes of ``_LEAF_AXES``; the norm gains are
  ("embed",).  These are the JAX tree's ``Box`` axes, leaf for leaf."""
  def walk(tree, parent, stacked):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out[k] = walk(v, k, stacked or k == "blocks")
        continue
      if not stacked:
        ax = _TOP_AXES[k]
      elif parent in _LEAF_AXES:
        ax = ("layers",) + _LEAF_AXES[parent][k]
      else:                                   # ln1, ln2, ln_cross, *_post
        ax = ("layers", "embed")
      if len(ax) != len(v):
        raise AssertionError(f"axes {ax} of {k} do not fit its shape {v}")
      out[k] = ax
    return out
  return walk(param_shapes(c), None, False)


def encoder_config(c: ModelConfig) -> ModelConfig:
  """The config the encoder's layers run under (the JAX
  ``transformer._encoder_cfg``): its layers, heads (as many kv heads) and
  d_ff, one plain layer kind, no encoder."""
  e = c.encoder
  return dataclasses.replace(
      c, n_layers=e.n_layers, n_heads=e.n_heads, n_kv_heads=e.n_heads,
      d_ff=e.d_ff, moe=None, ssm=None, encoder=None,
      block_pattern=(LayerSpec(),))


def leaves(tree: Dict, prefix: str = ""):
  """(path "a/b/c", leaf) of a nested dict, in insertion order."""
  for k, v in tree.items():
    path = f"{prefix}{k}"
    if isinstance(v, dict):
      yield from leaves(v, path + "/")
    else:
      yield path, v
