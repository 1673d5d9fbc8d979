"""Model configs: the port's own copy of ``repro.models.common``'s config
dataclasses, cut to what the dense GQA serving path reads (llama3's global
attention; gemma2's local layers, softcaps, sandwich norms, embedding
scale and tied embeddings; pixtral's vision-stub patch prefix).  ``dtype``
is a torch dtype."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
  kind: str = "attn"              # the only layer kind the port runs
  local: bool = False             # sliding-window attention (gemma2)


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
  sandwich_norm: bool = False             # post-block norms (gemma2)
  scale_embed: bool = False               # sqrt(d) embedding scale (gemma2)
  tie_embeddings: bool = False            # logits read embed.T (gemma2)
  # "vision_stub" (pixtral): precomputed patch embeddings, projected by
  # ``frontend_proj`` (frontend_dim, d), prefix the prompt's text.
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

  def param_count(self) -> int:
    """The JAX count plus the norm gains; like the JAX count it leaves
    out ``frontend_proj``."""
    c = self
    per = c.d_model * c.hd * (c.n_heads * 2 + c.n_kv_heads * 2)
    per += 3 * c.d_model * c.d_ff + 2 * c.d_model
    if c.sandwich_norm:
      per += 2 * c.d_model
    embed = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
    return embed + c.d_model + per * c.n_layers
