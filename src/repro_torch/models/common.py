"""Model configs: the port's own copy of ``repro.models.common``'s config
dataclasses, cut to what the dense GQA serving path reads.  ``dtype`` is a
torch dtype."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
  kind: str = "attn"              # the only layer kind the port runs


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
    c = self
    per = c.d_model * c.hd * (c.n_heads * 2 + c.n_kv_heads * 2)
    per += 3 * c.d_model * c.d_ff + 2 * c.d_model
    return 2 * c.vocab * c.d_model + c.d_model + per * c.n_layers
