"""Quantized synopsis representation (the port's own copy of
``repro.kernels.quant``, in torch).

``k_syn``/``v_syn`` are stored int8 or fp8-e4m3 with one f32 scale per
centroid row; under the ``+kv`` specs the sorted cache is stored quantized
too, with one f32 scale per C-row cluster block.  Symmetric and
zero-point-free:

  scale = amax(block) / qmax        (qmax: int8 -> 127, fp8-e4m3 -> 448)
  inv   = 1 / max(scale, 1e-30) where scale > 0, else 0
  q     = encode(x * inv)           (int8: round half to even, clip to
                                     +-127; fp8: clip to +-448, then cast)
  x^    = q.float() * scale

The rounding is deterministic on purpose: the CUDA kernels, the plain
versions and the JAX package must encode the same codes.  Dequantization
folds into the attention kernels: the k-scale multiplies the raw q.k
logits, the v-scale the softmax weights entering p.V (``l`` stays
unscaled).  Scale leaves have the shape of the tables without D, (..., M)
f32, so they concatenate along M like ``counts``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

# spec string -> (kind, quantize the sorted KV too?)
QSPECS = {
    "none": ("none", False),
    "int8": ("int8", False),
    "fp8": ("fp8", False),
    "int8+kv": ("int8", True),
    "fp8+kv": ("fp8", True),
}

# Arena scale leaves (all (..., M) f32): one scale per centroid row
# (k_syn_scale, v_syn_scale) and one per C-row sorted-KV block (k_scale,
# v_scale).
SCALE_LEAVES = ("k_syn_scale", "v_syn_scale", "k_scale", "v_scale")
SYN_SCALE_LEAVES = ("k_syn_scale", "v_syn_scale")
KV_SCALE_LEAVES = ("k_scale", "v_scale")

QDTYPES = (torch.int8, torch.float8_e4m3fn)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
  """Parsed spec: the numeric kind and whether the sorted KV is covered."""
  kind: str = "none"           # "none" | "int8" | "fp8"
  sorted_kv: bool = False

  @property
  def enabled(self) -> bool:
    return self.kind != "none"

  @property
  def spec(self) -> str:
    if not self.enabled:
      return "none"
    return self.kind + ("+kv" if self.sorted_kv else "")


def parse_qconfig(spec: Union[None, str, QuantConfig]) -> QuantConfig:
  """"none"/"int8"/"fp8"/"int8+kv"/"fp8+kv" (or None) -> QuantConfig."""
  if spec is None:
    return QuantConfig()
  if isinstance(spec, QuantConfig):
    return spec
  if spec not in QSPECS:
    raise ValueError(f"unknown quant spec {spec!r}; one of {list(QSPECS)}")
  kind, skv = QSPECS[spec]
  return QuantConfig(kind=kind, sorted_kv=skv)


def qdtype(kind: str) -> torch.dtype:
  if kind == "int8":
    return torch.int8
  if kind == "fp8":
    return torch.float8_e4m3fn
  raise ValueError(f"no quantized dtype for kind {kind!r}")


def qmax(kind: str) -> float:
  if kind == "int8":
    return 127.0
  if kind == "fp8":
    return 448.0               # float8_e4m3fn's largest finite value
  raise ValueError(f"no qmax for kind {kind!r}")


def kind_of(dtype: torch.dtype) -> str:
  """Storage dtype -> kind ("int8" / "fp8")."""
  for kind in ("int8", "fp8"):
    if dtype == qdtype(kind):
      return kind
  raise ValueError(f"{dtype} is not a quantized storage dtype")


def encode_scaled(y: torch.Tensor, kind: str) -> torch.Tensor:
  """Encode already-scaled f32 values into the storage dtype."""
  if kind == "int8":
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
  if kind == "fp8":
    return torch.clamp(y, -qmax(kind), qmax(kind)).to(qdtype(kind))
  raise ValueError(f"cannot encode kind {kind!r}")


def block_scale(x: torch.Tensor, kind: str) -> torch.Tensor:
  """Symmetric scale over the last dim (kept): amax / qmax, 0 for an
  all-zero block.  qmax is a tensor on purpose: on CUDA torch divides by a
  Python scalar as a product with its reciprocal, one ulp off the IEEE
  quotient that the kernels and the JAX package take."""
  amax = x.float().abs().amax(dim=-1, keepdim=True)
  return amax / torch.full_like(amax, qmax(kind))


def quantize_rows(x: torch.Tensor, kind: str,
                  block: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
  """Quantize (..., R, D) with one scale per ``block`` rows.  Returns
  (codes (..., R, D) in the storage dtype, scales (..., R // block) f32)."""
  *lead, R, D = x.shape
  if R % block:
    raise ValueError(f"{R} rows are not a multiple of block {block}")
  xb = x.float().reshape(*lead, R // block, block * D)
  scale = block_scale(xb, kind)                        # (..., R//block, 1)
  inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-30),
                    torch.zeros_like(scale))
  q = encode_scaled(xb * inv, kind).reshape(*lead, R, D)
  return q, scale[..., 0]


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    block: int = 1) -> torch.Tensor:
  """Inverse of :func:`quantize_rows`: f32 (..., R, D)."""
  s = torch.repeat_interleave(scales.float(), block, dim=-1)   # (..., R)
  return q.float() * s[..., None]


def gather_rows(x: torch.Tensor, dim: int, index: torch.Tensor
                ) -> torch.Tensor:
  """``torch.gather`` that also takes fp8 tensors (which torch's gather
  does not): one-byte codes are gathered as uint8 and viewed back."""
  if x.dtype == torch.float8_e4m3fn:
    return torch.gather(x.view(torch.uint8), dim, index).view(x.dtype)
  return torch.gather(x, dim, index)


def select_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """``x.index_select(0, index)`` that also takes fp8 tensors, as
  :func:`gather_rows`."""
  if x.dtype == torch.float8_e4m3fn:
    return x.view(torch.uint8).index_select(0, index).view(x.dtype)
  return x.index_select(0, index)
