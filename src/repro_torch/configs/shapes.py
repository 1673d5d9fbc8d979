"""The dry run's input shapes and per-(arch x shape) input specs
(counterpart of ``repro.configs.shapes``).

Four shapes per architecture:
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill_step
  decode_32k   seq=32768  global_batch=128   -> serve_step (one new token,
                                                a KV cache of seq_len)
  long_500k    seq=524288 global_batch=1     -> serve_step (synopsis
                                                attention / SSM)

:func:`input_specs` returns tensors on the ``meta`` device by default: no
storage, only shapes and dtypes.  The modality frontends are stubs: whisper
takes precomputed frame embeddings, pixtral patch embeddings.  Train and
prefill token ids are int32 (the data pipeline's); a decode step's token
is int64, the ``argmax`` of the previous step's logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
  name: str
  seq_len: int
  global_batch: int
  kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, torch.Tensor]:
  """Every model input of this cell, as empty tensors on ``device``: the
  frontend stub's embeddings in ``cfg.dtype`` (pixtral's patches take
  ``frontend_tokens`` of the sequence; whisper's frames are the encoder's
  ``source_len``), ``tokens`` and, to train, ``labels``; a decode cell's
  one new token a sequence (its KV cache is ``kv_cache.cache_struct``'s)."""
  B, S = shape.global_batch, shape.seq_len
  specs: Dict[str, torch.Tensor] = {}

  def empty(sh, dt):
    return torch.empty(sh, dtype=dt, device=device)

  if shape.kind in ("train", "prefill"):
    text = S
    if cfg.frontend == "vision_stub":
      text = S - cfg.frontend_tokens
      specs["frontend_embeds"] = empty(
          (B, cfg.frontend_tokens, cfg.frontend_dim), cfg.dtype)
    if cfg.encoder is not None:
      specs["frontend_embeds"] = empty(
          (B, cfg.encoder.source_len, cfg.frontend_dim), cfg.dtype)
    specs["tokens"] = empty((B, text), torch.int32)
    if shape.kind == "train":
      specs["labels"] = empty((B, text), torch.int32)
  else:
    specs["tokens"] = empty((B, 1), torch.long)
  return specs
