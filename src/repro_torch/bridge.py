"""Weights bridge: the JAX parameter tree (``repro.models.transformer
.init_model`` after ``common.split``, leaves converted to numpy) -> the
port's parameters.

Parity tests need the same weights on both sides, and torch cannot replay
JAX's RNG, so the tests draw the weights once in JAX and load them here.
Leaves are cast to ``cfg.dtype``, as the JAX launcher casts its params.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig


def _convert(tree, dtype, device):
  if isinstance(tree, dict):
    return {k: _convert(v, dtype, device) for k, v in tree.items()}
  return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
      device=device, dtype=dtype)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device) -> Dict:
  tf.check_supported(cfg)
  missing = {"embed", "final_norm", "blocks", "unembed"} - set(tree)
  if missing:
    raise KeyError(f"parameter tree lacks {sorted(missing)}")
  return tf.finish_params(_convert(tree, cfg.dtype, torch.device(device)))
