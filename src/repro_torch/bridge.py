"""Bridge from the JAX package's state (leaves converted to numpy) to the
port's tensors.

* :func:`params_from_numpy`: the JAX parameter tree
  (``repro.models.transformer.init_model`` after ``common.split``) -> the
  port's parameters.  Parity tests need the same weights on both sides,
  and torch cannot replay JAX's RNG, so the tests draw the weights once in
  JAX and load them here.  Leaves are cast to ``cfg.dtype``, as the JAX
  launcher casts its params.
* :func:`arena_from_numpy`: a JAX synopsis cache or arena dict -> the
  port's, each leaf keeping its dtype (int8 and fp8 codes included).
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


def _leaf(a: np.ndarray, device) -> torch.Tensor:
  """One array, same dtype.  ``torch.from_numpy`` refuses the ml_dtypes
  float8_e4m3fn arrays that JAX hands out, so those cross as their bytes
  (uint8) and are viewed back as torch's float8_e4m3fn.  The array is
  copied: the port writes its cache in place (the recent ring)."""
  a = np.array(a, order="C")
  if a.dtype.name == "float8_e4m3fn":
    return torch.from_numpy(a.view(np.uint8)).view(
        torch.float8_e4m3fn).to(device)
  return torch.from_numpy(a).to(device)


def arena_from_numpy(arena: Dict, device) -> Dict[str, torch.Tensor]:
  """{leaf name: numpy array} -> {leaf name: tensor} on ``device``."""
  return {k: _leaf(v, torch.device(device))
          for k, v in arena.items()}


def params_from_numpy(tree: Dict, cfg: ModelConfig, device) -> Dict:
  """The JAX tree -> the port's parameters.  A tied config's tree has no
  ``unembed`` (the logits read ``embed``), an untied one needs it; under
  sandwich norms every layer carries ``ln1_post`` and ``ln2_post``; a
  frontend needs ``frontend_proj``."""
  tf.check_supported(cfg)
  want = {"embed", "final_norm", "blocks"}
  if not cfg.tie_embeddings:
    want.add("unembed")
  if cfg.frontend:
    want.add("frontend_proj")
  missing = want - set(tree)
  if cfg.sandwich_norm:
    missing |= {f"blocks/{pos}/{name}" for pos, lp in tree.get(
        "blocks", {}).items() for name in ("ln1_post", "ln2_post")
                if name not in lp}
  if missing:
    raise KeyError(f"parameter tree lacks {sorted(missing)}")
  return tf.finish_params(_convert(tree, cfg.dtype, torch.device(device)),
                          cfg)
