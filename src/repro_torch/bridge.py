"""Bridge from the JAX package's state (leaves converted to numpy) to the
port's tensors.

* :func:`params_from_numpy`: the JAX parameter tree
  (``repro.models.transformer.init_model`` after ``common.split``) -> the
  port's parameters.  Parity tests need the same weights on both sides,
  and torch cannot replay JAX's RNG, so the tests draw the weights once in
  JAX and load them here.  Leaves are cast to ``cfg.dtype``, as the JAX
  launcher casts its params.
* :func:`shard_params_from_numpy`: the same, then this rank's shard of
  it under a rule table (``dist.sharding.shard_params``), so that every
  rank of a mesh holds its cut of the JAX package's global weights.
* :func:`arena_from_numpy`: a JAX synopsis cache or arena dict -> the
  port's, each leaf keeping its dtype (int8 and fp8 codes included).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, leaves, param_shapes


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
  """The JAX tree -> the port's parameters.  The tree must hold every leaf
  of ``common.param_shapes`` at its shape: a tied config's has no
  ``unembed`` (the logits read ``embed``), an untied one needs it; under
  sandwich norms every layer carries ``ln1_post`` and ``ln2_post``; a stub
  frontend needs ``frontend_proj``; whisper its attention biases, every
  layer's ``cross`` and ``ln_cross``, the GELU biases and the encoder
  tree; a mamba layer its ``ssm`` leaves (``A_log``, ``D`` and
  ``dt_bias`` cast like the rest, as the JAX launcher casts them) and no
  ``ln2`` / ``mlp`` where d_ff = 0; an MoE layer its ``moe`` leaves (and
  ``mlp`` beside them under ``dense_parallel``); a parallel block no
  ``ln2``.  Nor may the tree hold a leaf that ``param_shapes`` lacks:
  weights the port would not read raise instead of loading silently."""
  tf.check_supported(cfg)
  shapes = dict(leaves(param_shapes(cfg)))
  missing, wrong = [], []
  for path, shape in shapes.items():
    node = tree
    for key in path.split("/"):
      node = node.get(key) if isinstance(node, dict) else None
    if node is None:
      missing.append(path)
    elif tuple(np.shape(node)) != tuple(shape):
      wrong.append(f"{path} {np.shape(node)} != {shape}")
  extra = [path for path, _ in leaves(tree) if path not in shapes]
  if missing or wrong or extra:
    raise KeyError(f"parameter tree lacks {missing}, shapes differ {wrong}, "
                   f"leaves not in the config's tree {extra}")
  return tf.finish_params(_convert(tree, cfg.dtype, torch.device(device)),
                          cfg)


def shard_params_from_numpy(tree: Dict, cfg: ModelConfig, device, mesh,
                            rules):
  """:func:`params_from_numpy`, then this rank's shard under ``rules`` on
  ``mesh``: (the rank's tree, the spec tree), as
  ``dist.sharding.shard_params`` returns them."""
  return shd.shard_params(params_from_numpy(tree, cfg, device), cfg, mesh,
                          rules)
