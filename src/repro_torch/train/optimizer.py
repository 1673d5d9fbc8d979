"""AdamW with a warmup + cosine schedule, as functions over the parameter
dict (counterpart of ``repro.train.optimizer``).

f32 master weights and moments.  The update keeps the reference's order:
clip by the global norm, the bias corrections, ``sqrt(vhat) + eps``, then
the weight decay inside the lr product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
  lr: float = 3e-4
  b1: float = 0.9
  b2: float = 0.95
  eps: float = 1e-8
  weight_decay: float = 0.1
  warmup_steps: int = 100
  total_steps: int = 10000
  clip_norm: float = 1.0


def tree_map(fn, *trees):
  """``fn`` over the leaves of nested dicts with the first tree's keys."""
  if isinstance(trees[0], dict):
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
  return fn(*trees)


def tree_leaves(tree):
  """The leaves of a nested dict, in its key order."""
  if isinstance(tree, dict):
    return [x for v in tree.values() for x in tree_leaves(v)]
  return [tree]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
  """The learning rate at ``step`` (an int32 tensor), f32: linear warmup,
  then a cosine from ``lr`` down to 0.1 ``lr``."""
  warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
  t = torch.clamp((step - cfg.warmup_steps)
                  / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
  cos = 0.5 * (1 + torch.cos(math.pi * t))
  return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params) -> Dict[str, Any]:
  zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
  return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
          "step": torch.zeros((), dtype=torch.int32,
                              device=tree_leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
  return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                        for x in tree_leaves(tree)))


def adamw_update(grads, opt_state, params, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
  """One AdamW step on f32 params / grads.  Returns (params', opt',
  {"grad_norm", "lr"}); nothing is written in place."""
  step = opt_state["step"] + 1
  lr = schedule(cfg, step)
  gnorm = global_norm(grads)
  scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
  b1c = 1 - cfg.b1 ** step.float()
  b2c = 1 - cfg.b2 ** step.float()

  def upd(p, g, m, v):
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / b1c
    vhat = v / b2c
    new_p = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                      + cfg.weight_decay * p)
    return new_p, m, v

  out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
  new_p, new_m, new_v = (unzip(out, i) for i in range(3))
  return new_p, {"m": new_m, "v": new_v, "step": step}, {
      "grad_norm": gnorm, "lr": lr}


def unzip(tree, i: int):
  """Element ``i`` of each tuple leaf of ``tree``."""
  if isinstance(tree, dict):
    return {k: unzip(v, i) for k, v in tree.items()}
  return tree[i]
