"""AdamW with a warmup + cosine schedule, as functions over the parameter
dict (counterpart of ``repro.train.optimizer``).

f32 master weights and moments.  The update keeps the reference's order:
clip by the global norm, the bias corrections, ``sqrt(vhat) + eps``, then
the weight decay inside the lr product.

A tree may be a rank's shard (``dist.sharding.shard_tree``): the maps
carry each dict's ``_cut`` entry through unchanged, AdamW runs on the
shards as it is (it is elementwise), and :func:`global_norm` sums each cut
leaf's squares over the mesh axes it is cut over, so that every rank
clips by the whole tree's norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.dist import sharding as shd


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
  """``fn`` over the leaves of nested dicts with the first tree's keys; a
  cut tree's ``_cut`` entries are carried through unchanged."""
  if isinstance(trees[0], dict):
    return {k: trees[0][k] if k == shd.CUT_KEY else
            tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
  return fn(*trees)


def tree_leaves(tree):
  """The leaves of a nested dict, in its key order (``_cut`` entries are
  not leaves)."""
  if isinstance(tree, dict):
    return [x for k, v in tree.items() if k != shd.CUT_KEY
            for x in tree_leaves(v)]
  return [tree]


def leaf_cuts(tree):
  """The :class:`~repro_torch.dist.sharding.Cut` of each leaf of
  :func:`tree_leaves`, None where a leaf is whole."""
  if not isinstance(tree, dict):
    return [None]
  cuts = tree.get(shd.CUT_KEY, {})
  return [c for k, v in tree.items() if k != shd.CUT_KEY
          for c in (leaf_cuts(v) if isinstance(v, dict) else [cuts.get(k)])]


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


def global_norm(tree, mesh=None) -> torch.Tensor:
  """The L2 norm of every leaf.  On a cut tree the squares of the leaves
  cut over the same mesh axes are summed on the rank, then over those axes
  (one all-reduce of a scalar for each set of axes, in a fixed order, so
  that every rank gets the same bits); a whole leaf counts once.
  ``mesh`` defaults to the installed one."""
  leaves = tree_leaves(tree)
  cuts = leaf_cuts(tree)
  if not any(c is not None for c in cuts):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))
  mesh = mesh if mesh is not None else shd.active_mesh()
  groups = {}
  for x, c in zip(leaves, cuts):
    axes = tuple(a for a in mesh.axis_names if a in shd.cut_mesh_axes(c))
    sq = torch.sum(torch.square(x.float()))
    groups[axes] = sq if axes not in groups else groups[axes] + sq
  total = None
  for axes in sorted(groups):
    part = mesh.all_reduce(groups[axes], axes) if axes else groups[axes]
    total = part if total is None else total + part
  return torch.sqrt(total)


def adamw_update(grads, opt_state, params, cfg: OptConfig, mesh=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
  """One AdamW step on f32 params / grads (whole, or a rank's shards with
  ``mesh``, or the installed mesh, for the global norm).  Returns
  (params', opt', {"grad_norm", "lr"}); nothing is written in place."""
  step = opt_state["step"] + 1
  lr = schedule(cfg, step)
  gnorm = global_norm(grads, mesh)
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
  """Element ``i`` of each tuple leaf of ``tree`` (``_cut`` entries kept)."""
  if isinstance(tree, dict):
    return {k: v if k == shd.CUT_KEY else unzip(v, i)
            for k, v in tree.items()}
  return tree[i]
