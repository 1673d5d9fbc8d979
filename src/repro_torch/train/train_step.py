"""The train step: microbatched gradients with remat, then AdamW
(counterpart of ``repro.train.train_step``).

State: {"params": f32 master weights, "opt": {"m", "v", "step"}} (and
"err", the error feedback, when built with ``compress``).  The step casts
the master weights to ``cfg.dtype``, runs the forward and backward of
``transformer.forward_loss`` on each of ``microbatches`` slices of the
batch (each layer and each loss chunk recomputed in the backward), sums
the slices' gradients in f32 and divides by their count, and applies
AdamW in f32.  Causal attention is the differentiable
``layers.causal_attention`` on every device, never the prefill kernel,
which has no backward.

On a mesh (``make_train_step(mesh=...)``, the port's ``dist.sharding.
Mesh``) every rank runs the step on its (pod, data) share of the global
batch (:func:`shard_batch`), which it is given.  An MoE layer groups the tokens of each rank's share, the
reference's grouping per data-parallel shard.  The state is whole on
every rank, or each rank's shard of it (:func:`shard_train_state`: the
reference's state under ``TRAIN_RULES``, tensor-parallel over `model` and
FSDP, the weights' ``embed`` dim, over `data`).  On a cut state the
forward gathers each layer's FSDP leaves inside its checkpointed function
and keeps the `model` cuts, and every collective has its backward
(``dist.sharding``): ``gather_fsdp``'s reduce-scatter sums an FSDP leaf's
gradient over the ranks its gather spans.  :func:`mesh_loss_and_grads`
then sums each leaf's gradient over the (pod, data) axes it is not yet
summed over, in rank order (``Mesh.all_reduce``), and divides by the
(pod, data) count: the global-mean gradient of the reference's GSPMD
step.  No leaf is summed over `model`: every rank's cotangent of a
replicated tensor is whole (``dist.sharding.enter``).  On a whole state
all of it is one all-reduce of the gradients packed flat, so that it
equals the one-rank step with the shares as its microbatches, bit for
bit.  With ``compress_pods`` the cross-pod reduction then goes through
``compression.compressed_pod_psum``, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import tree_leaves, tree_map


def init_train_state(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig, *,
                     generator: torch.Generator, device,
                     compress: bool = False) -> Dict:
  """Random f32 master weights (``transformer.init_params``'s init),
  zero moments and step 0."""
  del opt_cfg
  params = tf.init_params(cfg, generator, device, torch.float32)
  state = {"params": params, "opt": opt_lib.init_opt_state(params)}
  if compress:
    state["err"] = comp.init_error_feedback(params)
  return state


def loss_and_grads(cfg: ModelConfig, params, batch: Dict, *,
                   microbatches: int = 1, causal_skip: bool = False):
  """(loss, metrics, f32 grads of the master ``params``) of one batch
  {"tokens", "labels"[, "frontend_embeds"]} (B leading).  The loss is the
  mean over the microbatches, the metrics the last one's, the gradients
  the f32 sum over them divided by their count; a parameter the loss does
  not reach gets zeros."""
  B = batch["tokens"].shape[0]
  if B % microbatches:
    raise ValueError(f"batch {B} is not a multiple of {microbatches} "
                     "microbatches")
  masters = tree_map(lambda p: p.detach().requires_grad_(True), params)
  leaves = tree_leaves(masters)
  n = B // microbatches
  grads, loss = None, 0.0
  for i in range(microbatches):
    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
    cast = tree_map(lambda p: p.to(cfg.dtype), masters)
    l, metrics = tf.forward_loss(cast, cfg, mb["tokens"], mb["labels"],
                                 mb.get("frontend_embeds"),
                                 causal_skip=causal_skip)
    g = torch.autograd.grad(l, leaves, allow_unused=True)
    g = [torch.zeros_like(p) if gi is None else gi.float()
         for p, gi in zip(leaves, g)]
    grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    loss = loss + l.detach()
  if microbatches > 1:
    grads = [g / microbatches for g in grads]
  it = iter(grads)
  metrics = {k: v.detach() for k, v in metrics.items()}
  return loss / microbatches, metrics, tree_map(lambda _: next(it), params)


def _each_tree(fn, state: Dict) -> Dict:
  """``fn`` over the state's trees of the parameters' shape (the master,
  ``m``, ``v`` and ``err``); ``step`` as it is."""
  out = {"params": fn(state["params"]),
         "opt": {"m": fn(state["opt"]["m"]), "v": fn(state["opt"]["v"]),
                 "step": state["opt"]["step"]}}
  if "err" in state:
    out["err"] = fn(state["err"])
  return out


def shard_train_state(state: Dict, cfg: ModelConfig, mesh,
                      rules: Dict) -> Dict:
  """This rank's shard of a whole train state under ``rules`` (the
  reference's ``state_shardings``): the f32 master, ``m``, ``v`` and
  ``err`` cut leaf by leaf by ``common.param_axes``, as
  ``dist.sharding.shard_params`` cuts weights, but with no f32 unembedding
  beside a tied ``embed`` (AdamW would train it); ``step`` whole."""
  axes = cm.param_axes(cfg)
  return _each_tree(lambda t: shd.shard_tree(t, axes, mesh, rules)[0],
                    state)


def unshard_train_state(state: Dict, mesh) -> Dict:
  """The whole train state from the ranks' shards (the inverse of
  :func:`shard_train_state`; collective: every member of ``mesh`` calls
  it); a whole state as it is."""
  if not shd.is_cut(state["params"]):
    return state
  return _each_tree(lambda t: shd.unshard_tree(t, mesh), state)


def dp_axes(mesh) -> tuple:
  """The mesh axes the batch is split over (`pod`, `data`)."""
  return tuple(a for a in ("pod", "data") if a in mesh.shape)


def shard_batch(batch: Dict, mesh) -> Dict:
  """This rank's share of a global batch: its contiguous rows, in the
  order of its combined (pod, data) index."""
  axes = dp_axes(mesh)
  if not axes:
    return batch
  n, i = mesh.axis_size(axes), mesh.index(axes)
  B = batch["tokens"].shape[0]
  if B % n:
    raise ValueError(f"batch {B} does not split over {n} (pod, data) ranks")
  rows = B // n
  return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def mesh_loss_and_grads(cfg: ModelConfig, params, batch: Dict, mesh, *,
                        microbatches: int = 1, causal_skip: bool = False):
  """:func:`loss_and_grads` of ``batch``, this rank's share of the global
  batch (:func:`shard_batch`), under ``mesh`` (installed here with the
  rules installed now), then the loss, the metrics and the gradients
  averaged over the mesh's pod and data ranks: each leaf summed over the
  (pod, data) axes its FSDP gather has not summed it over, packed flat by
  those axes (one all-reduce for each set, summed in rank order,
  ``Mesh.all_reduce``), then divided by the (pod, data) count."""
  with shd.use_mesh(mesh, shd.current_rules()):
    loss, metrics, grads = loss_and_grads(
        cfg, params, batch, microbatches=microbatches,
        causal_skip=causal_skip)
  axes = dp_axes(mesh)
  if not axes:
    return loss, metrics, grads
  n = mesh.axis_size(axes)
  leaves = tree_leaves(grads)
  cuts = opt_lib.leaf_cuts(grads)
  tail = torch.stack([loss.float().reshape(()), *(
      metrics[k].float().reshape(()) for k in metrics)])
  groups: Dict[tuple, list] = {axes: []}
  for i, c in enumerate(cuts):
    fsdp = shd.fsdp_axes(c)
    groups.setdefault(tuple(a for a in axes if a not in fsdp), []).append(i)
  out = [None] * len(leaves)
  for red, idx in groups.items():
    parts = [leaves[i].reshape(-1) for i in idx]
    if red == axes:
      parts.append(tail)
    flat = torch.cat(parts)
    flat = (mesh.all_reduce(flat, red) if red else flat) / n
    at = 0
    for i in idx:
      out[i] = flat[at:at + leaves[i].numel()].view_as(leaves[i])
      at += leaves[i].numel()
    if red == axes:
      tail = flat[at:]
  it = iter(out)
  return (tail[0], {k: tail[1 + i] for i, k in enumerate(metrics)},
          tree_map(lambda _: next(it), grads))


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig, *,
                    microbatches: int = 1, compress_pods: bool = False,
                    mesh=None, causal_skip: bool = False):
  """Returns train_step(state, batch) -> (state', metrics) with metrics
  {"loss", "ce", "aux", "grad_norm", "lr"}.  With ``mesh`` (the port's
  ``Mesh``; anything else raises ``TypeError``) ``batch`` is this rank's
  share of the global batch (:func:`shard_batch`), and each rank steps on
  it with its state whole or cut (see the module doc);
  ``compress_pods`` then quantises the cross-pod reduction of a mesh with
  a `pod` axis (its state needs ``err``: ``init_train_state(compress=
  True)``).  Without a mesh ``compress_pods`` does nothing, as in the
  reference."""
  if mesh is not None:
    shd.require_mesh(mesh)
  compress = compress_pods and mesh is not None and "pod" in mesh.shape

  def train_step(state: Dict, batch: Dict):
    if mesh is None:
      loss, metrics, grads = loss_and_grads(
          cfg, state["params"], batch, microbatches=microbatches,
          causal_skip=causal_skip)
    else:
      loss, metrics, grads = mesh_loss_and_grads(
          cfg, state["params"], batch, mesh, microbatches=microbatches,
          causal_skip=causal_skip)
    if compress:
      with torch.no_grad():
        grads, err = comp.compressed_pod_psum(grads, state["err"], "pod",
                                              mesh=mesh)
        npods = mesh.shape["pod"]
        grads = tree_map(lambda g: g / npods, grads)
      state = {**state, "err": err}
    with torch.no_grad():
      new_params, new_opt, om = opt_lib.adamw_update(
          grads, state["opt"], state["params"], opt_cfg, mesh=mesh)
    return ({**state, "params": new_params, "opt": new_opt},
            {"loss": loss, **metrics, **om})

  return train_step
