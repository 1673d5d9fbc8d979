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
batch, and the gradients are averaged over the pod and data ranks
(:func:`mesh_loss_and_grads`): the global-mean gradient of the
reference's GSPMD step, summed in rank order, so that it equals the
one-rank step with the shares as its microbatches, bit for bit.  An MoE
layer groups the tokens of each rank's share, the reference's grouping per
data-parallel shard.  With ``compress_pods`` the cross-pod reduction then
goes through ``compression.compressed_pod_psum``, as in the reference.
Ranks along `model` hold the weights whole and compute the same thing:
the serving path cuts its weights by the rule tables
(``dist.sharding.shard_params``), but the train step's tensor-parallel
weights over `model` and FSDP over `data`, which need a backward for each
hand-written collective, are ROADMAP A.7d-ii; ``transformer``'s training
forward refuses a cut tree.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.dist import sharding as shd
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
  """:func:`loss_and_grads` of this rank's share of the global ``batch``,
  then the loss, the metrics and the gradients averaged over the mesh's
  pod and data ranks: one all-reduce of the gradients packed flat, summed
  in rank order (``Mesh.all_reduce``)."""
  loss, metrics, grads = loss_and_grads(
      cfg, params, shard_batch(batch, mesh), microbatches=microbatches,
      causal_skip=causal_skip)
  axes = dp_axes(mesh)
  if not axes:
    return loss, metrics, grads
  leaves = tree_leaves(grads)
  flat = torch.cat([g.reshape(-1) for g in leaves]
                   + [torch.stack([loss.float().reshape(()), *(
                       metrics[k].float().reshape(()) for k in metrics)])])
  flat = mesh.all_reduce(flat, axes, op="mean")
  out, at = [], 0
  for g in leaves:
    out.append(flat[at:at + g.numel()].view_as(g))
    at += g.numel()
  tail = flat[at:]
  it = iter(out)
  return (tail[0], {k: tail[1 + i] for i, k in enumerate(metrics)},
          tree_map(lambda _: next(it), grads))


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig, *,
                    microbatches: int = 1, compress_pods: bool = False,
                    mesh=None, causal_skip: bool = False):
  """Returns train_step(state, batch) -> (state', metrics) with metrics
  {"loss", "ce", "aux", "grad_norm", "lr"}.  With ``mesh`` (the port's
  ``Mesh``; anything else raises ``TypeError``) ``batch`` is the global
  batch and each rank steps on its share (see the module doc);
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
          grads, state["opt"], state["params"], opt_cfg)
    return ({**state, "params": new_params, "opt": new_opt},
            {"loss": loss, **metrics, **om})

  return train_step
