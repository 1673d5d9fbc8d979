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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

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


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig, *,
                    microbatches: int = 1, compress_pods: bool = False,
                    mesh=None, causal_skip: bool = False):
  """Returns train_step(state, batch) -> (state', metrics) with metrics
  {"loss", "ce", "aux", "grad_norm", "lr"}.  ``compress_pods`` quantises
  the cross-pod reduction of a mesh; without a mesh it does nothing, as in
  the reference.  A mesh (the sharded path) is not ported yet."""
  if mesh is not None:
    raise NotImplementedError("the sharded train step needs a mesh, which "
                              "the port does not have yet (ROADMAP A.7c)")
  del compress_pods

  def train_step(state: Dict, batch: Dict):
    loss, metrics, grads = loss_and_grads(
        cfg, state["params"], batch, microbatches=microbatches,
        causal_skip=causal_skip)
    with torch.no_grad():
      new_params, new_opt, om = opt_lib.adamw_update(
          grads, state["opt"], state["params"], opt_cfg)
    return ({**state, "params": new_params, "opt": new_opt},
            {"loss": loss, **metrics, **om})

  return train_step
