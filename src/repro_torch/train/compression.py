"""Error-feedback int8 gradient quantisation (counterpart of
``repro.train.compression``).

Per leaf: q = int8(g + err) with one f32 scale, err' = (g + err) -
deq(q); the residual is added back on the next step, so the quantisation
is unbiased over steps.  Within a pod, gradients reduce over `data`
uncompressed; across pods (:func:`compressed_pod_psum`, on a mesh with a
`pod` axis) each rank all-gathers the pods' int8 codes and f32 scales (1
byte a parameter on the wire, and one scale a leaf, instead of 4) and
sums the dequantised copies itself.

On a cut tree (``dist.sharding.shard_tree``) a leaf's scale is that of
the whole leaf, as in the reference, whose GSPMD keeps the `data` and
`model` cuts: the max of ``|g + err|`` over the mesh axes the leaf is cut
over (an all-gather of one scalar a rank).  The codes of a shard are then
the whole leaf's codes of its block.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.train.optimizer import (leaf_cuts, tree_leaves, tree_map,
                                        unzip)


def _quantise(g: torch.Tensor, mesh=None, axes: Tuple[str, ...] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(int8 codes, f32 scale) of ``g``, a whole leaf or a rank's block of
  one cut over ``axes`` (the scale the whole leaf's)."""
  amax = g.abs().max()
  if axes:
    amax = mesh.all_gather(amax.reshape(1), axes, dim=0).max()
  scale = amax / 127.0 + 1e-12
  q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
  return q, scale


def _map_cut(fn, grads, err):
  """``fn(cut, g, e)`` over the leaves of two trees of the same cuts, as
  a tree of its results (the first tree's ``_cut`` entries carried)."""
  it = iter([fn(c, g, e) for c, g, e in zip(
      leaf_cuts(grads), tree_leaves(grads), tree_leaves(err))])

  def rebuild(tree):
    if isinstance(tree, dict):
      return {k: v if k == shd.CUT_KEY else rebuild(v)
              for k, v in tree.items()}
    return next(it)
  return rebuild(grads)


def compressed_pod_psum(grads, err, axis_name: str = "pod", mesh=None):
  """Per leaf: q = int8(g + err); all-gather q and its scale over
  ``axis_name``; summed = sum over the pods of scale_p * q_p, in pod
  order; err' = (g + err) - deq(q).  Returns (summed grads, new err).

  ``mesh`` defaults to the installed one (``dist.sharding.use_mesh``).
  As in the reference, the gradients come in replicated (already the
  global mean), so the pods' codes are equal and summed / npods is
  exactly :func:`local_quantise_feedback`'s dequantised gradient.  With no
  mesh, or one without ``axis_name``, it raises the reference's
  ``NameError`` (the collective has no axis of that name)."""
  mesh = mesh if mesh is not None else shd.current_mesh()
  if mesh is None or axis_name not in mesh.shape:
    raise NameError(f"unbound axis name: {axis_name}")
  shd.require_mesh(mesh)

  def one(cut, g, e):
    g32 = g.float() + e
    q, scale = _quantise(g32, mesh, shd.cut_mesh_axes(cut))
    deq = q.float() * scale
    q_all = mesh.all_gather(q, axis_name, dim=0, tiled=False)
    s_all = mesh.all_gather(scale.reshape(1), axis_name, dim=0)
    summed = s_all[0] * q_all[0].float()
    for p in range(1, q_all.shape[0]):
      summed = summed + s_all[p] * q_all[p].float()
    return summed, g32 - deq

  out = _map_cut(one, grads, err)
  return unzip(out, 0), unzip(out, 1)


def local_quantise_feedback(grads, err):
  """Quantise-dequantise + error feedback without the collective: the
  numerics of :func:`compressed_pod_psum` on one device.  Returns
  (dequantised grads, new error)."""
  def one(g, e):
    g32 = g.float() + e
    q, scale = _quantise(g32)
    deq = q.float() * scale
    return deq, g32 - deq

  out = tree_map(one, grads, err)
  return unzip(out, 0), unzip(out, 1)


def init_error_feedback(params) -> Any:
  return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
