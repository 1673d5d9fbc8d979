"""Error-feedback int8 gradient quantisation (counterpart of
``repro.train.compression``).

Per leaf: q = int8(g + err) with one f32 scale, err' = (g + err) -
deq(q); the residual is added back on the next step, so the quantisation
is unbiased over steps.  Within a pod, gradients reduce over `data`
uncompressed; across pods (:func:`compressed_pod_psum`, on a mesh with a
`pod` axis) each rank all-gathers the pods' int8 codes and f32 scales (1
byte a parameter on the wire, and one scale a leaf, instead of 4) and
sums the dequantised copies itself.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.train.optimizer import tree_map, unzip


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  scale = g.abs().max() / 127.0 + 1e-12
  q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
  return q, scale


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

  def one(g, e):
    g32 = g.float() + e
    q, scale = _quantise(g32)
    deq = q.float() * scale
    q_all = mesh.all_gather(q, axis_name, dim=0, tiled=False)
    s_all = mesh.all_gather(scale.reshape(1), axis_name, dim=0)
    summed = s_all[0] * q_all[0].float()
    for p in range(1, q_all.shape[0]):
      summed = summed + s_all[p] * q_all[p].float()
    return summed, g32 - deq

  out = tree_map(one, grads, err)
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
