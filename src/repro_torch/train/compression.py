"""Error-feedback int8 gradient quantisation (counterpart of
``repro.train.compression``).

Per leaf: q = int8(g + err) with one f32 scale, err' = (g + err) -
deq(q); the residual is added back on the next step, so the quantisation
is unbiased over steps.  The reference applies it to the cross-pod
all-reduce of a mesh; the port has no mesh yet (ROADMAP A.7c), so
:func:`compressed_pod_psum` refuses and the train step, like the
reference's without a mesh, does not compress.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.optimizer import tree_map, unzip


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  scale = g.abs().max() / 127.0 + 1e-12
  q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
  return q, scale


def compressed_pod_psum(grads, err, axis_name: str = "pod"):
  """The cross-pod int8 all-gather of the reference's mesh path."""
  raise NotImplementedError(
      "compressed_pod_psum reduces across the pods of a mesh; the port has "
      "no mesh yet (ROADMAP A.7c)")


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
