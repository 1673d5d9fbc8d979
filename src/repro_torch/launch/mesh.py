"""Production and debug meshes over the ``torch.distributed`` world
(counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the `pod` axis carries pure DP and the compressed
cross-pod gradient reduction (``train.compression``).  Defined as
functions: building a mesh creates process groups, which is collective
over the world.
"""
from __future__ import annotations

import math

from repro_torch.dist import world
from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
  """The production mesh over the first 256 (512) ranks of the world;
  fewer ranks raise, with the reference's message."""
  shape = (2, 16, 16) if multi_pod else (16, 16)
  axes = ("pod", "data", "model") if multi_pod else ("data", "model")
  n = math.prod(shape)
  have = world.world_size()
  if have < n:
    raise RuntimeError(
        f"need {n} devices for mesh {dict(zip(axes, shape))}, have {have} "
        f"ranks: start {n} (torchrun --nproc-per-node, or "
        f"repro_torch.dist.world.run_world)")
  return Mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
  """A small mesh over the first prod(shape) ranks of the world (tests)."""
  return Mesh(shape, axes)
