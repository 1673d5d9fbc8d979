"""Production and debug meshes over the ``torch.distributed`` world
(counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the `pod` axis carries pure DP and the compressed
cross-pod gradient reduction (``train.compression``).  Defined as
functions: building a mesh creates process groups, which is collective
over the world.  :func:`make_abstract_production_mesh` gives one rank of
the same shapes with no world (``dist.sharding.AbstractMesh``): the dry
run traces that rank's program on it.
"""
from __future__ import annotations

import math

from repro_torch.dist import world
from repro_torch.dist.sharding import AbstractMesh, Mesh


def _production(multi_pod: bool):
  """(shape, axis names) of the production mesh."""
  if multi_pod:
    return (2, 16, 16), ("pod", "data", "model")
  return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
  """The production mesh over the first 256 (512) ranks of the world;
  fewer ranks raise, with the reference's message."""
  shape, axes = _production(multi_pod)
  n = math.prod(shape)
  have = world.world_size()
  if have < n:
    raise RuntimeError(
        f"need {n} devices for mesh {dict(zip(axes, shape))}, have {have} "
        f"ranks: start {n} (torchrun --nproc-per-node, or "
        f"repro_torch.dist.world.run_world)")
  return Mesh(shape, axes)


def make_abstract_production_mesh(*, multi_pod: bool = False,
                                  rank: int = 0) -> AbstractMesh:
  """Rank ``rank`` of the production mesh, with no world (the dry run)."""
  shape, axes = _production(multi_pod)
  return AbstractMesh(shape, axes, rank=rank)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
  """A small mesh over the first prod(shape) ranks of the world (tests)."""
  return Mesh(shape, axes)
