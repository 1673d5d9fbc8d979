"""Logical-axis sharding: rule tables, the mesh context and the port's mesh
of ``torch.distributed`` ranks (counterpart of ``repro.dist.sharding``).

Every tensor carries *logical* axis names (``"batch"``, ``"heads"``,
``"kv_seq"`` ...) instead of mesh axes.  A *rule table* maps logical names
to mesh axes; :func:`mesh_axes_for` resolves one tensor's logical axes
against a table with two safety rails:

  * divisibility: a dim that does not divide evenly over its mesh axes
    falls back to replication (trailing mesh axes are dropped first, so a
    two-axis rule can degrade to one axis before giving up);
  * no double use: a mesh axis consumed by an earlier dim of the same
    tensor is unavailable to later dims (first dim wins).

Rule tables (all derive from :data:`DEFAULT_RULES`):

  * TRAIN_RULES: TP over `model` + FSDP (the weight ``embed`` dim over
    `data`);
  * SERVE_RULES: decode; the KV cache / synopsis ``kv_seq`` axis over
    `model`: each shard is one paper "component" of the scatter-gather;
  * LONG_RULES: ``kv_seq`` over ``(data, model)``, batch over `pod` only.

A resolved spec is a plain tuple with the entries of a ``PartitionSpec``:
None (replicated), a mesh axis name, or a tuple of them.

The active (mesh, rules) pair is installed with :func:`use_mesh`.  Unlike
JAX's, the port's programs are SPMD by hand: every rank of a :class:`Mesh`
runs the same step on its own shard and calls the collectives itself, so
there is no ``shard_map`` (each sharded body runs directly on its rank)
and :func:`constrain` has nothing to do.

:class:`Mesh` lays ``prod(shape)`` ranks of the ``torch.distributed``
world out row-major over named axes (the first ``prod(shape)`` ranks; a
larger world's other ranks take part in building it and in nothing
else).  Its collectives run over one process group for each line of each
set of axes.  On the gloo backend a CUDA tensor's collective is staged
through host memory by the helper (the operands are copied to the host,
gathered there and copied back); the compute never leaves the card.  The
backend is chosen when the world starts (``dist.world``), never switched
on a failure.

:class:`AbstractMesh` is the dry run's mesh: the same interface for any
rank of any shape, with no world.  Its collectives allocate what the real
mesh's allocate, on the operand's device (``meta`` in the dry run), and
move nothing; the two tally the operand bytes of each kind of collective
alike (``stats``, read by ``analysis.roofline.collective_bytes``).
:func:`mesh_axes_for` (one tensor: the spec tuple that stands for the
reference's ``named_sharding``), :func:`tree_shardings` and
:func:`shard_shape` resolve logical axes to spec tuples and the per-rank
shapes they give.

:func:`shard_tree` places a tree (the reference's ``tree_shardings`` then
``jax.device_put``): each rank keeps the block of every leaf that the rule
table gives it, and each dict of the rank's tree carries its leaves'
:class:`Cut` under :data:`CUT_KEY`; :func:`shard_params` places the
serving weights so, :func:`unshard_tree` gathers a tree whole again.  The
model code reads a leaf's cut from there (:func:`cut_axes`), gathers an
FSDP-cut ``embed`` dim before use (:func:`gather_fsdp`, per layer) and
calls the installed mesh's collectives where a cut needs them
(:func:`all_reduce_over`, :func:`all_gather_over`, :func:`enter`).  A
tree without cuts runs as it always has, whatever rules are installed.

Where autograd records them (the training path), those collectives have
backwards: Megatron-LM's conjugate pairs, with one invariant, that every
rank's cotangent of a replicated tensor is the whole cotangent (see the
comment above :class:`_ReduceOut`).  Each keeps its mesh from the forward,
since the backward may run on a thread where no mesh is installed.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AxisRule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisRule, ...]

DEFAULT_RULES: Dict[str, AxisRule] = {
    "batch": ("pod", "data"),
    "embed": None,            # weight FSDP dim: replicated unless training
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "ssm_heads": "model",
    "layers": None,
    "kv_seq": None,
    "ssm_state": None,
}

TRAIN_RULES: Dict[str, AxisRule] = {**DEFAULT_RULES, "embed": "data"}

# Serving: the cache sequence axis takes `model`; the cache head axis must
# stay unsharded or it would claim `model` first (leading dims win).
SERVE_RULES: Dict[str, AxisRule] = {
    **DEFAULT_RULES, "kv_heads": None, "kv_seq": "model",
}

# long_500k: the KV cache dominates memory: its sequence axis spreads over
# both data and model; batch parallelism keeps only the pod axis.
LONG_RULES: Dict[str, AxisRule] = {
    **DEFAULT_RULES, "batch": ("pod",), "kv_heads": None,
    "kv_seq": ("data", "model"),
}


class _Ctx(threading.local):

  def __init__(self):
    self.mesh = None
    self.rules: Optional[Dict[str, AxisRule]] = None
    self.manual: frozenset = frozenset()


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, AxisRule]]):
  """Install (mesh, rules) as the ambient sharding context (``rules``
  None: no table, as outside any context)."""
  prev = (_CTX.mesh, _CTX.rules)
  _CTX.mesh, _CTX.rules = mesh, None if rules is None else dict(rules)
  try:
    yield mesh
  finally:
    _CTX.mesh, _CTX.rules = prev


@contextlib.contextmanager
def manual_axes(axes):
  """Mark mesh axes as manual (the reference's ``shard_map`` bodies).  The
  port keeps the bookkeeping for code that reads it; nothing here emits a
  constraint."""
  prev = _CTX.manual
  _CTX.manual = prev | frozenset(axes)
  try:
    yield
  finally:
    _CTX.manual = prev


def current_mesh():
  return _CTX.mesh


def current_rules() -> Optional[Dict[str, AxisRule]]:
  return _CTX.rules


def rules_dict() -> Dict[str, AxisRule]:
  """The active rule table, or DEFAULT_RULES when none is installed."""
  return dict(_CTX.rules if _CTX.rules is not None else DEFAULT_RULES)


def tp_size(mesh) -> int:
  return int(mesh.shape.get("model", 1)) if mesh is not None else 1


def dp_size(mesh) -> int:
  if mesh is None:
    return 1
  n = 1
  for a in ("pod", "data"):
    n *= int(mesh.shape.get(a, 1))
  return n


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
  return math.prod(int(mesh.shape[a]) for a in axes)


def mesh_axes_for(logical_axes: Sequence[Optional[str]], mesh,
                  rules: Dict[str, AxisRule],
                  shape: Optional[Sequence[int]] = None) -> Spec:
  """Resolve logical axes -> a spec tuple with divisibility + no-reuse
  fallbacks.  ``mesh`` only needs a ``.shape`` mapping (tests use fakes)."""
  used: set = set()
  entries = []
  for d, name in enumerate(logical_axes):
    target = rules.get(name) if name is not None else None
    if target is None:
      entries.append(None)
      continue
    axes = (target,) if isinstance(target, str) else tuple(target)
    axes = tuple(a for a in axes if a in mesh.shape and a not in used)
    # Drop trailing mesh axes until the dim divides evenly.
    while axes and shape is not None and \
        shape[d] % _axis_size(mesh, axes) != 0:
      axes = axes[:-1]
    if not axes:
      entries.append(None)
      continue
    used.update(axes)
    entries.append(axes[0] if len(axes) == 1 else axes)
  return tuple(entries)


def tree_shardings(axes_tree, mesh, rules, shapes_tree):
  """The spec tuple of every leaf of a nested dict of logical axes (a
  leaf's None: replicated), given the same tree of shapes (tuples or
  tensors)."""
  if isinstance(axes_tree, dict):
    return {k: tree_shardings(v, mesh, rules, shapes_tree[k])
            for k, v in axes_tree.items()}
  shape = tuple(getattr(shapes_tree, "shape", shapes_tree))
  axes = axes_tree if axes_tree is not None else (None,) * len(shape)
  return mesh_axes_for(axes, mesh, rules, shape=shape)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
  """The per-rank shape of a tensor of ``shape`` under ``spec``: each dim
  divided by the size of its mesh axes."""
  out = []
  for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
    if entry is None:
      out.append(int(d))
      continue
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    n = _axis_size(mesh, axes)
    if d % n:
      raise ValueError(f"dim {d} does not divide over {axes} ({n})")
    out.append(int(d) // n)
  return tuple(out)


# The kinds of collective whose operand bytes a mesh tallies (the keys of
# the reference's ``roofline.collective_bytes``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def constrain(x, logical_axes, rules: Optional[Dict[str, AxisRule]] = None):
  """Returns ``x`` unchanged.  The reference's ``with_sharding_constraint``
  tells GSPMD where a value should live and never changes the value; the
  port places every tensor explicitly (each rank holds its own shard), so
  there is nothing to constrain."""
  del logical_axes, rules
  return x


# ---------------------------------------------------------------------------
# The mesh of ranks
# ---------------------------------------------------------------------------

class Mesh:
  """``shape`` ranks of the ``torch.distributed`` world laid out row-major
  over ``axis_names`` (rank ``i`` of the first ``prod(shape)`` at the
  row-major coordinates of ``i``).

  Every rank of the world must build the mesh, in the same order as the
  other ranks build theirs: :func:`torch.distributed.new_group` is
  collective over the world.  A rank outside the first ``prod(shape)``
  (``member`` False) holds groups of nothing and calls no collective.

  ``shape`` maps axis name -> size, like JAX's ``Mesh.shape``, so the rule
  logic takes the mesh as it takes the tests' fakes.  The collectives
  :meth:`all_gather`, :meth:`all_reduce`, :meth:`reduce_scatter` and
  :meth:`broadcast_object` run over one axis or a tuple of axes (the combined index in the tuple's
  order, JAX's).  ``stats`` counts the collectives, the bytes this rank
  received and their host wall (staging included) since
  :meth:`reset_stats`, and under each kind of ``COLLECTIVES`` the bytes
  of the operands this rank handed to it."""

  def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
    if not dist.is_available() or not dist.is_initialized():
      raise RuntimeError("a Mesh needs an initialised torch.distributed "
                         "world (repro_torch.dist.world)")
    dims = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(dims) != len(names) or len(set(names)) != len(names):
      raise ValueError(f"mesh shape {dims} and axes {names} do not match")
    self.axis_names = names
    self.shape: Dict[str, int] = dict(zip(names, dims))
    self.size = math.prod(dims)
    world = dist.get_world_size()
    if world < self.size:
      raise RuntimeError(f"need {self.size} ranks for mesh {self.shape}, "
                         f"have {world}")
    self.rank = dist.get_rank()
    self.backend = dist.get_backend()
    self.ranks = np.arange(self.size).reshape(dims)
    self.member = self.rank < self.size
    self.coords: Dict[str, int] = (
        dict(zip(names, (int(i) for i in np.unravel_index(self.rank, dims))))
        if self.member else {})
    # One group per line of every non-empty set of axes (in mesh order):
    # the ranks that differ only in those axes' coordinates.
    self._groups: Dict[Tuple[str, ...], Tuple[object, list]] = {}
    for n_ax in range(1, len(names) + 1):
      for subset in itertools.combinations(names, n_ax):
        keep = [names.index(a) for a in subset]
        rest = [i for i in range(len(names)) if i not in keep]
        for fixed in itertools.product(*(range(dims[i]) for i in rest)):
          idx = [slice(None)] * len(names)
          for i, v in zip(rest, fixed):
            idx[i] = v
          line = [int(r) for r in self.ranks[tuple(idx)].reshape(-1)]
          group = dist.new_group(line)
          if self.rank in line:
            self._groups[subset] = (group, line)
    self.reset_stats()

  def __repr__(self) -> str:
    return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"

  def reset_stats(self) -> None:
    self.stats: Dict[str, Any] = {"calls": 0, "bytes": 0, "ms": 0.0,
                                  **{k: 0 for k in COLLECTIVES}}

  def axis_index(self, name: str) -> int:
    """This rank's coordinate along axis ``name``."""
    self._require_member()
    return self.coords[name]

  def index(self, axes) -> int:
    """This rank's combined index along ``axes`` (a name or a tuple, in
    the tuple's order: the first axis major)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    i = 0
    for a in axes:
      i = i * self.shape[a] + self.axis_index(a)
    return i

  def axis_size(self, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(self.shape[a] for a in axes)

  def _require_member(self) -> None:
    if not self.member:
      raise RuntimeError(f"rank {self.rank} is not in the mesh "
                         f"{self.shape} (ranks 0..{self.size - 1})")

  def _line(self, axes):
    """(group, member ranks in the order of the combined index along
    ``axes``)."""
    self._require_member()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    key = tuple(a for a in self.axis_names if a in axes)
    if len(key) != len(axes):
      raise ValueError(f"axes {axes} not all in mesh {self.shape}")
    group, line = self._groups[key]
    if key != axes:
      def combined(r):
        c = np.unravel_index(r, self.ranks.shape)
        i = 0
        for a in axes:
          i = i * self.shape[a] + int(c[self.axis_names.index(a)])
        return i
      line = sorted(line, key=combined)
    return group, line

  def _staged(self, x: torch.Tensor) -> torch.Tensor:
    """The operand of a collective: on gloo a CUDA tensor goes through
    host memory (gloo's transport), elsewhere the tensor itself."""
    x = x.contiguous()
    if self.backend == "gloo" and x.device.type != "cpu":
      return x.cpu()
    return x

  def all_gather(self, x: torch.Tensor, axes, dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` along ``axes``, in the order of the combined
    index: concatenated along ``dim`` (``tiled``) or stacked at ``dim``
    (JAX's ``all_gather(x, axes, axis=dim, tiled=...)``)."""
    group, line = self._line(axes)
    t0 = time.perf_counter()
    xs = self._staged(x)
    parts = [torch.empty_like(xs) for _ in line]
    self._all_gather(parts, xs, group)
    # dist's list is in group-rank order, the sorted global ranks.
    by_rank = dict(zip(sorted(line), parts))
    parts = [by_rank[r] for r in line]
    out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
    out = out.to(x.device)
    self.stats["calls"] += 1
    self.stats["bytes"] += xs.numel() * xs.element_size() * len(line)
    self.stats["all-gather"] += xs.numel() * xs.element_size()
    self.stats["ms"] += (time.perf_counter() - t0) * 1e3
    return out

  def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                 ) -> torch.Tensor:
    """The sum (or mean) of every member's ``x`` along ``axes``, as a
    reduce-scatter and an all-gather: ``x``, flat and zero-padded to a
    multiple of the line's n ranks, is cut into n pieces; one all-to-all
    hands each rank its piece of every member's ``x``, the rank sums them
    in the order of the combined index, and one all-gather gives every rank
    all n sums.  A rank sends and receives about 2 (n - 1) / n of ``x`` and
    holds one more copy of it, whatever n.  Every element is summed in the
    same fixed order, so all ranks get the same bits and the result equals
    the one-rank sum of the same parts in that order: a backend's ring
    order changes the last bits, which ``compress_pods``' int8 quantiser
    would turn into whole steps of a code."""
    if op not in ("sum", "mean"):
      raise ValueError(f"op {op!r} not in ('sum', 'mean')")
    group, line = self._line(axes)
    n = len(line)
    t0 = time.perf_counter()
    xs = self._staged(x.reshape(-1))
    per = -(-xs.numel() // n)
    if per * n != xs.numel():
      xs = torch.cat([xs, xs.new_zeros(per * n - xs.numel())])
    pieces = torch.empty_like(xs)
    self._all_to_all(pieces, xs, group)
    # Row j came from group rank j, the j-th of the sorted global ranks.
    by_rank = dict(zip(sorted(line), pieces.view(n, per)))
    acc = by_rank[line[0]]
    for r in line[1:]:
      acc = acc + by_rank[r]
    if op == "mean":
      acc = acc / n
    sums = [torch.empty_like(acc) for _ in line]
    self._all_gather(sums, acc, group)        # piece j from group rank j
    out = torch.cat(sums)[:x.numel()].view(x.shape).to(x.device)
    self.stats["calls"] += 2
    self.stats["bytes"] += 2 * xs.numel() * xs.element_size()
    self.stats["all-to-all"] += xs.numel() * xs.element_size()
    self.stats["all-gather"] += acc.numel() * acc.element_size()
    self.stats["ms"] += (time.perf_counter() - t0) * 1e3
    return out

  def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0
                     ) -> torch.Tensor:
    """The sum of every member's ``x`` along ``axes``, of which each member
    keeps its block along ``dim`` (the block at its combined index, as
    :meth:`all_gather` places blocks): one all-to-all hands each rank its
    block of every member's ``x``, and the rank sums them in the order of
    the combined index, :meth:`all_reduce`'s order, so that every element
    has the bits the all-reduce gives it.  A rank sends and receives
    (n - 1) / n of ``x``."""
    group, line = self._line(axes)
    n = len(line)
    if x.shape[dim] % n:
      raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over "
                       f"{n} ranks")
    t0 = time.perf_counter()
    blocks = x.movedim(dim, 0).chunk(n, 0)
    # Chunk j of the operand goes to group rank j, the j-th of the sorted
    # global ranks: the block of that rank's combined index.
    xs = self._staged(torch.cat([blocks[line.index(r)] for r in
                                 sorted(line)]))
    pieces = torch.empty_like(xs)
    self._all_to_all(pieces, xs, group)
    by_rank = dict(zip(sorted(line), pieces.chunk(n, 0)))
    acc = by_rank[line[0]]
    for r in line[1:]:
      acc = acc + by_rank[r]
    out = acc.movedim(0, dim).to(x.device)
    self.stats["calls"] += 1
    self.stats["bytes"] += xs.numel() * xs.element_size()
    self.stats["reduce-scatter"] += xs.numel() * xs.element_size()
    self.stats["ms"] += (time.perf_counter() - t0) * 1e3
    return out

  def broadcast_object(self, obj, src: int = 0):
    """Mesh rank ``src``'s picklable ``obj`` on every member (over the
    whole mesh)."""
    group, line = self._line(self.axis_names)
    t0 = time.perf_counter()
    box = [obj]
    self._broadcast(box, line[src], group)
    self.stats["calls"] += 1
    self.stats["ms"] += (time.perf_counter() - t0) * 1e3
    return box[0]

  # The communication itself: the collectives above allocate their
  # operands and results and call these to fill them.
  def _all_gather(self, parts, x, group) -> None:
    dist.all_gather(parts, x, group=group)

  def _all_to_all(self, out, x, group) -> None:
    dist.all_to_all_single(out, x, group=group)

  def _broadcast(self, box, src, group) -> None:
    dist.broadcast_object_list(box, src=src, group=group)


class AbstractMesh(Mesh):
  """The interface of :class:`Mesh` for rank ``rank`` of a mesh of any
  shape, with no ``torch.distributed`` world and no process groups: the
  dry run's mesh, on which one rank's program is traced.

  Its collectives are :class:`Mesh`'s own code: they allocate the same
  operands, pieces and results, of the real mesh's shapes, on the
  operand's device, tally ``stats`` alike, and skip only the
  communication, so the results' values are unspecified (``meta``
  tensors have none).  Nothing is staged through host memory: the
  production meshes span one card a rank (NCCL).  ``broadcast_object``
  returns the object as given."""

  def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
               rank: int = 0):
    dims = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(dims) != len(names) or len(set(names)) != len(names):
      raise ValueError(f"mesh shape {dims} and axes {names} do not match")
    self.axis_names = names
    self.shape = dict(zip(names, dims))
    self.size = math.prod(dims)
    if not 0 <= rank < self.size:
      raise ValueError(f"rank {rank} not in a mesh of {self.size}")
    self.rank = int(rank)
    self.backend = "abstract"
    self.ranks = np.arange(self.size).reshape(dims)
    self.member = True
    self.coords = dict(zip(names, (int(i) for i in
                                   np.unravel_index(self.rank, dims))))
    self.reset_stats()

  def __repr__(self) -> str:
    return f"AbstractMesh({self.shape}, rank={self.rank})"

  def _line(self, axes):
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if any(a not in self.shape for a in axes):
      raise ValueError(f"axes {axes} not all in mesh {self.shape}")
    keep = [self.axis_names.index(a) for a in axes]
    idx = [self.coords[a] for a in self.axis_names]
    line = []
    for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
      for i, v in zip(keep, combo):
        idx[i] = v
      line.append(int(self.ranks[tuple(idx)]))
    return None, line

  def _staged(self, x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()

  def _all_gather(self, parts, x, group) -> None:
    del parts, x, group

  def _all_to_all(self, out, x, group) -> None:
    del out, x, group

  def _broadcast(self, box, src, group) -> None:
    del box, src, group


# ---------------------------------------------------------------------------
# Weights cut by the rule tables
# ---------------------------------------------------------------------------

# The key under which a dict of a cut parameter tree holds its leaves'
# :class:`Cut` (``{leaf name: Cut}``).  A tree without it holds its leaves
# whole, and every model function computes as it always has.
CUT_KEY = "_cut"


class Cut(NamedTuple):
  """How a leaf of a cut parameter tree was cut: its logical axes (those of
  ``common.param_axes``) and the spec they resolved to (a stacked leaf's
  leading ``"layers"`` entry included until ``layer_params`` slices it)."""
  axes: Tuple[Optional[str], ...]
  spec: Spec

  def layer(self) -> "Cut":
    """The cut of one layer's slice of a stacked leaf."""
    if self.spec[0] is not None:
      raise ValueError(f"the layer axis is cut ({self.spec}): the port "
                       "slices layers on every rank")
    return Cut(self.axes[1:], self.spec[1:])


def axes_of(entry) -> Tuple[str, ...]:
  """The mesh axes of one spec entry (None, a name or a tuple) as a
  tuple."""
  if entry is None:
    return ()
  return (entry,) if isinstance(entry, str) else tuple(entry)


def take_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
  """This rank's block of the whole tensor ``x`` under ``spec``: along each
  cut dim the contiguous block at the rank's combined index over that
  dim's mesh axes (a contiguous copy, which never aliases ``x``)."""
  shape = shard_shape(tuple(x.shape), spec, mesh)
  for d, entry in enumerate(spec):
    axes = axes_of(entry)
    if axes:
      x = x.narrow(d, mesh.index(axes) * shape[d], shape[d])
  return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Dict, axes_tree: Dict, mesh,
               rules: Dict[str, AxisRule]):
  """This rank's shard of a whole tree of tensors (the reference's
  ``tree_shardings`` followed by ``jax.device_put``): every leaf cut by
  ``mesh_axes_for(axes_tree[leaf], mesh, rules, shape)``, each rank
  holding the block at its combined index along every cut dim.  Returns
  (the rank's tree, whose every dict carries its leaves' :class:`Cut`
  under :data:`CUT_KEY`; the spec tree)."""
  mesh = require_mesh(mesh)

  def walk(tree, axes):
    out, cuts, specs = {}, {}, {}
    for k, v in tree.items():
      if k == CUT_KEY:
        raise ValueError("the tree is already a rank's shard")
      if isinstance(v, dict):
        out[k], specs[k] = walk(v, axes[k])
        continue
      spec = mesh_axes_for(axes[k], mesh, rules, shape=tuple(v.shape))
      cuts[k] = Cut(tuple(axes[k]), spec)
      specs[k] = spec
      out[k] = take_block(v, spec, mesh)
    out[CUT_KEY] = cuts
    return out, specs

  return walk(tree, axes_tree)


def shard_params(params: Dict, cfg, mesh, rules: Dict[str, AxisRule]):
  """This rank's shard of a whole serving parameter tree
  (:func:`shard_tree` by ``common.param_axes``).  Returns (the rank's
  tree; the spec tree).  ``params`` is the tree of
  ``transformer.finish_params``: its f32 ``unembed`` is cut as the
  ``(embed, vocab)`` leaf it is, and a tied model's is the f32 cast of
  the rank's ``embed`` block, seen transposed (``embed``'s spec, the
  other way round).  The model code reads each leaf's cut from the tree,
  never from its shape nor from the installed rules, so whole parameters
  under any rule table stay whole."""
  from repro_torch.models import common as cm
  mesh = require_mesh(mesh)
  axes_tree = cm.param_axes(cfg)
  axes_tree["unembed"] = ("embed", "vocab")
  tied = cfg.tie_embeddings
  local, specs = shard_tree(
      {k: v for k, v in params.items() if not (tied and k == "unembed")},
      axes_tree, mesh, rules)
  if tied:
    spec = mesh_axes_for(axes_tree["unembed"], mesh, rules,
                         shape=tuple(params["unembed"].shape))
    local[CUT_KEY]["unembed"] = Cut(axes_tree["unembed"], spec)
    specs["unembed"] = spec
    local["unembed"] = local["embed"].float().t()
  return local, specs


def unshard_tree(tree, mesh) -> Dict:
  """The whole tree from the ranks' shards (the inverse of
  :func:`shard_tree`): every cut leaf all-gathered over its mesh axes
  along each cut dim; the :data:`CUT_KEY` entries dropped.  Collective:
  every member of ``mesh`` calls it, on trees of the same cuts."""
  if not isinstance(tree, dict):
    return tree
  cuts = tree.get(CUT_KEY, {})
  out = {}
  for k, v in tree.items():
    if k == CUT_KEY:
      continue
    if isinstance(v, dict):
      out[k] = unshard_tree(v, mesh)
      continue
    cut = cuts.get(k)
    for d, entry in enumerate(cut.spec if cut is not None else ()):
      if axes_of(entry):
        v = mesh.all_gather(v, axes_of(entry), dim=d)
    out[k] = v
  return out


def is_cut(p) -> bool:
  """Whether the dict ``p`` of a parameter tree is a rank's shard."""
  return isinstance(p, dict) and CUT_KEY in p


def cut_axes(p: Dict, name: str, dim: int) -> Tuple[str, ...]:
  """The mesh axes dim ``dim`` of leaf ``name`` of the dict ``p`` is cut
  over, () where it is whole or ``p`` holds whole leaves."""
  cut = p.get(CUT_KEY, {}).get(name) if isinstance(p, dict) else None
  return () if cut is None else axes_of(cut.spec[dim])


def active_mesh() -> "Mesh":
  """The installed mesh, which a cut leaf needs for its collectives."""
  mesh = current_mesh()
  if mesh is None:
    raise RuntimeError("cut weights (shard_params) used with no mesh "
                       "installed (use_mesh): a rank's shard alone does not "
                       "give the global answer")
  return mesh


def block_start(axes: Tuple[str, ...], size: int) -> int:
  """The first global index of this rank's block of ``size`` along a dim
  cut over ``axes``."""
  return active_mesh().index(axes) * size if axes else 0


def under_current_mesh(fn):
  """``fn`` run under the (mesh, rules) installed now, on whatever thread
  calls it.  The mesh context is thread-local, and autograd runs a
  backward on a thread of its own on CUDA, where
  ``torch.utils.checkpoint`` recomputes a layer: the recomputed layer
  must gather and reduce over the mesh it first ran under."""
  mesh, rules = _CTX.mesh, _CTX.rules
  if mesh is None:
    return fn

  def run(*args, **kw):
    with use_mesh(mesh, rules):
      return fn(*args, **kw)
  return run


# The collectives of a cut tree, as autograd sees them (Megatron-LM's
# conjugate pairs, Shoeybi et al. 2019).  A tensor is either replicated
# over a line of ranks (every rank holds the same bits) or the rank's own
# (a block, or a partial sum).  The code keeps one invariant: every rank's
# cotangent of a replicated tensor is the whole cotangent.  So a
# collective whose output is replicated needs no sum in its backward, and
# :func:`enter` marks each place where a replicated tensor feeds the
# rank's own computation, whose cotangents are partial: its backward sums
# them.  Each op keeps its mesh and axes from the forward: the backward
# may run on a thread with no mesh installed.

class _ReduceOut(torch.autograd.Function):
  """The sum of the ranks' partials; backward: the identity."""

  @staticmethod
  def forward(ctx, x, mesh, axes):
    return mesh.all_reduce(x, axes)

  @staticmethod
  def backward(ctx, g):
    return g, None, None


class _GatherOut(torch.autograd.Function):
  """The ranks' blocks concatenated, replicated; backward: the rank's
  block of the cotangent."""

  @staticmethod
  def forward(ctx, x, mesh, axes, dim):
    ctx.dim, ctx.size = dim, x.shape[dim]
    ctx.start = mesh.index(axes) * ctx.size
    return mesh.all_gather(x, axes, dim=dim)

  @staticmethod
  def backward(ctx, g):
    return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


class _Enter(torch.autograd.Function):
  """The identity; backward: the sum of the ranks' partial cotangents."""

  @staticmethod
  def forward(ctx, x, mesh, axes):
    ctx.mesh, ctx.axes = mesh, axes
    return x

  @staticmethod
  def backward(ctx, g):
    return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _GatherFsdp(torch.autograd.Function):
  """A weight's FSDP blocks gathered; backward: a reduce-scatter, the
  gradients of every rank's rows of the batch summed, the rank keeping its
  block."""

  @staticmethod
  def forward(ctx, x, mesh, axes, dim):
    ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
    return mesh.all_gather(x, axes, dim=dim)

  @staticmethod
  def backward(ctx, g):
    return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, None


def all_reduce_over(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
  """The sum of every rank's partial ``x`` along ``axes``, replicated;
  ``x`` where ``axes`` is ().  Its backward is the identity."""
  if not axes:
    return x
  return _ReduceOut.apply(x, active_mesh(), axes)


def all_gather_over(x: torch.Tensor, axes: Tuple[str, ...],
                    dim: int) -> torch.Tensor:
  """Every rank's block of ``x`` along ``axes``, concatenated along
  ``dim`` and replicated; ``x`` where ``axes`` is ().  Its backward is the
  rank's block of the cotangent."""
  if not axes:
    return x
  return _GatherOut.apply(x, active_mesh(), axes, dim)


def enter(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
  """``x``, replicated over ``axes``, where it enters computation of the
  rank's own (a column-cut product, the rank's heads or experts): the
  identity, whose backward all-reduces the ranks' partial cotangents over
  ``axes``."""
  if not axes:
    return x
  return _Enter.apply(x, active_mesh(), axes)


def gather_fsdp(x: torch.Tensor, cut: Cut) -> Tuple[torch.Tensor, Cut]:
  """``x`` with its FSDP cut undone (the reference's ``_gather_fsdp``):
  each ``embed`` dim that is cut is all-gathered over its mesh axes; the
  other cuts (``model``) stay.  Its backward is a reduce-scatter over
  those axes: the gradient comes out summed over the data-parallel ranks
  whose rows it saw.  Returns (the tensor, its cut after)."""
  spec = list(cut.spec)
  for d, (name, entry) in enumerate(zip(cut.axes, cut.spec)):
    if name == "embed" and entry is not None:
      x = _GatherFsdp.apply(x, active_mesh(), axes_of(entry), d)
      spec[d] = None
  return x, Cut(cut.axes, tuple(spec))


def fsdp_axes(cut: Optional[Cut]) -> Tuple[str, ...]:
  """The mesh axes a leaf's ``embed`` dim is cut over (its FSDP cut), ()
  for a whole leaf."""
  if cut is None:
    return ()
  return tuple(a for name, entry in zip(cut.axes, cut.spec)
               if name == "embed" for a in axes_of(entry))


def cut_mesh_axes(cut: Optional[Cut]) -> Tuple[str, ...]:
  """Every mesh axis a leaf is cut over, () for a whole leaf."""
  if cut is None:
    return ()
  return tuple(a for entry in cut.spec for a in axes_of(entry))


def leaf(p: Dict, name: str) -> torch.Tensor:
  """Leaf ``name`` of the dict ``p`` with its FSDP cut undone (the
  top-level leaves: ``embed``, ``unembed``, ``final_norm``,
  ``frontend_proj``); the leaf itself in a whole tree."""
  cut = p.get(CUT_KEY, {}).get(name)
  return p[name] if cut is None else gather_fsdp(p[name], cut)[0]


def require_mesh(mesh) -> "Mesh":
  """``mesh`` when it is the port's :class:`Mesh` (an :class:`AbstractMesh`
  too); anything else raises ``TypeError`` (a JAX mesh has no ranks to run
  on)."""
  if not isinstance(mesh, Mesh):
    raise TypeError(f"mesh must be a repro_torch.dist.sharding.Mesh, got "
                    f"{type(mesh).__name__}")
  return mesh
