"""The live storage of one traced program on the ``meta`` device: the
dry run's counterpart of XLA's ``memory_analysis``.

:class:`MemoryTracker` is a ``TorchDispatchMode``: every op's outputs pass
through it, and a storage it has not seen (a new allocation: views share
their base's storage, and an in-place op returns its input's) is counted
live from that op until Python frees it (``weakref.finalize`` on the
storage).  Each storage is charged what the CUDA caching allocator charges
for it, its bytes rounded up to a multiple of 512 (none for an empty one),
so that the trace's peak compares with ``torch.cuda.max_memory_allocated``
on the card.  The arguments' storages (registered before the program runs)
are never new.

  with MemoryTracker(args) as t:
    out = step(*args)
  t.finish(out)
  t.argument_bytes, t.output_bytes, t.temp_bytes, t.alias_bytes
"""
from __future__ import annotations

import gc
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# The CUDA caching allocator's block size unit (kMinBlockSize).
ALLOC_UNIT = 512


def allocator_bytes(nbytes: int) -> int:
  """The bytes the caching allocator charges an allocation of ``nbytes``."""
  return -(-int(nbytes) // ALLOC_UNIT) * ALLOC_UNIT


def _tensors(tree) -> Iterable[torch.Tensor]:
  return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def storage_key(t: torch.Tensor) -> int:
  return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
  """Bytes of the distinct storages of every tensor in ``tree`` (nested
  dicts, lists, tuples), each once whatever its views."""
  seen: Dict[int, int] = {}
  for t in _tensors(tree):
    seen.setdefault(storage_key(t), t.untyped_storage().nbytes())
  return sum(seen.values())


class MemoryTracker(TorchDispatchMode):
  """Live storage of a program on ``meta`` (see the module doc).
  ``arguments``: the tree of tensors the program takes."""

  def __init__(self, arguments=()):
    super().__init__()
    self._args = {storage_key(t): t.untyped_storage().nbytes()
                  for t in _tensors(arguments)}
    self.argument_bytes = sum(self._args.values())
    self._live: Dict[int, int] = {}
    self.live_bytes = 0
    self.peak_bytes = 0
    self.allocations = 0
    self.output_bytes = self.alias_bytes = self.temp_bytes = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    for t in tree_flatten(out)[0]:
      if isinstance(t, torch.Tensor) and t.device.type == "meta":
        self._see(t)
    return out

  def _see(self, t: torch.Tensor) -> None:
    st = t.untyped_storage()
    key = st._cdata
    if key in self._args or key in self._live:
      return
    n = allocator_bytes(st.nbytes())
    self._live[key] = n
    self.live_bytes += n
    self.allocations += 1
    self.peak_bytes = max(self.peak_bytes, self.live_bytes)
    weakref.finalize(st, self._free, key)

  def _free(self, key: int) -> None:
    n = self._live.pop(key, None)
    if n is not None:
      self.live_bytes -= n

  def finish(self, outputs) -> "MemoryTracker":
    """Split the trace into output, alias and temp bytes, given what the
    program returned: output = every distinct storage it returned (new
    ones as the allocator charges them, arguments as they are), alias =
    the returned arguments' storages, temp = the peak of new live storage
    beyond the new outputs."""
    gc.collect()
    new, alias = {}, {}
    for t in _tensors(outputs):
      key = storage_key(t)
      if key in self._args:
        alias[key] = self._args[key]
      elif key in self._live:
        new[key] = self._live[key]
    self.alias_bytes = sum(alias.values())
    self.output_bytes = sum(new.values()) + self.alias_bytes
    self.temp_bytes = self.peak_bytes - sum(new.values())
    return self
