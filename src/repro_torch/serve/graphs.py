"""The engine's program set: one captured CUDA graph per program on a CUDA
device, the same programs run eagerly on the CPU (the counterpart of the
JAX engine's ``jax.jit`` programs).  A program that runs collectives over
gloo (a step backend on a mesh) cannot be captured: its caller asks for
eager programs explicitly (``capture=False``), on any device.

A program is a Python callable with no arguments that reads and writes
tensors at fixed addresses only (the slot pool, static input and output
buffers).  :meth:`Programs.capture` runs it twice on a side stream, as
``torch.cuda.graph`` needs (the kernels' library is loaded and every lazy
allocation made there), then records it into one graph; :meth:`run`
replays the graph.  All graphs share one memory pool: the engine runs them
on one stream, one at a time, so one graph's temporaries are free when
the next one replays.  Nothing falls back to an eager call on the card:
running a program that was not captured raises.

The kernels' launch counters are host-side: they move when a program runs
in Python (the warm-up calls, the capture, :meth:`call_eager`), not when a
graph replays.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable

import torch


class Programs:
  """Named programs on one device: captured graphs on CUDA, eager on the
  CPU (the device's own behaviour), or eager on any device where the
  caller says ``capture=False``."""

  def __init__(self, device: torch.device, capture: bool = True):
    self.device = torch.device(device)
    self.fns: Dict[Hashable, Callable[[], None]] = {}
    self.graphs: Dict[Hashable, "torch.cuda.CUDAGraph"] = {}
    self._capture = bool(capture) and self.device.type == "cuda"
    self.pool = torch.cuda.graph_pool_handle() if self._capture else None

  @property
  def captures(self) -> bool:
    return self._capture

  def add(self, key: Hashable, fn: Callable[[], None]) -> None:
    if key in self.fns:
      raise ValueError(f"program {key!r} is already defined")
    self.fns[key] = fn

  def capture(self, key: Hashable, warmups: int = 2) -> None:
    """Record program ``key`` into a CUDA graph (no-op on the CPU).  The
    warm-up calls run for real: a program must leave the state it reads
    unchanged when its inputs say so (the engine's append runs them with
    no lane active)."""
    if not self.captures:
      return
    fn = self.fns[key]
    main = torch.cuda.current_stream(self.device)
    side = torch.cuda.Stream(self.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
      for _ in range(warmups):
        fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=self.pool):
      fn()
    self.graphs[key] = graph

  def run(self, key: Hashable) -> None:
    """Replay program ``key``'s graph on the current stream (CUDA), or run
    it (CPU)."""
    if not self.captures:
      self.fns[key]()
      return
    graph = self.graphs.get(key)
    if graph is None:
      raise RuntimeError(f"program {key!r} has no captured graph on "
                         f"{self.device}: capture it first")
    graph.replay()

  def call_eager(self, key: Hashable) -> None:
    """Run program ``key`` eagerly, whatever the device (the comparison a
    probe holds a replay against)."""
    self.fns[key]()
