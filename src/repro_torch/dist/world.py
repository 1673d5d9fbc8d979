"""Starting a ``torch.distributed`` world: the backend choice, and W ranks
spawned and joined in bounded time (a helper of the port's own, as
``kernels/_build.py`` is).

The backend is chosen once, when the world starts (:func:`backend_for`):
``nccl`` when every rank has a CUDA device of its own, ``gloo`` when ranks
share a card or run on the CPU.  Nothing switches it after a failure.
Whoever starts the ranks prints the choice.

:func:`run_world` spawns W ranks with the ``spawn`` start method (CUDA
needs it), joins them through a ``file://`` store under a temporary
directory, and gives ``init_process_group`` a timeout, so a collective
that hangs fails in bounded time; the join itself is bounded too, and a
rank still running then is killed.  Each rank returns its function's
result to the parent through a file (``torch.save``), or its traceback.
The CUDA kernels are built by the parent before any rank starts
(:func:`repro_torch.kernels._build.build`): the ranks only load the
library.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# torch threads in each spawned rank: W ranks share the host's cores, and
# torch's default (one a core) in every rank oversubscribes them.
RANK_THREADS = 1


def backend_for(device, world_size: int) -> str:
  """``nccl`` when ``device`` is CUDA and there is a card for every rank,
  else ``gloo`` (ranks sharing one card, or on the CPU)."""
  dev = torch.device(device)
  if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
    return "nccl"
  return "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
  """The device a rank computes on: its own card under nccl, the one
  shared card (or the CPU) under gloo."""
  dev = torch.device(device)
  if dev.type == "cuda":
    return torch.device("cuda", rank if backend == "nccl" else 0)
  return dev


def init_world(rank: int, world_size: int, init_method: str, backend: str,
               timeout_s: float = 120.0) -> None:
  """Join the world (the caller's backend choice, explicitly)."""
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world_size,
                          timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(device) -> Optional[str]:
  """Join the world a launcher (``torchrun``) describes in the environment
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), when it
  describes more than one rank; returns the backend, or None for a world
  of one."""
  world = int(os.environ.get("WORLD_SIZE", "1"))
  if world <= 1 or dist.is_initialized():
    return dist.get_backend() if dist.is_initialized() else None
  backend = backend_for(device, world)
  dist.init_process_group(backend, init_method="env://",
                          rank=int(os.environ["RANK"]), world_size=world,
                          timeout=datetime.timedelta(seconds=300))
  return backend


def started() -> bool:
  """Whether this process joined a ``torch.distributed`` world."""
  return dist.is_available() and dist.is_initialized()


def world_size() -> int:
  return dist.get_world_size() if started() else 1


def rank() -> int:
  return dist.get_rank() if started() else 0


def _rank_main(rank_: int, world_size_: int, store: str, backend: str,
               device: str, timeout_s: float, out_dir: str,
               fn: Callable, args: Sequence) -> None:
  torch.set_num_threads(RANK_THREADS)
  if torch.device(device).type == "cuda":
    torch.cuda.set_device(rank_device(device, rank_, backend))
  path = os.path.join(out_dir, f"rank{rank_}")
  try:
    init_world(rank_, world_size_, f"file://{store}", backend, timeout_s)
    result = fn(*args)
    torch.save(result, path + ".pt")
  except BaseException:             # noqa: BLE001: reported to the parent
    with open(path + ".err", "w") as f:
      f.write(traceback.format_exc())
    raise
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()


def run_world(fn: Callable, world_size_: int, args: Sequence = (), *,
              device="cpu", timeout_s: float = 120.0) -> List:
  """Run ``fn(*args)`` on ``world_size_`` spawned ranks joined into one
  world (the backend of :func:`backend_for` on ``device``); returns each
  rank's result, in rank order.  ``fn`` and ``args`` must be picklable
  (``fn`` a module-level function); each rank finds its rank and the world
  through ``torch.distributed``.  A rank that raises, or a world not done
  within ``timeout_s`` (the join; each collective has the same timeout),
  raises here with the ranks' tracebacks, after every rank has ended.
  Each rank runs torch on ``RANK_THREADS`` threads."""
  import torch.multiprocessing as mp  # noqa: PLC0415
  backend = backend_for(device, world_size_)
  tmp = tempfile.mkdtemp(prefix="repro_world_")
  store = os.path.join(tmp, "store")
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=_rank_main, args=(
      r, world_size_, store, backend, str(device), timeout_s, tmp,
      fn, tuple(args)), daemon=True) for r in range(world_size_)]
  try:
    for p in procs:
      p.start()
    # Wait for every rank, but no longer than timeout_s, and stop waiting
    # once one has failed (the others may wait on it in a collective).
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
      if any(p.exitcode not in (None, 0) for p in procs):
        break
      time.sleep(0.02)
    failed = any(p.exitcode not in (None, 0) for p in procs)
    hung = [] if failed else [r for r, p in enumerate(procs)
                              if p.is_alive()]
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join(10.0)
    errors = []
    for r, p in enumerate(procs):
      err = os.path.join(tmp, f"rank{r}.err")
      if os.path.exists(err):
        with open(err) as f:
          errors.append(f"rank {r}:\n{f.read()}")
      elif p.exitcode != 0 and r not in hung:
        errors.append(f"rank {r}: exit code {p.exitcode}")
    if hung:
      raise TimeoutError(f"ranks {hung} of {world_size_} ({backend}) still "
                         f"ran after {timeout_s}s and were killed\n"
                         + "\n".join(errors))
    if errors:
      raise RuntimeError(f"{len(errors)} of {world_size_} ranks ({backend}) "
                         "failed\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size_)]
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
