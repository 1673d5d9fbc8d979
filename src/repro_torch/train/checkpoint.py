"""Atomic, async checkpoints in the reference's layout (counterpart of
``repro.train.checkpoint``), so that the port restores what the JAX
package wrote and the other way round.

Layout:  <dir>/step_<n:08d>/
           manifest.json   {"step", "leaves": {path: {file, dtype, shape}},
                            "extras"}
           <path with "/" as "__">.npy, one file per leaf of the nested dict

* Atomic: written to ``step_<n>.tmp``, then renamed; a crash never leaves
  a half checkpoint visible, and :func:`latest_step` reads complete ones
  only.
* Async: :meth:`AsyncCheckpointer.save_async` copies the tree to host
  memory at once and writes it on a background thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"


def _flatten(tree, prefix=""):
  out = {}
  if isinstance(tree, dict):
    for k, v in tree.items():
      out.update(_flatten(v, f"{prefix}{k}{SEP}"))
  else:
    out[prefix.rstrip(SEP)] = tree
  return out


def _unflatten(flat):
  tree: dict = {}
  for path, v in flat.items():
    parts = path.split(SEP)
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return tree


def _host(x) -> np.ndarray:
  """A leaf as a numpy array on the host (a copy of a tensor's data)."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy().copy()
  return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Any, extras: Optional[dict] = None):
  """Synchronous atomic save of a nested dict of tensors / arrays."""
  flat = _flatten(tree)
  final = os.path.join(ckpt_dir, f"step_{step:08d}")
  tmp = final + ".tmp"
  os.makedirs(tmp, exist_ok=True)
  manifest = {"step": step, "leaves": {}, "extras": extras or {}}
  for path, arr in flat.items():
    arr = _host(arr)
    fname = path.replace(SEP, "__") + ".npy"
    np.save(os.path.join(tmp, fname), arr)
    manifest["leaves"][path] = {"file": fname, "dtype": str(arr.dtype),
                                "shape": list(arr.shape)}
  with open(os.path.join(tmp, "manifest.json"), "w") as f:
    json.dump(manifest, f)
  if os.path.exists(final):
    os.rename(final, final + ".old")
  os.rename(tmp, final)
  old = final + ".old"
  if os.path.exists(old):
    shutil.rmtree(old)
  return final


class AsyncCheckpointer:
  """Snapshot to host memory synchronously, write on a daemon thread."""

  def __init__(self):
    self._thread: Optional[threading.Thread] = None

  def wait(self):
    if self._thread is not None:
      self._thread.join()
      self._thread = None

  def save_async(self, ckpt_dir: str, step: int, tree: Any,
                 extras: Optional[dict] = None):
    self.wait()
    host_tree = _unflatten({p: _host(x) for p, x in _flatten(tree).items()})
    self._thread = threading.Thread(
        target=save, args=(ckpt_dir, step, host_tree, extras), daemon=True)
    self._thread.start()


def latest_step(ckpt_dir: str) -> Optional[int]:
  if not os.path.isdir(ckpt_dir):
    return None
  steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
           if (m := re.fullmatch(r"step_(\d+)", d))]
  return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, device="cpu"):
  """Load a checkpoint (the newest complete one by default) as a nested
  dict of tensors on ``device``.  Returns (tree, step, extras)."""
  if step is None:
    step = latest_step(ckpt_dir)
    if step is None:
      raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
  d = os.path.join(ckpt_dir, f"step_{step:08d}")
  with open(os.path.join(d, "manifest.json")) as f:
    manifest = json.load(f)
  flat = {path: torch.from_numpy(np.load(os.path.join(d, meta["file"]))).to(
      device) for path, meta in manifest["leaves"].items()}
  return _unflatten(flat), step, manifest.get("extras", {})
