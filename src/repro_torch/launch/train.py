"""Training driver with checkpoint / restart (counterpart of
``repro.launch.train``).

Trains a registered architecture on the synthetic token stream with
AdamW; every ``--ckpt-every`` steps the state goes to an atomic,
asynchronous checkpoint, and a run that finds one in ``--ckpt-dir``
resumes from it.  A checkpoint labelled n holds the state after n steps
and the run resumes at step n; the JAX launcher labels it with the last
step taken and so takes that step once more on restart, which the port
does not copy (a restart must reproduce the run it resumes).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 50 --batch 8 --seq 256 --device cpu

Without ``--device cpu`` it needs a CUDA device and refuses to run
otherwise.

``run(mesh=...)`` trains on a mesh of ranks (``dist.sharding.Mesh``):
every rank runs it on its (pod, data) share of each global batch
(``train_step.make_train_step(mesh=...)``, with ``compress_pods`` the
int8 cross-pod reduction).  A checkpoint holds the whole state
(:func:`save_state` gathers a cut one, ``train_step.shard_train_state``'s,
and rank 0 writes it), so that ``checkpoint.restore`` gives it back on one
rank and ``shard_train_state`` cuts it onto any mesh, as the reference's
logical-axes checkpoints restore elastically.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import checkpoint as ck
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          shard_batch, unshard_train_state)


def save_state(saver: ck.AsyncCheckpointer, ckpt_dir: str, step: int,
               state: Dict, mesh=None, extras: Optional[dict] = None
               ) -> None:
  """Checkpoint ``state`` whole: on a mesh every rank calls it (a cut
  state is gathered, a collective), and rank 0 writes."""
  whole = state if mesh is None else unshard_train_state(state, mesh)
  if mesh is None or mesh.rank == 0:
    saver.save_async(ckpt_dir, step, whole, extras=extras)


def run(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
        opt_cfg: Optional[OptConfig] = None, microbatches: int = 1,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
        device="cuda", seed: int = 0, log_every: int = 10,
        mesh=None, compress_pods: bool = False, log=print) -> Dict:
  """Train ``cfg`` from step 0, or from the newest checkpoint in
  ``ckpt_dir``, up to ``steps``; save every ``ckpt_every`` steps (none
  without ``ckpt_dir``; on a ``mesh``, rank 0 saves).  Returns {"start",
  "losses" (one a step run),
  "grad_norms", "step_ms" (CUDA events on the card, the host clock around
  synchronised steps on the CPU), "state", "device"}."""
  dev = resolve_device(device)
  opt_cfg = opt_cfg or OptConfig(total_steps=steps)
  data = TokenStream(DataConfig(cfg.vocab, seq, batch, seed=seed))
  start = 0
  if ckpt_dir is not None and ck.latest_step(ckpt_dir) is not None:
    state, start, extras = ck.restore(ckpt_dir, device=dev)
    data.load_state_dict(extras.get("data", {"step": start, "seed": seed}))
    log(f"[restore] resumed at step {start} on {dev.type}")
  else:
    state = init_train_state(cfg, opt_cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(seed),
                             compress=compress_pods)
  step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                            compress_pods=compress_pods, mesh=mesh)
  saver = ck.AsyncCheckpointer()
  cuda = dev.type == "cuda"
  losses, gnorms, marks = [], [], []
  t0 = time.perf_counter()
  for step in range(start, steps):
    tokens, labels = data.batch_at(step)
    b = {"tokens": torch.from_numpy(tokens).to(dev),
         "labels": torch.from_numpy(labels).to(dev)}
    if mesh is not None:
      b = shard_batch(b, mesh)
    if cuda:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      marks.append(ev)
    else:
      marks.append(time.perf_counter())
    state, m = step_fn(state, b)
    losses.append(m["loss"])
    gnorms.append(m["grad_norm"])
    done = step + 1
    if step % log_every == 0 or done == steps:
      log(f"step {step:5d} loss {float(m['loss']):.4f} "
          f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} "
          f"({time.perf_counter() - t0:.1f}s)")
    if ckpt_dir is not None and done % ckpt_every == 0 and done < steps:
      data.step = done
      save_state(saver, ckpt_dir, done, state, mesh,
                 extras={"data": data.state_dict()})
  if cuda:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)
    torch.cuda.synchronize(dev)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
  else:
    marks.append(time.perf_counter())
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
  saver.wait()
  return {"start": start, "losses": [float(x) for x in losses],
          "grad_norms": [float(x) for x in gnorms], "step_ms": step_ms,
          "state": state, "device": dev}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="smollm-135m")
  ap.add_argument("--smoke", action="store_true")
  ap.add_argument("--steps", type=int, default=100)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=256)
  ap.add_argument("--microbatches", type=int, default=1)
  ap.add_argument("--lr", type=float, default=3e-4)
  ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                     "repro_torch_train"))
  ap.add_argument("--ckpt-every", type=int, default=25)
  ap.add_argument("--device", default="cuda",
                  help="cuda (default; refuses without a card) or cpu")
  args = ap.parse_args(argv)
  cfg = get_config(args.arch, smoke=args.smoke)
  out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps),
            microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, device=args.device)
  if out["step_ms"]:
    print(f"done: {len(out['step_ms'])} steps, step p50 "
          f"{float(np.median(out['step_ms'])):.1f} ms on "
          f"{out['device'].type}")
  return out


if __name__ == "__main__":
  main()
