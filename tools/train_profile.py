#!/usr/bin/env python3
"""Where the device time of one training step goes, for whichever
``repro_torch`` is on ``PYTHONPATH``, at smollm-135m's full width.

  PYTHONPATH=<tree>/src python3 tools/train_profile.py --label <tree> \
      [--batch 8 --seq 2048 --steps 3 --rows 25]

One warm-up step, then ``--steps`` steps timed with CUDA events, then one
step under ``torch.profiler``.  Prints the card's name and power limit,
the step's ms, and the profiler's table of the ops and kernels that took
the most device time.  The training path launches none of the port's
kernels, so nothing is built.  Needs a CUDA device.
"""
import argparse
import subprocess

import torch


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--label", default="tree")
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=2048)
  ap.add_argument("--steps", type=int, default=3)
  ap.add_argument("--rows", type=int, default=25)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("train_profile: no CUDA device")
  from torch.profiler import ProfilerActivity, profile

  from repro_torch.configs.registry import get_config
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig
  from repro_torch.train.train_step import init_train_state, make_train_step

  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda")
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
  cfg = get_config("smollm-135m")
  opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=30)
  data = TokenStream(DataConfig(cfg.vocab, args.seq, args.batch))

  def batch(i):
    tokens, labels = data.batch_at(i)
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}

  state = init_train_state(cfg, opt_cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
  step = make_train_step(cfg, opt_cfg)
  state, _ = step(state, batch(0))
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for i in range(args.steps):
    state, _ = step(state, batch(i + 1))
  end.record()
  torch.cuda.synchronize()
  print(f"[{args.label}] {cfg.name} batch {args.batch} x {args.seq}: "
        f"{start.elapsed_time(end) / args.steps:.1f} ms a step (CUDA "
        f"events, mean of {args.steps})")
  b = batch(args.steps + 1)
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    state, _ = step(state, b)
    torch.cuda.synchronize()
  print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=args.rows,
                                  max_name_column_width=70))


if __name__ == "__main__":
  main()
