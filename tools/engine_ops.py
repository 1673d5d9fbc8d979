#!/usr/bin/env python3
"""Device ops of each budget bucket's replayed decode step of the engine
of whichever ``repro_torch`` is on ``PYTHONPATH``, at full llama3-8b width.

  PYTHONPATH=<tree>/src python3 tools/engine_ops.py --label <tree> \
      [--contract deadline_with_bound]

The engine (4 slots, prompt 8192, 32 new tokens, deadline 2000 ms, random
weights from seed 0) serves one Poisson window (3 req/s for 4 s, seed 0),
so that its pool holds resident lanes; then each bucket's graph is replayed
alone under the profiler, ``--sessions`` times, and the device rows of each
session are counted (kernels, copies and sets with device time).  A
session at times loses rows, so the most of the sessions is the count.
Run it for two trees in one call on one card to compare them: each run
builds its tree's kernels into that tree's own ``build/``.  Prints the
card's name and power limit, then one JSON object a bucket, with the
kernel rows of the bucket's replay.
"""
import argparse
import json
import subprocess

import torch


def replay_ops(fn, sessions):
  """[device ops of one call of ``fn``, per session], and the rows
  {name: count} of the last session."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  counts, rows = [], {}
  for _ in range(sessions):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    rows = {e.key: e.count for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0}
    counts.append(sum(rows.values()))
  return counts, rows


def main():
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--label", default="tree")
  ap.add_argument("--contract", default="deadline")
  ap.add_argument("--sessions", type=int, default=3)
  args = ap.parse_args()
  from repro_torch.configs.registry import get_config
  from repro_torch.kernels import _build
  from repro_torch.models import transformer as tf
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  torch.backends.cuda.matmul.allow_tf32 = False
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
  _build.build()
  dev = torch.device("cuda")
  cfg = get_config("llama3-8b")
  params = tf.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
  kw = {} if args.contract == "deadline" else {"contract": args.contract}
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=4, prompt_len=8192, max_new_tokens=32, deadline_ms=2000.0,
      **kw), params=params, device=dev)
  run_open_loop(eng, 3.0, 4.0, seed=0)
  for b in eng.buckets:
    counts, rows = replay_ops(lambda: eng.programs.run(("step", b)),
                              args.sessions)
    print(json.dumps({"label": args.label, "contract": args.contract,
                      "bucket": b, "ops": max(counts), "sessions": counts,
                      "rows": rows}, sort_keys=True))


if __name__ == "__main__":
  main()
