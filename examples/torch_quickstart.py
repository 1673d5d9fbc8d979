"""Quickstart on the PyTorch port: train smollm-135m end to end.

The port's training stack (the token stream, AdamW, per-layer remat,
checkpoints and restart; ``repro_torch.launch.train``), the counterpart of
``examples/quickstart.py``.  A second run with the same ``--ckpt-dir``
resumes from its newest checkpoint.

  # CPU demo at the SMOKE width (~10 s):
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

  # the full width on the card:
  PYTHONPATH=src python examples/torch_quickstart.py --full --steps 300 \\
      --batch 8 --seq 2048
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.registry import get_config
from repro_torch.launch.train import run
from repro_torch.train.optimizer import OptConfig, tree_leaves


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--full", action="store_true",
                  help="the full smollm-135m config (on the card)")
  ap.add_argument("--steps", type=int, default=30)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--seq", type=int, default=256)
  ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                     "repro_torch_quickstart"))
  ap.add_argument("--ckpt-every", type=int, default=20)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  cfg = get_config("smollm-135m", smoke=not args.full)
  out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            opt_cfg=OptConfig(lr=1e-3, warmup_steps=10,
                              total_steps=args.steps),
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            device=args.device, log_every=5)
  n = sum(x.numel() for x in tree_leaves(out["state"]["params"]))
  print(f"arch={cfg.name} params={n / 1e6:.1f}M device="
        f"{out['device'].type}; done, checkpoints in {args.ckpt_dir}")
  return out


if __name__ == "__main__":
  main()
