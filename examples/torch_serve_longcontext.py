"""Long-context decode with synopsis attention on the PyTorch port
(demo-sized; the counterpart of ``examples/serve_longcontext.py``).

Prefills a prompt with a SMOKE config, builds the KV synopsis (the offline
module), then decodes one token with AccuracyTrader attention at several
budgets and compares the next-token distributions with exact attention:
the LM analogue of the paper's accuracy-loss tables.  On the card the
prefill runs on ``flash_prefill``, the build on ``segment_build``, the
synopsis steps on ``fused_synopsis_score_attention`` and
``block_gather_attention`` and the exact step on ``flash_decode``.  The
weights are random (torch's RNG, so not the JAX example's numbers).

  PYTHONPATH=src python examples/torch_serve_longcontext.py --device cpu \\
      [--seq 512]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.common import n_attn_positions
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step


def main(argv=None):
  """Prints the table and returns {i_max: (TV distance, argmax match)}."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--arch", default="llama3-8b")
  ap.add_argument("--seq", type=int, default=512)
  ap.add_argument("--batch", type=int, default=2)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)

  cfg = get_config(args.arch, smoke=True)
  if not n_attn_positions(cfg):
    raise ValueError(f"{cfg.name}: synopsis attention needs attention")
  gen = torch.Generator(dev).manual_seed(0)
  params = tf.init_model(cfg, gen, dev)

  B, S = args.batch, args.seq
  C = cfg.synopsis.cluster_size
  M = S // C
  prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
  print(f"prefill {S} tokens ({cfg.name}) on {dev.type}...")
  _, cache = make_prefill_step(cfg)(params, prompt)
  print(f"building synopsis (offline module): C={C}, M={M}")
  syn_cache = skv.build(cache, cfg)

  nt = torch.randint(0, cfg.vocab, (B, 1), device=dev,
                     generator=torch.Generator(dev).manual_seed(7))
  lg_ex, _ = make_serve_step(cfg, mode="exact")(params, cache, nt)
  p_ex = torch.softmax(lg_ex.float(), -1)
  print(f"\n{'i_max':>6s} {'kv rows touched':>16s} {'TV-dist to exact':>17s} "
        f"{'argmax match':>13s}")
  out = {}
  for i_max in sorted({0, 1, 2, M // 2, M}):
    step = make_serve_step(cfg, mode="synopsis", i_max=i_max)
    lg, _ = step(params, syn_cache, nt)
    p = torch.softmax(lg.float(), -1)
    tv = float(0.5 * (p - p_ex).abs().sum(-1).mean())
    match = float((lg.argmax(-1) == lg_ex.argmax(-1)).float().mean())
    out[i_max] = (tv, match)
    print(f"{i_max:6d} {M + i_max * C:10d}/{S:5d} {tv:17.4f} "
          f"{100 * match:12.0f}%")
  print(f"\nA step reads the M = {M} centroids and i_max x C = i_max x {C} "
        f"rows of the S = {S} cached ones, per layer and kv head.")
  return out


if __name__ == "__main__":
  main()
