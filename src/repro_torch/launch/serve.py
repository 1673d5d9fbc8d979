"""Serving driver: prefill -> synopsis build -> deadline-budgeted decode
(counterpart of the single-batch loop of ``repro.launch.serve``).

Each decode step picks its refinement budget from the calibrated latency
model and the deadline; new tokens accumulate in the recent ring and are
absorbed into the synopsis when it fills (the paper's incremental update).
All stages run on the port's kernels when the device is a GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --no-smoke --prompt-len 8192 --tokens 130

``--device cpu`` runs the plain PyTorch versions of the kernels (tests);
without it the driver needs a CUDA device and refuses to run otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.control import BudgetController, make_predictor
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

BUCKETS = (0, 1, 2, 4, 8, 16, 32)


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run(cfg: ModelConfig, *, batch: int, prompt_len: int, tokens: int,
        deadline_ms: float = 50.0, device="cuda", seed: int = 0,
        params: Optional[Dict] = None,
        prompt: Optional[torch.Tensor] = None,
        budgets: Optional[Sequence[int]] = None,
        pca_basis: Optional[torch.Tensor] = None, log=print) -> Dict:
  """Prefill ``batch`` prompts, build the synopsis, decode ``tokens``
  greedy tokens.  ``params``/``prompt`` default to random ones drawn from
  ``seed``; ``budgets`` fixes the budget of each step instead of the
  deadline controller (parity tests); ``pca_basis`` is the clustering's
  PCA start (``core.cluster.initial_basis``).

  Returns the generated ids (B, 1 + tokens), the last step's logits, the
  budget and wall time of every step, prefill and build times (ms, host
  clock around synchronised work), the number of absorbs and the final
  cache."""
  dev = resolve_device(device)
  gen = torch.Generator(dev).manual_seed(seed)
  if params is None:
    params = tf.init_model(cfg, gen, dev)
  if prompt is None:
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
  prompt = prompt.to(dev)
  if budgets is not None and len(budgets) < tokens:
    raise ValueError(f"{len(budgets)} budgets for {tokens} steps")

  _sync(dev)
  t0 = time.perf_counter()
  logits, cache = make_prefill_step(cfg)(params, prompt)
  _sync(dev)
  prefill_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  cache = skv.build(cache, cfg, basis=pca_basis)
  _sync(dev)
  build_ms = (time.perf_counter() - t0) * 1e3
  M = cache["k_syn"].shape[4]
  log(f"[prefill+build] {tuple(prompt.shape)} tokens: prefill "
      f"{prefill_ms:.1f}ms, build {build_ms:.1f}ms; M={M} clusters of "
      f"C={cfg.synopsis.cluster_size}")

  ctrl = BudgetController(
      make_predictor("affine", base=5.0, slope=1.0, alpha=0.1),
      buckets=BUCKETS, i_max_cap=cfg.synopsis.i_max or BUCKETS[-1])
  steps = {}
  tok = logits.argmax(-1, keepdim=True)
  out_tokens = [tok]
  step_ms, chosen, absorbs = [], [], 0
  for i in range(tokens):
    budget = (int(budgets[i]) if budgets is not None
              else ctrl.budget_for(deadline_ms))
    if budget not in steps:
      steps[budget] = make_serve_step(cfg, i_max=budget)
    t0 = time.perf_counter()
    logits, st = steps[budget](params, cache, tok)
    _sync(dev)
    dt = (time.perf_counter() - t0) * 1e3
    ctrl.observe(budget, dt)
    cache = skv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if int(cache["recent_len"][0]) >= cfg.synopsis.recent:
      cache = skv.absorb_recent(cache, cfg)
      absorbs += 1
      log(f"[update] absorbed recent buffer -> M={cache['k_syn'].shape[4]}")
    tok = logits.argmax(-1, keepdim=True)
    out_tokens.append(tok)
    step_ms.append(dt)
    chosen.append(budget)
    log(f"[decode {i:3d}] budget={budget:3d} {dt:7.1f}ms")
  generated = torch.cat(out_tokens, 1)
  log(f"generated: {generated[0].tolist()}")
  return {"tokens": generated, "logits": logits, "budgets": chosen,
          "step_ms": step_ms,
          "prefill_ms": prefill_ms, "build_ms": build_ms,
          "absorbs": absorbs, "cache": cache}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
  ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                  default=True,
                  help="the arch's small test config (--no-smoke: full "
                       "width and depth)")
  ap.add_argument("--batch", type=int, default=2)
  ap.add_argument("--prompt-len", type=int, default=256)
  ap.add_argument("--tokens", type=int, default=32)
  ap.add_argument("--deadline-ms", type=float, default=50.0)
  ap.add_argument("--budget", type=int, default=None,
                  help="fix every step's refinement budget (clusters) "
                       "instead of the deadline controller")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default; required unless cpu is asked for) "
                       "or cpu (the kernels' plain PyTorch versions)")
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  try:
    device = resolve_device(args.device)
  except RuntimeError as e:
    ap.error(str(e))
  cfg = get_config(args.arch, smoke=args.smoke)
  budgets = None if args.budget is None else [args.budget] * args.tokens
  return run(cfg, batch=args.batch, prompt_len=args.prompt_len,
             tokens=args.tokens, deadline_ms=args.deadline_ms,
             device=device, seed=args.seed, budgets=budgets)


if __name__ == "__main__":
  main()
