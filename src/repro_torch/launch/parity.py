"""An arch's SMOKE loop on a card against the same loop on the CPU.

Each kernel's wrapper runs its plain PyTorch version on a CPU tensor and
launches its CUDA kernel on a card's, so one loop run on both devices from
the same f32 weights and prompt holds every kernel of the path at once.
``tests/test_torch_card.py`` and ``chip_smoke.py`` both run it:

  from repro_torch.launch.parity import loop_parity
  launched, rel, bound = loop_parity("smollm-135m", "cuda", mode="exact")
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

# Every step's logits on the card within GAP_MULT times the CPU's f32 loop's
# distance from the same loop in float64 (the same weights, prompt and
# budgets, measured in the same call), or within TOL, whichever is larger;
# both as shares of max|logits|.  The card's and the CPU's f32 loops each
# lie about that distance from float64 (f32 sums in another order, tf32
# off), so they lie within about twice it of each other; twice that again
# leaves room for the card's rounding (and under int8+kv its quantization
# codes) to fall less luckily than the CPU's.  The bound so follows the
# SMOKE loop's own conditioning (whisper-medium's attention logits of order
# 100 make its f32 loop lie 1e-4 to 7e-4 from float64, the other archs'
# 1e-5 to 7e-5, by the CPU: tests/test_torch_whisper.py's
# test_smoke_loop_f32_floor), and a path that rounds through bf16 (eps
# 2^-8, not 2^-24) lands far beyond it (tests/test_torch_parity.py).
TOL = 1e-4
GAP_MULT = 4

PROMPT, TOKENS = 64, 18            # one absorb of the 16-token ring
BUDGETS = [2, 1, 0] * 6


def smoke_f32(arch: str):
  """The arch's SMOKE config in f32 and its weights from seed 2, on the
  CPU."""
  cfg = dataclasses.replace(get_config(arch, smoke=True),
                            dtype=torch.float32)
  return cfg, tf.init_model(cfg, torch.Generator().manual_seed(2), "cpu")


def tree_to(tree, where):
  """Every leaf of ``tree`` moved to a device or cast to a dtype."""
  return {k: tree_to(v, where) if isinstance(v, dict) else v.to(where)
          for k, v in tree.items()}


def step_rel(got, want) -> float:
  """The largest step's distance as a share of that step's max|logits|."""
  return max(float((a.cpu().double() - b.double()).abs().max()
                   / b.abs().max())
             for a, b in zip(got["step_logits"], want["step_logits"]))


def loop_parity(arch: str, device, mode: str = "synopsis",
                quant: str = "none") -> Tuple[Dict[str, int], float, float]:
  """The SMOKE loop (B = 2, prompt 64 from seed 3, 18 steps; budgets 2, 1,
  0 in turn in synopsis mode) under ``quant``: in f32 on the CPU, in
  float64 on the CPU (weights and activations; the plain versions then
  compute in float64 too) and in f32 on ``device``.  Raises AssertionError
  unless all three give the same ids and every step's logits on
  ``device`` lie within the bound above of the CPU's, or if a CPU run
  launched a kernel.  Returns the launches of the ``device`` run, the
  largest step's distance from the CPU's as a share of its max|logits|,
  and the bound it was held to."""
  cfg, params = smoke_f32(arch)
  cfg = serve.apply_quant(cfg, quant)
  prompt = torch.randint(0, cfg.vocab, (2, PROMPT),
                         generator=torch.Generator().manual_seed(3))
  runs = {"cpu": (cfg, params, "cpu"),
          "f64": (dataclasses.replace(cfg, dtype=torch.float64),
                  tree_to(params, torch.float64), "cpu"),
          "card": (cfg, tree_to(params, device), device)}
  outs, launched = {}, {}
  for name, (c, p, where) in runs.items():
    before = _build.launch_counts()
    outs[name] = serve.run(
        c, batch=2, prompt_len=PROMPT, tokens=TOKENS, device=where,
        params=p, prompt=prompt.to(where),
        budgets=BUDGETS if mode == "synopsis" else None, mode=mode,
        keep_logits=True, log=lambda _: None)
    if torch.device(where).type == "cuda":
      torch.cuda.synchronize()
    launched[name] = {k: n - before[k]
                      for k, n in _build.launch_counts().items()}
  label = f"{arch} smoke {mode} quant={quant}"
  for name in ("cpu", "f64"):
    if any(launched[name].values()):
      raise AssertionError(f"{label}: the {name} run launched "
                           f"{launched[name]}")
  cpu = outs["cpu"]
  for name in ("f64", "card"):
    if not torch.equal(outs[name]["tokens"].cpu(), cpu["tokens"]):
      raise AssertionError(f"{label}: {name} ids differ: "
                           f"{outs[name]['tokens'].tolist()} vs "
                           f"{cpu['tokens'].tolist()}")
  gap = step_rel(cpu, outs["f64"])
  bound = max(TOL, GAP_MULT * gap)
  rel = step_rel(outs["card"], cpu)
  if not rel <= bound:
    raise AssertionError(f"{label}: logits differ by {rel} of max (bound "
                         f"{bound}: the CPU's f32 loop lies {gap} from "
                         f"float64)")
  return launched["card"], rel, bound
