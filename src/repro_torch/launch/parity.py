"""An arch's SMOKE loop on a card against the same loop on the CPU.

Each kernel's wrapper runs its plain PyTorch version on a CPU tensor and
launches its CUDA kernel on a card's, so one loop run on both devices from
the same f32 weights and prompt holds every kernel of the path at once.
``tests/test_torch_card.py`` and ``chip_smoke.py`` both run it:

  from repro_torch.launch.parity import loop_parity
  launched, rel = loop_parity("smollm-135m", "cuda", mode="exact")
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

# Every step's logits on the card within this share of max|logits| of the
# CPU's: f32 sums in another order (tf32 off) through the SMOKE layers.
TOL = 1e-4
PROMPT, TOKENS = 64, 18            # one absorb of the 16-token ring
BUDGETS = [2, 1, 0] * 6


def smoke_f32(arch: str):
  """The arch's SMOKE config in f32 and its weights from seed 2, on the
  CPU."""
  cfg = dataclasses.replace(get_config(arch, smoke=True),
                            dtype=torch.float32)
  return cfg, tf.init_model(cfg, torch.Generator().manual_seed(2), "cpu")


def tree_to(tree, dev):
  return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
          for k, v in tree.items()}


def loop_parity(arch: str, device, mode: str = "synopsis",
                quant: str = "none") -> Tuple[Dict[str, int], float]:
  """The SMOKE loop (B = 2, prompt 64 from seed 3, 18 steps; budgets 2, 1,
  0 in turn in synopsis mode) under ``quant`` on the CPU and on
  ``device``.  Raises AssertionError unless the ids are equal and every
  step's logits lie within TOL of max|logits|, or if the CPU run launched
  a kernel.  Returns the launches of the ``device`` run and the largest
  step's distance as a share of its max|logits|."""
  cfg, params = smoke_f32(arch)
  cfg = serve.apply_quant(cfg, quant)
  prompt = torch.randint(0, cfg.vocab, (2, PROMPT),
                         generator=torch.Generator().manual_seed(3))
  outs, launched = {}, {}
  for where in ("cpu", device):
    before = _build.launch_counts()
    outs[where] = serve.run(
        cfg, batch=2, prompt_len=PROMPT, tokens=TOKENS, device=where,
        params=tree_to(params, where), prompt=prompt.to(where),
        budgets=BUDGETS if mode == "synopsis" else None, mode=mode,
        keep_logits=True, log=lambda _: None)
    if torch.device(where).type == "cuda":
      torch.cuda.synchronize()
    launched[where] = {k: n - before[k]
                       for k, n in _build.launch_counts().items()}
  label = f"{arch} smoke {mode} quant={quant}"
  if any(launched["cpu"].values()):
    raise AssertionError(f"{label}: the CPU run launched "
                         f"{launched['cpu']}")
  cpu, card = outs["cpu"], outs[device]
  if not torch.equal(card["tokens"].cpu(), cpu["tokens"]):
    raise AssertionError(f"{label}: ids differ: {card['tokens'].tolist()} "
                         f"vs {cpu['tokens'].tolist()}")
  rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
            for a, b in zip(card["step_logits"], cpu["step_logits"]))
  if not rel <= TOL:
    raise AssertionError(f"{label}: logits differ by {rel} of max (tol "
                         f"{TOL})")
  return launched[device], rel
