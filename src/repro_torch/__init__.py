"""PyTorch/CUDA port of the AccuracyTrader serving path (the JAX package
``repro`` is the reference; nothing here imports it).

The package mirrors ``repro``'s layout (``configs``, ``models``,
``kernels``, ``core``, ``serve``, ``serving``, ``control``, ``train``,
``launch``) so each module's counterpart is easy to find.  Tensors keep the JAX layouts at function
boundaries: decode caches ``(nb, na, B, Hkv, S, D)``, decode queries
``(B, H, D)``, attention partials ``(o (B,H,D) f32, m (B,H), l (B,H))``.

Kernels dispatch on the device of their inputs: a CUDA tensor launches the
hand-written Hopper kernel (``kernels/csrc``), a CPU tensor runs the plain
PyTorch version in ``kernels/ref.py``.  Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no card is present
(see :func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
  """``None``/``"cuda"`` -> the card, which must exist; ``"cpu"`` only when
  the caller asks for it.  There is no silent fallback to the CPU."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "repro_torch runs on a CUDA device and none is available; pass "
        "device='cpu' (--device cpu) to run the plain PyTorch path")
  return dev
