"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

Only the architectures the port runs are registered."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
}


def list_archs() -> List[str]:
  return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
  if arch not in _MODULES:
    raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
  mod = importlib.import_module(_MODULES[arch])
  return mod.SMOKE if smoke else mod.CONFIG
