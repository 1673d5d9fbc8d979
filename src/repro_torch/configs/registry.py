"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

Only the architectures the port runs are registered."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
}


def list_archs() -> List[str]:
  return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
  if arch not in _MODULES:
    raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
  mod = importlib.import_module(_MODULES[arch])
  return mod.SMOKE if smoke else mod.CONFIG
