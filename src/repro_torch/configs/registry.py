"""Architecture registry: `--arch <id>` resolution for the port's launchers.

Lists only the architectures the port can build.  The rest of the
reference zoo (`src/repro/configs/`) joins as the port gains their block
kinds (see ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port builds: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG
