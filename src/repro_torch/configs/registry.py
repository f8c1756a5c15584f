"""Architecture registry: `--arch <id>` resolution for the port's launchers.

Lists only the architectures the port can build, under the reference's
ids (`src/repro/configs/`): the dense GQA / MHA decoders, hymba-1.5b
(hybrid attention + Mamba heads) and xlstm-1.3b (mLSTM / sLSTM).  The rest
of the reference zoo joins as the port gains their block kinds (see
ROADMAP.md); an id the port cannot build raises `KeyError`.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port builds: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


# long_500k needs sub-quadratic attention: the ssm and hybrid archs serve it
# natively (an O(1) recurrent state; hybrid's attention keeps its own
# window), the dense archs through a sliding window of LONG_CONTEXT_WINDOW
# keys and a rolling KV cache of as many slots (`ServingEngine(window=...)`),
# as the reference does.
LONG_CONTEXT_WINDOW = 8192


def long_500k_mode(arch_id: str) -> str:
    """How the arch serves a 500k-token context, as the reference's:
    'native' for the ssm and hybrid families, 'sliding_window' for the
    dense archs.  The reference's 'skip' (whisper's encoder-decoder) comes
    back with that arch; `get_config` raises KeyError for an arch the port
    does not build."""
    if get_config(arch_id).family in ("ssm", "hybrid"):
        return "native"
    return "sliding_window"
