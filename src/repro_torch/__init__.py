"""PyTorch and CUDA port of the `repro` package, for one NVIDIA H100.

The JAX package under `src/repro/` is the reference; this package mirrors
its file names so each module's counterpart is easy to find.  It imports
`torch` and numpy only, never `jax` and nothing of `repro`.

Entry points (`serving.ServingEngine`, `models.layers.init_params`, the
`launch.serve` CLI, `federated.Experiment`, `federated.pretrain` and
`federated.evaluate`) run on the card unless the caller passes
`device="cpu"` (or, for `pretrain` and `evaluate`, CPU tensors); on the
CPU every kernel wrapper takes its plain PyTorch version.  Ported so far:
multi-tenant LoRA serving of dense GQA decoder models (`serving/`); the
FLASC federated round on the `sim` engine with its Top-K transport
kernels (`core/`, `federated/`); sparse aggregation of packed uploads
with the pack kernels, on `sim` and on the event-driven `async` engine
(`federated/async_clock.py`); long prompts through the flash kernel and
the `kernels/ops.py` entry point; and the paper's task path: the four
synthetic federated tasks (`data/`), the ViT / GPT task models and the
paper's backbones (`configs/paper_models.py`), central pretraining and
evaluation (`federated/runtime.py`) behind `Experiment(task)`.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the card.  Raises when a CUDA device is asked for (or
    defaulted to) and none is present: nothing silently falls back to the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the host")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
