"""Runtime helpers of the experiment loop: the port of the parts of
`src/repro/federated/runtime.py` that the task-less path needs.  The task
path (`model_for_task`, `pretrain`, `evaluate`) is not ported yet
(ROADMAP queue 1)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.core import comm as comm_mod
from repro_torch.models.config import ModelConfig


def _task_batch(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Adapt task arrays to the model input dict (the token LM takes them
    as they are)."""
    return dict(batch)


@dataclasses.dataclass
class ExperimentResult:
    history: List[Dict[str, Any]]
    ledger: comm_mod.CommLedger
    final_acc: float
