"""Federated experiments: the `Experiment` builder, the task runtime
(`model_for_task`, `pretrain`, `evaluate`), the engine registry (`sim`,
`async`), the async engine's virtual clock and the round-loop callbacks.
Mirrors `src/repro/federated/`."""
from repro_torch.federated.api import Experiment, ModelOptions, TrainOptions
from repro_torch.federated.engine import (AsyncEngine, Callback,
                                          EvalCallback, LedgerCallback,
                                          LoggingCallback, RoundEvent,
                                          RoundTask, RunState, SimEngine,
                                          StopRun, registered_engines,
                                          resolve_engine)
from repro_torch.federated.runtime import (ExperimentResult, evaluate,
                                           model_for_task, pretrain,
                                           run_experiment, task_loss)

__all__ = ["AsyncEngine", "Callback", "EvalCallback", "Experiment",
           "ExperimentResult", "LedgerCallback", "LoggingCallback",
           "ModelOptions", "RoundEvent", "RoundTask", "RunState",
           "SimEngine", "StopRun", "TrainOptions", "evaluate",
           "model_for_task", "pretrain", "registered_engines",
           "resolve_engine", "run_experiment", "task_loss"]
