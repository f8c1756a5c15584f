"""Federated experiments: the `Experiment` builder, the engine registry
(`sim`, `async`), the async engine's virtual clock and the round-loop
callbacks.  Mirrors `src/repro/federated/`."""
from repro_torch.federated.api import Experiment, TrainOptions
from repro_torch.federated.engine import (AsyncEngine, Callback,
                                          LedgerCallback,
                                          LoggingCallback, RoundEvent,
                                          RoundTask, RunState, SimEngine,
                                          StopRun, registered_engines,
                                          resolve_engine)
from repro_torch.federated.runtime import ExperimentResult

__all__ = ["AsyncEngine", "Callback", "Experiment", "ExperimentResult",
           "LedgerCallback", "LoggingCallback", "RoundEvent", "RoundTask",
           "RunState", "SimEngine", "StopRun", "TrainOptions",
           "registered_engines", "resolve_engine"]
