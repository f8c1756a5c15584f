"""Execution engines: one federated round loop behind a registry.

The port of `src/repro/federated/engine.py` for the synchronous `sim`
backend.  An `Engine` compiles a `RoundTask` into a step (one call = one
FL round) and drives the callback-instrumented loop:

    compile(plan)  -> step
    run_rounds(state, data, callbacks) -> state'

The loop body is a `Callback` pipeline (`on_round_end` / `on_eval`);
`LedgerCallback` does the communication accounting and `LoggingCallback`
prints progress.  A callback may raise `StopRun`.

After each round the engine pulls the round's metrics to the host once:
the only host sync of a round.  Recorded losses and ledger entries are
reduced on the host in a fixed order (`_mean_f32`, `_sum_f32`), as the
reference does, so the records do not depend on a device's reduction
order.

Not ported yet: the sharded engine, the async engine, population runs,
evaluation and checkpoint callbacks (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, ClassVar, Dict, List, Optional, Sequence,
                    Type, Union)

import numpy as np
import torch

from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.models.config import FederatedConfig

DataProvider = Callable[[int], Any]
# data(round_idx) -> dict of tensors, leaves (n_clients, steps, bs, ...)


def _mean_f32(values) -> float:
    """Sequential float32 mean: the canonical host reduction for recorded
    metrics (the reference's, so records match across packages)."""
    vals = np.asarray(values, np.float32)
    acc = np.float32(0.0)
    for v in vals:
        acc = np.float32(acc + v)
    return float(np.float32(acc / np.float32(max(vals.size, 1))))


def _sum_f32(values) -> float:
    """Sequential float32 sum (see `_mean_f32`)."""
    acc = np.float32(0.0)
    for v in np.asarray(values, np.float32):
        acc = np.float32(acc + v)
    return float(acc)


@dataclasses.dataclass
class RoundTask:
    """The static facets of one experiment: what an engine compiles.

    loss_of  -- `loss_of(params, trainable_tree, microbatch) -> scalar`
                when `params` is set (the backbone is then an explicit step
                argument), else `loss_of(trainable_tree, microbatch)`.
    meta     -- `fedround.FlatMeta` of the trainable tree.
    fed      -- federation geometry + client/server optimizer settings.
    strategy -- the resolved `Strategy` instance.
    seed     -- base seed; round r quantizes with generators derived from
                `fedround.fold_in(seed + 2, r)`.
    params   -- the frozen backbone (nested dict of tensors), or None.
    """
    loss_of: fedround.LossFn
    meta: fedround.FlatMeta
    fed: FederatedConfig
    strategy: st.Strategy
    seed: int = 0
    params: Any = None


@dataclasses.dataclass
class RunState:
    """Everything that changes between rounds.  `round` is the next round
    to run; `flatP` the flat trainable vector; `server` the server
    optimizer state (`fedround.init_server`); `sstate` the strategy's."""
    plan: RoundTask
    flatP: Any
    server: Any
    sstate: Any
    round: int = 0
    rounds: int = 0
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @classmethod
    def fresh(cls, plan: RoundTask, flatP, *, rounds: int) -> "RunState":
        return cls(plan, flatP, fedround.init_server(flatP),
                   plan.strategy.init_state(plan.meta.p_len),
                   round=0, rounds=rounds)


class StopRun(Exception):
    """Raised by a callback to end `run_rounds` cleanly after the current
    round's bookkeeping."""


@dataclasses.dataclass
class RoundEvent:
    """Mutable context handed to every callback hook for one round.
    `metrics` are the round's metrics, already on the host."""
    round: int
    state: RunState
    metrics: Dict[str, Any]
    record: Dict[str, Any]
    evaluated: bool = False


class Callback:
    """Round-loop hook protocol; all hooks default to no-ops.  `on_eval`
    runs after every `on_round_end` when a hook set `ev.evaluated`."""

    def on_round_end(self, ev: RoundEvent) -> None:
        pass

    def on_eval(self, ev: RoundEvent) -> None:
        pass


class LedgerCallback(Callback):
    """Per-round communication accounting, one message per cohort client,
    with the index-vs-bitmap coding minimum taken per message."""

    def __init__(self, ledger):
        self.ledger = ledger

    def on_round_end(self, ev: RoundEvent) -> None:
        m, led = ev.metrics, self.ledger
        n_messages = int(m.get("n_messages", ev.state.plan.fed.n_clients))
        down_pm = np.asarray(m["down_nnz_clients"], np.float32).tolist()
        up_pm = np.asarray(m["up_nnz_clients"], np.float32).tolist()
        led.record_round(
            n_messages, _mean_f32(down_pm), _sum_f32(up_pm),
            down_per_message=down_pm, up_per_message=up_pm)
        ev.record.update(
            down_bytes=led.down_bytes, up_bytes=led.up_bytes,
            total_bytes=led.total_bytes, coded_bytes=led.total_coded_bytes,
            down_coded_bytes=led.down_coded_bytes,
            up_coded_bytes=led.up_coded_bytes)


class LoggingCallback(Callback):
    """Prints the one-line progress record every `every` rounds."""

    def __init__(self, verbose: bool = True, every: int = 0):
        self.verbose = verbose
        self.every = every

    def _line(self, ev: RoundEvent) -> str:
        rec = ev.record
        acc = f" acc={rec['acc']:.4f}" if "acc" in rec else ""
        return (f"  round {ev.round + 1:4d} loss={rec['loss']:.4f}{acc} "
                f"comm={rec.get('total_bytes', 0) / 1e6:.2f}MB")

    def on_round_end(self, ev: RoundEvent) -> None:
        if (self.verbose and not ev.evaluated and self.every > 0
                and (ev.round + 1) % self.every == 0):
            print(self._line(ev))

    def on_eval(self, ev: RoundEvent) -> None:
        if self.verbose:
            print(self._line(ev))


# ---------------------------------------------------------------------------
# the engine protocol + registry
# ---------------------------------------------------------------------------

def _to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The round's one device->host pull of its metrics; the round's
    `PhaseTimes` are read after it, as {phase: ms}."""
    out = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in metrics.items()}
    out["phase_ms"] = out["phase_ms"].read()
    return out


class Engine:
    """Execution backend: compiles a `RoundTask` into a step and drives
    the callback-instrumented round loop."""

    name: ClassVar[str] = "base"

    def config(self) -> Dict[str, Any]:
        """Constructor kwargs that rebuild an equivalent backend."""
        return {}

    def _step_params(self, plan: RoundTask) -> tuple:
        return () if plan.params is None else (plan.params,)

    def compile(self, plan: RoundTask):
        """-> step(flatP, server, sstate, batch, rng_seed) -> (flatP',
        server', sstate', metrics); with `plan.params` set the step takes
        the backbone first."""
        raise NotImplementedError

    def run_rounds(self, state: RunState, data: DataProvider,
                   callbacks: Sequence[Callback] = ()) -> RunState:
        """Run rounds [state.round, state.rounds); mutates and returns
        `state`.  Round r's rng seed is `fold_in(seed + 2, r)`."""
        plan = state.plan
        pargs = self._step_params(plan)
        step = self.compile(plan)
        try:
            with torch.no_grad():
                r = state.round
                while r < state.rounds:
                    seed = fedround.fold_in(plan.seed + 2, r)
                    state.flatP, state.server, state.sstate, metrics = step(
                        *pargs, state.flatP, state.server, state.sstate,
                        data(r), seed)
                    self._finish_round(state, r, metrics, callbacks)
                    r += 1
        except StopRun:
            pass
        return state

    def _finish_round(self, state: RunState, round_idx: int, metrics,
                      callbacks: Sequence[Callback]) -> None:
        metrics = _to_host(metrics)
        loss = (_mean_f32(metrics["loss_clients"])
                if "loss_clients" in metrics else float(metrics["loss"]))
        record: Dict[str, Any] = {"round": round_idx, "loss": loss,
                                  "phase_ms": metrics["phase_ms"]}
        ev = RoundEvent(round=round_idx, state=state, metrics=metrics,
                        record=record)
        # a StopRun from any hook still finishes this round's bookkeeping
        stop: Optional[StopRun] = None
        try:
            for cb in callbacks:
                cb.on_round_end(ev)
            if ev.evaluated:
                for cb in callbacks:
                    cb.on_eval(ev)
        except StopRun as e:
            stop = e
        state.history.append(record)
        state.round = round_idx + 1
        if stop is not None:
            raise stop


_ENGINES: Dict[str, Type[Engine]] = {}
# registered by the reference, not ported yet (ROADMAP queue 1)
UNPORTED_ENGINES = ("sharded", "async")


def register_engine(name: str):
    """Class decorator: `@register_engine("sim")`."""
    def deco(cls: Type[Engine]) -> Type[Engine]:
        if not issubclass(cls, Engine):
            raise TypeError(f"{cls} is not an Engine")
        cls.name = name
        _ENGINES[name] = cls
        return cls
    return deco


def registered_engines():
    return tuple(sorted(_ENGINES))


EngineLike = Union[Engine, str, Type[Engine]]


def resolve_engine(obj: EngineLike, **kwargs) -> Engine:
    """Engine instance / registered name / Engine class -> instance."""
    if isinstance(obj, Engine):
        if kwargs:
            raise TypeError("pass constructor kwargs with a name, not an "
                            "instance")
        return obj
    if isinstance(obj, str):
        if obj in UNPORTED_ENGINES:
            raise NotImplementedError(
                f"the {obj!r} engine is not ported yet (ROADMAP queue 1, "
                f"items 7 and 12); the port has {registered_engines()}")
        try:
            cls = _ENGINES[obj]
        except KeyError:
            raise KeyError(f"no engine registered as {obj!r}; known: "
                           f"{registered_engines()}") from None
        return cls(**kwargs)
    if isinstance(obj, type) and issubclass(obj, Engine):
        return obj(**kwargs)
    raise TypeError(f"cannot resolve {obj!r} to an Engine")


@register_engine("sim")
class SimEngine(Engine):
    """Single-device simulation: the whole cohort runs on one device, one
    round per step (eager PyTorch; the kernels run on the card)."""

    def config(self) -> Dict[str, Any]:
        return {}

    def compile(self, plan: RoundTask):
        return fedround.make_round_fn(plan.loss_of, plan.meta, plan.fed,
                                      plan.strategy,
                                      with_params=plan.params is not None)
