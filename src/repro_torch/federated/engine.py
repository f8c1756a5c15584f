"""Execution engines: one federated round loop behind a registry.

The port of `src/repro/federated/engine.py` for the synchronous `sim`
backend and the event-driven `async` backend.  An `Engine` compiles a
`RoundTask` into a step (one call = one FL round) and drives the
callback-instrumented loop:

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

`AsyncEngine` runs split client / server phases on a virtual clock
(`federated/async_clock.py`); at its defaults it reproduces `SimEngine`
bit for bit.

Not ported yet: the sharded engine, population runs, evaluation and
checkpoint callbacks (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, ClassVar, Dict, List, Optional, Sequence,
                    Type, Union)

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import fedround
from repro_torch.core import strategies as st
from repro_torch.core import transport as tp
from repro_torch.federated import async_clock as ac
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
    optimizer state (`fedround.init_server`); `sstate` the strategy's.
    `aux` is engine-owned state: None for `sim`; the async engine's
    virtual-clock snapshot (`VirtualClock.to_arrays`), from which a later
    `run_rounds` on the same state continues."""
    plan: RoundTask
    flatP: Any
    server: Any
    sstate: Any
    round: int = 0
    rounds: int = 0
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    aux: Any = None

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
    if isinstance(out["phase_ms"], fedround.PhaseTimes):
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
                      callbacks: Sequence[Callback],
                      extra: Optional[Dict[str, Any]] = None) -> None:
        metrics = _to_host(metrics)
        loss = (_mean_f32(metrics["loss_clients"])
                if "loss_clients" in metrics else float(metrics["loss"]))
        record: Dict[str, Any] = {"round": round_idx, "loss": loss,
                                  "phase_ms": metrics["phase_ms"]}
        if extra:
            record.update(extra)
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
UNPORTED_ENGINES = ("sharded",)


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
                f"item 12); the port has {registered_engines()}")
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


@register_engine("async")
class AsyncEngine(Engine):
    """Event-driven async backend: virtual-clock client timing and
    FedBuff-style buffered, staleness-weighted aggregation.

    Clients draw compute speed and up/down bandwidth from a
    `ClientSystemProfile`; a job downloads the current server snapshot,
    trains locally and uploads its delta, completing at

        t_start + coded_down_bytes / down_bw
                + local_steps * step_time / speed
                + coded_up_bytes / up_bw

    on the virtual clock, both transfers charged over the coded wire bytes
    the `CommLedger` bills.  When `buffer_size` updates have arrived the
    server aggregates them, each scaled by the `staleness_weight` of
    (current version - start version), applies the server optimizer and
    advances one "round".  Updates staler than `max_staleness` are dropped
    (their traffic is still billed).  One aggregation event is one round
    of the callback pipeline; its history record also carries `sim_time`,
    `staleness`, `applied` and `dropped`, `phase_ms` (the client phases
    launched since the previous event plus the server step) and
    `launch_bytes` (the bytes each of those launches pulled to the host).

    With `sparse_aggregate=True` a launch pulls each job's packed
    (index, value) row, O(cap) instead of O(p_len), or the dense row of a
    message that overflowed the capacity; a buffer of packed jobs
    aggregates through the scatter-add server phase, any dense row flips
    the event to the dense phase.

    Sync-equivalence anchor: with `concurrency == buffer_size ==
    n_clients` and a uniform profile (the defaults) every event is one
    full fresh cohort at staleness 0, and the run reproduces `SimEngine`
    bit for bit.

    Refused: DP aggregation (`fed.dp_clip > 0`).  Not ported yet
    (`NotImplementedError`, ROADMAP queue 1, item 8): `sampler=` and the
    slot-specialised server phase a non-uniform `Strategy.aggregate` needs
    under partial buffers.
    """

    def __init__(self, *, concurrency: Optional[int] = None,
                 buffer_size: Optional[int] = None,
                 staleness_alpha: float = 0.5,
                 max_staleness: Optional[int] = None,
                 allow_version_repeats: bool = False,
                 profile=None, sampler=None):
        if sampler is not None:
            raise NotImplementedError(
                "AsyncEngine(sampler=...) needs federated/population.py, "
                "which is not ported yet (ROADMAP queue 1, item 8)")
        if isinstance(profile, dict):   # config() round trip
            profile = ac.ClientSystemProfile(
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in profile.items()})
        self.concurrency = None if concurrency is None else int(concurrency)
        self.buffer_size = None if buffer_size is None else int(buffer_size)
        self.staleness_alpha = float(staleness_alpha)
        self.max_staleness = (None if max_staleness is None
                              else int(max_staleness))
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got "
                             f"{self.max_staleness}")
        # by default a client waits for the server version to advance
        # before its next job; True lets fast clients train continuously,
        # repeat jobs folding fresh quantization seeds
        self.allow_version_repeats = bool(allow_version_repeats)
        self.profile = profile if profile is not None \
            else ac.ClientSystemProfile()

    def config(self) -> Dict[str, Any]:
        return {"concurrency": self.concurrency,
                "buffer_size": self.buffer_size,
                "staleness_alpha": self.staleness_alpha,
                "max_staleness": self.max_staleness,
                "allow_version_repeats": self.allow_version_repeats,
                "profile": dataclasses.asdict(self.profile),
                "sampler": None}

    def compile(self, plan: RoundTask):
        raise NotImplementedError(
            "AsyncEngine has no single-round step: it drives split client/"
            "server phases (fedround.make_client_phase_fn / "
            "make_server_phase_fn) from run_rounds")

    # --- the event loop ----------------------------------------------------
    def run_rounds(self, state: RunState, data: DataProvider,
                   callbacks: Sequence[Callback] = ()) -> RunState:
        plan = state.plan
        fed, meta = plan.fed, plan.meta
        if fed.dp_clip > 0.0:
            raise NotImplementedError(
                "AsyncEngine: DP aggregation (dp_clip > 0) under buffered/"
                "partial aggregation: the noise scale assumes one uniform "
                "synchronous cohort (and core/dp.py is not ported yet, "
                "ROADMAP queue 1, item 6)")
        n = fed.n_clients
        concurrency = (n if self.concurrency is None
                       else min(self.concurrency, n))
        buffer_size = n if self.buffer_size is None else self.buffer_size
        if concurrency < 1 or buffer_size < 1:
            raise ValueError(f"concurrency {concurrency} and buffer_size "
                             f"{buffer_size} must be >= 1")
        prof = self.profile
        spec = plan.strategy.spec
        down_vb, down_dense = tp.wire_format(spec, meta.p_len, "down")
        up_vb, up_dense = tp.wire_format(spec, meta.p_len, "up")
        # jobs carry packed rows at this capacity; 0 means stay dense
        pack_cap = st.sparse_aggregate_capacity(plan.strategy, meta.p_len)
        server_fns = (
            fedround.make_server_phase_fn(meta, fed, plan.strategy),
            fedround.make_server_phase_fn(meta, fed, plan.strategy,
                                          sparse=True) if pack_cap else None)
        full_slots = tuple(range(n))

        def get_server_fns(slots):
            if plan.strategy.uniform_aggregation or slots == full_slots:
                return server_fns
            raise NotImplementedError(
                "AsyncEngine: a non-uniform Strategy.aggregate under a "
                "partial or stale buffer needs the slot-specialised server "
                "phase (cohort_slots), not ported yet (ROADMAP queue 1, "
                "item 8)")

        clock = (ac.VirtualClock.from_arrays(state.aux, n, meta.p_len)
                 if state.aux is not None
                 else ac.VirtualClock(n, meta.p_len))
        # job index -> cohort batch; data(j) is deterministic, so entries a
        # straggler still needs can be evicted and recomputed
        data_cache: Dict[int, Any] = {}
        data_cache_cap = max(2 * n, 16)

        def fetch(j: int):
            if j not in data_cache:
                if len(data_cache) >= data_cache_cap:
                    del data_cache[next(iter(data_cache))]   # oldest insert
                data_cache[j] = data(j)
            return data_cache[j]

        pargs = self._step_params(plan)
        device = state.flatP.device
        # the client phases launched since the previous aggregation event
        pending_phases: List[Dict[str, float]] = []
        pending_bytes: List[int] = []

        def launch(slots):
            version = state.round
            repeats = tuple(clock.version_repeat(c, version) for c in slots)
            if not (spec.quant_bits_up or spec.quant_bits_down):
                repeats = (0,) * len(slots)     # repeats only move seeds
            rows = [fetch(int(clock.job_counts[c])) for c in slots]
            batch = {k: torch.stack([r[k][c] for r, c in zip(rows, slots)])
                     for k in rows[0]}
            phase = fedround.make_client_phase_fn(
                plan.loss_of, meta, fed, plan.strategy, slots, repeats,
                pack_cap=pack_cap or None, with_params=plan.params is not None)
            phases = fedround.PhaseTimes(device)
            out = phase(*pargs, state.flatP, state.sstate,
                        torch.tensor(version, dtype=torch.int32,
                                     device=device),
                        batch, fedround.fold_in(plan.seed + 2, version),
                        phases=phases)
            deltas, up_nnzs, losses, down_nnzs = out[:4]
            # stage each starter's next batch while the launch runs
            for c in slots:
                fetch(int(clock.job_counts[c]) + 1)
            # one bulk pull per output; jobs keep host rows, so no device
            # row outlives its launch
            small = [down_nnzs, up_nnzs, losses]
            down_host, up_host, loss_host = (
                t.detach().cpu().numpy().astype(np.float32) for t in small)
            nbytes = sum(t.numel() * t.element_size() for t in small)
            if pack_cap:
                pidx, pval, pnnz = out[4:]
                fits = pnnz.cpu().numpy() <= pack_cap
                if not fits.all():          # overflow: pull those rows dense
                    keep = torch.from_numpy(np.flatnonzero(fits)).to(device)
                    over = torch.from_numpy(np.flatnonzero(~fits)).to(device)
                    pidx, pval = (pidx.index_select(0, keep),
                                  pval.index_select(0, keep))
                    deltas = deltas.index_select(0, over)
                idx_host, val_host = pidx.cpu().numpy(), pval.cpu().numpy()
                dense_host = (deltas.float().cpu().numpy() if not fits.all()
                              else np.zeros((0, meta.p_len), np.float32))
                nbytes += (pnnz.numel() * 4 + idx_host.nbytes
                           + val_host.nbytes + dense_host.nbytes)
                packed = iter(zip(idx_host, val_host))
                dense = iter(dense_host)
                delta_rows = [next(packed) if f else next(dense)
                              for f in fits]
            else:
                delta_host = deltas.detach().float().cpu().numpy()
                nbytes += delta_host.nbytes
                delta_rows = list(delta_host)
            pending_phases.append(phases.read())
            pending_bytes.append(int(nbytes))
            for i, c in enumerate(slots):
                dn, un = float(down_host[i]), float(up_host[i])
                dur = (prof.down_time(c, comm_mod.coded_message_bytes(
                           int(dn), meta.p_len, 1, down_vb, down_dense))
                       + prof.compute_time(c, fed.local_steps)
                       + prof.up_time(c, comm_mod.coded_message_bytes(
                           int(un), meta.p_len, 1, up_vb, up_dense)))
                clock.submit(ac.Job(
                    slot=c, version=version, seq=clock.next_seq(),
                    t_start=clock.now, t_finish=clock.now + dur,
                    delta=delta_rows[i], loss=loss_host[i],
                    down_nnz=dn, up_nnz=un))
                clock.job_counts[c] += 1

        def start_jobs():
            version = state.round
            budget = max(concurrency - len(clock.inflight), 0)
            startable = [c for c in clock.idle
                         if (self.allow_version_repeats
                             or clock.last_version[c] < version)]
            starters = startable[:budget]
            taken = set(starters)
            clock.idle = [c for c in clock.idle if c not in taken]
            if not starters:
                return
            slots = tuple(sorted(starters))
            if slots == full_slots or len(slots) == 1:
                # a full fresh cohort runs as ONE client phase: the
                # sync-equivalence anchor needs the round's batch shape
                launch(slots)
            else:
                for c in slots:
                    launch((c,))
            # every future job index is >= the slowest client's count
            low = int(clock.job_counts.min())
            for old in [j for j in data_cache if j < low]:
                del data_cache[old]

        try:
            with torch.no_grad():
                while state.round < state.rounds:
                    if not clock.pending:
                        start_jobs()
                        if not clock.inflight:
                            # every client already contributed to this
                            # version: flush the buffer partially (FedBuff
                            # timeout semantics)
                            if not clock.buffer:
                                raise RuntimeError("async engine deadlocked")
                            self._aggregate(state, clock, get_server_fns,
                                            callbacks, pending_phases,
                                            pending_bytes)
                            continue
                        clock.pull_completions()
                    job = clock.pending.pop(0)
                    clock.idle.append(job.slot)
                    staleness = state.round - job.version
                    if (self.max_staleness is not None
                            and staleness > self.max_staleness):
                        clock.drop(job)
                        continue
                    clock.buffer.append(job)
                    if len(clock.buffer) >= buffer_size:
                        self._aggregate(state, clock, get_server_fns,
                                        callbacks, pending_phases,
                                        pending_bytes)
        except StopRun:
            pass
        state.aux = clock.to_arrays()
        return state

    def _aggregate(self, state: RunState, clock: ac.VirtualClock,
                   get_server_fns, callbacks: Sequence[Callback],
                   pending_phases: List[Dict[str, float]],
                   pending_bytes: List[int]) -> None:
        """One buffered aggregation event, then the round-end callbacks.
        Updates aggregate in submission (seq) order, so a full fresh cohort
        aggregates in slot order, like the synchronous round.  A buffer of
        packed jobs goes through the sparse server phase; any dense row
        flips the event to the dense phase, its packed peers densified on
        the host first.  The stacked buffer goes to the device once."""
        jobs, clock.buffer = sorted(clock.buffer, key=lambda j: j.seq), []
        server_fn, sparse_fn = get_server_fns(
            tuple(int(j.slot) for j in jobs))
        staleness = [state.round - j.version for j in jobs]
        device = state.flatP.device
        weights = torch.tensor(
            [ac.staleness_weight(s, self.staleness_alpha) for s in staleness],
            dtype=torch.float32, device=device)
        phases = fedround.PhaseTimes(device)
        if sparse_fn is not None and all(isinstance(j.delta, tuple)
                                         for j in jobs):
            idx = torch.from_numpy(np.stack([j.delta[0] for j in jobs]))
            val = torch.from_numpy(np.stack([j.delta[1] for j in jobs]))
            state.flatP, state.server, state.sstate = sparse_fn(
                state.flatP, state.server, state.sstate, idx.to(device),
                val.to(device), weights)
        else:
            deltas = torch.from_numpy(np.stack(
                [ac.dense_delta(j.delta, clock.p_len) for j in jobs]))
            state.flatP, state.server, state.sstate = server_fn(
                state.flatP, state.server, state.sstate, deltas.to(device),
                weights)
        phases.mark("server")
        phase_ms: Dict[str, float] = {}
        for ph in pending_phases + [phases.read()]:
            for k, v in ph.items():
                phase_ms[k] = phase_ms.get(k, 0.0) + v
        drop_down, drop_up = clock.take_drops()
        down_list = [j.down_nnz for j in jobs] + drop_down
        up_list = [j.up_nnz for j in jobs] + drop_up
        metrics: Dict[str, Any] = {
            # a full fresh cohort in seq order carries the synchronous
            # round's values in its order: the host reductions match
            "loss_clients": [j.loss for j in jobs],
            "down_nnz": _mean_f32(down_list),
            "up_nnz": _sum_f32(up_list),
            "down_nnz_clients": down_list,
            "up_nnz_clients": up_list,
            "n_messages": len(down_list),
            "phase_ms": phase_ms,
        }
        extra = {"sim_time": clock.now,
                 "staleness": _mean_f32(staleness),
                 "applied": len(jobs), "dropped": len(drop_down),
                 "launch_bytes": list(pending_bytes)}
        pending_phases.clear()
        pending_bytes.clear()
        self._finish_round(state, state.round, metrics, callbacks,
                           extra=extra)
