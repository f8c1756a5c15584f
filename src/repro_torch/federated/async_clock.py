"""Event-driven virtual clock for asynchronous federated simulation.

The port's own copy of `src/repro/federated/async_clock.py` (numpy only,
the same classes and arithmetic).  `AsyncEngine` (federated/engine.py)
separates *what* a client computes -- the client phase of
`core.fedround.make_client_phase_fn` -- from *when* its update reaches
the server.  This module owns the "when":

  * `ClientSystemProfile` -- per-client compute speed and up/down
    bandwidth; a job's virtual duration is download time + compute time +
    upload time, where both transfer times are charged over the *coded*
    wire bytes of the actual messages (`core.comm.coded_message_bytes`,
    the same index-vs-bitmap minimum the `CommLedger` bills).
  * `staleness_weight` -- the FedBuff-style polynomial discount applied to
    buffered updates at aggregation time.
  * `Job` / `VirtualClock` -- the in-flight job records, the completion
    event queue, the server buffer, and lossless (de)serialization of the
    whole simulator state into flat numpy arrays.

Timestamps are float64 on the host; nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientSystemProfile:
    """Per-client system heterogeneity for the virtual clock.

    Base rates — `step_time` (seconds per local SGD step at speed 1.0)
    and `down_bw` / `up_bw` (bytes/second at bandwidth factor 1.0) — are
    scaled per client by the cyclic factor tuples: client `c` computes at
    `speed_factors[c % len(speed_factors)]` times base speed, and likewise
    for the two bandwidth directions.  Empty tuples mean "uniform at
    factor 1.0", which is the AsyncEngine sync-equivalence configuration.
    """
    step_time: float = 1.0
    down_bw: float = 1e6
    up_bw: float = 1e6
    speed_factors: Tuple[float, ...] = ()
    down_factors: Tuple[float, ...] = ()
    up_factors: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.step_time >= 0.0:
            raise ValueError(f"step_time must be >= 0, got {self.step_time}")
        if not (self.down_bw > 0.0 and self.up_bw > 0.0):
            raise ValueError(f"bandwidths must be > 0, got {self.down_bw}, "
                             f"{self.up_bw}")
        for name in ("speed_factors", "down_factors", "up_factors"):
            if not all(f > 0.0 for f in getattr(self, name)):
                raise ValueError(f"{name} must be strictly positive")

    @staticmethod
    def _factor(factors: Tuple[float, ...], client: int) -> float:
        return float(factors[client % len(factors)]) if factors else 1.0

    def compute_time(self, client: int, local_steps: int) -> float:
        return (local_steps * self.step_time
                / self._factor(self.speed_factors, client))

    def down_time(self, client: int, nbytes: float) -> float:
        return nbytes / (self.down_bw * self._factor(self.down_factors,
                                                     client))

    def up_time(self, client: int, nbytes: float) -> float:
        return nbytes / (self.up_bw * self._factor(self.up_factors, client))

    @property
    def is_uniform(self) -> bool:
        """True when every client sees identical rates (sync-equivalence
        needs this plus full concurrency and a full buffer)."""
        return all(len(set(f)) <= 1
                   for f in (self.speed_factors, self.down_factors,
                             self.up_factors))

    @classmethod
    def tiered(cls, n_clients: int, n_tiers: int,
               **kw) -> "ClientSystemProfile":
        """Round-robin budget tiers (the fig6 systems-heterogeneity grid):
        client i runs at speed/bandwidth factor ((i % n_tiers)+1)/n_tiers."""
        f = tuple(((i % n_tiers) + 1) / n_tiers for i in range(n_clients))
        return cls(speed_factors=f, down_factors=f, up_factors=f, **kw)

    @classmethod
    def lognormal(cls, n_clients: int, sigma: float = 0.5, seed: int = 0,
                  **kw) -> "ClientSystemProfile":
        """Independent log-normal speed and bandwidth factors (median 1.0),
        the classic straggler model."""
        rng = np.random.default_rng(seed)

        def draw():
            return tuple(float(x) for x in rng.lognormal(0.0, sigma,
                                                         n_clients))
        return cls(speed_factors=draw(), down_factors=draw(),
                   up_factors=draw(), **kw)


def staleness_weight(staleness: int, alpha: float) -> float:
    """FedBuff-style polynomial staleness discount: w(s) = (1+s)^(-alpha).

    w(0) == 1.0 exactly for every alpha, so an aggregation over a fresh
    full cohort applies unit weights and reduces bit-exactly to the
    synchronous server update.  alpha == 0 disables discounting.
    """
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return float((1.0 + float(staleness)) ** (-float(alpha)))


@dataclasses.dataclass
class Job:
    """One client's local update in flight on the virtual clock.

    `delta`/`loss` hold the already-computed results as HOST numpy rows
    (the engine runs the client phase at job start -- the client's view of
    the server is frozen then, so virtual completion time is pure
    bookkeeping -- and pulls the cohort outputs to the host once; keeping
    device rows here would pin the stacked device result until the last
    straggler aggregates).

    Under sparse aggregation (`StrategySpec.sparse_aggregate`) `delta` is
    the packed `(idx, val)` pair of (cap,) host rows — sentinel index
    `p_len` in empty slots — instead of the dense (p_len,) row;
    `dense_delta` recovers the dense form where the engine needs it.
    """
    slot: int                   # global client index
    version: int                # server version (round) the job started from
    seq: int                    # global submission counter (determinism)
    t_start: float
    t_finish: float
    delta: Any                  # (p_len,) f32, or packed (idx, val) pair
    loss: Any                   # f32 scalar
    down_nnz: float             # download message entries (for the ledger)
    up_nnz: float               # upload message entries


_JOB_SCALARS = (("slot", np.int64), ("version", np.int64), ("seq", np.int64),
                ("t_start", np.float64), ("t_finish", np.float64),
                ("loss", np.float32), ("down_nnz", np.float64),
                ("up_nnz", np.float64))


def dense_delta(delta: Any, p_len: int) -> np.ndarray:
    """A Job's delta as a dense (p_len,) f32 row: packed `(idx, val)`
    pairs are scatter-set into zeros (indices are unique and the sentinel
    `p_len` marks empty slots, so this is exact), dense rows pass
    through.  Note a position the packing skipped comes back as +0.0 even
    if the original masked row carried -0.0 there — aggregation sums are
    unaffected unless *every* contribution at a position is -0.0."""
    if not isinstance(delta, tuple):
        return np.asarray(delta, np.float32)
    idx, val = (np.asarray(delta[0]), np.asarray(delta[1], np.float32))
    out = np.zeros(p_len, np.float32)
    keep = idx < p_len
    out[idx[keep]] = val[keep]
    return out


def _jobs_to_arrays(jobs: List[Job], p_len: int) -> Dict[str, np.ndarray]:
    out = {name: np.asarray([getattr(j, name) for j in jobs], dtype)
           for name, dtype in _JOB_SCALARS}
    packed = [isinstance(j.delta, tuple) for j in jobs]
    if any(packed):
        # packed and dense jobs may coexist (capacity overflow): row i of
        # the job list maps to the next row of delta_idx/delta_val when
        # packed[i], else to the next row of delta — `_jobs_from_arrays`
        # walks the flag vector to re-zip them
        out["packed"] = np.asarray(packed, bool)
        pj = [j for j, p in zip(jobs, packed) if p]
        dj = [j for j, p in zip(jobs, packed) if not p]
        out["delta_idx"] = np.stack(
            [np.asarray(j.delta[0], np.int32) for j in pj])
        out["delta_val"] = np.stack(
            [np.asarray(j.delta[1], np.float32) for j in pj])
        out["delta"] = (np.stack([np.asarray(j.delta, np.float32)
                                  for j in dj])
                        if dj else np.zeros((0, p_len), np.float32))
    else:
        # no packed jobs: byte-identical to the pre-sparse checkpoint
        # layout, so existing dense-path checkpoints round-trip unchanged
        out["delta"] = (np.stack([np.asarray(j.delta, np.float32)
                                  for j in jobs])
                        if jobs else np.zeros((0, p_len), np.float32))
    return out


def _jobs_from_arrays(arrays: Dict[str, np.ndarray]) -> List[Job]:
    n = int(np.asarray(arrays["slot"]).shape[0])
    packed = (np.asarray(arrays["packed"], bool) if "packed" in arrays
              else np.zeros(n, bool))
    jobs, pi, di = [], 0, 0
    for i in range(n):
        if packed[i]:
            delta: Any = (np.asarray(arrays["delta_idx"][pi], np.int32),
                          np.asarray(arrays["delta_val"][pi], np.float32))
            pi += 1
        else:
            delta = np.asarray(arrays["delta"][di], np.float32)
            di += 1
        jobs.append(Job(
            slot=int(arrays["slot"][i]), version=int(arrays["version"][i]),
            seq=int(arrays["seq"][i]),
            t_start=float(arrays["t_start"][i]),
            t_finish=float(arrays["t_finish"][i]),
            delta=delta,
            loss=np.asarray(arrays["loss"][i], np.float32),
            down_nnz=float(arrays["down_nnz"][i]),
            up_nnz=float(arrays["up_nnz"][i])))
    return jobs


class VirtualClock:
    """The async simulator state: who is idle, what is in flight, what has
    completed-but-not-aggregated, and what virtual time it is.

    Determinism contract (what makes runs — and resumed runs — bit-exact):
    completions are processed in (t_finish, slot) order; same-timestamp
    completions are drained as one batch before any new job is scheduled;
    idle clients are scheduled FIFO in the order they went idle.
    """

    def __init__(self, n_clients: int, p_len: int):
        self.n_clients = n_clients
        self.p_len = p_len
        self.now = 0.0
        self.seq = 0
        self.job_counts = np.zeros(n_clients, np.int64)
        self.last_version = np.full(n_clients, -1, np.int64)
        self.runs_at_version = np.zeros(n_clients, np.int64)
        self.idle: List[int] = list(range(n_clients))
        self.inflight: List[Tuple[float, int, Job]] = []    # heap
        self.pending: List[Job] = []    # popped completions, not yet applied
        self.buffer: List[Job] = []     # server buffer (arrival order)
        self.drop_down: List[float] = []    # traffic of staleness-dropped
        self.drop_up: List[float] = []      # updates awaiting ledger billing

    # --- scheduling --------------------------------------------------------
    def next_seq(self) -> int:
        self.seq += 1
        return self.seq - 1

    def version_repeat(self, client: int, version: int) -> int:
        """0 for a client's first job against server `version`, else how
        many jobs it already ran against it (bumps the count)."""
        if self.last_version[client] == version:
            self.runs_at_version[client] += 1
        else:
            self.last_version[client] = version
            self.runs_at_version[client] = 0
        return int(self.runs_at_version[client])

    def submit(self, job: Job) -> None:
        heapq.heappush(self.inflight, (job.t_finish, job.slot, job))

    def pull_completions(self) -> None:
        """Advance `now` to the earliest in-flight completion and move every
        job finishing at exactly that time into `pending`, slot-ordered."""
        if not self.inflight:
            raise RuntimeError("no jobs in flight")
        t = self.inflight[0][0]
        batch = []
        while self.inflight and self.inflight[0][0] == t:
            batch.append(heapq.heappop(self.inflight)[2])
        batch.sort(key=lambda j: j.slot)
        self.now = t
        self.pending.extend(batch)

    def drop(self, job: Job) -> None:
        """Discard a too-stale update; its traffic still happened, so it is
        billed with the next aggregation event's record."""
        self.drop_down.append(job.down_nnz)
        self.drop_up.append(job.up_nnz)

    def take_drops(self) -> Tuple[List[float], List[float]]:
        d, u = self.drop_down, self.drop_up
        self.drop_down, self.drop_up = [], []
        return d, u

    # --- checkpoint (de)serialization --------------------------------------
    def to_arrays(self) -> Dict[str, Any]:
        """Flat numpy tree of the full simulator state (nested dicts of
        arrays), the form an npz experiment checkpoint stores."""
        inflight = [e[2] for e in sorted(self.inflight, key=lambda e: e[:2])]
        return {
            "now": np.asarray(self.now, np.float64),
            "seq": np.asarray(self.seq, np.int64),
            "job_counts": self.job_counts.copy(),
            "last_version": self.last_version.copy(),
            "runs_at_version": self.runs_at_version.copy(),
            "idle": np.asarray(self.idle, np.int64),
            "inflight": _jobs_to_arrays(inflight, self.p_len),
            "pending": _jobs_to_arrays(self.pending, self.p_len),
            "buffer": _jobs_to_arrays(self.buffer, self.p_len),
            "drop_down": np.asarray(self.drop_down, np.float64),
            "drop_up": np.asarray(self.drop_up, np.float64),
        }

    @classmethod
    def from_arrays(cls, arrays: Dict[str, Any], n_clients: int,
                    p_len: int) -> "VirtualClock":
        clock = cls(n_clients, p_len)
        clock.now = float(arrays["now"])
        clock.seq = int(arrays["seq"])
        clock.job_counts = np.asarray(arrays["job_counts"], np.int64).copy()
        clock.last_version = np.asarray(arrays["last_version"],
                                        np.int64).copy()
        clock.runs_at_version = np.asarray(arrays["runs_at_version"],
                                           np.int64).copy()
        clock.idle = [int(c) for c in np.asarray(arrays["idle"], np.int64)]
        clock.inflight = []
        for job in _jobs_from_arrays(arrays["inflight"]):
            clock.submit(job)
        clock.pending = _jobs_from_arrays(arrays["pending"])
        clock.buffer = _jobs_from_arrays(arrays["buffer"])
        clock.drop_down = [float(v) for v in np.asarray(arrays["drop_down"])]
        clock.drop_up = [float(v) for v in np.asarray(arrays["drop_up"])]
        return clock
