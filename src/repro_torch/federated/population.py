"""Client populations far larger than the cohort: host-resident client
state, cohort sampling and double-buffered cohort prefetch.

The port of `src/repro/federated/population.py`.  The samplers and the
host store are numpy, and their cohorts are bit for bit the reference's
from the same seed:

  * `PopulationStore` -- chunked, lazily materialized host storage for one
    (row_len,) f32 row per client (the client's momentum).  A chunk never
    written reads back as zeros (a fresh client), so memory and checkpoint
    size are O(touched clients); its checkpoint payload keeps every chunk
    its own npz array (`{"chunks": {str(chunk_idx): (chunk, row_len)}}`).
    A chunk materializes whole on its first write, `chunk x row_len x 4`
    bytes: at a LoRA vector of millions of entries, pick `chunk` so that
    one chunk fits the host.
  * the `CohortSampler` registry (`uniform`, `fraction`, `availability`):
    which clients form round r's cohort, a pure function of (config, seed,
    r), so a resumed run replays the same cohorts with no saved state.
  * `CohortPrefetcher` -- the double buffer.  While round r computes on
    the card, round r+1's cohort is sampled, gathered from the store into
    a pinned host slab and copied host-to-device as ONE non-blocking copy
    on a side CUDA stream; the compute stream waits on the copy's event
    before the round reads the rows.  An overlapping next cohort stages
    only its ids and gathers after round r's commit, so prefetch never
    changes values.
  * `Population` -- the (store, sampler, prefetch) bundle a `RoundTask`
    carries; `Engine._run_population_rounds` drives it.
  * `DevicePopulationStore` -- one dense (population, row_len) tensor on a
    device with the store's interface: the test backend the host store is
    held to.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.federated import async_clock as ac

# ---------------------------------------------------------------------------
# cohort samplers
# ---------------------------------------------------------------------------

_SAMPLERS: Dict[str, Type["CohortSampler"]] = {}


def register_sampler(name: str):
    """Class decorator: `@register_sampler("fraction")` makes the sampler
    reachable from `resolve_sampler("fraction", ...)`, Population specs and
    the AsyncEngine `sampler=` argument."""
    def deco(cls: Type["CohortSampler"]) -> Type["CohortSampler"]:
        if not issubclass(cls, CohortSampler):
            raise TypeError(f"{cls} is not a CohortSampler")
        cls.kind = name
        _SAMPLERS[name] = cls
        return cls
    return deco


def registered_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_SAMPLERS))


class CohortSampler:
    """Deterministic cohort selection over a client population.

    `eligible(r)` -> (population,) bool mask of the clients available in
    round r; `sample(r)` -> (cohort,) int64 ascending client ids drawn
    uniformly from the eligible set.  Both are pure functions of (config,
    seed, r).  Membership is decided by per-client random scores
    (`default_rng([seed, r])`) selected with `argpartition`, O(N) in the
    population, and returned in ascending id order."""

    kind = "base"

    def __init__(self, population: int, cohort: Optional[int] = None,
                 seed: int = 0):
        if population < 1:
            raise ValueError(f"population {population} < 1")
        if cohort is not None and not 1 <= cohort <= population:
            raise ValueError(f"cohort {cohort} outside [1, {population}]")
        self.population = int(population)
        self.cohort = None if cohort is None else int(cohort)
        self.seed = int(seed)

    def eligible(self, round_idx: int) -> np.ndarray:
        return np.ones(self.population, bool)

    def sample(self, round_idx: int) -> np.ndarray:
        if self.cohort is None:
            raise ValueError(f"{self.kind}: construct with a cohort size to "
                             "sample")
        elig = self.eligible(round_idx)
        n_elig = int(elig.sum())
        if n_elig < self.cohort:
            raise RuntimeError(
                f"{self.kind}: round {round_idx} has {n_elig} eligible "
                f"clients < cohort {self.cohort}")
        scores = np.random.default_rng(
            [self.seed, round_idx]).random(self.population)
        scores[~elig] = np.inf
        pick = np.argpartition(scores, self.cohort - 1)[:self.cohort]
        return np.sort(pick.astype(np.int64))

    def config(self) -> Dict[str, Any]:
        """JSON spec: `resolve_sampler(self.config(), population=N)`
        rebuilds an equivalent sampler."""
        return {"kind": self.kind, "cohort": self.cohort, "seed": self.seed}


@register_sampler("uniform")
class UniformSampler(CohortSampler):
    """Every client eligible every round: uniform cohorts without
    replacement within a round."""


@register_sampler("fraction")
class FractionSampler(CohortSampler):
    """Bernoulli participation: client c is available in a round with
    probability `participation`, independently per (seed, round, client),
    from its own stream (`[seed, round, 1]`), so `participation=1.0` is
    bit for bit `uniform`."""

    def __init__(self, population: int, cohort: Optional[int] = None,
                 seed: int = 0, participation: float = 1.0):
        super().__init__(population, cohort, seed)
        if not 0.0 < participation <= 1.0:
            raise ValueError(f"participation {participation} outside (0, 1]")
        self.participation = float(participation)

    def eligible(self, round_idx: int) -> np.ndarray:
        if self.participation >= 1.0:
            return np.ones(self.population, bool)
        rng = np.random.default_rng([self.seed, round_idx, 1])
        return rng.random(self.population) < self.participation

    def config(self) -> Dict[str, Any]:
        return dict(super().config(), participation=self.participation)


@register_sampler("availability")
class AvailabilitySampler(CohortSampler):
    """Duty-cycle availability from a `ClientSystemProfile`: client c is on
    for a contiguous window of `w_c = clip(round(duty * period /
    speed_factor(c)), 1, period)` rounds out of every `period`, shifted by
    `c % period`, so slow devices are available longer.

    `trace=<path>` replaces the duty cycle with a recorded (N, T) 0/1
    matrix (`load_availability_trace`): client c follows row `c % N`,
    round r reads column `r % T`.  `config()` carries the path, and a
    resumed run re-reads the file."""

    def __init__(self, population: int, cohort: Optional[int] = None,
                 seed: int = 0, period: int = 24, duty: float = 0.5,
                 profile: Any = None, trace: Optional[str] = None):
        super().__init__(population, cohort, seed)
        if period < 1:
            raise ValueError(f"period {period} < 1")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty {duty} outside (0, 1]")
        if isinstance(profile, dict):   # checkpoint meta round trip
            profile = ac.ClientSystemProfile(
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in profile.items()})
        self.period = int(period)
        self.duty = float(duty)
        self.profile = profile if profile is not None \
            else ac.ClientSystemProfile()
        self.trace = None if trace is None else str(trace)
        if self.trace is not None:
            windows = load_availability_trace(self.trace)
            rows = np.arange(self.population, dtype=np.int64) \
                % windows.shape[0]
            self._windows = windows[rows]           # (population, T)
            return
        self._windows = None
        factors = np.asarray(self.profile.speed_factors or (1.0,), float)
        f = factors[np.arange(self.population) % factors.size]
        self._window = np.clip(
            np.rint(self.duty * self.period / f).astype(np.int64),
            1, self.period)
        self._phase = np.arange(self.population, dtype=np.int64) \
            % self.period

    def eligible(self, round_idx: int) -> np.ndarray:
        if self._windows is not None:
            return self._windows[:, round_idx % self._windows.shape[1]]
        return ((round_idx - self._phase) % self.period) < self._window

    def config(self) -> Dict[str, Any]:
        return dict(super().config(), period=self.period, duty=self.duty,
                    profile=dataclasses.asdict(self.profile),
                    trace=self.trace)


def load_availability_trace(path: str) -> np.ndarray:
    """An (N, T) bool availability matrix from `path`: npz (key "windows",
    else the first array), npy, or json (`{"windows": [...]}` or a bare
    list of rows)."""
    if path.endswith((".npz", ".npy")):
        loaded = np.load(path)
        if isinstance(loaded, np.lib.npyio.NpzFile):
            with loaded:
                key = "windows" if "windows" in loaded.files \
                    else loaded.files[0]
                arr = loaded[key]
        else:
            arr = loaded
    else:
        with open(path) as f:
            obj = json.load(f)
        arr = np.asarray(obj["windows"] if isinstance(obj, dict) else obj)
    arr = np.asarray(arr)
    if arr.ndim != 2 or not arr.size:
        raise ValueError(f"availability trace {path}: need a non-empty "
                         f"(N, T) matrix, got shape {arr.shape}")
    return arr.astype(bool)


SamplerLike = Union["CohortSampler", str, Dict[str, Any],
                    Type["CohortSampler"]]


def resolve_sampler(obj: SamplerLike, *, population: int,
                    **kwargs) -> CohortSampler:
    """Sampler instance / registered name / `config()` spec dict / class ->
    instance."""
    if isinstance(obj, CohortSampler):
        if kwargs:
            raise TypeError("pass kwargs with a name or spec, not an "
                            "instance")
        return obj
    if isinstance(obj, dict):
        spec = dict(obj)
        kind = spec.pop("kind")
        return resolve_sampler(kind, population=population,
                               **dict(spec, **kwargs))
    if isinstance(obj, str):
        try:
            cls = _SAMPLERS[obj]
        except KeyError:
            raise KeyError(f"no sampler registered as {obj!r}; known: "
                           f"{registered_samplers()}") from None
        return cls(population, **kwargs)
    if isinstance(obj, type) and issubclass(obj, CohortSampler):
        return obj(population, **kwargs)
    raise TypeError(f"cannot resolve {obj!r} to a CohortSampler")


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------

def _check_ids(ids, population: int) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    if ids.ndim != 1:
        raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
    if ids.size and not (0 <= ids.min() and ids.max() < population):
        raise ValueError(f"ids [{int(ids.min())}, {int(ids.max())}] outside "
                         f"the population of {population}")
    return ids


class PopulationStore:
    """One (row_len,) f32 row of persistent state per client, in chunks of
    `chunk` clients on the host that materialize on their first write; a
    chunk never written reads back as zeros.  `gather` / `scatter` move
    whole cohorts; nothing here touches a device."""

    def __init__(self, population: int, row_len: int, chunk: int = 4096):
        if population < 1 or row_len < 1 or chunk < 1:
            raise ValueError(f"population {population}, row_len {row_len} "
                             f"and chunk {chunk} must be >= 1")
        self.population = int(population)
        self.row_len = int(row_len)
        self.chunk = int(chunk)
        self._chunks: Dict[int, np.ndarray] = {}

    def gather(self, ids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """-> (len(ids), row_len) f32 copy of the rows for `ids`, written
        into `out` when given (a pinned staging slab)."""
        ids = _check_ids(ids, self.population)
        if out is None:
            out = np.zeros((ids.size, self.row_len), np.float32)
        else:
            out[...] = 0.0
        cidx = ids // self.chunk
        for c in np.unique(cidx):
            buf = self._chunks.get(int(c))
            if buf is not None:
                sel = cidx == c
                out[sel] = buf[ids[sel] - c * self.chunk]
        return out

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Write `rows` back to `ids`, materializing chunks as needed."""
        ids = _check_ids(ids, self.population)
        rows = np.asarray(rows, np.float32)
        if rows.shape != (ids.size, self.row_len):
            raise ValueError(f"rows {rows.shape} != "
                             f"{(ids.size, self.row_len)}")
        cidx = ids // self.chunk
        for c in np.unique(cidx):
            c = int(c)
            buf = self._chunks.get(c)
            if buf is None:
                rows_in_chunk = min(self.chunk,
                                    self.population - c * self.chunk)
                buf = np.zeros((rows_in_chunk, self.row_len), np.float32)
                self._chunks[c] = buf
            sel = cidx == c
            buf[ids[sel] - c * self.chunk] = rows[sel]

    sample_cohort = gather
    commit_cohort = scatter

    @property
    def n_chunks(self) -> int:
        """Chunks materialized so far."""
        return len(self._chunks)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._chunks.values())

    def to_arrays(self) -> Dict[str, Any]:
        """Npz-ready tree, one array per materialized chunk (aliased, not
        copied: save before the next `scatter`)."""
        return {"chunks": {str(c): buf for c, buf in
                           sorted(self._chunks.items())}}

    def load_arrays(self, arrays: Dict[str, Any]) -> None:
        """Restore from a `to_arrays` tree; no "chunks" means an empty
        store."""
        self._chunks = {}
        for key, buf in arrays.get("chunks", {}).items():
            buf = np.asarray(buf, np.float32)
            if buf.shape[1] != self.row_len:
                raise ValueError(f"chunk {key}: rows of {buf.shape[1]} != "
                                 f"{self.row_len}")
            self._chunks[int(key)] = buf.copy()


class DevicePopulationStore:
    """Dense (population, row_len) f32 tensor on `device` with the
    `PopulationStore` interface: the test backend the chunked host store is
    held to, viable only at test scale."""

    def __init__(self, population: int, row_len: int,
                 device: DeviceLike = "cpu"):
        self.population = int(population)
        self.row_len = int(row_len)
        self._arr = torch.zeros((population, row_len), dtype=torch.float32,
                                device=device)

    def gather(self, ids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        ids = torch.from_numpy(_check_ids(ids, self.population))
        rows = self._arr[ids.to(self._arr.device)].cpu().numpy()
        if out is None:
            return rows
        out[...] = rows
        return out

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = torch.from_numpy(_check_ids(ids, self.population))
        rows = torch.from_numpy(np.asarray(rows, np.float32))
        self._arr[ids.to(self._arr.device)] = rows.to(self._arr.device)

    sample_cohort = gather
    commit_cohort = scatter

    def to_arrays(self) -> Dict[str, Any]:
        return {"dense": self._arr.cpu().numpy()}

    def load_arrays(self, arrays: Dict[str, Any]) -> None:
        self._arr.copy_(torch.from_numpy(np.asarray(arrays["dense"],
                                                    np.float32)))


# ---------------------------------------------------------------------------
# double-buffered prefetch
# ---------------------------------------------------------------------------

class CohortPrefetcher:
    """Stages round r+1's cohort while round r computes.

    `prefetch(r, exclude=ids_r)` runs between the engine's queueing of
    round r and its blocking metrics pull: it samples round r+1's ids and,
    when they are disjoint from round r's uncommitted cohort, gathers the
    host rows and starts their copy to the device at once.  An overlapping
    cohort would read rows round r is about to rewrite, so only its ids are
    staged and `take(r+1)`, called after the commit, gathers then.

    On a CUDA device the rows are gathered into one of two pinned host
    slabs (alternating, so a slab is never rewritten while its copy is in
    flight: the slab's last copy event is waited on first) and copied with
    one non-blocking H2D copy on a side stream.  `take` makes the current
    stream wait on that copy's event and `record_stream`s the device rows
    onto it.  On the CPU the gathered rows are the round's rows.

    Counters: `take_wait_s`, the host seconds the round loop spent in
    `take` (the staging cost left on the critical path), and `h2d_puts`,
    the cohort copies issued (one per round)."""

    def __init__(self, store, sampler: CohortSampler,
                 device: DeviceLike = "cpu"):
        self.store = store
        self.sampler = sampler
        self.device = torch.device(device)
        self._staged: Optional[Tuple[int, np.ndarray, Any]] = None
        self._slabs: list = []
        self._slab_events: list = []
        self._next_slab = 0
        self._stream = None
        self.take_wait_s = 0.0
        self.h2d_puts = 0

    def _cuda_put(self, ids: np.ndarray):
        n = ids.size
        if not self._slabs or self._slabs[0].shape[0] != n:
            # pin_memory raises when pinning fails: never a pageable copy
            self._slabs = [torch.empty((n, self.store.row_len),
                                       dtype=torch.float32, pin_memory=True)
                           for _ in range(2)]
            self._slab_events = [None, None]
            self._stream = torch.cuda.Stream(self.device)
        i = self._next_slab
        self._next_slab ^= 1
        if self._slab_events[i] is not None:
            self._slab_events[i].synchronize()
        slab = self._slabs[i]
        self.store.gather(ids, out=slab.numpy())
        with torch.cuda.stream(self._stream):
            rows = torch.empty(slab.shape, dtype=torch.float32,
                               device=self.device)
            rows.copy_(slab, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._slab_events[i] = ev
        return rows, ev

    def _put(self, ids: np.ndarray):
        self.h2d_puts += 1
        if self.device.type == "cuda":
            return self._cuda_put(ids)
        return torch.from_numpy(self.store.gather(ids)).to(self.device), None

    def prefetch(self, round_idx: int, exclude: np.ndarray) -> None:
        ids = self.sampler.sample(round_idx)
        if np.intersect1d(ids, np.asarray(exclude, np.int64)).size:
            staged = None       # stale-read hazard: gather after the commit
        else:
            staged = self._put(ids)
        self._staged = (round_idx, ids, staged)

    def take(self, round_idx: int) -> Tuple[np.ndarray, torch.Tensor]:
        """-> (ids, device rows) for `round_idx`: the staged copy when it
        matches, else sample + gather + copy now."""
        t0 = time.perf_counter()
        staged, self._staged = self._staged, None
        if staged is not None and staged[0] == round_idx:
            _, ids, put = staged
        else:
            ids, put = self.sampler.sample(round_idx), None
        if put is None:
            put = self._put(ids)
        rows, ev = put
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            rows.record_stream(stream)
        self.take_wait_s += time.perf_counter() - t0
        return ids, rows


# ---------------------------------------------------------------------------
# the bundle a RoundTask carries
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Population:
    """The host store, the cohort sampler (whose `cohort` must equal
    `fed.n_clients`) and the prefetch switch.  `last_prefetcher` is the
    round loop's prefetcher, filled in by the engine for its counters."""

    store: Any
    sampler: CohortSampler
    prefetch: bool = True
    last_prefetcher: Optional[CohortPrefetcher] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def population(self) -> int:
        return self.store.population

    def config(self) -> Dict[str, Any]:
        """JSON facets for checkpoint metadata (the reference's keys)."""
        return {"population": self.store.population,
                "row_len": self.store.row_len,
                "chunk": getattr(self.store, "chunk", 0),
                "sampler": self.sampler.config(),
                "prefetch": self.prefetch}

    @classmethod
    def build(cls, population: int, row_len: int, *,
              cohort: Optional[int] = None, sampler: SamplerLike = "uniform",
              seed: int = 0, chunk: int = 4096, prefetch: bool = True,
              device: DeviceLike = "cpu", **sampler_kw) -> "Population":
        """`chunk=0` selects the dense `DevicePopulationStore` on
        `device`."""
        store = (PopulationStore(population, row_len, chunk) if chunk
                 else DevicePopulationStore(population, row_len, device))
        if isinstance(sampler, (CohortSampler, dict)):
            # an instance or a spec already carries cohort and seed
            samp = resolve_sampler(sampler, population=population,
                                   **sampler_kw)
        else:
            samp = resolve_sampler(sampler, population=population,
                                   cohort=cohort, seed=seed, **sampler_kw)
        return cls(store=store, sampler=samp, prefetch=prefetch)

    @classmethod
    def from_config(cls, cfg: Dict[str, Any],
                    device: DeviceLike = "cpu") -> "Population":
        """Rebuild from `config()`; the caller restores the store payload
        with `store.load_arrays`."""
        return cls.build(int(cfg["population"]), int(cfg["row_len"]),
                         sampler=dict(cfg["sampler"]), chunk=int(cfg["chunk"]),
                         prefetch=bool(cfg["prefetch"]), device=device)
