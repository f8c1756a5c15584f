"""The port's client populations (`federated/population.py`, the population
round loop and `AsyncEngine(sampler=...)`) on the CPU, against the
reference where the two packages compute the same numbers.

Bitwise against the reference: every sampler's eligibility and cohorts
from the same (config, seed, round), recorded trace files included, the
config round trips, and the store's gather / scatter / checkpoint arrays.

Bitwise inside the port (the reference's anchors of
`tests/test_population.py`): prefetch on == prefetch off, the chunked host
store == the dense device store, a population run is deterministic and
its momentum persists, and a checkpoint resumed mid-flight reproduces the
uninterrupted run; plus the 10^4-client smoke and the async engine's
refusal of a population bundle.

Against the reference's `AsyncEngine`, on weights converted from it
(`tests/_fed_parity.py`'s model and settings): a `fraction` sampler with
partial buffers under `flasc` (FedAdam at eps 1e-5) and
`hetlora_weighted` (the slot-specialised server phase, under the FedAvg
rule, see `ASYNC_CASES`): the same events with the same clients (each
event's per-client losses rtol 1e-5), `sim_time`, `staleness`, `applied`,
`dropped` and the ledger bytes equal, the clock's queue equal, and the
flat vector atol 1e-6 (the upload masks of both kinds agree).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _fed_parity as fp
from repro.core import comm as jcomm
from repro.core import fedround as jfr
from repro.core import strategies as jst
from repro.federated import async_clock as jac
from repro.federated import engine as jeng
from repro.federated import population as jpop
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro_torch.core import fedround as tfr
from repro_torch.core import strategies as tst
from repro_torch.data import make_synth_image
from repro_torch.federated import Experiment
from repro_torch.federated import async_clock as tac
from repro_torch.federated import engine as teng
from repro_torch.federated import population as tpop
from repro_torch.models import model as TM
from repro_torch.models.config import FederatedConfig


@pytest.fixture(scope="module")
def task():
    return make_synth_image(n_examples=128, n_clients=8, n_patches=4, dim=16,
                            seed=0, n_eval=128)


def _experiment(task, rounds=4, **spec_kw):
    defaults = dict(density_down=0.5, density_up=0.5)
    defaults.update(spec_kw)
    return (Experiment(task, device="cpu")
            .with_strategy("flasc", **defaults)
            .with_federation(n_clients=4, local_batch=4, local_steps=2)
            .with_model(d_model=16, num_layers=1, num_heads=2, d_ff=32)
            .with_lora(rank=4)
            .with_training(rounds=rounds, pretrain_steps=2, eval_every=2,
                           seed=0))


def _strip(history):
    """History without the port's wall-clock `phase_ms`."""
    return [{k: v for k, v in h.items() if k != "phase_ms"} for h in history]


class _Flat(teng.Callback):
    def __init__(self):
        self.flats = []

    def on_round_end(self, ev):
        self.flats.append(ev.state.flatP.numpy().copy())


# ---------------------------------------------------------------------------
# samplers and the store, bitwise against the reference
# ---------------------------------------------------------------------------

SAMPLERS = [
    ("uniform", {}),
    ("fraction", dict(participation=0.3)),
    ("fraction", dict(participation=1.0)),
    ("availability", dict(period=8, duty=0.5)),
    ("availability", dict(period=6, duty=0.25, profile="tiered")),
]


@pytest.mark.parametrize("kind,kw", SAMPLERS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(SAMPLERS)])
def test_sampler_cohorts_bitwise_the_reference(kind, kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("profile") == "tiered":
        jkw["profile"] = jac.ClientSystemProfile.tiered(8, 4)
        tkw["profile"] = tac.ClientSystemProfile.tiered(8, 4)
    for pop, cohort, seed in ((300, 20, 2), (1000, 8, 7)):
        j = jpop.resolve_sampler(kind, population=pop, cohort=cohort,
                                 seed=seed, **jkw)
        t = tpop.resolve_sampler(kind, population=pop, cohort=cohort,
                                 seed=seed, **tkw)
        assert t.config() == j.config()
        assert json.dumps(t.config()) == json.dumps(j.config())
        for r in range(10):
            np.testing.assert_array_equal(t.eligible(r), j.eligible(r))
            got = t.sample(r)
            assert got.dtype == np.int64 and np.all(np.diff(got) > 0)
            np.testing.assert_array_equal(got, j.sample(r))
        # each package rebuilds the other's spec into the same sampler
        t2 = tpop.resolve_sampler(j.config(), population=pop)
        j2 = jpop.resolve_sampler(t.config(), population=pop)
        for r in (0, 5, 11):
            np.testing.assert_array_equal(t2.sample(r), j2.sample(r))


def test_sampler_registry_and_refusals():
    assert tpop.registered_samplers() == jpop.registered_samplers()
    assert isinstance(tpop.resolve_sampler("uniform", population=50,
                                           cohort=8), tpop.UniformSampler)
    with pytest.raises(KeyError, match="no sampler registered"):
        tpop.resolve_sampler("nope", population=50)
    with pytest.raises(TypeError):
        tpop.resolve_sampler(3.14, population=50)
    tiny = tpop.resolve_sampler("fraction", population=20, cohort=19,
                                seed=0, participation=0.05)
    with pytest.raises(RuntimeError, match="eligible"):
        tiny.sample(0)
    # heterogeneous profile: slower clients get wider windows
    h = tpop.resolve_sampler(
        "availability", population=8, cohort=2, seed=0, period=8, duty=0.25,
        profile=tac.ClientSystemProfile(speed_factors=(0.5, 2.0)))
    assert h._window[0] == 4 and h._window[1] == 1


def test_availability_trace_files_bitwise_the_reference(tmp_path):
    windows = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]], np.int64)
    paths = {"npz": tmp_path / "trace.npz", "npy": tmp_path / "trace.npy",
             "json": tmp_path / "trace.json", "bare": tmp_path / "bare.json",
             "first": tmp_path / "first.npz"}
    np.savez(paths["npz"], windows=windows)
    np.save(paths["npy"], windows.astype(bool))
    paths["json"].write_text(json.dumps({"windows": windows.tolist()}))
    paths["bare"].write_text(json.dumps(windows.tolist()))
    np.savez(paths["first"], w=windows)
    for name, p in paths.items():
        np.testing.assert_array_equal(tpop.load_availability_trace(str(p)),
                                      jpop.load_availability_trace(str(p)))
        t = tpop.resolve_sampler("availability", population=12, cohort=3,
                                 seed=4, trace=str(p))
        j = jpop.resolve_sampler("availability", population=12, cohort=3,
                                 seed=4, trace=str(p))
        assert t.config() == j.config() and t.trace == str(p)
        for r in range(9):
            np.testing.assert_array_equal(t.eligible(r), j.eligible(r),
                                          err_msg=f"{name} round {r}")
            np.testing.assert_array_equal(t.sample(r), j.sample(r))
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 0, 1]")
    with pytest.raises(ValueError, match="matrix"):
        tpop.load_availability_trace(str(bad))


def test_store_roundtrips_bitwise_the_reference():
    rng = np.random.default_rng(0)
    t = tpop.PopulationStore(population=1000, row_len=7, chunk=64)
    j = jpop.PopulationStore(population=1000, row_len=7, chunk=64)
    ids = np.asarray([3, 63, 64, 512, 999])
    np.testing.assert_array_equal(t.gather(ids), np.zeros((5, 7), np.float32))
    assert t.n_chunks == 0 and t.nbytes == 0
    for r in range(4):
        ids = np.unique(rng.integers(0, 1000, size=12))
        rows = rng.normal(size=(ids.size, 7)).astype(np.float32)
        t.scatter(ids, rows)
        j.scatter(ids, rows)
        probe = np.unique(rng.integers(0, 1000, size=30))
        np.testing.assert_array_equal(t.gather(probe), j.gather(probe))
        # gather into a caller's buffer (the prefetcher's pinned slab)
        out = np.full((probe.size, 7), np.nan, np.float32)
        np.testing.assert_array_equal(t.gather(probe, out=out),
                                      j.gather(probe))
    assert t.n_chunks == j.n_chunks and t.nbytes == j.nbytes
    ta, ja = t.to_arrays(), j.to_arrays()
    assert sorted(ta["chunks"]) == sorted(ja["chunks"])
    clone = tpop.PopulationStore(population=1000, row_len=7, chunk=64)
    clone.load_arrays(ja)               # the reference's payload
    np.testing.assert_array_equal(clone.gather(np.arange(1000)),
                                  j.gather(np.arange(1000)))
    with pytest.raises(ValueError):
        t.gather(np.asarray([1000]))
    with pytest.raises(ValueError):
        t.scatter(np.asarray([0]), np.zeros((1, 3), np.float32))


def test_device_store_matches_host_store():
    rng = np.random.default_rng(0)
    host = tpop.PopulationStore(population=300, row_len=5, chunk=32)
    dev = tpop.DevicePopulationStore(population=300, row_len=5)
    for _ in range(5):
        ids = np.unique(rng.integers(0, 300, size=16))
        rows = rng.normal(size=(ids.size, 5)).astype(np.float32)
        host.scatter(ids, rows)
        dev.scatter(ids, rows)
        probe = np.unique(rng.integers(0, 300, size=24))
        np.testing.assert_array_equal(host.gather(probe), dev.gather(probe))
    clone = tpop.DevicePopulationStore(population=300, row_len=5)
    clone.load_arrays(dev.to_arrays())
    np.testing.assert_array_equal(clone.gather(np.arange(300)),
                                  dev.gather(np.arange(300)))


def test_prefetcher_defers_an_overlapping_gather():
    store = tpop.PopulationStore(population=10, row_len=3, chunk=4)
    samp = tpop.resolve_sampler("uniform", population=10, cohort=10)
    pre = tpop.CohortPrefetcher(store, samp, "cpu")
    ids, rows = pre.take(0)
    assert pre.h2d_puts == 1
    pre.prefetch(1, exclude=ids)            # every id overlaps: no copy yet
    assert pre.h2d_puts == 1
    store.scatter(ids, np.ones((10, 3), np.float32) + rows.numpy())
    ids1, rows1 = pre.take(1)               # gathered after the commit
    assert pre.h2d_puts == 2
    np.testing.assert_array_equal(rows1.numpy(), np.ones((10, 3)))


# ---------------------------------------------------------------------------
# the engine anchors, bitwise inside the port
# ---------------------------------------------------------------------------

def test_prefetch_on_equals_prefetch_off_bit_for_bit(task):
    fon, foff = _Flat(), _Flat()
    exp_on = _experiment(task).with_population(64).with_callbacks(fon)
    on = exp_on.run()
    off = (_experiment(task).with_population(64, prefetch=False)
           .with_callbacks(foff).run())
    assert _strip(on.history) == _strip(off.history)
    assert on.final_acc == off.final_acc
    for a, b in zip(fon.flats, foff.flats):
        np.testing.assert_array_equal(a, b)
    pre = exp_on._population_bundle.last_prefetcher
    assert pre.h2d_puts == 4 and pre.take_wait_s >= 0.0


def test_host_store_equals_device_resident_store(task):
    host = _experiment(task).with_population(64, chunk=16).run()
    dev = _experiment(task).with_population(64, chunk=0).run()
    assert _strip(host.history) == _strip(dev.history)
    assert host.final_acc == dev.final_acc


def test_population_run_is_deterministic_and_momentum_persists(task):
    kw = dict(sampler="availability", period=4, duty=0.75)
    a = _experiment(task).with_population(64, **kw).run()
    exp = _experiment(task).with_population(64, **kw)
    b = exp.run()
    assert _strip(a.history) == _strip(b.history)
    assert all(len(h["cohort"]) == 4 for h in a.history)
    assert len({tuple(h["cohort"]) for h in a.history}) > 1
    # the cohorts are the reference sampler's
    j = jpop.resolve_sampler("availability", population=64, cohort=4,
                             seed=0, period=4, duty=0.75)
    assert [h["cohort"] for h in a.history] == \
        [j.sample(r).tolist() for r in range(4)]
    # every client that trained keeps a nonzero momentum row, the rest none
    store = exp._population_bundle.store
    seen = sorted({c for h in a.history for c in h["cohort"]})
    rows = store.gather(np.arange(64))
    assert np.abs(rows[seen]).sum(1).min() > 0
    assert not np.delete(rows, seen, axis=0).any()
    # a cohort that is the whole population: round 0 starts from zero rows
    # (the stateless round), round 1 from round 0's final momenta
    same = _experiment(task, rounds=2).with_population(4).run()
    plain = _experiment(task, rounds=2).run()
    assert same.history[0]["loss"] == plain.history[0]["loss"]
    assert same.history[1]["loss"] != plain.history[1]["loss"]


def test_population_round_without_momentum_is_the_round(task):
    """A population round on all-zero rows equals the stateless round
    bitwise (the same uploads, losses and flat vector)."""
    pop = _experiment(task, rounds=1).with_population(4).run()
    plain = _experiment(task, rounds=1).run()
    keys = ("loss", "down_bytes", "up_bytes", "coded_bytes", "acc")
    assert [h[k] for h in pop.history for k in keys] == \
        [h[k] for h in plain.history for k in keys]


class _StopAt(teng.Callback):
    def __init__(self, r):
        self.r = r

    def on_round_end(self, ev):
        if ev.round == self.r:
            raise teng.StopRun()


@pytest.mark.parametrize("sampler", ["fraction", "trace"])
def test_population_checkpoint_resumes_mid_flight_bit_exactly(
        task, tmp_path, sampler):
    if sampler == "trace":
        rng = np.random.default_rng(7)
        windows = rng.random((16, 6)) < 0.6
        windows[::4] = True
        tr = tmp_path / "tr.npz"
        np.savez(tr, windows=windows)
        kw = dict(sampler="availability", trace=str(tr))
    else:
        kw = dict(sampler="fraction", participation=0.6)
    ffull = _Flat()
    full_exp = (_experiment(task, rounds=6).with_population(64, **kw)
                .with_callbacks(ffull))
    full = full_exp.run()
    d = str(tmp_path / "ckpt")
    part = (_experiment(task, rounds=6).with_population(64, **kw)
            .with_checkpoint(d, every=3).with_callbacks(_StopAt(3)).run())
    assert len(part.history) == 4       # stopped after round 3
    fres = _Flat()
    exp = Experiment.resume(d, device="cpu").with_callbacks(fres)
    resumed = exp.run()
    assert _strip(resumed.history) == _strip(full.history)
    assert resumed.final_acc == full.final_acc
    for a, b in zip(fres.flats, ffull.flats[3:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        exp._population_bundle.store.gather(np.arange(64)),
        full_exp._population_bundle.store.gather(np.arange(64)))


def test_population_smoke_1e4_clients(task):
    exp = _experiment(task, rounds=2).with_population(10_000, chunk=256)
    res = exp.run()
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    store = exp._population_bundle.store
    assert store.population == 10_000
    assert 0 < store.n_chunks <= 8
    assert store.nbytes == store.n_chunks * 256 * store.row_len * 4


def test_async_engine_rejects_population_bundle(task):
    exp = _experiment(task).with_population(64).with_engine("async")
    with pytest.raises(NotImplementedError, match="population store"):
        exp.run()


# ---------------------------------------------------------------------------
# AsyncEngine(sampler=...) against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return fp.build_model()


def _async_pair(model, spec_kw, engine_kw, rounds, n=4, fed_kw=None):
    """(reference state, port state, each one's per-event client losses)
    of an async run from the same converted state on the same batches."""
    fed = dict(fp.FED, n_clients=n, **(fed_kw or {}))
    jspec, tspec = jst.StrategySpec(**spec_kw), tst.StrategySpec(**spec_kw)
    jmeta = jfr.FlatMeta.of({"lora": model["lora"]})
    jtask = jeng.RoundTask(
        lambda bb, tree, mb: JM.loss_fn(bb, fp.CFG, mb, lora=tree["lora"],
                                        lora_scale=fp.LCFG.scale),
        jmeta, JFederatedConfig(**fed), jst.resolve(jspec), seed=0,
        params=model["params"])
    jstate = jeng.RunState.fresh(jtask, jmeta.flatten({"lora": model["lora"]}),
                                 rounds=rounds)
    flat0 = np.asarray(jstate.flatP)
    tmeta = tfr.FlatMeta.of({"lora": model["tlora"]})
    ttask = teng.RoundTask(
        lambda bb, tree, mb: TM.loss_fn(bb, model["tcfg"], mb,
                                        lora=tree["lora"],
                                        lora_scale=fp.LCFG.scale),
        tmeta, FederatedConfig(**fed), tst.resolve(tspec), seed=0,
        params=model["tparams"])
    tstate = teng.RunState.fresh(ttask, fp.t_(flat0), rounds=rounds)
    batches = [{"tokens": fp.tokens(200 + j, n, 1, 4, fp.SEQ)}
               for j in range(4 * rounds + 4)]

    class Losses:
        """Each event's per-client losses (they pin the event's clients)."""

        def __init__(self):
            self.rows = []

        def wants_state(self, round_idx, rounds):
            return False

        def on_round_end(self, ev):
            self.rows.append(np.asarray(ev.metrics["loss_clients"],
                                        np.float32))

        def on_eval(self, ev):
            pass

        def on_checkpoint(self, ev):
            pass

    jled = jeng.LedgerCallback(jcomm.CommLedger(total_params=jmeta.p_len))
    tled = teng.LedgerCallback(Experiment(device="cpu", strategy=tspec)
                               .build_ledger(tmeta.p_len))
    jeng_ = jeng.AsyncEngine(
        profile=jac.ClientSystemProfile.tiered(n, 2), **engine_kw)
    teng_ = teng.AsyncEngine(
        profile=tac.ClientSystemProfile.tiered(n, 2), **engine_kw)
    assert teng_.config() == jeng_.config()
    jl, tl = Losses(), Losses()
    jstate = jeng_.run_rounds(
        jstate, lambda j: jax.tree.map(jnp.asarray, batches[j]), [jled, jl])
    tstate = teng_.run_rounds(
        tstate, lambda j: {k: fp.t_(v) for k, v in batches[j].items()},
        [tled, tl])
    return jstate, tstate, jl.rows, tl.rows


# (strategy, federation overrides).  hetlora_weighted runs under the
# FedAvg rule at server_lr 1: FedAdam's first steps are invariant to the
# scale of the pseudo-gradient, so a wrong coverage divisor would not
# show, while here it moves the flat vector linearly
ASYNC_CASES = {
    "flasc": (dict(kind="flasc", selector="fused"), {}),
    "hetlora_weighted": (dict(kind="hetlora", hetlora_ranks=(1, 2, 3, 4),
                              hetlora_weighted=True),
                         dict(server_opt="sgd", server_lr=1.0)),
}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_sampler_matches_reference(model, case):
    engine_kw = dict(concurrency=4, buffer_size=2,
                     sampler={"kind": "fraction", "participation": 0.5,
                              "seed": 0})
    spec_kw, fed_kw = ASYNC_CASES[case]
    jstate, tstate, jl, tl = _async_pair(model, spec_kw, engine_kw, 4,
                                         fed_kw=fed_kw)
    jh, th = jstate.history, tstate.history
    assert len(th) == len(jh) == 4
    for r, (a, b) in enumerate(zip(th, jh)):
        np.testing.assert_allclose(tl[r], jl[r], rtol=fp.RTOL)
        for key in ("sim_time", "staleness", "applied", "dropped",
                    "down_bytes", "up_bytes", "coded_bytes"):
            assert a[key] == b[key], (case, r, key)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=fp.RTOL)
    # partial buffers of 2: the weighted kind ran slot-specialised phases
    assert all(h["applied"] == 2 for h in th)
    np.testing.assert_allclose(tstate.flatP.numpy(),
                               np.asarray(jstate.flatP), atol=fp.ATOL)
    # the clock is the reference's: same queue, counts and time
    ta, ja = tstate.aux, jax.tree.map(np.asarray, jstate.aux)
    for key in ("now", "seq", "job_counts", "last_version", "idle"):
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


def test_async_sampler_config_round_trips_and_starvation(model):
    spec = {"kind": "fraction", "participation": 0.5, "seed": 0}
    eng = teng.AsyncEngine(sampler=spec)
    assert eng.config()["sampler"] == spec
    assert teng.AsyncEngine(**eng.config()).config() == eng.config()
    inst = tpop.resolve_sampler("availability", population=4, period=4,
                                duty=0.25)
    eng2 = teng.AsyncEngine(sampler=inst)
    assert eng2.config()["sampler"] == inst.config() == jeng.AsyncEngine(
        sampler=jpop.resolve_sampler("availability", population=4, period=4,
                                     duty=0.25)).config()["sampler"]
    # a trace under which client 0 alone is ever on: every other version
    # starves and ignores the gate, so the loop still finishes its events
    state = fp_state(model, 4)
    starving = teng.AsyncEngine(concurrency=4, buffer_size=1,
                                sampler=StarveSampler(4))
    state = starving.run_rounds(
        state, lambda j: {"tokens": fp.t_(fp.tokens(300 + j, 4, 1, 4,
                                                    fp.SEQ))})
    assert len(state.history) == 4
    assert all(np.isfinite(h["loss"]) for h in state.history)


class StarveSampler(tpop.CohortSampler):
    kind = "starve"

    def eligible(self, round_idx):
        out = np.zeros(self.population, bool)
        out[0] = round_idx % 2 == 0
        return out


def fp_state(model, n):
    tmeta = tfr.FlatMeta.of({"lora": model["tlora"]})
    task = teng.RoundTask(
        lambda bb, tree, mb: TM.loss_fn(bb, model["tcfg"], mb,
                                        lora=tree["lora"],
                                        lora_scale=fp.LCFG.scale),
        tmeta, FederatedConfig(**dict(fp.FED, n_clients=n)),
        tst.resolve(tst.StrategySpec(kind="flasc", selector="fused")),
        seed=0, params=model["tparams"])
    return teng.RunState.fresh(task, tmeta.flatten({"lora": model["tlora"]}),
                               rounds=4)


def test_population_bench_runs_on_the_cpu(tmp_path, monkeypatch):
    """The port of benchmarks/population_bench.py: its quick sweep on the
    host, one H2D copy a round in every cell, written under chiprun_out/
    of the given root (never BENCH_population.json)."""
    from benchmarks_torch import population_bench as pb
    monkeypatch.setattr(pb, "ROOT", str(tmp_path))
    out = pb.main(["--quick", "--out", "pb.json"], device="cpu")
    assert [(r["population"], r["prefetch"]) for r in out["rows"]] == [
        (1_000, True), (1_000, False), (10_000, True), (10_000, False)]
    assert all(r["h2d_puts"] == r["rounds"] == 6 for r in out["rows"])
    assert all(r["chunk"] == pb.CHUNK for r in out["rows"])
    with open(tmp_path / "chiprun_out" / "pb.json") as f:
        assert json.load(f)["summary"] == out["summary"]
    assert set(out["summary"]) >= {"flatness_on", "stage_wait_ratio_at_max"}
