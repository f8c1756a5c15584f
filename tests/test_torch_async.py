"""The port's sparse aggregation round and its async engine, on the CPU, at
a small f32 size (a 2-layer, d 64 model; p_len 3,584).

Inside the port, bitwise:
  - the `async` engine at its defaults (concurrency = buffer = n_clients,
    uniform profile) reproduces the `sim` engine: history, ledger and
    final `flatP`, for `lora` and `flasc`, dense and with
    `sparse_aggregate=True`, with `selector="fused", quant_bits_up=4`,
    over an odd cohort;
  - a sparse round whose messages overflow the packed capacity is the
    dense round, and one whose messages fit is the dense round to
    atol 1e-6 (the scatter-add sums in another order than the mean);
  - an async run continued from its clock snapshot (`RunState.aux`)
    reproduces an uninterrupted run.

Against the reference, on weights converted from it, with the tolerances
of `test_torch_round.py` (losses rtol 1e-5, `flatP` atol 1e-6, upload-mask
overlap >= 0.999, equal ledger bytes where the masks agree):
  - two sparse rounds through both `SimEngine`s, where the port's
    `aggregate_sparse` also equals the reference's bit for bit on the
    reference's own packed rows;
  - an async run with staleness: concurrency 4, buffer 2, a tiered
    profile, max_staleness 1, 4 events, no quantization (the two
    packages draw different random numbers).  `applied`, `dropped`,
    `staleness` and `sim_time` are equal wherever the upload sizes are.
And the virtual clock's array form, the engine's `config()` (with a
`sampler=`, equal to the reference's) and the refusals (`dp_clip > 0`,
the sharded engine).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import strategies as jst
from repro.federated import async_clock as jac
from repro.federated import engine as jeng
from repro.core import fedround as jfr
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adam_init as j_adam_init
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import fedround as tfr
from repro_torch.core import strategies as tst
from repro_torch.federated import Experiment
from repro_torch.federated import async_clock as tac
from repro_torch.federated import engine as teng
from repro_torch.models import model as TM
from repro_torch.models.config import FederatedConfig, ModelConfig

CFG = JModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
LCFG = JLoRAConfig(rank=4, alpha=8.0)
SEQ = 16
P_LEN = 3584
ASYNC_KEYS = {"sim_time", "staleness", "applied", "dropped", "launch_bytes",
              "phase_ms"}
LEDGER_ATTRS = ("down_values", "up_values", "down_bytes", "up_bytes",
                "total_bytes", "down_coded_bytes", "up_coded_bytes",
                "total_coded_bytes", "rounds")


def _t(a):
    return torch.from_numpy(np.array(a))


def _fed(n_clients):
    return dict(n_clients=n_clients, local_batch=4, local_steps=1,
                client_lr=5e-2, server_lr=2e-3)


@pytest.fixture(scope="module")
def model():
    """Reference backbone and a LoRA tree with nonzero `b` (numpy draws),
    plus their port conversions."""
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(JM.model_spec(CFG), k))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    lora = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, dtype=np.float32)
                   * np.float32(0.1)), jlora.lora_spec(CFG, LCFG),
        is_leaf=lambda x: isinstance(x, JL.P))
    return {"params": params, "lora": lora,
            "tparams": tree_from_numpy(params, device="cpu"),
            "tlora": tree_from_numpy(lora, device="cpu"),
            "tcfg": ModelConfig(**dataclasses.asdict(CFG))}


def _tokens(seed, n_clients):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (n_clients, 1, 4, SEQ)).astype(np.int32)


def _port_state(model, strategy, n_clients, rounds):
    """A port RunState from the converted LoRA tree (Adam from zeros)."""
    meta = tfr.FlatMeta.of({"lora": model["tlora"]})
    task = teng.RoundTask(
        lambda bb, tree, mb: TM.loss_fn(bb, model["tcfg"], mb,
                                        lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        meta, FederatedConfig(**_fed(n_clients)), tst.resolve(strategy),
        seed=0, params=model["tparams"])
    return teng.RunState.fresh(task, meta.flatten({"lora": model["tlora"]}),
                               rounds=rounds)


class _UpNnz(teng.Callback):
    """Each round's (or event's) per-message upload sizes."""

    def __init__(self):
        self.rows = []

    def on_round_end(self, ev):
        self.rows.append(list(ev.metrics["up_nnz_clients"]))


def _port_run(model, engine, spec, n_clients, rounds, probe=None):
    """(state, history, ledger) of a port run on the converted weights."""
    state = _port_state(model, spec, n_clients, rounds)
    led = teng.LedgerCallback(Experiment(device="cpu").with_strategy(
        spec).build_ledger(P_LEN))
    data = lambda j: {"tokens": _t(_tokens(100 + j, n_clients))}  # noqa: E731
    state = engine.run_rounds(state, data, [led] + ([probe] if probe else []))
    return state, state.history, led.ledger


def _strip(record):
    return {k: v for k, v in record.items() if k not in ASYNC_KEYS}


CASES = {
    "lora-dense": dict(kind="lora"),
    "flasc-dense": dict(kind="flasc"),
    "lora-sparse": dict(kind="lora", sparse_aggregate=True),
    "flasc-sparse": dict(kind="flasc", sparse_aggregate=True),
    "flasc-sparse-fused4": dict(kind="flasc", sparse_aggregate=True,
                                selector="fused", quant_bits_up=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_defaults_reduce_to_sim_bitwise(model, case):
    spec = tst.StrategySpec(**CASES[case])
    s_state, s_hist, s_led = _port_run(model, teng.SimEngine(), spec, 3, 2)
    a_state, a_hist, a_led = _port_run(model, teng.AsyncEngine(), spec, 3, 2)
    assert len(a_hist) == len(s_hist) == 2
    for a, s in zip(a_hist, s_hist):
        assert _strip(a) == _strip(s)
        assert a["staleness"] == 0.0 and a["applied"] == 3
        assert a["dropped"] == 0 and len(a["launch_bytes"]) == 1
    for attr in LEDGER_ATTRS:
        assert getattr(a_led, attr) == getattr(s_led, attr), attr
    assert torch.equal(a_state.flatP.view(torch.int32),
                       s_state.flatP.view(torch.int32))
    for k in ("m", "v"):
        assert torch.equal(a_state.server["opt"][k], s_state.server["opt"][k])
    if spec.sparse_aggregate and spec.kind == "flasc":
        # packed pulls: (int32 index + f32 value) per slot, far below the
        # dense (3, p_len) f32 rows
        cap = tst.sparse_aggregate_capacity(tst.resolve(spec), P_LEN)
        assert a_hist[0]["launch_bytes"][0] < 3 * P_LEN * 4
        assert a_hist[0]["launch_bytes"][0] >= 3 * cap * 8


def test_sparse_round_equals_dense_round_inside_the_port(model):
    """flasc fits the capacity: equal to atol 1e-6.  lora uploads every
    entry, so every message overflows: the round is the dense round."""
    for kind, exact in (("flasc", False), ("lora", True)):
        dense = tst.StrategySpec(kind=kind)
        sparse = tst.StrategySpec(kind=kind, sparse_aggregate=True)
        probe = _UpNnz()
        d_state, d_hist, _ = _port_run(model, teng.SimEngine(), dense, 3, 2)
        s_state, s_hist, _ = _port_run(model, teng.SimEngine(), sparse, 3, 2,
                                       probe)
        cap = tst.sparse_aggregate_capacity(tst.resolve(sparse), P_LEN)
        nnz = np.asarray(probe.rows)
        assert (nnz > cap).all() if exact else (nnz <= cap).all()
        assert d_hist[0]["loss"] == s_hist[0]["loss"]
        if exact:
            assert torch.equal(d_state.flatP, s_state.flatP)
            assert [h["loss"] for h in d_hist] == [h["loss"] for h in s_hist]
        else:
            assert not torch.equal(d_state.flatP, s_state.flatP)
            np.testing.assert_allclose(s_state.flatP.numpy(),
                                       d_state.flatP.numpy(), atol=1e-6)


class _JaxCapture(jst.Flasc):
    """The reference's flasc, keeping each round's packed rows and its
    sparse pseudo-gradient."""
    kept: list

    def aggregate_sparse(self, idx, val, ctx):
        out = super().aggregate_sparse(idx, val, ctx)
        jax.debug.callback(lambda i, v, o: self.kept.append(
            (np.asarray(i), np.asarray(v), np.asarray(o))), idx, val, out)
        return out


class _TorchCapture(tst.Flasc):
    kept: list

    def aggregate_sparse(self, idx, val, ctx):
        self.kept.append(idx.numpy().copy())
        return super().aggregate_sparse(idx, val, ctx)


def _masks(idx):
    """(k, cap) packed indices -> (k, P_LEN) bool upload masks."""
    m = np.zeros((idx.shape[0], P_LEN + 1), bool)
    np.put_along_axis(m, idx.astype(np.int64), True, axis=1)
    return m[:, :P_LEN]


def _reference_state(model, jstrat, n_clients, rounds):
    jmeta = jfr.FlatMeta.of({"lora": model["lora"]})
    jtask = jeng.RoundTask(
        lambda bb, tree, mb: JM.loss_fn(bb, CFG, mb, lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        jmeta, JFederatedConfig(**_fed(n_clients)), jstrat, seed=0,
        params=model["params"])
    return jeng.RunState.fresh(
        jtask, jmeta.flatten({"lora": model["lora"]}), rounds=rounds)


def _reference_run(model, engine, jstrat, n_clients, rounds):
    state = _reference_state(model, jstrat, n_clients, rounds)
    led = jeng.LedgerCallback(jcomm.CommLedger(total_params=P_LEN))
    data = lambda j: {"tokens": jnp.asarray(_tokens(100 + j,  # noqa: E731
                                                    n_clients))}
    state = engine.run_rounds(state, data, [led])
    return state, state.history


def _port_from_reference(model, tstrat, jstate, n_clients, rounds):
    """A port RunState at a reference state's flatP and Adam state."""
    state = _port_state(model, tstrat, n_clients, rounds)
    flat0 = np.asarray(jstate.flatP)
    state.flatP = _t(flat0)
    state.server = {"opt": {k: _t(v) for k, v in j_adam_init(
        jnp.asarray(flat0)).items()},
        "round": torch.zeros((), dtype=torch.int32)}
    return state


def _compare_uploads(jstrat, tstrat, j_hist, t_hist):
    """Per event: losses rtol 1e-5; the packed upload masks' overlap
    (printed, >= 0.999); equal ledger bytes where it is 1.  Returns the
    events whose masks agree exactly."""
    exact = []
    for r, (jh, th) in enumerate(zip(j_hist, t_hist)):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
        jm, tm_ = _masks(jstrat.kept[r][0]), _masks(tstrat.kept[r])
        overlap = float((jm == tm_).mean())
        print(f"event {r}: upload-mask overlap {overlap:.6f}")
        assert overlap >= 0.999
        if overlap == 1.0:
            exact.append(r)
            for key in ("down_bytes", "up_bytes", "coded_bytes"):
                assert th[key] == jh[key], (r, key)
    return exact


def test_two_sparse_rounds_match_reference_sim_engine(model):
    kw = dict(kind="flasc", selector="fused", sparse_aggregate=True)
    jstrat = _JaxCapture(jst.StrategySpec(**kw))
    tstrat = _TorchCapture(tst.StrategySpec(**kw))
    jstrat.kept, tstrat.kept = [], []
    jstate, j_hist = _reference_run(model, jeng.SimEngine(), jstrat, 4, 2)
    init = _reference_state(model, jstrat, 4, 2)
    tstate = _port_from_reference(model, tstrat, init, 4, 2)
    led = teng.LedgerCallback(Experiment(device="cpu").build_ledger(P_LEN))
    tstate = teng.SimEngine().run_rounds(
        tstate, lambda j: {"tokens": _t(_tokens(100 + j, 4))}, [led])
    _compare_uploads(jstrat, tstrat, j_hist, tstate.history)
    np.testing.assert_allclose(tstate.flatP.numpy(), np.asarray(jstate.flatP),
                               atol=1e-6)
    # the port's aggregate_sparse on the reference's own packed rows
    ctx = tst.PlanContext(P_LEN, 4)
    for idx, val, out in jstrat.kept:
        got = tstrat.aggregate_sparse(_t(idx), _t(val), ctx)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      out.view(np.int32))


def test_async_with_staleness_matches_reference(model):
    kw = dict(kind="flasc", selector="fused", sparse_aggregate=True)
    ekw = dict(concurrency=4, buffer_size=2, max_staleness=1)
    jstrat = _JaxCapture(jst.StrategySpec(**kw))
    tstrat = _TorchCapture(tst.StrategySpec(**kw))
    jstrat.kept, tstrat.kept = [], []
    jstate, j_hist = _reference_run(
        model, jeng.AsyncEngine(profile=jac.ClientSystemProfile.tiered(4, 2),
                                **ekw), jstrat, 4, 4)
    init = _reference_state(model, jstrat, 4, 4)
    tstate = _port_from_reference(model, tstrat, init, 4, 4)
    led = teng.LedgerCallback(Experiment(device="cpu").build_ledger(P_LEN))
    tstate = teng.AsyncEngine(
        profile=tac.ClientSystemProfile.tiered(4, 2), **ekw).run_rounds(
        tstate, lambda j: {"tokens": _t(_tokens(100 + j, 4))}, [led])
    t_hist = tstate.history
    assert len(t_hist) == len(j_hist) == 4
    exact = _compare_uploads(jstrat, tstrat, j_hist, t_hist)
    # the event loop follows the upload sizes: equal while they are
    for r in range(4):
        if r not in exact:
            break
        for key in ("applied", "dropped", "staleness", "sim_time"):
            assert t_hist[r][key] == j_hist[r][key], (r, key)
    assert any(h["staleness"] > 0 for h in t_hist)
    np.testing.assert_allclose(tstate.flatP.numpy(), np.asarray(jstate.flatP),
                               atol=1e-6)


def test_async_run_continues_from_its_clock(model):
    """Two events, then two more from `RunState.aux` (jobs in flight and
    buffered), equal an uninterrupted four-event run, bit for bit."""
    spec = tst.StrategySpec(kind="flasc", sparse_aggregate=True,
                            selector="fused", quant_bits_up=4)

    def engine():
        return teng.AsyncEngine(concurrency=3, buffer_size=2,
                                profile=tac.ClientSystemProfile.tiered(3, 2))

    whole, w_hist, _ = _port_run(model, engine(), spec, 3, 4)
    part = _port_state(model, spec, 3, 2)
    data = lambda j: {"tokens": _t(_tokens(100 + j, 3))}  # noqa: E731
    led = teng.LedgerCallback(Experiment(device="cpu").with_strategy(
        spec).build_ledger(P_LEN))
    part = engine().run_rounds(part, data, [led])
    assert part.aux is not None and part.round == 2
    part.rounds = 4
    part = engine().run_rounds(part, data, [led])
    keep = ("sim_time", "staleness", "applied", "dropped")
    assert [_strip(h) | {k: h[k] for k in keep} for h in part.history] == \
        [_strip(h) | {k: h[k] for k in keep} for h in w_hist]
    assert torch.equal(part.flatP, whole.flatP)


def _job(mod, seq, packed):
    rng = np.random.default_rng(seq)
    delta = ((rng.integers(0, 50, 8).astype(np.int32),
              rng.standard_normal(8, dtype=np.float32)) if packed
             else rng.standard_normal(50, dtype=np.float32))
    return mod.Job(slot=seq % 3, version=seq // 3, seq=seq,
                   t_start=0.25 * seq, t_finish=1.0 + 0.5 * seq, delta=delta,
                   loss=np.float32(0.1 * seq), down_nnz=12.0 + seq,
                   up_nnz=7.0 + seq)


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_virtual_clock_arrays_match_reference_and_round_trip():
    clocks = []
    for mod in (tac, jac):
        clock = mod.VirtualClock(3, 50)
        for seq in range(6):
            clock.submit(_job(mod, seq, packed=seq % 2 == 0))
        clock.next_seq()
        clock.version_repeat(1, 0)
        clock.pull_completions()
        clock.buffer.append(clock.pending.pop(0))
        clock.drop(_job(mod, 9, packed=True))
        clocks.append(clock)
    ours = clocks[0].to_arrays()
    _same_tree(ours, clocks[1].to_arrays())
    back = tac.VirtualClock.from_arrays(ours, 3, 50)
    _same_tree(back.to_arrays(), ours)
    packed = back.buffer[0].delta
    assert isinstance(packed, tuple)
    dense = tac.dense_delta(packed, 50)
    np.testing.assert_array_equal(dense, jac.dense_delta(packed, 50))
    prof = tac.ClientSystemProfile.lognormal(4, seed=3)
    jprof = jac.ClientSystemProfile.lognormal(4, seed=3)
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    for s in range(4):
        assert tac.staleness_weight(s, 0.5) == jac.staleness_weight(s, 0.5)
    with pytest.raises(ValueError):
        tac.ClientSystemProfile(speed_factors=(1.0, 0.0))


def test_async_engine_config_and_refusals(model):
    kw = dict(concurrency=2, buffer_size=3, staleness_alpha=1.0,
              max_staleness=2, allow_version_repeats=True,
              profile=tac.ClientSystemProfile.tiered(4, 2))
    eng = teng.AsyncEngine(**kw)
    cfg = eng.config()
    assert teng.AsyncEngine(**cfg).config() == cfg
    jkw = dict(kw, profile=jac.ClientSystemProfile.tiered(4, 2))
    assert cfg == jeng.AsyncEngine(**jkw).config()
    assert isinstance(teng.resolve_engine("async", **cfg), teng.AsyncEngine)
    exp = Experiment(None, device="cpu").with_engine("async", concurrency=2)
    assert exp.engine.concurrency == 2
    # the sampler argument round-trips through config(), as the
    # reference's does
    frac = teng.AsyncEngine(**dict(kw, sampler="fraction"))
    assert frac.config() == jeng.AsyncEngine(
        **dict(jkw, sampler="fraction")).config()
    assert teng.AsyncEngine(**frac.config()).config() == frac.config()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Experiment(None, device="cpu").with_engine("sharded")
    with pytest.raises(NotImplementedError):
        eng.compile(None)
    state = _port_state(model, tst.StrategySpec(), 3, 1)
    state.plan.fed = dataclasses.replace(state.plan.fed, dp_clip=1.0)
    with pytest.raises(NotImplementedError, match="dp_clip"):
        teng.AsyncEngine().run_rounds(state, lambda j: None)
    with pytest.raises(ValueError, match="packed"):
        tfr.make_server_phase_fn(state.plan.meta, state.plan.fed,
                                 tst.StrategySpec(), sparse=True)
