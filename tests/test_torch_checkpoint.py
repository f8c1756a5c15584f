"""The port's experiment checkpoints (`checkpoint/io.py`, the engine's
`CheckpointCallback`, `Experiment.with_checkpoint` / `Experiment.resume`)
on the CPU.

Bitwise against the reference's format: npz payloads whose keys, shapes
and dtypes the reference reads (bf16 leaves as a raw 2-byte void dtype,
host scalars as 0-d int32 / bool arrays), each package's `load_pytree`
reading the other's files, and the same file set and `meta.json` keys.

Bitwise inside the port (the counterparts of `tests/test_engine.py` and
`tests/test_async_engine.py`): a run stopped after a snapshot and resumed
reproduces the uninterrupted run's history (wall-clock `phase_ms` left
out), ledger, accuracy and flat vector, on `sim`, on `async` with the
dense and the packed event queue in flight, and a snapshot of the final
round resumes to a no-op run.

Across packages (tiny f32 task, no quantization, `exact` Top-K): a
snapshot the reference writes at round 2 is resumed by the port, and a
port snapshot is resumed by the reference's `Experiment.resume`; each
resumed run's rounds 2-3 match the writer's straight run to
`tests/_fed_parity.py`'s tolerances: losses rtol 1e-5, the flat vector
atol 1e-6 on every entry whose upload masks agreed in every round so far
(elsewhere within the Adam steps taken, 4 server_lr a round), ledger bytes
equal where the masks agree, accuracy within 2 of the 128 eval examples.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import strategies as jst
from repro.data import datasets as jds
from repro.federated import api as japi
from repro.federated import engine as jeng
from repro_torch.checkpoint import io as tio
from repro_torch.core import strategies as tst
from repro_torch.data import make_synth_image
from repro_torch.federated import Experiment
from repro_torch.federated import async_clock as tac
from repro_torch.federated import engine as teng
from repro_torch.federated import runtime as trt

LEDGER_ATTRS = ("down_values", "up_values", "down_bytes", "up_bytes",
                "total_bytes", "down_coded_bytes", "up_coded_bytes",
                "total_coded_bytes", "rounds")
TASK_KW = dict(n_examples=128, n_clients=8, n_patches=4, dim=16, seed=0,
               n_eval=128)
MODEL_KW = dict(d_model=16, num_layers=1, num_heads=2, d_ff=32)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def task():
    return make_synth_image(**TASK_KW)


def _experiment(task, kind="flasc", rounds=4, **kw):
    spec = tst.StrategySpec(kind=kind, density_down=0.5, density_up=0.5,
                            **kw)
    return (Experiment(task, strategy=spec, device="cpu")
            .with_federation(n_clients=4, local_batch=4)
            .with_model(**MODEL_KW)
            .with_lora(rank=4)
            .with_training(rounds=rounds, eval_every=2, pretrain_steps=2))


def _strip(history):
    return [{k: v for k, v in h.items() if k != "phase_ms"} for h in history]


class _StopAfterCheckpoint(teng.Callback):
    def on_checkpoint(self, ev):
        raise teng.StopRun


class _Flat(teng.Callback):
    def __init__(self):
        self.flats = []

    def on_round_end(self, ev):
        self.flats.append(ev.state.flatP.numpy().copy())


def _same_result(got, want, got_flats, want_flats):
    assert _strip(got.history) == _strip(want.history)
    assert got.final_acc == want.final_acc
    for attr in LEDGER_ATTRS:
        assert getattr(got.ledger, attr) == getattr(want.ledger, attr), attr
    for a, b in zip(got_flats, want_flats[-len(got_flats):]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the npz format, against the reference's reader and writer
# ---------------------------------------------------------------------------

def test_pytree_bf16_and_host_scalars_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    tree = {"w": {"bf16": w.to(torch.bfloat16), "f32": w},
            "server": {"round": 7, "flag": True},
            "ids": np.arange(4, dtype=np.int64)}
    path = str(tmp_path / "port.npz")
    tio.save_pytree(tree, path)

    jback = jio.load_pytree(path)          # the reference's reader
    assert jback["w"]["bf16"].dtype.kind == "V" and \
        jback["w"]["bf16"].dtype.itemsize == 2
    np.testing.assert_array_equal(
        jback["w"]["bf16"].view(np.uint16),
        tree["w"]["bf16"].view(torch.int16).numpy().view(np.uint16))
    assert jback["server"]["round"].dtype == np.int32 and \
        jback["server"]["round"].shape == () and \
        int(jback["server"]["round"]) == 7
    assert jback["server"]["flag"].dtype == np.bool_ and \
        bool(jback["server"]["flag"])
    np.testing.assert_array_equal(jback["w"]["f32"], w.numpy())

    # the reference's writer: an ml_dtypes bfloat16 leaf and jnp scalars
    jpath = str(tmp_path / "ref.npz")
    jio.save_pytree({"w": jnp.asarray(w.numpy()).astype(jnp.bfloat16),
                     "round": jnp.asarray(7, jnp.int32),
                     "flag": jnp.asarray(True)}, jpath)
    with np.load(jpath) as a, np.load(path) as b:
        assert a["w"].dtype == b["w/bf16"].dtype     # the same npz dtype
    tback = tio.load_pytree(jpath)
    got = tio.restore_like(tback, {"w": torch.zeros(3, 5,
                                                    dtype=torch.bfloat16),
                                   "round": 0, "flag": False})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"]["bf16"])
    assert got["round"] == 7 and type(got["round"]) is int
    assert got["flag"] is True
    ours = tio.restore_like(tio.load_pytree(path), tree)
    assert ours["server"] == {"round": 7, "flag": True}
    assert torch.equal(ours["w"]["bf16"], tree["w"]["bf16"])
    np.testing.assert_array_equal(
        jback["w"]["bf16"].view(ml_dtypes.bfloat16).astype(np.float32),
        tree["w"]["bf16"].float().numpy())
    with pytest.raises(ValueError, match="shape"):
        tio.restore_like(tback, {"w": torch.zeros(2, 5), "round": 0,
                                 "flag": False})
    with pytest.raises(KeyError, match="missing"):
        tio.restore_like(tback, {"nope": 0})


def test_server_round_roundtrip(tmp_path):
    P = torch.arange(6, dtype=torch.float32)
    from repro_torch.core import fedround as tfr
    server = tfr.init_server(P)
    server["round"] = 3
    sst = {"mask": P > 2, "initialized": True}
    path = str(tmp_path / "round.npz")
    tio.save_server_round(P, server, sst, path)
    jP, jserver, jsst = jio.load_server_round(path)
    np.testing.assert_array_equal(jP, P.numpy())
    assert jserver["round"].dtype == np.int32 and int(jserver["round"]) == 3
    assert jserver["opt"]["count"].dtype == np.int32
    assert jsst["initialized"].dtype == np.bool_
    like = (torch.zeros(6), tfr.init_server(torch.zeros(6)),
            {"mask": torch.zeros(6, dtype=torch.bool), "initialized": False})
    gP, gserver, gsst = tio.load_server_round(path, like)
    assert torch.equal(gP, P) and gserver["round"] == 3
    assert gsst["initialized"] is True and torch.equal(gsst["mask"], P > 2)


def test_experiment_checkpoint_atomic_prune_and_overwrite(tmp_path):
    d = str(tmp_path / "ck")
    frozen = {"params": {"w": torch.ones(2, dtype=torch.bfloat16)}}
    p1 = tio.save_experiment_checkpoint(d, {"P": torch.zeros(3)},
                                        {"round": 1}, frozen=frozen,
                                        overwrite_frozen=True)
    assert os.path.basename(p1) == "state-r1.npz"
    p2 = tio.save_experiment_checkpoint(
        d, {"P": torch.ones(3)}, {"round": 2},
        frozen={"params": {"w": torch.zeros(2)}})      # frozen kept
    assert sorted(os.listdir(d)) == ["frozen.npz", "meta.json",
                                     "state-r2.npz"]
    arrays, meta = tio.load_experiment_checkpoint(d)
    assert meta == {"round": 2, "state_file": "state-r2.npz"}
    np.testing.assert_array_equal(arrays["P"], np.ones(3, np.float32))
    assert arrays["params"]["w"].dtype.kind == "V"      # the first frozen
    # the reference reads the port's directory
    jarrays, jmeta = jio.load_experiment_checkpoint(d)
    assert jmeta == meta and sorted(jarrays) == sorted(arrays)
    # a fresh run's first save: old sidecar gone before the frozen changes
    tio.save_experiment_checkpoint(
        d, {"P": torch.ones(3)}, {"round": 1},
        frozen={"params": {"w": torch.zeros(2)}}, overwrite_frozen=True)
    arrays, meta = tio.load_experiment_checkpoint(d)
    assert meta["round"] == 1 and arrays["params"]["w"].dtype == np.float32
    assert not any(".tmp" in n for n in os.listdir(d))
    assert os.path.exists(p2) is False
    with pytest.raises(FileNotFoundError):
        tio.load_experiment_checkpoint(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# resume inside the port, bitwise (tests/test_engine.py,
# tests/test_async_engine.py counterparts)
# ---------------------------------------------------------------------------

def _tiered(**kw):
    kw.setdefault("buffer_size", 2)
    return teng.AsyncEngine(profile=tac.ClientSystemProfile.tiered(4, 4),
                            **kw)


ENGINES = {
    "sim": (lambda: "sim", {}),
    "async": (_tiered, {}),
    "async-sparse": (_tiered, dict(sparse_aggregate=True, selector="fused",
                                   quant_bits_up=4)),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_checkpoint_resume_reproduces_history(task, tmp_path, name):
    make_engine, spec_kw = ENGINES[name]
    ffull = _Flat()
    full = (_experiment(task, rounds=8, **spec_kw)
            .with_engine(make_engine()).with_callbacks(ffull).run())
    ckpt = str(tmp_path / "ckpt")
    interrupted = (_experiment(task, rounds=8, **spec_kw)
                   .with_engine(make_engine())
                   .with_checkpoint(ckpt, every=3)
                   .with_callbacks(_StopAfterCheckpoint()).run())
    assert len(interrupted.history) == 3
    assert sorted(os.listdir(ckpt)) == ["frozen.npz", "meta.json",
                                        "state-r3.npz"]
    exp = Experiment.resume(ckpt, device="cpu")
    if name != "sim":
        assert isinstance(exp.engine, teng.AsyncEngine)
        assert exp.engine.buffer_size == 2
        assert exp.engine.profile == tac.ClientSystemProfile.tiered(4, 4)
        arrays, _ = tio.load_experiment_checkpoint(ckpt)
        assert arrays["aux"]["inflight"]["slot"].size > 0   # jobs in flight
    fres = _Flat()
    resumed = exp.with_callbacks(fres).run()
    assert len(fres.flats) == 5
    _same_result(resumed, full, fres.flats, ffull.flats)
    if name != "sim":
        assert any(h["staleness"] > 0 for h in resumed.history)


def test_resume_without_remaining_rounds_is_stable(task, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    full = (_experiment(task, rounds=3).with_engine(_tiered())
            .with_checkpoint(ckpt, every=3).run())
    exp = Experiment.resume(ckpt, device="cpu")
    assert isinstance(exp.engine, teng.AsyncEngine)
    resumed = exp.run()
    assert resumed.history == full.history      # phase_ms included
    assert resumed.final_acc == full.final_acc


def test_resume_restores_host_scalars_and_strategy_state(task, tmp_path):
    """sparse_adapter keeps a mask and a host `initialized` flag; the
    round index is a host int: both come back as host scalars."""
    ckpt = str(tmp_path / "ckpt")
    ffull = _Flat()
    full = (_experiment(task, "sparse_adapter", rounds=5)
            .with_callbacks(ffull).run())
    (_experiment(task, "sparse_adapter", rounds=5)
     .with_checkpoint(ckpt, every=2)
     .with_callbacks(_StopAfterCheckpoint()).run())

    class Probe(teng.Callback):
        def on_round_end(self, ev):
            self.sst = ev.state.sstate
            self.server = ev.state.server

    probe, fres = Probe(), _Flat()
    resumed = (Experiment.resume(ckpt, device="cpu")
               .with_callbacks(probe, fres).run())
    _same_result(resumed, full, fres.flats, ffull.flats)
    assert probe.sst["initialized"] is True
    assert type(probe.server["round"]) is int
    assert probe.server["opt"]["count"].dtype == torch.int32
    assert probe.server["opt"]["count"].shape == ()


def test_checkpoint_refuses_a_custom_model_config(task, tmp_path):
    cfg = trt.model_for_task(task, **MODEL_KW)
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import init_params
    params = init_params(mdl.model_spec(cfg), 0, device="cpu")
    import dataclasses
    other = dataclasses.replace(cfg, max_seq=32)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="custom ModelConfig"):
        (_experiment(task, rounds=2).with_params(params, other)
         .with_checkpoint(ckpt, every=1).run())
    # the task's own config through with_params is accepted
    ok = (_experiment(task, rounds=2).with_params(params, cfg)
          .with_checkpoint(ckpt, every=1).run())
    assert len(ok.history) == 2
    # save_model_config carries the custom one through the port's resume
    ck2 = str(tmp_path / "ck2")
    fone = _Flat()
    full = (_experiment(task, rounds=3).with_params(params, other)
            .with_callbacks(fone).run())
    (_experiment(task, rounds=3).with_params(params, other)
     .with_checkpoint(ck2, every=2, save_model_config=True)
     .with_callbacks(_StopAfterCheckpoint()).run())
    with open(os.path.join(ck2, "meta.json")) as f:
        assert json.load(f)["model_config"]["max_seq"] == 32
    exp = Experiment.resume(ck2, device="cpu")
    assert exp.build_backbone()[1] == other
    fres = _Flat()
    _same_result(exp.with_callbacks(fres).run(), full, fres.flats,
                 fone.flats)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

SPEC = dict(kind="flasc", density_down=0.25, density_up=0.25)
FED = dict(n_clients=4, local_batch=4, local_steps=2, client_lr=5e-2,
           server_lr=5e-3, adam_eps=1e-5)
TRAIN = dict(rounds=4, eval_every=2, pretrain_steps=2, seed=3)


def _capture(monkeypatch):
    """Each package's upload messages, per round, through `aggregate`."""
    kept = {"j": [], "t": []}
    jorig, torig = jst.Strategy.aggregate, tst.Strategy.aggregate

    def jagg(self, deltas, ctx):
        jax.debug.callback(lambda d: kept["j"].append(np.asarray(d)), deltas)
        return jorig(self, deltas, ctx)

    def tagg(self, deltas, ctx):
        kept["t"].append(deltas.numpy().copy())
        return torig(self, deltas, ctx)

    monkeypatch.setattr(jst.Strategy, "aggregate", jagg)
    monkeypatch.setattr(tst.Strategy, "aggregate", tagg)
    return kept


def _reference_experiment(task):
    from repro.models.config import FederatedConfig as JFed
    return (japi.Experiment(task, strategy=jst.StrategySpec(**SPEC),
                            federation=JFed(**FED))
            .with_model(**MODEL_KW).with_lora(rank=4)
            .with_training(**TRAIN))


def _port_experiment(task):
    from repro_torch.models.config import FederatedConfig
    return (Experiment(task, strategy=tst.StrategySpec(**SPEC),
                       federation=FederatedConfig(**FED), device="cpu")
            .with_model(**MODEL_KW).with_lora(rank=4)
            .with_training(**TRAIN))


class _JFlat(jeng.Callback):
    def __init__(self):
        self.flats = []

    def on_round_end(self, ev):
        self.flats.append(np.array(ev.state.flatP))


def _compare_tail(got_hist, want_hist, got_flats, want_flats, kept_got,
                  kept_want, n_eval):
    """Rounds 2-3: the module doc's tolerances."""
    assert len(got_hist) == len(want_hist) == 4
    apart = np.zeros(got_flats[0].shape, bool)
    for i, r in enumerate((2, 3)):
        g, w = got_hist[r], want_hist[r]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        jm, tm_ = kept_want[i] != 0, kept_got[i] != 0
        overlap = float((jm == tm_).mean())
        apart |= (jm != tm_).any(0)
        print(f"round {r}: loss {g['loss']:.6f} / {w['loss']:.6f}, "
              f"upload-mask overlap {overlap:.6f}")
        assert overlap >= 0.999
        if overlap == 1.0:
            for key in ("down_bytes", "up_bytes", "coded_bytes",
                        "up_coded_bytes"):
                assert g[key] == w[key], (r, key)
        diff = np.abs(got_flats[i] - want_flats[r])
        assert diff.max() <= 4 * FED["server_lr"] * (i + 1)
        np.testing.assert_allclose(got_flats[i][~apart], want_flats[r][~apart],
                                   atol=ATOL)
        if "acc" in w:
            assert abs(g["acc"] - w["acc"]) <= 2 / n_eval + 1e-12


def test_port_resumes_a_reference_snapshot(tmp_path, monkeypatch):
    jtask = jds.make_synth_image(**TASK_KW)
    kept = _capture(monkeypatch)
    jfull_flats = _JFlat()
    jfull = _reference_experiment(jtask).with_callbacks(jfull_flats).run()
    ckpt = str(tmp_path / "ref")

    class Stop(jeng.Callback):
        def on_checkpoint(self, ev):
            raise jeng.StopRun
    (_reference_experiment(jtask).with_checkpoint(ckpt, every=2)
     .with_callbacks(Stop()).run())
    kept["j"] = kept["j"][2:4]          # the straight run's rounds 2-3
    fres = _Flat()
    exp = Experiment.resume(ckpt, device="cpu")
    assert exp.task.data["embeds"].dtype == jtask.data["embeds"].dtype
    res = exp.with_callbacks(fres).run()
    _compare_tail(res.history, jfull.history, fres.flats, jfull_flats.flats,
                  kept["t"], kept["j"], TASK_KW["n_eval"])
    assert res.history[:2] == jfull.history[:2]     # restored verbatim


def _npz_layout(directory):
    out = {}
    for name in ("frozen.npz", "state-r2.npz"):
        with np.load(os.path.join(directory, name)) as z:
            out[name] = {k: (z[k].shape, z[k].dtype.str) for k in z.files
                         if k != "__manifest__"}
    return out


def test_reference_resumes_a_port_snapshot(tmp_path, monkeypatch):
    task = make_synth_image(**TASK_KW)
    kept = _capture(monkeypatch)
    tflats = _Flat()
    tfull = _port_experiment(task).with_callbacks(tflats).run()
    ck_t, ck_j = str(tmp_path / "port"), str(tmp_path / "ref")
    _port_experiment(task).with_checkpoint(ck_t, every=2).with_callbacks(
        _StopAfterCheckpoint()).run()

    class Stop(jeng.Callback):
        def on_checkpoint(self, ev):
            raise jeng.StopRun
    _reference_experiment(jds.make_synth_image(**TASK_KW)).with_checkpoint(
        ck_j, every=2).with_callbacks(Stop()).run()
    # the same npz keys, shapes and dtypes, and the same sidecar keys
    assert _npz_layout(ck_t) == _npz_layout(ck_j)
    with open(os.path.join(ck_t, "meta.json")) as f:
        tmeta = json.load(f)
    with open(os.path.join(ck_j, "meta.json")) as f:
        jmeta = json.load(f)
    assert tmeta.keys() == jmeta.keys()
    for key in ("strategy", "federation", "model", "lora", "train",
                "task_meta", "engine", "round", "version"):
        assert tmeta[key] == jmeta[key], key
    assert tmeta["ledger"].keys() == jmeta["ledger"].keys()
    assert [set(h) - {"phase_ms"} for h in tmeta["history"]] == \
        [set(h) for h in jmeta["history"]]

    kept["t"] = kept["t"][2:4]
    kept["j"].clear()
    jflats = _JFlat()
    jres = japi.Experiment.resume(ck_t).with_callbacks(jflats).run()
    _compare_tail(jres.history, tfull.history, jflats.flats, tflats.flats,
                  kept["j"], kept["t"], TASK_KW["n_eval"])
    for attr in LEDGER_ATTRS[:2]:
        assert getattr(jres.ledger, attr) == getattr(tfull.ledger, attr)


def test_finetune_example_checkpoints_and_resumes(tmp_path, capsys):
    """examples/federated_finetune_torch.py: a tiny run snapshotted every
    round, then `--resume` extends it by one round."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples",
        "federated_finetune_torch.py")
    spec = importlib.util.spec_from_file_location("ff_torch", path)
    ff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ff)
    ck = str(tmp_path / "ck")
    first = ff.main(["--device", "cpu", "--rounds", "2", "--ckpt-every", "1",
                     "--ckpt", ck])
    assert len(first.history) == 2
    more = ff.main(["--device", "cpu", "--resume", ck, "--rounds", "3"])
    assert len(more.history) == 3
    assert _strip(more.history[:2]) == _strip(first.history)
    assert "checkpoints -> " + ck in capsys.readouterr().out
