"""The port's baselines against the reference, on the CPU: `ffa`,
`hetlora` (plain and weighted), `flocora` and `two_stage_ortho` through
both packages' `SimEngine` (harness and tolerances: `tests/_fed_parity.py`),
DP-FedAdam (`core/dp.py` and the round's DP branch), the `lowrank`
transport stage, and whole `Experiment(task)` runs of FLoCoRA's learned
mode, DP-FLASC at zero noise and full finetuning.

Random draws cannot match across the packages (threefry against Philox):
  - the random-mode projection `Q` is the reference's, computed from the
    same seed and fold and put in the port's stage by monkeypatching
    `LowRankCompress._projection` in the test;
  - factor quantization gets the reference's uniforms injected, and
    matches bitwise where both quantize the same factor;
  - DP noise is held in distribution: (agg - clean) n / sigma over 1.2e5
    entries has mean within 0.02 and standard deviation within 2% of 1,
    and two rounds draw different noise.

Tolerances: `clip_deltas` / `dp_aggregate` at zero noise 1e-6; low-rank
reconstructions 1e-5 relative (QR and SVD round differently in the two
libraries; the learned mode's truncated reconstruction is unique where
the factors are not); the `Experiment` runs like the strategy runs
(losses rtol 1e-5, flat vector atol 1e-6, equal ledger bytes) and equal
accuracy.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fed_parity import ATOL, RTOL, build_model, compare, run_pair, t_
from repro.core import dp as jdp
from repro.core import fedround as jfr
from repro.core import quantization as jqz
from repro.core import strategies as jst
from repro.core import transport as jtp
from repro.data import datasets as jds
from repro.federated import api as japi
from repro.federated import runtime as jrt
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro.models.config import LoRAConfig as JLoRAConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import dp as tdp
from repro_torch.core import fedround as tfr
from repro_torch.core import strategies as tst
from repro_torch.core import transport as ttp
from repro_torch.data import datasets as tds
from repro_torch.federated import Experiment
from repro_torch.federated import engine as teng
from repro_torch.models import lora as tlora
from repro_torch.models.config import FederatedConfig, ModelConfig

TASK_KW = dict(n_examples=128, n_clients=8, n_patches=6, dim=32, n_eval=128,
               seed=3)
MODEL_KW = dict(d_model=32, num_layers=2, num_heads=4, d_ff=64)
EXP_FED = dict(n_clients=4, local_batch=4, local_steps=2, client_lr=5e-2,
               server_lr=5e-3, adam_eps=1e-5)


@pytest.fixture(scope="module")
def model():
    return build_model()


def _meta(model):
    return tfr.FlatMeta.of({"lora": model["tlora"]})


def _ref_projection(self, cols, device):
    """The reference's random-mode Q for this stage's seed and fold."""
    q = jtp.LowRankCompress(rank=self.rank, seed=self.seed,
                            fold=self.fold)._projection(cols)
    return torch.from_numpy(np.array(q)).to(device)


# ---------------------------------------------------------------------------
# the kinds through both SimEngines
# ---------------------------------------------------------------------------

def test_ffa_matches_reference(model):
    jrun, trun, flat0, _ = run_pair(model, dict(kind="ffa"), rounds=2)
    compare("ffa", jrun, trun, _meta(model))
    is_a = _meta(model).is_b == 0
    # A is frozen: its entries never move, bit for bit
    np.testing.assert_array_equal(trun.flats[-1][is_a], flat0[is_a])
    assert (trun.flats[-1][~is_a] != flat0[~is_a]).mean() > 0.5
    assert all((k[:, is_a] == 0).all() for k in trun.strat.kept)


@pytest.mark.parametrize("weighted", [False, True])
def test_hetlora_matches_reference(model, weighted):
    ranks = (1, 2, 2, 3)
    spec = dict(kind="hetlora", hetlora_ranks=ranks,
                hetlora_weighted=weighted)
    jrun, trun, flat0, _ = run_pair(model, spec, rounds=2)
    compare("hetlora", jrun, trun, _meta(model))
    rank_idx = _meta(model).rank_idx
    # no client covers rank component 3: FedAdam moves nothing there
    np.testing.assert_array_equal(trun.flats[-1][rank_idx >= 3],
                                  flat0[rank_idx >= 3])
    assert (trun.flats[-1][rank_idx < 1] != flat0[rank_idx < 1]).all()
    for c, r_c in enumerate(ranks):
        assert (trun.strat.kept[0][c, rank_idx >= r_c] == 0).all()


def test_flocora_matches_reference(model, monkeypatch):
    """Random mode in both directions (rank 8 of a 60 x 60 embedding of
    the 3,584 entries), the reference's Q injected."""
    monkeypatch.setattr(ttp.LowRankCompress, "_projection", _ref_projection)
    jrun, trun, _, _ = run_pair(model, dict(kind="flocora"), rounds=2)
    exact = compare("flocora", jrun, trun, _meta(model))
    assert exact == [0, 1]
    led = trun.ledger
    rows = 60
    assert (led.down_dense, led.up_dense) == (True, True)
    assert led.up_coded_bytes == 2 * 4 * rows * 8 * 4
    assert led.down_coded_bytes == 2 * 4 * rows * 8 * 4
    assert jrun.ledger.up_coded_bytes == led.up_coded_bytes


@pytest.mark.parametrize("phase_len", [1, 2])
@pytest.mark.parametrize("selector", ["exact", "fused"])
def test_two_stage_ortho_matches_reference(model, selector, phase_len):
    spec = dict(kind="two_stage_ortho", selector=selector,
                phase_len=phase_len)
    jrun, trun, flat0, _ = run_pair(model, spec, rounds=2)
    meta = _meta(model)
    compare("two_stage_ortho", jrun, trun, meta)
    is_b = meta.is_b == 1
    fold = phase_len - 1                   # the A phase's last round
    for r, flat in enumerate(trun.flats):
        tree = meta.unflatten(t_(flat))
        for blk in tree["lora"]["g0"].values():
            for pair in blk.values():
                a = pair["a"]
                qtq = a.transpose(-1, -2) @ a
                err = float((qtq - torch.eye(a.shape[-1])).abs().max())
                # orthonormal right after the fold; later rounds move A
                # again with the Adam momentum of the A phase
                assert (err <= 1e-5) == (r == fold), (r, err)
    # round 0 is an A phase: B moved nowhere, every upload is A only
    assert (trun.strat.kept[0][:, is_b] == 0).all()
    if phase_len == 1:       # round 1 is a B phase
        assert (trun.strat.kept[1][:, ~is_b] == 0).all()


def test_ortho_lora_pairs_keeps_products(model):
    """`_ortho_lora_pairs` on the model's LoRA tree: Q orthonormal (1e-5),
    every product A·B kept (1e-5 relative to its largest entry), and the
    reference's products (1e-6)."""
    tree = model["tlora"]
    out = tst._ortho_lora_pairs(tree)
    jout = jst._ortho_lora_pairs(jax.tree.map(jnp.asarray, model["lora"]))
    for sec in tree["g0"]:
        for k in tree["g0"][sec]:
            a, b = tree["g0"][sec][k]["a"], tree["g0"][sec][k]["b"]
            q, rb = out["g0"][sec][k]["a"], out["g0"][sec][k]["b"]
            eye = torch.eye(a.shape[-1]).expand(a.shape[0], -1, -1)
            assert float((q.transpose(-1, -2) @ q - eye).abs().max()) < 1e-5
            want = (a.double() @ b.double())
            got = q.double() @ rb.double()
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
            jq, jrb = (np.asarray(jout["g0"][sec][k][x]) for x in "ab")
            np.testing.assert_allclose(got.numpy(), jq.astype(np.float64)
                                       @ jrb.astype(np.float64), atol=ATOL)


# ---------------------------------------------------------------------------
# DP-FedAdam
# ---------------------------------------------------------------------------

def test_clip_and_dp_aggregate_match_reference():
    rng = np.random.default_rng(0)
    deltas = rng.standard_normal((5, 3000), dtype=np.float32)
    deltas[1] *= np.float32(1e-4)                  # one delta under the clip
    for clip in (0.5, 10.0, 1e4):
        jc, jn = jdp.clip_deltas(jnp.asarray(deltas), clip)
        tc, tn = tdp.clip_deltas(torch.from_numpy(deltas), clip)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
        ja, _ = jdp.dp_aggregate(jnp.asarray(deltas), clip, 0.0,
                                 jax.random.key(0))
        ta, _ = tdp.dp_aggregate(torch.from_numpy(deltas), clip, 0.0, None)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    for args in ((1.0, 100, 0.01), (0.7, 30, 0.3, 1e-5), (0.0, 10, 0.1)):
        assert tdp.gaussian_epsilon(*args) == jdp.gaussian_epsilon(*args)
    assert tdp.simulated_noise_multiplier(1.2, 1000, 8) == \
        jdp.simulated_noise_multiplier(1.2, 1000, 8)


def _linear_task(fed, spec, n=120_000, C=4):
    """A linear model (loss = w · x, so every client's delta is client_lr *
    x whatever w is) under server_opt "sgd" at lr 1: a round's
    pseudo-gradient is the drop of w.  Returns (RoundTask, w, the clean
    DP aggregate)."""
    w = torch.linspace(-1, 1, n)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (C, 1, n), dtype=np.float32))
    task = teng.RoundTask(lambda tree, mb: (tree["w"] * mb["x"]).sum(),
                          tfr.FlatMeta.of({"w": w}), fed, tst.resolve(spec))
    clean, _ = tdp.dp_aggregate(fed.client_lr * x[:, 0], fed.dp_clip, 0.0,
                                None)
    return task, w, {"x": x}, clean


def test_dp_round_draws_new_noise_each_round(monkeypatch):
    """The round's DP branch through the sim engine: the normalized noise
    (pseudo-gradient - clean aggregate) n / sigma is standard normal, every
    round draws new noise (also with no seed, by calling the round
    directly), the same seed and round the same noise; uploads never take
    the packed path, even with sparse_aggregate."""
    monkeypatch.setattr(tfr.ft, "pack_values_batch", None)   # never called
    fed = FederatedConfig(n_clients=4, local_batch=1, client_lr=1e-3,
                          client_momentum=0.0, server_opt="sgd",
                          server_lr=1.0, dp_clip=0.5, dp_noise=0.8)
    spec = tst.StrategySpec(kind="lora", sparse_aggregate=True)
    task, w, batch, clean = _linear_task(fed, spec)

    def noise(before, after):
        z = ((before - after - clean) * 4 / fed.dp_noise).numpy()
        print(f"mean {z.mean():.5f} std {z.std():.5f}")
        assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
        return z

    runs = []
    for _ in range(2):
        class Keep(teng.Callback):
            flats = [w]

            def on_round_end(self, ev):
                self.flats.append(ev.state.flatP)
        keep = Keep()
        teng.SimEngine().run_rounds(teng.RunState.fresh(task, w, rounds=2),
                                    lambda r: batch, [keep])
        runs.append([noise(a, b) for a, b in zip(keep.flats, keep.flats[1:])])
    assert not np.allclose(runs[0][0], runs[0][1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    unseeded = []
    for r in (0, 1):
        out = tfr.federated_round(w, {"opt": None, "round": r}, {}, batch,
                                  None, loss_of=task.loss_of, meta=task.meta,
                                  fed=fed, strategy=spec)
        unseeded.append(noise(w, out[0]))
    assert not np.allclose(unseeded[0], unseeded[1])
    with pytest.raises(NotImplementedError, match="dp_clip"):
        tfr.federated_round(
            w, {"opt": None, "round": 0}, {}, batch, 0, loss_of=task.loss_of,
            meta=task.meta, fed=fed, strategy=tst.StrategySpec(
                kind="hetlora", hetlora_ranks=(1,) * 4, hetlora_weighted=True))


# ---------------------------------------------------------------------------
# the lowrank transport stage
# ---------------------------------------------------------------------------

def _rows(n, C=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (C, n), dtype=np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mode", ["random", "learned"])
def test_lowrank_reconstruction_matches_reference(mode, monkeypatch):
    """A batch of rows through the port's stage against the reference's,
    one row at a time: n = 3,000 (a 55 x 55 embedding with 25 zeros of
    padding), rank 6, fold 3, no quantization.  Reconstruction within 1e-5
    relative, nnz and wire format equal."""
    monkeypatch.setattr(ttp.LowRankCompress, "_projection", _ref_projection)
    x = _rows(3000)
    kw = dict(rank=6, mode=mode, seed=5, fold=3)
    jst_, tst_ = jtp.LowRankCompress(**kw), ttp.LowRankCompress(**kw)
    got = tst_(ttp.Message.dense(torch.from_numpy(x)))
    assert got.values.shape == x.shape and got.value_bits == 32.0
    for c in range(len(x)):
        want = jst_(jtp.Message.dense(jnp.asarray(x[c])))
        assert _rel(got.values[c].numpy(), np.asarray(want.values)) < 1e-5
        assert float(got.nnz[c]) == float(want.nnz) == tst_.sent(3000)
    assert tst_.wire(3000, 32.0, False) == jst_.wire(3000, 32.0, False) \
        == (32.0, True)
    assert tst_.sent(3000) == (55 * 6 if mode == "random" else 6 * 110)


@pytest.mark.parametrize("mode", ["random", "learned"])
def test_lowrank_factor_quantization_matches_reference(mode, monkeypatch):
    """bits 4.  Each factor quantized with the reference's uniforms (the
    right factor's from `fold_in(key, 1)`, as the reference draws them)
    gives the reference's levels bitwise on the same factor.  The stage's
    message is its own factors quantized with the injected uniforms and
    reconstructed (bitwise), billed at 4 bits.  Against the reference's
    stage: with nearest rounding in both modes, and with the same uniforms
    in random mode, reconstruction within 1e-5 relative (a learned factor
    pair is unique only up to sign, and a flipped sign meets other
    uniforms)."""
    monkeypatch.setattr(ttp.LowRankCompress, "_projection", _ref_projection)
    x = _rows(3000, C=1)[0]
    kw = dict(rank=6, mode=mode, seed=5, bits=4)
    jst_, tst_ = jtp.LowRankCompress(**kw), ttp.LowRankCompress(**kw)
    key = jax.random.key(9)
    rows, cols = ttp._factor_dims(3000)
    mt = torch.nn.functional.pad(torch.from_numpy(x),
                                 (0, rows * cols - 3000)).reshape(rows, cols)
    if mode == "random":
        q = _ref_projection(tst_, cols, "cpu")
        factors = [mt @ q]
        keys = [key]
    else:
        uu, s, vt = torch.linalg.svd(mt, full_matrices=False)
        factors = [uu[:, :6] * s[:6], vt[:6]]
        keys = [key, jax.random.fold_in(key, 1)]
    draws = []
    for f, k in zip(factors, keys):
        u = torch.from_numpy(np.array(jax.random.uniform(k, (f.numel(),))))
        draws.append(u)
        want = jax.jit(jst_._quant)(jnp.asarray(f.numpy()), k)
        got = tst_._quant(f, u)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u_all = torch.cat(draws)
    msg = tst_(ttp.Message.dense(torch.from_numpy(x)), rng=u_all)
    assert msg.value_bits == 4.0 and float(msg.nnz) == tst_.sent(3000)
    if mode == "random":
        rec = tst_._quant(factors[0], u_all) @ q.T
    else:
        rec = tst_._quant(factors[0], draws[0]) @ tst_._quant(factors[1],
                                                              draws[1])
    np.testing.assert_array_equal(msg.values.numpy(),
                                  rec.reshape(-1)[:3000].numpy())
    nearest = tst_(ttp.Message.dense(torch.from_numpy(x)))
    jnear, jnnz = jax.jit(lambda v: dataclasses.astuple(
        jst_(jtp.Message.dense(v)))[:2])(jnp.asarray(x))
    assert _rel(nearest.values.numpy(), np.asarray(jnear)) < 1e-5
    assert float(jnnz) == float(nearest.nnz)
    if mode == "random":
        jmsg = jax.jit(lambda v: jst_(jtp.Message.dense(v), key=key).values)(
            jnp.asarray(x))
        assert _rel(msg.values.numpy(), np.asarray(jmsg)) < 1e-5
    # an inactive stage (rank >= min(rows, cols)) degrades to Quantize
    big = ttp.LowRankCompress(rank=55, bits=4)
    assert not big.active(3000)
    np.testing.assert_array_equal(
        big(ttp.Message.dense(torch.from_numpy(x))).values.numpy(),
        np.asarray(jax.jit(lambda v: jqz.quantize_roundtrip(v, 4))(
            jnp.asarray(x))))


# ---------------------------------------------------------------------------
# whole Experiment(task) runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def task_model():
    """The image task in both packages, the reference's ViT task model on
    random weights, a numpy-drawn LoRA tree, and their port conversions."""
    jt, tt = (jds.make_synth_image(**TASK_KW), tds.make_synth_image(**TASK_KW))
    cfg = jrt.model_for_task(jt, **MODEL_KW)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(JM.model_spec(cfg), k))(jax.random.key(0)))
    rng = np.random.default_rng(100)
    lora = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, dtype=np.float32)
                   * np.float32(0.1)),
        jlora.lora_spec(cfg, JLoRAConfig(rank=4, alpha=8.0)),
        is_leaf=lambda x: isinstance(x, JL.P))
    return {"jt": jt, "tt": tt, "cfg": cfg, "params": params, "lora": lora,
            "tcfg": ModelConfig(**dataclasses.asdict(cfg)),
            "tparams": tree_from_numpy(params, device="cpu")}


def _experiments(tm, monkeypatch, spec_kw, fed_kw=None, **train):
    """Both packages' `Experiment(task)` on the same converted backbone and
    injected LoRA tree, 2 rounds, eval at the end; returns the two results
    and each run's flat vector after every round."""
    monkeypatch.setattr(jlora, "init_lora",
                        lambda *a, **k: jax.tree.map(jnp.asarray, tm["lora"]))
    monkeypatch.setattr(tlora, "init_lora", lambda *a, **k: tree_from_numpy(
        tm["lora"], device="cpu"))
    fed = dict(EXP_FED, **(fed_kw or {}))
    train = dict(rounds=2, eval_every=0, seed=5, **train)
    jexp = (japi.Experiment(tm["jt"], strategy=jst.StrategySpec(**spec_kw),
                            federation=JFederatedConfig(**fed))
            .with_lora(rank=4, alpha=8.0).with_training(**train)
            .with_params(jax.tree.map(jnp.asarray, tm["params"]), tm["cfg"]))
    texp = (Experiment(tm["tt"], strategy=tst.StrategySpec(**spec_kw),
                       federation=FederatedConfig(**fed), device="cpu")
            .with_lora(rank=4, alpha=8.0).with_training(**train)
            .with_params(tm["tparams"], tm["tcfg"]))
    flats = {"j": [], "t": []}
    for exp, tag, base in ((jexp, "j", japi.eng.Callback),
                           (texp, "t", teng.Callback)):
        class Keep(base):
            def on_round_end(self, ev, _tag=tag):
                flats[_tag].append(np.array(ev.state.flatP))
        exp.with_callbacks(Keep())
    return jexp.run(), texp.run(), flats


def _same_run(jres, tres, flats, what):
    for r, (jh, th) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL)
        for key in ("down_bytes", "up_bytes", "coded_bytes",
                    "down_coded_bytes", "up_coded_bytes"):
            assert th[key] == jh[key], (what, r, key)
        np.testing.assert_allclose(flats["t"][r], flats["j"][r], atol=ATOL,
                                   err_msg=f"{what} round {r}")
    assert len(tres.history) == len(jres.history) == 2
    print(f"{what}: losses {[h['loss'] for h in tres.history]}, acc "
          f"{tres.final_acc} (reference {jres.final_acc})")


def test_flocora_learned_experiment_matches_reference(task_model,
                                                      monkeypatch):
    jres, tres, flats = _experiments(
        task_model, monkeypatch, dict(kind="flocora", lowrank_mode="learned"))
    _same_run(jres, tres, flats, "flocora learned")
    assert tres.final_acc == jres.final_acc
    assert tres.ledger.up_dense and tres.ledger.down_dense


def test_dp_flasc_experiment_at_zero_noise_matches_reference(task_model,
                                                             monkeypatch):
    jres, tres, flats = _experiments(
        task_model, monkeypatch,
        dict(kind="flasc", selector="fused", sparse_aggregate=True),
        fed_kw=dict(dp_clip=0.05, dp_noise=0.0))
    _same_run(jres, tres, flats, "dp flasc")
    assert tres.final_acc == jres.final_acc


def test_full_finetune_experiment_matches_reference(task_model, monkeypatch):
    """Every backbone leaf trains (dense LoRA kind over the backbone); the
    port evaluates the trained backbone, the reference the pretrained one
    (`Experiment.run` hands `evaluate` its frozen params), so the port's
    accuracy is held to the reference's `evaluate` of the reference's
    trained backbone.  FedAdam at eps 1e-4: most backbone pseudo-gradients
    are cancellations of 4 clients' deltas near 1e-5, where at eps 1e-5
    Adam's g / (|g| + eps) turns their 1e-8 rounding difference into 1.4e-6
    of an update (`tests/_fed_parity.py` has the same reason for 1e-5)."""
    tm = task_model
    jres, tres, flats = _experiments(tm, monkeypatch, dict(kind="lora"),
                                     fed_kw=dict(adam_eps=1e-4),
                                     full_finetune=True)
    n_params = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(
        tm["params"]))
    assert tres.ledger.total_params == jres.ledger.total_params == n_params
    _same_run(jres, tres, flats, "full finetune")
    jtrain = {"lora": {}, "head": {}, "backbone": tm["params"]}
    jmeta = jfr.FlatMeta.of(jtrain)
    trained = jmeta.unflatten(jnp.asarray(flats["j"][-1]))["backbone"]
    want = jrt.evaluate(trained, tm["cfg"], jtrain, jmeta, tm["jt"], 1.0,
                        jnp.asarray(flats["j"][-1]))
    assert tres.final_acc == want
    tmeta = tfr.FlatMeta.of({"lora": {}, "head": {},
                             "backbone": tm["tparams"]})
    assert tmeta.p_len == n_params
    np.testing.assert_array_equal(tmeta.is_b, np.ones(n_params, np.int8))
