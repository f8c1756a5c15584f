"""The port's figure harnesses (`benchmarks_torch/`) against the reference's
(`benchmarks/`), on the CPU at the reference's tiny `MODEL_KW`.

Exact:
  - table1's rows;
  - every figure's `main` with `run` and `get_task` replaced by
    stand-ins in both packages: the same calls (task, strategy,
    federation, rank, rounds, engine configuration, training options) in
    the same order, and the same rows from the stand-in's results, so METHODS, the
    grids and the row names are the reference's;
  - fig3's `sim_time_to_target`, `posthoc_time_to_target` and `rel_row`,
    and fig6's `tiers`;
  - on real runs (2 rounds, eval every round) from the same backbone and
    the same initial LoRA vector: fig2's byte, `comm_vs_dense` and
    `coded_vs_dense` rows for `lora`, `flasc_d1/4` and `flocora_r8`, and
    fig3's `sim_time` and relative-time rows of one async run.

To tolerance, on those runs:
  - each round's loss, rtol 1e-5 (the packages' CPU matmuls and softmax
    round in other places; test_torch_task.py holds three rounds there);
  - accuracy rows within `ACC_TOL`, two eval examples of 512: an example
    whose top two logits are within the packages' rounding of each other
    may go either way.
  - fig7's DP federation at sigma 0 only (clipping, no noise: the noise
    streams cannot be ported).

fig3's async run and fig7's DP run use fig2's image task and backbone, so
the file compiles one reference backbone.

The backbone is the reference's own, pretrained `PRETRAIN_STEPS` steps
by its `pretrained_backbone` and carried into the port through
`checkpoint/io.py::tree_from_numpy`; the port's `init_lora` returns the
reference's draw for the same seed, and flocora's random projection is
the reference's Q (threefry and Philox differ).  Pretraining itself is
compared at ViT-B/16's width (d 768, 12 heads, d_ff 3072) at 1 layer and
4 patches, at `PAPER_PRETRAIN`'s lr, in its dtype (bf16) and in f32: the
two loss curves step by step.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import hashlib
import json
import types

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jc
from benchmarks import fig2_comm_efficiency as jf2
from benchmarks import fig3_async_bandwidth as jf3
from benchmarks import fig4_freezing as jf4
from benchmarks import fig5_heterogeneity as jf5
from benchmarks import fig6_system_het as jf6
from benchmarks import fig7_privacy as jf7
from benchmarks import table1_partitions as jt1
from benchmarks_torch import common as tc
from benchmarks_torch import fig2_comm_efficiency as tf2
from benchmarks_torch import fig3_async_bandwidth as tf3
from benchmarks_torch import fig4_freezing as tf4
from benchmarks_torch import fig5_heterogeneity as tf5
from benchmarks_torch import fig6_system_het as tf6
from benchmarks_torch import fig7_privacy as tf7
from benchmarks_torch import table1_partitions as tt1
from repro.configs import paper_models as jpm
from repro.core import transport as jtp
from repro.data import datasets as jds
from repro.federated import runtime as jrt
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import transport as ttp
from repro_torch.data import datasets as tds
from repro_torch.federated import runtime as trt
from repro_torch.models import layers as TL
from repro_torch.models import lora as tlora
from repro_torch.models.config import ModelConfig

ROUNDS = 2
PRETRAIN_STEPS = 5
RTOL = 1e-5
ACC_TOL = 2 / 512
BYTE_METRICS = ("total_MB", "coded_MB", "comm_vs_dense", "coded_vs_dense")
ACC_METRICS = ("best_acc", "final_acc")
FIG2_METHODS = ("lora", "flasc_d1/4", "flocora_r8")
PAIRS = {"fig2": (jf2, tf2), "fig3": (jf3, tf3), "fig4": (jf4, tf4),
         "fig5": (jf5, tf5), "fig6": (jf6, tf6), "fig7": (jf7, tf7)}


def _by_key(rows):
    out = {}
    for r in rows:
        key = (r["figure"], r["setting"], r["metric"])
        assert key not in out, key
        out[key] = r["value"]
    return out


def test_table1_rows_equal_the_reference():
    want, got = jt1.main(), tt1.main()
    assert got == want
    assert len(got) == 19


# ---------------------------------------------------------------------------
# every figure's main through a stand-in `run`
# ---------------------------------------------------------------------------

class _Ledger:
    def __init__(self, h):
        self.total_bytes = 1000 + h % 9000
        self.total_coded_bytes = 500 + h % 7000

    def dense_equivalent_bytes(self, n):
        return 100 * n + 12_345


def _stand_in_task(name, alpha=0.1, seed=0):
    """`get_task` replaced: the task by its arguments (table1's test holds
    the real tasks' statistics to the reference's)."""
    return types.SimpleNamespace(name=name, alpha=alpha, seed=seed)


def _stand_in(calls):
    """`run` replaced: records its arguments (the engine by its `config()`)
    and returns a result whose accuracies, times and bytes are a function
    of them."""
    def run(task, spec, fed=None, rounds=None, lora_rank=16, seed=0,
            model_kw=None, pretrain_steps=None, full_finetune=False,
            engine=None, device=None, **train_kw):
        args = dict(task=vars(task), spec=dataclasses.asdict(spec),
                    fed=None if fed is None else dataclasses.asdict(fed),
                    rounds=rounds, lora_rank=lora_rank, seed=seed,
                    model_kw=model_kw, pretrain_steps=pretrain_steps,
                    full_finetune=full_finetune,
                    engine=None if engine is None else
                    (type(engine).__name__, engine.config()),
                    train_kw=train_kw)
        text = json.dumps(args, sort_keys=True, default=list)
        calls.append(text)
        h = int(hashlib.sha256(text.encode()).hexdigest()[:12], 16)
        history = [dict(acc=((h >> (4 * r)) % 97) / 100, sim_time=1.5 * r + 1,
                        down_bytes=100 * r + 100, up_bytes=50 * r + h % 13,
                        down_coded_bytes=90 * r + 90, up_coded_bytes=40 * r)
                   for r in range(4)]
        best = max(x["acc"] for x in history)
        return types.SimpleNamespace(history=history, ledger=_Ledger(h),
                                     final_acc=history[-1]["acc"],
                                     best_acc=lambda: best)
    return run


@pytest.mark.parametrize("fig", sorted(PAIRS))
def test_figure_main_makes_the_reference_calls_and_rows(fig, monkeypatch):
    jmod, tmod = PAIRS[fig]
    jcalls, tcalls = [], []
    for mod, calls in ((jmod, jcalls), (tmod, tcalls)):
        monkeypatch.setattr(mod, "run", _stand_in(calls))
        monkeypatch.setattr(mod, "get_task", _stand_in_task)
    want = jmod.main()
    got = tmod.main(device="cpu")
    assert tcalls == jcalls and len(tcalls) >= 11
    assert got == want


def test_grids_are_the_reference():
    for jmod, tmod in ((jf2, tf2), (jf3, tf3)):
        assert list(tmod.METHODS) == list(jmod.METHODS)
        for name, spec in jmod.METHODS.items():
            assert dataclasses.asdict(tmod.METHODS[name]) == \
                dataclasses.asdict(spec), name
    for name in ("DOWN_BW", "BW_RATIOS"):
        assert getattr(tf3, name) == getattr(jf3, name)
    assert tf4.DENSITIES == jf4.DENSITIES
    assert tf5.ALPHAS == jf5.ALPHAS
    assert tf6.RANK == jf6.RANK
    assert (tf7.SIGMAS, tf7.CLIP) == (jf7.SIGMAS, jf7.CLIP)
    for name in ("QUICK", "ENGINE", "MODEL_KW", "ROUNDS", "EVAL_EVERY"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert dataclasses.asdict(tc.default_fed(dp_clip=0.05)) == \
        dataclasses.asdict(jc.default_fed(dp_clip=0.05))


HISTORY = [dict(round=0, sim_time=1.0, down_bytes=10, up_bytes=20,
                down_coded_bytes=8, up_coded_bytes=15),
           dict(round=1, acc=0.2, sim_time=2.5, down_bytes=30, up_bytes=40,
                down_coded_bytes=25, up_coded_bytes=31),
           dict(round=2, acc=0.5, sim_time=7.0, down_bytes=50, up_bytes=90,
                down_coded_bytes=41, up_coded_bytes=77)]


@pytest.mark.parametrize("target", [0.0, 0.2, 0.3, 0.5, 0.9])
def test_fig3_time_to_target_is_the_reference(target):
    assert tf3.sim_time_to_target(HISTORY, target) == \
        jf3.sim_time_to_target(HISTORY, target)
    for ratio in (1, 4, 16):
        for coded in (False, True):
            assert tf3.posthoc_time_to_target(HISTORY, target, ratio, coded) \
                == jf3.posthoc_time_to_target(HISTORY, target, ratio, coded)
    for t, base in ((None, 2.0), (3.0, None), (None, None), (3.0, 2.0)):
        assert tf3.rel_row("fig3", "s", "m", t, base) == \
            jf3.rel_row("fig3", "s", "m", t, base)


def test_fig6_tiers_are_the_reference():
    for n, k in ((8, 2), (8, 4), (5, 3), (1, 4), (16, 16)):
        assert tf6.tiers(n, k) == jf6.tiers(n, k)


def test_harness_raises_where_the_port_has_no_path():
    with pytest.raises(NotImplementedError, match="item 8"):
        tc._engine_for("sharded")
    with pytest.raises(NotImplementedError, match="item 8"):
        tc._engine_for("sharded:4")
    with pytest.raises(ValueError, match="rounds_per_call"):
        tc._engine_for("sim:4")
    if not torch.cuda.is_available():
        # the harnesses run on the card by default and never fall back
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.run(tc.get_task("synth_image"), tf2.METHODS["lora"],
                   rounds=1)


def test_paper_configs():
    img = tds.make_synth_image(n_examples=64, n_clients=2, n_patches=4,
                               dim=768, n_eval=8)
    vit = tc.paper_config(img)
    assert (vit.d_model, vit.num_layers, vit.num_heads, vit.d_ff) == \
        (768, 12, 12, 3072)
    assert vit.param_dtype == tc.PAPER_PRETRAIN["param_dtype"]
    assert dataclasses.replace(vit, param_dtype="bfloat16") == \
        dataclasses.replace(ModelConfig(**dataclasses.asdict(jpm.VIT_B16)),
                            param_dtype="bfloat16")
    txt = tds.make_synth_text(n_examples=64, n_clients=2, vocab=16, length=4,
                              n_eval=4)
    gpt = tc.paper_config(txt)
    assert (gpt.d_model, gpt.num_layers, gpt.num_heads, gpt.d_ff,
            gpt.num_classes) == (768, 12, 12, 3072, txt.n_classes)
    assert tc.PAPER_KW == dict(d_model=768, num_layers=12, num_heads=12,
                               d_ff=3072)


# ---------------------------------------------------------------------------
# real runs from the same start
# ---------------------------------------------------------------------------

def _ref_init_lora(cfg, lcfg, seed=0, *, device=None, generator=None):
    """The reference's LoRA init for this seed, as the port's tensors."""
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jl = JLoRAConfig(**dataclasses.asdict(lcfg))
    tree = jlora.init_lora(jcfg, jl, jax.random.key(seed))
    return tree_from_numpy(jax.tree.map(np.asarray, tree), device=device)


def _ref_projection(self, cols, device):
    q = jtp.LowRankCompress(rank=self.rank, seed=self.seed,
                            fold=self.fold)._projection(cols)
    return torch.from_numpy(np.array(q)).to(device)


def _ref_backbone(task, model_kw, pretrain_steps, seed, device=None):
    """The reference harness's pretrained backbone for the task of the same
    name (bitwise the same arrays), converted."""
    jtask = jc.get_task(task.name)
    np.testing.assert_array_equal(jtask.eval_data[next(iter(
        jtask.eval_data))], task.eval_data[next(iter(task.eval_data))])
    params, cfg = jc.pretrained_backbone(jtask, model_kw, pretrain_steps,
                                         seed)
    return (tree_from_numpy(jax.tree.map(np.asarray, params), device=device),
            ModelConfig(**dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def same_start():
    """Both packages at 2 rounds, eval every round, from the reference's
    backbone (5 pretraining steps), LoRA init and flocora projection."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jc, tc):
            mp.setattr(mod, "ROUNDS", ROUNDS)
            mp.setattr(mod, "EVAL_EVERY", 1)
        jorig = jc.pretrained_backbone
        mp.setattr(jc, "pretrained_backbone",
                   lambda task, kw, steps, seed: jorig(task, kw,
                                                       PRETRAIN_STEPS, seed))
        mp.setattr(tc, "pretrained_backbone", _ref_backbone)
        mp.setattr(tlora, "init_lora", _ref_init_lora)
        mp.setattr(ttp.LowRankCompress, "_projection", _ref_projection)
        yield mp


def _recording(mod, results):
    orig = mod.run

    def run(*a, **k):
        res = orig(*a, **k)
        results.append(res)
        return res
    return run


def _runs(same_start, pair, main_kw, **patch):
    """Rows and results of the reference's and the port's `main`."""
    out = {}
    for tag, mod in zip(("j", "t"), pair):
        results = []
        with pytest.MonkeyPatch.context() as mp:
            for name, value in patch.items():
                mp.setattr(mod, name, value(mod))
            mp.setattr(mod, "run", _recording(mod, results))
            rows = mod.main(**main_kw, **({"device": "cpu"} if tag == "t"
                                          else {}))
        out[tag] = (_by_key(rows), results)
    return out


@pytest.fixture(scope="module")
def fig2_runs(same_start):
    return _runs(same_start, (jf2, tf2), dict(tasks=("synth_image",)),
                 METHODS=lambda m: {k: m.METHODS[k] for k in FIG2_METHODS})


def _same_losses(jres, tres):
    assert len(tres.history) == len(jres.history) == ROUNDS
    for jh, th in zip(jres.history, tres.history):
        assert np.isfinite(th["loss"])
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL)


@pytest.mark.parametrize("method", FIG2_METHODS)
def test_fig2_rows_match_the_reference(fig2_runs, method):
    (jrows, jres), (trows, tres) = fig2_runs["j"], fig2_runs["t"]
    assert sorted(trows) == sorted(jrows) and len(trows) == 6 * 3
    i = FIG2_METHODS.index(method)
    _same_losses(jres[i], tres[i])
    for metric in BYTE_METRICS:
        key = ("fig2", f"synth_image/{method}", metric)
        assert trows[key] == jrows[key], key
    for metric in ACC_METRICS:
        key = ("fig2", f"synth_image/{method}", metric)
        assert abs(trows[key] - jrows[key]) <= ACC_TOL, (key, trows[key],
                                                          jrows[key])
        assert 0.0 < trows[key] <= 1.0


def test_fig3_async_rows_match_the_reference(same_start):
    """fig3's main at one method and one ratio, on fig2's image task and
    backbone (its text task would add a backbone for no other path)."""
    runs = _runs(same_start, (jf3, tf3), {},
                 METHODS=lambda m: {"lora": m.METHODS["lora"]},
                 BW_RATIOS=lambda m: (4,),
                 get_task=lambda m: (lambda orig: lambda name: orig(
                     "synth_image"))(m.get_task))
    (jrows, jres), (trows, tres) = runs["j"], runs["t"]
    _same_losses(jres[0], tres[0])
    assert sorted(trows) == sorted(jrows)
    assert ("fig3", "up1/4/lora", "sim_time") in trows
    for key, want in jrows.items():
        if key[2] == "target_acc":
            assert abs(trows[key] - want) <= ACC_TOL
        else:
            assert trows[key] == want, key
    for jh, th in zip(jres[0].history, tres[0].history):
        assert th["sim_time"] == jh["sim_time"]


def test_fig7_dp_at_sigma_0_matches_the_reference(same_start):
    """fig7's flasc_d1/2 under its DP federation at sigma 0 (clipping at
    CLIP, FedAdam at 2e-2), on fig2's image task and backbone.  FedAdam at
    `adam_eps` 1e-5, as tests/_fed_parity.py says why: a clipped mean whose
    clients cancel is near 0, and Adam's first step g / (|g| + 1e-8) turns
    the packages' rounding of it into up to lr (2e-2) of its update."""
    res = {}
    for tag, fig in (("j", jf7), ("t", tf7)):
        fed = fig.default_fed(dp_clip=fig.CLIP, dp_noise=0.0, server_lr=2e-2,
                              adam_eps=1e-5)
        kw = {"device": "cpu"} if tag == "t" else {}
        res[tag] = fig.run(fig.get_task("synth_image"),
                           fig.StrategySpec(kind="flasc", density_down=0.5,
                                            density_up=0.5), fed=fed, **kw)
    _same_losses(res["j"], res["t"])
    assert res["t"].ledger.total_bytes == res["j"].ledger.total_bytes
    assert res["t"].ledger.total_coded_bytes == \
        res["j"].ledger.total_coded_bytes
    assert abs(res["t"].best_acc() - res["j"].best_acc()) <= ACC_TOL


# ---------------------------------------------------------------------------
# pretraining at ViT-B/16's width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", [("bfloat16", 2 ** -8),
                                        ("float32", 1e-5)])
def test_pretraining_at_vit_b16_width_matches_the_reference(dtype, rtol):
    """`PAPER_PRETRAIN`'s lr, 1 layer of ViT-B/16 on 4 patches of 768,
    batch 8: the loss after each of 5 steps within `rtol`.  `pretrain`
    draws a run's batches up front from its seed, so a run of s steps is
    the first s steps of a longer one and returns step s's loss.  bf16
    (the setting's dtype) to one bf16 unit (2^-8) of relative rounding:
    the two packages round the bf16 matmuls' sums in other places (1.3e-3
    seen); f32 to 1e-5, and every final leaf within lr + 1e-5 (Adam's
    division by |g| turns a near-zero element's rounding into up to lr of
    its step)."""
    assert tc.PAPER_PRETRAIN["param_dtype"] in ("bfloat16", "float32")
    kw = dict(n_examples=64, n_clients=4, n_patches=4, dim=768, n_eval=8,
              seed=2)
    jtask, ttask = jds.make_synth_image(**kw), tds.make_synth_image(**kw)
    cfg = dataclasses.replace(jpm.VIT_B16, num_layers=1, param_dtype=dtype)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(JM.model_spec(cfg), k))(jax.random.key(4)))
    tparams0 = tree_from_numpy(params, device="cpu")
    opts = dict(lr=tc.PAPER_PRETRAIN["lr"], batch_size=8, seed=1)
    curves = {"j": [], "t": []}
    for steps in range(1, 6):
        jparams, jloss = jrt.pretrain(params, cfg, jtask, steps, **opts)
        tparams, tloss = trt.pretrain(tparams0, tcfg, ttask, steps, **opts)
        curves["j"].append(jloss)
        curves["t"].append(tloss)
    np.testing.assert_allclose(curves["t"], curves["j"], rtol=rtol)
    assert curves["t"][-1] < 0.5 * curves["t"][0]
    if dtype != "float32":
        return
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    assert len(flat_j) == len(list(TL.tree_leaves(tparams)))
    for path, want in flat_j:
        got = tparams
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 + opts["lr"], rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
