"""The port's task path against the reference, on the CPU, at a small f32
size: the synthetic federated tasks, the ViT / GPT task models, central
pretraining, evaluation and whole `Experiment(task)` runs.  Weights cross
from the reference through `checkpoint/io.py::tree_from_numpy`.

Bitwise: every array of the four tasks, both partitions,
`label_heterogeneity`, `sample_round` and `eval_batches` (the port's numpy
copy must draw the same numbers), and the task model configs.

To tolerance (`_close`: rtol 1e-5, atol 1e-6 in units of the larger of 1
and the tensor's largest magnitude; the two packages' CPU matmuls, softmax
and logsumexp round in other places, and an LM logit near 0 is a sum of
terms of the row's scale: 1.6e-6 apart at logits up to 3):
  - forward logits, loss and the LoRA + head gradient;
  - `pretrain`, 3 Adam steps on every backbone leaf at lr 1e-4: each leaf
    and the loss.  Adam divides each step by |g|, so a gradient element
    near 0 turns its rounding difference into up to lr of the update (at
    the default lr 1e-3 one element of 4096 lands 1.06e-6 outside); a
    wrong gradient still moves a leaf by lr;
  - `evaluate`: equal predictions, except where the reference's top-2
    logit gap is below 1e-4 (each such case is printed);
  - three whole FLASC rounds (`fused` selector, no quantization: no random
    draws) from the same converted backbone and the same injected initial
    LoRA vector (threefry and Philox differ): losses rtol 1e-5,
    accuracies equal under the same near-tie rule, final flatP atol 1e-6,
    equal ledger bytes where the upload masks agree.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import fedround as jfr
from repro.core import strategies as jst
from repro.data import datasets as jds
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.federated import api as japi
from repro.federated import runtime as jrt
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro.models.config import LoRAConfig as JLoRAConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.configs import paper_models as tpm
from repro_torch.core import fedround as tfr
from repro_torch.core import strategies as tst
from repro_torch.data import datasets as tds
from repro_torch.data import partition as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.federated import Experiment
from repro_torch.federated import api as tapi
from repro_torch.federated import runtime as trt
from repro_torch.models import layers as TL
from repro_torch.models import lora as tlora
from repro_torch.models import model as TM
from repro_torch.models.config import FederatedConfig, LoRAConfig, ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GAP_TOL = 1e-4
MODEL_KW = dict(d_model=32, num_layers=2, num_heads=4, d_ff=64)
LCFG = dict(rank=4, alpha=8.0)

# small task sizes (make_synth_text's Markov sampler is a Python loop); the
# ViT task model takes the patch embeddings as they are, so dim = d_model
TASK_KW = {
    "synth_image": dict(n_examples=128, n_clients=8, n_patches=6, dim=32,
                        n_eval=128, seed=3),
    "synth_flair": dict(n_users=12, examples_per_user=(4, 10), n_patches=6,
                        dim=32, n_eval=128, seed=4),
    "synth_text": dict(n_examples=96, n_clients=6, vocab=64, length=10,
                       n_eval=128, seed=5),
    "synth_reddit": dict(n_users=12, examples_per_user=(3, 8), vocab=64,
                         length=10, n_eval=128, seed=6),
}
KIND_TASK = {"embeds_cls": "synth_image", "tokens_cls": "synth_text",
             "tokens_lm": "synth_reddit"}


@pytest.fixture(scope="module")
def tasks():
    """Each task built by both packages."""
    return {name: (jds.TASKS[name](**kw), tds.TASKS[name](**kw))
            for name, kw in TASK_KW.items()}


def _same_task(jt, tt):
    assert (tt.name, tt.kind, tt.n_classes) == (jt.name, jt.kind, jt.n_classes)
    assert len(tt.parts) == len(jt.parts)
    for a, b in zip(tt.parts, jt.parts):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for split in ("data", "eval_data"):
        jd, td = getattr(jt, split), getattr(tt, split)
        assert sorted(td) == sorted(jd)
        for k in jd:
            assert td[k].dtype == jd[k].dtype and td[k].shape == jd[k].shape
            np.testing.assert_array_equal(td[k], jd[k])


@pytest.mark.parametrize("name", sorted(TASK_KW))
def test_task_arrays_are_bitwise_the_reference(tasks, name):
    _same_task(*tasks[name])


def test_partitions_and_heterogeneity_are_bitwise_the_reference():
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 5, 200).astype(np.int32)
    for alpha, n in ((0.1, 12), (1.0, 5), (0.01, 30)):
        jp = jpart.dirichlet_partition(labels, n, alpha, seed=2)
        tp_ = tpart.dirichlet_partition(labels, n, alpha, seed=2)
        assert len(tp_) == len(jp)
        for a, b in zip(tp_, jp):
            np.testing.assert_array_equal(a, b)
        assert tpart.label_heterogeneity(tp_, labels) == \
            jpart.label_heterogeneity(jp, labels)
    users = rng.integers(0, 9, 100)
    for a, b in zip(tpart.natural_partition(users),
                    jpart.natural_partition(users)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TASK_KW))
def test_sample_round_and_eval_batches_are_bitwise_the_reference(tasks, name):
    jt, tt = tasks[name]
    kw = dict(n_clients=4, local_steps=2, local_batch=3)
    for r in range(3):
        jb = jpipe.sample_round(jt, JFederatedConfig(**kw), r, seed=11)
        tb = tpipe.sample_round(tt, FederatedConfig(**kw), r, seed=11)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].shape[:3] == (4, 2, 3)
            np.testing.assert_array_equal(tb[k], jb[k])
    for bs in (128, 50):
        jbs, tbs = list(jpipe.eval_batches(jt, bs)), \
            list(tpipe.eval_batches(tt, bs))
        assert len(tbs) == len(jbs) >= 1
        for a, b in zip(tbs, jbs):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_task_configs_match_the_reference(tasks):
    for kind, name in KIND_TASK.items():
        jt, tt = tasks[name]
        for kw in ({}, MODEL_KW):
            jc = jrt.model_for_task(jt, **kw)
            tc = trt.model_for_task(tt, **kw)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), kind
    for name in ("VIT_B16", "GPT2_SMALL", "VIT_TINY", "GPT_TINY"):
        jc, tc = getattr(jpm, name), getattr(tpm, name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert TM.count_params(tc) == jc.param_count()


# ---------------------------------------------------------------------------
# the task models: forward, loss, gradient, pretrain, evaluate
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol,
                               err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models(name, seed=0):
    """The reference's model for task `name` on random weights (numpy-drawn
    nonzero LoRA `b`, a perturbed final norm), its trainable tree as
    `Experiment` builds it, and the port's conversions.  Shared by the
    tests, which do not modify it."""
    cfg = jrt.model_for_task(jds.TASKS[name](**TASK_KW[name]), **MODEL_KW)
    params = _np(jax.jit(lambda k: JL.init_params(JM.model_spec(cfg), k))(
        jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    params["final_norm"] = (params["final_norm"] + rng.standard_normal(
        params["final_norm"].shape).astype(np.float32) * np.float32(0.1))
    spec = jlora.lora_spec(cfg, JLoRAConfig(**LCFG))
    lora = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, dtype=np.float32)
                   * np.float32(0.1)), spec,
        is_leaf=lambda x: isinstance(x, JL.P))
    trainable = {"lora": lora}
    if cfg.num_classes > 0:
        trainable["head"] = {"cls_head": params["cls_head"],
                             "final_norm": params["final_norm"]}
    return {"cfg": cfg, "params": params, "trainable": trainable,
            "tcfg": ModelConfig(**dataclasses.asdict(cfg)),
            "tparams": tree_from_numpy(params, device="cpu"),
            "ttrainable": tree_from_numpy(trainable, device="cpu")}


def _batch(task, n=6):
    return {k: v[:n] for k, v in task.data.items()}


def _loss_of_tree(params, cfg, tree, batch, loss_fn, scale):
    p = dict(params)
    if "head" in tree:
        p.update(tree["head"])
    return loss_fn(p, cfg, batch, lora=tree["lora"], lora_scale=scale)


@pytest.mark.parametrize("kind", sorted(KIND_TASK))
def test_forward_loss_and_gradient_match_reference(tasks, kind):
    jt, tt = tasks[KIND_TASK[kind]]
    m = _models(KIND_TASK[kind])
    cfg, tcfg = m["cfg"], m["tcfg"]
    scale = JLoRAConfig(**LCFG).scale
    batch = _batch(jt)
    tbatch = {k: _t(v) for k, v in batch.items()}

    jout = JM.forward({**m["params"], **m["trainable"].get("head", {})}, cfg,
                      batch, lora=m["trainable"]["lora"], lora_scale=scale)
    tout = TM.forward({**m["tparams"], **m["ttrainable"].get("head", {})},
                      tcfg, tbatch, lora=m["ttrainable"]["lora"],
                      lora_scale=scale)
    _close(tout["logits"].numpy(), jout["logits"])

    jmeta = jfr.FlatMeta.of(m["trainable"])
    jflat = jmeta.flatten(m["trainable"])
    want_l, want_g = jax.value_and_grad(lambda f: _loss_of_tree(
        m["params"], cfg, jmeta.unflatten(f), batch, JM.loss_fn, scale))(jflat)
    tmeta = tfr.FlatMeta.of(m["ttrainable"])
    assert tmeta.p_len == jmeta.p_len
    flat = tmeta.flatten(m["ttrainable"]).requires_grad_(True)
    np.testing.assert_array_equal(flat.detach().numpy(), np.asarray(jflat))
    loss = _loss_of_tree(m["tparams"], tcfg, tmeta.unflatten(flat), tbatch,
                         TM.loss_fn, scale)
    (g,) = torch.autograd.grad(loss, flat)
    _close(loss.item(), float(want_l))
    _close(g.numpy(), want_g)
    if cfg.num_classes > 0:   # the head's gradient is in the flat vector
        assert np.abs(np.asarray(want_g)[-cfg.d_model:]).max() > 0


@pytest.mark.parametrize("kind", ["embeds_cls", "tokens_cls"])
def test_classifiers_attend_both_ways(tasks, kind):
    """A classifier's first position sees the last one (no causal mask);
    its logits follow the reference's on both inputs; an LM's does not."""
    jt, _ = tasks[KIND_TASK[kind]]
    m = _models(KIND_TASK[kind])
    batch = _batch(jt, 2)
    other = dict(batch)
    key = "embeds" if "embeds" in batch else "tokens"
    v = batch[key].copy()
    if key == "embeds":
        v[:, -1] += np.float32(1.0)
    else:
        v[:, -1] = (v[:, -1] + 1) % m["cfg"].vocab_size
    other[key] = v
    h = {}
    for name, b in (("a", batch), ("b", other)):
        out = TM.forward(m["tparams"], m["tcfg"],
                         {k: _t(x) for k, x in b.items()})
        h[name] = out["hidden"]
        want = JM.forward(m["params"], m["cfg"], b)["logits"]
        _close(out["logits"].numpy(), want)
    assert (h["a"][:, 0] - h["b"][:, 0]).abs().max() > 1e-4
    lm = _models("synth_reddit")
    toks = _batch(tasks["synth_reddit"][0], 2)["tokens"]
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % lm["cfg"].vocab_size
    ha = TM.forward(lm["tparams"], lm["tcfg"], {"tokens": _t(toks)})["hidden"]
    hb = TM.forward(lm["tparams"], lm["tcfg"], {"tokens": _t(toks2)})["hidden"]
    assert torch.equal(ha[:, :-1], hb[:, :-1])


def test_serving_still_refuses_the_task_models(tasks):
    # the reference's engine refuses classifier heads and embedding inputs,
    # not learned positions: the GPT LM prefills (its last logits the
    # reference forward's), the ViT is refused by name
    m = _models("synth_reddit")
    toks = _batch(tasks["synth_reddit"][0], 1)["tokens"]
    with torch.no_grad():
        logits, _ = TM.prefill(m["tparams"], m["tcfg"], {"tokens": _t(toks)})
    want = JM.forward(m["params"], m["cfg"], {"tokens": toks})["logits"]
    _close(logits.numpy(), np.asarray(want)[:, -1:])
    with pytest.raises(NotImplementedError, match="classifier head"):
        TM.decode_step({}, tpm.VIT_TINY, _t(toks)[:, 0], torch.tensor(0), {})


@pytest.mark.parametrize("kind", sorted(KIND_TASK))
def test_pretrain_matches_reference(tasks, kind):
    jt, tt = tasks[KIND_TASK[kind]]
    m = _models(KIND_TASK[kind])
    kw = dict(steps=3, lr=1e-4, batch_size=8, seed=9)
    jparams, jloss = jrt.pretrain(m["params"], m["cfg"], jt, **kw)
    tparams, tloss = trt.pretrain(m["tparams"], m["tcfg"], tt, **kw)
    _close(tloss, jloss)
    flat_j = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    assert len(flat_j) == len(list(TL.tree_leaves(tparams)))
    for path, want in flat_j:
        got = tparams
        for k in path:
            got = got[k.key]
        _close(got.numpy(), want, jax.tree_util.keystr(path))
    same, loss0 = trt.pretrain(m["tparams"], m["tcfg"], tt, steps=0)
    assert same is m["tparams"] and loss0 is None


def _near_tie_preds(jlogits, tlogits, what):
    """Equal argmax, except where the reference's top-2 gap < GAP_TOL;
    returns the number of allowed disagreements."""
    jp, tp_ = np.argmax(jlogits, -1), np.argmax(tlogits, -1)
    top2 = np.sort(jlogits, -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    bad = jp != tp_
    for i in zip(*np.nonzero(bad)):
        print(f"{what}: near tie at {i}, reference gap {gap[i]:.3e}")
    assert (gap[bad] < GAP_TOL).all(), gap[bad]
    return int(bad.sum())


@pytest.mark.parametrize("kind", sorted(KIND_TASK))
def test_evaluate_matches_reference(tasks, kind):
    jt, tt = tasks[KIND_TASK[kind]]
    m = _models(KIND_TASK[kind])
    scale = JLoRAConfig(**LCFG).scale
    jmeta = jfr.FlatMeta.of(m["trainable"])
    jflat = jmeta.flatten(m["trainable"])
    tmeta = tfr.FlatMeta.of(m["ttrainable"])
    tflat = _t(jflat)
    jacc = jrt.evaluate(m["params"], m["cfg"], m["trainable"], jmeta, jt,
                        scale, jflat)
    tacc = trt.evaluate(m["tparams"], m["tcfg"], m["ttrainable"], tmeta, tt,
                        scale, tflat)
    ties = 0
    for batch in jpipe.eval_batches(jt):
        jtree = jmeta.unflatten(jflat)
        p = dict(m["params"])
        p.update(jtree.get("head", {}))
        jl = np.asarray(JM.forward(p, m["cfg"], batch, lora=jtree["lora"],
                                   lora_scale=scale)["logits"])
        tl = trt.eval_logits(m["tparams"], m["tcfg"], tmeta, scale, tflat,
                             {k: _t(v) for k, v in batch.items()}).numpy()
        if m["cfg"].num_classes == 0:
            jl, tl = jl[..., :-1, :], tl[..., :-1, :]
        ties += _near_tie_preds(jl, tl, kind)
    n = sum(int(np.prod(b["labels"].shape if "labels" in b else
                        b["tokens"][..., 1:].shape))
            for b in jpipe.eval_batches(jt))
    assert abs(tacc - jacc) * n <= ties + 1e-9, (tacc, jacc, ties)
    assert 0.0 <= tacc <= 1.0


# ---------------------------------------------------------------------------
# whole experiments
# ---------------------------------------------------------------------------

class _JaxCapture(jst.Flasc):
    kept: list

    def aggregate(self, deltas, ctx):
        jax.debug.callback(lambda d: self.kept.append(np.asarray(d)), deltas)
        return super().aggregate(deltas, ctx)


class _TorchCapture(tst.Flasc):
    kept: list

    def aggregate(self, deltas, ctx):
        self.kept.append(deltas.numpy().copy())
        return super().aggregate(deltas, ctx)


@pytest.mark.parametrize("kind", ["embeds_cls", "tokens_lm"])
def test_experiment_matches_reference(tasks, kind, monkeypatch):
    jt, tt = tasks[KIND_TASK[kind]]
    m = _models(KIND_TASK[kind])
    lora0 = m["trainable"]["lora"]
    monkeypatch.setattr(jlora, "init_lora",
                        lambda *a, **k: jax.tree.map(jnp.asarray, lora0))
    monkeypatch.setattr(tlora, "init_lora",
                        lambda *a, **k: tree_from_numpy(lora0, device="cpu"))
    spec_kw = dict(kind="flasc", selector="fused", density_down=0.25,
                   density_up=0.25)
    jstrat = _JaxCapture(jst.StrategySpec(**spec_kw))
    tstrat = _TorchCapture(tst.StrategySpec(**spec_kw))
    jstrat.kept, tstrat.kept = [], []
    fed = dict(n_clients=4, local_batch=4, local_steps=2, client_lr=5e-2,
               server_lr=5e-3)
    train = dict(rounds=3, eval_every=1, seed=5)
    jres = (japi.Experiment(jt, strategy=jstrat,
                            federation=JFederatedConfig(**fed))
            .with_lora(**LCFG).with_training(**train)
            .with_params(jax.tree.map(jnp.asarray, m["params"]), m["cfg"]))
    tres = (Experiment(tt, strategy=tstrat, federation=FederatedConfig(**fed),
                       device="cpu")
            .with_lora(**LCFG).with_training(**train)
            .with_params(m["tparams"], m["tcfg"]))
    flats = {"j": [], "t": []}

    for exp, tag in ((jres, "j"), (tres, "t")):
        class Keep(japi.eng.Callback if tag == "j" else tapi.eng.Callback):
            def on_round_end(self, ev, _tag=tag):
                flats[_tag].append(np.array(ev.state.flatP))
        exp.with_callbacks(Keep())
    jres, tres = jres.run(), tres.run()
    scale = JLoRAConfig(**LCFG).scale
    jmeta = jfr.FlatMeta.of(m["trainable"])
    tmeta = tfr.FlatMeta.of(m["ttrainable"])

    assert len(tres.history) == len(jres.history) == 3
    for r, (jh, th) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL)
        assert np.isfinite(th["loss"]) and 0.0 <= th["acc"] <= 1.0
        jm, tm_ = jstrat.kept[r] != 0, tstrat.kept[r] != 0
        overlap = float((jm == tm_).mean())
        print(f"{kind} round {r}: loss {th['loss']:.6f}, acc {th['acc']:.4f}"
              f" (reference {jh['acc']:.4f}), upload-mask overlap "
              f"{overlap:.6f}")
        assert overlap >= 0.999
        if overlap == 1.0:
            for key in ("down_bytes", "up_bytes", "coded_bytes",
                        "up_coded_bytes"):
                assert th[key] == jh[key], (r, key)
        if th["acc"] != jh["acc"]:
            # only near ties of the reference's logits may differ
            ties, n = 0, 0
            for batch in jpipe.eval_batches(jt):
                jtree = jmeta.unflatten(jnp.asarray(flats["j"][r]))
                p = dict(m["params"])
                p.update(jtree.get("head", {}))
                jl = np.asarray(JM.forward(
                    p, m["cfg"], batch, lora=jtree["lora"],
                    lora_scale=scale)["logits"])
                tl = trt.eval_logits(
                    m["tparams"], m["tcfg"], tmeta, scale, _t(flats["t"][r]),
                    {k: _t(v) for k, v in batch.items()}).numpy()
                if m["cfg"].num_classes == 0:
                    jl, tl = jl[..., :-1, :], tl[..., :-1, :]
                ties += _near_tie_preds(jl, tl, f"{kind} round {r}")
                n += int(np.prod(jl.shape[:-1]))
            assert abs(th["acc"] - jh["acc"]) * n <= ties + 1e-9
    assert tres.final_acc == tres.history[-1]["acc"]
    np.testing.assert_allclose(flats["t"][-1], flats["j"][-1], atol=ATOL)


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, QUICK="1", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FLASC matches LoRA with" in proc.stdout, proc.stdout
    assert proc.stdout.count("acc=") >= 2, proc.stdout
