"""The port's federated round against the reference, on the CPU, at a small
f32 size with weights converted from the reference
(`checkpoint/io.py::tree_from_numpy`).

Bitwise: the flat-vector layout (`FlatMeta`, rank map) and the round-0
download mask, which both packages compute from the identical `flatP`.

To tolerance, each stated where it is checked:
  - `loss_fn` and the LoRA gradient: rtol 1e-5, atol 1e-6 (the two
    packages' CPU matmuls, softmax and logsumexp round in other places);
  - `adam_update`: rtol 1e-6 (`pow` and `sqrt` of two libraries);
  - two whole FLASC rounds (`fused` selector, no quantization: no random
    draws) through the reference's `SimEngine` and the port's, from the
    same converted `RunState` and batches: losses rtol 1e-5, final `flatP`
    atol 1e-6, upload-mask overlap >= 0.999, and equal ledger bytes where
    the masks agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import fedround as jfr
from repro.core import selectors as jsel
from repro.core import strategies as jst
from repro.federated import engine as jeng
from repro.models import layers as JL
from repro.models import lora as jlora
from repro.models import model as JM
from repro.models.config import FederatedConfig as JFederatedConfig
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adam_init as j_adam_init
from repro.optim import adam_update as j_adam_update
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import fedround as tfr
from repro_torch.core import selectors as tsel
from repro_torch.core import sparsity as tsp
from repro_torch.core import strategies as tst
from repro_torch.federated import Experiment
from repro_torch.federated import engine as teng
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import FederatedConfig, LoRAConfig, ModelConfig
from repro_torch.optim import adam_init, adam_update

CFG = JModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
LCFG = JLoRAConfig(rank=4, alpha=8.0)
FED = dict(n_clients=4, local_batch=4, local_steps=1, client_lr=5e-2,
           server_lr=2e-3)
SEQ = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """Reference backbone and a LoRA tree with nonzero `b` (numpy draws),
    plus their port conversions."""
    params = _np(jax.jit(lambda k: JL.init_params(JM.model_spec(CFG), k))(
        jax.random.key(0)))
    rng = np.random.default_rng(1)
    spec = jlora.lora_spec(CFG, LCFG)
    lora = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, dtype=np.float32)
                   * np.float32(0.1)), spec,
        is_leaf=lambda x: isinstance(x, JL.P))
    return {"params": params, "lora": lora,
            "tparams": tree_from_numpy(params, device="cpu"),
            "tlora": tree_from_numpy(lora, device="cpu"),
            "tcfg": ModelConfig(**dataclasses.asdict(CFG))}


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def test_flat_meta_matches_reference(model):
    jmeta = jfr.FlatMeta.of({"lora": model["lora"]})
    tmeta = tfr.FlatMeta.of({"lora": model["tlora"]})
    assert tmeta.p_len == jmeta.p_len == 2 * (64 * 4 + 4 * 64 + 2 * (
        64 * 4 + 4 * 32) + 64 * 4 + 4 * 64)
    jflat = np.asarray(jmeta.flatten({"lora": model["lora"]}))
    tflat = tmeta.flatten({"lora": model["tlora"]})
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    np.testing.assert_array_equal(tmeta.rank_idx, jmeta.rank_idx)
    np.testing.assert_array_equal(tmeta.is_b, jmeta.is_b)
    back = tmeta.unflatten(tflat)
    for path in tmeta.paths:
        a, b = back, model["tlora"]
        for k in (path[1:] if path[0] == "lora" else path):
            a, b = a[k] if k in a else a["lora"][k], b[k]
        assert torch.equal(a, b), path


# a long-prompt cut of CFG: 64 tokens take chunked_attention (chunks of 16,
# the reference's fori_loop branch) under the reference's remat-scanned
# layers and the port's recomputed blocks
LONG_CFG = dataclasses.replace(CFG, chunked_attn_threshold=32,
                               attn_chunk_q=16, attn_chunk_kv=16)


@pytest.mark.parametrize("chunk,cfg,seq", [
    pytest.param(1024, CFG, SEQ, id="1024"),
    pytest.param(16, CFG, SEQ, id="16"),
    pytest.param(16, LONG_CFG, 64, id="long")])
def test_loss_and_lora_gradient_match_reference(model, chunk, cfg, seq):
    """rtol 1e-5, atol 1e-6; chunk=16 takes the chunked-vocab branch (the
    reference's remat scan, the port's checkpointed loop); "long" takes
    the long-prompt attention, chunked_attention, at S 64."""
    tokens = _tokens(2, 3, seq)
    mask = (np.random.default_rng(3).random((3, seq)) < 0.8).astype(np.int32)
    batch = {"tokens": tokens, "loss_mask": mask}
    jmeta = jfr.FlatMeta.of(model["lora"])
    jflat = jmeta.flatten(model["lora"])

    def jloss(flat):
        return JM.loss_fn(model["params"], cfg, batch,
                          lora=jmeta.unflatten(flat), lora_scale=LCFG.scale,
                          loss_chunk=chunk)

    want_l, want_g = jax.value_and_grad(jloss)(jflat)
    tmeta = tfr.FlatMeta.of(model["tlora"])
    flat = tmeta.flatten(model["tlora"]).requires_grad_(True)
    loss = TM.loss_fn(model["tparams"], ModelConfig(**dataclasses.asdict(cfg)),
                      {k: _t(v) for k, v in batch.items()},
                      lora=tmeta.unflatten(flat), lora_scale=LCFG.scale,
                      loss_chunk=chunk)
    (g,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


def test_adam_update_matches_reference():
    rng = np.random.default_rng(4)
    p = rng.standard_normal(1000, dtype=np.float32)
    jstate, tstate = j_adam_init(jnp.asarray(p)), adam_init(_t(p))
    jp, tp_ = jnp.asarray(p), _t(p)
    for step in range(3):
        g = rng.standard_normal(1000, dtype=np.float32) * np.float32(
            10.0 ** -step)
        jp, jstate = j_adam_update(jp, jnp.asarray(g), jstate, 2e-3)
        tp_, tstate = adam_update(tp_, _t(g), tstate, 2e-3)
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), rtol=1e-6)
        np.testing.assert_allclose(tstate["v"].numpy(),
                                   np.asarray(jstate["v"]), rtol=1e-6)
    assert int(tstate["count"]) == int(jstate["count"]) == 3


def test_sgd_global_norm_and_split_batch_match_reference():
    """SGD with and without momentum, rtol 1e-6; `global_norm`, rtol 1e-6
    (two libraries' sums); `FederatedConfig.split_batch` equal."""
    from repro.optim import global_norm as j_global_norm
    from repro.optim import sgd_init as j_sgd_init
    from repro.optim import sgd_update as j_sgd_update
    from repro_torch.optim import global_norm, sgd_init, sgd_update
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal(300, dtype=np.float32),
         "b": {"c": rng.standard_normal((4, 5), dtype=np.float32)}}
    g = jax.tree.map(lambda v: rng.standard_normal(v.shape, dtype=np.float32),
                     p)
    tp_, tg = jax.tree.map(_t, p), jax.tree.map(_t, g)
    for mom in (0.0, 0.9):
        jp, js = jax.tree.map(jnp.asarray, p), j_sgd_init(p)
        ts, tcur = sgd_init(tp_), tp_
        for _ in range(2):
            jp, js = j_sgd_update(jp, g, js, 5e-2, mom)
            tcur, ts = sgd_update(tcur, tg, ts, 5e-2, mom)
        np.testing.assert_allclose(tcur["b"]["c"].numpy(),
                                   np.asarray(jp["b"]["c"]), rtol=1e-6)
        np.testing.assert_allclose(tcur["a"].numpy(), np.asarray(jp["a"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(j_global_norm(g)), rtol=1e-6)
    for fed_kw, gb in ((FED, 16), (FED, 8), (dict(n_clients=16,
                                                   local_batch=16), 64)):
        assert FederatedConfig(**fed_kw).split_batch(gb) == \
            JFederatedConfig(**fed_kw).split_batch(gb)


class _JaxCapture(jst.Flasc):
    """The reference's flasc, keeping each round's upload messages."""
    kept: list

    def aggregate(self, deltas, ctx):
        jax.debug.callback(lambda d: self.kept.append(np.asarray(d)), deltas)
        return super().aggregate(deltas, ctx)


class _TorchCapture(tst.Flasc):
    kept: list

    def aggregate(self, deltas, ctx):
        self.kept.append(deltas.numpy().copy())
        return super().aggregate(deltas, ctx)


def test_two_flasc_rounds_match_reference_sim_engine(model):
    """Two rounds, fused selector, no quantization, 4 clients."""
    spec_kw = dict(kind="flasc", selector="fused", density_down=0.25,
                   density_up=0.25)
    jstrat = _JaxCapture(jst.StrategySpec(**spec_kw))
    tstrat = _TorchCapture(tst.StrategySpec(**spec_kw))
    jstrat.kept, tstrat.kept = [], []
    batches = [{"tokens": _tokens(10 + r, 4, 1, 4, SEQ)} for r in range(2)]

    jmeta = jfr.FlatMeta.of({"lora": model["lora"]})
    jtask = jeng.RoundTask(
        lambda bb, tree, mb: JM.loss_fn(bb, CFG, mb, lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        jmeta, JFederatedConfig(**FED), jstrat, seed=0,
        params=model["params"])
    jstate = jeng.RunState.fresh(jtask, jmeta.flatten({"lora": model["lora"]}),
                                 rounds=2)
    jflat0 = np.asarray(jstate.flatP)
    jled = jeng.LedgerCallback(jcomm.CommLedger(total_params=jmeta.p_len))
    jstate = jeng.SimEngine().run_rounds(
        jstate, lambda r: jax.tree.map(jnp.asarray, batches[r]), [jled])

    tmeta = tfr.FlatMeta.of({"lora": model["tlora"]})
    ttask = teng.RoundTask(
        lambda bb, tree, mb: TM.loss_fn(bb, model["tcfg"], mb,
                                        lora=tree["lora"],
                                        lora_scale=LCFG.scale),
        tmeta, FederatedConfig(**FED), tstrat, seed=0,
        params=model["tparams"])
    server = {"opt": {k: _t(v) for k, v in
                      _np(j_adam_init(jnp.asarray(jflat0))).items()},
              "round": torch.zeros((), dtype=torch.int32)}
    tstate = teng.RunState(ttask, _t(jflat0), server, {}, rounds=2)
    tled = teng.LedgerCallback(Experiment(device="cpu").build_ledger(
        tmeta.p_len))
    tstate = teng.SimEngine().run_rounds(
        tstate, lambda r: {k: _t(v) for k, v in batches[r].items()}, [tled])

    # round 0's download mask: the same flatP in, the same mask out
    want = jax.jit(lambda f: jsel.FusedSelector().mask(f, 0.25))(jflat0)
    got = tsel.FusedSelector().mask(_t(jflat0), 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for r in range(2):
        jh, th = jstate.history[r], tstate.history[r]
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
        jm, tm_ = jstrat.kept[r] != 0, tstrat.kept[r] != 0
        overlap = float((jm == tm_).mean())
        print(f"round {r}: upload-mask overlap {overlap:.6f}")
        assert overlap >= 0.999
        if overlap == 1.0:
            for key in ("down_bytes", "up_bytes", "coded_bytes"):
                assert th[key] == jh[key], (r, key)
        assert (tm_.sum(-1) >= tsp.density_count(tmeta.p_len, 0.25)).all()
    np.testing.assert_allclose(tstate.flatP.numpy(), np.asarray(jstate.flatP),
                               atol=1e-6)
    assert int(tstate.server["round"]) == 2


def test_port_experiment_runs_end_to_end_on_cpu():
    """The task-less `Experiment` path of the reference's train CLI, on the
    port's smoke-size Yi config, quantized uploads and all."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("yi-9b", smoke=True)
    params = TL.init_params(TM.model_spec(cfg), 0, device="cpu")
    fed = FederatedConfig(n_clients=4, local_batch=2, local_steps=2,
                          client_lr=1e-3, server_lr=2e-3)
    rng = np.random.default_rng(0)

    def data(r):
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 2, 2, 16)))}

    class UpNnz(teng.Callback):
        def __init__(self):
            self.per_client = []

        def on_round_end(self, ev):
            self.per_client.append(list(ev.metrics["up_nnz_clients"]))

    probe = UpNnz()

    res = (Experiment(None, federation=fed, device="cpu")
           .with_strategy("flasc", selector="fused", quant_bits_up=4)
           .with_lora(config=LoRAConfig(rank=8))
           .with_training(rounds=2)
           .with_params(params, cfg)
           .with_data(data)
           .with_engine("sim")
           .with_callbacks(probe)
           .run())
    led = res.ledger
    k = tsp.density_count(led.total_params, 0.25)
    assert len(res.history) == 2 and led.rounds == 2
    assert len(probe.per_client) == 2
    assert all(v >= k for row in probe.per_client for v in row)
    assert led.up_values == sum(map(sum, probe.per_client))
    assert led.up_value_bytes == 0.5
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert set(res.history[0]["phase_ms"]) == {
        "download_mask", "download", "local_update", "upload", "server"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Experiment(None, device="cpu").with_engine("sharded")
