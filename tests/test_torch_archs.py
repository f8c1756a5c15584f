"""The port's other dense archs against the reference: the registry
(`configs/registry.py`), the smoke configs of minitron-8b, gemma-7b and
qwen3-32b through `forward`, `prefill` and `decode_step`, a 2-layer narrow
config at gemma's head size (hd 256) whose prompt reaches
`chunked_attention`, the serving example (`examples/serve_lora_torch.py`)
and the serving sweep (`benchmarks_torch/serving_bench.py`), on weights
converted from the reference and inputs made from a seed.

Tolerances: configs, parameter counts, registry answers, tokens and the
sweep's counters exact; logits and caches atol = rtol = 1e-5 in f32, as
`test_torch_model.py` (the two packages' CPU matmuls round in different
places); the example's merged against unmerged logits 1e-4.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.configs import registry as TR
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
NEW_ARCHS = ("minitron-8b", "gemma-7b", "qwen3-32b")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _init(spec, seed):
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(spec, k))(jax.random.key(seed)))


def test_registry_matches_reference():
    assert set(TR.ARCH_IDS) == {"yi-9b", *NEW_ARCHS}
    assert set(TR.ARCH_IDS) <= set(JR.ARCH_IDS)
    assert TR.LONG_CONTEXT_WINDOW == JR.LONG_CONTEXT_WINDOW == 8192
    for arch in TR.ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(TR.get_config(arch, smoke)) == \
                dataclasses.asdict(JR.get_config(arch, smoke)), (arch, smoke)
        assert TR.long_500k_mode(arch) == JR.long_500k_mode(arch) \
            == "sliding_window"
    for smoke in (False, True):
        got = TR.all_configs(smoke)
        assert list(got) == list(TR.ARCH_IDS)
        want = JR.all_configs(smoke)
        for arch, cfg in got.items():
            assert dataclasses.asdict(cfg) == dataclasses.asdict(want[arch])
    for arch in ("hymba-1.5b", "deepseek-v2-236b", "whisper-large-v3", "x"):
        with pytest.raises(KeyError, match="the port builds"):
            TR.get_config(arch)


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
def test_full_size_parameter_counts_match_reference(arch):
    # specs only, nothing allocated: qwen3-32b's 32.76 B, gemma-7b's tied
    # vocab and hd 256
    tcfg, jcfg = TR.get_config(arch), JR.get_config(arch)
    assert TM.count_params(tcfg) == JM.count_params(jcfg) == \
        jcfg.param_count()
    TM.check_servable(tcfg)


def _run_both(jcfg, params, lora, lcfg, toks, gen, window=None):
    """Forward logits, prefill logits and cache, then `gen` decode steps of
    both packages on the same converted weights; compared as they go."""
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = tree_from_numpy(params, device="cpu")
    tl = tree_from_numpy(lora, device="cpu")
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    with torch.no_grad():
        out_t = TM.forward(tp, tcfg, batch_t, lora=tl, lora_scale=lcfg.scale,
                           window=window)
    out_j = JM.forward(params, jcfg, batch_j, lora=lora,
                       lora_scale=lcfg.scale, window=window)
    _close(out_t["logits"], out_j["logits"])
    S = toks.shape[1]
    lg_j, c_j = JM.prefill(params, jcfg, batch_j, lora=lora,
                           lora_scale=lcfg.scale, window=window,
                           max_len=S + gen)
    with torch.no_grad():
        lg_t, c_t = TM.prefill(tp, tcfg, batch_t, lora=tl,
                               lora_scale=lcfg.scale, window=window,
                               max_len=S + gen)
    _close(lg_t, lg_j)
    for got, want in zip(c_t["g0"]["self"], c_j["g0"]["self"]):
        _close(got, want)
    tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)
    step = jax.jit(lambda t, p, c: JM.decode_step(
        params, jcfg, t, p, c, lora=lora, lora_scale=lcfg.scale,
        window=window))
    for i in range(gen):
        lg_j, c_j = step(jnp.asarray(tok), jnp.int32(S + i), c_j)
        with torch.no_grad():
            lg_t, c_t = TM.decode_step(tp, tcfg, _t(tok), torch.tensor(S + i),
                                       c_t, lora=tl, lora_scale=lcfg.scale,
                                       window=window)
        _close(lg_t, lg_j)
        tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)


def _weights(cfg, seed):
    params = _init(JM.model_spec(cfg), seed)
    lcfg = JLoRAConfig(rank=4, alpha=8, dtype="float32")
    lora = _init(jax_lora.lora_spec(cfg, lcfg), seed + 1)
    rng = np.random.default_rng(seed)
    lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(
        x.shape, dtype=np.float32), lora)
    return params, lcfg, lora


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_configs_forward_prefill_decode_match_reference(arch):
    # minitron's rope theta 5e5, gemma's GeGLU and tied embeddings, qwen3's
    # QK-RMSNorm
    cfg = JR.get_config(arch, smoke=True)
    params, lcfg, lora = _weights(cfg, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    _run_both(cfg, params, lora, lcfg, toks, gen=3)


@pytest.mark.parametrize("window", [None, 20])
def test_hd_256_reaches_chunked_attention_and_matches_reference(window):
    # gemma's head size at a narrow width, the chunked path lowered to 32
    # tokens: a 48-token prompt takes chunked_attention in both packages
    # (in the port's place the flash kernel's hd256 route on the card),
    # with and without a window
    cfg = dataclasses.replace(
        JR.get_config("gemma-7b", smoke=True), head_dim=256, num_heads=2,
        num_kv_heads=2, chunked_attn_threshold=32, attn_chunk_q=16,
        attn_chunk_kv=16)
    assert cfg.hd == 256
    params, lcfg, lora = _weights(cfg, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 48))
    _run_both(cfg, params, lora, lcfg, toks, gen=2, window=window)


def _example():
    path = os.path.join(ROOT, "examples", "serve_lora_torch.py")
    spec = importlib.util.spec_from_file_location("serve_lora_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-32b", "minitron-8b", "gemma-7b"])
def test_serve_lora_example_runs_on_the_cpu(arch, capsys):
    # batched prefill and greedy decode of the smoke config; the merged
    # backbone's logits equal the unmerged adapter's (not checked for tied
    # embeddings, as the reference example)
    out = _example().main(["--device", "cpu", "--arch", arch, "--batch", "2",
                           "--prompt-len", "12", "--gen", "8"])
    assert tuple(out["tokens"].shape) == (2, 8)
    assert out["tokens"].min() >= 0
    assert out["tokens"].max() < out["cfg"].vocab_size
    printed = capsys.readouterr().out
    assert "generated token ids" in printed
    if out["cfg"].tie_embeddings:
        assert out["merge_err"] is None
    else:
        assert out["merge_err"] < 1e-4
        assert "merge-for-serving" in printed


def test_serving_bench_rows_match_reference(tmp_path, monkeypatch):
    # the same seeded trace through both engines at every cache size of the
    # quick sweep: the counters are the trace's and the cache's, not the
    # weights'; the port writes under chiprun_out/, never BENCH_serving.json
    from benchmarks import serving_bench as jsb
    from benchmarks_torch import serving_bench as tsb
    monkeypatch.setattr(tsb, "ROOT", str(tmp_path))
    want = jsb.serving_sweep([])
    got = tsb.main(["--out", "sb.json"], device="cpu")["rows"]
    keys = ("pages", "lanes", "tenants", "requests", "adapters_resident",
            "generated_tokens", "hit_rate", "hits", "misses", "evictions",
            "admission_stalls", "mean_occupancy")
    assert [{k: r[k] for k in keys} for r in got] == \
        [{k: r[k] for k in keys} for r in want]
    assert (tmp_path / "chiprun_out" / "sb.json").exists()
    assert not os.path.exists(os.path.join(str(tmp_path), "BENCH_serving.json"))
