"""The port's dense decoder against the reference, on weights converted from
the reference (`checkpoint/io.py::tree_from_numpy`), at a small f32 size.

Tolerance atol = rtol = 1e-5 in f32: the two packages' CPU matmuls, pow
and softmax round in different places.  Inside the port, the vector-pos
decode path must equal the scalar one bit for bit.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_io
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint.io import load_reference, tree_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lora as torch_lora
from repro_torch.models import model as TM
from repro_torch.models.config import LoRAConfig, ModelConfig

CFG = JModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _init(spec, seed):
    """Reference init, jitted (eager dispatch of every op is slower)."""
    return _np(jax.jit(lambda k: JL.init_params(spec, k))(jax.random.key(seed)))


def _lora_tree(cfg, seed, rank=4, targets=("wq", "wk", "wv", "wo")):
    lcfg = JLoRAConfig(rank=rank, alpha=2 * rank, targets=targets,
                       dtype="float32")
    lt = _init(jax_lora.lora_spec(cfg, lcfg), seed)
    rng = np.random.default_rng(seed)
    lt = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(
        x.shape, dtype=np.float32), lt)
    return lcfg, lt


@pytest.fixture(scope="module")
def weights():
    params = _init(JM.model_spec(CFG), 0)
    lcfg, lora = _lora_tree(CFG, 1, targets=("wq", "wk", "wv", "wo", "w1",
                                             "w2", "w3"))
    return params, lcfg, lora


def test_spec_trees_match_reference():
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda p: (p.shape, p.dtype), tree,
        is_leaf=lambda x: isinstance(x, (JL.P, TL.P)))
    tcfg = _tcfg(CFG)
    assert shapes(TM.model_spec(tcfg)) == shapes(JM.model_spec(CFG))
    lj = JLoRAConfig(rank=4, targets=("wq", "wo", "w1"))
    lt = LoRAConfig(rank=4, targets=("wq", "wo", "w1"))
    assert shapes(torch_lora.lora_spec(tcfg, lt)) == \
        shapes(jax_lora.lora_spec(CFG, lj))
    assert shapes(TM.cache_spec(tcfg, 3, 16)) == \
        shapes(JM.cache_spec(CFG, 3, 16))
    assert TM.count_params(tcfg) == JM.count_params(CFG)


def test_init_params_shapes_dtypes_and_seed():
    tcfg = _tcfg(dataclasses.replace(CFG, param_dtype="bfloat16"))
    spec = TM.model_spec(tcfg)
    p1 = TL.init_params(spec, 3, device="cpu")
    p2 = TL.init_params(spec, 3, device="cpu")
    leaves = list(TL.tree_leaves(p1))
    assert all(l.dtype == torch.bfloat16 for l in leaves)
    for a, b in zip(leaves, TL.tree_leaves(p2)):
        assert torch.equal(a, b)
    w1 = p1["groups"]["g0"]["mlp"]["w1"].float()     # fan-in scaled normal
    assert abs(w1.std().item() - 64 ** -0.5) < 0.01
    assert torch.all(p1["final_norm"] == 1)


def test_rms_norm_and_rope():
    x = _rng_f32(0, 3, 5, 4, 16)
    w = _rng_f32(1, 16)
    _close(TL.rms_norm(_t(x), _t(w), 1e-6), JL.rms_norm(x, w, 1e-6))
    pos = np.arange(5)
    _close(TA.apply_rope(_t(x), _t(pos), 10_000.0),
           JL.apply_rope(x, pos, 10_000.0))
    rows = np.stack([pos, pos + 7, pos * 3])            # per-row positions
    _close(TA.apply_rope(_t(x), _t(rows), 500.0),
           JL.apply_rope(x, rows, 500.0))
    x3 = x[:, :, 0]                         # no head axis: (B, S, hd)
    _close(TA.apply_rope(_t(x3), _t(rows), 10_000.0),
           JL.apply_rope(x3, rows, 10_000.0, head_axis=False))


def test_linear_plain_and_paged():
    x = _rng_f32(0, 2, 3, 24)
    w = _rng_f32(1, 24, 50)
    a = _rng_f32(2, 3, 24, 5) / 5
    b = _rng_f32(3, 3, 5, 50) / 3
    _close(TL.linear(_t(x), _t(w)), JL.linear(x, w))
    single = {"a": a[1], "b": b[1]}
    _close(TL.linear(_t(x), _t(w), tree_from_numpy(single, device="cpu"), 1.5),
           JL.linear(x, w, single, 1.5))
    gidx = np.asarray([2, 0], np.int32)
    paged = {"a": a, "b": b, "gidx": gidx}
    _close(TL.linear(_t(x), _t(w), tree_from_numpy(paged, device="cpu"), 1.5),
           JL.linear(x, w, jax.tree.map(jnp.asarray, paged), 1.5))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_apply(activation):
    spec = JL.mlp_spec(24, 40, activation, "float32")
    params = _init(spec, 4)
    lora = {"w1": {"a": _rng_f32(5, 24, 3) / 5, "b": _rng_f32(6, 3, 40) / 2}}
    x = _rng_f32(7, 2, 3, 24)
    want = JL.mlp_apply(params, x, activation, lora, 2.0)
    got = TL.mlp_apply(tree_from_numpy(params, device="cpu"), _t(x),
                       activation, tree_from_numpy(lora, device="cpu"), 2.0)
    _close(got, want)


def _layer0(tree):
    return jax.tree.map(lambda l: l[0], tree)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_forward_and_decode(weights, qk_norm):
    cfg = dataclasses.replace(CFG, qk_norm=qk_norm)
    params = _init(JA.gqa_spec(cfg), 9)
    if qk_norm:   # non-trivial norm weights
        params["q_norm"] = 1 + _rng_f32(10, cfg.hd) / 4
        params["k_norm"] = 1 + _rng_f32(11, cfg.hd) / 4
    lora = _layer0(weights[2]["g0"]["attn"])
    tp = tree_from_numpy(params, device="cpu")
    tl = tree_from_numpy(lora, device="cpu")
    tcfg = _tcfg(cfg)
    x = _rng_f32(12, 2, 6, cfg.d_model)
    y_j, (k_j, v_j) = jax.jit(lambda p, x, l: JA.gqa_forward(
        p, x, cfg, lora=l, lora_scale=2.0, return_kv=True))(params, x, lora)
    y_t, (k_t, v_t) = TA.gqa_forward(tp, _t(x), tcfg, lora=tl, lora_scale=2.0,
                                     return_kv=True)
    for got, want in ((y_t, y_j), (k_t, k_j), (v_t, v_j)):
        _close(got, want)

    B, T = 3, 8
    cache = (_rng_f32(13, B, T, cfg.num_kv_heads, cfg.hd),
             _rng_f32(14, B, T, cfg.num_kv_heads, cfg.hd))
    x1 = _rng_f32(15, B, 1, cfg.d_model)
    decode = jax.jit(lambda p, x1, c, pos, l: JA.gqa_decode(
        p, x1, c, pos, cfg, lora=l, lora_scale=2.0))
    for pos in (np.int32(5), np.asarray([2, 7, 11], np.int32)):
        y_j, c_j = decode(params, x1, cache, pos, lora)
        c_t = tuple(_t(c) for c in cache)
        y_t, c_t2 = TA.gqa_decode(tp, _t(x1), c_t, _t(pos), tcfg, lora=tl,
                                  lora_scale=2.0)
        assert c_t2[0] is c_t[0]                  # written in place
        _close(y_t, y_j)
        for got, want in zip(c_t2, c_j):
            _close(got, want)


# chunked_attention's two branches: causal with S == T and at most 8 q
# chunks skips kv chunks above the diagonal; otherwise every kv chunk is
# scanned.  (S, T, cq, ckv, causal): skip with nq = 4 and 8; scan with
# nq = 12, non-causal, and S != T.
CHUNK_CASES = [(64, 64, 16, 16, True), (64, 64, 8, 16, True),
               (48, 48, 4, 8, True), (64, 64, 16, 32, False),
               (32, 64, 8, 16, True)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,cq,ckv,causal", CHUNK_CASES)
def test_chunked_attention_matches_reference(S, T, cq, ckv, causal, dt):
    # f32 to atol 2e-5 (test_kernels.py's chunked-vs-oracle tolerance);
    # bf16 inputs and output to 2e-2, the reference's bf16 attention bound
    B, KV, G, hd = 2, 2, 2, 16
    q = _rng_f32(20, B, S, KV * G, hd)
    k, v = _rng_f32(21, B, T, KV, hd), _rng_f32(22, B, T, KV, hd)
    jq, jk, jv = (jnp.asarray(a).astype(dt) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(getattr(torch, dt)) for a in (q, k, v))
    want = JA.chunked_attention(jq, jk, jv, hd ** -0.5, causal=causal,
                                window=None, cq=cq, ckv=ckv)
    got = TA.chunked_attention(tq, tk, tv, hd ** -0.5, causal=causal, cq=cq,
                               ckv=ckv)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    tol = 2e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_chunked_attention_keeps_the_chunk_contract():
    q = _rng_f32(23, 1, 40, 4, 16)
    kv = _rng_f32(24, 1, 40, 2, 16)
    for cq, ckv in ((16, 8), (8, 16)):      # 40 % 16 != 0 on either side
        with pytest.raises(AssertionError):
            JA.chunked_attention(jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv), 0.25, causal=True,
                                 window=None, cq=cq, ckv=ckv)
        with pytest.raises(ValueError, match="S % cq == 0 and T % ckv"):
            TA.chunked_attention(_t(q), _t(kv), _t(kv), 0.25, causal=True,
                                 cq=cq, ckv=ckv)
    # a sliding window keeps the contract too
    with pytest.raises(ValueError, match="S % cq == 0 and T % ckv"):
        TA.chunked_attention(_t(q), _t(kv), _t(kv), 0.25, causal=True,
                             window=8, cq=16, ckv=8)


@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 4)])
def test_gqa_forward_long_prompt_matches_reference(weights, S, chunk):
    # at a lowered threshold both packages take their chunked path: 4 q
    # chunks (the skipping branch) and 12 (the scan); cache k/v included
    cfg = dataclasses.replace(CFG, chunked_attn_threshold=32,
                              attn_chunk_q=chunk, attn_chunk_kv=chunk)
    params = _init(JA.gqa_spec(cfg), 25)
    lora = _layer0(weights[2]["g0"]["attn"])
    x = _rng_f32(26, 2, S, cfg.d_model)
    y_j, (k_j, v_j) = jax.jit(lambda p, x, l: JA.gqa_forward(
        p, x, cfg, lora=l, lora_scale=2.0, return_kv=True))(params, x, lora)
    y_t, (k_t, v_t) = TA.gqa_forward(
        tree_from_numpy(params, device="cpu"), _t(x), _tcfg(cfg),
        lora=tree_from_numpy(lora, device="cpu"), lora_scale=2.0,
        return_kv=True)
    for got, want in ((y_t, y_j), (k_t, k_j), (v_t, v_j)):
        _close(got, want)
    with pytest.raises(ValueError, match="S % cq"):
        TA.gqa_forward(tree_from_numpy(params, device="cpu"),
                       _t(_rng_f32(27, 1, S + 2, cfg.d_model)), _tcfg(cfg))


def test_forward_prefill_decode_match_reference(weights):
    params, lcfg, lora = weights
    tp = tree_from_numpy(params, device="cpu")
    tl = tree_from_numpy(lora, device="cpu")
    tcfg = _tcfg(CFG)
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 7))
    out_j = JM.forward(params, CFG, {"tokens": jnp.asarray(toks)}, lora=lora,
                       lora_scale=lcfg.scale)
    out_t = TM.forward(tp, tcfg, {"tokens": _t(toks)}, lora=tl,
                       lora_scale=lcfg.scale)
    _close(out_t["logits"], out_j["logits"])
    _close(out_t["hidden"], out_j["hidden"])

    lg_j, c_j = JM.prefill(params, CFG, {"tokens": jnp.asarray(toks)},
                           lora=lora, lora_scale=lcfg.scale, max_len=12)
    lg_t, c_t = TM.prefill(tp, tcfg, {"tokens": _t(toks)}, lora=tl,
                           lora_scale=lcfg.scale, max_len=12)
    _close(lg_t, lg_j)
    for got, want in zip(c_t["g0"]["self"], c_j["g0"]["self"]):
        assert tuple(got.shape) == want.shape == (2, 2, 12, 2, 16)
        _close(got, want)

    tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)
    for pos in (np.int32(7), np.asarray([7, 4], np.int32)):
        lg2_j, c2_j = JM.decode_step(params, CFG, jnp.asarray(tok),
                                     jnp.asarray(pos), c_j, lora=lora,
                                     lora_scale=lcfg.scale)
        c_in = {"g0": {"self": tuple(c.clone() for c in c_t["g0"]["self"])}}
        lg2_t, c2_t = TM.decode_step(tp, tcfg, _t(tok), _t(pos), c_in,
                                     lora=tl, lora_scale=lcfg.scale)
        assert tuple(lg2_t.shape) == (2, 1, CFG.vocab_size)
        _close(lg2_t, lg2_j)
        for got, want in zip(c2_t["g0"]["self"], c2_j["g0"]["self"]):
            _close(got, want)


def test_decode_vector_pos_bit_equal_to_scalar(weights):
    # inside the port, the (B,) per-lane position path reproduces the
    # shared-position path exactly when every lane sits at the same position
    tp = tree_from_numpy(weights[0], device="cpu")
    tcfg = _tcfg(CFG)
    B, S = 3, 8
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG.vocab_size, (B, S)))
    logits, cache = TM.prefill(tp, tcfg, {"tokens": toks}, max_len=16)
    tok = torch.argmax(logits[:, -1], -1)

    def fresh():
        return {"g0": {"self": tuple(c.clone() for c in cache["g0"]["self"])}}

    lg_s, c_s = TM.decode_step(tp, tcfg, tok, torch.tensor(S), fresh())
    lg_v, c_v = TM.decode_step(tp, tcfg, tok, torch.full((B,), S), fresh())
    assert torch.equal(lg_s, lg_v)
    for a, b in zip(c_s["g0"]["self"], c_v["g0"]["self"]):
        assert torch.equal(a, b)
    # mixed positions run and only move the row they belong to
    lg_m, _ = TM.decode_step(tp, tcfg, tok, torch.tensor([S, 3, 5]), fresh())
    assert lg_m.shape == lg_s.shape and torch.equal(lg_m[0], lg_s[0])


def test_reference_npz_loads_and_forward_matches(tmp_path, weights):
    params = weights[0]
    path = str(tmp_path / "params.npz")
    jax_io.save_pytree(params, path)
    tp = load_reference(path, device="cpu")
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (1, 5))
    _close(TM.forward(tp, _tcfg(CFG), {"tokens": _t(toks)})["logits"],
           JM.forward(params, CFG, {"tokens": jnp.asarray(toks)})["logits"])


def test_bf16_leaves_convert_bit_exactly(tmp_path):
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16")
    params = _init(JM.model_spec(cfg), 0)
    path = str(tmp_path / "bf16.npz")
    jax_io.save_pytree(params, path)
    for tp in (tree_from_numpy(_np(params), device="cpu"),
               load_reference(path, device="cpu")):
        for got, want in zip(TL.tree_leaves(tp), jax.tree.leaves(params)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
