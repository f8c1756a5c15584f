"""Sliding-window attention and its rolling KV cache against the reference:
the mask, `chunked_attention` on both of its branches, the flash kernel's
plain version, `gqa_forward` below and at the chunked threshold, prefill
and decode across the rolling buffer's wrap, the serving engine, and
`merge_lora`, on inputs and weights made from a seed (f32, small sizes).

Tolerances: masks, completions and cache counters bitwise; attention
outputs atol = rtol = 2e-5 (the reference's chunked-vs-oracle bound,
`tests/test_kernels.py`); model outputs and caches 1e-5, as
`test_torch_model.py` (the two packages' CPU matmuls round in different
places).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import serving as TS
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as TA
from repro_torch.models import lora as torch_lora
from repro_torch.models import model as TM
from repro_torch.models.config import LoRAConfig, ModelConfig

CFG = JModelConfig(name="w", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _init(spec, seed):
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(spec, k))(jax.random.key(seed)))


@pytest.fixture(scope="module")
def weights():
    """Reference params and a rank-4 adapter on every attention and MLP
    projection, with a nonzero b."""
    params = _init(JM.model_spec(CFG), 0)
    lcfg = JLoRAConfig(rank=4, alpha=8, dtype="float32",
                       targets=("wq", "wk", "wv", "wo", "w1", "w2", "w3"))
    lora = _init(jax_lora.lora_spec(CFG, lcfg), 1)
    rng = np.random.default_rng(1)
    lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(
        x.shape, dtype=np.float32), lora)
    return params, lcfg, lora


@pytest.mark.parametrize("window", [None, 1, 3, 8, 100])
def test_causal_mask_with_a_window_is_bitwise(window):
    rng = np.random.default_rng(0)
    for q_pos, k_pos in ((np.arange(12), np.arange(12)),
                         (np.arange(5) + 20, np.arange(30)),
                         (rng.integers(0, 50, (3, 7)),
                          rng.integers(0, 50, (3, 9)))):
        want = np.asarray(JA.causal_mask(jnp.asarray(q_pos),
                                         jnp.asarray(k_pos), window))
        got = TA.causal_mask(_t(q_pos), _t(k_pos), window).numpy()
        np.testing.assert_array_equal(got, want)


# (S, cq, ckv, W): the skipping branch (causal, S == T, nq <= 8; its `lo`
# skips kv chunks below the window) with W below, at and above the chunk
# size and past S; the scanning branch (nq = 12) likewise
@pytest.mark.parametrize("S,cq,ckv,W", [
    (64, 16, 16, 5), (64, 16, 16, 16), (64, 16, 16, 40), (64, 8, 16, 100),
    (96, 8, 8, 3), (96, 8, 8, 8), (96, 8, 8, 24)])
def test_chunked_attention_window_matches_reference(S, cq, ckv, W):
    B, KV, G, hd = 2, 2, 2, 16
    q = _rng_f32(20 + W, B, S, KV * G, hd)
    k, v = _rng_f32(21 + W, B, S, KV, hd), _rng_f32(22 + W, B, S, KV, hd)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                hd ** -0.5, causal=True, window=W, cq=cq,
                                ckv=ckv)
    got = TA.chunked_attention(_t(q), _t(k), _t(v), hd ** -0.5, causal=True,
                               window=W, cq=cq, ckv=ckv)
    _close(got, want, ATTN_TOL)
    # the window changes the function unless it spans the sequence
    plain = TA.chunked_attention(_t(q), _t(k), _t(v), hd ** -0.5,
                                 causal=True, cq=cq, ckv=ckv)
    assert torch.equal(got, plain) == (W >= S)


@pytest.mark.parametrize("W", [1, 7, 16, 30, 100])
def test_flash_attention_plain_window_matches_reference(W):
    # the flash kernel's plain version (every route's function) against the
    # reference's chunked_attention with the same window
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    q = _rng_f32(30 + W, B, S, H, hd)
    k, v = _rng_f32(31 + W, B, S, KV, hd), _rng_f32(32 + W, B, S, KV, hd)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                hd ** -0.5, causal=True, window=W, cq=16,
                                ckv=16)
    got = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                   scale=hd ** -0.5, window=W)
    _close(got, want, ATTN_TOL)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                          scale=hd ** -0.5, window=W), got)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(_t(q), _t(k), _t(v), causal=False, scale=0.25,
                           window=W)
    if W < S:     # T = S - W keys leave the last query row none
        with pytest.raises(ValueError, match="see no key"):
            fa.flash_attention_plain(_t(q), _t(k)[:, :S - W],
                                     _t(v)[:, :S - W], scale=0.25, window=W)


def _layer0(tree):
    return jax.tree.map(lambda l: l[0], tree)


# below the threshold (the full mask) and at it (chunked_attention: 6 q
# chunks of 8, the skipping branch; 12 of 4, the scan)
@pytest.mark.parametrize("S,chunk,W", [(24, 8, 5), (24, 8, 100), (48, 8, 5),
                                       (48, 8, 20), (48, 4, 13)])
def test_gqa_forward_window_matches_reference(weights, S, chunk, W):
    cfg = dataclasses.replace(CFG, chunked_attn_threshold=32,
                              attn_chunk_q=chunk, attn_chunk_kv=chunk)
    params = _init(JA.gqa_spec(cfg), 25)
    lora = _layer0(weights[2]["g0"]["attn"])
    x = _rng_f32(26, 2, S, cfg.d_model)
    y_j, (k_j, v_j) = jax.jit(lambda p, x, l: JA.gqa_forward(
        p, x, cfg, lora=l, lora_scale=2.0, window=W, return_kv=True))(
            params, x, lora)
    y_t, (k_t, v_t) = TA.gqa_forward(
        tree_from_numpy(params, device="cpu"), _t(x),
        ModelConfig(**dataclasses.asdict(cfg)),
        lora=tree_from_numpy(lora, device="cpu"), lora_scale=2.0, window=W,
        return_kv=True)
    for got, want in ((y_t, y_j), (k_t, k_j), (v_t, v_j)):
        _close(got, want)


def test_roll_window_puts_position_p_at_slot_p_mod_w():
    t = torch.arange(13)[None, :, None].expand(2, 13, 3)
    rolled = TM._roll_window(t, 5)
    assert rolled.shape == (2, 5, 3)
    for slot in range(5):
        p = int(rolled[0, slot, 0])
        assert 8 <= p <= 12 and p % 5 == slot
    np.testing.assert_array_equal(
        rolled.numpy(), np.asarray(JM._roll_window(jnp.asarray(t.numpy()), 5)))
    assert TM._roll_window(t, 20) is t


# S < W, S == W and S > W; decode runs 7 steps past the prompt, across the
# rolling buffer's wrap at every W slots
@pytest.mark.parametrize("S", [5, 8, 13])
def test_prefill_and_decode_across_the_wrap_match_reference(weights, S):
    params, lcfg, lora = weights
    W, gen = 8, 7
    tp = tree_from_numpy(params, device="cpu")
    tl = tree_from_numpy(lora, device="cpu")
    toks = np.random.default_rng(S).integers(0, CFG.vocab_size, (2, S))
    lg_j, c_j = JM.prefill(params, CFG, {"tokens": jnp.asarray(toks)},
                           lora=lora, lora_scale=lcfg.scale, window=W,
                           max_len=S + gen)
    with torch.no_grad():
        lg_t, c_t = TM.prefill(tp, TCFG, {"tokens": _t(toks)}, lora=tl,
                               lora_scale=lcfg.scale, window=W,
                               max_len=S + gen)
    _close(lg_t, lg_j)
    slots = min(W, S + gen)
    for got, want in zip(c_t["g0"]["self"], c_j["g0"]["self"]):
        assert tuple(got.shape) == want.shape == (2, 2, slots, 2, 16)
        _close(got, want)
    assert jax.tree.map(lambda p: p.shape, TM.cache_spec(TCFG, 2, S + gen, W),
                        is_leaf=lambda x: hasattr(x, "shape")) == \
        jax.tree.map(lambda p: p.shape, JM.cache_spec(CFG, 2, S + gen, W),
                     is_leaf=lambda x: hasattr(x, "shape"))
    tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)
    for i in range(gen):
        pos = np.int32(S + i)
        lg_j, c_j = JM.decode_step(params, CFG, jnp.asarray(tok),
                                   jnp.asarray(pos), c_j, lora=lora,
                                   lora_scale=lcfg.scale, window=W)
        with torch.no_grad():
            lg_t, c_t = TM.decode_step(tp, TCFG, _t(tok), _t(pos), c_t,
                                       lora=tl, lora_scale=lcfg.scale,
                                       window=W)
        _close(lg_t, lg_j)
        for got, want in zip(c_t["g0"]["self"], c_j["g0"]["self"]):
            _close(got, want)
        tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)


def test_serving_engine_window_matches_reference(weights):
    # prompts of 4 and 12 tokens through a window of 6: the long ones
    # prefill past it and every lane decodes across the wrap; completions
    # and counters equal the reference engine's on the same weights
    params, lcfg, _ = weights
    W, max_len = 6, 20
    alcfg = JLoRAConfig(rank=4, alpha=8, dtype="float32")
    make = jax.jit(lambda c: jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(
            jax.random.key(9), c), x.shape, x.dtype),
        jax_lora.init_lora(CFG, alcfg, jax.random.fold_in(
            jax.random.key(8), c))))
    adapters = {c: jax.tree.map(np.asarray, make(c)) for c in range(4)}
    trace = JS.synth_trace(6, 4, CFG.vocab_size, seed=5,
                           prompt_buckets=(4, 12), gen_range=(3, 8))
    assert {r.prompt_len for r in trace} == {4, 12}
    jstore, tstore = JS.HostAdapterStore(), TS.HostAdapterStore()
    for c, lt in adapters.items():
        jstore.put(c, lt)
        tstore.put(c, lt)
    want = JS.ServingEngine(
        jax.tree.map(jnp.asarray, params), CFG,
        JS.PagedAdapterCache(jstore, jstore.get(0), pages=2), n_lanes=2,
        lora_scale=alcfg.scale, max_len=max_len, window=W).run(trace)
    eng = TS.ServingEngine(
        tree_from_numpy(params, device="cpu"), TCFG,
        TS.PagedAdapterCache(tstore, tstore.get(0), pages=2, device="cpu"),
        n_lanes=2, lora_scale=alcfg.scale, max_len=max_len, window=W,
        device="cpu")
    got = eng.run(trace)
    assert len(got.completions) == len(trace)
    assert got.completions == want.completions
    assert got.cache == want.cache
    for f in ("steps", "prefills", "decode_tokens", "generated_tokens",
              "mean_occupancy", "stalls"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="window"):
        TS.ServingEngine(eng.params, TCFG, eng.cache, max_len=max_len,
                         window=0, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_reference(weights, dtype):
    # a @ b * scale folded in f32 and cast back to the weight's dtype: f32
    # to 1e-5, bf16 to one bf16 step (2^-8 of a weight's magnitude)
    params, lcfg, lora = weights
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), params)
    want = jax_lora.merge_lora(jparams, lora, CFG, lcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    attn = tp["groups"]["g0"]["attn"]
    kept = {k: v.clone() for k, v in attn.items()}
    got = torch_lora.merge_lora(tp, tree_from_numpy(lora, device="cpu"),
                                TCFG, LoRAConfig(**dataclasses.asdict(lcfg)))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -8, atol=2 ** -8)
    for (path, w), g in zip(wl, gl):
        assert g.dtype == getattr(torch, dtype), path
        _close(g, np.asarray(w.astype(jnp.float32)), tol)
    # the given params are unchanged; the adapted weights moved
    for k, v in kept.items():
        assert torch.equal(attn[k], v), k
    assert not torch.equal(got["groups"]["g0"]["attn"]["wq"], attn["wq"])
