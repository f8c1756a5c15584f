"""Training at `chunked_attn_threshold` tokens or more: the attention
gradient and the per-layer recomputation, on the CPU at small sizes.

  - The port's `chunked_attention` differentiated by autograd against
    `jax.grad` of the reference's, w.r.t. q, k and v, in f32, on both of
    the reference's branches (the `fori_loop` that skips the kv chunks
    above the diagonal, and the `lax.map` of scans): rtol 1e-5, atol 1e-6
    (the two packages' CPU einsums and exponentials round in other places).
  - `flash_attention_bwd_plain`, the backward kernels' function, against
    autograd of `flash_attention_plain` in f64 (causal and full, GQA,
    ragged S and T, under a causal window of 1, 5 and 37 keys, at hd 8, 16
    and 256): rtol 1e-10, atol 1e-12, both exact up to f64 rounding; and
    in f64 against the reference's f32 gradient of (1) at (1)'s tolerance,
    and against `jax.vjp` of the reference's `chunked_attention(window=)`
    and `full_attention` under `causal_mask(..., window)`, at hd 256 and
    under a window, at the same tolerance in units of the gradient's
    largest magnitude (at hd 256 the reference's f32 sums run over 256
    terms).
  - the model's flat LoRA gradient of `loss_fn(window=W)` on a long-prompt
    cut at hd 256 (sequences of 32 tokens or more take
    `chunked_attention`) against the reference's `jax.grad` of its
    `loss_fn`: rtol 1e-5, atol 1e-6 in units of the gradient's largest
    magnitude.
  - `models/model.py::forward` recomputes each block in the backward pass
    (the reference's `jax.checkpoint` of its layer scan): the LoRA gradient
    of `loss_fn` equals bit for bit that of the same layer loop run without
    recomputation, and a training forward saves for the backward pass no
    more than the layer inputs plus a few (B, S, D) tensors.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedround as JF
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lora as JLoRA
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.core.fedround import FlatMeta
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lora as TLoRA
from repro_torch.models import model as TM
from repro_torch.models.config import LoRAConfig, ModelConfig

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
F64_TOL = dict(rtol=1e-10, atol=1e-12)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _qkv(seed, B, S, T, H, KV, hd):
    return (_normal(seed, B, S, H, hd), _normal(seed + 1, B, T, KV, hd),
            _normal(seed + 2, B, T, KV, hd), _normal(seed + 3, B, S, H, hd))


@functools.lru_cache(maxsize=None)
def _case_and_jax_grads(S):
    """The inputs of `_qkv(S, 1, S, S, 4, 2, 16)` and jax.grad of the
    reference's chunked_attention (causal, chunks of 16) w.r.t. q, k, v
    with the output gradient dout; computed once a module run."""
    q, k, v, dout = _qkv(S, 1, S, S, 4, 2, 16)
    return (q, k, v, dout), _jax_grads(q, k, v, dout, 16)


def _jax_grads(q, k, v, dout, chunk):
    """jax.grad of the reference's chunked_attention (causal) w.r.t. q, k,
    v, with the output gradient `dout`."""
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        out = JA.chunked_attention(q, k, v, scale, causal=True, window=None,
                                   cq=chunk, ckv=chunk)
        return jnp.sum(out * dout)

    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))]


# S = T = 64 at chunks of 16: nq = 4, the reference's fori_loop branch that
# skips the kv chunks above the diagonal; S = T = 256 at 16: nq = 16, its
# lax.map of scans over every kv chunk
@pytest.mark.parametrize("S", [64, 256])
def test_chunked_attention_gradient_matches_reference(S):
    (q, k, v, dout), want = _case_and_jax_grads(S)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = TA.chunked_attention(tq, tk, tv, 16 ** -0.5, causal=True, cq=16,
                               ckv=16)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (1, 48, 48, 4, 2, 16), (2, 37, 50, 6, 3, 8), (1, 50, 37, 4, 4, 8),
    (2, 33, 33, 8, 1, 16)])
def test_flash_bwd_plain_matches_autograd_f64(B, S, T, H, KV, hd, causal):
    _bwd_plain_against_autograd(S + T, B, S, T, H, KV, hd, causal, None)


# under a causal window: W 1 (each row sees its own key alone), 5 and 37
# (across the ragged edges), S == T and S < T, GQA and H == KV; hd 256
# with and without one
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (1, 48, 48, 4, 2, 16, True, 1), (2, 37, 50, 6, 3, 8, True, 5),
    (1, 48, 48, 4, 2, 16, True, 37), (2, 33, 50, 4, 2, 8, True, 37),
    (2, 40, 40, 4, 4, 16, True, 5), (1, 40, 40, 2, 2, 256, True, None),
    (1, 33, 50, 4, 2, 256, False, None), (2, 33, 50, 4, 2, 256, True, 37)])
def test_flash_bwd_plain_matches_autograd_f64_under_a_window(
        B, S, T, H, KV, hd, causal, window):
    _bwd_plain_against_autograd(S + T + hd, B, S, T, H, KV, hd, causal,
                                window)


def _bwd_plain_against_autograd(seed, B, S, T, H, KV, hd, causal, window):
    q, k, v, dout = (torch.from_numpy(a).double()
                     for a in _qkv(seed, B, S, T, H, KV, hd))
    scale = hd ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                        window=window, return_lse=True)
    assert out.dtype == lse.dtype == torch.float64 and lse.shape == (B, H, S)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale,
                                       window=window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=causal, scale=scale,
                                 window=window), leaves, dout)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F64_TOL,
                                   err_msg=name)
    # the CPU path of the wrapper is the plain backward
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   scale=scale, window=window)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# the function the hd-256 kernel is held to on the card, lse included: the
# plain forward at hd 256 against the reference's mask (causal_mask, with a
# window of 37 too), softmax and the log-sum-exp of its scaled, masked
# scores, f32 on both sides; ragged S < T and GQA 4 / 2
@pytest.mark.parametrize("B,S,T,H,KV,causal,window", [
    (1, 40, 40, 4, 4, True, None), (2, 33, 50, 4, 2, True, None),
    (1, 48, 48, 4, 2, True, 37), (2, 30, 45, 4, 2, True, 37),
    (2, 33, 50, 4, 2, False, None)])
def test_flash_plain_with_lse_matches_reference_at_hd_256(B, S, T, H, KV,
                                                          causal, window):
    hd = 256
    q, k, v, _ = _qkv(S + T + (window or 0), B, S, T, H, KV, hd)
    scale = hd ** -0.5
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        scale=scale, window=window, return_lse=True)
    mask = (JA.causal_mask(jnp.arange(S), jnp.arange(T), window) if causal
            else None)
    want = JA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask, scale)
    scores = JA._grouped_scores(jnp.asarray(q).reshape(B, S, KV, H // KV, hd),
                                jnp.asarray(k), scale)
    if mask is not None:
        scores = jnp.where(mask, scores, JA.NEG_INF)
    want_lse = jax.nn.logsumexp(scores, axis=-1).reshape(B, H, S)
    assert out.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)


def test_flash_bwd_plain_matches_reference_gradient():
    (q, k, v, dout), want = _case_and_jax_grads(64)
    tq, tk, tv, tdo = (torch.from_numpy(a).double() for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                        scale=0.25, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                       causal=True, scale=0.25)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


def _close_scaled(got, want, err_msg=""):
    """GRAD_TOL with atol in units of the larger of 1 and want's largest
    magnitude."""
    want = np.asarray(want)
    atol = GRAD_TOL["atol"] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_TOL["rtol"],
                               atol=atol, err_msg=err_msg)


# the reference's own gradient of both of its attention paths, by jax.vjp:
# chunked_attention (chunks of 16; W 37 also skips kv chunks below the
# window) and full_attention under causal_mask(..., window); S = T = 64,
# GQA 4 / 2, at hd 256 and under a window
@pytest.mark.parametrize("path", ["chunked", "full"])
@pytest.mark.parametrize("hd,window", [(256, None), (16, 5), (16, 37),
                                       (256, 37)])
def test_flash_bwd_plain_matches_reference_vjp(path, hd, window):
    S, H, KV = 64, 4, 2
    q, k, v, dout = _qkv(hd + (window or 0), 1, S, S, H, KV, hd)
    scale = hd ** -0.5
    mask = JA.causal_mask(jnp.arange(S), jnp.arange(S), window)

    def f(q, k, v):
        if path == "chunked":
            return JA.chunked_attention(q, k, v, scale, causal=True,
                                        window=window, cq=16, ckv=16)
        return JA.full_attention(q, k, v, mask, scale)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(a).double() for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=True, scale=scale,
                                        window=window, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=True,
                                       scale=scale, window=window)
    for name, g, w in zip("qkv", got, want):
        _close_scaled(g.numpy(), w, err_msg=name)


# gemma's head size on a 2-layer narrow cut whose 64-token sequences take
# the long-prompt path (chunked_attention, the flash kernel's place on the
# card), trained under a sliding window as the reference's loss_fn(window=)
HD256_LONG = JModelConfig(
    name="hd256-long", family="dense", num_layers=2, d_model=64, num_heads=2,
    num_kv_heads=1, head_dim=256, d_ff=128, vocab_size=128,
    param_dtype="float32", compute_dtype="float32", chunked_attn_threshold=32,
    attn_chunk_q=16, attn_chunk_kv=16)


@pytest.mark.parametrize("window", [None, 20])
def test_windowed_lora_gradient_at_hd_256_matches_reference(window):
    cfg = HD256_LONG
    assert cfg.hd == 256
    params = jax.tree.map(np.asarray, jax.jit(lambda key: JL.init_params(
        JM.model_spec(cfg), key))(jax.random.key(7)))
    lcfg = JLoRAConfig(rank=4, alpha=8.0, dtype="float32")
    rng = np.random.default_rng(8)
    lora = jax.tree.map(
        lambda p: rng.standard_normal(p.shape, dtype=np.float32)
        * np.float32(0.05), JLoRA.lora_spec(cfg, lcfg),
        is_leaf=lambda x: isinstance(x, JL.P))
    batch = _batch(cfg, 2, 64, seed=9)
    jmeta = JF.FlatMeta.of(lora)
    jflat = jmeta.flatten(lora)
    want_l, want_g = jax.value_and_grad(lambda f: JM.loss_fn(
        params, cfg, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        lora=jmeta.unflatten(f), lora_scale=lcfg.scale, window=window))(jflat)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tlora = tree_from_numpy(lora, device="cpu")
    meta = FlatMeta.of(tlora)
    flat = meta.flatten(tlora).requires_grad_(True)
    np.testing.assert_array_equal(flat.detach().numpy(), np.asarray(jflat))
    loss = TM.loss_fn(tree_from_numpy(params, device="cpu"), tcfg, batch,
                      lora=meta.unflatten(flat), lora_scale=lcfg.scale,
                      window=window)
    (g,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=1e-5)
    _close_scaled(g.numpy(), want_g)
    assert float(np.abs(np.asarray(want_g)).max()) > 0


# ---------------------------------------------------------------------------
# per-layer recomputation
# ---------------------------------------------------------------------------

CFG = ModelConfig(name="t", family="dense", num_layers=3, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                  param_dtype="float32", compute_dtype="float32")
# a long-prompt cut: sequences of 32 tokens or more take chunked_attention
LONG = dataclasses.replace(CFG, chunked_attn_threshold=32, attn_chunk_q=16,
                           attn_chunk_kv=16)
LCFG = LoRAConfig(rank=4, alpha=8.0)
# hymba-smoke (hybrid attention + Mamba blocks, 2 layers, d 128): its scan
# records through kernels/selective_scan.py's Function, whose saved
# tensors a training forward without recomputation keeps as well
HYMBA = get_config("hymba-1.5b", smoke=True)


def _model(cfg, seed=0):
    """Backbone, a LoRA tree whose `b` is nonzero, and its FlatMeta."""
    params = TL.init_params(TM.model_spec(cfg), seed, device="cpu")
    lora = TLoRA.init_lora(cfg, LCFG, seed + 1, device="cpu")
    gen = torch.Generator().manual_seed(seed + 2)
    for sec in lora["g0"].values():
        for pair in sec.values():
            pair["b"] = 0.1 * torch.randn(pair["b"].shape, generator=gen)
    return params, lora, FlatMeta.of(lora)


def _batch(cfg, B, S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)),
            "loss_mask": torch.from_numpy(
        (rng.random((B, S)) < 0.8).astype(np.int32))}


def _loss_without_recompute(params, cfg, batch, lora, ls, chunk):
    """loss_fn's LM path with the layer loop written out and no
    recomputation: every block's activations are kept for the backward."""
    x = TM.embed_tokens(params, cfg, batch["tokens"])
    gp, gl = params["groups"]["g0"], lora["g0"]
    for i in range(cfg.num_layers):
        x, _ = TM.block_forward(TL.layer_slice(gp, i), x, cfg,
                                lora=TL.layer_slice(gl, i), ls=ls)
    x = TL.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TL.chunked_softmax_ce(x[..., :-1, :], params["lm_head"],
                                 batch["tokens"][..., 1:],
                                 batch["loss_mask"][..., 1:], chunk=chunk)


# S 16: full attention; S 64 under LONG: chunked_attention, the long-prompt
# path; loss_chunk 16 also takes the chunked vocab CE
@pytest.mark.parametrize("cfg,S,chunk", [(CFG, 16, 1024), (LONG, 64, 16)],
                         ids=["short", "long"])
def test_recomputation_gives_the_same_gradient_bitwise(cfg, S, chunk,
                                                       monkeypatch):
    params, lora, meta = _model(cfg)
    batch = _batch(cfg, 2, S)
    calls = []
    block = TM.block_forward

    def counting(*args, **kwargs):
        calls.append(1)
        return block(*args, **kwargs)

    monkeypatch.setattr(TM, "block_forward", counting)
    flat = meta.flatten(lora).requires_grad_(True)
    loss = TM.loss_fn(params, cfg, batch, lora=meta.unflatten(flat),
                      lora_scale=LCFG.scale, loss_chunk=chunk)
    (g,) = torch.autograd.grad(loss, flat)
    # each block runs once forward and once more in the backward pass
    assert len(calls) == 2 * cfg.num_layers
    calls.clear()
    flat2 = meta.flatten(lora).requires_grad_(True)
    loss2 = _loss_without_recompute(params, cfg, batch, meta.unflatten(flat2),
                                    LCFG.scale, chunk)
    (g2,) = torch.autograd.grad(loss2, flat2)
    assert torch.equal(loss.detach(), loss2.detach())
    assert torch.equal(g, g2) and bool(g.abs().sum() > 0)
    # with no gradient recorded (serving, eval) the loop runs once
    calls.clear()
    with torch.no_grad():
        TM.loss_fn(params, cfg, batch, lora=meta.unflatten(flat),
                   lora_scale=LCFG.scale, loss_chunk=chunk)
    assert len(calls) == cfg.num_layers


# with recomputation the forward keeps the layer inputs (L x (B, S, D),
# which each recomputed block saves) and what lies outside the blocks: the
# final norm's input and statistics and the token ids; without it, every
# block's activations (over 10 x (B, S, D) a layer here)
SAVED_MULTIPLE = 2


def _saved_bytes(params, lora, fn):
    """Bytes of the distinct storages that autograd saves for the backward
    pass while fn() runs, the backbone's weights left out (they are held
    anyway); the LoRA vector's storage is counted."""
    weights = {t.untyped_storage().data_ptr()
               for t in TL.tree_leaves(params)}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in weights:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@pytest.mark.parametrize("cfg,S", [(CFG, 16), (LONG, 64), (HYMBA, 64)],
                         ids=["short", "long", "hymba"])
def test_recomputation_bounds_the_saved_activations(cfg, S):
    params, lora, meta = _model(cfg)
    batch = _batch(cfg, 2, S)
    B, L, D = 2, cfg.num_layers, cfg.d_model
    layer_inputs = L * B * S * D * 4
    flat = meta.flatten(lora).requires_grad_(True)
    bound = SAVED_MULTIPLE * layer_inputs + flat.numel() * 4

    def with_recompute():
        TM.forward(params, cfg, batch, lora=meta.unflatten(flat),
                   lora_scale=LCFG.scale, want_logits=False)

    def without():
        x = TM.embed_tokens(params, cfg, batch["tokens"])
        for _, _, kind, lp, ll, _ in TM._layers(cfg, params,
                                                meta.unflatten(flat)):
            x, _ = TM.block_forward(lp, x, cfg, kind, lora=ll, ls=LCFG.scale)
        TL.rms_norm(x, params["final_norm"], cfg.norm_eps)

    kept = _saved_bytes(params, lora, with_recompute)
    full = _saved_bytes(params, lora, without)
    assert kept <= bound < full, (kept, bound, full)
