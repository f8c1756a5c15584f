"""Training at `chunked_attn_threshold` tokens or more: the attention
gradient and the per-layer recomputation, on the CPU at small sizes.

  - The port's `chunked_attention` differentiated by autograd against
    `jax.grad` of the reference's, w.r.t. q, k and v, in f32, on both of
    the reference's branches (the `fori_loop` that skips the kv chunks
    above the diagonal, and the `lax.map` of scans): rtol 1e-5, atol 1e-6
    (the two packages' CPU einsums and exponentials round in other places).
  - `flash_attention_bwd_plain`, the backward kernels' function, against
    autograd of `flash_attention_plain` in f64 (causal and full, GQA,
    ragged S and T): rtol 1e-10, atol 1e-12, both exact up to f64
    rounding; and in f64 against the reference's f32 gradient of (1) at
    (1)'s tolerance.
  - `models/model.py::forward` recomputes each block in the backward pass
    (the reference's `jax.checkpoint` of its layer scan): the LoRA gradient
    of `loss_fn` equals bit for bit that of the same layer loop run without
    recomputation, and a training forward saves for the backward pass no
    more than the layer inputs plus a few (B, S, D) tensors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
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
    q, k, v, dout = (torch.from_numpy(a).double()
                     for a in _qkv(S + T, B, S, T, H, KV, hd))
    scale = hd ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                        return_lse=True)
    assert out.dtype == lse.dtype == torch.float64 and lse.shape == (B, H, S)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=causal, scale=scale),
        leaves, dout)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F64_TOL,
                                   err_msg=name)
    # the CPU path of the wrapper is the plain backward
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_flash_bwd_plain_matches_reference_gradient():
    (q, k, v, dout), want = _case_and_jax_grads(64)
    tq, tk, tv, tdo = (torch.from_numpy(a).double() for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                        scale=0.25, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                       causal=True, scale=0.25)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


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


@pytest.mark.parametrize("cfg,S", [(CFG, 16), (LONG, 64)],
                         ids=["short", "long"])
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
        gp, gl = params["groups"]["g0"], meta.unflatten(flat)["g0"]
        for i in range(L):
            x, _ = TM.block_forward(TL.layer_slice(gp, i), x, cfg,
                                    lora=TL.layer_slice(gl, i),
                                    ls=LCFG.scale)
        TL.rms_norm(x, params["final_norm"], cfg.norm_eps)

    kept = _saved_bytes(params, lora, with_recompute)
    full = _saved_bytes(params, lora, without)
    assert kept <= bound < full, (kept, bound, full)
