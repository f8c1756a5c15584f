"""The port's `kernels/ref.py` and `kernels/ops.py` against the reference's,
on the CPU (where each ops wrapper runs its kernel's plain version).
Inputs are made with numpy from a seed and fed to both packages.

Tolerances are those of the reference's own kernel tests
(tests/test_kernels.py): attention 2e-6 in f32 and 2e-2 in bf16, the
LoRA matmul 1e-5 in f32 and 5e-2 in bf16; the two CPU backends sum in
different orders.  Masks, counts and the bisection threshold are exact.
The flash kernel's plain version keeps the probabilities in f32, as the
Pallas kernel does: in bf16 each of its output rows holds to 4e-3 of the
row's largest value against an f64 attention (the output's rounding to
bf16 allows 2^-8 = 3.9e-3), which the reference's oracle, rounding p to
bf16, misses; and it is within one bf16 ulp of the row's largest value
(2^-7) of the reference's `chunked_attention`.

The JAX side of `ops.lora_matmul` runs the Pallas kernel in interpret mode
at shapes that tile (as tests/test_kernels.py does) and its oracle at
ragged ones.  Attention is held against the reference's oracle and, at a
ragged length, against its `ops.flash_attention` (which takes the oracle
there), never against the Pallas flash kernel itself: on this jax
(0.9.0) `pl.load` is gone and its interpret run fails
(`test_flash_attention_kernel`, ROADMAP queue 3).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_transport as jft
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk_mask import BLOCK
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_transport as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"f32": 2e-6, "bf16": 2e-2}
LORA_TOL = {"f32": 1e-5, "bf16": 5e-2}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _pair(a, dt):
    """One numpy f32 array as (jax array, torch tensor) of dtype `dt`."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape, np.float32)
            * np.float32(scale))


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mask_and_count_oracles_match_reference(dt):
    xj, xt = _pair(_normal(0, 1000), dt)
    for t in (0.0, 0.5, 1.7):
        got = tref.topk_mask_ref(xt, torch.tensor(t, dtype=xt.dtype))
        want = jref.topk_mask_ref(xj, jnp.asarray(t, xj.dtype))
        np.testing.assert_array_equal(_np(got), _np(want))
        assert int(tref.threshold_count_ref(xt, t)) == \
            int(jref.threshold_count_ref(xj, jnp.asarray(t, xj.dtype)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_matmul_oracle_matches_reference(dt):
    arrs = [_normal(i, *s, scale=0.1) for i, s in
            enumerate(((48, 96), (96, 40), (96, 6), (6, 40)))]
    jx, tx = zip(*(_pair(a, dt) for a in arrs))
    got = tref.lora_matmul_ref(*tx, 2.0)
    want = jref.lora_matmul_ref(*jx, 2.0)
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=LORA_TOL[dt],
                               atol=LORA_TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_oracle_matches_reference(dt, causal):
    q, k, v = (_normal(i, 2, 24, 3, 16) for i in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL[dt],
                               atol=ATTN_TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [None, 0.25])
def test_flash_attention_oracle_gqa_matches_reference_prebroadcast(dt, scale):
    # the port's oracle reads kv head h // (H // KV) in place, with the
    # reference's 1 / sqrt(hd) or a given scale (0.25 here: the same); the
    # reference's takes K, V repeated per query head
    q = _normal(60, 2, 24, 6, 16)
    k, v = (_normal(61 + i, 2, 24, 2, 16) for i in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=True, scale=scale)
    want = jref.flash_attention_ref(jq, jnp.repeat(jk, 3, axis=2),
                                    jnp.repeat(jv, 3, axis=2), causal=True)
    assert got.shape == tq.shape and got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL[dt],
                               atol=ATTN_TOL[dt])


# ---------------------------------------------------------------------------
# the ops wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dims", [(128, 256, 128, 8), (100, 300, 200, 5)])
def test_ops_lora_matmul_matches_reference(dims, dt):
    # (128, 256, 128, 8) tiles: the reference runs its Pallas kernel in
    # interpret mode; (100, 300, 200, 5) does not: its oracle
    M, K, N, r = dims
    arrs = [_normal(10 + i, *s, scale=0.1) for i, s in
            enumerate(((M, K), (K, N), (K, r), (r, N)))]
    jx, tx = zip(*(_pair(a, dt) for a in arrs))
    got = tops.lora_matmul(*tx, 2.0)
    want = jops.lora_matmul(*jx, 2.0)
    assert got.shape == (M, N) and got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=LORA_TOL[dt],
                               atol=LORA_TOL[dt])


@pytest.mark.parametrize("n", [2 * BLOCK, 1000])
def test_ops_topk_mask_and_threshold_match_reference_bitwise(n):
    # n = 2 BLOCK runs the reference's Pallas kernels in interpret mode,
    # n = 1000 its oracles
    x = _normal(20 + n, n)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    t_j = jops.histogram_threshold(xj, 0.25, iters=24)
    t_t = tops.histogram_threshold(xt, 0.25, iters=24)
    assert t_t.dtype == torch.float32 and t_t.shape == ()
    assert np.asarray(t_j).view(np.int32) == t_t.numpy().view(np.int32)
    assert torch.equal(t_t, tops.histogram_threshold_plain(xt, 0.25))
    masked_j, nnz_j = jops.topk_mask(xj, t_j)
    masked_t, nnz_t = tops.topk_mask(xt, t_t)
    np.testing.assert_array_equal(masked_t.numpy().view(np.int32),
                                  np.asarray(masked_j).view(np.int32))
    assert int(nnz_t) == int(nnz_j) >= round(0.25 * n)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_matches_reference(dt, causal):
    q, k, v = (_normal(30 + i, 2, 32, 4, 16) for i in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == tq.shape and got.dtype == DTYPES[dt][1]
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL[dt],
                               atol=ATTN_TOL[dt])


def test_ops_flash_attention_ragged_matches_reference_ops():
    # test_kernels.py's ragged case: S = 60 does not tile, so the
    # reference's ops.flash_attention takes its oracle
    q = _normal(40, 1, 60, 2, 16)
    got = tops.flash_attention(*(torch.from_numpy(q),) * 3)
    want = jops.flash_attention(*(jnp.asarray(q),) * 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-6)


def test_flash_attention_gqa_equals_prebroadcast():
    # the port's GQA wrapper reads KV head h // G; repeating the KV heads
    # per query head (the reference's pre-broadcast layout) gives the
    # same result on the CPU's plain version
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.from_numpy(_normal(50, 2, 40, 6, 32))
    k, v = (torch.from_numpy(_normal(51 + i, 2, 40, 2, 32)) for i in range(2))
    gqa = flash_attention(q, k, v, causal=True, scale=32 ** -0.5)
    pre = tops.flash_attention(q, k.repeat_interleave(3, 2),
                               v.repeat_interleave(3, 2))
    np.testing.assert_allclose(gqa.numpy(), pre.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the flash kernel's plain version keeps p in f32 (bf16, hd 128; S = T = 512,
# and 1025, one row past eight 128-row tiles: the wgmma kernel's last block
# then holds a single query row)
# ---------------------------------------------------------------------------

F64_ROW_TOL = 4e-3


def _row_err(got, want):
    """The worst output row's largest |got - want| over its largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(-1)
    return float((d / np.maximum(np.abs(want).max(-1), 1e-30)).max())


def _attn_f64(q, k, v, scale):
    """Causal GQA attention of numpy inputs in f64."""
    S, H = q.shape[1], q.shape[2]
    G = H // k.shape[2]
    kd, vd = (np.repeat(t.astype(np.float64), G, axis=2) for t in (k, v))
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kd) * scale
    s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bthd->bshd", p, vd)


def _bf16_qkv(seed, KV, S=512):
    """q (1, S, 4, 128), k and v (1, S, KV, 128), rounded to bf16: the
    torch tensors and the same values as f32 numpy arrays."""
    t = [torch.from_numpy(_normal(seed + i, 1, S, h, 128)).bfloat16()
         for i, h in enumerate((4, KV, KV))]
    return t, [x.float().numpy() for x in t]


@pytest.mark.parametrize("S", [512, 1025])
@pytest.mark.parametrize("KV", [2, 4])
def test_flash_plain_bf16_keeps_p_in_f32(KV, S):
    (tq, tk, tv), (q, k, v) = _bf16_qkv(70 + KV, KV, S)
    exact = _attn_f64(q, k, v, 128 ** -0.5)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True,
                                    scale=128 ** -0.5)
    assert got.dtype == torch.bfloat16
    assert _row_err(got.float().numpy(), exact) <= F64_ROW_TOL
    # the oracle's formula, p rounded to bf16 before the second product,
    # misses the bound: the check sees that rounding
    old = tref.flash_attention_ref(tq, tk, tv, causal=True, scale=128 ** -0.5)
    assert _row_err(old.float().numpy(), exact) > F64_ROW_TOL


# chunks that divide S, as the reference asserts: 1025 = 5 x 205
@pytest.mark.parametrize("S,chunk", [(512, 128), (1025, 205)])
@pytest.mark.parametrize("KV", [2, 4])
def test_flash_plain_bf16_matches_reference_chunked_attention(KV, S, chunk):
    (tq, tk, tv), (q, k, v) = _bf16_qkv(80 + KV, KV, S)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True,
                                    scale=128 ** -0.5)
    want = JA.chunked_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                  for a in (q, k, v)), 128 ** -0.5,
                                causal=True, window=None, cq=chunk, ckv=chunk)
    assert want.dtype == jnp.bfloat16
    assert _row_err(got.float().numpy(), _np(want)) <= 2.0 ** -7


# ---------------------------------------------------------------------------
# the quantize kernels' plain versions keep NaN, as the reference's Pallas
# kernels do (interpret mode), on rows that hold +inf, -inf and NaN
# ---------------------------------------------------------------------------

def _same_nan_and_bits(got, want):
    """NaN at the same places, every other element bit for bit."""
    g, w = (np.ascontiguousarray(a, np.float32) for a in (got, want))
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    np.testing.assert_array_equal(g.view(np.int32)[~nan],
                                  w.view(np.int32)[~nan])


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("scale_of", ["absmax", "finite"])
def test_quantize_plain_keeps_nan_like_reference(scale_of, stochastic):
    # "absmax": the scale of a row that holds an inf is inf, so a kept +-inf
    # gives y = inf / inf = NaN and a kept finite x gives 0 * inf = NaN;
    # "finite": a kept +-inf clips to a bound.  NaN elements fail |x| >= t.
    n, block, cap, bits = 512, 128, 200, 4
    rng = np.random.default_rng(7 + stochastic)
    x = rng.standard_normal((1, n), dtype=np.float32)
    x[0, ::97] = np.where(rng.random(x[0, ::97].shape) < 0.5, -np.inf, np.inf)
    x[0, 5::89] = np.nan
    u = rng.random((1, n), dtype=np.float32)
    top = np.nanmax(np.abs(x)) if scale_of == "absmax" else \
        np.abs(x[np.isfinite(x)]).max()
    scale = np.float32(top) / np.float32(7.0)
    t = np.float32(0.3) * np.abs(x[np.isfinite(x)]).max()
    uu = u if stochastic else None
    tx, tt, ts = (torch.from_numpy(np.array(a, np.float32).reshape(-1))
                  for a in (x, t, scale))
    tu = torch.from_numpy(u) if stochastic else None
    got, cnt = tft.fused_mask_quantize_plain(tx.view(1, n), tt, ts, tu, bits)
    want, wcnt = jft.fused_mask_quantize_pallas(
        jnp.asarray(x[0]), jnp.float32(t), jnp.float32(scale),
        None if uu is None else jnp.asarray(uu[0]), bits, block=block,
        interpret=True)
    _same_nan_and_bits(got[0].numpy(), want)
    assert int(cnt[0]) == int(wcnt)
    got_p = tft.fused_mask_quantize_pack_plain(tx.view(1, n), tt, ts, tu, bits,
                                               cap, n)
    want_p = jft.fused_mask_quantize_pack_pallas(
        jnp.asarray(x[0]), jnp.float32(t), jnp.float32(scale),
        None if uu is None else jnp.asarray(uu[0]), bits, cap, n,
        block=block, interpret=True)
    _same_nan_and_bits(got_p[0][0].numpy(), want_p[0])
    np.testing.assert_array_equal(got_p[1][0].numpy(), np.asarray(want_p[1]))
    _same_nan_and_bits(got_p[2][0].numpy(), want_p[2])
    assert int(got_p[3][0]) == int(want_p[3]) == int(cnt[0])
    # the rows reach the case: NaN out of a kept element only under an inf
    # scale, and the inf elements themselves are kept
    inf_at = np.isinf(x[0])
    assert bool(np.isnan(np.asarray(want))[inf_at].all()) == \
        (scale_of == "absmax")
    assert not np.isnan(np.asarray(want))[np.isnan(x[0])].any()
