"""The port's pack codec, the two pack kernels' plain versions and the
server-side accumulate against the reference, on the CPU.

Every comparison here is BITWISE (raw f32 words, or integers):
  - `pack_values`, `pack_values_batch` (its CPU path is the plain version
    of the batched pack kernel) and `unpack_values` against the
    reference's `pack_values`, `vmap(pack_values)` and `pack_values_batch`
    (its Pallas kernel in interpret mode), on ragged lengths, overflowing
    capacities, all-zero rows and rows holding -0.0;
  - `sparse_accumulate` and `hierarchical_accumulate` (edges 1, 2, 3, 7)
    against the reference's, and the hierarchical form against the flat
    one: the f32 adds of each coordinate associate in the same row-major
    order in both packages;
  - `Strategy.aggregate_sparse` against the reference's jitted one on the
    same packed rows, odd cohorts included (XLA folds `acc / C` into a
    multiply by the f32 reciprocal);
  - kernel 7's plain version and `FusedSelector.sparsify_quantized_packed`
    against the reference's selector with its Pallas kernel in interpret
    mode: bits 0 and 4, nearest and stochastic rounding (the same uniform
    draw injected), k in {0, 1, n/4, n}, a tied row that overflows its
    capacity, and a row where survivors quantize to zero.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import selectors as jsel
from repro.core import strategies as jst
from repro.kernels import fused_transport as jft
from repro_torch.core import comm as tcomm
from repro_torch.core import selectors as tsel
from repro_torch.core import strategies as tst
from repro_torch.kernels import fused_transport as tft


def _words(a):
    """Raw 32-bit words of a f32 array (so -0.0 != +0.0)."""
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sparse_rows(seed, B, n, density, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n), dtype=np.float32)
    x = np.where(rng.random((B, n)) < density, x, np.float32(0.0))
    if kind == "negzero":       # -0.0 entries must not be packed
        x = np.where(rng.random((B, n)) < 0.3, np.float32(-0.0), x)
    elif kind == "zeros":
        x[:] = 0.0
    return np.ascontiguousarray(x, np.float32)


@pytest.mark.parametrize("n,cap,kind", [
    (50, 20, "normal"), (4097, 1300, "normal"), (4097, 1300, "negzero"),
    (3000, 40, "normal"), (3000, 900, "zeros")])
def test_pack_codec_matches_reference_bitwise(n, cap, kind):
    """cap 40 at n 3000 overflows every row; n 4097 is ragged."""
    x = _sparse_rows(n + cap, 3, n, 0.25, kind)
    if kind == "zeros":
        x[1] = _sparse_rows(1, 1, n, 0.25)[0]       # one row not empty
    ridx, rval, rnnz = jax.jit(jax.vmap(lambda v: jft.pack_values(v, cap)))(x)
    bidx, bval, bnnz = jft.pack_values_batch(jnp.asarray(x), cap)
    np.testing.assert_array_equal(np.asarray(bidx), np.asarray(ridx))
    np.testing.assert_array_equal(_words(bval), _words(rval))
    tidx, tval, tnnz = tft.pack_values_batch(_t(x), cap)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(_words(tval), _words(rval))
    np.testing.assert_array_equal(tnnz.numpy(), np.asarray(rnnz))
    assert (tnnz > cap).any() == (cap == 40)
    for b in range(3):
        i, v, c = tft.pack_values(_t(x[b]), cap)
        assert torch.equal(i, tidx[b]) and torch.equal(v, tval[b])
        assert int(c) == int(rnnz[b])
        got = tft.unpack_values(i, v, n)
        want = jft.unpack_values(ridx[b], rval[b], n)
        np.testing.assert_array_equal(_words(got), _words(want))
    if kind == "negzero":       # the keep rule is a float compare
        assert int(tnnz.sum()) == int((x != 0).sum())
    # an explicit mask keeps what it says, zeros included
    mask = np.abs(x[0]) < 1.0
    i, v, c = tft.pack_values(_t(x[0]), cap, mask=_t(mask))
    ri, rv, rc = jax.jit(lambda a, m: jft.pack_values(a, cap, mask=m))(
        x[0], mask)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_words(v), _words(rv))
    assert int(c) == int(rc)


@pytest.mark.parametrize("C", [3, 4, 5])
def test_accumulate_and_aggregate_sparse_match_reference(C):
    n = 5001
    cap = tcomm.pack_capacity(n, n // 4)
    x = _sparse_rows(C, C, n, 0.25, "negzero")
    idx, val, _ = tft.pack_values_batch(_t(x), cap)
    jidx, jval = jnp.asarray(idx.numpy()), jnp.asarray(val.numpy())
    flat = tft.sparse_accumulate(idx, val, n)
    want = jax.jit(lambda i, v: jft.sparse_accumulate(i, v, n))(jidx, jval)
    np.testing.assert_array_equal(_words(flat), _words(want))
    for edges in (1, 2, 3, 7):
        got = tft.hierarchical_accumulate(idx, val, n, edges)
        ref = jax.jit(lambda i, v: jft.hierarchical_accumulate(
            i, v, n, edges))(jidx, jval)
        np.testing.assert_array_equal(_words(got), _words(flat))
        np.testing.assert_array_equal(_words(got), _words(ref))
    for edges in (0, 3):
        kw = dict(sparse_aggregate=True, edge_shards=edges)
        tstrat = tst.resolve(tst.StrategySpec(**kw))
        jstrat = jst.resolve(jst.StrategySpec(**kw))
        got = tstrat.aggregate_sparse(idx, val, tst.PlanContext(n, C))
        want = jax.jit(lambda i, v: jstrat.aggregate_sparse(
            i, v, jst.PlanContext(n, C)))(jidx, jval)
        np.testing.assert_array_equal(_words(got), _words(want))
    # the sparse sum is the dense sum (all in range, no overflow)
    np.testing.assert_allclose(flat.numpy(), x.sum(0), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="edges"):
        tft.hierarchical_accumulate(idx, val, n, 0)


def _packed_reference(k, bits, stochastic, cap):
    sel_ = jsel.FusedSelector(levels=12, block=1024, interpret=True)

    def run(v, key):
        return sel_.sparsify_quantized_packed(
            v, count=k, bits=bits, key=key if stochastic else None, cap=cap)
    return jax.jit(run)


def _packed_rows(n):
    """name -> (n,) f32 row: normal draws; a tied row (16 distinct
    magnitudes); a row whose one outlier sets the scale so high that the
    other survivors quantize to zero at 4 bits."""
    rng = np.random.default_rng(n)
    normal = rng.standard_normal(n, dtype=np.float32)
    tied = rng.integers(-4, 5, n).astype(np.float32) * np.float32(0.5)
    outlier = rng.standard_normal(n, dtype=np.float32)
    outlier[n // 3] = np.float32(100.0)
    return {"normal": normal, "tied": tied, "outlier": outlier}


@pytest.mark.parametrize("bits,stochastic", [(0, False), (4, False),
                                             (4, True)])
def test_sparsify_quantized_packed_matches_reference(bits, stochastic):
    n = 3000
    rows = _packed_rows(n)
    key = jax.random.key(bits + 11)
    u = _t(np.asarray(jax.random.uniform(key, (n,)))) if stochastic else None
    sel_ = tsel.FusedSelector(levels=12)
    zero_survivors = 0
    for name, x in rows.items():
        for k in (0, 1, n // 4, n):
            # the tied row keeps every entry tied at the threshold: a cap
            # of k + 8 overflows there
            cap = k + 8 if name == "tied" else tcomm.pack_capacity(n, k)
            ref = _packed_reference(k, bits, stochastic, cap)
            wv, wn, wi, wval = ref(jnp.asarray(x), key)
            gv, gn, gi, gval = sel_.sparsify_quantized_packed(
                _t(x), count=k, bits=bits, rng=u, cap=cap)
            what = f"{name} k={k}"
            np.testing.assert_array_equal(_words(gv), _words(wv),
                                          err_msg=what)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi),
                                          err_msg=what)
            np.testing.assert_array_equal(_words(gval), _words(wval),
                                          err_msg=what)
            assert int(gn) == int(wn), what
            if k == 0:
                assert (gi == n).all() and int(gn) == 0
            if name == "tied" and 0 < k < n:
                assert int(gn) > cap, what          # overflow flagged
            slots = gi < n
            zero_survivors += int((gval[slots] == 0).sum())
            # a survivor that quantized to zero keeps its slot: the pack
            # holds every survivor, the value codec only the nonzero ones
            _, _, pn = tft.pack_values(gv, cap)
            if int(gn) <= cap:
                assert int(slots.sum()) == int(gn)
                got = tft.unpack_values(gi, gval, n)
                np.testing.assert_array_equal(got.numpy(), gv.numpy())
            assert int(pn) <= int(gn)
    if bits:
        assert zero_survivors > 0      # the outlier row exercised the trap


def _same_words(got, want):
    """Bitwise equal f32 arrays, NaN compared as NaN (a NaN's sign and
    payload are the platform's)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_words(got[~nan]), _words(want[~nan]))


@pytest.mark.parametrize("bits,stochastic,rows", [
    (0, False, "normal"), (4, True, "normal"), (4, True, "overflow"),
    (8, False, "normal"), (4, True, "nonfinite"), (4, False, "nonfinite"),
], ids=["0-False", "4-True", "4-True-overflow", "8-False",
        "4-True-nonfinite", "4-False-nonfinite"])
def test_mask_quantize_pack_plain_matches_pallas_kernel(bits, stochastic,
                                                        rows):
    """The plain version against the Pallas kernel itself (interpret mode,
    the row zero-padded to the block), on (B, n) rows with per-row
    thresholds and scales, sentinel n: the cases the CUDA kernel is held
    to.  "overflow": every row overflows its capacity; "nonfinite": rows
    holding +-inf and NaN elements (NaN is dropped, +-inf kept), one of
    them at the inf scale a row holding an inf gets (its survivors
    quantize to NaN)."""
    n, block, B = 2500, 1024, 3
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((B, n), dtype=np.float32)
    x[2, 7] = np.float32(50.0)                  # survivors round to zero
    u = rng.random((B, n), dtype=np.float32)
    pad = -n % block
    hi0 = np.abs(x).max(-1)
    thr = (hi0 * np.float32(0.3)).astype(np.float32)
    qscale = np.maximum(hi0 * np.float32(1.0 / 7.0), 1e-12).astype(np.float32)
    cap = 40 if rows == "overflow" else 300
    if rows == "overflow":
        thr = (hi0 * np.float32(0.05)).astype(np.float32)
    if rows == "nonfinite":
        x[0, [3, 400, 2499]] = [np.inf, -np.inf, np.nan]
        x[1, [0, 1025, 2048]] = [-np.inf, np.nan, np.inf]
        qscale[1] = np.float32(np.inf)
    got = tft.fused_mask_quantize_pack(
        _t(x), _t(thr), _t(qscale), _t(u) if stochastic else None, bits, cap)
    for b in range(B):
        want = jax.jit(lambda v, uu: jft.fused_mask_quantize_pack_pallas(
            jnp.pad(v, (0, pad)), thr[b], qscale[b],
            jnp.pad(uu, (0, pad)) if stochastic else None, bits, cap, n,
            block=block, interpret=True))(x[b], u[b])
        _same_words(got[0][b], want[0][:n])
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
        _same_words(got[2][b], want[2])
        assert int(got[3][b]) == int(want[3])
    if rows == "overflow":
        assert (got[3] > cap).all()
    else:
        assert (got[3] > cap).any() and (got[3] <= cap).any()
    if rows == "nonfinite":
        assert not bool(torch.isnan(got[0][0]).any())
        assert bool(torch.isnan(got[2][1][got[1][1] < n]).all())
