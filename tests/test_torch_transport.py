"""The port's Top-K transport against the reference, on the CPU: the plain
versions of the five transport kernels, `threshold_from_bins`, the four
selectors, the fused stage and the byte ledger.

Every comparison here is BITWISE (raw f32 words, or integers): counts and
bins are integer sums, absmax a max, and the masked / quantized values
elementwise f32 chains with the same IEEE ops in both packages.  The
reference's Pallas kernels run as its own tests run them, in interpret
mode with a small explicit block.  Inputs are numpy draws from a seed in
the normal f32 range (XLA's CPU flushes subnormals to zero, torch does
not), and stochastic rounding gets the same uniform draw `u` in both.
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import selectors as jsel
from repro.core import strategies as jst
from repro.core import transport as jtp
from repro.kernels import fused_transport as jft
from repro.kernels import topk_mask as jtm
from repro_torch.core import comm as tcomm
from repro_torch.core import quantization as tqz
from repro_torch.core import selectors as tsel
from repro_torch.core import strategies as tst
from repro_torch.core import transport as ttp
from repro_torch.kernels import fused_transport as tft
from repro_torch.kernels import topk_mask as ttm

LEVELS = 12
BLOCKS = {50: 128, 4096: 1024, 70001: 8192}


def _words(a):
    """Raw 32-bit words of a f32 array (so -0.0 != +0.0 and NaN == NaN)."""
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(seed, B, n, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        x = np.zeros((B, n), np.float32)
    elif kind == "ties":
        x = rng.integers(-3, 4, (B, n)).astype(np.float32) * np.float32(0.5)
    else:
        x = rng.standard_normal((B, n), dtype=np.float32)
    return x, rng.random((B, n), dtype=np.float32)


def _reference_passes(n):
    """One jitted reference row: the five Pallas kernels in interpret mode
    on the zero-padded row (the selector layer's padding)."""
    block = BLOCKS[n]
    pad = -n % block

    def row(x, t, scale, u):
        xp = jnp.pad(x, (0, pad))
        up = jnp.pad(u, (0, pad))
        hi0 = jft.absmax_pallas(jnp.abs(xp), block=block, interpret=True)
        hist = jft.bin_counts_pallas(jnp.abs(xp), hi0, LEVELS, block=block,
                                     interpret=True)
        cnt = jtm.threshold_count_pallas(xp, t, block=block, interpret=True)
        masked, kept = jtm.topk_mask_pallas(xp, t, block=block, interpret=True)
        fused = {}
        for bits in (0, 4, 8):
            for stoch in (False, True):
                if stoch and not bits:
                    continue
                v, c = jft.fused_mask_quantize_pallas(
                    xp, t, scale, up if stoch else None, bits, block=block,
                    interpret=True)
                fused[bits, stoch] = (v[:n], c)
        return hi0, hist, cnt, masked[:n], kept, fused

    return jax.jit(row)


@pytest.fixture(scope="module")
def reference_rows():
    return {n: _reference_passes(n) for n in BLOCKS}


# every length and row count on normal draws; the edge rows (heavy ties,
# all zeros) at n = 4096, which needs no block padding
@pytest.mark.parametrize("n,B,kind", [
    (n, B, "normal") for n in sorted(BLOCKS) for B in (1, 3)] + [
    (4096, 3, "ties"), (4096, 1, "zeros")])
def test_plain_kernels_match_pallas_bitwise(reference_rows, n, B, kind):
    x, u = _draw(n + B, B, n, kind)
    tx, tu = _t(x), _t(u)
    hi0 = tft.absmax(tx)
    t = hi0 * 0.3
    qscale = torch.clamp_min(hi0 / 7.0, 1e-12)
    hist = tft.bin_counts(tx, hi0, LEVELS)
    cnt = ttm.threshold_count(tx, t)
    masked, kept = ttm.topk_mask(tx, t)
    for b in range(B):
        r_hi0, r_hist, r_cnt, r_masked, r_kept, r_fused = reference_rows[n](
            x[b], t[b].numpy(), qscale[b].numpy(), u[b])
        assert _words(hi0[b]) == _words(r_hi0)
        # the reference's pad zeros land in bin 0; no threshold reads it
        np.testing.assert_array_equal(hist[b, 1:].numpy(),
                                      np.asarray(r_hist)[1:])
        assert hist[b].sum() == n
        assert int(cnt[b]) == int(r_cnt) == int(kept[b]) == int(r_kept)
        np.testing.assert_array_equal(_words(masked[b]), _words(r_masked))
        for (bits, stoch), (r_v, r_c) in r_fused.items():
            scale = qscale if bits else torch.ones_like(qscale)
            v, c = tft.fused_mask_quantize(tx[b], t[b], scale[b],
                                           tu[b] if stoch else None, bits)
            np.testing.assert_array_equal(_words(v), _words(r_v),
                                          err_msg=f"bits={bits} {stoch}")
            assert int(c) == int(r_c)


def test_threshold_from_bins_matches_reference():
    x, _ = _draw(7, 2, 4096)
    tx = _t(x)
    hi0 = tft.absmax(tx)
    hist = tft.bin_counts(tx, hi0, LEVELS)
    ks = [0, 1, 100, 1024, 4095, 4096]
    for b in range(2):
        for k in ks:
            got = tft.threshold_from_bins(hist[b], hi0[b], k, LEVELS)
            want = jft.threshold_from_bins(jnp.asarray(hist[b].numpy()),
                                           jnp.asarray(hi0[b].numpy()),
                                           jnp.asarray(k, jnp.int32), LEVELS)
            assert _words(got) == _words(want), (b, k)
    # one (B, 2^L) replay with per-row counts equals the row-by-row replays
    k = torch.tensor([5, 4000], dtype=torch.int32)
    both = tft.threshold_from_bins(hist, hi0, k, LEVELS)
    for b in range(2):
        assert _words(both[b]) == _words(
            tft.threshold_from_bins(hist[b], hi0[b], int(k[b]), LEVELS))


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_fused_equals_histogram_inside_the_port(kind):
    x, u = _draw(11, 4, 1000, kind)
    tx, tu = _t(x), _t(u)
    k = torch.tensor([0, 1, 250, 1000], dtype=torch.int32)
    # equal values and counts, as the reference pins it: the histogram
    # form writes x * False = -0.0 where the mask form writes 0.0
    got, gn = tsel.FusedSelector(levels=LEVELS).sparsify_by_count(tx, k)
    want, wn = tsel.HistogramSelector(iters=LEVELS).sparsify_by_count(tx, k)
    assert torch.equal(got, want) and torch.equal(gn, wn)
    got, gn = tsel.PallasSelector(iters=LEVELS).sparsify_by_count(tx, k)
    assert torch.equal(got, want) and torch.equal(gn, wn)
    # the fused quantizing pass equals Top-K then quantize_roundtrip
    for bits, rng in ((4, tu), (8, None)):
        got, gn = tsel.FusedSelector().sparsify_quantized(
            tx, count=k, bits=bits, rng=rng)
        two = tqz.quantize_roundtrip(want, bits, rng) * (k > 0)[:, None]
        assert torch.equal(got, two) and torch.equal(gn, wn)


_SELECTORS = {
    "exact": (lambda: jsel.ExactSelector(), lambda: tsel.ExactSelector()),
    "histogram": (lambda: jsel.HistogramSelector(iters=16),
                  lambda: tsel.HistogramSelector(iters=16)),
    "pallas": (lambda: jsel.PallasSelector(iters=12, block=1024),
               lambda: tsel.PallasSelector(iters=12)),
    "fused": (lambda: jsel.FusedSelector(block=1024),
              lambda: tsel.FusedSelector()),
}


@pytest.mark.parametrize("name", sorted(_SELECTORS))
def test_selectors_match_reference_bitwise(name):
    """Per-row counts k = 0, 1, n/4 and n over normal, tied (exact's
    positional tie-break) and all-zero rows."""
    jfac, tfac = _SELECTORS[name]
    js = jfac()
    ref = jax.jit(jax.vmap(js.sparsify_by_count))
    ref_mask = jax.jit(lambda v: js.mask(v, 0.25))
    n = 3000
    k = np.asarray([0, 1, n // 4, n], np.int32)
    for kind in ("normal", "ties", "zeros"):
        x, _ = _draw(len(name), 4, n, kind)
        got, gn = tfac().sparsify_by_count(_t(x), _t(k))
        want, wn = ref(jnp.asarray(x), jnp.asarray(k))
        np.testing.assert_array_equal(_words(got), _words(want),
                                      err_msg=kind)
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        # the density entry points (what the download mask calls)
        gm = tfac().mask(_t(x[1]), 0.25)
        wm = ref_mask(jnp.asarray(x[1]))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("bits", [0, 4])
def test_fused_stage_matches_reference_with_injected_draw(bits):
    """The port's FusedTopKQuantize on (C, n) stacked deltas, with u drawn
    by `jax.random.uniform(key, (n,))` per row as the reference stage draws
    it, equals the reference stage row by row."""
    n, C = 2048, 3
    x, _ = _draw(bits + 5, C, n)
    keys = jax.random.split(jax.random.key(9), C)
    sel_ = jsel.FusedSelector(block=1024)
    stage = jtp.FusedTopKQuantize(density=0.25, bits=bits, selector=sel_)

    @jax.jit
    def ref(v, key):
        msg = stage(jtp.Message.dense(v), key=key)
        return msg.values, msg.nnz
    u = np.stack([np.asarray(jax.random.uniform(kk, (n,))) for kk in keys])
    msg = ttp.FusedTopKQuantize(density=0.25, bits=bits)(
        ttp.Message.dense(_t(x)), rng=_t(u) if bits else None)
    for c in range(C):
        values, nnz = ref(jnp.asarray(x[c]), keys[c])
        np.testing.assert_array_equal(_words(msg.values[c]), _words(values))
        assert int(msg.nnz[c]) == int(nnz)
    assert msg.value_bits == stage(jtp.Message.dense(jnp.zeros(8)),
                                   key=keys[0]).value_bits


def test_pipelines_and_wire_format_match_reference():
    spec_kw = [dict(), dict(quant_bits_up=4), dict(quant_bits_down=8),
               dict(lowrank_up=4, quant_bits_up=4), dict(lowrank_down=2)]
    for kw in spec_kw:
        for n in (10, 4096, 9_830_400):
            for d in ("down", "up"):
                assert ttp.wire_format(tst.StrategySpec(**kw), n, d) == \
                    jtp.wire_format(jst.StrategySpec(**kw), n, d), (kw, n, d)
    assert ttp.registered_stages() == jtp.registered_stages()
    assert tsel.registered_selectors() == jsel.registered_selectors()
    rule = tst.UploadRule.topk(0.25)
    pipe = ttp.upload_pipeline(rule, 4, selector="fused")
    assert [type(s).__name__ for s in pipe.stages] == ["FusedTopKQuantize"]
    pipe = ttp.upload_pipeline(rule, 4, selector="histogram")
    assert [s.stage_name for s in pipe.stages] == ["topk", "quantize"]
    # the lowrank stage on a batch of rows: the reference's shape and bill
    x = np.random.default_rng(2).standard_normal((3, 100), dtype=np.float32)
    stage = ttp.lowrank_stage(tst.StrategySpec(lowrank_up=4), "up")
    jstage = jtp.lowrank_stage(jst.StrategySpec(lowrank_up=4), "up")
    msg = stage(ttp.Message.dense(_t(x)))
    jmsg = jstage(jtp.Message.dense(jnp.asarray(x[0])))
    assert msg.values.shape == (3, 100) and msg.nnz.tolist() == [40.0] * 3
    assert float(jmsg.nnz) == 40.0 and msg.value_bits == jmsg.value_bits
    assert stage.wire(100, 32.0, False) == jstage.wire(100, 32.0, False)


def test_comm_ledger_bytes_match_reference():
    rng = np.random.default_rng(0)
    for kw in (dict(), dict(up_value_bytes=0.5), dict(down_dense=True)):
        jl = jcomm.CommLedger(total_params=9_830_400, **kw)
        tl = tcomm.CommLedger(total_params=9_830_400, **kw)
        for _ in range(3):
            down = [float(v) for v in rng.integers(0, 9_830_400, 4)]
            up = [float(v) for v in rng.integers(0, 9_830_400, 4)]
            for led in (jl, tl):
                led.record_round(4, sum(down) / 4, sum(up),
                                 down_per_message=down, up_per_message=up)
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
        assert (jl.total_coded_bytes, jl.total_bytes) == \
            (tl.total_coded_bytes, tl.total_bytes)
    assert tcomm.pack_capacity(9_830_400, 2_457_600) == \
        jcomm.pack_capacity(9_830_400, 2_457_600)


def test_spec_migration_and_unported_kinds():
    with pytest.warns(DeprecationWarning):
        spec = tst.StrategySpec(exact_topk=False)
    assert spec.selector == "histogram" and spec.exact_topk is None
    with pytest.raises(ValueError, match="unknown selector"):
        tst.StrategySpec(selector="sorted")
    assert tst.resolve(tst.StrategySpec(kind="hetlora")).kind == "hetlora"
    with pytest.raises(ValueError, match="unknown strategy kind"):
        tst.resolve(tst.StrategySpec(kind="hetlora_v2"))
    assert tst.resolve("lora").kind == "lora"
    assert tst.sparse_aggregate_capacity(
        tst.resolve(tst.StrategySpec(sparse_aggregate=True)), 9_830_400) == \
        jst.sparse_aggregate_capacity(
            jst.resolve(jst.StrategySpec(sparse_aggregate=True)), 9_830_400)
    x, _ = _draw(17, 1, 3000)
    got = tsel.FusedSelector().sparsify_quantized_packed(
        _t(x[0]), count=750, cap=900)
    want = jax.jit(lambda v: jsel.FusedSelector(
        block=1024, interpret=True).sparsify_quantized_packed(
            v, count=750, cap=900))(jnp.asarray(x[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_sparsity_helpers_and_byte_formulas_match_reference():
    """`threshold_exact` bitwise on tied rows; `density_of` (an f32 mean,
    summed in another order by each library) to rtol 1e-6; the
    closed-form byte helpers equal, over densities and widths."""
    from repro.core import quantization as jqz
    from repro.core import sparsity as jsp
    from repro_torch.core import sparsity as tsp
    x, _ = _draw(13, 3, 999, "ties")
    x[1, :500] = 0.0
    for d in (0.01, 0.25, 0.5, 1.0):
        got = tsp.threshold_exact(_t(np.abs(x)), d)
        want = jax.jit(lambda a: jsp.threshold_exact(a, d))(np.abs(x))
        np.testing.assert_array_equal(_words(got), _words(want))
    np.testing.assert_allclose(tsp.density_of(_t(x)).numpy(),
                               np.asarray(jsp.density_of(jnp.asarray(x))),
                               rtol=1e-6)
    for nnz in (0, 7, 2_457_600):
        for bits in (0, 2, 4, 8, 32):
            assert tqz.message_bytes(nnz, bits) == jqz.message_bytes(nnz, bits)
        for vb, dense in ((4, False), (0.5, False), (1, True)):
            assert tcomm.coded_message_bytes(nnz, 9_830_400, 1, vb, dense) == \
                jcomm.coded_message_bytes(nnz, 9_830_400, 1, vb, dense)
    assert tcomm.lora_dense_bytes(9_830_400) == \
        jcomm.lora_dense_bytes(9_830_400)
