"""The port's Top-K strategy kinds against the reference, on the CPU:
`flasc_ef`, `sparse_adapter`, `fedselect` and `adapter_lth`, each through
both packages' `SimEngine` from the same converted state (the harness and
its tolerances: `tests/_fed_parity.py`), under the `exact` and `fused`
selectors, with no quantization (no random draws); plus the registry and
the static rank map.

Bitwise, each package computing it from the same reference flat vector and
state: every round's download mask, the sparse adapter's one pruning mask
and each of the lottery ticket's pruning steps (mask, density, pruned
vector).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import numpy as np
import pytest
import torch

from _fed_parity import (build_model, compare, download_masks_equal,
                         post_round_equal, run_pair)
from repro.core import fedround as jfr
from repro.core import strategies as jst
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.core import fedround as tfr
from repro_torch.core import sparsity as tsp
from repro_torch.core import strategies as tst

SELECTORS = ("exact", "fused")


@pytest.fixture(scope="module")
def model():
    return build_model()


def _meta(model):
    return tfr.FlatMeta.of({"lora": model["tlora"]})


def test_every_reference_kind_resolves():
    assert tst.registered_kinds() == jst.registered_kinds()
    assert not hasattr(tst, "UNPORTED_KINDS")
    for kind in jst.registered_kinds():
        strat = tst.resolve(kind)
        assert strat.kind == kind and type(strat).__name__ == type(
            jst.resolve(kind)).__name__
        assert strat.spec == tst.StrategySpec(**{
            f: getattr(jst.resolve(kind).spec, f)
            for f in tst.StrategySpec.__dataclass_fields__})
    with pytest.raises(ValueError, match="unknown strategy kind"):
        tst.StrategySpec(kind="fedprox")


@pytest.mark.parametrize("selector", SELECTORS)
def test_flasc_ef_matches_reference(model, selector):
    spec = dict(kind="flasc_ef", selector=selector)
    jrun, trun, flat0, sst0 = run_pair(model, spec, rounds=2)
    download_masks_equal(jrun.strat, trun.strat, flat0, sst0, jrun)
    compare("flasc_ef", jrun, trun, _meta(model))
    # the residual is the unsent part of the corrected vector
    e = trun.sstates[-1]["e"]
    assert (e != 0).any() and np.isfinite(e).all()


@pytest.mark.parametrize("selector", SELECTORS)
def test_fedselect_matches_reference(model, selector):
    spec = dict(kind="fedselect", selector=selector)
    jrun, trun, flat0, sst0 = run_pair(model, spec, rounds=2)
    download_masks_equal(jrun.strat, trun.strat, flat0, sst0, jrun)
    exact = compare("fedselect", jrun, trun, _meta(model))
    for r in exact:             # uploads stay inside the round's mask
        assert trun.strat.kept[r].any()


@pytest.mark.parametrize("selector", SELECTORS)
def test_sparse_adapter_matches_reference(model, selector):
    spec = dict(kind="sparse_adapter", selector=selector, density_down=0.25)
    jrun, trun, flat0, sst0 = run_pair(model, spec, rounds=2)
    compare("sparse_adapter", jrun, trun, _meta(model))
    # round 0 trains densely, then prunes once; round 1 keeps the mask
    assert sst0["initialized"] is False and sst0["mask"].all()
    s0, s1 = trun.sstates
    assert s0["initialized"] is True and s1["initialized"] is True
    np.testing.assert_array_equal(s0["mask"], s1["mask"])
    p_len = flat0.size
    assert s0["mask"].sum() >= tsp.density_count(p_len, 0.25)
    assert (trun.strat.kept[1][:, ~s0["mask"]] == 0).all()
    # the pruning mask from the same flat vector: bitwise
    got = post_round_equal(jrun.strat, trun.strat, jrun.flats[0], sst0, 0)
    assert got["initialized"] is True
    again = post_round_equal(jrun.strat, trun.strat, jrun.flats[1],
                             jrun.sstates[0], 1)
    np.testing.assert_array_equal(again["mask"], jrun.sstates[0]["mask"])


@pytest.mark.parametrize("selector", SELECTORS)
def test_adapter_lth_matches_reference(model, selector):
    spec = dict(kind="adapter_lth", selector=selector, lth_keep=0.9)
    jrun, trun, flat0, sst0 = run_pair(model, spec, rounds=3)
    compare("adapter_lth", jrun, trun, _meta(model))
    p_len = flat0.size
    dens = [float(s["density"]) for s in trun.sstates]
    assert dens == [1.0, np.float32(0.9), np.float32(np.float32(0.9) * 0.9)]
    for r, s in enumerate(trun.sstates):
        # pruned entries are exactly zero and stay pruned
        assert (trun.flats[r][~s["mask"]] == 0).all()
        if r:
            assert not (s["mask"] & ~trun.sstates[r - 1]["mask"]).any()
            k = int(np.clip(np.round(np.float32(p_len) * s["density"]), 1,
                            p_len - 1))
            kept = int(s["mask"].sum())
            print(f"{selector} round {r}: kept {kept}, k {k}")
            assert (kept == k) if selector == "exact" else (kept >= k)
    # each pruning step from the same flat vector and state: bitwise
    for r in (1, 2):
        post_round_equal(jrun.strat, trun.strat, jrun.flats[r],
                         jrun.sstates[r - 1], r)
    post_round_equal(jrun.strat, trun.strat, jrun.flats[0], sst0, 0)


def test_rank_index_map_with_a_head_leaf(model):
    """The flat layout of a LoRA tree plus a classifier head: the rank map,
    is_b (head entries ride B) and FlatMeta offsets equal the reference's."""
    rng = np.random.default_rng(7)
    head = {"cls_head": rng.standard_normal((64, 10), dtype=np.float32),
            "final_norm": rng.standard_normal(64, dtype=np.float32)}
    tree = {"lora": model["lora"], "head": head}
    jrk, jib = jst.rank_index_map(tree)
    trk, tib = tst.rank_index_map(tree_from_numpy(tree, device="cpu"))
    np.testing.assert_array_equal(trk, jrk)
    np.testing.assert_array_equal(tib, jib)
    jmeta = jfr.FlatMeta.of(jax.tree.map(np.asarray, tree))
    tmeta = tfr.FlatMeta.of(tree_from_numpy(tree, device="cpu"))
    assert tmeta.p_len == jmeta.p_len
    np.testing.assert_array_equal(tmeta.rank_idx, jmeta.rank_idx)
    n_head = 64 * 10 + 64
    assert (tib[:n_head] == 1).all() and (trk[:n_head] == 0).all()
    assert set(np.unique(trk)) == {0, 1, 2, 3}


def test_hetlora_coverage_and_weighted_aggregate(model):
    """`coverage` over the full cohort and over cohort slots (a repeated
    slot counts twice), and the weighted rule on random deltas, against the
    reference (rtol 1e-6: one division each)."""
    meta_j = jfr.FlatMeta.of({"lora": model["lora"]})
    meta_t = _meta(model)
    ranks = (1, 2, 2, 3)
    kw = dict(kind="hetlora", hetlora_ranks=ranks, hetlora_weighted=True)
    js, ts = jst.resolve(jst.StrategySpec(**kw)), tst.resolve(
        tst.StrategySpec(**kw))
    deltas = np.random.default_rng(3).standard_normal(
        (4, meta_t.p_len), dtype=np.float32)
    for slots in (None, (0, 3, 3), (1,)):
        n = 4 if slots is None else len(slots)
        jctx = meta_j.plan_context(4, round_idx=0, cohort_slots=slots)
        tctx = meta_t.plan_context(4, round_idx=0, cohort_slots=slots)
        np.testing.assert_array_equal(ts.coverage(tctx), js.coverage(jctx))
        want = jax.jit(lambda d: js.aggregate(d, jctx))(deltas[:n])
        got = ts.aggregate(torch.from_numpy(deltas[:n]), tctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    cov = ts.coverage(meta_t.plan_context(4))
    assert cov.max() == 4 and cov.min() == 0
    assert not ts.uniform_aggregation and tst.resolve("hetlora") \
        .uniform_aggregation
