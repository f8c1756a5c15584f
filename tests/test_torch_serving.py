"""The port's serving slice against the reference: traces, the paged cache's
LRU bookkeeping, the scheduler, and the whole engine on the same converted
weights, adapters and trace (f32, small config of tests/test_serving.py).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as JS
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import serving as TS
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig

CFG = JModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))


def _tiny_adapter(seed, rank=4, d_in=8, d_out=8, layers=2):
    rng = np.random.default_rng(seed)
    return {"g0": {"attn": {"wq": {
        "a": rng.normal(size=(layers, d_in, rank)).astype(np.float32),
        "b": rng.normal(size=(layers, rank, d_out)).astype(np.float32)}}}}


@pytest.mark.parametrize("kw", [
    dict(n_requests=32, n_clients=8, vocab=100, seed=5,
         prompt_buckets=(4, 8), gen_range=(2, 6)),
    dict(n_requests=16, n_clients=8, vocab=64000, seed=0,
         prompt_buckets=(8, 16), gen_range=(4, 12))])
def test_trace_identical_to_reference(kw):
    tr = TS.synth_trace(**kw)
    jr = JS.synth_trace(**kw)
    assert [dataclasses.astuple(r) for r in tr] == \
        [dataclasses.astuple(r) for r in jr]


def test_cache_lru_matches_reference():
    stores = (JS.HostAdapterStore(), TS.HostAdapterStore())
    for c in range(4):
        for s in stores:
            s.put(c, _tiny_adapter(c, rank=2 + c % 3))
    jc = JS.PagedAdapterCache(stores[0], _tiny_adapter(0), pages=2, rank=4)
    tc = TS.PagedAdapterCache(stores[1], _tiny_adapter(0), pages=2, rank=4,
                              device="cpu")
    ops = [("a", 0), ("a", 1), ("a", 2), ("r", 0), ("a", 2), ("a", 1),
           ("r", 1), ("r", 1), ("a", 3), ("a", 0), ("r", 2), ("a", 0),
           ("r", 3), ("a", 1), ("a", 3)]
    for op, c in ops:
        if op == "a":
            assert tc.acquire(c) == jc.acquire(c), (op, c)
        else:
            jc.release(c)
            tc.release(c)
        assert tc.stats() == jc.stats()
    for c in range(4):
        p = tc.page_of(c)
        assert p == jc.page_of(c)
        if p is not None:
            got = TS.page_lora(tc.pool, p)["g0"]["attn"]["wq"]
            want = JS.page_lora(jc.pool, p)["g0"]["attn"]["wq"]
            for k in ("a", "b"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    with pytest.raises(ValueError, match="unpinned"):
        tc.release(2)


def test_cache_rank_padding_and_pool_in_place():
    store = TS.HostAdapterStore()
    low = _tiny_adapter(7, rank=2)
    store.put(0, low)
    cache = TS.PagedAdapterCache(store, _tiny_adapter(0, rank=4), pages=1,
                                 device="cpu")
    leaf = cache.pool["g0"]["attn"]["wq"]["a"]
    p = cache.acquire(0)
    assert cache.pool["g0"]["attn"]["wq"]["a"] is leaf      # written in place
    page = TS.page_lora(cache.pool, p)["g0"]["attn"]["wq"]
    np.testing.assert_array_equal(page["a"][..., :2].numpy(),
                                  low["g0"]["attn"]["wq"]["a"])
    assert torch.all(page["a"][..., 2:] == 0)
    assert torch.all(page["b"][..., 2:, :] == 0)


def test_host_store_disk_roundtrip_with_reference(tmp_path):
    js = JS.HostAdapterStore()
    for c in (3, 11):
        js.put(c, _tiny_adapter(c))
    js.save(str(tmp_path / "ref"))
    back = TS.HostAdapterStore.load(str(tmp_path / "ref"))
    assert back.clients() == [3, 11]
    back.save(str(tmp_path / "port"))
    again = JS.HostAdapterStore.load(str(tmp_path / "port"))
    for c in (3, 11):
        for la, lb, lc in zip(jax.tree.leaves(js.get(c)),
                              jax.tree.leaves(back.get(c)),
                              jax.tree.leaves(again.get(c))):
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_array_equal(la, lc)


def test_scheduler_admission_stall_and_retirement():
    store = TS.HostAdapterStore()
    for c in range(2):
        store.put(c, _tiny_adapter(c))
    cache = TS.PagedAdapterCache(store, store.get(0), pages=1, device="cpu")
    trace = TS.synth_trace(2, 2, 50, seed=0, prompt_buckets=(4,),
                           gen_range=(2, 2))
    # force distinct clients so one page cannot satisfy both at once
    trace = [dataclasses.replace(trace[0], client=0),
             dataclasses.replace(trace[1], client=1)]
    sched = TS.ContinuousBatchingScheduler(trace, cache, n_lanes=2)
    sched.tick(1e9)
    lanes = sched.admit()
    assert len(lanes) == 1 and sched.stalls == 1   # head pinned the only page
    lane = lanes[0]
    assert lane.pos == trace[0].prompt_len and lane.remaining == 1
    sched.push_token(lane, 7)                      # prefill token
    assert lane.active
    sched.push_token(lane, 9)                      # budget spent -> retire
    assert not lane.active and sched.completions[trace[0].rid] == [7, 9]
    lanes = sched.admit()                          # freed pin admits client 1
    assert len(lanes) == 1 and lanes[0].request.client == 1
    sched.push_token(lanes[0], 1)
    sched.push_token(lanes[0], 2)
    assert sched.done() and sched.retired == 2


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _nonzero_lora(cfg, lcfg, seed):
    k = jax.random.fold_in(jax.random.key(1), seed)
    lt = jax_lora.init_lora(cfg, lcfg, k)
    return jax.tree.map(lambda x: x + 0.02 * jax.random.normal(
        jax.random.fold_in(k, 7), x.shape, x.dtype), lt)


@pytest.fixture(scope="module")
def setup():
    """test_serving.py's engine settings: params, 5 adapters, the trace."""
    spec = JM.model_spec(CFG)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(spec, k))(jax.random.key(0)))
    lcfg = JLoRAConfig(rank=4, alpha=8, dtype="float32")
    make = jax.jit(lambda c: _nonzero_lora(CFG, lcfg, c))
    adapters = {c: jax.tree.map(np.asarray, make(c)) for c in range(5)}
    trace = JS.synth_trace(6, 5, CFG.vocab_size, seed=3,
                           prompt_buckets=(4, 8), gen_range=(1, 5))
    return params, lcfg, adapters, trace


def _port_engine(setup, pages=2, n_lanes=2, max_len=16):
    params, lcfg, adapters, _ = setup
    store = TS.HostAdapterStore()
    for c, lt in adapters.items():
        store.put(c, lt)
    cache = TS.PagedAdapterCache(store, store.get(0), pages=pages,
                                 device="cpu")
    return TS.ServingEngine(tree_from_numpy(params, device="cpu"), TCFG, cache,
                            n_lanes=n_lanes, lora_scale=lcfg.scale,
                            max_len=max_len, device="cpu")


def test_engine_matches_reference_engine(setup):
    params, lcfg, adapters, trace = setup
    store = JS.HostAdapterStore()
    for c, lt in adapters.items():
        store.put(c, lt)
    jeng = JS.ServingEngine(jax.tree.map(jnp.asarray, params), CFG,
                            JS.PagedAdapterCache(store, store.get(0), pages=2),
                            n_lanes=2, lora_scale=lcfg.scale, max_len=16)
    want = jeng.run(trace)
    got = _port_engine(setup).run(TS.synth_trace(
        6, 5, CFG.vocab_size, seed=3, prompt_buckets=(4, 8),
        gen_range=(1, 5)))
    assert len(got.completions) == len(trace)
    assert got.completions == want.completions
    assert got.cache == want.cache
    for f in ("steps", "prefills", "decode_tokens", "generated_tokens",
              "mean_occupancy", "stalls"):
        assert getattr(got, f) == getattr(want, f), f


def test_engine_matches_single_adapter_reference(setup):
    params, lcfg, adapters, trace = setup
    rep = _port_engine(setup).run(trace)
    assert len(rep.completions) == len(trace)
    assert rep.cache["hits"] + rep.cache["misses"] > 0
    tp = tree_from_numpy(params, device="cpu")
    with torch.no_grad():
        for req in trace:
            lt = tree_from_numpy(adapters[req.client], device="cpu")
            toks = torch.tensor([req.prompt])
            logits, c = TM.prefill(tp, TCFG, {"tokens": toks}, lora=lt,
                                   lora_scale=lcfg.scale, max_len=16)
            want = [int(torch.argmax(logits[0, -1]))]
            pos = req.prompt_len
            for _ in range(req.gen_len - 1):
                lg, c = TM.decode_step(tp, TCFG, torch.tensor([want[-1]]),
                                       torch.tensor(pos), c, lora=lt,
                                       lora_scale=lcfg.scale)
                want.append(int(torch.argmax(lg[0, 0])))
                pos += 1
            assert rep.completions[req.rid] == want, req


def test_long_prompts_match_reference_engine():
    # the long-prompt slice end to end: the smoke config with its chunked
    # path lowered to 32 tokens (chunks of 16) serves prompts of 32 and 48
    # tokens; completions and cache counters equal the reference engine's
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config as torch_config
    over = dict(chunked_attn_threshold=32, attn_chunk_q=16, attn_chunk_kv=16)
    cfg = dataclasses.replace(jax_config("yi-9b", smoke=True), **over)
    tcfg = dataclasses.replace(torch_config("yi-9b", smoke=True), **over)
    spec = JM.model_spec(cfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JL.init_params(spec, k))(jax.random.key(4)))
    lcfg = JLoRAConfig(rank=4, alpha=8, dtype="float32")
    make = jax.jit(lambda c: _nonzero_lora(cfg, lcfg, c))
    adapters = {c: jax.tree.map(np.asarray, make(c)) for c in range(3)}
    trace = JS.synth_trace(4, 3, cfg.vocab_size, seed=7,
                           prompt_buckets=(32, 48), gen_range=(2, 4))
    assert {r.prompt_len for r in trace} == {32, 48}
    jstore, tstore = JS.HostAdapterStore(), TS.HostAdapterStore()
    for c, lt in adapters.items():
        jstore.put(c, lt)
        tstore.put(c, lt)
    want = JS.ServingEngine(
        jax.tree.map(jnp.asarray, params), cfg,
        JS.PagedAdapterCache(jstore, jstore.get(0), pages=2), n_lanes=2,
        lora_scale=lcfg.scale, max_len=52).run(trace)
    got = TS.ServingEngine(
        tree_from_numpy(params, device="cpu"), tcfg,
        TS.PagedAdapterCache(tstore, tstore.get(0), pages=2, device="cpu"),
        n_lanes=2, lora_scale=lcfg.scale, max_len=52, device="cpu").run(trace)
    assert len(got.completions) == len(trace) == 4
    assert got.completions == want.completions
    assert got.cache == want.cache
    for f in ("steps", "prefills", "decode_tokens", "generated_tokens",
              "mean_occupancy", "stalls"):
        assert getattr(got, f) == getattr(want, f), f


def test_cli_serves_every_request_on_cpu(capsys):
    rep = torch_serve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                            "--requests", "6", "--clients", "3",
                            "--pages", "2", "--lanes", "2"])
    assert len(rep.completions) == rep.requests == 6
    out = capsys.readouterr().out
    assert "6/6 requests served" in out and "hit-rate" in out
