"""Multi-tenant serving sweep on the port: cache size against throughput
and hit rate, the sweep of `benchmarks/serving_bench.py`.

  PYTHONPATH=src python -m benchmarks_torch.serving_bench [--out F]

Runs the continuous-batching engine over the SAME seeded Zipf trace
(`synth_trace`, seed 7) at several paged-cache sizes and records, per
cache size, the adapters resident on the device, the generated-token
throughput and the cache's hit / miss / eviction profile.  The model and
trace are the reference's (2 layers, d 64, f32, 12 tenants, rank-4
adapters, 4 lanes); hits, misses, evictions, admission stalls and
generated tokens are deterministic for the trace seed and equal the
reference's rows; tokens/s is the device's (the card by default, the
grouped kernel in every decode step) or, with `main(device="cpu")`, the
host's.  BENCH_QUICK=0 sweeps 2, 4, 8 and 12 pages over 96 requests
instead of 2 and 4 over 24.

Prints the harness's CSV rows, then one JSON object (rows), also written
to chiprun_out/<--out>; never to BENCH_serving.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from benchmarks_torch.common import QUICK, emit, row
from repro_torch import resolve_device
from repro_torch.models import lora as lora_mod
from repro_torch.models import model as mdl
from repro_torch.models.config import LoRAConfig, ModelConfig
from repro_torch.models.layers import init_params, tree_leaves
from repro_torch.serving import (HostAdapterStore, PagedAdapterCache,
                                 ServingEngine, synth_trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = ModelConfig(name="serve-bench", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, param_dtype="float32",
                  compute_dtype="float32")

N_CLIENTS = 12
N_LANES = 4
MAX_LEN = 24
PAGE_SWEEP = (2, 4) if QUICK else (2, 4, 8, 12)
N_REQUESTS = 24 if QUICK else 96
TRACE_SEED = 7


def serving_sweep(rows, device=None):
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    lcfg = LoRAConfig(rank=4, alpha=8, dtype="float32")
    params = init_params(mdl.model_spec(CFG), device=device, generator=gen)
    store = HostAdapterStore()
    for c in range(N_CLIENTS):
        lt = lora_mod.init_lora(CFG, lcfg, device=device, generator=gen)
        for w in tree_leaves(lt):
            w.add_(torch.randn(w.shape, generator=gen, device=device,
                               dtype=w.dtype), alpha=0.02)
        store.put(c, lt)
    trace = synth_trace(N_REQUESTS, N_CLIENTS, CFG.vocab_size,
                        seed=TRACE_SEED, prompt_buckets=(4, 8),
                        gen_range=(3, 10))
    jrows = []
    for pages in PAGE_SWEEP:
        cache = PagedAdapterCache(store, store.get(0), pages=pages,
                                  device=device)
        eng = ServingEngine(params, CFG, cache, n_lanes=N_LANES,
                            lora_scale=lcfg.scale, max_len=MAX_LEN,
                            device=device)
        t0 = time.perf_counter()
        rep = eng.run(trace)
        wall = time.perf_counter() - t0
        st = rep.cache
        label = f"pages{pages}_lanes{N_LANES}"
        rows.append(row("serving", label, "tokens_per_s", rep.tokens_per_s))
        rows.append(row("serving", label, "cache_hit_rate", st["hit_rate"]))
        rows.append(row("serving", label, "evictions", st["evictions"]))
        jrows.append({
            "pages": pages, "lanes": N_LANES, "tenants": N_CLIENTS,
            "requests": rep.requests,
            "adapters_resident": st["resident"],
            "tokens_per_s": round(rep.tokens_per_s, 1),
            "generated_tokens": rep.generated_tokens,
            "hit_rate": round(st["hit_rate"], 4),
            "hits": st["hits"], "misses": st["misses"],
            "evictions": st["evictions"],
            "admission_stalls": rep.stalls,
            "mean_occupancy": round(rep.mean_occupancy, 3),
            "wall_s": round(wall, 3),
        })
    return jrows


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="serving_bench.json",
                    help="file name under chiprun_out/")
    args = ap.parse_args(argv if argv is not None else [])
    rows = []
    jrows = serving_sweep(rows, device)
    emit(rows, "Multi-tenant serving (paged adapter cache sweep)")
    payload = {"bench": "multi_tenant_serving_sweep",
               "device": str(resolve_device(device)), "quick": QUICK,
               "trace": {"requests": N_REQUESTS,
                         "tenants": N_CLIENTS, "seed": TRACE_SEED,
                         "zipf_a": 1.1},
               "rows": jrows}
    print(json.dumps(payload))
    out = os.path.join(ROOT, "chiprun_out", args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
