"""Multi-tenant serving launcher: a thin CLI over `serving.ServingEngine`.

Builds random backbone params, a per-client adapter library (one LoRA
tree per client), a paged device cache and a Zipf-popularity request
trace, all seeded from --seed, then runs the continuous-batching loop and
prints the throughput and cache report.  Runs on the card by default, at
the architecture's full width and depth:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --clients 8 --pages 4 --lanes 4 --requests 16

--arch takes every id of `configs/registry.py` (yi-9b, minitron-8b,
gemma-7b, qwen3-32b).  --window W serves through a sliding window of W
keys with a rolling cache of min(W, --max-len) slots a lane (the
reference serves long contexts on dense archs at
`registry.LONG_CONTEXT_WINDOW`).  --smoke serves the reduced config;
--device cpu runs the plain PyTorch versions on the host.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds params, adapters and the request trace")
    ap.add_argument("--clients", type=int, default=8,
                    help="tenant population (adapters in the host store)")
    ap.add_argument("--pages", type=int, default=4,
                    help="device-resident adapter pages")
    ap.add_argument("--lanes", type=int, default=4,
                    help="concurrent decode lanes")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48,
                    help="per-lane positions (prompt + generation); the KV "
                         "cache's slots unless --window is smaller")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding window in keys: a rolling KV cache of "
                         "min(window, max-len) slots (default: none)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the architecture's reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg=None):
    """-> (engine, trace, cfg, lcfg) for the parsed flags; `cfg` replaces
    the architecture's registered config (e.g. a depth-cut copy)."""
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lora as lora_mod
    from repro_torch.models import model as mdl
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.layers import init_params, tree_leaves
    from repro_torch.serving import (HostAdapterStore, PagedAdapterCache,
                                     ServingEngine, synth_trace)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(mdl.model_spec(cfg), device=device, generator=gen)
    lcfg = LoRAConfig(rank=args.rank, alpha=2 * args.rank, dtype="float32")

    # one trained-looking adapter per tenant (b is zero at init; perturb it
    # so the adapters actually disagree and the paged path is observable).
    store = HostAdapterStore()
    for c in range(args.clients):
        lt = lora_mod.init_lora(cfg, lcfg, device=device, generator=gen)
        for w in tree_leaves(lt):
            w.add_(torch.randn(w.shape, generator=gen, device=device,
                               dtype=w.dtype), alpha=0.02)
        store.put(c, lt)
    cache = PagedAdapterCache(store, store.get(0), pages=args.pages,
                              device=device)
    trace = synth_trace(args.requests, args.clients, cfg.vocab_size,
                        seed=args.seed, prompt_buckets=(8, 16),
                        gen_range=(4, 12))
    eng = ServingEngine(params, cfg, cache, n_lanes=args.lanes,
                        lora_scale=lcfg.scale, max_len=args.max_len,
                        window=args.window, device=device)
    return eng, trace, cfg, lcfg


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    eng, trace, cfg, _ = build(args)
    size = "reduced" if args.smoke else "full"
    print(f"[serve] {args.arch} ({size}: {cfg.num_layers}L d{cfg.d_model}) "
          f"{args.clients} tenants / {args.pages} pages / {args.lanes} lanes "
          f"on {eng.device}")
    rep = eng.run(trace)
    st = rep.cache
    print(f"[serve] {len(rep.completions)}/{rep.requests} requests served: "
          f"{rep.generated_tokens} tokens in {rep.wall_s:.2f}s "
          f"({rep.tokens_per_s:.1f} tok/s), "
          f"occupancy {rep.mean_occupancy:.2f}/{args.lanes} lanes")
    print(f"[serve] cache: hit-rate {st['hit_rate']:.2f} "
          f"({st['hits']} hits / {st['misses']} misses / "
          f"{st['evictions']} evictions), resident {st['resident']}"
          f"/{st['pages']} pages, {rep.stalls} admission stalls")
    return rep


if __name__ == "__main__":
    main()
