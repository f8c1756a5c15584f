#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch/`) on one NVIDIA card.

  python3 chip_smoke.py [--seed N] [--profile]

Phases, each fatal on failure:
  1. build    -- compile every CUDA source under src/repro_torch/csrc/ with
                 nvcc (one process per source, all started together).
  2. kernels  -- each kernel against its plain PyTorch version on the card
                 at the serving decode shapes (f32, rtol 1e-4 / atol 1e-5:
                 the summation order differs); times the kernel, the plain
                 version and a PyTorch library call computing the same
                 function.
  3. serve    -- the port's serving CLI (`launch/serve.py`) at the full
                 width and depth of Yi-9B in bf16: 8 tenants, rank-16
                 adapters, 4 pages, 8 lanes, 16 requests.  The grouped
                 kernel's launch count is zeroed just before and read just
                 after: it must equal decode steps x 48 layers x 4 targets
                 (prefill launches none).
  4. parity   -- a 2-layer full-width f32 engine against the port's
                 single-adapter prefill + decode reference: completions
                 must match, except where the reference's top-2 logit gap
                 is below 1e-3 (each such case is printed).
--profile adds a torch.profiler window over a few decode steps of phase
3's engine and writes its trace under chiprun_out/.

The last three lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.  With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores, same source
RTOL, ATOL = 1e-4, 1e-5
GAP_TOL = 1e-3

SERVE_ARGS = ["--arch", "yi-9b", "--clients", "8", "--pages", "4",
              "--lanes", "8", "--requests", "16", "--rank", "16",
              "--max-len", "48"]


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n_iter: int, warmup: int = 3) -> float:
    """Time per call of fn(i) over n_iter back-to-back calls, by CUDA
    events.  Where the host queues a call more slowly than the device runs
    it, this is the host's rate, not the device's."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def device_ms(fn, n_iter: int) -> float:
    """Device time per call of fn(i), the host's per-call overhead left
    out: a spin kernel holds the stream while the n_iter calls are queued
    behind it, so they run back to back.  The hold is checked: if the
    start event has already passed when the last call is queued, the spin
    was too short and the measurement is repeated with a longer one."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    cycles = 20_000_000
    while cycles < 4_000_000_000:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(n_iter):
            fn(i)
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / n_iter
        cycles *= 4
    raise PhaseError("could not hold the stream while queueing the calls")


# ---------------------------------------------------------------------------
# phase 2: the grouped LoRA kernel
# ---------------------------------------------------------------------------

def grouped_case(gen, M, K, R, N, G):
    import torch
    x = torch.randn(M, K, generator=gen, device="cuda")
    a = torch.randn(G, K, R, generator=gen, device="cuda") / K ** 0.5
    b = torch.randn(G, R, N, generator=gen, device="cuda") / R ** 0.5
    g = torch.randint(0, G, (M,), generator=gen, device="cuda",
                      dtype=torch.int32)
    return x, a, b, g


def grouped_bound(x, a, b, g):
    """(bound_ms, bound_by): the bytes the function must move (x, the
    distinct pages this gidx selects, gidx, the output) over HBM rate, and
    its f32 operations over the f32 rate."""
    M, K = x.shape
    _, _, R = a.shape
    N = b.shape[-1]
    pages = len(set(g.tolist()))
    nbytes = 4 * (M * K + pages * (K * R + R * N) + M + M * N)
    flops = 2 * M * K * R + 2 * M * R * N + M * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(seed: int):
    import torch
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    kern = resolve_grouped_kernel("grouped_pallas")
    ref = resolve_grouped_kernel("grouped_ref")
    gather = resolve_grouped_kernel("grouped_gather")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, R, G, scale = 4096, 16, 4, 2.0
    max_err = 0.0
    for M in (1, 8, 130):
        for N in (4096, 512, 50):
            x, a, b, g = grouped_case(gen, M, K, R, N, G)
            got = kern.delta(x, a, b, g, scale)
            want = ref.delta(x, a, b, g, scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
            print(f"[kernels] grouped_pallas M={M} K={K} R={R} N={N} G={G}: "
                  f"max|err| {err:.3e} {'ok' if ok else 'MISMATCH'}")
            check(ok and bool(torch.isfinite(got).all()),
                  f"grouped_pallas disagrees with grouped_ref at M={M} N={N}")
            max_err = max(max_err, err)

    # timings at the decode shapes of the serving phase (8 lanes; wq/wo give
    # N = 4096, wk/wv N = 512).  40 input sets (88 MB, more than the 50 MB
    # L2) are cycled so the pages come from HBM, as a decode step finds
    # them.  `ms`, `gather_ms` and `library_ms` are device times
    # (`device_ms`); `call_ms` / `library_call_ms` are back-to-back calls
    # with the host's per-call overhead in them.  The plain version syncs
    # with the host (it reads gidx), so it has only the latter.
    shapes = []
    for N in (4096, 512):
        sets = [grouped_case(gen, 8, K, R, N, G) for _ in range(40)]
        gathered = [(x[:, None, :], a.index_select(0, g.long()),
                     b.index_select(0, g.long())) for x, a, b, g in sets]

        def kernel(i):
            return kern.delta(*sets[i % len(sets)], scale)

        def library(i):
            x3, ag, bg = gathered[i % len(gathered)]
            return torch.bmm(torch.bmm(x3, ag), bg)

        bounds = [grouped_bound(*s) for s in sets]
        row = {"M": 8, "K": K, "R": R, "N": N, "G": G,
               "ms": device_ms(kernel, 2 * len(sets)),
               "call_ms": cuda_ms(kernel, 400),
               "plain_ms": cuda_ms(lambda i: ref.delta(*sets[i % 40], scale),
                                   40),
               "gather_ms": device_ms(
                   lambda i: gather.delta(*sets[i % 40], scale), 2 * len(sets)),
               "library_ms": device_ms(library, 2 * len(sets)),
               "library_call_ms": cuda_ms(library, 400),
               "bound_ms": sum(bd for bd, _ in bounds) / len(bounds),
               "bound_by": bounds[0][1]}
        print(f"[kernels] timing {json.dumps(row)}")
        shapes.append(row)
    main = shapes[0]
    return {"name": "grouped_lora_delta", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_lora.cu",
            "replaces": "src/repro/kernels/lora_matmul.py:248",
            "launches": None, "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "torch.bmm x2 on pre-gathered pages",
            "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 3: serve Yi-9B at full width and depth
# ---------------------------------------------------------------------------

def serve_phase(seed: int):
    import torch
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_leaves

    kern = resolve_grouped_kernel("grouped_pallas")
    args = serve.parse_args(SERVE_ARGS + ["--seed", str(seed)])
    t0 = time.perf_counter()
    eng, trace, cfg, _ = serve.build(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    print(f"[serve] {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.3f} B params, "
          f"built in {setup_s:.1f}s")

    kern.launches = 0
    rep = eng.run(trace)
    launches = kern.launches

    st = rep.cache
    n_targets = len(eng.cache.pool["g0"]["attn"])
    per_step = cfg.num_layers * 4
    print(f"[serve] {len(rep.completions)}/{rep.requests} requests served: "
          f"{rep.generated_tokens} tokens in {rep.wall_s:.3f}s "
          f"({rep.tokens_per_s:.2f} tok/s), {rep.steps} decode steps, "
          f"{1e3 * rep.decode_s / max(rep.steps, 1):.3f} ms/decode step, "
          f"occupancy {rep.mean_occupancy:.3f}/{eng.n_lanes} lanes")
    print(f"[serve] cache: hit-rate {st['hit_rate']:.3f} ({st['hits']} hits / "
          f"{st['misses']} misses / {st['evictions']} evictions), "
          f"{rep.stalls} admission stalls; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(eng.params)) - \
        eng.params["embed"].numel() * eng.params["embed"].element_size()
    print(f"[serve] decode weight-read bound {1e3 * weight_bytes / HBM_BYTES_PER_S:.3f} "
          f"ms/step ({weight_bytes / 1e9:.2f} GB of weights besides the "
          f"embedding table at {HBM_BYTES_PER_S / 1e12} TB/s)")
    print(f"[serve] grouped_pallas launches {launches} = {rep.steps} steps x "
          f"{cfg.num_layers} layers x {n_targets} targets")
    check(len(rep.completions) == len(trace) == rep.requests,
          "not every request was served")
    for req in trace:
        toks = rep.completions[req.rid]
        check(len(toks) == req.gen_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {req.rid}: bad completion {toks}")
    check(n_targets == 4, f"expected 4 adapted targets, pool has {n_targets}")
    check(launches == rep.steps * per_step and launches > 0,
          f"grouped_pallas launched {launches} times, expected "
          f"{rep.steps} x {per_step}")
    return eng, rep, launches


def profile_decode(eng, seed: int, steps: int = 4):
    """torch.profiler over `steps` full-batch decode steps of phase 3's
    engine (every lane active, pages resident): device busy share of the
    wall time and device time by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import zeros_from_spec

    n = eng.n_lanes
    rng = np.random.default_rng(seed)
    cache = zeros_from_spec(mdl.cache_spec(eng.cfg, n, eng.max_len), eng.device)
    tokens = rng.integers(0, eng.cfg.vocab_size, n).astype(np.int64)
    pos = np.full(n, 16, np.int64)
    gidx = (np.arange(n) % eng.cache.pages).astype(np.int32)
    with torch.no_grad():
        for _ in range(2):                                     # warm
            eng._decode(cache, tokens, pos, gidx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng._decode(cache, tokens, pos, gidx)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_decode_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with gzip.open(path + ".gz", "wt") as f:
        json.dump(events, f)
    os.remove(path)

    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy, end = 0.0, float("-inf")       # union of kernel intervals, in us
    for s, e in sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name", "").startswith("cudaLaunchKernel"))
    print(f"[profile] {steps} decode steps x {n} lanes under the profiler: "
          f"wall {wall_ms / steps:.3f} ms/step, device busy "
          f"{busy / 1e3 / steps:.3f} ms/step "
          f"({100 * busy / 1e3 / wall_ms:.1f}% of wall), "
          f"{len(kernels) // steps} kernels and {launches // steps} "
          f"launch calls per step")
    by_name: dict = {}
    for k in kernels:
        t, c = by_name.get(k["name"], (0.0, 0))
        by_name[k["name"]] = (t + k["dur"], c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[profile]   {t / 1e3 / steps:8.3f} ms/step {c // steps:5d} "
              f"launches/step  {name[:80]}")


# ---------------------------------------------------------------------------
# phase 4: f32 parity against the single-adapter reference path
# ---------------------------------------------------------------------------

def parity_phase(seed: int):
    import torch
    from repro_torch.checkpoint.io import tree_from_numpy
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    # phase 3's engine settings on a 2-layer f32 cut of the full width
    cfg2 = dataclasses.replace(get_config("yi-9b"), num_layers=2,
                               param_dtype="float32", compute_dtype="float32")
    eng2, trace2, _, lcfg = serve.build(
        serve.parse_args(SERVE_ARGS + ["--seed", str(seed)]), cfg=cfg2)
    rep = eng2.run(trace2)
    check(len(rep.completions) == len(trace2), "parity engine dropped requests")
    store = eng2.cache.store
    near_ties = 0
    with torch.no_grad():
        for req in trace2:
            lt = tree_from_numpy(store.get(req.client), device="cuda")
            toks = torch.tensor([req.prompt], device="cuda")
            logits, c = mdl.prefill(eng2.params, cfg2, {"tokens": toks},
                                    lora=lt, lora_scale=lcfg.scale,
                                    max_len=eng2.max_len)
            want, gaps = [], []
            lg = logits[0, -1]
            pos = req.prompt_len
            while True:
                top2 = torch.topk(lg.float(), 2).values
                gaps.append((top2[0] - top2[1]).item())
                want.append(int(torch.argmax(lg)))
                if len(want) == req.gen_len:
                    break
                out, c = mdl.decode_step(
                    eng2.params, cfg2, torch.tensor([want[-1]], device="cuda"),
                    torch.tensor(pos, device="cuda"), c, lora=lt,
                    lora_scale=lcfg.scale)
                lg = out[0, 0]
                pos += 1
            got = rep.completions[req.rid]
            if got != want:
                t = next(i for i, (p, q) in enumerate(zip(got, want)) if p != q)
                print(f"[parity] request {req.rid} differs at token {t}: "
                      f"engine {got[t]} vs reference {want[t]}, reference "
                      f"top-2 gap {gaps[t]:.3e}")
                check(gaps[t] < GAP_TOL,
                      f"request {req.rid}: engine and reference disagree at a "
                      f"top-2 gap of {gaps[t]:.3e} >= {GAP_TOL}")
                near_ties += 1
    print(f"[parity] {cfg2.name} 2L d{cfg2.d_model} f32: "
          f"{len(trace2) - near_ties}/{len(trace2)} completions identical to "
          f"the single-adapter reference, {near_ties} near-tie divergences")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {', '.join(sorted(libs))} in {time.perf_counter() - t0:.1f}s")
    for name, path in sorted(libs.items()):
        log = path.with_suffix(".so.log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    t0 = time.perf_counter()
    entry = kernel_phase(args.seed)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    eng, rep, launches = serve_phase(args.seed)
    entry["launches"] = launches
    entry["launches_per_decode_step"] = launches // max(rep.steps, 1)
    if args.profile:
        profile_decode(eng, args.seed)
    del eng
    torch.cuda.empty_cache()
    print(f"[serve] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    parity_phase(args.seed)
    print(f"[parity] done in {time.perf_counter() - t0:.1f}s")
    print(f"[total] {time.perf_counter() - t_start:.1f}s")

    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
