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
  5. transport -- the five Top-K transport kernels (csrc/transport.cu)
                 against their plain versions, BITWISE, at the Yi-9B LoRA
                 vector length (9,830,400), 1,000,003 and 50, one and four
                 rows, normal / tied / all-zero rows, bits 0 and 4, nearest
                 and stochastic rounding; then each kernel's device time at
                 the Yi-9B length beside its bound, its plain version and a
                 library call.
  6. train    -- the port's `Experiment` (sim engine) on Yi-9B at full
                 width and depth in bf16: flasc, selector "fused", 4-bit
                 uploads, rank 8, density 0.25 both ways, 4 clients x 4 x
                 32 random tokens, 2 rounds.  The transport launch counts
                 are zeroed just before and read just after and must equal
                 the expected count per round x 2; every loss must be
                 finite and every client must upload at least k entries.
                 Then one round with selector "pallas" (the count kernel),
                 its counts zeroed and read the same way.
  7. round-parity -- phase 6's round-0 client deltas, as its round handed
                 them to the upload pipeline, uploaded, aggregated and
                 FedAdam-stepped twice on the card, through the fused stage
                 (the kernels) and through topk(histogram, 12 iterations)
                 + quantize(4) (plain torch), with one uniform draw: masks,
                 nnz and the new flatP must be bitwise equal.
  8. pack     -- the two pack kernels (csrc/transport.cu) against their
                 plain versions, BITWISE: pack_batch at n in {9,830,400,
                 1,000,003, 50}, B in {1, 4}, normal / -0.0-and-NaN /
                 tied / all-zero rows, the Yi-9B capacity and an
                 overflowing one; mask_quantize_pack at bits 0 and 4,
                 nearest and stochastic, k in {0, 1, n/4, n}.  Flat ==
                 hierarchical accumulate (edges 1, 4, 7) bitwise, the
                 sparse mean against the dense one (atol 1e-6); then both
                 kernels' device times at the Yi-9B length beside their
                 bounds, plain versions and torch.nonzero.
  9. sparse-async -- phase 6's setting plus sparse_aggregate=True on
                 full-width Yi-9B: (a) the sim engine, 2 rounds; (b) the
                 async engine at its defaults, 2 events, which must equal
                 (a) bit for bit (flatP, history, ledger); (c) async with
                 concurrency 4, buffer 2, a tiered profile and a 4-edge
                 accumulate, 4 events, finite losses and some stale
                 update.  pack_batch launches once per round in (a) and
                 once per client-phase launch in (b) and (c); every pack's
                 pnnz / cap is printed with the branch it took.  The
                 selector's packed entry point (mask_quantize_pack) runs on
                 (a)'s round-0 client deltas and must reproduce the round's
                 uploads.
--profile adds torch.profiler windows over a few decode steps of phase
3's engine and over one more round of phase 6, and writes their traces
under chiprun_out/.

The last three lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.  With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time
import types

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
            "launches": None, "path": "serve, Yi-9B, 16 requests",
            "max_abs_err": max_err, "ms": main["ms"],
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
    summarize_trace(prof, "serve_decode_trace.json",
                    f"{steps} decode steps x {n} lanes", steps, wall_ms)


def summarize_trace(prof, fname: str, label: str, steps: int,
                    wall_ms: float) -> None:
    """Write the profiler's trace to chiprun_out/<fname>.gz and print the
    device busy share of the wall time (union of kernel intervals), the
    kernel and launch-call counts per step, and the ten kernels that take
    the most device time."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
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
    print(f"[profile] {label} under the profiler: "
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


def profile_round(state, data) -> None:
    """torch.profiler over one more FLASC round from phase 6's trained
    state (round 0's batch), the metrics pull included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import fedround
    from repro_torch.federated.engine import SimEngine
    plan = state.plan
    step = SimEngine().compile(plan)
    seed = fedround.fold_in(plan.seed + 2, 0)
    batch = data(0)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(plan.params, state.flatP, state.server, state.sstate,
                   batch, seed)
        {k: v.cpu() for k, v in out[3].items() if isinstance(v, torch.Tensor)}
        wall_ms = 1e3 * (time.perf_counter() - t0)
    summarize_trace(prof, "train_round_trace.json",
                    "1 FLASC round of 4 clients", 1, wall_ms)


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
# phase 5: the Top-K transport kernels
# ---------------------------------------------------------------------------

# the flat LoRA vector of Yi-9B at rank 8 on wq/wk/wv/wo: 48 layers x
# (4096x8 + 8x4096 + 2 x (4096x8 + 8x512) + 4096x8 + 8x4096)
P_LEN = 48 * (65_536 + 36_864 + 36_864 + 65_536)
LEVELS = 12
TRANSPORT = (   # (kernel, the TPU kernel it replaces)
    ("threshold_count", "src/repro/kernels/topk_mask.py:69"),
    ("topk_mask", "src/repro/kernels/topk_mask.py:37"),
    ("absmax", "src/repro/kernels/fused_transport.py:86"),
    ("bin_counts", "src/repro/kernels/fused_transport.py:122"),
    ("mask_quantize", "src/repro/kernels/fused_transport.py:201"),
)


def transport_functions():
    """kernel name -> the `CudaFunction` that launches and counts it."""
    from repro_torch.kernels import fused_transport as ft
    from repro_torch.kernels import topk_mask as tm
    return {"threshold_count": tm.THRESHOLD_COUNT, "topk_mask": tm.TOPK_MASK,
            "absmax": ft.ABSMAX, "bin_counts": ft.BIN_COUNTS,
            "mask_quantize": ft.MASK_QUANTIZE}


def transport_rows(gen, B: int, n: int, kind: str):
    """(B, n) f32 rows (normal draws, heavy ties, or all zeros) and a
    (B, n) uniform draw for stochastic rounding, from one generator."""
    import torch
    if kind == "zeros":
        x = torch.zeros(B, n, device="cuda")
    elif kind == "ties":
        x = torch.randint(-3, 4, (B, n), generator=gen, device="cuda"
                          ).float() * 0.5
    else:
        x = torch.randn(B, n, generator=gen, device="cuda")
    return x, torch.rand(B, n, generator=gen, device="cuda")


def transport_bound(name: str, B: int, n: int, kept: int, stochastic: bool):
    """(bound_ms, bound_by) of one call on (B, n) rows: each input read
    once and each output written once over the HBM rate, against the f32
    operations these rows need over the f32 rate (`kept` survivors are
    quantized).  Per-row operands and outputs count their few bytes."""
    row, small = 4 * B * n, 16 * B
    ops = {
        "absmax": (row + small, 2 * B * n),                 # abs, max
        "threshold_count": (row + small, 3 * B * n),        # abs, >=, add
        "topk_mask": (2 * row + small, 4 * B * n),          # + select
        # abs, then 12 x (add, mul, >=, two selects, index shift-add)
        "bin_counts": (row + small + 4 * B * (1 << LEVELS),
                       B * n * (1 + 6 * LEVELS)),
        # abs, >=, select, add for every entry; divide, add, floor, two
        # clamps and a multiply for each survivor
        "mask_quantize": ((3 if stochastic else 2) * row + small,
                          4 * B * n + 6 * kept),
    }
    nbytes, flops = ops[name]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def transport_phase(seed: int):
    """Every transport kernel against its plain version, bitwise, at the
    Yi-9B vector length, an odd length and a tiny one, one and four rows,
    normal / tied / all-zero rows and per-row counts k in {0, 1, n/4, n};
    then each kernel's device time at the Yi-9B length (B = 1 and 4)."""
    import torch
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft
    from repro_torch.kernels import topk_mask as tm

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    errs = {name: 0.0 for name, _ in TRANSPORT}

    def same(name, got, want, what):
        a, b = got.contiguous(), want.contiguous()
        if a.dtype == torch.float32:
            equal = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            equal = torch.equal(a, b)
        if a.numel():
            errs[name] = max(errs[name],
                             (a.double() - b.double()).abs().max().item())
        check(equal, f"{name} differs from its plain version ({what})")

    cases = 0
    for n in (P_LEN, 1_000_003, 50):
        kd = sp.density_count(n, 0.25)
        for B in (1, 4):
            ks = [kd] if B == 1 else [0, 1, kd, n]
            k = torch.tensor(ks, dtype=torch.int32, device="cuda")
            for kind in ("normal", "ties", "zeros"):
                what = f"n={n} B={B} {kind}"
                x, u = transport_rows(gen, B, n, kind)
                hi0 = ft.absmax(x)
                same("absmax", hi0, ft.absmax_plain(x), what)
                hist = ft.bin_counts(x, hi0, LEVELS)
                same("bin_counts", hist, ft.bin_counts_plain(x, hi0, LEVELS),
                     what)
                check(bool((hist.sum(-1) == n).all()),
                      f"bin_counts lost entries ({what})")
                thr = torch.clamp_min(
                    ft.threshold_from_bins(hist, hi0, k, LEVELS), sp.TINY)
                same("threshold_count", tm.threshold_count(x, thr),
                     tm.threshold_count_plain(x, thr), what)
                got, gcnt = tm.topk_mask(x, thr)
                want, wcnt = tm.topk_mask_plain(x, thr)
                same("topk_mask", got, want, what)
                same("topk_mask", gcnt, wcnt, what + " count")
                for bits in (0, 4):
                    scale = qz.scale_of(hi0, bits) if bits else \
                        torch.ones_like(hi0)
                    for uu in ((None, u) if bits else (None,)):
                        tag = f"{what} bits={bits} " + \
                            ("stochastic" if uu is not None else "nearest")
                        got, gcnt = ft.fused_mask_quantize(x, thr, scale, uu,
                                                           bits)
                        want, wcnt = ft.fused_mask_quantize_plain(
                            x, thr, scale, uu, bits)
                        same("mask_quantize", got, want, tag)
                        same("mask_quantize", gcnt, wcnt, tag + " count")
                torch.cuda.synchronize()
                cases += 1
    print(f"[transport] {cases} cases (n in {{{P_LEN}, 1000003, 50}} x B in "
          f"{{1, 4}} x normal/ties/zeros, bits 0 and 4, nearest and "
          f"stochastic): every kernel bitwise equal to its plain version")

    # device times at the Yi-9B vector: the kernel alone (its C entry point
    # on preallocated outputs), the wrapper (which also zeroes its count /
    # max / histogram output), the plain version and, where PyTorch has
    # one, a library call computing the same function.  Calls alternate
    # between two input sets: one row (39.3 MB) fits the 50 MB L2, and the
    # round reads its rows from HBM.
    fns = transport_functions()
    dev = torch.device("cuda")
    timings = {name: {} for name, _ in TRANSPORT}
    for B in (1, 4):
        k = torch.full((B,), sp.density_count(P_LEN, 0.25), dtype=torch.int32,
                       device="cuda")
        sets = []
        for _ in range(2):
            x, u = transport_rows(gen, B, P_LEN, "normal")
            hi0 = ft.absmax(x)
            thr = torch.clamp_min(ft.threshold_from_bins(
                ft.bin_counts(x, hi0, LEVELS), hi0, k, LEVELS), sp.TINY)
            sets.append(types.SimpleNamespace(
                x=x, u=u, hi0=hi0, thr=thr, scale=qz.scale_of(hi0, 4),
                kept=int(tm.threshold_count(x, thr).sum())))
        out = torch.empty_like(sets[0].x)
        cnt = torch.zeros(B, dtype=torch.int32, device="cuda")
        hout = torch.zeros((B, 1 << LEVELS), dtype=torch.int32, device="cuda")
        amax = torch.zeros(B, device="cuda")
        op, cp = out.data_ptr(), cnt.data_ptr()
        calls = {   # (kernel alone, wrapper, plain, library) on one set
            "absmax": (
                lambda s: fns["absmax"](dev, s.x.data_ptr(), amax.data_ptr(),
                                        P_LEN, B),
                lambda s: ft.absmax(s.x), lambda s: ft.absmax_plain(s.x),
                lambda s: torch.amax(s.x.abs(), -1)),
            "threshold_count": (
                lambda s: fns["threshold_count"](dev, s.x.data_ptr(),
                                                 s.thr.data_ptr(), cp, P_LEN,
                                                 B),
                lambda s: tm.threshold_count(s.x, s.thr),
                lambda s: tm.threshold_count_plain(s.x, s.thr),
                lambda s: (s.x.abs() >= s.thr[:, None]).sum(-1)),
            "topk_mask": (
                lambda s: fns["topk_mask"](dev, s.x.data_ptr(),
                                           s.thr.data_ptr(), op, cp, P_LEN, B),
                lambda s: tm.topk_mask(s.x, s.thr),
                lambda s: tm.topk_mask_plain(s.x, s.thr), None),
            "bin_counts": (
                lambda s: fns["bin_counts"](dev, s.x.data_ptr(),
                                            s.hi0.data_ptr(), hout.data_ptr(),
                                            P_LEN, B, LEVELS),
                lambda s: ft.bin_counts(s.x, s.hi0, LEVELS),
                lambda s: ft.bin_counts_plain(s.x, s.hi0, LEVELS), None),
            "mask_quantize": (
                lambda s: fns["mask_quantize"](dev, s.x.data_ptr(),
                                               s.u.data_ptr(),
                                               s.thr.data_ptr(),
                                               s.scale.data_ptr(), op, cp,
                                               P_LEN, B, 4, 1),
                lambda s: ft.fused_mask_quantize(s.x, s.thr, s.scale, s.u, 4),
                lambda s: ft.fused_mask_quantize_plain(s.x, s.thr, s.scale,
                                                       s.u, 4),
                None),
        }

        def on_sets(f):
            return lambda i: f(sets[i % len(sets)])

        for name, (raw, wrapper, plain, library) in calls.items():
            bounds = [transport_bound(name, B, P_LEN, s.kept, True)
                      for s in sets]
            row = {"ms": device_ms(on_sets(raw), 20),
                   "wrapper_ms": device_ms(on_sets(wrapper), 20),
                   "plain_ms": device_ms(on_sets(plain), 6),
                   "library_ms": (device_ms(on_sets(library), 20)
                                  if library is not None else None),
                   "bound_ms": sum(b for b, _ in bounds) / len(bounds),
                   "bound_by": bounds[0][1]}
            timings[name][B] = row
            print(f"[transport] timing {name} B={B} n={P_LEN}: "
                  f"{json.dumps(row)}")
        del sets, out
    return errs, timings


# ---------------------------------------------------------------------------
# phase 6: train Yi-9B with FLASC at full width and depth
# ---------------------------------------------------------------------------

FED = dict(n_clients=4, local_batch=4, local_steps=1, client_lr=1e-3,
           server_lr=2e-3)
SEQ = 32
TRAIN_ROUNDS = 2
# transport launches per round of flasc with selector="fused": the download
# mask (one row) and the upload of the stacked client deltas (B = 4)
FUSED_PER_ROUND = {"threshold_count": 0, "topk_mask": 1, "absmax": 2,
                   "bin_counts": 2, "mask_quantize": 1}
# ... and with selector="pallas" (24 bisection count passes each way)
PALLAS_PER_ROUND = {"threshold_count": 48, "topk_mask": 2, "absmax": 0,
                    "bin_counts": 0, "mask_quantize": 0}


class RoundProbe:
    """Callback: host time at the end of every round (after the metrics
    pull), the per-client upload sizes, and the run state."""

    def __init__(self):
        self.t = [time.perf_counter()]
        self.up_nnz = []
        self.state = None

    def on_round_end(self, ev):
        import numpy as np
        self.t.append(time.perf_counter())
        self.up_nnz.append(np.asarray(ev.metrics["up_nnz_clients"]).tolist())
        self.state = ev.state

    def on_eval(self, ev):
        pass


class UploadCapture:
    """Keeps the stacked client deltas that a run's first round hands to
    its upload pipeline.  Inside `around()`, `transport.upload_pipeline`
    (which the round calls to build the upload) returns pipelines that
    record their first input and then run as they would."""

    def __init__(self):
        self.deltas = None

    @contextlib.contextmanager
    def around(self):
        from repro_torch.core import transport as tp
        make = tp.upload_pipeline

        def recording(*args, **kwargs):
            pipe = make(*args, **kwargs)

            def run(x, rng=None):
                if self.deltas is None:
                    self.deltas = x
                return pipe(x, rng=rng)
            return run

        tp.upload_pipeline = recording
        try:
            yield self
        finally:
            tp.upload_pipeline = make


def yi_backbone(seed: int):
    """Yi-9B at full width and depth, bf16, random weights from `seed`."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import init_params
    cfg = get_config("yi-9b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_params(mdl.model_spec(cfg), device="cuda", generator=gen)


def token_batches(cfg, seed: int):
    """data(r): random tokens (n_clients, local_steps, local_batch, SEQ),
    drawn on the card from a generator seeded by (seed, r)."""
    import torch

    def data(r):
        gen = torch.Generator(device="cuda").manual_seed(1_000_003 * seed + r)
        shape = (FED["n_clients"], FED["local_steps"], FED["local_batch"], SEQ)
        return {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                        generator=gen, device="cuda")}
    return data


def run_flasc(cfg, params, data, seed: int, selector: str, rounds: int,
              capture: UploadCapture = None):
    """One `Experiment` of the port on the card; returns (result, probe,
    {kernel: launches in this run}, wall seconds).  `capture`, if given,
    keeps round 0's upload input."""
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    fns = transport_functions()
    probe = RoundProbe()
    exp = (Experiment(None, federation=FederatedConfig(**FED))
           .with_strategy("flasc", selector=selector, quant_bits_up=4,
                          density_down=0.25, density_up=0.25)
           .with_lora(rank=8)
           .with_training(rounds=rounds, seed=seed)
           .with_params(params, cfg)
           .with_data(data)
           .with_engine("sim")
           .with_callbacks(probe))
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    probe.t = [time.perf_counter()]
    with (capture.around() if capture else contextlib.nullcontext()):
        res = exp.run()
    launches = {name: f.launches for name, f in fns.items()}
    return res, probe, launches, probe.t[-1] - probe.t[0]


def train_phase(seed: int, cfg, params):
    import numpy as np
    import torch
    from repro_torch.core import sparsity as sp

    data = token_batches(cfg, seed)
    k = sp.density_count(P_LEN, 0.25)
    torch.cuda.reset_peak_memory_stats()
    capture = UploadCapture()
    res, probe, launches, wall = run_flasc(cfg, params, data, seed, "fused",
                                           TRAIN_ROUNDS, capture)
    peak = torch.cuda.max_memory_allocated() / 2**30
    led = res.ledger
    check(led.total_params == P_LEN,
          f"flat LoRA vector has {led.total_params} entries, not {P_LEN}")
    C = FED["n_clients"]
    for r, h in enumerate(res.history):
        ph = h["phase_ms"]
        transport = ph["download_mask"] + ph["download"] + ph["upload"]
        print(f"[train] round {r}: loss {h['loss']:.6f}, wall "
              f"{1e3 * (probe.t[r + 1] - probe.t[r]):.3f} ms; device-event "
              f"phases: local update {ph['local_update'] / C:.3f} ms/client, "
              f"transport {transport:.3f} ms (download mask "
              f"{ph['download_mask']:.3f}, download {ph['download']:.3f}, "
              f"upload {ph['upload']:.3f}), server step {ph['server']:.3f} ms;"
              f" up_nnz per client {probe.up_nnz[r]}")
    print(f"[train] {cfg.name} {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype}: {TRAIN_ROUNDS} FLASC rounds (fused selector, "
          f"4-bit uploads, density 0.25/0.25, {C} clients x "
          f"{FED['local_batch']} x {SEQ} tokens) in {1e3 * wall:.3f} ms; "
          f"p_len {led.total_params}, k {k}; ledger {led.total_bytes} B "
          f"value-only, {led.total_coded_bytes} B coded (down "
          f"{led.down_coded_bytes} / up {led.up_coded_bytes}); peak device "
          f"memory {peak:.2f} GiB (round 0's upload input kept for phase 7)")
    print(f"[train] launches in the fused run: {json.dumps(launches)}")
    check(len(res.history) == TRAIN_ROUNDS, "the run stopped early")
    check(all(np.isfinite(h["loss"]) for h in res.history),
          "a round's loss is not finite")
    check(all(v >= k for row in probe.up_nnz for v in row),
          f"a client uploaded fewer than k = {k} entries: {probe.up_nnz}")
    for name, per_round in FUSED_PER_ROUND.items():
        check(launches[name] == per_round * TRAIN_ROUNDS,
              f"{name} launched {launches[name]} times in the fused run, "
              f"expected {per_round} x {TRAIN_ROUNDS}")
    state = probe.state

    # the `pallas` selector's path: the count kernel, one round
    pres, _, plaunch, pwall = run_flasc(cfg, params, data, seed, "pallas", 1)
    print(f"[train] selector=pallas: 1 round in {1e3 * pwall:.3f} ms, loss "
          f"{pres.history[0]['loss']:.6f}; launches {json.dumps(plaunch)}")
    check(np.isfinite(pres.history[0]["loss"]), "pallas-round loss not finite")
    for name, per_round in PALLAS_PER_ROUND.items():
        check(plaunch[name] == per_round,
              f"{name} launched {plaunch[name]} times in the pallas round, "
              f"expected {per_round}")
    return state, capture.deltas, launches, plaunch


# ---------------------------------------------------------------------------
# phase 7: round parity on the card, fused stage against two stages
# ---------------------------------------------------------------------------

def round_parity_phase(state, deltas, seed: int):
    """Round 0's client deltas of full-width Yi-9B, as phase 6's round
    handed them to its upload pipeline, uploaded, aggregated and
    FedAdam-stepped (from the run's final server state) twice on the card:
    through the `fused_topk_quantize` stage (the kernels) and through
    `topk` with `HistogramSelector(iters=12)` then `quantize(4)` (plain
    torch), with one injected uniform draw.  Everything must be bitwise
    equal."""
    import torch
    from repro_torch.core import selectors as sel
    from repro_torch.core import strategies as st
    from repro_torch.core import transport as tp
    from repro_torch.optim import adam_update

    plan, flatP, server = state.plan, state.flatP, state.server
    strat, meta, fed = plan.strategy, plan.meta, plan.fed
    s = strat.spec
    C = FED["n_clients"]
    check(deltas is not None and tuple(deltas.shape) == (C, P_LEN),
          "phase 6 handed no (n_clients, p_len) upload input to its pipeline")
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        u = torch.rand(deltas.shape, generator=gen, device="cuda")
        ctx = meta.plan_context(C, round_idx=server["round"])
        fused = tp.upload_pipeline(st.UploadRule.topk(s.density_up), 4,
                                   selector=sel.FusedSelector(levels=LEVELS))
        check([type(x).__name__ for x in fused.stages] == ["FusedTopKQuantize"],
              f"fused upload pipeline is {fused.stages}")
        two = tp.Pipeline((tp.TopKSparsify(
            density=s.density_up,
            selector=sel.HistogramSelector(iters=LEVELS)), tp.Quantize(4)))
        out = {}
        for name, pipe in (("fused", fused), ("two-stage", two)):
            msg = pipe(deltas, rng=u)
            pg = strat.aggregate(msg.values, ctx)
            newP, opt = adam_update(flatP, pg, server["opt"], fed.server_lr,
                                    fed.adam_b1, fed.adam_b2, fed.adam_eps)
            out[name] = (msg.values, msg.nnz, newP, opt["m"], opt["v"])
        torch.cuda.synchronize()

    def bits(t):
        return t.contiguous().view(torch.int32)

    (fv, fn, fp, fm, fvv), (tv, tn, tp_, tm_, tvv) = out["fused"], \
        out["two-stage"]
    masks_equal = torch.equal(fv != 0, tv != 0)
    print(f"[round-parity] {C} client deltas of {deltas.shape[1]} entries: "
          f"nnz fused {fn.tolist()} two-stage {tn.tolist()}; masks equal "
          f"{masks_equal}; uploads, flatP and Adam moments bitwise equal "
          f"{torch.equal(bits(fv), bits(tv)) and torch.equal(bits(fp), bits(tp_))}")
    check(masks_equal and torch.equal(fn, tn),
          "fused and two-stage uploads keep different entries")
    check(torch.equal(bits(fv), bits(tv)), "upload values differ")
    check(torch.equal(bits(fm), bits(tm_)) and torch.equal(bits(fvv), bits(tvv))
          and torch.equal(bits(fp), bits(tp_)),
          "FedAdam results differ between the fused and two-stage uploads")


# ---------------------------------------------------------------------------
# phase 8: the two pack kernels
# ---------------------------------------------------------------------------

PACK = (   # (kernel, the TPU kernel it replaces)
    ("mask_quantize_pack", "src/repro/kernels/fused_transport.py:269"),
    ("pack_batch", "src/repro/kernels/fused_transport.py:365"),
)


def pack_functions():
    from repro_torch.kernels import fused_transport as ft
    return {"mask_quantize_pack": ft.MASK_QUANTIZE_PACK,
            "pack_batch": ft.PACK_BATCH}


def pack_rows(gen, B: int, n: int, kind: str):
    """(B, n) rows as a cohort's uploads look: 25% nonzero normal draws;
    with -0.0 entries and a NaN mixed in ("negzero"); tied magnitudes; or
    all zeros."""
    import torch
    x = torch.randn(B, n, generator=gen, device="cuda")
    x = torch.where(torch.rand(B, n, generator=gen, device="cuda") < 0.25,
                    x, 0.0)
    if kind == "negzero":
        x = torch.where(torch.rand(B, n, generator=gen, device="cuda") < 0.2,
                        -0.0, x)
        x[0, n // 2] = float("nan")
    elif kind == "ties":
        x = torch.sign(x) * 0.5
    elif kind == "zeros":
        x.zero_()
    return x.contiguous()


def pack_bound(name: str, B: int, n: int, cap: int, stochastic: bool):
    """(bound_ms, bound_by): each input read once, each output written
    once (every slot of the packed buffer is written), over the HBM rate,
    against the f32 operations over the f32 rate."""
    row, slots = 4 * B * n, 8 * B * cap
    ops = {"pack_batch": (row + slots + 4 * B, 2 * B * n),
           # x, u, the masked row; abs, >=, select, count for every entry,
           # six ops to quantize it
           "mask_quantize_pack": ((3 if stochastic else 2) * row + slots
                                  + 16 * B, 10 * B * n)}
    nbytes, flops = ops[name]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pack_phase(seed: int):
    """Both pack kernels against their plain versions, bitwise, at the
    Yi-9B vector length, an odd length and a tiny one, one and four rows,
    normal / tied / all-zero / -0.0-bearing rows, the Yi-9B capacity and
    an overflowing one, bits 0 and 4, nearest and stochastic rounding, k
    in {0, 1, n/4, n}; flat == hierarchical accumulate on the card; then
    each kernel's device time at the Yi-9B length (B = 1 and 4)."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    errs = {name: 0.0 for name, _ in PACK}

    def same(name, got, want, what):
        for a, b in zip(got, want):
            a, b = a.contiguous(), b.contiguous()
            if a.dtype == torch.float32:
                equal = torch.equal(a.view(torch.int32), b.view(torch.int32))
                diff = (a.double() - b.double()).abs().nan_to_num(0.0)
            else:
                equal = torch.equal(a, b)
                diff = (a.double() - b.double()).abs()
            if a.numel():
                errs[name] = max(errs[name], diff.max().item())
            check(equal, f"{name} differs from its plain version ({what})")

    cases = 0
    for n in (P_LEN, 1_000_003, 50):
        kd = sp.density_count(n, 0.25)
        caps = (comm.pack_capacity(n, kd), n // 64 + 1)
        for B in (1, 4):
            for kind in ("normal", "negzero", "ties", "zeros"):
                x = pack_rows(gen, B, n, kind)
                for cap in caps:
                    what = f"n={n} B={B} {kind} cap={cap}"
                    got = ft.pack_values_batch(x, cap)
                    same("pack_batch", got,
                         ft.pack_rows_plain(x, x != 0, cap, n), what)
                    if kind == "normal" and cap == caps[1]:
                        check(bool((got[2] > cap).all()),
                              f"pack_batch did not flag overflow ({what})")
                    cases += 1
            # kernel 7: per-row thresholds for k in {0, 1, n/4, n}
            ks = [kd] if B == 1 else [0, 1, kd, n]
            k = torch.tensor(ks, dtype=torch.int32, device="cuda")
            for kind in ("normal", "ties", "zeros"):
                x, u = transport_rows(gen, B, n, kind)
                if kind == "normal":
                    x[0, n // 3] = 100.0        # survivors round to zero
                hi0 = ft.absmax(x)
                thr = torch.clamp_min(ft.threshold_from_bins(
                    ft.bin_counts(x, hi0, LEVELS), hi0, k, LEVELS), sp.TINY)
                for bits in (0, 4):
                    scale = qz.scale_of(hi0, bits) if bits else \
                        torch.ones_like(hi0)
                    for uu in ((None, u) if bits else (None,)):
                        for cap in caps:
                            what = (f"n={n} B={B} {kind} bits={bits} "
                                    f"{'stochastic' if uu is not None else 'nearest'}"
                                    f" cap={cap}")
                            same("mask_quantize_pack",
                                 ft.fused_mask_quantize_pack(
                                     x, thr, scale, uu, bits, cap),
                                 ft.fused_mask_quantize_pack_plain(
                                     x, thr, scale, uu, bits, cap, n), what)
                            cases += 1
            torch.cuda.synchronize()
    print(f"[pack] {cases} cases (n in {{{P_LEN}, 1000003, 50}} x B in "
          f"{{1, 4}}; pack_batch on normal/-0.0+NaN/tied/zero rows, "
          f"mask_quantize_pack on normal/tied/zero rows at bits 0 and 4, "
          f"nearest and stochastic, k in {{0, 1, n/4, n}}; the Yi-9B "
          f"capacity and an overflowing one): both kernels bitwise equal "
          f"to their plain versions")

    # the server side on the card: flat == edge tree, bitwise, and the
    # sparse mean against the dense one
    cap = comm.pack_capacity(P_LEN, sp.density_count(P_LEN, 0.25))
    rows = pack_rows(gen, 4, P_LEN, "normal")
    idx, val, nnz = ft.pack_values_batch(rows, cap)
    check(bool((nnz <= cap).all()), "cohort rows overflow the Yi-9B cap")
    flat = ft.sparse_accumulate(idx, val, P_LEN)
    for edges in (1, 4, 7):
        tree = ft.hierarchical_accumulate(idx, val, P_LEN, edges)
        check(torch.equal(tree.view(torch.int32), flat.view(torch.int32)),
              f"hierarchical_accumulate({edges} edges) != sparse_accumulate")
    mean_err = (flat * 0.25 - rows.mean(0)).abs().max().item()
    print(f"[pack] flat == hierarchical (edges 1, 4, 7) bitwise at (4, "
          f"{P_LEN}), cap {cap}; sparse mean vs dense mean max|err| "
          f"{mean_err:.3e} (tolerance 1e-6: another summation order)")
    check(mean_err <= 1e-6, "the sparse sum disagrees with the dense mean")
    del rows, idx, val, flat

    # device times at the Yi-9B vector, two input sets alternating (as in
    # phase 5): the kernel alone on preallocated outputs, the wrapper, the
    # plain version and torch.nonzero of the same rows' keep mask (indices
    # only; it syncs with the host for its output size, so it is timed
    # call to call, host round trip included)
    fns = pack_functions()
    dev = torch.device("cuda")
    nt = -(-P_LEN // ft.PACK_TILE)
    kd = sp.density_count(P_LEN, 0.25)
    timings = {name: {} for name, _ in PACK}
    for B in (1, 4):
        k = torch.full((B,), kd, dtype=torch.int32, device="cuda")
        sets = []
        for _ in range(2):
            x, u = transport_rows(gen, B, P_LEN, "normal")
            hi0 = ft.absmax(x)
            thr = torch.clamp_min(ft.threshold_from_bins(
                ft.bin_counts(x, hi0, LEVELS), hi0, k, LEVELS), sp.TINY)
            sets.append(types.SimpleNamespace(
                x=x, u=u, thr=thr, scale=qz.scale_of(hi0, 4),
                sparse=ft.fused_mask_quantize(x, thr, qz.scale_of(hi0, 4), u,
                                              4)[0]))
        out = torch.empty_like(sets[0].x)
        idx = torch.empty((B, cap), dtype=torch.int32, device="cuda")
        val = torch.empty((B, cap), device="cuda")
        cnt = torch.zeros(B, dtype=torch.int32, device="cuda")
        scratch = torch.empty((B, nt), dtype=torch.int32, device="cuda")
        op, ip, vp, cp, sp_ = (out.data_ptr(), idx.data_ptr(), val.data_ptr(),
                               cnt.data_ptr(), scratch.data_ptr())
        calls = {   # (kernel alone, wrapper, plain, library) on one set
            "pack_batch": (
                lambda s: fns["pack_batch"](dev, s.sparse.data_ptr(), ip, vp,
                                            cp, sp_, P_LEN, B, cap, P_LEN),
                lambda s: ft.pack_values_batch(s.sparse, cap),
                lambda s: ft.pack_rows_plain(s.sparse, s.sparse != 0, cap,
                                             P_LEN),
                lambda s: torch.nonzero(s.sparse)),
            "mask_quantize_pack": (
                lambda s: fns["mask_quantize_pack"](
                    dev, s.x.data_ptr(), s.u.data_ptr(), s.thr.data_ptr(),
                    s.scale.data_ptr(), op, ip, vp, cp, sp_, P_LEN, B, 4, 1,
                    cap, P_LEN),
                lambda s: ft.fused_mask_quantize_pack(s.x, s.thr, s.scale,
                                                      s.u, 4, cap),
                lambda s: ft.fused_mask_quantize_pack_plain(
                    s.x, s.thr, s.scale, s.u, 4, cap, P_LEN),
                lambda s: torch.nonzero(s.x.abs() >= s.thr[:, None])),
        }

        def on_sets(f):
            return lambda i: f(sets[i % len(sets)])

        for name, (raw, wrapper, plain, library) in calls.items():
            bound, by = pack_bound(name, B, P_LEN, cap, True)
            row = {"ms": device_ms(on_sets(raw), 20),
                   "wrapper_ms": device_ms(on_sets(wrapper), 20),
                   "plain_ms": device_ms(on_sets(plain), 6),
                   "library_ms": cuda_ms(on_sets(library), 10),
                   "library": "torch.nonzero (indices only, host-synchronizing)",
                   "bound_ms": bound, "bound_by": by, "cap": cap}
            if name == "mask_quantize_pack" and B == 1:
                row["nearest_ms"] = device_ms(on_sets(
                    lambda s: fns[name](dev, s.x.data_ptr(), None,
                                        s.thr.data_ptr(), s.scale.data_ptr(),
                                        op, ip, vp, cp, sp_, P_LEN, B, 4, 0,
                                        cap, P_LEN)), 20)
                row["nearest_bound_ms"] = pack_bound(name, B, P_LEN, cap,
                                                     False)[0]
            timings[name][B] = row
            print(f"[pack] timing {name} B={B} n={P_LEN}: {json.dumps(row)}")
        del sets, out
    return errs, timings


# ---------------------------------------------------------------------------
# phase 9: sparse aggregation on sim and async, full-width Yi-9B
# ---------------------------------------------------------------------------

SPARSE_ROUNDS = 2
ASYNC_EVENTS = 4


class PackProbe:
    """Inside `around()`, records the (pnnz, cap) of every cohort pack
    (`fused_transport.pack_values_batch`, which the round and the client
    phase call through the module) and counts the client-phase calls the
    async engine makes; the device tensors are read after the run."""

    def __init__(self):
        self.packs = []
        self.phase_calls = 0

    @contextlib.contextmanager
    def around(self):
        from repro_torch.core import fedround
        from repro_torch.kernels import fused_transport as ft
        pack, make = ft.pack_values_batch, fedround.make_client_phase_fn

        def recording_pack(values, cap):
            out = pack(values, cap)
            self.packs.append((out[2], cap))
            return out

        def counting_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def run(*a, **kw):
                self.phase_calls += 1
                return fn(*a, **kw)
            return run

        ft.pack_values_batch = recording_pack
        fedround.make_client_phase_fn = counting_make
        try:
            yield self
        finally:
            ft.pack_values_batch = pack
            fedround.make_client_phase_fn = make

    def report(self, label: str) -> list:
        """Print each pack's pnnz / cap; returns the overflow flags."""
        flags = []
        for i, (pnnz, cap) in enumerate(self.packs):
            p = pnnz.cpu().tolist()
            over = any(v > cap for v in p)
            flags.append(over)
            print(f"[sparse-async] {label} pack {i}: pnnz/cap "
                  f"{[round(v / cap, 4) for v in p]} (cap {cap}); "
                  f"{'DENSE overflow branch' if over else 'sparse branch'}")
        return flags


def run_sparse(cfg, params, data, seed: int, engine: str, rounds: int,
               capture: UploadCapture = None, edge_shards: int = 0,
               **engine_kw):
    """One sparse-aggregation `Experiment` of the port on the card (the
    phase-6 setting plus sparse_aggregate=True); returns (result, probe,
    pack probe, pack-kernel launches, final flatP)."""
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    fns = pack_functions()
    probe, packs = RoundProbe(), PackProbe()
    exp = (Experiment(None, federation=FederatedConfig(**FED))
           .with_strategy("flasc", selector="fused", quant_bits_up=4,
                          density_down=0.25, density_up=0.25,
                          sparse_aggregate=True, edge_shards=edge_shards)
           .with_lora(rank=8)
           .with_training(rounds=rounds, seed=seed)
           .with_params(params, cfg)
           .with_data(data)
           .with_engine(engine, **engine_kw)
           .with_callbacks(probe))
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    probe.t = [time.perf_counter()]
    with packs.around(), (capture.around() if capture
                          else contextlib.nullcontext()):
        res = exp.run()
    launches = {name: f.launches for name, f in fns.items()}
    return res, probe, packs, launches, probe.state.flatP.clone()


def sparse_async_phase(seed: int, cfg, params):
    import numpy as np
    import torch
    from repro_torch.core import comm, fedround
    from repro_torch.core import selectors as sel
    from repro_torch.core import sparsity as sp
    from repro_torch.core import strategies as st
    from repro_torch.core import transport as tp
    from repro_torch.federated import async_clock as ac
    from repro_torch.kernels import fused_transport as ft

    data = token_batches(cfg, seed)
    k = sp.density_count(P_LEN, 0.25)
    cap = comm.pack_capacity(P_LEN, k)
    C = FED["n_clients"]
    ledger_keys = ("down_bytes", "up_bytes", "total_bytes", "coded_bytes",
                   "down_coded_bytes", "up_coded_bytes")
    async_keys = {"sim_time", "staleness", "applied", "dropped",
                  "launch_bytes", "phase_ms"}

    def strip(h):
        return {key: v for key, v in h.items() if key not in async_keys}

    # (a) sim, 2 rounds
    capture = UploadCapture()
    res_a, probe_a, packs_a, la, flat_a = run_sparse(
        cfg, params, data, seed, "sim", SPARSE_ROUNDS, capture)
    for r, h in enumerate(res_a.history):
        print(f"[sparse-async] (a) sim round {r}: loss {h['loss']:.6f}, wall "
              f"{1e3 * (probe_a.t[r + 1] - probe_a.t[r]):.3f} ms, phases "
              f"{json.dumps({key: round(v, 3) for key, v in h['phase_ms'].items()})}"
              f", up_nnz {probe_a.up_nnz[r]}")
    over_a = packs_a.report("(a)")
    print(f"[sparse-async] (a) launches {json.dumps(la)}; ledger "
          f"{json.dumps({key: res_a.history[-1][key] for key in ledger_keys})}")
    check(all(np.isfinite(h["loss"]) for h in res_a.history),
          "(a) a sparse round's loss is not finite")
    check(la["pack_batch"] == SPARSE_ROUNDS,
          f"(a) pack_batch launched {la['pack_batch']} times, expected one "
          f"per round ({SPARSE_ROUNDS})")

    # kernel 7's path: the selector's packed entry point on each client's
    # round-0 upload, with the round's own upload generators.  Its values
    # must be the round's upload row, its unpack the same row, its total
    # the round's nnz
    deltas = capture.deltas
    check(deltas is not None and tuple(deltas.shape) == (C, P_LEN),
          "(a) handed no (n_clients, p_len) upload input to its pipeline")
    round_seed = fedround.fold_in(seed + 2, 0)
    gens = [fedround.generator(fedround.fold_in(round_seed, c), "cuda")
            for c in range(C)]
    with torch.no_grad():
        up = tp.upload_pipeline(st.UploadRule.topk(0.25), 4,
                                selector="fused")(deltas, rng=gens)
        fused = sel.FusedSelector()
        f7 = pack_functions()["mask_quantize_pack"]
        f7.launches = 0
        outs = [fused.sparsify_quantized_packed(
            deltas[c], count=k, bits=4,
            rng=fedround.generator(fedround.fold_in(round_seed, c), "cuda"),
            cap=cap) for c in range(C)]
        l7 = f7.launches
        torch.cuda.synchronize()
    for c, (vals, tot, idx, val) in enumerate(outs):
        check(torch.equal(vals.view(torch.int32), up.values[c].view(torch.int32)),
              f"packed entry point: client {c} values differ from the round's")
        check(int(tot) == int(up.nnz[c]),
              f"packed entry point: client {c} total {int(tot)} != nnz "
              f"{int(up.nnz[c])}")
        if int(tot) <= cap:
            check(torch.equal(ft.unpack_values(idx, val, P_LEN), vals),
                  f"packed entry point: client {c} unpack differs")
    print(f"[sparse-async] sparsify_quantized_packed on round 0's {C} "
          f"uploads: totals {[int(o[1]) for o in outs]} (cap {cap}), values "
          f"bitwise equal to the round's uploads; mask_quantize_pack "
          f"launches {l7}")
    check(l7 == C, f"mask_quantize_pack launched {l7} times, expected {C}")
    del capture, deltas, up, outs

    # (b) async at its defaults from the same start: the sync anchor
    res_b, probe_b, packs_b, lb, flat_b = run_sparse(
        cfg, params, data, seed, "async", SPARSE_ROUNDS)
    for r, h in enumerate(res_b.history):
        print(f"[sparse-async] (b) async event {r}: loss {h['loss']:.6f}, "
              f"wall {1e3 * (probe_b.t[r + 1] - probe_b.t[r]):.3f} ms, "
              f"launch bytes pulled {h['launch_bytes']}, phases "
              f"{json.dumps({key: round(v, 3) for key, v in h['phase_ms'].items()})}")
    packs_b.report("(b)")
    equal = (torch.equal(flat_a.view(torch.int32), flat_b.view(torch.int32))
             and [strip(h) for h in res_a.history]
             == [strip(h) for h in res_b.history])
    print(f"[sparse-async] (b) launches {json.dumps(lb)}, client-phase "
          f"calls {packs_b.phase_calls}; flatP, history and ledger bitwise "
          f"equal to (a): {equal}")
    check(equal, "(b) async at its defaults differs from the sim engine")
    check(lb["pack_batch"] == packs_b.phase_calls == SPARSE_ROUNDS,
          f"(b) pack_batch launched {lb['pack_batch']} times for "
          f"{packs_b.phase_calls} client-phase launches")
    del flat_b

    # (c) async with staleness and the edge tree
    res_c, probe_c, packs_c, lc, _ = run_sparse(
        cfg, params, data, seed, "async", ASYNC_EVENTS, edge_shards=4,
        concurrency=4, buffer_size=2,
        profile=ac.ClientSystemProfile.tiered(4, 2))
    for r, h in enumerate(res_c.history):
        print(f"[sparse-async] (c) async event {r}: loss {h['loss']:.6f}, "
              f"wall {1e3 * (probe_c.t[r + 1] - probe_c.t[r]):.3f} ms, "
              f"sim_time {h['sim_time']:.6f}, staleness {h['staleness']}, "
              f"applied {h['applied']}, dropped {h['dropped']}, launch "
              f"bytes pulled {h['launch_bytes']}, phases "
              f"{json.dumps({key: round(v, 3) for key, v in h['phase_ms'].items()})}")
    over_c = packs_c.report("(c)")
    print(f"[sparse-async] (c) launches {json.dumps(lc)}, client-phase "
          f"calls {packs_c.phase_calls}")
    check(len(res_c.history) == ASYNC_EVENTS, "(c) the run stopped early")
    check(all(np.isfinite(h["loss"]) for h in res_c.history),
          "(c) an event's loss is not finite")
    check(any(h["staleness"] > 0 for h in res_c.history),
          "(c) no event aggregated a stale update")
    check(lc["pack_batch"] == packs_c.phase_calls > 0,
          f"(c) pack_batch launched {lc['pack_batch']} times for "
          f"{packs_c.phase_calls} client-phase launches")
    return {"pack_batch": la["pack_batch"], "pack_batch_b": lb["pack_batch"],
            "pack_batch_c": lc["pack_batch"], "mask_quantize_pack": l7,
            "overflow_a": over_a, "overflow_c": over_c}


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
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    errs, timings = transport_phase(args.seed)
    print(f"[transport] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    cfg, params = yi_backbone(args.seed)
    torch.cuda.synchronize()
    print(f"[train] backbone built in {time.perf_counter() - t0:.1f}s")
    state, deltas, launches, plaunch = train_phase(args.seed, cfg, params)
    if args.profile:
        profile_round(state, token_batches(cfg, args.seed))
    print(f"[train] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    round_parity_phase(state, deltas, args.seed)
    print(f"[round-parity] done in {time.perf_counter() - t0:.1f}s")
    del state, deltas
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    perrs, ptimings = pack_phase(args.seed)
    print(f"[pack] done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    slaunch = sparse_async_phase(args.seed, cfg, params)
    print(f"[sparse-async] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; done in "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"[total] {time.perf_counter() - t_start:.1f}s")

    entries = [entry]
    for name, replaces in TRANSPORT:
        t1, t4 = timings[name][1], timings[name][4]
        on_pallas = name == "threshold_count"
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/transport.cu",
            "replaces": replaces,
            "launches": plaunch[name] if on_pallas else launches[name],
            "path": ("train, selector=pallas, 1 round" if on_pallas else
                     f"train, selector=fused, {TRAIN_ROUNDS} rounds"),
            "max_abs_err": errs[name], "ms": t4["ms"],
            "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
            "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
            "shape": f"(4, {P_LEN}) f32", "B1": t1,
            "wrapper_ms": t4["wrapper_ms"]})
    paths = {
        "pack_batch": (slaunch["pack_batch"],
                       f"sparse-async (a): sim, sparse_aggregate, "
                       f"{SPARSE_ROUNDS} rounds (b: {slaunch['pack_batch_b']}"
                       f", c: {slaunch['pack_batch_c']} launches)"),
        "mask_quantize_pack": (slaunch["mask_quantize_pack"],
                               "sparse-async: FusedSelector."
                               "sparsify_quantized_packed on round 0's "
                               f"{FED['n_clients']} client uploads")}
    for name, replaces in PACK:
        t1, t4 = ptimings[name][1], ptimings[name][4]
        launches_, path = paths[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/transport.cu",
            "replaces": replaces, "launches": launches_, "path": path,
            "max_abs_err": perrs[name], "ms": t4["ms"],
            "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
            "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
            "library": t4["library"], "shape": f"(4, {P_LEN}) f32",
            "B1": t1, "wrapper_ms": t4["wrapper_ms"]})
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
