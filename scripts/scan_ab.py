#!/usr/bin/env python3
"""Build the selective scan (csrc/selective_scan.cu) of several source
trees side by side on one NVIDIA card, hold each against the plain version
and its own repeat, and time them in turns in one process.

  python3 scripts/scan_ab.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding selective_scan.cu, such as a checkout's
src/repro_torch/csrc (an older commit unpacked with `git archive` into a
directory that .gitignore lists).  Each is compiled with the port's nvcc
flags into build/selective_scan_ab/, all at once (scripts/ab_trees.py);
the ptxas report of each of its kernels (registers, shared memory, stack
frame, spills) is printed.  The entry point's arguments are read from each
tree's source: the one-pass kernel of the first version takes no scratch,
the chunked scan one (from `kernels/selective_scan.py::scan_scratch`, at
this tree's `CHUNK`, which must be the chunked tree's kChunk).

Cases: chip_smoke.SCAN_CASES (phase 23 (a)) and the chunk edges of
chip_smoke.scan_edge_cases.  Every label's y and h_last must be
within chip_smoke.SCAN_TOL of max|plain| of `selective_scan_plain` on the
same inputs (computed once a case), finite, and equal to its own second
launch bit for bit; the script exits 1 otherwise, or if a tree does not
build (the others still run).  Timing: device time per call
(chip_smoke.device_ms on the C entry point and preallocated outputs) of
each label in the order given and then reversed, twice (A B B A A B B A),
at hymba-1.5b's prefill of one layer (1, 8192, 3200, 16), u bf16 and f32,
at its 32768-token prefill (u bf16), and at its decode of 8 lanes (8, 1, 3200, 16), u f32 from h0, h_last
written over h0 as decode does; beside chip_smoke.scan_bound at the SM's
maximum clock, with each chunked tree's three kernels split by
torch.profiler (chip_smoke.kernel_split_ms: every kernel in every call,
the parts summing to within chip_smoke.SPLIT_RTOL of the tree's mean time).
One JSON object per line; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys

import ab_trees
from ab_trees import cs

ITERS = 10                     # calls a timed turn
TURNS = 2                      # A B B A rounds of timing
SEED = 31
TIMED = ((1, cs.LONG_S, 3200, 16, "bfloat16", False),
         (1, cs.LONG_S, 3200, 16, "float32", False),
         (1, 32768, 3200, 16, "bfloat16", False),
         (8, 1, 3200, 16, "float32", True))


def chunked(csrc) -> bool:
    """Whether the tree's entry point is the chunked scan's (it takes a
    scratch pointer)."""
    text = (csrc / "selective_scan.cu").read_text()
    m = re.search(r"selective_scan_fwd\(([^)]*)\)", text)
    return m is not None and "scratch" in m.group(1)


def bind(so, csrc):
    """The tree's C entry point with its argument types."""
    fn = so.selective_scan_fwd
    fn.chunked = chunked(csrc)
    fn.argtypes = ([ctypes.c_void_p] * (11 if fn.chunked else 10)
                   + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(fn, args, y, h_last, scratch) -> None:
    """One launch of a tree's entry point: args as chip_smoke.scan_inputs
    gives them, y and h_last preallocated."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0 = args
    B, S, di = u.shape
    N = A_log.shape[-1]
    ptrs = [t.data_ptr() for t in (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc)]
    ptrs += [None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h_last.data_ptr()]
    if fn.chunked:
        ptrs.append(None if scratch is None else scratch.data_ptr())
    rc = fn(*ptrs, B, S, di, N, ss.DTYPES[u.dtype],
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"selective_scan_fwd failed: CUDA error {rc}")


def main() -> int:
    srcs = ab_trees.trees(__doc__, "selective_scan.cu")
    if srcs is None:
        return 1
    import torch
    from repro_torch.kernels import selective_scan as ss
    libs = {label: bind(so, srcs[label]) for label, so in ab_trees.build(
        srcs, "selective_scan.cu", lambda name: "scan" in name).items()}
    labels = list(libs)
    ok = labels == list(srcs)
    if not labels:
        return 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B, S, di, N, dtype, h0 in cs.SCAN_CASES + cs.scan_edge_cases():
        args_ = cs.scan_inputs(gen, B, S, di, N, dtype, h0)
        yp, hp = ss.selective_scan_plain(*args_)
        scratch = ss.scan_scratch(B, S, di, N, "cuda")
        res = {}
        for label in labels:
            outs = []
            for _ in range(2):
                y = torch.empty(B, S, di, device="cuda")
                hl = torch.empty(B, di, N, device="cuda")
                launch(libs[label], args_, y, hl, scratch)
                outs.append((y, hl))
            torch.cuda.synchronize()
            (y, hl), (y2, hl2) = outs
            ey = ((y - yp).abs().max() / yp.abs().max()).item()
            eh = ((hl - hp).abs().max() / hp.abs().max()).item()
            same = torch.equal(y, y2) and torch.equal(hl, hl2)
            held = (ey <= cs.SCAN_TOL and eh <= cs.SCAN_TOL and same and bool(
                torch.isfinite(y).all() and torch.isfinite(hl).all()))
            ok = ok and held
            res[label] = {"y_err": ey, "h_err": eh, "bitwise_on_repeat": same,
                          "held": held}
            del outs, y, hl, y2, hl2
        print(json.dumps({"B": B, "S": S, "di": di, "N": N, "u": dtype,
                          "h0": h0, "chunk": ss.CHUNK, "tol": cs.SCAN_TOL,
                          "labels": res}))
        del args_, yp, hp, scratch
    clock, cur = cs.sm_clocks()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, di, N, dtype, h0 in TIMED:
        args_ = cs.scan_inputs(gen, B, S, di, N, dtype, h0)
        y = torch.empty(B, S, di, device="cuda")
        # decode writes h_last over h0
        hl = args_[-1] if h0 else torch.empty(B, di, N, device="cuda")
        scratch = ss.scan_scratch(B, S, di, N, "cuda")

        def call(label, i):
            launch(libs[label], args_, y, hl, scratch)

        ms = ab_trees.abba(labels, call, ITERS, TURNS)
        bound, by = cs.scan_bound(B, S, di, N, dtype, h0, clock, sms)
        split = {}
        if scratch is not None:
            for label in labels:
                if libs[label].chunked:
                    split[label] = cs.kernel_split_ms(
                        lambda i, label=label: call(label, i), ITERS,
                        cs.scan_kernels(dtype, N),
                        ms=sum(ms[label]) / len(ms[label]))
        print(json.dumps({"timing": {"B": B, "S": S, "di": di, "N": N,
                                     "u": dtype, "h0": h0, "chunk": ss.CHUNK},
                          "ms": ms, "split_ms": split,
                          "bound_ms": bound, "bound_by": by,
                          "clock_mhz": clock / 1e6,
                          "clock_now_mhz": cur / 1e6}))
        del args_, y, hl, scratch
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
