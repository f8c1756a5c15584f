#!/usr/bin/env python3
"""Build the pack kernels (csrc/transport.cu) of several source trees side
by side on one NVIDIA card, hold `mask_quantize_pack_f32` and
`pack_batch_f32` of each against the first tree's and against the plain
versions bit for bit, and time them in turns in one process.

  python3 scripts/pack_ab.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding transport.cu and the headers it includes, such
as a checkout's src/repro_torch/csrc (an older commit unpacked with `git
archive` into a directory that .gitignore lists).  Each is compiled with
the port's nvcc flags into build/transport_ab/, all at once
(scripts/ab_trees.py); the ptxas report (registers, shared memory, stack
frame, spills) of each of its pack kernels is printed, every
`pack_scan_kernel<Rows>` instantiation among them.  Every tree gets the
scratch of the current contract, `pack_batch_scratch_words(B, n)` 64-bit
words, which holds what an older tree's entry point needs.

Cases: chip_smoke.pack_cases, phase 8's, each run through every tree's C
entry point into outputs filled with a pattern first, so that a slot a
kernel leaves unwritten differs.  Every label's outputs must equal the
plain version's and the first label's bit for bit (NaN compared as NaN);
the script exits 1 otherwise, or if a tree does not build (the others
still run).

Timing at n = 9,830,400, the Yi-9B capacity 2,764,800, B = 1 and 4:
device time per call (chip_smoke.device_ms on the C entry point and
preallocated outputs, two input sets alternating) of each label in the
order given and then reversed, twice (A B B A A B B A): mask_quantize_pack
at 4 bits stochastic and nearest, pack_batch on the masked row; beside the
bounds of chip_smoke.pack_bound.  One JSON object per line; the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
import types

import ab_trees
from ab_trees import cs

ITERS = 20                     # calls a timed turn
TURNS = 2                      # A B B A rounds of timing
SEED = 19
REPORTED = re.compile(r"pack|scan|mask_quantize_tile")
PATTERN = 0x7F7F7F7F           # what every output holds before a call


def bind(so) -> dict:
    """{entry point: C function} of one tree's library."""
    from repro_torch.kernels import fused_transport as ft
    fns = {}
    for key, bound in (("mask_quantize_pack", ft.MASK_QUANTIZE_PACK),
                       ("pack_batch", ft.PACK_BATCH)):
        fn = getattr(so, bound.symbol)
        fn.argtypes = bound.argtypes
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def run_mqp(fn, x, thr, scale, u, bits, cap, bufs=None):
    """mask_quantize_pack_f32 of one tree -> (out, idx, val, tot), into
    `bufs` (preallocated, for timing) or into new pattern-filled tensors."""
    import torch
    from repro_torch.kernels import fused_transport as ft
    B, n = x.shape
    if bufs is None:
        bufs = (torch.full((B, n), PATTERN, dtype=torch.int32,
                           device=x.device).view(torch.float32),
                torch.full((B, cap), PATTERN, dtype=torch.int32,
                           device=x.device),
                torch.full((B, cap), PATTERN, dtype=torch.int32,
                           device=x.device).view(torch.float32),
                torch.full((B,), PATTERN, dtype=torch.int32, device=x.device),
                torch.empty(ft.pack_batch_scratch_words(B, n),
                            dtype=torch.int64, device=x.device))
    out, idx, val, tot, scratch = bufs
    rc = fn(x.data_ptr(), None if u is None else u.data_ptr(),
            thr.data_ptr(), scale.data_ptr(), out.data_ptr(), idx.data_ptr(),
            val.data_ptr(), tot.data_ptr(), scratch.data_ptr(), n, B, bits,
            int(u is not None), cap, n, stream())
    cs.check(rc == 0, f"mask_quantize_pack_f32 failed: CUDA error {rc}")
    return out, idx, val, tot


def run_pack(fn, x, cap, bufs=None):
    """pack_batch_f32 of one tree -> (idx, val, nnz)."""
    import torch
    from repro_torch.kernels import fused_transport as ft
    B, n = x.shape
    if bufs is None:
        bufs = (torch.full((B, cap), PATTERN, dtype=torch.int32,
                           device=x.device),
                torch.full((B, cap), PATTERN, dtype=torch.int32,
                           device=x.device).view(torch.float32),
                torch.full((B,), PATTERN, dtype=torch.int32, device=x.device),
                torch.empty(ft.pack_batch_scratch_words(B, n),
                            dtype=torch.int64, device=x.device))
    idx, val, nnz, scratch = bufs
    rc = fn(x.data_ptr(), idx.data_ptr(), val.data_ptr(), nnz.data_ptr(),
            scratch.data_ptr(), n, B, cap, n, stream())
    cs.check(rc == 0, f"pack_batch_f32 failed: CUDA error {rc}")
    return idx, val, nnz


def held(got: dict, want, what: str) -> bool:
    """Every label's outputs against the plain version's and the first
    label's, bitwise; prints the case and returns whether all held."""
    import torch
    torch.cuda.synchronize()
    labels = list(got)
    plain = {lb: all(cs.same_bits(a, b) for a, b in zip(got[lb], want))
             for lb in labels}
    first = {lb: all(cs.same_bits(a, b)
                     for a, b in zip(got[lb], got[labels[0]]))
             for lb in labels[1:]}
    ok = all(plain.values()) and all(first.values())
    if not ok:
        print(json.dumps({"case": what, "equal_to_plain": plain,
                          "bitwise_equal_to_" + labels[0]: first}))
    return ok


def check_cases(libs: dict) -> bool:
    import torch
    runs = {"pack_batch": run_pack, "mask_quantize_pack": run_mqp}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ok, cases = True, 0
    for name, what, args, _ in cs.pack_cases(gen):
        got = {lb: runs[name](f[name], *args) for lb, f in libs.items()}
        ok &= held(got, cs.pack_plain(name, args), f"{name} {what}")
        cases += 1
    print(json.dumps({"cases": cases, "labels": list(libs),
                      "all_bitwise_equal": ok}))
    return ok


def time_calls(libs: dict) -> None:
    import torch
    from repro_torch.core import comm
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n = cs.P_LEN
    kd = sp.density_count(n, 0.25)
    cap = comm.pack_capacity(n, kd)
    labels = list(libs)
    for B in (1, 4):
        k = torch.full((B,), kd, dtype=torch.int32, device="cuda")
        sets = []
        for _ in range(2):
            x, u = cs.transport_rows(gen, B, n, "normal")
            hi0 = ft.absmax(x)
            thr = torch.clamp_min(ft.threshold_from_bins(
                ft.bin_counts(x, hi0, cs.LEVELS), hi0, k, cs.LEVELS), sp.TINY)
            scale = qz.scale_of(hi0, 4)
            sets.append(types.SimpleNamespace(
                x=x, u=u, thr=thr, scale=scale,
                sparse=ft.fused_mask_quantize(x, thr, scale, u, 4)[0]))
        mbufs = (torch.empty_like(sets[0].x),
                 torch.empty((B, cap), dtype=torch.int32, device="cuda"),
                 torch.empty((B, cap), device="cuda"),
                 torch.empty(B, dtype=torch.int32, device="cuda"),
                 torch.empty(ft.pack_batch_scratch_words(B, n),
                             dtype=torch.int64, device="cuda"))
        pbufs = mbufs[1:]
        calls = {
            "mask_quantize_pack": lambda f, s: run_mqp(
                f["mask_quantize_pack"], s.x, s.thr, s.scale, s.u, 4, cap,
                mbufs),
            "mask_quantize_pack_nearest": lambda f, s: run_mqp(
                f["mask_quantize_pack"], s.x, s.thr, s.scale, None, 4, cap,
                mbufs),
            "pack_batch": lambda f, s: run_pack(f["pack_batch"], s.sparse,
                                                cap, pbufs),
        }
        for case, call in calls.items():
            ms = ab_trees.abba(labels, lambda label, i: call(
                libs[label], sets[i % 2]), ITERS, TURNS)
            name = case.replace("_nearest", "")
            bound, by = cs.pack_bound(name, B, n, cap,
                                      not case.endswith("nearest"))
            print(json.dumps({"timing": {"kernel": case, "B": B, "n": n,
                                         "cap": cap},
                              "ms": ms, "bound_ms": bound, "bound_by": by}))
        del sets, mbufs, pbufs


def main() -> int:
    srcs = ab_trees.trees(__doc__, "transport.cu")
    if srcs is None:
        return 1
    libs = {label: bind(so) for label, so in ab_trees.build(
        srcs, "transport.cu", REPORTED.search).items()}
    if not libs:
        return 1
    ok = list(libs) == list(srcs)
    ok = check_cases(libs) and ok
    time_calls(libs)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
