#!/usr/bin/env python3
"""Build the flash-attention kernel (csrc/flash_attention.cu) of several
source trees side by side on one NVIDIA card, hold the bf16 wgmma route of
each against the plain version and against the others bit for bit, hold
the bf16 hd256 route of each against an f64 attention, and time both
routes in turns in one process.

  python3 scripts/flash_ab.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding flash_attention.cu and the headers it includes,
such as a checkout's src/repro_torch/csrc (an older commit unpacked with
`git archive` into a directory that .gitignore lists).  Each is compiled
with the port's nvcc flags into build/flash_attention_ab/, all at once
(scripts/ab_trees.py); the ptxas report of its flash_wgmma_kernel
and of the kernel behind its hd256 route (flash_wgmma_hd256_kernel, or
an older tree's flash_bf16_kernel<256>) (registers, stack frame, spills)
is printed, with any compiler warning or note that a wgmma was
serialised.  The entry point's arguments are read
from each tree's source: trees before the backward take no lse pointer,
and trees with the sliding window take a trailing window, passed as 0
(none), so that a tree of either kind times against this one.

Cases: phase 10 of chip_smoke.py on the wgmma route (bf16, hd 128, H 32,
KV 4): B 1, S = T = 8192 and 1000; B 2, S 1000 and 1025, T 1100; causal and
full.  Every label's output must equal the first label's bit for bit, and
the first label's must hold to `flash_attention_plain` at 2e-2 elementwise
and of each output row's largest value (chip_smoke.ATTN_TOL); the script
exits 1 otherwise, or if a tree does not build (the others still run).
Timing at S = T = 8192, causal and full: device time per launch
(chip_smoke.device_ms, the C entry point on preallocated outputs) of each
label in the order given and then reversed (A B B A), ten launches a
turn, beside the bound and one F.scaled_dot_product_attention call on the
same inputs (drawn from a fixed seed).

hd256 route (route 3: bf16, hd 256), on the trees that have it (a tree
without it is skipped with a note): B 1, S = T = 8192, 16 / 16 heads
(gemma-7b), and B 2, S 1000 and 1025, T 1100, 8 / 2 heads; causal and
full.  Two kernels that sum in other orders are not held bitwise to each
other: each label's output must be within 4e-3 of each row's largest value
of an f64 attention of its inputs (chip_smoke.F64_ROW_TOL; F64_ROWS sampled
query rows of every head at 8192 tokens) and equal to its own second
launch bit for bit; the largest difference from the first label is
printed.  Timing at (1, 8192, 16/16, 256), causal and full, A B B A beside
the bound and SDPA.  One JSON object per line; the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys

import ab_trees
from ab_trees import cs

CASES = [(1, 8192, 8192), (1, 1000, 1000), (2, 1000, 1100), (2, 1025, 1100)]
H, KV, HD = 32, 4, 128
# the hd256 route: (B, S, T, H, KV)
HD256_CASES = [(1, 8192, 8192, 16, 16), (2, 1000, 1100, 8, 2),
               (2, 1025, 1100, 8, 2)]
HD256_KERNELS = ("flash_wgmma_hd256_kernel", "flash_bf16_kernel<256>")
ITERS = 10                     # launches a timed turn
SEED = 18


def _fwd_params(csrc) -> str:
    text = (csrc / "flash_attention.cu").read_text()
    m = re.search(r"flash_attention_fwd\(([^)]*)\)", text)
    return "" if m is None else m.group(1)


def takes_lse(csrc) -> bool:
    """Whether the tree's flash_attention_fwd takes the lse pointer after
    out (the trees that have the backward do; older ones do not)."""
    return re.search(r"\blse_?\b", _fwd_params(csrc)) is not None


def takes_window(csrc) -> bool:
    """Whether the tree's flash_attention_fwd takes a trailing `window`
    after `route` (the trees with the sliding window do; this script
    passes 0, none)."""
    return re.search(r"\bint window\b", _fwd_params(csrc)) is not None


def has_hd256(csrc) -> bool:
    """Whether the tree's entry point takes route 3 (bf16, hd 256)."""
    return "route == 3" in (csrc / "flash_attention.cu").read_text()


def launch(fn, q, k, v, out, causal: bool, route: int = 0) -> None:
    """One launch of the tree's entry point on route 0 (wgmma) or 3
    (hd256), shapes and head size read from q and k."""
    import torch
    B, S, Hq, hd = q.shape
    T, KVh = k.shape[1], k.shape[2]
    lse = (None,) if fn.takes_lse else ()
    window = (0,) if fn.takes_window else ()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse,
            B, S, T, Hq, KVh, hd, 0, int(causal), hd ** -0.5, route, *window,
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"flash_attention_fwd failed: CUDA error {rc}")


def hd256_cases(libs: dict, srcs: dict, gen) -> bool:
    """The hd256 route of each tree that has it against an f64 attention
    and its own repeat; prints one line a case; True if all held."""
    import torch
    import torch.nn.functional as F
    labels = [lb for lb in libs if has_hd256(srcs[lb])]
    for lb in libs:
        if lb not in labels:
            print(json.dumps({"label": lb, "hd256": "skipped: the tree has "
                              "no route 3 (bf16, hd 256)"}))
    if not labels:
        return True
    ok = True
    for B, S, T, Hq, KVh in HD256_CASES:
        for causal in (True, False):
            q, k, v = cs.attn_inputs(gen, B, S, T, Hq, KVh, 256, "bfloat16")
            rows = None
            if S >= cs.LONG_S:
                rows = torch.randperm(S, generator=gen, device="cuda")
                rows = rows[:cs.F64_ROWS].sort().values
            exact = cs.attn_f64(q, k, v, 256 ** -0.5, causal, rows)
            res, outs = {}, {}
            for label in labels:
                out, again = torch.empty_like(q), torch.empty_like(q)
                launch(libs[label], q, k, v, out, causal, 3)
                launch(libs[label], q, k, v, again, causal, 3)
                torch.cuda.synchronize()
                row = cs.attn_row_err(out if rows is None else out[:, rows],
                                      exact)
                same = torch.equal(out.view(torch.int16),
                                   again.view(torch.int16))
                held = (bool(torch.isfinite(out.float()).all()) and same
                        and row <= cs.F64_ROW_TOL)
                ok = ok and held
                outs[label] = out
                res[label] = {"row_err_vs_f64": row, "bitwise_on_repeat": same,
                              "held": held}
                del again
            first = outs[labels[0]]
            diff = {lb: (outs[lb].float() - first.float()).abs().max().item()
                    for lb in labels[1:]}
            print(json.dumps({"route": "hd256", "B": B, "S": S, "T": T,
                              "H": Hq, "KV": KVh, "causal": causal,
                              "f64_rows": "all" if rows is None else len(rows),
                              "tol": cs.F64_ROW_TOL, "labels": res,
                              "max_abs_diff_from_" + labels[0]: diff}))
            del q, k, v, exact, outs, first
    for causal in (True, False):
        q, k, v = cs.attn_inputs(gen, 1, 8192, 8192, 16, 16, 256, "bfloat16")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        ms = ab_trees.abba(labels, lambda label, i: launch(
            libs[label], q, k, v, out, causal, 3), ITERS, 1)
        sdpa = cs.device_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), ITERS)
        bound, by = cs.attn_bound(1, 8192, 8192, 16, 16, 256, "bfloat16",
                                  causal)
        print(json.dumps({"timing": {"route": "hd256", "B": 1, "S": 8192,
                                     "T": 8192, "H": 16, "KV": 16, "hd": 256,
                                     "causal": causal},
                          "ms": ms, "sdpa_ms": sdpa, "bound_ms": bound,
                          "bound_by": by}))
        del q, k, v, qh, kh, vh, out
    return ok


def main() -> int:
    srcs = ab_trees.trees(__doc__, "flash_attention.cu")
    if srcs is None:
        return 1
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    libs = {}
    for label, so in ab_trees.build(
            srcs, "flash_attention.cu",
            lambda name: name == "flash_wgmma_kernel"
            or name in HD256_KERNELS).items():
        fn = so.flash_attention_fwd
        lse, window = takes_lse(srcs[label]), takes_window(srcs[label])
        fn.argtypes = [ctypes.c_void_p] * (5 if lse else 4) + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int] + [
                ctypes.c_int] * window + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn.takes_lse, fn.takes_window = lse, window
        libs[label] = fn
    labels = list(libs)
    ok = labels == list(srcs)
    if not labels:
        return 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B, S, T in CASES:
        for causal in (True, False):
            q, k, v = cs.attn_inputs(gen, B, S, T, H, KV, HD, "bfloat16")
            outs = {}
            for label in labels:
                outs[label] = torch.empty_like(q)
                launch(libs[label], q, k, v, outs[label], causal)
            torch.cuda.synchronize()
            first = outs[labels[0]]
            same = {lb: torch.equal(outs[lb].view(torch.int16),
                                    first.view(torch.int16))
                    for lb in labels[1:]}
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            scale=HD ** -0.5)
            tol = cs.ATTN_TOL["bfloat16"]
            err = (first.float() - want.float()).abs().max().item()
            row = cs.attn_row_err(first, want)
            held = (bool(torch.isfinite(first.float()).all()) and row <= tol
                    and torch.allclose(first.float(), want.float(), rtol=tol,
                                       atol=tol))
            ok = ok and held and all(same.values())
            print(json.dumps({"B": B, "S": S, "T": T, "causal": causal,
                              "bitwise_equal_to_" + labels[0]: same,
                              "max_abs_err": err, "row_err": row,
                              "tol": tol, "held": held}))
            del q, k, v, outs, first, want
    for causal in (True, False):
        q, k, v = cs.attn_inputs(gen, 1, 8192, 8192, H, KV, HD, "bfloat16")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        ms = ab_trees.abba(labels, lambda label, i: launch(
            libs[label], q, k, v, out, causal), ITERS, 1)
        sdpa = cs.device_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True), ITERS)
        bound, by = cs.attn_bound(1, 8192, 8192, H, KV, HD, "bfloat16",
                                  causal)
        print(json.dumps({"timing": {"B": 1, "S": 8192, "T": 8192, "H": H,
                                     "KV": KV, "hd": HD, "causal": causal},
                          "ms": ms, "sdpa_ms": sdpa, "bound_ms": bound,
                          "bound_by": by}))
        del q, k, v, qh, kh, vh, out
    ok = hd256_cases(libs, srcs, gen) and ok
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
