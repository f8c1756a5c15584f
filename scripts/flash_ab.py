#!/usr/bin/env python3
"""Build the flash-attention kernel (csrc/flash_attention.cu) of several
source trees side by side on one NVIDIA card, hold the bf16 wgmma route of
each against the plain version and against the others bit for bit, and
time them in turns in one process.

  python3 scripts/flash_ab.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding flash_attention.cu and the headers it includes,
such as a checkout's src/repro_torch/csrc (an older commit unpacked with
`git archive` into a directory that .gitignore lists).  Each is compiled
with the port's nvcc flags into build/flash_attention_ab/, all at once
(scripts/ab_trees.py); the ptxas report of its flash_wgmma_kernel
(registers, stack frame, spills) is printed, with any compiler warning or
note that a wgmma was serialised.  The entry point's arguments are read
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
same inputs (drawn from a fixed seed).  One JSON object per line; the
card's name and power limit first.
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


def launch(fn, q, k, v, out, causal: bool) -> None:
    import torch
    B, S, _, _ = q.shape
    T = k.shape[1]
    lse = (None,) if fn.takes_lse else ()
    window = (0,) if fn.takes_window else ()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse,
            B, S, T, H, KV, HD, 0, int(causal), HD ** -0.5, 0, *window,
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"flash_attention_fwd failed: CUDA error {rc}")


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
            lambda name: name == "flash_wgmma_kernel").items():
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
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
