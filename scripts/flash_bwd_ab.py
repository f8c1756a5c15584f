#!/usr/bin/env python3
"""Build the flash-attention backward (csrc/flash_attention_bwd.cu) of
several source trees side by side on one NVIDIA card, hold each tree's
bf16 hd-128 route to the plain backward in f64, and time them in turns in
one process.

  python3 scripts/flash_bwd_ab.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding flash_attention_bwd.cu and the headers it
includes, such as a checkout's src/repro_torch/csrc (an older commit
unpacked with `git archive` into a directory that .gitignore lists).  Each
is compiled with the port's nvcc flags into build/flash_attention_bwd_ab/,
all at once (scripts/ab_trees.py); the ptxas report of its flash_bwd_*
kernels at hd 128 and 256 (registers, stack frame, spills) is printed,
with any compiler warning or note that a wgmma was serialised.  A tree
takes bf16 at hd 128 on route 0 ("wgmma") where its source has the wgmma
backward, else on route 1 ("mma_sync", the first version).  The entry
point's arguments are read from each tree's source: trees with the
sliding window take a trailing window, passed as 0 (none) in the cases
without one, so that a tree of either kind runs them.

Inputs: q, k, v and dout drawn from a fixed seed, out and lse from this
checkout's forward kernel, the same for every tree.  Cases (bf16, hd 128,
no window): Yi-9B's B 1, S = T = 8192, H 32, KV 4, causal; B 2, S 1000
and 1025, T 1100, causal and full; B 1, S 129, T 191, H = KV = 8.  Each
tree's dq, dk and dv must hold row by row to `flash_attention_bwd_plain`
in f64 on the same inputs (each row within chip_smoke.BWD_ROW_TOL of its
largest value, floored at chip_smoke.BWD_ROW_FLOOR of the tensor's), and
two calls of a tree must be bitwise equal.  Whether each tree's gradient
equals the first label's bit for bit is printed (trees that sum in the
same order give the same bits; others need not).  The script exits 1 if a
check fails or a tree does not build (the others still run).

Cases that only some trees have -- a causal window on route 0 (W 63, 65
and 8192 over S 1000, T 1100) and the hd-256 route ("hd256", in either
design: the first version's warp pairs or the TMA + wgmma kernels; 16 / 16
and 8 / 2 heads, causal and full, a window of 65) -- run on the trees whose
source has them, held the same way; each other tree prints a note that it
lacks them.

Timing at the Yi-9B shape: device time per launch (chip_smoke.device_ms,
the C entry point on preallocated outputs and scratch) of each label in
the order given and then reversed (A B B A), twice, five launches a turn;
each tree's kernels split by torch.profiler; beside the bound and the
backward of F.scaled_dot_product_attention (its forward and backward less
its forward) on the same inputs.  Then, on the trees that have them,
gemma-7b's (1, 8192, 16/16, 256) causal and full and Yi-9B's (1, 32768,
32/4, 128) causal under a window of 8192, in turns the same way, beside
their bounds.  One JSON object per line; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys

import ab_trees
from ab_trees import cs

H, KV, HD = 32, 4, 128
CASES = [(1, 8192, 8192, H, KV, True), (2, 1000, 1100, H, KV, True),
         (2, 1025, 1100, H, KV, False), (1, 129, 191, 8, 8, True)]
# (B, S, T, H, KV, hd, causal, window) on the trees that take them
NEW_CASES = [(2, 1000, 1100, H, KV, HD, True, 63),
             (2, 1000, 1100, H, KV, HD, True, 65),
             (2, 1000, 1100, H, KV, HD, True, 8192),
             (2, 1000, 1100, 16, 16, 256, True, None),
             (2, 1025, 1100, 8, 2, 256, False, None),
             (2, 1000, 1100, 16, 16, 256, True, 65)]
# (B, S, H, KV, hd, window, causal), timed on the trees that take them
NEW_TIMING = [(1, 8192, 16, 16, 256, None, True),
              (1, 8192, 16, 16, 256, None, False),
              (1, 32768, H, KV, HD, 8192, True)]
ITERS = 5                      # launches a timed turn
TURNS = 2
SEED = 25


def _text(csrc) -> str:
    return (csrc / "flash_attention_bwd.cu").read_text()


def route_of(csrc) -> int:
    """The route a tree's entry point takes for bf16 at hd 128."""
    return 0 if "flash_bwd_dkdv_wgmma_kernel" in _text(csrc) else 1


def takes_window(csrc) -> bool:
    """Whether the tree's flash_attention_bwd takes a trailing window."""
    m = re.search(r"flash_attention_bwd\(([^)]*)\)", _text(csrc))
    return m is not None and "window" in m.group(1)


# the bf16 hd-256 backward's (route 3's) dK / dV kernel in each design:
# the first version's warp pairs, then its TMA + wgmma redesign
HD256_DKDV_KERNELS = ("flash_bwd_dkdv_hd256_kernel",
                      "flash_bwd_dkdv_wgmma_hd256_kernel")


def has_hd256(csrc) -> bool:
    """Whether the tree has the bf16 hd-256 backward (route 3), in either
    design."""
    text = _text(csrc)
    return any(name in text for name in HD256_DKDV_KERNELS)


def main() -> int:
    srcs = ab_trees.trees(__doc__, "flash_attention_bwd.cu")
    if srcs is None:
        return 1
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    libs = {}
    for label, so in ab_trees.build(
            srcs, "flash_attention_bwd.cu",
            lambda name: name.startswith("flash_bwd_") and (
                "wgmma" in name or "128" in name or "256" in name
                or "rows" in name or "__nv_bfloat16" in name)).items():
        fn = so.flash_attention_bwd
        win = takes_window(srcs[label])
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * win + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[label] = {"fn": fn, "route": route_of(srcs[label]),
                       "window": win, "hd256": has_hd256(srcs[label])}
    labels = list(libs)
    ok = labels == list(srcs)
    if not labels:
        return 1
    print(json.dumps({"trees": {
        lb: {k: v for k, v in libs[lb].items() if k != "fn"}
        for lb in labels}}))

    def launch(label, q, k, v, out, lse, dout, grads, scratch, causal,
               window=None):
        lib = libs[label]
        B, S, Hq, hd = q.shape
        T, KVq = k.shape[1], k.shape[2]
        route = 3 if hd == 256 else lib["route"]
        rc = lib["fn"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                       *(t.data_ptr() for t in grads), scratch.data_ptr(), B,
                       S, T, Hq, KVq, hd, 0, int(causal), hd ** -0.5, route,
                       *([window or 0] if lib["window"] else []),
                       torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"{label}: flash_attention_bwd failed: CUDA error "
                 f"{rc}")

    def eligible(label, hd, window):
        lib = libs[label]
        return (hd != 256 or lib["hd256"]) and (not window or lib["window"])

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timing_inputs = None
    cases = [(B, S, T, Hq, KVq, HD, causal, None)
             for B, S, T, Hq, KVq, causal in CASES] + NEW_CASES
    for B, S, T, Hq, KVq, hd, causal, window in cases:
        q, k, v = cs.attn_inputs(gen, B, S, T, Hq, KVq, hd, "bfloat16")
        dout = torch.randn(q.shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
        out, lse = fa._forward(q, k, v, causal, hd ** -0.5, want_lse=True,
                               window=window or 0)
        # sized for the wgmma route, it serves every route
        scratch = fa.flash_bwd_scratch(B, Hq, S, q.device)
        case = {"B": B, "S": S, "T": T, "H": Hq, "KV": KVq, "hd": hd,
                "causal": causal, "window": window}
        got = {}
        for label in labels:
            if not eligible(label, hd, window):
                print(json.dumps({"label": label, **case, "note": (
                    "this tree has no "
                    + ("hd-256 backward" if hd == 256 else "window"))}))
                continue
            runs = []
            for _ in range(2):
                grads = [torch.empty_like(t) for t in (q, k, v)]
                launch(label, q, k, v, out, lse, dout, grads, scratch, causal,
                       window)
                runs.append(grads)
            torch.cuda.synchronize()
            got[label] = (runs[0], all(torch.equal(a, b)
                                       for a, b in zip(*runs)))
        x64 = [t.double() for t in (q, k, v, out, lse, dout)]
        want = fa.flash_attention_bwd_plain(*x64, causal=causal,
                                            scale=hd ** -0.5, window=window)
        del x64
        tol = cs.BWD_ROW_TOL["bfloat16"]
        first = next(iter(got.values()))[0] if got else None
        for label, (grads, same) in got.items():
            errs = cs.grad_errs(grads, want)
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            as_first = all(torch.equal(a, b) for a, b in zip(grads, first))
            held = (finite and same
                    and max(e["row"] for e in errs.values()) <= tol)
            ok = ok and held
            print(json.dumps({"label": label, **case, "errs": errs,
                              "row_tol": tol, "bitwise_repeat": same,
                              "bitwise_vs_first": as_first, "held": held}))
        del want, got, first
        if S == 8192 and hd == HD:
            timing_inputs = (q, k, v, out, lse, dout, scratch)
        else:
            del q, k, v, out, lse, dout, scratch
        torch.cuda.empty_cache()

    q, k, v, out, lse, dout, scratch = timing_inputs
    grads = [torch.empty_like(t) for t in (q, k, v)]
    ms = ab_trees.abba(labels, lambda label, i: launch(
        label, q, k, v, out, lse, dout, grads, scratch, True), ITERS, TURNS)
    split = {label: cs.kernel_split_ms(lambda i, label=label: launch(
        label, q, k, v, out, lse, dout, grads, scratch, True), ITERS)
        for label in labels}
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    doh = dout.transpose(1, 2).contiguous()

    def sdpa(i):
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qh, kh, vh), doh)

    def sdpa_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                           enable_gqa=True)

    fb, fwd = cs.device_ms(sdpa, ITERS), cs.device_ms(sdpa_fwd, ITERS)
    bound, by = cs.attn_bwd_bound(1, 8192, 8192, H, KV, HD, "bfloat16", True)
    print(json.dumps({"timing": {"B": 1, "S": 8192, "T": 8192, "H": H,
                                 "KV": KV, "hd": HD, "causal": True},
                      "ms": ms, "kernel_ms": split,
                      "sdpa_bwd_ms": fb - fwd, "sdpa_fwd_bwd_ms": fb,
                      "bound_ms": bound, "bound_by": by,
                      "card": cs.card_line()}))
    del q, k, v, out, lse, dout, scratch, grads, qh, kh, vh, doh
    torch.cuda.empty_cache()

    for B, S, Hq, KVq, hd, window, causal in NEW_TIMING:
        have = [lb for lb in labels if eligible(lb, hd, window)]
        case = {"B": B, "S": S, "T": S, "H": Hq, "KV": KVq, "hd": hd,
                "causal": causal, "window": window}
        if not have:
            print(json.dumps({"timing": case, "note": "no tree has it"}))
            continue
        q, k, v = cs.attn_inputs(gen, B, S, S, Hq, KVq, hd, "bfloat16")
        dout = torch.randn(q.shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
        out, lse = fa._forward(q, k, v, causal, hd ** -0.5, want_lse=True,
                               window=window or 0)
        scratch = fa.flash_bwd_scratch(B, Hq, S, q.device)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        ms = ab_trees.abba(have, lambda label, i: launch(
            label, q, k, v, out, lse, dout, grads, scratch, causal, window),
            ITERS, TURNS)
        split = {label: cs.kernel_split_ms(lambda i, label=label: launch(
            label, q, k, v, out, lse, dout, grads, scratch, causal, window),
            ITERS) for label in have}
        bound, by = (cs.attn_window_bwd_bound(B, S, Hq, KVq, hd, "bfloat16",
                                              window) if window else
                     cs.attn_bwd_bound(B, S, S, Hq, KVq, hd, "bfloat16",
                                       causal))
        print(json.dumps({"timing": case, "ms": ms, "kernel_ms": split,
                          "bound_ms": bound, "bound_by": by,
                          "without": [lb for lb in labels if lb not in have],
                          "card": cs.card_line()}))
        del q, k, v, out, lse, dout, scratch, grads
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
