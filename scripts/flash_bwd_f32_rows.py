#!/usr/bin/env python3
"""Where the f32 flash-attention backward (route 2, "fma") loses precision:
build csrc/flash_attention_bwd.cu of several source trees side by side on
one NVIDIA card and hold each tree's f32 gradient to the plain backward in
f64 row by row, with and without a causal window on the same inputs.

  python3 scripts/flash_bwd_f32_rows.py LABEL=CSRC [LABEL=CSRC ...]

CSRC is a directory holding flash_attention_bwd.cu and the headers it
includes (scripts/ab_trees.py builds them).  Every tree must take the
trailing window.

Cases: the f32 cases of tests/test_torch_cuda.py's backward tests, on the
same inputs (numpy seeds as there): the windowed ones at hd 128 and 256
(each also run with no window on the same q, k, v and dout), the
unwindowed ones at hd 32 / 64 / 128 and hd 256; then SWEEP seeds of
(2, 129, 191, 4 / 2 heads, hd 128) under W 64 and with no window.  For
each tree, case and tensor it prints the contract's measure (the worst
row's largest |error| over that row's largest |value|, floored at
chip_smoke.BWD_ROW_FLOOR of the tensor's), and for dq the worst row's
(b, s, h) and how many keys it sees; beside them the same measure of
`flash_attention_bwd_plain` run in f32 on the card.  One JSON object per
line, the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json

import numpy as np

import ab_trees
from ab_trees import cs

# (dtype name, hd, H, KV) x (B, S, T, W): test_flash_backward_window_matches_plain
WINDOW_ROUTES = [(128, 4, 2), (256, 4, 2)]
WINDOW_SHAPES = [(2, 150, 200, 5), (1, 200, 200, 63), (2, 129, 191, 64),
                 (1, 191, 191, 65), (1, 100, 130, 300)]
# (B, S, T, H, KV, hd): test_flash_backward_matches_plain, causal and full
PLAIN_SHAPES = [(1, 2, 3, 1, 1, 32), (2, 65, 65, 4, 4, 32),
                (1, 100, 37, 4, 2, 64), (2, 37, 100, 6, 3, 64),
                (1, 257, 257, 32, 4, 128), (2, 129, 300, 8, 8, 128),
                (1, 300, 129, 16, 4, 128), (2, 256, 256, 8, 1, 128)]
# (B, S, T, H, KV, causal): test_flash_backward_hd_256_matches_plain
HD256_SHAPES = [(1, 1, 63, 4, 4, False), (1, 63, 65, 8, 2, True),
                (2, 64, 64, 4, 4, True), (1, 129, 127, 4, 2, True),
                (2, 127, 128, 4, 1, False), (1, 200, 260, 8, 8, True)]
SWEEP = 32


def main() -> int:
    srcs = ab_trees.trees(__doc__, "flash_attention_bwd.cu")
    if srcs is None:
        return 1
    import torch
    from repro_torch.kernels import flash_attention as fa
    libs = {}
    for label, so in ab_trees.build(
            srcs, "flash_attention_bwd.cu",
            lambda name: "f32" in name or "float" in name).items():
        fn = so.flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[label] = fn

    def inputs(seed, B, S, T, H, KV, hd):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   .cuda() for s in ((B, S, H, hd), (B, T, KV, hd),
                                     (B, T, KV, hd)))
        dout = torch.from_numpy(np.random.default_rng(seed + 1)
                                .standard_normal((B, S, H, hd),
                                                 dtype=np.float32)).cuda()
        return q, k, v, dout

    def rows(got, want):
        """The contract's measure of one tensor, and its worst row's index
        (b, s, h) or (b, t, kh)."""
        want = want.double()
        d = (got.double() - want).abs().amax(-1)
        m = want.abs().amax(-1).clamp_min(cs.BWD_ROW_FLOOR
                                          * want.abs().max().item())
        r = d / m.clamp_min(1e-300)
        i = int(r.argmax())
        return r.max().item(), list(np.unravel_index(i, r.shape))

    def run(case, q, k, v, dout, causal, window):
        B, S, H, hd = q.shape
        T, KV = k.shape[1], k.shape[2]
        scale = hd ** -0.5
        out, lse = fa._forward(q, k, v, causal, scale, want_lse=True,
                               window=window)
        want = fa.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, out, lse, dout)), causal=causal,
            scale=scale, window=window or None)
        plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             causal=causal, scale=scale,
                                             window=window or None)
        line = {**case, "causal": causal, "window": window,
                "plain_f32": {n: rows(g, w)[0] for n, g, w in
                              zip(("dq", "dk", "dv"), plain, want)}}
        scratch = fa.flash_bwd_scratch(B, H, S, q.device)
        for label, fn in libs.items():
            grads = [torch.empty_like(t) for t in (q, k, v)]
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), dout.data_ptr(),
                    *(g.data_ptr() for g in grads), scratch.data_ptr(), B, S,
                    T, H, KV, hd, 1, int(causal), scale, 2, window,
                    torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"{label}: CUDA error {rc}")
            torch.cuda.synchronize()
            errs = {n: rows(g, w)[0] for n, g, w in
                    zip(("dq", "dk", "dv"), grads, want)}
            err, (b, s, h) = rows(grads[0], want[0])
            seen = (s + 1 if causal else T) if not window else min(s + 1,
                                                                   window)
            line[label] = {"row": errs, "dq_worst_row": {
                "b": int(b), "s": int(s), "h": int(h), "keys": int(seen)}}
        print(json.dumps(line))
        return line

    worst = {}
    for hd, H, KV in WINDOW_ROUTES:
        for B, S, T, W in WINDOW_SHAPES:
            q, k, v, dout = inputs(B + S + W, B, S, T, H, KV, hd)
            case = {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd}
            for w in (W, 0):
                run({**case, "test": "window"}, q, k, v, dout, True, w)
    for B, S, T, H, KV, hd in PLAIN_SHAPES:
        q, k, v, dout = inputs(S + T + hd, B, S, T, H, KV, hd)
        for causal in (True, False):
            run({"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd,
                 "test": "plain"}, q, k, v, dout, causal, 0)
    for B, S, T, H, KV, causal in HD256_SHAPES:
        q, k, v, dout = inputs(B + S + T, B, S, T, H, KV, 256)
        run({"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": 256,
             "test": "hd256"}, q, k, v, dout, causal, 0)
    for seed in range(1000, 1000 + SWEEP):
        q, k, v, dout = inputs(seed, 2, 129, 191, 4, 2, 128)
        for w in (64, 0):
            line = run({"B": 2, "S": 129, "T": 191, "H": 4, "KV": 2,
                        "hd": 128, "test": "sweep", "seed": seed}, q, k, v,
                       dout, True, w)
            for label in libs:
                key = f"{label} W {w}"
                worst[key] = max(worst.get(key, 0.0),
                                 max(line[label]["row"].values()))
    print(json.dumps({"sweep_worst_row": worst, "seeds": SWEEP,
                      "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
