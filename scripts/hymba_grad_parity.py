#!/usr/bin/env python3
"""Hold hymba-1.5b's bf16 LoRA gradient through the kernels against the
plain path's on several seeds, beside a control, on one NVIDIA card: the
readings that chip_smoke.GRAD_REL_L2_BF16 (phase 24 (c)) is read from.

  python3 scripts/hymba_grad_parity.py [--seeds 0 1 2 3] [--tokens 8192]

For each seed: full-width hymba-1.5b with random weights from the seed
(chip_smoke.recurrent_params, phase 24's draw) cut to 2 layers, one
--tokens sequence in bf16, and chip_smoke.parity_grads: the flat LoRA
gradient through the flash and scan kernels and through the plain path
(chunked_attention and selective_scan_plain under autograd).  Then the
control: the plain path again with its scan's state rounded to bf16 at
every step (`rounded_state_scan`: what a scan kernel that kept its state in
u's dtype would give), held to the plain path's gradient by the same
relative L2.  A limit that the seeds meet and the control fails tells a
kernel that rounds as the control does from one that does not.  One JSON
object a seed, then the largest reading and the smallest control; the
card's name and power limit first.  Exits 1 if a check of parity_grads
fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                    # noqa: E402


def rounded_state_scan(u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0=None,
                       out_state=None):
    """`selective_scan_plain` with its state h rounded to u's dtype after
    every step (the wrapper's signature, differentiated by autograd)."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    uf, dt, A = ss.scan_coeffs(u, w_dt, dt_bias, A_log)
    B, S, di = u.shape
    h = torch.zeros(B, di, A.shape[-1], dtype=uf.dtype, device=u.device)
    dtu = dt * uf
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        h = (a * h + dtu[:, t, :, None] * Bc[:, t, None, :]).to(
            u.dtype).to(uf.dtype)
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    return torch.stack(ys, dim=1) + D_skip * uf, h


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tokens", type=int, default=cs.LONG_S)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("hymba_grad_parity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0)}))
    tag = "[grad-parity]"
    rows = []
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            cfg, params = cs.recurrent_params("hymba-1.5b", seed)
            cfg2, p2 = cs.layer_cut(cfg, params)
            base = cs.parity_grads(cfg2, p2, seed, args.tokens, None, tag)
            plain_scan = cs.plain_scan
            cs.plain_scan = rounded_state_scan
            try:
                ctrl = cs.parity_grads(cfg2, p2, seed, args.tokens, None, tag)
            finally:
                cs.plain_scan = plain_scan
            row = {"seed": seed, "tokens": args.tokens, "layers": 2,
                   "dtype": cfg2.compute_dtype,
                   "kernels_vs_plain": cs.rel_l2(base["kernels"],
                                                 base["plain"]),
                   "control_vs_plain": cs.rel_l2(ctrl["plain"],
                                                 base["plain"]),
                   "loss": base["loss"], "control_loss": ctrl["loss"][1],
                   "s": time.perf_counter() - t0}
            print(json.dumps(row))
            rows.append(row)
            del params, p2, base, ctrl
            torch.cuda.empty_cache()
    except cs.PhaseError as e:
        print(f"{tag} FAILED: {e}")
        return 1
    print(json.dumps({
        "largest_kernels_vs_plain": max(r["kernels_vs_plain"] for r in rows),
        "smallest_control_vs_plain": min(r["control_vs_plain"]
                                         for r in rows),
        "limit_in_chip_smoke": cs.GRAD_REL_L2_BF16, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
