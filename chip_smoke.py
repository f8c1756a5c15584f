#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch/`) on one NVIDIA card.

  python3 chip_smoke.py [--seed N] [--profile]

Phases, each fatal on failure:
  1. build    -- compile every CUDA source under src/repro_torch/csrc/ with
                 nvcc (one process per source, all started together); print
                 each kernel's registers, shared memory and spills, and fail
                 if a wgmma kernel, a rank bucket of the grouped kernel, a
                 bin_counts kernel or an instantiation of the packs' scan
                 (pack_scan_kernel<Rows>: pack_batch's and
                 mask_quantize_pack's at bits 0, nearest and stochastic)
                 or their fill, or a kernel of the flash backward, has a
                 stack frame or spills, or ptxas serialised a wgmma or
                 ignored a setmaxnreg.
  2. kernels  -- the grouped LoRA kernel against its plain PyTorch version
                 on the card at the serving decode shapes and ragged ones
                 (M in {1, 8, 130}, N in {4096, 512, 50}, R in {1, 16, 64},
                 K 4096 and 4097; f32, rtol 1e-4 / atol 1e-5: the
                 summation order differs), two launches bitwise equal; times
                 the kernel, an empty launch of the same grid and clusters
                 (the latency floor), the plain version and a PyTorch
                 library call computing the same function.
  3. serve    -- the port's serving CLI (`launch/serve.py`) at the full
                 width and depth of Yi-9B in bf16: 8 tenants, rank-16
                 adapters, 4 pages, 8 lanes, 16 requests.  The grouped
                 kernel's launch count is zeroed just before and read just
                 after: it must equal decode steps x 48 layers x 4 targets
                 (prefill launches none).
  4. parity   -- a 2-layer full-width f32 engine against the port's
                 single-adapter prefill + decode reference: completions
                 must match, except where the reference's top-2 logit gap
                 is below 1e-3 (each such case is printed).  Then one
                 8192-token prompt on the same weights: prefill logits and
                 greedy completion through the flash kernel, and through
                 `chunked_attention` (plain torch on the card) put in the
                 kernel's place for this one comparison; completions must
                 match under the same near-tie rule, the largest logit
                 difference is printed.
  5. transport -- the five Top-K transport kernels (csrc/transport.cu)
                 against their plain versions, BITWISE, at the Yi-9B LoRA
                 vector length (9,830,400), phase 12's ViT-B/16 vector
                 (1,188,096), 1,000,003 and 50, one and four
                 rows, normal / tied / all-zero rows and rows holding
                 +-inf (whose inf scale makes the quantized survivors NaN,
                 compared as NaN), bits 0 and 4, nearest and stochastic
                 rounding; bin_counts also at 1, 5 and 12
                 levels on every row kind of tests/_bin_rows.py (denormal,
                 overflowing, infinite, NaN and negative bounds, NaN
                 elements, sixty decades, elements on the edges of its
                 search table); then each kernel's device time at the Yi-9B
                 length beside its bound, its plain version and a library
                 call.
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
                 overflowing one, and (n in {9,830,400, 1,000,003}) a view
                 one float into its storage, cap 0, and a second call that
                 must give the same bits; mask_quantize_pack at bits 0 and 4,
                 nearest and stochastic, k in {0, 1, n/4, n}, also on rows
                 holding +-inf and NaN elements (NaN compared as NaN), and
                 like pack_batch on views one float in (x and u), at cap 0
                 and twice over.  Flat ==
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
                 uploads.  (d) one sim round of kind "lora" with
                 sparse_aggregate=True, whose dense uploads overflow the
                 capacity on every row (the dense branch), against the
                 same round with sparse_aggregate=False: equal losses and
                 flatP bitwise equal.
  10. ops      -- the `kernels/ops.py` entry point: `lora_matmul` once per
                 Yi-9B projection for an 8192-row prompt in bf16 (launches
                 counted, every one on the wgmma route), each output
                 against its plain version, plus bf16 at M = 8191 (wgmma),
                 f32 at (4096, 4096) (fma) and a ragged (M, K, N, r) = (100,
                 300, 200, 5) in bf16 (mma_sync) and f32; `flash_attention`
                 (GQA: B 1, H 32, KV 4, hd 128) at S = T = 8192 and 1000,
                 bf16 (wgmma) and f32 (fma), causal and not, and at B 2,
                 S 1000 and 1025, T 1100 in bf16 with hd 128 (wgmma, H 32,
                 KV 4; the last block's second consumer warpgroup holds 40
                 rows or none), S 1000 and 1025 at hd 64 (hd64, H 8, KV 2)
                 and S 1000 at hd 32 (mma_sync), against its plain version
                 (p in f32, v promoted), every bf16 case against an f64
                 attention of its inputs row by row (4e-3 of each row's
                 largest value; at 8192 tokens on 256 sampled query rows of
                 every head); a causal sliding window on every route
                 (bf16 wgmma, hd64, mma_sync at hd 32, hd256; f32 fma at hd
                 128 and 256) at B 2, S 1000, T 1100 with W 1, 37, 100 and
                 1100 (bitwise the call without a window), S 1025 with W
                 65, and at 9000
                 tokens with W 4096 and 8192, and hd 256 (the hd256 route
                 in bf16, fma in f32) at 8192 tokens and ragged, every one
                 bitwise on repeat, bf16 rows against an f64 attention
                 under the same window, the hd256 and hd64 routes' lse
                 within 1e-4 of the plain version's in f64; at 8192 in bf16
                 also against
                 `chunked_attention`, and the pre-broadcast
                 `ops.flash_attention` bitwise equal to the GQA call; each
                 call's route is counted.  `ops.topk_mask` and `ops.histogram_threshold`
                 bitwise against their plain loops at the Yi-9B LoRA
                 length.  Tolerances: f32 attention 2e-6, f32 matmul 1e-5
                 x sqrt(K / 512), bf16 5e-2 matmul and 2e-2 attention,
                 elementwise and of each output row's largest value.  Then
                 device times beside bounds, plain versions and library
                 calls (cuBLAS; F.scaled_dot_product_attention), also at
                 (1, 32768, 32/4, 128) bf16 causal under a window of 8192
                 (plain: chunked_attention(window=); library: SDPA's
                 memory-efficient kernel with the band as a bool mask) and
                 (1, 8192, 16/16, 256) bf16 causal.
  11. long-prefill -- `ServingEngine` on Yi-9B at full width and depth in
                 bf16: 4 tenants, rank-16 adapters, 2 pages, 2 lanes, 4
                 requests with prompts of 8192 or 9216 tokens.  The flash
                 kernel's launch counts are zeroed just before and read just
                 after: they must equal prefills x 48, every one on the
                 wgmma route; the grouped kernel's must equal decode steps
                 x 48 x 4.  Prefill ms per request, decode ms per step,
                 tok/s and peak memory are printed.
  12. task     -- the paper's path through `Experiment(task)` at full
                 width and depth, random weights from --seed: (a) ViT-B/16
                 (bf16) on make_synth_image with 196 patches of 768 (1024
                 examples, 32 clients, 256 eval), pretrained 20 steps at
                 batch 64, then 8 clients x 2 local steps x 8 examples,
                 rank-16 LoRA on wq/wk/wv/wo plus the trained head (p_len
                 1,188,096): flasc (fused selector, 4-bit uploads, density
                 0.25 both ways) for 4 rounds with eval every 2, and dense
                 lora for 4; (b) GPT-2 Small (vocab 50,257, tied, learned
                 positions) on make_synth_reddit, pretrained 10 steps,
                 then flasc for 2 rounds with eval at the end.  The
                 transport launch counts are zeroed just before each run
                 and read just after: phase 6's per-round counts x rounds
                 for flasc, none for lora.  Losses finite, accuracies in
                 [0, 1], FLASC's coded upload bytes below dense LoRA's, the
                 batches, backbone and flat vector on the card, and the
                 transport kernels bitwise equal to their plain versions on
                 the ViT run's round-0 uploads (8 x 1,188,096).  Prints
                 pretrain ms a step, round ms, eval ms, accuracy, loss,
                 ledger bytes and peak memory beside the card's name and
                 power limit.
  13. baselines -- the paper's baselines through `Experiment(task)` on
                 phase 12's pretrained ViT-B/16 and task (8 clients x 2 x 8,
                 rank 16 plus the head, eval at the end): flasc_ef,
                 fedselect, sparse_adapter (fused selector; flasc_ef with
                 4-bit uploads) 2 rounds, adapter_lth 3 (two prunes), ffa,
                 hetlora plain and weighted (ranks 2, 2, 4, 4, 8, 8, 12,
                 12), adapter_lth through the pallas selector, flocora in random and in learned mode (rank 8 of a
                 1090 x 1090 embedding), two_stage_ortho (fused, 4-bit up),
                 FLASC with DP (clip 1, noise 1) and full finetuning
                 (p_len 85,112,832), 2 rounds each.  The transport and pack
                 launch counts are zeroed before each run and must equal
                 the kind's prediction (BASELINES); losses finite; flat
                 vector and backbone on the card; ffa's A entries and
                 hetlora's uncovered ranks bitwise unchanged and every B
                 entry of its lowest ranks moved; the lottery ticket's
                 pruned entries 0, its density the schedule's and its kept
                 count k to k + 0.1%;
                 two_stage_ortho's A orthonormal (1e-4) after its fold and
                 its products kept by the fold (1e-4); flocora's coded
                 bytes the factors' f32 entries; DP with hetlora_weighted
                 refused.  Prints each round's loss and ms, ledger bytes
                 against dense LoRA's (phase 12), accuracy and peak memory.
  14. fig2     -- Figure 2 at ViT-B/16 through the ported harness
                 (benchmarks_torch): the paper-size image task and
                 backbone from common.get_task / common.pretrained_backbone
                 at common.PAPER_PRETRAIN (the pretrained accuracy must be
                 at least 0.3), then four of the figure's METHODS through
                 common.run, 10 rounds with eval every 5: lora, flasc_d1/4
                 as written (the exact selector) and flasc_d1/4 and
                 flasc_d1/4_q8 with selector "fused".  Prints the harness's
                 rows for each run (best_acc, final_acc, total_MB,
                 coded_MB, comm_vs_dense, coded_vs_dense) and the best-
                 accuracy gap between the exact and the fused FLASC d1/4.
                 Losses finite; every FLASC run's coded bytes below dense
                 LoRA's; the launches zeroed before each run and read after
                 must be fig2_launches' (none for exact and lora); the fused
                 d1/4 run's round-0 uploads through the transport kernels
                 bitwise equal to their plain versions.
  15. resume   -- checkpoint / resume on phase 12's pretrained ViT-B/16 and
                 task (8 clients x 2 x 8, rank 16 plus the head), FLASC
                 (fused, 4-bit up), 4 rounds: (a) sim, (b) async with
                 sparse_aggregate, concurrency 4, buffer 2, tiered(8, 2),
                 the snapshot taken with jobs in flight, (c) a population
                 of 10,000 behind an availability trace (period 8, duty
                 0.5, chunk 4).  Each runs straight twice (which must agree
                 bitwise: the card's own determinism), then with
                 with_checkpoint(every=2) stopped after its first snapshot
                 and Experiment.resume(dir, device="cuda") for rounds 2-3:
                 history (wall-clock phases left out), ledger, accuracy,
                 flat vector, server and strategy state bitwise equal to
                 the straight run, (a)'s resumed launches its per-round
                 counts x 2, (c)'s store the touched chunks x 4 x
                 4,752,384 B with equal rows.  (d) AsyncEngine(sampler=
                 fraction 0.5) under hetlora_weighted (phase 13's ranks)
                 at buffer 2, the slot-specialised server phase: finite
                 losses, every event a buffer of 2, the uncovered ranks
                 bitwise unchanged.  Prints each snapshot's files and
                 bytes, save and load seconds and peak memory.
  16. population -- phase 6's full-width Yi-9B FLASC (fused, 4-bit up, rank
                 8, 4 clients x 4 x 32 tokens) behind with_population(10^6,
                 sampler="uniform", chunk=1), 4 rounds with prefetch on and
                 4 off: histories and final flat vectors bitwise equal,
                 one H2D copy a round, the store the touched clients x
                 39,321,600 B, the transport launches phase 6's a round x
                 4; prints take() wait ms and round ms a round.
  17. train-cli -- `python -m repro_torch.launch.train --arch yi-9b
                 --rounds 2` in this process at full width and depth: its
                 ledger lines positive, its losses finite.
  18. long-train -- LoRA training at 8192 tokens or more: (a) the flash
                 backward (csrc/flash_attention_bwd.cu) at q (1, 8192, 32,
                 128), k / v (1, 8192, 4, 128) bf16 causal and at a ragged
                 f32 shape at hd 64 with H == KV (causal and full), each row
                 of dq, dk and dv against `flash_attention_bwd_plain` in f64
                 on the same inputs (bf16 1e-2, f32 1e-4 of the row's
                 largest value, floored at 1e-2 of the tensor's), the error
                 against the exact gradient printed beside it, the
                 forward's lse against the f64 one (1e-4), two calls bitwise
                 equal, out bitwise the same with and without lse; its
                 device time (bf16 at hd 128 takes the wgmma route) beside
                 its bound, its plain version and SDPA's backward, split
                 into its kernels by torch.profiler.  (b) Yi-9B at full width, 2 layers, 8192 tokens,
                 bf16: the flat LoRA gradient of `loss_fn` through the
                 kernels against the one through chunked_attention's
                 autograd on the card, relative L2 within 2e-2.  (c)
                 `Experiment(None)` on full Yi-9B (48 layers): FLASC (fused,
                 4-bit up, density 0.25/0.25, rank 8), one local step of one
                 sequence a client, 2 rounds of 2 clients at 8192 tokens,
                 then 1 round of 1 client at 32768.  Launches zeroed just
                 before each run and read just after: flash forward 96 a
                 client step (the forward and its recomputation), all on
                 the wgmma route, the backward 48 a client step (wgmma),
                 the transport kernels phase 6's a round; losses finite;
                 round ms, ms a client step and peak memory printed.
                 (a) also holds the widened backward, each case to
                 the f64 plain backward under the same window and bitwise
                 on repeat: a causal window of 1, 63, 64, 65 and 8192 keys
                 (8192 >= S: bitwise the call without one) at B 2, S 1000,
                 T 1100 on every route (bf16 wgmma 32/4 at hd 128,
                 mma_sync 8/2 at hd 64 after the hd64 forward, hd256
                 16/16, f32 fma 8/2 at hd 128); the hd256 route around its 32-, 64- and 128-row
                 tiles, at S / T of 1, 31, 32, 33, 63, 64, 65, 127, 128,
                 129 and 1000 / 1100, heads 16/16 and 8/2, causal and
                 full, and under windows of 1, 31, 32, 33, 63, 64 and 65;
                 f32 at hd 256 ragged and under a window (where every row
                 sees one key, W 1, the exact dq and dk are 0 and are
                 held by their size, grad_worst); then times the hd256
                 backward (lse and D, dK / dV, dQ) at (1, 8192,
                 16/16, 256) and the windowed wgmma backward at (1, 32768,
                 32/4, 128), W 8192, each first held to the f64 plain
                 backward at that shape (every row at hd 256; sampled
                 rows of dq, dk and dv under the window) and its timed
                 launches to the checked call's bits, beside their
                 bounds, plain versions and SDPA's backward, split into
                 kernels.  (e) full Yi-9B's LoRA gradient of
                 loss_fn(window=8192) on one 32768-token sequence: 96
                 windowed wgmma forward and 48 windowed wgmma backward
                 launches, ms and peak memory; then (b) on a 2-layer cut
                 at 8192 tokens under a window of 4096.
  19. window  -- (a) `ServingEngine(window=8192)` (registry.LONG_CONTEXT_
                 WINDOW) on Yi-9B at full width and depth in bf16: 8
                 lanes, 8 requests with prompts of 32768 or 64 tokens.
                 Every prefill's cache must hold 8192 slots; the flash
                 launches, zeroed just before and read just after, must
                 be 48 a long prefill, every one windowed and on the
                 wgmma route; the grouped kernel's decode steps x 48 x 4.
                 Prints prefill ms, decode ms a step, peak memory and the
                 batch cache's bytes against an unwindowed one at the same
                 max_len.  (b) a 2-layer full-width f32 engine under the
                 same window, prompts of 12288 or 64 tokens, against the
                 single-adapter prefill + decode reference (phase 4's
                 near-tie rule), and one 12288-token prompt through the
                 kernel (2 windowed fma launches) and through
                 chunked_attention(window=) in its place: completions
                 under the same rule, the largest logit difference printed.
  20. archs   -- minitron-8b, gemma-7b and qwen3-32b at full width and
                 depth in bf16 through `launch/serve.py` with phase 3's
                 settings: the grouped kernel's launches decode steps x L
                 x 4; the device memory left once the weights are built;
                 one 8192-token prefill each, L flash launches on the
                 hd256 route (gemma-7b) or wgmma, its ms and peak memory.
                 Then phase 4 on a 2-layer f32 cut of gemma-7b, whose
                 8192-token prompt takes the f32 hd-256 route.
  21. gemma-train -- gemma-7b at full width and depth in bf16 (hd 256):
                 phase 18 (b)'s gradient parity on a 2-layer cut at 8192
                 tokens, then phase 18 (c)'s FLASC rounds (2 rounds of 2
                 clients at 8192 tokens): 56 hd256 forward and 28 hd256
                 backward launches a client step; ms a client step, round
                 ms and peak memory.
  22. gpt-serve -- GPT-2 Small (configs/paper_models.py, learned positions,
                 tied 50,257 vocab) at full width and depth in bf16 through
                 `ServingEngine` with phase 3's tenants, pages, lanes and
                 rank: 16 requests with prompts of 16 or 1000 tokens, 4-12
                 generated, max_len 1024; the grouped kernel's launches
                 decode steps x 12 x 4; decode ms a step, tok/s, a
                 1000-token prefill's ms.  Then a 2-layer f32 cut against
                 a greedy loop over `forward` on the whole sequence (phase
                 4's near-tie rule: the reference's decode adds position
                 0's embedding to every token, its forward each token's
                 own).
  23. recurrent -- (a) the selective scan (csrc/selective_scan.cu) against
                 its plain version on the card at hymba-1.5b's 8192-token
                 prefill (bf16 and f32), its decode (S 1, nonzero h0), S 300
                 and 1, B 4 and a ragged width at N 8, and at the chunk
                 edges (L - 1, L, L + 1, 2 L + 3 for the kernels' L =
                 CHUNK; B 4 ragged from h0 and N 8 over three chunks) (y
                 and h_last within 1e-4 of max|plain|, two launches
                 bitwise equal), in place over h0 as decode calls it,
                 timed beside its bound at the card's clock and the plain
                 loop, its three kernels split by torch.profiler (each
                 recorded once a call, the parts within 5% of the call);
                 the windowed flash forward at hymba's (1, 8192, 25/5, 64)
                 under W 1024 (route hd64) held to chunked_attention and
                 f64 rows, and timed, its timed output the checked call's
                 bits; also unwindowed beside SDPA, held to a wrapper call
                 and f64 rows.  (b)
                 hymba-1.5b at full width and depth in bf16
                 through `launch/serve.py` with phase 3's settings: grouped
                 launches steps x 32 x 6, scan launches (prefills + steps)
                 x 32; prompts of 8192 and 32768 tokens through the
                 engine's prefill (32 windowed hd64 flash launches and
                 32 scan launches each; ms, peak memory, the lane's 1024 KV
                 slots and Mamba state against an unwindowed cache), the
                 8192-token prefill split by kernel (scan, flash, GEMMs,
                 elementwise and casts with the causal conv timed apart,
                 the rest) beside its wall ms.  (c)
                 xlstm-1.3b the same way (grouped launches steps x 54), then
                 one 1024-token prompt (ms, device kernels, the lane's
                 state bytes).  (d) 2-layer f32 hymba and one-period f32
                 xLSTM at full width against the single-adapter reference
                 (phase 4's near-tie rule), hymba's 8192-token prompt
                 through the kernel against chunked_attention, and its
                 300-token prefill through the scan kernel against the
                 plain scan.
--profile adds torch.profiler windows over a few decode steps of phase
3's engine, over one more round of phase 6, over one 8192-token
prefill of phase 11's engine and over one 8192-token client step of
phase 18 (device busy share, GEMM, flash forward and backward ms), and
writes their traces under chiprun_out/.

The last three lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.  With no CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import gzip
import json
import math
import os
import re
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
# phase 1: the build's report
# ---------------------------------------------------------------------------

# the kernels built on csrc/hopper.cuh (TMA, mbarriers, wgmma, setmaxnreg)
# and the libraries that hold them
HOPPER_KERNELS = ("flash_wgmma_kernel<128>", "lora_matmul_wgmma_kernel",
                  "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                  "flash_wgmma_hd256_kernel",
                  "flash_bwd_dkdv_wgmma_window_kernel",
                  "flash_bwd_dq_wgmma_window_kernel",
                  "flash_bwd_dkdv_wgmma_hd256_kernel",
                  "flash_bwd_dq_wgmma_hd256_kernel",
                  "flash_bwd_dkdv_wgmma_hd256_window_kernel",
                  "flash_bwd_dq_wgmma_hd256_window_kernel",
                  "flash_wgmma_kernel<64>")
WGMMA_LIBS = ("flash_attention", "flash_attention_bwd", "lora_matmul")
# what the backward's wgmma route launches, in order: lse and D, dK / dV, dQ
FLASH_BWD_WGMMA = ("flash_bwd_rows_kernel<128>", "flash_bwd_dkdv_wgmma_kernel",
                   "flash_bwd_dq_wgmma_kernel")
# the grouped LoRA kernel (thread-block clusters): one per rank bucket, with
# 16-byte loads (1) or element loads (0)
GROUPED_KERNELS = tuple(f"grouped_lora_cluster_kernel<{rp}, {vec}>"
                        for rp in (4, 8, 16, 32, 64) for vec in (1, 0))
# the transport entry points redesigned for Hopper (csrc/transport.cu): the
# histogram search at its widest and its sum; the one-pass scan of both
# packs, one instantiation a row source (pack_batch; mask_quantize_pack at
# bits 0, nearest and stochastic), and their fill
PACK_SCAN_KERNELS = tuple(
    f"pack_scan_kernel<{rows}>" for rows in (
        "NonzeroRows", "MaskQuantizeRows<0, 0>", "MaskQuantizeRows<1, 0>",
        "MaskQuantizeRows<1, 1>"))
TRANSPORT_KERNELS = ("bin_partial_kernel<12>", "bin_sum_kernel",
                     *PACK_SCAN_KERNELS, "pack_fill_kernel")
# the flash backward (csrc/flash_attention_bwd.cu): lse and D at hd 128 and
# 256 for the wgmma and hd256 routes (bf16; their dK / dV and dQ kernels are
# in HOPPER_KERNELS); D, then dK / dV and dQ on the mma.sync (bf16, hd 32
# and 64) and FMA (f32, every head size) routes; each dK / dV and dQ kernel
# with its twin under a window (`_window_kernel`)
FLASH_BWD_KERNELS = ("flash_bwd_rows_kernel<128>",
                     "flash_bwd_rows_kernel<256>",
                     "flash_bwd_dot_kernel<__nv_bfloat16>",
                     "flash_bwd_dot_kernel<float>") + tuple(
    f"flash_bwd_{part}_bf16{win}_kernel<{hd}>"
    for part in ("dkdv", "dq") for win in ("", "_window") for hd in (32, 64)
    if (part, win, hd) != ("dq", "_window", 64)) + tuple(
    f"flash_bwd_{part}_f32{win}_kernel<{hd}>" for part in ("dkdv", "dq")
    for win in ("", "_window") for hd in (32, 64, 128, 256))
# flash backward kernels that ptxas builds with a spill: reported with
# their registers and spills, not gated (the windowed mma.sync dQ at hd 64:
# 12 bytes of spill stores)
FLASH_BWD_REPORTED = ("flash_bwd_dq_bf16_window_kernel<64>",)
# the selective scan (csrc/selective_scan.cu): state sizes 8 and 16, u in
# bf16 or f32; a chunk's end state from zero, the chunks' carry, the
# rescan with the readout
SCAN_KERNELS = tuple(f"selective_scan_{part}<{n}, {t}>"
                     for part in ("chunk_kernel", "kernel") for n in (8, 16)
                     for t in ("__nv_bfloat16", "float")) + tuple(
    f"selective_scan_carry_kernel<{n}>" for n in (8, 16))
# kernels that must build with no stack frame and no spills
GATED_KERNELS = (HOPPER_KERNELS + GROUPED_KERNELS + TRANSPORT_KERNELS
                 + FLASH_BWD_KERNELS + SCAN_KERNELS)
# the flash forward's other kernels (csrc/flash_attention.cu): mma.sync at hd
# 32, FMA at every head size; each must be in its library's log, and its
# registers and spills are printed
FLASH_FWD_KERNELS = ("flash_bf16_kernel<32>",) \
    + tuple(f"flash_f32_kernel<{hd}>" for hd in (32, 64, 128, 256))


# what cu++filt prints beside a kernel's name and template arguments: the
# anonymous namespace of csrc/<file>.cu, and the type of each literal
DEMANGLED_NOISE = re.compile(r"<unnamed>::|\([\w ]+\)")


def short_name(demangled: str) -> str:
    """`pack_scan_kernel<MaskQuantizeRows<1, 0>>` from a kernel's name as
    `cu++filt -p` prints it: without the anonymous namespace, the types of
    the literal arguments and the return type."""
    return DEMANGLED_NOISE.sub("", demangled).removeprefix("void ").strip()


def ptxas_kernels(log: str):
    """[(kernel, report)] from one library's `nvcc -Xptxas -v` output: each
    kernel's registers, shared memory, stack frame and spills, in the
    compiler's words, under its name as the CUDA toolkit's cu++filt
    demangles it (short_name)."""
    mangled, reports = [], []
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            mangled.append(line.split("'")[1])
            reports.append([])
        elif reports and ("spill" in line or "registers" in line):
            reports[-1].append(line.replace("ptxas info    :", "").strip())
    if not mangled:
        return []
    from repro_torch.kernels import _build
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    names = subprocess.run([filt, "-p", *mangled], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    check(len(names) == len(mangled),
          f"cu++filt gave {len(names)} names for {len(mangled)} kernels")
    return [(short_name(name), "; ".join(report))
            for name, report in zip(names, reports)]


def build_report(libs) -> None:
    """Print every kernel's registers, shared memory and spills, and every
    compiler warning.  Fail if a library's compiler log is missing, if a
    gated kernel (the five wgmma kernels, the grouped kernel's rank
    buckets, the bin_counts kernels, every instantiation of the packs' scan
    and their fill, the flash backward's kernels) is not in its library's
    log with its stack frame and spill counts, if it has any of them, or if
    ptxas serialised a wgmma or ignored a setmaxnreg in a library that
    holds a wgmma kernel (each of which quietly costs most of what the
    design buys)."""
    checked = {}
    for lib, path in sorted(libs.items()):
        log_path = path.with_suffix(".so.log")
        check(log_path.exists(), f"{lib}: no compiler log at {log_path}")
        log = log_path.read_text()
        for name, report in ptxas_kernels(log):
            print(f"[build] {lib}: {name}: {report}")
            if name in FLASH_FWD_KERNELS + FLASH_BWD_REPORTED:
                checked[name] = report
            if name in GATED_KERNELS:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", report)
                check(m is not None,
                      f"{name}: no stack frame and spill counts in {report!r}")
                check(not any(int(c) for c in m.groups()),
                      f"{name} has a stack frame or spills: {report}")
                checked[name] = report
        warnings = [ln.strip() for ln in log.splitlines()
                    if "warning" in ln.lower() or
                    "Potential Performance Loss" in ln]
        for ln in warnings:
            print(f"[build] {lib}: {ln}")
        if lib in WGMMA_LIBS:
            check(not any("wgmma" in ln or "setmaxnreg" in ln or "C75" in ln
                          for ln in warnings),
                  f"ptxas serialised the wgmma or ignored setmaxnreg in {lib}")
    missing = [k for k in GATED_KERNELS + FLASH_FWD_KERNELS
               + FLASH_BWD_REPORTED if k not in checked]
    check(not missing, f"the compiler logs report no {missing}")
    import ctypes
    from repro_torch.kernels import _build
    for lib in ("flash_attention", "lora_matmul"):
        vals = [ctypes.c_int() for _ in range(3)]
        getattr(_build.load(lib), f"{lib}_wgmma_config")(
            *(ctypes.byref(v) for v in vals))
        print(f"[build] {lib}: {HOPPER_KERNELS[lib == 'lora_matmul']}: "
              f"{vals[0].value} bytes dynamic shared memory, setmaxnreg "
              f"{vals[1].value} registers (producer) / {vals[2].value} "
              "(consumers)")
    vals = [ctypes.c_int() for _ in range(4)]
    _build.load("flash_attention_bwd").flash_attention_bwd_wgmma_config(
        *(ctypes.byref(v) for v in vals))
    print(f"[build] flash_attention_bwd: {HOPPER_KERNELS[2]} / "
          f"{HOPPER_KERNELS[3]}: {vals[0].value} / {vals[1].value} bytes "
          f"dynamic shared memory, setmaxnreg {vals[2].value} registers "
          f"(producer) / {vals[3].value} (consumers)")
    vals = [ctypes.c_int() for _ in range(2)]
    _build.load("flash_attention").flash_attention_hd256_config(
        *(ctypes.byref(v) for v in vals))
    print(f"[build] flash_attention: {HOPPER_KERNELS[4]}: {vals[0].value} "
          f"bytes dynamic shared memory, {vals[1].value} threads, no "
          "setmaxnreg (every thread may take 255 registers)")
    vals = [ctypes.c_int() for _ in range(3)]
    _build.load("flash_attention").flash_attention_hd64_config(
        *(ctypes.byref(v) for v in vals))
    print(f"[build] flash_attention: {HOPPER_KERNELS[-1]}: {vals[0].value} "
          f"bytes dynamic shared memory, setmaxnreg {vals[1].value} "
          f"registers (producer) / {vals[2].value} (consumers)")
    vals = [ctypes.c_int() for _ in range(3)]
    _build.load("flash_attention_bwd").flash_attention_bwd_hd256_config(
        *(ctypes.byref(v) for v in vals))
    print(f"[build] flash_attention_bwd: {HOPPER_KERNELS[7]} / "
          f"{HOPPER_KERNELS[8]} (and their window twins): {vals[0].value} / "
          f"{vals[1].value} bytes dynamic shared memory, {vals[2].value} "
          "threads, no setmaxnreg (every thread may take 255 registers)")
    print(f"[build] {', '.join(GATED_KERNELS)}: no stack frame, no spills; "
          "no wgmma serialisation, no ignored setmaxnreg")
    print(f"[build] reported, not gated: "
          + "; ".join(f"{k}: {checked[k]}"
                      for k in FLASH_FWD_KERNELS + FLASH_BWD_REPORTED))


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


def grouped_held(kern, ref, gen, M, K, R, N, G, scale,
                 tag: str = "[kernels]") -> float:
    """grouped_pallas against grouped_ref on one input set of this shape:
    within RTOL / ATOL, finite, and a second launch bitwise equal to the
    first.  Returns max|err|."""
    import torch
    x, a, b, g = grouped_case(gen, M, K, R, N, G)
    got = kern.delta(x, a, b, g, scale)
    again = kern.delta(x, a, b, g, scale)
    want = ref.delta(x, a, b, g, scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    print(f"{tag} grouped_pallas M={M} K={K} R={R} N={N} G={G}: "
          f"max|err| {err:.3e} {'ok' if ok else 'MISMATCH'}; a second "
          f"launch bitwise equal: {same}")
    check(ok and bool(torch.isfinite(got).all()),
          f"grouped_pallas disagrees with grouped_ref at M={M} K={K} "
          f"R={R} N={N}")
    check(same, f"grouped_pallas is not deterministic at M={M} K={K} "
          f"R={R} N={N}")
    return err


def kernel_phase(seed: int):
    import torch
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    kern = resolve_grouped_kernel("grouped_pallas")
    ref = resolve_grouped_kernel("grouped_ref")
    gather = resolve_grouped_kernel("grouped_gather")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, R, G, scale = 4096, 16, 4, 2.0
    max_err = 0.0
    cases = [(M, K, R_, N) for R_ in (16, 1, 64) for M in (1, 8, 130)
             for N in (4096, 512, 50)] + [(8, 4097, 16, 4096),
                                          (130, 4097, 5, 257)]
    for M, K_, R_, N in cases:
        max_err = max(max_err, grouped_held(kern, ref, gen, M, K_, R_, N, G,
                                            scale))

    # timings at the decode shapes of the serving phase (8 lanes; wq/wo give
    # N = 4096, wk/wv N = 512).  40 input sets (88 MB, more than the 50 MB
    # L2) are cycled so the pages come from HBM, as a decode step finds
    # them.  `ms`, `floor_ms`, `gather_ms` and `library_ms` are device
    # times (`device_ms`); `call_ms` / `library_call_ms` are back-to-back
    # calls with the host's per-call overhead in them.  The plain version
    # syncs with the host (it reads gidx), so it has only the latter.
    # `floor_ms` is the same C entry point's launch of an empty kernel on
    # the same grid and clusters: the latency no design of this launch goes
    # below.
    from repro_torch.kernels import _build
    from repro_torch.kernels import lora_matmul as lm
    floor_fn = _build.CudaFunction("grouped_lora", "grouped_lora_floor_f32",
                                   lm._ARGTYPES)
    shapes = []
    for N in (4096, 512):
        sets = [grouped_case(gen, 8, K, R, N, G) for _ in range(40)]
        gathered = [(x[:, None, :], a.index_select(0, g.long()),
                     b.index_select(0, g.long())) for x, a, b, g in sets]
        out = torch.empty(8, N, device="cuda")

        def kernel(i):
            return kern.delta(*sets[i % len(sets)], scale)

        def floor(i):
            x, a, b, g = sets[i % len(sets)]
            floor_fn(x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                     g.data_ptr(), out.data_ptr(), 8, K, R, N, G, scale)

        def library(i):
            x3, ag, bg = gathered[i % len(gathered)]
            return torch.bmm(torch.bmm(x3, ag), bg)

        bounds = [grouped_bound(*s) for s in sets]
        row = {"M": 8, "K": K, "R": R, "N": N, "G": G,
               "ms": device_ms(kernel, 2 * len(sets)),
               "floor_ms": device_ms(floor, 2 * len(sets)),
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
        print(f"[kernels] grouped_pallas M=8 K={K} R={R} N={N} G={G}: "
              f"{1e3 * row['ms']:.3f} us a launch against a bound of "
              f"{1e3 * row['bound_ms']:.3f} us ({row['bound_by']}) and a "
              f"launch floor of {1e3 * row['floor_ms']:.3f} us (empty "
              f"kernel, same grid); torch.bmm x2 pre-gathered "
              f"{1e3 * row['library_ms']:.3f} us")
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
            "launch_floor_ms": main["floor_ms"], "shapes": shapes}


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
                    wall_ms: float) -> dict:
    """Write the profiler's trace to chiprun_out/<fname>.gz and print the
    device busy share of the wall time (union of kernel intervals), the
    kernel and launch-call counts per step, and the ten kernels that take
    the most device time.  Returns {"busy_ms", "by_name": {kernel: (us,
    launches)}} over the window."""
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
    return {"busy_ms": busy / 1e3, "by_name": by_name}


SPLIT_RTOL = 0.05              # kernel_split_ms: |sum of the parts - ms| / ms


def profiled_kernels(fn, n_iter: int) -> tuple:
    """({kernel name: device ms per call}, {kernel name: launches}, device
    ms per call from the first kernel's start to the last one's end) of
    n_iter calls of fn(i) in one torch.profiler window (CPU and CUDA
    activities, as every other window here)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    ms: dict = {}
    counts: dict = {}
    first, last = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n_iter
        counts[name] = counts.get(name, 0) + 1
        first, last = min(first, e.time_range.start), max(last,
                                                          e.time_range.end)
    span = (last - first) / 1e3 / n_iter if counts else 0.0
    return ms, counts, span


def kernel_split_ms(fn, n_iter: int, names=(), windows: int = 8,
                    ms=None) -> dict:
    """{kernel name: device ms per call of fn(i)} over n_iter calls after
    one unprofiled call (profiled_kernels): the parts of an entry point that
    launches several kernels.  A window is whole when it recorded a
    kernel, each of `names` a multiple of n_iter times, and, given `ms`
    (the call's device ms, timed apart), parts that sum to within
    SPLIT_RTOL of it.  A window may record none of the card's kernels
    (after the profiled phases of a `--profile` run every other window:
    none, all, none, all, ...; the same with TEARDOWN_CUPTI=0) or only 7
    or 8 calls' of 10 (the first windows of phase 23 (a) on an H100), so
    a window that is not whole is printed and opened again, up to
    `windows` times; the phase fails if none is."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    for w in range(windows):
        split, counts, span = profiled_kernels(fn, n_iter)
        total = sum(split.values())
        if (split and all(counts.get(n, 0) > 0 and counts[n] % n_iter == 0
                          for n in names)
                and (ms is None or abs(total - ms) <= SPLIT_RTOL * ms)):
            return split
        print(f"[profile] split window {w}: parts {total:.4f} ms of "
              f"{'-' if ms is None else f'{ms:.4f}'} ms a call, kernels "
              f"{span:.4f} ms first to last, launches {json.dumps(counts)} "
              f"over {n_iter} calls; not whole")
    check(False, f"no profiler window of {windows} split {list(names)} "
                 f"whole")


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

def arch_args(arch: str, args=SERVE_ARGS):
    """Phase 3's serving flags (or `args`) for another arch."""
    i = args.index("--arch")
    return args[:i + 1] + [arch] + args[i + 2:]


def engine_vs_reference(eng2, trace2, rep, cfg2, lcfg, tag: str,
                        window=None) -> int:
    """Each request of a serving run against the port's single-adapter
    prefill + greedy decode of the same prompt: completions must match,
    except where the reference's top-2 logit gap is below GAP_TOL (each
    such case is printed).  Returns the number of near ties."""
    import torch
    from repro_torch.checkpoint.io import tree_from_numpy
    from repro_torch.models import model as mdl

    check(len(rep.completions) == len(trace2), f"{tag} engine dropped requests")
    store = eng2.cache.store
    near_ties = 0
    with torch.no_grad():
        for req in trace2:
            lt = tree_from_numpy(store.get(req.client), device="cuda")
            toks = torch.tensor([req.prompt], device="cuda")
            logits, c = mdl.prefill(eng2.params, cfg2, {"tokens": toks},
                                    lora=lt, lora_scale=lcfg.scale,
                                    window=window, max_len=eng2.max_len)
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
                    lora_scale=lcfg.scale, window=window)
                lg = out[0, 0]
                pos += 1
            got = rep.completions[req.rid]
            if got != want:
                t = next(i for i, (p, q) in enumerate(zip(got, want)) if p != q)
                print(f"{tag} request {req.rid} differs at token {t}: "
                      f"engine {got[t]} vs reference {want[t]}, reference "
                      f"top-2 gap {gaps[t]:.3e}")
                check(gaps[t] < GAP_TOL,
                      f"request {req.rid}: engine and reference disagree at a "
                      f"top-2 gap of {gaps[t]:.3e} >= {GAP_TOL}")
                near_ties += 1
    return near_ties


def parity_cfg(arch: str):
    """A 2-layer f32 cut of an arch at its full width."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), num_layers=2,
                               param_dtype="float32", compute_dtype="float32")


def parity_phase(seed: int, arch: str = "yi-9b", tag: str = "[parity]"):
    from repro_torch.launch import serve

    # phase 3's engine settings on a 2-layer f32 cut of the full width
    cfg2 = parity_cfg(arch)
    eng2, trace2, _, lcfg = serve.build(
        serve.parse_args(arch_args(arch) + ["--seed", str(seed)]), cfg=cfg2)
    rep = eng2.run(trace2)
    near_ties = engine_vs_reference(eng2, trace2, rep, cfg2, lcfg, tag)
    print(f"{tag} {cfg2.name} 2L d{cfg2.d_model} f32: "
          f"{len(trace2) - near_ties}/{len(trace2)} completions identical to "
          f"the single-adapter reference, {near_ties} near-tie divergences")
    return long_prompt_parity(eng2, cfg2, lcfg, seed, tag=tag)


def greedy(params, cfg, prompt, lora, scale, gen_len, window=None):
    """Single-adapter prefill + greedy decode: (last-position logits of
    every step, tokens, top-2 gaps)."""
    import torch
    from repro_torch.models import model as mdl
    toks = torch.tensor([prompt], device="cuda")
    logits, c = mdl.prefill(params, cfg, {"tokens": toks}, lora=lora,
                            lora_scale=scale, window=window,
                            max_len=len(prompt) + gen_len)
    lg, pos = logits[0, -1], len(prompt)
    steps, out, gaps = [], [], []
    while True:
        steps.append(lg.float())
        top2 = torch.topk(lg.float(), 2).values
        gaps.append((top2[0] - top2[1]).item())
        out.append(int(torch.argmax(lg)))
        if len(out) == gen_len:
            return steps, out, gaps
        o, c = mdl.decode_step(params, cfg, torch.tensor([out[-1]],
                                                         device="cuda"),
                               torch.tensor(pos, device="cuda"), c,
                               lora=lora, lora_scale=scale, window=window)
        lg, pos = o[0, 0], pos + 1


def long_prompt_parity(eng2, cfg2, lcfg, seed: int, gen_len: int = 4,
                       S: int = None, window=None, tag: str = "[parity]"):
    """One long prompt (8192 tokens unless S says otherwise) on a 2-layer
    f32 engine's weights: the prefill logits and greedy completion through
    the flash kernel (under `window`, if given), and the same with
    `chunked_attention` (plain torch, on the card) put in the kernel's
    place on the attention module for this one comparison."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import tree_from_numpy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A

    S = S or LONG_S
    prompt = np.random.default_rng(seed + 11).integers(
        0, cfg2.vocab_size, S).tolist()
    lt = tree_from_numpy(eng2.cache.store.get(0), device="cuda")
    route = fa.flash_route(torch.float32, cfg2.hd)
    with torch.no_grad():
        fa.FLASH.reset()
        k_logits, k_toks, _ = greedy(eng2.params, cfg2, prompt, lt,
                                     lcfg.scale, gen_len, window)
        k_launches = fa.FLASH.launches
        k_routes = dict(fa.FLASH.launches_by_route)
        k_tagged = fa.FLASH.launches_by_tag.get("window", 0)
        kernel = A.flash_attention

        def chunked(q, k, v, *, causal, scale, window=None):
            return A.chunked_attention(q, k, v, scale, causal=causal,
                                       window=window, cq=cfg2.attn_chunk_q,
                                       ckv=cfg2.attn_chunk_kv)

        A.flash_attention = chunked
        try:
            fa.FLASH.reset()
            c_logits, c_toks, c_gaps = greedy(eng2.params, cfg2, prompt, lt,
                                              lcfg.scale, gen_len, window)
            c_launches = fa.FLASH.launches
        finally:
            A.flash_attention = kernel
    diff = max((a - b).abs().max().item() for a, b in zip(k_logits, c_logits))
    what = f"{S}-token prompt" + (f", window {window}" if window else "")
    print(f"{tag} {what}, f32, 2 layers, hd {cfg2.hd}: flash kernel "
          f"({k_launches} launches, by route {json.dumps(k_routes)}, "
          f"{k_tagged} windowed) {k_toks} vs chunked_attention "
          f"({c_launches} launches) {c_toks}; top-2 gaps "
          f"{[round(g, 6) for g in c_gaps]}; largest logit difference "
          f"{diff:.3e}")
    check(k_launches == cfg2.num_layers and c_launches == 0
          and k_routes == {route: k_launches},
          f"the long prompt's prefill launched the flash kernel {k_routes} "
          f"/ {c_launches} times, expected {cfg2.num_layers} on {route} / 0")
    check(k_tagged == (k_launches if window else 0),
          f"{k_tagged} of {k_launches} flash launches windowed, window "
          f"{window}")
    for t, (a, b) in enumerate(zip(k_toks, c_toks)):
        if a != b:
            check(c_gaps[t] < GAP_TOL,
                  f"long prompt: kernel and chunked_attention disagree at "
                  f"token {t} at a top-2 gap of {c_gaps[t]:.3e} >= {GAP_TOL}")
            print(f"{tag} long prompt differs at token {t} (near tie, "
                  f"gap {c_gaps[t]:.3e}); the rest is not compared")
            break
    check(all(bool(torch.isfinite(x).all()) for x in k_logits),
          "long prompt: non-finite logits")
    return diff


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
    """(B, n) f32 rows (normal draws, heavy ties, all zeros, or normal
    draws with +-inf at every 97th place) and a (B, n) uniform draw for
    stochastic rounding, from one generator.  A row that holds an inf has
    an inf scale: a kept +-inf quantizes to inf / inf = NaN, a kept finite
    x to 0 * inf = NaN."""
    import torch
    if kind == "zeros":
        x = torch.zeros(B, n, device="cuda")
    elif kind == "ties":
        x = torch.randint(-3, 4, (B, n), generator=gen, device="cuda"
                          ).float() * 0.5
    else:
        x = torch.randn(B, n, generator=gen, device="cuda")
        if kind == "inf":
            x[:, ::97] = torch.copysign(torch.tensor(float("inf"),
                                                     device="cuda"),
                                        x[:, ::97])
    return x, torch.rand(B, n, generator=gen, device="cuda")


def same_bits(a, b) -> bool:
    """Bitwise equal, NaN compared as NaN: the same places NaN, every other
    element bit for bit (f32); equal (other dtypes)."""
    import torch
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan) and
            torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def finite_diff(a, b) -> float:
    """The largest |a - b| where both are finite (0.0 for empty)."""
    import torch
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return (torch.where(ok, a - b, 0.0).abs().max().item()
            if a.numel() else 0.0)


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
        # abs, multiply, floor, subtract, four compares, two clamps, the
        # histogram add (the elements near an edge add a table search)
        "bin_counts": (row + small + 4 * B * (1 << LEVELS), 11 * B * n),
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
    Yi-9B vector length, the ViT-B/16 task vector's (phase 12), an odd
    length and a tiny one, one and four rows,
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
        errs[name] = max(errs[name], finite_diff(a, b))
        check(same_bits(a, b),
              f"{name} differs from its plain version ({what})")

    cases = 0
    for n in (P_LEN, VIT_P_LEN, 1_000_003, 50):
        kd = sp.density_count(n, 0.25)
        for B in (1, 4):
            ks = [kd] if B == 1 else [0, 1, kd, n]
            k = torch.tensor(ks, dtype=torch.int32, device="cuda")
            for kind in ("normal", "ties", "zeros", "inf"):
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
    print(f"[transport] {cases} cases (n in {{{P_LEN}, {VIT_P_LEN}, 1000003, "
          f"50}} x B in "
          f"{{1, 4}} x normal/ties/zeros/inf, bits 0 and 4, nearest and "
          f"stochastic): every kernel bitwise equal to its plain version "
          f"(NaN compared as NaN)")

    # bin_counts alone on the rows that reach every path of its search
    # (tests/_bin_rows.py): denormal, overflowing, infinite, NaN and
    # negative bounds, NaN elements, sixty decades, elements on the table's
    # edges; and every kind above at 1, 5 and 12 levels
    from _bin_rows import KINDS, bin_rows
    cases = 0
    for n in (P_LEN, 1_000_003, 50):
        for B in (1, 4):
            for kind in KINDS:
                for levels in (1, 5, 12):   # only the edges kind's rows
                    if levels == 1 or kind == "edges":   # depend on levels
                        xs, hs = bin_rows(kind, B, n, levels, seed + n + B)
                        x, hi0 = (torch.from_numpy(a).cuda()
                                  for a in (xs, hs))
                    what = f"n={n} B={B} {kind} levels={levels}"
                    hist = ft.bin_counts(x, hi0, levels)
                    same("bin_counts", hist,
                         ft.bin_counts_plain(x, hi0, levels), what)
                    check(bool((hist.sum(-1) == n).all()),
                          f"bin_counts lost entries ({what})")
                    cases += 1
                del x, hi0
    torch.cuda.synchronize()
    print(f"[transport] bin_counts: {cases} more cases (n in {{{P_LEN}, "
          f"1000003, 50}} x B in {{1, 4}} x {'/'.join(KINDS)} x levels in "
          f"{{1, 5, 12}}): bitwise equal to its plain version")

    # device times at the Yi-9B vector: the kernel alone (its C entry point
    # on preallocated outputs), the wrapper (which also allocates its
    # outputs and zeroes a count or max), the plain version and, where PyTorch has
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
        hpart = torch.empty(B * ft.BIN_PARTS << LEVELS, dtype=torch.int32,
                            device="cuda")
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
                                            hpart.data_ptr(), P_LEN, B,
                                            LEVELS),
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


def pack_cases(gen):
    """Phase 8's bitwise cases, made one at a time on the card: yields
    (kernel, what, args, checks), with args the positional arguments of the
    kernel's wrapper (x, cap for pack_batch; x, thr, scale, u, bits, cap
    for mask_quantize_pack) and checks naming what else must hold:
    "overflow" (every row's total over cap), "twice" (a second call gives
    the same bits).  The Yi-9B vector length, an odd length and a tiny one,
    one and four rows; pack_batch on normal / -0.0-and-NaN / tied / zero
    rows, mask_quantize_pack on normal / tied / zero / +-inf-and-NaN rows
    at bits 0 and 4, nearest and stochastic, k in {0, 1, n/4, n}; the
    Yi-9B capacity and an overflowing one; then both on views one float
    into their storage (no 16-byte loads) at the Yi-9B capacity and 0."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft
    for n in (P_LEN, 1_000_003, 50):
        kd = sp.density_count(n, 0.25)
        caps = (comm.pack_capacity(n, kd), n // 64 + 1)
        for B in (1, 4):
            for kind in ("normal", "negzero", "ties", "zeros"):
                x = pack_rows(gen, B, n, kind)
                for cap in caps:
                    yield ("pack_batch", f"n={n} B={B} {kind} cap={cap}",
                           (x, cap), {"overflow"} if (
                               kind == "normal" and cap == caps[1]) else ())
            # kernel 7: per-row thresholds for k in {0, 1, n/4, n}
            ks = [kd] if B == 1 else [0, 1, kd, n]
            k = torch.tensor(ks, dtype=torch.int32, device="cuda")
            for kind in ("normal", "ties", "zeros", "inf"):
                x, u = transport_rows(gen, B, n, kind)
                if kind == "normal":
                    x[0, n // 3] = 100.0        # survivors round to zero
                hi0 = ft.absmax(x)
                thr = torch.clamp_min(ft.threshold_from_bins(
                    ft.bin_counts(x, hi0, LEVELS), hi0, k, LEVELS), sp.TINY)
                if kind == "inf":               # NaN elements are dropped
                    x[:, 1::101] = float("nan")
                for bits in (0, 4):
                    scale = qz.scale_of(hi0, bits) if bits else \
                        torch.ones_like(hi0)
                    for uu in ((None, u) if bits else (None,)):
                        rnd = "nearest" if uu is None else "stochastic"
                        for cap in caps:
                            yield ("mask_quantize_pack",
                                   f"n={n} B={B} {kind} bits={bits} {rnd} "
                                   f"cap={cap}",
                                   (x, thr, scale, uu, bits, cap), ())
    for n in (P_LEN, 1_000_003):
        for B in (1, 4):
            cap = comm.pack_capacity(n, sp.density_count(n, 0.25))
            x = pack_rows(gen, 1, B * n + 1, "negzero")[0][1:].view(B, n)
            check(x.data_ptr() % 16 != 0, "the view is 16-byte aligned")
            xq, uq = (t.reshape(-1)[1:].view(B, n) for t in
                      transport_rows(gen, 1, B * n + 1, "normal"))
            hi0 = ft.absmax(xq)
            thr, scale = hi0 * 0.3, qz.scale_of(hi0, 4)
            for c in (cap, 0):
                what = f"n={n} B={B} unaligned cap={c}"
                yield "pack_batch", what, (x, c), {"twice"}
                yield ("mask_quantize_pack", what,
                       (xq, thr, scale, uq, 4, c), {"twice"})


def pack_plain(name: str, args):
    """The plain version of a pack kernel on one case's arguments."""
    from repro_torch.kernels import fused_transport as ft
    x, n = args[0], args[0].shape[1]
    if name == "pack_batch":
        return ft.pack_rows_plain(x, x != 0, args[1], n)
    return ft.fused_mask_quantize_pack_plain(*args, n)


def pack_phase(seed: int):
    """Both pack kernels against their plain versions, bitwise, on
    pack_cases; flat == hierarchical accumulate on the card; then each
    kernel's device time at the Yi-9B length (B = 1 and 4)."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    errs = {name: 0.0 for name, _ in PACK}
    wrappers = {"pack_batch": ft.pack_values_batch,
                "mask_quantize_pack": ft.fused_mask_quantize_pack}

    def same(name, got, want, what):
        for a, b in zip(got, want):
            a, b = a.contiguous(), b.contiguous()
            errs[name] = max(errs[name], finite_diff(a, b))
            check(same_bits(a, b),
                  f"{name} differs from its plain version ({what})")

    cases = 0
    for name, what, args, checks in pack_cases(gen):
        got = wrappers[name](*args)
        same(name, got, pack_plain(name, args), what)
        if "overflow" in checks:
            check(bool((got[-1] > args[-1]).all()),
                  f"{name} did not flag overflow ({what})")
        if "twice" in checks:
            same(name, wrappers[name](*args), got, what + " second call")
        cases += 1
    torch.cuda.synchronize()
    print(f"[pack] {cases} cases (n in {{{P_LEN}, 1000003, 50}} x B in "
          f"{{1, 4}}; pack_batch on normal/-0.0+NaN/tied/zero rows, "
          f"mask_quantize_pack on normal/tied/zero/inf+NaN rows at bits 0 "
          f"and 4, nearest and stochastic, k in {{0, 1, n/4, n}}; the Yi-9B "
          f"capacity and an overflowing one; both on unaligned views, cap 0 "
          f"and twice over): both kernels bitwise equal "
          f"to their plain versions (NaN compared as NaN)")

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
        scratch = torch.empty(ft.pack_batch_scratch_words(B, P_LEN),
                              dtype=torch.int64, device="cuda")
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
               strategy: dict = None, **engine_kw):
    """One sparse-aggregation `Experiment` of the port on the card (the
    phase-6 setting plus sparse_aggregate=True, or `strategy`'s kind and
    options); returns (result, probe, pack probe, pack-kernel launches,
    final flatP)."""
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    fns = pack_functions()
    probe, packs = RoundProbe(), PackProbe()
    strategy = dict(strategy or dict(
        kind="flasc", selector="fused", quant_bits_up=4, density_down=0.25,
        density_up=0.25, sparse_aggregate=True, edge_shards=edge_shards))
    exp = (Experiment(None, federation=FederatedConfig(**FED))
           .with_strategy(strategy.pop("kind"), **strategy)
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

    # (d) the dense overflow branch: `lora` uploads every entry it changed,
    # unquantized, far past the capacity (from density_up 0.25), so every
    # packed message overflows and the round takes the dense rule on the
    # device; it must be the dense round bit for bit
    res_d, _, packs_d, ld, flat_d = run_sparse(
        cfg, params, data, seed, "sim", 1,
        strategy=dict(kind="lora", sparse_aggregate=True))
    res_e, _, packs_e, _, flat_e = run_sparse(
        cfg, params, data, seed, "sim", 1,
        strategy=dict(kind="lora", sparse_aggregate=False))
    over_d = packs_d.report("(d)")
    rows_d = [(v, cap_) for pnnz, cap_ in packs_d.packs
              for v in pnnz.cpu().tolist()]
    every = bool(rows_d) and all(v > cap_ for v, cap_ in rows_d)
    loss_d, loss_e = res_d.history[0]["loss"], res_e.history[0]["loss"]
    same_d = torch.equal(flat_d.view(torch.int32), flat_e.view(torch.int32))
    print(f"[sparse-async] overflow: lora, sparse_aggregate=True, 1 sim round"
          f": pnnz {[v for v, _ in rows_d]} against cap "
          f"{sorted({c for _, c in rows_d})}, every row past its capacity: "
          f"{every}; pack_batch launches {ld['pack_batch']}; loss "
          f"{loss_d!r} against the dense round's {loss_e!r}; flatP bitwise "
          f"equal to the dense round's: {same_d}")
    check(every and ld["pack_batch"] == 1,
          "(d) not every packed lora upload overflowed its capacity")
    check(not packs_e.packs, "(d) the dense lora round packed its uploads")
    check(loss_d == loss_e, f"(d) loss {loss_d!r} != dense {loss_e!r}")
    check(same_d, "(d) the overflowing sparse round's flatP differs from the "
          "dense round's")
    del flat_d, flat_e
    return {"pack_batch": la["pack_batch"], "pack_batch_b": lb["pack_batch"],
            "pack_batch_c": lc["pack_batch"], "mask_quantize_pack": l7,
            "overflow_a": over_a, "overflow_c": over_c, "overflow_d": over_d}


# ---------------------------------------------------------------------------
# phase 10: the ops entry point and its two CUDA kernels
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores, data sheet
LONG_S = 8192                  # the rows of one long prompt
LORA_RANK = 16                 # the serving adapter rank
# Yi-9B's projections as (K, N): wq / wo, wk / wv, w1 / w3, w2
YI_PROJ = {"wq": (4096, 4096), "wk": (4096, 512), "wv": (4096, 512),
           "wo": (4096, 4096), "w1": (4096, 11008), "w3": (4096, 11008),
           "w2": (11008, 4096)}
# f32 tolerances: the reference's kernel tests (tests/test_kernels.py:45
# and :62) at 2e-6 for attention; for the matmul 1e-5 at the tests' K of
# 256 to 512, scaled by sqrt(K / 512) (8 times as long a K: f32 rounding of
# a sum grows like the square root of its length).  bf16: 2e-2 attention,
# 5e-2 matmul, as those tests.  Those tests draw S <= 256, where attention
# outputs are about 0.1; over 8192 keys they are about 0.02, as small as the
# tolerance.  So bf16 attention is also held row by row: each output row
# (one query, one head) to ATTN_TOL of its own largest value, which a
# dropped or misweighted KV tile exceeds many times over.
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-6}
# bf16 attention against an f64 attention of the same inputs, row by row:
# the kernel keeps p to f32 precision, so only the output's rounding to
# bf16 (up to 2^-8 = 3.9e-3 of a row's largest value) separates them; a p
# rounded to bf16 before the second product gives 5e-3 to 6e-3
F64_ROW_TOL = 4e-3
F64_ROWS = 256                 # query rows sampled per head at 8192 tokens


def lora_tol(dtype: str, K: int) -> float:
    return 5e-2 if dtype == "bfloat16" else 1e-5 * max(1.0, (K / 512) ** 0.5)


def lora_inputs(gen, M, K, N, r, dtype):
    """x, w, a, b ~ N(0, 0.1^2), as the reference's kernel test draws them."""
    import torch
    return tuple((0.1 * torch.randn(shape, generator=gen, device="cuda"))
                 .to(getattr(torch, dtype))
                 for shape in ((M, K), (K, N), (K, r), (r, N)))


def lora_bound(M, K, N, r, dtype):
    """(bound_ms, bound_by): x, w, xa, b read once and y written once over
    the HBM rate, against 2 M N (K + r) multiply-adds over the dtype's
    peak (bf16 tensor cores; f32 outside them)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (M * K + K * N + M * r + r * N + M * N)
    flops = 2 * M * N * (K + r)
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_inputs(gen, B, S, T, H, KV, hd, dtype):
    import torch
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(getattr(torch, dtype))
                 for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def attn_bound(B, S, T, H, KV, hd, dtype, causal):
    """(bound_ms, bound_by): q, k, v read once and out written once, against
    4 S T hd multiply-adds per head (both products), halved under the
    causal mask."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * B * (2 * S * H * hd + 2 * T * KV * hd)
    flops = 4 * B * H * S * T * hd / (2 if causal else 1)
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_window_bound(B, S, H, KV, hd, dtype, window):
    """(bound_ms, bound_by) of causal attention under a window of W keys
    (S == T): q, k, v read once and out written once, against 4 hd
    multiply-adds per head for each kept (query, key) pair, of which there
    are sum over q of min(q + 1, W)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * B * (2 * S * H * hd + 2 * S * KV * hd)
    W = min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W
    flops = 4 * B * H * pairs * hd
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_row_err(got, want) -> float:
    """The largest |got - want| of an output row (one query, one head) over
    the largest |want| of that row, the worst row's."""
    d = (got.double() - want.double()).abs().amax(-1)
    return (d / want.double().abs().amax(-1).clamp_min(1e-30)).max().item()


def attn_f64(q, k, v, scale: float, causal: bool, rows=None, window=None):
    """Attention of the same inputs in f64, not rounded, for the query rows
    `rows` of every head (all rows when None): (B, len(rows), H, hd), under
    a causal window of `window` keys if given.  One kv head's group of
    query heads at a time."""
    import torch
    S, H = q.shape[1], q.shape[2]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    pos = torch.arange(S, device=q.device) if rows is None else rows
    qd = q[:, pos].double()
    outs = []
    for h in range(KV):
        sc = torch.einsum("bsgd,btd->bgst", qd[:, :, h * G:(h + 1) * G],
                          k[:, :, h].double()) * scale
        if causal:
            t = torch.arange(T, device=q.device)[None, :]
            keep = t <= pos[:, None]
            if window is not None:
                keep &= t > pos[:, None] - window
            sc = torch.where(keep, sc, -1e30)
        outs.append(torch.einsum("bgst,btd->bsgd", torch.softmax(sc, -1),
                                 v[:, :, h].double()))
    return torch.cat(outs, dim=2)


def attn_held(got, want, what):
    """Phase 10's attention check: the bf16 cases are held elementwise and
    row by row (ATTN_TOL's comment); the f32 ones elementwise (their row
    error is printed).  Returns (max abs error, worst row's error)."""
    import torch
    tol = ATTN_TOL[str(got.dtype).split(".")[-1]]
    err = (got.float() - want.float()).abs().max().item()
    row = attn_row_err(got, want)
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    if got.dtype == torch.bfloat16:
        ok = ok and row <= tol
    print(f"[ops] flash_attention {what}: max|err| {err:.3e}, row "
          f"max|err| / max|want| {row:.3e} (tol {tol:g}) "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok and bool(torch.isfinite(got.float()).all()),
          f"flash_attention disagrees at {what}")
    return err, row


def ops_phase(seed: int):
    """The `kernels/ops.py` entry point on the card: the fused LoRA matmul
    at Yi-9B's projections for an 8192-token prompt (the path: one call per
    projection, launches counted), flash attention at S = T = 8192 (GQA
    and pre-broadcast), the Top-K wrappers bitwise at the Yi-9B LoRA
    length; then device times beside bounds, plain versions and library
    calls."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops, ref

    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    scale = 2.0                              # the serving adapters' alpha / r
    lora_err, attn_err, attn_row = 0.0, 0.0, 0.0
    yi = get_config("yi-9b")

    def held(name, got, want, tol, what):
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        print(f"[ops] {name} {what}: max|err| {err:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"{name} disagrees with its plain version at {what}")
        return err

    # the path: ops.lora_matmul once per Yi-9B projection, bf16, 8192 rows,
    # every call on the wgmma route
    inputs = {p: lora_inputs(gen, LONG_S, K, N, LORA_RANK, "bfloat16")
              for p, (K, N) in YI_PROJ.items()}
    lm.LORA_MATMUL.reset()
    outs = {p: ops.lora_matmul(*inputs[p], scale) for p in YI_PROJ}
    torch.cuda.synchronize()
    lora_launches = lm.LORA_MATMUL.launches
    lora_routes = dict(lm.LORA_MATMUL.launches_by_route)
    print(f"[ops] lora_matmul launches {lora_launches}, by route "
          f"{json.dumps(lora_routes)}, for {len(YI_PROJ)} ops calls")
    check(lora_launches == len(YI_PROJ) and
          lora_routes == {"wgmma": len(YI_PROJ)},
          f"lora_matmul launched {lora_routes} for {len(YI_PROJ)} ops calls, "
          "expected all on the wgmma route")
    for p, (K, N) in YI_PROJ.items():
        want = lm.lora_matmul_plain(*inputs[p], scale)
        lora_err = max(lora_err, held(
            "lora_matmul", outs[p], want, lora_tol("bfloat16", K),
            f"{p} (M, K, N, r) = ({LONG_S}, {K}, {N}, {LORA_RANK}) bf16, "
            "route wgmma"))
    del outs, want
    # a ragged M on the wgmma route; f32 (fma) and unaligned bf16
    # (mma_sync), the shapes the first kernels still serve
    for M, K, N, r, dt in ((LONG_S - 1, 4096, 4096, LORA_RANK, "bfloat16"),
                           (LONG_S, 4096, 4096, LORA_RANK, "float32"),
                           (100, 300, 200, 5, "bfloat16"),
                           (100, 300, 200, 5, "float32")):
        x = lora_inputs(gen, M, K, N, r, dt)
        route = lm.lora_route(getattr(torch, dt), K, N)
        n_route = lm.LORA_MATMUL.launches_by_route.get(route, 0)
        got = lm.lora_matmul(*x, scale)
        check(lm.LORA_MATMUL.launches_by_route.get(route, 0) == n_route + 1,
              f"lora_matmul at ({M}, {K}, {N}, {r}) {dt} missed route {route}")
        lora_err = max(lora_err, held(
            "lora_matmul", got, lm.lora_matmul_plain(*x, scale),
            lora_tol(dt, K),
            f"(M, K, N, r) = ({M}, {K}, {N}, {r}) {dt}, route {route}"))
        del x, got

    # flash attention, GQA, at the long prompt's shapes and ragged ones (B 2,
    # T past S; hd 64 on the hd64 route, hd 32 on the first, mma.sync
    # kernel, f32 on the FMA one); at
    # 8192 tokens in bf16 also against chunked_attention.  Every bf16 case
    # is also held row by row to an f64 attention of its inputs (at 8192
    # tokens on F64_ROWS sampled query rows of every head): p must keep
    # f32 precision on both bf16 routes
    hd = 128
    main_err, chunked, f64_rows = None, {}, {}
    sample = torch.randperm(LONG_S, generator=gen, device="cuda")[:F64_ROWS]
    sample = sample.sort().values
    for B, S, T, H, KV, hd_, dt, causal in (
            (1, LONG_S, LONG_S, 32, 4, hd, "bfloat16", True),
            (1, LONG_S, LONG_S, 32, 4, hd, "bfloat16", False),
            (1, LONG_S, LONG_S, 32, 4, hd, "float32", True),
            (1, LONG_S, LONG_S, 32, 4, hd, "float32", False),
            (1, 1000, 1000, 32, 4, hd, "bfloat16", True),
            (1, 1000, 1000, 32, 4, hd, "float32", True),
            (1, 1000, 1000, 32, 4, hd, "bfloat16", False),
            (1, 1000, 1000, 32, 4, hd, "float32", False),
            (2, 1000, 1100, 32, 4, hd, "bfloat16", True),
            (2, 1000, 1100, 32, 4, hd, "bfloat16", False),
            (2, 1025, 1100, 32, 4, hd, "bfloat16", True),
            (2, 1025, 1100, 32, 4, hd, "bfloat16", False),
            (2, 1000, 1100, 8, 2, 64, "bfloat16", True),
            (2, 1000, 1100, 8, 2, 64, "bfloat16", False),
            (2, 1025, 1100, 8, 2, 64, "bfloat16", True),
            (2, 1025, 1100, 8, 2, 64, "bfloat16", False),
            (2, 1000, 1100, 8, 2, 32, "bfloat16", True),
            (2, 1000, 1100, 8, 2, 32, "bfloat16", False)):
        q, k, v = attn_inputs(gen, B, S, T, H, KV, hd_, dt)
        route = fa.flash_route(getattr(torch, dt), hd_)
        n_route = fa.FLASH.launches_by_route.get(route, 0)
        got = fa.flash_attention(q, k, v, causal=causal, scale=hd_ ** -0.5)
        check(fa.FLASH.launches_by_route.get(route, 0) == n_route + 1,
              f"flash_attention at {tuple(q.shape)} {dt} missed route {route}")
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        scale=hd_ ** -0.5)
        what = (f"B {B}, S {S}, T {T}, H {H}, KV {KV}, hd {hd_}, {dt}, "
                f"{'causal' if causal else 'full'}, route {route}")
        err, row = attn_held(got, want, what)
        attn_err = max(attn_err, err)
        if dt == "bfloat16":
            attn_row = max(attn_row, row)
            rows = sample if S == LONG_S else None
            exact = attn_f64(q, k, v, hd_ ** -0.5, causal, rows)
            row64 = attn_row_err(got if rows is None else got[:, rows], exact)
            print(f"[ops] flash_attention {what} against f64 attention "
                  f"({'all' if rows is None else len(rows)} query rows of "
                  f"every head): row max|err| / max|want| {row64:.3e} (tol "
                  f"{F64_ROW_TOL:g}) {'ok' if row64 <= F64_ROW_TOL else 'MISMATCH'}")
            check(row64 <= F64_ROW_TOL,
                  f"flash_attention at {what} is {row64:.3e} from f64 "
                  f"attention, above {F64_ROW_TOL:g}")
            f64_rows[what] = row64
            del exact
        if S == LONG_S and dt == "bfloat16":
            if causal:
                main_err = {"max_abs_err": err, "max_row_rel_err": row}
            ch = A.chunked_attention(q, k, v, hd ** -0.5, causal=causal,
                                     cq=yi.attn_chunk_q, ckv=yi.attn_chunk_kv)
            err, row = attn_held(got, ch, what + " against chunked_attention")
            chunked["causal" if causal else "full"] = {
                "max_abs_err": err, "max_row_rel_err": row}
            del ch
        if S == LONG_S and dt == "bfloat16" and causal:
            pre = ops.flash_attention(q, k.repeat_interleave(8, 2),
                                      v.repeat_interleave(8, 2), causal=True)
            same = torch.equal(pre, got)
            print(f"[ops] ops.flash_attention on pre-broadcast K, V equals "
                  f"the GQA call bit for bit: {same}")
            check(same, "pre-broadcast flash_attention differs from GQA")
            del pre
        del q, k, v, got, want
    torch.cuda.empty_cache()
    win = window_cases(gen)

    # the Top-K wrappers at the Yi-9B LoRA length, bitwise
    x = torch.randn(P_LEN, generator=gen, device="cuda")
    t = ops.histogram_threshold(x, 0.25)
    t_plain = ops.histogram_threshold_plain(x, 0.25)
    masked, nnz = ops.topk_mask(x, t)
    same = (torch.equal(t.view(torch.int32), t_plain.view(torch.int32))
            and torch.equal(masked.view(torch.int32),
                            ref.topk_mask_ref(x, t).view(torch.int32))
            and int(nnz) == int(ref.threshold_count_ref(x, t)))
    print(f"[ops] histogram_threshold + topk_mask at n = {P_LEN}: threshold "
          f"{t.item():.9g}, nnz {int(nnz)} (k {round(0.25 * P_LEN)}); "
          f"bitwise equal to their plain loops: {same}")
    check(same, "ops Top-K wrappers differ from their plain loops")
    del x, masked

    # device times: the kernel alone (its C entry point on preallocated
    # outputs, xa included in the inputs), the wrapper, the plain version
    # and the library call computing the same function
    rows = []
    for p in ("wq", "wk", "w1", "w2"):
        K, N = YI_PROJ[p]
        x, w, a, b = inputs[p]
        xa = lm.lora_xa(x, a)
        y = torch.empty(LONG_S, N, dtype=x.dtype, device="cuda")
        route = lm.lora_route(x.dtype, K, N)

        def kernel(i, x=x, w=w, xa=xa, b=b, y=y, K=K, N=N, route=route):
            lm.LORA_MATMUL(x.device, x.data_ptr(), w.data_ptr(),
                           xa.data_ptr(), b.data_ptr(), y.data_ptr(), LONG_S,
                           K, N, LORA_RANK, 0, scale, lm.LORA_ROUTES[route])

        check(route == "wgmma", f"lora_matmul {p} takes route {route}")
        bound, by = lora_bound(LONG_S, K, N, LORA_RANK, "bfloat16")
        row = {"proj": p, "M": LONG_S, "K": K, "N": N, "r": LORA_RANK,
               "dtype": "bfloat16", "route": route,
               "ms": device_ms(kernel, 10),
               "wrapper_ms": device_ms(
                   lambda i: ops.lora_matmul(x, w, a, b, scale), 10),
               "plain_ms": cuda_ms(
                   lambda i: lm.lora_matmul_plain(x, w, a, b, scale), 5),
               "library_ms": device_ms(
                   lambda i: torch.matmul(x, w) + scale * torch.matmul(xa, b),
                   10),
               "bound_ms": bound, "bound_by": by}
        print(f"[ops] timing {json.dumps(row)}")
        rows.append(row)
    del inputs
    torch.cuda.empty_cache()

    attn_rows = []
    for dt, causal in (("bfloat16", True), ("bfloat16", False),
                       ("float32", True)):
        q, k, v = attn_inputs(gen, 1, LONG_S, LONG_S, 32, 4, hd, dt)
        out = torch.empty_like(q)
        qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
        route = fa.flash_route(q.dtype, hd)

        def kernel(i, q=q, k=k, v=v, out=out, causal=causal, route=route):
            fa.FLASH(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None, 1, LONG_S, LONG_S, 32, 4, hd,
                     fa.DTYPES[q.dtype], int(causal), hd ** -0.5,
                     fa.ROUTES[route], 0)

        n = 10 if dt == "bfloat16" else 3
        bound, by = attn_bound(1, LONG_S, LONG_S, 32, 4, hd, dt, causal)
        row = {"B": 1, "S": LONG_S, "T": LONG_S, "H": 32, "KV": 4, "hd": hd,
               "dtype": dt, "causal": causal, "route": route,
               "ms": device_ms(kernel, n),
               "wrapper_ms": device_ms(lambda i: fa.flash_attention(
                   q, k, v, causal=causal, scale=hd ** -0.5), n),
               "plain_ms": cuda_ms(lambda i: fa.flash_attention_plain(
                   q, k, v, causal=causal, scale=hd ** -0.5), 2, warmup=1),
               "library_ms": device_ms(
                   lambda i: F.scaled_dot_product_attention(
                       qh, kh, vh, is_causal=causal, enable_gqa=True), n),
               "bound_ms": bound, "bound_by": by}
        print(f"[ops] timing {json.dumps(row)}")
        attn_rows.append(row)
        del q, k, v, out, qh, kh, vh
        torch.cuda.empty_cache()
    win.update(window_timings(gen, win))
    return {"lora_err": lora_err, "attn_err": attn_err, "attn_row": attn_row,
            "attn_main": main_err, "attn_chunked": chunked,
            "attn_f64": f64_rows,
            "lora_launches": lora_launches, "lora_routes": lora_routes,
            "lora_rows": rows, "attn_rows": attn_rows, **win}


# the sliding window on every route (bf16 wgmma at hd 128, hd64, mma_sync at
# hd 32, hd256; f32 fma at hd 128 and 256): ragged S and T with W of 1 (each
# row its own key), 37, 65 (S past a 128-row tile) and 100 (not multiples
# of a tile: the lowest visited tile holds no key of some rows' windows,
# and comes first for them), and W
# >= S (no effect: bitwise the call without a window); W 4096 and 8192 over
# 9000 tokens.  Then hd 256 without a window, bf16 and f32, at 8192 tokens
# and ragged.  All causal but one full hd-256 case a dtype.
WINDOW_ROUTES = ((32, 4, 128, "bfloat16"), (8, 2, 64, "bfloat16"),
                 (8, 2, 32, "bfloat16"), (16, 16, 256, "bfloat16"),
                 (32, 4, 128, "float32"), (16, 16, 256, "float32"))
WINDOW_SHAPES = ((2, 1000, 1100, 1), (2, 1000, 1100, 37),
                 (2, 1025, 1100, 65), (2, 1000, 1100, 100),
                 (2, 1000, 1100, 1100), (1, 9000, 9000, 4096),
                 (1, 9000, 9000, 8192))
HD256_SHAPES = ((1, LONG_S, LONG_S, True), (2, 1000, 1100, True),
                (2, 1025, 1100, True), (2, 1000, 1100, False))
WINDOW_S = 32768               # a long context: four windows of 8192
LSE_TOL = 1e-4                 # the written lse against the plain one in f64


def window_cases(gen) -> dict:
    """Phase 10's window and hd-256 cases: each call held to its plain
    version (`attn_held`), every bf16 one row by row to an f64 attention
    of its inputs under the same window (F64_ROW_TOL; F64_ROWS sampled
    query rows at 8192 tokens or more), two calls bitwise equal, each
    launch on its route and, with a window, tagged windowed.  On the hd256
    and hd64 routes the lse a third launch writes is held to the plain
    version's in f64 (LSE_TOL), and that launch's output to the first's
    bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cases = [(B, S, T, H, KV, hd, dt, True, W)
             for H, KV, hd, dt in WINDOW_ROUTES
             for B, S, T, W in WINDOW_SHAPES]
    cases += [(B, S, T, 16, 16, 256, dt, causal, None)
              for dt in ("bfloat16", "float32")
              for B, S, T, causal in HD256_SHAPES]
    res = {"win_err": 0.0, "win_f64": {}, "hd256_err": 0.0, "hd256_f64": {},
           "hd256_lse_err": 0.0, "hd64_lse_err": 0.0}
    for B, S, T, H, KV, hd, dt, causal, W in cases:
        q, k, v = attn_inputs(gen, B, S, T, H, KV, hd, dt)
        route = fa.flash_route(getattr(torch, dt), hd)
        n_route = fa.FLASH.launches_by_route.get(route, 0)
        n_win = fa.FLASH.launches_by_tag.get("window", 0)
        got = fa.flash_attention(q, k, v, causal=causal, scale=hd ** -0.5,
                                 window=W)
        again = fa.flash_attention(q, k, v, causal=causal, scale=hd ** -0.5,
                                   window=W)
        check(fa.FLASH.launches_by_route.get(route, 0) == n_route + 2 and
              fa.FLASH.launches_by_tag.get("window", 0) ==
              n_win + (2 if W else 0),
              f"flash_attention at {tuple(q.shape)} {dt}, window {W}, missed "
              f"route {route} or its window tag")
        check(torch.equal(got, again),
              f"flash_attention at {tuple(q.shape)} {dt}, window {W}: two "
              "calls differ")
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        scale=hd ** -0.5, window=W)
        what = (f"B {B}, S {S}, T {T}, H {H}, KV {KV}, hd {hd}, {dt}, "
                f"{'causal' if causal else 'full'}, window {W}, route "
                f"{route}, bitwise on repeat")
        err, _ = attn_held(got, want, what)
        key = "win" if W else "hd256"
        res[f"{key}_err"] = max(res[f"{key}_err"], err)
        if dt == "bfloat16":
            rows = None
            if S >= LONG_S:
                rows = torch.randperm(S, generator=gen, device="cuda")
                rows = rows[:F64_ROWS].sort().values
            exact = attn_f64(q, k, v, hd ** -0.5, causal, rows, W)
            row64 = attn_row_err(got if rows is None else got[:, rows], exact)
            print(f"[ops] flash_attention {what} against f64 attention "
                  f"({'all' if rows is None else len(rows)} query rows of "
                  f"every head): row max|err| / max|want| {row64:.3e} (tol "
                  f"{F64_ROW_TOL:g}) "
                  f"{'ok' if row64 <= F64_ROW_TOL else 'MISMATCH'}")
            check(row64 <= F64_ROW_TOL,
                  f"flash_attention at {what} is {row64:.3e} from f64 "
                  f"attention, above {F64_ROW_TOL:g}")
            res[f"{key}_f64"][what] = row64
            del exact
        if route in ("hd256", "hd64"):
            out, lse = fa._forward(q, k, v, causal, hd ** -0.5, want_lse=True,
                                   window=W or 0)
            _, l64 = fa.flash_attention_plain(
                *(t.double() for t in (q, k, v)), causal=causal,
                scale=hd ** -0.5, window=W, return_lse=True)
            lerr = (lse.double() - l64).abs().max().item()
            same = torch.equal(out, got)
            print(f"[ops] flash_attention {what}: lse max|err| {lerr:.3e} "
                  f"against the plain version in f64 (tol {LSE_TOL:g}); out "
                  f"with lse equals out without bit for bit: {same}")
            check(lerr <= LSE_TOL and same,
                  f"flash_attention at {what}: lse {lerr:.3e} from the plain "
                  f"version's, or out changed with lse ({same})")
            res[f"{route}_lse_err"] = max(res[f"{route}_lse_err"], lerr)
            del out, lse, l64
        if W is not None and W >= S:
            same = torch.equal(got, fa.flash_attention(q, k, v, causal=True,
                                                       scale=hd ** -0.5))
            print(f"[ops] flash_attention {what}: equal to the call without "
                  f"a window bit for bit: {same}")
            check(same, f"a window of {W} >= S changed flash_attention")
        del q, k, v, got, again, want
    torch.cuda.empty_cache()
    return res


def window_timings(gen, res: dict) -> dict:
    """Device times of the window's and hd 256's timed shapes beside their
    bounds, plain versions and library calls: (1, 32768, 32/4, 128) bf16
    causal under a window of 8192 (the plain version is chunked_attention,
    the model's plain path: flash_attention_plain's f32 scores would take
    34 GB a KV group; the library call SDPA's memory-efficient kernel with
    the band as a bool mask and K, V repeated per query head), and (1, 8192,
    16/16, 256) bf16 causal (SDPA, causal).  The windowed shape is the one
    the window phase's prefills run, so its output is first held to
    chunked_attention's (`attn_held`) and, on F64_ROWS sampled query rows
    of every head, to an f64 windowed attention (F64_ROW_TOL); the errors
    go into `res`, window_cases' result."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs.registry import LONG_CONTEXT_WINDOW
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A

    def kernel_fn(q, k, v, out, route, causal, W):
        B, S, H, hd = q.shape
        T, KV = k.shape[1], k.shape[2]
        return lambda i: fa.FLASH(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None, B, S, T, H, KV, hd, fa.DTYPES[q.dtype],
            int(causal), hd ** -0.5, fa.ROUTES[route], W or 0)

    W = LONG_CONTEXT_WINDOW
    q, k, v = attn_inputs(gen, 1, WINDOW_S, WINDOW_S, 32, 4, 128, "bfloat16")
    got = fa.flash_attention(q, k, v, causal=True, scale=128 ** -0.5,
                             window=W)
    what = (f"B 1, S {WINDOW_S}, T {WINDOW_S}, H 32, KV 4, hd 128, bfloat16, "
            f"causal, window {W}, route {fa.flash_route(q.dtype, 128)}")
    plain = A.chunked_attention(q, k, v, 128 ** -0.5, causal=True, window=W,
                                cq=1024, ckv=1024)
    err, _ = attn_held(got, plain, what + " against chunked_attention")
    del plain
    rows = torch.randperm(WINDOW_S, generator=gen, device="cuda")
    rows = rows[:F64_ROWS].sort().values
    row64 = attn_row_err(got[:, rows],
                         attn_f64(q, k, v, 128 ** -0.5, True, rows, W))
    print(f"[ops] flash_attention {what} against f64 attention ({F64_ROWS} "
          f"query rows of every head): row max|err| / max|want| {row64:.3e} "
          f"(tol {F64_ROW_TOL:g}) {'ok' if row64 <= F64_ROW_TOL else 'MISMATCH'}")
    check(row64 <= F64_ROW_TOL,
          f"flash_attention at {what} is {row64:.3e} from f64 attention, "
          f"above {F64_ROW_TOL:g}")
    res["win_err"] = max(res["win_err"], err)
    res["win_f64"][what] = row64
    out = torch.empty_like(q)
    bound, by = attn_window_bound(1, WINDOW_S, 32, 4, 128, "bfloat16", W)
    win = {"B": 1, "S": WINDOW_S, "T": WINDOW_S, "H": 32, "KV": 4, "hd": 128,
           "dtype": "bfloat16", "causal": True, "window": W,
           "route": fa.flash_route(q.dtype, 128),
           "ms": device_ms(kernel_fn(q, k, v, out, "wgmma", True, W), 5),
           "wrapper_ms": device_ms(lambda i: fa.flash_attention(
               q, k, v, causal=True, scale=128 ** -0.5, window=W), 5),
           "plain": "chunked_attention(window=8192, cq = ckv = 1024)",
           "plain_ms": cuda_ms(lambda i: A.chunked_attention(
               q, k, v, 128 ** -0.5, causal=True, window=W, cq=1024,
               ckv=1024), 1, warmup=0),
           "bound_ms": bound, "bound_by": by,
           "library": "F.scaled_dot_product_attention, memory-efficient "
                      "kernel, the band as a bool mask (1 GiB), K and V "
                      "repeated per query head"}
    # the card's own verdict on whether SDPA takes this call: a library
    # call that no backend runs is reported as such, not retried elsewhere
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(8, 2).transpose(1, 2).contiguous()
              for t in (k, v))
    pos = torch.arange(WINDOW_S, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            win["library_ms"] = device_ms(
                lambda i: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=band), 3)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        win["library_ms"] = None
        win["library_note"] = f"did not run: {str(e).splitlines()[0][:200]}"
    print(f"[ops] timing {json.dumps(win)}")
    same = torch.equal(out, got)
    print(f"[ops] flash_attention {what}: the timed launches' output equals "
          f"the checked call's bit for bit: {same}")
    check(same, f"flash_attention at {what}: two calls differ")
    del q, k, v, out, got, qh, kh, vh, band
    torch.cuda.empty_cache()

    q, k, v = attn_inputs(gen, 1, LONG_S, LONG_S, 16, 16, 256, "bfloat16")
    out = torch.empty_like(q)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, by = attn_bound(1, LONG_S, LONG_S, 16, 16, 256, "bfloat16", True)
    hd256 = {"B": 1, "S": LONG_S, "T": LONG_S, "H": 16, "KV": 16, "hd": 256,
             "dtype": "bfloat16", "causal": True,
             "route": fa.flash_route(q.dtype, 256),
             "ms": device_ms(kernel_fn(q, k, v, out, "hd256", True, None), 5),
             "wrapper_ms": device_ms(lambda i: fa.flash_attention(
                 q, k, v, causal=True, scale=256 ** -0.5), 5),
             "plain_ms": cuda_ms(lambda i: fa.flash_attention_plain(
                 q, k, v, causal=True, scale=256 ** -0.5), 2, warmup=1),
             "library_ms": device_ms(
                 lambda i: F.scaled_dot_product_attention(
                     qh, kh, vh, is_causal=True), 5),
             "library": "F.scaled_dot_product_attention(is_causal=True)",
             "bound_ms": bound, "bound_by": by}
    print(f"[ops] timing {json.dumps(hd256)}")
    del q, k, v, out, qh, kh, vh
    torch.cuda.empty_cache()
    return {"win_timing": win, "hd256_timing": hd256}


# ---------------------------------------------------------------------------
# phase 11: long-prompt prefill of Yi-9B through the flash kernel
# ---------------------------------------------------------------------------

LONG_ARGS = ["--arch", "yi-9b", "--clients", "4", "--pages", "2",
             "--lanes", "2", "--requests", "4", "--rank", "16",
             "--max-len", "9232"]
LONG_BUCKETS = (8192, 9216)


def prefill_bound(cfg, S: int, weight_bytes: int):
    """(bound_ms, bound_by) of one causal prefill of S tokens: the GEMMs'
    2 x weights x S multiply-adds (every layer's projections and the LM
    head) plus causal attention's 2 S^2 hd H per layer over the bf16 rate,
    against one read of the weights over the HBM rate."""
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)
    weights = cfg.num_layers * (2 * D * H * hd + 2 * D * KV * hd + 3 * D * F) \
        + D * cfg.vocab_size
    flops = 2 * weights * S + cfg.num_layers * 2 * S * S * hd * H
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, weight_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def profile_prefill(eng, seed: int) -> None:
    """torch.profiler over one 8192-token prefill of phase 11's engine
    (page 0's adapter), after one unprofiled warm-up prefill."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine

    prompt = np.random.default_rng(seed + 12).integers(
        0, eng.cfg.vocab_size, LONG_S).tolist()
    with torch.no_grad():
        ServingEngine._prefill(eng, 0, prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ServingEngine._prefill(eng, 0, prompt)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    summarize_trace(prof, "long_prefill_trace.json",
                    f"1 prefill of {LONG_S} tokens", 1, wall_ms)


def long_prefill_phase(seed: int, profile: bool = False):
    """`ServingEngine` on full-width, full-depth Yi-9B in bf16 serving four
    prompts of 8192 or 9216 tokens (4 to 8 generated each): every prefill
    goes through the flash kernel, 48 launches a prefill, and every decode
    step through the grouped kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving import synth_trace

    t0 = time.perf_counter()
    eng, _, cfg, _ = serve.build(serve.parse_args(
        LONG_ARGS + ["--seed", str(seed)]))
    trace = synth_trace(4, 4, cfg.vocab_size, seed=seed,
                        prompt_buckets=LONG_BUCKETS, gen_range=(4, 8))
    torch.cuda.synchronize()
    print(f"[long-prefill] {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype}, built in {time.perf_counter() - t0:.1f}s; "
          f"prompts {[r.prompt_len for r in trace]} (chunks of "
          f"{cfg.attn_chunk_q}: "
          f"{sorted({r.prompt_len // cfg.attn_chunk_q for r in trace})} q "
          f"chunks), generating {[r.gen_len for r in trace]}")
    prefill_ms = []
    prefill = eng._prefill

    def timed_prefill(page, prompt):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = prefill(page, prompt)           # syncs: pulls the argmax
        prefill_ms.append((len(prompt), 1e3 * (time.perf_counter() - t1)))
        return out

    # the timing wrapper is stored on the engine only while the trace runs:
    # a closure over a bound method kept in the engine's own __dict__ is a
    # reference cycle that would hold the weights until gc runs
    eng._prefill = timed_prefill
    grouped = resolve_grouped_kernel("grouped_pallas")
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH.reset()
    grouped.launches = 0
    try:
        rep = eng.run(trace)
    finally:
        del eng._prefill
    del prefill, timed_prefill
    flash_launches, grouped_launches = fa.FLASH.launches, grouped.launches
    flash_routes = dict(fa.FLASH.launches_by_route)
    peak = torch.cuda.max_memory_allocated() / 2**30
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(eng.params))
    for n, ms in prefill_ms:
        bound, by = prefill_bound(cfg, n, weight_bytes)
        print(f"[long-prefill] prefill of {n} tokens: {ms:.3f} ms "
              f"({n / ms * 1e3:.1f} prompt tok/s), bound {bound:.3f} ms "
              f"({by})")
    print(f"[long-prefill] {len(rep.completions)}/{rep.requests} requests "
          f"served: {rep.generated_tokens} tokens in {rep.wall_s:.3f}s "
          f"({rep.tokens_per_s:.3f} tok/s), {rep.prefills} prefills, "
          f"{rep.steps} decode steps, "
          f"{1e3 * rep.decode_s / max(rep.steps, 1):.3f} ms/decode step; "
          f"cache {rep.cache['hits']} hits / {rep.cache['misses']} misses / "
          f"{rep.cache['evictions']} evictions; peak device memory "
          f"{peak:.2f} GiB")
    print(f"[long-prefill] flash_attention launches {flash_launches} = "
          f"{rep.prefills} prefills x {cfg.num_layers}, by route "
          f"{json.dumps(flash_routes)}; grouped_pallas "
          f"launches {grouped_launches} = {rep.steps} steps x "
          f"{cfg.num_layers} x 4")
    check(len(rep.completions) == len(trace) == rep.requests,
          "not every long-prompt request was served")
    check({r.prompt_len for r in trace} == set(LONG_BUCKETS),
          f"the trace does not hold both prompt lengths {LONG_BUCKETS}")
    for req in trace:
        toks = rep.completions[req.rid]
        check(len(toks) == req.gen_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {req.rid}: bad completion {toks}")
    check(flash_launches == rep.prefills * cfg.num_layers > 0,
          f"flash_attention launched {flash_launches} times, expected "
          f"{rep.prefills} x {cfg.num_layers}")
    check(flash_routes == {"wgmma": flash_launches},
          f"flash_attention launches by route {flash_routes}: every prefill "
          "launch must take the wgmma route")
    check(grouped_launches == rep.steps * cfg.num_layers * 4,
          f"grouped_pallas launched {grouped_launches} times, expected "
          f"{rep.steps} x {cfg.num_layers} x 4")
    if profile:
        profile_prefill(eng, seed)
    return {"flash": flash_launches, "flash_routes": flash_routes,
            "prefills": rep.prefills,
            "prefill_ms": [ms for _, ms in prefill_ms],
            "decode_ms": 1e3 * rep.decode_s / max(rep.steps, 1),
            "tok_s": rep.tokens_per_s, "peak_gib": peak,
            "mean_prompt": float(np.mean([r.prompt_len for r in trace]))}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 19: sliding-window serving with a rolling KV cache
# ---------------------------------------------------------------------------

WINDOW_ARGS = ["--arch", "yi-9b", "--clients", "8", "--pages", "4",
               "--lanes", "8", "--requests", "8", "--rank", "16",
               "--max-len", str(WINDOW_S + 16)]
WINDOW_BUCKETS = (64, WINDOW_S)
WINDOW_PARITY_S = 12288        # one and a half windows
WINDOW_PARITY_ARGS = arch_args("yi-9b", ["--arch", "yi-9b", "--clients", "4",
                                         "--pages", "2", "--lanes", "2",
                                         "--requests", "4", "--rank", "16",
                                         "--max-len",
                                         str(WINDOW_PARITY_S + 16)])


def cache_bytes(cfg, lanes: int, max_len: int, window=None) -> int:
    """Bytes of the serving engine's batch KV cache (`cache_spec`)."""
    import torch
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import tree_leaves, torch_dtype
    return sum(math.prod(p.shape) * torch.empty(
        (), dtype=torch_dtype(p.dtype)).element_size()
        for p in tree_leaves(mdl.cache_spec(cfg, lanes, max_len, window)))


def window_serve_phase(seed: int):
    """(a) `ServingEngine(window=LONG_CONTEXT_WINDOW)` on full-width,
    full-depth Yi-9B in bf16: 8 lanes, 8 requests with prompts of 32768 or
    64 tokens, every lane's cache 8192 slots; each long prefill launches the
    flash kernel 48 times, windowed, on the wgmma route, and every decode
    step the grouped kernel 48 x 4 times.  (b) A 2-layer full-width f32
    engine under the same window serving prompts of 12288 or 64 tokens
    against the single-adapter prefill + decode reference, and one 12288-
    token prompt through the kernel and through chunked_attention(window=)
    in its place."""
    import torch
    from repro_torch.configs.registry import LONG_CONTEXT_WINDOW as W
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.serving import synth_trace

    t0 = time.perf_counter()
    eng, _, cfg, _ = serve.build(serve.parse_args(
        WINDOW_ARGS + ["--window", str(W), "--seed", str(seed)]))
    trace = synth_trace(8, 8, cfg.vocab_size, seed=seed,
                        prompt_buckets=WINDOW_BUCKETS, gen_range=(4, 8))
    torch.cuda.synchronize()
    n_long = sum(r.prompt_len >= cfg.chunked_attn_threshold for r in trace)
    print(f"[window] {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype}, window {W}, built in "
          f"{time.perf_counter() - t0:.1f}s; prompts "
          f"{[r.prompt_len for r in trace]}, generating "
          f"{[r.gen_len for r in trace]}, max_len {eng.max_len}")
    check({r.prompt_len for r in trace} == set(WINDOW_BUCKETS),
          f"the trace does not hold both prompt lengths {WINDOW_BUCKETS}")
    prefills, prefill = [], eng._prefill

    def timed_prefill(page, prompt):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok, row = prefill(page, prompt)      # syncs: pulls the argmax
        prefills.append((len(prompt), 1e3 * (time.perf_counter() - t1),
                         row["g0"]["self"][0].shape[2]))
        return tok, row

    eng._prefill = timed_prefill          # removed again below (phase 11)
    grouped = resolve_grouped_kernel("grouped_pallas")
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH.reset()
    grouped.launches = 0
    try:
        rep = eng.run(trace)
    finally:
        del eng._prefill
    del prefill, timed_prefill
    flash, routes = fa.FLASH.launches, dict(fa.FLASH.launches_by_route)
    windowed = fa.FLASH.launches_by_tag.get("window", 0)
    g_launches = grouped.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    slots = {n: T for n, _, T in prefills}
    lanes_bytes = cache_bytes(cfg, eng.n_lanes, eng.max_len, W)
    full_bytes = cache_bytes(cfg, eng.n_lanes, eng.max_len)
    for n, ms, T in prefills:
        print(f"[window] prefill of {n} tokens: {ms:.3f} ms, cache {T} slots")
    print(f"[window] {len(rep.completions)}/{rep.requests} requests served: "
          f"{rep.generated_tokens} tokens in {rep.wall_s:.3f}s "
          f"({rep.tokens_per_s:.3f} tok/s), {rep.prefills} prefills, "
          f"{rep.steps} decode steps, "
          f"{1e3 * rep.decode_s / max(rep.steps, 1):.3f} ms/decode step; "
          f"peak device memory {peak:.2f} GiB; batch KV cache "
          f"{lanes_bytes / 2**30:.3f} GiB ({eng.n_lanes} lanes x "
          f"{min(W, eng.max_len)} slots) against "
          f"{full_bytes / 2**30:.3f} GiB unwindowed at max_len "
          f"{eng.max_len}")
    print(f"[window] flash_attention launches {flash} ({windowed} windowed) "
          f"= {n_long} long prefills x {cfg.num_layers}, by route "
          f"{json.dumps(routes)}; grouped_pallas launches {g_launches} = "
          f"{rep.steps} steps x {cfg.num_layers} x 4")
    check(len(rep.completions) == len(trace) == rep.requests,
          "not every windowed request was served")
    for req in trace:
        toks = rep.completions[req.rid]
        check(len(toks) == req.gen_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {req.rid}: bad completion {toks}")
    check(slots == {64: W, WINDOW_S: W},
          f"prefill cache slots {slots}: every lane must hold {W}")
    check(min(W, eng.max_len) == W and
          lanes_bytes * (eng.max_len // W) <= full_bytes,
          f"the batch cache holds {lanes_bytes} B against {full_bytes}")
    check(flash == windowed == n_long * cfg.num_layers > 0 and
          routes == {"wgmma": flash},
          f"flash_attention launched {routes} ({windowed} windowed), "
          f"expected {n_long} x {cfg.num_layers} windowed on wgmma")
    check(g_launches == rep.steps * cfg.num_layers * 4,
          f"grouped_pallas launched {g_launches} times, expected "
          f"{rep.steps} x {cfg.num_layers} x 4")
    res = {"flash": flash, "windowed": windowed, "flash_routes": routes,
           "grouped": g_launches, "steps": rep.steps, "peak_gib": peak,
           "prefill_ms": {n: ms for n, ms, _ in prefills},
           "decode_ms": 1e3 * rep.decode_s / max(rep.steps, 1),
           "cache_bytes": lanes_bytes, "unwindowed_cache_bytes": full_bytes}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the 2-layer f32 parity at full width under the same window
    cfg2 = parity_cfg("yi-9b")
    eng2, _, _, lcfg = serve.build(serve.parse_args(
        WINDOW_PARITY_ARGS + ["--window", str(W), "--seed", str(seed)]),
        cfg=cfg2)
    trace2 = synth_trace(4, 4, cfg2.vocab_size, seed=seed + 1,
                         prompt_buckets=(64, WINDOW_PARITY_S),
                         gen_range=(4, 8))
    check(WINDOW_PARITY_S in {r.prompt_len for r in trace2},
          f"the parity trace holds no {WINDOW_PARITY_S}-token prompt")
    rep2 = eng2.run(trace2)
    near = engine_vs_reference(eng2, trace2, rep2, cfg2, lcfg, "[window]",
                               window=W)
    print(f"[window] {cfg2.name} 2L d{cfg2.d_model} f32, window {W}, "
          f"prompts {[r.prompt_len for r in trace2]}: "
          f"{len(trace2) - near}/{len(trace2)} completions identical to the "
          f"single-adapter reference, {near} near-tie divergences")
    res["parity_logit_diff"] = long_prompt_parity(
        eng2, cfg2, lcfg, seed, S=WINDOW_PARITY_S, window=W, tag="[window]")
    del eng2
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 20: the other dense archs at full width
# ---------------------------------------------------------------------------

ARCHS = ("minitron-8b", "gemma-7b", "qwen3-32b")


def arch_serve_phase(seed: int):
    """minitron-8b, gemma-7b and qwen3-32b each at full width and depth in
    bf16 through `launch/serve.py` with phase 3's settings: the grouped
    kernel's launches must equal decode steps x L x 4.  Then one
    8192-token prompt through the engine's prefill: L flash launches, on
    the hd256 route for gemma-7b and wgmma for the others.  The device
    memory left once the weights are built is printed (qwen3-32b's 65.5 GB
    of bf16 weights leave what the cache and the prefill may use).
    gemma-7b then gets phase 4's 2-layer full-width f32 parity, an
    8192-token prompt included (the f32 hd-256 route end to end)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_leaves

    grouped = resolve_grouped_kernel("grouped_pallas")
    res = {}
    for arch in ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng, trace, cfg, _ = serve.build(serve.parse_args(
            arch_args(arch) + ["--seed", str(seed)]))
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated()
        # what the cache and the prefill may still take: the CUDA driver's
        # free memory and what the allocator holds but has not handed out
        left = free + torch.cuda.memory_reserved() - held
        wbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(eng.params))
        print(f"[archs] {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads hd {cfg.hd}, "
              f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.3f} B params "
              f"({wbytes / 1e9:.2f} GB), built in "
              f"{time.perf_counter() - t0:.1f}s; device memory allocated "
              f"{held / 2**30:.2f} GiB, left for the cache and the prefill "
              f"{left / 2**30:.2f} of {total / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        grouped.launches = 0
        rep = eng.run(trace)
        g_launches = grouped.launches
        print(f"[archs] {cfg.name}: {len(rep.completions)}/{rep.requests} "
              f"requests served, {rep.generated_tokens} tokens in "
              f"{rep.wall_s:.3f}s ({rep.tokens_per_s:.2f} tok/s), "
              f"{rep.steps} decode steps, "
              f"{1e3 * rep.decode_s / max(rep.steps, 1):.3f} ms/decode "
              f"step; cache {rep.cache['hits']} hits / "
              f"{rep.cache['misses']} misses / {rep.cache['evictions']} "
              f"evictions; grouped_pallas launches {g_launches} = "
              f"{rep.steps} steps x {cfg.num_layers} x 4")
        check(len(rep.completions) == len(trace) == rep.requests,
              f"{arch}: not every request was served")
        for req in trace:
            toks = rep.completions[req.rid]
            check(len(toks) == req.gen_len
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{arch} request {req.rid}: bad completion {toks}")
        check(g_launches == rep.steps * cfg.num_layers * 4 > 0,
              f"{arch}: grouped_pallas launched {g_launches} times, "
              f"expected {rep.steps} x {cfg.num_layers} x 4")
        prompt = np.random.default_rng(seed + 13).integers(
            0, cfg.vocab_size, LONG_S).tolist()
        route = fa.flash_route(torch.bfloat16, cfg.hd)
        fa.FLASH.reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            tok, row = eng._prefill(0, prompt)
        ms = 1e3 * (time.perf_counter() - t1)
        launches = dict(fa.FLASH.launches_by_route)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[archs] {cfg.name}: one {LONG_S}-token prefill {ms:.3f} ms, "
              f"first token {tok}, flash_attention launches by route "
              f"{json.dumps(launches)}; peak device memory {peak:.2f} GiB")
        check(launches == {route: cfg.num_layers} and
              fa.FLASH.launches == cfg.num_layers,
              f"{arch}: the {LONG_S}-token prefill launched {launches}, "
              f"expected {cfg.num_layers} on {route}")
        check(0 <= tok < cfg.vocab_size and
              tuple(row["g0"]["self"][0].shape[:3]) ==
              (cfg.num_layers, 1, LONG_S),
              f"{arch}: bad prefill output")
        res[arch] = {"layers": cfg.num_layers, "hd": cfg.hd, "route": route,
                     "grouped": g_launches, "steps": rep.steps,
                     "flash": fa.FLASH.launches, "prefill_ms": ms,
                     "left_gib": left / 2**30, "peak_gib": peak,
                     "weight_gb": wbytes / 1e9,
                     "decode_ms": 1e3 * rep.decode_s / max(rep.steps, 1)}
        del eng, row
    gc.collect()
    torch.cuda.empty_cache()
    res["gemma_parity_logit_diff"] = parity_phase(seed, "gemma-7b",
                                                  "[archs] parity")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 12: the paper's task path, ViT-B/16 and GPT-2 Small
# ---------------------------------------------------------------------------

TASK_FED = dict(n_clients=8, local_steps=2, local_batch=8, client_lr=5e-3,
                server_lr=5e-3)
TASK_RANK = 16
VIT_ROUNDS, GPT_ROUNDS = 4, 2
VIT_PRETRAIN, GPT_PRETRAIN = 20, 10
# rank-16 LoRA on wq/wk/wv/wo of 12 x 768 layers, plus the trained head
# (cls_head 768 x 10 and final_norm 768)
VIT_P_LEN = 12 * 4 * 2 * 768 * TASK_RANK + 7_680 + 768
GPT_P_LEN = 12 * 4 * 2 * 768 * TASK_RANK


class TaskProbe:
    """Callback: host time at the end of every round (after the metrics
    pull and, on eval rounds, the evaluation), and that the flat vector
    and the backbone lie on the card."""

    def __init__(self):
        self.t = []
        self.state = None

    def on_round_end(self, ev):
        from repro_torch.models.layers import tree_leaves
        self.t.append(time.perf_counter())
        check(ev.state.flatP.is_cuda, "the flat vector left the card")
        check(all(p.is_cuda for p in tree_leaves(ev.state.plan.params)),
              "a backbone leaf is not on the card")
        self.state = ev.state

    def on_eval(self, ev):
        pass


def run_task(task, params, cfg, strategy: dict, rounds: int, eval_every: int,
             seed: int, capture: UploadCapture = None, fed=None, train=None,
             callbacks=()):
    """One `Experiment(task)` on the card from a given backbone (`fed` and
    `train` override `TASK_FED` and the training options); returns
    (result, probe, {kernel: launches in this run}, wall ms per round, the
    experiment).  The launches cover the transport and the pack kernels."""
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    fns = {**transport_functions(), **pack_functions()}
    probe = TaskProbe()
    exp = (Experiment(task, federation=FederatedConfig(**{**TASK_FED,
                                                          **(fed or {})}))
           .with_strategy(**strategy)
           .with_lora(rank=TASK_RANK)
           .with_training(rounds=rounds, eval_every=eval_every, seed=seed,
                          **(train or {}))
           .with_params(params, cfg)
           .with_callbacks(probe, *callbacks))
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    with (capture.around() if capture else contextlib.nullcontext()):
        res = exp.run()
    launches = {name: f.launches for name, f in fns.items()}
    ts = [t0] + probe.t
    round_ms = [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
    return res, probe, launches, round_ms, exp


def timed_pretrain(params, cfg, task, steps: int, seed: int):
    """`pretrain` on the card; returns (params, loss, ms a step, with the
    one upload of the pooled data included).  One untimed step first (its
    result dropped) loads the step's kernels."""
    import torch
    from repro_torch.federated import pretrain
    pretrain(params, cfg, task, 1, seed=seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, loss = pretrain(params, cfg, task, steps, seed=seed)
    torch.cuda.synchronize()
    return params, loss, 1e3 * (time.perf_counter() - t0) / steps


def timed_eval(exp, params, cfg, state, task):
    """One more `evaluate` of the run's final flat vector, timed; and, apart,
    the host-to-device upload of its eval batches (which `evaluate` does
    batch by batch)."""
    import torch
    from repro_torch.data import eval_batches
    from repro_torch.federated import evaluate, runtime
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = evaluate(params, cfg, None, state.plan.meta, task, exp.lora.scale,
                   state.flatP)
    t1 = time.perf_counter()
    for batch in eval_batches(task):
        runtime._to_device(batch, "cuda")
    torch.cuda.synchronize()
    return acc, 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)


def check_task_run(tag, res, launches, rounds, expect_launches):
    import numpy as np
    check(len(res.history) == rounds, f"{tag}: the run stopped early")
    check(all(np.isfinite(h["loss"]) for h in res.history),
          f"{tag}: a round's loss is not finite")
    accs = [h["acc"] for h in res.history if "acc" in h]
    check(accs and all(0.0 <= a <= 1.0 for a in accs),
          f"{tag}: accuracies {accs} not in [0, 1]")
    check(res.final_acc == accs[-1], f"{tag}: final_acc is not the last eval")
    for name, per_round in FUSED_PER_ROUND.items():
        want = per_round * rounds if expect_launches else 0
        check(launches[name] == want,
              f"{tag}: {name} launched {launches[name]} times, expected "
              f"{want}")


def task_line(tag, cfg, res, round_ms, launches, card):
    led = res.ledger
    rounds = [f"{r}: loss {h['loss']:.6f}, {round_ms[r]:.3f} ms"
              + (f", acc {h['acc']:.6f} (eval round)" if "acc" in h else "")
              for r, h in enumerate(res.history)]
    print(f"[task] {tag} on {cfg.name}: " + "; ".join(rounds))
    print(f"[task] {tag} on {cfg.name}: p_len {led.total_params}; ledger "
          f"{led.total_bytes} B value-only, {led.total_coded_bytes} B coded "
          f"(down {led.down_coded_bytes} / up {led.up_coded_bytes}); "
          f"launches {json.dumps(launches)}; {card}")


def task_transport_parity(deltas, seed: int, label: str = "task"):
    """The transport kernels at the task path's shapes: the ViT run's round-0
    uploads (8 rows of 1,188,096) and its first row as a download, against
    the plain versions, bitwise."""
    import torch
    from repro_torch.core import quantization as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fused_transport as ft
    from repro_torch.kernels import topk_mask as tm
    check(deltas is not None and tuple(deltas.shape) ==
          (TASK_FED["n_clients"], VIT_P_LEN),
          f"round 0 handed no ({TASK_FED['n_clients']}, {VIT_P_LEN}) upload "
          f"input to its pipeline")
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    for x in (deltas, deltas[:1].contiguous()):
        B, n = x.shape
        what = f"task uploads B={B} n={n}"
        hi0 = ft.absmax(x)
        check(same_bits(hi0, ft.absmax_plain(x)), f"absmax differs ({what})")
        hist = ft.bin_counts(x, hi0, LEVELS)
        check(same_bits(hist, ft.bin_counts_plain(x, hi0, LEVELS)),
              f"bin_counts differs ({what})")
        k = torch.full((B,), sp.density_count(n, 0.25), dtype=torch.int32,
                       device="cuda")
        thr = torch.clamp_min(ft.threshold_from_bins(hist, hi0, k, LEVELS),
                              sp.TINY)
        for got, want in zip(tm.topk_mask(x, thr), tm.topk_mask_plain(x, thr)):
            check(same_bits(got, want), f"topk_mask differs ({what})")
        u = torch.rand(x.shape, generator=gen, device="cuda")
        scale = qz.scale_of(hi0, 4)
        for got, want in zip(ft.fused_mask_quantize(x, thr, scale, u, 4),
                             ft.fused_mask_quantize_plain(x, thr, scale, u, 4)):
            check(same_bits(got, want), f"mask_quantize differs ({what})")
    torch.cuda.synchronize()
    print(f"[{label}] transport kernels bitwise equal to their plain versions on "
          f"the ViT run's round-0 uploads ({TASK_FED['n_clients']} x "
          f"{VIT_P_LEN}) and on one row (4-bit stochastic)")


def task_phase(seed: int):
    """The paper's path through `Experiment(task)` on ViT-B/16 and GPT-2
    Small at full width and depth, random weights from `seed`, pretrained
    on the task: FLASC (fused selector, 4-bit uploads) against dense LoRA
    on the image task, FLASC on the Reddit-style LM task."""
    import torch
    from repro_torch.configs.paper_models import GPT2_SMALL, VIT_B16
    from repro_torch.data import make_synth_image, make_synth_reddit
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import init_params, tree_leaves

    card = card_line()
    out = {}
    print(f"[task] device memory in use at the start: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    flasc = dict(strategy="flasc", selector="fused", quant_bits_up=4,
                 density_down=0.25, density_up=0.25)

    # (a) ViT-B/16 on 196 patches of 768 (a 224-px image at patch 16)
    t0 = time.perf_counter()
    task = make_synth_image(n_examples=1024, n_clients=32, n_patches=196,
                            dim=768, n_eval=256, seed=seed)
    gen_s = time.perf_counter() - t0
    gb = sum(v.nbytes for d in (task.data, task.eval_data)
             for v in d.values()) / 1e9
    print(f"[task] synth_image: 1024 + 256 examples x 196 x 768 f32 "
          f"({gb:.3f} GB) generated on the host in {gen_s:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    cfg = VIT_B16
    params = init_params(mdl.model_spec(cfg), seed, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == mdl.count_params(cfg), "ViT-B/16 parameter count")
    params, loss, pre_ms = timed_pretrain(params, cfg, task, VIT_PRETRAIN, seed)
    check(bool(torch.isfinite(torch.tensor(loss))), "ViT pretrain loss")
    print(f"[task] {cfg.name} ({n_params} params, {cfg.param_dtype}): "
          f"pretrain {VIT_PRETRAIN} steps at batch 64, {pre_ms:.3f} ms a step "
          f"(the pooled data's one upload included), final loss {loss:.6f}; "
          f"{card}")
    capture = UploadCapture()
    res_f, probe, lf, ms_f, exp = run_task(task, params, cfg, flasc,
                                           VIT_ROUNDS, 2, seed, capture)
    check(res_f.ledger.total_params == VIT_P_LEN,
          f"ViT flat vector has {res_f.ledger.total_params} entries, not "
          f"{VIT_P_LEN}")
    check_task_run("vit flasc", res_f, lf, VIT_ROUNDS, True)
    batch = exp._default_data()(0)
    check(all(v.is_cuda for v in batch.values()), "a task batch is not on "
          "the card")
    acc, eval_ms, upload_ms = timed_eval(exp, params, cfg, probe.state, task)
    check(acc == res_f.final_acc, f"re-evaluation gave {acc}, the run "
          f"{res_f.final_acc}")
    task_line("flasc (fused, 4-bit up, density 0.25/0.25)", cfg, res_f, ms_f,
              lf, card)
    print(f"[task] {cfg.name}: eval of 256 examples (2 batches) "
          f"{eval_ms:.3f} ms (their upload alone {upload_ms:.3f} ms), "
          f"accuracy {acc:.6f}; {card}")
    task_transport_parity(capture.deltas, seed)
    del capture
    res_d, _, ld, ms_d, _ = run_task(task, params, cfg, dict(strategy="lora"),
                                     VIT_ROUNDS, 2, seed)
    check_task_run("vit lora", res_d, ld, VIT_ROUNDS, False)
    task_line("dense lora", cfg, res_d, ms_d, ld, card)
    up_f, up_d = res_f.ledger.up_coded_bytes, res_d.ledger.up_coded_bytes
    check(up_f < up_d, f"FLASC coded upload {up_f} B is not below dense "
          f"LoRA's {up_d} B")
    peak_vit = torch.cuda.max_memory_allocated() / 2**30
    print(f"[task] {cfg.name}: FLASC up_coded_bytes {up_f} against dense "
          f"LoRA's {up_d} ({up_d / up_f:.2f}x); best acc {res_f.best_acc():.6f}"
          f" against {res_d.best_acc():.6f}; peak device memory "
          f"{peak_vit:.3f} GiB; {card}")
    out["vit"] = dict(flasc=lf, pretrain_ms=pre_ms, round_ms=ms_f,
                      eval_ms=eval_ms, acc=acc, peak_gib=peak_vit)
    # phase 13 runs the baselines on this pretrained backbone and task
    out["vit_setup"] = dict(params=params, cfg=cfg, task=task,
                            lora_ledger=res_d.ledger)
    del params, task, exp, probe, batch
    torch.cuda.empty_cache()

    # (b) GPT-2 Small on the Reddit-style next-token task (256 of its ids)
    torch.cuda.reset_peak_memory_stats()
    cfg = GPT2_SMALL
    task = make_synth_reddit(seed=seed)
    params = init_params(mdl.model_spec(cfg), seed, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == mdl.count_params(cfg), "GPT-2 parameter count")
    params, loss, pre_ms = timed_pretrain(params, cfg, task, GPT_PRETRAIN, seed)
    check(bool(torch.isfinite(torch.tensor(loss))), "GPT-2 pretrain loss")
    print(f"[task] {cfg.name} ({n_params} params, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}): pretrain {GPT_PRETRAIN} steps at batch 64, "
          f"{pre_ms:.3f} ms a step, final loss {loss:.6f}; {card}")
    res_g, probe, lg, ms_g, exp = run_task(task, params, cfg, flasc,
                                           GPT_ROUNDS, 0, seed)
    check(res_g.ledger.total_params == GPT_P_LEN,
          f"GPT-2 flat vector has {res_g.ledger.total_params} entries, not "
          f"{GPT_P_LEN}")
    check_task_run("gpt2 flasc", res_g, lg, GPT_ROUNDS, True)
    acc, eval_ms, upload_ms = timed_eval(exp, params, cfg, probe.state, task)
    check(acc == res_g.final_acc, "GPT-2 re-evaluation differs")
    task_line("flasc (fused, 4-bit up, density 0.25/0.25)", cfg, res_g, ms_g,
              lg, card)
    peak_gpt = torch.cuda.max_memory_allocated() / 2**30
    print(f"[task] {cfg.name}: eval of 512 sequences (4 batches) "
          f"{eval_ms:.3f} ms (their upload alone {upload_ms:.3f} ms), "
          f"next-token accuracy {acc:.6f}; peak device memory "
          f"{peak_gpt:.3f} GiB; {card}")
    out["gpt"] = dict(flasc=lg, pretrain_ms=pre_ms, round_ms=ms_g,
                      eval_ms=eval_ms, acc=acc, peak_gib=peak_gpt)
    return out


# ---------------------------------------------------------------------------
# phase 13: the paper's baselines, DP, FLoCoRA and full finetuning on ViT-B/16
# ---------------------------------------------------------------------------

HET_RANKS = (2, 2, 4, 4, 8, 8, 12, 12)
VIT_FULL_P_LEN = 85_112_832           # every ViT-B/16 parameter
LR_RANK = 8                           # flocora's default factor rank
LTH_ROUNDS = 3                        # adapter_lth prunes after rounds 1, 2


def _per_run(topk=0, absmax=0, bins=0, mq=0, count=0):
    return {"threshold_count": count, "topk_mask": topk, "absmax": absmax,
            "bin_counts": bins, "mask_quantize": mq,
            "mask_quantize_pack": 0, "pack_batch": 0}


# (tag, strategy, rounds, federation overrides, training overrides,
#  transport launches over the run).  Fused Top-K of one vector: topk_mask,
# absmax and bin_counts once each; a fused 4-bit upload of the 8 stacked
# deltas: absmax, bin_counts and mask_quantize once each; a `pallas` Top-K:
# 24 threshold_count passes and one topk_mask.  adapter_lth prunes through
# `pallas`: its 2-4% prune sits below the fused selector's resolution here
# (12 levels over [0, max |x|], and max |x| is the head's norm scale, 1.0,
# so one bin of 2.4e-4 holds more than the entries to prune, and the fused
# prune keeps them all).
BASELINES = (
    ("flasc_ef", dict(strategy="flasc_ef", selector="fused",
                      quant_bits_up=4), 2, {}, {}, _per_run(2, 4, 4, 2)),
    ("fedselect", dict(strategy="fedselect", selector="fused"), 2, {}, {},
     _per_run(2, 2, 2)),
    ("sparse_adapter", dict(strategy="sparse_adapter", selector="fused"), 2,
     {}, {}, _per_run(1, 1, 1)),
    ("adapter_lth", dict(strategy="adapter_lth", selector="pallas"),
     LTH_ROUNDS, {}, {}, _per_run(2, count=48)),
    ("ffa", dict(strategy="ffa"), 2, {}, {}, _per_run()),
    ("hetlora", dict(strategy="hetlora", hetlora_ranks=HET_RANKS), 2, {}, {},
     _per_run()),
    ("hetlora_weighted", dict(strategy="hetlora", hetlora_ranks=HET_RANKS,
                              hetlora_weighted=True), 2, {}, {}, _per_run()),
    ("flocora random", dict(strategy="flocora"), 2, {}, {}, _per_run()),
    ("flocora learned", dict(strategy="flocora", lowrank_mode="learned"), 2,
     {}, {}, _per_run()),
    ("two_stage_ortho", dict(strategy="two_stage_ortho", selector="fused",
                             quant_bits_up=4), 2, {}, {}, _per_run(0, 2, 2, 2)),
    ("dp flasc", dict(strategy="flasc", selector="fused", quant_bits_up=4), 2,
     dict(dp_clip=1.0, dp_noise=1.0), {}, _per_run(2, 4, 4, 2)),
    ("full finetune", dict(strategy="lora"), 2, {},
     dict(full_finetune=True), _per_run()),
)


class FlatAt:
    """Callback: a copy of the flat vector at the end of round `r`."""

    def __init__(self, r: int):
        self.r, self.flat = r, None

    def on_round_end(self, ev):
        if ev.round == self.r:
            self.flat = ev.state.flatP.clone()

    def on_eval(self, ev):
        pass


def _lora_pairs(tree):
    """[(path, a, b)] of every LoRA pair of an unflattened vector."""
    out = []

    def walk(node, path):
        if isinstance(node, dict) and {"a", "b"} <= set(node) \
                and not isinstance(node["a"], dict):
            out.append(("/".join(path), node["a"], node["b"]))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
    walk(tree, ())
    return out


def _lora_entries(meta):
    """(p_len,) bool on the card: the entries of the `lora` subtree."""
    import numpy as np
    import torch
    keep = np.concatenate([np.full(int(np.prod(shape)), path[0] == "lora")
                           for path, (shape, _) in zip(meta.paths,
                                                       meta.shapes)])
    return torch.from_numpy(keep).cuda()


def baseline_checks(tag, state, flat0, extra):
    """The kind-specific invariants on the card, from the final run state,
    the initial flat vector (ffa, hetlora) and `extra` (the ledger for
    flocora, the round-0 `FlatAt` for two_stage_ortho); returns a note to
    print."""
    import torch
    from repro_torch.core import strategies as st
    from repro_torch.core import transport as tp
    meta, flat, spec = state.plan.meta, state.flatP, state.plan.strategy.spec
    if tag == "ffa":
        is_a = torch.from_numpy(meta.is_b == 0).cuda()
        check(torch.equal(flat[is_a], flat0[is_a]),
              "ffa: an A entry moved")
        return f"{int(is_a.sum())} A entries bitwise unchanged"
    if tag.startswith("hetlora"):
        rank = torch.from_numpy(meta.rank_idx).cuda()
        is_b = torch.from_numpy(meta.is_b == 1).cuda()
        lora = _lora_entries(meta)
        free, low = lora & (rank >= max(HET_RANKS)), lora & (rank < min(
            HET_RANKS))
        check(torch.equal(flat[free], flat0[free]),
              f"{tag}: an entry no client covers moved")
        # every B entry starts at 0, so any local step moves it; an A entry
        # (|a| ~ 0.036) can take local steps below half its f32 ulp
        moved = {name: float((flat[m] != flat0[m]).float().mean())
                 for name, m in (("B", low & is_b), ("A", low & ~is_b))}
        check(moved["B"] >= 0.999 and moved["A"] > 0.0, f"{tag}: moved "
              f"{moved} of the rank < {min(HET_RANKS)} entries")
        return (f"{int(free.sum())} entries of rank >= {max(HET_RANKS)} "
                f"bitwise unchanged; of rank < {min(HET_RANKS)}, "
                f"{moved['B']:.6f} of B and {moved['A']:.6f} of A moved")
    if tag == "adapter_lth":
        mask, dens = state.sstate["mask"], state.sstate["density"]
        n = meta.p_len
        k = int(torch.clamp(torch.round(n * dens).to(torch.int32), 1, n - 1))
        kept = int(mask.sum())
        want = torch.tensor(1.0) * spec.lth_keep * spec.lth_keep
        check(float(dens) == float(want), f"adapter_lth: density "
              f"{float(dens)} after two prunes, expected {float(want)}")
        check(bool((flat[~mask] == 0).all()), "adapter_lth: a pruned entry "
              "is not zero")
        # the bisection keeps every |x| at or above its threshold: k, or
        # more by the entries of the threshold's last bin (2^-24 max |x|)
        check(k <= kept <= k + n // 1000, f"adapter_lth: kept {kept} for k "
              f"{k}")
        return (f"density {float(dens):.6f}, kept {kept} for k {k}, pruned "
                "entries all 0")
    if tag == "two_stage_ortho":
        worst = 0.0
        for path, a, _ in _lora_pairs(meta.unflatten(extra.flat)["lora"]):
            a = a.float()
            eye = torch.eye(a.shape[-1], device=a.device)
            worst = max(worst, float((a.transpose(-1, -2) @ a - eye)
                                     .abs().max()))
        check(worst <= 1e-4, f"two_stage_ortho: max |QᵀQ - I| {worst} after "
              "round 0")
        tree = meta.unflatten(flat)["lora"]
        folded = st._ortho_lora_pairs(tree)
        rel = 0.0
        for (_, a, b), (_, q, rb) in zip(_lora_pairs(tree),
                                        _lora_pairs(folded)):
            want = a.double() @ b.double()
            got = q.double() @ rb.double()
            rel = max(rel, float((got - want).abs().max()
                                 / want.abs().max()))
        check(rel <= 1e-4, f"two_stage_ortho: the fold moved a product "
              f"A·B by {rel} relative")
        return (f"max |QᵀQ - I| {worst:.3e} after round 0; folding the "
                f"final vector keeps every A·B within {rel:.3e}")
    if tag.startswith("flocora"):
        led = extra
        rows, cols = tp._factor_dims(meta.p_len)
        per = LR_RANK * (rows if spec.lowrank_mode == "random"
                         else rows + cols)
        want = 2 * TASK_FED["n_clients"] * per * 4
        check(led.up_dense and led.down_dense, f"{tag}: not dense-coded")
        check(led.up_coded_bytes == want == led.down_coded_bytes,
              f"{tag}: coded bytes up {led.up_coded_bytes} down "
              f"{led.down_coded_bytes}, expected {want} each")
        return (f"{rows} x {cols} embedding, {per} f32 entries a message: "
                f"up = down = {want} B coded")
    if tag == "full finetune":
        check(meta.p_len == VIT_FULL_P_LEN, f"full finetune p_len "
              f"{meta.p_len}, expected {VIT_FULL_P_LEN}")
        return f"p_len {meta.p_len}"
    return ""


def baseline_phase(seed: int, vit: dict):
    """The paper's baselines through `Experiment(task)` on phase 12's
    pretrained ViT-B/16 and task (8 clients x 2 x 8, rank 16 plus the
    head): every strategy kind besides flasc and lora, DP-FLASC and full
    finetuning, with their transport launches and invariants checked."""
    import numpy as np
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig

    card = card_line()
    params, cfg, task = vit["params"], vit["cfg"], vit["task"]
    lora_led = vit["lora_ledger"]
    lora_down = lora_led.down_coded_bytes / lora_led.rounds
    lora_up = lora_led.up_coded_bytes / lora_led.rounds
    out = {}
    for tag, strategy, rounds, fed, train, expect in BASELINES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        extra = FlatAt(0) if tag == "two_stage_ortho" else None
        res, probe, launches, round_ms, exp = run_task(
            task, params, cfg, strategy, rounds, 0, seed, fed=fed,
            train=train, callbacks=(extra,) if extra else ())
        peak = torch.cuda.max_memory_allocated() / 2**30
        state, led = probe.state, res.ledger
        check(len(res.history) == rounds, f"{tag}: the run stopped early")
        check(all(np.isfinite(h["loss"]) for h in res.history),
              f"{tag}: a round's loss is not finite")
        check(0.0 <= res.final_acc <= 1.0 and "acc" in res.history[-1],
              f"{tag}: final accuracy {res.final_acc}")
        check(launches == expect, f"{tag}: launches {launches}, expected "
              f"{expect}")
        flat0 = None
        if tag == "ffa" or tag.startswith("hetlora"):
            # the run's initial vector: the LoRA init is seeded
            trainable, meta, _ = exp._build_trainable(params, cfg)
            flat0 = meta.flatten(trainable)
        note = baseline_checks(tag, state, flat0,
                               led if tag.startswith("flocora") else extra)
        del flat0
        rows = "; ".join(f"{r}: loss {h['loss']:.6f}, {round_ms[r]:.3f} ms"
                         for r, h in enumerate(res.history))
        print(f"[baselines] {tag} ({json.dumps(strategy)}"
              + (f", {json.dumps(fed)}" if fed else "")
              + (f", {json.dumps(train)}" if train else "") + f"): {rows}")
        print(f"[baselines] {tag}: p_len {led.total_params}; ledger coded "
              f"down {led.down_coded_bytes} / up {led.up_coded_bytes} B; "
              f"final acc {res.final_acc:.6f}; peak device memory "
              f"{peak:.3f} GiB; launches {json.dumps(launches)}; {note}; "
              f"{card}")
        down_r, up_r = (led.down_coded_bytes / rounds,
                        led.up_coded_bytes / rounds)
        print(f"[baselines] {tag}: coded bytes a round down {down_r:.0f} / "
              f"up {up_r:.0f} against dense LoRA's {lora_down:.0f} / "
              f"{lora_up:.0f} (phase 12): {lora_up / up_r:.3f}x less up, "
              f"{lora_down / down_r:.3f}x less down")
        out[tag] = dict(launches=launches, round_ms=round_ms, peak_gib=peak,
                        acc=res.final_acc, down=led.down_coded_bytes,
                        up=led.up_coded_bytes)
        del res, probe, exp, state
        torch.cuda.empty_cache()
    # DP noise is calibrated for a uniform mean: a weighted rule is refused
    exp = (Experiment(task, federation=FederatedConfig(
               **{**TASK_FED, "dp_clip": 1.0, "dp_noise": 1.0}))
           .with_strategy("hetlora", hetlora_ranks=HET_RANKS,
                          hetlora_weighted=True)
           .with_lora(rank=TASK_RANK).with_training(rounds=1, seed=seed)
           .with_params(params, cfg))
    try:
        exp.run()
    except NotImplementedError as e:
        print(f"[baselines] dp + hetlora_weighted refused: {e}")
    else:
        check(False, "DP with hetlora_weighted ran")
    return out


# ---------------------------------------------------------------------------
# phase 14: Figure 2 at ViT-B/16 through the ported harness
# ---------------------------------------------------------------------------

FIG2_ROUNDS = 10
MIN_PRETRAINED_ACC = 0.3              # 3x chance on 10 classes
# (tag, Figure 2's METHODS key, selector put in its spec or None): the
# figure's entries as written run the `exact` selector (plain torch)
FIG2_RUNS = (("lora", "lora", None),
             ("flasc_d1/4", "flasc_d1/4", None),
             ("flasc_d1/4 fused", "flasc_d1/4", "fused"),
             ("flasc_d1/4_q8 fused", "flasc_d1/4_q8", "fused"))


def fig2_launches(selector, rounds: int) -> dict:
    """The transport and pack launches of a FLASC run, derived from the
    port's code: under `fused`, a round's download mask is
    `FusedSelector.mask` (absmax, bin_counts, topk_mask) and its upload one
    `FusedTopKQuantize` over the 8 stacked deltas (absmax, bin_counts,
    mask_quantize, also at bits 0); the download's 8-bit quantization is
    plain torch.  `exact` and dense LoRA launch none."""
    if selector != "fused":
        return _per_run()
    return _per_run(topk=rounds, absmax=2 * rounds, bins=2 * rounds,
                    mq=rounds)


def fig2_phase(seed: int):
    """Figure 2 at ViT-B/16 size through `benchmarks_torch`: the paper-size
    backbone from `common.pretrained_backbone` at `common.PAPER_PRETRAIN`,
    then dense LoRA, FLASC d1/4 as written (exact) and FLASC d1/4 and
    d1/4_q8 with the fused selector, `FIG2_ROUNDS` rounds each, the
    harness's rows printed and the fused runs' launches asserted."""
    import numpy as np
    import torch
    from benchmarks_torch import common
    from benchmarks_torch.fig2_comm_efficiency import METHODS, result_rows

    card = card_line()
    t0 = time.perf_counter()
    task = common.get_task("synth_image", seed=seed, model="paper")
    gen_s = time.perf_counter() - t0
    pre = common.PAPER_PRETRAIN
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, cfg = common.pretrained_backbone(task, common.PAPER_KW,
                                             pre["steps"], seed, "cuda")
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    acc0 = common.backbone_acc(params, cfg, task)
    print(f"[fig2] {cfg.name} ({cfg.param_dtype}) on synth_image (196 x 768, "
          f"generated in {gen_s:.3f} s): pretrained {pre['steps']} steps at lr "
          f"{pre['lr']}, batch {pre['batch_size']} in {pre_s:.3f} s; "
          f"pretrained accuracy {acc0:.6f}; {card}")
    check(acc0 >= MIN_PRETRAINED_ACC, f"the pretrained ViT-B/16 reads "
          f"{acc0}, below {MIN_PRETRAINED_ACC}")
    fns = {**transport_functions(), **pack_functions()}
    out = {}
    for tag, key, selector in FIG2_RUNS:
        spec = METHODS[key] if selector is None else \
            dataclasses.replace(METHODS[key], selector=selector)
        capture = UploadCapture() if tag == "flasc_d1/4 fused" else None
        torch.cuda.synchronize()
        for f in fns.values():
            f.launches = 0
        with (capture.around() if capture else contextlib.nullcontext()):
            res = common.run(task, spec, rounds=FIG2_ROUNDS, seed=seed,
                             model_kw=common.PAPER_KW, device="cuda")
        launches = {name: f.launches for name, f in fns.items()}
        expect = fig2_launches(spec.selector if spec.kind == "flasc"
                               else None, FIG2_ROUNDS)
        check(len(res.history) == FIG2_ROUNDS, f"fig2 {tag}: stopped early")
        check(all(np.isfinite(h["loss"]) for h in res.history),
              f"fig2 {tag}: a round's loss is not finite")
        check(launches == expect, f"fig2 {tag}: launches {launches}, "
              f"expected {expect}")
        accs = [h["acc"] for h in res.history if "acc" in h]
        print(f"[fig2] {tag} ({spec.selector}): losses "
              + ", ".join(f"{h['loss']:.6f}" for h in res.history)
              + f"; evals {accs}; {res.elapsed:.3f} s; coded down "
              f"{res.ledger.down_coded_bytes} / up {res.ledger.up_coded_bytes}"
              f" B; launches {json.dumps(launches)}")
        for r in result_rows(f"synth_image/{tag}", res):
            print(f"[fig2] row {r['figure']},{r['setting']},{r['metric']},"
                  f"{r['value']}")
        out[tag] = dict(launches=launches, best=res.best_acc(),
                        coded=res.ledger.total_coded_bytes)
        if capture is not None:
            task_transport_parity(capture.deltas, seed, label="fig2")
    for tag in out:
        if tag != "lora":
            check(out[tag]["coded"] < out["lora"]["coded"], f"fig2 {tag}: "
                  f"coded {out[tag]['coded']} B not below dense LoRA's "
                  f"{out['lora']['coded']} B")
    gap = out["flasc_d1/4"]["best"] - out["flasc_d1/4 fused"]["best"]
    print(f"[fig2] best accuracy, exact minus fused FLASC d1/4: {gap:+.6f}; "
          f"dense LoRA's best {out['lora']['best']:.6f} against the "
          f"pretrained {acc0:.6f}; coded bytes of dense LoRA over FLASC d1/4: "
          f"{out['lora']['coded'] / out['flasc_d1/4']['coded']:.3f}x; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; {card}")
    return out


# ---------------------------------------------------------------------------
# phase 15: checkpoint / resume on phase 12's ViT-B/16
# ---------------------------------------------------------------------------

RESUME_ROUNDS = 4                     # rounds (events) of every run
RESUME_EVERY = 2                      # the snapshot after round (event) 1
VIT_ROW_BYTES = 4 * VIT_P_LEN         # 4,752,384: one ViT momentum row
YI_ROW_BYTES = 4 * P_LEN              # 39,321,600: one Yi-9B momentum row
RESUME_FLASC = dict(strategy="flasc", selector="fused", quant_bits_up=4,
                    density_down=0.25, density_up=0.25)
RESUME_POPULATION = dict(population=10_000, sampler="availability",
                         period=8, duty=0.5, chunk=4)
ASYNC_SAMPLER = {"kind": "fraction", "participation": 0.5, "seed": 0}


def kernel_functions():
    """Every kernel of the kernels JSON line -> its counting wrapper."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    return {**transport_functions(), **pack_functions(),
            "grouped_lora_delta": lm.resolve_grouped_kernel("grouped_pallas"),
            "flash_attention": fa.FLASH,
            "flash_attention_bwd": fa.FLASH_BWD, "lora_matmul": lm.LORA_MATMUL}


@contextlib.contextmanager
def counted(out: dict):
    """Zero every kernel's launch count, run the body, and put the counts
    of the body's launches in `out`."""
    import torch
    fns = kernel_functions()
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    yield out
    out.update({name: f.launches for name, f in fns.items()})


def same_tree(a, b) -> bool:
    """Trees of tensors or numpy arrays (dtype, shape and bits), host
    scalars and containers: equal."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.reshape(-1).contiguous().view(torch.uint8),
                    b.reshape(-1).contiguous().view(torch.uint8)))
    return type(a) is type(b) and a == b


def strip_wall(history):
    """History records without the wall-clock `phase_ms`."""
    return [{k: v for k, v in h.items() if k != "phase_ms"} for h in history]


class RunEnd:
    """Callback: the last round's state, and the host seconds of each
    snapshot save (from the round end that marked it due to the end of
    `on_checkpoint`); with `stop` the run ends after its first save."""

    def __init__(self, stop: bool = False):
        self.stop, self.state, self.save_s = stop, None, []
        self._t0 = None

    def wants_state(self, round_idx, rounds):
        return False

    def on_round_end(self, ev):
        self.state = ev.state
        self._t0 = time.perf_counter() if ev.checkpoint_due else None

    def on_eval(self, ev):
        pass

    def on_checkpoint(self, ev):
        from repro_torch.federated.engine import StopRun
        self.save_s.append(time.perf_counter() - self._t0)
        if self.stop:
            raise StopRun


def dir_bytes(d: str) -> dict:
    return {n: os.path.getsize(os.path.join(d, n)) for n in sorted(
        os.listdir(d))}


def resume_run(vit, seed, strategy, engine=None, population=None,
               ckpt=None, callbacks=()):
    """One `Experiment(task)` on phase 12's ViT-B/16 (`RESUME_ROUNDS`
    rounds, eval every 2), optionally checkpointed into `ckpt` and stopped
    after the first save; returns (result, RunEnd, launches, experiment)."""
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig
    end = RunEnd(stop=ckpt is not None)
    exp = (Experiment(vit["task"], federation=FederatedConfig(**TASK_FED))
           .with_strategy(**strategy)
           .with_lora(rank=TASK_RANK)
           .with_training(rounds=RESUME_ROUNDS, eval_every=2, seed=seed)
           .with_params(vit["params"], vit["cfg"])
           .with_callbacks(end, *callbacks))
    if engine is not None:
        exp.with_engine(engine())
    if population is not None:
        exp.with_population(**population)
    if ckpt is not None:
        # ViT-B/16 is not the task model of `ModelOptions`: the snapshot
        # carries its config (a port-only sidecar key)
        exp.with_checkpoint(ckpt, every=RESUME_EVERY, save_model_config=True)
    launches = {}
    with counted(launches):
        res = exp.run()
    return res, end, launches, exp


def check_same_run(tag, got, got_end, want, want_end):
    """Bitwise: history (wall-clock phases left out), ledger, accuracy,
    flat vector, server state, strategy state and the engine's final state
    (the async clock, the population store)."""
    import dataclasses as dc
    check(strip_wall(got.history) == strip_wall(want.history),
          f"{tag}: histories differ: {strip_wall(got.history)} against "
          f"{strip_wall(want.history)}")
    check(dc.asdict(got.ledger) == dc.asdict(want.ledger),
          f"{tag}: ledgers differ")
    check(got.final_acc == want.final_acc, f"{tag}: accuracies differ")
    g, w = got_end.state, want_end.state
    check(same_tree(g.flatP, w.flatP), f"{tag}: flat vectors differ")
    check(same_tree(g.server, w.server), f"{tag}: server states differ")
    check(same_tree(g.sstate, w.sstate), f"{tag}: strategy states differ")
    check(same_tree(g.aux, w.aux), f"{tag}: the engines' final states "
          "(clock or store) differ")


def resume_case(tag, vit, seed, root, **kw):
    """The straight run twice (the card's own determinism first), then a
    run stopped after its round-1 snapshot and `Experiment.resume` on the
    card for the rest: everything bitwise equal to the straight run.
    Prints the snapshot's size, save and load seconds and peak memory."""
    import torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.federated import Experiment
    from repro_torch.models.layers import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    a, a_end, la, a_exp = resume_run(vit, seed, **kw)
    b, b_end, _, _ = resume_run(vit, seed, **kw)
    check_same_run(f"resume {tag}: two straight runs", b, b_end, a, a_end)
    d = os.path.join(root, tag)
    part, part_end, _, _ = resume_run(vit, seed, ckpt=d, **kw)
    check(len(part.history) == RESUME_EVERY, f"resume {tag}: the run did "
          f"not stop at its snapshot ({len(part.history)} rounds)")
    sizes = dir_bytes(d)
    check(sorted(sizes) == ["frozen.npz", "meta.json",
                            f"state-r{RESUME_EVERY}.npz"],
          f"resume {tag}: snapshot files {sorted(sizes)}")
    state_arrays = ckpt_io.load_pytree(
        os.path.join(d, f"state-r{RESUME_EVERY}.npz"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = Experiment.resume(d, device="cuda")
    load_s = time.perf_counter() - t0
    r_end = RunEnd()
    exp.with_callbacks(r_end)
    launches = {}
    with counted(launches):
        res = exp.run()
    check_same_run(f"resume {tag}", res, r_end, a, a_end)
    check(r_end.state.flatP.is_cuda and all(
        p.is_cuda for p in tree_leaves(r_end.state.plan.params)),
        f"resume {tag}: the resumed run left the card")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[resume] {tag}: straight run twice bitwise equal; stopped after "
          f"round {RESUME_EVERY - 1}'s snapshot and resumed: history, ledger,"
          f" accuracy, flat vector ({r_end.state.flatP.numel()}), server and "
          f"strategy state bitwise equal to the straight run; losses "
          + ", ".join(f"{h['loss']:.6f}" for h in res.history)
          + f"; snapshot on disk {json.dumps(sizes)} ({sum(sizes.values())} "
          f"B), save {', '.join(f'{s:.3f}' for s in part_end.save_s)} s, "
          f"load (Experiment.resume) {load_s:.3f} s; peak device memory "
          f"{peak:.3f} GiB; launches straight {json.dumps(la)}, resumed "
          f"{json.dumps(launches)}; {card_line()}")
    return dict(straight=a, launches=la, resumed_launches=launches,
                exp=a_exp, resumed=exp, state=state_arrays, sizes=sizes,
                load_s=load_s, save_s=part_end.save_s, peak_gib=peak)


def resume_phase(seed: int, vit: dict):
    """Checkpoint / resume on phase 12's pretrained ViT-B/16 and task (8
    clients x 2 x 8, rank 16 plus the head), FLASC (fused, 4-bit up):
    (a) sim, (b) async with packed uploads and jobs in flight at the
    snapshot, (c) a 10,000-client population; then (d) the async engine
    with a participation sampler under hetlora_weighted."""
    import tempfile
    import shutil
    import numpy as np
    import torch
    from repro_torch.federated import AsyncEngine
    from repro_torch.federated.async_clock import ClientSystemProfile

    root = tempfile.mkdtemp(prefix="resume-")
    out = {}
    try:
        # (a) sim
        r = resume_case("sim", vit, seed, root, strategy=RESUME_FLASC)
        per_round = {k: v // RESUME_ROUNDS for k, v in r["launches"].items()}
        check(r["launches"] == fig2_launches("fused", RESUME_ROUNDS)
              | {k: 0 for k in ("grouped_lora_delta", "flash_attention",
                                "flash_attention_bwd", "lora_matmul")},
              f"resume sim: straight launches {r['launches']}")
        want = {k: v * (RESUME_ROUNDS - RESUME_EVERY)
                for k, v in per_round.items()}
        check(r["resumed_launches"] == want, f"resume sim: resumed launches "
              f"{r['resumed_launches']}, expected {want}")
        out["sim"] = r

        # (b) async, packed uploads, a tiered profile: jobs in flight
        def engine():
            return AsyncEngine(concurrency=4, buffer_size=2,
                               profile=ClientSystemProfile.tiered(
                                   TASK_FED["n_clients"], 2))
        r = resume_case("async", vit, seed, root,
                        strategy=dict(RESUME_FLASC, sparse_aggregate=True),
                        engine=engine)
        inflight = r["state"]["aux"]["inflight"]["slot"].size
        check(inflight > 0, "resume async: no job in flight at the snapshot")
        hist = r["straight"].history
        check(any(h["staleness"] > 0 for h in hist),
              "resume async: no stale update")
        check(r["launches"]["pack_batch"] > 0 and
              r["resumed_launches"]["pack_batch"] > 0,
              "resume async: the packed path did not run")
        print(f"[resume] async: {inflight} jobs in flight at the snapshot; "
              f"sim_time " + ", ".join(f"{h['sim_time']:.6f}" for h in hist)
              + "; staleness " + ", ".join(f"{h['staleness']}" for h in hist))
        out["async"] = r

        # (c) a population of 10,000 behind an availability trace
        r = resume_case("population", vit, seed, root,
                        strategy=RESUME_FLASC, population=RESUME_POPULATION)
        ids = np.unique([c for h in r["straight"].history
                         for c in h["cohort"]])
        chunks = np.unique(ids // RESUME_POPULATION["chunk"]).size
        want_bytes = chunks * RESUME_POPULATION["chunk"] * VIT_ROW_BYTES
        for which in ("exp", "resumed"):
            store = r[which]._population_bundle.store
            check(store.nbytes == want_bytes, f"resume population: "
                  f"{which} store holds {store.nbytes} B, expected "
                  f"{chunks} chunks x {RESUME_POPULATION['chunk']} x "
                  f"{VIT_ROW_BYTES}")
        rows = [r[w]._population_bundle.store.gather(ids)
                for w in ("exp", "resumed")]
        check(np.array_equal(rows[0].view(np.int32), rows[1].view(np.int32)),
              "resume population: the stores' rows differ")
        print(f"[resume] population: cohorts "
              f"{[h['cohort'] for h in r['straight'].history]}; "
              f"{ids.size} clients in {chunks} chunks touched, store "
              f"{want_bytes} B in both runs, rows bitwise equal")
        out["population"] = r

        # (d) async with a participation sampler, hetlora_weighted, buffer
        # 2: every event aggregates through the slot-specialised phase
        torch.cuda.reset_peak_memory_stats()
        het = dict(strategy="hetlora", hetlora_ranks=HET_RANKS,
                   hetlora_weighted=True)
        res, end, launches, exp = resume_run(
            vit, seed, het, engine=lambda: AsyncEngine(
                buffer_size=2, sampler=ASYNC_SAMPLER))
        check(exp.engine.config()["sampler"] == ASYNC_SAMPLER,
              "resume sampler: config")
        check(len(res.history) == RESUME_ROUNDS and
              all(np.isfinite(h["loss"]) for h in res.history),
              f"resume sampler: losses {[h['loss'] for h in res.history]}")
        check(all(h["applied"] == 2 for h in res.history),
              "resume sampler: an event was not a partial buffer of 2")
        trainable, meta, _ = exp._build_trainable(vit["params"], vit["cfg"])
        note = baseline_checks("hetlora_weighted", end.state,
                               meta.flatten(trainable), None)
        print(f"[resume] async sampler {json.dumps(ASYNC_SAMPLER)}, "
              f"hetlora_weighted {HET_RANKS}, buffer 2: losses "
              + ", ".join(f"{h['loss']:.6f}" for h in res.history)
              + "; sim_time " + ", ".join(f"{h['sim_time']:.6f}"
                                          for h in res.history)
              + f"; {note}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {json.dumps(launches)}")
        out["sampler"] = dict(launches=launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in ("sim", "async", "population"):
        for k in ("exp", "resumed", "straight", "state"):
            out[r].pop(k)
    return out


# ---------------------------------------------------------------------------
# phase 16: a population of 10^6 clients on full-width Yi-9B
# ---------------------------------------------------------------------------

POP_ROUNDS = 4
YI_POPULATION = 1_000_000


class WaitProbe:
    """Callback: host time at every round end, the prefetcher's take()
    seconds of every round, and the last state."""

    def __init__(self):
        self.t = [time.perf_counter()]
        self.wait = [0.0]
        self.state = None

    def on_round_end(self, ev):
        self.t.append(time.perf_counter())
        self.wait.append(ev.state.plan.population.last_prefetcher.take_wait_s)
        self.state = ev.state

    def on_eval(self, ev):
        pass


def population_phase(seed: int):
    """Phase 6's full-width Yi-9B FLASC (fused, 4-bit up, rank 8, 4
    clients x 4 x 32 tokens) behind `with_population(10^6,
    sampler="uniform", chunk=1)`, prefetch on and off: bitwise equal, one
    H2D copy a cohort, the store O(touched clients)."""
    import numpy as np
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.models.config import FederatedConfig

    t0 = time.perf_counter()
    cfg, params = yi_backbone(seed)
    torch.cuda.synchronize()
    print(f"[population] backbone built in {time.perf_counter() - t0:.1f}s")
    data = token_batches(cfg, seed)
    runs = {}
    for prefetch in (True, False):
        probe = WaitProbe()
        torch.cuda.reset_peak_memory_stats()
        exp = (Experiment(None, federation=FederatedConfig(**FED))
               .with_strategy("flasc", selector="fused", quant_bits_up=4,
                              density_down=0.25, density_up=0.25)
               .with_lora(rank=8)
               .with_training(rounds=POP_ROUNDS, seed=seed)
               .with_params(params, cfg)
               .with_data(data)
               .with_engine("sim")
               .with_population(YI_POPULATION, sampler="uniform", chunk=1,
                                prefetch=prefetch)
               .with_callbacks(probe))
        launches = {}
        probe.t = [time.perf_counter()]
        with counted(launches):
            res = exp.run()
        bundle = exp._population_bundle
        pre, store = bundle.last_prefetcher, bundle.store
        ids = np.unique([c for h in res.history for c in h["cohort"]])
        round_ms = [1e3 * (b - a) for a, b in zip(probe.t, probe.t[1:])]
        wait_ms = [1e3 * (b - a) for a, b in zip(probe.wait, probe.wait[1:])]
        tag = "on" if prefetch else "off"
        print(f"[population] prefetch {tag}: {POP_ROUNDS} rounds of "
              f"{FED['n_clients']} out of {YI_POPULATION}; losses "
              + ", ".join(f"{h['loss']:.6f}" for h in res.history)
              + f"; round ms {', '.join(f'{m:.3f}' for m in round_ms)}; "
              f"take() wait ms a round {', '.join(f'{m:.3f}' for m in wait_ms)}"
              f" (take_wait_s {pre.take_wait_s:.6f}); h2d_puts "
              f"{pre.h2d_puts}; store {store.nbytes} B for {ids.size} "
              f"clients ({store.n_chunks} chunks); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {json.dumps(launches)} (phase 6 a round: "
              f"{json.dumps(FUSED_PER_ROUND)}); {card_line()}")
        check(len(res.history) == POP_ROUNDS and
              all(np.isfinite(h["loss"]) for h in res.history),
              f"population {tag}: losses")
        check(pre.h2d_puts == POP_ROUNDS, f"population {tag}: {pre.h2d_puts}"
              f" H2D copies in {POP_ROUNDS} rounds")
        check(store.nbytes == ids.size * YI_ROW_BYTES, f"population {tag}: "
              f"store {store.nbytes} B for {ids.size} clients")
        for name, per_round in FUSED_PER_ROUND.items():
            check(launches[name] == per_round * POP_ROUNDS,
                  f"population {tag}: {name} launched {launches[name]} times,"
                  f" expected {per_round} x {POP_ROUNDS}")
        runs[tag] = dict(res=res, flat=probe.state.flatP, launches=launches,
                         round_ms=round_ms, wait_ms=wait_ms,
                         nbytes=store.nbytes, clients=int(ids.size))
        del exp, bundle, pre, store, probe
    check(strip_wall(runs["on"]["res"].history)
          == strip_wall(runs["off"]["res"].history),
          "population: prefetch on and off give different histories")
    check(same_tree(runs["on"]["flat"], runs["off"]["flat"]),
          "population: prefetch on and off give different flat vectors")
    print("[population] prefetch on == prefetch off: histories and final "
          "flat vectors bitwise equal")
    for r in runs.values():
        r.pop("res")
        r.pop("flat")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 17: the training CLI at full width
# ---------------------------------------------------------------------------

TRAIN_CLI_ARGS = ["--arch", "yi-9b", "--rounds", "2"]
TRAFFIC = re.compile(r"traffic: total ([\d.]+)MB \(([\d.]+)% of dense\) \| "
                     r"coded wire format ([\d.]+)MB \(down ([\d.]+) / up "
                     r"([\d.]+)\)")
PER_CLIENT = re.compile(r"per client per round: down ([\d.]+)kB \((\d+) "
                        r"values\), up ([\d.]+)kB \((\d+) values\)")


def train_cli_phase(seed: int):
    """`python -m repro_torch.launch.train --arch yi-9b --rounds 2` in this
    process, on the card at full width and depth: its printed ledger lines
    positive and its losses finite."""
    import io
    import numpy as np
    import torch
    from repro_torch.launch import train

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    launches = {}
    t0 = time.perf_counter()
    with counted(launches), contextlib.redirect_stdout(buf):
        res = train.main(TRAIN_CLI_ARGS + ["--seed", str(seed)])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[train-cli] {line}")
    traffic, per = TRAFFIC.search(text), PER_CLIENT.search(text)
    check(traffic is not None and per is not None,
          "train-cli: no ledger lines")
    nums = [float(x) for x in traffic.groups() + per.groups()]
    check(all(x > 0 for x in nums), f"train-cli: ledger numbers {nums}")
    check("(full: 48L d4096)" in text, "train-cli: not the full config")
    check(len(res.history) == 2 and
          all(np.isfinite(h["loss"]) for h in res.history),
          f"train-cli: losses {[h['loss'] for h in res.history]}")
    print(f"[train-cli] {' '.join(TRAIN_CLI_ARGS)}: {wall:.3f} s with the "
          f"backbone's build; losses "
          + ", ".join(f"{h['loss']:.6f}" for h in res.history)
          + f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{json.dumps(launches)}; {card_line()}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 18: LoRA training at 8192 tokens or more, Yi-9B at full width and depth
# ---------------------------------------------------------------------------

LONG_TRAIN = ((8192, 2, 2), (32768, 1, 1))     # (tokens, clients, rounds)
LONG_FED = dict(local_batch=1, local_steps=1, client_lr=1e-3, server_lr=2e-3)
# dq, dk and dv against `flash_attention_bwd_plain` in f64 on the same
# inputs (q, k, v, out, lse, dout), row by row (grad_row_err): the bf16
# contract of csrc/flash_attention_bwd.cu (the outputs' own rounding takes
# 2^-9 of it), and f32 sums against exact ones
BWD_ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# a row's largest value is floored at this share of the gradient's largest:
# the first query row under causal masking has an exact dq of 0 (a softmax
# over one key), and a row that cancels so far has no relative error
BWD_ROW_FLOOR = 1e-2
# the lse the forward writes, against the f64 rows' log-sum-exp
LSE_TOL = 1e-4
# the model's flat LoRA gradient through the kernels against the one through
# chunked_attention's autograd, relative L2: both run in bf16 with p and dS
# at f32 precision, so they differ by bf16 roundings (2^-9 each) of q, k, v,
# the attention output and their gradients
GRAD_REL_L2 = 2e-2
# cuBLAS GEMM kernels on Hopper, by name in a profiler trace
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)


def attn_bwd_bound(B, S, T, H, KV, hd, dtype, causal):
    """(bound_ms, bound_by) of the attention backward: q, k, v, out, dout
    and lse read once, dq, dk and dv written once, against five products
    of S T hd multiply-adds per head (Q K^T, P^T dO, dO V^T, dS K, dS^T Q),
    halved under the causal mask."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * B * (4 * S * H * hd + 4 * T * KV * hd) + 4 * B * H * S
    flops = 10 * B * H * S * T * hd / (2 if causal else 1)
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_window_bwd_bound(B, S, H, KV, hd, dtype, window):
    """(bound_ms, bound_by) of the attention backward under a causal window
    of W keys (S == T): attn_bwd_bound's bytes against its five products
    over the kept (query, key) pairs only, sum over q of min(q + 1, W)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * B * (4 * S * H * hd + 4 * S * KV * hd) + 4 * B * H * S
    W = min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W
    flops = 10 * B * H * pairs * hd
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def grad_row_err(got, want) -> float:
    """The worst row's largest |got - want| over that row's largest |want|,
    floored at BWD_ROW_FLOOR of the tensor's largest |want|."""
    want = want.double()
    d = (got.double() - want).abs().amax(-1)
    m = want.abs().amax(-1).clamp_min(BWD_ROW_FLOOR * want.abs().max().item())
    return (d / m.clamp_min(1e-300)).max().item()


def grad_errs(got, want) -> dict:
    """{name: {"row": grad_row_err, "rel_l2": ||got - want|| / ||want||}}
    of (dq, dk, dv)."""
    return {n: {"row": grad_row_err(g, w), "rel_l2": (
        (g.double() - w).norm() / w.double().norm().clamp_min(1e-300)).item()}
        for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def grad_worst(got, want, one_key: bool) -> float:
    """The case's error under the contract: grad_errs' worst row.  Where
    every query row sees one key alone (a window of 1, or T = 1), P = 1 and
    the exact dq and dk are 0 (dP - D cancels): the row measure has no
    scale there, so dq and dk are held instead by their largest |value|
    over BWD_ROW_FLOOR of dv's largest (dv = the rows' dout), the floor
    that every other row measure takes."""
    errs = grad_errs(got, want)
    if not one_key:
        return max(e["row"] for e in errs.values())
    scale = BWD_ROW_FLOOR * want[2].abs().max().item()
    return max(errs["dv"]["row"],
               *(g.double().abs().max().item() / scale for g in got[:2]))


# phase 18 (a)'s windowed backward cases: every route, (H, KV, hd, dtype),
# each at B 2, S 1000, T 1100 under windows around the 64-key tiles (W 1:
# each row sees its own key; W 8192 >= S: bitwise the call without one)
BWD_WINDOW_ROUTES = ((32, 4, 128, "bfloat16"), (8, 2, 64, "bfloat16"),
                     (8, 2, 128, "float32"), (16, 16, 256, "bfloat16"))
BWD_WINDOWS = (1, 63, 64, 65, 8192)
# its hd-256 cases: (B, S, T, H, KV, dtype, causal, window).  The hd256
# route's tiles: 64 keys and 64-row query steps in dK / dV, 128 rows and
# 32-key steps in dQ; S and T one short of, at and one past each, heads
# 16/16 and 8/2, causal and full (S 1 only full: a causal row that sees
# one key has an exact dq of 0), and windows around the 32- and 64-key
# tiles (W 1: every row sees its own key alone, grad_worst)
BWD_HD256_CASES = tuple(
    (1, S, T, *heads, "bfloat16", causal, None)
    for S, T, heads, causal in (
        (1, 31, (16, 16), False), (1, 63, (16, 16), False),
        (31, 31, (8, 2), True), (32, 33, (16, 16), True),
        (33, 32, (8, 2), False), (63, 63, (8, 2), True),
        (63, 64, (16, 16), False), (64, 64, (16, 16), True),
        (64, 65, (8, 2), True), (65, 63, (16, 16), True),
        (65, 129, (8, 2), True), (127, 128, (16, 16), False),
        (127, 129, (8, 2), False), (128, 127, (16, 16), True),
        (128, 128, (8, 2), True), (129, 128, (8, 2), True),
        (129, 127, (16, 16), True))) + tuple(
    (1, 200, 200, *heads, "bfloat16", True, W)
    for W, heads in ((1, (16, 16)), (31, (8, 2)), (32, (16, 16)),
                     (33, (8, 2)), (63, (16, 16)), (64, (8, 2)),
                     (65, (16, 16)))) + (
    (2, 1000, 1100, 16, 16, "bfloat16", True, None),
    (2, 1000, 1100, 8, 2, "bfloat16", False, None),
    (2, 100, 129, 4, 2, "float32", True, None),
    (2, 129, 100, 4, 2, "float32", False, None),
    (2, 300, 310, 4, 2, "float32", True, 65))
# what the hd256 route launches, in order: lse and D, dK / dV, dQ
FLASH_BWD_HD256 = ("flash_bwd_rows_kernel<256>",
                   "flash_bwd_dkdv_wgmma_hd256_kernel",
                   "flash_bwd_dq_wgmma_hd256_kernel")
# ... and the wgmma route under a window
FLASH_BWD_WGMMA_WINDOW = ("flash_bwd_rows_kernel<128>",
                          "flash_bwd_dkdv_wgmma_window_kernel",
                          "flash_bwd_dq_wgmma_window_kernel")


def bwd_case(gen, B, S, T, H, KV, hd, dt, causal, window=None):
    """One backward case of phase 18 (a)'s widened set: the wrapper twice
    (bitwise equal, both launches on the route and, with a window, tagged
    windowed), held to `flash_attention_bwd_plain` in f64 on the same
    inputs under the same window (grad_worst against BWD_ROW_TOL); a window
    of W >= S must give the bits of the call without one."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attn_inputs(gen, B, S, T, H, KV, hd, dt)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    scale = hd ** -0.5
    out, lse = fa._forward(q, k, v, causal, scale, want_lse=True,
                           window=window or 0)
    route = fa.flash_route(q.dtype, hd, backward=True)
    n = fa.FLASH_BWD.launches_by_route.get(route, 0)
    nw = fa.FLASH_BWD.launches_by_tag.get("window", 0)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 scale=scale, window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   scale=scale, window=window)
    torch.cuda.synchronize()
    what = (f"B {B}, S {S}, T {T}, H {H}, KV {KV}, hd {hd}, {dt}, "
            f"{'causal' if causal else 'full'}, window {window}, route "
            f"{route}")
    check(fa.FLASH_BWD.launches_by_route.get(route, 0) == n + 2 and
          fa.FLASH_BWD.launches_by_tag.get("window", 0) ==
          nw + (2 if window else 0),
          f"flash_attention_bwd at {what} missed its route or window tag")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    no_window = None
    if window is not None and window >= S:
        plain_out, plain_lse = fa._forward(q, k, v, causal, scale,
                                           want_lse=True)
        no_window = (torch.equal(plain_out, out) and torch.equal(plain_lse, lse)
                     and all(torch.equal(a, b) for a, b in zip(
                         got, fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                     causal=causal,
                                                     scale=scale))))
        del plain_out, plain_lse
    x64 = [t.double() for t in (q, k, v, out, lse, dout)]
    want = fa.flash_attention_bwd_plain(*x64, causal=causal, scale=scale,
                                        window=window)
    del x64
    errs = grad_errs(got, want)
    worst = grad_worst(got, want, window == 1 or T == 1)
    abs_err = max((g.double() - w).abs().max().item()
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = BWD_ROW_TOL[dt]
    ok = finite and same and worst <= tol and no_window is not False
    print(f"[long-train] flash_attention_bwd {what}: against the plain "
          f"backward in f64 on the same inputs {json.dumps(errs)}, worst "
          f"{worst:.3e} (row tol {tol:g}{'; every row sees one key: dq, dk '
          'held to 0' if window == 1 or T == 1 else ''}), max|err| "
          f"{abs_err:.3e}; two calls bitwise equal: {same}"
          + ("" if no_window is None else
             f"; bitwise the call without a window: {no_window}")
          + f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"flash_attention_bwd at {what} misses its contract")
    del q, k, v, dout, out, lse, got, want
    return {"case": what, "route": route, "window": window, "errs": errs,
            "max_row_err": worst, "max_abs_err": abs_err}


def bwd_plain_by_head(q, k, v, out, lse, dout, *, causal, scale, window):
    """`flash_attention_bwd_plain` one query head at a time (dk, dv summed
    over each KV head's group in head order, as the plain version sums
    them): the same function where one KV group's (S, T) f32 scores do not
    fit the card."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    dq = torch.empty_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for h in range(H):
        kh = h // G
        g = fa.flash_attention_bwd_plain(
            q[:, :, h:h + 1].float(), k[:, :, kh:kh + 1].float(),
            v[:, :, kh:kh + 1].float(), out[:, :, h:h + 1].float(),
            lse[:, h:h + 1], dout[:, :, h:h + 1].float(), causal=causal,
            scale=scale, window=window)
        dq[:, :, h:h + 1] = g[0]
        dk[:, :, kh:kh + 1] += g[1]
        dv[:, :, kh:kh + 1] += g[2]
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def bwd_rows_f64(q, k, v, out, lse, dout, *, scale, window, qrows, krows):
    """`flash_attention_bwd_plain` in f64 under the causal mask (and
    `window`), at the query rows `qrows` of dq and the key rows `krows` of
    dk and dv only: (dq[:, qrows], dk[:, krows], dv[:, krows]), every head.
    Each sampled row is the whole sum the plain version takes for it (dq
    over every key, dk and dv over every query and the G heads of the
    group), one KV head's group at a time: the f64 check where a group's
    (S, T) scores do not fit the card."""
    import torch
    S, H = q.shape[1], q.shape[2]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device

    def keep(srow, tcol):
        m = tcol[None, :] <= srow[:, None]
        return m if window is None else m & (tcol[None, :] > srow[:, None]
                                             - window)

    kq = keep(qrows, torch.arange(T, device=dev))
    kk = keep(torch.arange(S, device=dev), krows)
    dsum = torch.einsum("bshd,bshd->bhs", dout.double(), out.double())
    dqs, dks, dvs = [], [], []
    for h in range(KV):
        grp = slice(h * G, (h + 1) * G)
        kh, vh = k[:, :, h].double(), v[:, :, h].double()
        qg, dog = q[:, qrows, grp].double(), dout[:, qrows, grp].double()
        p = torch.exp(torch.einsum("bsgd,btd->bgst", qg, kh) * scale
                      - lse[:, grp][:, :, qrows, None].double())
        p = torch.where(kq, p, 0.0)
        dp = torch.einsum("bsgd,btd->bgst", dog, vh)
        ds = p * (dp - dsum[:, grp][:, :, qrows, None])
        dqs.append(scale * torch.einsum("bgst,btd->bsgd", ds, kh))
        del qg, dog, p, dp, ds
        qa, doa = q[:, :, grp].double(), dout[:, :, grp].double()
        kc, vc = kh[:, krows], vh[:, krows]
        p = torch.exp(torch.einsum("bsgd,btd->bgst", qa, kc) * scale
                      - lse[:, grp, :, None].double())
        p = torch.where(kk, p, 0.0)
        dvs.append(torch.einsum("bgst,bsgd->btd", p, doa))
        dp = torch.einsum("bsgd,btd->bgst", doa, vc)
        ds = p * (dp - dsum[:, grp, :, None])
        dks.append(scale * torch.einsum("bgst,bsgd->btd", ds, qa))
        del qa, doa, p, dp, ds, kh, vh
    return (torch.cat(dqs, dim=2), torch.stack(dks, dim=2),
            torch.stack(dvs, dim=2))


def edge_rows(gen, S: int, window, n: int):
    """n rows of 0..S-1 drawn from `gen`, with the rows at the sequence's
    ends, at the 64- and 128-row tiles' first edges and, under a window W,
    around W and S - W (where the window's lower edge enters and leaves a
    tile), sorted and unique: the rows a sampled check must not miss."""
    import torch
    fixed = [0, 1, 63, 64, 65, 127, 128, S - 65, S - 64, S - 2, S - 1]
    if window is not None:
        fixed += [window - 1, window, window + 1, S - window - 1,
                  S - window, S - window + 1]
    drawn = torch.randperm(S, generator=gen, device=gen.device)[:n]
    rows = torch.cat([drawn, torch.tensor([r for r in fixed if 0 <= r < S],
                                          device=gen.device)])
    return torch.unique(rows)


def bwd_timing(gen, B, S, H, KV, hd, window, names):
    """The backward at (B, S, S, H, KV, hd) bf16 causal under `window`,
    the shape a main path gives it: first held to the plain backward in f64
    on the same inputs (grad_worst against BWD_ROW_TOL) -- all of it
    without a window; under one, where a KV group's f64 scores would take
    69 GB at 32768 tokens, F64_ROWS sampled rows of dq and of dk / dv
    (`edge_rows`, `bwd_rows_f64`), each row's largest value floored at
    BWD_ROW_FLOOR of the sampled rows' largest.  Then device ms: the C
    entry point (its outputs must be the checked call's bits), the
    wrapper, the plain version (one query head at a time under a window: a
    KV group's f32 scores would take 34 GB at 32768 tokens), SDPA's
    backward (its forward and backward less its forward: is_causal, or
    under a window the band as a bool mask with K and V repeated per query
    head, the memory-efficient kernel; where the card does not take the
    call the line says so), the bound, and the kernels' split by
    torch.profiler (which must name `names`)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attn_inputs(gen, B, S, S, H, KV, hd, "bfloat16")
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    scale = hd ** -0.5
    out, lse = fa._forward(q, k, v, True, scale, want_lse=True,
                           window=window or 0)
    route = fa.flash_route(q.dtype, hd, backward=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                 scale=scale, window=window)
    what = (f"B {B}, S {S}, T {S}, H {H}, KV {KV}, hd {hd}, bfloat16, "
            f"causal, window {window}, route {route}")
    if window:
        qrows = edge_rows(gen, S, window, F64_ROWS)
        krows = edge_rows(gen, S, window, F64_ROWS)
        want = bwd_rows_f64(q, k, v, out, lse, dout, scale=scale,
                            window=window, qrows=qrows, krows=krows)
        held = (got[0][:, qrows], got[1][:, krows], got[2][:, krows])
        checked = (f"{len(qrows)} dq rows and {len(krows)} dk / dv rows of "
                   f"every head (bwd_rows_f64)")
    else:
        want = fa.flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, out, lse, dout)), causal=True,
            scale=scale)
        held = got
        checked = "every row (flash_attention_bwd_plain in f64)"
    errs = grad_errs(held, want)
    worst = grad_worst(held, want, False)
    abs_err = max((g.double() - w).abs().max().item()
                  for g, w in zip(held, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del want, held
    tol = BWD_ROW_TOL["bfloat16"]
    print(f"[long-train] flash_attention_bwd {what}: against the plain "
          f"backward in f64 on the same inputs, {checked}: "
          f"{json.dumps(errs)}, worst {worst:.3e} (row tol {tol:g}), "
          f"max|err| {abs_err:.3e} "
          f"{'ok' if finite and worst <= tol else 'MISMATCH'}")
    check(finite and worst <= tol,
          f"flash_attention_bwd at {what} misses its contract")
    outs = [torch.empty_like(t) for t in (q, k, v)]
    dsum = fa.flash_bwd_scratch(B, H, S, q.device)

    def kernel(i):
        fa.FLASH_BWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                     *(t.data_ptr() for t in outs), dsum.data_ptr(), B, S, S,
                     H, KV, hd, fa.DTYPES[q.dtype], 1, scale,
                     fa.ROUTES[route], window or 0)

    if window:
        bound, by = attn_window_bwd_bound(B, S, H, KV, hd, "bfloat16", window)
        plain = bwd_plain_by_head
        plain_name = ("flash_attention_bwd_plain, one query head at a time "
                      "(bwd_plain_by_head)")
    else:
        bound, by = attn_bwd_bound(B, S, S, H, KV, hd, "bfloat16", True)
        plain = fa.flash_attention_bwd_plain
        plain_name = "flash_attention_bwd_plain"
    row = {"B": B, "S": S, "T": S, "H": H, "KV": KV, "hd": hd,
           "dtype": "bfloat16", "causal": True, "window": window,
           "route": route, "checked": checked, "errs": errs,
           "max_row_err": worst, "max_abs_err": abs_err,
           "ms": device_ms(kernel, 5),
           "wrapper_ms": device_ms(lambda i: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, causal=True, scale=scale,
               window=window), 5),
           "plain": plain_name,
           "plain_ms": cuda_ms(lambda i: plain(
               q, k, v, out, lse, dout, causal=True, scale=scale,
               window=window), 1, warmup=1),
           "bound_ms": bound, "bound_by": by,
           "kernel_ms": kernel_split_ms(kernel, 3, names)}
    check(all(row["kernel_ms"].get(n, 0.0) > 0.0 for n in names),
          f"the profiler's split of the backward {row['kernel_ms']} lacks a "
          f"kernel of {names}")
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs, got))
    print(f"[long-train] flash_attention_bwd {what}: the timed launches' "
          f"output equals the checked call's bit for bit: {same}")
    check(same, f"flash_attention_bwd at {what}: two calls differ")
    row["timed_bits_as_checked"] = same
    del got
    qh = q.transpose(1, 2).contiguous().requires_grad_(True)
    rep = 1 if window is None else H // KV
    kh, vh = (t.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
              .requires_grad_(True) for t in (k, v))
    doh = dout.transpose(1, 2).contiguous()
    kw = {"is_causal": True}
    ctx = contextlib.nullcontext()
    if window:
        pos = torch.arange(S, device="cuda")
        kw = {"attn_mask": (pos[None, :] <= pos[:, None])
              & (pos[None, :] > pos[:, None] - window)}
        ctx = sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)
        row["library"] = ("autograd.grad of F.scaled_dot_product_attention, "
                          "memory-efficient kernel, the band as a bool mask, "
                          "K and V repeated per query head, less its forward")
    else:
        row["library"] = ("autograd.grad of F.scaled_dot_product_attention("
                          "is_causal=True) less its forward")

    def sdpa(i):
        o = F.scaled_dot_product_attention(qh, kh, vh, **kw)
        torch.autograd.grad(o, (qh, kh, vh), doh)

    def sdpa_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, **kw)

    try:
        with ctx:
            fb, fwd = device_ms(sdpa, 3), device_ms(sdpa_fwd, 3)
        row.update(library_ms=fb - fwd, library_fwd_bwd_ms=fb,
                   library_fwd_ms=fwd)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        row["library_ms"] = None
        row["library_note"] = f"did not run: {str(e).splitlines()[0][:200]}"
    print(f"[long-train] timing {json.dumps(row)}")
    del q, k, v, dout, out, lse, outs, dsum, qh, kh, vh, doh, kw
    torch.cuda.empty_cache()
    return row


def flash_bwd_check(seed: int):
    """(a) The backward kernels on the card against
    `flash_attention_bwd_plain` in f64 on the same inputs (the contract),
    at the Yi-9B shape of an 8192-token sequence (bf16, causal: the wgmma
    route), a ragged bf16 one at hd 64 with G = 4 (mma_sync, after the
    hd64 forward whose out and lse it reads) and ragged
    f32 ones at hd 64 with H == KV (fma); the error against the exact
    gradient (f64 attention's own out and lse) printed beside it; two calls
    bitwise equal; the forward's out bitwise the same with and without lse;
    then the backward's device time at the Yi-9B shape (the wgmma route)
    beside its bound, its plain version and SDPA's backward, and its
    kernels' parts of it (lse and D, dK / dV, dQ) by torch.profiler."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import LONG_CONTEXT_WINDOW
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    res = {"cases": []}
    for B, S, T, H, KV, hd, dt, causal in (
            (1, LONG_S, LONG_S, 32, 4, 128, "bfloat16", True),
            (2, 1000, 1100, 8, 2, 64, "bfloat16", True),
            (2, 1000, 1100, 4, 4, 64, "float32", True),
            (2, 1000, 1100, 4, 4, 64, "float32", False)):
        q, k, v = attn_inputs(gen, B, S, T, H, KV, hd, dt)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        scale = hd ** -0.5
        what = (f"B {B}, S {S}, T {T}, H {H}, KV {KV}, hd {hd}, {dt}, "
                f"{'causal' if causal else 'full'}")
        out, lse = fa._forward(q, k, v, causal, scale, want_lse=True)
        same_out = torch.equal(out, fa.flash_attention(q, k, v, causal=causal,
                                                       scale=scale))
        route = fa.flash_route(q.dtype, hd, backward=True)
        n = fa.FLASH_BWD.launches_by_route.get(route, 0)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                     scale=scale)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale)
        torch.cuda.synchronize()
        check(fa.FLASH_BWD.launches_by_route.get(route, 0) == n + 2,
              f"flash_attention_bwd at {what} missed route {route}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        x64 = [t.double() for t in (q, k, v, out, lse, dout)]
        want = fa.flash_attention_bwd_plain(*x64, causal=causal, scale=scale)
        errs = grad_errs(got, want)
        abs_err = max((g.double() - w).abs().max().item()
                      for g, w in zip(got, want))
        del want
        o64, l64 = fa.flash_attention_plain(*x64[:3], causal=causal,
                                            scale=scale, return_lse=True)
        lse_err = (lse.double() - l64).abs().max().item()
        exact = fa.flash_attention_bwd_plain(*x64[:3], o64, l64, x64[5],
                                             causal=causal, scale=scale)
        exact_errs = grad_errs(got, exact)
        del x64, o64, l64, exact
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        tol = BWD_ROW_TOL[dt]
        worst = max(e["row"] for e in errs.values())
        ok = (finite and same and same_out and lse_err <= LSE_TOL
              and worst <= tol)
        print(f"[long-train] flash_attention_bwd {what}, route {route} "
              f"(the forward's {fa.flash_route(q.dtype, hd)}): "
              f"against the plain backward in f64 on the same inputs "
              f"{json.dumps(errs)} (row tol {tol:g}), max|err| "
              f"{abs_err:.3e}; against the exact gradient (f64 attention's "
              f"out and lse) {json.dumps(exact_errs)}; lse max|err| "
              f"{lse_err:.3e} (tol {LSE_TOL:g}); two calls bitwise equal: "
              f"{same}; out with and without lse bitwise equal: {same_out} "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"flash_attention_bwd at {what} misses its contract")
        res["cases"].append({"case": what, "route": route, "errs": errs,
                             "exact_errs": exact_errs, "max_row_err": worst,
                             "max_abs_err": abs_err, "lse_err": lse_err})
        if S == LONG_S:
            res["main"] = res["cases"][-1]
        torch.cuda.empty_cache()
        if S != LONG_S:
            continue
        # device times at the Yi-9B shape
        outs = [torch.empty_like(t) for t in (q, k, v)]
        dsum = fa.flash_bwd_scratch(B, H, S, q.device)

        def kernel(i, q=q, k=k, v=v, out=out, lse=lse, dout=dout, outs=outs,
                   dsum=dsum, route=route):
            fa.FLASH_BWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                         *(t.data_ptr() for t in outs), dsum.data_ptr(), B, S,
                         T, H, KV, hd, fa.DTYPES[q.dtype], int(causal), scale,
                         fa.ROUTES[route], 0)

        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        doh = dout.transpose(1, 2).contiguous()

        def sdpa(i):
            o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                               enable_gqa=True)
            torch.autograd.grad(o, (qh, kh, vh), doh)

        def sdpa_fwd(i):
            with torch.no_grad():
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                               enable_gqa=True)

        bound, by = attn_bwd_bound(B, S, T, H, KV, hd, dt, causal)
        fb, fwd = device_ms(sdpa, 5), device_ms(sdpa_fwd, 5)
        row = {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd,
               "dtype": dt, "causal": causal, "route": route,
               "ms": device_ms(kernel, 5),
               "wrapper_ms": device_ms(lambda i: fa.flash_attention_bwd(
                   q, k, v, out, lse, dout, causal=causal, scale=scale), 5),
               "plain_ms": cuda_ms(lambda i: fa.flash_attention_bwd_plain(
                   q, k, v, out, lse, dout, causal=causal, scale=scale), 2,
                   warmup=1),
               "library_ms": fb - fwd, "library_fwd_bwd_ms": fb,
               "library_fwd_ms": fwd, "bound_ms": bound, "bound_by": by,
               "kernel_ms": kernel_split_ms(kernel, 3, FLASH_BWD_WGMMA)}
        split = row["kernel_ms"]
        check(route == "wgmma" and all(split.get(n, 0.0) > 0.0
                                       for n in FLASH_BWD_WGMMA),
              f"the profiler's split of the backward {split} lacks a kernel "
              f"of {FLASH_BWD_WGMMA}")
        print(f"[long-train] timing {json.dumps(row)}")
        res["timing"] = row
        del outs, dsum, qh, kh, vh, doh
    torch.cuda.empty_cache()
    # the widened backward: a window on every route, and hd 256
    for H, KV, hd, dt in BWD_WINDOW_ROUTES:
        for W in BWD_WINDOWS:
            res["cases"].append(bwd_case(gen, 2, 1000, 1100, H, KV, hd, dt,
                                         True, W))
    for B, S, T, H, KV, dt, causal, W in BWD_HD256_CASES:
        res["cases"].append(bwd_case(gen, B, S, T, H, KV, 256, dt, causal, W))
    torch.cuda.empty_cache()
    res["hd256_timing"] = bwd_timing(gen, 1, LONG_S, 16, 16, 256, None,
                                     FLASH_BWD_HD256)
    res["window_timing"] = bwd_timing(gen, 1, WINDOW_S, 32, 4, 128,
                                      LONG_CONTEXT_WINDOW,
                                      FLASH_BWD_WGMMA_WINDOW)
    return res


def first_layers(tree, n: int):
    """Every leaf of a layer-stacked tree cut to its first n layers (views)."""
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def long_grad_parity(cfg, params, seed: int, S: int = LONG_S, window=None,
                     tag: str = "[long-train]"):
    """(b) an arch at full width, 2 layers, one S-token sequence in bf16:
    the flat LoRA gradient of `loss_fn(window=)` through the flash kernels,
    and the same with `chunked_attention` (plain torch on the card,
    differentiated by autograd) put in the kernel's place on the attention
    module; launches on the route of the arch's head size (and, under a
    window, every one tagged windowed)."""
    import torch
    from repro_torch.core.fedround import FlatMeta
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    from repro_torch.models import model as mdl
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.lora import init_lora

    L = 2
    cfg2 = dataclasses.replace(cfg, num_layers=L)
    p2 = dict(params)
    p2["groups"] = {"g0": first_layers(params["groups"]["g0"], L)}
    lcfg = LoRAConfig(rank=8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    lora = init_lora(cfg2, lcfg, device="cuda", generator=gen)
    for sec in lora["g0"].values():
        for pair in sec.values():
            pair["b"] = 0.01 * torch.randn(pair["b"].shape, generator=gen,
                                           device="cuda")
    meta = FlatMeta.of(lora)
    flat0 = meta.flatten(lora)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")

    def grad():
        f = flat0.clone().requires_grad_(True)
        loss = mdl.loss_fn(p2, cfg2, {"tokens": tokens},
                           lora=meta.unflatten(f), lora_scale=lcfg.scale,
                           window=window)
        (g,) = torch.autograd.grad(loss, f)
        torch.cuda.synchronize()
        return loss.detach(), g

    def chunked(q, k, v, *, causal, scale, window=None):
        return A.chunked_attention(q, k, v, scale, causal=causal,
                                   window=window, cq=cfg.attn_chunk_q,
                                   ckv=cfg.attn_chunk_kv)

    launches = {}
    with counted(launches):
        fa.FLASH.reset()
        fa.FLASH_BWD.reset()
        lk, gk = grad()
        routes = [dict(f.launches_by_route) for f in (fa.FLASH, fa.FLASH_BWD)]
        tags = [dict(f.launches_by_tag) for f in (fa.FLASH, fa.FLASH_BWD)]
    kernel = A.flash_attention
    A.flash_attention = chunked
    torch.cuda.reset_peak_memory_stats()
    try:
        plain_launches = {}
        with counted(plain_launches):
            lp, gp = grad()
    finally:
        A.flash_attention = kernel
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    rel = ((gk - gp).norm() / gp.norm()).item()
    route = fa.flash_route(torch.bfloat16, cfg.hd)
    print(f"{tag} gradient parity, {cfg.name} at full width, {L} layers, "
          f"{S} tokens, window {window}, bf16: loss {lk.item():.6f} (kernels)"
          f" / {lp.item():.6f} (chunked_attention); flat LoRA gradient (p_len "
          f"{meta.p_len}) relative L2 error {rel:.3e} (bound "
          f"{GRAD_REL_L2:g}); flash launches {launches['flash_attention']} "
          f"forward / {launches['flash_attention_bwd']} backward, by route "
          f"{routes}, windowed {tags} (plain path "
          f"{plain_launches['flash_attention']} / "
          f"{plain_launches['flash_attention_bwd']}, peak device memory "
          f"{plain_peak:.2f} GiB)")
    check(launches["flash_attention"] == 2 * L
          and launches["flash_attention_bwd"] == L
          and routes == [{route: 2 * L}, {route: L}]
          and tags == ([{"window": 2 * L}, {"window": L}] if window
                       else [{}, {}]),
          f"gradient parity: kernel launches {launches}, by route {routes}, "
          f"windowed {tags}; expected {2 * L} forward and {L} backward on "
          f"{route}")
    check(plain_launches["flash_attention"] == 0
          and plain_launches["flash_attention_bwd"] == 0,
          "gradient parity: the plain path launched a flash kernel")
    check(bool(torch.isfinite(gk).all()) and gk.norm().item() > 0,
          "gradient parity: the kernels' gradient is not finite or is zero")
    check(rel <= GRAD_REL_L2, f"gradient parity: relative L2 error {rel:.3e}"
          f" above {GRAD_REL_L2:g}")
    del gk, gp, flat0, lora, p2
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "p_len": meta.p_len, "S": S, "window": window,
            "loss": [lk.item(), lp.item()], "plain_peak_gib": plain_peak}


def long_token_batches(cfg, seed: int, clients: int, S: int):
    """data(r): random tokens (clients, 1, 1, S) drawn on the card."""
    import torch

    def data(r):
        gen = torch.Generator(device="cuda").manual_seed(
            1_000_003 * seed + 7919 * S + r)
        return {"tokens": torch.randint(0, cfg.vocab_size, (clients, 1, 1, S),
                                        generator=gen, device="cuda")}
    return data


def long_train_runs(cfg, params, seed: int, runs=LONG_TRAIN,
                    tag: str = "[long-train]"):
    """(c) `Experiment(None)` on a full arch: FLASC (fused, 4-bit up,
    density 0.25 / 0.25, rank 8) with one local step of one sequence a
    client, each (tokens, clients, rounds) of `runs` (Yi-9B: 2 rounds of 2
    clients at 8192 tokens, then 1 round of 1 client at 32768); launches
    asserted, every flash launch on the route of the arch's head size."""
    import numpy as np
    import torch
    from repro_torch.federated import Experiment
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import FederatedConfig

    L = cfg.num_layers
    route = fa.flash_route(torch.bfloat16, cfg.hd)
    out = {}
    for S, C, R in runs:
        probe = RoundProbe()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        exp = (Experiment(None, federation=FederatedConfig(n_clients=C,
                                                           **LONG_FED))
               .with_strategy("flasc", selector="fused", quant_bits_up=4,
                              density_down=0.25, density_up=0.25)
               .with_lora(rank=8)
               .with_training(rounds=R, seed=seed)
               .with_params(params, cfg)
               .with_data(long_token_batches(cfg, seed, C, S))
               .with_engine("sim")
               .with_callbacks(probe))
        launches = {}
        with counted(launches):
            fa.FLASH.reset()
            fa.FLASH_BWD.reset()
            probe.t = [time.perf_counter()]
            res = exp.run()
            routes = {"flash_attention": dict(fa.FLASH.launches_by_route),
                      "flash_attention_bwd":
                          dict(fa.FLASH_BWD.launches_by_route)}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = C * R                    # one local step a client a round
        round_ms = [1e3 * (b - a) for a, b in zip(probe.t, probe.t[1:])]
        step_ms = [h["phase_ms"]["local_update"] / C for h in res.history]
        losses = [h["loss"] for h in res.history]
        for r, h in enumerate(res.history):
            print(f"{tag} {S} tokens, round {r}: loss {h['loss']:.6f}, "
                  f"wall {round_ms[r]:.3f} ms; local update "
                  f"{step_ms[r]:.3f} ms a client step (device events); up_nnz "
                  f"per client {probe.up_nnz[r]}")
        print(f"{tag} {cfg.name} {L}L d{cfg.d_model} {cfg.param_dtype}"
              f": {R} FLASC round(s) of {C} client(s) x 1 step x 1 x {S} "
              f"tokens (fused, 4-bit up, density 0.25/0.25, rank 8); peak "
              f"device memory {peak:.3f} GiB; launches {json.dumps(launches)}"
              f", by route {json.dumps(routes)}; {card_line()}")
        check(len(res.history) == R and all(np.isfinite(x) for x in losses),
              f"long-train {S}: losses {losses}")
        want = {"flash_attention": 2 * L * steps,
                "flash_attention_bwd": L * steps,
                **{k: v * R for k, v in FUSED_PER_ROUND.items()}}
        for name, n in want.items():
            check(launches[name] == n, f"long-train {S}: {name} launched "
                  f"{launches[name]} times, expected {n}")
        check(routes == {"flash_attention": {route: 2 * L * steps},
                         "flash_attention_bwd": {route: L * steps}},
              f"long-train {S}: flash launches by route {routes}")
        out[S] = {"clients": C, "rounds": R, "round_ms": round_ms,
                  "step_ms": step_ms, "losses": losses, "peak_gib": peak,
                  "launches": launches, "routes": routes}
        del exp, res, probe
        gc.collect()
        torch.cuda.empty_cache()
    return out


def profile_long_step(cfg, params, seed: int) -> dict:
    """(d) torch.profiler over one 8192-token client step of full Yi-9B
    (the loss and its LoRA gradient, as `_client_update` takes them), after
    one unprofiled step: device busy share, GEMM, flash forward and
    backward ms and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fedround import FlatMeta
    from repro_torch.models import model as mdl
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.lora import init_lora

    lcfg = LoRAConfig(rank=8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    lora = init_lora(cfg, lcfg, device="cuda", generator=gen)
    meta = FlatMeta.of(lora)
    flat0 = meta.flatten(lora)
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_S), generator=gen,
                           device="cuda")

    def step():
        f = flat0.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = mdl.loss_fn(params, cfg, {"tokens": tokens},
                               lora=meta.unflatten(f), lora_scale=lcfg.scale)
            (g,) = torch.autograd.grad(loss, f)
        return g

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    stats = summarize_trace(prof, "long_train_step_trace.json",
                            f"1 client step of {LONG_S} tokens", 1, wall_ms)
    parts = {"gemm": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0, "rest": 0.0}
    for name, (us, _) in stats["by_name"].items():
        key = ("flash_bwd" if "flash_bwd_" in name else
               "flash_fwd" if "flash_" in name and "_kernel" in name else
               "gemm" if GEMM_NAME.search(name) else "rest")
        parts[key] += us / 1e3
    out = {"wall_ms": wall_ms, "busy_ms": stats["busy_ms"],
           "busy_share": stats["busy_ms"] / wall_ms, **{
               f"{k}_ms": v for k, v in parts.items()}}
    print(f"[long-train] profiled client step: {json.dumps(out)}")
    return out


# (e): one sequence of WINDOW_S tokens under the long-context window at full
# depth, and the 2-layer parity at the longest sequence where
# chunked_attention's autograd fits the card beside the backbone: 8192
# tokens under a window of 4096 (a row's window spans 64 key tiles).  The
# chunked stand-in skips the score chunks outside the window only up to 8
# query chunks (the reference's branch): at 8192 it keeps 30 of 1024 x 1024
# (36 without a window: 33.6 GiB at its peak), while at 12288 under 4096 it
# computes all 144 and ran out of the card's 80 GB
WINDOW_PARITY = (LONG_S, 4096)


def long_window_grad(cfg, params, seed: int):
    """(e) the LoRA gradient of `loss_fn(window=LONG_CONTEXT_WINDOW)` of one
    WINDOW_S-token sequence through full Yi-9B: every flash launch windowed
    on the wgmma route (2 L forward with the recomputation, L backward),
    the gradient finite and nonzero; its ms and peak memory printed.  Then
    long_grad_parity on a 2-layer cut under WINDOW_PARITY."""
    import torch
    from repro_torch.configs.registry import LONG_CONTEXT_WINDOW as W
    from repro_torch.core.fedround import FlatMeta
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as mdl
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.lora import init_lora

    L = cfg.num_layers
    lcfg = LoRAConfig(rank=8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    lora = init_lora(cfg, lcfg, device="cuda", generator=gen)
    meta = FlatMeta.of(lora)
    flat = meta.flatten(lora).requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, WINDOW_S), generator=gen,
                           device="cuda")
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(launches):
        fa.FLASH.reset()
        fa.FLASH_BWD.reset()
        t0 = time.perf_counter()
        loss = mdl.loss_fn(params, cfg, {"tokens": tokens},
                           lora=meta.unflatten(flat), lora_scale=lcfg.scale,
                           window=W)
        (g,) = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        routes = [dict(f.launches_by_route) for f in (fa.FLASH, fa.FLASH_BWD)]
        tags = [dict(f.launches_by_tag) for f in (fa.FLASH, fa.FLASH_BWD)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(g).all()) and g.norm().item() > 0
    print(f"[long-train] windowed gradient, {cfg.name} {L}L d{cfg.d_model} "
          f"bf16: one {WINDOW_S}-token sequence, loss_fn(window={W}) "
          f"{loss.item():.6f} and its LoRA gradient (p_len {meta.p_len}) in "
          f"{ms:.3f} ms; peak device memory {peak:.3f} GiB; flash launches "
          f"{launches['flash_attention']} forward / "
          f"{launches['flash_attention_bwd']} backward, by route {routes}, "
          f"windowed {tags}; gradient finite and nonzero: {finite}; "
          f"{card_line()}")
    check(routes == [{"wgmma": 2 * L}, {"wgmma": L}]
          and tags == [{"window": 2 * L}, {"window": L}],
          f"windowed gradient: flash launches by route {routes}, windowed "
          f"{tags}; expected {2 * L} forward and {L} backward, all windowed "
          "on wgmma")
    check(finite, "windowed gradient: not finite or zero")
    del loss, g, flat, lora, tokens
    gc.collect()
    torch.cuda.empty_cache()
    S, W2 = WINDOW_PARITY
    parity = long_grad_parity(cfg, params, seed, S=S, window=W2)
    return {"ms": ms, "peak_gib": peak, "window": W, "tokens": WINDOW_S,
            "launches": launches, "routes": routes, "windowed": tags,
            "parity": parity}


def long_train_phase(seed: int, profile: bool = False):
    """Phase 18: (a) the backward kernels against their plain version; (b)
    the model's LoRA gradient through them against chunked_attention's; (c)
    FLASC rounds of full Yi-9B at 8192 and 32768 tokens a sequence through
    `Experiment(None)`; (d) under --profile, one profiled client step; (e)
    a windowed gradient at 32768 tokens."""
    import torch
    kern = flash_bwd_check(seed)
    t0 = time.perf_counter()
    cfg, params = yi_backbone(seed)
    torch.cuda.synchronize()
    print(f"[long-train] backbone built in {time.perf_counter() - t0:.1f}s")
    parity = long_grad_parity(cfg, params, seed)
    runs = long_train_runs(cfg, params, seed)
    prof = profile_long_step(cfg, params, seed) if profile else None
    window = long_window_grad(cfg, params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel": kern, "parity": parity, "runs": runs, "profile": prof,
            "window": window}


# ---------------------------------------------------------------------------
# phase 21: gemma-7b trains at 8192 tokens (the hd-256 backward)
# ---------------------------------------------------------------------------

GEMMA_TRAIN = ((LONG_S, 2, 2),)                 # (tokens, clients, rounds)


def gemma_train_phase(seed: int):
    """Phase 21: gemma-7b at full width and depth in bf16 (hd 256, MHA, tied
    256,000 vocab): (a) phase 18 (b)'s gradient parity on a 2-layer cut at
    8192 tokens (hd256 launches); (b) phase 18 (c)'s FLASC rounds through
    `Experiment(None)`, 2 rounds of 2 clients at 8192 tokens, 56 hd256
    forward and 28 hd256 backward launches a client step."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.models.layers import init_params

    tag = "[gemma-train]"
    t0 = time.perf_counter()
    cfg = get_config("gemma-7b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    params = init_params(mdl.model_spec(cfg), device="cuda", generator=gen)
    torch.cuda.synchronize()
    print(f"{tag} {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads hd {cfg.hd}, "
          f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.3f} B params, built "
          f"in {time.perf_counter() - t0:.1f}s")
    parity = long_grad_parity(cfg, params, seed, tag=tag)
    runs = long_train_runs(cfg, params, seed, GEMMA_TRAIN, tag=tag)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"parity": parity, "runs": runs, "layers": cfg.num_layers}


# ---------------------------------------------------------------------------
# phase 22: GPT-2 Small serves (learned positions)
# ---------------------------------------------------------------------------

GPT_SERVE_LEN = 1024           # max_len: GPT-2 Small's learned positions
GPT_BUCKETS = (16, 1000)


def gpt_engine(cfg, seed: int):
    """`launch/serve.py`'s build at phase 3's settings with GPT-2 Small's
    config in place of a registry arch (the CLI resolves registry archs
    only) and max_len GPT_SERVE_LEN; its trace re-drawn with prompts from
    GPT_BUCKETS."""
    from repro_torch.launch import serve
    from repro_torch.serving import synth_trace
    args = serve.parse_args(SERVE_ARGS + ["--seed", str(seed), "--max-len",
                                          str(GPT_SERVE_LEN)])
    eng, trace, _, lcfg = serve.build(args, cfg=cfg)
    trace = synth_trace(args.requests, args.clients, cfg.vocab_size,
                        seed=seed, prompt_buckets=GPT_BUCKETS,
                        gen_range=(4, 12))
    return eng, trace, lcfg


def forward_greedy_vs_engine(eng, trace, rep, cfg, lcfg, tag: str) -> int:
    """Each request of a serving run against a greedy loop over the port's
    `forward` on the whole sequence with the request's adapter alone (the
    reference's decode adds position 0's embedding to every token; its
    forward each token's own): completions must match, except where the
    loop's top-2 logit gap is below GAP_TOL (each printed).  Returns the
    number of near ties."""
    import torch
    from repro_torch.checkpoint.io import tree_from_numpy
    from repro_torch.models import model as mdl

    check(len(rep.completions) == len(trace), f"{tag} engine dropped requests")
    near_ties = 0
    with torch.no_grad():
        for req in trace:
            lt = tree_from_numpy(eng.cache.store.get(req.client),
                                 device="cuda")
            seq, want, gaps = list(req.prompt), [], []
            while len(want) < req.gen_len:
                lg = mdl.forward(eng.params, cfg, {"tokens": torch.tensor(
                    [seq], device="cuda")}, lora=lt,
                    lora_scale=lcfg.scale)["logits"][0, -1].float()
                top2 = torch.topk(lg, 2).values
                gaps.append((top2[0] - top2[1]).item())
                want.append(int(torch.argmax(lg)))
                seq.append(want[-1])
            got = rep.completions[req.rid]
            if got != want:
                t = next(i for i, (p, q) in enumerate(zip(got, want)) if p != q)
                print(f"{tag} request {req.rid} differs at token {t}: engine "
                      f"{got[t]} vs forward {want[t]}, top-2 gap "
                      f"{gaps[t]:.3e}")
                check(gaps[t] < GAP_TOL,
                      f"request {req.rid}: engine and forward disagree at a "
                      f"top-2 gap of {gaps[t]:.3e} >= {GAP_TOL}")
                near_ties += 1
    return near_ties


def gpt_serve_phase(seed: int):
    """Phase 22: GPT-2 Small (12 layers, d 768, vocab 50,257, tied, 1,024
    learned positions) at full width and depth in bf16 through
    `ServingEngine` with phase 3's tenants, pages, lanes and rank: prompts
    of 16 or 1000 tokens, 4-12 generated, max_len 1024.  The grouped
    kernel's launches must equal decode steps x 12 x its projections a
    layer; prints decode ms a step, tok/s and one 1000-token prefill's ms.
    Then a 2-layer f32 cut against a greedy loop over `forward`
    (forward_greedy_vs_engine)."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_models import GPT2_SMALL
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel

    tag = "[gpt-serve]"
    grouped = resolve_grouped_kernel("grouped_pallas")
    cfg = GPT2_SMALL                                        # bf16
    t0 = time.perf_counter()
    eng, trace, lcfg = gpt_engine(cfg, seed)
    torch.cuda.synchronize()
    print(f"{tag} {cfg.name}: {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype}, {cfg.param_count() / 1e6:.3f} M params, "
          f"learned positions {cfg.max_seq}, built in "
          f"{time.perf_counter() - t0:.1f}s; prompts {GPT_BUCKETS}, max_len "
          f"{eng.max_len}")
    torch.cuda.reset_peak_memory_stats()
    grouped.launches = 0
    rep = eng.run(trace)
    launches = grouped.launches
    n_targets = len(eng.cache.pool["g0"]["attn"])
    decode_ms = 1e3 * rep.decode_s / max(rep.steps, 1)
    print(f"{tag} {len(rep.completions)}/{rep.requests} requests served: "
          f"{rep.generated_tokens} tokens in {rep.wall_s:.3f}s "
          f"({rep.tokens_per_s:.2f} tok/s), {rep.steps} decode steps, "
          f"{decode_ms:.3f} ms/decode step, occupancy "
          f"{rep.mean_occupancy:.3f}/{eng.n_lanes} lanes; cache "
          f"{rep.cache['hits']} hits / {rep.cache['misses']} misses; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; grouped_pallas launches {launches} = {rep.steps} steps x "
          f"{cfg.num_layers} x {n_targets}")
    check(len(rep.completions) == len(trace) == rep.requests,
          f"{tag} not every request was served")
    for req in trace:
        toks = rep.completions[req.rid]
        check(len(toks) == req.gen_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"{tag} request {req.rid}: bad completion {toks}")
    check(launches == rep.steps * cfg.num_layers * n_targets > 0,
          f"{tag} grouped_pallas launched {launches} times, expected "
          f"{rep.steps} x {cfg.num_layers} x {n_targets}")
    prompt = np.random.default_rng(seed + 22).integers(
        0, cfg.vocab_size, GPT_BUCKETS[-1]).tolist()
    eng._prefill(0, prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        tok, _ = eng._prefill(0, prompt)
    prefill_ms = 1e3 * (time.perf_counter() - t1)
    print(f"{tag} one {len(prompt)}-token prefill {prefill_ms:.3f} ms "
          f"(after one unmeasured), first token {tok}; {card_line()}")
    res = {"grouped": launches, "steps": rep.steps, "layers": cfg.num_layers,
           "decode_ms": decode_ms, "tok_s": rep.tokens_per_s,
           "prefill_ms": prefill_ms}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(GPT2_SMALL, num_layers=2,
                               param_dtype="float32", compute_dtype="float32")
    eng2, trace2, lcfg2 = gpt_engine(cfg2, seed)
    rep2 = eng2.run(trace2)
    near = forward_greedy_vs_engine(eng2, trace2, rep2, cfg2, lcfg2,
                                    f"{tag} parity")
    print(f"{tag} parity {cfg2.name} 2L d{cfg2.d_model} f32: "
          f"{len(trace2) - near}/{len(trace2)} completions identical to a "
          f"greedy loop over forward, {near} near-tie divergences")
    res["near_ties"] = near
    del eng2
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 23: the recurrent families, hymba-1.5b and xlstm-1.3b
# ---------------------------------------------------------------------------

SCAN_TOL = 1e-4                # |kernel - plain| / max|plain|, y and h_last
# (B, S, di, N, dtype of u, nonzero h0): hymba-1.5b's prefill of 8192
# tokens (one layer), its decode of 8 lanes (u is f32 there), a ragged
# length, one step from zeros, four rows, and a width and state size off
# the 8-channel tiles (the smoke configs' N = 8)
SCAN_CASES = ((1, LONG_S, 3200, 16, "bfloat16", False),
              (1, LONG_S, 3200, 16, "float32", False),
              (8, 1, 3200, 16, "float32", True),
              (8, 1, 3200, 16, "bfloat16", True),
              (1, 300, 3200, 16, "bfloat16", True),
              (1, 1, 3200, 16, "bfloat16", False),
              (4, 1000, 3200, 16, "bfloat16", True),
              (3, 77, 100, 8, "float32", True))


def scan_edge_cases() -> tuple:
    """The chunked scan's edges, as SCAN_CASES, at the kernels' chunk
    length L (`selective_scan.CHUNK`): a step short of one chunk, one
    chunk, a step past it (from h0) and two chunks and three steps; four
    rows of a ragged length over three chunks from h0; N = 8 over three
    chunks off the 128-channel blocks."""
    from repro_torch.kernels.selective_scan import CHUNK as L
    return ((1, L - 1, 3200, 16, "bfloat16", False),
            (1, L, 3200, 16, "bfloat16", False),
            (1, L + 1, 3200, 16, "bfloat16", True),
            (1, 2 * L + 3, 3200, 16, "bfloat16", False),
            (4, 2 * L + 37, 3200, 16, "bfloat16", True),
            (3, 2 * L + 5, 100, 8, "float32", True))


SFU_EX2_PER_CLOCK = 16         # ex2 results an SM's special function units
#                                give a clock (Hopper)
FMA_PER_CLOCK = 128            # f32 results an SM's FMA pipes give a clock
SCAN_FMA_OPS = 4               # FMA-pipe ops a scan element needs besides
#                                its exp: dt*A, (dt*u)*B, h's multiply-add
#                                and h*C's
EX2_POLY_OPS = 4               # FMA-pipe ops of an exp2 computed there
#                                (range reduction and a cubic, as FA3 does;
#                                the exponent goes in on the integer pipe)
HYMBA_BUCKETS = (LONG_S, 32768)
HYMBA_WINDOW_SHAPE = (1, LONG_S, 25, 5, 64, 1024)   # B, S, H, KV, hd, W
XLSTM_PROMPT = 1024
SCAN_MODEL_S = 300             # phase 23 (d): a prefill through the scan
#                                kernel and through the plain scan


def sm_clocks():
    """(max SM clock, current SM clock) in Hz, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    mx, cur = (float(v) * 1e6 for v in out.split(","))
    return mx, cur


def scan_clocks_per_element() -> float:
    """An SM's least clocks for one (b, t, d, n) element of the scan: one
    exp2 and SCAN_FMA_OPS FMA-pipe ops, with a share f of the exps
    computed on the FMA pipes (EX2_POLY_OPS each) so that both pipes
    finish together: (1 - f) / SFU = (c + f p) / FMA, i.e. (c + p) /
    (FMA + p SFU) = 1/24 on Hopper (f = 1/3), against 1/16 for the
    special function units alone."""
    sfu, fma, c, p = (SFU_EX2_PER_CLOCK, FMA_PER_CLOCK, SCAN_FMA_OPS,
                      EX2_POLY_OPS)
    return max(c / fma, min(1 / sfu, (c + p) / (fma + p * sfu)))


def scan_bound(B, S, di, N, dtype, h0: bool, clock_hz: float, sms: int):
    """(bound_ms, bound_by) of one selective scan: u read and y written
    once, Bc, Cc, the five parameter vectors and h0 read, h_last written,
    against B S di N elements, each an exp and its multiply-adds, on the
    special function units and the FMA pipes together
    (`scan_clocks_per_element`) at the card's clock."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (elt * B * S * di + 4 * B * S * di + 4 * 2 * B * S * N
              + 4 * di * (N + 4) + 4 * B * di * N * (2 if h0 else 1))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = B * S * di * N * scan_clocks_per_element() / (sms * clock_hz)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def grouped_decode_shapes(arch: str) -> list:
    """The distinct (K, N) of `arch`'s 2-D LoRA targets at phase 3's rank:
    the shapes its decode steps give the grouped kernel (a headwise (H, hd,
    r) target takes the per-lane gather instead)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import LoRAConfig
    from repro_torch.models.lora import lora_spec
    rank = int(SERVE_ARGS[SERVE_ARGS.index("--rank") + 1])
    shapes = set()

    def walk(t):
        if set(t) == {"a", "b"}:
            if len(t["a"].shape) == 3:             # (layers, K, r)
                shapes.add((t["a"].shape[1], t["b"].shape[2]))
            return
        for v in t.values():
            walk(v)
    walk(lora_spec(get_config(arch), LoRAConfig(rank=rank, alpha=2 * rank)))
    return sorted(shapes)


def grouped_recurrent_phase(seed: int) -> dict:
    """Row 1 at the recurrent archs' decode shapes, before they are served:
    grouped_pallas against grouped_ref at M of 1 and phase 3's 8 lanes and
    every (K, N) of `grouped_decode_shapes`, phase 3's rank and pages, at
    phase 2's RTOL / ATOL, a second launch bitwise equal."""
    import torch
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    kern = resolve_grouped_kernel("grouped_pallas")
    ref = resolve_grouped_kernel("grouped_ref")
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    arg = dict(zip(SERVE_ARGS[::2], SERVE_ARGS[1::2]))
    R, G, lanes = int(arg["--rank"]), int(arg["--pages"]), int(arg["--lanes"])
    res = {"M": [1, lanes], "R": R, "G": G, "shapes": {}, "max_abs_err": 0.0}
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        res["shapes"][arch] = shapes = grouped_decode_shapes(arch)
        for K, N in shapes:
            for M in res["M"]:
                res["max_abs_err"] = max(res["max_abs_err"], grouped_held(
                    kern, ref, gen, M, K, R, N, G, 2.0, tag="[recurrent]"))
    print(f"[recurrent] grouped_pallas at the decode shapes of hymba-1.5b "
          f"and xlstm-1.3b: max|err| {res['max_abs_err']:.3e} (rtol {RTOL:g}, "
          f"atol {ATOL:g})")
    return res


def scan_inputs(gen, B, S, di, N, dtype, h0: bool):
    """u in `dtype`, the rest f32, at the scales of a trained model's
    state: A_log in [-4, 1] (decays over tens to hundreds of steps), dt's
    bias about -1."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = rnd(B, S, di).to(getattr(torch, dtype))
    w_dt = rnd(di, 1) / di ** 0.5
    dt_bias = rnd(di) * 0.5 - 1.0
    A_log = torch.rand((di, N), generator=gen, device="cuda") * 5 - 4
    D_skip = 1 + 0.1 * rnd(di)
    Bc, Cc = rnd(B, S, N), rnd(B, S, N)
    return (u, w_dt, dt_bias, A_log, D_skip, Bc, Cc,
            rnd(B, di, N) if h0 else None)


def scan_launch(args, y, h_last, scratch) -> None:
    """One launch of the scan's C entry point on preallocated outputs: args
    as scan_inputs gives them and the scratch `scan_scratch` sizes (None
    when S <= CHUNK)."""
    from repro_torch.kernels import selective_scan as ss
    u, w_dt, dt_bias, A_log, D_skip, Bc, Cc, h0 = args
    B, S, di = u.shape
    ss.SCAN(u.device, u.data_ptr(), w_dt.data_ptr(), dt_bias.data_ptr(),
            A_log.data_ptr(), D_skip.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, S, di, A_log.shape[-1], ss.DTYPES[u.dtype])


def scan_kernels(dtype: str, N: int = 16) -> tuple:
    """The chunked scan's three kernels, in launch order, as the profiler
    names them, at u's dtype and the state size N."""
    t = "__nv_bfloat16" if dtype == "bfloat16" else "float"
    return (f"selective_scan_chunk_kernel<{N}, {t}>",
            f"selective_scan_carry_kernel<{N}>",
            f"selective_scan_kernel<{N}, {t}>")


def scan_held(gen, B, S, di, N, dtype, h0: bool) -> dict:
    """One case of the scan against its plain version on the same inputs:
    y and h_last within SCAN_TOL of max|plain|, finite, and a second
    call bitwise equal."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    args = scan_inputs(gen, B, S, di, N, dtype, h0)
    (y, h), (y2, h2) = ss.selective_scan(*args), ss.selective_scan(*args)
    yp, hp = ss.selective_scan_plain(*args)
    torch.cuda.synchronize()
    abs_err = max((y - yp).abs().max().item(), (h - hp).abs().max().item())
    ey = ((y - yp).abs().max() / yp.abs().max()).item()
    eh = ((h - hp).abs().max() / hp.abs().max()).item()
    same = torch.equal(y, y2) and torch.equal(h, h2)
    ok = (ey <= SCAN_TOL and eh <= SCAN_TOL and same
          and bool(torch.isfinite(y).all() and torch.isfinite(h).all()))
    what = (f"B {B}, S {S}, di {di}, N {N}, u {dtype}, h0 "
            f"{'nonzero' if h0 else 'none'}, chunk {ss.CHUNK}")
    print(f"[recurrent] selective_scan {what}: y max|err| / max|plain| "
          f"{ey:.3e}, h_last {eh:.3e} (tol {SCAN_TOL:g}), max|y| "
          f"{yp.abs().max().item():.3e}; a second launch bitwise equal: "
          f"{same} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"selective_scan disagrees with its plain version at {what}")
    return {"case": what, "y_err": ey, "h_err": eh, "max_abs_err": abs_err}


def scan_in_place(gen) -> None:
    """Decode's call: h_last written over h0 (out_state=h0), against the
    plain version from a copy of h0, at hymba's 8 lanes in f32."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    args = scan_inputs(gen, 8, 1, 3200, 16, "float32", True)
    h0 = args[-1]
    yp, hp = ss.selective_scan_plain(*args[:-1], h0.clone())
    y, h = ss.selective_scan(*args, out_state=h0)
    torch.cuda.synchronize()
    ok = (h.data_ptr() == h0.data_ptr()
          and (y - yp).abs().max().item() <= SCAN_TOL * yp.abs().max().item()
          and (h - hp).abs().max().item() <= SCAN_TOL * hp.abs().max().item())
    print(f"[recurrent] selective_scan (8, 1, 3200, 16) f32, h_last written "
          f"over h0 (decode): {'ok' if ok else 'MISMATCH'}")
    check(ok, "selective_scan in place over h0 disagrees with its plain "
              "version")


def scan_phase(seed: int) -> dict:
    """(a) Row 11, the selective scan, against its plain version on the
    card at SCAN_CASES and scan_edge_cases (two calls bitwise equal; y and
    h_last within SCAN_TOL of max|plain|) and in place over h0, then timed
    at hymba-1.5b's
    prefill shape in bf16 and f32 beside its bound, the plain version and
    (no PyTorch call computes a selective scan) no library call, with its
    three kernels' parts by torch.profiler."""
    import torch
    from repro_torch.kernels import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    clock, cur = sm_clocks()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[recurrent] SM clock max {clock / 1e6:.0f} MHz, now "
          f"{cur / 1e6:.0f} MHz, {sms} SMs")
    res = {"cases": [], "timings": {}}
    for case in SCAN_CASES:
        res["cases"].append(scan_held(gen, *case))
    for case in scan_edge_cases():
        res["cases"].append(scan_held(gen, *case))
    scan_in_place(gen)
    res["max_abs_err"] = max(c["max_abs_err"] for c in res["cases"])
    res["max_rel_err"] = max(max(c["y_err"], c["h_err"])
                             for c in res["cases"])
    for dtype in ("bfloat16", "float32"):
        B, S, di, N = 1, LONG_S, 3200, 16
        args = scan_inputs(gen, B, S, di, N, dtype, False)
        y = torch.empty(B, S, di, device="cuda")
        hl = torch.empty(B, di, N, device="cuda")
        scratch = ss.scan_scratch(B, S, di, N, "cuda")

        def kernel(i):
            scan_launch(args, y, hl, scratch)

        bound, by = scan_bound(B, S, di, N, dtype, False, clock, sms)
        ms = device_ms(kernel, 10)
        row = {"B": B, "S": S, "di": di, "N": N, "dtype": dtype,
               "chunk": ss.CHUNK, "ms": ms,
               "wrapper_ms": device_ms(lambda i: ss.selective_scan(*args), 10),
               "split_ms": kernel_split_ms(kernel, 10, scan_kernels(dtype),
                                           ms=ms),
               "plain_ms": cuda_ms(lambda i: ss.selective_scan_plain(*args),
                                   1, warmup=1),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "library": "none: no PyTorch call computes a selective scan",
               "clock_mhz": clock / 1e6}
        print(f"[recurrent] timing {json.dumps(row)}")
        print(f"[recurrent] selective_scan (1, {LONG_S}, 3200, 16) u "
              f"{dtype}: {1e3 * row['ms']:.1f} us a launch against a bound "
              f"of {1e3 * bound:.1f} us ({by}, {100 * bound / row['ms']:.1f}%"
              f"); the plain loop {row['plain_ms']:.1f} ms")
        res["timings"][dtype] = row
        del args, y, hl, scratch
    torch.cuda.empty_cache()
    return res


def hymba_window_attention(seed: int) -> dict:
    """Row 10w at hymba-1.5b's attention shape (1, 8192, 25/5, 64) bf16
    causal under its window of 1024 (route hd64, a GQA group of 5):
    held to chunked_attention(window=) elementwise and row by row and, on
    F64_ROWS sampled query rows of every head, to an f64 windowed
    attention; then timed beside its bound, the plain version and SDPA's
    memory-efficient kernel (the band as a bool mask, K and V repeated),
    the timed launches' output equal to the checked call's bit for bit.
    The same shape unwindowed (causal) is timed beside its bound and
    F.scaled_dot_product_attention(is_causal=True, enable_gqa=True), its
    timed launches' output equal to a wrapper call's bit for bit and
    within F64_ROW_TOL of an f64 causal attention on the same rows."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A

    B, S, H, KV, hd, W = HYMBA_WINDOW_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    q, k, v = attn_inputs(gen, B, S, S, H, KV, hd, "bfloat16")
    scale = hd ** -0.5
    route = fa.flash_route(q.dtype, hd)
    what = (f"B {B}, S {S}, T {S}, H {H}, KV {KV}, hd {hd}, bfloat16, "
            f"causal, window {W}, route {route}")
    got = fa.flash_attention(q, k, v, causal=True, scale=scale, window=W)
    plain = A.chunked_attention(q, k, v, scale, causal=True, window=W,
                                cq=1024, ckv=1024)
    err, _ = attn_held(got, plain, what + " against chunked_attention")
    rows = torch.randperm(S, generator=gen, device="cuda")[:F64_ROWS]
    rows = rows.sort().values
    row64 = attn_row_err(got[:, rows], attn_f64(q, k, v, scale, True, rows, W))
    print(f"[recurrent] flash_attention {what} against f64 attention "
          f"({F64_ROWS} query rows of every head): row max|err| / max|want| "
          f"{row64:.3e} (tol {F64_ROW_TOL:g})")
    check(row64 <= F64_ROW_TOL, f"flash_attention at {what} is {row64:.3e} "
          f"from f64 attention")
    out = torch.empty_like(q)
    bound, by = attn_window_bound(B, S, H, KV, hd, "bfloat16", W)
    row = {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "window": W,
           "dtype": "bfloat16", "route": route,
           "ms": device_ms(lambda i: fa.FLASH(
               q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), None, B, S, S, H, KV, hd,
               fa.DTYPES[q.dtype], 1, scale, fa.ROUTES[route], W), 10),
           "wrapper_ms": device_ms(lambda i: fa.flash_attention(
               q, k, v, causal=True, scale=scale, window=W), 10),
           "plain": "chunked_attention(window=1024, cq = ckv = 1024)",
           "plain_ms": cuda_ms(lambda i: A.chunked_attention(
               q, k, v, scale, causal=True, window=W, cq=1024, ckv=1024), 2,
               warmup=1),
           "bound_ms": bound, "bound_by": by,
           "library": "F.scaled_dot_product_attention, memory-efficient "
                      "kernel, the band as a bool mask, K and V repeated "
                      "per query head", "max_abs_err": err,
           "row_err_vs_f64": row64}
    same = torch.equal(out, got)
    print(f"[recurrent] flash_attention {what}: the timed launches' output "
          f"equals the checked call's bit for bit: {same}")
    check(same, f"flash_attention at {what}: the timed launches differ from "
          f"the checked call")
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
              for t in (k, v))
    pos = torch.arange(S, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        row["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band), 5)
    bound, by = attn_bound(B, S, S, H, KV, hd, "bfloat16", True)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    causal = torch.empty_like(q)
    row["causal"] = {
        "window": None, "route": route,
        "ms": device_ms(lambda i: fa.FLASH(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            causal.data_ptr(), None, B, S, S, H, KV, hd, fa.DTYPES[q.dtype],
            1, scale, fa.ROUTES[route], 0), 10),
        "bound_ms": bound, "bound_by": by,
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "library_ms": device_ms(lambda i: F.scaled_dot_product_attention(
            qh, kt, vt, is_causal=True, enable_gqa=True), 5)}
    what_c = what.replace(f"window {W}", "no window")
    same = torch.equal(causal, fa.flash_attention(q, k, v, causal=True,
                                                  scale=scale))
    row64 = attn_row_err(causal[:, rows], attn_f64(q, k, v, scale, True,
                                                   rows, None))
    row["causal"]["row_err_vs_f64"] = row64
    print(f"[recurrent] timing {json.dumps(row)}")
    print(f"[recurrent] flash_attention {what_c}: the timed launches' output "
          f"equals a wrapper call's bit for bit: {same}; against f64 "
          f"attention ({F64_ROWS} query rows of every head): row max|err| / "
          f"max|want| {row64:.3e} (tol {F64_ROW_TOL:g})")
    check(same and row64 <= F64_ROW_TOL,
          f"flash_attention at {what_c}: the timed launches differ from a "
          f"wrapper call or are {row64:.3e} from f64 attention")
    del q, k, v, got, plain, out, causal, qh, kh, vh, kt, vt, band
    torch.cuda.empty_cache()
    return row


def kernels_in(fn) -> int | None:
    """Device kernels that one call of fn() runs, by torch.profiler (CUDA
    activity only); a window that records none (PERF.md §7: after profiled
    phases the profiler records every other window) is opened once more.
    None if neither records a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n
    return None


def recurrent_serve(arch: str, seed: int, per_step: int, scan_layers: int):
    """`launch/serve.py` at phase 3's settings for `arch` at full width and
    depth in bf16: the grouped kernel's launches must be decode steps x
    `per_step`, the scan's (prefills + decode steps) x `scan_layers`, the
    flash kernel's none (prompts of 8 or 16 tokens)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.models.layers import tree_leaves

    grouped = resolve_grouped_kernel("grouped_pallas")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng, trace, cfg, _ = serve.build(serve.parse_args(
        arch_args(arch) + ["--seed", str(seed)]))
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(eng.params))
    print(f"[recurrent] {cfg.name}: {cfg.num_layers} blocks d{cfg.d_model} "
          f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.3f} B params "
          f"({wbytes / 1e9:.2f} GB), built in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    grouped.launches = 0
    ss.SCAN.reset()
    fa.FLASH.reset()
    rep = eng.run(trace)
    g, sc, fl = grouped.launches, ss.SCAN.launches, fa.FLASH.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[recurrent] {cfg.name}: {len(rep.completions)}/{rep.requests} "
          f"requests served, {rep.generated_tokens} tokens in "
          f"{rep.wall_s:.3f}s ({rep.tokens_per_s:.2f} tok/s), {rep.prefills} "
          f"prefills, {rep.steps} decode steps, "
          f"{1e3 * rep.decode_s / max(rep.steps, 1):.3f} ms/decode step; "
          f"peak device memory {peak:.2f} GiB; grouped_pallas launches {g} = "
          f"{rep.steps} steps x {per_step}, selective_scan launches {sc} = "
          f"({rep.prefills} prefills + {rep.steps} steps) x {scan_layers}, "
          f"flash_attention {fl}")
    check(len(rep.completions) == len(trace) == rep.requests,
          f"{arch}: not every request was served")
    for req in trace:
        toks = rep.completions[req.rid]
        check(len(toks) == req.gen_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"{arch} request {req.rid}: bad completion {toks}")
    check(g == rep.steps * per_step > 0,
          f"{arch}: grouped_pallas launched {g} times, expected "
          f"{rep.steps} x {per_step}")
    check(sc == (rep.prefills + rep.steps) * scan_layers,
          f"{arch}: selective_scan launched {sc} times, expected "
          f"({rep.prefills} + {rep.steps}) x {scan_layers}")
    check(fl == 0, f"{arch}: short prompts launched flash_attention {fl} times")
    return eng, cfg, {"grouped": g, "scan": sc, "steps": rep.steps,
                      "prefills": rep.prefills, "peak_gib": peak,
                      "weight_gb": wbytes / 1e9,
                      "decode_ms": 1e3 * rep.decode_s / max(rep.steps, 1),
                      "tok_s": rep.tokens_per_s}


def timed_prefill(eng, prompt):
    """(first token, row cache, ms, peak GiB) of one prefill through the
    engine (page 0's adapter)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with torch.no_grad():
        tok, row = eng._prefill(0, prompt)     # syncs: pulls the argmax
    return (tok, row, 1e3 * (time.perf_counter() - t1),
            torch.cuda.max_memory_allocated() / 2**30)


def scan_in_model(cfg2, eng2, lcfg, seed: int) -> float:
    """The 2-layer f32 hymba's prefill logits of one SCAN_MODEL_S-token
    prompt through the scan kernel and through its plain version put in its
    place: the largest difference over max|logit|."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import tree_from_numpy
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import model as mdl
    from repro_torch.models import ssm

    prompt = torch.as_tensor(np.random.default_rng(seed + 17).integers(
        0, cfg2.vocab_size, (1, SCAN_MODEL_S)), device="cuda")
    lt = tree_from_numpy(eng2.cache.store.get(0), device="cuda")

    def logits():
        with torch.no_grad():
            return mdl.forward(eng2.params, cfg2, {"tokens": prompt}, lora=lt,
                               lora_scale=lcfg.scale)["logits"]

    ss.SCAN.reset()
    got = logits()
    launches = ss.SCAN.launches
    kernel = ssm.selective_scan

    def plain(*args, out_state=None):
        return ss.selective_scan_plain(*args)

    ssm.selective_scan = plain
    try:
        want = logits()
    finally:
        ssm.selective_scan = kernel
    diff = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[recurrent] parity {cfg2.name} 2L f32, one {SCAN_MODEL_S}-token "
          f"prompt: logits through the scan kernel ({launches} launches) "
          f"against its plain version in its place, max|diff| / max|logit| "
          f"{diff:.3e} (tol {SCAN_TOL:g})")
    check(launches == cfg2.num_layers and diff <= SCAN_TOL,
          f"{cfg2.name}: the model's scan kernel ({launches} launches) is "
          f"{diff:.3e} from its plain version")
    return diff


# kernel name -> part of a prefill, the first test that matches (lower case)
PREFILL_PARTS = (("scan", ("selective_scan",)), ("flash", ("flash_",)),
                 ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "s16816",
                            "tensorop")),
                 ("elementwise and casts", ("elementwise", "vectorized",
                                            "unrolled", "copy", "cast",
                                            "fill", "cat")))


def prefill_split(eng, cfg, prompt, wall_ms: float,
                  windows: int = 6) -> dict:
    """One prefill of `prompt` through the engine split by kernel
    (profiled_kernels): device ms by PREFILL_PARTS and the rest (its five
    largest kernels named), beside the prefill's wall ms; the depthwise
    causal conv of the Mamba heads, eager elementwise kernels inside the
    elementwise part, timed apart at the prefill's shape times the layers.
    Windows are opened until two in a row record as many kernels and
    device totals within SPLIT_RTOL of each other, the later of which is
    kept, with the scan's three kernels and the windowed flash forward's
    each once a layer (up to `windows`; the phase fails if none agree)."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.ssm import mamba_inner_dim

    def run(i):
        with torch.no_grad():
            eng._prefill(0, prompt)

    layers = cfg.num_layers
    names = scan_kernels(cfg.compute_dtype, cfg.ssm_state_size) + (
        HOPPER_KERNELS[-1],)
    run(0)
    torch.cuda.synchronize()
    prev = None
    for w in range(windows):
        ms, counts, _ = profiled_kernels(run, 1)
        n, total = sum(counts.values()), sum(ms.values())
        if (prev is not None and n == prev[0]
                and abs(total - prev[1]) <= SPLIT_RTOL * total
                and all(counts.get(k) == layers for k in names)):
            break
        print(f"[recurrent] prefill split window {w}: {n} kernels, "
              f"{total:.3f} device ms, {json.dumps({k: counts.get(k, 0) for k in names})}"
              f" (want {layers} each); the previous window "
              f"{prev}")
        prev = (n, total)
    else:
        check(False, f"{cfg.name}: no two profiler windows of a prefill "
                     f"agree")
    parts = {name: 0.0 for name, _ in PREFILL_PARTS}
    rest = {}
    for kname, t in ms.items():
        low = kname.lower()
        for name, keys in PREFILL_PARTS:
            if any(k in low for k in keys):
                parts[name] += t
                break
        else:
            rest[kname] = t
    parts["rest"] = sum(rest.values())
    di, W, S = mamba_inner_dim(cfg), cfg.ssm_conv_width, len(prompt)
    dt = getattr(torch, cfg.compute_dtype)
    x = torch.randn(1, S, di, device="cuda").to(dt)
    w = torch.randn(W, di, device="cuda").to(getattr(torch, cfg.param_dtype))
    b = torch.randn(di, device="cuda").to(w.dtype)
    conv = cfg.num_layers * device_ms(
        lambda i: ssm._causal_conv(x, w, b), 5)
    out = {"wall_ms": wall_ms, "device_ms": sum(ms.values()),
           "kernels": len(ms), "launches": sum(counts.values()),
           "parts_ms": parts,
           "causal_conv_ms": conv,
           "rest_top": dict(sorted(rest.items(), key=lambda kv: -kv[1])[:5])}
    print(f"[recurrent] {cfg.name}: one {S}-token prefill by kernel "
          f"(torch.profiler): {json.dumps(out)}")
    del x, w, b
    return out


def recurrent_phase(seed: int) -> dict:
    """Phase 23: (a) the grouped kernel at both archs' decode shapes
    (`grouped_recurrent_phase`), the selective scan (`scan_phase`) and row
    10w at hymba's attention shape; (b) hymba-1.5b served at full width and depth
    (grouped launches steps x 32 x 6, scan launches (prefills + steps) x
    32), then prompts of 8192 and 32768 tokens through the engine's prefill
    (32 windowed hd64 flash launches and 32 scan launches each, a cache
    of 1024 KV slots and the Mamba state); (c) xlstm-1.3b served the same
    way (grouped launches steps x 54: 42 mLSTM downs and 6 sLSTM wx and
    down), then one 1024-token prompt; (d) 2-layer f32 hymba and a
    one-period f32 xLSTM at full width against the single-adapter
    reference (phase 4's near-tie rule), hymba's 8192-token prompt through
    the flash kernel against chunked_attention, and its prefill through
    the scan kernel against the plain scan."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.lora_matmul import resolve_grouped_kernel
    from repro_torch.launch import serve
    from repro_torch.models.ssm import mamba_inner_dim

    t0 = time.perf_counter()
    res = {"grouped": grouped_recurrent_phase(seed), "scan": scan_phase(seed),
           "window": hymba_window_attention(seed)}
    grouped = resolve_grouped_kernel("grouped_pallas")
    print(f"[recurrent] (a) done in {time.perf_counter() - t0:.1f}s")

    # (b) hymba-1.5b
    t0 = time.perf_counter()
    eng, cfg, served = recurrent_serve("hymba-1.5b", seed, 32 * 6, 32)
    check(len(eng.cache.pool["g0"]["attn"]) + len(eng.cache.pool["g0"]["mamba"])
          == 6, "hymba's adapters do not take 6 targets a layer")
    long = {}
    for S in HYMBA_BUCKETS:
        prompt = np.random.default_rng(seed + S).integers(
            0, cfg.vocab_size, S).tolist()
        fa.FLASH.reset()
        ss.SCAN.reset()
        grouped.launches = 0
        tok, row, ms, peak = timed_prefill(eng, prompt)
        fl, sc = fa.FLASH.launches, ss.SCAN.launches
        chunked = ss.SCAN.launches_by_tag.get("chunked", 0)
        routes = dict(fa.FLASH.launches_by_route)
        windowed = fa.FLASH.launches_by_tag.get("window", 0)
        # the same prompt again: the first call of a shape also pays the
        # library's first-use costs (GEMM heuristics, allocator growth)
        again = timed_prefill(eng, prompt)[2]
        kv = tuple(row["g0"]["self"][0].shape)
        lane = cache_bytes(cfg, 1, S + 16)
        mamba = 4 * cfg.num_layers * mamba_inner_dim(cfg) * (
            cfg.ssm_conv_width - 1 + cfg.ssm_state_size)
        unwindowed = cache_bytes(dataclasses.replace(cfg, sliding_window=None),
                                 1, S + 16)
        print(f"[recurrent] {cfg.name}: one {S}-token prefill {ms:.3f} ms "
              f"({again:.3f} ms again), first token {tok}, peak device "
              f"memory {peak:.2f} GiB; "
              f"flash_attention {fl} ({windowed} windowed, by route "
              f"{json.dumps(routes)}), selective_scan {sc} ({chunked} "
              f"chunked); the lane's cache "
              f"{lane / 1e6:.3f} MB ({kv[2]} KV slots a layer; Mamba state "
              f"{mamba / 1e6:.3f} MB) against {unwindowed / 1e9:.3f} GB "
              f"unwindowed at {S + 16} slots")
        check(fl == windowed == cfg.num_layers and
              routes == {"hd64": fl} and sc == chunked == cfg.num_layers,
              f"hymba {S}-token prefill: flash {routes} ({windowed} "
              f"windowed), scan {sc} ({chunked} chunked); expected "
              f"{cfg.num_layers} each")
        check(kv == (cfg.num_layers, 1, cfg.sliding_window, cfg.num_kv_heads,
                     cfg.hd) and 0 <= tok < cfg.vocab_size and
              grouped.launches == 0,
              f"hymba {S}-token prefill: cache {kv}, token {tok}")
        long[S] = {"ms": ms, "again_ms": again, "peak_gib": peak,
                   "flash": fl, "scan": sc, "scan_chunked": chunked,
                   "lane_bytes": lane, "mamba_bytes": mamba,
                   "unwindowed_bytes": unwindowed}
        del row
        if S == LONG_S:
            long[S]["split"] = prefill_split(eng, cfg, prompt, again)
    served["long"] = long
    res["hymba"] = served
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[recurrent] (b) done in {time.perf_counter() - t0:.1f}s")

    # (c) xlstm-1.3b
    t0 = time.perf_counter()
    eng, cfg, served = recurrent_serve("xlstm-1.3b", seed, 54, 0)
    prompt = np.random.default_rng(seed + 19).integers(
        0, cfg.vocab_size, XLSTM_PROMPT).tolist()
    grouped.launches = 0
    tok, row, ms, peak = timed_prefill(eng, prompt)
    again = timed_prefill(eng, prompt)[2]
    kernels = kernels_in(lambda: eng._prefill(0, prompt))
    state = cache_bytes(cfg, 1, XLSTM_PROMPT)
    print(f"[recurrent] {cfg.name}: one {XLSTM_PROMPT}-token prefill "
          f"{ms:.3f} ms ({again:.3f} ms again), first token {tok}, peak "
          f"device memory {peak:.2f} GiB, {kernels} device kernels "
          f"(torch.profiler, a third prefill); the lane's recurrent state "
          f"{state / 1e6:.3f} MB at any context length")
    check(0 <= tok < cfg.vocab_size and grouped.launches == 0,
          f"xlstm prefill: token {tok}, {grouped.launches} grouped launches")
    served.update(prefill_ms=ms, prefill_again_ms=again,
                  prefill_peak_gib=peak, prefill_kernels=kernels,
                  state_bytes=state)
    res["xlstm"] = served
    del eng, row
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[recurrent] (c) done in {time.perf_counter() - t0:.1f}s")

    # (d) f32 parity at full width
    t0 = time.perf_counter()
    tag = "[recurrent] parity"
    cfg2 = parity_cfg("hymba-1.5b")
    eng2, trace2, _, lcfg = serve.build(serve.parse_args(
        arch_args("hymba-1.5b") + ["--seed", str(seed)]), cfg=cfg2)
    rep = eng2.run(trace2)
    near = engine_vs_reference(eng2, trace2, rep, cfg2, lcfg, tag)
    print(f"{tag} {cfg2.name} 2L d{cfg2.d_model} f32: "
          f"{len(trace2) - near}/{len(trace2)} completions identical to the "
          f"single-adapter reference, {near} near-tie divergences")
    res["hymba_parity_logit_diff"] = long_prompt_parity(
        eng2, cfg2, lcfg, seed, window=cfg2.sliding_window, tag=tag)
    res["scan_in_model"] = scan_in_model(cfg2, eng2, lcfg, seed)
    del eng2
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_config
    cfg3 = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=8,
                               param_dtype="float32", compute_dtype="float32")
    eng3, trace3, _, lcfg = serve.build(serve.parse_args(
        arch_args("xlstm-1.3b") + ["--seed", str(seed)]), cfg=cfg3)
    rep = eng3.run(trace3)
    near = engine_vs_reference(eng3, trace3, rep, cfg3, lcfg, tag)
    print(f"{tag} {cfg3.name} one period (8 blocks) d{cfg3.d_model} f32: "
          f"{len(trace3) - near}/{len(trace3)} completions identical to the "
          f"single-adapter reference, {near} near-tie divergences")
    del eng3
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[recurrent] (d) done in {time.perf_counter() - t0:.1f}s")
    return res


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
    sys.path.insert(0, os.path.join(ROOT, "tests"))   # _bin_rows (numpy only)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {', '.join(sorted(libs))} in {time.perf_counter() - t0:.1f}s")
    build_report(libs)

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
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ops_res = ops_phase(args.seed)
    print(f"[ops] done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    long_res = long_prefill_phase(args.seed, args.profile)
    print(f"[long-prefill] done in {time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()       # kept as a guard; phase 11 leaves no cycle behind
    torch.cuda.empty_cache()
    print(f"[long-prefill] device memory in use after the phase "
          f"{held / 2**30:.3f} GiB, after gc.collect() "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    t0 = time.perf_counter()
    task_res = task_phase(args.seed)
    print(f"[task] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    vit = task_res.pop("vit_setup")     # phase 15 resumes on it too
    base_res = baseline_phase(args.seed, vit)
    torch.cuda.empty_cache()
    print(f"[baselines] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    fig2_res = fig2_phase(args.seed)
    torch.cuda.empty_cache()
    print(f"[fig2] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    resume_res = resume_phase(args.seed, vit)
    del vit
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[resume] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    pop_res = population_phase(args.seed)
    print(f"[population] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    cli_res = train_cli_phase(args.seed)
    print(f"[train-cli] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    lt_res = long_train_phase(args.seed, args.profile)
    print(f"[long-train] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    win_res = window_serve_phase(args.seed)
    print(f"[window] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    arch_res = arch_serve_phase(args.seed)
    print(f"[archs] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    gemma_res = gemma_train_phase(args.seed)
    print(f"[gemma-train] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    gpt_res = gpt_serve_phase(args.seed)
    print(f"[gpt-serve] done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    rec = recurrent_phase(args.seed)
    print(f"[recurrent] done in {time.perf_counter() - t0:.1f}s")
    print(f"[total] {time.perf_counter() - t_start:.1f}s")
    hym, xl = rec["hymba"], rec["xlstm"]
    lt_runs = lt_res["runs"]
    gemma_run = gemma_res["runs"][GEMMA_TRAIN[0][0]]
    lt_win = lt_res["window"]

    def later(name: str) -> str:
        """The launches of phases 15-18 for the kernels JSON's paths."""
        return (f"; resume (vit-b16, {RESUME_ROUNDS} rounds straight / "
                f"{RESUME_ROUNDS - RESUME_EVERY} resumed): " + ", ".join(
                    f"{tag} {r['launches'][name]} / "
                    f"{r['resumed_launches'][name]}"
                    for tag, r in resume_res.items() if tag != "sampler")
                + f", async sampler hetlora_weighted "
                f"{resume_res['sampler']['launches'][name]}"
                + f"; population (yi-9b, {POP_ROUNDS} rounds): prefetch on "
                f"{pop_res['on']['launches'][name]}, off "
                f"{pop_res['off']['launches'][name]}"
                + f"; train-cli (yi-9b, 2 rounds, default selector): "
                f"{cli_res['launches'][name]}"
                + "; long-train (yi-9b): " + ", ".join(
                    f"{S} tokens {r['launches'][name]} in {r['rounds']} "
                    f"round(s) of {r['clients']} client(s)"
                    for S, r in lt_runs.items()))
    entry["path"] += later("grouped_lora_delta") + (
        f"; window (yi-9b, 8 lanes, window 8192): {win_res['grouped']} in "
        f"{win_res['steps']} decode steps; archs: " + ", ".join(
            f"{a} {arch_res[a]['grouped']} in {arch_res[a]['steps']} steps "
            f"x {arch_res[a]['layers']} x 4" for a in ARCHS)
        + f"; gpt-serve (gpt2-small, d 768): {gpt_res['grouped']} in "
        f"{gpt_res['steps']} steps x {gpt_res['layers']} x 4"
        + f"; recurrent: hymba-1.5b {hym['grouped']} in {hym['steps']} steps "
        f"x 32 x 6, xlstm-1.3b {xl['grouped']} in {xl['steps']} steps x 54")
    # the recurrent archs' decode shapes, held before they were served
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               rec["grouped"]["max_abs_err"])
    entry["recurrent_shapes"] = rec["grouped"]

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
                     f"train, selector=fused, {TRAIN_ROUNDS} rounds; task: "
                     f"vit-b16 flasc {task_res['vit']['flasc'][name]} in "
                     f"{VIT_ROUNDS} rounds, gpt2-small flasc "
                     f"{task_res['gpt']['flasc'][name]} in {GPT_ROUNDS}")
            + "; baselines (vit-b16): " + ", ".join(
                f"{tag} {r['launches'][name]}"
                for tag, r in base_res.items())
            + f"; fig2 (vit-b16, {FIG2_ROUNDS} rounds): " + ", ".join(
                f"{tag} {r['launches'][name]}"
                for tag, r in fig2_res.items()) + later(name),
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
    for name, (n, path) in paths.items():
        paths[name] = (n, path + "; baselines (vit-b16): " + ", ".join(
            f"{tag} {r['launches'][name]}" for tag, r in base_res.items())
            + "; fig2 (vit-b16): " + ", ".join(
                f"{tag} {r['launches'][name]}"
                for tag, r in fig2_res.items()) + later(name))
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
    lmain, amain = ops_res["lora_rows"][0], ops_res["attn_rows"][0]
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:58",
        "launches": long_res["flash"],
        "launches_by_route": long_res["flash_routes"],
        "path": ("long-prefill, 48 per prefill; long-train, 96 per client "
                 "step (forward and recomputation)")
        + later("flash_attention")
        + f"; window (yi-9b): {win_res['flash']} windowed; archs: "
        + ", ".join(f"{a} {arch_res[a]['flash']} ({arch_res[a]['route']})"
                    for a in ARCHS)
        + f"; long-train (e): {lt_win['launches']['flash_attention']} "
        f"windowed in one {lt_win['tokens']}-token gradient; gemma-train: "
        f"{gemma_run['launches']['flash_attention']} (hd256) in "
        f"{gemma_run['rounds']} rounds of {gemma_run['clients']} clients",
        "shape": "q (1, 8192, 32, 128), k/v (1, 8192, 4, 128) bf16 causal",
        "max_abs_err": ops_res["attn_err"],
        "max_row_rel_err_bf16": ops_res["attn_row"],
        "max_row_err_vs_f64": max(ops_res["attn_f64"].values()),
        "row_err_vs_f64": ops_res["attn_f64"],
        "at_shape": ops_res["attn_main"],
        "against_chunked_attention": ops_res["attn_chunked"],
        "ms": amain["ms"],
        "plain_ms": amain["plain_ms"], "bound_ms": amain["bound_ms"],
        "bound_by": amain["bound_by"], "library_ms": amain["library_ms"],
        "library": "F.scaled_dot_product_attention(enable_gqa=True)",
        "route_timed": amain["route"],
        "wrapper_ms": amain["wrapper_ms"], "timings": ops_res["attn_rows"]})
    wt, ht = ops_res["win_timing"], ops_res["hd256_timing"]
    entries.append({
        "name": "flash_attention_window", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:58",
        "replaces_note": "the Pallas kernel has no window; the reference "
                         "serves a window through models/attention.py::"
                         "chunked_attention (:102, its skip at :161)",
        "launches": win_res["windowed"],
        "launches_by_route": win_res["flash_routes"],
        "path": ("window (yi-9b, window 8192): 48 per prompt of 32768 "
                 "tokens, every one windowed; recurrent (hymba-1.5b, window "
                 "1024, hd 64, 25/5 heads, hd64): "
                 + ", ".join(f"{r['flash']} in its {S}-token prefill"
                             for S, r in hym["long"].items())),
        "hymba_timing": rec["window"],
        "shape": "q (1, 32768, 32, 128), k/v (1, 32768, 4, 128) bf16 "
                 "causal, window 8192",
        "max_abs_err": ops_res["win_err"],
        "max_row_err_vs_f64": max(ops_res["win_f64"].values()),
        "row_err_vs_f64": ops_res["win_f64"],
        "model_logit_diff_vs_chunked": win_res["parity_logit_diff"],
        "ms": wt["ms"], "plain_ms": wt["plain_ms"], "plain": wt["plain"],
        "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"],
        "library_ms": wt["library_ms"], "library": wt["library"],
        "route_timed": wt["route"], "wrapper_ms": wt["wrapper_ms"],
        "timing": wt})
    hw = rec["window"]
    entries.append({
        "name": "flash_attention_hd64", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:58",
        "kernel": "flash_wgmma_kernel<64> (route hd64)",
        "launches": sum(r["flash"] for r in hym["long"].values()),
        "launches_by_route": {"hd64": sum(r["flash"]
                                          for r in hym["long"].values())},
        "path": "recurrent (hymba-1.5b, 32 layers, window 1024): "
                + ", ".join(f"{r['flash']} in its {S}-token prefill"
                            for S, r in hym["long"].items()),
        "shape": "q (1, 8192, 25, 64), k/v (1, 8192, 5, 64) bf16 causal, "
                 "window 1024",
        "max_abs_err": hw["max_abs_err"],
        "max_row_err_vs_f64": hw["row_err_vs_f64"],
        "max_lse_err_vs_plain_f64": ops_res["hd64_lse_err"],
        "ms": hw["ms"], "plain_ms": hw["plain_ms"], "plain": hw["plain"],
        "bound_ms": hw["bound_ms"], "bound_by": hw["bound_by"],
        "library_ms": hw["library_ms"], "library": hw["library"],
        "causal": hw["causal"], "route_timed": hw["route"],
        "wrapper_ms": hw["wrapper_ms"]})
    entries.append({
        "name": "flash_attention_hd256", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:58",
        "kernel": "flash_wgmma_hd256_kernel (route hd256); "
                  "flash_f32_kernel<256> (fma)",
        "launches": arch_res["gemma-7b"]["flash"],
        "launches_by_route": {arch_res["gemma-7b"]["route"]:
                              arch_res["gemma-7b"]["flash"]},
        "path": "archs (gemma-7b): one 8192-token prefill, 28 layers",
        "shape": "q, k, v (1, 8192, 16, 256) bf16 causal",
        "max_abs_err": ops_res["hd256_err"],
        "max_lse_err_vs_plain_f64": ops_res["hd256_lse_err"],
        "max_row_err_vs_f64": max(ops_res["hd256_f64"].values()),
        "row_err_vs_f64": ops_res["hd256_f64"],
        "model_logit_diff_vs_chunked": arch_res["gemma_parity_logit_diff"],
        "ms": ht["ms"], "plain_ms": ht["plain_ms"],
        "bound_ms": ht["bound_ms"], "bound_by": ht["bound_by"],
        "library_ms": ht["library_ms"], "library": ht["library"],
        "route_timed": ht["route"], "wrapper_ms": ht["wrapper_ms"],
        "timing": ht})
    bmain, btime = lt_res["kernel"]["main"], lt_res["kernel"]["timing"]
    first = lt_runs[LONG_TRAIN[0][0]]
    entries.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:102",
        "replaces_note": "no Pallas kernel: the reference trains through "
                         "XLA's autodiff of the jnp chunked_attention",
        "launches": first["launches"]["flash_attention_bwd"],
        "launches_by_route": first["routes"]["flash_attention_bwd"],
        "path": (f"long-train (c), {LONG_TRAIN[0][0]} tokens, 48 per client "
                 "step") + later("flash_attention_bwd")
        + f"; long-train (e): {lt_win['launches']['flash_attention_bwd']} "
        f"windowed; gemma-train: "
        f"{gemma_run['launches']['flash_attention_bwd']} (hd256)",
        "shape": "q (1, 8192, 32, 128), k/v (1, 8192, 4, 128) bf16 causal",
        "max_abs_err": bmain["max_abs_err"],
        "max_row_err_vs_f64": bmain["max_row_err"],
        "err_vs_f64": bmain["errs"], "err_vs_exact": bmain["exact_errs"],
        "lse_err": bmain["lse_err"],
        "cases": lt_res["kernel"]["cases"],
        "model_grad_rel_l2": lt_res["parity"]["rel_l2"],
        "ms": btime["ms"], "plain_ms": btime["plain_ms"],
        "bound_ms": btime["bound_ms"], "bound_by": btime["bound_by"],
        "library_ms": btime["library_ms"],
        "library": "autograd.grad of F.scaled_dot_product_attention("
                   "enable_gqa=True) less its forward (p rounded to bf16)",
        "route_timed": btime["route"], "wrapper_ms": btime["wrapper_ms"],
        "timing": btime})
    kres = lt_res["kernel"]
    for name, timing, kernels, keep, launches_, path, shape in (
            ("flash_attention_bwd_window", kres["window_timing"],
             FLASH_BWD_WGMMA_WINDOW,
             lambda c: c.get("window") is not None,
             lt_win["windowed"][1]["window"],
             f"long-train (e): one {lt_win['tokens']}-token gradient of "
             f"full yi-9b under window {lt_win['window']}, 48 windowed wgmma "
             f"launches; (e) parity: "
             f"{lt_win['parity']['window']}-key window at "
             f"{lt_win['parity']['S']} tokens, 2 launches",
             "q (1, 32768, 32, 128), k/v (1, 32768, 4, 128) bf16 causal, "
             "window 8192"),
            ("flash_attention_bwd_hd256", kres["hd256_timing"],
             FLASH_BWD_HD256, lambda c: "hd 256" in c["case"],
             gemma_run["launches"]["flash_attention_bwd"],
             f"gemma-train (gemma-7b, 28 layers): "
             f"{gemma_run['rounds']} rounds of {gemma_run['clients']} "
             f"clients at {GEMMA_TRAIN[0][0]} tokens, 28 a client step; "
             "parity 2",
             "q, k, v (1, 8192, 16, 256) bf16 causal")):
        cases = [c for c in kres["cases"] if keep(c)]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:102",
            "replaces_note": "no Pallas kernel: the reference trains through "
                             "XLA's autodiff of the jnp chunked_attention "
                             "(its window's chunk skip at :161)",
            "kernel_names": kernels, "launches": launches_, "path": path,
            "shape": shape,
            "max_abs_err": max([c["max_abs_err"] for c in cases]
                               + [timing["max_abs_err"]]),
            "max_row_err_vs_f64": max([c["max_row_err"] for c in cases]
                                      + [timing["max_row_err"]]),
            "shape_row_err_vs_f64": timing["max_row_err"],
            "shape_checked": timing["checked"],
            "cases": [c["case"] for c in cases],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "plain": timing["plain"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"], "library": timing["library"],
            "route_timed": timing["route"],
            "wrapper_ms": timing["wrapper_ms"], "timing": timing})
    entries.append({
        "name": "lora_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:66",
        "launches": ops_res["lora_launches"],
        "launches_by_route": ops_res["lora_routes"],
        "path": "ops phase" + later("lora_matmul"),
        "shape": "(M, K, N, r) = (8192, 4096, 4096, 16) bf16",
        "max_abs_err": ops_res["lora_err"], "ms": lmain["ms"],
        "plain_ms": lmain["plain_ms"], "bound_ms": lmain["bound_ms"],
        "bound_by": lmain["bound_by"], "library_ms": lmain["library_ms"],
        "library": "torch.matmul(x, w) + scale * torch.matmul(xa, b)",
        "route_timed": lmain["route"],
        "wrapper_ms": lmain["wrapper_ms"], "timings": ops_res["lora_rows"]})
    sc, st = rec["scan"], rec["scan"]["timings"]["bfloat16"]
    entries.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": "src/repro/models/ssm.py:75",
        "replaces_note": "no Pallas kernel: XLA's fusion of _ssm_coeffs "
                         "(:62), _chunk_scan's associative_scan (:75) and "
                         "mamba_forward_state's readout (:115)",
        "launches": hym["scan"],
        "path": (f"recurrent (hymba-1.5b, 32 layers): serve {hym['scan']} = "
                 f"({hym['prefills']} prefills + {hym['steps']} decode steps)"
                 f" x 32; " + ", ".join(f"{r['scan']} ({r['scan_chunked']} "
                                        f"chunked: three kernels each) in "
                                        f"its {S}-token prefill"
                                        for S, r in hym["long"].items())),
        "shape": "(B, S, di, N) = (1, 8192, 3200, 16), u bf16",
        "max_abs_err": sc["max_abs_err"],
        "max_err_over_max_plain": sc["max_rel_err"], "cases": sc["cases"],
        "model_logits_vs_plain_scan": rec["scan_in_model"],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None, "library": st["library"],
        "chunk": st["chunk"], "split_ms": st["split_ms"],
        "wrapper_ms": st["wrapper_ms"], "timings": sc["timings"],
        "prefill_split": hym["long"][LONG_S]["split"]})
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
