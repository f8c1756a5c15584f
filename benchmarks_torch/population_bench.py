"""Client-population scaling on the port: host population store + cohort
prefetch, the sweep of `benchmarks/population_bench.py`.

  PYTHONPATH=src python -m benchmarks_torch.population_bench [--quick]
      [--out population_bench.json]

Sweeps the client population (1e3 -> 1e6; the cohort stays at 8) through
the chunked host `PopulationStore` and measures steady-state rounds/s with
the double-buffered cohort prefetch on and off.  A round's device work
does not depend on the population, so with prefetch on the O(population)
host work (sampler scoring, row gather, pinned staging, the H2D copy)
should hide under the round's compute.  `stage_wait_ms` is the time the
round loop spent blocked in the prefetcher's `take()` a round: the
staging cost left on the critical path.  Every cell must issue one H2D
copy a round (`h2d_puts == rounds`).

Round 0 is excluded: rounds/s is the median inter-round interval from the
round-end callbacks after it.  The model is the reference's tiny one
(`common.MODEL_KW`-sized, rank 8); with BENCH_MODEL=paper it is ViT-B/16
(`common.paper_config`, pretrained at `common.PAPER_PRETRAIN`) on the
196-patch task, and the store's chunk is cut so that one chunk holds at
most 64 MB.  Runs on the card unless `main(device="cpu")`.

Prints the harness's CSV rows, then one JSON object (rows and summary),
also written to chiprun_out/<--out>; never to BENCH_population.json.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

from benchmarks_torch import common
from benchmarks_torch.common import emit, row
from repro_torch.data import datasets as ds
from repro_torch.federated import engine as eng
from repro_torch.federated.api import Experiment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORT = 8
RANK = 8
CHUNK = 4096                    # the reference's chunk (tiny model)
CHUNK_BYTES = 64_000_000        # the most one chunk may hold (paper model)
POPULATIONS_QUICK = (1_000, 10_000)
POPULATIONS = (1_000, 10_000, 100_000, 1_000_000)


class _RoundTimer(eng.Callback):
    """Host stamp at every round end; rounds/s is the median interval
    after round 0."""

    def __init__(self):
        self.stamps = []

    def on_round_end(self, ev):
        self.stamps.append(time.perf_counter())

    def rounds_per_s(self) -> float:
        post = self.stamps[1:]
        if len(post) < 3:
            raise ValueError("need >= 4 rounds to measure steady state")
        gaps = [b - a for a, b in zip(post, post[1:])]
        return 1.0 / statistics.median(gaps)


def _experiment(task, backbone, rounds: int, device):
    exp = (Experiment(task, device=device)
           .with_federation(n_clients=COHORT, local_batch=8, local_steps=4)
           .with_lora(rank=RANK)
           .with_training(rounds=rounds, eval_every=rounds + 1,
                          pretrain_steps=2, seed=0))
    if backbone is None:
        return exp.with_model(d_model=48, num_layers=2, num_heads=4, d_ff=96)
    return exp.with_params(*backbone)


def chunk_for(task, backbone, device) -> int:
    """The reference's chunk for the tiny model; for a given backbone the
    most clients a chunk of `CHUNK_BYTES` holds."""
    if backbone is None:
        return CHUNK
    exp = _experiment(task, backbone, 1, device)
    p_len = exp._build_trainable(*backbone)[1].p_len
    return max(1, CHUNK_BYTES // (4 * p_len))


def run_cell(task, backbone, population: int, prefetch: bool, rounds: int,
             chunk: int, device) -> dict:
    timer = _RoundTimer()
    exp = (_experiment(task, backbone, rounds, device)
           .with_population(population, sampler="uniform", chunk=chunk,
                            prefetch=prefetch)
           .with_callbacks(timer))
    t0 = time.perf_counter()
    exp.run()
    wall = time.perf_counter() - t0
    bundle = exp._population_bundle
    store, pre = bundle.store, bundle.last_prefetcher
    if pre.h2d_puts != rounds:
        raise RuntimeError(f"{pre.h2d_puts} H2D copies in {rounds} rounds: "
                           "the contract is one per cohort")
    return {
        "population": population,
        "prefetch": prefetch,
        "rounds": rounds,
        "cohort": COHORT,
        "chunk": chunk,
        "rounds_per_s": timer.rounds_per_s(),
        "stage_wait_ms": pre.take_wait_s / rounds * 1e3,
        "h2d_puts": pre.h2d_puts,
        "wall_s": wall,
        "store_chunks": store.n_chunks,
        "store_mbytes": store.nbytes / 2**20,
    }


def population_sweep(rows, quick: bool, device=None):
    paper = common.MODEL == "paper"
    if paper:
        task = common.get_task("synth_image", model="paper")
        backbone = common.pretrained_backbone(
            task, common.PAPER_KW, common.PAPER_PRETRAIN["steps"], 0, device)
    else:
        task = ds.make_synth_image(n_examples=512, n_clients=COHORT,
                                   n_patches=8, dim=48, seed=0, n_eval=64)
        backbone = None
    rounds = 6 if quick else 14
    chunk = chunk_for(task, backbone, device)
    pops = POPULATIONS_QUICK if quick else POPULATIONS
    jrows = []
    for population in pops:
        for prefetch in (True, False):
            cell = run_cell(task, backbone, population, prefetch, rounds,
                            chunk, device)
            jrows.append(cell)
            label = f"pop{population}_" + ("pf" if prefetch else "nopf")
            rows.append(row("population", label, "rounds_per_s",
                            cell["rounds_per_s"]))
            rows.append(row("population", label, "stage_wait_ms",
                            cell["stage_wait_ms"]))
    on = {c["population"]: c for c in jrows if c["prefetch"]}
    off = {c["population"]: c for c in jrows if not c["prefetch"]}
    base, top = min(pops), max(pops)
    summary = {
        "model": "vit-b16" if paper else "tiny",
        "flatness_on": on[top]["rounds_per_s"] / on[base]["rounds_per_s"],
        "flatness_off": off[top]["rounds_per_s"] / off[base]["rounds_per_s"],
        "stage_wait_ms_on_at_max": on[top]["stage_wait_ms"],
        "stage_wait_ms_off_at_max": off[top]["stage_wait_ms"],
        "stage_wait_ratio_at_max": (off[top]["stage_wait_ms"]
                                    / max(on[top]["stage_wait_ms"], 1e-6)),
    }
    rows.append(row("population", "summary", "flatness_on",
                    summary["flatness_on"]))
    rows.append(row("population", "summary", "stage_wait_ratio_at_max",
                    summary["stage_wait_ratio_at_max"]))
    return jrows, summary


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="two populations and 6 rounds (also BENCH_QUICK)")
    ap.add_argument("--out", default="population_bench.json",
                    help="file name under chiprun_out/")
    args = ap.parse_args(argv if argv is not None else [])
    quick = args.quick or common.QUICK
    rows = []
    jrows, summary = population_sweep(rows, quick, device)
    emit(rows, "Population scaling (host store + cohort prefetch)")
    payload = {"bench": "population_scaling_sweep", "quick": quick,
               "summary": summary, "rows": jrows}
    print(json.dumps(payload))
    out = os.path.join(ROOT, "chiprun_out", args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
