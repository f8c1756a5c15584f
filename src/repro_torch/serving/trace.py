"""Seeded synthetic multi-tenant request traces (numpy only; the port's own
copy of `src/repro/serving/trace.py`, draw for draw, so one seed gives the
identical trace in both packages).

A serving trace is a list of `Request`s sorted by arrival time.  Client
popularity is Zipf-distributed — a few hot clients dominate, a long tail
appears rarely — which is exactly the regime where a paged adapter cache
earns its keep (hot adapters stay resident, the tail churns through the
LRU).  Arrivals follow a Poisson process (exponential inter-arrival
gaps); prompt lengths are drawn from a small bucket set.

Everything is driven by one `np.random.default_rng(seed)` — the same
seed always produces the identical trace, which the benchmark and the
CI smoke rely on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: `client` selects the LoRA adapter; the engine
    prefills `prompt` then decodes `gen_len` tokens greedily."""
    rid: int
    client: int
    arrival: float                # virtual seconds
    prompt_len: int
    gen_len: int
    prompt: Tuple[int, ...]       # token ids, len == prompt_len


def zipf_probs(n_clients: int, a: float) -> np.ndarray:
    """Normalized Zipf pmf over client ranks: p(i) ∝ 1/(i+1)^a."""
    p = 1.0 / np.arange(1, n_clients + 1, dtype=np.float64) ** a
    return p / p.sum()


def synth_trace(n_requests: int, n_clients: int, vocab: int, *,
                seed: int = 0, zipf_a: float = 1.1, rate: float = 4.0,
                prompt_buckets: Sequence[int] = (8, 16, 32),
                gen_range: Tuple[int, int] = (4, 24)) -> List[Request]:
    """Generate a seeded multi-tenant trace.

    rate — mean request arrivals per virtual second (Poisson process).
    prompt_buckets — the admissible prompt lengths (uniform over buckets).
    gen_range — inclusive (lo, hi) for the per-request decode budget.
    """
    if n_requests < 1 or n_clients < 1 or vocab < 2:
        raise ValueError(f"need requests >= 1, clients >= 1, vocab >= 2; got "
                         f"{n_requests}, {n_clients}, {vocab}")
    lo, hi = gen_range
    if not 1 <= lo <= hi:
        raise ValueError(f"gen_range must be 1 <= lo <= hi, got {gen_range}")
    rng = np.random.default_rng(seed)
    probs = zipf_probs(n_clients, zipf_a)
    reqs: List[Request] = []
    t = 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        client = int(rng.choice(n_clients, p=probs))
        plen = int(rng.choice(np.asarray(prompt_buckets)))
        glen = int(rng.integers(lo, hi + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, size=plen))
        reqs.append(Request(rid=rid, client=client, arrival=t,
                            prompt_len=plen, gen_len=glen, prompt=prompt))
    return reqs
