"""The serving loop: per-request prefill + grouped-adapter continuous decode.

One backbone, many adapters.  Each admitted request is prefilled alone
(B=1, exact prompt length) with its client's adapter sliced out of the
device pool (`cache.page_lora`), and its KV cache is copied into the lane
slot of the persistent batch cache.  Decode then runs all lanes as one
batch: per-lane positions go in as a `(B,)` pos tensor and per-lane
adapters as a paged lora tree (`cache.paged_lora`), which
`models/layers.py::linear` routes through the grouped-kernel registry in
`kernels/lora_matmul.py` -- on the card, the CUDA kernel, four launches
per layer (wq, wk, wv, wo) per decode step.

Under a sliding window W (`window=W`, how the reference serves contexts
longer than its caches) each lane holds a rolling cache of min(W,
max_len) slots, written at pos % W, and prefill and decode attend over the
last W positions: the batch cache's size no longer grows with max_len.

Idle lanes keep decoding against page 0 with their stale position; their
outputs are discarded and their cache slots overwritten at the next
admission, so the decode computation stays a single fixed shape.
Sampling is greedy (argmax), deterministic given the trace seed.  The
loop mirrors `src/repro/serving/engine.py`, with one host pull per decode
step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.layers import tree_leaves, zeros_from_spec
from repro_torch.serving.cache import PagedAdapterCache, page_lora, paged_lora
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.trace import Request


@dataclasses.dataclass
class ServingReport:
    """What a serving run produced and what it cost."""
    completions: Dict[int, List[int]]   # rid -> generated token ids
    requests: int
    steps: int                          # decode steps executed
    prefills: int
    decode_tokens: int                  # tokens produced by decode steps
    generated_tokens: int               # decode_tokens + one per prefill
    wall_s: float
    tokens_per_s: float                 # generated_tokens / wall_s
    mean_occupancy: float               # active lanes per decode step
    stalls: int                         # admissions blocked on pinned cache
    cache: Dict[str, float]             # PagedAdapterCache.stats()
    decode_s: float = 0.0               # wall time inside decode steps


class ServingEngine:
    """Continuous-batching serving over a paged adapter cache.

    `run(trace)` drives the full loop: virtual arrivals -> FIFO admission
    (pinning adapter pages) -> per-request prefill into a lane slot ->
    batched multi-adapter decode -> retirement.  Host state is three small
    numpy arrays (current token, position, page index per lane);
    everything heavy stays on the device.  `device` defaults to the card;
    params and the cache's pool must already lie on it.
    """

    def __init__(self, params, cfg, cache: PagedAdapterCache, *,
                 n_lanes: int = 4, lora_scale: float = 1.0,
                 max_len: int = 64, window: Optional[int] = None,
                 step_dt: float = 0.25, device: DeviceLike = None):
        self.device = resolve_device(device)
        if cfg.num_classes or cfg.encoder_decoder or cfg.embed_inputs:
            raise ValueError("serving requires a causal token LM architecture")
        if n_lanes < 1 or max_len < 2 or (window is not None and window < 1):
            raise ValueError(f"need n_lanes >= 1, max_len >= 2 and window "
                             f"None or >= 1, got {n_lanes}, {max_len}, "
                             f"{window}")
        mdl.check_servable(cfg)
        for what, dev in (("params", next(tree_leaves(params)).device),
                          ("adapter pool", cache.device)):
            if dev.type != self.device.type:
                raise ValueError(f"{what} on {dev}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.cache = cache
        self.n_lanes = n_lanes
        self.lora_scale = lora_scale
        self.max_len = max_len
        self.window = window
        self.step_dt = step_dt

    # --- device work --------------------------------------------------------
    def _prefill(self, page: int, prompt) -> tuple:
        tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                                 device=self.device)
        logits, row_cache = mdl.prefill(
            self.params, self.cfg, {"tokens": tokens},
            lora=page_lora(self.cache.pool, page),
            lora_scale=self.lora_scale, window=self.window,
            max_len=self.max_len)
        return int(torch.argmax(logits[0, -1])), row_cache

    @staticmethod
    def _write_lane(batch_cache, row_cache, lane: int) -> None:
        # every cache leaf is (layers, B, ...): copy row 0 into the lane slot.
        for bc, rc in zip(batch_cache["g0"]["self"], row_cache["g0"]["self"]):
            bc[:, lane].copy_(rc[:, 0])

    def _decode(self, batch_cache, tokens, pos, gidx) -> np.ndarray:
        dev = self.device
        logits, _ = mdl.decode_step(
            self.params, self.cfg, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev), batch_cache,
            lora=paged_lora(self.cache.pool, torch.from_numpy(gidx).to(dev)),
            lora_scale=self.lora_scale, window=self.window)
        return torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

    # --- the loop -----------------------------------------------------------
    @torch.no_grad()
    def run(self, trace: List[Request],
            max_steps: Optional[int] = None) -> ServingReport:
        # max_len counts positions; under a window the cache holds
        # min(window, max_len) slots of them
        for req in trace:
            if req.prompt_len + req.gen_len > self.max_len:
                raise ValueError(
                    f"request {req.rid} needs {req.prompt_len + req.gen_len} "
                    f"cache slots, engine has {self.max_len}")
        sched = ContinuousBatchingScheduler(trace, self.cache, self.n_lanes)
        batch_cache = zeros_from_spec(
            mdl.cache_spec(self.cfg, self.n_lanes, self.max_len, self.window),
            self.device)
        tokens = np.zeros(self.n_lanes, np.int64)
        pos = np.zeros(self.n_lanes, np.int64)
        gidx = np.zeros(self.n_lanes, np.int32)

        now = 0.0
        steps = prefills = decode_tokens = 0
        occupancy = 0
        decode_s = 0.0
        t0 = time.perf_counter()
        while not sched.done():
            if max_steps is not None and steps >= max_steps:
                break
            jump = sched.idle_jump()
            if jump is not None:
                now = max(now, jump)
            sched.tick(now)
            for lane in sched.admit():
                req = lane.request
                tok, row_cache = self._prefill(lane.page, req.prompt)
                self._write_lane(batch_cache, row_cache, lane.index)
                li = lane.index
                tokens[li] = tok
                pos[li] = req.prompt_len
                gidx[li] = lane.page
                prefills += 1
                # the prompt's last logits already yielded token #1.
                sched.push_token(lane, tok)
            active = [l for l in sched.lanes if l.active]
            if active:
                td = time.perf_counter()
                out_host = self._decode(batch_cache, tokens, pos, gidx)
                decode_s += time.perf_counter() - td
                steps += 1
                occupancy += len(active)
                for lane in active:
                    li = lane.index
                    tokens[li] = out_host[li]
                    pos[li] += 1
                    decode_tokens += 1
                    sched.push_token(lane, int(out_host[li]))
            now += self.step_dt
        wall = time.perf_counter() - t0
        generated = decode_tokens + prefills
        return ServingReport(
            completions=dict(sched.completions), requests=len(trace),
            steps=steps, prefills=prefills, decode_tokens=decode_tokens,
            generated_tokens=generated, wall_s=wall,
            tokens_per_s=generated / wall if wall > 0 else 0.0,
            mean_occupancy=occupancy / steps if steps else 0.0,
            stalls=sched.stalls, cache=self.cache.stats(), decode_s=decode_s)
