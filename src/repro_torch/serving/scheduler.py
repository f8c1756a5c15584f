"""Continuous batching over fixed decode lanes (pure Python; the port's own
copy of `src/repro/serving/scheduler.py`).

The scheduler owns the *when* of serving, the way the reference's virtual
clock owns the when of federated training: requests
sit in a heapq event queue ordered by `(arrival, rid)`, move to a FIFO
waiting queue once their virtual arrival time has passed, and are
admitted into decode lanes as lanes free up.  A lane retires the moment
its request's decode budget is spent — the freed lane is refilled from
the waiting queue on the very next admission pass (that refill-without-
draining-the-batch is what "continuous batching" means).

Admission couples to the paged adapter cache: a request only enters a
lane if `cache.acquire(client)` can pin a page (hit, or miss + upload,
or miss + evict an unpinned LRU victim).  When every page is pinned by
other active lanes, the head of the waiting queue stalls — FIFO order is
preserved, nothing overtakes — until a retirement releases a pin.  With
pages >= 1 this cannot deadlock: once all lanes drain, every pin is
released and the head request admits.

The scheduler is pure host bookkeeping; `serving.engine` drives the
device work and calls back into `push_token` with each lane's sampled
token.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.cache import PagedAdapterCache
from repro_torch.serving.trace import Request


@dataclasses.dataclass
class Lane:
    """One decode slot of the fixed-size batch."""
    index: int
    request: Optional[Request] = None
    page: int = 0                 # adapter page while active; 0 when idle
    pos: int = 0                  # next decode position (== tokens cached)
    remaining: int = 0            # decode steps left before retirement
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.request is not None


class ContinuousBatchingScheduler:
    """Request admission/retirement over `n_lanes` decode lanes.

    Event flow per engine step:
      1. `tick(now)`  — drain arrivals whose time has come into `waiting`.
      2. `admit()`    — FIFO-fill free lanes while the cache can pin pages;
                        returns the newly-filled lanes for prefill.
      3. engine decodes one token for every active lane, then calls
         `push_token(lane, tok)` per lane; a lane whose budget hits zero
         retires (pin released, completion recorded) and is free for the
         next `admit`.
    """

    def __init__(self, trace: List[Request], cache: PagedAdapterCache,
                 n_lanes: int):
        if n_lanes < 1:
            raise ValueError(f"need at least one decode lane, got {n_lanes}")
        self.cache = cache
        self.lanes = [Lane(index=i) for i in range(n_lanes)]
        self._arrivals: List[Tuple[float, int, Request]] = [
            (r.arrival, r.rid, r) for r in trace]
        heapq.heapify(self._arrivals)
        self.waiting: Deque[Request] = deque()
        self.completions: Dict[int, List[int]] = {}   # rid -> generated tokens
        self.admitted = 0
        self.retired = 0
        self.stalls = 0          # admission passes blocked on a pinned-full cache

    # --- event queue --------------------------------------------------------
    def tick(self, now: float) -> None:
        """Move every request with arrival <= now into the waiting queue."""
        while self._arrivals and self._arrivals[0][0] <= now:
            self.waiting.append(heapq.heappop(self._arrivals)[2])

    def next_arrival(self) -> Optional[float]:
        return self._arrivals[0][0] if self._arrivals else None

    def idle_jump(self) -> Optional[float]:
        """When nothing is waiting or active, jump virtual time to the next
        arrival (the VirtualClock pull-completions idiom); None when done."""
        if self.waiting or any(l.active for l in self.lanes):
            return None
        return self.next_arrival()

    # --- admission ----------------------------------------------------------
    def free_lanes(self) -> List[Lane]:
        return [l for l in self.lanes if not l.active]

    def admit(self) -> List[Lane]:
        """FIFO-admit waiting requests into free lanes, pinning adapter
        pages.  Stops at the first request whose page cannot be pinned
        (strict FIFO: later requests never overtake a stalled head)."""
        filled: List[Lane] = []
        free = self.free_lanes()
        while free and self.waiting:
            req = self.waiting[0]
            page = self.cache.acquire(req.client)
            if page is None:
                self.stalls += 1
                break
            self.waiting.popleft()
            lane = free.pop(0)
            lane.request = req
            lane.page = page
            lane.pos = req.prompt_len
            # prefill emits the first token; the decode loop owes the rest.
            lane.remaining = req.gen_len - 1
            lane.tokens = []
            self.admitted += 1
            filled.append(lane)
        return filled

    # --- decode/retire ------------------------------------------------------
    def push_token(self, lane: Lane, token: int) -> None:
        assert lane.active, f"push_token on idle lane {lane.index}"
        lane.tokens.append(int(token))
        lane.pos += 1
        assert len(lane.tokens) <= lane.request.gen_len, "decode budget overrun"
        if lane.remaining == 0:
            self._retire(lane)
        else:
            lane.remaining -= 1

    def _retire(self, lane: Lane) -> None:
        req = lane.request
        assert len(lane.tokens) == req.gen_len, (len(lane.tokens), req.gen_len)
        self.completions[req.rid] = lane.tokens
        self.cache.release(req.client)
        lane.request = None
        lane.page = 0            # idle lanes decode against page 0, discarded
        lane.remaining = 0
        lane.tokens = []
        self.retired += 1

    # --- termination --------------------------------------------------------
    def done(self) -> bool:
        return (not self._arrivals and not self.waiting
                and not any(l.active for l in self.lanes))
