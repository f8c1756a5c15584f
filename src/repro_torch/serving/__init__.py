"""Multi-tenant LoRA serving on the card (port of `src/repro/serving/`).

* `serving/cache.py`     -- paged device-resident adapter cache (LRU by
  client id, host-side spill, hit/miss/eviction counters).
* `serving/trace.py`     -- seeded synthetic multi-tenant request traces.
* `serving/scheduler.py` -- continuous batching over fixed decode lanes.
* `serving/engine.py`    -- per-request prefill + grouped-adapter decode
  through the CUDA kernel of `kernels/lora_matmul.py`.
"""
from repro_torch.serving.cache import (HostAdapterStore, PagedAdapterCache,
                                       page_lora, paged_lora)
from repro_torch.serving.engine import ServingEngine, ServingReport
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Lane
from repro_torch.serving.trace import Request, synth_trace

__all__ = [
    "ContinuousBatchingScheduler", "HostAdapterStore", "Lane",
    "PagedAdapterCache", "Request", "ServingEngine", "ServingReport",
    "page_lora", "paged_lora", "synth_trace",
]
