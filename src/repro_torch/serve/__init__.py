"""Serving subsystem (port of `repro.serve`).

`Runtime` (serve/runtime.py) is the continuous-batching paged-KV serving
loop — priority admission, preemption-by-page-reclaim, mixed lengths,
staggered arrivals, packed-QT params, bf16 or int8/4-bit pages. `Engine`
(serve/engine.py) is the static-slot equal-length batcher kept as the
equivalence baseline. Both run on the card unless `device="cpu"`.
`recover_runtime` rebuilds a Runtime from its request journal after a
crash.
"""
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import (BlockAllocator, blocks_for,
                                        init_paged_cache, paged_cache_bytes)
from repro_torch.serve.runtime import Runtime, ServeConfig, recover_runtime
from repro_torch.serve.sampler import (sample, sample_batch,
                                       sample_batch_seeded)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["BlockAllocator", "Engine", "Request", "Runtime", "Scheduler",
           "ServeConfig", "blocks_for", "init_paged_cache",
           "paged_cache_bytes", "recover_runtime", "sample", "sample_batch",
           "sample_batch_seeded"]
