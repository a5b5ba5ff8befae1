"""Continuous-batching serving tier (port of ``repro.serve``).

Layered on the functional prefill / decode of ``train/serve.py``:
``RequestQueue`` models the arriving workload, ``SlotManager`` maps live
requests onto a fixed decode batch (insert / evict / recycle cache rows),
``Scheduler`` interleaves prefill with batched vector-position decode, and
``ServeMetrics`` folds the event stream into TTFT / throughput numbers.
``run_oneshot`` is the static-batch baseline.

``paged`` adds the block-granular KV allocator (``BlockPool`` /
``BlockTable`` / ``PagedSlotManager``): attention caches become a shared
pool of ``block_size``-token blocks mapped through per-request tables, so
cache memory scales with live tokens instead of worst-case reservations;
``ServeConfig(kv="paged")`` switches the scheduler over.
"""

from repro_torch.serve.metrics import RequestRecord, ServeMetrics
from repro_torch.serve.paged import (BlockPool, BlockTable, PagedSlotManager,
                                     PoolExhausted, PreemptedSlot)
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler, ServeConfig, run_oneshot
from repro_torch.serve.slots import Slot, SlotManager

__all__ = [
    "BlockPool",
    "BlockTable",
    "PagedSlotManager",
    "PoolExhausted",
    "PreemptedSlot",
    "Request",
    "RequestQueue",
    "RequestRecord",
    "Scheduler",
    "ServeConfig",
    "ServeMetrics",
    "Slot",
    "SlotManager",
    "run_oneshot",
]
