"""Continuous-batching serving tier (port of the contiguous tier of
``repro.serve``).

Layered on the functional prefill / decode of ``train/serve.py``:
``RequestQueue`` models the arriving workload, ``SlotManager`` maps live
requests onto a fixed decode batch (insert / evict / recycle cache rows),
``Scheduler`` interleaves prefill with batched vector-position decode, and
``ServeMetrics`` folds the event stream into TTFT / throughput numbers.
``run_oneshot`` is the static-batch baseline.  The paged allocator
(``BlockPool``, ``PagedSlotManager``) is ROADMAP item 10b.
"""

from repro_torch.serve.metrics import RequestRecord, ServeMetrics
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler, ServeConfig, run_oneshot
from repro_torch.serve.slots import Slot, SlotManager

__all__ = [
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
