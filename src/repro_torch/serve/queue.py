"""Request queue for the continuous-batching serving tier (port of
``repro.serve.queue``; numpy only, the reference's draws in its order, so
both packages build the same workload from a seed).

``Request`` is one generation job (prompt tokens, budget, optional enc-dec
frames); ``RequestQueue`` holds the pending workload ordered by arrival
time and hands ready requests to the scheduler in FIFO order, with two
scheduler-facing niceties:

  * ``pop_group`` pulls up to N *equal-prompt-length* requests from the
    ready front so short prompts prefill packed in one batched call
    (padding would break the bit-parity guarantee, so only exact-length
    groups pack);
  * ``synthetic`` builds a deterministic open-loop workload — Poisson-ish
    arrivals at a given rate and a categorical prompt-length mix — so
    benchmarks and tests replay the exact same traffic.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.  ``max_new_tokens`` counts the prefill's
    first sampled token; ``frames`` feeds enc-dec / audio-frontend archs."""
    rid: int
    tokens: np.ndarray                 # (prompt_len,) int32 prompt ids
    max_new_tokens: int
    arrival: float = 0.0               # seconds since workload start
    eos_id: Optional[int] = None
    frames: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


class RequestQueue:
    """Arrival-ordered pending set + FIFO ready deque."""

    def __init__(self, requests: Sequence[Request] = ()):
        self._pending: List[Request] = sorted(requests,
                                              key=lambda r: r.arrival)
        self._ready: Deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._pending) + len(self._ready)

    @property
    def num_ready(self) -> int:
        return len(self._ready)

    @property
    def drained(self) -> bool:
        return not self._pending and not self._ready

    def push(self, req: Request) -> None:
        """Admit a request that is ready right now (tests / REPL use)."""
        self._ready.append(req)

    def peek(self) -> Optional[Request]:
        """Front ready request without popping it (the scheduler inspects
        length/block needs before committing to admission)."""
        return self._ready[0] if self._ready else None

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival if self._pending else None

    def poll(self, now: float) -> int:
        """Move requests whose arrival time has passed into the ready
        deque; returns how many arrived."""
        n = 0
        while self._pending and self._pending[0].arrival <= now:
            self._ready.append(self._pending.pop(0))
            n += 1
        return n

    def pop_group(self, max_n: int,
                  chunk_len: Optional[int] = None) -> List[Request]:
        """Pop up to ``max_n`` ready requests sharing the front request's
        prompt length (exact-length prefill packing).  Requests longer than
        ``chunk_len`` take the chunked-prefill path and always go alone."""
        if not self._ready:
            return []
        head = self._ready.popleft()
        group = [head]
        if chunk_len is not None and head.prompt_len > chunk_len:
            return group
        keep: List[Request] = []
        while self._ready and len(group) < max_n:
            r = self._ready.popleft()
            if r.prompt_len == head.prompt_len and (
                    chunk_len is None or r.prompt_len <= chunk_len):
                group.append(r)
            else:
                keep.append(r)
        self._ready.extendleft(reversed(keep))
        return group

    # ------------------------------------------------------------ workloads

    @classmethod
    def synthetic(cls, n_requests: int, vocab: int, *,
                  prompt_lens: Sequence[int] = (8, 16, 32),
                  mix: Optional[Sequence[float]] = None,
                  new_tokens: Tuple[int, int] = (4, 32),
                  budgets: Optional[Sequence[int]] = None,
                  rate: Optional[float] = None,
                  frontend_dim: Optional[int] = None,
                  seed: int = 0) -> "RequestQueue":
        """Deterministic mixed-traffic workload.

        ``rate`` (requests/sec) draws exponential inter-arrival gaps
        (open-loop Poisson process); ``rate=None`` means everything is
        already waiting at t=0.  ``mix`` weights the prompt-length
        categories.  ``budgets`` replaces the uniform ``new_tokens``
        range with a categorical draw (bimodal mixes are the workloads
        where lockstep decoding wastes the most).  ``frontend_dim`` attaches per-request frames (enc-dec
        archs; frame length == prompt length, uniform across the workload
        so the cross-attention caches align slot-for-slot).
        """
        rng = np.random.default_rng(seed)
        probs = None
        if mix is not None:
            probs = np.asarray(mix, np.float64)
            probs = probs / probs.sum()
        lens = rng.choice(np.asarray(prompt_lens), size=n_requests, p=probs)
        if budgets is not None:   # categorical budget mix (e.g. bimodal)
            budgets = rng.choice(np.asarray(budgets), size=n_requests)
        else:
            lo, hi = new_tokens
            budgets = rng.integers(lo, hi + 1, size=n_requests)
        arrivals = np.zeros(n_requests)
        if rate is not None:
            arrivals = np.cumsum(rng.exponential(1.0 / rate,
                                                 size=n_requests))
        reqs = []
        for i in range(n_requests):
            toks = rng.integers(0, vocab, size=int(lens[i])).astype(np.int32)
            frames = None
            if frontend_dim is not None:
                frames = (rng.standard_normal(
                    (int(lens[i]), frontend_dim)) * 0.1).astype(np.float32)
            reqs.append(Request(rid=i, tokens=toks,
                                max_new_tokens=int(budgets[i]),
                                arrival=float(arrivals[i]), frames=frames))
        return cls(reqs)
