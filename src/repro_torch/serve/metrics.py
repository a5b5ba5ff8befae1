"""Serving metrics (port of ``repro.serve.metrics``): per-request TTFT /
latency plus fleet-level throughput.

The scheduler reports events (first token, decode tokens, completion,
decode-step wall times, slot occupancy samples); ``summary()`` folds them
into time-to-first-token, per-token decode latency, tokens/sec (and per
card: the scheduler serves on one), and mean slot occupancy.  Timestamps
are seconds relative to the scheduler's t0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def _median(xs: List[float]) -> float:
    return float(np.median(xs)) if xs else 0.0


def _p90(xs: List[float]) -> float:
    return float(np.percentile(xs, 90)) if xs else 0.0


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    prompt_len: int
    requested: int
    t_first: Optional[float] = None      # TTFT timestamp
    t_done: Optional[float] = None
    generated: int = 0
    tokens: Optional[List[int]] = None
    logits: Optional[List[np.ndarray]] = None   # parity capture (tests)
    rejected: bool = False               # over-length, never admitted
    preemptions: int = 0                 # paged pool preempt→resume cycles

    @property
    def ttft(self) -> float:
        return self.t_first - self.arrival

    @property
    def per_token_latency(self) -> float:
        """Mean decode latency per token after the first (0 for 1-token
        requests)."""
        if self.generated <= 1 or self.t_done is None:
            return 0.0
        return (self.t_done - self.t_first) / (self.generated - 1)


class ServeMetrics:
    """Event sink for one scheduler run."""

    chips = 1                                    # cards served on

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.requests: Dict[int, RequestRecord] = {}
        self.decode_step_s: List[float] = []     # batched-step wall times
        self.prefill_s: List[float] = []         # per prefill call
        self.active_per_step: List[int] = []
        self.decode_steps = 0
        self.wall_s = 0.0
        # per-decode-step (reserved_tokens, used_tokens, pool_blocks,
        # used_blocks) samples from SlotManager.pool_stats()
        self.pool_samples: List[tuple] = []
        self.preemptions = 0                     # fleet-level preempt count

    # -------------------------------------------------------------- events

    def on_admit(self, req, now: float, first_token: int,
                 logits_row: Optional[np.ndarray] = None) -> None:
        rec = RequestRecord(rid=req.rid, arrival=req.arrival,
                            prompt_len=req.prompt_len,
                            requested=req.max_new_tokens,
                            t_first=now, generated=1,
                            tokens=[int(first_token)])
        if logits_row is not None:
            rec.logits = [logits_row]
        self.requests[req.rid] = rec

    def on_token(self, rid: int, token: int,
                 logits_row: Optional[np.ndarray] = None) -> None:
        rec = self.requests[rid]
        rec.generated += 1
        rec.tokens.append(int(token))
        if logits_row is not None:
            rec.logits.append(logits_row)

    def on_done(self, rid: int, now: float) -> None:
        self.requests[rid].t_done = now

    def on_reject(self, req, now: float) -> None:
        """Over-length request turned away at admission: recorded as done
        with the ``rejected`` marker, zero tokens, no TTFT."""
        self.requests[req.rid] = RequestRecord(
            rid=req.rid, arrival=req.arrival, prompt_len=req.prompt_len,
            requested=req.max_new_tokens, t_done=now, rejected=True)

    def on_preempt(self, rid: int, now: float) -> None:
        self.requests[rid].preemptions += 1
        self.preemptions += 1

    def on_decode_step(self, dt: float, n_active: int) -> None:
        self.decode_steps += 1
        self.decode_step_s.append(dt)
        self.active_per_step.append(n_active)

    def on_pool_sample(self, reserved: int, used: int,
                       pool_blocks: int, used_blocks: int) -> None:
        self.pool_samples.append((reserved, used, pool_blocks, used_blocks))

    # ------------------------------------------------------------- summary

    @property
    def total_generated(self) -> int:
        return sum(r.generated for r in self.requests.values())

    def summary(self) -> Dict[str, float]:
        ttfts = [r.ttft for r in self.requests.values()
                 if r.t_first is not None]
        per_tok = [r.per_token_latency for r in self.requests.values()
                   if r.generated > 1]
        occ = (float(np.mean(self.active_per_step)) / self.num_slots
               if self.active_per_step else 0.0)
        toks = self.total_generated
        tps = toks / self.wall_s if self.wall_s > 0 else 0.0
        out = {
            "requests": len(self.requests),
            "tokens": toks,
            "wall_s": self.wall_s,
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps / self.chips,
            "ttft_ms_median": _median(ttfts) * 1e3,
            "ttft_ms_p90": _p90(ttfts) * 1e3,
            "per_token_ms_median": _median(per_tok) * 1e3,
            "decode_step_us_median": _median(self.decode_step_s) * 1e6,
            "decode_step_us_p90": _p90(self.decode_step_s) * 1e6,
            "decode_steps": self.decode_steps,
            "slot_occupancy": occ,
            "concurrent_mean": (float(np.mean(self.active_per_step))
                                if self.active_per_step else 0.0),
            "concurrent_peak": (int(max(self.active_per_step))
                                if self.active_per_step else 0),
            "rejected": sum(1 for r in self.requests.values() if r.rejected),
            "preemptions": self.preemptions,
        }
        if self.pool_samples:
            reserved = np.asarray([s[0] for s in self.pool_samples], float)
            used = np.asarray([s[1] for s in self.pool_samples], float)
            pool_blocks = self.pool_samples[-1][2]
            used_blocks = np.asarray([s[3] for s in self.pool_samples],
                                     float)
            # fragmentation: fraction of reserved cache tokens not holding
            # a live token (block-internal waste for paged, whole idle-slot
            # rows for contiguous)
            nz = reserved > 0
            out["frag_pct"] = (float(np.mean(
                (reserved[nz] - used[nz]) / reserved[nz])) * 100.0
                if nz.any() else 0.0)
            out["pool_blocks"] = pool_blocks
            out["pool_occupancy"] = (float(np.mean(used_blocks))
                                     / pool_blocks if pool_blocks else 0.0)
        return out
