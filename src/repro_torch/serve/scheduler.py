"""Continuous-batching scheduler (port of the contiguous tier of
``repro.serve.scheduler``): interleaved prefill + batched decode.

    poll queue -> prefill waiting requests into free slots -> one batched
    decode step over ALL slots (per-slot positions) -> sample / advance /
    evict finished -> repeat

Prefill policy: ready requests with the *same* prompt length pack into one
batched prefill call (up to ``prefill_pack``); prompts longer than
``chunk_len`` stream through ``prefill_chunk_fn`` in ``chunk_len``-token
pieces and occupy the prefill lane alone.  Decode runs at the fixed slot
batch with the vector-``pos`` decode path, so every slot advances at its
own depth.  A served request's logits equal, bit for bit, the same request
replayed alone at the shapes it was served at (its prefill group size and
row, or batch 1 and the same chunks; decode at ``num_slots`` in its slot
row): row i of a batched op does not read the other rows.  A batch-1 solo
run differs by rounding where a library picks its reduction by batch size
(tests/test_torch_serve_tier.py measures it).

Everything runs under ``torch.inference_mode()``; the greedy
``argmax(...).cpu()`` is a step's one host sync, and ``decode_step_s``
times the step up to it.

``run_oneshot`` is the static-batch baseline: FIFO rounds of ``batch``
requests prefilled together and decoded in lockstep until the slowest
request in the round finishes.

The paged allocator (``kv="paged"``, ``preempt_every``) is ROADMAP item
10b; serving under a mesh (``mesh=``) needs the tensor-parallel forward,
ROADMAP item 6.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.device import DeviceLike
from repro_torch.models import layers, model_fns
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.slots import SlotManager
from repro_torch.train import serve as serve_fns

MESH = ("serving under a mesh needs the tensor-parallel forward, ROADMAP "
        "item 6")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-harness knobs (decode batch geometry + prefill policy)."""
    num_slots: int = 8
    max_len: int = 128            # per-slot cache rows (prefix+prompt+new)
    prefill_pack: int = 4         # max equal-length prompts per prefill
    chunk_len: Optional[int] = None   # chunked prefill above this length
    cache_dtype: Any = torch.bfloat16
    enc_len: Optional[int] = None     # enc-dec: uniform encoder length
    record_logits: bool = False       # keep per-token logits (parity tests)
    # the paged KV allocator (kv="paged") and its preemption drill are
    # ROADMAP item 10b: anything but the defaults raises
    kv: str = "contiguous"
    preempt_every: Optional[int] = None


def _params_device(params) -> torch.device:
    """The one device every parameter lives on."""
    devices = {v.device for _, v in tree.flatten(params)}
    if len(devices) != 1:
        raise ValueError(f"parameters span devices {sorted(map(str, devices))}")
    return devices.pop()


def _prefix_len(cfg) -> int:
    """Cache positions a frontend prefix takes before the prompt."""
    return cfg.frontend_len if cfg.frontend is not None and not cfg.encdec \
        else 0


def _frontend_key(cfg) -> Optional[str]:
    if not (cfg.encdec or cfg.frontend is not None):
        return None
    return "patches" if cfg.frontend == "patch" else "frames"


class Scheduler:
    """One model, one fixed decode batch, many requests.  The slot cache
    lives on the parameters' device; an explicit ``device`` must name
    it."""

    def __init__(self, cfg, params, scfg: ServeConfig = ServeConfig(), *,
                 mesh=None, device: DeviceLike = None):
        if scfg.kv not in ("contiguous", "paged"):
            raise ValueError(f"kv must be contiguous|paged, got {scfg.kv!r}")
        if scfg.kv == "paged" or scfg.preempt_every is not None:
            raise NotImplementedError(layers.PAGED)
        if mesh is not None:
            raise NotImplementedError(MESH)
        self.device = _params_device(params)
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"parameters are on {self.device}, not on the "
                             f"requested device {device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.prefix = _prefix_len(cfg)
        self.slots = SlotManager(cfg, scfg.num_slots, scfg.max_len,
                                 cache_dtype=scfg.cache_dtype,
                                 enc_len=scfg.enc_len, device=self.device)
        self.max_len = self.slots.max_len

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- prefill

    def _prefill_group(self, group: List[Request]):
        """Batched prefill of equal-length prompts -> (logits, cache)."""
        toks = self._tensor(np.stack([r.tokens for r in group]))
        kw = {}
        key = _frontend_key(self.cfg)
        if key is not None:
            kw[key] = self._tensor(np.stack([r.frames for r in group]))
        return serve_fns.prefill_fn(self.cfg, self.params, toks,
                                    self.max_len,
                                    cache_dtype=self.scfg.cache_dtype, **kw)

    def _prefill_chunked(self, req: Request):
        """Stream one long prompt through the cache in chunk_len pieces."""
        c = self.scfg.chunk_len
        cache = model_fns(self.cfg).init_cache(
            self.cfg, 1, self.max_len, self.scfg.cache_dtype,
            device=self.device)
        toks = np.asarray(req.tokens)[None]
        logits = None
        for off in range(0, req.prompt_len, c):
            logits, cache = serve_fns.prefill_chunk_fn(
                self.cfg, self.params, self._tensor(toks[:, off:off + c]),
                cache, off)
        return logits, cache

    def _admit(self, group: List[Request], metrics: ServeMetrics,
               t0: float, chunked: bool) -> None:
        if chunked:
            logits, rcache = self._prefill_chunked(group[0])
        else:
            logits, rcache = self._prefill_group(group)
        first = logits.argmax(-1).to(torch.int32).cpu().numpy()
        logits_np = (logits.cpu().numpy()
                     if self.scfg.record_logits else None)
        now = time.perf_counter() - t0
        metrics.prefill_s.append(now)
        for row, r in enumerate(group):
            pos = r.prompt_len + self.prefix
            i = self.slots.insert(r, rcache, row, int(first[row]), pos)
            metrics.on_admit(r, now, int(first[row]),
                             logits_np[row] if logits_np is not None
                             else None)
            if (r.max_new_tokens <= 1
                    or (r.eos_id is not None and first[row] == r.eos_id)):
                metrics.on_done(r.rid, now)
                self.slots.evict(i)

    # -------------------------------------------------------------- decode

    def _decode_step(self, metrics: ServeMetrics, t0: float) -> None:
        slots = self.slots
        for i, s in slots.active():     # cache-exhausted: truncate
            if slots.out_of_cache(i):
                metrics.on_done(s.request.rid, time.perf_counter() - t0)
                slots.evict(i)
        n_active = slots.num_active
        if n_active == 0:
            return
        t_start = time.perf_counter()
        logits, slots.cache = serve_fns.decode_fn(
            self.cfg, self.params, self._tensor(slots.tok), slots.cache,
            self._tensor(slots.pos))
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()  # host sync
        metrics.on_decode_step(time.perf_counter() - t_start, n_active)
        metrics.on_pool_sample(*slots.pool_stats())
        logits_np = (logits.cpu().numpy()
                     if self.scfg.record_logits else None)
        now = time.perf_counter() - t0
        for i, s in slots.active():
            tok = int(nxt[i])
            slots.advance(i, tok)
            r = s.request
            metrics.on_token(r.rid, tok,
                             logits_np[i] if logits_np is not None else None)
            if (s.generated >= r.max_new_tokens
                    or (r.eos_id is not None and tok == r.eos_id)):
                metrics.on_done(r.rid, now)
                slots.evict(i)

    # ----------------------------------------------------------------- run

    @torch.inference_mode()
    def run(self, queue: RequestQueue) -> ServeMetrics:
        """Serve the queue to completion; returns the metrics sink."""
        metrics = ServeMetrics(self.scfg.num_slots)
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            queue.poll(now)
            while self.slots.num_free > 0 and queue.num_ready > 0:
                head = queue.peek()
                if head.prompt_len + self.prefix >= self.max_len:
                    # over-length: the prompt alone fills the cache.  Reject
                    # at admission instead of failing in insert()
                    r = queue.pop_group(1, self.scfg.chunk_len)[0]
                    metrics.on_reject(r, time.perf_counter() - t0)
                    continue
                cap = min(self.slots.num_free, self.scfg.prefill_pack)
                group = queue.pop_group(cap, self.scfg.chunk_len)
                chunked = (self.scfg.chunk_len is not None
                           and group[0].prompt_len > self.scfg.chunk_len)
                self._admit(group, metrics, t0, chunked)
            if self.slots.num_active == 0:
                if queue.drained:
                    break
                nxt = queue.next_arrival()
                if nxt is not None:   # idle until the next arrival
                    time.sleep(min(max(nxt - (time.perf_counter() - t0),
                                       0.0), 0.005))
                continue
            self._decode_step(metrics, t0)
        metrics.wall_s = time.perf_counter() - t0
        return metrics


# ------------------------------------------------------- one-shot baseline

@torch.inference_mode()
def run_oneshot(cfg, params, requests: List[Request], batch: int,
                max_len: int, *, cache_dtype=torch.bfloat16) -> ServeMetrics:
    """Static-batch baseline: FIFO rounds of ``batch`` requests, each
    prefilled together and decoded in lockstep for the round's largest
    budget, on the parameters' device.  Requires a uniform prompt length;
    only requested tokens count toward throughput — the lockstep padding
    is the waste continuous batching removes."""
    lens = {r.prompt_len for r in requests}
    if len(lens) != 1:
        raise ValueError(f"one-shot baseline needs uniform prompts: {lens}")
    device = _params_device(params)
    prefix = _prefix_len(cfg)
    key = _frontend_key(cfg)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    metrics = ServeMetrics(batch)
    t0 = time.perf_counter()
    for start in range(0, len(requests), batch):
        rnd = requests[start:start + batch]
        S = rnd[0].prompt_len
        kw = {} if key is None else \
            {key: tensor(np.stack([r.frames for r in rnd]))}
        logits, cache = serve_fns.prefill_fn(
            cfg, params, tensor(np.stack([r.tokens for r in rnd])), max_len,
            cache_dtype=cache_dtype, **kw)
        tok = logits.argmax(-1).to(torch.int32)
        first = tok.cpu().numpy()
        now = time.perf_counter() - t0
        for row, r in enumerate(rnd):
            metrics.on_admit(r, now, int(first[row]))
            if r.max_new_tokens <= 1:
                metrics.on_done(r.rid, now)
        steps = max(r.max_new_tokens for r in rnd) - 1
        for i in range(steps):
            t_start = time.perf_counter()
            logits, cache = serve_fns.decode_fn(cfg, params, tok, cache,
                                                S + prefix + i)
            tok = logits.argmax(-1).to(torch.int32)
            nxt = tok.cpu().numpy()
            live = [r for r in rnd if r.max_new_tokens > i + 1]
            metrics.on_decode_step(time.perf_counter() - t_start, len(live))
            now = time.perf_counter() - t0
            for row, r in enumerate(rnd):
                if r.max_new_tokens > i + 1:   # still within budget
                    metrics.on_token(r.rid, int(nxt[row]))
                    if r.max_new_tokens == i + 2:
                        metrics.on_done(r.rid, now)
    metrics.wall_s = time.perf_counter() - t0
    return metrics
