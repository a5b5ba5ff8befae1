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

``kv="paged"`` serves from the paged allocator (``serve/paged.py``): the
attention cache is a pool of ``block_size``-token blocks read through
per-slot block tables, admission holds back a ``watermark`` share of the
pool, the youngest slot is preempted when the pool runs dry, and
preempted requests resume first, in seniority order (``preempt_every``
forces a preemption every N decode steps, a drill).  On the same schedule
(``watermark=0``, the default pool, ``max_len`` a whole number of blocks)
paged logits equal the contiguous tier's bit for bit: the gathered view
has the contiguous cache's length, so the same kernels run on the same
values.

``run_oneshot`` is the static-batch baseline: FIFO rounds of ``batch``
requests prefilled together and decoded in lockstep until the slowest
request in the round finishes.

Under a ("data", "model") mesh (``mesh=``; the reference's
``Scheduler(..., mesh=mesh)``, scheduler.py:109-116) every rank runs this
same host loop on a ``torch.distributed`` world of one process a card,
and makes the same decisions: the queue, admission and eviction are
deterministic, and where requests are still to arrive the ranks agree on
the clock (the largest of theirs).  The parameters are this rank's parts
(``param_specs``), the slot cache this rank's part (``cache_specs``:
slots over the data axes, KV heads or sequence over 'model').  Each
packed or chunked prefill runs on every rank of the data axes, on the
whole group, and each keeps the rows of the slots it holds; each decode
step runs this rank's slot rows, and the sampled logits are all-gathered
over the data axes so every rank advances every slot.  Each rank records
its own ``ServeMetrics`` (report rank 0's).  On a mesh of one rank every
collective is the identity and the run is bitwise the one-card
scheduler's.  The families without a tensor-parallel forward and the
paged pool (refused by the reference too) serve on one card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree
from repro_torch.device import DeviceLike
from repro_torch.models import model_fns
from repro_torch.models import tp as tp_lib
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paged import PagedSlotManager, PreemptedSlot
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.slots import SlotManager
from repro_torch.train import serve as serve_fns

# the reference's refusal (src/repro/serve/scheduler.py:110-113)
PAGED_MESH = ("paged pool sharding is follow-up work; serve paged caches "
              "single-process for now")


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
    # ---- the paged KV allocator (serve/paged.py) ----
    kv: str = "contiguous"            # "contiguous" | "paged"
    block_size: int = 16              # tokens per cache block (paged)
    pool_blocks: Optional[int] = None   # pool size; None = the contiguous
                                        # reservation's bytes
    watermark: float = 0.05           # free-block share held back from
                                      # admission (preemption headroom)
    preempt_every: Optional[int] = None   # drill: preempt the youngest
                                          # slot every N decode steps
                                          # (paged only)


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
    """One model, one fixed decode batch, many requests
    (``repro.serve.scheduler.Scheduler``, scheduler.py:71).  The slot cache
    lives on the parameters' device; an explicit ``device`` must name
    it."""

    def __init__(self, cfg, params, scfg: ServeConfig = ServeConfig(), *,
                 mesh=None, device: DeviceLike = None):
        if scfg.kv not in ("contiguous", "paged"):
            raise ValueError(f"kv must be contiguous|paged, got {scfg.kv!r}")
        self.paged = scfg.kv == "paged"
        if scfg.preempt_every is not None and not self.paged:
            raise ValueError("preempt_every drills need kv='paged' "
                             "(contiguous slots cannot resume)")
        # under a mesh: the mesh seen from this rank (module docstring)
        self.ctx: Optional[serve_fns.MeshContext] = None
        if mesh is not None:
            if self.paged:
                raise NotImplementedError(PAGED_MESH)
            self.ctx = serve_fns.mesh_context(cfg, mesh)
            params = serve_fns.local_params(params, self.ctx)
        self.device = _params_device(params)
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"parameters are on {self.device}, not on the "
                             f"requested device {device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.prefix = _prefix_len(cfg)
        if self.paged:
            self.slots: SlotManager = PagedSlotManager(
                cfg, scfg.num_slots, scfg.max_len,
                block_size=scfg.block_size, pool_blocks=scfg.pool_blocks,
                cache_dtype=scfg.cache_dtype, enc_len=scfg.enc_len,
                device=self.device)
        else:
            self.slots = SlotManager(cfg, scfg.num_slots, scfg.max_len,
                                     cache_dtype=scfg.cache_dtype,
                                     enc_len=scfg.enc_len,
                                     device=self.device, mesh=mesh)
        # paged slots round max_len up to whole blocks; every staging cache
        # takes the same length, so the gathered view matches it
        self.max_len = self.slots.max_len
        # attention leaves pooled?  (pure-recurrent families keep the
        # contiguous cache and gain only preempt / resume)
        self._use_tables = self.paged and self.slots.paged
        self._wm = (max(1, round(scfg.watermark * self.slots.pool.num_blocks))
                    if self.paged and scfg.watermark > 0 else 0)
        # hybrid recurrent leaves sit at the slot batch, so a batch-1
        # chunked prefill cannot stream into the live cache: hybrids stage
        # chunked prompts contiguously and scatter on insert
        self._direct_chunk = self._use_tables and cfg.family != "hybrid"
        self._resume: List[PreemptedSlot] = []   # preempted, awaiting blocks
        self._steps = 0                          # decode steps (drill clock)
        if self.ctx is not None:
            # prefill runs the whole group on every data rank; decode this
            # rank's slots, ranked over the data axes only where they split
            self._prefill_ctx = self.ctx.whole_batch()
            first, end = self.slots.rows
            self._decode_ctx = self.ctx if end - first < scfg.num_slots \
                else self._prefill_ctx

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
        if self.ctx is not None:
            kw["ctx"] = self._prefill_ctx
        return serve_fns.prefill_fn(self.cfg, self.params, toks,
                                    self.max_len,
                                    cache_dtype=self.scfg.cache_dtype, **kw)

    def _prefill_chunked(self, req: Request):
        """Stream one long prompt through the cache in chunk_len pieces."""
        c = self.scfg.chunk_len
        kw, mesh_kw = {}, {}
        if self.ctx is not None:
            kw = dict(tp=self.ctx.tp)
            mesh_kw = dict(ctx=self._prefill_ctx, max_len=self.max_len)
        cache = model_fns(self.cfg).init_cache(
            self.cfg, 1, self.max_len, self.scfg.cache_dtype,
            device=self.device, **kw)
        toks = np.asarray(req.tokens)[None]
        logits = None
        for off in range(0, req.prompt_len, c):
            logits, cache = serve_fns.prefill_chunk_fn(
                self.cfg, self.params, self._tensor(toks[:, off:off + c]),
                cache, off, **mesh_kw)
        return logits, cache

    def _prefill_chunked_paged(self, req: Request):
        """Stream one long prompt straight into pool blocks through its
        block table, with no contiguous staging cache (the paged
        long-prompt admission path): (logits, table)."""
        c = self.scfg.chunk_len
        table = self.slots.new_table(req.prompt_len + 1)
        bt = self._tensor(table.padded()[None])
        toks = np.asarray(req.tokens)[None]
        logits = None
        for off in range(0, req.prompt_len, c):
            logits, self.slots.cache = serve_fns.prefill_chunk_fn(
                self.cfg, self.params, self._tensor(toks[:, off:off + c]),
                self.slots.cache, off, block_tables=bt)
        return logits, table

    def _admit(self, group: List[Request], metrics: ServeMetrics,
               t0: float, chunked: bool) -> None:
        table = None
        if chunked and self._direct_chunk:
            logits, table = self._prefill_chunked_paged(group[0])
        elif chunked:
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
            if table is not None:
                i = self.slots.insert_prefilled(r, table, int(first[row]),
                                                pos)
            else:
                i = self.slots.insert(r, rcache, row, int(first[row]), pos)
            metrics.on_admit(r, now, int(first[row]),
                             logits_np[row] if logits_np is not None
                             else None)
            if (r.max_new_tokens <= 1
                    or (r.eos_id is not None and first[row] == r.eos_id)):
                metrics.on_done(r.rid, now)
                self.slots.evict(i)

    # ----------------------------------------------------- preempt / resume

    def _requeue(self, ps: PreemptedSlot, metrics: ServeMetrics,
                 t0: float) -> None:
        metrics.on_preempt(ps.request.rid, time.perf_counter() - t0)
        self._resume.append(ps)
        self._resume.sort(key=lambda p: p.seq)   # seniority order

    def _admit_resumes(self, metrics: ServeMetrics, t0: float) -> None:
        """Re-admit preempted requests, before any new admission: they
        hold seniority and already consumed prefill work.  Attention
        families rebuild their cache by re-prefilling prompt + generated
        tokens (hybrids then restore their saved recurrent rows);
        pure-recurrent families restore the exact saved state rows with
        no recompute."""
        while self._resume and self.slots.num_free > 0:
            ps = self._resume[0]
            r = ps.request
            # tokens the model has consumed so far (the last sampled token
            # has not been fed yet: it is the resumed slot's next input)
            n_fed = r.prompt_len + ps.generated - 1
            pos = n_fed + self.prefix
            if self._use_tables:
                need = self.slots.blocks_for(pos + 1)
                head = 0 if self.slots.num_active == 0 else self._wm
                if self.slots.pool.num_free < need + head:
                    break                     # wait for blocks to free up
            self._resume.pop(0)
            last = int(ps.tokens[-1])
            if not self.slots.paged:
                self.slots.insert(r, None, 0, last, pos, resume=ps)
                continue
            toks = np.concatenate([np.asarray(r.tokens, np.int32),
                                   np.asarray(ps.tokens[:-1], np.int32)])
            req2 = dataclasses.replace(r, tokens=toks)
            if (self.scfg.chunk_len is not None
                    and len(toks) > self.scfg.chunk_len):
                if self._direct_chunk:
                    _, table = self._prefill_chunked_paged(req2)
                    self.slots.insert_prefilled(r, table, last, pos,
                                                resume=ps)
                    continue
                _, rcache = self._prefill_chunked(req2)
            else:
                _, rcache = self._prefill_group([req2])
            self.slots.insert(r, rcache, 0, last, pos, resume=ps)

    # -------------------------------------------------------------- decode

    def _decode_step(self, metrics: ServeMetrics, t0: float) -> None:
        slots = self.slots
        for i, s in slots.active():     # cache-exhausted: truncate
            if slots.out_of_cache(i):
                metrics.on_done(s.request.rid, time.perf_counter() - t0)
                slots.evict(i)
        if self.paged:
            pe = self.scfg.preempt_every
            if pe and self._steps and self._steps % pe == 0 \
                    and slots.num_active >= 2:
                # drill: force one preempt → requeue → resume cycle (the
                # >= 2 guard keeps the fleet progressing between drills)
                self._requeue(slots.preempt(slots._youngest()), metrics, t0)
            # grow every table to cover its next write; preempt the
            # youngest when the pool runs dry
            for ps in slots.prepare_decode():
                self._requeue(ps, metrics, t0)
        n_active = slots.num_active
        if n_active == 0:
            return
        t_start = time.perf_counter()
        if self.ctx is None:
            tables = (self._tensor(slots.block_tables()) if self._use_tables
                      else None)
            logits, slots.cache = serve_fns.decode_fn(
                self.cfg, self.params, self._tensor(slots.tok), slots.cache,
                self._tensor(slots.pos), block_tables=tables)
        else:
            logits = self._decode_mesh()
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()  # host sync
        self._steps += 1
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

    def _decode_mesh(self) -> torch.Tensor:
        """One decode step of this rank's slot rows under the mesh: their
        logits, gathered over the data axes where the slots split over
        them, so every rank holds (num_slots, vocab) in slot order."""
        slots = self.slots
        first, end = slots.rows
        logits, slots.cache = serve_fns.decode_fn(
            self.cfg, self.params, self._tensor(slots.tok[first:end]),
            slots.cache, self._tensor(slots.pos[first:end]),
            ctx=self._decode_ctx, max_len=self.max_len)
        dp = self._decode_ctx.dp
        if dp is None:
            return logits
        return tp_lib.gather_over_data(logits, dp).reshape(
            self.scfg.num_slots, -1)

    def _now(self, t0: float, queue: RequestQueue) -> float:
        """Seconds since ``t0``; under a mesh, while requests are still to
        arrive, the largest of every rank's, so every rank admits the same
        requests at the same step."""
        now = time.perf_counter() - t0
        if self.ctx is None or self.ctx.mesh.size() == 1 or \
                queue.next_arrival() is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    # ----------------------------------------------------------------- run

    @torch.inference_mode()
    def run(self, queue: RequestQueue) -> ServeMetrics:
        """Serve the queue to completion; returns the metrics sink."""
        metrics = ServeMetrics(self.scfg.num_slots)
        t0 = time.perf_counter()
        while True:
            queue.poll(self._now(t0, queue))
            self._admit_resumes(metrics, t0)   # preempted hold seniority
            while self.slots.num_free > 0 and queue.num_ready > 0:
                head = queue.peek()
                pos0 = head.prompt_len + self.prefix
                if pos0 >= self.max_len:
                    # over-length: the prompt alone fills the cache.  Reject
                    # at admission instead of failing in insert()
                    r = queue.pop_group(1, self.scfg.chunk_len)[0]
                    metrics.on_reject(r, time.perf_counter() - t0)
                    continue
                cap = min(self.slots.num_free, self.scfg.prefill_pack)
                if self._use_tables:
                    # watermark admission: admit only what the free pool
                    # covers, holding back headroom for in-flight growth
                    need = self.slots.blocks_for(pos0 + 1)
                    afford = (self.slots.pool.num_free - self._wm) // need
                    if afford < 1:
                        if (self.slots.num_active == 0
                                and not self._resume
                                and self.slots.pool.num_free >= need):
                            afford = 1     # progress guarantee
                        else:
                            break
                    cap = min(cap, afford)
                group = queue.pop_group(cap, self.scfg.chunk_len)
                chunked = (self.scfg.chunk_len is not None
                           and group[0].prompt_len > self.scfg.chunk_len)
                self._admit(group, metrics, t0, chunked)
            if self.slots.num_active == 0 and not self._resume:
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
