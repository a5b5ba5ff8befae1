"""Paged KV-cache allocator (port of ``repro.serve.paged``): block-granular
memory for the serving tier.

The contiguous ``SlotManager`` reserves a full ``max_len`` cache row per
slot, so one long request dictates the reservation for every short chat
request and the decode batch is capped by worst-case length.  This module
is the vLLM-style fix (PagedAttention, arXiv:2309.06180):

  ``BlockPool``        fixed pool of ``block_size``-token physical cache
                       blocks: LIFO alloc / free, refcounts, hard
                       double-free detection.  Physical id 0 is the
                       reserved *null block*: free decode slots idle
                       there, no live table ever maps it.
  ``BlockTable``       one request's logical→physical block map; grows
                       block by block as the request decodes, releases
                       wholesale on evict / preempt.
  ``PagedSlotManager`` drop-in ``SlotManager`` (insert / evict / advance /
                       out_of_cache) whose attention leaves live in a
                       (L, P, bs, ...) pool read through per-slot block
                       tables (``models/transformer.py:init_paged_cache``,
                       ``decode_step(..., block_tables=)``).  Recurrent
                       leaves (SSM conv / state, xLSTM memories) are O(1)
                       per slot and stay batch-contiguous; pure-recurrent
                       families keep the whole contiguous cache and gain
                       only the preempt / resume machinery.

Preemption: when the pool cannot cover the next decode write of every
active slot, the *youngest* slot (latest ``Slot.seq``) is evicted and its
sampled tokens (plus its exact recurrent state, where the family has any)
go back to the scheduler to requeue and resume.  Attention caches are
rebuilt by re-prefilling prompt + generated tokens: a resumed request
equals its replay at the shapes it was served at, bit for bit, but not
the unpreempted run, since the re-prefill computes those positions at
another shape.  An xLSTM resume restores the state exactly.

The pool is written in place, as the contiguous tier's caches are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.device import DeviceLike
from repro_torch.models import model_fns
from repro_torch.models.transformer import PAGED_CACHE_KEYS
from repro_torch.serve.queue import Request
from repro_torch.serve.slots import Slot, SlotManager, _write_row

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Raised by ``BlockPool.alloc`` when no free block remains; the caller
    (``PagedSlotManager.prepare_decode``, the scheduler's watermark
    admission) turns it into preemption or held-back admission."""


class BlockPool:
    """Fixed pool of ``num_blocks`` physical cache blocks, ids
    1..num_blocks (0 is the null block, outside the pool), as
    ``repro.serve.paged.BlockPool`` (paged.py:61): a LIFO free list and
    per-block refcounts, so a ``share``d block returns to the free list
    only when its last reference drops."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"pool needs >= 1 block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._ref = np.zeros(num_blocks + 1, np.int32)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"all {self.num_blocks} blocks live")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def share(self, block: int) -> int:
        """Take an extra reference on a live block."""
        if self._ref[block] <= 0:
            raise ValueError(f"block {block} is not live")
        self._ref[block] += 1
        return block

    def free(self, block: int) -> None:
        """Drop one reference; recycle the block when none remain."""
        if block == NULL_BLOCK or not 1 <= block <= self.num_blocks:
            raise ValueError(f"block {block} is not a pool block")
        if self._ref[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)


class BlockTable:
    """One request's logical→physical block map
    (``repro.serve.paged.BlockTable``, paged.py:108).  ``blocks[j]`` backs
    logical positions [j·bs, (j+1)·bs); ``padded()`` is the fixed
    (max_blocks,) row the decode gathers through, unallocated entries on
    the null block."""

    def __init__(self, pool: BlockPool, max_blocks: int):
        self.pool = pool
        self.max_blocks = max_blocks
        self.blocks: List[int] = []

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def grow(self, n: int = 1) -> None:
        """Append ``n`` freshly allocated blocks (``PoolExhausted`` leaves
        the blocks allocated before it in the table, where ``release``
        finds them)."""
        if len(self.blocks) + n > self.max_blocks:
            raise ValueError(
                f"table at {len(self.blocks)}+{n} blocks exceeds max "
                f"{self.max_blocks}")
        for _ in range(n):
            self.blocks.append(self.pool.alloc())

    def ensure_blocks(self, n: int) -> int:
        """Grow to at least ``n`` blocks; returns how many were added."""
        add = n - len(self.blocks)
        if add > 0:
            self.grow(add)
        return max(add, 0)

    def release(self) -> None:
        """Free every block (evict / preempt); safe to call twice."""
        blocks, self.blocks = self.blocks, []
        for b in blocks:
            self.pool.free(b)

    def padded(self) -> np.ndarray:
        row = np.full(self.max_blocks, NULL_BLOCK, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row


@dataclasses.dataclass
class PreemptedSlot:
    """What the scheduler needs to resume a preempted request: the request,
    its sampled-token stream, its seniority and, for families with
    recurrent state, the exact per-slot state rows saved at preemption."""
    request: Request
    generated: int
    tokens: List[int]
    seq: int                      # original admission order (seniority)
    recurrent: Optional[Any] = None   # {leaf: (L, ...)} per-slot state rows


def _scatter_blocks(pool_leaves, row_leaves, ids: torch.Tensor, row: int,
                    bs: int) -> None:
    """Copy the first len(ids) blocks of batch row ``row`` of a contiguous
    prefilled cache into the physical pool blocks ``ids``, in place (the
    insert path; ``repro.serve.paged._scatter_blocks``, paged.py:167)."""
    nb = ids.shape[0]
    for k, pool in pool_leaves.items():
        src = row_leaves[k][:, row, :nb * bs]
        pool[:, ids] = src.reshape((src.shape[0], nb, bs) + src.shape[2:]
                                   ).to(pool.dtype)


class PagedSlotManager(SlotManager):
    """``SlotManager`` whose sequence axis is block-granular
    (``repro.serve.paged.PagedSlotManager``, paged.py:181).

    The lifecycle surface (insert / evict / advance / out_of_cache) plus:
      * ``prepare_decode()``: grow every active slot's table to cover its
        next write, preempting the youngest slots when the pool runs dry;
      * ``new_table()`` / ``insert_prefilled()``: the chunked-prefill
        admission path that streams a long prompt straight into pool
        blocks (no contiguous staging cache);
      * ``block_tables()``: the (num_slots, W) gather index of the paged
        decode.

    ``max_len`` is rounded up to whole blocks, so the gathered (B, W·bs,
    ...) view has the sequence length of a contiguous ``max_len`` cache:
    the same kernels then run on the same values, which keeps paged logits
    bitwise equal to the contiguous tier's on the same schedule."""

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 cache_dtype=torch.bfloat16, enc_len: Optional[int] = None,
                 device: DeviceLike = None):
        if cfg.encdec:
            raise NotImplementedError(
                "paged slots cover decoder-only families; enc-dec keeps "
                "the contiguous SlotManager")
        self.block_size = block_size
        self.blocks_per_slot = math.ceil(max_len / block_size)
        # ssm-family caches are O(1) recurrent state: nothing to page
        self.paged = cfg.family != "ssm"
        if pool_blocks is None:   # the contiguous tier's reservation
            pool_blocks = num_slots * self.blocks_per_slot
        if self.paged and pool_blocks < self.blocks_per_slot:
            raise ValueError(
                f"pool of {pool_blocks} blocks cannot hold one full-length "
                f"request ({self.blocks_per_slot} blocks)")
        self.pool = BlockPool(pool_blocks)
        self.tables: List[Optional[BlockTable]] = [None] * num_slots
        super().__init__(cfg, num_slots, self.blocks_per_slot * block_size,
                         cache_dtype=cache_dtype, enc_len=enc_len,
                         device=device)

    def _alloc_cache(self, cache_dtype):
        m = model_fns(self.cfg)
        if not self.paged:
            return m.init_cache(self.cfg, self.num_slots, self.max_len,
                                cache_dtype, device=self.device)
        return m.init_paged_cache(self.cfg, self.num_slots,
                                  self.pool.num_blocks + 1, self.block_size,
                                  cache_dtype, device=self.device)

    # ------------------------------------------------------------- queries

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    def block_tables(self) -> np.ndarray:
        """(num_slots, blocks_per_slot) int32 gather index for decode;
        free slots are all-null rows (their idle writes hit block 0)."""
        rows = np.full((self.num_slots, self.blocks_per_slot), NULL_BLOCK,
                       np.int32)
        for i, t in enumerate(self.tables):
            if t is not None:
                rows[i, :t.num_blocks] = t.blocks
        return rows

    def pool_stats(self):
        if not self.paged:
            return super().pool_stats()
        used_blocks = self.pool.num_live
        used = sum(int(self.pos[i]) for i, _ in self.active())
        return (used_blocks * self.block_size, used,
                self.pool.num_blocks, used_blocks)

    def _recurrent_keys(self) -> List[str]:
        return [k for k in self.cache if k not in PAGED_CACHE_KEYS]

    # ----------------------------------------------------------- lifecycle

    def new_table(self, n_tokens: int) -> BlockTable:
        """A table covering ``n_tokens`` logical positions, allocated
        before the slot exists (chunked prefill streams into it).  On
        ``PoolExhausted`` the blocks it took go back to the pool."""
        t = BlockTable(self.pool, self.blocks_per_slot)
        try:
            t.grow(self.blocks_for(n_tokens))
        except PoolExhausted:
            t.release()
            raise
        return t

    def _claim(self, i: int, req: Request, table: Optional[BlockTable],
               first_token: int, pos: int,
               resume: Optional[PreemptedSlot]) -> int:
        """Slot ``i``'s bookkeeping for ``req`` with ``table``, and for a
        resume the generated-token stream and saved recurrent rows."""
        self.tables[i] = table
        self.pos[i] = pos
        self.tok[i] = first_token
        if resume is not None:
            self.slots[i] = Slot(request=req, generated=resume.generated,
                                 tokens=list(resume.tokens), seq=resume.seq)
            if resume.recurrent is not None:
                self._restore_recurrent(i, resume.recurrent)
        else:
            self._seq += 1
            self.slots[i] = Slot(request=req, generated=1,
                                 tokens=[int(first_token)], seq=self._seq)
        return i

    def _check_claim(self, pos: int) -> None:
        if not self._free:
            raise RuntimeError("no free slot (scheduler admitted too many)")
        if pos >= self.max_len:
            raise ValueError(f"prompt fills the cache: pos {pos} >= "
                             f"max_len {self.max_len}")

    @torch.inference_mode()
    def insert(self, req: Request, row_cache, row: int, first_token: int,
               pos: int, *, resume: Optional[PreemptedSlot] = None) -> int:
        """Claim a slot: allocate blocks covering [0, pos], scatter row
        ``row`` of the contiguous prefilled ``row_cache`` into them and
        copy its recurrent rows (batch axis 1).  ``resume`` restores a
        preempted request: its generated-token bookkeeping continues and
        its saved recurrent state overwrites what the re-prefill produced
        (``row_cache=None`` skips the cache copy: the pure-recurrent
        resume)."""
        self._check_claim(pos)
        table = None
        if self.paged:
            table = self.new_table(pos + 1)   # PoolExhausted bubbles up
        i = self._free.pop()
        if row_cache is not None:
            if self.paged:
                ids = torch.tensor(table.blocks, dtype=torch.long,
                                   device=self.device)
                _scatter_blocks(
                    {k: self.cache[k] for k in PAGED_CACHE_KEYS
                     if k in self.cache}, row_cache, ids, row,
                    self.block_size)
                rec = self._recurrent_keys()
                _write_row({k: self.cache[k] for k in rec},
                           {k: row_cache[k] for k in rec}, i, row)
            else:
                _write_row(self.cache, row_cache, i, row)
        return self._claim(i, req, table, first_token, pos, resume)

    def insert_prefilled(self, req: Request, table: BlockTable,
                         first_token: int, pos: int, *,
                         resume: Optional[PreemptedSlot] = None) -> int:
        """Claim a slot whose blocks already hold the prompt: the chunked
        admission path prefilled straight into ``table`` through
        ``prefill_chunk(..., block_tables=)``."""
        self._check_claim(pos)
        table.ensure_blocks(self.blocks_for(pos + 1))
        return self._claim(self._free.pop(), req, table, first_token, pos,
                           resume)

    def evict(self, i: int) -> Slot:
        s = super().evict(i)
        if self.tables[i] is not None:
            self.tables[i].release()
            self.tables[i] = None
        return s

    # ---------------------------------------------------------- preemption

    def _save_recurrent(self, i: int) -> Optional[Dict[str, Any]]:
        keys = self._recurrent_keys()
        if not keys:
            return None
        return {k: tree.tree_map(lambda a: a[:, i].clone(), self.cache[k])
                for k in keys}

    @torch.inference_mode()
    def _restore_recurrent(self, i: int, saved: Dict[str, Any]) -> None:
        for k, v in saved.items():
            tree.tree_map(lambda a, s: a[:, i].copy_(s), self.cache[k], v)

    def preempt(self, i: int) -> PreemptedSlot:
        """Evict slot ``i`` and capture what resume needs: the sampled
        token stream (attention caches are rebuilt by re-prefill) and, for
        recurrent families, the exact per-slot state rows, copied out of
        the live cache (O(1) per slot, the reason recurrent state is never
        paged)."""
        s = self.slots[i]
        if s is None:
            raise ValueError(f"slot {i} already free")
        saved = self._save_recurrent(i)
        self.evict(i)
        return PreemptedSlot(request=s.request, generated=s.generated,
                             tokens=list(s.tokens), seq=s.seq,
                             recurrent=saved)

    def _youngest(self) -> Optional[int]:
        live = self.active()
        if not live:
            return None
        return max(live, key=lambda t: t[1].seq)[0]

    def prepare_decode(self) -> List[PreemptedSlot]:
        """Grow every active slot's table to cover its next write, oldest
        slot first.  When the pool runs dry, preempt the youngest active
        slot and retry: each preemption frees >= 1 block, so this ends, and
        a lone slot can always reach max_len because the pool holds >=
        blocks_per_slot.  Returns the preempted requests for the scheduler
        to requeue."""
        preempted: List[PreemptedSlot] = []
        if not self.paged:
            return preempted
        for i, s in sorted(self.active(), key=lambda t: t[1].seq):
            if self.slots[i] is not s:    # preempted by an older slot
                continue
            need = self.blocks_for(int(self.pos[i]) + 1)
            while self.tables[i].num_blocks < need:
                try:
                    self.tables[i].grow()
                except PoolExhausted:
                    j = self._youngest()
                    preempted.append(self.preempt(j))
                    if j == i:
                        break
        return preempted
