"""Slot manager (port of ``repro.serve.slots``): live requests mapped onto
a fixed decode batch.

The decode cache is allocated ONCE at ``num_slots`` batch rows and never
reshaped; requests come and go by writing / recycling batch rows (axis 1 of
every cache leaf — KV caches ``(L, B, S, KV, hd)``, MLA latents
``(L, B, S, r)``, SSM conv / state ``(L, B, K, di)`` / ``(L, B, di, ds)``,
xLSTM matrix memories ``(n, B, H, hd, hd)``, enc-dec cross K / V — the
batch axis is uniform across every model family, so one slot abstraction
covers KV growth *and* recurrent state).

Lifecycle: ``insert`` claims a free slot and copies a prefilled batch-1
(or one row of a packed batch-P) cache into the slot's row, in place; the
slot then decodes at its own position via the vector-``pos`` decode path.
``evict`` (EOS / budget exhausted) returns the slot to the free list — the
stale row is *recycled*, not zeroed, because ``insert`` overwrites every
leaf's full row and causal masking never reads rows past a slot's own
position.

Under a mesh (``mesh=``) the cache is this rank's part as
``models.sharding.cache_specs`` places it (``train.serve.init_cache_part``):
the slots [first, end) of ``rows`` where they split over the data axes,
each leaf's KV heads or sequence split over 'model'.  The host bookkeeping
(positions, tokens, the free list) stays whole and the same on every rank;
``insert`` copies a prefilled row only on the data ranks that hold the
slot.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model_fns
from repro_torch.serve.queue import Request
from repro_torch.train.serve import init_cache_part


@dataclasses.dataclass
class Slot:
    """Host-side bookkeeping for one occupied decode-batch row."""
    request: Request
    generated: int = 0          # tokens sampled so far (prefill's counts)
    tokens: Optional[List[int]] = None
    seq: int = 0                # admission order (preemption picks youngest)

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = []


@torch.inference_mode()
def _write_row(dcache, rcache, slot: int, row: int):
    """Copy batch row ``row`` of a prefilled cache into batch row ``slot``
    of the decode cache, in place, for every leaf (axis 1 is batch
    everywhere)."""
    rows = dict(tree.flatten(rcache))
    for path, leaf in tree.flatten(dcache):
        leaf[:, slot].copy_(rows[path][:, row])
    return dcache


class SlotManager:
    """Fixed-batch decode cache + per-slot position / token bookkeeping.
    The cache lives on ``device`` (CUDA unless given; the scheduler passes
    its parameters' device)."""

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 cache_dtype=torch.bfloat16, enc_len: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.device = resolve_device(device)
        self.mesh = mesh
        # the slots [first, end) whose rows this rank's cache holds
        self.rows = (0, num_slots)
        self.cache = self._alloc_cache(cache_dtype)
        # per-slot decode state, consumed directly by the vector-pos decode:
        # pos[i] is the next cache write position, tok[i] the last sampled
        # token.  Free slots idle at pos 0 — their writes land in a row that
        # insert() fully overwrites before it is ever attended.
        self.pos = np.zeros(num_slots, np.int32)
        self.tok = np.zeros(num_slots, np.int32)
        self.slots: List[Optional[Slot]] = [None] * num_slots
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._seq = 0            # monotonic admission counter (Slot.seq)

    def _alloc_cache(self, cache_dtype):
        """Cache-layout hook: contiguous (L, B, S_max, ...) rows here;
        ``paged.PagedSlotManager`` overrides it with the block-pool
        layout."""
        if self.mesh is not None:
            cache, self.rows = init_cache_part(self.cfg, self.num_slots,
                                               self.max_len, self.mesh,
                                               cache_dtype, self.device)
            return cache
        m = model_fns(self.cfg)
        if self.cfg.encdec:
            if self.enc_len is None:
                raise ValueError("enc-dec slots need a uniform enc_len")
            return m.init_cache(self.cfg, self.num_slots, self.max_len,
                                self.enc_len, cache_dtype,
                                device=self.device)
        return m.init_cache(self.cfg, self.num_slots, self.max_len,
                            cache_dtype, device=self.device)

    # ------------------------------------------------------------- queries

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.num_slots - len(self._free)

    def active(self) -> List[Tuple[int, Slot]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def pool_stats(self) -> Tuple[int, int, int, int]:
        """(reserved_tokens, used_tokens, pool_blocks, used_blocks) for the
        occupancy / fragmentation metrics.  The contiguous tier reserves
        every slot's full max_len row up front, occupied or not: the
        worst-case reservation ``paged.PagedSlotManager``'s block-granular
        accounting shrinks."""
        used = sum(int(self.pos[i]) for i, _ in self.active())
        return self.num_slots * self.max_len, used, 0, 0

    # ----------------------------------------------------------- lifecycle

    def insert(self, req: Request, row_cache, row: int,
               first_token: int, pos: int) -> int:
        """Claim a free slot for ``req``: copy row ``row`` of the prefilled
        ``row_cache`` into it and start decoding at ``pos`` (the prompt
        length, plus any frontend prefix).  Returns the slot index."""
        if not self._free:
            raise RuntimeError("no free slot (scheduler admitted too many)")
        if pos >= self.max_len:
            raise ValueError(f"prompt fills the cache: pos {pos} >= "
                             f"max_len {self.max_len}")
        i = self._free.pop()
        first, end = self.rows
        if first <= i < end:
            _write_row(self.cache, row_cache, i - first, row)
        self.pos[i] = pos
        self.tok[i] = first_token
        self._seq += 1
        self.slots[i] = Slot(request=req, generated=1,
                             tokens=[int(first_token)], seq=self._seq)
        return i

    def evict(self, i: int) -> Slot:
        """Free slot ``i`` (EOS / budget reached).  The cache row is left
        in place and recycled by the next insert."""
        s = self.slots[i]
        if s is None:
            raise ValueError(f"slot {i} already free")
        self.slots[i] = None
        self.pos[i] = 0
        self.tok[i] = 0
        self._free.append(i)
        return s

    def advance(self, i: int, token: int) -> None:
        """Record one decoded token for slot ``i`` and move its write
        position forward."""
        s = self.slots[i]
        assert s is not None
        self.pos[i] += 1
        self.tok[i] = token
        s.generated += 1
        s.tokens.append(int(token))

    def out_of_cache(self, i: int) -> bool:
        """True when slot ``i``'s next write would run off the cache end —
        the scheduler must evict (max-token truncation) before decoding."""
        return int(self.pos[i]) >= self.max_len
