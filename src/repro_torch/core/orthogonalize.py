"""Pluggable orthogonalization backends (port of ``repro.core.orthogonalize``).

Every backend implements one protocol:

    class Orthogonalizer:
        name: str
        def init_state(self, layout, cfg) -> dict | None: ...
        def __call__(self, stacks, *, step, state, layout, cfg)
            -> (ortho_stacks, new_state)

``stacks`` is a dict of owner-major buffers keyed by ``group_key_str``:
(D·cap, m, n) on one process, this rank's (cap, m, n) owner rows under a
mesh (``OwnerLayout.shard_local``); ``cfg`` is the MuonConfig (only ``ns``
is read here).

Ported backends:

  gram        — batched Gram Newton-Schulz per shape group (the default).
  gram_fused  — one batched m×m Gram recurrence per Gram bucket.
  full_ns     — full-matrix standard NS (the Muon-AG baseline compute).

The reference's variant backends (normuon, adamuon, block_periodic, dion2)
wait for ROADMAP item 7.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.core.gram_ns import (gram_finish, gram_iterate,
                                      gram_newton_schulz, gram_prepare)
from repro_torch.core.newton_schulz import newton_schulz
from repro_torch.core.owner_comms import OwnerLayout, group_key_str


class Orthogonalizer:
    """Protocol base: a stateless orthogonalizer."""

    name = "base"

    def init_state(self, layout: OwnerLayout, cfg) -> Optional[dict]:
        return None

    def __call__(self, stacks: Dict[str, torch.Tensor], *, step, state,
                 layout: OwnerLayout, cfg):
        raise NotImplementedError


class GramNS(Orthogonalizer):
    """Batched Gram NS per shape group — the owner-local DMuon default."""

    name = "gram"

    def __call__(self, stacks, *, step, state, layout, cfg):
        ns = cfg.ns
        base = functools.partial(gram_newton_schulz, cfg=ns,
                                 assume_short_fat=True)

        def one(x):
            if ns.owner_chunk and x.shape[0] > ns.owner_chunk \
                    and x.shape[0] % ns.owner_chunk == 0:
                # bound the live Gram working set: sequential chunks of the
                # owner-local batch
                return torch.cat([base(c) for c in x.split(ns.owner_chunk)])
            return base(x)

        out = {k: layout.shard_local(one, v) for k, v in stacks.items()}
        return out, state


class BucketFusedGramNS(Orthogonalizer):
    """Bucket-fused owner NS: one batched m×m recurrence per Gram bucket.

    Per-group prepare (normalize + SYRK; shapes differ in n), concatenate the
    Gram stacks of the bucket (the local owner rows under a mesh), ONE
    batched iterate, split Q back, per-group finish (Q·X₀)."""

    name = "gram_fused"

    def __call__(self, stacks, *, step, state, layout, cfg):
        ns = cfg.ns
        buckets = layout.plan.buckets

        def run(sts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            out: Dict[str, torch.Tensor] = {}
            for _m_dim, keys in buckets.items():
                keys_here = [group_key_str(k) for k in keys
                             if group_key_str(k) in sts]
                if not keys_here:
                    continue
                x0s, gs, sizes = [], [], []
                for k in keys_here:
                    x0, g = gram_prepare(sts[k], ns)
                    x0s.append(x0)
                    gs.append(g)
                    sizes.append(g.shape[0])
                q_all = gram_iterate(torch.cat(gs, dim=0), ns)
                off = 0
                for k, x0, sz in zip(keys_here, x0s, sizes):
                    out[k] = gram_finish(q_all[off:off + sz], x0,
                                         sts[k].dtype)
                    off += sz
            return out

        return layout.shard_local(run, stacks), state


class FullMatrixNS(Orthogonalizer):
    """Full-matrix standard NS — the Muon-AG baseline compute.  Accepts
    arbitrarily-shaped (..., r, c) leaves (training layout)."""

    name = "full_ns"

    def __call__(self, stacks, *, step, state, layout, cfg):
        out = {k: newton_schulz(v, num_steps=cfg.ns.num_steps,
                                schedule=cfg.ns.schedule)
               for k, v in stacks.items()}
        return out, state


ORTHOGONALIZERS = {
    "gram": GramNS,
    "gram_fused": BucketFusedGramNS,
    "full_ns": FullMatrixNS,
}

# names resolving to the base Gram dispatch itself
BASE_ALIASES = ("auto", "gram_auto")

# the reference's composed and stateful backends, not ported yet
PENDING_ORTHOGONALIZERS = ("adamuon", "block_periodic", "dion2", "normuon")


def known_orthogonalizers() -> list:
    """Every name ``make_orthogonalizer`` accepts."""
    return sorted(set(ORTHOGONALIZERS) | set(BASE_ALIASES))


def make_orthogonalizer(name: str, cfg) -> Orthogonalizer:
    """Build the backend for ``name``, honoring ``cfg.ns.bucket_fusion`` for
    the base aliases ``"auto"``/``"gram_auto"``."""
    if name in BASE_ALIASES:
        return BucketFusedGramNS() if cfg.ns.bucket_fusion else GramNS()
    if name in PENDING_ORTHOGONALIZERS:
        raise ValueError(f"orthogonalizer {name!r} is not ported yet "
                         "(ROADMAP item 7)")
    try:
        return ORTHOGONALIZERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown orthogonalizer {name!r}; "
            f"known: {known_orthogonalizers()}") from None
