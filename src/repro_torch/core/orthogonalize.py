"""Pluggable orthogonalization backends (port of ``repro.core.orthogonalize``).

Every backend implements one protocol:

    class Orthogonalizer:
        name: str
        def init_state(self, layout, cfg) -> dict | None: ...
        def __call__(self, stacks, *, step, state, layout, cfg)
            -> (ortho_stacks, new_state)

``stacks`` is a dict of owner-major buffers keyed by ``group_key_str``:
(D·cap, m, n) on one process, this rank's (cap, m, n) owner rows under a
mesh (``OwnerLayout.shard_local``); ``step`` is the optimizer step (an int);
``cfg`` is the MuonConfig (``ns`` and the variant knobs are read).  A
variant's state is built of owner-major buffers too (``OwnerLayout.zeros``),
so under a mesh it holds this rank's rows only and every op below is local.
Stateless backends return ``state`` unchanged (None).

Backends:

  gram           — batched Gram Newton-Schulz per shape group (the default).
  gram_fused     — one batched m×m Gram recurrence per Gram bucket.
  full_ns        — full-matrix standard NS (the Muon-AG baseline compute).
  normuon        — NorMuon (arXiv:2510.05491) over the base Gram path:
                   neuron-wise second-moment normalization of the
                   orthogonalized update, rescaled to preserve each matrix's
                   norm.  State: one (rows, m) fp32 moment per group.
  block_periodic — MuonBP (arXiv:2510.16981): full Gram NS every
                   ``cfg.muonbp_period`` steps, caching the polar
                   accumulator Q; in between, Q applied to the freshly
                   normalized momentum (one m×n product, no kernel).  State:
                   one (rows, m, m) fp32 Q per group.  Period 1 is ``gram``
                   bit for bit.
  dion2          — Dion2 (arXiv:2512.16928): a warm-started orthonormal
                   rank-r basis per matrix; Gram NS runs on the r×n factor
                   QᵀM only and the update is Q·NS(QᵀM)·√(m/r).  State: one
                   (rows, m, r) fp32 basis per group.
  adamuon        — AdaMuon (arXiv:2507.11005) over the base Gram path:
                   elementwise second-moment adaptation of the
                   orthogonalized update, norm-preserving.  State: one
                   (rows, m, n) fp32 moment per group.

``make_orthogonalizer(name, cfg)`` resolves a name to a (possibly composed)
backend; ``known_orthogonalizers()`` lists every name it accepts.  The
variant → backend mapping lives with the variant registry in ``core/api.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.gram_ns import (gram_finish, gram_iterate,
                                      gram_newton_schulz, gram_prepare,
                                      normalize)
from repro_torch.core.newton_schulz import newton_schulz
from repro_torch.core.owner_comms import OwnerLayout, group_key_str
from repro_torch.core.update_rules import norm_preserving_rescale
from repro_torch.device import as_dtype


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


def bias_correction(beta2: float, step: int) -> float:
    """1 − β₂^(step+1) computed in fp32, as the reference computes it from
    its int32 step (a float64 power differs in the last bits)."""
    one = np.float32(1.0)
    return float(one - np.float32(beta2) ** (np.float32(step) + one))


class NeuronwiseNorm(Orthogonalizer):
    """NorMuon-style neuron-wise normalization on top of a base backend.

    After orthogonalization, each output row (neuron) is divided by the
    bias-corrected RMS of its own update history (second moment with decay
    ``cfg.normuon_beta2``), then the whole matrix is rescaled to its
    pre-normalization Frobenius norm."""

    name = "normuon"

    def __init__(self, inner: Orthogonalizer):
        self.inner = inner

    def init_state(self, layout, cfg):
        v = {group_key_str(k): layout.zeros(
                k, torch.float32, trailing=(layout.plan.groups[k].key[0],))
             for k in layout.plan.groups}
        return {"v": v, "inner": self.inner.init_state(layout, cfg)}

    def __call__(self, stacks, *, step, state, layout, cfg):
        ortho, inner_state = self.inner(stacks, step=step,
                                        state=state.get("inner"),
                                        layout=layout, cfg=cfg)
        b2, eps = cfg.normuon_beta2, cfg.normuon_eps
        bc = bias_correction(b2, step)
        new_v: Dict[str, torch.Tensor] = {}
        out: Dict[str, torch.Tensor] = {}
        for k, o in ortho.items():
            o32 = o.float()
            row_ms = torch.mean(torch.square(o32), dim=-1)         # (B, m)
            v = b2 * state["v"][k] + (1.0 - b2) * row_ms
            new_v[k] = v
            o_n = o32 / (torch.sqrt(v / bc) + eps)[..., None]
            out[k] = norm_preserving_rescale(o_n, o32).to(o.dtype)
        return out, {"v": new_v, "inner": inner_state}


class AdaptiveSecondMoment(Orthogonalizer):
    """AdaMuon-style elementwise second-moment adaptation over a base
    backend: every entry of the update divided by the bias-corrected RMS of
    its own history (decay ``cfg.adamuon_beta2``), then each matrix rescaled
    to its pre-adaptation Frobenius norm.  The elementwise sibling of
    :class:`NeuronwiseNorm`.  At the first step v = (1 − β₂)·o² and the
    bias correction is 1 − β₂, so each entry becomes about sign(o)."""

    name = "adamuon"

    def __init__(self, inner: Orthogonalizer):
        self.inner = inner

    def init_state(self, layout, cfg):
        v = {group_key_str(k): layout.zeros(k, torch.float32)
             for k in layout.plan.groups}
        return {"v": v, "inner": self.inner.init_state(layout, cfg)}

    def __call__(self, stacks, *, step, state, layout, cfg):
        ortho, inner_state = self.inner(stacks, step=step,
                                        state=state.get("inner"),
                                        layout=layout, cfg=cfg)
        b2, eps = cfg.adamuon_beta2, cfg.adamuon_eps
        bc = bias_correction(b2, step)
        new_v: Dict[str, torch.Tensor] = {}
        out: Dict[str, torch.Tensor] = {}
        for k, o in ortho.items():
            o32 = o.float()
            v = b2 * state["v"][k] + (1.0 - b2) * torch.square(o32)
            new_v[k] = v
            o_n = o32 / (torch.sqrt(v / bc) + eps)
            out[k] = norm_preserving_rescale(o_n, o32).to(o.dtype)
        return out, {"v": new_v, "inner": inner_state}


def dion2_rank(m: int, cfg) -> int:
    """Factor rank r for a group with Gram dimension ``m`` under
    ``cfg.dion2_rank_frac`` (validated here, the single entry point)."""
    frac = float(cfg.dion2_rank_frac)
    if not 0.0 < frac <= 1.0:
        raise ValueError(
            f"dion2_rank_frac must be in (0, 1], got {frac}")
    return max(1, min(m, int(round(frac * m))))


class Dion2GramNS(Orthogonalizer):
    """Dion2-style shrunken-factor orthogonalization (arXiv:2512.16928).

    A persistent orthonormal rank-r basis Q per matrix; only the r×n factor
    is orthogonalized:

        Z = M (Mᵀ Q_prev)          warm-started subspace iteration
        Q = qr(Z)                  re-orthonormalize the basis
        U = Q · NS(Qᵀ M) · √(m/r)  Gram NS on the factor, reconstruct

    The Gram kernels run at Gram dimension r = ``dion2_rank(m, cfg)``.  The
    √(m/r) rescale restores the Frobenius norm of a fully orthogonalized
    update.  A cold basis (all-zero: the first step, or pad rows) is
    replaced by the leading-r row selector ``eye(m, r)``.  The update does
    not depend on the QR's column signs (NS is odd), so the batched
    ``torch.linalg.qr`` (LAPACK on the CPU, cuSOLVER on the card; the
    reference's QR is outside its kernels too) may differ from the
    reference's in them."""

    name = "dion2"

    def init_state(self, layout, cfg):
        q = {}
        for k in layout.plan.groups:
            m = layout.plan.groups[k].key[0]
            q[group_key_str(k)] = layout.zeros(
                k, torch.float32, trailing=(m, dion2_rank(m, cfg)))
        return {"q": q}

    def __call__(self, stacks, *, step, state, layout, cfg):
        ns = cfg.ns

        def run(args):
            out, new_q = {}, {}
            for k, x in args["stacks"].items():
                q_prev = args["q"][k]
                m, r = q_prev.shape[-2:]
                x32 = x.float()
                # one subspace iteration toward the top-r left singular
                # directions; O(mnr), never the m×m Gram matrix
                z = torch.matmul(x32, torch.matmul(x32.mT, q_prev))
                cold = torch.sum(torch.square(q_prev), dim=(-2, -1),
                                 keepdim=True) == 0.0
                eye = torch.eye(m, r, dtype=torch.float32, device=x.device)
                q = torch.linalg.qr(torch.where(cold, eye, z))[0]
                f = torch.matmul(q.mT, x32)                      # (B, r, n)
                o = gram_newton_schulz(f.to(x.dtype), cfg=ns,
                                       assume_short_fat=True)
                u = torch.matmul(q, o.float())
                out[k] = (u * math.sqrt(m / r)).to(x.dtype)
                new_q[k] = q
            return out, new_q

        out, new_q = layout.shard_local(run, {"stacks": stacks,
                                              "q": state["q"]})
        return out, {"q": new_q}


class BlockPeriodicGramNS(Orthogonalizer):
    """MuonBP-style block-periodic orthogonalization.

    Refresh steps (``step % cfg.muonbp_period == 0``) run the full Gram NS
    and cache the polar accumulator Q_k; the steps between reuse the cached
    Q on the freshly normalized momentum: one m×n product
    (``gram_finish``, a plain matmul) in place of the iteration's kernels."""

    name = "block_periodic"

    def init_state(self, layout, cfg):
        q = {group_key_str(k): layout.zeros(
                k, torch.float32,
                trailing=(layout.plan.groups[k].key[0],) * 2)
             for k in layout.plan.groups}
        return {"q": q}

    def __call__(self, stacks, *, step, state, layout, cfg):
        ns = cfg.ns
        cdtype = as_dtype(ns.compute_dtype)

        def refresh(sts):
            out, new_q = {}, {}
            for k, x in sts.items():
                x0, g = gram_prepare(x, ns)
                q = gram_iterate(g, ns)
                out[k] = gram_finish(q, x0, x.dtype)
                new_q[k] = q.float()
            return out, new_q

        def reuse(args):
            out = {k: gram_finish(args["q"][k].to(cdtype), normalize(x, ns),
                                  x.dtype)
                   for k, x in args["stacks"].items()}
            return out, args["q"]

        period = max(1, int(cfg.muonbp_period))
        if step % period == 0:
            out, new_q = layout.shard_local(refresh, stacks)
        else:
            out, new_q = layout.shard_local(reuse, {"stacks": stacks,
                                                    "q": state["q"]})
        return out, {"q": new_q}


ORTHOGONALIZERS = {
    "gram": GramNS,
    "gram_fused": BucketFusedGramNS,
    "full_ns": FullMatrixNS,
    "block_periodic": BlockPeriodicGramNS,
    "dion2": Dion2GramNS,
}

# wrappers composed over the base Gram path (plain or bucket-fused)
COMPOSED_ORTHOGONALIZERS = {
    "normuon": NeuronwiseNorm,
    "adamuon": AdaptiveSecondMoment,
}

# names resolving to the base Gram dispatch itself
BASE_ALIASES = ("auto", "gram_auto")


def known_orthogonalizers() -> list:
    """Every name ``make_orthogonalizer`` accepts."""
    return sorted(set(ORTHOGONALIZERS) | set(COMPOSED_ORTHOGONALIZERS)
                  | set(BASE_ALIASES))


def make_orthogonalizer(name: str, cfg) -> Orthogonalizer:
    """Build the backend for ``name``, honoring ``cfg.ns.bucket_fusion``.

    Composed names (``"normuon"``, ``"adamuon"``) wrap the base Gram path;
    ``"auto"``/``"gram_auto"`` are the base Gram dispatch itself (fused
    when configured)."""
    base = BucketFusedGramNS() if cfg.ns.bucket_fusion else GramNS()
    if name in BASE_ALIASES:
        return base
    if name in COMPOSED_ORTHOGONALIZERS:
        return COMPOSED_ORTHOGONALIZERS[name](base)
    try:
        return ORTHOGONALIZERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown orthogonalizer {name!r}; "
            f"known: {known_orthogonalizers()}") from None
