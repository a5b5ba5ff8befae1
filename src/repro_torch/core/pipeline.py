"""Bucket-pipelined optimizer schedule: stage_in → compute → publish (port
of ``repro.core.pipeline``).

The fused owner path runs the optimizer as one post-backward phase: pack
EVERY group (each a blocking collective under a mesh), orthogonalize EVERY
group, publish EVERY group.  That is this module's schedule with a single
stage over every group and no overlap (``BucketPipeline(..., fused=True)``,
what ``core/muon.py:_owner_update`` runs for ``pipeline="fused"``).  The
bucketed schedule splits the step by *Gram bucket* (``plan.buckets``: the
groups sharing a Gram dimension m):

  ``stage_in(b)``  pack the bucket's gradients and issue their moves to the
                   owners (``OwnerLayout.pack_async``)
  ``compute(b)``   momentum + the variant's orthogonalizer on the local rows
  ``publish(b)``   issue the moves back to the training layout
                   (``OwnerLayout.unpack_async``); scale / wd / lr on wait

and orders them with double-buffered staging, largest m first:

    stage_in(b₀) → [stage_in(b₁) ‖ compute(b₀)]
                 → [stage_in(b₂) ‖ compute(b₁) ‖ publish(b₀)] → …

The reference expresses that order to XLA with ``lax.optimization_barrier``
ties; here it is the order of issues and waits on asynchronous collectives.
``run_from_grads`` issues stage_in(b+1) before compute(b) and waits for it
only after compute(b) is enqueued; it issues publish(b) before compute(b+1)
and waits for it only after compute(b+1) is enqueued.  So at most one
bucket's staging is in flight ahead of the compute wavefront (the
reference's bound), and every collective is issued in the same order on
every rank.  Under NCCL the collectives run on the process group's own
stream and ``Work.wait()`` makes the current stream wait for them without
blocking the host; packing, compute and unpacking run on the current
stream, and each ``Pending`` holds its buffers until it is waited.  On gloo
the same code runs and ``wait()`` blocks.  Nothing here asks which backend
it is on.  The overlap runs only with ``cfg.pipeline_barriers`` and a mesh
of more than one rank; otherwise every move is waited as it is issued.  The
values are the same either way, and the same as the fused path's: the same
collectives and arithmetic per group, reordered (every orthogonalizer
works group by group or bucket by bucket, so a call per bucket does what
one call over every group does).

Gradients can also arrive *pre-staged*: with gradient accumulation,
``train/step.py`` issues each microbatch's ``stage_in_all`` right after its
backward and adds it into an owner-layout accumulator, so the owner
transposes ride under the next microbatch's forward and backward.
``run_staged`` then starts the pipeline at ``compute``.  In one process
packing is a permutation plus zero pad, so accumulating packed microbatch
gradients is bit-exact with packing the accumulated gradient
(``tests/test_torch_pipeline.py``).

Every registry variant rides the pipeline unchanged: the orthogonalizer
takes a dict of stacks, so each bucket's compute is one backend call on the
bucket's slice of ``MuonState.variant_state`` (``_slice_state`` /
``_merge_state`` over its ``{field: {group_key_str: buffer}}`` form).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dedication import DedicationPlan
from repro_torch.core.orthogonalize import make_orthogonalizer
from repro_torch.core.owner_comms import (OwnerLayout, Pending,
                                          group_key_str, repack_rows)
from repro_torch.core.update_rules import (apply_wd_and_lr, momentum_update,
                                           scale_factor)
from repro_torch.device import as_dtype


def _slice_state(state: Optional[dict], skeys: List[str]) -> Optional[dict]:
    """Per-bucket view of a variant state ({field: {skey: buf} | other})."""
    if state is None:
        return None
    return {field: ({k: bufs[k] for k in skeys if k in bufs}
                    if isinstance(bufs, dict) else bufs)
            for field, bufs in state.items()}


def _merge_state(acc: Optional[dict], part: Optional[dict]) -> Optional[dict]:
    """Fold one bucket's updated state slice back into the full state."""
    if part is None:
        return acc
    if acc is None:
        acc = {}
    for field, bufs in part.items():
        if isinstance(bufs, dict):
            acc.setdefault(field, {}).update(bufs)
        else:
            acc[field] = bufs
    return acc


def wait_all(pending: Dict[str, Pending]) -> Dict[str, torch.Tensor]:
    """{key: pending} -> {key: result}, waited in the dict's order."""
    return {k: p.wait() for k, p in pending.items()}


def reshard_staged(staged: Dict[str, torch.Tensor], old_plan: DedicationPlan,
                   new_plan: DedicationPlan) -> Dict[str, torch.Tensor]:
    """Re-layout in-flight staged gradient stacks across dedication plans.

    A preemption mid-accumulation leaves owner-major staging buffers
    (partial gradient sums) padded to the OLD plan's ``D·cap`` rows.  This
    repacks their logical rows under the new plan (the old pad rows are
    dropped, the new ones are zeros), so an elastic restart can finish the
    interrupted step at another owner count.  On whole (one-process)
    stacks."""
    skey_to_key = {group_key_str(k): k for k in old_plan.groups}
    return {skey: repack_rows(old_plan.groups[skey_to_key[skey]],
                              new_plan.groups[skey_to_key[skey]], buf)
            for skey, buf in staged.items()}


class BucketPipeline:
    """The per-bucket realization of the owner update.

    One instance per (plan, config, mesh).  ``run_from_grads`` is the owner
    update of ``core/muon.py:_owner_update``; ``fused=True`` makes its
    schedule one stage over every group (in ``plan.groups`` order) with
    every move waited as it is issued: the fused pipeline.
    ``stage_in_all`` + ``run_staged`` split the step around the backward
    pass for the accumulation-overlapped mode.  ``on_event``, when set, is
    called with ``(what, bucket index)`` at each issue, wait and compute
    of the schedule ("issue_stage_in", "wait_stage_in", "compute",
    "issue_publish", "wait_publish"): the order the schedule promises, to
    be read by tests."""

    def __init__(self, plan: DedicationPlan, cfg, mesh=None, spec=None, *,
                 device=None, fused: bool = False):
        if spec is None:
            from repro_torch.core.api import get_variant
            spec = get_variant(cfg.variant)
        self.plan = plan
        self.cfg = cfg
        self.mesh = mesh
        self.spec = spec
        self.layout = OwnerLayout(plan, mesh, device=device)
        self.ortho = make_orthogonalizer(spec.orthogonalizer, cfg)
        # Gram buckets, largest m first: the longest compute goes first so
        # the later (cheaper) buckets' staging has the most to hide behind.
        self.schedule: List[Tuple[Optional[int], List[Any]]] = (
            [(None, list(plan.groups))] if fused else
            sorted(plan.buckets.items(), key=lambda kv: -kv[0]))
        # Overlap pays only where there are transfers; values are the same
        # either way.
        multi = mesh is not None and mesh.size() > 1
        self.overlap = (not fused and multi
                        and bool(getattr(cfg, "pipeline_barriers", True)))
        self.on_event: Optional[Callable[[str, int], None]] = None

    def _note(self, what: str, b: int) -> None:
        if self.on_event is not None:
            self.on_event(what, b)

    def _issued(self, pending: Pending) -> Pending:
        """Without overlap each move is waited as it is issued."""
        if not self.overlap:
            pending.wait()
        return pending

    # ------------------------------------------------------------ stages

    def stage_in(self, keys, grads: Dict[str, torch.Tensor],
                 placements=None, *, dtype=None) -> Dict[str, Pending]:
        """Pack one bucket's gradients and issue their moves to the owners:
        ``{group_key_str: Pending}`` of this rank's owner rows.  ``grads``
        hold local parts, ``placements`` their mesh placements (missing:
        replicated).  ``dtype`` casts the leaves before packing (the pack
        dtype on the direct path, the accumulator dtype when pre-staging)."""
        out = {}
        for key in keys:
            leaves = {p: (grads[p] if dtype is None else grads[p].to(dtype))
                      for p in self.plan.groups[key].leaf_paths}
            out[group_key_str(key)] = self._issued(
                self.layout.pack_async(key, leaves, placements))
        return out

    def stage_in_all(self, grads: Dict[str, torch.Tensor], placements=None,
                     *, dtype=None) -> Dict[str, Pending]:
        """stage_in over every bucket, in schedule order (the pre-staging
        path, where the microbatch loop is the schedule)."""
        out = {}
        for _, keys in self.schedule:
            out.update(self.stage_in(keys, grads, placements, dtype=dtype))
        return out

    def zeros_staged(self, dtype) -> Dict[str, torch.Tensor]:
        """Zero staging accumulators for every group (this rank's rows)."""
        return {group_key_str(k): self.layout.zeros(k, dtype)
                for k in self.plan.groups}

    def compute(self, keys, staged: Dict[str, torch.Tensor], momentum, step,
                vstate, donate: bool = False):
        """Momentum + the variant's orthogonalizer for one bucket, on the
        owner-local rows only.  Consumes ``staged`` (each group's rows leave
        it as they are read); with ``donate`` each old momentum leaves
        ``momentum`` likewise.  Returns (ortho, new momentum, new variant
        state slice)."""
        cfg = self.cfg
        pdt, mdt = as_dtype(cfg.pack_dtype), as_dtype(cfg.momentum_dtype)
        take = dict.pop if donate else dict.__getitem__
        new_mom, eff = {}, {}
        for key in keys:
            skey = group_key_str(key)
            mom, e = momentum_update(take(momentum, skey).to(pdt),
                                     staged.pop(skey).to(pdt), cfg)
            new_mom[skey] = mom.to(mdt)
            eff[skey] = e
        skeys = [group_key_str(k) for k in keys]
        ortho, new_sub = self.ortho(eff, step=step,
                                    state=_slice_state(vstate, skeys),
                                    layout=self.layout, cfg=cfg)
        return ortho, new_mom, new_sub

    def publish(self, keys, ortho: Dict[str, torch.Tensor], params_matrix,
                placements=None) -> Pending:
        """Scale each bucket stack, issue its moves back to the training
        layout (``published(placements)``), and return a ``Pending`` whose
        ``wait()`` gives ``{path: update}`` with wd / lr applied.  Consumes
        ``ortho``; without overlap each group's update is finished as its
        move is waited, so one group's scaled stack is alive at a time."""
        cfg = self.cfg
        pdt = as_dtype(cfg.pack_dtype)
        done, pend = {}, []

        def apply(leaves):
            return {p: apply_wd_and_lr(upd, params_matrix[p], cfg)
                    for p, upd in leaves.items()}
        for key in keys:
            m, n = self.plan.groups[key].key
            s = scale_factor(m, n, cfg.scale_mode)
            moving = self._issued(self.layout.unpack_async(
                key, ortho.pop(group_key_str(key)).to(pdt) * s, placements))
            if self.overlap:
                pend.append(moving)
            else:
                done.update(apply(moving.wait()))
            del moving

        def finish(_):
            for moving in pend:
                done.update(apply(moving.wait()))
            return done
        return Pending(None, then=finish)

    # ---------------------------------------------------------- schedules

    def _run(self, staged_for, pm, placements, state, donate=False):
        """compute(b) on ``staged_for(b)``'s rows, bucket by bucket, with
        publish(b) issued before compute(b+1) and waited after it.
        Returns ``(matrix_updates, new_momentum, new_variant_state)``."""
        updates: Dict[str, torch.Tensor] = {}
        new_momentum: Dict[str, torch.Tensor] = {}
        new_vstate = None
        published: Optional[Pending] = None
        for b, (_, keys) in enumerate(self.schedule):
            cur = staged_for(b)
            self._note("compute", b)
            ortho, mom_b, vs_b = self.compute(keys, cur, state.momentum,
                                              state.step, state.variant_state,
                                              donate)
            del cur
            if published is not None:
                self._note("wait_publish", b - 1)
                updates.update(published.wait())
            self._note("issue_publish", b)
            published = self.publish(keys, ortho, pm, placements)
            new_momentum.update(mom_b)
            new_vstate = _merge_state(new_vstate, vs_b)
        if published is not None:
            self._note("wait_publish", len(self.schedule) - 1)
            updates.update(published.wait())
        return updates, new_momentum, new_vstate

    def run_from_grads(self, gm, gm_pl, pm, state, donate=False):
        """The pipelined step from training-layout gradients (local parts
        ``gm``, placements ``gm_pl``; ``pm`` the matrix parameters' local
        parts).  Same math per group as the fused path, staged per bucket:
        stage_in(b+1) is issued before compute(b) and waited after it.
        Returns ``(matrix_updates, new_momentum, new_error_feedback,
        new_variant_state)``."""
        from repro_torch.core.muon import compress_with_error_feedback
        grads_for_pack, new_ef = compress_with_error_feedback(
            gm, state.error_feedback, self.cfg)
        pdt = as_dtype(self.cfg.pack_dtype)
        sched = self.schedule

        def stage(b):
            self._note("issue_stage_in", b)
            return self.stage_in(sched[b][1], grads_for_pack, gm_pl,
                                 dtype=pdt)

        inflight = [stage(0)] if sched else []

        def staged_for(b):
            self._note("wait_stage_in", b)
            cur = wait_all(inflight.pop())
            if b + 1 < len(sched):
                inflight.append(stage(b + 1))
            return cur

        updates, new_momentum, new_vstate = self._run(staged_for, pm, gm_pl,
                                                      state, donate)
        return updates, new_momentum, new_ef, new_vstate

    def run_staged(self, staged: Dict[str, torch.Tensor], pm, state,
                   placements=None, donate=False):
        """Compute + publish over pre-staged owner-layout gradients
        (``{group_key_str: this rank's rows}``, already averaged), with
        publish(b−1) in flight under compute(b).  ``placements`` are the
        matrix leaves' training layouts (missing: replicated).  Returns
        ``(matrix_updates, new_momentum, new_variant_state)``."""
        def staged_for(b):
            return {group_key_str(k): staged[group_key_str(k)]
                    for k in self.schedule[b][1]}
        return self._run(staged_for, pm, placements, state, donate)
