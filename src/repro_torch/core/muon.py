"""The DMuon optimizer orchestrator: layout → orthogonalize → update rule
(port of ``repro.core.muon``).

Execution modes (``MuonConfig.mode``):

* ``owner``  — DMuon.  Matrix gradients are packed into owner-major stacked
  buffers; under a mesh each rank receives only its owner rows (the
  reduce-to-owner collectives of ``core/owner_comms.py``).  Momentum lives
  permanently in this layout; one batched Gram NS runs per shape group on
  the local rows and the updates are published back to each parameter's
  training layout.
* ``gather`` — Muon-AG baseline: momentum in training layout; under a mesh
  every gradient is reduced and all-gathered and every rank runs the
  full-matrix standard NS of every leaf.
* ``adamw``  — element-wise baseline.

Under a ``DeviceMesh`` a gradient leaf is a ``DTensor`` (its placements are
its training layout; ``Partial`` = a data-parallel reduction still to do)
or a plain tensor (replicated).  The optimizer state holds this rank's
local parts only: owner rows of the momentum, AdamW moments shaped like the
parameter's local part.  Updates come back as the gradients went in: a
``DTensor`` in the gradient's training layout (``Partial`` replicated), or
a plain tensor.

Variants (``MuonConfig.variant``; registry in ``core/api.py``): ``muon``,
``normuon``, ``muonbp``, ``dion2``, ``adamuon``, ``adamw``.  All but AdamW
share the owner pipeline and differ only in the orthogonalizer backend and
its per-group state, threaded through ``MuonState.variant_state`` (this
rank's owner rows, like the momentum); the gather baseline runs ``muon``
only.

Non-matrix parameters always take AdamW (Alg. 1 line 16).  For
variant='muon' all modes produce identical updates up to NS rounding.

Trees are nested dicts of tensors addressed by '/'-joined paths
(``core/tree.py``).  Updates are returned as deltas to be *added* to the
parameters, as in the reference; the state is rebuilt each step (new
tensors), not updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import tree
from repro_torch.core.dedication import DedicationPlan
from repro_torch.core.gram_ns import GramNSConfig
from repro_torch.core.orthogonalize import FullMatrixNS, make_orthogonalizer
from repro_torch.core.owner_comms import (  # noqa: F401 — re-exports
    OwnerLayout, _lead_perm, group_key_str, local_shard, pack_group,
    published, reduce_partial, replicate, stacked_placements, unpack_group)
from repro_torch.core.update_rules import (  # noqa: F401 — re-exports
    AdamWState, adamw_init, adamw_update, apply_wd_and_lr, momentum_update,
    scale_factor)
from repro_torch.device import as_dtype


@dataclass(frozen=True)
class MuonConfig:
    learning_rate: float = 0.02
    momentum: float = 0.95
    nesterov: bool = True
    weight_decay: float = 0.0
    ns: GramNSConfig = GramNSConfig()
    # update scale: 'match_rms_adam' = 0.2·sqrt(max(m,n)) (Moonlight),
    # 'spectral' = sqrt(max(1, m/n)), 'none' = 1.0
    scale_mode: str = "match_rms_adam"
    mode: str = "owner"                  # 'owner' | 'gather' | 'adamw'
    # optimizer variant by name (registry in core/api.py):
    #   'muon'    — plain orthogonalized updates (the paper's optimizer)
    #   'normuon' — + neuron-wise second-moment normalization (NorMuon)
    #   'muonbp'  — block-periodic NS refresh every `muonbp_period` steps
    #   'dion2'   — Gram NS on a warm-started rank-r factor only (Dion2)
    #   'adamuon' — + elementwise second-moment adaptation (AdaMuon)
    #   'adamw'   — elementwise baseline (equivalent to mode='adamw')
    variant: str = "muon"
    # optimizer-step schedule for mode='owner' (core/pipeline.py):
    #   'fused'    — pack all → NS all → publish all
    #   'bucketed' — per-Gram-bucket stage_in / compute / publish with the
    #                collectives issued asynchronously, double-buffered
    pipeline: str = "fused"
    # overlap the bucketed schedule's collectives (only on a mesh of more
    # than one rank; the values are the same either way)
    pipeline_barriers: bool = True
    # pre-warm the kernel autotune cache for every shape of the plan at
    # optimizer construction (paper §3.3 workflow)
    autotune_prewarm: bool = True
    momentum_dtype: str = "float32"
    # dtype of the packed owner-layout gradient/momentum math
    pack_dtype: str = "float32"
    # AdamW settings for non-matrix params (and for mode='adamw')
    adam_lr: float = 3e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    adam_weight_decay: float = 0.0
    # reduce matrix gradients in bf16 with an fp32 error-feedback residual
    compress_grads: bool = False
    # variant knobs
    normuon_beta2: float = 0.95          # NorMuon neuron second-moment decay
    normuon_eps: float = 1e-8
    muonbp_period: int = 4               # full-NS refresh period (1 = every step)
    # Dion2: rank fraction r/m of the factor the Gram NS runs on (1.0 =
    # full rank; the update then matches plain muon up to rounding)
    dion2_rank_frac: float = 0.25
    adamuon_beta2: float = 0.95          # AdaMuon entry second-moment decay
    adamuon_eps: float = 1e-8


def _resolve(cfg: MuonConfig):
    """(variant_spec, effective_mode) for ``cfg`` — validates the combo."""
    from repro_torch.core.api import get_variant   # lazy: api imports this module
    spec = get_variant(cfg.variant)
    mode = "adamw" if spec.elementwise else cfg.mode
    if mode not in ("owner", "gather", "adamw"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.mode == "gather" and not spec.elementwise and spec.name != "muon":
        raise ValueError(
            f"variant {spec.name!r} requires the owner pipeline "
            "(mode='owner'); the gather baseline only supports 'muon'")
    if cfg.pipeline not in ("fused", "bucketed"):
        raise ValueError(f"unknown pipeline {cfg.pipeline!r}; "
                         "known: 'fused', 'bucketed'")
    if cfg.pipeline == "bucketed" and mode == "gather":
        raise ValueError(
            "pipeline='bucketed' schedules the owner-layout stages; the "
            "gather baseline has no staged comms to pipeline (mode='owner')")
    return spec, mode


def compress_with_error_feedback(gm, error_feedback, cfg: MuonConfig):
    """bf16 gradient transpose with fp32 error feedback: compressed =
    bf16(g + e); residual e' = (g + e) - compressed stays in the training
    layout.  Identity when compression is off.  Returns
    ``(grads_for_pack, new_error_feedback)``."""
    if not (cfg.compress_grads and error_feedback is not None):
        return gm, error_feedback
    compressed, new_ef = {}, {}
    for p, g in gm.items():
        acc = g.float() + error_feedback[p]
        cg = acc.to(torch.bfloat16)
        new_ef[p] = acc - cg.float()
        compressed[p] = cg
    return compressed, new_ef


class MuonState(NamedTuple):
    step: int
    # mode='owner': {group_key_str: (D*cap, m, n) owner-major momentum}
    # mode='gather': {path: momentum} in training layout (matrix leaves only)
    momentum: Any
    adamw: AdamWState            # state for non-matrix leaves
    error_feedback: Any = None   # fp32 residual for compressed grad transpose
    # per-variant orthogonalizer state of owner-major buffers (this rank's
    # rows), e.g. NorMuon's neuron-wise second moments; None for 'muon'
    variant_state: Any = None


def _matrix_and_rest(plan: DedicationPlan, t):
    """Split a tree into {path: leaf} dicts of Muon matrices and the rest."""
    matrix, rest = {}, {}
    for path, leaf in tree.flatten(t):
        (matrix if path in plan.leaves else rest)[path] = leaf
    return matrix, rest


def _device_of(params, device):
    if device is not None:
        return torch.device(device)
    leaves = tree.flatten(params)
    return leaves[0][1].device if leaves else torch.device("cpu")


def _split(layout: OwnerLayout, leaves: Dict[str, Any]):
    """({path: local part}, {path: placements or None})."""
    local, placements = {}, {}
    for p, v in leaves.items():
        local[p], placements[p] = layout.split(v)
    return local, placements


def _like(grad, update: torch.Tensor, placements, mesh):
    """``update`` (a local part) in the form its gradient came in."""
    if not isinstance(grad, DTensor):
        return update
    return DTensor.from_local(update, mesh, published(placements),
                              run_check=False, shape=grad.shape,
                              stride=grad.stride())


def muon_init(plan: DedicationPlan, params, cfg: MuonConfig, mesh=None,
              device=None) -> MuonState:
    spec, mode = _resolve(cfg)
    layout = OwnerLayout(plan, mesh, device=_device_of(params, device))
    matrix, rest = _matrix_and_rest(plan, params)
    matrix, _ = _split(layout, matrix)
    rest, _ = _split(layout, rest)
    mdt = as_dtype(cfg.momentum_dtype)
    variant_state = None
    if mode == "owner":
        momentum = {group_key_str(key): layout.zeros(key, mdt)
                    for key in plan.groups}
        if spec.stateful:
            variant_state = make_orthogonalizer(
                spec.orthogonalizer, cfg).init_state(layout, cfg)
    elif mode == "gather":
        momentum = {p: torch.zeros(v.shape, dtype=mdt, device=v.device)
                    for p, v in matrix.items()}
    else:  # adamw for everything
        momentum = {}
        rest = {**rest, **matrix}
    ef = None
    if cfg.compress_grads and mode == "owner":
        ef = {p: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for p, v in matrix.items()}
    return MuonState(step=0, momentum=momentum, adamw=adamw_init(rest),
                     error_feedback=ef, variant_state=variant_state)


@torch.no_grad()
def muon_update(plan: DedicationPlan, grads, state: MuonState, params,
                cfg: MuonConfig, mesh=None, *, donate: bool = False):
    """One optimizer step.  Returns (updates, new_state); updates are deltas
    to be *added* to params.  ``donate`` (the reference's buffer donation):
    ``state``'s momentum and AdamW moments are released as their successors
    are made, so the old and new state never coexist whole; ``state`` must
    not be used afterwards."""
    spec, mode = _resolve(cfg)
    layout = OwnerLayout(plan, mesh)
    gm, gr = _matrix_and_rest(plan, grads)
    pm, pr = _matrix_and_rest(plan, params)
    if mode == "adamw":
        gr, pr, gm, pm = {**gr, **gm}, {**pr, **pm}, {}, {}
    gm_local, gm_pl = _split(layout, gm)
    pm_local, _ = _split(layout, pm)
    adam_updates, adamw_state = _adamw_step(layout, gr, pr, state, cfg,
                                            donate)
    new_ef, new_vstate = state.error_feedback, state.variant_state
    if mode == "owner":
        matrix_updates, new_momentum, new_ef, new_vstate = _owner_update(
            plan, gm_local, gm_pl, pm_local, state, cfg, layout, spec,
            donate)
    elif mode == "gather":
        matrix_updates, new_momentum = _gather_update(
            plan, gm_local, gm_pl, pm_local, state, cfg, layout, donate)
    else:
        matrix_updates, new_momentum = {}, state.momentum
    updates = {p: _like(g, matrix_updates[p], gm_pl[p], mesh)
               for p, g in gm.items()}
    return tree.rebuild(grads, {**updates, **adam_updates}), MuonState(
        state.step + 1, new_momentum, adamw_state, new_ef, new_vstate)


def _adamw_step(layout: OwnerLayout, gr, pr, state: MuonState,
                cfg: MuonConfig, donate: bool = False):
    """AdamW on the non-matrix leaves: gradients ``gr`` reduced first under
    a mesh (AdamW is elementwise), updates in their gradients' form.
    Returns ({path: update}, new AdamW state)."""
    mesh = layout.mesh
    gr_local, gr_pl = _split(layout, gr)
    pr_local, _ = _split(layout, pr)
    if mesh is not None:
        gr_local = {p: reduce_partial(g, gr_pl[p], mesh)
                    for p, g in gr_local.items()}
    adam_updates, adamw_state = adamw_update(gr_local, state.adamw, pr_local,
                                             state.step, cfg, donate=donate)
    return {p: _like(g, adam_updates[p], gr_pl[p], mesh)
            for p, g in gr.items()}, adamw_state


def _owner_update(plan: DedicationPlan, gm, gm_pl, pm, state: MuonState,
                  cfg: MuonConfig, layout: OwnerLayout, spec,
                  donate: bool = False):
    """DMuon path: pack (reduce-to-owner) → momentum → orthogonalize on the
    local owner rows by the variant's backend → unpack (publish) +
    scale/wd/lr.  Alg. 1 lines 10–15.  ``gm`` / ``pm`` hold local parts,
    ``gm_pl`` the gradients' placements.  Both pipelines run through
    ``BucketPipeline``: 'fused' as one stage over every group without
    overlap, 'bucketed' per Gram bucket.  Returns (updates, momentum,
    error feedback, variant state)."""
    if cfg.compress_grads and any(
            p.is_partial() for pl in gm_pl.values() if pl for p in pl):
        raise ValueError(
            "compress_grads with Partial (data-parallel) gradients would "
            "reduce them in bf16; not ported yet (ROADMAP item 6)")
    from repro_torch.core.pipeline import BucketPipeline
    return BucketPipeline(plan, cfg, layout.mesh, spec,
                          fused=cfg.pipeline == "fused").run_from_grads(
        gm, gm_pl, pm, state, donate=donate)


@torch.no_grad()
def muon_update_staged(plan: DedicationPlan, staged, rest_grads,
                       state: MuonState, params, cfg: MuonConfig, mesh=None,
                       *, donate: bool = False):
    """One optimizer step from PRE-STAGED owner-layout matrix gradients.

    ``staged`` is ``{group_key_str: owner rows}`` (this rank's rows of the
    owner-major gradient stack, already averaged over microbatches);
    ``rest_grads`` is the ``{path: grad}`` dict of the non-matrix (AdamW)
    leaves, reduced here first under a mesh, as ``muon_update`` reduces
    them.  The entry point of the accumulation-overlapped bucketed
    pipeline: ``train/step.py`` stages each microbatch's gradients to the
    owners under the next microbatch's backward, then calls this to run
    compute + publish only.  Updates are published to the matrix
    parameters' training layouts.

    In one process, bit-exact with ``muon_update`` on the packed-then-
    averaged gradients: packing is a permutation + zero pad, so it commutes
    with the microbatch sum, the 1/accum scaling and the pack-dtype cast.

    Incompatible with ``compress_grads`` (error feedback needs the summed
    gradient in the training layout): refused here."""
    spec, mode = _resolve(cfg)
    if mode != "owner":
        raise ValueError(f"muon_update_staged requires mode='owner' "
                         f"(got {mode!r})")
    if cfg.compress_grads:
        raise ValueError("pre-staged gradients are incompatible with "
                         "compress_grads (error feedback is a training-layout "
                         "residual)")
    from repro_torch.core.pipeline import BucketPipeline
    pipe = BucketPipeline(plan, cfg, mesh, spec)
    layout = pipe.layout
    pm, pr = _matrix_and_rest(plan, params)
    pm_local, pm_pl = _split(layout, pm)
    adam_updates, adamw_state = _adamw_step(layout, rest_grads, pr, state,
                                            cfg, donate)
    matrix_updates, new_momentum, new_vstate = pipe.run_staged(
        staged, pm_local, state, pm_pl, donate=donate)
    updates = {p: _like(v, matrix_updates[p], pm_pl[p], mesh)
               for p, v in pm.items()}
    if isinstance(params, torch.nn.Module):
        params = tree.from_named(params.named_parameters())
    return tree.rebuild(params, {**updates, **adam_updates}), MuonState(
        state.step + 1, new_momentum, adamw_state, state.error_feedback,
        new_vstate)


def _gather_update(plan: DedicationPlan, gm, gm_pl, pm, state: MuonState,
                   cfg: MuonConfig, layout: OwnerLayout,
                   donate: bool = False):
    """Muon-AG baseline: momentum in training layout; under a mesh each
    gradient is reduced, its momentum look-ahead all-gathered, and every
    rank runs the full-matrix standard NS of every leaf."""
    mesh = layout.mesh
    new_momentum: Dict[str, torch.Tensor] = {}
    eff_all: Dict[str, torch.Tensor] = {}
    mdt = as_dtype(cfg.momentum_dtype)
    for p, g in gm.items():
        if mesh is not None:
            g = reduce_partial(g, gm_pl[p], mesh)
        old = state.momentum.pop(p) if donate else state.momentum[p]
        mom, eff = momentum_update(old.float(), g.float(), cfg)
        del old
        new_momentum[p] = mom.to(mdt)
        eff_all[p] = eff if mesh is None else \
            replicate(eff, published(gm_pl[p]), mesh)
    ortho, _ = FullMatrixNS()(eff_all, step=state.step, state=None,
                              layout=layout, cfg=cfg)
    matrix_updates: Dict[str, torch.Tensor] = {}
    for p, o in ortho.items():
        m, n = plan.leaves[p].group
        s = scale_factor(m, n, cfg.scale_mode)
        if mesh is not None:
            o = local_shard(o, gm_pl[p], mesh)
        matrix_updates[p] = apply_wd_and_lr(o * s, pm[p], cfg)
    return matrix_updates, new_momentum
