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
    OwnerLayout, group_key_str, local_shard, pack_group, published,
    reduce_partial, replicate, unpack_group)
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
    # optimizer variant by name (registry in core/api.py): 'muon', 'adamw';
    # the reference's normuon / muonbp / dion2 / adamuon wait for ROADMAP
    # item 7
    variant: str = "muon"
    # 'fused': pack all → NS all → publish all.  'bucketed' waits for
    # ROADMAP item 7.
    pipeline: str = "fused"
    pipeline_barriers: bool = True       # read by the bucketed pipeline only
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
    # variant knobs of the reference, kept so configs carry over
    normuon_beta2: float = 0.95
    normuon_eps: float = 1e-8
    muonbp_period: int = 4
    dion2_rank_frac: float = 0.25
    adamuon_beta2: float = 0.95
    adamuon_eps: float = 1e-8


def _resolve(cfg: MuonConfig):
    """(variant_spec, effective_mode) for ``cfg`` — validates the combo."""
    from repro_torch.core.api import get_variant   # lazy: api imports this module
    spec = get_variant(cfg.variant)
    mode = "adamw" if spec.elementwise else cfg.mode
    if mode not in ("owner", "gather", "adamw"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.pipeline == "bucketed":
        raise ValueError("pipeline='bucketed' is not ported yet "
                         "(ROADMAP item 7); use pipeline='fused'")
    if cfg.pipeline != "fused":
        raise ValueError(f"unknown pipeline {cfg.pipeline!r}; known: 'fused'")
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
    variant_state: Any = None    # per-variant state (none for 'muon')


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
    if mode == "owner":
        momentum = {group_key_str(key): layout.zeros(key, mdt)
                    for key in plan.groups}
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
                     error_feedback=ef, variant_state=None)


@torch.no_grad()
def muon_update(plan: DedicationPlan, grads, state: MuonState, params,
                cfg: MuonConfig, mesh=None):
    """One optimizer step.  Returns (updates, new_state); updates are deltas
    to be *added* to params."""
    spec, mode = _resolve(cfg)
    layout = OwnerLayout(plan, mesh)
    gm, gr = _matrix_and_rest(plan, grads)
    pm, pr = _matrix_and_rest(plan, params)
    if mode == "adamw":
        gr, pr, gm, pm = {**gr, **gm}, {**pr, **pm}, {}, {}
    gm_local, gm_pl = _split(layout, gm)
    gr_local, gr_pl = _split(layout, gr)
    pm_local, _ = _split(layout, pm)
    pr_local, _ = _split(layout, pr)
    if mesh is not None:    # AdamW is elementwise: reduce first
        gr_local = {p: reduce_partial(g, gr_pl[p], mesh)
                    for p, g in gr_local.items()}

    adam_updates, adamw_state = adamw_update(gr_local, state.adamw, pr_local,
                                             state.step, cfg)
    if mode == "owner":
        matrix_updates, new_momentum, new_ef = _owner_update(
            plan, gm_local, gm_pl, pm_local, state, cfg, layout, spec)
    elif mode == "gather":
        matrix_updates, new_momentum = _gather_update(
            plan, gm_local, gm_pl, pm_local, state, cfg, layout)
        new_ef = state.error_feedback
    else:
        matrix_updates, new_momentum = {}, state.momentum
        new_ef = state.error_feedback
    updates = {p: _like(g, matrix_updates[p], gm_pl[p], mesh)
               for p, g in gm.items()}
    updates.update({p: _like(g, adam_updates[p], gr_pl[p], mesh)
                    for p, g in gr.items()})
    return tree.rebuild(grads, updates), MuonState(
        state.step + 1, new_momentum, adamw_state, new_ef,
        state.variant_state)


def _owner_update(plan: DedicationPlan, gm, gm_pl, pm, state: MuonState,
                  cfg: MuonConfig, layout: OwnerLayout, spec):
    """DMuon path: pack (reduce-to-owner) → momentum → orthogonalize on the
    local owner rows → unpack (publish) + scale/wd/lr.  Alg. 1 lines 10–15.
    ``gm`` / ``pm`` hold local parts, ``gm_pl`` the gradients' placements."""
    if cfg.compress_grads and any(
            p.is_partial() for pl in gm_pl.values() if pl for p in pl):
        raise ValueError(
            "compress_grads with Partial (data-parallel) gradients would "
            "reduce them in bf16; not ported yet (ROADMAP item 6)")
    new_momentum: Dict[str, torch.Tensor] = {}
    grads_for_pack, new_ef = compress_with_error_feedback(
        gm, state.error_feedback, cfg)

    pdt = as_dtype(cfg.pack_dtype)
    mdt = as_dtype(cfg.momentum_dtype)
    packed_mom: Dict[str, torch.Tensor] = {}
    skey_to_key = {group_key_str(key): key for key in plan.groups}
    for key, g in plan.groups.items():
        g_packed = layout.pack(key, {p: grads_for_pack[p].to(pdt)
                                     for p in g.leaf_paths}, gm_pl)
        skey = group_key_str(key)
        mom, eff = momentum_update(state.momentum[skey].to(pdt), g_packed, cfg)
        new_momentum[skey] = mom.to(mdt)
        packed_mom[skey] = eff

    ortho_fn = make_orthogonalizer(spec.orthogonalizer, cfg)
    ortho, _ = ortho_fn(packed_mom, step=state.step, state=state.variant_state,
                        layout=layout, cfg=cfg)

    matrix_updates: Dict[str, torch.Tensor] = {}
    for skey, o in ortho.items():
        key = skey_to_key[skey]
        m, n = plan.groups[key].key
        s = scale_factor(m, n, cfg.scale_mode)
        for p, upd in layout.unpack(key, o.to(pdt) * s, gm_pl).items():
            matrix_updates[p] = apply_wd_and_lr(upd, pm[p], cfg)
    return matrix_updates, new_momentum, new_ef


def _gather_update(plan: DedicationPlan, gm, gm_pl, pm, state: MuonState,
                   cfg: MuonConfig, layout: OwnerLayout):
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
        mom, eff = momentum_update(state.momentum[p].float(), g.float(), cfg)
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
