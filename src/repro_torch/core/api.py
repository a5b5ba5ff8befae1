"""Drop-in user surface (port of ``repro.core.api``; paper Fig. 1a):

    import repro_torch.core.api as dmuon
    plan = dmuon.dedicate_params(params, mesh=mesh)
    opt  = dmuon.Muon(plan, mesh=mesh, learning_rate=0.02)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)

``params`` and ``grads`` are nested dicts of tensors (or ``params`` an
``nn.Module``); ``update`` returns update *deltas*, as the reference does.
``mesh`` is an optional ``DeviceMesh`` (``repro_torch.launch.mesh``): its
axes, all by default or ``owner_axes``, are the owners, one slot per rank.
Under it a gradient is a ``DTensor`` in its training layout (``Partial``
for data parallelism) or a plain tensor (replicated), and the state holds
each rank's own part (``core/muon.py``).

Variant registry
----------------
``MuonConfig.variant`` selects a named optimizer variant; all but AdamW
share the owner-layout pipeline (``core/owner_comms.py``) and differ only in
the orthogonalizer backend (``core/orthogonalize.py``) and its per-group
state:

    muon     — plain orthogonalized updates (the paper's optimizer)
    normuon  — NorMuon: neuron-wise second-moment normalization of the
               orthogonalized update
    muonbp   — MuonBP: full NS refresh every ``muonbp_period`` steps, the
               cached polar map in between
    dion2    — Dion2: Gram NS on a warm-started rank-r factor only
               (``dion2_rank_frac``), the full update reconstructed
    adamuon  — AdaMuon: elementwise second-moment adaptation of the
               orthogonalized update, norm-preserving
    adamw    — elementwise AdamW baseline

``register_variant`` plugs in further backends.

Pipelines (``MuonConfig.pipeline``): ``"fused"`` runs the owner update as
one phase; ``"bucketed"`` stages, computes and publishes one Gram bucket at
a time with asynchronous collectives (``core/pipeline.py``), bit for bit
the same updates.  ``update_staged`` takes gradients already staged to the
owners (the train step's accumulation-overlapped mode).
"""

from __future__ import annotations

from dataclasses import replace
import functools
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import dedication
from repro_torch.core.dedication import DedicationPlan, default_muon_predicate
from repro_torch.core.gram_ns import GramNSConfig
from repro_torch.core.muon import (AdamWState, MuonConfig, MuonState,
                                   _resolve, muon_init, muon_update,
                                   muon_update_staged)
from repro_torch.core.orthogonalize import dion2_rank
from repro_torch.core.owner_comms import OwnerLayout, group_key_str, repack_rows
from repro_torch.core.update_rules import VariantSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import axis_sizes

__all__ = ["dedicate_params", "Muon", "MuonConfig", "GramNSConfig",
           "DedicationPlan", "default_muon_predicate", "VariantSpec",
           "VARIANTS", "register_variant", "get_variant",
           "reshard_owner_state"]


VARIANTS: Dict[str, VariantSpec] = {}


def register_variant(spec: VariantSpec, *, overwrite: bool = False) -> None:
    """Register a named optimizer variant."""
    if spec.name in VARIANTS and not overwrite:
        raise ValueError(f"variant {spec.name!r} already registered")
    VARIANTS[spec.name] = spec


def get_variant(name: str) -> VariantSpec:
    try:
        return VARIANTS[name]
    except KeyError:
        raise ValueError(
            f"unknown variant {name!r}; known: {sorted(VARIANTS)}") from None


register_variant(VariantSpec(
    "muon", orthogonalizer="auto",
    description="owner-centric Muon: batched Gram NS (bucket-fused when "
                "GramNSConfig.bucket_fusion)"))
register_variant(VariantSpec(
    "normuon", orthogonalizer="normuon", stateful=True,
    description="Muon + NorMuon neuron-wise second-moment normalization"))
register_variant(VariantSpec(
    "muonbp", orthogonalizer="block_periodic", stateful=True,
    description="Muon with block-periodic NS refresh (MuonBP)"))
register_variant(VariantSpec(
    "dion2", orthogonalizer="dion2", stateful=True,
    description="Dion2: batched Gram NS on a warm-started rank-r factor "
                "only (dion2_rank_frac), full update reconstructed"))
register_variant(VariantSpec(
    "adamuon", orthogonalizer="adamuon", stateful=True,
    description="AdaMuon: elementwise second-moment adaptation of the "
                "orthogonalized update, norm-preserving"))
register_variant(VariantSpec(
    "adamw", orthogonalizer="none", elementwise=True,
    description="elementwise AdamW baseline (no matrix pipeline)"))


def dedicate_params(params, mesh=None, *, num_owners: Optional[int] = None,
                    strategy: str = "load_balance",
                    owner_axes: Tuple[str, ...] = (), **kw) -> DedicationPlan:
    """Plan ownership for ``params`` over ``mesh`` (or ``num_owners`` slots,
    default 1).

    With a mesh, the owner axis is the flattened mesh (all axes by default;
    restrict with ``owner_axes``) and the XOR slot layout uses the owner
    axes' extents as (rows, cols): the last one is cols, the rest rows.
    """
    if mesh is not None:
        sizes = axis_sizes(mesh)
        axes = owner_axes or tuple(sizes)
        num_owners = math.prod(sizes[a] for a in axes)
        cols = sizes[axes[-1]]
        kw.setdefault("mesh_rows", num_owners // cols)
        kw.setdefault("mesh_cols", cols)
    elif num_owners is None:
        num_owners = 1
    return dedication.dedicate_params(
        params, num_owners=num_owners, strategy=strategy,
        owner_axes=owner_axes, **kw)


class Muon:
    """Functional optimizer implementing the DMuon training step (Alg. 1).

    ``device`` is where the optimizer state lives and the kernels run:
    CUDA unless ``device="cpu"`` is passed.  ``mesh`` (a ``DeviceMesh``)
    spreads the owners over its ranks."""

    def __init__(self, plan: DedicationPlan, mesh=None,
                 config: Optional[MuonConfig] = None, *,
                 device: DeviceLike = None, **overrides):
        self.plan = plan
        self.mesh = mesh
        self.device = resolve_device(device)
        cfg = config or MuonConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        spec, _ = _resolve(cfg)          # fail fast on unported settings
        self.config = cfg
        if cfg.autotune_prewarm and not spec.elementwise:
            # Parameter shapes are fixed for the whole run, so score every
            # kernel shape of the plan once, at init, into the cache.  Dion2
            # runs the kernels on its r×n factors.
            from repro_torch.kernels.autotune import device_arch, prewarm_plan
            gram_dim = None
            if spec.orthogonalizer == "dion2":
                gram_dim = functools.partial(dion2_rank, cfg=cfg)
            prewarm_plan(plan, dtypes=(cfg.ns.compute_dtype,),
                         arch=device_arch(self.device), gram_dim=gram_dim)

    @property
    def variant(self) -> VariantSpec:
        return get_variant(self.config.variant)

    @property
    def effective_mode(self) -> str:
        """Execution mode after variant resolution."""
        return _resolve(self.config)[1]

    def replace(self, **overrides) -> "Muon":
        """A new Muon sharing this plan, mesh and device, config fields
        overridden."""
        return Muon(self.plan, self.mesh,
                    config=replace(self.config, **overrides),
                    device=self.device)

    def init(self, params) -> MuonState:
        return muon_init(self.plan, params, self.config, self.mesh,
                         device=self.device)

    def update(self, grads, state: MuonState, params):
        return muon_update(self.plan, grads, state, params, self.config,
                           self.mesh)

    def update_staged(self, staged, rest_grads, state: MuonState, params):
        """Optimizer step from pre-staged owner-layout matrix gradients (the
        accumulation-overlapped bucketed pipeline; see core/pipeline.py)."""
        return muon_update_staged(self.plan, staged, rest_grads, state,
                                  params, self.config, self.mesh)

    def state_dict(self, state: MuonState) -> dict:
        return {"step": state.step, "momentum": state.momentum,
                "adamw_mu": state.adamw.mu, "adamw_nu": state.adamw.nu,
                "error_feedback": state.error_feedback,
                "variant_state": state.variant_state}

    def load_state_dict(self, d: dict) -> MuonState:
        return MuonState(step=d["step"], momentum=d["momentum"],
                         adamw=AdamWState(d["adamw_mu"], d["adamw_nu"]),
                         error_feedback=d.get("error_feedback"),
                         variant_state=d.get("variant_state"))


def map_owner_buffers(state: MuonState, fn) -> MuonState:
    """``state`` with ``fn(group_key_str, buffer)`` applied to every
    owner-major buffer: the momentum and each non-None variant-state field
    (None fields stay None, so the tree matches a fresh ``muon_init``'s).
    AdamW moments and error feedback are training-layout trees and pass
    through as they are."""
    vstate = state.variant_state
    if vstate is not None:
        vstate = {field: None if bufs is None else
                  {skey: fn(skey, buf) for skey, buf in bufs.items()}
                  for field, bufs in vstate.items()}
    return MuonState(step=state.step,
                     momentum={skey: fn(skey, buf)
                               for skey, buf in state.momentum.items()},
                     adamw=state.adamw, error_feedback=state.error_feedback,
                     variant_state=vstate)


def reshard_owner_state(state: MuonState, old_plan: DedicationPlan,
                        new_plan: DedicationPlan, mesh=None) -> MuonState:
    """Elastic restart across owner counts (fault-tolerance substrate).

    Owner-layout buffers are padded to ``D·cap`` rows, so a state taken at D
    owners cannot be used verbatim at D′ owners after a node failure.  Each
    group's owner-major buffers are unpacked to their logical (count, ...)
    rows under the OLD plan and repacked / padded under the NEW plan
    (``owner_comms.repack_rows``): an exact permutation of the logical rows,
    the pad rows zero.  This covers the momentum and every per-variant
    state buffer (NorMuon / AdaMuon moments, MuonBP polar caches, Dion2
    bases), which share the owner-major row layout.  AdamW moments and
    error feedback are training-layout trees and pass through as they are.

    Under ``mesh`` each rank holds only its own rows (``OwnerLayout.
    local_rows``): the group's D·cap rows are all-gathered over the owner
    axes, repacked, and this rank keeps its block of the new layout.  Both
    plans must then be plans of this mesh (the rebalance case, equal owner
    counts); a move across world sizes goes through a checkpoint
    (``checkpoint/manager.py``), whose restore assembles every row."""
    skey_to_key = {group_key_str(k): k for k in old_plan.groups}
    old_layout = OwnerLayout(old_plan, mesh)
    new_layout = OwnerLayout(new_plan, mesh)

    def repack(skey, buf):
        old_g = old_plan.groups[skey_to_key[skey]]
        new_g = new_plan.groups[skey_to_key[skey]]
        if old_g.count != new_g.count:
            raise ValueError(
                f"reshard_owner_state: group {skey!r} has {old_g.count} "
                f"logical rows under the old plan but {new_g.count} under "
                f"the new plan — the plans describe different parameter "
                f"sets, not an owner-count change")
        full = repack_rows(old_g, new_g, old_layout.gather_rows(buf))
        if mesh is None:
            return full
        return new_layout.local_block(full).clone()   # free the others' rows

    return map_owner_buffers(state, repack)
