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

Variant registry: ``muon`` (owner-centric Muon, batched Gram NS) and
``adamw`` (elementwise baseline).  The reference's normuon, muonbp, dion2 and
adamuon wait for ROADMAP item 7.
"""

from __future__ import annotations

from dataclasses import replace
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import dedication
from repro_torch.core.dedication import DedicationPlan, default_muon_predicate
from repro_torch.core.gram_ns import GramNSConfig
from repro_torch.core.muon import (AdamWState, MuonConfig, MuonState,
                                   _resolve, muon_init, muon_update)
from repro_torch.core.update_rules import VariantSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import axis_sizes

__all__ = ["dedicate_params", "Muon", "MuonConfig", "GramNSConfig",
           "DedicationPlan", "default_muon_predicate", "VariantSpec",
           "VARIANTS", "register_variant", "get_variant"]


VARIANTS: Dict[str, VariantSpec] = {}
PENDING_VARIANTS = ("adamuon", "dion2", "muonbp", "normuon")


def register_variant(spec: VariantSpec, *, overwrite: bool = False) -> None:
    """Register a named optimizer variant."""
    if spec.name in VARIANTS and not overwrite:
        raise ValueError(f"variant {spec.name!r} already registered")
    VARIANTS[spec.name] = spec


def get_variant(name: str) -> VariantSpec:
    try:
        return VARIANTS[name]
    except KeyError:
        if name in PENDING_VARIANTS:
            raise ValueError(f"variant {name!r} is not ported yet "
                             "(ROADMAP item 7)") from None
        raise ValueError(
            f"unknown variant {name!r}; known: {sorted(VARIANTS)}") from None


register_variant(VariantSpec(
    "muon", orthogonalizer="auto",
    description="owner-centric Muon: batched Gram NS (bucket-fused when "
                "GramNSConfig.bucket_fusion)"))
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
            # kernel shape of the plan once, at init, into the cache.
            from repro_torch.kernels.autotune import device_arch, prewarm_plan
            prewarm_plan(plan, dtypes=(cfg.ns.compute_dtype,),
                         arch=device_arch(self.device))

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
        raise ValueError("update_staged (the bucketed pipeline) is not ported "
                         "yet (ROADMAP item 7)")

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
