"""DMuon as a ``torch.optim.Optimizer``: the drop-in front door.

The reference states its drop-in property for the optax protocol
(``init`` / ``update`` returning deltas, ``core/api.py``).  A PyTorch
training loop speaks ``torch.optim``:

    opt = MuonOptimizer(model, mesh, device="cuda")
    for batch in data:
        loss_fn(model, batch).backward()
        opt.step()
        opt.zero_grad()

``MuonOptimizer`` wraps the functional ``Muon`` and adds no update of its
own: ``step`` reads each parameter's ``.grad``, runs ``Muon.update`` on the
whole tree and adds the deltas in place, as ``train/step.py`` does.  Its
two parameter groups are the plan's Muon matrices (``lr`` is
``MuonConfig.learning_rate``) and the rest (``lr`` is ``adam_lr``), so a
``torch.optim.lr_scheduler`` drives both rates.  With an elementwise
variant (``adamw``) every parameter takes ``adam_lr``, the second group's
rate, as ``Muon`` does.

Under a data-parallel mesh (``("data",)``, or a mesh whose other axes have
one rank) each rank runs its own backward without
``DistributedDataParallel``: with ``grads="partial"`` its gradients go to
the optimizer as ``Partial("avg")`` ``DTensor``s, and the owner
reduce-scatter takes the place of DDP's all-reduce (the point of DMuon).
``grads="replicated"`` takes gradients a DDP wrapper has already averaged.
A mesh that splits parameters over 'model' keeps ``make_train_step``
(ROADMAP item 12).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import replace
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.core import tree
from repro_torch.core.api import Muon, dedicate_params
from repro_torch.core.dedication import DedicationPlan
from repro_torch.core.muon import MuonConfig, MuonState
from repro_torch.core.owner_comms import OwnerLayout, group_key_str
from repro_torch.device import DeviceLike

__all__ = ["MuonOptimizer"]

GRADS = ("partial", "replicated")


def _containers(node):
    """``node`` with every dict copied and the tensors shared: the update
    with ``donate`` pops the spent state's tensors out of its dicts."""
    if isinstance(node, Mapping):
        return {k: _containers(v) for k, v in node.items()}
    return node


class MuonOptimizer(torch.optim.Optimizer):
    """``torch.optim.Optimizer`` over ``core.api.Muon``.

    ``params``: an ``nn.Module`` or a nested dict of leaf tensors; the plan
    names them by their '/'-joined paths ('.' of a module's names becomes
    '/'), the reference's paths.  ``plan``: ``dedicate_params(params,
    mesh)`` unless given.  ``config`` and ``overrides``: the
    ``MuonConfig`` (fields overridden by ``overrides``).  ``device``: where
    the optimizer state lives and the kernels run (CUDA unless given).
    ``grads``: under a mesh, "partial" (each rank's own backward; the
    update averages over the data axes) or "replicated" (already
    averaged, e.g. by ``DistributedDataParallel``).

    The ``MuonState`` is ``muon_state``; ``self.state`` stays empty."""

    def __init__(self, params, mesh=None, *,
                 plan: Optional[DedicationPlan] = None,
                 config: Optional[MuonConfig] = None,
                 device: DeviceLike = None, grads: str = "partial",
                 **overrides):
        if grads not in GRADS:
            raise ValueError(f"grads={grads!r}; known: {GRADS}")
        if mesh is not None:
            from repro_torch.models.sharding import dp_axes
            dp = dp_axes(mesh)
            split = [a for i, a in enumerate(mesh.mesh_dim_names)
                     if a not in dp and mesh.size(i) > 1]
            if split:
                raise NotImplementedError(
                    f"MuonOptimizer runs in one process or over data axes; "
                    f"axes {split} of more than one rank split the "
                    f"parameters, which make_train_step trains (ROADMAP "
                    f"item 12)")
            self._grad_placements = tuple(
                Partial("avg") if a in dp else Replicate()
                for a in mesh.mesh_dim_names)
        self._tree = tree.from_named(params.named_parameters()) \
            if isinstance(params, torch.nn.Module) else params
        self._flat = tree.flatten(self._tree)
        self.plan = plan or dedicate_params(self._tree, mesh)
        self.mesh = mesh
        self.grads = grads
        self.muon = Muon(self.plan, mesh, config, device=device,
                         **overrides)
        cfg = self.muon.config
        matrix = [v for p, v in self._flat if p in self.plan.leaves]
        rest = [v for p, v in self._flat if p not in self.plan.leaves]
        groups = [{"params": matrix, "lr": cfg.learning_rate},
                  {"params": rest, "lr": cfg.adam_lr}]
        super().__init__(groups, {"lr": cfg.learning_rate,
                                  "momentum": cfg.momentum,
                                  "weight_decay": cfg.weight_decay})
        self.muon_state: MuonState = self.muon.init(self._tree)

    def _rates(self) -> dict:
        """The groups' ``lr``s as the config's fields."""
        return {"learning_rate": self.param_groups[0]["lr"],
                "adam_lr": self.param_groups[1]["lr"]}

    def _grad(self, path: str, p: torch.Tensor):
        g = p.grad
        if g is None:
            raise ValueError(
                f"parameter {path!r} has no gradient: the update takes the "
                "whole tree (every parameter in the loss)")
        if self.mesh is None or self.grads == "replicated":
            return g
        return DTensor.from_local(g, self.mesh, self._grad_placements,
                                  run_check=False)

    def step(self, closure=None):
        """One DMuon step from every parameter's ``.grad``; the deltas are
        added to the parameters in place."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        rates = self._rates()
        cfg = self.muon.config
        if any(getattr(cfg, k) != v for k, v in rates.items()):
            self.muon.config = replace(cfg, **rates)
        grads = tree.rebuild(self._tree, {p: self._grad(p, v)
                                          for p, v in self._flat})
        updates, self.muon_state = self.muon.update(
            grads, self.muon_state, self._tree, donate=True)
        with torch.no_grad():
            for (_, p), (_, u) in zip(self._flat, tree.flatten(updates)):
                p.add_(u.to_local() if isinstance(u, DTensor) else u)
        return loss

    # ------------------------------------------------------------ state

    def state_dict(self) -> dict:
        """This rank's optimizer state (``Muon.state_dict``: its owner rows,
        the AdamW moments of its parameters) and the groups' settings, in
        the form ``checkpoint/manager.py`` saves per rank."""
        return {"state": _containers(self.muon.state_dict(self.muon_state)),
                "param_groups": [{k: v for k, v in g.items()
                                  if k != "params"}
                                 for g in self.param_groups],
                "num_owners": self.plan.num_owners,
                "groups": sorted(group_key_str(k) for k in self.plan.groups)}

    def load_state_dict(self, state_dict: dict) -> None:
        """Resume from ``state_dict`` (a ``state_dict()`` of an optimizer on
        the same plan); a state of another owner count or other groups
        raises (``reshard_owner_state`` moves one across plans)."""
        groups = sorted(group_key_str(k) for k in self.plan.groups)
        if state_dict["num_owners"] != self.plan.num_owners or \
                list(state_dict["groups"]) != groups:
            raise ValueError(
                f"state of {state_dict['num_owners']} owners and groups "
                f"{list(state_dict['groups'])}; this optimizer's plan has "
                f"{self.plan.num_owners} owners and groups {groups} "
                "(reshard_owner_state moves a state across plans)")
        saved = state_dict["param_groups"]
        if len(saved) != len(self.param_groups):
            raise ValueError(f"{len(saved)} parameter groups saved, "
                             f"{len(self.param_groups)} here")
        state = self.muon.load_state_dict(_containers(state_dict["state"]))
        layout = OwnerLayout(self.plan, self.mesh)
        if self.muon.effective_mode == "owner":
            for k in self.plan.groups:
                rows = state.momentum[group_key_str(k)].shape[0]
                if rows != layout.local_rows(k):
                    raise ValueError(
                        f"group {group_key_str(k)!r}: {rows} owner rows "
                        f"saved, {layout.local_rows(k)} on this rank")
        for group, g in zip(self.param_groups, saved):
            group.update({k: v for k, v in g.items() if k != "params"})
        self.muon_state = state
