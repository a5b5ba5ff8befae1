"""Train-step factory (port of ``repro.train.step``): loss, gradient
accumulation and the optimizer transform, eagerly.

``make_train_step`` returns ``step(state, batch) -> state``: forward and
backward (autograd of plain tensor code; remat per ``cfg.remat``), then the
optimizer — owner-centric DMuon, Muon-AG or AdamW per the MuonConfig the
caller gave ``Muon`` — whose deltas are added to the parameters in place.
``accum_steps`` splits the batch on its leading axis and accumulates fp32
gradients over the microbatches.

Under a ``DeviceMesh`` the step is data-parallel over
``models.sharding.dp_axes(mesh)``: parameters are replicated (the same
seed on every rank, checked once by ``init_state``), each rank runs forward
and backward on its own rows of the global batch
(``data.pipeline.batch_for_step(..., mesh=mesh)``), and its gradients go to
the optimizer as ``Partial("avg")`` ``DTensor``s over those axes, so the
owner update reduces each gradient straight to its owner.  The published
deltas are added on every rank.  The tensor-parallel forward (sharded
weights and logits inside the model) is not ported (ROADMAP item 6).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.core import tree
from repro_torch.core.api import Muon
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model_fns
from repro_torch.models.sharding import dp_axes
from repro_torch.train.train_state import TrainState


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy as logsumexp − gold logit, in fp32.  (The
    reference sums a where-mask for vocab sharding; a gather reads the same
    gold value without the (B, S, V) temporary.)"""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(cfg) -> Callable:
    m = model_fns(cfg)

    def loss_fn(params, batch):
        logits = m.forward(cfg, params, batch["tokens"])
        return softmax_xent(logits, batch["labels"])
    return loss_fn


def make_train_step(cfg, opt: Muon, mesh=None, *, accum_steps: int = 1,
                    device: DeviceLike = None):
    """Returns ``step(state, batch) -> state`` running on ``device`` (CUDA
    unless given; it must be where ``init_state`` put the parameters).
    With ``mesh`` (the optimizer's), ``batch`` is this rank's rows."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(cfg)
    if mesh is not None:
        if opt.mesh is not mesh:
            raise ValueError("the optimizer must be built on the step's mesh")
        dp = dp_axes(mesh)
        dp_dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a in dp]
        grad_placements = tuple(Partial("avg") if i in dp_dims
                                else Replicate() for i in range(mesh.ndim))

    def mean_over_dp(loss):
        """The global batch's mean loss from each rank's local mean."""
        for i in dp_dims:
            dist.all_reduce(loss, group=mesh.get_group(i))
            loss /= mesh.size(i)
        return loss

    def compute_grads(params, leaves, batch):
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        micro = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in leaves]
        for i in range(accum_steps):
            loss = loss_fn(params, {k: v[i] for k, v in micro.items()})
            grads = torch.autograd.grad(loss, leaves)
            loss_acc += loss.detach()
            for a, g in zip(grad_acc, grads):
                a += g.float()
        inv = 1.0 / accum_steps
        return loss_acc * inv, [g * inv for g in grad_acc]

    def step(state: TrainState, batch) -> TrainState:
        paths, leaves = zip(*tree.flatten(state.params))
        loss, grads = compute_grads(state.params, list(leaves), batch)
        if mesh is not None:
            grads = [DTensor.from_local(g, mesh, grad_placements,
                                        run_check=False) for g in grads]
            loss = mean_over_dp(loss)
        grads = tree.rebuild(state.params, dict(zip(paths, grads)))
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for (_, p), (_, u) in zip(tree.flatten(state.params),
                                      tree.flatten(updates)):
                p.add_(u.to_local() if isinstance(u, DTensor) else u)
        ema = loss if state.step == 0 else 0.98 * state.loss_ema + 0.02 * loss
        return TrainState(state.step + 1, state.params, opt_state, ema)

    return step


def init_state(cfg, opt: Muon, seed: int = 0, device: DeviceLike = None,
               *, mesh=None) -> TrainState:
    """Random parameters (``torch.Generator(device)`` seeded with ``seed``)
    as leaf tensors requiring grad, plus the optimizer state.  Under
    ``mesh`` the parameters are replicated: every rank draws them from the
    same seed, and a checksum compared across ranks proves it."""
    device = resolve_device(device)
    m = model_fns(cfg)
    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           m.init(cfg, seed, device))
    if mesh is not None:
        _check_replicated(params)
    return TrainState(0, params, opt.init(params),
                      torch.zeros((), dtype=torch.float32, device=device))


def _check_replicated(params) -> None:
    """Raise unless every rank holds the same parameters (a float64 sum of
    each leaf, and their positions, compared across the world)."""
    with torch.no_grad():
        sums = torch.stack([v.double().sum() * (i + 1) for i, (_, v) in
                            enumerate(tree.flatten(params))]).sum()
    world = dist.get_world_size()
    out = sums.new_empty(world)
    dist.all_gather_into_tensor(out, sums.reshape(1))
    if not bool((out == sums).all()):
        raise RuntimeError(f"parameters differ across ranks: checksums "
                           f"{out.tolist()}")
