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

Pipelines (``pipeline=`` / ``MuonConfig.pipeline``):

* ``"fused"``    — the optimizer runs as one post-backward phase (default).
* ``"bucketed"`` — per-Gram-bucket stage_in / compute / publish with
  asynchronous collectives (``core/pipeline.py``).  With ``accum_steps > 1``
  and prestaging, each microbatch's matrix gradients are staged to the
  owners (a reduce-scatter under a mesh) right after its backward and added
  into an owner-layout fp32 accumulator after the next microbatch's
  backward, so the owner transposes ride under that microbatch's forward
  and backward; the AdamW gradients accumulate locally and are reduced
  once; then ``opt.update_staged``.  In one process bit-exact with the
  unstaged step (``tests/test_torch_pipeline.py``); under a mesh with
  ``Partial`` gradients, "reduce-scatter each microbatch, then sum" and
  "sum, then reduce-scatter" differ by rounding.
"""

from __future__ import annotations

from typing import Callable, Optional

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
        kwargs = {k: batch[k] for k in ("patches", "frames") if k in batch}
        logits = m.forward(cfg, params, batch["tokens"], **kwargs)
        return softmax_xent(logits, batch["labels"])
    return loss_fn


def make_train_step(cfg, opt: Muon, mesh=None, *, accum_steps: int = 1,
                    pipeline: Optional[str] = None,
                    prestage: Optional[bool] = None,
                    donate: bool = False,
                    device: DeviceLike = None):
    """Returns ``step(state, batch) -> state`` running on ``device`` (CUDA
    unless given; it must be where ``init_state`` put the parameters).
    With ``mesh`` (the optimizer's), ``batch`` is this rank's rows.

    ``pipeline`` overrides ``opt.config.pipeline`` through ``opt.replace``
    (the caller's ``opt`` is untouched).  ``prestage`` forces the
    accumulation-overlapped staging on or off; None (auto) turns it on for
    a mesh of more than one rank, where the staged reduce-scatters are real
    transfers to hide.  It runs only with ``pipeline="bucketed"``,
    ``accum_steps > 1``, owner mode and no ``compress_grads`` (whose error
    feedback needs the summed gradient in the training layout).

    ``donate`` (the reference's ``donate``, off by default here): the
    optimizer releases the incoming state's momentum and AdamW moments as
    it makes their successors (``Muon.update(..., donate=True)``), so a
    step holds one optimizer state, not two; the state passed to ``step``
    is spent."""
    device = resolve_device(device)
    if pipeline is not None and pipeline != opt.config.pipeline:
        opt = opt.replace(pipeline=pipeline)
    if prestage is None:
        prestage = mesh is not None and mesh.size() > 1
    prestage = (prestage and opt.config.pipeline == "bucketed"
                and accum_steps > 1 and opt.effective_mode == "owner"
                and not opt.config.compress_grads)
    loss_fn = make_loss_fn(cfg)
    grad_placements = None
    if mesh is not None:
        if opt.mesh is not mesh:
            raise ValueError("the optimizer must be built on the step's mesh")
        dp = dp_axes(mesh)
        dp_dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a in dp]
        grad_placements = tuple(Partial("avg") if i in dp_dims
                                else Replicate() for i in range(mesh.ndim))
    pipe = None
    if prestage:
        from repro_torch.core.pipeline import BucketPipeline, wait_all
        pipe = BucketPipeline(opt.plan, opt.config, mesh, opt.variant,
                              device=device)

    def mean_over_dp(loss):
        """The global batch's mean loss from each rank's local mean."""
        for i in dp_dims:
            dist.all_reduce(loss, group=mesh.get_group(i))
            loss /= mesh.size(i)
        return loss

    def split(batch):
        return {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                for k, v in batch.items()}

    def compute_grads(params, leaves, batch):
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        micro = split(batch)
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

    def compute_grads_staged(params, paths, leaves, batch):
        """(loss, staged owner-layout matrix gradients, AdamW gradients):
        microbatch i's stage_in is issued after its backward and added
        after microbatch i+1's, so it rides under that forward and
        backward."""
        matrix = [j for j, p in enumerate(paths) if p in opt.plan.leaves]
        rest = [j for j, p in enumerate(paths) if p not in opt.plan.leaves]
        placements = None if mesh is None else \
            {paths[j]: grad_placements for j in matrix}
        micro = split(batch)
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        staged = pipe.zeros_staged(torch.float32)
        rest_acc = [torch.zeros(leaves[j].shape, dtype=torch.float32,
                                device=device) for j in rest]
        inflight = None
        for i in range(accum_steps):
            loss = loss_fn(params, {k: v[i] for k, v in micro.items()})
            grads = torch.autograd.grad(loss, leaves)
            loss_acc += loss.detach()
            if inflight is not None:
                for k, v in wait_all(inflight).items():
                    staged[k] += v
            inflight = pipe.stage_in_all({paths[j]: grads[j] for j in matrix},
                                         placements, dtype=torch.float32)
            for a, j in zip(rest_acc, rest):
                a += grads[j].float()
            del grads
        for k, v in wait_all(inflight).items():
            staged[k] += v
        inv = 1.0 / accum_steps
        return (loss_acc * inv, {k: v * inv for k, v in staged.items()},
                {paths[j]: a * inv for j, a in zip(rest, rest_acc)})

    def as_grad(g):
        return g if mesh is None else \
            DTensor.from_local(g, mesh, grad_placements, run_check=False)

    def step(state: TrainState, batch) -> TrainState:
        paths, leaves = zip(*tree.flatten(state.params))
        if prestage:
            loss, staged, rest = compute_grads_staged(
                state.params, paths, list(leaves), batch)
        else:
            loss, grads = compute_grads(state.params, list(leaves), batch)
        if mesh is not None:
            loss = mean_over_dp(loss)
        if prestage:
            updates, opt_state = opt.update_staged(
                staged, {p: as_grad(g) for p, g in rest.items()},
                state.opt_state, state.params, donate=donate)
        else:
            grads = tree.rebuild(state.params, {
                p: as_grad(g) for p, g in zip(paths, grads)})
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params, donate=donate)
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
