"""Train-step factory (port of ``repro.train.step``): loss, gradient
accumulation and the optimizer transform, eagerly.

``make_train_step`` returns ``step(state, batch) -> state``: forward and
backward (autograd of plain tensor code; remat per ``cfg.remat``), then the
optimizer — owner-centric DMuon, Muon-AG or AdamW per the MuonConfig the
caller gave ``Muon`` — whose deltas are added to the parameters in place.
``accum_steps`` splits the batch on its leading axis and accumulates the
gradients over the microbatches in ``accum_dtype`` (fp32 by default; the
reference's ``accum_dtype``, bf16 under its >= 340 B memory policy).

Under a ``DeviceMesh`` the step is data-parallel over
``models.sharding.dp_axes(mesh)``: each rank runs forward and backward on
its own rows of the global batch
(``data.pipeline.batch_for_step(..., mesh=mesh)``), and its gradients go to
the optimizer as ``Partial("avg")`` ``DTensor``s over those axes, so the
owner update reduces each gradient straight to its owner.  The published
deltas are added on every rank.  On a mesh whose 'model' axis has more
than one rank (``models.tp.tensor_parallel``, the one rule: every family),
or where ``grad_specs`` is given, the step is also tensor-parallel over
that axis (``models/tp.py``; the MoE experts split over it: expert
parallelism): each parameter is this rank's part as
``models.sharding.param_specs`` places it (``init_state``), the forward
works from those parts, the loss is the
vocab-parallel cross entropy where the vocab is split, and each gradient
reaches the optimizer with the spec's ``Shard`` on the model axis and
``Partial("avg")`` over the data axes.  The MoE dispatch ranks each
microbatch's tokens over the data axes (``models.moe.moe``'s ``dp``), as
the reference's over its global microbatch; at ``accum_steps > 1`` on
more than one data rank, microbatch i is therefore each rank's block of
the global batch's i-th block, as the reference's is that block
(``microbatch_rows``).  Otherwise the parameters are
replicated (the same seed on every rank, checked once by ``init_state``)
and the model axis only spreads the owners.

ZeRO-3 (``init_state(..., zero3=True)`` and ``grad_specs=param_specs(...,
zero3=True)``, the reference's policy of the >= 340 B configs): the block
weights are also split over the 'data' axis on the dim the 'model' axis
leaves whole (the experts' d_ff).  The forward gathers one layer's parts
at a time over 'data' (``models.tp.ZeroShards``; under remat again in the
backward), the backward reduce-scatters each gradient back to its part,
and the gradient reaches the optimizer ``Shard`` over 'data' (the mean
over the data ranks' batches) and ``Partial("avg")`` over 'pod'.

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
from repro_torch.models import tp as tp_lib
from repro_torch.models.layers import drawing
from repro_torch.models.sharding import (dp_axes, entry_axes, local_part,
                                         param_specs, placed, placements)
from repro_torch.train.train_state import TrainState


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy as logsumexp − gold logit, in fp32.  (The
    reference sums a where-mask for vocab sharding; a gather reads the same
    gold value without the (B, S, V) temporary.)"""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        mp) -> torch.Tensor:
    """``softmax_xent`` of logits whose vocab is split over the model axis
    (``logits`` this rank's (B, S, V/tp) columns, ``mp`` the axis): the
    local max, all-reduced (max); the sum of exponentials, all-reduced; the
    gold logit, read where this rank holds it and all-reduced (the
    reference's where-sum form, ``src/repro/train/step.py:39-53``, a
    gather with a mask here).  Only (B, S) values cross the axis."""
    lg = logits.float()
    n = lg.shape[-1]
    shift = tp_lib.all_max(lg.amax(-1), mp)
    sumexp = tp_lib.reduce_from_model(
        torch.exp(lg - shift[..., None]).sum(-1), mp)
    local = labels.long() - mp.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp_lib.reduce_from_model(gold.masked_fill(~inside, 0.0), mp)
    return torch.mean(torch.log(sumexp) + shift - gold)


def _model_parallel(mesh):
    """The model axis of the tensor-parallel step on ``mesh``."""
    mp = tp_lib.model_parallel(mesh)
    if mp is None:
        raise ValueError("tensor parallelism needs a mesh with a 'model' "
                         "axis")
    return mp


def make_loss_fn(cfg, mesh=None, specs: Optional[dict] = None) -> Callable:
    """``loss_fn(params, batch)``: the mean cross entropy of the forward's
    logits, ``batch`` this rank's rows on ``mesh``.  Where the step on
    ``mesh`` is tensor-parallel (``models.tp.tensor_parallel``, or
    ``specs`` given) the forward runs on this rank's parameter parts
    placed by ``specs`` (default ``param_specs``; ``_loss_fn``)."""
    if not (mesh is not None and (specs is not None
                                  or tp_lib.tensor_parallel(mesh))):
        return _loss_fn(cfg, None, tp_lib.data_parallel(mesh))
    return _loss_fn(cfg, _model_parallel(mesh),
                    tp_lib.data_parallel(mesh),
                    tp_lib.zero_shards(mesh, _tp_specs(cfg, mesh, specs)))


def _loss_fn(cfg, mp, dp=None, zero=None) -> Callable:
    """``make_loss_fn``'s function under the model axis ``mp`` (None: the
    whole model): the logits are this rank's vocab columns where the vocab
    divides the axis (the loss then ``vocab_parallel_xent``), whole on
    every rank otherwise (the reference then falls back to
    sequence-sharded or replicated logits,
    ``src/repro/train/step.py:62-77``: the same values).  ``dp``: the data
    axes the batch is split over, which the MoE dispatch ranks its tokens
    across; ``zero``: the block weights split over 'data' (ZeRO-3)."""
    m = model_fns(cfg)

    def loss_fn(params, batch):
        kwargs = {k: batch[k] for k in ("patches", "frames") if k in batch}
        if mp is not None:
            kwargs["tp"] = mp
        if dp is not None and cfg.moe is not None:
            kwargs["dp"] = dp
        if zero is not None:
            kwargs["zero"] = zero
        logits = m.forward(cfg, params, batch["tokens"], **kwargs)
        if mp is not None and mp.size > 1 and mp.divides(cfg.vocab):
            return vocab_parallel_xent(logits, batch["labels"], mp)
        return softmax_xent(logits, batch["labels"])
    return loss_fn


def grad_placements(mesh, specs: Optional[dict] = None, paths=()) -> dict:
    """{path: the placements its gradient reaches the optimizer with}: the
    spec's ``Shard`` on every axis that splits the leaf (``specs``;
    replicated without them), ZeRO-3's 'data' included, and
    ``Partial("avg")`` on the other data axes."""
    dp = dp_axes(mesh)
    rep = (Replicate(),) * mesh.ndim
    out = {}
    for p in paths:
        pl = rep if specs is None else placements(specs[p], mesh)
        out[p] = tuple(Partial("avg") if a in dp and not q.is_shard() else q
                       for a, q in zip(mesh.mesh_dim_names, pl))
    return out


def _tp_specs(cfg, mesh, grad_specs) -> dict:
    """The parameters' specs of the tensor-parallel step: ``grad_specs``,
    or ``param_specs`` of the model on ``mesh``.  A split over a data axis
    is admitted where ``param_specs(..., zero3=True)`` makes it (ZeRO-3),
    and refused elsewhere."""
    shapes = model_fns(cfg).init(cfg, device="meta")
    if grad_specs is None:
        return param_specs(cfg, shapes, mesh)
    zero3 = param_specs(cfg, shapes, mesh, zero3=True)
    dp = set(dp_axes(mesh))
    for p, spec in grad_specs.items():
        for d, e in enumerate(spec):
            if any(a in dp for a in entry_axes(e)) and e != zero3[p][d]:
                raise ValueError(
                    f"{p} is split over a data axis ({spec}) where "
                    f"param_specs(..., zero3=True) gives {zero3[p]}")
    return grad_specs


def microbatch_rows(x: torch.Tensor, dp, accum: int) -> torch.Tensor:
    """This rank's rows of each of the global batch's ``accum``
    microbatches, in microbatch order: ``x`` (this rank's block of the
    global batch, over the data axes ``dp``) gathered into the global
    batch, cut into ``accum`` blocks (the reference's microbatches,
    ``src/repro/train/step.py:125``), and this rank's part of each block
    taken as ``models.sharding.local_batch`` takes its block."""
    whole = tp_lib.gather_over_data(x, dp)
    rows = whole.reshape((accum, dp.size, -1) + tuple(x.shape[1:]))
    return rows[:, dp.rank].reshape(x.shape)


def make_train_step(cfg, opt: Muon, mesh=None, *, accum_steps: int = 1,
                    pipeline: Optional[str] = None,
                    prestage: Optional[bool] = None,
                    donate: bool = False,
                    device: DeviceLike = None,
                    grad_specs: Optional[dict] = None,
                    accum_dtype: torch.dtype = torch.float32):
    """Returns ``step(state, batch) -> state`` running on ``device`` (CUDA
    unless given; it must be where ``init_state`` put the parameters).
    With ``mesh`` (the optimizer's), ``batch`` is this rank's rows.

    ``grad_specs`` (the reference's): {path: spec} of the parameters'
    placements.  Given, or where the step on ``mesh`` is tensor-parallel
    (``models.tp.tensor_parallel``; ``param_specs`` of the model then),
    the step is tensor-parallel (module docstring): ``state.params`` hold
    this rank's parts and each gradient reaches the optimizer placed as
    its spec says.  Given on a model axis of one rank, the step runs the
    tensor-parallel code path, whose collectives are then identities.
    Specs split over 'data' as ``param_specs(..., zero3=True)`` splits
    them make the step ZeRO-3 (module docstring; ``state`` from
    ``init_state(..., zero3=True)``).

    ``accum_dtype`` (the reference's): the dtype the gradients of the
    ``accum_steps`` microbatches are summed in (and the staged and rest
    accumulators of the prestaged schedule).

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
    tensor_parallel = mesh is not None and (
        grad_specs is not None or tp_lib.tensor_parallel(mesh))
    data = tp_lib.data_parallel(mesh)
    specs = _tp_specs(cfg, mesh, grad_specs) if tensor_parallel else None
    loss_fn = _loss_fn(cfg, _model_parallel(mesh)
                       if tensor_parallel else None, data,
                       tp_lib.zero_shards(mesh, specs))
    # the MoE dispatch spans the data ranks, so they take their rows of
    # the same global microbatch
    regroup = data is not None and cfg.moe is not None and accum_steps > 1
    shapes = None
    if mesh is not None:
        if opt.mesh is not mesh:
            raise ValueError("the optimizer must be built on the step's mesh")
        dp = dp_axes(mesh)
        dp_dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a in dp]
        shapes = dict(tree.flatten(model_fns(cfg).init(cfg, device="meta")))
        grad_pl = grad_placements(mesh, specs, shapes)
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
        if regroup:
            batch = {k: microbatch_rows(v, data, accum_steps)
                     for k, v in batch.items()}
        return {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                for k, v in batch.items()}

    def compute_grads(params, leaves, batch):
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        micro = split(batch)
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        grad_acc = [torch.zeros(p.shape, dtype=accum_dtype, device=device)
                    for p in leaves]
        for i in range(accum_steps):
            loss = loss_fn(params, {k: v[i] for k, v in micro.items()})
            grads = torch.autograd.grad(loss, leaves)
            loss_acc += loss.detach()
            for a, g in zip(grad_acc, grads):
                a += g.to(accum_dtype)
        inv = 1.0 / accum_steps
        return loss_acc * inv, [g.mul_(inv) for g in grad_acc]

    def compute_grads_staged(params, paths, leaves, batch):
        """(loss, staged owner-layout matrix gradients, AdamW gradients):
        microbatch i's stage_in is issued after its backward and added
        after microbatch i+1's, so it rides under that forward and
        backward."""
        matrix = [j for j, p in enumerate(paths) if p in opt.plan.leaves]
        rest = [j for j, p in enumerate(paths) if p not in opt.plan.leaves]
        placements = None if mesh is None else \
            {paths[j]: grad_pl[paths[j]] for j in matrix}
        micro = split(batch)
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        staged = pipe.zeros_staged(accum_dtype)
        rest_acc = [torch.zeros(leaves[j].shape, dtype=accum_dtype,
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
                                         placements, dtype=accum_dtype)
            for a, j in zip(rest_acc, rest):
                a += grads[j].to(accum_dtype)
            del grads
        for k, v in wait_all(inflight).items():
            staged[k] += v
        inv = 1.0 / accum_steps
        return (loss_acc * inv, {k: v.mul_(inv) for k, v in staged.items()},
                {paths[j]: a.mul_(inv) for j, a in zip(rest, rest_acc)})

    def as_grad(p, g):
        if mesh is None:
            return g
        if specs is None:
            return DTensor.from_local(g, mesh, grad_pl[p], run_check=False)
        return DTensor.from_local(g, mesh, grad_pl[p], run_check=False,
                                  shape=shapes[p].shape,
                                  stride=shapes[p].stride())

    def step(state: TrainState, batch) -> TrainState:
        paths, leaves = zip(*tree.flatten(state.params))
        if prestage:
            loss, staged, rest = compute_grads_staged(
                state.params, paths, list(leaves), batch)
        else:
            loss, grads = compute_grads(state.params, list(leaves), batch)
        if mesh is not None:
            loss = mean_over_dp(loss)
        params = state.params if specs is None else \
            placed_params(state.params, specs, mesh)
        if prestage:
            updates, opt_state = opt.update_staged(
                staged, {p: as_grad(p, g) for p, g in rest.items()},
                state.opt_state, params, donate=donate)
        else:
            grads = tree.rebuild(state.params, {
                p: as_grad(p, g) for p, g in zip(paths, grads)})
            updates, opt_state = opt.update(grads, state.opt_state,
                                            params, donate=donate)
        with torch.no_grad():
            for (_, p), (_, u) in zip(tree.flatten(state.params),
                                      tree.flatten(updates)):
                p.add_(u.to_local() if isinstance(u, DTensor) else u)
        ema = loss if state.step == 0 else 0.98 * state.loss_ema + 0.02 * loss
        return TrainState(state.step + 1, state.params, opt_state, ema)

    return step


def placed_params(params, specs: dict, mesh):
    """``params`` (this rank's parts) as the ``DTensor``s ``specs`` place,
    for the optimizer (no copy)."""
    return tree.rebuild(params, {
        p: placed(v.detach(), specs[p], mesh,
                  _global_shape(v.shape, specs[p], mesh))
        for p, v in tree.flatten(params)})


def _global_shape(local_shape, spec, mesh) -> tuple:
    shape = list(local_shape)
    for i, q in enumerate(placements(spec, mesh)):
        if q.is_shard():
            shape[q.dim] *= mesh.size(i)
    return tuple(shape)


def init_state(cfg, opt: Muon, seed: int = 0, device: DeviceLike = None,
               *, mesh=None, zero3: bool = False) -> TrainState:
    """Random parameters (``torch.Generator(device)`` seeded with ``seed``)
    as leaf tensors requiring grad, plus the optimizer state
    (``src/repro/train/step.py:226-247``).

    Where the step on ``mesh`` is tensor-parallel
    (``models.tp.tensor_parallel``), or ``zero3`` (the reference's
    ZeRO-3: ``param_specs(..., zero3=True)``, the block weights split over
    'data' too; on any mesh of the dense and MoE families), the parameters
    are placed by ``param_specs``: each rank keeps its parts,
    bitwise the slices of the one-card ``init`` from the same seed,
    drawing one whole leaf at a time on ``device`` (``layers.drawing``:
    the generator's sequence is ``init``'s).  The AdamW moments follow
    their parameters' placements and the Muon momentum is in the owner
    layout (the reference's ``_opt_state_shardings``).  Under any other
    mesh the parameters are replicated: every rank draws them from the
    same seed.
    A checksum compared across ranks proves either layout.  Without a
    mesh ``zero3`` changes nothing, as the reference's."""
    device = resolve_device(device)
    m = model_fns(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    zero3 = zero3 and mesh is not None
    if zero3:
        _model_parallel(mesh)           # a mesh with a 'model' axis
    if not (zero3 or tp_lib.tensor_parallel(mesh)):
        params = tree.tree_map(lambda v: v.requires_grad_(True),
                               m.init(cfg, seed, device))
        if mesh is not None:
            _check_replicated(params)
        return TrainState(0, params, opt.init(params), zero)
    specs = param_specs(cfg, m.init(cfg, device="meta"), mesh, zero3=zero3)
    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           init_parts(cfg, seed, device, specs, mesh))
    _check_replicated(params, specs, mesh)
    return TrainState(0, params, opt.init(placed_params(params, specs, mesh)),
                      zero)


# the leaves ``init`` draws from its generator (``layers.normal``): the
# weights, the embeddings, the MoE router, the SSM's conv kernel and the
# mLSTM's gate weight
DRAWN_LEAVES = ("w", "embedding", "router_w", "conv_w", "if_gate_w")


def init_parts(cfg, seed: int, device, specs: dict, mesh):
    """This rank's parts of ``model_fns(cfg).init(cfg, seed, device)``
    under ``specs``: each random leaf drawn whole, in ``init``'s order,
    and cut to its part before the next is drawn; the constant leaves
    (norms, biases) made whole and cut."""
    m = model_fns(cfg)
    shapes = m.init(cfg, device="meta")
    drawn = [(p, tuple(v.shape)) for p, v in _in_draw_order(shapes)
             if p.rsplit("/", 1)[-1] in DRAWN_LEAVES]
    queue = iter(drawn)

    def keep(whole):
        path, shape = next(queue, (None, None))
        if shape != tuple(whole.shape):
            raise RuntimeError(f"init drew {tuple(whole.shape)} where "
                               f"{path!r} {shape} was due")
        return local_part(whole, specs[path], mesh).clone()
    with drawing(keep):
        params = m.init(cfg, seed, device)
    if next(queue, None) is not None:
        raise RuntimeError("init drew fewer leaves than its tree holds")
    cut = {p for p, _ in drawn}
    return tree.rebuild(params, {
        p: v if p in cut else local_part(v, specs[p], mesh).clone()
        for p, v in tree.flatten(params)})


def _in_draw_order(t, prefix=()):
    """(path, leaf) in the order ``init`` made them: dict insertion
    order (``tree.flatten`` sorts)."""
    out = []
    for k, v in t.items():
        if isinstance(v, dict):
            out += _in_draw_order(v, prefix + (k,))
        else:
            out.append(("/".join(prefix + (k,)), v))
    return out


def _check_replicated(params, specs: Optional[dict] = None,
                      mesh=None) -> None:
    """Raise unless the parameters are what every rank should hold: a
    float64 sum of the replicated leaves (and their positions) equal
    across the world, and, under ``specs``, for each set of axes that
    split leaves, a sum of those leaves equal across the ranks that hold
    the same parts (one coordinate on those axes; under ZeRO-3 on a mesh
    without a replicated axis no two ranks do)."""
    by_axes = {}
    for p, s in (specs or {}).items():
        axes = tuple(a for a in mesh.mesh_dim_names
                     if any(a in entry_axes(e) for e in s))
        if axes:
            by_axes[p] = axes
    kinds = [()] + sorted(set(by_axes.values()))
    with torch.no_grad():
        sums = [torch.zeros((), dtype=torch.float64,
                            device=tree.flatten(params)[0][1].device)
                for _ in kinds]
        for i, (p, v) in enumerate(tree.flatten(params)):
            j = kinds.index(by_axes.get(p, ()))
            sums[j] = sums[j] + v.double().sum() * (i + 1)
        coords = [0.0] * len(kinds)
        for j, axes in enumerate(kinds):
            for a in axes:
                k = mesh.mesh_dim_names.index(a)
                coords[j] = coords[j] * mesh.size(k) + mesh.get_local_rank(k)
        mine = torch.stack(sums + [sums[0].new_tensor(c) for c in coords])
    world, n = dist.get_world_size(), len(kinds)
    out = mine.new_empty(world * 2 * n)
    dist.all_gather_into_tensor(out, mine)
    out = out.reshape(world, 2 * n)
    for j in range(n):
        same_part = out[:, n + j] == mine[n + j]
        if not bool((out[same_part, j] == mine[j]).all()):
            raise RuntimeError(f"parameters differ across ranks: checksums "
                               f"of the leaves split over {kinds} and "
                               f"the coordinates on those axes "
                               f"{out.tolist()}")
