"""Train-step factory (port of ``repro.train.step``): loss, gradient
accumulation and the optimizer transform, eagerly.

``make_train_step`` returns ``step(state, batch) -> state``: forward and
backward (autograd of plain tensor code; remat per ``cfg.remat``), then the
optimizer — owner-centric DMuon, Muon-AG or AdamW per the MuonConfig the
caller gave ``Muon`` — whose deltas are added to the parameters in place.
``accum_steps`` splits the batch on its leading axis and accumulates fp32
gradients over the microbatches.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import tree
from repro_torch.core.api import Muon
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model_fns
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


def make_train_step(cfg, opt: Muon, *, accum_steps: int = 1,
                    device: DeviceLike = None):
    """Returns ``step(state, batch) -> state`` running on ``device`` (CUDA
    unless given; it must be where ``init_state`` put the parameters)."""
    device = resolve_device(device)
    loss_fn = make_loss_fn(cfg)

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
        grads = tree.rebuild(state.params, dict(zip(paths, grads)))
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for (_, p), (_, u) in zip(tree.flatten(state.params),
                                      tree.flatten(updates)):
                p.add_(u)
        ema = loss if state.step == 0 else 0.98 * state.loss_ema + 0.02 * loss
        return TrainState(state.step + 1, state.params, opt_state, ema)

    return step


def init_state(cfg, opt: Muon, seed: int = 0,
               device: DeviceLike = None) -> TrainState:
    """Random parameters (``torch.Generator(device)`` seeded with ``seed``)
    as leaf tensors requiring grad, plus the optimizer state."""
    device = resolve_device(device)
    m = model_fns(cfg)
    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           m.init(cfg, seed, device))
    return TrainState(0, params, opt.init(params),
                      torch.zeros((), dtype=torch.float32, device=device))
