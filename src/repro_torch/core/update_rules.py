"""Update rules: momentum, scaling, weight decay, AdamW (port of
``repro.core.update_rules``).

``core/owner_comms.py`` decides where tensors live, ``core/orthogonalize.py``
how a matrix update is orthogonalized, and this module the scalar math
around them: heavy-ball/Nesterov momentum in owner layout, the RMS-matching
scale factor, weight decay + learning rate, and the elementwise AdamW of the
non-matrix leaves (and of the pure-AdamW baseline).

``VariantSpec`` describes a named optimizer variant (the registry lives in
``core/api.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.gram_ns import frobenius_norm


@dataclass(frozen=True)
class VariantSpec:
    """A named optimizer variant, resolved by ``MuonConfig.variant``."""
    name: str
    orthogonalizer: str         # registry key in core/orthogonalize.py
    description: str = ""
    elementwise: bool = False   # True: no matrix pipeline at all (AdamW)
    stateful: bool = False      # carries per-group variant state


def scale_factor(m: int, n: int, mode: str) -> float:
    if mode == "match_rms_adam":
        return 0.2 * float(np.sqrt(max(m, n)))
    if mode == "spectral":
        return float(np.sqrt(max(1.0, m / n)))
    if mode == "none":
        return 1.0
    raise ValueError(f"unknown scale_mode {mode!r}")


def momentum_update(mom: torch.Tensor, grad: torch.Tensor, cfg):
    """Heavy-ball momentum in the layout of its inputs.  Returns
    ``(new_momentum, effective)``; ``effective`` is what the orthogonalizer
    consumes (the Nesterov look-ahead when configured)."""
    new_mom = cfg.momentum * mom + grad
    eff = grad + cfg.momentum * new_mom if cfg.nesterov else new_mom
    return new_mom, eff


def norm_preserving_rescale(normalized: torch.Tensor, reference: torch.Tensor,
                            eps: float = 1e-7) -> torch.Tensor:
    """Rescale each matrix in ``normalized`` back to the Frobenius norm of
    its ``reference`` counterpart (leading dims are batch): the epilogue of
    the adaptive variants (NorMuon's per-neuron, AdaMuon's per-entry second
    moments), which reshape the orthogonalized update but keep the
    magnitude the RMS-matching scale rule expects.  The norms are taken one
    matrix at a time (``gram_ns.frobenius_norm``), so a matrix's result does
    not depend on how many share the call."""
    return normalized * frobenius_norm(reference) / (
        frobenius_norm(normalized) + eps)


def apply_wd_and_lr(update: torch.Tensor, param: torch.Tensor, cfg) -> torch.Tensor:
    # fp32 update math for fp32 master params; bf16 masters stay in bf16
    cd = torch.float32 if param.dtype == torch.float32 else param.dtype
    u = update.to(cd) + cfg.weight_decay * param.detach().to(cd)
    return (-cfg.learning_rate * u).to(param.dtype)


# --------------------------------------------------------------------------
# AdamW (non-matrix leaves + the elementwise baseline variant)
# --------------------------------------------------------------------------

class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, Any]) -> AdamWState:
    """Zero fp32 moments for a {path: param} dict."""
    def zeros():
        return {p: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for p, v in params.items()}
    return AdamWState(mu=zeros(), nu=zeros())


# elements of one leaf that AdamW's temporaries span at a time
ADAMW_CHUNK = 1 << 24


def adamw_update(grads, state: AdamWState, params, step: int, cfg, *,
                 donate: bool = False):
    """One AdamW step over {path: tensor} dicts; returns (updates, state).
    ``donate``: each old moment leaves ``state`` as its new one is made, so
    the two never coexist whole (the old state is spent).  A leaf of more
    than ``ADAMW_CHUNK`` elements is updated that many at a time, into
    preallocated moments (with ``donate``, the old ones, in place) and
    update: the same elementwise operations, so the same values bit for
    bit, without whole-leaf fp32 temporaries (the reference's ``jit``
    fuses them away; an embedding of 2.4 B entries a card would otherwise
    hold five 9.4 GB ones)."""
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    t = float(step) + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    mu, nu, updates = {}, {}, {}
    take = dict.pop if donate else dict.__getitem__

    def rule(g, m, v, w):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + cfg.adam_weight_decay * w.float()
        return m, v, (-cfg.adam_lr * u).to(w.dtype)

    for p, g in grads.items():
        m, v, w = take(state.mu, p), take(state.nu, p), params[p].detach()
        if g.numel() <= ADAMW_CHUNK:
            mu[p], nu[p], updates[p] = rule(g, m, v, w)
            continue
        if not donate or not (m.is_contiguous() and v.is_contiguous()):
            m, v = m.clone(memory_format=torch.contiguous_format), \
                v.clone(memory_format=torch.contiguous_format)
        u = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        flat = [x.reshape(-1) for x in (g, m, v, w, u)]
        for i in range(0, g.numel(), ADAMW_CHUNK):
            part = [x[i:i + ADAMW_CHUNK] for x in flat]
            out = rule(part[0], part[1], part[2], part[3])
            for dst, src in zip(part[1:3] + part[4:], out):
                dst.copy_(src)
        mu[p], nu[p], updates[p] = m, v, u
    return updates, AdamWState(mu, nu)
