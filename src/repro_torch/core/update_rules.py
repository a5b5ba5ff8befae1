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


def adamw_update(grads, state: AdamWState, params, step: int, cfg):
    """One AdamW step over {path: tensor} dicts; returns (updates, state)."""
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    t = float(step) + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    mu, nu, updates = {}, {}, {}
    for p, g in grads.items():
        g32 = g.float()
        mu[p] = b1 * state.mu[p] + (1 - b1) * g32
        nu[p] = b2 * state.nu[p] + (1 - b2) * torch.square(g32)
        u = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + eps)
        u = u + cfg.adam_weight_decay * params[p].detach().float()
        updates[p] = (-cfg.adam_lr * u).to(params[p].dtype)
    return updates, AdamWState(mu, nu)
