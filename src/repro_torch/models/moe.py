"""Mixture-of-Experts FFN with top-k routing, DeepSeek-V3 / Kimi-K2 style
(port of ``repro.models.moe``).

Tokens are routed to ``top_k`` experts under a capacity factor; shared
experts (DeepSeek's "1 shared") run densely on every token.

Param leaves (each with the leading ``lead`` dims of a stacked block):
  router_w                       (d, E)        — AdamW (excluded by name)
  experts/{gate,up,down}_proj/w  (E, d, d_ff)  — Muon (E matrices per layer)
  shared/{gate,up,down}_proj/w   (d, s*d_ff)   — Muon
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int                 # per-expert FFN width
    n_experts: int                # routed experts
    top_k: int
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_noise: float = 0.0


def moe_init(gen: Optional[torch.Generator], cfg: MoEConfig, *,
             lead: tuple = (), dtype=torch.float32, device="cpu"):
    d, dff, E = cfg.d_model, cfg.d_expert, cfg.n_experts

    def ew(din, dout):
        return (layers.normal(gen, lead + (E, din, dout), device)
                * (1.0 / math.sqrt(din))).to(dtype)

    p = {"router_w": (layers.normal(gen, lead + (d, E), device)
                      * (1.0 / math.sqrt(d))).to(dtype),
         "experts": {"gate_proj": {"w": ew(d, dff)},
                     "up_proj": {"w": ew(d, dff)},
                     "down_proj": {"w": ew(dff, d)}}}
    if cfg.n_shared:
        p["shared"] = layers.mlp_init(gen, d, cfg.n_shared * dff, "swiglu",
                                      lead=lead, dtype=dtype, device=device)
    return p


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert: C = ceil(cf·T·K/E), clipped to [1, T]."""
    return max(1, min(int(math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                                    / cfg.n_experts)), tokens))


def route(p, cfg: MoEConfig, xt: torch.Tensor):
    """(router probabilities (T, E), renormalised gates (T, K), expert ids
    (T, K)) of the flat tokens ``xt`` (T, d), in fp32."""
    logits = layers.dot(xt, p["router_w"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), idx


def dispatch_slots(idx: torch.Tensor, n_experts: int, cap: int):
    """The sort-based capacity dispatch of the (token, k) assignments
    ``idx`` (T, K): stably sorted by expert id, ranked within their expert's
    segment, kept when the rank is below ``cap``.  Returns (slot (T·K,):
    the buffer slot ``e·cap + rank`` of each assignment in (t, k) order, or
    the drop slot ``E·cap``; src (E·cap,): the assignment filling each
    slot, or T·K for an empty one)."""
    TK = idx.numel()
    flat_e = idx.reshape(TK)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    # each expert's first position in the sorted ids; shapes depend on
    # (T, K, E) alone, so the dispatch also runs on shape-only tensors
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(n_experts, device=idx.device,
                               dtype=e_sorted.dtype))
    rank = torch.arange(TK, device=idx.device) - seg_start[e_sorted]
    keep = rank < cap
    drop = n_experts * cap
    dest = torch.where(keep, e_sorted * cap + rank, torch.full_like(rank,
                                                                    drop))
    slot = torch.empty_like(dest)
    slot[order] = dest
    # every dropped assignment writes the extra slot ``drop``, cut off
    src = torch.full((drop + 1,), TK, dtype=torch.long, device=idx.device)
    src[dest] = order
    return slot, src[:drop]


def moe(p, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).

    Exact token-choice top-k with the reference's sort-based dispatch: the
    (token, k) assignments are stably sorted by expert id, ranked within
    their expert segment, and placed in per-expert capacity buffers;
    assignments beyond an expert's capacity C = ceil(cf·T·K/E) are
    dropped.  Both moves are gathers: each buffer slot reads the assignment
    that fills it, and each token reads its K slots back and sums them in
    k order (the reference's scatter-add of the same terms).  No index is
    written twice, so forward and backward are deterministic."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T)

    _, gates, idx = route(p, cfg, xt)
    slot, src = dispatch_slots(idx, E, cap)

    xa = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
    xa = torch.cat([xa, xa.new_zeros(1, d)])
    xe = xa[src].reshape(E, cap, d)

    ex = p["experts"]
    h = F.silu(torch.bmm(xe, ex["gate_proj"]["w"].to(xt.dtype))) * \
        torch.bmm(xe, ex["up_proj"]["w"].to(xt.dtype))
    ye = torch.bmm(h, ex["down_proj"]["w"].to(xt.dtype)).reshape(E * cap, d)

    back = torch.cat([ye, ye.new_zeros(1, d)])[slot]          # (T·K, d)
    keep = (slot < E * cap).to(ye.dtype)
    g = gates.reshape(T * K).to(ye.dtype)
    y = (back * g[:, None] * keep[:, None]).reshape(T, K, d).sum(1)

    if "shared" in p:
        y = y + layers.mlp(p["shared"], xt, "swiglu")
    return y.reshape(B, S, d)


def dropped(p, cfg: MoEConfig, x: torch.Tensor) -> int:
    """Assignments beyond their expert's capacity in ``moe(p, cfg, x)``."""
    T = x.shape[0] * x.shape[1]
    _, _, idx = route(p, cfg, x.reshape(T, -1))
    slot, _ = dispatch_slots(idx, cfg.n_experts, capacity(cfg, T))
    return int((slot == cfg.n_experts * capacity(cfg, T)).sum())


def aux_load_balance_loss(p, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (f·P), available to training configs."""
    xt = x.reshape(-1, x.shape[-1])
    probs, _, idx = route(p, cfg, xt)
    frac = F.one_hot(idx, cfg.n_experts).float().mean(dim=(0, 1))
    pmean = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * pmean)
