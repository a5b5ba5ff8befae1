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

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import tp as tp_lib


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
    return _route(layers.dot(xt, p["router_w"]).float(), cfg)


def _route(logits: torch.Tensor, cfg: MoEConfig):
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), idx


def _ranks(idx: torch.Tensor, n_experts: int, dp=None):
    """The assignments ``idx`` (T, K) stably sorted by expert id: (order,
    their expert ids, each one's rank within its expert's segment, each
    expert's assignments here (E,), and each expert's assignments before
    this rank's (E,)).  With ``dp`` (a ``models.tp.DataParallel``) those
    before are every lower data rank's, which the reference's sort over
    the whole batch counts first (one all-gather of the (E,) counts);
    without, there are none (None).  Shapes depend on (T, K, E) alone, so
    the ranking also runs on shape-only tensors."""
    TK = idx.numel()
    flat_e = idx.reshape(TK)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    experts = torch.arange(n_experts, device=idx.device,
                           dtype=e_sorted.dtype)
    # each expert's first position in the sorted ids
    seg_start = torch.searchsorted(e_sorted, experts)
    rank = torch.arange(TK, device=idx.device) - seg_start[e_sorted]
    counts = torch.searchsorted(e_sorted, experts, right=True) - seg_start
    if dp is None:
        return order, e_sorted, rank, counts, None
    every = tp_lib.gather_over_data(counts, dp)               # (D, E)
    return order, e_sorted, rank, counts, every[:dp.rank].sum(0)


def dispatch_slots(idx: torch.Tensor, n_experts: int, cap: int):
    """The sort-based capacity dispatch of the (token, k) assignments
    ``idx`` (T, K): stably sorted by expert id, ranked within their expert's
    segment, kept when the rank is below ``cap``.  Returns (slot (T·K,):
    the buffer slot ``e·cap + rank`` of each assignment in (t, k) order, or
    the drop slot ``E·cap``; src (E·cap,): the assignment filling each
    slot, or T·K for an empty one)."""
    return _dispatch(idx, n_experts, cap)[:2]


def _dispatch(idx, n_experts, cap, dp=None, experts=None):
    """``dispatch_slots`` over the global batch with ``dp`` (``_ranks``),
    for the experts ``experts`` = (first, count) (default all); also the
    assignments kept (T·K,) in sorted order and the slots of each
    expert's buffer.  An assignment is kept when its rank over the global
    batch is below ``cap``.  Each kept assignment of those experts fills
    the slot of its rank among this rank's assignments in its expert's
    buffer: slot ``(e − first)·buf + rank``, or the drop slot
    ``count·buf`` (dropped, or another rank's expert).  Without ``dp`` a
    buffer has ``cap`` slots; with it, as many as this rank keeps of the
    expert that keeps most here (read back to the host: its own tokens,
    at most ``cap``).  Shape-only tensors hold no counts: there a buffer
    has cap / D slots, what each rank keeps under even routing (the dry
    run's walk predicts that)."""
    TK = idx.numel()
    order, e_sorted, rank, counts, lower = _ranks(idx, n_experts, dp)
    first, count = (0, n_experts) if experts is None else experts
    if lower is None:
        kept, buf = rank < cap, cap
    else:
        kept = rank + lower[e_sorted] < cap
        here = (cap - lower).clamp(min=0).minimum(counts)[first:first + count]
        buf = -(-cap // dp.size) if _shape_only(here) else \
            max(1, int(here.max()))
    fill = kept if experts is None else \
        kept & (e_sorted >= first) & (e_sorted < first + count)
    drop = count * buf
    dest = torch.where(fill, (e_sorted - first) * buf + rank,
                       torch.full_like(rank, drop))
    slot = torch.empty_like(dest)
    slot[order] = dest
    # every dropped assignment writes the extra slot ``drop``, cut off
    src = torch.full((drop + 1,), TK, dtype=torch.long, device=idx.device)
    src[dest] = order
    return slot, src[:drop], kept, buf


def _shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no values to read: on ``meta``, or fake (the
    dry run's ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)


def moe(p, cfg: MoEConfig, x: torch.Tensor, *, tp=None,
        dp=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).

    Exact token-choice top-k with the reference's sort-based dispatch: the
    (token, k) assignments are stably sorted by expert id, ranked within
    their expert segment, and placed in per-expert capacity buffers;
    assignments beyond an expert's capacity C = ceil(cf·T·K/E) are
    dropped.  Both moves are gathers: each buffer slot reads the assignment
    that fills it, and each token reads its K slots back and sums them in
    k order (the reference's scatter-add of the same terms).  No index is
    written twice, so forward and backward are deterministic.

    dp: a ``models.tp.DataParallel`` when ``x`` is this rank's rows of a
    global batch split over the data axes (a training batch, or the
    serving decode's slots: every data rank runs every MoE layer of every
    decode step, so each makes the counts' all-gather and its own read of
    its buffer length; a prefill every data rank runs whole passes none).
    The reference dispatches the global batch (T = B·S of every rank,
    rank 0's rows first): C counts every rank's tokens, and an assignment
    is kept exactly when its rank among every rank's assignments to its
    expert is below C.  A kept
    token's output does not depend on the other tokens of its buffer, so
    each rank still runs only its own tokens, in buffers as long as it
    keeps of its fullest expert (``_dispatch``: one read to the host a
    call), not the global C.

    tp: a ``models.tp.ModelParallel`` (training and the serving path;
    ``x`` replicated over the model axis).  Where the experts divide the axis
    (``param_specs``' guard) the leaves are this rank's E/tp experts and
    ``router_w``'s columns: the local logits are gathered to (T, E), the
    routing and the dispatch are then the same on every rank, each rank
    runs its experts' buffers, and the combine sums the local experts'
    terms, reduced once over the axis with the shared expert's row-parallel
    part.  Otherwise the experts are whole on every rank.  The shared
    expert is column / row split where its width divides the axis."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T * (1 if dp is None else dp.size))
    ep = tp is not None and tp.divides(E)
    shared = "shared" in p
    sh = tp if tp is not None and shared and \
        tp.divides(cfg.n_shared * cfg.d_expert) else None

    if ep:
        x_own = tp_lib.copy_to_model(xt, tp)
        # the whole logits feed each rank's own combine: summed back
        logits = tp_lib.gather_from_model(
            layers.dot(x_own, p["router_w"]), tp, -1, reduce_grad=True)
        n_local = E // tp.size
        experts = (tp.rank * n_local, n_local)
    else:
        x_own = xt
        logits = layers.dot(xt, p["router_w"])
        n_local, experts = E, None
    _, gates, idx = _route(logits.float(), cfg)
    slot, src, kept, buf = _dispatch(idx, E, cap, dp, experts)

    xa = x_own[:, None, :].expand(T, K, d).reshape(T * K, d)
    xa = torch.cat([xa, xa.new_zeros(1, d)])
    xe = xa[src].reshape(n_local, buf, d)

    ex = p["experts"]
    h = F.silu(torch.bmm(xe, ex["gate_proj"]["w"].to(xt.dtype))) * \
        torch.bmm(xe, ex["up_proj"]["w"].to(xt.dtype))
    ye = torch.bmm(h, ex["down_proj"]["w"].to(xt.dtype)).reshape(
        n_local * buf, d)

    back = torch.cat([ye, ye.new_zeros(1, d)])[slot]          # (T·K, d)
    keep = (slot < n_local * buf).to(ye.dtype)
    g = gates.reshape(T * K).to(ye.dtype)
    y = (back * g[:, None] * keep[:, None]).reshape(T, K, d).sum(1)

    if ep:
        if sh is not None:      # one reduction of both partial sums
            y = y + layers.mlp(p["shared"], x_own, "swiglu")
        y = tp_lib.reduce_from_model(y, tp)
        if shared and sh is None:
            y = y + layers.mlp(p["shared"], xt, "swiglu")
    elif shared:
        y = y + layers.mlp(p["shared"], xt, "swiglu", tp=sh)
    _record(idx, kept, buf)
    return y.reshape(B, S, d)


# per-call dispatch records (``recording``), or None
_RECORD = contextvars.ContextVar("moe_record", default=None)


@contextlib.contextmanager
def recording():
    """Within the block every ``moe`` call appends {"idx": its expert ids
    (T, K), "dropped": its assignments beyond capacity (a 0-dim tensor;
    with ``dp`` this rank's tokens under the global rule), "slots": the
    slots of each of its expert buffers} to the list the block yields.
    Nothing more is read back to the host."""
    rec = []
    token = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(token)


def _record(idx, kept, slots: int) -> None:
    rec = _RECORD.get()
    if rec is not None:
        rec.append({"idx": idx.detach(), "dropped": (~kept).sum(),
                    "slots": slots})


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
