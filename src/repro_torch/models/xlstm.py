"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM and sLSTM (port of
``repro.models.xlstm``).

mLSTM — matrix-memory LSTM, per head a (hd × hd) memory
    C_t = f_t·C_{t-1} + i_t·(v_t k_tᵀ),  n_t = f_t·n_{t-1} + i_t·k_t,
    y_t = (C_t q_t) / max(|n_tᵀ q_t|, 1),
with exponential input gates stabilised by a running max.  The reference
runs it as an associative scan that materialises C as (B, S, H, hd, hd);
the port computes the same y in the xLSTM paper's parallel form, a masked
(B, H, S, S) product (``mlstm_core``'s docstring derives it), and never
builds C.

sLSTM — scalar-memory LSTM with exponential gating, a recurrence through
``r_proj`` that is inherently sequential: a Python loop over time carrying
fp32 (c, n, h, m), as the reference's ``lax.scan``.

Muon-eligible leaves: q/k/v/o projections, up/down FFN, r/w sLSTM
matrices; gate biases and ``if_gate_w`` stay on AdamW by the name rules.

Serving carries each block's state across calls (``state=``): the
mLSTM's (C, n, m) — memory (B, H, hd, hd), normaliser (B, H, hd) and
stabiliser (B, H), the reference's state at the last position — and the
sLSTM's fp32 (c, n, h, m).  The mLSTM folds a carried state into its
parallel form and builds only the last position's memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    slstm_every: int = 8        # every k-th block is an sLSTM block
    ff_mult: float = 2.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------------- mLSTM

def mlstm_init(gen, cfg: XLSTMConfig, *, lead: tuple = (),
               dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "q_proj": layers.linear_init(gen, d, d, **kw),
        "k_proj": layers.linear_init(gen, d, d, **kw),
        "v_proj": layers.linear_init(gen, d, d, **kw),
        "o_proj": layers.linear_init(gen, d, d, **kw),
        "if_gate_bias": torch.zeros(lead + (2 * cfg.n_heads,), dtype=dtype,
                                    device=device),
        "if_gate_w": (layers.normal(gen, lead + (d, 2 * cfg.n_heads), device)
                      * 0.02).to(dtype),
    }


def _mlstm_operands(p, cfg: XLSTMConfig, x: torch.Tensor):
    """q, k (scaled by 1/√hd), v as (B, S, H, hd) in x.dtype, and the fp32
    log input gate ``ig`` and log forget gate ``fg`` (B, S, H)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = layers.linear(p["q_proj"], x).reshape(B, S, H, hd)
    k = layers.linear(p["k_proj"], x).reshape(B, S, H, hd) / math.sqrt(hd)
    v = layers.linear(p["v_proj"], x).reshape(B, S, H, hd)
    gates = (layers.dot(x, p["if_gate_w"])
             + p["if_gate_bias"].to(x.dtype)).float().reshape(B, S, 2, H)
    return q, k, v, gates[:, :, 0], F.logsigmoid(gates[:, :, 1])


def mlstm_core(q, k, v, ig, fg, state: Optional[Tuple] = None):
    """y (B, S, H, hd) of the stabilised mLSTM recurrence, in parallel
    form, in fp32 (float64 for float64 operands); with a carried ``state``
    (C0, n0, m0), -> (y, (C, n, m) at the last position).

    The reference's scan (``repro/models/xlstm.py``) takes cum_f =
    cumsum(fg), shifted_j = ig_j − cum_f_j, run_max_t = max_{j≤t}
    shifted_j, the input weight a_t = exp(shifted_t − run_max_t) and the
    decay decay_t = exp(run_max_{t−1} − run_max_t), and scans
    C_t = decay_t·C_{t−1} + a_t·v_t k_tᵀ (n likewise with k_t).  Unrolled,
    the decays between j and t telescope to exp(run_max_j − run_max_t), so

        C_t = Σ_{j≤t} D_tj · v_j k_jᵀ,   n_t = Σ_{j≤t} D_tj · k_j,
        D_tj = exp(shifted_j − run_max_t)  (≤ 1, as run_max_t ≥ shifted_j),

    and with q_t: num_t = C_t q_t = Σ_j D_tj (q_t·k_j) v_j and
    den_t = |n_t·q_t| = |Σ_j D_tj (q_t·k_j)|, y_t = num_t / max(den_t, 1).
    That is W = (q kᵀ) ⊙ D over (S, S) per head, num = W v, den = |W 1|:
    (B, H, S, S) instead of C's (B, S, H, hd, hd).

    A carried state enters as the reference folds it: its stabiliser
    max(m0 + cum_f_t, m_t) is cum_f_t + r_t with r_t = max(m0, run_max_t),
    so D_tj = exp(shifted_j − r_t), the state's weight is
    e_t = exp(m0 − r_t), C_t gains e_t·C0 and n_t gains e_t·n0
    (num_t += e_t·C0 q_t, den_t = |... + e_t·n0·q_t|), and the new state
    is C, n at t = S−1 (one (B, H, hd, hd) sum over j) with
    m = cum_f_{S−1} + r_{S−1}."""
    # shifted_j grows like |cum_f_j| ~ t while D's exponents are
    # differences of it: in float64 they keep fp32's relative precision,
    # which fp32 cumsums of S terms would lose
    cum_f = torch.cumsum(fg.double(), dim=1)              # (B,S,H)
    shifted = ig.double() - cum_f
    ref = torch.cummax(shifted, dim=1).values
    if state is not None:
        C0, n0, m0 = state
        ref = torch.maximum(ref, m0.double()[:, None])
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    # (B,H,S_t,S_j): shifted_j − ref_t where j ≤ t, −inf elsewhere
    logd = (shifted.transpose(1, 2)[:, :, None, :]
            - ref.transpose(1, 2)[:, :, :, None])
    dt = torch.promote_types(q.dtype, torch.float32)     # fp32 (or f64)
    d = torch.exp(torch.where(causal, logd, float("-inf")).to(dt))
    qf = q.to(dt).transpose(1, 2)                         # (B,H,S,hd)
    kf = k.to(dt).transpose(1, 2)
    vf = v.to(dt).transpose(1, 2)
    w = torch.matmul(qf, kf.mT) * d                       # (B,H,S,S)
    num = torch.matmul(w, vf)                             # (B,H,S,hd)
    den = w.sum(-1)                                       # (B,H,S)
    if state is not None:
        e = torch.exp(m0.double()[:, None] - ref).to(dt).transpose(1, 2)
        C0, n0 = C0.to(dt), n0.to(dt)
        num = num + e[..., None] * torch.matmul(qf, C0.mT)
        den = den + e * torch.matmul(qf, n0[..., None])[..., 0]
    y = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    y = y.transpose(1, 2)                                 # (B,S,H,hd)
    if state is None:
        return y
    d_last = d[:, :, -1]                                  # (B,H,S_j)
    C = torch.matmul(vf.mT * d_last[:, :, None, :], kf)   # (B,H,hd,hd)
    n = torch.matmul(d_last[:, :, None, :], kf)[:, :, 0]  # (B,H,hd)
    C = C + e[:, :, -1, None, None] * C0
    n = n + e[:, :, -1, None] * n0
    m = (cum_f[:, -1] + ref[:, -1]).float()
    return y, (C.float(), n.float(), m)


def mlstm(p, cfg: XLSTMConfig, x: torch.Tensor, *,
          state: Optional[Tuple] = None):
    """x (B, S, d) -> (B, S, d); with a carried ``state`` (C, n, m),
    -> (y, new state)."""
    B, S, d = x.shape
    out = mlstm_core(*_mlstm_operands(p, cfg, x), state=state)
    y, new = (out, None) if state is None else out
    y = layers.linear(p["o_proj"], y.to(x.dtype).reshape(B, S, d))
    return y if state is None else (y, new)


def mlstm_init_state(cfg: XLSTMConfig, batch: int, *, lead: tuple = (),
                     device: DeviceLike = None):
    """Fresh (C, n, m): zeros (*lead, batch, H, hd, hd) and
    (*lead, batch, H, hd), m = −1e30 (*lead, batch, H); fp32."""
    device = resolve_device(device)
    H, hd = cfg.n_heads, cfg.head_dim
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (batch, H, hd, hd), **kw),
            torch.zeros(lead + (batch, H, hd), **kw),
            torch.full(lead + (batch, H), -1e30, **kw))


# ------------------------------------------------------------------- sLSTM

def slstm_init(gen, cfg: XLSTMConfig, *, lead: tuple = (),
               dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "w_proj": layers.linear_init(gen, d, 4 * d, **kw),
        "r_proj": layers.linear_init(gen, d, 4 * d, **kw),
        "gate_bias": torch.zeros(lead + (4 * d,), dtype=dtype, device=device),
        "o_proj": layers.linear_init(gen, d, d, **kw),
    }


def slstm(p, cfg: XLSTMConfig, x: torch.Tensor, *,
          state: Optional[Tuple] = None):
    """x (B, S, d) -> (B, S, d).  One step per position: the fp32 carry
    (c, n, h, m) starts at (0, 0, 0, −1e30), or at a carried ``state``, and
    h crosses ``r_proj`` in x.dtype, as in the reference's scan.  With a
    ``state``, -> (y, the last carry)."""
    B, S, d = x.shape
    wx = layers.linear(p["w_proj"], x) + p["gate_bias"].to(x.dtype)
    if state is None:
        c = torch.zeros(B, d, dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        h = torch.zeros_like(c)
        m = torch.full_like(c, -1e30)
    else:
        c, n, h, m = state
    ys = []
    for t in range(S):
        pre = (wx[:, t].float()
               + layers.linear(p["r_proj"], h.to(x.dtype)).float())
        zi, ii, fi, oi = pre.chunk(4, dim=-1)
        lf = F.logsigmoid(fi)
        mn = torch.maximum(lf + m, ii)
        i_ = torch.exp(ii - mn)
        f_ = torch.exp(lf + m - mn)
        c = f_ * c + i_ * torch.tanh(zi)
        n = f_ * n + i_
        h = torch.sigmoid(oi) * c / torch.clamp(n, min=1.0)
        m = mn
        ys.append(h.to(x.dtype))
    y = layers.linear(p["o_proj"], torch.stack(ys, dim=1))
    return y if state is None else (y, (c, n, h, m))


def slstm_init_state(cfg: XLSTMConfig, batch: int, dtype=torch.float32, *,
                     lead: tuple = (), device: DeviceLike = None):
    """Fresh (c, n, h, m) of (*lead, batch, d): zeros, h in ``dtype``,
    m = −1e30; the rest fp32."""
    device = resolve_device(device)
    shape = lead + (batch, cfg.d_model)
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros(shape, **kw), torch.zeros(shape, **kw),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.full(shape, -1e30, **kw))
