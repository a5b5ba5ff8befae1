"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM and sLSTM (port of
the training paths of ``repro.models.xlstm``).

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
The decode state (``state=``) waits for ROADMAP item 10.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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


def mlstm_core(q, k, v, ig, fg) -> torch.Tensor:
    """y (B, S, H, hd) of the stabilised mLSTM recurrence, in parallel
    form, in fp32 (float64 for float64 operands).

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
    (B, H, S, S) instead of C's (B, S, H, hd, hd)."""
    # shifted_j grows like |cum_f_j| ~ t while D's exponents are
    # differences of it: in float64 they keep fp32's relative precision,
    # which fp32 cumsums of S terms would lose
    cum_f = torch.cumsum(fg.double(), dim=1)              # (B,S,H)
    shifted = ig.double() - cum_f
    run_max = torch.cummax(shifted, dim=1).values
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    # (B,H,S_t,S_j): shifted_j − run_max_t where j ≤ t, −inf elsewhere
    logd = (shifted.transpose(1, 2)[:, :, None, :]
            - run_max.transpose(1, 2)[:, :, :, None])
    dt = torch.promote_types(q.dtype, torch.float32)     # fp32 (or f64)
    d = torch.exp(torch.where(causal, logd, float("-inf")).to(dt))
    qf = q.to(dt).transpose(1, 2)                         # (B,H,S,hd)
    kf = k.to(dt).transpose(1, 2)
    w = torch.matmul(qf, kf.mT) * d                       # (B,H,S,S)
    num = torch.matmul(w, v.to(dt).transpose(1, 2))       # (B,H,S,hd)
    den = torch.abs(w.sum(-1))                            # (B,H,S)
    y = num / torch.clamp(den, min=1.0)[..., None]
    return y.transpose(1, 2)                              # (B,S,H,hd)


def mlstm(p, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """Training forward: x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    y = mlstm_core(*_mlstm_operands(p, cfg, x))
    return layers.linear(p["o_proj"], y.to(x.dtype).reshape(B, S, d))


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


def slstm(p, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """Training forward: x (B, S, d) -> (B, S, d).  One step per position:
    the fp32 carry (c, n, h, m) starts at (0, 0, 0, −1e30), and h crosses
    ``r_proj`` in x.dtype, as in the reference's scan."""
    B, S, d = x.shape
    wx = layers.linear(p["w_proj"], x) + p["gate_bias"].to(x.dtype)
    c = torch.zeros(B, d, dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    h = torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
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
    return layers.linear(p["o_proj"], torch.stack(ys, dim=1))
