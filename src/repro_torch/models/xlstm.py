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

Under tensor parallelism (``mlstm`` / ``slstm`` with ``tp``, the train
step of a mesh whose 'model' axis has more than one rank) the leaves are
this rank's parts as ``models.sharding.param_specs`` places them: the
mLSTM runs its heads head-parallel (``_mlstm_tp``), the sLSTM its loop
whole on every rank from gathered inputs (``_slstm_tp``).

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
from repro_torch.models import tp as tp_lib


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
    return (q, k, v) + _gates(layers.dot(x, p["if_gate_w"])
                              + p["if_gate_bias"].to(x.dtype), H)


def _gates(pre: torch.Tensor, H: int) -> tuple:
    """ig and the log-sigmoid fg (B, S, H), fp32, of the (B, S, 2H)
    pre-activations [i₀…i_{H−1}, f₀…f_{H−1}]."""
    B, S, _ = pre.shape
    gates = pre.float().reshape(B, S, 2, H)
    return gates[:, :, 0], F.logsigmoid(gates[:, :, 1])


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
          state: Optional[Tuple] = None, tp=None):
    """x (B, S, d) -> (B, S, d); with a carried ``state`` (C, n, m),
    -> (y, new state).  ``tp`` (a ``models.tp.ModelParallel`` of more than
    one rank; training only): the leaves are this rank's parts
    (``_mlstm_tp``)."""
    if tp is not None and tp.size > 1:
        if state is not None:
            raise ValueError("the split mixer is the training path")
        return _mlstm_tp(p, cfg, x, tp)
    B, S, d = x.shape
    out = mlstm_core(*_mlstm_operands(p, cfg, x), state=state)
    y, new = (out, None) if state is None else out
    y = layers.linear(p["o_proj"], y.to(x.dtype).reshape(B, S, d))
    return y if state is None else (y, new)


def _whole_gate_bias(b: torch.Tensor, n_heads: int, tp) -> torch.Tensor:
    """The whole (2H) ``if_gate_bias`` from this rank's part.  Split over
    the axis as [i₀…i_{H−1}, f₀…f_{H−1}], a part does not follow the heads
    (at tp = 2 rank 0 holds every input-gate bias), so it is gathered
    whole; the gates it feeds are whole on every rank, so the backward
    keeps this rank's part of their gradient."""
    return tp_lib.gather_from_model(b, tp, -1) if tp.divides(2 * n_heads) \
        else b


def _mlstm_tp(p, cfg: XLSTMConfig, x: torch.Tensor, tp):
    """The mLSTM of the replicated (B, S, d) ``x`` on the leaves
    ``param_specs`` splits over the model axis: q / k / v out-split and
    ``o_proj`` in-split over d, ``if_gate_bias`` over 2H, ``if_gate_w``
    whole.  Every rank computes all 2H gate pre-activations from ``x``
    with the whole bias (``_whole_gate_bias``); they feed each rank's own
    heads, so their gradient is summed over the axis (``copy_to_model``),
    which makes ``if_gate_w``'s whole on every rank.

    * Head-parallel where H divides the axis: the q / k / v columns of a
      rank are its H/tp heads, it runs their recurrence, and ``o_proj`` is
      row-parallel (one reduction).
    * Otherwise the q / k / v columns split mid-head: they are gathered
      whole, every rank runs every head, and ``o_proj`` takes this rank's
      columns of y through its rows (one reduction).
    Where d does not divide the axis every projection is whole and every
    rank computes the whole block."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    bias = _whole_gate_bias(p["if_gate_bias"], H, tp)
    if not tp.divides(d):
        return mlstm(dict(p, if_gate_bias=bias), cfg, x)
    pre = layers.dot(x, p["if_gate_w"]) + bias.to(x.dtype)
    x_in = tp_lib.copy_to_model(x, tp)
    q, k, v = (layers.linear(p[n], x_in)
               for n in ("q_proj", "k_proj", "v_proj"))
    ig, fg = _gates(tp_lib.copy_to_model(pre, tp), H)
    if tp.divides(H):
        h = H // tp.size
        heads = slice(tp.rank * h, (tp.rank + 1) * h)
        q, k, v = (t.reshape(B, S, h, hd) for t in (q, k, v))
        y = mlstm_core(q, k / math.sqrt(hd), v, ig[..., heads],
                       fg[..., heads])
        y = layers.linear(p["o_proj"], y.to(x.dtype).reshape(B, S, h * hd))
        return tp_lib.reduce_from_model(y, tp)
    q, k, v = (tp_lib.gather_from_model(t, tp, -1, reduce_grad=True)
               .reshape(B, S, H, hd) for t in (q, k, v))
    y = mlstm_core(q, k / math.sqrt(hd), v, ig, fg)
    return layers._row_parallel(p["o_proj"], y.to(x.dtype).reshape(B, S, d),
                                True, tp)


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
          state: Optional[Tuple] = None, tp=None):
    """x (B, S, d) -> (B, S, d).  One step per position: the fp32 carry
    (c, n, h, m) starts at (0, 0, 0, −1e30), or at a carried ``state``, and
    h crosses ``r_proj`` in x.dtype, as in the reference's scan.  With a
    ``state``, -> (y, the last carry).  ``tp`` (a
    ``models.tp.ModelParallel`` of more than one rank; training only): the
    leaves are this rank's parts (``_slstm_tp``)."""
    if tp is not None and tp.size > 1:
        if state is not None:
            raise ValueError("the split mixer is the training path")
        return _slstm_tp(p, cfg, x, tp)
    wx = layers.linear(p["w_proj"], x) + p["gate_bias"].to(x.dtype)
    out = _slstm_loop(wx, p["r_proj"], x.dtype, state)
    y = layers.linear(p["o_proj"], out[0])
    return y if state is None else (y, out[1])


def _slstm_loop(wx: torch.Tensor, r_proj, dtype, state=None) -> tuple:
    """(the stacked h (B, S, d) in ``dtype``, the last carry) of the
    recurrence over ``wx`` (B, S, 4d), the input projection with the gate
    bias, in (z, i, f, o) order."""
    B, S, d4 = wx.shape
    d = d4 // 4
    if state is None:
        c = torch.zeros(B, d, dtype=torch.float32, device=wx.device)
        n = torch.zeros_like(c)
        h = torch.zeros_like(c)
        m = torch.full_like(c, -1e30)
    else:
        c, n, h, m = state
    ys = []
    for t in range(S):
        pre = (wx[:, t].float()
               + layers.linear(r_proj, h.to(dtype)).float())
        zi, ii, fi, oi = pre.chunk(4, dim=-1)
        lf = F.logsigmoid(fi)
        mn = torch.maximum(lf + m, ii)
        i_ = torch.exp(ii - mn)
        f_ = torch.exp(lf + m - mn)
        c = f_ * c + i_ * torch.tanh(zi)
        n = f_ * n + i_
        h = torch.sigmoid(oi) * c / torch.clamp(n, min=1.0)
        m = mn
        ys.append(h.to(dtype))
    return torch.stack(ys, dim=1), (c, n, h, m)


def _slstm_tp(p, cfg: XLSTMConfig, x: torch.Tensor, tp):
    """The sLSTM of the replicated (B, S, d) ``x`` on the leaves
    ``param_specs`` splits over the model axis: ``w_proj`` / ``r_proj`` /
    ``gate_bias`` out-split over 4d in (z, i, f, o) order (at tp = 4 a
    rank holds one kind of gate, not a range of channels), ``o_proj``
    in-split over d.  The recurrence needs the whole h at every step, so
    nothing inside the time loop crosses the axis: ``wx`` (this rank's
    columns of the input projection, with ``gate_bias``, whose columns are
    the same) is gathered whole once, ``r_proj`` once, and every rank runs
    the whole loop on the same input; ``o_proj`` is row-parallel from this
    rank's columns of y (one reduction).  y's gradient is then this rank's
    own, so the gathers' backward reduce-scatters: each returns this
    rank's slice of the summed gradient.  Where d does not divide the axis
    ``o_proj`` is whole, every rank computes the same y, and the gathers'
    backward keeps this rank's slice."""
    d = x.shape[-1]
    own = tp.divides(d)
    if tp.divides(4 * d):
        wx = layers.linear(p["w_proj"], tp_lib.copy_to_model(x, tp)) + \
            p["gate_bias"].to(x.dtype)
        wx = tp_lib.gather_from_model(wx, tp, -1, reduce_grad=own)
        r_proj = {"w": tp_lib.gather_from_model(p["r_proj"]["w"], tp, -1,
                                                reduce_grad=own)}
    else:
        wx = layers.linear(p["w_proj"], x) + p["gate_bias"].to(x.dtype)
        r_proj = p["r_proj"]
    y, _ = _slstm_loop(wx, r_proj, x.dtype)
    return layers._row_parallel(p["o_proj"], y, own, tp)


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
