"""Selective state-space mixer (Mamba-style) of the hymba hybrid blocks
(port of ``repro.models.ssm``).

    x -> in_proj -> (xs, z): xs through a depthwise causal conv1d + SiLU,
    dt, B, C from x_proj;  h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t·x_t;
    y = C·h + D·x, gated by SiLU(z)

The reference runs the recurrence as ``lax.associative_scan`` over time;
under autograd a doubling scan would keep about 2·log₂S tensors of
(B, S, d_inner, d_state) fp32, 0.84 GB each at hymba-1.5b and batch
2 × 2048.  ``linear_scan`` is one ``torch.autograd.Function`` instead: its
forward is a log-depth doubling scan that saves only its input ``a`` and
its output ``h``, and its backward is the reverse scan.  Equal in exact
arithmetic; in fp32 the sums associate in another order.

Parameter names as the reference's: conv kernels / a_log / dt_bias / d_skip
stay on AdamW by the dedication name rules; in / x / dt / out projections
are Muon matrices.

Under tensor parallelism (``ssm(..., tp=...)``, the train step of a mesh
whose 'model' axis has more than one rank) the leaves are this rank's
parts as ``models.sharding.param_specs`` places them and each rank scans
its own channels (``_ssm_tp``).

Serving carries ``state`` = (conv, h): the conv's trailing (B, K-1,
d_inner) context and the recurrence's last (B, d_inner, d_state) fp32
state.  ``ssm(..., state=)`` continues from them and returns the new ones;
its scan runs outside autograd (serving is inference only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models import tp as tp_lib


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(16, self.d_model // 16)


def ssm_init(gen, cfg: SSMConfig, *, lead: tuple = (), dtype=torch.float32,
             device="cpu"):
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dtr
    kw = dict(lead=lead, dtype=dtype, device=device)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": layers.linear_init(gen, cfg.d_model, 2 * di, **kw),
        "conv_w": (layers.normal(gen, lead + (cfg.d_conv, di), device)
                   * 0.1).to(dtype),
        "x_proj": layers.linear_init(gen, di, dtr + 2 * ds, **kw),
        "dt_proj": layers.linear_init(gen, dtr, di, **kw),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (di, ds)).to(dtype).contiguous(),
        "d_skip": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": layers.linear_init(gen, di, cfg.d_model, **kw),
    }


def _conv1d(w: torch.Tensor, x: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, di), w: (K, di):
    y_t = Σ_i w_i · x_{t-K+1+i}, summed in the reference's order, from a
    zero context, or from ``state`` (B, K-1, di), the trailing context of
    an earlier call; then returns (y, the new trailing context)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if state is None else \
        torch.cat([state, x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return y if state is None else (y, xp[:, -(K - 1):])


def _doubling_scan(a: torch.Tensor, b: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """h_t = a_t·h_{t∓1} + b_t along dim 1 from h = 0 (forward: t-1;
    ``reverse``: t+1), by log₂S doubling steps: after the step of shift s
    every (A_t, H_t) spans 2s steps.  Works on copies; no autograd."""
    A, H = a.clone(), b.clone()
    S = a.shape[1]
    s = 1
    while s < S:
        if reverse:
            H[:, :S - s] += A[:, :S - s] * H[:, s:]
            if 2 * s < S:
                A[:, :S - s] = A[:, :S - s] * A[:, s:]
        else:
            H[:, s:] += A[:, s:] * H[:, :S - s]
            if 2 * s < S:
                A[:, s:] = A[:, s:] * A[:, :S - s]
        s *= 2
    return H


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        a, h = ctx.saved_tensors
        # g_t = ∂L/∂h_t + a_{t+1}·g_{t+1}: the reverse scan on a shifted
        c = torch.empty_like(a)
        c[:, :-1] = a[:, 1:]
        c[:, -1] = 0
        g = _doubling_scan(c, grad_h.contiguous(), reverse=True)
        del c
        da = torch.zeros_like(a)
        da[:, 1:] = g[:, 1:] * h[:, :-1]
        return da, g


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over dim 1 from h_{-1} = 0, for any trailing
    dims (the reference's ``_selective_scan``).  Saves ``a`` and ``h`` for
    its backward: ∂b = g, ∂a_t = g_t·h_{t-1}, with g the reverse scan
    g_t = ∂L/∂h_t + a_{t+1}·g_{t+1}."""
    return _LinearScan.apply(a, b)


def _scan_operands(p, cfg: SSMConfig, x: torch.Tensor, conv_state=None):
    """(xs, z, a_bar, bx, C, new_conv): the gated branch, the recurrence's
    fp32 coefficients and inputs (B, S, di, ds), the fp32 readout C, and
    the conv's new trailing context (None without ``conv_state``)."""
    xs, z = layers.linear(p["in_proj"], x).chunk(2, dim=-1)
    return _channel_operands(p, cfg, xs, z, conv_state)


def _channel_operands(p, cfg: SSMConfig, xs: torch.Tensor, z: torch.Tensor,
                      conv_state=None, project=None):
    """``_scan_operands`` from the in-projection's (xs, z): every step
    after it acts channel by channel but ``x_proj``, whose product
    ``project(xs)`` (default the whole ``x_proj``) reads every channel."""
    ds = cfg.d_state
    new_conv = None
    if conv_state is None:
        xs = _conv1d(p["conv_w"], xs)
    else:
        xs, new_conv = _conv1d(p["conv_w"], xs, conv_state)
    xs = F.silu(xs)
    dbc = layers.linear(p["x_proj"], xs) if project is None else project(xs)
    dt, Bc, Cc = torch.split(dbc, [cfg.dtr, ds, ds], dim=-1)
    dt = F.softplus(layers.linear(p["dt_proj"], dt)
                    + p["dt_bias"].to(xs.dtype))                 # (B,S,di)
    A = -torch.exp(p["a_log"].float())                           # (di,ds)
    dt32 = dt.float()
    a_bar = torch.exp(dt32[..., None] * A)                       # (B,S,di,ds)
    bx = (dt32 * xs.float())[..., None] * Bc.float()[..., None, :]
    return xs, z, a_bar, bx, Cc.float(), new_conv


def _readout(p, h: torch.Tensor, Cc: torch.Tensor, xs: torch.Tensor,
             z: torch.Tensor, dtype) -> torch.Tensor:
    """y = C·h + D·x, gated by SiLU(z), in ``dtype`` (before out_proj)."""
    y = torch.einsum("bsdn,bsn->bsd", h, Cc)
    y = y + xs.float() * p["d_skip"].float()
    return y.to(dtype) * F.silu(z)


def ssm(p, cfg: SSMConfig, x: torch.Tensor, *,
        state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, tp=None):
    """x (B, S, d) -> (B, S, d); with ``state`` = (conv, h) carried from
    an earlier call, -> (y, (new conv, h at the last position)), the scan
    seeded by h (``bx[:, 0] += a_bar[:, 0] · h``) and run outside
    autograd.  ``tp`` (a ``models.tp.ModelParallel`` of more than one
    rank; training only): the leaves are this rank's parts
    (``_ssm_tp``)."""
    if tp is not None and tp.size > 1:
        if state is not None:
            raise ValueError("the split mixer is the training path")
        return _ssm_tp(p, cfg, x, tp)
    xs, z, a_bar, bx, Cc, new_conv = _scan_operands(
        p, cfg, x, None if state is None else state[0])
    if state is None:
        h = linear_scan(a_bar, bx)                               # (B,S,di,ds)
    else:
        bx[:, 0] += a_bar[:, 0] * state[1]
        h = _doubling_scan(a_bar, bx)
    del a_bar, bx
    out = layers.linear(p["out_proj"], _readout(p, h, Cc, xs, z, x.dtype))
    return out if state is None else (out, (new_conv, h[:, -1]))


def _rows_of_whole(w: torch.Tensor, tp, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of a weight every rank holds whole but
    reads in part: through ``copy_to_model``, whose backward sums the
    ranks' gradients (each nonzero on its own rows only) into the whole
    weight's gradient on every rank."""
    return tp_lib.copy_to_model(w, tp)[tp.rank * rows:(tp.rank + 1) * rows]


def _ssm_tp(p, cfg: SSMConfig, x: torch.Tensor, tp):
    """The mixer of the replicated (B, S, d) ``x`` on the leaves
    ``param_specs`` splits over the model axis (the reference's GSPMD
    placement; nothing regrouped): ``in_proj`` out-split over 2·d_inner,
    ``conv_w`` / ``dt_proj`` / ``dt_bias`` / ``a_log`` / ``d_skip`` over
    d_inner, ``out_proj`` in-split over it; ``x_proj`` whole.

    Where d_inner divides the axis, each rank runs the channels
    [r·di/tp, (r+1)·di/tp):

    * its ``in_proj`` columns are a contiguous part of [xs ; z] (at tp = 2
      rank 0 holds every xs column), so one all-to-all
      (``tp.halves_to_channels``) gives it xs and z of its channels:
      2·B·S·di/tp values a rank, each way;
    * the conv, dt, the doubling scan and the skip are then channel-local,
      with no collective inside the scan;
    * ``x_proj`` contracts over the channels, so each rank's product is a
      partial sum, reduced over the axis (B·S·(dtr + 2·ds) values), and
      then feeds every rank's own channels (``copy_to_model``); each rank
      reads only its rows of the whole weight, whose gradient is therefore
      summed over the axis (``_rows_of_whole``);
    * ``out_proj`` is row-parallel: one reduction of (B, S, d).

    Otherwise the channel leaves are whole: ``in_proj``'s columns are
    gathered where they split, and every rank runs the whole mixer."""
    di = cfg.d_inner
    split = tp.divides(di)
    xz = layers.linear(p["in_proj"], tp_lib.copy_to_model(x, tp)
                       if tp.divides(2 * di) else x)
    project = None
    if split:
        xs, z = tp_lib.halves_to_channels(xz, tp).unbind(0)
        w = _rows_of_whole(p["x_proj"]["w"], tp, di // tp.size)

        def project(xs):
            part = layers.dot(xs, w)
            return tp_lib.copy_to_model(tp_lib.reduce_from_model(part, tp),
                                        tp)
    else:
        if tp.divides(2 * di):
            xz = tp_lib.gather_from_model(xz, tp, -1)
        xs, z = xz.chunk(2, dim=-1)
    xs, z, a_bar, bx, Cc, _ = _channel_operands(p, cfg, xs, z,
                                                project=project)
    h = linear_scan(a_bar, bx)
    del a_bar, bx
    out = layers.linear(p["out_proj"], _readout(p, h, Cc, xs, z, x.dtype))
    return tp_lib.reduce_from_model(out, tp) if split else out


def ssm_init_state(cfg: SSMConfig, batch: int, dtype=torch.float32, *,
                   lead: tuple = (), device: DeviceLike = None):
    """Zero (conv, h): (*lead, batch, d_conv-1, d_inner) in ``dtype`` and
    (*lead, batch, d_inner, d_state) in fp32."""
    device = resolve_device(device)
    return (torch.zeros(lead + (batch, cfg.d_conv - 1, cfg.d_inner),
                        dtype=dtype, device=device),
            torch.zeros(lead + (batch, cfg.d_inner, cfg.d_state),
                        dtype=torch.float32, device=device))
