"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``) on the same numpy parameters and
inputs: the mLSTM in parallel form and the sLSTM loop, outputs and
gradients, at the reduced xlstm-350m widths; a case with strongly negative
forget gates, where the running-max stabiliser carries the result; and the
mLSTM's memory never built as a (B, S, H, hd, hd) tensor.

Tolerances: outputs 1e-4 and gradients rtol 1e-4 / atol 1e-5 (the arch
twin's, ``tests/test_torch_arch.py``).  The mLSTM's gradients, whose sums
the parallel form associates in another order than the reference's scan,
are held instead to the same function stepped in float64: the port's
worst error, relative to each leaf's largest entry, no larger than the
reference's (both ≈ 1e-6 at the default gates; the reference's 1e-3 at
forget gates near −8, where its fp32 cumulative log gates lose digits).
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

CFG = dict(d_model=64, n_heads=4, slstm_every=4)   # reduced xlstm-350m's
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(kind, forget_bias=0.0):
    init = jxlstm.mlstm_init if kind == "mlstm" else jxlstm.slstm_init
    jp = init(jax.random.PRNGKey(1), jxlstm.XLSTMConfig(**CFG))
    if kind == "mlstm":    # log forget gates are the second half
        H = CFG["n_heads"]
        jp = {**jp, "if_gate_bias": jp["if_gate_bias"].at[H:].add(
            forget_bias).at[:H].add(0.5)}
    else:                  # gate pre-activations z | i | f | o
        d = CFG["d_model"]
        jp = {**jp, "gate_bias": jp["gate_bias"].at[2 * d:3 * d].add(
            forget_bias)}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                                 requires_grad=True)


def _x(seq, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, seq, CFG["d_model"])).astype(np.float32)


def _sequential(q, k, v, ig, fg):
    """The stabilised mLSTM recurrence stepped in time: m_t = max(f_t +
    m_{t−1}, i_t), C and n rescaled by e^{f_t + m_{t−1} − m_t} and fed
    e^{i_t − m_t}·(v kᵀ, k), y_t = C_t q_t / max(|n_t·q_t|, 1)."""
    B, S, H, hd = q.shape
    C = q.new_zeros(B, H, hd, hd)
    n = q.new_zeros(B, H, hd)
    m = q.new_full((B, H), -math.inf)
    ys = []
    for t in range(S):
        mt = torch.maximum(fg[:, t] + m, ig[:, t])
        fw, iw = torch.exp(fg[:, t] + m - mt), torch.exp(ig[:, t] - mt)
        C = fw[..., None, None] * C + iw[..., None, None] * (
            v[:, t, :, :, None] * k[:, t, :, None, :])
        n = fw[..., None] * n + iw[..., None] * k[:, t]
        den = (n * q[:, t]).sum(-1).abs().clamp(min=1.0)
        ys.append((C @ q[:, t, :, :, None])[..., 0] / den[..., None])
        m = mt
    return torch.stack(ys, dim=1)


def _mlstm_float64(p, x):
    """The reference's mLSTM block stepped in time in float64."""
    B, S, d = x.shape
    H = CFG["n_heads"]
    hd = d // H
    q = (x @ p["q_proj"]["w"]).reshape(B, S, H, hd)
    k = (x @ p["k_proj"]["w"]).reshape(B, S, H, hd) / math.sqrt(hd)
    v = (x @ p["v_proj"]["w"]).reshape(B, S, H, hd)
    g = (x @ p["if_gate_w"] + p["if_gate_bias"]).reshape(B, S, 2, H)
    y = _sequential(q, k, v, g[:, :, 0],
                    torch.nn.functional.logsigmoid(g[:, :, 1]))
    return y.reshape(B, S, d) @ p["o_proj"]["w"]


def _worst_relative(grads, truth):
    return max(float(np.abs(g - t).max() / np.abs(t).max())
               for g, t in zip(grads, truth))


def _compare(kind, seq, forget_bias=0.0):
    jp, tp = _params(kind, forget_bias)
    x = _x(seq)
    jcfg, tcfg = jxlstm.XLSTMConfig(**CFG), txlstm.XLSTMConfig(**CFG)
    jfn = jxlstm.mlstm if kind == "mlstm" else jxlstm.slstm
    tfn = txlstm.mlstm if kind == "mlstm" else txlstm.slstm

    def jloss(p, xx):
        y, _ = jfn(p, jcfg, xx)
        return jnp.sum(y * jnp.sin(y)), y
    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tfn(tp, tcfg, tx)
    paths, leaves = zip(*tree.flatten(tp))
    grads = torch.autograd.grad((y * torch.sin(y)).sum(), leaves + (tx,))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    want = dict(tree.flatten(jax.tree.map(np.asarray, jg)))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    if kind == "slstm":
        for p, g in zip(paths, grads):
            np.testing.assert_allclose(g.numpy(), want[p], err_msg=p,
                                       **GRAD_TOL)
        np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                                   **GRAD_TOL)
        return y
    p64 = tree.tree_map(lambda v: v.detach().double().requires_grad_(True),
                        tp)
    x64 = tx.detach().double().requires_grad_(True)
    y64 = _mlstm_float64(p64, x64)
    truth = torch.autograd.grad((y64 * torch.sin(y64)).sum(),
                                [v for _, v in tree.flatten(p64)] + [x64])
    truth = [t.numpy() for t in truth]
    port = _worst_relative([g.numpy() for g in grads], truth)
    ref = _worst_relative([want[p] for p in paths] + [np.asarray(jgx)],
                          truth)
    assert port <= ref, (port, ref)
    return y


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_grads_match_reference(kind):
    _compare(kind, seq=24)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_negative_forget_gates_match_reference(kind):
    """Forget pre-activations near −8: the memory forgets within a step or
    two, the cumulative log forget gate reaches ≈ −250 over 32 steps, and
    the stabiliser's running max moves at every step."""
    y = _compare(kind, seq=32, forget_bias=-8.0)
    assert bool(torch.isfinite(y).all())


def test_mlstm_parallel_form_equals_sequential_recurrence():
    """``mlstm_core`` in float64 against the stabilised recurrence stepped
    in time (m_t = max(f_t + m_{t−1}, i_t), C and n rescaled each step)."""
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 2, 19, 3, 5
    q, k, v = (torch.randn(B, S, H, hd, generator=g, dtype=torch.float64)
               for _ in range(3))
    ig = torch.randn(B, S, H, generator=g, dtype=torch.float64) * 3
    fg = torch.nn.functional.logsigmoid(
        torch.randn(B, S, H, generator=g, dtype=torch.float64) * 3)
    torch.testing.assert_close(txlstm.mlstm_core(q, k, v, ig, fg),
                               _sequential(q, k, v, ig, fg), rtol=1e-12,
                               atol=1e-12)


class _Sizes(TorchDispatchMode):
    """Every tensor an aten op returns, forward and backward."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree.flatten({"o": out if isinstance(out, (list, tuple))
                               else [out]}):
            if isinstance(t[1], torch.Tensor):
                self.shapes.append(tuple(t[1].shape))
        return out


def test_mlstm_never_builds_the_memory_matrix():
    """No tensor of the forward or backward holds (B, S, H, hd, hd): at
    these sizes the memory C would have B·S·H·hd² = 32768 entries, and the
    largest tensor the parallel form makes is a (B, H, S, S) or a
    (d, d) weight, at most 4096."""
    _, tp = _params("mlstm")
    x = torch.from_numpy(_x(16)).requires_grad_(True)
    cfg = txlstm.XLSTMConfig(**CFG)
    B, S, H, hd = 2, 16, cfg.n_heads, cfg.head_dim
    with _Sizes() as sizes:
        y = txlstm.mlstm(tp, cfg, x)
        torch.autograd.grad(y.square().sum(), [x] + [v for _, v in
                                                    tree.flatten(tp)])
    assert sizes.shapes
    largest = max(int(np.prod(s)) for s in sizes.shapes)
    assert largest <= max(B * H * S * S, CFG["d_model"] ** 2) < \
        B * S * H * hd * hd // 4
    assert not [s for s in sizes.shapes if len(s) == 5]
