"""The port's selective SSM (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the same numpy parameters and inputs,
and ``linear_scan`` against the recurrence stepped in time.

Tolerances: outputs 1e-4 and gradients rtol 1e-4 / atol 1e-5 (the arch
twin's, ``tests/test_torch_arch.py``); the scan against a float64 loop at
1e-6 in fp32 and 1e-12 in float64; ``gradcheck``'s own defaults.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

CFG = dict(d_model=64, d_state=4, expand=2)   # reduced hymba's
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _params():
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jssm.SSMConfig(**CFG))
    # a nonzero dt_bias and skip, so their gradients are tested off zero
    jp = {**jp, "dt_bias": jp["dt_bias"] + 0.3,
          "d_skip": jp["d_skip"] * 0.7}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 device="cpu", requires_grad=True)


def _x(shape=(2, 24, 64), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_config_matches_reference():
    for kw in (CFG, dict(d_model=1600, d_state=16, expand=2)):
        j, t = jssm.SSMConfig(**kw), tssm.SSMConfig(**kw)
        assert (t.d_inner, t.dtr) == (j.d_inner, j.dtr)


def test_init_leaves_match_reference():
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jssm.SSMConfig(**CFG))
    tp = tssm.ssm_init(None, tssm.SSMConfig(**CFG), lead=(3,), device="meta")
    want = {p: (3,) + np.shape(v) for p, v in tree.flatten(
        jax.tree.map(np.asarray, jp))}
    assert {p: tuple(v.shape) for p, v in tree.flatten(tp)} == want
    real = tssm.ssm_init(torch.Generator().manual_seed(0),
                         tssm.SSMConfig(**CFG))
    for name in ("a_log", "dt_bias", "d_skip"):   # deterministic leaves
        np.testing.assert_array_equal(real[name].numpy(),
                                      np.asarray(jp[name]))


def test_ssm_and_grads_match_reference():
    jp, tp = _params()
    x = _x()
    jcfg, tcfg = jssm.SSMConfig(**CFG), tssm.SSMConfig(**CFG)

    def jloss(p, xx):
        y, _ = jssm.ssm(p, jcfg, xx)
        return jnp.sum(y * jnp.cos(y)), y
    (jl, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tssm.ssm(tp, tcfg, tx)
    paths, leaves = zip(*tree.flatten(tp))
    grads = torch.autograd.grad((y * torch.cos(y)).sum(), leaves + (tx,))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    want = dict(tree.flatten(jax.tree.map(np.asarray, jg)))
    for p, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[p], err_msg=p, **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               **GRAD_TOL)


def test_conv1d_matches_reference():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    want, _ = jssm._conv1d(jnp.asarray(w), jnp.asarray(x))
    got = tssm._conv1d(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # causal: the output at t reads no input after t
    x2 = x.copy()
    x2[:, 5:] += 1.0
    got2 = tssm._conv1d(torch.from_numpy(w), torch.from_numpy(x2))
    torch.testing.assert_close(got2[:, :5], got[:, :5], rtol=0, atol=0)


def _scan_inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(shape, generator=g, dtype=dtype) * 0.98 + 0.01
    b = torch.randn(shape, generator=g, dtype=dtype)
    return a, b


def _loop(a, b):
    """h_t = a_t h_{t-1} + b_t, one step at a time (differentiable)."""
    out, h = [], torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("seq", [1, 2, 7, 16, 33])
def test_linear_scan_matches_sequential_loop(seq):
    """Forward and both gradients, at lengths that are and are not powers
    of two: in float64 to 1e-12, and in fp32 within 1e-6 of float64."""
    a, b = _scan_inputs((2, seq, 3, 4), torch.float64)
    w = torch.randn(a.shape, dtype=torch.float64)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        aa = a.to(dtype).requires_grad_(True)
        bb = b.to(dtype).requires_grad_(True)
        h = tssm.linear_scan(aa, bb)
        got = (h,) + torch.autograd.grad(h, (aa, bb), w.to(dtype))
        a64 = a.clone().requires_grad_(True)
        b64 = b.clone().requires_grad_(True)
        h64 = _loop(a64, b64)
        want = (h64,) + torch.autograd.grad(h64, (a64, b64), w)
        for x, y in zip(got, want):
            torch.testing.assert_close(x.double(), y.detach(), rtol=tol,
                                       atol=tol)


def test_linear_scan_matches_reference_selective_scan():
    a, b = _scan_inputs((2, 20, 8, 4), torch.float32, seed=3)
    want = jssm._selective_scan(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_allclose(tssm.linear_scan(a, b).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


def test_linear_scan_gradcheck():
    a, b = _scan_inputs((1, 5, 3), torch.float64, seed=4)
    assert torch.autograd.gradcheck(
        tssm.linear_scan, (a.requires_grad_(True), b.requires_grad_(True)))


def test_linear_scan_saves_only_a_and_h():
    """Its backward keeps its input ``a`` and its output ``h``: two saved
    tensors, whatever the length (a doubling scan under autograd would save
    about 2·log₂S)."""
    a, b = _scan_inputs((2, 64, 3, 4), torch.float32, seed=5)
    a.requires_grad_(True)
    b.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = tssm.linear_scan(a, b)
    assert len(saved) == 2
    assert saved[0] is a and saved[1].data_ptr() == h.data_ptr()
