"""Port Gram NS vs the reference ``repro.core.gram_ns`` on identical inputs.

Inputs are seeded numpy arrays handed to both packages.  Tolerances:
port vs reference 1e-4 (the reference's kernel-vs-jnp gate; the CPU matmuls
of the two frameworks sum in different orders), Gram NS vs standard NS 2e-3
(test_gram_ns_end_to_end_with_kernels).  With ``use_kernels=True`` the
reference runs its Pallas kernels in interpret mode and the port its plain
versions (CPU tensors).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import gram_ns as jgram  # noqa: E402
from repro_torch.core import gram_ns as tgram  # noqa: E402
from repro_torch.core.newton_schulz import msign_svd, newton_schulz  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

SHAPES = [(3, 64, 192), (4, 64, 160), (2, 16, 64)]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("schedule", ["polar_express", "quintic"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_port_matches_reference(shape, schedule, use_kernels):
    x = _x(shape)
    jcfg = jgram.GramNSConfig(num_steps=5, schedule=schedule,
                              use_kernels=use_kernels, kernel_interpret=True,
                              block_m=64, block_k=64)
    tcfg = tgram.GramNSConfig(num_steps=5, schedule=schedule,
                              use_kernels=use_kernels)
    want = jgram.gram_newton_schulz(jnp.asarray(x), jcfg,
                                    assume_short_fat=True)
    got = tgram.gram_newton_schulz(torch.from_numpy(x), tcfg,
                                   assume_short_fat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(3, 64, 192), (2, 96, 40)])
def test_gram_matches_standard_ns(shape):
    x = torch.from_numpy(_x(shape, seed=3))
    got = tgram.gram_newton_schulz(x, tgram.GramNSConfig(use_kernels=True))
    want = newton_schulz(x, num_steps=5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_standard_ns_matches_reference():
    from repro.core.newton_schulz import newton_schulz as jns
    x = _x((2, 48, 80), seed=5)
    np.testing.assert_allclose(
        newton_schulz(torch.from_numpy(x), num_steps=5).numpy(),
        np.asarray(jns(jnp.asarray(x), num_steps=5)), rtol=1e-4, atol=1e-4)


def test_ns_approximates_polar_factor():
    x = torch.from_numpy(_x((2, 32, 96), seed=9))
    got = tgram.gram_newton_schulz(x, tgram.GramNSConfig(num_steps=8))
    # singular values pulled into Polar Express's converged band
    s = torch.linalg.svdvals(got)
    assert float(s.min()) > 0.6 and float(s.max()) < 1.3
    cos = (got * msign_svd(x)).sum() / (got.norm() * msign_svd(x).norm())
    assert float(cos) > 0.99


def test_zero_rows_stay_zero():
    """Owner pad rows are all zero: _EPS keeps them zero, never NaN."""
    x = _x((3, 32, 64))
    x[1] = 0.0
    got = tgram.gram_newton_schulz(torch.from_numpy(x),
                                   tgram.GramNSConfig(use_kernels=True),
                                   assume_short_fat=True)
    assert torch.isfinite(got).all()
    assert float(got[1].abs().max()) == 0.0


def test_phases_compose_to_full_iteration():
    x = torch.from_numpy(_x((2, 32, 80), seed=11))
    cfg = tgram.GramNSConfig()
    x0, g = tgram.gram_prepare(x, cfg)
    out = tgram.gram_finish(tgram.gram_iterate(g, cfg), x0, x.dtype)
    torch.testing.assert_close(out, tgram.gram_newton_schulz(
        x, cfg, assume_short_fat=True), rtol=0, atol=0)


def test_tall_input_transposes():
    x = torch.from_numpy(_x((2, 96, 32), seed=12))
    got = tgram.gram_newton_schulz(x)
    want = tgram.gram_newton_schulz(x.mT.contiguous()).mT
    # strided vs contiguous operands sum in another order: rounding only
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_flops_model_matches_reference():
    for args in [(960, 2560, 5, 32), (320, 960, 5, 32), (2560, 960, 3, 1)]:
        assert tgram.gram_ns_flops(*args) == jgram.gram_ns_flops(*args)


@pytest.mark.parametrize("shape", [(32, 96, 256), (32, 32, 96)])
def test_normalize_is_batch_invariant(shape):
    """The first 8 matrices of a (32, m, n) stack normalize bit for bit as
    they do alone (a rank holding 8 of 32 owner rows), and the norm is the
    reference's sqrt(sum(x²)) within fp32 rounding."""
    x = torch.from_numpy(_x(shape, seed=11))
    cfg = tgram.GramNSConfig()
    assert torch.equal(tgram.normalize(x, cfg)[:8],
                       tgram.normalize(x[:8], cfg))
    want = np.sqrt(np.sum(np.square(x.numpy().astype(np.float64)),
                          axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(tgram.frobenius_norm(x).numpy(), want,
                               rtol=1e-6)


def _ill_conditioned(m, n, smallest, seed=0):
    """A full-rank m×n matrix (m <= n) whose singular values fall
    geometrically from 1 to ``smallest``."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n, m)))
    return ((u * np.geomspace(1.0, smallest, m)) @ v.T).astype(np.float32)


def _bf16(a):
    """A JAX bf16 array as the torch bf16 tensor of the same values."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


def _least_eigenvalue(g):
    return float(np.linalg.eigvalsh(np.asarray(g.astype(jnp.float32),
                                               np.float64))[0])


def test_bf16_blow_up_is_the_reference_s():
    """The >= 340 B policy's Gram NS (``compute_dtype="bfloat16"``) blows
    up on an ill-conditioned matrix of full rank in the reference, and the
    port does what the reference does.  Stage by stage, each op of the
    port on the reference's bf16 operands is held to the reference's
    result (so the chaos of the blow-up does not hide a fault): a product
    within one bf16 ulp (2^-7) of the result's largest entry; P = aI + bG
    + cG² within two of its largest term, as the port rounds each term and
    sum to bf16 and the reference's compiler may keep them in fp32.  The
    cause: bf16 rounding gives G₀ = X₀X₀ᵀ
    negative eigenvalues, though X₀'s singular values are all positive,
    and each G' = PGP, P = aI + bG + cG², multiplies a small negative
    eigenvalue by about a² (about 69 at the first step's a, 8.3)."""
    x = _ill_conditioned(64, 256, 1e-3)
    jcfg = jgram.GramNSConfig(compute_dtype="bfloat16")
    tcfg = tgram.GramNSConfig(compute_dtype="bfloat16")

    def close(got, want, scale=None):
        want = _bf16(want).double()
        scale = 2.0 ** -7 * float(want.abs().max()) if scale is None \
            else 2.0 ** -6 * scale
        assert float((got.double() - want).abs().max()) <= scale
    jx0, g = jgram.gram_prepare(jnp.asarray(x, jnp.bfloat16), jcfg)
    tx0, tg = tgram.gram_prepare(torch.from_numpy(x).to(torch.bfloat16),
                                 tcfg)
    close(tx0, jx0)
    close(tg, g)
    _, jpoly, jsym = jgram._ops(jcfg)
    _, tpoly, tsym = tgram._ops(tcfg)
    least, q, coeffs = [_least_eigenvalue(g)], None, jcfg.coeffs()
    for i, (a, b, c) in enumerate(coeffs):
        p = jpoly(g, a, b, c)
        top = float(jnp.abs(g.astype(jnp.float32)).max())
        square = float(jnp.abs(jsym(g, g).astype(jnp.float32)).max())
        close(tpoly(_bf16(g), a, b, c), p,
              max(abs(a), abs(b) * top, abs(c) * square))
        if q is None:
            q = p
        else:
            close(tsym(_bf16(p), _bf16(q)), jsym(p, q))
            q = jsym(p, q)
        if i != len(coeffs) - 1:
            t = jsym(p, g)
            close(tsym(_bf16(p), _bf16(t)), jsym(p, t))
            close(tsym(_bf16(p), _bf16(g)), t)
            g = jsym(p, t)
            least.append(_least_eigenvalue(g))
    close(tgram._rect_dot(_bf16(q), _bf16(jx0)), jgram._rect_dot(q, jx0))
    assert least[0] < 0, least
    assert all(b < a for a, b in zip(least, least[1:])), least
    assert least[-1] < -10, least
    # end to end: both blow up in bf16, neither in fp32
    for dtype, floor, ceiling in (("bfloat16", 100.0, None),
                                  ("float32", None, 1.0)):
        got = tgram.gram_newton_schulz(
            torch.from_numpy(x).to(getattr(torch, dtype)),
            tgram.GramNSConfig(compute_dtype=dtype))
        want = jgram.gram_newton_schulz(
            jnp.asarray(x, dtype), jgram.GramNSConfig(compute_dtype=dtype))
        for top in (float(got.float().abs().max()),
                    float(jnp.abs(want.astype(jnp.float32)).max())):
            assert floor is None or top > floor, (dtype, top)
            assert ceiling is None or top < ceiling, (dtype, top)
