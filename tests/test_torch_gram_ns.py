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
