"""The arithmetic the fp32 symmul / gram_poly kernel relies on, on the CPU.

csrc/symmul.cu runs fp32 products on the tensor cores as 3xTF32: each
operand split as x = big + small, both rounded to TF32, and
A·B ≈ small_A·big_B + big_A·small_B + big_A·big_B.  ``symmul_tf32_emulated``
repeats that in plain PyTorch.  Here, on the same numpy-seeded inputs as the
reference (products O(1), as chip_smoke.py builds them):

* three passes stay within the card's fp32 gate, max|got − want| <=
  1e-5 · max|want|, against the JAX reference's fp32 product;
* one TF32 pass misses it by more than 10x, so the gate tells TF32 from
  fp32;
* the wrapper's zero-pad-and-crop for m % 4 != 0 (TMA needs 16-byte row
  strides) equals the unpadded product bit for bit.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.symmul import (  # noqa: E402
    TMA_ALIGN, padded_call, symmul_plain, symmul_tf32_emulated, tf32_round)

GATE = 1e-5
COEFFS = (8.287, -23.6, 17.3)       # the largest polar_express step


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(m: int, epilogue: str, seed: int = 0):
    """(a, b) as numpy fp32: G = X Xᵀ for X/√n (G near I), and for the plain
    epilogue P = aI + bG + cG² against G, so every product is O(1)."""
    x = np.random.default_rng(seed).standard_normal((2, m, 2 * m)).astype(
        np.float32) / np.float32(math.sqrt(2 * m))
    g = x @ np.swapaxes(x, -1, -2)
    g = np.tril(g) + np.swapaxes(np.tril(g, -1), -1, -2)
    if epilogue == "gram_poly":
        return g, g
    p = np.asarray(jref.gram_poly_ref(jnp.asarray(g), *COEFFS), np.float32)
    return np.tril(p) + np.swapaxes(np.tril(p, -1), -1, -2), g


def _want(a, b, epilogue):
    """The JAX reference's fp32 product (or polynomial), mirrored."""
    if epilogue == "gram_poly":
        out = jref.gram_poly_ref(jnp.asarray(a), *COEFFS)
    else:
        out = jref.symmul_ref(jnp.asarray(a), jnp.asarray(b))
    return torch.from_numpy(np.array(jref.mirror_lower(out), np.float32))


def _emulated(a, b, epilogue, passes):
    out = symmul_tf32_emulated(torch.from_numpy(a), torch.from_numpy(b),
                               epilogue=epilogue, coeffs=COEFFS,
                               passes=passes)
    return ref.mirror_lower(out)


@pytest.mark.parametrize("epilogue", ["plain", "gram_poly"])
@pytest.mark.parametrize("m", [64, 200])
def test_3xtf32_emulation_within_fp32_gate(m, epilogue):
    a, b = _operands(m, epilogue)
    want = _want(a, b, epilogue)
    err = float((_emulated(a, b, epilogue, 3) - want).abs().max())
    assert err <= GATE * float(want.abs().max())


@pytest.mark.parametrize("epilogue", ["plain", "gram_poly"])
@pytest.mark.parametrize("m", [64, 200])
def test_one_tf32_pass_fails_fp32_gate_by_10x(m, epilogue):
    a, b = _operands(m, epilogue)
    want = _want(a, b, epilogue)
    err = float((_emulated(a, b, epilogue, 1) - want).abs().max())
    assert err >= 10 * GATE * float(want.abs().max())


@pytest.mark.parametrize("epilogue", ["plain", "gram_poly"])
@pytest.mark.parametrize("m", [198, 101])
def test_padded_call_equals_unpadded_bitwise(m, epilogue):
    a, b = (torch.from_numpy(t) for t in _operands(m, epilogue, seed=1))
    if epilogue == "gram_poly":
        b = a
    fn = lambda x, y: symmul_plain(x, y, epilogue=epilogue,  # noqa: E731
                                   coeffs=COEFFS)
    got = padded_call(fn, a, b)
    assert got.shape == a.shape and got.is_contiguous()
    assert torch.equal(got, fn(a, b))


def test_padded_call_pads_to_tma_alignment_and_keeps_aliasing():
    seen = []

    def fn(x, y):
        seen.append((x.shape[-1], x is y))
        return x + y
    g = torch.ones(1, 6, 6)
    padded_call(fn, g, g)
    padded_call(fn, g, g.clone())
    out = padded_call(fn, torch.ones(1, 8, 8), torch.ones(1, 8, 8))
    assert seen == [(8, True), (8, False), (8, False)]
    assert TMA_ALIGN[torch.float32] == 4 and out.shape == (1, 8, 8)
    padded_call(fn, g.to(torch.bfloat16), g.to(torch.bfloat16))
    assert seen[-1] == (8, False) and TMA_ALIGN[torch.bfloat16] == 8


def test_tf32_round_is_round_to_nearest_ties_away():
    u = 2.0 ** -10                     # one TF32 unit at 1.0
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 4, 1 + 3 * u / 4,
                      3.0, 0.0, -2.5e-30])
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + u, 3.0, 0.0, -2.5e-30])
    got = tf32_round(x)
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    assert ((tf32_round(r) - r).abs() <= r.abs() * 2.0 ** -11).all()


def test_3xtf32_split_is_exact_to_2_pow_minus_21():
    """x − big is exact in fp32 and small keeps 11 of its bits, so
    |x − big − small| <= 2⁻²¹ |x|: the residual the kernel drops."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(4096)
                         .astype(np.float32))
    big = tf32_round(x)
    small = tf32_round(x - big)
    resid = (x.double() - big.double() - small.double()).abs()
    assert (resid <= x.double().abs() * 2.0 ** -21).all()


def test_chip_smoke_gate_tells_tf32_from_fp32():
    """chip_smoke.py's fp32 gate, run on the CPU emulation: three passes
    pass check_scaled, one pass fails it and check_rejects_tf32 finds it
    >= 10x out."""
    cs = _chip_smoke()
    a, b = _operands(200, "plain")
    want = _want(a, b, "plain")
    cs.check_scaled("3xtf32", _emulated(a, b, "plain", 3), want,
                    cs.SCALED_GATE)
    one = _emulated(a, b, "plain", 1)
    with pytest.raises(AssertionError, match="exceeds"):
        cs.check_scaled("1xtf32", one, want, cs.SCALED_GATE)
    assert cs.check_rejects_tf32("1xtf32", one, want, cs.SCALED_GATE) >= 10
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_rejects_tf32("3xtf32", _emulated(a, b, "plain", 3), want,
                              cs.SCALED_GATE)


@pytest.mark.parametrize("name,shape,dtype,want", [
    # 32·960³ FLOPs, three TF32 passes at 495 TFLOP/s; FFMA at 67
    ("symmul_plain", (32, 960, 960), "float32",
     (32 * 960 ** 3 * 3 / 495e12 * 1e3, "operations",
      32 * 960 ** 3 / 67e12 * 1e3)),
    # 32·960²·2560 FLOPs for SYRK
    ("gram_syrk", (32, 960, 2560), "float32",
     (32 * 960 ** 2 * 2560 * 3 / 495e12 * 1e3, "operations",
      32 * 960 ** 2 * 2560 / 67e12 * 1e3)),
    # bf16 at 989 TFLOP/s is bound by its bytes: 8·320²·2 in, out once
    ("symmul_gram_poly", (8, 320, 320), "bfloat16",
     (8 * 320 ** 2 * 2 * 2 / 3.35e12 * 1e3, "bytes",
      8 * 320 ** 3 / 67e12 * 1e3)),
])
def test_chip_smoke_bounds(name, shape, dtype, want):
    got = _chip_smoke().bound(name, shape, dtype, 2 if dtype == "bfloat16"
                              else 4)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[2] == pytest.approx(want[2], rel=1e-12)
