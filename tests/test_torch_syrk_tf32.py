"""The arithmetic the fp32 SYRK kernel relies on, on the CPU.

csrc/gram_syrk.cu computes G = X Xᵀ on the tensor cores as 3xTF32 (each
row of X split as x = big + small, both TF32, and X Xᵀ ≈ small·bigᵀ +
big·smallᵀ + big·bigᵀ).  ``syrk_tf32_emulated`` repeats that in plain
PyTorch.  Here, on inputs like chip_smoke.py's SYRK inputs (heavy-tailed
rows: cubed Gaussians, each row at unit norm), made from a numpy seed:

* three passes stay within the card's fp32 gate, max|got − want| <=
  1e-5 · max|want|, against the JAX reference ``syrk_ref``, mirrored;
* one TF32 pass misses it by more than 10x, so the gate tells TF32 from
  fp32 (Gaussian rows would not: G is near I and the contraction averages
  one pass's rounding away);
* the wrapper's zero-pad-and-crop of m and n to multiples of 4 (TMA needs
  16-byte row strides) equals the unpadded plain SYRK bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gram_syrk import (  # noqa: E402
    syrk_lower, syrk_plain, syrk_tf32_emulated)
from repro_torch.kernels.symmul import TMA_ALIGN, padded_call  # noqa: E402

GATE = 1e-5
# chip_smoke.py's fp32 SYRK shapes that are cheap on a CPU: aligned, and
# unaligned in both m and n (the pad path); plus one main-path shape cut to
# batch 2
SHAPES = [(2, 100, 212), (2, 101, 211), (2, 320, 960)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(shape, seed=0):
    """Heavy-tailed rows at unit norm (numpy fp32): cubed Gaussians."""
    x = np.random.default_rng(seed).standard_normal(shape) ** 3
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _want(x: np.ndarray) -> torch.Tensor:
    """The JAX reference's fp32 G = X Xᵀ, mirrored."""
    g = jref.mirror_lower(jref.syrk_ref(jnp.asarray(x)))
    return torch.from_numpy(np.array(g, np.float32))


def _err_over_allowance(x: np.ndarray, passes: int) -> float:
    want = _want(x)
    got = ref.mirror_lower(syrk_tf32_emulated(torch.from_numpy(x),
                                              passes=passes))
    return float((got - want).abs().max()) / (GATE * float(want.abs().max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_syrk_emulation_within_fp32_gate(shape):
    assert _err_over_allowance(_rows(shape), 3) <= 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_fails_syrk_gate_by_10x(shape):
    assert _err_over_allowance(_rows(shape), 1) >= 10.0


def test_syrk_emulation_is_the_symmul_emulation_of_x_and_xt():
    """The SYRK's split is the symmetric product's, with B = Xᵀ: the same
    operands split elementwise give the same three products."""
    from repro_torch.kernels.symmul import symmul_tf32_emulated
    x = torch.from_numpy(_rows((2, 64, 96), seed=2))
    for passes in (1, 3):
        assert torch.equal(syrk_tf32_emulated(x, passes=passes),
                           symmul_tf32_emulated(x, x.mT, passes=passes))
    with pytest.raises(ValueError, match="passes"):
        syrk_tf32_emulated(x, passes=2)


@pytest.mark.parametrize("shape", [(2, 101, 211), (2, 102, 210),
                                   (2, 100, 213), (2, 320, 957)])
def test_rectangular_padded_call_equals_unpadded_bitwise(shape):
    x = torch.from_numpy(_rows(shape, seed=1))
    fn = lambda t: ref.mirror_lower(syrk_plain(t))  # noqa: E731
    got = padded_call(fn, x)
    assert got.shape == (shape[0], shape[1], shape[1]) and got.is_contiguous()
    assert torch.equal(got, fn(x))


def test_padded_call_pads_rows_and_columns_independently():
    seen = []

    def fn(t):
        seen.append(tuple(t.shape))
        return t @ t.mT
    x = torch.ones(2, 5, 7)
    out = padded_call(fn, x)
    padded_call(fn, torch.ones(2, 8, 6))
    padded_call(fn, torch.ones(2, 8, 12))          # aligned: no copy
    assert seen == [(2, 8, 8), (2, 8, 8), (2, 8, 12)]
    assert out.shape == (2, 5, 5) and torch.equal(out, torch.full((2, 5, 5),
                                                                  7.0))
    assert TMA_ALIGN[torch.float32] == 4
    padded_call(fn, torch.ones(2, 8, 12, dtype=torch.bfloat16))
    assert seen[-1] == (2, 8, 16) and TMA_ALIGN[torch.bfloat16] == 8


def test_syrk_lower_on_cpu_is_the_mirrored_plain_version():
    x = torch.from_numpy(_rows((2, 101, 211), seed=3))
    got = syrk_lower(x, block_m=64, block_k=32)
    assert torch.equal(got, ref.mirror_lower(torch.matmul(x, x.mT)))


@pytest.mark.parametrize("shape", [(2, 100, 212), (2, 101, 211)])
def test_chip_smoke_syrk_inputs_tell_tf32_from_fp32(shape):
    """chip_smoke.py's own SYRK inputs (here from a CPU generator): unit-norm
    rows, product term far above the allowance, the 3xTF32 emulation
    passes its gate, one TF32 pass fails it by >= 10x."""
    cs = _chip_smoke()
    x = cs.syrk_inputs(torch, torch.Generator().manual_seed(0), *shape)
    assert x.shape == shape and x.dtype == torch.float32
    torch.testing.assert_close(torch.linalg.vector_norm(x, dim=-1),
                               torch.ones(shape[:2]))
    want = ref.mirror_lower(syrk_plain(x))
    allowance = cs.scaled_allowance(want, cs.SCALED_GATE)
    cs.check_sensitive("syrk", syrk_plain(x), want, 0.0, allowance)
    cs.check_scaled("3xtf32", ref.mirror_lower(syrk_tf32_emulated(x)), want,
                    cs.SCALED_GATE)
    one = ref.mirror_lower(syrk_tf32_emulated(x, passes=1))
    assert cs.check_rejects_tf32("1xtf32", one, want, cs.SCALED_GATE) >= 10


def test_gaussian_rows_cannot_tell_tf32_from_fp32():
    """Why the SYRK gate uses heavy-tailed rows: with Gaussian rows (G near
    I) one TF32 pass stays within 10x the allowance at a main-path width,
    since the contraction averages its rounding away; heavy-tailed rows of
    the same shape put it past 10x."""
    shape = (2, 320, 960)
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    g /= np.float32(np.sqrt(shape[-1]))
    assert _err_over_allowance(g, 1) < 10.0 <= \
        _err_over_allowance(_rows(shape), 1)


@pytest.mark.parametrize("shape", [(32, 960, 2560), (32, 960, 960),
                                   (32, 320, 960)])
def test_chip_smoke_syrk_bound(shape):
    """The SYRK's bound: m²n FLOPs a matrix (the symmetric half of 2·m²·n)
    as three TF32 products at 495 TFLOP/s, operations-bound at every
    main-path shape; FFMA at 67 TFLOP/s."""
    b, m, n = shape
    got = _chip_smoke().bound("gram_syrk", shape, "float32", 4)
    assert got[1] == "operations"
    assert got[0] == pytest.approx(3 * b * m * m * n / 495e12 * 1e3,
                                   rel=1e-12)
    assert got[2] == pytest.approx(b * m * m * n / 67e12 * 1e3, rel=1e-12)
    nbytes = b * m * n * 4 + b * m * m * 4
    assert got[0] > nbytes / 3.35e12 * 1e3


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116syrk_tf32_kernelILi64EEEv14CUtensorMap_stPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116syrk_tf32_kernelILi64EEEv14CUtensorMap_stPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 119 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized in the function '_ZN12_GLOBAL__N_116syrk_tf32_kernelILi64EEEv14CUtensorMap_stPfii'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116syrk_ffma_kernelI13__nv_bfloat16S1_Li64ELi32EEEvPKT_PT0_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116syrk_ffma_kernelI13__nv_bfloat16S1_Li64ELi32EEEvPKT_PT0_ii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 376 bytes cmem[0]
"""  # noqa: E501


def test_chip_smoke_ptxas_report_keys_each_kernel():
    """The device line's ptxas report: one entry a kernel with its
    registers, spills and C75xx notes, the notes on the kernel they name."""
    report = _chip_smoke().ptxas_report(PTXAS_LOG)
    assert len(report) == 2
    tf32, ffma = (next(v for k, v in report.items() if tag in k)
                  for tag in ("syrk_tf32_kernel", "syrk_ffma_kernel"))
    assert "Used 119 registers" in tf32 and "0 bytes spill stores" in tf32
    assert "(C7515)" in tf32 and "(C75" not in ffma
    assert "Used 128 registers" in ffma and "4 bytes spill stores" in ffma
