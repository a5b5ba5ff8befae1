"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs no JAX, so it runs where the port runs:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips.  Tolerances: fp32 rtol 1e-4 /
atol 1e-3, bf16 2e-2 (the reference's kernel tolerances).
"""

import pytest
import torch

from repro_torch.kernels import LAUNCHES, autotune, ops, ref, reset_launches
from repro_torch.kernels.gram_syrk import syrk_lower, syrk_plain
from repro_torch.kernels.symmul import symmul_lower, symmul_plain

pytestmark = pytest.mark.cuda

BLOCKS = list(autotune.INSTANTIATED_BLOCKS)
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bm,bk", BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain(cuda_device, bm, bk, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda_device).manual_seed(0)
    # entries of G = X Xᵀ near 1, so atol 1e-3 is small against every term
    x = torch.randn(2, 100, 212, generator=gen, device=cuda_device)
    x = (x / 212 ** 0.5).to(dt)
    g = syrk_lower(x, block_m=bm, block_k=bk)
    torch.testing.assert_close(g.float(), ref.mirror_lower(syrk_plain(x))
                               .float(), **TOL[dtype])
    c = (8.287, -23.6, 17.3)
    p = symmul_lower(g, g, epilogue="gram_poly", coeffs=c, block_m=bm,
                     block_k=bk)
    torch.testing.assert_close(p.float(), ref.mirror_lower(symmul_plain(
        g, g, epilogue="gram_poly", coeffs=c)).float(), **TOL[dtype])
    q = symmul_lower(p, g, block_m=bm, block_k=bk)
    torch.testing.assert_close(q.float(), ref.mirror_lower(
        symmul_plain(p, g)).float(), **TOL[dtype])


def test_output_is_exactly_symmetric(cuda_device):
    a = torch.randn(3, 200, 200, device=cuda_device)
    b = torch.randn(3, 200, 200, device=cuda_device)   # A·B not symmetric
    c = symmul_lower(a, b, block_m=64, block_k=32)
    assert torch.equal(c, c.mT)
    torch.testing.assert_close(c, ref.mirror_lower(symmul_plain(a, b)),
                               **TOL["float32"])


def test_wrappers_count_launches(cuda_device):
    reset_launches()
    x = torch.randn(2, 64, 96, device=cuda_device)
    g = ops.syrk(x)
    ops.gram_poly(g, 1.0, 2.0, 3.0)
    ops.symmul(g, g)
    assert LAUNCHES == {"syrk": 1, "symmul": 1, "gram_poly": 1}


def test_unsupported_dtype_raises_on_card(cuda_device):
    x = torch.randn(1, 32, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        syrk_lower(x, block_m=64, block_k=32)
