"""Plain PyTorch oracles for the Gram kernels (port of ``repro.kernels.ref``).

All functions accept arbitrary leading batch dims and accumulate in fp32.
"""

from __future__ import annotations

import torch


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def syrk_ref(x: torch.Tensor) -> torch.Tensor:
    """G = X Xᵀ for X of shape (..., m, n); output (..., m, m), symmetric."""
    return _bmm(x, x.mT)


def symmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A B for symmetric commuting A, B (C symmetric). Shapes (..., m, m)."""
    return _bmm(a, b)


def gram_poly_ref(g: torch.Tensor, a: float, b: float, c: float) -> torch.Tensor:
    """P = aI + bG + c(G@G) for symmetric G of shape (..., m, m).  Like the
    reference, G² is rounded to ``g.dtype`` before the combination."""
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return (a * eye + b * g + c * _bmm(g, g)).to(g.dtype)


def mirror_lower(c_raw: torch.Tensor) -> torch.Tensor:
    """Full symmetric matrix from a lower-triangular raw output: everything
    strictly above the diagonal (including the upper half of each diagonal
    tile) is discarded and replaced by the mirrored strict lower triangle."""
    return torch.tril(c_raw) + torch.tril(c_raw, -1).mT
