"""Standard (non-Gram) Newton-Schulz orthogonalization (port of
``repro.core.newton_schulz``).

The compute path of the gather-then-compute baseline (Muon-AG) and the
semantic oracle of the Gram-space path in ``gram_ns.py``:

    X₀ = M / ||M||_F
    X_{i+1} = a X_i + (b A_i + c A_i²) X_i,   A_i = X_i X_iᵀ          (Eq. 2)

All matmuls accumulate in fp32 whatever the working dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.coefficients import Coeffs, get_coefficients

_EPS = 1e-7


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul over the last two dims with fp32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def newton_schulz(
    m: torch.Tensor,
    *,
    num_steps: int = 5,
    schedule: str | Sequence[Coeffs] = "polar_express",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Orthogonalize ``m`` (shape ``(..., r, c)``) via standard Newton-Schulz.
    Tall matrices are transposed so the iteration runs on the smaller Gram
    side.  Returns a tensor of the same shape and dtype as ``m``."""
    if m.ndim < 2:
        raise ValueError(f"newton_schulz expects a matrix, got shape {tuple(m.shape)}")
    coeffs = (get_coefficients(schedule, num_steps)
              if isinstance(schedule, str) else tuple(schedule)[:num_steps])

    out_dtype = m.dtype
    cdtype = compute_dtype or torch.float32
    x = m.float()

    transposed = m.shape[-2] > m.shape[-1]
    if transposed:
        x = x.mT

    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    x = (x / (norm + _EPS)).to(cdtype)

    for a, b, c in coeffs:
        g = _dot(x, x.mT)                      # A = X Xᵀ
        poly = b * g + c * _dot(g, g)          # bA + cA²
        x = a * x + _dot(poly, x)              # aX + (·)X

    if transposed:
        x = x.mT
    return x.to(out_dtype)


def msign_svd(m: torch.Tensor) -> torch.Tensor:
    """Exact polar factor UVᵀ via SVD — test oracle only."""
    u, _, vt = torch.linalg.svd(m.float(), full_matrices=False)
    return (u @ vt).to(m.dtype)
