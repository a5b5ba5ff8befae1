"""Gram-space Newton-Schulz iteration (port of ``repro.core.gram_ns``; paper
§3.3, after Zhang et al.).

One NS step is ``X_{i+1} = P_i X_i`` with ``P_i = aI + bG_i + cG_i²``, so the
Gram matrix obeys ``G_{i+1} = P_i G_i P_i`` (Eq. 4) and the polar factor is
``X_k = Q_k X₀`` with ``Q_{i+1} = P_i Q_i``.  Every matrix of the iteration
is a polynomial in G₀: symmetric and commuting, so every product has a
symmetric output and the kernels compute only its lower triangle.

Per step (fp32 accumulation everywhere):

    P  = aI + bG + c·(G@G)     gram_poly kernel (fused epilogue)
    T  = P@G                   symmul kernel        (skipped on last step)
    G' = P@T                   symmul kernel        (skipped on last step)
    Q' = P@Q                   symmul kernel        (Q' := P on first step)

giving ``4k − 3`` m×m products for k steps, plus one m×n SYRK (G₀) and one
m×n product (final ``Q_k X₀``, a plain matmul outside every kernel).

With ``use_kernels=True`` the products go through ``repro_torch.kernels.ops``,
which launches the Hopper kernels for CUDA tensors and their plain versions
for CPU tensors; otherwise through the plain oracles of ``kernels.ref``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core.coefficients import Coeffs, get_coefficients
from repro_torch.device import as_dtype

_EPS = 1e-7


@dataclass(frozen=True)
class GramNSConfig:
    """Execution configuration for the Gram NS iteration."""
    num_steps: int = 5
    schedule: str = "polar_express"
    compute_dtype: str = "float32"   # iterate dtype; fp32 accumulation regardless
    use_kernels: bool = False        # Hopper symmetric kernels vs plain torch
    # Accepted for parity with the reference and ignored: the port chooses
    # kernel or plain version by the tensor's device, not by a flag.
    kernel_interpret: bool = True
    # Kernel blocks; None lets the autotuner choose.  (The reference's
    # defaults, 128/128, are TPU MXU-sized; the Hopper kernels are compiled
    # for the pairs in kernels.autotune.INSTANTIATED_BLOCKS.)
    block_m: Optional[int] = None
    block_k: Optional[int] = None
    # Owner-local batch chunking: bounds the live Gram-space working set.
    # 0 = no chunking.
    owner_chunk: int = 0
    # Fuse the m×m iteration phase across groups sharing a Gram dimension.
    bucket_fusion: bool = False

    def coeffs(self) -> Sequence[Coeffs]:
        return get_coefficients(self.schedule, self.num_steps)


def _ops(cfg: GramNSConfig):
    """Resolve the (syrk, gram_poly, symmul) op set for ``cfg``."""
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        kw = dict(block_m=cfg.block_m, block_k=cfg.block_k)
        return (
            lambda x: kops.syrk(x, **kw),
            lambda g, a, b, c: kops.gram_poly(g, a, b, c, **kw),
            lambda a, b: kops.symmul(a, b, **kw),
        )
    from repro_torch.kernels import ref as kref
    return kref.syrk_ref, kref.gram_poly_ref, kref.symmul_ref


def _rect_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (…, m, m) @ (…, m, n) with fp32 accumulation (IEEE fp32 on
    the card: entry points turn TF32 off, ``device.resolve_device``)."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _normalize(x: torch.Tensor, cfg: GramNSConfig) -> torch.Tensor:
    # Frobenius norm accumulated in fp32 without an fp32 copy of x: the cast
    # fuses into the reduction.
    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True,
                                    dtype=torch.float32)
    cdtype = as_dtype(cfg.compute_dtype)
    return x.to(cdtype) / (norm + _EPS).to(cdtype)


def gram_newton_schulz(
    m: torch.Tensor,
    cfg: GramNSConfig = GramNSConfig(),
    *,
    assume_short_fat: bool = False,
) -> torch.Tensor:
    """Orthogonalize ``m`` of shape ``(..., r, c)`` via Gram-space NS.

    Transposes internally so the Gram side is the smaller dimension unless
    ``assume_short_fat`` asserts r <= c already."""
    if m.ndim < 2:
        raise ValueError(f"gram_newton_schulz expects a matrix, got {tuple(m.shape)}")
    out_dtype = m.dtype
    x = m
    transposed = False
    if not assume_short_fat and m.shape[-2] > m.shape[-1]:
        x, transposed = x.mT, True

    x0 = _normalize(x, cfg)
    syrk, _, _ = _ops(cfg)
    q = gram_iterate(syrk(x0), cfg)                # G₀ = X₀X₀ᵀ, then Q_k
    out = _rect_dot(q, x0)                         # X_k = Q_k X₀
    if transposed:
        out = out.mT
    return out.to(out_dtype)


def gram_prepare(m: torch.Tensor, cfg: GramNSConfig):
    """Phase 1: normalize + initial Gram.  m: (..., r, c) with r <= c.
    Returns (x0, G) — G is (..., r, r)."""
    x0 = _normalize(m, cfg)
    syrk, _, _ = _ops(cfg)
    return x0, syrk(x0)


def gram_iterate(g: torch.Tensor, cfg: GramNSConfig) -> torch.Tensor:
    """Phase 2: the m×m Gram recurrence; returns the polar accumulator Q_k.
    Shape-uniform in the Gram dimension only, so stacks of groups with equal
    m can be batched together here (bucket fusion)."""
    _, gram_poly, symmul = _ops(cfg)
    coeffs = cfg.coeffs()
    q = None
    last = len(coeffs) - 1
    for i, (a, b, c) in enumerate(coeffs):
        p = gram_poly(g, a, b, c)                  # P = aI + bG + c(G@G)
        q = p if q is None else symmul(p, q)       # Q' = P Q
        if i != last:                              # G' not needed after last P
            t = symmul(p, g)                       # T = PG (= GP)
            g = symmul(p, t)                       # G' = PT = P G P
    return q


def gram_finish(q: torch.Tensor, x0: torch.Tensor, out_dtype) -> torch.Tensor:
    """Phase 3: X_k = Q_k X₀."""
    return _rect_dot(q, x0).to(out_dtype)


def gram_ns_flops(m: int, n: int, num_steps: int = 5, batch: int = 1,
                  symmetric_kernels: bool = True) -> dict:
    """Analytic FLOP model: the naive-GEMM count and the symmetric-kernel
    count (every m×m product and the SYRK compute only the lower half)."""
    if m > n:
        m, n = n, m
    sym_products = 4 * num_steps - 3
    mm = 2.0 * m * m * m                 # one full m×m×m GEMM
    rect = 2.0 * m * m * n               # one m×m @ m×n GEMM (or SYRK of X)
    full = batch * (rect + sym_products * mm + rect)
    half = batch * (rect / 2.0 + sym_products * mm / 2.0 + rect)
    ns_standard = batch * num_steps * (2.0 * rect + mm)
    return {
        "gram_full_gemm": full,
        "gram_symmetric_kernel": half if symmetric_kernels else full,
        "standard_ns": ns_standard,
    }
