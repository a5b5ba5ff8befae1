"""Public ops over the Gram kernels (port of ``repro.kernels.ops``).

These are what the Gram NS iteration (core/gram_ns.py) dispatches to when
``use_kernels=True``.  Each op:

  * accepts arbitrary leading batch dims (flattened internally to one),
  * runs the lower-triangle kernel (symmul.py / gram_syrk.py) — on a CUDA
    tensor the Hopper kernel, on a CPU tensor its plain version,
  * returns the dense symmetric output: the kernels' epilogue mirrors the
    lower triangle up (``ref.mirror_lower`` of the lower product),
  * consults the autotuner cache for block shapes unless both ``block_m``
    and ``block_k`` are given.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import dtype_name
from repro_torch.kernels import autotune
from repro_torch.kernels.gram_syrk import syrk_lower
from repro_torch.kernels.symmul import symmul_lower


def _flatten_batch(x: torch.Tensor):
    lead = tuple(x.shape[:-2])
    return x.reshape((-1,) + tuple(x.shape[-2:])), lead


def _resolve_blocks(m: int, k: int, block_m: Optional[int],
                    block_k: Optional[int], mode: str,
                    x: torch.Tensor) -> tuple[int, int]:
    if block_m is not None and block_k is not None:
        return block_m, block_k
    bm, bk = autotune.lookup(mode, m, k, dtype_name(x.dtype),
                             arch=autotune.device_arch(x.device))
    return (block_m or bm, block_k or bk)


def syrk(x, *, block_m: Optional[int] = None, block_k: Optional[int] = None,
         out_dtype=None):
    """G = X Xᵀ (dense symmetric output) for x of shape (..., m, n)."""
    xf, lead = _flatten_batch(x)
    bm, bk = _resolve_blocks(xf.shape[-2], xf.shape[-1], block_m, block_k,
                             "syrk", xf)
    out = syrk_lower(xf, block_m=bm, block_k=bk, out_dtype=out_dtype)
    return out.reshape(lead + tuple(out.shape[-2:]))


def symmul(a, b, *, block_m: Optional[int] = None,
           block_k: Optional[int] = None, out_dtype=None):
    """C = A B for symmetric commuting A, B of shape (..., m, m)."""
    af, lead = _flatten_batch(a)
    bf, _ = _flatten_batch(b)
    bm, bk = _resolve_blocks(af.shape[-1], af.shape[-1], block_m, block_k,
                             "symmul", af)
    out = symmul_lower(af, bf, epilogue="plain", block_m=bm, block_k=bk,
                       out_dtype=out_dtype)
    return out.reshape(lead + tuple(out.shape[-2:]))


def gram_poly(g, a: float, b: float, c: float, *,
              block_m: Optional[int] = None, block_k: Optional[int] = None,
              out_dtype=None):
    """P = aI + bG + cG² with the polynomial fused into the G@G epilogue."""
    gf, lead = _flatten_batch(g)
    bm, bk = _resolve_blocks(gf.shape[-1], gf.shape[-1], block_m, block_k,
                             "gram_poly", gf)
    out = symmul_lower(gf, gf, epilogue="gram_poly",
                       coeffs=(float(a), float(b), float(c)),
                       block_m=bm, block_k=bk, out_dtype=out_dtype)
    return out.reshape(lead + tuple(out.shape[-2:]))
