"""Batched SYRK, G = X Xᵀ: wrapper of the Hopper kernel ``csrc/gram_syrk.cu``
and its plain PyTorch version (port of ``repro.kernels.gram_syrk``).

Computes the initial Gram matrix of the Gram Newton-Schulz iteration for a
stack X of shape (B, m, n).  G is symmetric, so the kernel computes only the
lower tiles and writes the dense result (lower triangle mirrored up).

fp32 inputs run on the tensor cores as 3xTF32 (``syrk_tf32_emulated``
repeats that arithmetic in plain PyTorch); bf16 inputs as one bf16 wgmma
pass with fp32 accumulation.  TMA needs 16-byte row strides, m and n
multiples of 4 in fp32 and of 8 in bf16 (``symmul.TMA_ALIGN``), and the
wrapper zero-pads any other m or n and crops the result
(``symmul.padded_call``), which is exact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.autotune import slice_k
from repro_torch.kernels.symmul import (DTYPE_CODES, LAUNCH_ERRORS, TMA_ALIGN,
                                        check_kernel_args, padded_call,
                                        symmul_tf32_emulated, tma_ready)


def syrk_plain(x: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: the full batched X Xᵀ with fp32 accumulation."""
    xf = x.float()
    return torch.matmul(xf, xf.mT).to(out_dtype or x.dtype)


def syrk_tf32_emulated(x: torch.Tensor, *, passes: int = 3) -> torch.Tensor:
    """The fp32 kernel's tensor-core arithmetic in plain PyTorch: X Xᵀ as
    3xTF32 products (``passes=3``) or one TF32 product (``passes=1``, which
    the fp32 gate must reject); see ``symmul.symmul_tf32_emulated``."""
    return symmul_tf32_emulated(x, x.mT, passes=passes)


_entry = None


def _kernel():
    """(launch, error_string) C entry points of csrc/gram_syrk.cu, built and
    loaded on first use."""
    global _entry
    if _entry is None:
        from repro_torch.kernels import build
        lib = build.load("gram_syrk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_syrk_lower.argtypes = [p, p, i, i, i, i, i, i, i, p]
        lib.gram_syrk_lower.restype = i
        lib.gram_syrk_error_string.argtypes = [i]
        lib.gram_syrk_error_string.restype = ctypes.c_char_p
        _entry = (lib.gram_syrk_lower, lib.gram_syrk_error_string)
    return _entry


def syrk_lower(x: torch.Tensor, *, block_m: int = 128,
               block_k: Optional[int] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """G = X Xᵀ for x of shape (B, m, n) -> dense (B, m, m) whose upper
    triangle mirrors the lower one.  ``block_k`` defaults to one 128-byte
    swizzle row of the input type (``autotune.slice_k``).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if x.ndim != 3:
        raise ValueError(f"expected (B, m, n), got {tuple(x.shape)}")
    out_dtype = out_dtype or x.dtype
    block_k = block_k or slice_k(x.element_size())
    check_kernel_args(x, block_m, block_k, out_dtype)
    if x.device.type == "cpu":
        return ref.mirror_lower(syrk_plain(x, out_dtype))

    if x.shape[-2] % TMA_ALIGN[x.dtype] or x.shape[-1] % TMA_ALIGN[x.dtype]:
        return padded_call(functools.partial(
            syrk_lower, block_m=block_m, block_k=block_k,
            out_dtype=out_dtype), x)

    x = tma_ready(x)
    batch, m, n = x.shape
    out = torch.empty((batch, m, m), dtype=out_dtype, device=x.device)
    if batch == 0 or m == 0:
        return out
    if n == 0:
        return out.zero_()
    launch, error_string = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), batch, m, n, block_m,
                     block_k, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
                     stream)
    if err != 0:
        msg = LAUNCH_ERRORS.get(err) or error_string(err).decode()
        raise RuntimeError(f"gram_syrk_lower launch failed ({err}): {msg}")
    LAUNCHES["syrk"] += 1
    return out
