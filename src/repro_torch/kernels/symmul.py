"""Batched symmetric-output product: wrapper of the Hopper kernel
``csrc/symmul.cu`` and its plain PyTorch version (port of
``repro.kernels.symmul``).

Every matrix of the Gram NS iteration is a polynomial in G₀, so all products
are symmetric and commute; the kernel computes only the lower tiles of
C = A·B and writes the dense result (the lower triangle mirrored up, i.e.
``ref.mirror_lower`` of the lower product).  Two epilogues:

* ``plain``      — C = A·B
* ``gram_poly``  — P = aI + bG + cG² from the G·G pass, combined in fp32
  before the cast, so the polynomial never round-trips device memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.autotune import INSTANTIATED_BLOCKS

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (input, output) dtype pairs the kernels are compiled for
KERNEL_DTYPES = {(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32)}
MAX_BATCH = 65535               # grid.y limit


def tri_index_tables(n_blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) coordinates of the block-lower triangle, row-major — the order
    the kernels' 1-D launch enumerates tiles in (closed form on the card)."""
    ii, jj = [], []
    for i in range(n_blocks):
        for j in range(i + 1):
            ii.append(i)
            jj.append(j)
    return (np.asarray(ii, dtype=np.int32), np.asarray(jj, dtype=np.int32))


def check_kernel_args(x: torch.Tensor, block_m: int, block_k: int,
                      out_dtype: torch.dtype) -> None:
    """Raise on what the CUDA kernels do not take."""
    if (block_m, block_k) not in INSTANTIATED_BLOCKS:
        raise ValueError(f"no kernel instantiated for block (block_m, block_k)"
                         f"=({block_m}, {block_k}); "
                         f"instantiated: {INSTANTIATED_BLOCKS}")
    if (x.dtype, out_dtype) not in KERNEL_DTYPES:
        raise ValueError(f"no kernel for {x.dtype} -> {out_dtype}")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} exceeds {MAX_BATCH}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def symmul_plain(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = "plain",
                 coeffs: Optional[tuple] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: the full batched product with fp32 accumulation; for
    ``gram_poly`` the epilogue is combined in fp32 before the cast, as the
    kernel does."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if epilogue == "gram_poly":
        ca, cb, cc = coeffs
        eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
        acc = ca * eye + cb * a.float() + cc * acc
    return acc.to(out_dtype)


_entry = None


def _kernel():
    """(launch, error_string) C entry points of csrc/symmul.cu, built and
    loaded on first use."""
    global _entry
    if _entry is None:
        from repro_torch.kernels import build
        lib = build.load("symmul")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.symmul_lower.argtypes = [p, p, p, i, i, i, i, i, f, f, f, i, i, p]
        lib.symmul_lower.restype = i
        lib.symmul_error_string.argtypes = [i]
        lib.symmul_error_string.restype = ctypes.c_char_p
        _entry = (lib.symmul_lower, lib.symmul_error_string)
    return _entry


def symmul_lower(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = "plain",
                 coeffs: Optional[tuple] = None, block_m: int = 128,
                 block_k: int = 32,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Symmetric product of a, b: (B, m, m) -> dense (B, m, m) whose upper
    triangle mirrors the lower one.  For ``epilogue='gram_poly'`` call with
    a == b == G and (a, b, c) in ``coeffs``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"expected (B, m, m) operands, got {a.shape}, {b.shape}")
    if a.shape != b.shape or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"symmul expects equal square operands, got {a.shape}, {b.shape}")
    if epilogue not in ("plain", "gram_poly"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "gram_poly" and (coeffs is None or len(coeffs) != 3):
        raise ValueError("gram_poly epilogue requires (a, b, c) coeffs")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError("symmul operands must share dtype and device")
    out_dtype = out_dtype or a.dtype
    check_kernel_args(a, block_m, block_k, out_dtype)
    if a.device.type == "cpu":
        return ref.mirror_lower(symmul_plain(a, b, epilogue=epilogue,
                                             coeffs=coeffs, out_dtype=out_dtype))

    a = a.contiguous()
    b = b.contiguous()
    batch, m, _ = a.shape
    out = torch.empty((batch, m, m), dtype=out_dtype, device=a.device)
    if batch == 0 or m == 0:
        return out
    poly = epilogue == "gram_poly"
    ca, cb, cc = (float(c) for c in coeffs) if poly else (0.0, 0.0, 0.0)
    launch, error_string = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m,
                     block_m, block_k, int(poly), ca, cb, cc,
                     DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype], stream)
    if err != 0:
        msg = ("no instantiation" if err < 0
               else error_string(err).decode())
        raise RuntimeError(f"symmul_lower launch failed ({err}): {msg}")
    LAUNCHES["gram_poly" if poly else "symmul"] += 1
    return out
