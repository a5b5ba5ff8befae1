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

fp32 operands run on the tensor cores as 3xTF32 (``symmul_tf32_emulated``
repeats that arithmetic in plain PyTorch); bf16 operands as one bf16 wgmma
pass with fp32 accumulation.  TMA needs 16-byte row strides, m % 4 == 0 in
fp32 and m % 8 == 0 in bf16 (``TMA_ALIGN``), and the wrapper zero-pads any
other m and crops the result (``padded_call``), which is exact for both
epilogues.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.autotune import INSTANTIATED_BLOCKS, slice_k

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (input, output) dtype pairs the kernels are compiled for
KERNEL_DTYPES = {(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32)}
MAX_BATCH = 65535               # grid.y limit
# elements in 16 bytes, TMA's row-stride unit, per input dtype
TMA_ALIGN = {torch.float32: 4, torch.bfloat16: 8}
# error codes of the C entry points (csrc/symmul.cu, csrc/gram_syrk.cu) below 0
LAUNCH_ERRORS = {-1: "no instantiation",
                 -2: "TMA tensor map encoding failed",
                 -3: "dims not multiples of 16 bytes (TMA row strides)"}


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
    blocks = INSTANTIATED_BLOCKS.get(x.element_size(), ())
    if (block_m, block_k) not in blocks:
        raise ValueError(f"no kernel instantiated for block (block_m, block_k)"
                         f"=({block_m}, {block_k}) and {x.dtype}; "
                         f"instantiated: {blocks}")
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
    return _epilogue(torch.matmul(a.float(), b.float()), a, epilogue, coeffs,
                     out_dtype or a.dtype)


def _epilogue(acc: torch.Tensor, a: torch.Tensor, epilogue: str,
              coeffs: Optional[tuple], out_dtype: torch.dtype) -> torch.Tensor:
    if epilogue == "gram_poly":
        ca, cb, cc = coeffs
        eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
        acc = ca * eye + cb * a.float() + cc * acc
    return acc.to(out_dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to the nearest TF32 value, ties away from zero, as
    the kernel's ``cvt.rna.tf32.f32``: half a TF32 unit is added to the
    magnitude's bits and the 13 low mantissa bits are cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def symmul_tf32_emulated(a: torch.Tensor, b: torch.Tensor, *,
                         epilogue: str = "plain",
                         coeffs: Optional[tuple] = None,
                         passes: int = 3) -> torch.Tensor:
    """The fp32 kernel's tensor-core arithmetic in plain PyTorch: each
    operand split as x = big + small, both TF32 (``tf32_round``), and
    A·B ≈ small_A·big_B + big_A·small_B + big_A·big_B, every product of TF32
    values exact in fp32 (``passes=3``, what the kernel runs).  ``passes=1``
    keeps big_A·big_B alone: one TF32 product, which the fp32 gate must
    reject."""
    a32, b32 = a.float(), b.float()
    a_big, b_big = tf32_round(a32), tf32_round(b32)
    acc = torch.matmul(a_big, b_big)
    if passes == 3:
        acc = (torch.matmul(tf32_round(a32 - a_big), b_big)
               + torch.matmul(a_big, tf32_round(b32 - b_big)) + acc)
    elif passes != 1:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return _epilogue(acc, a, epilogue, coeffs, torch.float32)


def padded_call(fn: Callable[..., torch.Tensor],
                *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)`` on (B, rows, cols) operands whose last two dims are
    zero-padded, each on its own, to the next multiple of ``TMA_ALIGN`` of
    their dtype, cropped back to (B, m, m) with m the first operand's rows.
    Exact for the symmetric product's epilogues and for the SYRK: zero
    columns add zero terms to every kept product, zero rows only add output
    rows and columns that are cropped, and aI + bG at a kept entry reads
    only kept entries of G.  An operand that is the first one stays the
    first one (padded once)."""
    def pad(t):
        rows, cols = t.shape[-2:]
        align = TMA_ALIGN[t.dtype]
        return torch.nn.functional.pad(t, (0, -cols % align, 0, -rows % align))
    if not any(d % TMA_ALIGN[t.dtype] for t in operands
               for d in t.shape[-2:]):
        return fn(*operands)
    first = pad(operands[0])
    padded = [first if t is operands[0] else pad(t) for t in operands]
    m = operands[0].shape[-2]
    return fn(*padded)[:, :m, :m].contiguous()


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


def tma_ready(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with the 16-byte-aligned base address TMA needs."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def symmul_lower(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = "plain",
                 coeffs: Optional[tuple] = None, block_m: int = 128,
                 block_k: Optional[int] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Symmetric product of a, b: (B, m, m) -> dense (B, m, m) whose upper
    triangle mirrors the lower one.  For ``epilogue='gram_poly'`` call with
    a == b == G and (a, b, c) in ``coeffs``.  ``block_k`` defaults to one
    128-byte swizzle row of the operand type (``autotune.slice_k``).

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
    block_k = block_k or slice_k(a.element_size())
    check_kernel_args(a, block_m, block_k, out_dtype)
    if a.device.type == "cpu":
        return ref.mirror_lower(symmul_plain(a, b, epilogue=epilogue,
                                             coeffs=coeffs, out_dtype=out_dtype))

    if a.shape[-1] % TMA_ALIGN[a.dtype]:
        return padded_call(functools.partial(
            symmul_lower, epilogue=epilogue, coeffs=coeffs, block_m=block_m,
            block_k=block_k, out_dtype=out_dtype), a, b)

    a = tma_ready(a)
    b = a if b is a else tma_ready(b)
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
        msg = LAUNCH_ERRORS.get(err) or error_string(err).decode()
        raise RuntimeError(f"symmul_lower launch failed ({err}): {msg}")
    LAUNCHES["gram_poly" if poly else "symmul"] += 1
    return out
