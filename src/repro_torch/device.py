"""Device and dtype helpers shared by the port's entry points.

Entry points run on CUDA unless the caller passes ``device="cpu"``; they
never fall back to the CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        strict_fp32()
    return device


def strict_fp32() -> None:
    """fp32 matmuls in full IEEE precision: TF32 keeps ~3 decimal digits and
    cannot meet the port's 1e-4 parity with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_dtype(name) -> torch.dtype:
    """torch dtype from a reference dtype name ('float32', 'bfloat16')."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dtype_name(dtype: torch.dtype) -> str:
    """Reference spelling of a torch dtype ('float32', 'bfloat16')."""
    return str(dtype).removeprefix("torch.")
