"""Hopper kernels for the Gram Newton-Schulz products (port of
``repro.kernels``).

Modules:
  gram_syrk  — batched G = X Xᵀ, lower tiles only (CUDA, csrc/gram_syrk.cu)
  symmul     — batched symmetric product, lower tiles only, with the plain
               and the fused ``gram_poly`` epilogue (CUDA, csrc/symmul.cu)
  ops        — public ops: batch flattening and autotuned block dispatch
  ref        — plain PyTorch oracles
  autotune   — Hopper block-shape search + persistent cache
  build      — compiles csrc/*.cu with nvcc at first use, loads with ctypes

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor, and counts kernel launches in ``LAUNCHES``.  Nothing is
compiled at import time.
"""

LAUNCHES = {"syrk": 0, "symmul": 0, "gram_poly": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
