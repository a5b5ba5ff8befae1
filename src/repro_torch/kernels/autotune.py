"""Shape-adaptive block selection for the Hopper Gram kernels, with a
persistent cache (port of ``repro.kernels.autotune``, paper §3.3, Fig. 6).

The search space is the (block_m, block_k) pairs the CUDA kernels are
instantiated for (``INSTANTIATED_BLOCKS``; csrc/*.cu dispatch on exactly
these) that fit the 227 KB of shared memory a Hopper block may use.

Two backends:
  * ``analytical`` — padded lower-tile work times the register tile's
    shared-memory cost (``analytical_score``); runs anywhere, including the
    CPU, so ``prewarm_plan``, ``lookup`` and ``cached_entry`` work without a
    card.
  * ``measured``   — times the public op on the card with CUDA events.

Cache entries are keyed by (arch, mode, m, k, dtype), where arch is the
device capability (``sm90``) or ``cpu``.  The cache file is the port's own,
``build/repro_torch/autotune.json`` in the checkout (``CACHE_PATH``):
winners tuned for the TPU by the reference package never leak in.
"""

from __future__ import annotations

import functools
import json
import os
import threading
from pathlib import Path
from typing import Iterable, Optional

import torch

# (block_m, block_k) pairs the CUDA kernels are compiled for.
INSTANTIATED_BLOCKS = ((64, 32), (128, 32))
SMEM_BYTES = 232_448            # dynamic shared memory a Hopper block may use
THREADS = 256                   # threads per block (16 x 16 micro-tile grid)

CACHE_PATH = str(Path(__file__).resolve().parents[3] / "build"
                 / "repro_torch" / "autotune.json")

_lock = threading.Lock()
_memory_cache: dict[str, tuple[int, int]] = {}
_loaded_paths: set[str] = set()


def default_cache_path() -> str:
    return CACHE_PATH


@functools.lru_cache(maxsize=None)
def device_arch(device) -> str:
    """Cache key of a device: ``sm<major><minor>`` for CUDA, else its type."""
    device = torch.device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"sm{major}{minor}"
    return device.type


def _key(arch: str, mode: str, m: int, k: int, dtype: str) -> str:
    return f"{arch}:{mode}:{m}x{k}:{dtype}"


def _load(path: str) -> None:
    if path in _loaded_paths:
        return
    _loaded_paths.add(path)
    try:
        with open(path) as f:
            data = json.load(f)
        for k, v in data.items():
            _memory_cache.setdefault(k, (int(v[0]), int(v[1])))
    except (OSError, ValueError):
        pass


def _save(path: str) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({k: list(v) for k, v in _memory_cache.items()}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def smem_bytes(bm: int, bk: int) -> int:
    """Dynamic shared memory of one block (csrc/lower_tiles.cuh)."""
    return 4 * max(2 * bk * (bm + 1), bm * (bm + 1))


def candidate_blocks(m: int, k: int, dtype_bytes: int = 4
                     ) -> Iterable[tuple[int, int]]:
    """Instantiated (block_m, block_k) pairs that fit a block's shared memory.
    Operands are staged as fp32 whatever their type, so ``dtype_bytes``
    does not change the footprint."""
    return [(bm, bk) for bm, bk in INSTANTIATED_BLOCKS
            if smem_bytes(bm, bk) <= SMEM_BYTES]


def analytical_score(bm: int, bk: int, m: int, k: int,
                     dtype_bytes: int = 4) -> float:
    """Lower is better: padded work times the register tile's cost.

    * padded work — the lower tiles of a ceil(m/bm)-block grid over
      ceil(k/bk) slices, relative to the m(m+1)/2 · k products needed;
    * register tile — a thread's (bm/16)² micro-tile does (bm/16)² FFMA per
      2·bm/16 shared-memory reads, so the cost per FFMA is 1 + 2/(bm/16).

    The two factors are exact in binary, so equal scores compare equal; the
    tuner breaks a tie towards the larger tile (fewer reads per FFMA).  At
    m = 960 the pairs tie and 128×32 is chosen; at m = 320 the 128-row grid
    pads 60% more work and 64×32 is chosen (both the measured winners on an
    H100, chip_smoke.py's blocks phase).
    """
    nb = -(-m // bm)
    nk = -(-k // bk)
    padded = nb * (nb + 1) // 2 * bm * bm * nk * bk
    return padded * (1.0 + 2.0 / (bm // 16)) / (m * (m + 1) / 2.0 * k)


def tune(mode: str, m: int, k: int, dtype: str = "float32", *,
         backend: str = "analytical", batch: int = 1,
         cache_path: Optional[str] = None, arch: str = "cpu"
         ) -> tuple[int, int]:
    """Search the candidates and cache the winner."""
    cache_path = default_cache_path() if cache_path is None else cache_path
    key = _key(arch, mode, m, k, dtype)
    with _lock:
        _load(cache_path)
        if key in _memory_cache:
            return _memory_cache[key]

    dtype_bytes = 2 if dtype in ("bfloat16", "float16") else 4
    scores = {}
    for bm, bk in candidate_blocks(m, k, dtype_bytes):
        if backend == "analytical":
            scores[bm, bk] = analytical_score(bm, bk, m, k, dtype_bytes)
        elif backend == "measured":
            scores[bm, bk] = measure_cuda(mode, bm, bk, m, k, dtype, batch)
        else:
            raise ValueError(f"unknown autotune backend {backend!r}")
    best = min(scores, key=lambda b: (scores[b], -b[0]))   # tie: larger tile

    with _lock:
        _memory_cache[key] = best
        _save(cache_path)
    return best


def measure_cuda(mode: str, bm: int, bk: int, m: int, k: int, dtype: str,
                  batch: int, reps: int = 10) -> float:
    """Milliseconds of one call of the public op on the card (CUDA events,
    median of ``reps`` after a warm-up)."""
    from repro_torch.device import as_dtype
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        raise RuntimeError("backend='measured' times the kernels on a CUDA "
                           "card; none is available")
    gen = torch.Generator("cuda").manual_seed(0)
    dt = as_dtype(dtype)
    if mode == "syrk":
        x = torch.randn(batch, m, k, generator=gen, device="cuda").to(dt)
        fn = lambda: ops.syrk(x, block_m=bm, block_k=bk)       # noqa: E731
    else:
        g = torch.randn(batch, m, m, generator=gen, device="cuda")
        g = ((g + g.mT) / 2).to(dt)
        if mode == "gram_poly":
            fn = lambda: ops.gram_poly(g, 3.0, -4.0, 2.0,         # noqa: E731
                                       block_m=bm, block_k=bk)
        else:
            fn = lambda: ops.symmul(g, g, block_m=bm, block_k=bk)  # noqa: E731
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def cached_entry(mode: str, m: int, k: int, dtype: str,
                 cache_path: Optional[str] = None, arch: str = "cpu"
                 ) -> Optional[tuple[int, int]]:
    """The cached winner for a shape, or None — never tunes or scores."""
    cache_path = default_cache_path() if cache_path is None else cache_path
    with _lock:
        _load(cache_path)
        return _memory_cache.get(_key(arch, mode, m, k, dtype))


def lookup(mode: str, m: int, k: int, dtype: str,
           cache_path: Optional[str] = None, arch: str = "cpu"
           ) -> tuple[int, int]:
    """Cache hit or analytical tune — never measures."""
    hit = cached_entry(mode, m, k, dtype, cache_path=cache_path, arch=arch)
    if hit is not None:
        return hit
    return tune(mode, m, k, dtype, backend="analytical",
                cache_path=cache_path, arch=arch)


def plan_shapes(plan) -> list[tuple[str, int, int]]:
    """Every (mode, m, k) kernel launch a dedication plan can produce: one
    m×n SYRK per group shape, ``gram_poly`` and ``symmul`` per Gram dim."""
    shapes: set[tuple[str, int, int]] = set()
    for g in plan.groups.values():
        m, n = g.key
        shapes.add(("syrk", m, n))
        shapes.add(("gram_poly", m, m))
        shapes.add(("symmul", m, m))
    return sorted(shapes)


def prewarm_plan(plan, *, dtypes=("float32",), backend: str = "analytical",
                 cache_path: Optional[str] = None, arch: str = "cpu") -> int:
    """Pre-warm the cache for every kernel shape of a dedication plan, once,
    at optimizer construction; cached shapes are skipped.  Returns the number
    of entries covered (hit or newly tuned)."""
    n = 0
    for dt in dtypes:
        for mode, m, k in plan_shapes(plan):
            if cached_entry(mode, m, k, str(dt), cache_path=cache_path,
                            arch=arch) is None:
                tune(mode, m, k, str(dt), backend=backend,
                     cache_path=cache_path, arch=arch)
            n += 1
    return n


def clear_memory_cache() -> None:
    with _lock:
        _memory_cache.clear()
        _loaded_paths.clear()
