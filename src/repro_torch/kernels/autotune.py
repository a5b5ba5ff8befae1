"""Shape-adaptive block selection for the Hopper Gram kernels, with a
persistent cache (port of ``repro.kernels.autotune``, paper §3.3, Fig. 6).

The search space is the (block_m, block_k) pairs the CUDA kernels are
instantiated for, per input type (``INSTANTIATED_BLOCKS``; csrc/*.cu
dispatch on exactly these) that fit the 227 KB of shared memory a Hopper
block may use.  Two tensor-core mainloops sit behind them, with their own
footprint and cost: fp32 syrk, symmul and gram_poly run 3xTF32
(csrc/tf32_lower.cuh), bf16 inputs one bf16 wgmma pass fed by a producer
warp (csrc/bf16_lower.cuh).  Either way block_k is one 128-byte swizzle row
of the input type (``slice_k``).

Two backends:
  * ``analytical`` — padded lower-tile work times the mainloop's per-tile
    overhead (``analytical_score``); runs anywhere, including the CPU, so
    ``prewarm_plan``, ``lookup`` and ``cached_entry`` work without a
    card.
  * ``measured``   — times the public op on the card with CUDA events.

Cache entries are keyed by (arch, digest, mode, m, k, dtype), where arch
is the device capability (``sm90``) or ``cpu`` and digest hashes the kernel
sources, nvcc flags and this module (``rule_digest``): a winner chosen for
other kernels or by another rule is never returned.  The cache file is the
port's own, ``build/repro_torch/autotune.json`` in the checkout
(``CACHE_PATH``): winners tuned for the TPU by the reference package never
leak in.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

# (block_m, block_k) pairs the CUDA kernels are compiled for, by the bytes
# of an input element: fp32 (3xTF32) and bf16 (bf16 wgmma).
INSTANTIATED_BLOCKS = {4: ((64, 32), (128, 32)), 2: ((128, 64), (192, 64))}
SMEM_BYTES = 232_448            # dynamic shared memory a Hopper block may use
SMS = 132                       # streaming multiprocessors of an H100 SXM
BF16_STAGES = {128: 6, 192: 4}  # csrc/bf16_lower.cuh's Bf16Cfg<bm>: ring stages
# bf16 time a product of a tile on a grid that fills the card, against the
# 192-row tile's (exact in binary): 128-row tiles read 1.5x the operand
# bytes a product, and took 1.35-2.4x the time at nemotron-4-340b's
# m = 18432 (chip_smoke.py's blocks phase on an H100, PERF.md §6)
BF16_TILE_COST = {128: 1.5, 192: 1.0}

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


@functools.lru_cache(maxsize=None)
def rule_digest() -> str:
    """Hash of the kernel sources, the nvcc flags and this module's scoring
    rule."""
    from repro_torch.kernels import build
    h = hashlib.sha256(build.sources_digest().encode())
    h.update(Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def _key(arch: str, mode: str, m: int, k: int, dtype: str) -> str:
    return f"{arch}:{rule_digest()}:{mode}:{m}x{k}:{dtype}"


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


def slice_k(dtype_bytes: int) -> int:
    """The kernels' block_k: one 128-byte swizzle row of the input type."""
    return 128 // dtype_bytes


def tensor_core_path(mode: str, dtype_bytes: int) -> bool:
    """syrk, symmul and gram_poly run on the tensor cores in both input
    types: 3xTF32 for fp32, one bf16 wgmma pass for bf16."""
    return mode in ("syrk", "symmul", "gram_poly") and dtype_bytes in (2, 4)


def smem_bytes(mode: str, bm: int, bk: int, dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one block (the same for syrk, symmul and
    gram_poly).

    * fp32 (csrc/tf32_lower.cuh, ``Tf32Cfg``): a ring of raw A and B
      slices (3 stages at bm = 128, 2 at bm = 64), one split buffer
      {B big, B small} (A's split stays in registers), one mbarrier a stage
      and 1 KB of alignment slack;
    * bf16 (csrc/bf16_lower.cuh, ``Bf16Cfg``): a ring of A and B slices
      (``BF16_STAGES``: 6 at bm = 128, 4 at 192), a full and an empty
      mbarrier a stage and 1 KB of alignment slack.
    """
    tile = bm * bk * dtype_bytes
    if dtype_bytes == 2:
        stages = BF16_STAGES[bm]
        return stages * 2 * tile + 2 * stages * 8 + 1024
    stages = 3 if bm == 128 else 2
    return stages * 2 * tile + 2 * tile + stages * 8 + 1024


def candidate_blocks(mode: str, m: int, k: int, dtype_bytes: int = 4
                     ) -> Iterable[tuple[int, int]]:
    """Instantiated (block_m, block_k) pairs of the input type whose
    ``mode`` mainloop fits a block's shared memory."""
    return [(bm, bk) for bm, bk in INSTANTIATED_BLOCKS[dtype_bytes]
            if smem_bytes(mode, bm, bk, dtype_bytes) <= SMEM_BYTES]


def analytical_score(mode: str, bm: int, bk: int, m: int, k: int,
                     dtype_bytes: int = 4) -> float:
    """Lower is better: padded work times the mainloop's cost a product.

    * padded work — the lower tiles of a ceil(m/bm)-block grid over
      ceil(k/bk) slices, relative to the m(m+1)/2 · k products needed;
    * fp32 (3xTF32) — no other factor: a 64-row block leaves room for four
      blocks an SM, whose splits and products overlap, so the larger tile
      saves nothing per product;
    * bf16 (one block an SM) — the tile's cost a product on a full card
      (``BF16_TILE_COST``), times the share of the card one matrix's lower
      tiles leave idle when they are fewer than its ``SMS`` SMs.

    The factors are exact in binary or equal for equal grids, so equal
    scores compare equal; a tie goes to the smaller tile in fp32 (more
    blocks an SM overlap, and 128×32 never won there on the card) and to
    the larger in bf16.  On the slice's shapes the rule picks the measured
    winners of chip_smoke.py's blocks phase on an H100: 64×32 for every
    fp32 product (syrk, symmul, gram_poly) at m = 960 and m = 320, since
    960 = 15 · 64 while the 128-row grid pads 20% more work (60% at
    m = 320); in bf16 192×64 at nemotron-4-340b's m = 18432 and 128×64 at
    its m = 1536 (36 tiles of 192 rows against 78 of 128).
    """
    nb = -(-m // bm)
    nk = -(-k // bk)
    tiles = nb * (nb + 1) // 2
    padded = tiles * bm * bm * nk * bk
    cost = 1.0
    if dtype_bytes == 2:
        cost = BF16_TILE_COST[bm] * max(1.0, SMS / tiles)
    return padded * cost / (m * (m + 1) / 2.0 * k)


def tie_break(mode: str, block: tuple[int, int], dtype_bytes: int = 4) -> int:
    """Second sort key of equal scores: smaller tile first in fp32, larger
    first in bf16 (see ``analytical_score``)."""
    return -block[0] if dtype_bytes == 2 else block[0]


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
    for bm, bk in candidate_blocks(mode, m, k, dtype_bytes):
        if backend == "analytical":
            scores[bm, bk] = analytical_score(mode, bm, bk, m, k, dtype_bytes)
        elif backend == "measured":
            scores[bm, bk] = measure_cuda(mode, bm, bk, m, k, dtype, batch)
        else:
            raise ValueError(f"unknown autotune backend {backend!r}")
    best = min(scores,
               key=lambda b: (scores[b], tie_break(mode, b, dtype_bytes)))

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


def plan_shapes(plan, gram_dim: Optional[Callable[[int], int]] = None
                ) -> list[tuple[str, int, int]]:
    """Every (mode, m, k) kernel launch a dedication plan can produce: one
    SYRK per group shape, ``gram_poly`` and ``symmul`` per Gram dim.  The
    Gram dim of an (m, n) group is m, or ``gram_dim(m)`` for a variant that
    orthogonalizes a smaller factor (Dion2's r×n)."""
    shapes: set[tuple[str, int, int]] = set()
    for g in plan.groups.values():
        m, n = g.key
        if gram_dim is not None:
            m = gram_dim(m)
        shapes.add(("syrk", m, n))
        shapes.add(("gram_poly", m, m))
        shapes.add(("symmul", m, m))
    return sorted(shapes)


def prewarm_plan(plan, *, dtypes=("float32",), backend: str = "analytical",
                 cache_path: Optional[str] = None, arch: str = "cpu",
                 gram_dim: Optional[Callable[[int], int]] = None) -> int:
    """Pre-warm the cache for every kernel shape of a dedication plan
    (``plan_shapes``), once, at optimizer construction; cached shapes are
    skipped.  Returns the number of entries covered (hit or newly tuned)."""
    n = 0
    for dt in dtypes:
        for mode, m, k in plan_shapes(plan, gram_dim):
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
