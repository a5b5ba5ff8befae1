"""Computation-aware load balancing (port of ``repro.core.load_balance``;
paper §3.4).

Owner assignment is driven by a *measured* execution-cost model: parameters
are grouped by shape, each shape s has a candidate set of batch sizes B_s, and
``c_{s,b}`` is the measured (``measured_cost_model``: timed on the card with
CUDA events) or analytically modelled time of one owner-local batched Muon
update.  Assignment is the MILP of Eq. 5:

    min  max_r Σ_{s,b} c_{s,b} · x_{s,b,r}
    s.t. Σ_{r,b} b · x_{s,b,r} = n_s            ∀s
         x_{s,b,r} ∈ Z≥0

solved once at init with SciPy's MILP; above a search-space threshold
``s_thr`` we fall back to a greedy assignment (paper: "bounded, predictable
initialization cost at large scale").  ``round_robin`` / ``rank0`` / ``lpt``
are kept as ablation handles (paper §4 "Ownership strategy plug-in").

Heterogeneity: every solver accepts per-owner ``speed`` factors (measured
step-time drift), which is how the straggler-mitigation hook re-balances a
degraded rank (runtime/elastic.py) — effective cost on owner r is c/speed_r.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ShapeKey = Tuple[int, int]          # (m, n) with m <= n (post-transpose)
DEFAULT_BATCH_SIZES = (1, 2, 4, 8, 16)
DEFAULT_S_THR = 4096                # max MILP decision variables (paper S_thr)


# --------------------------------------------------------------------------
# Cost models
# --------------------------------------------------------------------------

@dataclass
class CostModel:
    """c_{s,b}: cost (seconds) of one batch of shape s at batch size b."""
    costs: Dict[ShapeKey, Dict[int, float]] = field(default_factory=dict)

    def cost(self, shape: ShapeKey, batch: int) -> float:
        by_b = self.costs[shape]
        if batch in by_b:
            return by_b[batch]
        # interpolate: per-matrix cost of the nearest measured batch size
        bs = min(by_b, key=lambda b: abs(b - batch))
        return by_b[bs] / bs * batch

    def batch_sizes(self, shape: ShapeKey) -> List[int]:
        return sorted(self.costs[shape])

    def per_matrix(self, shape: ShapeKey) -> float:
        """Best achievable per-matrix cost over batch sizes."""
        by_b = self.costs[shape]
        return min(c / b for b, c in by_b.items())


# Rates of the reference's analytic model (its modelled TPU v5e chip), kept
# as they are so the port's analytic plans equal the reference's key for key.
# They only rank shapes against each other; they are not rates of an H100
# (``measured_cost_model`` times the port's own kernels on the card).
PEAK_FLOPS = 197e12        # FLOP/s
HBM_BW = 819e9             # bytes/s
DISPATCH_OVERHEAD = 2e-6   # per kernel launch, amortized by batching


def analytic_cost_model(
    shapes: Dict[ShapeKey, int],
    batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
    *,
    ns_steps: int = 5,
    dtype_bytes: int = 4,
    symmetric_kernels: bool = True,
) -> CostModel:
    """Roofline cost of one batched Gram-NS update per (shape, batch).

    Mirrors the paper's observation that runtime depends on shape, batch size
    and kernel selection: small matrices are dispatch/memory bound and batch
    well (Fig. 7); large ones are compute bound and gain little.
    """
    from repro_torch.core.gram_ns import gram_ns_flops
    cm = CostModel()
    for (m, n), _count in shapes.items():
        by_b: Dict[int, float] = {}
        for b in batch_sizes:
            fl = gram_ns_flops(m, n, ns_steps, batch=b,
                               symmetric_kernels=symmetric_kernels)
            flops = fl["gram_symmetric_kernel" if symmetric_kernels
                       else "gram_full_gemm"]
            # bytes: X in/out + Gram-space working set per step
            bytes_moved = b * dtype_bytes * (
                2 * m * n + (4 * ns_steps - 3) * 3 * m * m)
            t = max(flops / PEAK_FLOPS, bytes_moved / HBM_BW)
            # dispatch overhead: one launch per NS product for the whole batch
            t += DISPATCH_OVERHEAD * (4 * ns_steps - 1)
            by_b[b] = t
        cm.costs[(m, n)] = by_b
    return cm


def measured_cost_model(
    shapes: Dict[ShapeKey, int],
    batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
    *,
    ns_cfg=None,
    repeats: int = 2,
    device=None,
) -> CostModel:
    """Benchmark the complete owner-local execution path per (shape, batch).

    Times the port's batched Gram NS exactly as the optimizer runs it
    (kernels, batching, autotuned blocks): with CUDA events on a card, with
    the wall clock on the CPU.  ``device`` defaults to CUDA.
    """
    import time

    import torch

    from repro_torch.core.gram_ns import GramNSConfig, gram_newton_schulz
    from repro_torch.device import resolve_device
    ns_cfg = ns_cfg or GramNSConfig()
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(0)
    cm = CostModel()
    for (m, n), _count in shapes.items():
        by_b: Dict[int, float] = {}
        for b in batch_sizes:
            x = torch.randn(b, m, n, generator=gen, device=device)
            gram_newton_schulz(x, ns_cfg, assume_short_fat=True)   # warm-up
            best = float("inf")
            for _ in range(repeats):
                if device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    gram_newton_schulz(x, ns_cfg, assume_short_fat=True)
                    end.record()
                    end.synchronize()
                    secs = start.elapsed_time(end) / 1e3
                else:
                    t0 = time.perf_counter()
                    gram_newton_schulz(x, ns_cfg, assume_short_fat=True)
                    secs = time.perf_counter() - t0
                best = min(best, secs)
            by_b[b] = best
        cm.costs[(m, n)] = by_b
    return cm


# --------------------------------------------------------------------------
# Assignment result
# --------------------------------------------------------------------------

@dataclass
class Assignment:
    """Owner of every matrix of every shape group, plus the chunking used."""
    num_owners: int
    owner_of: Dict[ShapeKey, np.ndarray]               # (n_s,) int owner ids
    chunks: Dict[ShapeKey, List[Tuple[int, int]]]      # (batch_size, owner)
    strategy: str = ""

    def loads(self, cm: CostModel,
              speed: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-owner predicted time under cost model ``cm``."""
        loads = np.zeros(self.num_owners)
        for shape, chunk_list in self.chunks.items():
            for b, r in chunk_list:
                loads[r] += cm.cost(shape, b)
        if speed is not None:
            loads = loads / np.asarray(speed)
        return loads

    def makespan(self, cm: CostModel,
                 speed: Optional[np.ndarray] = None) -> float:
        return float(self.loads(cm, speed).max())

    def counts(self) -> Dict[ShapeKey, np.ndarray]:
        """Matrices per owner per shape (drives SPMD capacity padding)."""
        out = {}
        for shape, owners in self.owner_of.items():
            out[shape] = np.bincount(owners, minlength=self.num_owners)
        return out


def _expand_owner_of(shape_counts, chunks) -> Dict[ShapeKey, np.ndarray]:
    owner_of = {}
    for shape, n in shape_counts.items():
        ids = []
        for b, r in chunks[shape]:
            ids.extend([r] * b)
        assert len(ids) == n, (shape, len(ids), n)
        owner_of[shape] = np.asarray(ids, dtype=np.int64)
    return owner_of


# --------------------------------------------------------------------------
# Strategies
# --------------------------------------------------------------------------

def solve_milp(
    shape_counts: Dict[ShapeKey, int],
    cost_model: CostModel,
    num_owners: int,
    *,
    speed: Optional[np.ndarray] = None,
    s_thr: int = DEFAULT_S_THR,
    time_limit: float = 10.0,
) -> Assignment:
    """Exact Eq. 5 via SciPy MILP; greedy fallback above ``s_thr`` variables."""
    from scipy import optimize, sparse

    shapes = list(shape_counts)
    var_index: List[Tuple[ShapeKey, int, int]] = []   # (shape, b, r)
    for s in shapes:
        for b in cost_model.batch_sizes(s):
            for r in range(num_owners):
                var_index.append((s, b, r))
    nvar = len(var_index)
    if nvar > s_thr:
        return solve_greedy(shape_counts, cost_model, num_owners, speed=speed)

    spd = np.ones(num_owners) if speed is None else np.asarray(speed, float)
    # variables: x (nvar) + t (1); objective: minimize t
    c_obj = np.zeros(nvar + 1)
    c_obj[-1] = 1.0

    rows, cols, vals = [], [], []
    b_ub = []
    # load constraints: Σ c_{s,b}/spd_r · x_{s,b,r} − t ≤ 0   ∀r
    for r in range(num_owners):
        for vi, (s, b, rr) in enumerate(var_index):
            if rr == r:
                rows.append(r)
                cols.append(vi)
                vals.append(cost_model.cost(s, b) / spd[r])
        rows.append(r)
        cols.append(nvar)
        vals.append(-1.0)
        b_ub.append(0.0)
    a_ub = sparse.csr_matrix((vals, (rows, cols)),
                             shape=(num_owners, nvar + 1))

    rows, cols, vals = [], [], []
    b_eq = []
    # coverage: Σ_{r,b} b · x_{s,b,r} = n_s   ∀s
    for si, s in enumerate(shapes):
        for vi, (ss, b, r) in enumerate(var_index):
            if ss == s:
                rows.append(si)
                cols.append(vi)
                vals.append(float(b))
        b_eq.append(float(shape_counts[s]))
    a_eq = sparse.csr_matrix((vals, (rows, cols)),
                             shape=(len(shapes), nvar + 1))

    constraints = [
        optimize.LinearConstraint(a_ub, -np.inf, np.asarray(b_ub)),
        optimize.LinearConstraint(a_eq, np.asarray(b_eq), np.asarray(b_eq)),
    ]
    integrality = np.concatenate([np.ones(nvar), [0.0]])
    bounds = optimize.Bounds(np.zeros(nvar + 1), np.full(nvar + 1, np.inf))
    # A 2% MIP gap + time limit keeps the one-time solve bounded (paper:
    # "bounded, predictable initialization cost"); accept the incumbent even
    # when optimality was not proven within the limit.
    res = optimize.milp(c_obj, constraints=constraints,
                        integrality=integrality, bounds=bounds,
                        options={"time_limit": time_limit,
                                 "mip_rel_gap": 0.02})
    if res.x is None:
        return solve_greedy(shape_counts, cost_model, num_owners, speed=speed)

    x = np.round(res.x[:nvar]).astype(int)
    chunks: Dict[ShapeKey, List[Tuple[int, int]]] = {s: [] for s in shapes}
    remaining = dict(shape_counts)
    loads = np.zeros(num_owners)
    for vi, (s, b, r) in enumerate(var_index):
        for _ in range(x[vi]):
            take = min(b, remaining[s])
            if take > 0:
                chunks[s].append((take, r))
                remaining[s] -= take
                loads[r] += cost_model.cost(s, take) / spd[r]
    # numerical slack from rounding: top up any remainder onto the least
    # loaded owner
    for s in shapes:
        while remaining[s] > 0:
            r = int(np.argmin(loads))
            chunks[s].append((1, r))
            remaining[s] -= 1
            loads[r] += cost_model.cost(s, 1) / spd[r]

    asn = Assignment(num_owners, _expand_owner_of(shape_counts, chunks),
                     chunks, strategy="milp")
    return asn


def solve_greedy(
    shape_counts: Dict[ShapeKey, int],
    cost_model: CostModel,
    num_owners: int,
    *,
    speed: Optional[np.ndarray] = None,
) -> Assignment:
    """Greedy fallback (paper: used when MILP search space exceeds S_thr).

    For each shape pick the most batch-efficient chunk size, then assign
    chunks to the least-loaded owner, largest-cost shapes first (LPT over
    measured chunk costs).
    """
    spd = np.ones(num_owners) if speed is None else np.asarray(speed, float)
    # order shapes by total best-case work, largest first
    order = sorted(shape_counts,
                   key=lambda s: -cost_model.per_matrix(s) * shape_counts[s])
    heap = [(0.0, r) for r in range(num_owners)]
    heapq.heapify(heap)
    chunks: Dict[ShapeKey, List[Tuple[int, int]]] = {s: [] for s in shape_counts}
    for s in order:
        by_b = {b: cost_model.cost(s, b) for b in cost_model.batch_sizes(s)}
        b_star = min(by_b, key=lambda b: by_b[b] / b)   # best per-matrix cost
        n = shape_counts[s]
        # Batching efficiency vs balance granularity: cap the chunk size so
        # every owner can participate in this shape's work (the measured-cost
        # analogue of even spreading), but never below 1.  Under heterogeneous
        # owner speeds (straggler rebalancing) halve the granularity again so
        # a slow owner can actually shed load.
        denom = num_owners if (speed is None or np.ptp(spd) == 0) \
            else 2 * num_owners
        b_eff = max(1, min(b_star, -(-n // denom)))
        while n > 0:
            take = min(b_eff, n)
            load, r = heapq.heappop(heap)
            chunks[s].append((take, r))
            heapq.heappush(heap, (load + cost_model.cost(s, take) / spd[r], r))
            n -= take
    return Assignment(num_owners, _expand_owner_of(shape_counts, chunks),
                      chunks, strategy="greedy")


def solve_lpt(
    shape_counts: Dict[ShapeKey, int],
    cost_model: CostModel,
    num_owners: int,
    *,
    speed: Optional[np.ndarray] = None,
) -> Assignment:
    """Classic Longest-Processing-Time at single-matrix granularity —
    the analytical baseline the paper contrasts with (no batching effects)."""
    spd = np.ones(num_owners) if speed is None else np.asarray(speed, float)
    items = []
    for s, n in shape_counts.items():
        c = cost_model.cost(s, 1)
        items.extend([(c, s)] * n)
    items.sort(key=lambda t: -t[0])
    heap = [(0.0, r) for r in range(num_owners)]
    heapq.heapify(heap)
    chunks: Dict[ShapeKey, List[Tuple[int, int]]] = {s: [] for s in shape_counts}
    for c, s in items:
        load, r = heapq.heappop(heap)
        chunks[s].append((1, r))
        heapq.heappush(heap, (load + c / spd[r], r))
    return Assignment(num_owners, _expand_owner_of(shape_counts, chunks),
                      chunks, strategy="lpt")


def round_robin(shape_counts: Dict[ShapeKey, int],
                num_owners: int) -> Assignment:
    """Naive round-robin (ablation handle)."""
    chunks: Dict[ShapeKey, List[Tuple[int, int]]] = {}
    w = 0
    for s, n in shape_counts.items():
        chunks[s] = [(1, (w + i) % num_owners) for i in range(n)]
        w += n
    return Assignment(num_owners, _expand_owner_of(shape_counts, chunks),
                      chunks, strategy="round_robin")


def rank0(shape_counts: Dict[ShapeKey, int], num_owners: int) -> Assignment:
    """All matrices on owner 0 (ablation: load balancing removed entirely)."""
    chunks = {s: [(n, 0)] if n else [] for s, n in shape_counts.items()}
    owner_of = {s: np.zeros(n, dtype=np.int64) for s, n in shape_counts.items()}
    return Assignment(num_owners, owner_of, chunks, strategy="rank0")


def xor_layout(shape_counts: Dict[ShapeKey, int], num_owners: int, *,
               rows: int, cols: int) -> Assignment:
    """Owner = XOR fine-grained slot of the matrix's schedule index (Eq. 3)."""
    from repro_torch.core.layout import owner_slot
    assert rows * cols == num_owners
    chunks: Dict[ShapeKey, List[Tuple[int, int]]] = {}
    w = 0
    for s, n in shape_counts.items():
        chunks[s] = [(1, owner_slot(w + i, rows, cols)) for i in range(n)]
        w += n
    return Assignment(num_owners, _expand_owner_of(shape_counts, chunks),
                      chunks, strategy="xor")


STRATEGIES = {
    "load_balance": solve_milp,
    "greedy": solve_greedy,
    "lpt": solve_lpt,
}


def assign(
    shape_counts: Dict[ShapeKey, int],
    num_owners: int,
    *,
    strategy: str = "load_balance",
    cost_model: Optional[CostModel] = None,
    speed: Optional[np.ndarray] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
    s_thr: int = DEFAULT_S_THR,
) -> Assignment:
    """Front door used by dedicate_params."""
    if strategy == "round_robin":
        return round_robin(shape_counts, num_owners)
    if strategy == "rank0":
        return rank0(shape_counts, num_owners)
    if strategy == "xor":
        return xor_layout(shape_counts, num_owners,
                          rows=rows or 1, cols=cols or num_owners)
    cm = cost_model or analytic_cost_model(shape_counts)
    if strategy == "load_balance":
        return solve_milp(shape_counts, cm, num_owners, speed=speed,
                          s_thr=s_thr)
    if strategy in STRATEGIES:
        return STRATEGIES[strategy](shape_counts, cm, num_owners, speed=speed)
    raise ValueError(f"unknown ownership strategy {strategy!r}")
