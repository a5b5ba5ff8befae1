"""Parameter dedication (port of ``repro.core.dedication``): classify, group,
bucket and assign owners (§3.1/3.4/§4).

``dedicate_params`` is the planning half of the paper's three-line API.  It
walks the parameter pytree once at init and produces a ``DedicationPlan``:

* **classification** — 2-D hidden weight matrices (including scan-stacked
  ``(L, m, n)`` and MoE ``(L, E, m, n)`` leaves, which carry one matrix per
  leading index) take the Muon path; embeddings, heads, norms, biases,
  routers, convs and other <2-D leaves take AdamW through the host stack
  (paper line 16 of Alg. 1).
* **shape groups** — matrices grouped by post-transpose ``(m, n)`` (m ≤ n),
  the granularity at which costs are measured and batched kernels launch.
* **owner assignment** — the measured-cost MILP / greedy / ablation
  strategies of core/load_balance.py, one owner slot per matrix.
* **owner-major packed layout** — per group, an index permutation realizing
  the assignment as a capacity-padded stacked array ``(D·cap, m, n)``;
  position p belongs to owner ``p // cap``, so owner r holds and updates
  exactly the matrices assigned to owner slot r.
* **Gram buckets** — groups with equal Gram dimension m are fused for the
  m×m iteration phase (the paper's shape-batched NS execution), maximizing
  the batch the symmetric kernels see.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import load_balance, tree
from repro_torch.core.load_balance import Assignment, CostModel, ShapeKey

# Name fragments excluded from the Muon path by default (AdamW instead).
DEFAULT_EXCLUDE = ("embed", "unembed", "head", "norm", "bias", "router",
                   "gate_w", "conv", "a_log", "dt_bias", "skip", "pos_enc",
                   "patch", "frame")
MIN_MATRIX_DIM = 8


def default_muon_predicate(path: str, shape: Tuple[int, ...],
                           exclude: Sequence[str] = DEFAULT_EXCLUDE) -> bool:
    """True if the leaf at ``path`` should be optimized by Muon."""
    if len(shape) < 2:
        return False
    if min(shape[-2:]) < MIN_MATRIX_DIM:
        return False
    low = path.lower()
    return not any(pat in low for pat in exclude)


@dataclass
class LeafInfo:
    path: str
    shape: Tuple[int, ...]          # full leaf shape
    count: int                      # matrices in the leaf (prod of lead dims)
    transpose: bool                 # True if matrices were transposed to m<=n
    group: ShapeKey                 # post-transpose (m, n)
    offset: int                     # start position in the group's flat order


@dataclass
class GroupPlan:
    key: ShapeKey                   # (m, n), m <= n
    leaf_paths: List[str]           # deterministic member order (schedule order)
    count: int
    owner_of: np.ndarray            # (count,)
    capacity: int                   # max matrices per owner (padding target)
    pack_index: np.ndarray          # (D*cap,) flat member index or -1 = pad
    unpack_index: np.ndarray        # (count,) position of member in packed stack

    @property
    def packed_size(self) -> int:
        return len(self.pack_index)


# NOTE on group granularity: execution groups are PER LEAF (one stacked
# (L[,E],m,n) parameter each).  Merging same-shape leaves into one packed
# stack looks tempting (bigger NS batches) but the per-leaf sections of the
# merged stack are not aligned with the owner segments, so unpacking them
# would move whole tensors between owners.  The *census* handed to
# the load balancer still aggregates by (m, n) across leaves — costs are
# shape-keyed (§3.4) — and leaves of equal Gram dim remain fusable in the
# iteration phase (bucket metadata).


@dataclass
class DedicationPlan:
    num_owners: int
    mesh_rows: int                  # slower owner axis extent (node analogue)
    mesh_cols: int                  # faster owner axis extent (column analogue)
    leaves: Dict[str, LeafInfo]
    adamw_paths: List[str]
    groups: Dict[str, GroupPlan]            # keyed by leaf path
    buckets: Dict[int, List[str]]           # gram-dim m -> group keys
    assignment: Assignment
    strategy: str
    cost_model: Optional[CostModel] = None
    owner_axes: Tuple[str, ...] = ()        # mesh axes the stack axis shards over
    stats: dict = field(default_factory=dict)

    def group_of(self, path: str) -> GroupPlan:
        return self.groups[path]


def _flatten_paths(params) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf of a nested dict of tensors or arrays, or of
    an ``nn.Module``'s ``named_parameters()``, in ``jax.tree_util`` order
    (dict keys sorted at every level).  Only ``.shape`` is read, so
    ``device="meta"`` tensors plan a model without allocating it."""
    return [(path, tuple(leaf.shape)) for path, leaf in tree.flatten(params)]


def dedicate_params(
    params,
    *,
    num_owners: int,
    mesh_rows: Optional[int] = None,
    mesh_cols: Optional[int] = None,
    strategy: str = "load_balance",
    predicate: Callable[[str, Tuple[int, ...]], bool] = default_muon_predicate,
    cost_model: Optional[CostModel] = None,
    cost_backend: str = "analytic",     # 'analytic' | 'measured'
    speed: Optional[np.ndarray] = None,
    owner_axes: Tuple[str, ...] = (),
    s_thr: int = load_balance.DEFAULT_S_THR,
    xor_order: bool = True,
    physical_layout: str = "contiguous",   # 'contiguous' | 'assignment'
) -> DedicationPlan:
    """Build the dedication plan (paper: ``dmuon.dedicate_params(model, mesh)``).

    ``params`` may be a nested dict of tensors (``device="meta"`` plans
    without allocating) or arrays, or an ``nn.Module``.  ``num_owners`` is the flattened owner
    mesh size; ``mesh_rows × mesh_cols`` factorize it for the XOR layout
    (defaults: rows = num_owners // cols heuristic).
    """
    if mesh_cols is None:
        mesh_cols = min(num_owners, 8 if num_owners % 8 == 0 else num_owners)
    if mesh_rows is None:
        mesh_rows = num_owners // mesh_cols
    assert mesh_rows * mesh_cols == num_owners, (mesh_rows, mesh_cols, num_owners)

    leaves: Dict[str, LeafInfo] = {}
    adamw_paths: List[str] = []
    group_members: Dict[ShapeKey, List[str]] = {}
    group_offsets: Dict[ShapeKey, int] = {}

    for path, shape in _flatten_paths(params):
        if not predicate(path, shape):
            adamw_paths.append(path)
            continue
        m0, n0 = shape[-2:]
        transpose = m0 > n0
        key: ShapeKey = (min(m0, n0), max(m0, n0))
        count = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        off = group_offsets.get(key, 0)
        leaves[path] = LeafInfo(path, shape, count, transpose, key, off)
        group_offsets[key] = off + count
        group_members.setdefault(key, []).append(path)

    shape_counts = {k: group_offsets[k] for k in group_members}

    if cost_model is None and strategy in ("load_balance", "greedy", "lpt"):
        if cost_backend == "measured":
            cost_model = load_balance.measured_cost_model(shape_counts)
        else:
            cost_model = load_balance.analytic_cost_model(shape_counts)

    assignment = load_balance.assign(
        shape_counts, num_owners, strategy=strategy, cost_model=cost_model,
        speed=speed, rows=mesh_rows, cols=mesh_cols, s_thr=s_thr)

    if xor_order and strategy not in ("xor", "rank0"):
        # Relabel owner ids through the XOR slot map (Eq. 3): the balancing
        # strategies fill owners in index order, so consecutive matrices tend
        # to land on consecutively-numbered owners; the relabeling spreads
        # those over distinct mesh columns / rotated rows, which is exactly
        # the contention-avoidance of the paper's fine-grained layout.
        # Makespan is invariant under owner relabeling.
        from repro_torch.core.layout import owner_slot
        perm = np.asarray([owner_slot(r, mesh_rows, mesh_cols)
                           for r in range(num_owners)])
        if len(set(perm.tolist())) == num_owners:   # bijective only if R | C
            assignment = Assignment(
                num_owners,
                {k: perm[v] for k, v in assignment.owner_of.items()},
                {k: [(b, int(perm[r])) for b, r in v]
                 for k, v in assignment.chunks.items()},
                strategy=assignment.strategy + "+xor")

    groups: Dict[str, GroupPlan] = {}
    for path, info in leaves.items():
        key = info.group
        count = info.count
        if physical_layout == "contiguous":
            # Within a shape group every matrix has the same cost, so
            # balanced *contiguous* blocks are exactly as optimal as any
            # permuted assignment, and the pack is a pad instead of a gather.
            # The strategy's assignment is kept as *logical* metadata.
            capacity = max(1, -(-count // num_owners))
            pack_index = np.full(num_owners * capacity, -1, dtype=np.int64)
            pack_index[:count] = np.arange(count)
            unpack_index = np.arange(count, dtype=np.int64)
            owner_of = np.arange(count) // capacity
        else:
            owner_of = assignment.owner_of[key][info.offset:
                                                info.offset + count]
            counts_per_owner = np.bincount(owner_of, minlength=num_owners)
            capacity = max(1, int(counts_per_owner.max()))
            pack_index = np.full(num_owners * capacity, -1, dtype=np.int64)
            unpack_index = np.zeros(count, dtype=np.int64)
            cursor = np.zeros(num_owners, dtype=np.int64)
            for w in range(count):  # schedule order within owner segments
                r = owner_of[w]
                pos = r * capacity + cursor[r]
                cursor[r] += 1
                pack_index[pos] = w
                unpack_index[w] = pos
        groups[path] = GroupPlan(key, [path], count, owner_of, capacity,
                                 pack_index, unpack_index)

    buckets: Dict[int, List[str]] = {}
    for path in sorted(groups):
        buckets.setdefault(groups[path].key[0], []).append(path)

    total = sum(shape_counts.values())
    padded = sum(g.packed_size for g in groups.values())
    plan = DedicationPlan(
        num_owners=num_owners, mesh_rows=mesh_rows, mesh_cols=mesh_cols,
        leaves=leaves, adamw_paths=adamw_paths, groups=groups,
        buckets=buckets, assignment=assignment, strategy=assignment.strategy,
        cost_model=cost_model, owner_axes=tuple(owner_axes),
        stats={
            "num_matrices": total,
            "num_groups": len(groups),
            "num_buckets": len(buckets),
            "padded_matrices": padded,
            "padding_waste": (padded - total) / max(total, 1),
            "num_adamw_leaves": len(adamw_paths),
        })
    return plan
