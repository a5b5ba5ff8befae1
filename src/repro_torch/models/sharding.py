"""Partitioning rules (port of ``repro.models.sharding``): parameter specs
and the batch spec.

Megatron-style tensor parallelism over the 'model' axis (column-parallel
in-projections, row-parallel out-projections), expert parallelism for MoE
experts, vocab-sharded embeddings, optional ZeRO-3 sharding over the
data-parallel axes.  Every rule is divisibility-guarded: a dim that does
not divide the axis extent stays unsharded.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim split over them, the first
one major), as the reference's ``PartitionSpec``.  ``placements`` turns a
spec into the ``DTensor`` placements of a ``DeviceMesh``, and ``place`` a
tree by a spec table.  The mesh is a ``DeviceMesh`` or any object with
``mesh_dim_names`` and a ``shape`` tuple (the rules read shapes only).  ``input_shardings`` and ``cache_specs`` wait
for serving (ROADMAP item 10).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.core import tree
from repro_torch.launch.mesh import axis_sizes

# last-name-component classification
_OUT_SHARDED = {"q_proj", "k_proj", "v_proj", "up_proj", "gate_proj",
                "in_proj", "dt_proj", "w_proj", "r_proj", "fc1",
                "q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj"}
_IN_SHARDED = {"o_proj", "down_proj", "out_proj", "fc2"}

Spec = Tuple


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _guard(mesh, dim: int, axes):
    """axes if dim divides their extent, else None (stay replicated)."""
    if axes is None:
        return None
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def param_specs(cfg, params_tree, mesh, *, zero3: bool = False
                ) -> Dict[str, Spec]:
    """{path: spec} for every leaf of ``params_tree`` (anything with
    ``.shape`` leaves, ``device="meta"`` tensors included)."""
    zaxis = "data" if (zero3 and "data" in mesh.mesh_dim_names) else None

    def spec_for(path: str, shape) -> Spec:
        parts = path.split("/")
        name = parts[-2] if parts[-1] in ("w", "b") else parts[-1]
        rank = len(shape)
        lead = lambda k: (None,) * (rank - k)  # noqa: E731

        if parts[-1] == "b":  # bias (..., out)
            return lead(1) + (_guard(mesh, shape[-1], "model"),)
        if name == "embedding":
            return lead(2) + (_guard(mesh, shape[-2], "model"), None)
        if "experts" in parts:  # (L, E, din, dout): EP over 'model'
            if name in _IN_SHARDED:      # down_proj (L, E, dff, d)
                return lead(3) + (_guard(mesh, shape[-3], "model"),
                                  _guard(mesh, shape[-2], zaxis), None)
            return lead(3) + (_guard(mesh, shape[-3], "model"),  # gate/up
                              None, _guard(mesh, shape[-1], zaxis))
        if name in ("router_w", "conv_w", "dt_bias", "d_skip", "gate_bias",
                    "if_gate_bias"):
            return lead(1) + (_guard(mesh, shape[-1], "model"),)
        if name == "a_log":   # (L, di, ds)
            return lead(2) + (_guard(mesh, shape[-2], "model"), None)
        if name in _OUT_SHARDED and parts[-1] == "w":
            return lead(2) + (_guard(mesh, shape[-2], zaxis),
                              _guard(mesh, shape[-1], "model"))
        if name in _IN_SHARDED and parts[-1] == "w":
            return lead(2) + (_guard(mesh, shape[-2], "model"),
                              _guard(mesh, shape[-1], zaxis))
        return lead(0)  # norms, scalars, small gates

    return {p: spec_for(p, tuple(v.shape))
            for p, v in tree.flatten(params_tree)}


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Tuple[str, ...]):
    # one axis is written as its name, as PartitionSpec normalizes it
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh, batch: int) -> Spec:
    axes = dp_axes(mesh)
    if axes and batch % _axis_size(mesh, axes) == 0:
        return (_entry(axes),)
    if "data" in mesh.mesh_dim_names and \
            batch % axis_sizes(mesh)["data"] == 0:
        return ("data",)
    return (None,)


def placements(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on the
    mesh dims that split tensor dim ``d``, ``Replicate()`` on the rest.
    A dim split over several axes takes them in mesh order (the first
    named is major), the only order ``DTensor`` shards in."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        names = entry_axes(entry)
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {names} of dim {d} are not "
                             f"in mesh order {mesh.mesh_dim_names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def shard_of(x, spec: Spec, mesh):
    """``x`` (the same full tensor on every rank) as a ``DTensor`` placed
    by ``spec``: each rank keeps its own shard, no communication."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    local = x
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            local = local.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def place(params_tree, specs: Dict[str, Spec], mesh):
    """``params_tree`` (full tensors, the same on every rank) with each leaf
    a ``DTensor`` placed by ``specs[path]``."""
    return tree.rebuild(params_tree, {p: shard_of(v, specs[p], mesh)
                                      for p, v in tree.flatten(params_tree)})


def local_batch(arr, mesh):
    """This rank's rows of a global batch ``arr`` (leading dim) under
    ``batch_spec``: a contiguous block, the blocks ordered row-major over
    the spec's axes.  The whole batch where the spec replicates it."""
    index, count = 0, 1
    for a in entry_axes(batch_spec(mesh, arr.shape[0])[0]):
        i = mesh.mesh_dim_names.index(a)
        index = index * mesh.size(i) + mesh.get_local_rank(i)
        count *= mesh.size(i)
    rows = arr.shape[0] // count
    return arr[index * rows:(index + 1) * rows]
