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
``mesh_dim_names`` and a ``shape`` tuple (the rules read shapes only).
``input_shardings`` and ``cache_specs`` are the serving rules, held equal
to the reference's entry for entry: the serving tier on a mesh
(``serve.Scheduler(..., mesh=...)``, the dense and MoE families) allocates
each cache leaf as this rank's part (``local_shape``) from the start.  The
other families (whose train step splits by ``param_specs`` too) and the
paged pool still serve on one card (ROADMAP item 6's serving half; the
reference refuses the paged pool under a mesh too).
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


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of this rank's part of a leaf of ``shape`` under
    ``spec``: each split dim divided by the extent of the axes that split
    it (``local_part``'s result, with no tensor to cut)."""
    out = list(shape)
    for i, p in enumerate(placements(spec, mesh)):
        if p.is_shard():
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {mesh.size(i)} ranks")
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def local_part(x, spec: Spec, mesh):
    """This rank's part of ``x`` (the same full tensor on every rank) under
    ``spec``: a view, no communication."""
    for i, p in enumerate(placements(spec, mesh)):
        if p.is_shard():
            x = x.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return x


def shard_of(x, spec: Spec, mesh):
    """``x`` (the same full tensor on every rank) as a ``DTensor`` placed
    by ``spec``: each rank keeps its own shard, no communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_part(x, spec, mesh).contiguous(), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.stride())


def placed(local, spec: Spec, mesh, shape):
    """This rank's part ``local`` of a tensor of ``shape`` as the
    ``DTensor`` ``spec`` places (no communication, no copy)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def shard_range(spec: Spec, mesh, local_shape) -> Tuple[tuple, tuple, int,
                                                          bool]:
    """Where this rank's part of a leaf placed by ``spec`` sits: (the
    leaf's shape, the part's start in each dim, its index among the parts,
    whether this rank is the one that holds it first: coordinate 0 on
    every mesh axis that does not split the leaf).  The index is
    row-major over the splitting axes, in mesh order."""
    shape, start = list(local_shape), [0] * len(local_shape)
    index, writer = 0, True
    pl = placements(spec, mesh)
    for i, p in enumerate(pl):
        r = mesh.get_local_rank(i)
        if p.is_shard():
            start[p.dim] = start[p.dim] * mesh.size(i) + r * local_shape[p.dim]
            shape[p.dim] *= mesh.size(i)
            index = index * mesh.size(i) + r
        elif r:
            writer = False
    return tuple(shape), tuple(start), index, writer


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


def input_shardings(cfg, specs_dict, mesh) -> Dict[str, Spec]:
    """{name: spec} for a dict of input arrays (anything with ``shape``):
    batch-sharded on the leading dim, scalars replicated."""
    out = {}
    for name, sd in specs_dict.items():
        rank = len(sd.shape)
        out[name] = () if rank == 0 else \
            batch_spec(mesh, sd.shape[0]) + (None,) * (rank - 1)
    return out


def cache_specs(cfg, cache_tree, mesh) -> Dict[str, Spec]:
    """{path: spec} of the decode cache: batch over the data-parallel
    axes; kv-heads over 'model' when divisible, otherwise the sequence
    over 'model' (the fallback that also serves batch-1 long context).
    Leaf ranks: (L,B,S,KV,hd) attention KV · (L,B,S,r) MLA latent ·
    (L,B,S,1,rd) MLA rope key · (L,B,K,di) ssm conv · (L,B,di,ds) ssm h ·
    (n,B,H,hd,hd) / (n,B,H,hd) / (n,B,H) mLSTM · (n,B,d) sLSTM."""
    def spec_for(path: str, shape) -> Spec:
        rank = len(shape)
        if rank < 3:
            return (None,) * rank
        dims = [None] * rank
        if shape[1] > 1:
            dims[1] = _guard(mesh, shape[1], _entry(dp_axes(mesh))
                             if dp_axes(mesh) else None)
        leafname = path.split("/")[-1]
        if rank >= 5:                       # (L,B,S,KV,hd) or mLSTM C
            dims[3] = _guard(mesh, shape[3], "model")
            if dims[3] is None:
                dims[2] = _guard(mesh, shape[2], "model")
        elif rank == 4:
            if "conv" in leafname:          # (L,B,K,di): shard channels
                dims[3] = _guard(mesh, shape[3], "model")
            else:                           # (L,B,S,r) latent / (L,B,di,ds)
                dims[2] = _guard(mesh, shape[2], "model")
        else:                               # (L,B,X)
            dims[2] = _guard(mesh, shape[2], "model")
        return tuple(dims)

    return {p: spec_for(p, tuple(v.shape))
            for p, v in tree.flatten(cache_tree)}
