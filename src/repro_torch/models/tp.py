"""Tensor parallelism over the mesh's 'model' axis: its process group, and
its collectives as autograd Functions (Megatron-LM's operators).

This module has no counterpart in the reference.  There the parameters
enter ``jit`` placed by ``models.sharding.param_specs`` (column-parallel
in-projections, row-parallel out-projections, vocab-sharded embeddings)
and GSPMD inserts the collectives the forward and backward need.  The port
runs eagerly on each rank's local shard, so each family's forward
(``models/layers.py``, ``transformer.py``, ``ssm.py``, ``xlstm.py``,
``encdec.py``) issues them itself, through the Functions below.

A tensor is *replicated* when every rank of the model axis holds the same
value and computes the same thing from it (its gradient is then the same
on every rank too), and *split* when each rank holds its own part.  Each
operator's backward is the adjoint of its forward under that convention:

* ``copy_to_model``   replicated → used by every rank's own computation:
  identity forward, all-reduce backward (the ranks' partial gradients
  summed);
* ``reduce_from_model`` each rank's partial sum → replicated: all-reduce
  forward, identity backward.  (``torch.distributed.nn.functional``'s
  ``all_reduce`` all-reduces the gradient again, which multiplies a
  replicated gradient by the extent.)
* ``gather_from_model`` split along ``dim`` → the whole tensor on every
  rank: all-gather forward; backward splits the gradient (the whole
  tensor feeds replicated computation) or, with ``reduce_grad``,
  reduce-scatters it (each rank's copy feeds its own computation);
* ``split_to_model``  replicated → this rank's part along ``dim``: a slice
  forward, all-gather backward;
* ``seq_to_features`` / ``features_to_seq``: the all-to-all between
  (B, S/tp, F) (this rank's rows, every feature) and (B, S, F/tp) (every
  row, this rank's features), each the other's backward;
* ``halves_to_channels``: a column-parallel product whose columns are two
  halves (the hybrid SSM's ``in_proj``: xs ; z) regrouped so each rank
  holds the same channel range of both, one all-to-all of two blocks.

On a model axis of one rank every operator is the identity, so the
tensor-parallel code path of one card computes bitwise what the plain one
does.  Every collective is a ``torch.distributed`` call on the axis's
group: NCCL on the card, gloo on the CPU.

``DataParallel`` is the mesh's data axes seen from one rank, for the one
computation of the forward that reads across them: the MoE dispatch,
which ranks and drops tokens over the global batch as the reference's
``jit`` of it does (``models/moe.py``).  Its collective carries integers
and no gradient.

``ZeroShards`` is ZeRO-3 (``param_specs(..., zero3=True)``, the reference's
memory policy of the >= 340 B configs): the dim of a block weight that the
'model' axis leaves whole is split over the 'data' axis, and
``gather_layer`` makes one layer's weights whole, as each rank's own
computation uses them:

* ``gather_from_data`` a part along ``dim`` → the whole weight: all-gather
  over 'data' forward; backward reduce-scatters the gradient back to the
  part and divides it by the extent, so the part's gradient is the mean
  over the data ranks' batches (the global batch's mean over 'data', as
  the ``Partial("avg")`` gradients are averaged later).

The collective spans the 'data' axis alone (the reference's ``zaxis``),
never 'pod': the tokens of the MoE dispatch go over ``("pod", "data")``,
the weights over 'data'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """The model axis seen from one rank: its process group, its extent
    and this rank's index along it."""
    group: Any
    size: int
    rank: int

    def divides(self, n: int) -> bool:
        """Whether ``param_specs`` splits a dim of ``n`` over this axis
        (its divisibility guard)."""
        return n % self.size == 0


def model_extent(mesh) -> int:
    """The extent of ``mesh``'s 'model' axis (1 without one)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def serves_split(cfg) -> bool:
    """Whether ``cfg``'s family serves under a mesh: the dense decoders and
    the MoE family.  The others' serving under a mesh (their caches split
    by ``cache_specs``) is the serving half of ROADMAP item 6."""
    return cfg.family in ("dense", "moe") and not cfg.encdec


def tensor_parallel(mesh) -> bool:
    """Whether training on ``mesh`` is tensor-parallel: its 'model' axis
    has more than one rank (every family has the split train step).  The
    one rule by which the train step, its loss, ``init_state``, the
    resilient loop, the launcher and the dry run's train cells decide;
    otherwise the parameters are replicated and the model axis only
    spreads the owners."""
    return model_extent(mesh) > 1


def model_parallel(mesh) -> Optional[ModelParallel]:
    """The ``ModelParallel`` of ``mesh``'s 'model' axis, or None without
    one."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    i = mesh.mesh_dim_names.index("model")
    return ModelParallel(mesh.get_group(i), mesh.size(i),
                         mesh.get_local_rank(i))


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The mesh's data axes seen from one rank: their process groups,
    extents and this rank's coordinates, in mesh order (the first major,
    as ``models.sharding.local_batch`` orders the batch's blocks)."""
    groups: tuple
    sizes: tuple
    ranks: tuple

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def rank(self) -> int:
        """This rank's block of the global batch (row-major)."""
        r = 0
        for n, i in zip(self.sizes, self.ranks):
            r = r * n + i
        return r


def data_parallel(mesh) -> Optional[DataParallel]:
    """The ``DataParallel`` of ``mesh``'s data axes
    (``models.sharding.dp_axes``), or None where they hold one rank."""
    from repro_torch.models.sharding import dp_axes
    if mesh is None:
        return None
    idx = [mesh.mesh_dim_names.index(a) for a in dp_axes(mesh)]
    if math.prod(mesh.size(i) for i in idx) == 1:
        return None
    return DataParallel(tuple(mesh.get_group(i) for i in idx),
                        tuple(mesh.size(i) for i in idx),
                        tuple(mesh.get_local_rank(i) for i in idx))


@dataclasses.dataclass(frozen=True)
class ZeroShards:
    """The 'data' axis seen from one rank, and the block weights ZeRO-3
    splits over it: ``dims`` {path in one layer's tree: the dim split}."""
    group: Any
    size: int
    rank: int
    dims: dict


def zero_shards(mesh, specs: Optional[dict]) -> Optional[ZeroShards]:
    """The ``ZeroShards`` of ``specs`` (``param_specs``' {path: spec}) on
    ``mesh``, or None where no spec names 'data' or the axis holds one
    rank (the gather is then the identity).  Only the stacked blocks
    (``blocks/...``, one layer per leading index) may be split over it."""
    from repro_torch.models.sharding import entry_axes
    if mesh is None or specs is None or "data" not in mesh.mesh_dim_names:
        return None
    dims = {}
    for p, spec in specs.items():
        d = [i for i, e in enumerate(spec) if "data" in entry_axes(e)]
        if not d:
            continue
        if not p.startswith("blocks/") or d[0] == 0:
            raise ValueError(f"{p} {spec}: ZeRO-3 splits a stacked block "
                             "weight's matrix or expert dims only")
        dims[p[len("blocks/"):]] = d[0] - 1
    i = mesh.mesh_dim_names.index("data")
    if not dims or mesh.size(i) == 1:
        return None
    return ZeroShards(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i),
                      dims)


def gather_over_data(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """(dp.size, *x.shape): every data rank's ``x``, in the order of their
    blocks of the global batch (no gradient)."""
    out = x.detach()[None]
    for group, n in reversed(list(zip(dp.groups, dp.sizes))):
        whole = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        dist.all_gather_into_tensor(whole, out.contiguous(), group=group)
        out = whole
    return out


def gather_stack(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """(mp.size, *x.shape): every model rank's ``x``, in rank order, the
    same on every rank (no gradient: the serving path's attention
    partials, ``layers._sdpa_rows``)."""
    out = x.new_empty((mp.size,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, x.detach().contiguous()[None],
                                group=mp.group)
    return out


# ------------------------------------------------------------ collectives

def _all_reduce(x: torch.Tensor, mp: ModelParallel,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mp.group)
    return out


def _all_gather(x: torch.Tensor, mp: ModelParallel, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((mp.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mp.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mp: ModelParallel,
                    dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // mp.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mp.group)
    return out.movedim(0, dim)


def _split(x: torch.Tensor, mp: ModelParallel, dim: int) -> torch.Tensor:
    if x.shape[dim] % mp.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {mp.size} ranks")
    return x.chunk(mp.size, dim=dim)[mp.rank].contiguous()


def _all_to_all(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Block j of ``x``'s leading dim to rank j; block j of the result from
    rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mp.group)
    return out


def _seq_to_features(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    B, Sl, F = x.shape
    if F % mp.size:
        raise ValueError(f"{F} features do not split over {mp.size} ranks")
    blocks = x.reshape(B, Sl, mp.size, F // mp.size).permute(2, 0, 1, 3)
    out = _all_to_all(blocks, mp)               # (tp, B, Sl, F/tp)
    return out.permute(1, 0, 2, 3).reshape(B, mp.size * Sl, F // mp.size)


def _features_to_seq(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    B, S, Fl = x.shape
    if S % mp.size:
        raise ValueError(f"{S} positions do not split over {mp.size} ranks")
    blocks = x.reshape(B, mp.size, S // mp.size, Fl).permute(1, 0, 2, 3)
    out = _all_to_all(blocks, mp)               # (tp, B, S/tp, Fl)
    return out.permute(1, 2, 0, 3).reshape(B, S // mp.size, mp.size * Fl)


def _halves_routes(mp: ModelParallel) -> tuple:
    """The all-to-all of ``halves_to_channels`` on this rank: the ranks its
    two column blocks go to, and the ranks its two channel blocks come
    from.  The 2F columns are 2·tp blocks of F/tp; rank r holds blocks 2r
    and 2r + 1 and needs blocks r (first half) and tp + r (second half),
    so block j goes to rank j mod tp and comes from rank j // 2."""
    n, r = mp.size, mp.rank
    return [(2 * r) % n, (2 * r + 1) % n], [r // 2, (n + r) // 2]


def _exchange(x: torch.Tensor, mp: ModelParallel, send_to: list,
              recv_from: list) -> torch.Tensor:
    """x (2, ...): block i to rank ``send_to[i]``; the result's block i from
    rank ``recv_from[i]``.  ``all_to_all_single`` lays the blocks out in
    rank order on both sides, so a pair in descending order (on an odd
    axis, 2r + 1 = tp sends its second block to rank 0) is swapped before
    the exchange, or after it."""
    flip_in, flip_out = send_to[0] > send_to[1], recv_from[0] > recv_from[1]
    x = (x.flip(0) if flip_in else x).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(
        out, x, output_split_sizes=[recv_from.count(s)
                                    for s in range(mp.size)],
        input_split_sizes=[send_to.count(d) for d in range(mp.size)],
        group=mp.group)
    return out.flip(0) if flip_out else out


class _HalvesToChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        B, S, F2 = x.shape
        blocks = x.reshape(B, S, 2, F2 // 2).movedim(2, 0)
        return _exchange(blocks, mp, *_halves_routes(mp))

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from = _halves_routes(ctx.mp)
        blocks = _exchange(g, ctx.mp, recv_from, send_to)
        return blocks.movedim(0, 2).flatten(2), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return _all_reduce(x, mp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim, reduce_grad):
        ctx.mp, ctx.dim, ctx.reduce_grad = mp, dim, reduce_grad
        return _all_gather(x, mp, dim)

    @staticmethod
    def backward(ctx, g):
        g = _reduce_scatter(g, ctx.mp, ctx.dim) if ctx.reduce_grad else \
            _split(g, ctx.mp, ctx.dim)
        return g, None, None, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, zs, dim):
        ctx.zs, ctx.dim = zs, dim
        return _all_gather(x, zs, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.zs, ctx.dim).div_(ctx.zs.size), \
            None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return _split(x, mp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mp, ctx.dim), None, None


class _SeqToFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _seq_to_features(x, mp)

    @staticmethod
    def backward(ctx, g):
        return _features_to_seq(g, ctx.mp), None


class _FeaturesToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _features_to_seq(x, mp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_features(g, ctx.mp), None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.ndim


def copy_to_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    return x if mp.size == 1 else _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    return x if mp.size == 1 else _ReduceFromModel.apply(x, mp)


def gather_from_model(x: torch.Tensor, mp: ModelParallel, dim: int, *,
                      reduce_grad: bool = False) -> torch.Tensor:
    if mp.size == 1:
        return x
    return _GatherFromModel.apply(x, mp, _dim(x, dim), reduce_grad)


def gather_from_data(x: torch.Tensor, zs: ZeroShards,
                     dim: int) -> torch.Tensor:
    """This rank's part of a weight split along ``dim`` over 'data' → the
    whole weight (module docstring)."""
    return x if zs.size == 1 else _GatherFromData.apply(x, zs, _dim(x, dim))


def gather_layer(params: dict, zs: Optional[ZeroShards],
                 prefix: str = "") -> dict:
    """One layer's parameter tree with every leaf ``zs`` splits over
    'data' gathered whole (``gather_from_data``); the others as they are.
    ``zs`` None: ``params`` itself."""
    if zs is None:
        return params
    out = {}
    for k, v in params.items():
        path = prefix + k
        if isinstance(v, dict):
            out[k] = gather_layer(v, zs, path + "/")
        elif path in zs.dims:
            out[k] = gather_from_data(v, zs, zs.dims[path])
        else:
            out[k] = v
    return out


def split_to_model(x: torch.Tensor, mp: ModelParallel,
                   dim: int) -> torch.Tensor:
    return x if mp.size == 1 else _SplitToModel.apply(x, mp, _dim(x, dim))


def halves_to_channels(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """(B, S, 2F/tp) this rank's contiguous part of a (B, S, 2F) product
    whose columns are two halves [a ; b] → (2, B, S, F/tp): this rank's
    channels of a and of b, the same range of each (one all-to-all of two
    blocks a rank; its backward the inverse).  The hybrid SSM's ``in_proj``
    (xs ; z) split over 2·d_inner, regrouped for a channel-split scan."""
    if mp.size == 1:
        B, S, F2 = x.shape
        return x.reshape(B, S, 2, F2 // 2).movedim(2, 0)
    if x.shape[-1] % 2:
        raise ValueError(f"{x.shape[-1]} columns are not two halves")
    return _HalvesToChannels.apply(x, mp)


def seq_to_features(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """(B, S/tp, F) this rank's rows → (B, S, F/tp) this rank's
    features."""
    return x if mp.size == 1 else _SeqToFeatures.apply(x, mp)


def features_to_seq(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """(B, S, F/tp) this rank's features → (B, S/tp, F) this rank's
    rows."""
    return x if mp.size == 1 else _FeaturesToSeq.apply(x, mp)


def all_max(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Elementwise max over the model axis (no gradient: the vocab-parallel
    cross entropy's shift)."""
    return x if mp.size == 1 else _all_reduce(x.detach(), mp,
                                              dist.ReduceOp.MAX)
