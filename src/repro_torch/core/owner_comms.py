"""Owner-layout machinery (port of ``repro.core.owner_comms``).

Everything about *where matrices live*: the leaf↔matrix reshapes, the
owner-major packed stacking and, across ranks, the collectives that move a
shape group's stack between the training layout and the owner layout.

A packed stack is ``(D·cap, m, n)``; position p belongs to owner
``p // cap``.  Without a mesh the owner layout is a permutation plus zero
padding of each group's stack, all on one process.  Under a
``DeviceMesh`` every tensor here is this rank's local part:

* a leaf is a ``DTensor`` whose placements are its training layout
  (``Shard`` on a matrix dim for tensor parallelism, ``Partial`` for a
  data-parallel gradient still to be reduced) or a plain tensor, which
  means replicated;
* ``OwnerLayout.pack`` stacks the local parts (``pack_index`` permutes the
  stack while it is still local) and moves the stack to the owners one
  mesh axis per stage: an ``all_to_all_single`` where the axis shards a
  matrix dim, a ``reduce_scatter_tensor`` where the gradient is ``Partial``
  over it (the paper's reduce-to-owner), a local slice where it is
  replicated.  Each rank then holds its own ``packed_size / D`` rows, full
  matrices, as a plain tensor; the owner axes are ``plan.owner_axes`` (all
  mesh axes by default) and the owner index is row-major over them, the
  order in which ``DTensor`` shards one dim over several mesh dims;
* the owner-local compute runs on those rows (``shard_local``), never on
  ``DTensor``s, so no per-op dispatch touches the Newton-Schulz path;
* ``OwnerLayout.unpack`` publishes in reverse: an all-to-all back to the
  matrix dim, or an all-gather where the training layout replicates.

``pack_async`` / ``unpack_async`` issue the same moves with
``async_op=True`` and return a ``Pending`` (the bucketed schedule of
``core/pipeline.py`` runs compute while they fly); ``pack`` / ``unpack``
wait for it at once.

Moving one axis per stage keeps every collective a same-shape exchange;
resolving a two-axis move at once can go through replication (whole-tensor
all-gathers).  Explicit ``torch.distributed`` calls do the moves:
``DTensor.redistribute`` resolves a shard-to-shard move on gloo through an
all-gather.  Gloo on CPU tensors and NCCL on CUDA tensors run the same
calls; nothing is moved to the host to communicate.

A leaf may shard one *leading* dim (MoE expert parallelism: ``(L, E, m,
n)`` experts sharded on E).  ``_lead_perm`` makes that dim major before
the leaf is flattened, so its shard is a contiguous block of the stack
(``Shard(0)`` of the stacked view) and every reshape stays local.  The
block a rank then holds after the other owner axes have cut it is the
owner block of another rank unless the sharding axes lead the owner
order; one exchange of whole owner blocks (``_issue_permute``, one send
and one receive per rank) puts each block on its owner.  Where the
group's stack needs padding or a permutation over the owners (its count
not a multiple of theirs, or ``pack_index`` not contiguous), the shards
are not whole owner blocks: each rank's rows are padded with zero rows to
the other owner axes' extent, cut by them, and sent row by row to the
owners the plan gives them (``_route``, ``_issue_exchange``: point-to-point
sends, one a peer); the pad positions stay zero, as the reference's
padded stack's.  The publish runs the same exchange back.  This module
knows nothing about optimization:
``core/muon.py`` composes an :class:`OwnerLayout` with an orthogonalizer
and an update rule.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.dedication import DedicationPlan

Placements = Sequence  # one torch.distributed.tensor Placement per mesh dim


def group_key_str(key) -> str:
    """Sanitize a group key for use as a state-dict key ('/' would collide
    with a checkpoint manifest's path separator)."""
    return key.replace("/", ".") if isinstance(key, str) else \
        f"{key[0]}x{key[1]}"


def _sharded_lead(info, placements) -> Optional[int]:
    """The leading dim of ``info``'s leaf that ``placements`` shard, or
    None.  At most one may be (the sharded dim becomes the stack's major
    dim; a second would be split inside each stack block)."""
    if placements is None:
        return None
    n_lead = len(info.shape) - 2
    dims = {p.dim % len(info.shape) for p in placements if p.is_shard()}
    lead = sorted(d for d in dims if d < n_lead)
    if len(lead) > 1:
        raise ValueError(f"{info.path}: leading dims {lead} are sharded; "
                         "the owner layout moves one sharded leading dim")
    return lead[0] if lead else None


def _lead_perm(info, placements=None) -> tuple:
    """Permutation of the leaf's leading dims putting the sharded one first
    (major).  Flattening a sharded-MAJOR dim keeps the stack's sharding a
    split of its rows and every reshape local."""
    n_lead = len(info.shape) - 2
    d = _sharded_lead(info, placements)
    if d is None or n_lead <= 1:
        return tuple(range(n_lead))
    return (d,) + tuple(i for i in range(n_lead) if i != d)


def _leaf_to_matrices(arr: torch.Tensor, info, perm=None) -> torch.Tensor:
    """(lead..., m0, n0) -> (count, m, n) with m <= n, the leading dims in
    ``perm`` order (``_lead_perm``).  Reads the trailing dims off ``arr``,
    so a local shard reshapes as the whole leaf does."""
    n_lead = arr.ndim - 2
    if perm is not None and tuple(perm) != tuple(range(n_lead)):
        arr = arr.permute(tuple(perm) + (n_lead, n_lead + 1))
    flat = arr.reshape((-1,) + tuple(arr.shape[-2:]))
    return flat.mT if info.transpose else flat


def _matrices_to_leaf(flat: torch.Tensor, info, perm=None) -> torch.Tensor:
    """Inverse of ``_leaf_to_matrices``.  The first of the ``perm``-ordered
    leading dims is read off ``flat`` (a shard of the sharded one), the
    others off ``info``."""
    if info.transpose:
        flat = flat.mT
    n_lead = len(info.shape) - 2
    perm = tuple(range(n_lead)) if perm is None else tuple(perm)
    if n_lead == 0:
        return flat.reshape(tuple(flat.shape[-2:]))
    lead = (-1,) + tuple(info.shape[i] for i in perm[1:])
    out = flat.reshape(lead + tuple(flat.shape[-2:]))
    if perm != tuple(range(n_lead)):
        inv = tuple(int(i) for i in np.argsort(perm))
        out = out.permute(inv + (n_lead, n_lead + 1))
    return out


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _stack(plan: DedicationPlan, key, leaf_values, perms) -> torch.Tensor:
    """Group ``key``'s leaves as one (rows, m, n) stack, leaf by leaf."""
    parts = [_leaf_to_matrices(leaf_values[p], plan.leaves[p], perms.get(p))
             for p in plan.groups[key].leaf_paths]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _unstack(plan: DedicationPlan, key, flat, perms, counts
             ) -> Dict[str, torch.Tensor]:
    """Inverse of ``_stack``: ``counts`` rows of ``flat`` a leaf."""
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for p, n in zip(plan.groups[key].leaf_paths, counts):
        out[p] = _matrices_to_leaf(flat[start:start + n], plan.leaves[p],
                                   perms.get(p))
        start += n
    return out


def pack_group(plan: DedicationPlan, key,
               leaf_values: Dict[str, torch.Tensor],
               perms: Optional[Dict[str, tuple]] = None) -> torch.Tensor:
    """Stack a shape group's matrices into the owner-major padded layout:
    (num_owners * capacity, m, n); position p belongs to owner p // capacity.
    ``perms[path]`` orders a leaf's leading dims (``_lead_perm``; default
    as stored).  On one process; ``OwnerLayout.pack`` moves the result
    across ranks."""
    g = plan.groups[key]
    flat = _stack(plan, key, leaf_values, perms or {})
    pad_shape = tuple(flat.shape[1:])
    n_pad = g.packed_size - g.count
    if np.array_equal(g.pack_index[:g.count], np.arange(g.count)):
        # contiguous physical layout: a pure pad
        if n_pad == 0:
            return flat.contiguous()
        return torch.cat([flat, flat.new_zeros((n_pad,) + pad_shape)], dim=0)
    flat_ext = torch.cat([flat, flat.new_zeros((1,) + pad_shape)], dim=0)
    idx = np.where(g.pack_index < 0, g.count, g.pack_index)
    return flat_ext.index_select(0, _index(idx, flat.device))


def unpack_group(plan: DedicationPlan, key, packed: torch.Tensor,
                 perms: Optional[Dict[str, tuple]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Inverse of pack_group: owner-major stack -> per-leaf tensors."""
    g = plan.groups[key]
    perms = perms or {}
    if np.array_equal(g.unpack_index, np.arange(g.count)):
        flat = packed[:g.count]            # contiguous layout: pure slice
    else:
        flat = packed.index_select(0, _index(g.unpack_index, packed.device))
    return _unstack(plan, key, flat, perms,
                    [plan.leaves[p].count for p in g.leaf_paths])


def repack_rows(old_g, new_g, buf: torch.Tensor) -> torch.Tensor:
    """Re-layout one owner-major buffer across plans: unpack the logical rows
    under ``old_g`` (a GroupPlan), repack/pad under ``new_g``."""
    if np.array_equal(old_g.unpack_index, np.arange(old_g.count)):
        rows = buf[:old_g.count]
    else:
        rows = buf.index_select(0, _index(old_g.unpack_index, buf.device))
    n_pad = new_g.packed_size - new_g.count
    if np.array_equal(new_g.pack_index[:new_g.count], np.arange(new_g.count)):
        if n_pad == 0:
            return rows
        return torch.cat([rows, rows.new_zeros((n_pad,) + rows.shape[1:])], 0)
    ext = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])], 0)
    idx = np.where(new_g.pack_index < 0, new_g.count, new_g.pack_index)
    return ext.index_select(0, _index(idx, buf.device))


# --------------------------------------------------------------------------
# Placements
# --------------------------------------------------------------------------

def split_leaf(leaf, mesh):
    """(local tensor, placements) of a leaf under ``mesh``: a ``DTensor``'s
    own, or all ``Replicate`` for a plain tensor."""
    if isinstance(leaf, DTensor):
        if tuple(leaf.device_mesh.mesh_dim_names) != \
                tuple(mesh.mesh_dim_names):
            raise ValueError(f"leaf on mesh {leaf.device_mesh.mesh_dim_names}"
                             f", optimizer on {mesh.mesh_dim_names}")
        for i, p in enumerate(leaf.placements):
            if p.is_shard() and leaf.shape[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of a {tuple(leaf.shape)} leaf "
                                 f"does not split evenly over mesh dim {i}")
        return leaf.to_local(), tuple(leaf.placements)
    return leaf, (Replicate(),) * mesh.ndim


def published(placements: Placements) -> tuple:
    """The training layout of an update: a gradient's placements with each
    ``Partial`` (a pending data-parallel reduction) replicated."""
    return tuple(Replicate() if p.is_partial() else p for p in placements)


def _reduce_op(p) -> str:
    if p.reduce_op not in ("sum", "avg"):
        raise ValueError(f"Partial({p.reduce_op!r}) gradients are not "
                         "supported; only 'sum' and 'avg'")
    return p.reduce_op


def stacked_placements(info, placements: Placements) -> tuple:
    """Placements of the (count, m, n) stacked view of a leaf placed by
    ``placements``: a shard of the leaf's row / column dim becomes a shard
    of stack dim 1 / 2 (swapped for a transposed leaf), a shard of its one
    sharded leading dim (an expert dim) a shard of stack dim 0, which
    ``_lead_perm`` makes major."""
    n_lead = len(info.shape) - 2
    _sharded_lead(info, placements)
    out, seen = [], set()
    for p in placements:
        if p.is_shard():
            d = p.dim % len(info.shape)
            if d < n_lead:
                out.append(Shard(0))
                continue
            k = d - n_lead + 1
            k = 3 - k if info.transpose else k
            if k in seen:
                raise ValueError(f"{info.path}: matrix dim {d} is sharded "
                                 "over more than one mesh axis")
            seen.add(k)
            p = Shard(k)
        elif p.is_partial():
            _reduce_op(p)
        out.append(p)
    return tuple(out)


# --------------------------------------------------------------------------
# One mesh dim's move (x is this rank's local part; i the mesh dim)
# --------------------------------------------------------------------------
#
# Each move is issued with ``async_op=True`` and returns ``(work, finish,
# held)``: the collective's ``Work`` (None for a move without
# communication), a function that gives the move's result once the work is
# done (the ``div_`` of an average, the ``movedim`` / ``flatten`` after an
# all-to-all), and the collective's buffers, which ``Pending`` keeps
# referenced until the work is waited, so the caching allocator cannot hand
# their memory to anything else while the collective may still read or
# write it.  ``Pending`` chains the moves of one tensor.  A mesh dim of one
# rank moves nothing (a sum or mean over one rank is its own value), so it
# issues no collective and cannot hold back the next dim's.

def _issue_to_rows(x: torch.Tensor, p, i: int, mesh):
    """Placement ``p`` on mesh dim ``i`` -> ``Shard(0)`` (rows split)."""
    s, group = mesh.size(i), mesh.get_group(i)
    if s == 1:
        return None, lambda: x, ()
    rows = x.shape[0] // s
    if p.is_shard():
        # all-to-all: chunk j of my rows goes to rank j, which sends back
        # its part of dim k of my chunk
        inp = x.reshape((s, rows) + tuple(x.shape[1:])).contiguous()
        out = torch.empty_like(inp)
        work = dist.all_to_all_single(out, inp, group=group, async_op=True)
        return (work, lambda: out.movedim(0, p.dim).flatten(p.dim, p.dim + 1),
                (inp, out))
    if p.is_partial():
        inp = x.contiguous()
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        work = dist.reduce_scatter_tensor(out, inp, group=group,
                                          async_op=True)
        avg = _reduce_op(p) == "avg"
        return work, lambda: out.div_(s) if avg else out, (inp, out)
    c = mesh.get_local_rank(i)
    return None, lambda: x[c * rows:(c + 1) * rows], ()


def _issue_from_rows(x: torch.Tensor, target, i: int, mesh):
    """``Shard(0)`` on mesh dim ``i`` -> ``target`` (``Shard(k)`` or
    ``Replicate``): the publish direction of ``_issue_to_rows``."""
    s, group = mesh.size(i), mesh.get_group(i)
    if s == 1:
        return None, lambda: x, ()
    if target.is_shard():
        k = target.dim
        inp = x.unflatten(k, (s, -1)).movedim(k, 0).contiguous()
        out = torch.empty_like(inp)
        work = dist.all_to_all_single(out, inp, group=group, async_op=True)
        return work, lambda: out.flatten(0, 1), (inp, out)
    inp = x.contiguous()
    out = x.new_empty((s * x.shape[0],) + tuple(x.shape[1:]))
    work = dist.all_gather_into_tensor(out, inp, group=group, async_op=True)
    return work, lambda: out, (inp, out)


def _issue_replicate(x: torch.Tensor, p, i: int, mesh):
    """Placement ``p`` on mesh dim ``i`` -> ``Replicate``: all-gather a
    shard, all-reduce a partial sum (into a copy of ``x``); ``x`` itself on
    a dim of one rank."""
    s, group = mesh.size(i), mesh.get_group(i)
    if s == 1:
        return None, lambda: x, ()
    if p.is_shard():
        inp = x.contiguous()
        out = x.new_empty((s * x.shape[0],) + tuple(x.shape[1:]))
        work = dist.all_gather_into_tensor(out, inp, group=group,
                                           async_op=True)
        return work, lambda: out.unflatten(0, (s, x.shape[0])).movedim(
            0, p.dim).flatten(p.dim, p.dim + 1), (inp, out)
    if p.is_partial():
        out = x.clone(memory_format=torch.contiguous_format)
        work = dist.all_reduce(out, group=group, async_op=True)
        avg = _reduce_op(p) == "avg"
        return work, lambda: out.div_(s) if avg else out, (out,)
    return None, lambda: x, ()


class _Works:
    """The ``Work`` handles of one batch of point-to-point ops, waited as
    one."""

    def __init__(self, works):
        self.works = works

    def wait(self) -> None:
        for w in self.works:
            w.wait()


def _issue_permute(x: torch.Tensor, to: int, frm: int):
    """Send this rank's rows to global rank ``to`` and take the rows of
    ``frm`` in their place (same shape): one owner block each way.  A rank
    that keeps its own block moves nothing."""
    if to == dist.get_rank():
        return None, lambda: x, ()
    inp = x.contiguous()
    out = torch.empty_like(inp)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, inp, to),
                                    dist.P2POp(dist.irecv, out, frm)])
    return _Works(works), lambda: out, (inp, out)


class _Route(NamedTuple):
    """``OwnerLayout._route``: a padded group's exchange between training
    chunks and owner blocks.  ``sends``: (peer, chunk rows), ``recvs``:
    (peer, owner slots), both in the order the rows travel."""
    chunk: int          # rows of a training chunk, after the padding
    chunks: int         # chunks a shard is cut into
    cap: int            # rows of an owner block
    shares: list        # rows of each leaf in a training shard
    sends: list
    recvs: list


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    n_pad = rows - x.shape[0]
    if n_pad == 0:
        return x
    return torch.cat([x, x.new_zeros((n_pad,) + tuple(x.shape[1:]))], 0)


def _issue_exchange(x: torch.Tensor, sends, recvs, rows: int):
    """Send ``x``'s rows ``idx`` to each ``(peer, idx)`` of ``sends`` and
    write the rows each ``(peer, idx)`` of ``recvs`` sends into rows
    ``idx`` of a zero tensor of ``rows`` rows (one send and one receive a
    peer; a rank's rows to itself are copied)."""
    me = dist.get_rank()
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    ops, landed = [], []
    for peer, idx in sends:
        part = x.index_select(0, _index(idx, x.device))
        if peer == me:
            out.index_copy_(0, _index(dict(recvs)[me], x.device), part)
        else:
            ops.append(dist.P2POp(dist.isend, part, peer))
    for peer, idx in recvs:
        if peer != me:
            buf = x.new_empty((len(idx),) + tuple(x.shape[1:]))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            landed.append((_index(idx, x.device), buf))

    def finish():
        for idx, buf in landed:
            out.index_copy_(0, idx, buf)
        return out
    if not ops:
        return None, finish, ()
    held = tuple(op.tensor for op in ops)
    return _Works(dist.batch_isend_irecv(ops)), finish, held


class Pending:
    """A tensor on its way through a chain of mesh moves.

    ``moves`` are functions ``x -> (work, finish, held)`` (the ``_issue_*``
    moves, one mesh dim each).  Construction runs the moves that need no
    communication and issues the first collective; it returns at once.
    ``wait()`` waits for that collective, finishes it, and runs the rest of
    the chain, each later collective issued and waited in turn, then
    applies ``then`` and returns the result (the same tensor the
    synchronous call gives, bit for bit: the same collectives on the same
    data).  So only the chain's first collective overlaps what the caller
    enqueues before ``wait()``: a later move reads the earlier one's output,
    so it can be issued only after that output is complete.  On NCCL,
    ``Work.wait()`` makes the current stream wait for the collective's
    stream and does not block the host; on gloo it blocks.  Every
    ``Pending`` must be waited: its collective is issued on every rank, and
    the next collectives of the same group are matched in issue order."""

    def __init__(self, x, moves=(), then=None):
        self._value = x
        self._moves = list(moves)
        self._then = then
        self._flight = None            # (work, finish, held) of the move
        self._done = False
        self._advance()

    def _advance(self) -> None:
        """Run moves until one is in flight or none is left."""
        while self._moves:
            work, finish, held = self._moves.pop(0)(self._value)
            if work is not None:
                self._flight = (work, finish, held)
                return
            self._value = finish()

    def wait(self):
        """The result; the first call finishes the chain."""
        if not self._done:
            while self._flight is not None:
                work, finish, _ = self._flight
                work.wait()
                self._flight = None
                self._value = finish()
                self._advance()
            if self._then is not None:
                self._value = self._then(self._value)
            self._done = True
        return self._value


def replicate_dim(x: torch.Tensor, p, i: int, mesh) -> torch.Tensor:
    """Placement ``p`` on mesh dim ``i`` -> ``Replicate``: all-gather a
    shard, all-reduce a partial sum (into a copy of ``x``; ``x`` itself
    on a dim of one rank)."""
    return Pending(x, [lambda v: _issue_replicate(v, p, i, mesh)]).wait()


def shard_dim(x: torch.Tensor, target, i: int, mesh) -> torch.Tensor:
    """``Replicate`` on mesh dim ``i`` -> ``target``: this rank's chunk of a
    ``Shard``, no communication."""
    if not target.is_shard():
        return x
    return x.chunk(mesh.size(i), dim=target.dim)[mesh.get_local_rank(i)]


def replicate(x: torch.Tensor, placements: Placements, mesh) -> torch.Tensor:
    """The full tensor of local part ``x`` on every rank (the last mesh dim
    first: a dim split over several is gathered inner split first)."""
    for i, p in reversed(list(enumerate(placements))):
        x = replicate_dim(x, p, i, mesh)
    return x


def reduce_partial(x: torch.Tensor, placements: Placements,
                   mesh) -> torch.Tensor:
    """Local part of ``x`` in its training layout: pending reductions done,
    shards kept."""
    for i, p in enumerate(placements):
        if p.is_partial():
            x = replicate_dim(x, p, i, mesh)
    return x


def local_shard(full: torch.Tensor, placements: Placements,
                mesh) -> torch.Tensor:
    """This rank's part of ``full`` (the same on every rank) under the
    training layout ``published(placements)``."""
    for i, p in enumerate(published(placements)):
        full = shard_dim(full, p, i, mesh)
    return full


class OwnerLayout:
    """The pack/reshard half of the optimizer, bound to a (plan, mesh) pair.

    ``mesh=None``: one process, every owner's rows local.  Under a
    ``DeviceMesh`` each rank holds the rows of its own owner slot; the
    reference's ``constrain`` / ``constrain_buffer`` pin GSPMD shardings and
    have no counterpart, since every owner buffer here already *is* the
    local rows."""

    def __init__(self, plan: DedicationPlan, mesh=None,
                 device: Optional[torch.device] = None):
        self.plan = plan
        self.mesh = mesh
        self.device = device
        self.shards = 1
        self.owner_dims, self.other_dims = [], []
        if mesh is None:
            return
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(plan.owner_axes) or names
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"owner axes {unknown} are not mesh axes {names}")
        self.owner_dims = [names.index(a) for a in axes]
        self.other_dims = [i for i in range(len(names))
                           if i not in self.owner_dims]
        self.shards = math.prod(mesh.size(i) for i in self.owner_dims)
        if self.shards != plan.num_owners:
            raise ValueError(f"plan has {plan.num_owners} owners, the mesh's "
                             f"owner axes {axes} have {self.shards}")

    # ---------------------------------------------------------- structure

    def buffer_placements(self, ndim: int = 3) -> Optional[tuple]:
        """Placements of an owner-major buffer (axis 0 = stack) of any rank:
        ``Shard(0)`` over the owner axes, replicated over the others."""
        if self.mesh is None:
            return None
        return tuple(Shard(0) if i in self.owner_dims else Replicate()
                     for i in range(self.mesh.ndim))

    def owner_index(self) -> int:
        """This rank's owner slot: its coordinates on the owner axes,
        row-major, the order of its rows in the owner-major stack (0
        without a mesh)."""
        index = 0
        for i in self.owner_dims:
            index = index * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return index

    def local_block(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a buffer holding all D·cap rows."""
        rows = buf.shape[0] // self.shards
        i = self.owner_index()
        return buf[i * rows:(i + 1) * rows]

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """All D·cap rows of an owner-major buffer from every rank's own
        rows (all-gathers over the owner axes; ``local`` itself without a
        mesh)."""
        if self.mesh is None:
            return local
        return replicate(local, self.buffer_placements(), self.mesh)

    def local_rows(self, key) -> int:
        """Rows of group ``key``'s owner-major buffers on this rank."""
        return self.plan.groups[key].packed_size // self.shards

    def zeros(self, key, dtype, trailing: Optional[tuple] = None
              ) -> torch.Tensor:
        """Zero state buffer for group ``key``: this rank's owner rows (all
        D·cap rows without a mesh), each of shape ``trailing`` (default the
        group's (m, n); a variant's state may be per row, (m,), or per
        basis, (m, r))."""
        shape = self.plan.groups[key].key if trailing is None else trailing
        return torch.zeros((self.local_rows(key),) + tuple(shape),
                           dtype=dtype, device=self.device)

    def split(self, leaf):
        """(local tensor, placements) of a training-layout leaf; placements
        are None without a mesh."""
        if self.mesh is None:
            return leaf, None
        return split_leaf(leaf, self.mesh)

    # -------------------------------------------------------- movement

    def _stacked(self, key, placements) -> tuple:
        g = self.plan.groups[key]
        st = None
        for p in g.leaf_paths:
            pl = (placements or {}).get(p) or (Replicate(),) * self.mesh.ndim
            pl = stacked_placements(self.plan.leaves[p], pl)
            if st is not None and pl != st:
                raise ValueError(f"group {key!r}: leaves placed differently")
            st = pl
        return st

    def _perms(self, key, placements) -> Dict[str, tuple]:
        """``_lead_perm`` of each leaf of group ``key`` under its
        placements."""
        return {p: _lead_perm(self.plan.leaves[p], (placements or {}).get(p))
                for p in self.plan.groups[key].leaf_paths}

    def _row_dims(self, key, cur) -> list:
        """The mesh dims that split the stack's rows in the training layout
        (a sharded expert dim), in mesh order, the order ``DTensor`` splits
        a dim over several.  They must be owner dims."""
        dims = [i for i, p in enumerate(cur) if p.is_shard() and p.dim == 0]
        names = self.mesh.mesh_dim_names
        if any(i not in self.owner_dims for i in dims):
            raise ValueError(
                f"group {key!r}: its leading dim is sharded over "
                f"{[names[i] for i in dims]}, not all owner axes "
                f"{[names[i] for i in self.owner_dims]}")
        return dims

    def _blocks_align(self, key) -> bool:
        """Whether each training shard of group ``key``'s rows is a whole
        number of owner blocks: the stack needs no padding and no
        permutation (``_block_peers`` then places the blocks)."""
        g = self.plan.groups[key]
        return g.packed_size == g.count and np.array_equal(
            g.pack_index, np.arange(g.count))

    def _coord_rank(self, coord) -> int:
        # the rank map is a real tensor; the dry run walks this under
        # FakeTensorMode, so read it outside the active modes
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return int(self.mesh.mesh[tuple(coord)])

    def _route(self, key, row_dims) -> "_Route":
        """The exchange that moves group ``key``'s rows between the
        training shards and the padded owner layout where the shards are
        not whole owner blocks (``_blocks_align``).

        Before it, the owner dims that do not split the rows (``n_dims``)
        have cut this rank's training rows, padded to a multiple of their
        extent with zero rows, into chunks of ``k`` (``_issue_to_rows``:
        the reduce-scatter of a ``Partial`` gradient); chunk ``c`` (row-major
        over ``n_dims``) of training shard ``b`` (row-major over
        ``row_dims``) is this rank's.  Logical row ``l`` of the group (the
        leaves' rows, leaf by leaf, the sharded leading dim major) sits in
        shard ``l // share`` of its leaf; the plan puts it at packed position
        ``pos[l]``, on owner ``pos[l] // cap``.  Each rank sends every owner
        the rows of its chunk that owner holds, in chunk order, and takes
        from every holder the rows of its owner block, in the holder's
        chunk order; the pad positions (``pack_index`` -1) stay zero."""
        mesh, g = self.mesh, self.plan.groups[key]
        n_dims = [i for i in self.owner_dims if i not in row_dims]
        me = [mesh.get_local_rank(i) for i in range(mesh.ndim)]

        def index(dims, coord):
            out = 0
            for i in dims:
                out = out * mesh.size(i) + coord[i]
            return out

        def rank(parts):
            """Global rank of (dims, index) parts, the rest of ``me``."""
            coord = list(me)
            for dims, idx in parts:
                for i in reversed(dims):
                    coord[i] = idx % mesh.size(i)
                    idx //= mesh.size(i)
            return self._coord_rank(coord)
        shards = math.prod(mesh.size(i) for i in row_dims)
        chunks = math.prod(mesh.size(i) for i in n_dims)
        counts = np.array([self.plan.leaves[p].count for p in g.leaf_paths])
        shares = counts // shards
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        local_offsets = np.concatenate([[0], np.cumsum(shares)[:-1]])
        rows = int(shares.sum())
        k = -(-rows // chunks)
        cap = g.packed_size // self.shards
        pos = np.empty(g.count, dtype=np.int64)
        real = g.pack_index >= 0
        pos[g.pack_index[real]] = np.nonzero(real)[0]

        # this rank's chunk: local rows j, their logical rows, their owners
        b, c = index(row_dims, me), index(n_dims, me)
        j = np.arange(c * k, min((c + 1) * k, rows))
        leaf = np.searchsorted(local_offsets, j, side="right") - 1
        logical = offsets[leaf] + b * shares[leaf] + j - local_offsets[leaf]
        owner = pos[logical] // cap
        sends = [(rank([(self.owner_dims, int(o))]),
                  j[owner == o] - c * k) for o in np.unique(owner)]

        # this rank's owner block: its real slots and their holders
        o = self.owner_index()
        slots = np.nonzero(g.pack_index[o * cap:(o + 1) * cap] >= 0)[0]
        logical = g.pack_index[o * cap + slots]
        leaf = np.searchsorted(offsets, logical, side="right") - 1
        t = logical - offsets[leaf]
        hb, hj = t // shares[leaf], local_offsets[leaf] + t % shares[leaf]
        holder = np.array([rank([(row_dims, int(x)), (n_dims, int(y))])
                           for x, y in zip(hb, hj // k)], dtype=np.int64)
        recvs = []
        for h in np.unique(holder):
            mine = holder == h
            recvs.append((int(h), slots[mine][np.argsort(hj[mine],
                                                         kind="stable")]))
        return _Route(chunk=k, chunks=chunks, cap=cap,
                      shares=[int(x) for x in shares], sends=sends,
                      recvs=recvs)

    def _block_peers(self, row_dims) -> Optional[tuple]:
        """(to, from) global ranks of the exchange that puts owner blocks
        on their owners, or None when none is needed.  After the owner dims
        that do not split the rows have cut this rank's training rows, it
        holds block A: row-major over ``row_dims`` then those dims; its
        owner block B is row-major over the owner dims.  The block goes to
        the rank whose B is this A, and this rank's B comes from the rank
        whose A it is; both share this rank's other coordinates."""
        mesh = self.mesh
        order_a = list(row_dims) + [i for i in self.owner_dims
                                    if i not in row_dims]
        order_b = list(self.owner_dims)
        if order_a == order_b:
            return None
        me = [mesh.get_local_rank(i) for i in range(mesh.ndim)]

        def index(coord, order):
            out = 0
            for i in order:
                out = out * mesh.size(i) + coord[i]
            return out

        def coord(idx, order):
            out = list(me)
            for i in reversed(order):
                out[i] = idx % mesh.size(i)
                idx //= mesh.size(i)
            return out

        return (self._coord_rank(coord(index(me, order_a), order_b)),
                self._coord_rank(coord(index(me, order_b), order_a)))

    def pack_async(self, key, leaf_values: Dict[str, torch.Tensor],
                   placements: Optional[Dict[str, Placements]] = None
                   ) -> Pending:
        """Training layout -> this rank's owner rows (reduce-to-owner),
        issued: the stack is gathered now (on the current stream) and its
        first collective issued; ``wait()`` gives the rows.  ``leaf_values``
        are local parts; ``placements[path]`` their mesh placements
        (missing: replicated, which needs no communication: ready at
        once).  The moves run one mesh dim after another (``Pending``); a
        stack whose rows are split by a sharded expert dim keeps that split
        (those dims move nothing), is cut by the other owner dims, then
        exchanges whole owner blocks (``_block_peers``); where those shards
        are not whole owner blocks (``_blocks_align``), its rows are padded
        to the other owner dims' extent before they cut it, then each owner
        block is gathered from the chunks that hold its rows
        (``_route``)."""
        perms = self._perms(key, placements)
        if self.mesh is None:
            return Pending(pack_group(self.plan, key, leaf_values, perms))
        cur, mesh = self._stacked(key, placements), self.mesh
        row_dims = self._row_dims(key, cur)
        route = None
        if row_dims and not self._blocks_align(key):
            route = self._route(key, row_dims)
            packed = _pad_rows(_stack(self.plan, key, leaf_values, perms),
                               route.chunk * route.chunks)
        else:
            packed = pack_group(self.plan, key, leaf_values, perms)
        moves = [lambda v, i=i: _issue_to_rows(v, cur[i], i, mesh)
                 for i in self.owner_dims if i not in row_dims]
        if route is not None:
            moves.append(lambda v: _issue_exchange(v, route.sends,
                                                   route.recvs, route.cap))
        elif row_dims and (peers := self._block_peers(row_dims)):
            moves.append(lambda v: _issue_permute(v, *peers))
        moves += [lambda v, i=i: _issue_replicate(v, cur[i], i, mesh)
                  for i in self.other_dims]
        return Pending(packed, moves)

    def pack(self, key, leaf_values: Dict[str, torch.Tensor],
             placements: Optional[Dict[str, Placements]] = None
             ) -> torch.Tensor:
        """``pack_async(...).wait()``: this rank's owner rows."""
        return self.pack_async(key, leaf_values, placements).wait()

    def unpack_async(self, key, packed: torch.Tensor,
                     placements: Optional[Dict[str, Placements]] = None
                     ) -> Pending:
        """This rank's owner rows -> local parts of each leaf in its training
        layout (``published(placements[path])``), the publish direction,
        issued; ``wait()`` gives ``{path: local part}``."""
        perms = self._perms(key, placements)

        def leaves(rows):
            return unpack_group(self.plan, key, rows, perms)
        if self.mesh is None:
            return Pending(packed, then=leaves)
        target, mesh = published(self._stacked(key, placements)), self.mesh
        row_dims = self._row_dims(key, target)
        moves = [lambda v, i=i: (None, lambda: shard_dim(v, target[i], i,
                                                         mesh), ())
                 for i in self.other_dims]
        then = leaves
        if row_dims and not self._blocks_align(key):
            route = self._route(key, row_dims)
            moves.append(lambda v: _issue_exchange(v, route.recvs,
                                                   route.sends, route.chunk))

            def then(rows):
                return _unstack(self.plan, key, rows, perms, route.shares)
        elif row_dims and (peers := self._block_peers(row_dims)):
            to, frm = peers
            moves.append(lambda v: _issue_permute(v, frm, to))
        moves += [lambda v, i=i: _issue_from_rows(v, target[i], i, mesh)
                  for i in reversed(self.owner_dims) if i not in row_dims]
        return Pending(packed, moves, then=then)

    def unpack(self, key, packed: torch.Tensor,
               placements: Optional[Dict[str, Placements]] = None
               ) -> Dict[str, torch.Tensor]:
        """``unpack_async(...).wait()``: ``{path: local part}``."""
        return self.unpack_async(key, packed, placements).wait()

    # ---------------------------------------------------------- local map

    def shard_local(self, fn, tree_in):
        """Run ``fn`` over owner-major stacks: they hold this rank's rows
        only, so the compute is local by construction (no collectives)."""
        return fn(tree_in)
