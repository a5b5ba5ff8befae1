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

Leaves with sharded *leading* dims (MoE expert parallelism) wait for
ROADMAP item 9.  This module knows nothing about optimization:
``core/muon.py`` composes an :class:`OwnerLayout` with an orthogonalizer
and an update rule.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

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


def _leaf_to_matrices(arr: torch.Tensor, info) -> torch.Tensor:
    """(lead..., m0, n0) -> (count, m, n) with m <= n.  Reads the trailing
    dims off ``arr``, so a local shard reshapes as the whole leaf does."""
    flat = arr.reshape((-1,) + tuple(arr.shape[-2:]))
    return flat.mT if info.transpose else flat


def _matrices_to_leaf(flat: torch.Tensor, info) -> torch.Tensor:
    if info.transpose:
        flat = flat.mT
    return flat.reshape(tuple(info.shape[:-2]) + tuple(flat.shape[-2:]))


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def pack_group(plan: DedicationPlan, key,
               leaf_values: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack a shape group's matrices into the owner-major padded layout:
    (num_owners * capacity, m, n); position p belongs to owner p // capacity.
    On one process; ``OwnerLayout.pack`` moves the result across ranks."""
    g = plan.groups[key]
    parts = [_leaf_to_matrices(leaf_values[p], plan.leaves[p])
             for p in g.leaf_paths]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
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


def unpack_group(plan: DedicationPlan, key,
                 packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of pack_group: owner-major stack -> per-leaf tensors."""
    g = plan.groups[key]
    if np.array_equal(g.unpack_index, np.arange(g.count)):
        flat = packed[:g.count]            # contiguous layout: pure slice
    else:
        flat = packed.index_select(0, _index(g.unpack_index, packed.device))
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for p in g.leaf_paths:
        info = plan.leaves[p]
        out[p] = _matrices_to_leaf(flat[start:start + info.count], info)
        start += info.count
    return out


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
    of stack dim 1 / 2 (swapped for a transposed leaf)."""
    n_lead = len(info.shape) - 2
    out, seen = [], set()
    for p in placements:
        if p.is_shard():
            d = p.dim % len(info.shape)
            if d < n_lead:
                raise ValueError(
                    f"{info.path}: leading dim {d} is sharded (expert "
                    "parallelism); owner layouts of such leaves wait for "
                    "ROADMAP item 9")
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

    def pack_async(self, key, leaf_values: Dict[str, torch.Tensor],
                   placements: Optional[Dict[str, Placements]] = None
                   ) -> Pending:
        """Training layout -> this rank's owner rows (reduce-to-owner),
        issued: the stack is gathered now (on the current stream) and its
        first collective issued; ``wait()`` gives the rows.  ``leaf_values``
        are local parts; ``placements[path]`` their mesh placements
        (missing: replicated, which needs no communication: ready at
        once).  The moves run one mesh dim after another (``Pending``)."""
        packed = pack_group(self.plan, key, leaf_values)
        if self.mesh is None:
            return Pending(packed)
        cur, mesh = self._stacked(key, placements), self.mesh
        moves = [lambda v, i=i: _issue_to_rows(v, cur[i], i, mesh)
                 for i in self.owner_dims]
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
        def leaves(rows):
            return unpack_group(self.plan, key, rows)
        if self.mesh is None:
            return Pending(packed, then=leaves)
        target, mesh = published(self._stacked(key, placements)), self.mesh
        moves = [lambda v, i=i: (None, lambda: shard_dim(v, target[i], i,
                                                         mesh), ())
                 for i in self.other_dims]
        moves += [lambda v, i=i: _issue_from_rows(v, target[i], i, mesh)
                  for i in reversed(self.owner_dims)]
        return Pending(packed, moves, then=leaves)

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
