"""Serving-step functions (port of ``repro.train.serve``): prefill, chunked
prefill and decode over the decode cache of ``models.model_fns(cfg)``, and
the cache's shapes without allocation.

Under a ("data", "model") mesh (the dense and MoE families) each function
takes the mesh seen from one rank, a ``MeshContext``: the parameters are
this rank's parts as ``models.sharding.param_specs`` places them (ZeRO-3's
for the >= 340 B configs), and the cache this rank's part as
``cache_specs`` places it, allocated as that part from the start
(``init_cache_part``, the counterpart of the reference's
``cache_shardings``).  The other families train split over a mesh but
serve on one card: their caches split by ``cache_specs`` (conv channels,
SSM state, the xLSTM memories) are ROADMAP item 6's serving half.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import tree
from repro_torch.models import model_fns
from repro_torch.models import tp as tp_lib
from repro_torch.models.sharding import (cache_specs, local_part,
                                         local_shape, param_specs,
                                         shard_range)


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The serving mesh seen from one rank: its model axis (``tp``, None
    where it holds one rank), its data axes (``dp``: the rows the MoE
    dispatch ranks over; None where they hold one rank, or where every
    data rank runs the whole batch), ZeRO-3's weights split over 'data'
    (``zero``), and the parameters' specs and whole shapes by path."""
    mesh: Any
    tp: Optional[tp_lib.ModelParallel]
    dp: Optional[tp_lib.DataParallel]
    zero: Optional[tp_lib.ZeroShards]
    specs: dict
    shapes: dict

    def kwargs(self, max_len: Optional[int] = None) -> dict:
        """The model functions' keywords (``max_len``: the whole cache's
        positions, for the chunked prefill and decode)."""
        out = dict(tp=self.tp, dp=self.dp, zero=self.zero)
        if max_len is not None:
            out["max_len"] = max_len
        return out

    def whole_batch(self) -> "MeshContext":
        """The context of a batch every data rank runs whole (no ``dp``)."""
        return dataclasses.replace(self, dp=None)


def mesh_context(cfg, mesh, *, zero3: bool = False) -> MeshContext:
    """``MeshContext`` of serving ``cfg`` on ``mesh`` (its parameters split
    by ``param_specs(..., zero3=zero3)``).  Raises ``NotImplementedError``
    for a family that does not serve under a mesh
    (``models.tp.serves_split``; ROADMAP item 6, its serving half)."""
    if not tp_lib.serves_split(cfg):
        raise NotImplementedError(
            f"serving the {cfg.family} family under a mesh is not ported "
            "(ROADMAP item 6, its serving half; the training half is "
            "ported): serve it on one card")
    shapes = model_fns(cfg).init(cfg, device="meta")
    specs = param_specs(cfg, shapes, mesh, zero3=zero3)
    mp = tp_lib.model_parallel(mesh)
    return MeshContext(mesh, mp if mp is not None and mp.size > 1 else None,
                       tp_lib.data_parallel(mesh),
                       tp_lib.zero_shards(mesh, specs), specs,
                       {p: tuple(v.shape) for p, v in tree.flatten(shapes)})


def local_params(params, ctx: MeshContext):
    """``params`` as this rank's parts: a leaf of its whole shape is cut by
    ``local_part`` (a view; the same whole tensor on every rank), a leaf
    already of its part's shape (``train.step.init_parts``) kept."""
    out = {}
    for p, v in tree.flatten(params):
        part = local_shape(ctx.shapes[p], ctx.specs[p], ctx.mesh)
        if tuple(v.shape) == part:
            out[p] = v
        elif tuple(v.shape) == ctx.shapes[p]:
            out[p] = local_part(v, ctx.specs[p], ctx.mesh)
        else:
            raise ValueError(f"{p}: {tuple(v.shape)} is neither the whole "
                             f"leaf nor this rank's part {part}")
    return tree.rebuild(params, out)


def init_cache_part(cfg, batch: int, max_len: int, mesh,
                    cache_dtype=torch.bfloat16, device=None):
    """This rank's part of the decode cache of ``batch`` slots and
    ``max_len`` positions, each leaf zeros of ``local_shape`` under
    ``cache_specs`` (the slots over the data axes where they divide them,
    the KV heads or the sequence over 'model'): the whole cache never
    exists on one card.  Returns (cache, (first, end) of this rank's
    slots)."""
    shapes = make_cache_shapes(cfg, batch, max_len, cache_dtype)
    specs = cache_specs(cfg, shapes, mesh)
    flat = dict(tree.flatten(shapes))
    cache = tree.rebuild(shapes, {
        p: torch.zeros(local_shape(v.shape, specs[p], mesh), dtype=v.dtype,
                       device=device) for p, v in flat.items()})
    p0 = next(iter(flat))
    local = local_shape(flat[p0].shape, specs[p0], mesh)
    _, start, _, _ = shard_range(specs[p0], mesh, local)
    return cache, (start[1], start[1] + local[1])


def prefill_fn(cfg, params, tokens, max_len: int, *,
               cache_dtype=torch.bfloat16, ctx: Optional[MeshContext] = None,
               **kwargs):
    """Prefill of ``tokens`` (B, S) into a fresh cache of ``max_len``
    positions: (last-token logits, cache).  ``frames`` (enc-dec, audio
    frontend) or ``patches`` (VLM) as keywords.  ``ctx``: under a mesh,
    this rank's parameter parts and cache part."""
    m = model_fns(cfg)
    if cfg.encdec:
        return m.prefill(cfg, params, tokens, frames=kwargs["frames"],
                         max_len=max_len, cache_dtype=cache_dtype)
    if cfg.family == "ssm":
        return m.prefill(cfg, params, tokens, max_len)
    if ctx is not None:
        kwargs.update(ctx.kwargs())
    return m.prefill(cfg, params, tokens, max_len,
                     cache_dtype=cache_dtype, **kwargs)


def prefill_chunk_fn(cfg, params, tokens, cache, pos, block_tables=None, *,
                     ctx: Optional[MeshContext] = None,
                     max_len: Optional[int] = None):
    """Chunked-prefill continuation: write a prompt chunk at
    [pos, pos + S) of an existing cache (decoder-only, token-only).
    ``block_tables`` (1, W) writes the chunk straight into a paged pool
    cache through the request's block table (serve/paged.py).  ``ctx`` /
    ``max_len``: under a mesh, the cache this rank's part of a
    ``max_len``-position cache."""
    if cfg.encdec:
        raise NotImplementedError(
            "chunked prefill covers decoder-only families; enc-dec prompts "
            "prefill in one shot")
    kw = {} if ctx is None else ctx.kwargs(max_len)
    return model_fns(cfg).prefill_chunk(cfg, params, tokens, cache, pos,
                                        block_tables=block_tables, **kw)


def decode_fn(cfg, params, token, cache, pos, block_tables=None, *,
              ctx: Optional[MeshContext] = None,
              max_len: Optional[int] = None):
    """One decode step; ``pos`` is a scalar, or a (B,) tensor of per-slot
    positions when driven by the continuous-batching scheduler.  With
    ``block_tables`` (B, W) the attention cache is the paged pool layout
    (serve/paged.py) instead of contiguous per-slot rows.  ``ctx`` /
    ``max_len`` as ``prefill_chunk_fn``'s; with ``ctx.dp`` the rows are
    this rank's slots."""
    kw = {} if ctx is None else ctx.kwargs(max_len)
    return model_fns(cfg).decode_step(cfg, params, token, cache, pos,
                                      block_tables=block_tables, **kw)


def make_cache_shapes(cfg, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16):
    """The decode cache as ``device="meta"`` tensors (shapes and dtypes,
    no allocation); enc-dec caches take ``enc_len = max_len``, as the
    reference's."""
    m = model_fns(cfg)
    if cfg.encdec:
        return m.init_cache(cfg, batch, max_len, max_len, cache_dtype,
                            device="meta")
    return m.init_cache(cfg, batch, max_len, cache_dtype, device="meta")
