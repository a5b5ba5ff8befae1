"""Owner-layout machinery, single-process part (port of
``repro.core.owner_comms``).

Everything about *where matrices live*: the leaf↔matrix reshapes, the
owner-major packed stacking and its inverse.  With one process the owner
layout is a permutation plus zero padding of each shape group's stack; the
staged all-to-alls that move it between ranks wait for ROADMAP item 6, so
``OwnerLayout`` takes ``mesh=None`` only.

It knows nothing about optimization: ``core/muon.py`` composes an
:class:`OwnerLayout` with an orthogonalizer and an update rule.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.dedication import DedicationPlan


def group_key_str(key) -> str:
    """Sanitize a group key for use as a state-dict key ('/' would collide
    with a checkpoint manifest's path separator)."""
    return key.replace("/", ".") if isinstance(key, str) else \
        f"{key[0]}x{key[1]}"


def _leaf_to_matrices(arr: torch.Tensor, info) -> torch.Tensor:
    """(lead..., m0, n0) -> (count, m, n) with m <= n."""
    m0, n0 = info.shape[-2:]
    flat = arr.reshape((-1, m0, n0))
    return flat.mT if info.transpose else flat


def _matrices_to_leaf(flat: torch.Tensor, info) -> torch.Tensor:
    if info.transpose:
        flat = flat.mT
    return flat.reshape(info.shape)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def pack_group(plan: DedicationPlan, key,
               leaf_values: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack a shape group's matrices into the owner-major padded layout:
    (num_owners * capacity, m, n); position p belongs to owner p // capacity."""
    g = plan.groups[key]
    parts = [_leaf_to_matrices(leaf_values[p], plan.leaves[p])
             for p in g.leaf_paths]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    m, n = g.key
    n_pad = g.packed_size - g.count
    if np.array_equal(g.pack_index[:g.count], np.arange(g.count)):
        # contiguous physical layout: a pure pad
        if n_pad == 0:
            return flat.contiguous()
        return torch.cat([flat, flat.new_zeros((n_pad, m, n))], dim=0)
    flat_ext = torch.cat([flat, flat.new_zeros((1, m, n))], dim=0)
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


class OwnerLayout:
    """The pack/unpack half of the optimizer, bound to a plan (one process)."""

    def __init__(self, plan: DedicationPlan, mesh=None,
                 device: Optional[torch.device] = None):
        if mesh is not None:
            raise ValueError("owner layouts across ranks are not ported yet "
                             "(ROADMAP item 6); pass mesh=None")
        self.plan = plan
        self.mesh = None
        self.device = device

    def zeros(self, key, dtype) -> torch.Tensor:
        """Zero (D·cap, m, n) state buffer for group ``key``."""
        g = self.plan.groups[key]
        return torch.zeros((g.packed_size,) + g.key, dtype=dtype,
                           device=self.device)

    def pack(self, key, leaf_values: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training layout -> owner-major stack."""
        return pack_group(self.plan, key, leaf_values)

    def unpack(self, key, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Owner-major stack -> training layout."""
        return unpack_group(self.plan, key, packed)

    def shard_local(self, fn, tree_in):
        """Run ``fn`` over the owner-major stacks: with one process every
        owner's matrices are local."""
        return fn(tree_in)
