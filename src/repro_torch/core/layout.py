"""Fine-grained owner-slot layout (port of ``repro.core.layout``; paper
§3.2.1, Eq. 3, generalized).

The paper maps the logical index ``w`` of a matrix in the communication
schedule to an owner slot on a (nodes × gpus-per-node) mesh:

    gpu(w)  = w mod C
    node(w) = (w mod R) xor (floor(w / C) mod R)          (Eq. 3, 4×8 mesh)

The ``gpu`` term disperses consecutive matrices across the C inter-node
columns; the XOR term rotates the owner node across groups of C matrices, so
a lookahead window of publications never concentrates on a single column.

On GPUs "columns" are the cards of a host (NVLink) and "nodes" the hosts.
The layout orders owner slots in the stacked owner-major buffers so that
adjacent layers' collective traffic lands on different columns.

The XOR rule requires R to be a power of two (and balance additionally needs
R | C, as in the paper's 4×8); otherwise we fall back to an additive rotation
with identical dispersal and balance properties.
"""

from __future__ import annotations

import numpy as np


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def owner_slot(w: int, rows: int, cols: int) -> int:
    """Owner slot (node*cols + gpu) for logical matrix index ``w`` (Eq. 3)."""
    gpu = w % cols
    if _is_pow2(rows) and cols % rows == 0:
        node = (w % rows) ^ ((w // cols) % rows)
    else:  # additive rotation: same dispersal, valid for any (rows, cols)
        node = (w % rows + (w // cols)) % rows
    return node * cols + gpu


def slot_sequence(count: int, rows: int, cols: int) -> np.ndarray:
    """Owner slots for matrices w = 0..count-1."""
    return np.asarray([owner_slot(w, rows, cols) for w in range(count)],
                      dtype=np.int64)


def xor_permutation(count: int, rows: int, cols: int) -> np.ndarray:
    """A permutation of 0..count-1 ordering matrices so that, scanned in
    order, their owner slots follow the XOR layout.

    Used to order members inside a stacked owner-sharded shape group: position
    p of the padded stack belongs to owner ``p // capacity``; this permutation
    spreads consecutive logical matrices (adjacent layers) over distinct
    columns exactly as Fig. 4 does.
    """
    d = rows * cols
    slots = slot_sequence(count, rows, cols)
    # stable order: sort by (slot, arrival) — matrices owned by slot s keep
    # their schedule order within the slot.
    order = np.lexsort((np.arange(count), slots))
    del d
    return order


def column_of_slot(slot: int, cols: int) -> int:
    return slot % cols


def node_of_slot(slot: int, cols: int) -> int:
    return slot // cols
