"""Nested-dict parameter trees addressed by '/'-joined paths.

The reference keeps parameters as JAX pytrees and names every leaf by its
key path.  The port keeps nested dicts of tensors and visits dict keys in
sorted order at every level, exactly as ``jax.tree_util`` does, so leaf
order, dedication offsets and packed layouts agree key for key.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch


def flatten(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order.  An ``nn.Module`` is
    read through ``named_parameters()`` ('.' in a name becomes '/')."""
    if isinstance(tree, torch.nn.Module):
        tree = from_named(tree.named_parameters())
    out: List[Tuple[str, Any]] = []
    _flatten_into(out, tree, ())
    return out


# The walks are module functions, not closures: a nested function that
# calls itself is a reference cycle (function -> cell -> function) holding
# its enclosing variables, so every tensor of a flattened or rebuilt tree
# would outlive the call until Python's cyclic collector ran.

def _flatten_into(out: list, node, prefix: tuple) -> None:
    if node is None:
        return
    if isinstance(node, Mapping):
        for k in sorted(node):
            _flatten_into(out, node[k], prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten_into(out, v, prefix + (str(i),))
    else:
        out.append(("/".join(prefix), node))


def from_named(named: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """Nested dict from ('a.b.c', value) pairs, e.g. ``named_parameters()``."""
    root: Dict[str, Any] = {}
    for name, value in named:
        *parents, last = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    return root


def rebuild(tree_like, values: Dict[str, Any]):
    """A tree of ``tree_like``'s structure whose leaf at each path is
    ``values[path]``."""
    return _rebuild(tree_like, values, ())


def _rebuild(node, values: Dict[str, Any], prefix: tuple):
    if isinstance(node, Mapping):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(node))
    if node is None:
        return None
    return values["/".join(prefix)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    flat = flatten(tree)
    others = [dict(flatten(t)) for t in rest]
    return rebuild(tree, {p: fn(v, *(o[p] for o in others)) for p, v in flat})
