"""Op-level cost walker (the port's counterpart of
``repro.launch.hlo_walker``, ``src/repro/launch/hlo_walker.py``).

The reference compiles a step with XLA and walks the optimized HLO text,
because XLA's ``cost_analysis`` counts each ``while`` body once.  The port
runs eagerly: there is no HLO and no compiled program, so there is nothing
to parse.  ``OpWalker`` is a ``TorchDispatchMode`` that sees every aten and
c10d op the step issues, as it issues it, and accumulates the reference's
``Costs``:

    flops       — ``torch.utils.flop_counter``'s registry (matmuls, bmm,
                  convolutions, attention kernels), split by the dtype of
                  the op's first operand (``flops_by_dtype``), so that the
                  roofline divides each dtype by its own peak
    bytes       — operand plus output sizes of every aten op that is not a
                  view (op granularity: the eager counterpart of "a fusion
                  reads its operands and writes its output"); a
                  collective's buffers, each once
    coll        — input-operand bytes of every collective, per kind: the
                  c10d ops of ``torch.distributed`` (``owner_comms``'
                  reduce-scatters, all-to-alls, all-gathers, all-reduces;
                  a point-to-point send is a ``collective-permute``) and
                  the functional collectives of ``DTensor`` redistributions

There are no trip counts to infer: an eager loop runs its body as many
times as it says, and each run passes through the mode.

It also tracks the peak of live device bytes, the counterpart of XLA's
``memory_analysis``: every storage an op creates is counted from its
creation to its release (a weak reference whose callback fires when the
storage is freed, as ``torch.distributed._tools.mem_tracker`` does), each
rounded up to the CUDA caching allocator's 512-byte blocks.  Storages that
exist before the walk (parameters, optimizer state, the batch) are counted
by ``track_arguments``.  ``memory()`` reports them under the reference's
key names.

The walk works on real tensors (on the card) and under ``FakeTensorMode``
(the dry run: shapes only, nothing allocated; enter the fake mode first).
Ops on a tensor subclass other than a fake tensor (``DTensor``) are handed
to the subclass, whose ops on its local tensors then pass through the walk.
"""

from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512

# (namespace, op name) -> (kind, index of the input operand(s) in args)
_COLLECTIVE_OPS = {
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 0),
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
}


_PRIM_DEVICE = torch.ops.prim.device.default


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@dataclass
class Costs:
    """The reference's ``Costs`` (``src/repro/launch/hlo_walker.py:131``)
    plus ``flops_by_dtype``; ``snapshot`` and ``minus`` take the costs of
    a part of a walk."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: {
        k: 0.0 for k in _COLLECTIVES})
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    def scaled(self, k: float) -> "Costs":
        return Costs(self.flops * k, self.bytes * k,
                     {kk: v * k for kk, v in self.coll.items()},
                     {kk: v * k for kk, v in self.flops_by_dtype.items()})

    def minus(self, o: "Costs") -> "Costs":
        """What was added since ``o`` (a ``snapshot`` of these costs)."""
        return Costs(self.flops - o.flops, self.bytes - o.bytes,
                     {k: v - o.coll[k] for k, v in self.coll.items()},
                     {k: v - o.flops_by_dtype.get(k, 0.0)
                      for k, v in self.flops_by_dtype.items()})

    def snapshot(self) -> "Costs":
        return self.scaled(1.0)

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


def _rounded(nbytes: int) -> int:
    return math.ceil(nbytes / ALLOC_ROUND) * ALLOC_ROUND


class OpWalker(TorchDispatchMode):
    """``with OpWalker() as w: step(...)``; then ``w.costs``, ``w.peak``
    and ``w.memory(outputs)``.  See the module docstring."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.live = 0            # bytes of the live tracked storages
        self.peak = 0
        self.argument = 0
        self._refs: Dict[int, tuple] = {}   # id(storage) -> (ref, bytes)
        self._arguments: set = set()        # id(storage) of the arguments
        # a storage may die on the autograd engine's device thread
        self._lock = threading.RLock()

    # ------------------------------------------------------------ memory

    def _track(self, t: torch.Tensor, *, argument: bool = False) -> None:
        if type(t) not in (torch.Tensor, torch.nn.Parameter) and \
                not _is_fake(t):
            return
        st = t.untyped_storage()
        with self._lock:
            self._add(st, argument)

    def _add(self, st, argument: bool) -> None:
        key = id(st)
        if key in self._refs:
            ref, old = self._refs[key]
            new = _rounded(st.nbytes())
            if ref() is st and new != old:          # resized in place
                self._refs[key] = (ref, new)
                self.live += new - old
                self.peak = max(self.peak, self.live)
            if ref() is st:
                return
            self.live -= old                        # a stale entry
        nbytes = _rounded(st.nbytes())
        ref = weakref.ref(st, self._released(key))
        self._refs[key] = (ref, nbytes)
        self.live += nbytes
        if argument:
            self.argument += nbytes
            self._arguments.add(key)
        self.peak = max(self.peak, self.live)

    def _released(self, key: int):
        def done(ref):
            with self._lock:
                entry = self._refs.get(key)
                if entry is not None and entry[0] is ref:
                    del self._refs[key]
                    self.live -= entry[1]
        return done

    def track_arguments(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (the step's inputs,
        alive before the walk) as ``argument`` bytes."""
        for t in _tensors(tree):
            if hasattr(t, "to_local"):
                t = t.to_local()
            self._track(t, argument=True)

    def memory(self, outputs=None) -> dict:
        """The reference's ``memory_analysis`` keys: ``argument`` (inputs
        tracked before the walk), ``output`` (the storages of ``outputs``
        that are alive), ``alias`` (those of them that are arguments too:
        parameters updated in place), ``temp`` (the rest of the peak), and
        ``total_bytes`` = argument + output + temp − alias = the peak."""
        out = alias = 0
        seen = set()
        for t in _tensors(outputs):
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            entry = self._refs.get(id(st))
            nbytes = _rounded(st.nbytes())
            out += nbytes
            if entry is not None and entry[0]() is st and \
                    id(st) in self._arguments:
                alias += nbytes
        temp = self.peak - self.argument - out + alias
        return {"argument_size_in_bytes": self.argument,
                "output_size_in_bytes": out,
                "temp_size_in_bytes": temp,
                "generated_code_size_in_bytes": 0,
                "alias_size_in_bytes": alias,
                "total_bytes": self.peak}

    # ---------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _PRIM_DEVICE:          # a device query, most calls
            return func(*args)
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               and not _is_fake_type(t) for t in types):
            return NotImplemented        # a subclass (DTensor) unwraps first
        packet = func._overloadpacket
        key = (packet._qualified_op_name.split("::")[0], packet.__name__)
        coll = _COLLECTIVE_OPS.get(key)
        if coll is None and packet not in flop_registry:
            # a composite op (``matmul`` under ``inference_mode`` reaches
            # the mode whole): count its parts, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if coll is not None:
            kind, idx = coll
            self.costs.coll[kind] += _nbytes(args[idx])
            # its buffers (input and output, each once) cross HBM too
            self.costs.bytes += _nbytes(list({
                id(t): t for t in _tensors((args, out))}.values()))
            return out
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            first = _tensors(args)[0]
            dt = _dtype_name(first)
            self.costs.flops += flops
            self.costs.flops_by_dtype[dt] = \
                self.costs.flops_by_dtype.get(dt, 0.0) + flops
        if not func.is_view:
            self.costs.bytes += _nbytes(args) + _nbytes(kwargs) + \
                _nbytes(out)
        for t in _tensors(out):
            self._track(t)
        return out


def _is_fake_type(t) -> bool:
    return issubclass(t, FakeTensor)


def _is_fake(t) -> bool:
    return _is_fake_type(type(t))
