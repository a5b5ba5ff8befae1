"""Shard-aware checkpointing with atomic commit, rotation, async save and
elastic restore (port of ``repro.checkpoint.manager``).

Layout of one checkpoint, the reference's, file for file:

    <dir>/step_000000123.tmp/         # written first
        manifest.json                 # leaves: shape, dtype, file per path
        leaf_<sha1(path)[:16]>.shard<i>.npz   # 'data' and its global
                                      # 'index' ([start, length] per dim)
    <dir>/step_000000123/             # atomic os.replace commit

A leaf's path joins its keys with '/': dict keys, ``NamedTuple`` field
names (``train/opt_state/momentum/<group>``, ``train/opt_state/adamw/mu/
<param path>``), list positions.  So a checkpoint of either package names
its leaves as the other's does, and the port reads a reference
checkpoint's arrays by path (its pickled JAX ``treedef`` is ignored).  The
reference rebuilds its tree from that ``treedef``; the port writes its own
JSON ``structure`` into the manifest and rebuilds from it, or from ``like``
when one is given (the only way to read a reference checkpoint into a
tree).  None leaves are written as no file and come back as None; Python
ints (``TrainState.step``, ``MuonState.step``) are stored as int64 and come
back as ints; numpy arrays (the data cursor) come back as numpy arrays;
tensors come back as tensors on the device asked for.

``save`` copies every leaf to host memory before it returns (a CUDA tensor
by a device-to-host copy on the calling thread; a CPU tensor by an explicit
clone, because the train step adds its deltas into the parameters in
place), then writes the copies on a background thread (``async_save``), one
save in flight at a time.

Under a ``torch.distributed`` world of more than one rank, leaves are
replicated unless ``save``'s ``row_blocks`` says otherwise: those rank 0
writes once.  Leaves under a ``row_blocks`` prefix (the owner-major
optimizer buffers) hold block ``index`` of ``count`` equal row blocks of
the logical array; each rank writes its block as ``shard<index>`` with its
global row range, so ``restore`` reassembles all D·cap rows.  The commit
across ranks uses files, not collectives, so no writer thread ever issues
a collective beside the training thread's: each rank's writer ends with a
``rank<r>.done`` file in the ``.tmp``
directory, rank 0's writer waits for every rank's, writes the manifest and
commits, and every other rank's writer waits for the commit.  ``wait()``
therefore returns, on every rank, once the checkpoint is committed.  Only
``save`` itself, on the calling thread, runs one barrier (after rank 0 has
removed a ``.tmp`` left by an earlier, failed incarnation of the job).
Every rank must see the same directory (one host, or a shared file
system).
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import re
import shutil
import threading
import time
from collections import deque
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")
COMMIT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class RowBlocks:
    """This rank's part of the leaves under some path prefixes: block
    ``index`` of ``count`` equal blocks of rows (axis 0) of each logical
    array.  Exactly one rank may hold each block (the owner axes span the
    mesh)."""
    prefixes: Tuple[str, ...]
    index: int
    count: int

    def covers(self, path: str) -> bool:
        return any(path == p or path.startswith(p + "/")
                   for p in self.prefixes)


def _leaf_file(path: str) -> str:
    h = hashlib.sha1(path.encode()).hexdigest()[:16]
    return f"leaf_{h}"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(node, prefix: tuple, leaves: List[Tuple[str, Any]]):
    """(structure, leaves): the JSON structure of ``node`` and its
    (path, leaf) pairs appended to ``leaves``."""
    path = "/".join(prefix)
    if node is None:
        return {"none": True}
    if isinstance(node, Mapping):
        return {"dict": [[str(k), _flatten(v, prefix + (str(k),), leaves)]
                         for k, v in node.items()]}
    if _is_namedtuple(node):
        cls = type(node)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": [[f, _flatten(getattr(node, f), prefix + (f,),
                                        leaves)] for f in node._fields]}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [
            _flatten(v, prefix + (str(i),), leaves)
            for i, v in enumerate(node)]}
    if isinstance(node, torch.Tensor):
        leaves.append((path, node))
        return {"leaf": "tensor", "requires_grad": node.requires_grad}
    # bool before int: a bool is an int
    for types, kind in (((bool, np.bool_), "bool"), ((int, np.integer), "int"),
                        ((float,), "float"), ((np.ndarray,), "ndarray")):
        if isinstance(node, types):
            leaves.append((path, node))
            return {"leaf": kind}
    raise TypeError(f"checkpoint leaf {path!r}: unsupported type "
                    f"{type(node).__name__}")


def _to_host(path: str, leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that nothing else references, and its dtype
    name.  bfloat16 (which numpy lacks) travels as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        if type(leaf) is not torch.Tensor and \
                not isinstance(leaf, torch.nn.Parameter):
            raise TypeError(f"checkpoint leaf {path!r}: a "
                            f"{type(leaf).__name__}; pass each rank's local "
                            "tensor")
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        # .cpu() of a CPU tensor is the same storage: clone it
        host = t.cpu() if t.device.type != "cpu" else t.clone()
        return host.numpy(), name
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_), "bool"
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(int(leaf), np.int64), "int64"
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float64), "float64"
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _wait_for(what: str, ready, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} not there after "
                               f"{timeout:.0f} s")
        time.sleep(0.02)


class CheckpointManager:
    """Checkpoints of one run under ``directory``: the last ``keep``
    committed steps, saved asynchronously unless ``async_save`` is off
    (see the module docstring)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last saves' host-clock seconds: {"step", "snapshot_s" (the
        # synchronous copy in ``save``), "write_s" (writing and committing;
        # on a background thread when async)}
        self.timings: deque = deque(maxlen=16)
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir, f"step_{step:09d}"
                            + (".tmp" if tmp else ""))

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, *, block: bool = False,
             row_blocks: Optional[RowBlocks] = None) -> None:
        """Snapshot ``tree`` to host memory now; write and commit it on a
        background thread (``async_save``, unless ``block``) or before
        returning.  ``row_blocks``: see the module docstring."""
        self.wait()                       # one in-flight save at a time
        t0 = time.perf_counter()
        rank, world = _world()
        leaves: List[Tuple[str, Any]] = []
        structure = _flatten(tree, (), leaves)
        manifest = {"step": step, "leaves": {}, "structure": structure}
        host = []
        for path, leaf in leaves:
            rows = row_blocks is not None and row_blocks.covers(path)
            if not rows and rank != 0:
                continue                  # replicated: rank 0 writes it
            arr, dtype = _to_host(path, leaf)
            shape, start, shard = arr.shape, 0, 0
            if rows:
                shape = (arr.shape[0] * row_blocks.count,) + arr.shape[1:]
                start, shard = row_blocks.index * arr.shape[0], \
                    row_blocks.index
            if rank == 0:
                manifest["leaves"][path] = {"shape": list(shape),
                                            "dtype": dtype,
                                            "file": _leaf_file(path)}
            index = np.asarray([[start, arr.shape[0]]] + [
                [0, s] for s in arr.shape[1:]] if arr.ndim else [],
                dtype=np.int64).reshape(-1, 2)
            host.append((f"{_leaf_file(path)}.shard{shard}.npz", arr, index))
        tmp = self._step_dir(step, tmp=True)
        if rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)            # left by a save that died
        if world > 1:
            import torch.distributed as dist
            dist.barrier()

        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)

        def write():
            t1 = time.perf_counter()
            os.makedirs(tmp, exist_ok=True)
            for name, arr, index in host:
                np.savez(os.path.join(tmp, name), data=arr, index=index)
            if world > 1:
                open(os.path.join(tmp, f"rank{rank}.done"), "w").close()
            if rank == 0:
                self._commit(step, manifest, world)
            else:
                final = os.path.join(self._step_dir(step), "manifest.json")
                _wait_for(f"rank 0's commit of step {step}",
                          lambda: os.path.exists(final), COMMIT_TIMEOUT_S)
            timing["write_s"] = time.perf_counter() - t1

        if self.async_save and not block:
            self._thread = threading.Thread(target=self._run, args=(write,),
                                            daemon=True)
            self._thread.start()
        else:
            write()

    def _run(self, write) -> None:
        try:
            write()
        except BaseException as e:        # re-raised by wait()
            self._error = e

    def _commit(self, step: int, manifest: dict, world: int) -> None:
        tmp, final = self._step_dir(step, tmp=True), self._step_dir(step)
        if world > 1:
            done = [os.path.join(tmp, f"rank{r}.done") for r in range(world)]
            _wait_for(f"every rank's shards of step {step}",
                      lambda: all(os.path.exists(f) for f in done),
                      COMMIT_TIMEOUT_S)
            for f in done:
                os.remove(f)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)            # atomic commit
        self._rotate()

    def wait(self) -> None:
        """Until the save in flight is committed; re-raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                device: DeviceLike = None) -> Any:
        """The tree saved at ``step`` (default: the latest committed).

        Every leaf comes back whole: a leaf saved in row blocks by several
        ranks is reassembled to all its rows, and the caller keeps its own
        (``OwnerLayout.local_block``), after ``reshard_owner_state`` where
        the owner count changed.  ``like``: a tree whose structure the
        result takes (needed for a reference checkpoint, which has no
        port ``structure``); its tensors give each restored tensor's
        device and ``requires_grad``, unless ``device`` is given.  Without
        ``like``, tensors go to ``device`` (CUDA unless given)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for path, meta in manifest["leaves"].items():
            if meta.get("none"):
                continue
            arr = _assemble(d, meta)
            arrays[path] = torch.from_numpy(arr).view(torch.bfloat16) \
                if meta["dtype"] == "bfloat16" else arr
        if like is not None:
            leaves: List[Tuple[str, Any]] = []
            structure = _flatten(like, (), leaves)
            like_leaf = dict(leaves)
            dev = None if device is None else resolve_device(device)
        elif "structure" in manifest:
            structure, like_leaf = manifest["structure"], {}
            dev = resolve_device(device)
        else:
            return _nested(arrays)
        return _build(structure, (), arrays, like_leaf, dev)


def _assemble(d: str, meta: dict) -> np.ndarray:
    """Reassemble a logical array from its shard files (host numpy; a
    bfloat16 leaf as its int16 bits)."""
    shape = tuple(meta["shape"])
    dtype = np.int16 if meta["dtype"] == "bfloat16" else meta["dtype"]
    out = None
    i = 0
    while True:
        fp = os.path.join(d, f"{meta['file']}.shard{i}.npz")
        if not os.path.exists(fp):
            break
        with np.load(fp) as z:
            data, index = z["data"], z["index"]
        if i == 0 and tuple(data.shape) == shape:
            return data.astype(dtype, copy=False)
        if out is None:
            out = np.zeros(shape, dtype=dtype)
        out[tuple(slice(int(a), int(a) + int(b)) for a, b in index)] = data
        i += 1
    if out is None:
        raise FileNotFoundError(fp)
    return out


def _nested(arrays: Dict[str, np.ndarray]) -> dict:
    """{'a/b': x} -> {'a': {'b': x}}."""
    root: dict = {}
    for path, arr in arrays.items():
        *parents, last = path.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr
    return root


def _namedtuple_class(name: str):
    module, _, qual = name.partition(":")
    if module.split(".")[0] != "repro_torch":
        raise ValueError(f"checkpoint structure names {name!r}, outside "
                         "repro_torch")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _build(st: dict, prefix: tuple, arrays: dict, like_leaf: dict, dev):
    path = "/".join(prefix)
    if "none" in st:
        return None
    if "dict" in st:
        return {k: _build(v, prefix + (k,), arrays, like_leaf, dev)
                for k, v in st["dict"]}
    if "namedtuple" in st:
        cls = _namedtuple_class(st["namedtuple"])
        return cls(**{f: _build(v, prefix + (f,), arrays, like_leaf, dev)
                      for f, v in st["fields"]})
    for kind in ("list", "tuple"):
        if kind in st:
            items = [_build(v, prefix + (str(i),), arrays, like_leaf, dev)
                     for i, v in enumerate(st[kind])]
            return items if kind == "list" else tuple(items)
    if path not in arrays:
        raise KeyError(f"checkpoint has no leaf {path!r}")
    arr, kind = arrays[path], st["leaf"]
    if kind == "int":
        return int(arr)
    if kind == "float":
        return float(arr)
    if kind == "bool":
        return bool(arr)
    if kind == "ndarray":
        return arr
    like = like_leaf.get(path)
    t = torch.as_tensor(arr)
    t = t.to(dev if dev is not None or like is None else like.device)
    if st.get("requires_grad"):
        t.requires_grad_(True)
    return t
