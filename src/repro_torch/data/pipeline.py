"""Deterministic synthetic token pipeline (port of ``repro.data.pipeline``).

Batches are keyed by (seed, step): ``_batch_at`` is the reference's pure
numpy function, so both packages see byte-identical batches, and a restart
from a checkpoint at step k regenerates exactly the batches k, k+1, ...
(the determinism contract fault-tolerant training needs: the checkpoint
stores the step, nothing else).

``Pipeline`` keeps a bounded queue of numpy batches ahead of the training
loop on a background thread (input latency hides under step compute) and
places each on the device as ``__next__`` hands it out, on the caller's
thread; ``batch_for_step`` is the direct, thread-free access.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.sharding import (batch_spec, dp_axes, entry_axes,
                                         local_batch)


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: repeated n-gram process so loss can actually fall
    ngram: int = 3


def _batch_at(cfg: DataConfig, step: int) -> dict:
    """Deterministic batch for ``step`` (pure function — restart-safe)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD40A]))
    B, S = cfg.global_batch, cfg.seq_len
    # Markov-ish stream: next token depends on previous via a fixed table,
    # with noise — learnable structure for convergence examples.
    table = np.random.default_rng(cfg.seed).integers(
        0, cfg.vocab, size=(cfg.vocab,), dtype=np.int32)
    toks = np.empty((B, S + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab, size=(B,))
    noise = rng.random((B, S))
    rand_toks = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    for t in range(S):
        follow = table[toks[:, t]]
        toks[:, t + 1] = np.where(noise[:, t] < 0.75, follow, rand_toks[:, t])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _check_split(cfg: DataConfig, mesh) -> None:
    dp = dp_axes(mesh)
    if entry_axes(batch_spec(mesh, cfg.global_batch)[0]) != dp:
        raise ValueError(f"global batch {cfg.global_batch} does not "
                         f"split over the data-parallel axes {dp}")


def _place(batch: dict, device: torch.device, mesh=None) -> dict:
    """int32 tensors on ``device``; under a mesh this rank's rows only."""
    if mesh is not None:
        batch = {k: local_batch(v, mesh) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def batch_for_step(cfg: DataConfig, step: int, device: DeviceLike = None,
                   mesh=None) -> dict:
    """The batch of ``step`` as int32 tensors on ``device`` (CUDA unless
    given).  Under a ``DeviceMesh`` only this rank's rows of the global
    batch (``models.sharding.local_batch``): byte for byte the slice of
    the global batch, split over the data-parallel axes."""
    device = resolve_device(device)
    if mesh is not None:
        _check_split(cfg, mesh)
    return _place(_batch_at(cfg, step), device, mesh)


class Pipeline:
    """Iterator with bounded background prefetch and device placement.

    A worker thread computes ``_batch_at`` numpy batches into a queue of at
    most ``prefetch``; ``__next__`` takes the next one and places it on
    ``device`` (CUDA unless given) on the calling thread, so the worker
    never touches the device.  Under a ``DeviceMesh`` it yields this
    rank's rows, as ``batch_for_step(..., mesh=)`` does.

    Checkpointable iterator contract (fault tolerance): ``state()`` returns
    the cursor of the next batch ``__next__`` will yield, as a dict that
    rides inside the checkpoint tree (checkpoint/manager.py);
    ``restore(state)`` repositions the stream there, discarding prefetched
    batches.  A resumed run therefore replays batches k, k+1, ... exactly.
    """

    def __init__(self, cfg: DataConfig, mesh=None, start_step: int = 0,
                 prefetch: int = 2, device: DeviceLike = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.prefetch = prefetch
        if mesh is not None:
            _check_split(cfg, mesh)
        self._step = start_step
        self._start()

    def _start(self) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._step, self._q,
                                              self._stop), daemon=True)
        self._thread.start()

    def _worker(self, step: int, q: queue.Queue,
                stop: threading.Event) -> None:
        while not stop.is_set():
            batch = _batch_at(self.cfg, step)
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self._step = step + 1
        return _place(batch, self.device, self.mesh)

    def close(self) -> None:
        """Stop the worker (also when it is blocked on a full queue) and
        drop the prefetched batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    # ----------------------------------------------------- checkpoint state

    def state(self) -> dict:
        """Checkpointable cursor: the step of the next batch ``__next__``
        yields.  Prefetched-but-unconsumed batches are deliberately not
        part of the state: they are regenerated on restore (``_batch_at``
        is pure), so the state is one integer however deep the queue."""
        return {"data_step": np.asarray(self._step, dtype=np.int64)}

    def restore(self, state: dict) -> None:
        """Reposition the stream at a cursor produced by ``state()``
        (possibly round-tripped through the checkpoint manager)."""
        self.seek(int(np.asarray(state["data_step"])))

    def seek(self, step: int) -> None:
        """Repoint the stream at ``step``: stop the prefetch worker, drop
        the queued batches, restart from the new cursor."""
        self.close()
        self._step = step
        self._start()
