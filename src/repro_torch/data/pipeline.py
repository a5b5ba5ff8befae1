"""Deterministic synthetic token pipeline (port of ``repro.data.pipeline``).

Batches are keyed by (seed, step): ``_batch_at`` is the reference's pure
numpy function, so both packages see byte-identical batches.  The prefetch
``Pipeline`` class waits for ROADMAP item 8.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def batch_for_step(cfg: DataConfig, step: int, device: DeviceLike = None,
                   mesh=None) -> dict:
    """The batch of ``step`` as int32 tensors on ``device`` (CUDA unless
    given).  Under a ``DeviceMesh`` only this rank's rows of the global
    batch (``models.sharding.local_batch``): byte for byte the slice of
    the global batch, split over the data-parallel axes."""
    device = resolve_device(device)
    batch = _batch_at(cfg, step)
    if mesh is not None:
        dp = dp_axes(mesh)
        if entry_axes(batch_spec(mesh, cfg.global_batch)[0]) != dp:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over the data-parallel axes {dp}")
        batch = {k: local_batch(v, mesh) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
