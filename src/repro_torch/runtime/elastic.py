"""Elastic scaling + straggler mitigation hooks (fault-tolerance runtime;
port of ``repro.runtime.elastic``).

At thousands of nodes the failure model is: a host drops, the job restarts
on a different device set, training resumes from the last committed
checkpoint (checkpoint/manager.py) with the data pipeline replayed from the
stored step (data/pipeline.py determinism contract).  This module owns the
two decisions that change on such an event:

* ``remesh``             — build a ``DeviceMesh`` over the live ranks and
                           recompute every plan keyed on it (dedication plan,
                           shardings).  The dedication plan is a pure function
                           of (param shapes, mesh), so elastic re-planning is
                           a re-invocation, not a migration.
* ``StragglerMonitor``   — tracks per-step wall times; when drift beyond a
                           threshold persists, it re-solves the owner
                           assignment with per-owner ``speed`` factors
                           (core/load_balance.py) so a degraded host receives
                           proportionally fewer Muon updates — the paper's
                           measured-cost model applied online.

``StepTimer`` times what runs inside its block on the host clock; a caller
timing CUDA work synchronises inside the block (``torch.cuda.synchronize()``),
as the reference waits with ``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Sequence

import numpy as np


def viable_mesh_shape(n_devices: int, prefer_model: int = 16):
    """Largest (data, model) grid for a (possibly degraded) device count.

    Raises ``ValueError`` when no devices survive — the caller (supervisor
    loop) must abort the job rather than divide by zero planning a mesh for
    an empty cluster.
    """
    if n_devices < 1:
        raise ValueError(
            f"cannot build a mesh over {n_devices} devices; the job has no "
            "survivors to remesh onto")
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model)


def remesh(ranks: Optional[Sequence[int]] = None, prefer_model: int = 16,
           device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``viable_mesh_shape(len(ranks))`` with axes
    ("data", "model") over ``ranks`` (default: the whole world, which
    ``launch.mesh.init_process_group`` must have joined).  Every rank of
    the current world calls it, as ``torch.distributed.new_group``
    requires, those left out too (their coordinate on the mesh is None).
    Ranks beyond the grid the shape covers are left out."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import BACKENDS
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "launch.mesh.init_process_group first")
    if dist.get_backend() != BACKENDS[device_type]:
        raise ValueError(f"a {device_type!r} mesh needs the "
                         f"{BACKENDS[device_type]!r} backend, the process "
                         f"group runs {dist.get_backend()!r}")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    shape = viable_mesh_shape(len(ranks), prefer_model)
    grid = torch.as_tensor(ranks[:shape[0] * shape[1]]).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


@dataclass
class StragglerMonitor:
    """Detect persistent per-owner slowdowns and trigger rebalancing.

    Memory is bounded by construction: ``_times`` is a deque capped at
    ``window`` samples, so a months-long run holds ``window × num_owners``
    floats however many steps it takes.
    """
    num_owners: int
    window: int = 20
    threshold: float = 1.3          # relative slowdown triggering rebalance
    _times: Deque[np.ndarray] = field(default_factory=deque)

    def __post_init__(self):
        self._times = deque(self._times, maxlen=self.window)

    def record(self, per_owner_seconds: np.ndarray) -> None:
        self._times.append(np.asarray(per_owner_seconds, dtype=float))

    def reset(self) -> None:
        """Drop history — after a rebalance/remesh the samples describe the
        previous assignment and must not vote on the next one."""
        self._times.clear()

    def speed_estimate(self) -> np.ndarray:
        """speed[r] ∈ (0, 1]: measured relative throughput per owner."""
        if not self._times:
            return np.ones(self.num_owners)
        med = np.median(np.stack(self._times), axis=0)
        fastest = med.min()
        return np.clip(fastest / np.maximum(med, 1e-12), 1e-3, 1.0)

    def should_rebalance(self) -> bool:
        if len(self._times) < self.window:
            return False
        speed = self.speed_estimate()
        return bool(speed.min() < 1.0 / self.threshold)

    def rebalance(self, shape_counts, cost_model, strategy: str = "greedy"):
        """Re-solve the assignment with measured speeds (one-line hook)."""
        from repro_torch.core import load_balance
        return load_balance.assign(
            shape_counts, self.num_owners, strategy=strategy,
            cost_model=cost_model, speed=self.speed_estimate())


class StepTimer:
    """Wall-clock per step; feeds the monitor on real deployments where
    per-owner optimizer timings are exported by the profiler.

    ``history`` is bounded (default 1024 samples) so long-run supervisors
    don't grow a float per step forever; ``recent(n)`` and ``last`` cover
    the logging uses.
    """

    def __init__(self, max_history: int = 1024):
        self.t0 = None
        self.history: Deque[float] = deque(maxlen=max_history)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.history.append(time.perf_counter() - self.t0)

    @property
    def last(self) -> float:
        return self.history[-1]

    def recent(self, n: int) -> list:
        """The most recent ``n`` samples (deques don't slice)."""
        n = min(n, len(self.history))
        return [self.history[i] for i in range(len(self.history) - n,
                                               len(self.history))]
