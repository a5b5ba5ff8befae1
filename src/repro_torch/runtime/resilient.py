"""Survivable training loop: streaming data + checkpoints + elasticity +
online straggler rebalancing under one supervisor (port of
``repro.runtime.resilient``).

``ResilientLoop`` wires ``data/pipeline.py`` (deterministic prefetching
stream), ``checkpoint/manager.py`` (atomic, rotating, async, shard-aware
checkpoints), ``runtime/elastic.py`` (StragglerMonitor, StepTimer),
``core/load_balance.py`` (per-owner ``speed`` factors) and
``reshard_owner_state`` (owner-count migration) into one loop with three
recovery behaviours:

* **online rebalance** — per-owner step timings feed the ``StragglerMonitor``;
  when a persistent slowdown crosses the threshold the dedication plan is
  re-solved with the *measured* speeds and the owner-sharded optimizer
  state migrates through ``reshard_owner_state`` — no restart, no
  trajectory change.  Hysteresis: the speeds baked into the live plan are
  remembered, and a re-solve fires only when the estimate drifts beyond the
  threshold *relative to them*.
* **owner loss / re-add** — a ``kill`` fault shrinks the owner set: the
  loop re-plans at the surviving count, migrates momentum and per-variant
  state, and continues the same logical trajectory.  ``readd`` is the
  inverse.  Without a mesh the D owners live in this process (one launch
  per group carries all D·cap rows).  On a live ``torch.distributed``
  world this needs sub-groups of the survivors, which every rank must
  create; it raises ``NotImplementedError`` (ROADMAP item 8).
* **preemption** — the whole job dies and resumes from the latest committed
  checkpoint, which carries the train tree (params + owner-sharded
  ``MuonState`` incl. ``variant_state``), the data-pipeline cursor
  (``Pipeline.state()``) and the owner count at save time — so the resumed
  run replays batch k, k+1, ... exactly and, if the owner count changed in
  between, reshards the restored state onto the live plan.  Under a mesh a
  job restarted at another world size (a new process group) restores the
  same way (``resume=True``).

Invariant (tests/test_torch_resilience.py): the *logical* optimizer
trajectory — params, loss curve, and the unpacked per-matrix rows of
momentum and variant state — is bit-identical to an unfaulted run at equal
step counts, for every registry variant.  This holds because (a) the
per-matrix NS math is independent of which owner slot computes it and of
how many matrices one launch carries, (b) ``reshard_owner_state`` is an
exact permutation of logical rows, and (c) the data stream is a pure
function of (seed, step).

In-flight staged accumulators (the prestaged bucketed pipeline) never
cross a recovery boundary: faults are handled between steps, where staged
gradient state exists only inside the train step.  The loop is library
code and leaves Python's garbage collector alone; launchers that own their
process freeze the heap (``launch/train.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.elastic import StepTimer, StragglerMonitor
from repro_torch.runtime.faults import (FaultInjector, FaultPlan, OwnerLost,
                                        Preemption)

# the owner-major buffers of the checkpoint tree (written in row blocks
# under a mesh)
OWNER_PREFIXES = ("train/opt_state/momentum", "train/opt_state/variant_state")


@dataclass
class ResilientConfig:
    """Supervisor policy (everything but the optimizer math)."""
    steps: int = 50
    ckpt_every: int = 0             # 0 = no checkpointing
    strategy: str = "greedy"        # dedication strategy for every (re)plan
    accum_steps: int = 1
    # straggler policy
    rebalance: bool = True
    window: int = 8                 # monitor window (steps)
    threshold: float = 1.3          # slowdown ratio that triggers a re-solve
    cooldown: int = 10              # min steps between plan changes
    max_history: int = 1024         # StepTimer bound
    seed: int = 0                   # model init seed


@dataclass
class LoopReport:
    """Telemetry of one supervised run (consumed by tests + chip_smoke)."""
    steps: int = 0                       # logical steps completed
    executed_steps: int = 0              # including replays after preemption
    losses: Dict[int, float] = field(default_factory=dict)   # step -> ema
    step_times: List[float] = field(default_factory=list)
    rebalances: List[dict] = field(default_factory=list)
    recoveries: List[dict] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)
    final_owner_count: int = 0

    def loss_curve(self) -> List[float]:
        """EMA loss by logical step (replayed steps overwrite identically)."""
        return [self.losses[s] for s in sorted(self.losses)]


class ResilientLoop:
    """One supervised production training run (see module docstring).

    Always plans with the default *contiguous* physical layout: plans of
    equal owner count then share pack indices whatever the logical
    assignment, which is what lets a rebalance reuse the step function and
    keep bit-identity by construction.  Runs on ``device`` (CUDA unless
    given)."""

    def __init__(self, model_cfg, data_cfg, *, muon=None, run=None,
                 num_owners: int = 1, mesh=None, ckpt_dir: Optional[str] = None,
                 ckpt_keep: int = 3, faults: Optional[FaultPlan] = None,
                 resume: bool = False, log=None, device: DeviceLike = None):
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.muon import MuonConfig
        from repro_torch.data.pipeline import Pipeline
        from repro_torch.models import model_fns
        from repro_torch.train.step import init_state

        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.muon_cfg = muon or MuonConfig()
        self.rcfg = run or ResilientConfig()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.log = log or (lambda *a, **k: None)
        self.report = LoopReport()

        self.shapes = model_fns(model_cfg).init(model_cfg, self.rcfg.seed,
                                                device="meta")
        self._step_cache: dict = {}      # plan signature -> step function
        self._install(self._plan_for(num_owners=num_owners))
        self._plan_speed = np.ones(self.num_owners)
        self._last_plan_change = -self.rcfg.cooldown

        self.mgr = (CheckpointManager(ckpt_dir, keep=ckpt_keep)
                    if ckpt_dir else None)
        self.injector = FaultInjector(faults) if faults is not None else None
        self.timer = StepTimer(max_history=self.rcfg.max_history)
        self.monitor = StragglerMonitor(
            num_owners=self.num_owners, window=self.rcfg.window,
            threshold=self.rcfg.threshold)

        self.state = init_state(model_cfg, self.opt, self.rcfg.seed,
                                self.device, mesh=mesh)
        self.pipe = Pipeline(data_cfg, mesh=mesh, start_step=0,
                             device=self.device)
        if resume and self.mgr is not None and self.mgr.latest_step():
            self._restore_from_checkpoint()

    # ------------------------------------------------------------ planning

    def _plan_for(self, num_owners: Optional[int] = None, speed=None):
        from repro_torch.core import api
        if self.mesh is not None:
            return api.dedicate_params(self.shapes, mesh=self.mesh,
                                       strategy=self.rcfg.strategy,
                                       speed=speed)
        return api.dedicate_params(self.shapes, num_owners=num_owners,
                                   strategy=self.rcfg.strategy, speed=speed)

    @staticmethod
    def _plan_signature(plan):
        """Physical-layout key: plans with equal signatures run the same
        step (the logical assignment is scheduling metadata, not
        computation)."""
        return tuple(sorted(
            (path, g.key, g.count, g.capacity, plan.num_owners)
            for path, g in plan.groups.items()))

    def _install(self, plan) -> None:
        from repro_torch.core import api
        from repro_torch.train.step import make_train_step
        self.plan = plan
        self.num_owners = plan.num_owners
        self.opt = api.Muon(plan, self.mesh, config=self.muon_cfg,
                            device=self.device)
        sig = self._plan_signature(plan)
        if sig not in self._step_cache:
            self._step_cache[sig] = make_train_step(
                self.model_cfg, self.opt, self.mesh,
                accum_steps=self.rcfg.accum_steps, device=self.device)
        self.step_fn = self._step_cache[sig]

    def _owner_state(self) -> bool:
        """Whether the optimizer state holds owner-major buffers."""
        return self.opt.effective_mode == "owner"

    # --------------------------------------------------------- checkpoints

    def _checkpoint_tree(self):
        return {"train": self.state._asdict(),
                "data": self.pipe.state(),
                "meta": {"num_owners": np.asarray(self.num_owners,
                                                  np.int64)}}

    def _row_blocks(self):
        """Under a mesh, this rank's block of the owner-major buffers."""
        from repro_torch.checkpoint.manager import RowBlocks
        from repro_torch.core.owner_comms import OwnerLayout
        if self.mesh is None or not self._owner_state():
            return None
        return RowBlocks(OWNER_PREFIXES,
                         OwnerLayout(self.plan, self.mesh).owner_index(),
                         self.num_owners)

    def _save_checkpoint(self, step: int, *, block: bool = False) -> None:
        if self.mgr is None:
            return
        self.mgr.save(step, self._checkpoint_tree(), block=block,
                      row_blocks=self._row_blocks())
        self.report.checkpoints.append(step)

    def _restore_from_checkpoint(self) -> int:
        """Rebuild (state, data cursor) from the latest committed checkpoint;
        reshards the owner-sharded state if the live owner count differs from
        the one at save time, and keeps this rank's rows under a mesh.
        Returns the resumed step."""
        from repro_torch.core import api
        from repro_torch.core.owner_comms import OwnerLayout
        from repro_torch.train.train_state import TrainState
        tree = self.mgr.restore(like=self._checkpoint_tree())
        state = TrainState(**tree["train"])
        opt_state = state.opt_state
        if self._owner_state():
            saved_owners = int(np.asarray(tree["meta"]["num_owners"]))
            if saved_owners != self.num_owners:
                # The restored buffers hold all D·cap rows: repack them as
                # in one process (mesh=None), then keep this rank's.  The
                # contiguous layout depends on the owner count alone, so
                # the saved plan is rebuilt by the cheapest strategy.
                saved_plan = api.dedicate_params(
                    self.shapes, num_owners=saved_owners, strategy="greedy")
                opt_state = api.reshard_owner_state(opt_state, saved_plan,
                                                    self.plan)
            if self.mesh is not None:
                layout = OwnerLayout(self.plan, self.mesh)
                opt_state = api.map_owner_buffers(
                    opt_state, lambda _, buf: layout.local_block(buf).clone())
        self.state = TrainState(state.step, state.params, opt_state,
                                state.loss_ema)
        self.pipe.restore(tree["data"])
        return self.state.step

    # ----------------------------------------------------------- recovery

    def _migrate(self, new_plan) -> None:
        """Move the owner-sharded optimizer state onto ``new_plan`` and make
        it the live plan (exact permutation of logical rows)."""
        from repro_torch.core.api import reshard_owner_state
        from repro_torch.train.train_state import TrainState
        opt_state = self.state.opt_state
        if self._owner_state():
            opt_state = reshard_owner_state(opt_state, self.plan, new_plan,
                                            self.mesh)
        self._install(new_plan)
        self.state = TrainState(self.state.step, self.state.params,
                                opt_state, self.state.loss_ema)

    def _rebalance(self, speed: np.ndarray, step: int) -> None:
        """Re-solve the dedication with measured speeds; migrate in place."""
        t0 = time.perf_counter()
        old_plan = self.plan
        new_plan = self._plan_for(num_owners=self.num_owners, speed=speed)
        self._migrate(new_plan)
        self._sync()
        latency = time.perf_counter() - t0
        cm = new_plan.cost_model or old_plan.cost_model
        before = after = None
        if cm is not None:
            before = old_plan.assignment.makespan(cm, speed=speed)
            after = new_plan.assignment.makespan(cm, speed=speed)
        self._plan_speed = np.asarray(speed, float)
        self._last_plan_change = step
        self.monitor.reset()
        self.report.rebalances.append({
            "step": step, "latency_s": latency, "speed": speed.tolist(),
            "makespan_before_s": before, "makespan_after_s": after})
        self.log(f"[rebalance] step {step}: speeds={np.round(speed, 3)} "
                 f"makespan {before} -> {after} ({latency*1e3:.0f} ms)")

    def _resize_owners(self, new_count: int, *, kind: str, step: int,
                       owner: int = -1) -> None:
        """Shared kill/readd path: re-plan, migrate."""
        if self.mesh is not None:
            raise NotImplementedError(
                f"{kind} at step {step} on a live torch.distributed world: "
                "moving the owners onto the survivors needs sub-groups that "
                "every rank creates (ROADMAP item 8); restart from a "
                "checkpoint at the new world size instead")
        if new_count < 1:
            raise RuntimeError(
                f"owner loss at step {step} leaves no survivors")
        t0 = time.perf_counter()
        old_count = self.num_owners
        self._migrate(self._plan_for(num_owners=new_count))
        self._sync()
        latency = time.perf_counter() - t0
        if kind == "kill" and self.injector is not None:
            self.injector.on_owner_renumber(owner)
        self.monitor = StragglerMonitor(
            num_owners=self.num_owners, window=self.rcfg.window,
            threshold=self.rcfg.threshold)
        self._plan_speed = np.ones(self.num_owners)
        self._last_plan_change = step
        self.report.recoveries.append({
            "kind": kind, "step": step, "owner": owner,
            "owners": (old_count, self.num_owners), "latency_s": latency})
        self.log(f"[{kind}] step {step}: owners {old_count} -> "
                 f"{self.num_owners} ({latency*1e3:.0f} ms)")

    def _recover_preemption(self, step: int) -> int:
        """The job died; resume from the latest committed checkpoint (or from
        scratch when none committed yet).  Returns the step to resume at."""
        t0 = time.perf_counter()
        resumed = 0
        if self.mgr is not None and self.mgr.latest_step() is not None:
            resumed = self._restore_from_checkpoint()
        else:
            from repro_torch.train.step import init_state
            self.state = init_state(self.model_cfg, self.opt,
                                    self.rcfg.seed, self.device,
                                    mesh=self.mesh)
            self.pipe.seek(0)
        self._sync()
        latency = time.perf_counter() - t0
        self.report.recoveries.append({
            "kind": "preempt", "step": step, "resumed_step": resumed,
            "owners": (self.num_owners, self.num_owners),
            "latency_s": latency})
        self.log(f"[preempt] step {step}: resumed at {resumed} "
                 f"({latency*1e3:.0f} ms)")
        return resumed

    # ---------------------------------------------------------- main loop

    def _sync(self) -> None:
        """Wait for the device, so host clocks time finished work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _owner_times(self, wall_s: float) -> np.ndarray:
        """Per-owner step times as a profiler would export them.  SPMD makes
        every owner's wall clock the step time; injected slow factors model
        the degraded hosts the monitor is there to catch.  Under a mesh the
        step time is the slowest rank's (an all-reduce), so every rank
        records the same samples and takes the same rebalance decision."""
        if self.mesh is not None:
            import torch.distributed as dist
            t = torch.tensor([wall_s], dtype=torch.float64,
                             device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            wall_s = float(t)
        per_owner = np.full(self.num_owners, wall_s)
        if self.injector is not None:
            per_owner = self.injector.perturb(per_owner)
        return per_owner

    def _maybe_rebalance(self, step: int) -> None:
        if not self.rcfg.rebalance:
            return
        if step - self._last_plan_change < self.rcfg.cooldown:
            return
        if not self.monitor.should_rebalance():
            return
        est = self.monitor.speed_estimate()
        ref = self._plan_speed
        drift = float(np.max(np.maximum(est, ref)
                             / np.maximum(np.minimum(est, ref), 1e-9)))
        if drift <= self.rcfg.threshold:
            return                       # already planned for these speeds
        self._rebalance(est, step)

    def _raise_faults(self, step: int) -> None:
        """Poll the fault script for ``step``.  slow/unslow apply silently
        inside the injector; a control event surfaces as the exception a
        real runtime failure would (device loss, SIGTERM) and the supervisor
        recovers and re-polls, so stacked same-step faults strike one at a
        time against the already-recovered topology."""
        if self.injector is None:
            return
        for ev in self.injector.events_at(step):
            if ev.kind == "kill":
                raise OwnerLost(ev.owner)
            if ev.kind == "preempt":
                raise Preemption()
            if ev.kind == "readd":
                self._resize_owners(self.num_owners + 1, kind="readd",
                                    step=step)

    def run(self) -> LoopReport:
        step = self.state.step
        try:
            while step < self.rcfg.steps:
                try:
                    self._raise_faults(step)
                except OwnerLost as e:
                    self._resize_owners(self.num_owners - 1, kind="kill",
                                        step=step, owner=e.owner)
                    continue                 # re-poll the same step
                except Preemption:
                    step = self._recover_preemption(step)
                    continue

                batch = next(self.pipe)
                with self.timer:
                    self.state = self.step_fn(self.state, batch)
                    self._sync()
                self.report.executed_steps += 1
                self.report.losses[step] = float(self.state.loss_ema)
                self.report.step_times.append(self.timer.last)
                self.monitor.record(self._owner_times(self.timer.last))
                step += 1
                if step % 10 == 0:
                    self.log(f"step {step:5d} loss_ema "
                             f"{float(self.state.loss_ema):.4f} "
                             f"{np.mean(self.timer.recent(10))*1e3:.0f} "
                             f"ms/step")

                self._maybe_rebalance(step)
                if self.rcfg.ckpt_every and step % self.rcfg.ckpt_every == 0:
                    self._save_checkpoint(step)
        finally:
            self.pipe.close()
            if self.mgr is not None:
                self.mgr.wait()
        self.report.steps = step
        self.report.final_owner_count = self.num_owners
        return self.report
