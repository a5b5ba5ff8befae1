"""The port's resilient loop (twin of ``tests/test_resilience.py``), plus
the loop held against the reference's over a short drill.

Quick tests: the FaultPlan DSL (round trip, validation, the reference's
messages), the supervised loop's bit-equivalence to a manual train loop,
rebalance hysteresis, and a kill + re-add drill for Dion2 and AdaMuon.

Slow soak (marked ``slow``): a 60-step run per optimizer variant through the
full drill — slow + recover, owner kill + re-add, preemption + checkpoint
restore — asserting the *logical* optimizer trajectory (params, loss curve,
unpacked momentum/variant-state rows) is bit-identical to an unfaulted run.
The loop's ``StepTimer`` is replaced by one that records a fixed duration,
so the monitor's speeds come from the injected slow factors alone and the
re-plan's makespan is strictly lower by construction, not by wall clock.

Against the reference (numpy-carried weights, the same batches): the drill
``slow@1:r3x4.0; kill@3:r1; readd@5; preempt@7`` over 8 steps with a
checkpoint every 4, within the train step's parity tolerances (loss_ema
atol 1e-3, parameters rtol 5e-4 / atol 5e-5; ``tests/test_torch_train.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import api, tree
from repro_torch.core.muon import MuonConfig, group_key_str
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.kernels import autotune
from repro_torch.models import transformer
from repro_torch.runtime.elastic import StepTimer
from repro_torch.runtime.faults import FaultEvent, FaultInjector, FaultPlan
from repro_torch.runtime.resilient import ResilientConfig, ResilientLoop
from repro_torch.train.step import init_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VARIANTS = ["muon", "muonbp", "normuon"]
BAD_SPECS = [
    "flood@3",             # unknown kind
    "slow@3",              # slow needs an owner
    "kill@3",              # kill needs an owner
    "slow@3:r1x0.5",       # speedup is not a fault
    "slow@-1:r0x2",        # negative step doesn't parse
    "kill@3 r1",           # malformed clause
]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


class FixedTimer(StepTimer):
    """A ``StepTimer`` that records every step as ``seconds`` long."""

    def __init__(self, seconds: float = 0.01):
        super().__init__()
        self.seconds = seconds

    def __exit__(self, *exc):
        self.history.append(self.seconds)


def _model_cfg():
    return configs.get("smollm-360m", reduced=True, n_layers=2)


def _data_cfg(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)


def _loop(variant="muon", *, steps, num_owners=4, ckpt_dir=None,
          ckpt_every=0, faults=None, **run_kw):
    cfg = _model_cfg()
    run = ResilientConfig(steps=steps, ckpt_every=ckpt_every, **run_kw)
    loop = ResilientLoop(cfg, _data_cfg(cfg),
                         muon=MuonConfig(variant=variant), run=run,
                         num_owners=num_owners, ckpt_dir=ckpt_dir,
                         faults=faults, device="cpu")
    loop.timer = FixedTimer()
    return loop


def _logical_rows(plan, bufs):
    """Owner-major (D*cap, m, n) buffers -> logical (count, m, n) rows."""
    return {group_key_str(key): bufs[group_key_str(key)].numpy()[
        np.asarray(g.unpack_index)] for key, g in plan.groups.items()}


def _assert_same_trajectory(a, b):
    """a, b: finished ResilientLoops at equal logical step counts."""
    for (p, x), (q, y) in zip(tree.flatten(a.state.params),
                              tree.flatten(b.state.params), strict=True):
        assert p == q
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy(), err_msg=p)
    assert a.report.loss_curve() == b.report.loss_curve()
    ra = _logical_rows(a.plan, a.state.opt_state.momentum)
    rb = _logical_rows(b.plan, b.state.opt_state.momentum)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=f"momentum {k}")
    va, vb = a.state.opt_state.variant_state, b.state.opt_state.variant_state
    assert (va is None) == (vb is None)
    if va is not None:
        assert va.keys() == vb.keys()
        for field in va:
            assert (va[field] is None) == (vb[field] is None)
            if va[field] is None:
                continue
            fa = _logical_rows(a.plan, va[field])
            fb = _logical_rows(b.plan, vb[field])
            for k in fa:
                np.testing.assert_array_equal(
                    fa[k], fb[k], err_msg=f"variant_state {field}/{k}")


# ------------------------------------------------------------ FaultPlan DSL


def test_fault_plan_parse_roundtrip():
    spec = "slow@8:r3x4.0; unslow@24:r3; kill@30:r1; readd@40; preempt@52"
    plan = FaultPlan.parse(spec)
    assert len(plan) == 5
    assert plan.max_step == 52
    assert FaultPlan.parse(plan.spec()).events == plan.events
    assert plan.at(30) == [FaultEvent(step=30, kind="kill", owner=1)]
    assert plan.at(8)[0].factor == 4.0
    assert plan.at(7) == []


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_fault_plan_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_plan_same_dsl_and_messages_as_reference():
    """The port's DSL is the reference's: the same spec back for a valid
    drill, the same message for each invalid one."""
    pytest.importorskip("jax")
    from repro.runtime.faults import FaultPlan as JFaultPlan
    spec = "slow@8:r3x4.0, unslow@24:r3; kill@30:r1; readd@40; preempt@52"
    assert FaultPlan.parse(spec).spec() == JFaultPlan.parse(spec).spec()
    for bad in BAD_SPECS:
        with pytest.raises(ValueError) as got:
            FaultPlan.parse(bad)
        with pytest.raises(ValueError) as want:
            JFaultPlan.parse(bad)
        assert str(got.value) == str(want.value), bad


def test_injector_renumber_and_multipliers():
    inj = FaultInjector(FaultPlan.parse("slow@0:r3x4.0; slow@0:r1x2.0"))
    assert inj.events_at(0)                       # fires both slow events
    np.testing.assert_allclose(inj.multipliers(4), [1, 2, 1, 4])
    inj.on_owner_renumber(2)                      # slot 3 shifts down to 2
    np.testing.assert_allclose(inj.multipliers(3), [1, 2, 4])
    assert inj.events_at(0) == []                 # exactly-once


# ------------------------------------------------- loop ≡ manual (unfaulted)


def test_loop_matches_manual_train_loop():
    """The supervisor adds zero numerics: a supervised run is bit-identical
    to hand-stepping make_train_step over batch_for_step."""
    steps = 5
    loop = _loop(steps=steps, num_owners=2)
    report = loop.run()
    assert report.steps == steps
    assert report.executed_steps == steps

    cfg = _model_cfg()
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=2, strategy="greedy")
    opt = api.Muon(plan, config=MuonConfig(), device="cpu")
    state = init_state(cfg, opt, 0, "cpu")
    step_fn = make_train_step(cfg, opt, device="cpu")
    dcfg = _data_cfg(cfg)
    for i in range(steps):
        state = step_fn(state, batch_for_step(dcfg, i, device="cpu"))
    for (p, x), (_, y) in zip(tree.flatten(loop.state.params),
                              tree.flatten(state.params), strict=True):
        assert torch.equal(x, y), p
    assert float(loop.state.loss_ema) == float(state.loss_ema)


# --------------------------------------------------------------- hysteresis


def test_rebalance_fires_once_for_persistent_straggler():
    """A 4x-slow owner trips the monitor once; after the re-plan the baked-in
    speeds match the estimate, so hysteresis suppresses further re-fires."""
    loop = _loop(steps=16, num_owners=4,
                 faults=FaultPlan.parse("slow@1:r3x4.0"),
                 window=4, cooldown=3, threshold=1.3)
    report = loop.run()
    assert len(report.rebalances) == 1
    rb = report.rebalances[0]
    assert rb["speed"] == [1.0, 1.0, 1.0, 0.25]  # exactly: a fixed clock
    assert rb["makespan_after_s"] < rb["makespan_before_s"]
    assert report.steps == 16


def test_rebalance_preserves_trajectory():
    """The re-plan is scheduling metadata only: the rebalanced run stays
    bit-identical to an unfaulted one."""
    faulted = _loop(steps=12, num_owners=4,
                    faults=FaultPlan.parse("slow@1:r3x4.0"),
                    window=4, cooldown=3, threshold=1.3)
    faulted.run()
    assert faulted.report.rebalances
    plain = _loop(steps=12, num_owners=4)
    plain.run()
    _assert_same_trajectory(faulted, plain)


# ---------------------------------------- kill/readd drill (new variants)


@pytest.mark.parametrize("variant", ["dion2", "adamuon"])
def test_kill_readd_drill_new_variants(variant):
    """An owner kill + re-add mid-run leaves the logical trajectory
    bit-identical to an unfaulted run: the Dion2 / AdaMuon owner-major
    q / v buffers ride reshard_owner_state exactly like the momentum, and
    each Gram NS launch carries 3 matrices in place of 4 in between."""
    faulted = _loop(variant, steps=14, num_owners=4,
                    faults=FaultPlan.parse("kill@4:r1; readd@9"))
    report = faulted.run()
    assert report.steps == 14
    assert report.final_owner_count == 4
    kinds = [r["kind"] for r in report.recoveries]
    assert kinds.count("kill") == 1 and kinds.count("readd") == 1
    assert [r["owners"] for r in report.recoveries] == [(4, 3), (3, 4)]

    plain = _loop(variant, steps=14, num_owners=4)
    plain.run()
    _assert_same_trajectory(faulted, plain)


# --------------------------------------------------------------------- soak


@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
def test_soak_full_drill_bit_continuity(tmp_path, variant):
    """60-step survivability drill per variant: slow+recover, kill+readd,
    preempt+restore — logical trajectory bit-identical to an unfaulted run."""
    drill = "slow@8:r3x4.0; unslow@24:r3; kill@30:r1; readd@40; preempt@52"
    faulted = _loop(variant, steps=60, num_owners=4,
                    ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=16,
                    faults=FaultPlan.parse(drill),
                    window=8, cooldown=10, threshold=1.3)
    report = faulted.run()

    assert report.steps == 60
    assert report.final_owner_count == 4          # kill@30 then readd@40
    # preempt@52 rewinds to the step-48 checkpoint: 4 replayed steps
    assert report.executed_steps == 64
    kinds = [r["kind"] for r in report.recoveries]
    assert kinds.count("kill") == 1
    assert kinds.count("readd") == 1
    assert kinds.count("preempt") == 1
    preempt = next(r for r in report.recoveries if r["kind"] == "preempt")
    assert preempt["resumed_step"] == 48
    assert report.rebalances, "slow@8 must trigger a re-plan"
    rb = report.rebalances[0]
    assert rb["speed"][3] < 0.5 and rb["speed"][:3] == [1.0, 1.0, 1.0]
    assert rb["makespan_after_s"] < rb["makespan_before_s"]
    assert report.checkpoints and max(report.checkpoints) >= 48

    plain = _loop(variant, steps=60, num_owners=4)
    plain_report = plain.run()
    assert plain_report.steps == 60
    _assert_same_trajectory(faulted, plain)


# ------------------------------------------------------ against the reference


def test_loop_matches_reference_drill(tmp_path):
    """The port's supervised loop against the reference's over a short
    drill, from the reference's initial weights: the same recoveries and
    step counts, each step's loss_ema within 1e-3 and the final parameters
    within rtol 5e-4 / atol 5e-5."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.core.muon import MuonConfig as JMuonConfig
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.runtime.faults import FaultPlan as JFaultPlan
    from repro.runtime.resilient import (ResilientConfig as JResilientConfig,
                                         ResilientLoop as JResilientLoop)
    from repro_torch.train.train_state import TrainState

    drill, steps = "slow@1:r3x4.0; kill@3:r1; readd@5; preempt@7", 8
    jcfg = jconfigs.get("smollm-360m", reduced=True, n_layers=2)
    jloop = JResilientLoop(
        jcfg, JDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4),
        muon=JMuonConfig(), run=JResilientConfig(steps=steps, ckpt_every=4),
        num_owners=4, ckpt_dir=str(tmp_path / "jax"),
        faults=JFaultPlan.parse(drill))

    tloop = _loop(steps=steps, num_owners=4, ckpt_dir=str(tmp_path / "torch"),
                  ckpt_every=4, faults=FaultPlan.parse(drill))
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, jloop.state.params), device="cpu",
        requires_grad=True)
    tloop.state = TrainState(0, params, tloop.opt.init(params),
                             torch.zeros((), dtype=torch.float32))

    jrep, trep = jloop.run(), tloop.run()
    assert trep.steps == jrep.steps == steps
    assert trep.executed_steps == jrep.executed_steps == 11
    for key in ("kind", "step", "owners"):
        assert [r.get(key) for r in trep.recoveries] == \
            [tuple(r[key]) if key == "owners" else r.get(key)
             for r in jrep.recoveries]
    assert trep.recoveries[-1]["resumed_step"] == 4
    assert trep.checkpoints == jrep.checkpoints == [4, 8]
    np.testing.assert_allclose(trep.loss_curve(), jrep.loss_curve(),
                               rtol=0, atol=1e-3)
    for (p, a), (q, b) in zip(tree.flatten(tloop.state.params), tree.flatten(
            jax.tree.map(np.asarray, jloop.state.params)), strict=True):
        assert p == q
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-5, err_msg=p)
