"""The port's training substrate (twin of ``tests/test_substrate.py``):
data pipeline determinism, checkpoint manager (atomic commit / rotation),
straggler monitor and step timer, ``viable_mesh_shape``, end-to-end train
steps with loss decrease, and checkpoint-restart bit-exactness."""

import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import api, load_balance as lb, tree
from repro_torch.core.muon import MuonConfig
from repro_torch.data.pipeline import DataConfig, Pipeline, batch_for_step
from repro_torch.kernels import autotune
from repro_torch.models import transformer
from repro_torch.runtime.elastic import (StepTimer, StragglerMonitor,
                                         viable_mesh_shape)
from repro_torch.train.step import init_state, make_loss_fn, make_train_step
from repro_torch.train.train_state import TrainState


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _setup(**muon):
    cfg = configs.get("smollm-360m", reduced=True)
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=2, strategy="greedy")
    return cfg, api.Muon(plan, config=MuonConfig(**muon), device="cpu")


def test_pipeline_determinism_and_restart():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=7)
    b3 = batch_for_step(cfg, 3, device="cpu")
    assert torch.equal(b3["tokens"],
                       batch_for_step(cfg, 3, device="cpu")["tokens"])
    # streaming from step 3 yields the same batch as direct access
    pipe = Pipeline(cfg, start_step=3, prefetch=1, device="cpu")
    first = next(pipe)
    pipe.close()
    assert torch.equal(first["tokens"], b3["tokens"])
    # labels are next-token shifted
    assert torch.equal(b3["tokens"][:, 1:], b3["labels"][:, :-1])


def test_pipeline_has_learnable_structure():
    cfg = DataConfig(vocab=50, seq_len=256, global_batch=8, seed=1)
    b = batch_for_step(cfg, 0, device="cpu")
    toks, labs = b["tokens"].numpy(), b["labels"].numpy()
    # most transitions follow the deterministic table => repeated pairs
    pairs = {}
    for t, l in zip(toks.reshape(-1), labs.reshape(-1)):
        pairs.setdefault(int(t), []).append(int(l))
    consist = [max(np.bincount(v).max() / len(v), 0)
               for v in pairs.values() if len(v) >= 10]
    assert np.mean(consist) > 0.5


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, {"a": torch.arange(12.0).reshape(3, 4) + s,
                     "b": {"c": torch.ones((5,), dtype=torch.int32) + s,
                           "d": None}})
    assert mgr.all_steps() == [2, 3]          # rotation kept last 2
    out = mgr.restore(3, device="cpu")
    np.testing.assert_allclose(out["a"].numpy(),
                               np.arange(12.0).reshape(3, 4) + 3)
    assert out["b"]["c"].dtype == torch.int32
    assert out["b"]["d"] is None
    assert mgr.latest_step() == 3


def test_checkpoint_async_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, {"x": torch.ones((4, 4))})
    mgr.wait()
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    out = mgr.restore(device="cpu")
    np.testing.assert_array_equal(out["x"].numpy(), np.ones((4, 4)))


def test_straggler_monitor_rebalances():
    mon = StragglerMonitor(num_owners=4, window=5, threshold=1.2)
    for _ in range(5):
        mon.record(np.array([1.0, 1.0, 1.0, 3.0]))   # owner 3 is 3x slow
    assert mon.should_rebalance()
    shapes = {(64, 64): 12}
    cm = lb.analytic_cost_model(shapes)
    asn = mon.rebalance(shapes, cm)
    loads = asn.loads(cm)
    assert loads[3] < loads[:3].mean()    # degraded owner got less work


def test_straggler_monitor_matches_reference():
    """The same samples give the reference's speeds and re-plan."""
    pytest.importorskip("jax")
    from repro.core import load_balance as jlb
    from repro.runtime.elastic import StragglerMonitor as JMonitor
    mon, jmon = (M(num_owners=4, window=5, threshold=1.2)
                 for M in (StragglerMonitor, JMonitor))
    rng = np.random.default_rng(0)
    for _ in range(7):
        t = rng.uniform(1.0, 1.1, 4) * [1, 1, 2.5, 1]
        mon.record(t)
        jmon.record(t)
    np.testing.assert_array_equal(mon.speed_estimate(),
                                  jmon.speed_estimate())
    assert mon.should_rebalance() == jmon.should_rebalance() is True
    shapes = {(64, 64): 12, (64, 160): 6}
    asn = mon.rebalance(shapes, lb.analytic_cost_model(shapes))
    jasn = jmon.rebalance(shapes, jlb.analytic_cost_model(shapes))
    for k in shapes:
        np.testing.assert_array_equal(asn.owner_of[k], jasn.owner_of[k])


def test_viable_mesh_shape():
    assert viable_mesh_shape(256) == (16, 16)
    assert viable_mesh_shape(512, prefer_model=16) == (32, 16)
    assert viable_mesh_shape(252, prefer_model=16) == (18, 14)
    assert viable_mesh_shape(1) == (1, 1)
    assert viable_mesh_shape(4, prefer_model=1) == (4, 1)


def test_viable_mesh_shape_no_survivors_raises():
    """Total device loss must abort planning, not divide by zero."""
    with pytest.raises(ValueError):
        viable_mesh_shape(0)
    with pytest.raises(ValueError):
        viable_mesh_shape(-4)


def test_straggler_monitor_memory_bounded():
    """A months-long run holds window x num_owners floats, not one per step."""
    mon = StragglerMonitor(num_owners=2, window=5, threshold=1.2)
    for i in range(50):
        mon.record(np.array([1.0, 1.0 + i]))
    assert len(mon._times) == 5
    np.testing.assert_array_equal(mon._times[-1], [1.0, 50.0])
    np.testing.assert_array_equal(mon._times[0], [1.0, 46.0])
    mon.reset()
    assert len(mon._times) == 0
    assert not mon.should_rebalance()
    np.testing.assert_array_equal(mon.speed_estimate(), np.ones(2))


def test_step_timer_history_bounded():
    timer = StepTimer(max_history=8)
    for _ in range(30):
        with timer:
            pass
    assert len(timer.history) == 8
    assert timer.last == timer.history[-1]
    assert timer.recent(3) == list(timer.history)[-3:]
    assert len(timer.recent(100)) == 8      # clamped to available samples


@pytest.mark.parametrize("mode", ["owner", "gather", "adamw"])
def test_train_loop_loss_decreases(mode):
    cfg, opt = _setup(mode=mode, learning_rate=0.02, adam_lr=2e-3)
    state = init_state(cfg, opt, 0, "cpu")
    step = make_train_step(cfg, opt, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    loss_fn = make_loss_fn(cfg)
    losses = []
    for i in range(10):
        batch = batch_for_step(dcfg, i, device="cpu")
        with torch.no_grad():
            losses.append(float(loss_fn(state.params, batch)))
        state = step(state, batch)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (mode, losses)


def test_train_restart_bit_exact(tmp_path):
    """Checkpoint at step 3, restart, continue — states must match exactly."""
    cfg, opt = _setup(mode="owner")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    step = make_train_step(cfg, opt, device="cpu")

    state = init_state(cfg, opt, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for i in range(6):
        if i == 3:
            mgr.save(3, state._asdict())
        state = step(state, batch_for_step(dcfg, i, device="cpu"))

    state2 = TrainState(**mgr.restore(3, device="cpu"))
    assert state2.step == 3
    for i in range(3, 6):
        state2 = step(state2, batch_for_step(dcfg, i, device="cpu"))
    for (p, a), (_, b) in zip(tree.flatten(state), tree.flatten(state2),
                              strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), p
        else:
            assert a == b, p


def test_grad_accumulation_matches_full_batch():
    cfg, opt = _setup(mode="owner")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    batch = batch_for_step(dcfg, 0, device="cpu")
    full = make_train_step(cfg, opt, accum_steps=1, device="cpu")(
        init_state(cfg, opt, 0, "cpu"), batch)
    accum = make_train_step(cfg, opt, accum_steps=4, device="cpu")(
        init_state(cfg, opt, 0, "cpu"), batch)
    for (p, a), (_, b) in zip(tree.flatten(full.params),
                              tree.flatten(accum.params), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=p)
