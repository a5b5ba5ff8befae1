"""The port's checkpoint manager (twin of ``tests/test_checkpoint.py``),
plus its format held against the reference's.

* save/restore round trip of the FULL train tree — params + owner-sharded
  ``MuonState`` including per-variant state — exactly as the resilient loop
  writes it (train tree + data cursor + owner-count meta);
* ``keep=N`` rotation;
* async ``save(..., block=False)`` + ``wait()`` ordering;
* the snapshot is taken in ``save``: neither a numpy buffer nor a CPU
  tensor changed in place afterwards (the train step adds its deltas into
  the parameters) reaches the file;
* restore-latest after a partial write;
* against the reference: a checkpoint the reference's manager wrote after
  2 steps restores into the port's state bitwise and trains 2 more steps
  within the train step's parity tolerances; the port's checkpoint names
  its leaves as the reference's does and reads back leaf by leaf with the
  reference's own ``_assemble``.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import api, tree
from repro_torch.core.muon import MuonConfig
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.kernels import autotune
from repro_torch.models import transformer
from repro_torch.train.step import init_state, make_train_step
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


def _setup(variant: str = "muon"):
    cfg = configs.get("smollm-360m", reduced=True, n_layers=2)
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=2, strategy="greedy")
    opt = api.Muon(plan, config=MuonConfig(variant=variant), device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    return cfg, opt, dcfg


def _ckpt_tree(state, steps: int):
    return {"train": state._asdict(),
            "data": {"data_step": np.asarray(steps, np.int64)},
            "meta": {"num_owners": np.asarray(2, np.int64)}}


def _train_tree(variant: str, steps: int = 2):
    """A real train tree after ``steps`` updates (momentum + variant state
    populated), in the composite layout the resilient loop checkpoints."""
    cfg, opt, dcfg = _setup(variant)
    state = init_state(cfg, opt, 0, "cpu")
    step = make_train_step(cfg, opt, device="cpu")
    for i in range(steps):
        state = step(state, batch_for_step(dcfg, i, device="cpu"))
    return _ckpt_tree(state, steps)


def _flat(t):
    """(path, leaf) of every non-None leaf, NamedTuples by field name."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), prefix + (f,))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            out.append(("/".join(prefix), node))
    walk(t, ())
    return out


def _assert_trees_equal(a, b):
    la, lb = _flat(a), _flat(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.requires_grad == y.requires_grad, p
            np.testing.assert_array_equal(x.detach().numpy(),
                                          y.detach().numpy(), err_msg=p)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=p)
            assert np.asarray(x).dtype == np.asarray(y).dtype, p


@pytest.mark.parametrize("variant", ["muon", "normuon", "muonbp"])
def test_full_train_tree_roundtrip(tmp_path, variant):
    """The composite checkpoint tree — params, owner-sharded MuonState incl.
    variant_state, data cursor, owner meta — round-trips bit-exactly, with
    its None leaves, Python ints and requires_grad."""
    tree_ = _train_tree(variant)
    if variant == "muon":
        assert tree_["train"]["opt_state"].variant_state is None
    else:
        assert tree_["train"]["opt_state"].variant_state is not None
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, tree_)
    out = mgr.restore(device="cpu")
    _assert_trees_equal(tree_, out)
    restored = TrainState(**out["train"])
    assert type(restored.opt_state).__name__ == "MuonState"
    assert restored.step == 2 and restored.opt_state.step == 2
    assert restored.opt_state.error_feedback is None
    assert int(out["data"]["data_step"]) == 2
    assert int(out["meta"]["num_owners"]) == 2


def test_keep3_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for s in range(1, 6):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    assert mgr.all_steps() == [3, 4, 5]
    assert mgr.latest_step() == 5
    np.testing.assert_array_equal(mgr.restore(device="cpu")["x"].numpy(),
                                  np.full((3,), 5.0))


def test_async_save_then_wait_ordering(tmp_path):
    """Consecutive non-blocking saves serialize (one in-flight at a time):
    after wait(), every step is committed and the latest restores to the
    latest payload — no torn or reordered commits."""
    mgr = CheckpointManager(str(tmp_path), keep=4, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((4, 4), float(s)), "step": s})
    mgr.wait()
    assert mgr.all_steps() == [1, 2, 3]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    for s in (1, 2, 3):
        out = mgr.restore(s, device="cpu")
        np.testing.assert_array_equal(out["x"].numpy(),
                                      np.full((4, 4), float(s)))
    assert mgr.restore(device="cpu")["step"] == 3


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_async_save_snapshot_is_synchronous(tmp_path, kind):
    """``save`` snapshots to host memory before returning: changing the live
    buffer in place after an async save (as the train step adds its deltas
    into the parameters) must not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    x = np.arange(8.0) if kind == "numpy" else torch.arange(8.0)
    mgr.save(1, {"x": x})
    x += 100.0
    mgr.wait()
    got = mgr.restore(device="cpu")["x"]
    np.testing.assert_array_equal(np.asarray(got), np.arange(8.0))


def test_restore_latest_after_partial_write(tmp_path):
    """A crash mid-save leaves ``step_N.tmp``; it must not shadow the last
    committed step, and a fresh manager over the directory must restore it."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, {"x": torch.ones((2, 2)) * 7})
    tmp = os.path.join(str(tmp_path), "step_000000009.tmp")
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaf_dead.shard0.npz"),
             data=np.zeros((2, 2)), index=np.asarray([[0, 2], [0, 2]]))
    mgr2 = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr2.all_steps() == [7]
    assert mgr2.latest_step() == 7
    np.testing.assert_array_equal(mgr2.restore(device="cpu")["x"].numpy(),
                                  np.ones((2, 2)) * 7)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")


def test_bfloat16_leaf_roundtrip(tmp_path):
    """numpy has no bfloat16: such a leaf travels as its bits."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x": x})
    got = mgr.restore(device="cpu")["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


# ------------------------------------------------------ against the reference


def _reference_run(tmp_path, steps: int = 2):
    """The reference's train tree after ``steps`` steps (num_owners 2,
    greedy), saved by the reference's manager into ``tmp_path / 'jax'``."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import api as japi
    from repro.core.muon import MuonConfig as JMuonConfig
    from repro.data.pipeline import batch_for_step as jbatch
    from repro.models import model_fns
    from repro.train.step import init_state as jinit, make_train_step as jmake

    jcfg = jconfigs.get("smollm-360m", reduced=True, n_layers=2)
    shapes = jax.eval_shape(lambda k: model_fns(jcfg).init(jcfg, k),
                            jax.random.PRNGKey(0))
    plan = japi.dedicate_params(shapes, num_owners=2, strategy="greedy")
    opt = japi.Muon(plan, config=JMuonConfig())
    state = jinit(jcfg, opt, jax.random.PRNGKey(0))
    step = jmake(jcfg, opt, donate=False)
    dcfg = DataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    for i in range(steps):
        state = step(state, jbatch(dcfg, i))
    JManager(str(tmp_path / "jax"), async_save=False).save(steps, {
        "train": state._asdict(),
        "data": {"data_step": np.asarray(steps, np.int64)},
        "meta": {"num_owners": np.asarray(2, np.int64)}})
    return jax, state, step, dcfg


def test_reference_checkpoint_restores_into_port_state(tmp_path):
    """The port reads the reference's checkpoint by path into its own
    state: every array bitwise the reference's, then 2 more steps of each
    within loss_ema atol 1e-3 and parameters rtol 5e-4 / atol 5e-5."""
    jax, jstate, jstep, dcfg = _reference_run(tmp_path)
    from repro.data.pipeline import batch_for_step as jbatch

    cfg, opt, _ = _setup()
    like = _ckpt_tree(init_state(cfg, opt, 0, "cpu"), 0)
    out = CheckpointManager(str(tmp_path / "jax")).restore(like=like)
    want = {p: np.asarray(v) for p, v in _flat(
        {"train": jax.tree.map(np.asarray, jstate._asdict())})}
    got = dict(_flat({"train": out["train"]}))
    assert set(got) == set(want)
    for p, v in got.items():
        arr = v.detach().numpy() if isinstance(v, torch.Tensor) else \
            np.asarray(v)
        np.testing.assert_array_equal(arr, want[p], err_msg=p)
    state = TrainState(**out["train"])
    assert state.step == 2 and state.opt_state.step == 2
    assert all(v.requires_grad for _, v in tree.flatten(state.params))
    assert int(out["data"]["data_step"]) == 2

    step = make_train_step(cfg, opt, device="cpu")
    for i in (2, 3):
        state = step(state, batch_for_step(dcfg, i, device="cpu"))
        jstate = jstep(jstate, jbatch(dcfg, i))
        np.testing.assert_allclose(float(state.loss_ema),
                                   float(jstate.loss_ema), rtol=0, atol=1e-3)
    for (p, a), (q, b) in zip(tree.flatten(state.params), tree.flatten(
            jax.tree.map(np.asarray, jstate.params)), strict=True):
        assert p == q
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-5, err_msg=p)


def test_port_checkpoint_reads_with_reference_assemble(tmp_path):
    """The port's files are the reference's format: the same leaf paths
    and leaf file names as the reference's checkpoint of the same train
    tree, and each leaf read back by the reference's ``_assemble`` equal to
    the port's array bitwise."""
    _reference_run(tmp_path)
    from repro.checkpoint.manager import _assemble

    tree_ = _train_tree("muon")
    CheckpointManager(str(tmp_path / "torch"), async_save=False).save(
        2, tree_)
    manifests = {}
    for pkg in ("jax", "torch"):
        with open(tmp_path / pkg / "step_000000002" / "manifest.json") as f:
            manifests[pkg] = json.load(f)["leaves"]
    assert manifests["torch"].keys() == manifests["jax"].keys()
    for p, meta in manifests["torch"].items():
        assert meta["file"] == manifests["jax"][p]["file"], p
        assert meta["shape"] == manifests["jax"][p]["shape"], p
    d = str(tmp_path / "torch" / "step_000000002")
    for p, leaf in _flat(tree_):
        arr = _assemble(d, manifests["torch"][p])
        want = leaf.detach().numpy() if isinstance(leaf, torch.Tensor) else \
            np.asarray(leaf)
        np.testing.assert_array_equal(arr, want, err_msg=p)
