"""``MuonOptimizer`` (``core/optim.py``), DMuon as a
``torch.optim.Optimizer``, driven by a plain loop (``loss.backward();
opt.step(); opt.zero_grad()``) on the reduced smollm-360m.

It is bitwise the train step (``make_train_step``) for every variant; one
update is within the reference's 1e-4 of ``repro.core.api.Muon.update`` on
the same numpy parameters and gradients; its ``state_dict`` resumes
bitwise through a checkpoint; its groups' ``lr`` are the config's
``learning_rate`` / ``adam_lr``; it refuses a missing gradient and a mesh
that splits parameters over 'model'.  On two gloo ranks of a data-only
mesh (``tests/torch_dist_check.py optim``) the front door with
``grads="partial"`` is bitwise the data-parallel train step, and with
``grads="replicated"`` under ``DistributedDataParallel`` within 1e-5
relative of it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_check as dc
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import api, tree
from repro_torch.core.muon import MuonConfig
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.kernels import autotune
from repro_torch.models import transformer
from repro_torch.train.step import make_loss_fn, make_train_step
from repro_torch.train.train_state import TrainState

STEPS = 3
VARIANTS = ["muon", "normuon", "muonbp", "dion2", "adamuon", "adamw"]


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    """One intra-op thread (the suite runs in several pytest-xdist
    workers) and a private autotune cache."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()
    torch.set_num_threads(threads)


def _cfg():
    return configs.get("smollm-360m", reduced=True)


def _data(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)


def _muon_config(variant: str, **kw) -> MuonConfig:
    return MuonConfig(variant=variant, learning_rate=0.02, momentum=0.95,
                      muonbp_period=2, **kw)


def _params(cfg):
    return tree.tree_map(lambda v: v.requires_grad_(True),
                         transformer.init(cfg, 0, "cpu"))


def _step_run(cfg, mcfg, steps=STEPS):
    """``make_train_step``'s run: (loss_ema per step, parameters)."""
    opt = api.Muon(api.dedicate_params(transformer.init(cfg, device="meta")),
                   config=mcfg, device="cpu")
    params = _params(cfg)
    state = TrainState(0, params, opt.init(params), torch.zeros(()))
    step = make_train_step(cfg, opt, device="cpu", donate=True)
    ema = []
    for i in range(steps):
        state = step(state, batch_for_step(_data(cfg), i, device="cpu"))
        ema.append(state.loss_ema)
    return ema, state.params


def _loop(cfg, opt, params, first: int, last: int, ema=None):
    """The plain loop over batches ``first``..``last - 1``; the loss EMA
    as the train step keeps it."""
    loss_fn = make_loss_fn(cfg)
    out = []
    for i in range(first, last):
        loss = loss_fn(params, batch_for_step(_data(cfg), i, device="cpu"))
        loss.backward()
        opt.step()
        opt.zero_grad()
        loss = loss.detach()
        ema = loss if ema is None else 0.98 * ema + 0.02 * loss
        out.append(ema)
    return out


def _bitwise(a: dict, b: dict) -> None:
    fa, fb = dict(tree.flatten(a)), dict(tree.flatten(b))
    assert fa.keys() == fb.keys()
    for p in fa:
        assert torch.equal(fa[p].detach(), fb[p].detach()), p


@pytest.mark.parametrize("variant", VARIANTS)
def test_front_door_is_the_train_step(variant):
    """3 steps of the plain loop: every loss EMA and every final parameter
    bitwise ``make_train_step``'s (``zero_grad`` sets ``.grad`` to None,
    so each backward assigns it, as ``autograd.grad`` returns it)."""
    cfg = _cfg()
    mcfg = _muon_config(variant)
    ema, want = _step_run(cfg, mcfg)
    params = _params(cfg)
    opt = api.MuonOptimizer(params, config=mcfg, device="cpu")
    assert [len(g["params"]) for g in opt.param_groups] == [
        len(opt.plan.leaves), len(opt.plan.adamw_paths)]
    assert opt.state == {}
    got = _loop(cfg, opt, params, 0, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, ema)), (got, ema)
    _bitwise(params, want)
    assert opt.muon_state.step == STEPS


def test_one_update_matches_reference():
    """One step from the reference's parameters and random gradients (numpy,
    seed 3): the parameters move by the reference's ``Muon.update``
    deltas within 1e-4."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.core import api as japi
    from repro.core.muon import MuonConfig as JMuonConfig
    from repro.models import transformer as jtransformer
    jcfg = jconfigs.get("smollm-360m", reduced=True)
    jparams = jax.tree.map(np.asarray,
                           jtransformer.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(a.dtype),
        jparams)
    kw = dict(learning_rate=0.02, momentum=0.95)
    jopt = japi.Muon(japi.dedicate_params(jparams), config=JMuonConfig(**kw))
    upd, _ = jopt.update(grads, jopt.init(jparams), jparams)
    params = transformer.params_from_numpy(jparams, device="cpu",
                                           requires_grad=True)
    opt = api.MuonOptimizer(params, config=MuonConfig(**kw), device="cpu")
    tgrads = dict(tree.flatten(transformer.params_from_numpy(grads,
                                                             device="cpu")))
    for p, v in tree.flatten(params):
        v.grad = tgrads[p]
    opt.step()
    want = dict(tree.flatten(jax.tree.map(
        lambda a, u: np.asarray(a) + np.asarray(u), jparams, upd)))
    for p, v in tree.flatten(params):
        np.testing.assert_allclose(v.detach().numpy(), want[p], rtol=0,
                                   atol=1e-4, err_msg=p)


def test_state_dict_resumes_bitwise(tmp_path):
    """2 steps, ``state_dict()`` through a checkpoint (the manager's
    per-rank form), a fresh optimizer on the parameters and
    ``load_state_dict``: step 3 bitwise an uninterrupted run (NorMuon:
    momentum, AdamW moments and variant state)."""
    cfg = _cfg()
    mcfg = _muon_config("normuon")
    want = _params(cfg)
    ema = _loop(cfg, api.MuonOptimizer(want, config=mcfg, device="cpu"),
                want, 0, STEPS)

    params = _params(cfg)
    opt = api.MuonOptimizer(params, config=mcfg, device="cpu")
    got = _loop(cfg, opt, params, 0, 2)[-1]
    saved = opt.state_dict()
    del opt
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, {"state": saved["state"]}, block=True)
    saved["state"] = mgr.restore(2, device="cpu")["state"]
    fresh = api.MuonOptimizer(params, config=mcfg, device="cpu")
    fresh.load_state_dict(saved)
    got = _loop(cfg, fresh, params, 2, STEPS, got)
    assert torch.equal(got[-1], ema[-1])
    assert fresh.muon_state.step == STEPS
    _bitwise(params, want)


def test_load_state_dict_refuses_another_plan():
    """A state of 2 owners does not load into an optimizer of one."""
    cfg = _cfg()
    shapes = transformer.init(cfg, device="meta")
    two = api.MuonOptimizer(_params(cfg), device="cpu",
                            plan=api.dedicate_params(shapes, num_owners=2))
    one = api.MuonOptimizer(_params(cfg), device="cpu")
    with pytest.raises(ValueError, match="2 owners"):
        one.load_state_dict(two.state_dict())


def test_group_lr_is_the_config_rate():
    """Each group's ``lr`` set before the steps (a scheduler's job): the
    matrices' is ``learning_rate``, the rest's ``adam_lr``; 2 steps
    bitwise ``make_train_step`` with those rates."""
    cfg = _cfg()
    mcfg = _muon_config("muon")
    ema, want = _step_run(cfg, dataclasses.replace(
        mcfg, learning_rate=0.01, adam_lr=1e-3), steps=2)
    params = _params(cfg)
    opt = api.MuonOptimizer(params, config=mcfg, device="cpu")
    opt.param_groups[0]["lr"], opt.param_groups[1]["lr"] = 0.01, 1e-3
    got = _loop(cfg, opt, params, 0, 2)
    assert torch.equal(got[-1], ema[-1])
    _bitwise(params, want)
    assert (opt.muon.config.learning_rate, opt.muon.config.adam_lr) == (0.01, 1e-3)


def test_lr_scheduler_drives_both_groups():
    """A ``LambdaLR`` halves both rates each step: the config follows."""
    cfg = _cfg()
    params = _params(cfg)
    opt = api.MuonOptimizer(params, config=_muon_config("muon"),
                            device="cpu")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.5 ** s)
    loss_fn = make_loss_fn(cfg)
    for i in range(2):
        loss_fn(params, batch_for_step(_data(cfg), i,
                                       device="cpu")).backward()
        opt.step()
        opt.zero_grad()
        sched.step()
    assert opt.muon.config.learning_rate == 0.02 * 0.5
    assert opt.muon.config.adam_lr == 3e-4 * 0.5
    assert opt.param_groups[0]["lr"] == 0.02 * 0.25


def test_missing_grad_raises():
    cfg = _cfg()
    params = _params(cfg)
    opt = api.MuonOptimizer(params, device="cpu")
    make_loss_fn(cfg)(params, batch_for_step(_data(cfg), 0,
                                             device="cpu")).backward()
    params["final_norm"]["norm_scale"].grad = None
    with pytest.raises(ValueError, match="final_norm/norm_scale"):
        opt.step()


class _Mesh:
    """The names and extents ``MuonOptimizer`` reads of a mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape

    def size(self, i):
        return self.shape[i]


def test_model_axis_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        api.MuonOptimizer(_params(_cfg()), _Mesh((2, 2)), device="cpu")


def test_module_paths_are_the_reference_paths():
    """An ``nn.Module``: the plan names its parameters '/'-joined, and the
    loop trains it."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 4))
    opt = api.MuonOptimizer(model, device="cpu", learning_rate=0.05)
    assert "0/weight" in opt.plan.leaves
    assert set(opt.plan.leaves) | set(opt.plan.adamw_paths) == {
        n.replace(".", "/") for n, _ in model.named_parameters()}
    x, y = torch.randn(64, 16), torch.randn(64, 4)
    losses = []
    for _ in range(10):
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("optim")
    dc.launch("optim", 2, (2, 1), out, 300.0)
    return dc.load(out, 2)


def test_partial_grads_are_the_data_parallel_step(gloo):
    """Two gloo ranks, mesh (2, 1): each rank's own backward, no DDP,
    ``grads="partial"``: loss EMA and parameters bitwise the
    data-parallel ``make_train_step``'s on every rank."""
    for info in gloo["json"]:
        assert info["partial_bitwise"], info


def test_ddp_replicated_grads_match_the_step(gloo):
    """``DistributedDataParallel`` averages, ``grads="replicated"``: within
    1e-5 relative of the data-parallel step (DDP's bucketed all-reduce
    sums in another order than the owner reduce-scatter)."""
    for info in gloo["json"]:
        assert info["ddp_max_rel"] <= 1e-5, info
        assert info["ddp_ema_rel"] <= 1e-5, info
