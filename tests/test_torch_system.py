"""Twins of ``tests/test_system.py`` on the port: the three-line API
drives a real model (and so does ``MuonOptimizer`` in a plain PyTorch
loop), and the ownership strategy never changes the update."""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import api, tree
from repro_torch.core.muon import MuonConfig
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.kernels import autotune
from repro_torch.models import model_fns
from repro_torch.train.step import init_state, make_loss_fn, make_train_step


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()
    torch.set_num_threads(threads)


def test_three_line_api_end_to_end():
    """Paper Fig. 1(a): dedicate_params + Muon + update drives a real
    model (8 steps; the loss EMA falls)."""
    cfg = configs.get("smollm-360m", reduced=True)
    shapes = model_fns(cfg).init(cfg, device="meta")
    plan = api.dedicate_params(shapes)                              # line 1
    opt = api.Muon(plan, config=MuonConfig(), device="cpu")         # line 2
    state = init_state(cfg, opt, 0, device="cpu")                   # line 3
    step = make_train_step(cfg, opt, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    l0 = None
    for i in range(8):
        state = step(state, batch_for_step(dcfg, i, device="cpu"))
        if l0 is None:
            l0 = float(state.loss_ema)
    assert np.isfinite(float(state.loss_ema))
    assert float(state.loss_ema) < l0


def test_front_door_in_a_plain_loop():
    """The same model and data through ``MuonOptimizer``:
    ``loss.backward(); opt.step(); opt.zero_grad()`` for 8 steps; the
    loss EMA falls."""
    cfg = configs.get("smollm-360m", reduced=True)
    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           model_fns(cfg).init(cfg, 0, "cpu"))
    opt = api.MuonOptimizer(params, device="cpu")
    loss_fn = make_loss_fn(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    ema = l0 = None
    for i in range(8):
        loss = loss_fn(params, batch_for_step(dcfg, i, device="cpu"))
        loss.backward()
        opt.step()
        opt.zero_grad()
        loss = float(loss.detach())
        ema = loss if ema is None else 0.98 * ema + 0.02 * loss
        l0 = ema if l0 is None else l0
    assert np.isfinite(ema)
    assert ema < l0


def test_muon_semantics_invariant_across_strategies():
    """Ownership strategy changes scheduling, never the update (paper
    §3.4), on the reference's inputs: its 2-layer init and gradients
    (``jax.random``) as numpy."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import model_fns as jmodel_fns
    from repro_torch.models import transformer
    jcfg = jconfigs.get("smollm-360m", reduced=True, n_layers=2)
    jparams = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    jgrads = jax.tree.map(
        lambda x: jax.random.normal(jax.random.PRNGKey(1), x.shape) * 0.01,
        jparams)
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    grads = transformer.params_from_numpy(
        jax.tree.map(np.asarray, jgrads), device="cpu")
    outs = []
    for strat in ("greedy", "round_robin", "rank0"):
        plan = api.dedicate_params(params, num_owners=4, strategy=strat)
        opt = api.Muon(plan, config=MuonConfig(), device="cpu")
        upd, _ = opt.update(grads, opt.init(params), params)
        outs.append(dict(tree.flatten(upd)))
    for other in outs[1:]:
        assert other.keys() == outs[0].keys()
        for p, a in outs[0].items():
            np.testing.assert_allclose(a.numpy(), other[p].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=p)
