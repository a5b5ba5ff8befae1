"""Port optimizer vs the reference ``repro.core.api.Muon`` from identical
params and gradients, plus the port's own invariants.

Tolerance rtol 5e-4 / atol 5e-5, as the reference's
test_owner_equals_gather: the NS iterations of the two frameworks round
differently.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core.gram_ns import GramNSConfig as JGramNSConfig  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro_torch.core import api as tapi, tree  # noqa: E402
from repro_torch.core.gram_ns import GramNSConfig  # noqa: E402
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def n(*s):
        return (rng.standard_normal(s) * 0.02).astype(np.float32)
    return {"blocks": {"wq": n(3, 32, 32), "wo": n(3, 32, 32),
                       "up": n(3, 32, 128), "down": n(3, 128, 32),
                       "norm_scale": np.ones((3, 32), np.float32)},
            "embed_table": n(100, 32)}


def _grads(seed):
    rng = np.random.default_rng(100 + seed)
    return tree.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        _tree())


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _pair(mode, **kw):
    params = _tree()
    jplan = japi.dedicate_params(_to_jax(params), num_owners=4,
                                 strategy="greedy")
    tplan = tapi.dedicate_params(_to_torch(params), num_owners=4,
                                 strategy="greedy")
    common = dict(mode=mode, learning_rate=0.1, momentum=0.9, nesterov=True,
                  **kw)
    ns = kw.pop("ns", None)
    jopt = japi.Muon(jplan, config=JMuonConfig(
        **{**common, "ns": JGramNSConfig(num_steps=5, **(ns or {}))}))
    topt = tapi.Muon(tplan, config=MuonConfig(
        **{**common, "ns": GramNSConfig(num_steps=5, **(ns or {}))}),
        device="cpu")
    return params, jopt, topt


def _close(t, j, what):
    flat_t, flat_j = dict(tree.flatten(t)), dict(
        ("/".join(str(getattr(k, "key", k)) for k in kp), v)
        for kp, v in jax.tree_util.tree_flatten_with_path(j)[0])
    assert set(flat_t) == set(flat_j), what
    for p, v in flat_t.items():
        np.testing.assert_allclose(v.detach().float().numpy(),
                                   np.asarray(flat_j[p], np.float32),
                                   err_msg=f"{what}: {p}", **TOL)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("mode,kw", [("owner", {}), ("gather", {}),
                                     ("adamw", {}),
                                     ("owner", {"compress_grads": True})],
                         ids=["owner", "gather", "adamw", "owner-compress"])
def test_updates_and_state_match_reference(mode, kw, steps):
    params, jopt, topt = _pair(mode, **kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for t in range(steps):
        g = _grads(t)
        ju, js = jopt.update(_to_jax(g), js, jp)
        tu, ts = topt.update(_to_torch(g), ts, tp)
        _close(tu, ju, f"updates step {t}")
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = tree.tree_map(lambda p, u: p + u, tp, tu)
    assert ts.step == int(js.step) == steps
    _close(ts.momentum, js.momentum, "momentum")
    _close(ts.adamw.mu, js.adamw.mu, "adamw mu")
    _close(ts.adamw.nu, js.adamw.nu, "adamw nu")
    if kw.get("compress_grads"):
        _close(ts.error_feedback, js.error_feedback, "error feedback")
    _close(tp, jp, "params")


@pytest.mark.parametrize("steps", [1, 3])
def test_owner_equals_gather(steps):
    params, _, topt_o = _pair("owner")
    _, _, topt_g = _pair("gather")
    po, pg = _to_torch(params), _to_torch(params)
    so, sg = topt_o.init(po), topt_g.init(pg)
    for t in range(steps):
        g = _to_torch(_grads(t))
        uo, so = topt_o.update(g, so, po)
        ug, sg = topt_g.update(g, sg, pg)
        po = tree.tree_map(lambda p, u: p + u, po, uo)
        pg = tree.tree_map(lambda p, u: p + u, pg, ug)
    for (_, a), (_, b) in zip(tree.flatten(po), tree.flatten(pg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_bucket_fusion_matches_per_group():
    params = _to_torch(_tree())
    grads = _to_torch(_grads(0))
    plan = tapi.dedicate_params(params, num_owners=4, strategy="greedy")
    assert any(len(v) > 1 for v in plan.buckets.values())
    opt_a = tapi.Muon(plan, config=MuonConfig(mode="owner"), device="cpu")
    opt_b = tapi.Muon(plan, config=MuonConfig(
        mode="owner", ns=GramNSConfig(bucket_fusion=True)), device="cpu")
    ua, _ = opt_a.update(grads, opt_a.init(params), params)
    ub, _ = opt_b.update(grads, opt_b.init(params), params)
    for (_, a), (_, b) in zip(tree.flatten(ua), tree.flatten(ub)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_kernel_ops_path_matches_ref_path():
    """use_kernels=True (plain versions on CPU) == the ref-op path, within
    the reference's kernel-vs-jnp Gram NS gate (1e-4): the kernel path
    symmetrizes every product (mirror of the lower triangle), the ref path
    does not."""
    params = _to_torch(_tree())
    grads = _to_torch(_grads(0))
    plan = tapi.dedicate_params(params, num_owners=2, strategy="greedy")
    ua, _ = tapi.Muon(plan, device="cpu").update(
        grads, tapi.Muon(plan, device="cpu").init(params), params)
    opt_k = tapi.Muon(plan, config=MuonConfig(
        ns=GramNSConfig(use_kernels=True)), device="cpu")
    ub, _ = opt_k.update(grads, opt_k.init(params), params)
    for (_, a), (_, b) in zip(tree.flatten(ua), tree.flatten(ub)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_state_dict_roundtrip():
    params, _, opt = _pair("owner")
    tp = _to_torch(params)
    _, state = opt.update(_to_torch(_grads(0)), opt.init(tp), tp)
    state2 = opt.load_state_dict(opt.state_dict(state))
    for (_, a), (_, b) in zip(tree.flatten(state._asdict()),
                              tree.flatten(state2._asdict())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_unported_settings_raise_naming_roadmap():
    plan = tapi.dedicate_params(_to_torch(_tree()), num_owners=2)
    for kw in ({"pipeline": "bucketed"}, {"variant": "normuon"},
               {"variant": "dion2"}):
        with pytest.raises(ValueError, match="ROADMAP item 7"):
            tapi.Muon(plan, device="cpu", **kw)
    opt = tapi.Muon(plan, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        opt.update_staged({}, {}, None, None)
    from repro_torch.core.orthogonalize import (known_orthogonalizers,
                                                make_orthogonalizer)
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        make_orthogonalizer("normuon", opt.config)
    assert "normuon" not in known_orthogonalizers()
    with pytest.raises(ValueError, match="unknown variant"):
        tapi.Muon(plan, device="cpu", variant="nope")


def test_muon_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    plan = tapi.dedicate_params(_to_torch(_tree()), num_owners=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Muon(plan)
