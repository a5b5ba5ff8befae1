"""Elastic restart across owner counts in the port (twin of
``tests/test_elastic.py``): state taken at D owners resumes bit-exactly at
D' owners, ``reshard_owner_state`` round-trips D -> D' -> D exactly on
contiguous and non-contiguous pack layouts and per-variant state, and
equals the reference's ``reshard_owner_state`` bitwise on the same numpy
rows."""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import api, tree
from repro_torch.core.api import reshard_owner_state
from repro_torch.core.muon import AdamWState, MuonConfig, MuonState
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


def _setup(num_owners):
    cfg = configs.get("smollm-360m", reduced=True)
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=num_owners, strategy="greedy")
    return cfg, plan, api.Muon(plan, config=MuonConfig(), device="cpu")


def test_owner_state_reshard_resumes_exactly():
    """3 steps at 4 owners, re-plan at 2 and reshard, 2 more steps on each:
    the parameters agree bit for bit (each Gram NS launch carries a
    different number of matrices, which the math does not see)."""
    cfg, plan4, opt4 = _setup(4)
    _, plan2, opt2 = _setup(2)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    state = init_state(cfg, opt4, 0, "cpu")
    step4 = make_train_step(cfg, opt4, device="cpu")
    for i in range(3):
        state = step4(state, batch_for_step(dcfg, i, device="cpu"))

    opt_state2 = reshard_owner_state(state.opt_state, plan4, plan2)
    # the parameters are updated in place: continue each run from a copy
    params2 = tree.tree_map(lambda v: v.detach().clone().requires_grad_(True),
                            state.params)
    cont2 = TrainState(state.step, params2, opt_state2, state.loss_ema)
    step2 = make_train_step(cfg, opt2, device="cpu")
    cont4 = state
    for i in range(3, 5):
        batch = batch_for_step(dcfg, i, device="cpu")
        cont4 = step4(cont4, batch)
        cont2 = step2(cont2, batch)
    for (p, a), (_, b) in zip(tree.flatten(cont4.params),
                              tree.flatten(cont2.params), strict=True):
        assert torch.equal(a, b), p


def test_reshard_momentum_padding_is_zero():
    cfg, plan4, opt4 = _setup(4)
    _, plan8, _ = _setup(8)
    params = transformer.init(cfg, 0, "cpu")
    st = opt4.init(params)
    gen = torch.Generator().manual_seed(9)
    grads = tree.tree_map(
        lambda x: torch.randn(x.shape, generator=gen) * 0.1, params)
    _, st = opt4.update(grads, st, params)
    st8 = reshard_owner_state(st, plan4, plan8)
    for key, g in plan8.groups.items():
        buf = st8.momentum[key.replace("/", ".")].numpy()
        assert buf.shape[0] == g.packed_size
        if g.packed_size > g.count:
            assert np.all(buf[g.count:] == 0)        # pads stay zero


# ----------------------------------------------------------------------
# round trips (D -> D' -> D), incl. non-contiguous pack layouts and
# per-variant owner state
# ----------------------------------------------------------------------

def _logical_rows(plan, key, buf):
    return np.take(buf.numpy(), plan.groups[key].unpack_index, axis=0)


def _stack_plan(num_owners, physical_layout="contiguous",
                strategy="greedy"):
    # one leaf of 6 stacked matrices: capacity padding at 4 owners, and
    # (round_robin + layout='assignment') a non-contiguous pack_index
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        rng.standard_normal((6, 8, 24)).astype(np.float32))}
    plan = api.dedicate_params(params, num_owners=num_owners,
                               strategy=strategy,
                               physical_layout=physical_layout)
    return params, plan


def _stepped(plan, params, variant="muon", seed=3):
    opt = api.Muon(plan, config=MuonConfig(variant=variant), device="cpu")
    st = opt.init(params)
    gen = torch.Generator().manual_seed(seed)
    grads = {"w": torch.randn(params["w"].shape, generator=gen) * 0.1}
    _, st = opt.update(grads, st, params)
    return opt, st


@pytest.mark.parametrize("layout,strategy", [("contiguous", "greedy"),
                                             ("assignment", "round_robin")])
def test_reshard_roundtrip_4_2_4_exact(layout, strategy):
    """D=4 -> D'=2 -> D=4 reproduces the momentum exactly; with
    physical_layout='assignment' the reshard follows pack_index, not an
    assumption of contiguity."""
    params, plan4 = _stack_plan(4, layout, strategy)
    _, plan2 = _stack_plan(2, layout, strategy)
    if layout == "assignment":
        g4 = plan4.groups["w"]
        assert not np.array_equal(g4.pack_index[:g4.count],
                                  np.arange(g4.count)), \
            "test needs a non-contiguous pack layout"
    _, st = _stepped(plan4, params)
    st2 = reshard_owner_state(st, plan4, plan2)
    back = reshard_owner_state(st2, plan2, plan4)
    for skey, buf in st.momentum.items():
        assert torch.equal(buf, back.momentum[skey])
        np.testing.assert_array_equal(
            _logical_rows(plan4, "w", buf),
            _logical_rows(plan2, "w", st2.momentum[skey]))


def test_reshard_carries_variant_state():
    """NorMuon moments / MuonBP polar caches / Dion2 factor bases / AdaMuon
    second moments are owner-major buffers too and reshard row-exactly with
    the momentum; None fields stay None (the tree of a fresh init)."""
    for variant in ("normuon", "muonbp", "dion2", "adamuon"):
        params, plan4 = _stack_plan(4)
        _, plan2 = _stack_plan(2)
        _, st = _stepped(plan4, params, variant, seed=5)
        assert st.variant_state is not None
        st2 = reshard_owner_state(st, plan4, plan2)
        back = reshard_owner_state(st2, plan2, plan4)
        fresh = api.Muon(plan2, config=MuonConfig(variant=variant),
                         device="cpu").init(params).variant_state
        assert {f: None if v is None else sorted(v)
                for f, v in st2.variant_state.items()} == \
            {f: None if v is None else sorted(v) for f, v in fresh.items()}
        for field, bufs in st.variant_state.items():
            for skey, buf in (bufs or {}).items():
                np.testing.assert_array_equal(
                    _logical_rows(plan4, "w", buf),
                    _logical_rows(plan2, "w",
                                  st2.variant_state[field][skey]))
                np.testing.assert_array_equal(
                    _logical_rows(plan4, "w", buf),
                    _logical_rows(plan4, "w",
                                  back.variant_state[field][skey]))
                pads = np.delete(back.variant_state[field][skey].numpy(),
                                 plan4.groups["w"].unpack_index, axis=0)
                assert np.all(pads == 0)


def test_reshard_group_count_mismatch_raises():
    """Plans over different parameter sets are rejected with a typed error
    naming the group and both counts, the reference's message."""
    params6, plan6 = _stack_plan(2)
    plan4mat = api.dedicate_params({"w": torch.zeros(4, 8, 24)},
                                   num_owners=2, strategy="greedy")
    st = api.Muon(plan6, config=MuonConfig(), device="cpu").init(params6)
    with pytest.raises(ValueError) as ei:
        reshard_owner_state(st, plan6, plan4mat)
    msg = str(ei.value)
    assert "'w'" in msg and "6" in msg and "4" in msg


@pytest.mark.parametrize("layout,strategy", [("contiguous", "greedy"),
                                             ("assignment", "round_robin")])
def test_reshard_matches_reference(layout, strategy):
    """The same numpy rows (momentum, a per-row and a per-matrix variant
    field, a None field, AdamW moments) resharded 4 -> 2 -> 4 by both
    packages: every buffer bitwise equal."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import api as japi
    from repro.core.muon import MuonState as JMuonState
    from repro.core.update_rules import AdamWState as JAdamWState

    shape = (6, 8, 24)
    tplans = [api.dedicate_params({"w": torch.zeros(shape)}, num_owners=d,
                                  strategy=strategy, physical_layout=layout)
              for d in (4, 2)]
    jplans = [japi.dedicate_params({"w": jnp.zeros(shape)}, num_owners=d,
                                   strategy=strategy, physical_layout=layout)
              for d in (4, 2)]
    g = tplans[0].groups["w"]
    rng = np.random.default_rng(1)
    rows = {"mom": rng.standard_normal((g.packed_size, 8, 24)),
            "v": rng.standard_normal((g.packed_size, 8)),
            "q": rng.standard_normal((g.packed_size, 8, 8)),
            "mu": rng.standard_normal((24,))}
    rows = {k: v.astype(np.float32) for k, v in rows.items()}

    def state(arr, S, A):
        return S(step=2, momentum={"w": arr(rows["mom"])},
                 adamw=A({"bias": arr(rows["mu"])}, {"bias": arr(rows["mu"])}),
                 error_feedback=None,
                 variant_state={"v": {"w": arr(rows["v"])},
                                "q": {"w": arr(rows["q"])}, "inner": None})

    t = state(torch.from_numpy, MuonState, AdamWState)
    j = state(jnp.asarray, JMuonState, JAdamWState)
    t2 = reshard_owner_state(t, tplans[0], tplans[1])
    j2 = japi.reshard_owner_state(j, jplans[0], jplans[1])
    t4 = reshard_owner_state(t2, tplans[1], tplans[0])
    j4 = japi.reshard_owner_state(j2, jplans[1], jplans[0])
    for ts, js in ((t2, j2), (t4, j4)):
        assert ts.variant_state["inner"] is None is js.variant_state["inner"]
        assert ts.error_feedback is None is js.error_feedback
        pairs = [(ts.momentum["w"], js.momentum["w"]),
                 (ts.adamw.mu["bias"], js.adamw.mu["bias"])] + [
            (ts.variant_state[f]["w"], js.variant_state[f]["w"])
            for f in ("v", "q")]
        for a, b in pairs:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
