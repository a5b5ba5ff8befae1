"""Twins of ``tests/test_properties.py`` on the port: the same nine
hypothesis properties, drawn by the reference's strategies with its
settings (15 examples, no deadline), each asserted on the port's
function.  Where the reference's function is numpy or cheap (the
assignment, greedy, rebalance, XOR-layout, pack and cost-model
properties) the port must also equal it on the drawn input; the
Newton-Schulz properties are asserted on the port alone, on numpy draws
from the drawn seed."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import load_balance as jlb  # noqa: E402
from repro.core.layout import slot_sequence as jslot_sequence  # noqa: E402
from repro_torch.core import load_balance as lb  # noqa: E402
from repro_torch.core.gram_ns import (GramNSConfig,  # noqa: E402
                                      gram_newton_schulz)
from repro_torch.core.layout import slot_sequence  # noqa: E402
from repro_torch.core.newton_schulz import newton_schulz  # noqa: E402
from test_properties import _SETTINGS, _census  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(seed: int, shape) -> torch.Tensor:
    """A standard normal draw of ``shape`` from numpy's ``seed``."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _same_assignment(a, b) -> None:
    assert a.owner_of.keys() == b.owner_of.keys()
    for s in a.owner_of:
        np.testing.assert_array_equal(a.owner_of[s], b.owner_of[s])
        assert [tuple(map(int, c)) for c in a.chunks[s]] == \
            [tuple(map(int, c)) for c in b.chunks[s]]


# --------------------------------------------------------- optimizer math

@settings(**_SETTINGS)
@given(m=st.integers(4, 24), n=st.integers(4, 48), seed=st.integers(0, 999))
def test_ns_drives_singular_values_to_one(m, n, seed):
    out = newton_schulz(_normal(seed, (m, n)), num_steps=10)
    s = torch.linalg.svdvals(out.float())
    s = s[s > 0.2]
    assert float((s - 1.0).abs().max()) < 0.1


@settings(**_SETTINGS)
@given(m=st.integers(4, 16), n=st.integers(16, 40), seed=st.integers(0, 999))
def test_gram_ns_equals_standard_ns(m, n, seed):
    x = _normal(seed, (m, n))
    a = newton_schulz(x, num_steps=5)
    b = gram_newton_schulz(x, GramNSConfig(num_steps=5))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


@settings(**_SETTINGS)
@given(seed=st.integers(0, 999))
def test_ns_left_orthogonal_equivariance(seed):
    m = _normal(seed, (12, 20))
    q, _ = torch.linalg.qr(_normal(seed + 1000, (12, 12)))
    a = newton_schulz(q @ m, num_steps=8)
    b = q @ newton_schulz(m, num_steps=8)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


# ------------------------------------------------------------ assignment

@settings(**_SETTINGS)
@given(census=_census(), owners=st.integers(1, 16))
def test_assignment_covers_every_matrix_exactly_once(census, owners):
    cm = lb.analytic_cost_model(census)
    jcm = jlb.analytic_cost_model(census)
    for strat in ("greedy", "lpt", "round_robin", "rank0"):
        asn = lb.assign(census, owners, strategy=strat, cost_model=cm)
        for s, count in census.items():
            assert len(asn.owner_of[s]) == count
            assert sum(b for b, _ in asn.chunks[s]) == count
            assert (asn.owner_of[s] < owners).all()
            assert (asn.owner_of[s] >= 0).all()
        _same_assignment(asn, jlb.assign(census, owners, strategy=strat,
                                         cost_model=jcm))


@settings(**_SETTINGS)
@given(census=_census(), owners=st.integers(2, 12))
def test_greedy_never_worse_than_rank0(census, owners):
    cm = lb.analytic_cost_model(census, batch_sizes=(1,))
    g = lb.solve_greedy(census, cm, owners)
    r0 = lb.rank0(census, owners)
    assert g.makespan(cm) <= r0.makespan(cm) + 1e-12
    jcm = jlb.analytic_cost_model(census, batch_sizes=(1,))
    jg = jlb.solve_greedy(census, jcm, owners)
    _same_assignment(g, jg)
    assert g.makespan(cm) == jg.makespan(jcm)
    assert r0.makespan(cm) == jlb.rank0(census, owners).makespan(jcm)


@settings(**_SETTINGS)
@given(census=_census(), owners=st.integers(2, 8),
       slow=st.integers(0, 7), factor=st.floats(2.0, 8.0))
def test_speed_aware_rebalance_never_hurts(census, owners, slow, factor):
    slow = slow % owners
    speed = np.ones(owners)
    speed[slow] = 1.0 / factor
    cm = lb.analytic_cost_model(census, batch_sizes=(1,))
    aware = lb.solve_greedy(census, cm, owners, speed=speed)
    blind = lb.solve_greedy(census, cm, owners)
    assert aware.makespan(cm, speed) <= blind.makespan(cm, speed) + 1e-12
    jcm = jlb.analytic_cost_model(census, batch_sizes=(1,))
    jaware = jlb.solve_greedy(census, jcm, owners, speed=speed)
    _same_assignment(aware, jaware)
    assert aware.makespan(cm, speed) == jaware.makespan(jcm, speed)


# -------------------------------------------------------------- layout

@settings(**_SETTINGS)
@given(rows=st.sampled_from([2, 4, 8]), mult=st.sampled_from([1, 2, 4]),
       periods=st.integers(1, 3))
def test_xor_layout_balanced_for_divisible_meshes(rows, mult, periods):
    cols = rows * mult
    seq = slot_sequence(rows * cols * periods, rows, cols)
    counts = np.bincount(seq, minlength=rows * cols)
    assert counts.min() == counts.max() == periods
    if cols > 1:
        colseq = seq % cols
        assert all(colseq[i] != colseq[i + 1] for i in range(len(seq) - 1))
    np.testing.assert_array_equal(
        seq, jslot_sequence(rows * cols * periods, rows, cols))


# -------------------------------------------------------- pack round trip

@settings(**_SETTINGS)
@given(l=st.integers(1, 6), m=st.sampled_from([8, 16]),
       n=st.sampled_from([8, 24]), owners=st.sampled_from([1, 2, 4]),
       seed=st.integers(0, 99))
def test_pack_unpack_roundtrip_random_shapes(l, m, n, owners, seed):
    from repro.core import api as japi
    from repro.core.muon import pack_group as jpack_group
    from repro_torch.core import api
    from repro_torch.core.muon import pack_group, unpack_group
    w = _normal(seed, (l, m, n))
    plan = api.dedicate_params({"w": w}, num_owners=owners,
                               strategy="greedy")
    key = next(iter(plan.groups))
    packed = pack_group(plan, key, {"w": w})
    assert packed.shape[0] % owners == 0
    out = unpack_group(plan, key, packed)
    assert torch.equal(out["w"], w)
    jw = jnp.asarray(w.numpy())
    jplan = japi.dedicate_params({"w": jw}, num_owners=owners,
                                 strategy="greedy")
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpack_group(jplan, key, {"w": jw})))


# ------------------------------------------------------------ cost model

@settings(**_SETTINGS)
@given(m=st.sampled_from([64, 256]), n=st.sampled_from([256, 1024]))
def test_cost_model_batching_amortization(m, n):
    cm = lb.analytic_cost_model({(m, n): 8}, batch_sizes=(1, 2, 4, 8))
    costs = [cm.cost((m, n), b) for b in (1, 2, 4, 8)]
    assert all(c2 >= c1 - 1e-12 for c1, c2 in zip(costs, costs[1:]))
    per = [c / b for c, b in zip(costs, (1, 2, 4, 8))]
    assert all(p2 <= p1 + 1e-12 for p1, p2 in zip(per, per[1:]))
    jcm = jlb.analytic_cost_model({(m, n): 8}, batch_sizes=(1, 2, 4, 8))
    assert costs == [jcm.cost((m, n), b) for b in (1, 2, 4, 8)]
