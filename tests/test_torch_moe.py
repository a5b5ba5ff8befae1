"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same numpy parameters and inputs, for both MoE
configs' reduced ``MoEConfig`` (DeepSeek-V3, Kimi-K2): forward, gradients
(``jax.grad`` against autograd) of the parameters and of the input, a
capacity factor that drops assignments, and the auxiliary load-balance
loss.

Tolerance rtol 1e-4 / atol 1e-4 in fp32, as the port's logits parity
(``tests/test_torch_train.py``): the two frameworks sum the K expert terms
of a token in different orders.  Random inputs have no ties in the top-k,
so both pick the same experts.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
B, S = 2, 24


def _setup(arch, **moe_overrides):
    jcfg = dataclasses.replace(jconfigs.get(arch, reduced=True).moe,
                               **moe_overrides)
    tcfg = dataclasses.replace(tconfigs.get(arch, reduced=True).moe,
                               **moe_overrides)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    nump = jax.tree.map(np.asarray, jp)
    tp = tree.tree_map(lambda a: torch.from_numpy(np.array(a))
                       .requires_grad_(True), nump)
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_configs_match_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(tconfigs.get(arch).moe) == \
            dataclasses.asdict(jconfigs.get(arch).moe)
        assert dataclasses.asdict(tconfigs.get(arch, reduced=True).moe) == \
            dataclasses.asdict(jconfigs.get(arch, reduced=True).moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaves_match_reference(arch):
    jcfg, tcfg, jp, _, _ = _setup(arch)
    want = {p: tuple(v.shape) for p, v in tree.flatten(
        jax.tree.map(np.asarray, jp))}
    got = {p: tuple(v.shape) for p, v in tree.flatten(
        tmoe.moe_init(None, tcfg, lead=(3,), device="meta"))}
    assert got == {p: (3,) + s for p, s in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp, x = _setup(arch)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe(p, jcfg, xx) * w)

    jy = jmoe.moe(jp, jcfg, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tmoe.moe(tp, tcfg, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    leaves = [v for _, v in tree.flatten(tp)] + [tx]
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), leaves)
    want = [np.asarray(v) for _, v in tree.flatten(
        jax.tree.map(np.asarray, jgp))] + [np.asarray(jgx)]
    paths = [p for p, _ in tree.flatten(tp)] + ["x"]
    for p, g, wnt in zip(paths, grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), wnt, err_msg=p, **TOL)
    assert float(grads[paths.index("router_w")].abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_capacity_matches_reference(arch):
    """At capacity factor 0.5 half the slots are missing: the same
    assignments are dropped (the outputs agree, and the drop count is the
    reference routing's overflow of each expert's capacity)."""
    jcfg, tcfg, jp, tp, x = _setup(arch, capacity_factor=0.5)
    tx = torch.from_numpy(x)
    T = B * S
    cap = tmoe.capacity(tcfg, T)
    logits = jnp.asarray(x).reshape(T, -1) @ jp["router_w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.n_experts)
    want_drops = int(np.maximum(counts - cap, 0).sum())
    assert want_drops > 0
    assert tmoe.dropped(tp, tcfg, tx) == want_drops
    with torch.no_grad():
        got = tmoe.moe(tp, tcfg, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jmoe.moe(jp, jcfg, jnp.asarray(x))), **TOL)


def test_dispatch_slots_rank_within_expert():
    """Stable order by expert id, then rank within the expert's segment:
    the first ``cap`` assignments (in (t, k) order) of each expert keep
    their slots, the rest go to the drop slot; each kept slot is filled by
    exactly its assignment."""
    idx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 2]])
    slot, src = tmoe.dispatch_slots(idx, 3, cap=2)
    drop = 6
    assert slot.tolist() == [0, 2, 1, 4, 3, drop, drop, 5]
    assert src.tolist() == [0, 2, 1, 4, 3, 7]


def test_dispatch_runs_on_shape_only_tensors():
    """The dispatch's shapes depend on (T, K, E, cap) alone, so it runs
    under ``FakeTensorMode`` (the dry run): no ``bincount`` or boolean
    mask, whose output sizes depend on the ids."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        idx = torch.zeros((64, 8), dtype=torch.long)
        slot, src = tmoe.dispatch_slots(idx, 16, cap=40)
    assert tuple(slot.shape) == (64 * 8,) and tuple(src.shape) == (16 * 40,)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp, x = _setup(arch)
    want = jmoe.aux_load_balance_loss(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = tmoe.aux_load_balance_loss(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_forward_backward_deterministic():
    """Dispatch and combine are gathers (no index written twice), so two
    forward / backward passes agree bit for bit."""
    _, tcfg, _, tp, x = _setup("deepseek-v3-671b", capacity_factor=0.75)
    outs = []
    for _ in range(2):
        tx = torch.from_numpy(x).requires_grad_(True)
        y = tmoe.moe(tp, tcfg, tx)
        outs.append([y.detach()] + list(torch.autograd.grad(
            y.square().sum(), [tx] + [v for _, v in tree.flatten(tp)])))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
