"""Every registered variant's optimizer state survives the port's
durability surface (twin of ``tests/test_variant_durability.py``):
``state_dict`` -> checkpoint save/restore -> ``load_state_dict`` bitwise,
training continuing bitwise from it, and owner-count resharding
(D=4 -> 2 -> 4) preserving every unpacked momentum and variant-state row
bit-exactly.  Parametrized over the whole registry."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import api, tree
from repro_torch.core.api import reshard_owner_state
from repro_torch.core.gram_ns import GramNSConfig
from repro_torch.core.muon import MuonConfig
from repro_torch.kernels import autotune


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


def _params():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(
        (rng.standard_normal((6, 8, 24)) * 0.02).astype(np.float32)),
        "bias": torch.zeros(24)}


def _grads(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree.tree_map(
        lambda x: torch.randn(x.shape, generator=gen) * 0.1, params)


def _opt(variant, num_owners):
    params = _params()
    plan = api.dedicate_params(params, num_owners=num_owners,
                               strategy="greedy")
    cfg = MuonConfig(variant=variant, ns=GramNSConfig(num_steps=5))
    return params, plan, api.Muon(plan, config=cfg, device="cpu")


def _advance(opt, params, n=2):
    st = opt.init(params)
    for t in range(n):
        _, st = opt.update(_grads(params, t), st, params)
    return st


def _leaves(t):
    return [v for _, v in tree.flatten(t)]


@pytest.mark.parametrize("variant", sorted(api.VARIANTS))
def test_state_dict_checkpoint_roundtrip_every_variant(tmp_path, variant):
    params, _, opt = _opt(variant, 4)
    st = _advance(opt, params)
    d = opt.state_dict(st)
    if api.get_variant(variant).stateful:
        assert d["variant_state"] is not None
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, d, block=True)
    restored = opt.load_state_dict(mgr.restore(2, device="cpu"))
    assert restored.step == st.step == 2
    assert (restored.variant_state is None) == (st.variant_state is None)
    a, b = _leaves(st), _leaves(restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    # and training continues bit-identically from the restored state
    u1, _ = opt.update(_grads(params, 9), st, params)
    u2, _ = opt.update(_grads(params, 9), restored, params)
    for x, y in zip(_leaves(u1), _leaves(u2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", sorted(api.VARIANTS))
def test_reshard_preserves_rows_every_variant(variant):
    params, plan4, opt4 = _opt(variant, 4)
    _, plan2, _ = _opt(variant, 2)
    st = _advance(opt4, params)
    st2 = reshard_owner_state(st, plan4, plan2)
    back = reshard_owner_state(st2, plan2, plan4)

    def rows(plan, buf):
        return np.take(buf.numpy(), plan.groups["w"].unpack_index, axis=0)

    for skey, buf in st.momentum.items():
        np.testing.assert_array_equal(rows(plan4, buf),
                                      rows(plan2, st2.momentum[skey]))
        assert torch.equal(buf, back.momentum[skey])
    if st.variant_state is not None:
        for field, bufs in st.variant_state.items():
            for skey, buf in (bufs or {}).items():
                np.testing.assert_array_equal(
                    rows(plan4, buf),
                    rows(plan2, st2.variant_state[field][skey]))
                np.testing.assert_array_equal(
                    rows(plan4, buf),
                    rows(plan4, back.variant_state[field][skey]))
