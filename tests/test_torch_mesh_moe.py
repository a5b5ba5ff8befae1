"""Expert-parallel owner layouts across ranks on a (2, 2) ("data",
"model") gloo world (``tests/torch_dist_check.py moe``): 2 Muon steps of
the reduced Kimi-K2 whose expert leaves (L, E, m, n) are sharded on E over
"model" by ``param_specs``.  Their stacks are E-major (``_lead_perm``), so a
rank's shard is a block of owner rows that two of the four ranks must
exchange.  The updates equal, bit for bit, the same updates from
replicated gradients, from ``Partial`` data-parallel ones and in one
process (each matrix's Gram NS is the same arithmetic wherever its row
lands), and agree within 1e-5 with the reference's own update on an
8-device Auto-axis mesh with the same specs as its training layout."""

import numpy as np
import pytest

import torch_dist_check as dc

MESH = (2, 2)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_2x2")
    dc.launch("moe", 4, MESH, out)
    return dc.load(out, 4)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_moe_2x4")
    dc.run_jax((2, 4), out, mode="jax_moe")
    return dict(np.load(out / "jax.npz"))


def _under(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def test_experts_sharded_and_blocks_exchanged(result):
    """Every expert leaf's stacked view is split on its rows over "model",
    and the ranks off the diagonal of the (2, 2) grid swap owner blocks."""
    for info in result["json"]:
        assert len(info["expert_stacked"]) == 3
        for pl in info["expert_stacked"].values():
            assert pl[1] == "S(0)", pl
        a, c = info["coord"]
        partner = [i["rank"] for i in result["json"] if i["coord"] == [c, a]]
        assert info["block_peers"] == partner * 2
        assert (partner[0] == info["rank"]) == (a == c)


@pytest.mark.parametrize("kind", ["ep", "partial"])
def test_expert_parallel_update_bitwise_replicated(result, kind):
    for z in result["npz"]:
        for t in range(dc.MOE_STEPS):
            want = _under(z, f"replicated/upd{t}/")
            got = _under(z, f"{kind}/upd{t}/")
            assert want and set(got) == set(want)
            for p in want:
                np.testing.assert_array_equal(got[p], want[p],
                                              err_msg=f"step {t}: {p}")


def test_mesh_update_bitwise_one_process(result):
    z = result["npz"][0]
    for t in range(dc.MOE_STEPS):
        want = _under(z, f"nomesh/upd{t}/")
        got = _under(z, f"ep/upd{t}/")
        assert want and set(got) == set(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_expert_parallel_update_matches_reference_mesh(result, reference):
    z = result["npz"][0]
    for t in range(dc.MOE_STEPS):
        want = _under(reference, f"upd{t}/")
        got = _under(z, f"ep/upd{t}/")
        assert set(got) == set(want)
        for p in want:
            np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                       err_msg=f"step {t}: {p}")
