"""The port's owner layout across ranks on a (2, 4) ("data", "model")
gloo world of 8 processes: ``dist_check.py``'s checks 1–5 and the port's
invariants (``tests/torch_dist_check.py``), and the update against the
reference's own 8-device owner update on an Auto-axis mesh."""

import numpy as np
import pytest

import torch_dist_check as dc

MESH = (2, 4)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("owner_2x4")
    dc.launch("owner", 8, MESH, out)
    return dc.load(out, 8)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_2x4")
    dc.run_jax(MESH, out)
    return dict(np.load(out / "jax.npz"))


@pytest.mark.parametrize("check", sorted(dc.OWNER_CHECKS))
def test_dist_check_twin(result, check):
    dc.OWNER_CHECKS[check](result)


def test_update_matches_reference_mesh(result, reference):
    """(2, 4) owner update == the reference's 8-device owner update, at the
    kernel-path tolerance (1e-4)."""
    want = {k[6:]: v for k, v in reference.items() if k.startswith("owner/")}
    got = {k[6:]: v for k, v in result["npz"][0].items()
           if k.startswith("owner/")}
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-4, atol=1e-4,
                                   err_msg=p)


def test_owner_order_matches_reference_mesh(result, reference):
    """Each rank's momentum rows (after one step: the gradient, exactly)
    are the reference's shard on the device at the same mesh coordinate:
    the owner index is row-major over ("data", "model") in both."""
    for info, z in zip(result["json"], result["npz"]):
        oi = info["owner_index"]
        for k, full in reference.items():
            if k.startswith("mom/"):
                rows = z[k].shape[0]
                np.testing.assert_array_equal(
                    z[k], full[oi * rows:(oi + 1) * rows], err_msg=k)
