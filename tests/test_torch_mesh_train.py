"""The port's data-parallel train step on gloo worlds of 1, 2 and 4 ranks
(reduced smollm-360m, global batch 8 x 32 tokens, 3 steps) against the
single-process step, which rank 0 of each world also runs
(``tests/torch_dist_check.py train``).

At world 1 the step is bitwise the single-process one: the collectives of
one rank are copies.  At worlds 2 and 4 the gradient is the average of
per-rank means instead of one mean over the batch, so sums change order.
Measured on this reduced model: loss_ema within 4.8e-7 and parameters
within 6.7e-6 of the single process after 3 steps (updates are O(1e-2) a
step); the gates are loss_ema 1e-5 and parameters / logical momentum rows
5e-5 absolute.
"""

import numpy as np
import pytest

import torch_dist_check as dc

MESHES = [(1, 1), (2, 1), (4, 1), (2, 2)]
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{a}x{b}" for a, b in MESHES])
def world(request, tmp_path_factory):
    mesh = request.param
    out = tmp_path_factory.mktemp(f"train_{mesh[0]}x{mesh[1]}")
    n = mesh[0] * mesh[1]
    dc.launch("train", n, mesh, out)
    return mesh, dc.load(out, n)


def _close(got, want, atol, bitwise, what):
    if bitwise:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=what)


def test_losses_and_params_match_single_process(world):
    mesh, res = world
    info, z = res["json"][0], res["npz"][0]
    bitwise = mesh == (1, 1)
    _close(np.array(info["losses"]), np.array(info["single_losses"]),
           LOSS_ATOL, bitwise, "loss_ema")
    for k, v in z.items():
        if k.startswith("params/"):
            _close(v, z["single/" + k[len("params/"):]], PARAM_ATOL, bitwise,
                   k)


def test_params_replicated_on_every_rank(world):
    _, res = world
    z0 = res["npz"][0]
    for z in res["npz"][1:]:
        for k, v in z0.items():
            if k.startswith("params/"):
                np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_step_count_and_owner_momentum(world):
    """Every rank took 3 steps and holds packed_size / D momentum rows; the
    ranks' rows in owner order (rank order here) are the single process's
    logical momentum rows."""
    mesh, res = world
    z0 = res["npz"][0]
    for info in res["json"]:
        assert info["step"] == info["opt_step"] == 3
        assert info["num_owners"] == mesh[0] * mesh[1]
        for skey, (rows, packed) in info["rows"].items():
            assert rows == packed // info["num_owners"]
    assert [info["rank"] for info in res["json"]] == list(range(len(
        res["json"])))
    for skey in res["json"][0]["rows"]:
        stacked = np.concatenate([z[f"mom/{skey}"] for z in res["npz"]])
        single = z0[f"single_mom/{skey}"]
        # one owner holds every matrix with no pad row; the mesh plan's
        # contiguous layout keeps them first, pad rows (zeros) after
        count = len(single)
        _close(stacked[:count], single[:count], PARAM_ATOL,
               mesh == (1, 1), skey)
        assert not stacked[count:].any()


def test_each_rank_trains_on_its_slice(world):
    mesh, res = world
    assert all(info["local_tokens"] == 8 // mesh[0]
               for info in res["json"])
