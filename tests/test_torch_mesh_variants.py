"""The port's optimizer variants across ranks on a (2, 2) ("data",
"model") gloo world (``tests/torch_dist_check.py variants``, launched once
for the module): for NorMuon, MuonBP (period 2: refresh, reuse, refresh),
Dion2 and AdaMuon, 3 steps from tensor-parallel, replicated and
``Partial`` (data-parallel) gradients.  The mesh's updates and each rank's
variant-state rows equal the one-process run on the same plan bit for bit:
every variant's math is per owner row, so a rank computes the same
arithmetic on fewer rows."""

import numpy as np
import pytest

import torch_dist_check as dc

MESH = (2, 2)
KINDS = ("tp", "replicated", "partial")


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("variants_2x2")
    dc.launch("variants", 4, MESH, out)
    return dc.load(out, 4)


def _under(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", dc.VARIANTS)
def test_updates_bitwise_equal_one_process(result, variant, kind):
    z = result["npz"][0]
    for t in range(dc.VARIANT_STEPS):
        want = _under(z, f"{variant}/nomesh/upd{t}/")
        got = _under(z, f"{variant}/{kind}/upd{t}/")
        assert want and set(got) == set(want)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"step {t}: {p}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", dc.VARIANTS)
def test_state_rows_bitwise_equal_one_process(result, variant, kind):
    """Each rank holds packed_size / D rows of every variant-state buffer,
    the rows of its owner slot in the one-process state."""
    z0 = result["npz"][0]
    for info, z in zip(result["json"], result["npz"]):
        oi = info["owner_index"]
        for t in range(dc.VARIANT_STEPS):
            want = _under(z0, f"{variant}/nomesh/state{t}/")
            got = _under(z, f"{variant}/{kind}/state{t}/")
            assert want and set(got) == set(want)
            for p, full in want.items():
                rows = len(full) // info["num_owners"]
                assert got[p].shape == (rows,) + full.shape[1:]
                np.testing.assert_array_equal(
                    got[p], full[oi * rows:(oi + 1) * rows],
                    err_msg=f"rank {oi} step {t}: {p}")
