"""The port's owner layout across ranks on a (2, 2) ("data", "model")
gloo world: the twin of ``dist_check.py``'s checks 1–5 with its tree,
gradients and tensor-parallel specs, plus the port's own invariants (see
``tests/torch_dist_check.py``, which the four rank processes run)."""

import pytest

import torch_dist_check as dc

MESH = (2, 2)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("owner_2x2")
    dc.launch("owner", 4, MESH, out)
    return dc.load(out, 4)


@pytest.mark.parametrize("check", sorted(dc.OWNER_CHECKS))
def test_dist_check_twin(result, check):
    dc.OWNER_CHECKS[check](result)
