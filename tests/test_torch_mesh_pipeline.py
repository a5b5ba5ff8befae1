"""The bucketed schedule across ranks on a (2, 2) ("data", "model") gloo
world (``tests/torch_dist_check.py pipeline``, launched once for the
module), on a tree with two Gram buckets (m = 64 and 32).

* Bucketed equals fused bit for bit under the mesh, for every registry
  variant, from tensor-parallel and ``Partial`` gradients, over 3 steps:
  updates, momentum rows and variant-state rows.  The two schedules run
  the same collectives on the same data, reordered, and ``CommDebugMode``
  counts the same collectives and bytes for both.
* The schedule's events (``BucketPipeline.on_event``) come in the
  double-buffered order, with the overlap on: stage_in(b+1) issued before
  compute(b) and waited after it, publish(b) issued before compute(b+1)
  and waited after it, never two stagings in flight.
* Prestaged accumulation (``accum_steps=2``, a reduce-scatter per
  microbatch) against the unstaged step (one reduce-scatter of the summed
  gradient): the sums run in another order, so they agree to rounding.
  The gates are ``tests/test_torch_mesh_train.py``'s for the same
  reordered data-parallel sum on the same reduced model: loss_ema 1e-5
  and parameters 5e-5 absolute after 2 steps (measured: losses equal,
  parameters within 4.2e-6, each step's update within 1.7e-4 · its
  largest entry).
* AdamW's train step under the mesh: parameters and AdamW moments after 3
  steps bit for bit equal to the clone-and-all-reduce path, which the
  world recomputes itself.
"""

import numpy as np
import pytest

import torch_dist_check as dc

MESH = (2, 2)
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_2x2")
    dc.launch("pipeline", 4, MESH, out)
    return dc.load(out, 4)


def _under(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


@pytest.mark.parametrize("kind", dc.PIPELINE_KINDS)
@pytest.mark.parametrize("variant", dc.PIPELINE_VARIANTS)
def test_bucketed_bitwise_equal_fused(result, variant, kind):
    for z in result["npz"]:
        fused = _under(z, f"{variant}/{kind}/fused/")
        bucketed = _under(z, f"{variant}/{kind}/bucketed/")
        assert fused and set(fused) == set(bucketed)
        assert any("/vs/" in k for k in fused) == (
            variant not in ("muon", "adamw"))
        for k, v in fused.items():
            np.testing.assert_array_equal(bucketed[k], v, err_msg=k)


@pytest.mark.parametrize("kind", dc.PIPELINE_KINDS)
def test_same_collectives_and_bytes(result, kind):
    for info in result["json"]:
        fused = info["comm"][f"muon/{kind}/fused"]
        bucketed = info["comm"][f"muon/{kind}/bucketed"]
        assert fused
        assert sorted(map(tuple, fused)) == sorted(map(tuple, bucketed))


def test_double_buffered_issue_order(result):
    for info in result["json"]:
        assert info["overlap"] and info["buckets"] == 2
        events = [tuple(e) for e in info["events"]]
        at = {e: i for i, e in enumerate(events)}
        n = info["buckets"]
        assert len(at) == len(events) == 5 * n
        for b in range(n):
            assert at[("issue_stage_in", b)] < at[("wait_stage_in", b)] \
                < at[("compute", b)] < at[("issue_publish", b)] \
                < at[("wait_publish", b)]
            if b + 1 < n:
                assert at[("issue_stage_in", b + 1)] < at[("compute", b)]
                assert at[("wait_stage_in", b + 1)] > at[("compute", b)]
                assert at[("issue_publish", b)] < at[("compute", b + 1)]
                assert at[("wait_publish", b)] > at[("compute", b + 1)]
        staging = set()
        for what, b in events:
            if what == "issue_stage_in":
                staging.add(b)
            elif what == "wait_stage_in":
                staging.remove(b)
            elif what == "compute":
                assert staging == ({b + 1} if b + 1 < n else set()), \
                    (b, staging)
            assert len(staging) <= 1


def test_prestaged_accumulation_close_to_unstaged(result):
    for info, z in zip(result["json"], result["npz"]):
        # one reduce-scatter a group per microbatch, against one a group
        rs = info["prestage_reduce_scatters"]
        assert rs["True"] == 2 * rs["False"] > 0, rs
        losses = info["prestage_losses"]
        np.testing.assert_allclose(losses["True"], losses["False"], rtol=0,
                                   atol=LOSS_ATOL)
        want = _under(z, "prestageFalse/params/")
        got = _under(z, "prestageTrue/params/")
        assert want and set(got) == set(want)
        for p, v in want.items():
            np.testing.assert_allclose(got[p], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=p)


def test_adamw_step_bitwise_equal_clone_path(result):
    for info, z in zip(result["json"], result["npz"]):
        assert info["adamw_step_opt_step"] == info["adamw_clone_opt_step"]
        want = _under(z, "adamw_clone/")
        got = _under(z, "adamw_step/")
        assert want and set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
