"""Checkpoints and the resilient loop across ranks on gloo
(``tests/torch_dist_check.py checkpoint``, a (2, 2) ("data", "model")
world launched once for the module, then ``restore`` on a (1, 2) world):

* the (2, 2) loop's checkpoint, written by every rank in owner row blocks,
  reassembles to every rank's rows;
* it restores onto one process (4 -> 1 owners) and onto a (1, 2) world
  (4 -> 2 owners, each rank keeping its rows): the logical momentum and
  NorMuon rows and the parameters bitwise those of the (2, 2) run;
* a rebalance on the mesh fires alike on every rank, and
  ``reshard_owner_state`` on the mesh equals the one-process reshard
  bitwise on a layout where the re-plan moves rows;
* a kill on the live world raises, naming ROADMAP item 8;
* ``remesh`` over the world and over a subset of its ranks; the
  prefetching ``Pipeline`` yields each rank's rows."""

import numpy as np
import pytest
import torch

import torch_dist_check as dc
from repro_torch import configs
from repro_torch.core import api
from repro_torch.kernels import autotune
from repro_torch.models import transformer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MESH = (2, 2)
WORLD = 4


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("checkpoint_2x2")
    dc.launch("checkpoint", WORLD, MESH, out)
    return out, dc.load(out, WORLD)


def _plan(num_owners):
    cfg = configs.get("smollm-360m", reduced=True, n_layers=dc.CKPT_LAYERS)
    return api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=num_owners, strategy="greedy")


def _under(z: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _global(res, prefix: str) -> dict:
    """{group: all D·cap rows} assembled from every rank's own rows."""
    order = sorted(range(len(res["json"])),
                   key=lambda r: res["json"][r]["owner_index"])
    keys = _under(res["npz"][0], prefix)
    return {k: np.concatenate([res["npz"][r][prefix + k] for r in order])
            for k in keys}


def _logical(plan, bufs: dict) -> dict:
    from repro_torch.core.owner_comms import group_key_str
    return {group_key_str(k): bufs[group_key_str(k)][g.unpack_index]
            for k, g in plan.groups.items()}


def _want(res) -> dict:
    plan = _plan(WORLD)
    return {f: _logical(plan, _global(res, f"{f}/")) for f in ("mom", "v")}


def test_rebalance_fires_alike_on_every_rank(run):
    _, res = run
    assert [j["rebalances"] for j in res["json"]] == [1] * WORLD
    assert len({tuple(j["rebalance_steps"]) for j in res["json"]}) == 1
    assert all(j["checkpoints"] == [dc.CKPT_STEPS] for j in res["json"])
    assert sorted(j["owner_index"] for j in res["json"]) == list(range(WORLD))


def test_row_blocks_reassemble(run):
    """Every rank wrote its rows of the owner buffers; the checkpoint
    reassembles them to the D·cap rows the ranks hold between them."""
    from repro_torch.checkpoint.manager import CheckpointManager
    out, res = run
    tree = CheckpointManager(str(out / "ckpt")).restore(device="cpu")
    opt = tree["train"]["opt_state"]
    for f, bufs in (("mom", opt.momentum), ("v", opt.variant_state["v"])):
        want = _global(res, f"{f}/")
        assert bufs.keys() == want.keys()
        for k, v in bufs.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert tree["train"]["step"] == dc.CKPT_STEPS
    assert int(tree["meta"]["num_owners"]) == WORLD


def test_restore_onto_one_process(run):
    out, res = run
    loop = dc._resilient_loop(None, out / "ckpt", resume=True)
    loop.pipe.close()
    assert loop.num_owners == 1 and loop.state.step == dc.CKPT_STEPS
    st = loop.state.opt_state
    want = _want(res)
    for f, bufs in (("mom", st.momentum), ("v", st.variant_state["v"])):
        got = _logical(loop.plan, {k: v.numpy() for k, v in bufs.items()})
        for k in want[f]:
            np.testing.assert_array_equal(got[k], want[f][k], err_msg=k)
    params = _under(res["npz"][0], "params/")
    for p, v in dc._owner_arrays(loop).items():
        if p.startswith("params/"):
            np.testing.assert_array_equal(v, params[p[len("params/"):]])


def test_restore_onto_1x2(run):
    out, res = run
    sub = out / "restore"
    dc.launch("restore", 2, (1, 2), sub)
    got_res = dc.load(sub, 2)
    assert [j["num_owners"] for j in got_res["json"]] == [2, 2]
    assert all(j["step"] == dc.CKPT_STEPS for j in got_res["json"])
    plan2 = _plan(2)
    want = _want(res)
    for f in ("mom", "v"):
        got = _logical(plan2, _global(got_res, f"{f}/"))
        for k in want[f]:
            np.testing.assert_array_equal(got[k], want[f][k], err_msg=k)
    for r in range(2):
        for p, v in _under(got_res["npz"][r], "params/").items():
            np.testing.assert_array_equal(v, res["npz"][0]["params/" + p])


def test_mesh_reshard_equals_one_process(run):
    _, res = run
    assert res["json"][0]["layouts_differ"]
    for j in res["json"]:
        assert j["mesh_reshard_bitwise"] and \
            all(j["mesh_reshard_bitwise"].values())


def test_kill_on_mesh_raises(run):
    _, res = run
    for j in res["json"]:
        assert j["kill_error"] and "ROADMAP item 8" in j["kill_error"]


def test_remesh(run):
    """``remesh`` builds ("data", "model") meshes of
    ``viable_mesh_shape`` over the world or a subset; ranks left out have
    no coordinate."""
    _, res = run
    for r, j in enumerate(res["json"]):
        m = j["remesh"]
        assert m["full"] == [[1, 4], ["data", "model"]]
        assert m["flat"] == [4, 1] and m["sub"] == [1, 2]
        assert m["sub_coordinate"] == ([0, r] if r < 2 else None)


def test_pipeline_yields_rank_rows(run):
    """Under the mesh the prefetching ``Pipeline`` yields this rank's rows,
    byte for byte ``batch_for_step(..., mesh=)``."""
    _, res = run
    assert all(j["pipeline_rows"] for j in res["json"])
