"""The port's mesh layer against the reference, in one process: the
partitioning rules (``models/sharding.py``), mesh-aware dedication, spec →
placement mapping, the batch slice, and the checks that refuse what the
owner layout cannot move yet.  The multi-rank paths run in
``tests/test_torch_mesh_{owner,owner8,train}.py``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as tapi, tree  # noqa: E402
from repro_torch.core.dedication import LeafInfo  # noqa: E402
from repro_torch.core.owner_comms import (OwnerLayout,  # noqa: E402
                                          published, stacked_placements)
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")


class FakeMesh:
    """The ``DeviceMesh`` surface the rules read, for one rank's coordinate
    (no process group)."""

    def __init__(self, shape, names=AXES, coord=None):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(shape)
        self.coord = tuple(coord or (0,) * len(shape))

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, i):
        return self.coord[i]


def _shapes(reduced):
    jcfg = jconfigs.get("smollm-360m", reduced=reduced)
    tcfg = tconfigs.get("smollm-360m", reduced=reduced)
    jshapes = jax.eval_shape(lambda k: jtransformer.init(jcfg, k),
                             jax.random.PRNGKey(0))
    return jcfg, tcfg, jshapes, ttransformer.init(tcfg, device="meta")


@pytest.fixture(scope="module", params=[True, False], ids=["reduced", "full"])
def shapes(request):
    return _shapes(request.param)


def _jpaths(t):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(
                t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}


@pytest.mark.parametrize("zero3", [False, True], ids=["tp", "zero3"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (8, 1)],
                         ids=["2x4", "1x8", "8x1"])
def test_param_specs_match_reference(shapes, mesh_shape, zero3):
    jcfg, tcfg, jshapes, tshapes = shapes
    want = _jpaths(jsharding.param_specs(
        jcfg, jshapes, AbstractMesh(mesh_shape, AXES), zero3=zero3))
    got = tsharding.param_specs(tcfg, tshapes, FakeMesh(mesh_shape),
                                zero3=zero3)
    assert set(got) == set(want)
    for p, spec in want.items():
        assert got[p] == tuple(spec), p


@pytest.mark.parametrize("mesh_shape,names,batch", [
    ((2, 4), AXES, 8), ((2, 4), AXES, 3), ((4, 1), AXES, 8),
    ((2, 2, 2), ("pod", "data", "model"), 8),
    ((2, 2, 2), ("pod", "data", "model"), 6), ((8,), ("model",), 8)])
def test_batch_spec_matches_reference(mesh_shape, names, batch):
    want = jsharding.batch_spec(AbstractMesh(mesh_shape, names), batch)
    assert tsharding.batch_spec(FakeMesh(mesh_shape, names), batch) == \
        tuple(want)
    assert tsharding.dp_axes(FakeMesh(mesh_shape, names)) == \
        jsharding.dp_axes(AbstractMesh(mesh_shape, names))


@pytest.mark.parametrize("owner_axes", [(), ("model",)], ids=["all", "model"])
@pytest.mark.parametrize("strategy,reduced", [("load_balance", True),
                                              ("greedy", False)],
                         ids=["load_balance-reduced", "greedy-full"])
def test_dedicate_params_on_mesh_matches_reference(strategy, reduced,
                                                   owner_axes):
    # (the MILP of load_balance takes ~20 s on the full census at 8 owners)
    _, _, jshapes, tshapes = _shapes(reduced)
    jp = japi.dedicate_params(jshapes, AbstractMesh((2, 4), AXES),
                              strategy=strategy, owner_axes=owner_axes)
    tp = tapi.dedicate_params(tshapes, FakeMesh((2, 4)), strategy=strategy,
                              owner_axes=owner_axes)
    assert (tp.num_owners, tp.mesh_rows, tp.mesh_cols, tp.owner_axes) == \
        (jp.num_owners, jp.mesh_rows, jp.mesh_cols, tuple(jp.owner_axes))
    assert list(tp.groups) == list(jp.groups)
    for key, jg in jp.groups.items():
        tg = tp.groups[key]
        assert tg.capacity == jg.capacity
        np.testing.assert_array_equal(tg.pack_index, jg.pack_index)
        np.testing.assert_array_equal(tg.owner_of, jg.owner_of)


def test_placements_of_specs():
    m = FakeMesh((2, 4))
    assert tsharding.placements((None, None, "model"), m) == \
        (Replicate(), Shard(2))
    assert tsharding.placements(("model", None), m) == (Replicate(), Shard(0))
    assert tsharding.placements((("data", "model"), None), m) == \
        (Shard(0), Shard(0))
    assert tsharding.placements((None,), m) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.placements((("model", "data"),), m)


def test_local_batch_is_the_slice_of_the_global_batch():
    dcfg = tpipeline.DataConfig(vocab=257, seq_len=16, global_batch=8)
    full = tpipeline._batch_at(dcfg, 3)
    for shape in [(2, 2), (4, 1), (1, 1)]:
        parts = []
        for i in range(shape[0]):
            ranks = [tpipeline.batch_for_step(
                dcfg, 3, device="cpu", mesh=FakeMesh(shape, coord=(i, j)))
                for j in range(shape[1])]
            for r in ranks[1:]:          # replicated over 'model'
                assert torch.equal(r["tokens"], ranks[0]["tokens"])
            parts.append(ranks[0])
        for k in ("tokens", "labels"):
            got = np.concatenate([p[k].numpy() for p in parts])
            assert got.tobytes() == full[k].tobytes()
    with pytest.raises(ValueError, match="data-parallel"):
        tpipeline.batch_for_step(
            tpipeline.DataConfig(vocab=257, seq_len=16, global_batch=6),
            0, device="cpu", mesh=FakeMesh((4, 1)))


def _info(shape, transpose=False):
    return LeafInfo("blocks/w", shape, int(np.prod(shape[:-2])), transpose,
                    tuple(sorted(shape[-2:])), 0)


def test_stacked_placements():
    info = _info((8, 64, 256))
    assert stacked_placements(info, (Partial("avg"), Shard(2))) == \
        (Partial("avg"), Shard(2))
    assert stacked_placements(info, (Replicate(), Shard(1))) == \
        (Replicate(), Shard(1))
    tinfo = _info((8, 256, 64), transpose=True)
    assert stacked_placements(tinfo, (Replicate(), Shard(1))) == \
        (Replicate(), Shard(2))
    assert stacked_placements(tinfo, (Shard(-1), Replicate())) == \
        (Shard(1), Replicate())
    assert published((Partial("avg"), Shard(2))) == (Replicate(), Shard(2))


def test_stacked_placements_refuse_what_cannot_move():
    moe = _info((2, 4, 64, 256))
    with pytest.raises(ValueError, match="ROADMAP item 9"):
        stacked_placements(moe, (Shard(1), Replicate()))
    with pytest.raises(ValueError, match="more than one mesh axis"):
        stacked_placements(_info((8, 64, 256)), (Shard(2), Shard(2)))
    with pytest.raises(ValueError, match="'max'"):
        stacked_placements(_info((8, 64, 256)), (Partial("max"),
                                                  Replicate()))


def test_owner_layout_checks_the_mesh():
    params = {"w": torch.zeros(8, 64, 64, device="meta")}
    plan = tapi.dedicate_params(params, FakeMesh((2, 4)))
    layout = OwnerLayout(plan, FakeMesh((2, 4)))
    assert layout.local_rows("w") == plan.groups["w"].packed_size // 8
    assert layout.buffer_placements() == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="8 owners"):
        OwnerLayout(plan, FakeMesh((2, 2)))
    plan_m = tapi.dedicate_params(params, FakeMesh((2, 4)),
                                  owner_axes=("model",))
    assert OwnerLayout(plan_m, FakeMesh((2, 4))).buffer_placements() == \
        (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="not mesh axes"):
        OwnerLayout(plan_m, FakeMesh((2, 4), names=("data", "tensor")))


def test_make_mesh_needs_a_matching_process_group():
    assert tmesh.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh((1, 1), AXES, "cpu")
    with pytest.raises(ValueError, match="differ in rank"):
        tmesh.make_mesh((1,), AXES, "cpu")


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from repro_torch.launch import mesh
from repro_torch.models import sharding
from repro_torch.core import owner_comms
print("ok")
"""


def test_mesh_modules_import_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
