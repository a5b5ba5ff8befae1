"""ZeRO-3 and the >= 340 B memory policy (``init_state(..., zero3=True)``,
``make_train_step(..., grad_specs=param_specs(..., zero3=True),
accum_dtype=...)``) on gloo worlds of their own
(``tests/torch_dist_check.py zero3`` / ``zero3_restore``), against the
reference's ZeRO-3 step on an Auto-axis (2, 2) mesh (``jax_tp
--zero3``).

Configs (``torch_dist_check.TP_CONFIGS``): ``nemo`` (reduced
nemotron-4-340b, fp32, vocab 256 so the head splits), ``nemoremat`` (the
same under remat: each layer gathered again in the backward), ``nemoacc``
(two microbatches accumulated in bf16, the reference's policy), ``dsv3``
(reduced DeepSeek-V3: the experts' d_ff split over 'data') and
``dsv3e2`` (3 layers of 2 experts: the padded owner layout), and
``nemostage`` (two microbatches on the bucketed schedule, each staged to
the owners as its backward ends).  After 3
Muon steps from the same numpy parameters on the same batches: step 1's
gradients (the mean over the global batch: Muon's update alone would not
see their scale), loss_ema and every parameter within 1e-4 of the
reference (bf16 accumulation
within the reference's bf16 tolerance, 2e-2, of its bf16 run); on (1, 1)
bitwise the one-process step; each rank holding 1 / (data x model) of
every leaf both axes split; gradients reaching the optimizer ``Shard``
over 'data'; AdamW moments shaped as the parts; pad momentum rows zero;
``init_state``'s parts bitwise the slices of the one-process ``init``; a
checkpoint written on (2, 2) restored bitwise on (2, 2), on (1, 2) and in
one process, each rank reading only its part of every split leaf.  Also
each card's bf16 parts of the three >= 340 B configs on the (16, 16) mesh.
"""

import concurrent.futures
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_check as dc
from repro_torch import configs
from repro_torch.core import api, tree
from repro_torch.models import transformer
from repro_torch.models.sharding import entry_axes, param_specs

MESH = (2, 2)
CONFIGS = ("nemo", "nemoremat", "nemoacc", "nemostage", "dsv3", "dsv3e2")
# the reference runs each distinct computation once: ``nemoremat``
# computes what ``nemo`` does
REFERENCE = {"nemoremat": "nemo"}
FP32 = ("nemo", "nemoremat", "nemostage", "dsv3", "dsv3e2")
ONE_MICROBATCH = ("nemo", "dsv3", "dsv3e2")
ONE_RANK = ("nemo", "dsv3")
ATOL = 1e-4
BF16_ATOL = 2e-2
CKPT = "nemo"
RESTORES = {(2, 2): 4, (1, 2): 2}
# beside the suite's other workers a reference process has taken over
# 240 s (``test_torch_tp_moe.py``)
DEADLINE_S = 900.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 2) world (then its checkpoint restored on (2, 2) and
    (1, 2)), the (1, 1) world and the reference process, side by side."""
    pytest.importorskip("jax")
    port = tmp_path_factory.mktemp("zero3_2x2")
    one = tmp_path_factory.mktemp("zero3_1x1")
    ref = tmp_path_factory.mktemp("zero3_jax")
    restores = {m: port / f"restore_{m[0]}x{m[1]}" for m in RESTORES}

    def split_world():
        dc.launch("zero3", math.prod(MESH), MESH, port, DEADLINE_S,
                  ("--configs", ",".join(CONFIGS), "--ckpt", CKPT))
        with concurrent.futures.ThreadPoolExecutor(len(RESTORES)) as pool:
            for f in [pool.submit(dc.launch, "zero3_restore", n, m,
                                  restores[m], DEADLINE_S, ("--ckpt", CKPT))
                      for m, n in RESTORES.items()]:
                f.result()

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(split_world),
                pool.submit(dc.launch, "zero3", 1, (1, 1), one, DEADLINE_S,
                            ("--configs", ",".join(ONE_RANK))),
                pool.submit(dc.run_jax, MESH, ref, DEADLINE_S, "jax_tp",
                            ("--configs", ",".join(
                                c for c in CONFIGS if c not in REFERENCE),
                             "--zero3"))]
        for j in jobs:
            j.result()
    return {"port": dc.load(port, math.prod(MESH)),
            "one": dc.load(one, 1),
            "ref": dict(np.load(ref / "jax.npz")),
            "restore": {m: dc.load(restores[m], n)
                        for m, n in RESTORES.items()}}


def _against_reference(runs, name, atol):
    ref, port = runs["ref"], runs["port"]
    want = REFERENCE.get(name, name)
    np.testing.assert_allclose(port["json"][0]["configs"][name]["ema"],
                               ref[f"{want}/ema"], rtol=0, atol=atol,
                               err_msg="loss_ema")
    z = port["npz"][0]
    keys = sorted(k[len(want):] for k in ref
                  if k.startswith(f"{want}/params/"))
    assert keys and keys == sorted(k[len(name):] for k in z
                                   if k.startswith(f"{name}/params/"))
    for k in keys:
        np.testing.assert_allclose(z[name + k], ref[want + k], rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", FP32)
def test_matches_reference_zero3_step(runs, name):
    _against_reference(runs, name, ATOL)


@pytest.mark.parametrize("name", ONE_MICROBATCH)
def test_step1_gradients_match_reference(runs, name):
    """Each gradient as it reaches the optimizer (whole: the reduce-
    scattered parts over 'data', the ``Partial`` means reduced) against
    the reference's gradient of the same loss on its sharded mesh: the
    reduce-scatter's sum and its 1 / data mean, which the orthogonalized
    update is blind to."""
    ref, z = runs["ref"], runs["port"]["npz"][0]
    keys = sorted(k for k in ref if k.startswith(f"{name}/grads/"))
    assert keys and keys == sorted(k for k in z
                                   if k.startswith(f"{name}/grads/"))
    for k in keys:
        np.testing.assert_allclose(z[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_bf16_accumulation_matches_reference(runs):
    """Two microbatches whose gradients are summed in bf16: each sum is
    rounded to bf16, so the run is held to the reference's bf16 run at
    its bf16 tolerance, and differs from the fp32 run by more than
    1e-4."""
    _against_reference(runs, "nemoacc", BF16_ATOL)
    z = runs["port"]["npz"][0]
    diff = max(float(np.abs(z[k] - z["nemo" + k[len("nemoacc"):]]).max())
               for k in z if k.startswith("nemoacc/params/"))
    assert diff > ATOL


def test_remat_gathers_again_bitwise(runs):
    """Under remat each layer's weights are gathered again in its
    backward: the same values, in the same order, bitwise."""
    port = runs["port"]
    for info in port["json"]:
        assert info["configs"]["nemoremat"]["ema"] == \
            info["configs"]["nemo"]["ema"]
    z = port["npz"][0]
    for k in z:
        if k.startswith("nemo/params/"):
            assert np.array_equal(z[k], z["nemoremat" + k[len("nemo"):]]), k


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_is_the_unsplit_step(runs, name):
    row = runs["one"]["json"][0]["configs"][name]
    assert row["single_bitwise"], (row["ema"], row["single_ema"])


@pytest.mark.parametrize("name", CONFIGS)
def test_parts_are_quarters(runs, name):
    """Each rank holds 1 / (data x model) of every leaf both axes split,
    1 / 2 of a leaf one axis splits; ``init_state(..., zero3=True)``'s
    parts are the slices of the one-process ``init``; every rank ends
    with the same loss_ema."""
    infos = runs["port"]["json"]
    specs = infos[0]["configs"][name]["specs"]
    both = [p for p, s in specs.items()
            if {"data", "model"} <= {a for e in s for a in entry_axes(e)}]
    assert len(both) >= 4
    for info in infos:
        row = info["configs"][name]
        assert row["ema"] == infos[0]["configs"][name]["ema"]
        assert row["init_parts_bitwise"] and row["adamw_local_shapes"]
        for p, s in specs.items():
            n = math.prod(MESH[i] for i, a in enumerate(("data", "model"))
                          if any(a in entry_axes(e) for e in s))
            assert row["share"][p] == 1 / n, (p, s)


@pytest.mark.parametrize("name", [c for c in CONFIGS if c != "nemostage"])
def test_grads_shard_over_data(runs, name):
    """Every gradient reaches the optimizer with the spec's ``Shard`` on
    each axis that splits it, 'data' included, and ``Partial("avg")`` on
    'data' where it is whole; the experts' d_ff over 'data'.
    (``nemostage`` hands the optimizer staged owner rows instead.)"""
    row = runs["port"]["json"][0]["configs"][name]
    for p, spec in row["specs"].items():
        want = []
        for a in ("data", "model"):
            d = [i for i, e in enumerate(spec) if a in entry_axes(e)]
            want.append(f"S({d[0]})" if d else
                        ("P(avg)" if a == "data" else "R"))
        assert row["placements"][p] == want, p
    for p in row["specs"]:
        if "/experts/" in p:
            dff = 3 if "down_proj" not in p else 2
            assert row["specs"][p][dff] == "data", p


def test_padded_owner_rows_stay_zero(runs):
    """``dsv3e2``: each expert leaf's 6 matrices over 4 owners, split on
    E over 'model' and on d_ff over 'data'; every momentum row at a pad
    position is zero on every rank, and ``reshard_owner_state`` to a
    permuted layout and back is bitwise."""
    for info in runs["port"]["json"]:
        for name in CONFIGS:
            assert info["configs"][name]["pad_rows_zero"], (name,
                                                             info["rank"])
        row = info["configs"]["dsv3e2"]
        assert row["padded"] == [f"blocks.moe.experts.{w}_proj.w"
                                 for w in ("down", "gate", "up")]
        assert row["reshard_roundtrip"]


@pytest.mark.parametrize("mesh", list(RESTORES),
                         ids=[f"{m[0]}x{m[1]}" for m in RESTORES])
def test_checkpoint_restores_each_part(runs, mesh):
    """The (2, 2) checkpoint restored on ``mesh``: each rank's part of
    every split leaf bitwise its slice of the saved state, read without
    assembling more than that part on its host; every other leaf (the
    owner rows whole) bitwise; rank 0's one-process restore bitwise."""
    infos = runs["restore"][mesh]["json"]
    specs = runs["port"]["json"][0]["configs"][CKPT]["specs"]
    for info in infos:
        assert info["bitwise"] and all(info["bitwise"].values()), info["rank"]
        assert set(info["bitwise"]) == set(info["compared"])
        for path, (read, whole) in info["read"].items():
            leaf = path.split("/", 2)[-1] if path.startswith("train/params") \
                else path.split("/", 4)[-1]
            n = math.prod(mesh[i] for i, a in enumerate(("data", "model"))
                          if any(a in entry_axes(e) for e in specs[leaf]))
            assert read * n == whole, path
    assert all(infos[0]["single_bitwise"].values())
    assert set(infos[0]["single_bitwise"]) == set(infos[0]["compared"])


def test_init_state_without_mesh_ignores_zero3():
    """As the reference's: without a mesh ``zero3`` changes nothing."""
    from repro_torch.train.step import init_state
    cfg = configs.get("nemotron-4-340b", reduced=True)
    opt = api.Muon(api.dedicate_params(transformer.init(cfg, device="meta")),
                   device="cpu")
    a = init_state(cfg, opt, seed=3, device="cpu")
    b = init_state(cfg, opt, seed=3, device="cpu", zero3=True)
    for (p, u), (_, v) in zip(tree.flatten(a.params), tree.flatten(b.params)):
        assert torch.equal(u, v), p


def test_other_data_splits_are_refused():
    """``grad_specs`` may split over 'data' only where ``param_specs(...,
    zero3=True)`` does: the embedding's rows are refused."""
    from repro_torch.train.step import _tp_specs
    cfg = configs.get("nemotron-4-340b", reduced=True, vocab=256)
    mesh = _Mesh((2, 2))
    shapes = transformer.init(cfg, device="meta")
    specs = param_specs(cfg, shapes, mesh, zero3=True)
    assert _tp_specs(cfg, mesh, specs) is specs
    bad = dict(specs, **{"embed/embedding": ("data", None)})
    with pytest.raises(ValueError, match="zero3=True"):
        _tp_specs(cfg, mesh, bad)


class _Mesh:
    """The shapes ``param_specs`` reads of a ("data", "model") mesh (no
    process group): the reference's single production mesh by default."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape=(16, 16)):
        self.shape = shape

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "deepseek-v3-671b",
                                  "kimi-k2-1t-a32b"])
def test_published_zero3_parts_fit_a_card(arch):
    """At published widths on the (16, 16) mesh under ZeRO-3, each leaf
    split over 'data' and 'model' is held 1 / 256 a card, and each card's
    bf16 parameter parts sum below 80 GB (without ZeRO-3 deepseek's and
    kimi's exceed it: ``test_torch_tp_moe.py``)."""
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.models.sharding import placements
    cfg = configs.get(arch)
    mesh = _Mesh()
    shapes = transformer.init(cfg, device="meta")
    specs = param_specs(cfg, shapes, mesh, zero3=True)
    held, doubly = 0, 0
    for p, v in tree.flatten(shapes):
        split = [i for i, q in enumerate(placements(specs[p], mesh))
                 if q.is_shard()]
        n = math.prod(mesh.size(i) for i in split)
        assert v.numel() % n == 0, p
        if len(split) == 2:
            doubly += 1
            assert n == 256, p
        held += v.numel() * v.element_size() // n
    assert cfg.param_dtype == "bfloat16" and doubly >= 4
    assert held < HBM_BYTES, held / 1e9
