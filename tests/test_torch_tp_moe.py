"""The expert-parallel train step of the MoE family (``models/moe.py``,
``models/layers.py:_mla_tp``, ``train/step.py`` on a mesh whose 'model'
axis has more than one rank) on gloo worlds (1, 2), (2, 2) and (1, 4)
(``tests/torch_dist_check.py tp``), against the reference's sharded step
on an Auto-axis mesh of the same shape (``jax_tp``) and against its own
one-process step.

Configs (``torch_dist_check.TP_CONFIGS``): ``dsv3`` (reduced DeepSeek-V3:
MLA, 4 heads, 4 experts, top-2, 1 shared), ``kimi`` (reduced Kimi-K2:
GQA 4 / 2), ``dsv3g`` (3 heads, 6 experts: at model 4 the MLA's q_b /
kv_b / o split mid-head, so the sequence-sharded path, and the experts
whole) and ``dsv3drop`` (capacity factor 0.5: the dispatch drops
assignments, and on (2, 2) must drop them over the global batch as the
reference's ``jit`` of the whole batch does), ``dsv3acc`` (``dsv3drop``
in two microbatches: each the global batch's block, dispatched over the
data ranks), ``dsv3e16`` (16 experts: eight a rank at model 2, in the
owner layouts' blocks) and ``dsv3e2`` (3 layers of 2 experts: at (2, 2)
6 expert matrices a leaf over 4 owners, the padded owner layout).  After 3 Muon steps from
the same numpy parameters on the same batches: loss_ema and every
parameter within 1e-4 of the reference; each world within
``chip_smoke.tp_gate`` of one process (10x what one ulp on half the
parameters moves it); gradients placed as ``param_specs`` says (the
experts ``Shard(1)`` on 'model'); ``init_state``'s parts bitwise the
slices of the one-process ``init``.  Also: a checkpoint of ``dsv3``
written at (1, 4) and restored at (2, 2), bitwise, each rank assembling
only its experts; the dispatch over data ranks against the whole batch's;
the dry run's split walk; and the tensor-parallel code path on a model
axis of one rank bitwise the plain one.
"""

import concurrent.futures
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_check as dc
from repro_torch import configs
from repro_torch.core import tree
from repro_torch.models import moe as moe_lib
from repro_torch.models import tp as tp_lib
from repro_torch.models import transformer

PAIRS = {(1, 2): ("dsv3", "kimi", "dsv3e16"),
         (2, 2): ("dsv3", "kimi", "dsv3drop", "dsv3acc", "dsv3e2"),
         (1, 4): ("dsv3", "kimi", "dsv3g")}
CASES = [(m, c) for m, cs in PAIRS.items() for c in cs]
ATOL = 1e-4
CKPT, CKPT_SAVE, CKPT_RESTORE = "dsv3", (1, 4), (2, 2)
# the fixture's deadlines: alone the file takes ≈ 80 s, but beside the
# suite's other workers a reference process has taken over 240 s
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
    """One reference process per mesh shape beside the port's worlds (the
    (1, 4) world also checkpoints ``CKPT``, then the restore at (2, 2)
    runs)."""
    pytest.importorskip("jax")
    out = {m: (tmp_path_factory.mktemp(f"port_{m[0]}x{m[1]}"),
               tmp_path_factory.mktemp(f"jax_{m[0]}x{m[1]}")) for m in PAIRS}
    restore = out[CKPT_SAVE][0] / "restore"

    def port(m, cs):
        dc.launch("tp", math.prod(m), m, out[m][0], DEADLINE_S,
                  ("--configs", ",".join(cs))
                  + (("--ckpt", CKPT) if m == CKPT_SAVE else ()))
        if m == CKPT_SAVE:      # beside the reference processes
            dc.launch("tp_restore", math.prod(CKPT_RESTORE), CKPT_RESTORE,
                      restore, DEADLINE_S, ("--ckpt", CKPT))

    with concurrent.futures.ThreadPoolExecutor(2 * len(PAIRS)) as pool:
        jobs = [pool.submit(dc.run_jax, m, out[m][1], DEADLINE_S, "jax_tp",
                            ("--configs", ",".join(cs)))
                for m, cs in PAIRS.items()]
        jobs += [pool.submit(port, m, cs) for m, cs in PAIRS.items()]
        for j in jobs:
            j.result()
    res = {m: (dc.load(out[m][0], math.prod(m)),
               dict(np.load(out[m][1] / "jax.npz"))) for m in PAIRS}
    res["restore"] = dc.load(restore, math.prod(CKPT_RESTORE))
    return res


def _ids(cases):
    return [f"{m[0]}x{m[1]}-{c}" for m, c in cases]


@pytest.mark.parametrize("mesh,name", CASES, ids=_ids(CASES))
def test_matches_reference_sharded_step(runs, mesh, name):
    port, ref = runs[mesh]
    ema = port["json"][0]["configs"][name]["ema"]
    np.testing.assert_allclose(ema, ref[f"{name}/ema"], rtol=0, atol=ATOL,
                               err_msg="loss_ema")
    z = port["npz"][0]
    prefix = f"{name}/params/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(k for k in z
                                           if k.startswith(prefix))
    for k in keys:
        np.testing.assert_allclose(z[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh,name", CASES, ids=_ids(CASES))
def test_step_within_gate_of_one_process(runs, mesh, name):
    row = runs[mesh][0]["json"][0]["configs"][name]
    assert row["gate"]["factor"] <= 1.0, row["gate"]["ratios"]
    for info in runs[mesh][0]["json"]:
        assert info["configs"][name]["ema"] == row["ema"]
        assert info["configs"][name]["init_parts_bitwise"]
        assert info["configs"][name]["adamw_local_shapes"]
    np.testing.assert_allclose(row["ema"], row["single_ema"], rtol=1e-5)


@pytest.mark.parametrize("mesh,name", CASES, ids=_ids(CASES))
def test_expert_grads_shard_on_model(runs, mesh, name):
    """Every gradient placed as its spec says, ``Partial("avg")`` over
    'data'; the experts and the router split on 'model' where their
    count divides it (``dsv3g``'s 6 experts at 4 stay whole), the MLA /
    attention projections and the shared expert column / row split."""
    row = runs[mesh][0]["json"][0]["configs"][name]
    for p, spec in row["specs"].items():
        model = [f"S({d})" for d, e in enumerate(spec) if e == "model"]
        assert row["placements"][p] == ["P(avg)"] + (model or ["R"]), p
    split = {p for p, s in row["specs"].items() if "model" in s}
    experts = {p for p in row["specs"] if "/experts/" in p}
    whole = name == "dsv3g" and mesh[1] == 4
    assert len(experts) == 3
    assert all(row["specs"][p][1] == (None if whole else "model")
               for p in experts)
    assert ("blocks/moe/router_w" in split) == (not whole)
    assert "blocks/moe/shared/down_proj/w" in split
    attn = ("q_b_proj", "kv_b_proj", "o_proj") if name != "kimi" else \
        ("q_proj", "k_proj", "o_proj")
    assert all(f"blocks/attn/{a}/w" in split for a in attn)


def test_padded_expert_layout(runs):
    """``dsv3e2`` on (2, 2): each expert leaf's 6 matrices (3 layers of 2
    experts, split over 'model') over 4 owners, so the owner layout pads
    the E-split stack (``OwnerLayout._route``); the other configs' expert
    stacks are whole owner blocks on every mesh.  After 3 steps every
    momentum row at a pad position is zero on every rank, and
    ``reshard_owner_state`` to a permuted layout and back is bitwise."""
    for mesh, names in PAIRS.items():
        for info in runs[mesh][0]["json"]:
            for name in names:
                row = info["configs"][name]
                assert row["pad_rows_zero"], (mesh, name, info["rank"])
                if name != "dsv3e2":
                    assert row["padded"] == [], (mesh, name)
                    continue
                assert row["padded"] == [
                    f"blocks.moe.experts.{w}_proj.w"
                    for w in ("down", "gate", "up")]
                assert row["reshard_roundtrip"], info["rank"]


def test_padded_layout_is_the_one_process_pack(tmp_path):
    """``torch_dist_check.py owner_pad`` on gloo (2, 2): expert-split
    stacks of 6, 2, 8 and 14 matrices over 4 owners, in the contiguous
    layout and in a permuted one (``pack_index`` not the identity): each
    rank's owner rows bitwise its block of the one-process pack of the
    averaged gradients, and the publish bitwise its part of them."""
    dc.launch("owner_pad", 4, (2, 2), tmp_path, DEADLINE_S)
    infos = dc.load(tmp_path, 4)["json"]
    groups = infos[0]["groups"]
    assert any(r["padded"] for r in groups.values())
    assert any(r["permuted"] and not r["padded"] for r in groups.values())
    for info in infos:
        for name, row in info["groups"].items():
            assert row["pack_bitwise"] and row["publish_bitwise"], (
                info["rank"], name)


def test_drop_case_is_global(runs):
    """``dsv3drop`` on (2, 2): within 1e-4 of the one-process step (the
    whole batch in one dispatch), and the case is one where the rule
    matters: on the first batch the reference's global dispatch drops
    assignments that a dispatch of each data rank's rows at its own
    capacity would keep."""
    name = "dsv3drop"
    z = runs[(2, 2)][0]["npz"][0]
    single = dc.tp_train(name, None, dc.tp_params(name))
    np.testing.assert_allclose(runs[(2, 2)][0]["json"][0]["configs"][name]
                               ["ema"], single["ema"], rtol=0, atol=ATOL)
    for p, v in single["params"].items():
        np.testing.assert_allclose(z[f"{name}/params/{p}"], v.numpy(),
                                   rtol=0, atol=ATOL, err_msg=p)
    cfg = dc.tp_config(name)
    params = tree.tree_map(torch.from_numpy, dc.tp_params(name))
    tokens = torch.from_numpy(dc.tp_batch(name, 0)["tokens"])
    with torch.no_grad(), moe_lib.recording() as rec:
        transformer.forward(cfg, params, tokens)
    idx = rec[0]["idx"]                           # layer 0, (T, K)
    T, E = idx.shape[0], cfg.moe.n_experts
    cap = moe_lib.capacity(cfg.moe, T)
    order, _, rank, _, _ = moe_lib._ranks(idx, E)
    kept = torch.empty_like(rank, dtype=torch.bool)
    kept[order] = rank < cap
    per_rank = []
    for half in idx.chunk(2):                     # data ranks 0 and 1
        o, _, r, _, _ = moe_lib._ranks(half, E)
        k = torch.empty_like(r, dtype=torch.bool)
        k[o] = r < moe_lib.capacity(cfg.moe, T // 2)
        per_rank.append(k)
    per_rank = torch.cat(per_rank)
    assert int((~kept).sum()) > 0
    assert bool((per_rank & ~kept).any())


def test_checkpoint_restores_experts_on_another_mesh(runs):
    """``dsv3`` saved at (1, 4) (one expert a rank) and restored at (2, 2)
    (two a rank): parameters and AdamW moments bitwise, each rank making
    on its host only its part of every split leaf."""
    saved = {k[len("ckpt/"):]: v for k, v in
             runs[CKPT_SAVE][0]["npz"][0].items() if k.startswith("ckpt/")}
    assert any("/experts/" in k for k in saved)
    for z, info in zip(runs["restore"]["npz"], runs["restore"]["json"]):
        for k, v in saved.items():
            np.testing.assert_array_equal(z[f"restored/{k}"], v, err_msg=k)
        experts = {p: h for p, h in info["held"].items()
                   if "/experts/" in p and "/params/" in p}
        assert len(experts) == 3
        for p, h in experts.items():
            made, whole = h["assembled_whole"]
            assert h["split"] and made == h["bytes"] and 2 * made == whole
    for k, v in saved.items():
        np.testing.assert_array_equal(runs["restore"]["npz"][0][f"single/{k}"],
                                      v, err_msg=k)


class _Counts:
    """A ``DataParallel`` stand-in for one process: the (E,) counts of
    every data rank given, ``gather_over_data`` patched to return them."""

    def __init__(self, counts, rank):
        self.counts, self.rank, self.size = counts, rank, len(counts)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_dispatch_over_data_ranks_is_the_whole_batch(monkeypatch, cf):
    """The reduced DeepSeek-V3's MoE with skewed routing on 4 x 16 tokens,
    run as two data ranks run it (each half with the other's counts):
    the same assignments kept and the same outputs as the whole batch in
    one dispatch, the drops (``recording``) those of the whole batch, and
    each half's buffers as long as the whole batch's dispatch keeps of
    that half's fullest expert, not the global capacity."""
    import dataclasses
    cfg = dataclasses.replace(configs.get("deepseek-v3-671b",
                                          reduced=True).moe,
                              capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    p = moe_lib.moe_init(gen, cfg)
    p["router_w"][:, 0] += 0.5                   # expert 0 oversubscribed
    x = torch.randn(4, 16, cfg.d_model, generator=gen)
    whole = moe_lib.moe(p, cfg, x)
    counts = []
    for h in x.chunk(2):
        _, _, idx = moe_lib.route(p, cfg, h.reshape(-1, cfg.d_model))
        counts.append(torch.bincount(idx.reshape(-1),
                                     minlength=cfg.n_experts))
    counts = torch.stack(counts)
    monkeypatch.setattr(tp_lib, "gather_over_data",
                        lambda c, dp: counts)
    with moe_lib.recording() as rec:
        halves = [moe_lib.moe(p, cfg, h, dp=_Counts(counts, r))
                  for r, h in enumerate(x.chunk(2))]
    torch.testing.assert_close(torch.cat(halves), whole, rtol=0,
                               atol=1e-6)
    drops = [int(r["dropped"]) for r in rec]
    assert sum(drops) == moe_lib.dropped(p, cfg, x)
    if cf < 1:
        assert sum(drops) > 0
    T, E = x.shape[0] * x.shape[1], cfg.n_experts
    cap = moe_lib.capacity(cfg, T)
    _, _, idx = moe_lib.route(p, cfg, x.reshape(T, -1))
    slot, _ = moe_lib.dispatch_slots(idx, E, cap)
    kept = (slot < E * cap).reshape(idx.shape)
    for r, (i, k) in enumerate(zip(idx.chunk(2), kept.chunk(2))):
        fullest = int(torch.bincount(i[k], minlength=E).max())
        assert rec[r]["slots"] == max(1, fullest) <= cap
    # shorter than the bound a rank holds without the counts
    assert min(r["slots"] for r in rec) < min(cap, T // 2)


@pytest.mark.parametrize("name", ["dsv3", "kimi", "dsv3g"])
def test_no_context_bitwise(name):
    """The forward and gradients through the tensor-parallel code path on
    a model axis of one rank: bitwise the plain path's."""
    cfg = dc.tp_config(name)
    params = tree.tree_map(
        lambda v: torch.from_numpy(v).requires_grad_(True),
        dc.tp_params(name))
    tokens = torch.from_numpy(dc.tp_batch(name, 0)["tokens"])
    leaves = [v for _, v in tree.flatten(params)]
    plain = transformer.forward(cfg, params, tokens)
    one = transformer.forward(cfg, params, tokens,
                              tp=tp_lib.ModelParallel(None, 1, 0))
    assert torch.equal(plain, one)
    for g, h in zip(torch.autograd.grad(plain.square().mean(), leaves),
                    torch.autograd.grad(one.square().mean(), leaves)):
        assert torch.equal(g, h)


def test_dryrun_walks_split_moe_step():
    """``walk_cell`` of the reduced DeepSeek-V3 at a 4 x 16 batch on a
    fake (1, 4) world walks the split step, and its peak is below the
    replicated walk's on a (4, 1) world; each expert leaf of the walked
    state (``build_train_cell``'s, on the same fake worlds) is a quarter
    of its bytes there."""
    import json
    import os
    import subprocess
    import sys
    import tempfile
    out = Path(tempfile.mkdtemp())
    env = dict(os.environ, PYTHONPATH=str(dc.ROOT / "src"),
               OMP_NUM_THREADS="1")
    code = """
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import tree
from repro_torch.launch import dryrun
cfg = configs.get("deepseek-v3-671b", reduced=True)
shape = ShapeSpec("x", 16, 4, "train")
m = tuple(map(int, sys.argv[2].split(",")))
r = dryrun.walk_cell(cfg, "deepseek-v3-671b", shape, m, "owner")
with dryrun.fake_world(4):
    mesh = dryrun._fake_mesh(m)
    with FakeTensorMode():
        _, (state, _), _ = dryrun.build_train_cell(
            cfg, "deepseek-v3-671b", shape, mesh, "owner")
        r["held"] = {p: v.numel() * v.element_size()
                     for p, v in tree.flatten(state.params)}
json.dump(r, open(sys.argv[1], "w"), default=str)
"""
    meshes = {"split": "1,4", "replicated": "4,1"}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        procs = list(pool.map(lambda kv: subprocess.run(
            [sys.executable, "-c", code, str(out / f"{kv[0]}.json"), kv[1]],
            env=env, cwd=str(out), capture_output=True, text=True,
            timeout=180), meshes.items()))
    for p in procs:
        assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    split, rep = (json.loads((out / f"{k}.json").read_text())
                  for k in meshes)
    assert split["ok"] and rep["ok"]
    assert split["roofline"]["detail"]["layout"].startswith(
        "parameters split by param_specs over 'model' (4 cards)")
    assert rep["roofline"]["detail"]["layout"].startswith(
        "parameters replicated")
    experts = [p for p in rep["held"] if "/experts/" in p]
    assert len(experts) == 3
    for p in experts:
        assert 4 * split["held"][p] == rep["held"][p], p
    assert split["memory_analysis"]["total_bytes"] < \
        rep["memory_analysis"]["total_bytes"]


def test_dryrun_cuts_a_cell_in_depth(tmp_path):
    """``python -m repro_torch.launch.dryrun --layers 1`` walks the reduced
    DeepSeek-V3's train_4k cell on the fake 256-rank world with one
    layer, into a JSON of its own beside the whole cell's."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(dc.ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-v3-671b", "--shape", "train_4k", "--mesh", "single",
         "--reduced", "--layers", "1", "--outdir", str(tmp_path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=180)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    files = list((tmp_path / "single").glob("*.json"))
    assert [f.name for f in files] == \
        ["deepseek-v3-671b__train_4k__owner__1layers.json"]
    d = json.loads(files[0].read_text())
    assert d["ok"], d.get("traceback")
    assert d["params"] == configs.get("deepseek-v3-671b", reduced=True,
                                      n_layers=1).param_count()
    assert d["params"] < configs.get("deepseek-v3-671b",
                                     reduced=True).param_count()


class _Mesh:
    """The shapes ``param_specs`` and ``tensor_parallel`` read of a
    ("data", "model") mesh (no process group): the reference's single
    production mesh by default."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape=(16, 16)):
        self.shape = shape

    def size(self, i):
        return self.shape[i]


def card_param_bytes(cfg, mesh) -> dict:
    """{path: bytes of the part of each parameter one card holds} of the
    train step of ``cfg`` on ``mesh``, from shapes alone."""
    from repro_torch.models.sharding import param_specs
    shapes = transformer.init(cfg, device="meta")
    specs = param_specs(cfg, shapes, mesh) if \
        tp_lib.tensor_parallel(mesh) else None
    model = mesh.size(mesh.mesh_dim_names.index("model"))
    return {p: v.numel() * v.element_size()
            // (model if specs and "model" in specs[p] else 1)
            for p, v in tree.flatten(shapes)}


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b"])
def test_published_moe_parts_exceed_a_card(arch):
    """At published widths on the (16, 16) mesh the experts split 16
    ways, yet each card's bf16 parameter parts alone exceed 80 GB: the
    reference trains these with ZeRO-3 (ROADMAP item 6)."""
    from repro_torch.launch.mesh import HBM_BYTES
    held = card_param_bytes(configs.get(arch), _Mesh())
    whole = card_param_bytes(configs.get(arch), _Mesh((256, 1)))
    experts = [p for p in held if "/experts/" in p]
    assert len(experts) == 3
    for p in experts:
        assert 16 * held[p] == whole[p], p
    assert sum(held.values()) > HBM_BYTES
