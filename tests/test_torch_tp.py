"""The port's tensor-parallel train step of the dense family
(``models/tp.py``, ``train/step.py`` under a mesh whose 'model' axis has
more than one rank) on gloo worlds (1, 2), (2, 2) and (1, 4)
(``tests/torch_dist_check.py tp``), against its own one-process step.

Three configs (``torch_dist_check.TP_CONFIGS``): reduced qwen2.5-14b with
vocab 256 (head-parallel, the vocab split; at (1, 4) its 2 KV heads are
gathered), reduced smollm-360m with 3 heads (sequence-sharded attention,
its q / k columns split mid-head) and reduced qwen2.5-14b with vocab 257
(no vocab split); at (1, 4) also ``guarded``, every projection left whole
by ``param_specs``' guard.  3 steps of Muon from the same numpy
parameters on the same batches; rank 0 runs each in one process too, and
from the parameters with a random half of their entries one ulp up, and
holds the mesh run to it by ``chip_smoke.tp_gate``: step 1's loss,
gradients and updates and the last loss_ema and parameters, each leaf
within 10x what the one-ulp perturbation moves it.

Also: each autograd Function of ``models/tp.py`` on a model axis of two
against the unsplit float64 computation (forward and backward); the
gradients placed as ``param_specs`` says, with ``Partial("avg")`` over
'data'; AdamW moments shaped as their parameters' parts; ``init_state``'s
parts bitwise the slices of the one-process ``init``; each rank holding
1 / tp of every split leaf; a checkpoint written at (1, 2) restored at
(2, 1) and in one process, bitwise, and at (1, 2) with each rank making
only its part of every split leaf; without a context (and with a model
axis of one rank) the forward, the loss and the gradients bitwise those
of the one-card path; the one rule that decides tensor parallelism
(``models.tp.tensor_parallel``: every family), and the dry run's train
cells walking the split step for the hybrid family on (16, 16) and the
dense one on a (1, 4) mesh; serving the hybrid family under a mesh still
refused.
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
from repro_torch.models import transformer
from repro_torch.models import tp as tp_lib
from repro_torch.models.sharding import param_specs
from repro_torch.train.step import make_loss_fn, softmax_xent

BASE = ("qwen256", "smollm3h", "qwen257")
WORLDS = {(1, 2): BASE, (2, 2): BASE, (1, 4): BASE + ("guarded",)}
RUNS = [(m, c) for m, cs in WORLDS.items() for c in cs]
FUNCTION_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds side by side, then the restore at (2, 1) of the
    (1, 2) world's checkpoint."""
    outs = {m: tmp_path_factory.mktemp(f"tp_{m[0]}x{m[1]}") for m in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for f in [pool.submit(dc.launch, "tp", math.prod(m), m, outs[m],
                              240.0, ("--configs", ",".join(cs)))
                  for m, cs in WORLDS.items()]:
            f.result()
    restores = {m: outs[(1, 2)] / f"restore_{m[0]}x{m[1]}"
                for m in ((2, 1), (1, 2))}
    with concurrent.futures.ThreadPoolExecutor(len(restores)) as pool:
        for f in [pool.submit(dc.launch, "tp_restore", 2, m, out)
                  for m, out in restores.items()]:
            f.result()
    res = {m: dc.load(outs[m], math.prod(m)) for m in WORLDS}
    res["restore"] = dc.load(restores[(2, 1)], 2)
    res["restore_1x2"] = dc.load(restores[(1, 2)], 2)
    return res


def _ids(runs):
    return [f"{m[0]}x{m[1]}-{c}" for m, c in runs]


FUNCTIONS = ["copy_to_model", "reduce_from_model", "gather_from_model_1",
             "gather_from_model_-1", "gather_from_model_reduce_grad_1",
             "gather_from_model_reduce_grad_-1", "split_to_model_1",
             "split_to_model_-1", "seq_to_features", "features_to_seq"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_matches_unsplit_float64(worlds, name):
    for rank, info in enumerate(worlds[(1, 2)]["json"]):
        fwd, grad = info["functions"][name]
        assert fwd <= FUNCTION_TOL, (name, rank, "forward", fwd)
        assert grad <= FUNCTION_TOL, (name, rank, "backward", grad)


@pytest.mark.parametrize("mesh,name", RUNS, ids=_ids(RUNS))
def test_step_within_gate_of_one_process(worlds, mesh, name):
    row = worlds[mesh]["json"][0]["configs"][name]
    gate = row["gate"]
    assert gate["factor"] <= 1.0, gate["ratios"]
    # every rank ends on the same loss
    for info in worlds[mesh]["json"]:
        assert info["configs"][name]["ema"] == row["ema"]
    np.testing.assert_allclose(row["ema"], row["single_ema"], rtol=1e-5)


def _expected_placement(spec, mesh_shape):
    data, model = ["P(avg)"], ["R"]
    for d, e in enumerate(spec):
        if e == "model":
            model = [f"S({d})"]
    return data + model


@pytest.mark.parametrize("mesh,name", RUNS, ids=_ids(RUNS))
def test_grad_placements_follow_param_specs(worlds, mesh, name):
    for info in worlds[mesh]["json"]:
        row = info["configs"][name]
        for p, spec in row["specs"].items():
            assert row["placements"][p] == _expected_placement(spec, mesh), p
    # the split leaves: every projection but where a guard keeps it whole
    specs = worlds[mesh]["json"][0]["configs"][name]["specs"]
    split = {p for p, s in specs.items() if "model" in s}
    if name != "guarded":
        assert "blocks/attn/q_proj/w" in split
        assert "blocks/mlp/down_proj/w" in split
    assert ("embed/embedding" in split) == (name == "qwen256")
    assert "blocks/attn_norm/norm_scale" not in split


@pytest.mark.parametrize("mesh,name", RUNS, ids=_ids(RUNS))
def test_adamw_moments_and_init_parts(worlds, mesh, name):
    cfg = dc.tp_config(name)
    shapes = dict(tree.flatten(transformer.init(cfg, device="meta")))
    specs = worlds[mesh]["json"][0]["configs"][name]["specs"]
    tp = mesh[1]
    want = sum(math.prod(v.shape) // (tp if "model" in specs[p] else 1)
               for p, v in shapes.items())
    for info in worlds[mesh]["json"]:
        row = info["configs"][name]
        assert row["adamw_local_shapes"]
        assert row["init_parts_bitwise"]
        assert row["local_numel"] == want


def test_guarded_leaves_whole(worlds):
    specs = worlds[(1, 4)]["json"][0]["configs"]["guarded"]["specs"]
    assert all("model" not in s for s in specs.values())


def test_checkpoint_restores_at_2x1_and_one_process(worlds):
    saved = {k[len("ckpt/"):]: v for k, v in
             worlds[(1, 2)]["npz"][0].items() if k.startswith("ckpt/")}
    assert any(k.startswith("mu/") for k in saved)
    for rank, z in enumerate(worlds["restore"]["npz"]):
        for prefix in ("restored",) + (("single",) if rank == 0 else ()):
            for k, v in saved.items():
                np.testing.assert_array_equal(z[f"{prefix}/{k}"], v,
                                              err_msg=f"{prefix} {k}")
    # the saved run's parts are the same on both ranks of (1, 2)
    z1 = worlds[(1, 2)]["npz"][1]
    for k, v in saved.items():
        np.testing.assert_array_equal(z1["ckpt/" + k], v, err_msg=k)


def test_checkpoint_restores_only_each_ranks_part(worlds):
    """Restored at (1, 2), each rank makes on its host only its part of
    every split leaf (parameters and AdamW moments), never the whole
    leaf, and reads back the same values as the (2, 1) restore."""
    saved = {k[len("ckpt/"):]: v for k, v in
             worlds[(1, 2)]["npz"][0].items() if k.startswith("ckpt/")}
    for z, info in zip(worlds["restore_1x2"]["npz"],
                       worlds["restore_1x2"]["json"]):
        split = {p: h for p, h in info["held"].items() if h["split"]}
        assert any("/adamw/" in p for p in split) and \
            any("/params/" in p for p in split)
        for p, h in info["held"].items():
            made, whole = h["assembled_whole"]
            assert made == h["bytes"], p
            assert made * 2 == whole if h["split"] else made == whole, p
        assert info["assembled_bytes"] < info["whole_bytes"]
        for k, v in saved.items():
            np.testing.assert_array_equal(z[f"restored/{k}"], v, err_msg=k)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", dc.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tp_gate_admits_adamw_sign_flips_and_catches_faults():
    """``chip_smoke.tp_gate`` on synthetic runs: an AdamW leaf whose
    step-1 update (about −lr · sign(g)) flips where its gradient is at
    rounding size passes by the AdamW rule, and would not as a Muon leaf;
    a Muon leaf's update off by 1e-4 of its scale, or a gradient doubled,
    fails."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    lr, eps = 3e-4, 1e-8

    def adamw(g):
        return -lr * g / (g.abs() + eps)
    g = {"w": torch.randn(64, 32, generator=gen),
         "norm": torch.randn(256, generator=gen) * 1e-3}
    g["norm"][:8] = 1e-9 * torch.randn(8, generator=gen)
    ref = {"grads": g, "updates": {"w": g["w"] * 0.01,
                                   "norm": adamw(g["norm"])}}
    spread = {q: {p: v.clone() for p, v in d.items()}
              for q, d in ref.items()}
    tp_g = {p: v * (1 + 2.0 ** -22) for p, v in g.items()}
    tp_g["norm"][:8] = -g["norm"][:8]          # rounding-size entries
    tp = {"grads": tp_g, "updates": {"w": tp_g["w"] * 0.01,
                                     "norm": adamw(tp_g["norm"])}}
    for d in (ref, spread, tp):
        for q in ("loss", "params", "loss_ema"):
            d[q] = {"": torch.tensor(1.0)}

    def factor(tp, matrices):
        return cs.tp_gate(torch, tp, ref, spread, matrices)["factor"]
    assert factor(tp, {"w"}) <= 1
    assert factor(tp, {"w", "norm"}) > 100
    off = {**tp, "updates": {**tp["updates"],
                             "w": tp["updates"]["w"] + 1e-6}}
    assert factor(off, {"w"}) > 10
    doubled = {**tp, "grads": {**tp["grads"], "w": 2 * tp["grads"]["w"]}}
    assert factor(doubled, {"w"}) > 100


def test_one_rule_decides_tensor_parallelism():
    """``models.tp.tensor_parallel``: a model axis of more than one rank,
    whatever the family (every family has the split train step); a model
    axis of one rank and no mesh keep the parameters replicated.
    The serving rule (``models.tp.serves_split``) keeps the dense decoders
    and the MoE family."""
    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shape):
            self.shape = shape

        def size(self, i):
            return self.shape[i]
    dense = [a for a in configs.ARCH_IDS
             if configs.get(a, reduced=True).family == "dense"]
    assert set(dense) == {"smollm-360m", "stablelm-1.6b", "qwen2.5-14b",
                          "nemotron-4-340b"}
    serves = set(dense) | {"deepseek-v3-671b", "kimi-k2-1t-a32b"}
    assert tp_lib.tensor_parallel(Mesh((16, 16)))
    assert tp_lib.tensor_parallel(Mesh((2, 2)))
    assert not tp_lib.tensor_parallel(Mesh((4, 1)))
    assert not tp_lib.tensor_parallel(None)
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch, reduced=True)
        assert tp_lib.serves_split(cfg) == (arch in serves)


def _dryrun_walks():
    """Two dry-run walks in subprocesses on fake worlds: the reduced
    hymba-1.5b's train_4k cell on the (16, 16) production mesh (the CLI),
    and ``walk_cell`` of the reduced qwen2.5-14b at a 1 x 16 batch on a
    (1, 4) mesh (as ``chip_smoke.tp_predict`` predicts the card's run)."""
    import json
    import os
    import subprocess
    import sys
    import tempfile
    root = dc.ROOT
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = Path(tempfile.mkdtemp())
    code = ("import json, sys; from repro_torch import configs; "
            "from repro_torch.configs.shapes import ShapeSpec; "
            "from repro_torch.launch.dryrun import walk_cell; "
            "r = walk_cell(configs.get('qwen2.5-14b', reduced=True), "
            "'qwen2.5-14b', ShapeSpec('x', 16, 1, 'train'), (1, 4), "
            "'owner'); json.dump(r, open(sys.argv[1], 'w'), default=str)")
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "hymba-1.5b", "--shape", "train_4k", "--mesh", "single",
             "--reduced", "--outdir", str(out)],
            [sys.executable, "-c", code, str(out / "qwen_1x4.json")]]
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(lambda c: subprocess.run(
            c, env=env, cwd=str(out), capture_output=True, text=True,
            timeout=180), cmds))
    for p in procs:
        assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    return [json.loads((out / f).read_text()) for f in
            ("single/hymba-1.5b__train_4k__owner.json", "qwen_1x4.json")]


def test_dryrun_walks_replicated_and_split_train_steps():
    """The hybrid family's train_4k cell walks the split step on the
    16-wide model axis; the dense family on a fake (1, 4) mesh walks the
    split step."""
    hymba, qwen = _dryrun_walks()
    assert hymba["ok"], hymba.get("traceback")
    assert hymba["roofline"]["detail"]["layout"].startswith(
        "parameters split by param_specs over 'model' (16 cards)")
    assert qwen["ok"] and qwen["num_devices"] == 4
    assert qwen["roofline"]["detail"]["layout"].startswith(
        "parameters split by param_specs over 'model' (4 cards)")
    assert qwen["memory_analysis"]["total_bytes"] > 0


@pytest.mark.parametrize("name", BASE + ("guarded",))
def test_no_context_bitwise(name):
    """The forward, loss and gradients without a context, through
    ``make_loss_fn`` with and without a mesh-less call, and through the
    tensor-parallel code path on a model axis of one rank: bitwise
    equal."""
    cfg = dc.tp_config(name)
    params = tree.tree_map(
        lambda v: torch.from_numpy(v).requires_grad_(True),
        dc.tp_params(name))
    batch = {k: torch.from_numpy(v) for k, v in dc.tp_batch(name, 0).items()}
    leaves = [v for _, v in tree.flatten(params)]
    one = tp_lib.ModelParallel(None, 1, 0)
    plain = transformer.forward(cfg, params, batch["tokens"])
    assert torch.equal(plain, transformer.forward(cfg, params,
                                                  batch["tokens"], tp=None))
    assert torch.equal(plain, transformer.forward(cfg, params,
                                                  batch["tokens"], tp=one))
    want = softmax_xent(plain, batch["labels"])
    grads = torch.autograd.grad(want, leaves)
    for loss_fn in (make_loss_fn(cfg), make_loss_fn(cfg, None)):
        loss = loss_fn(params, batch)
        assert torch.equal(loss, want)
        for g, h in zip(torch.autograd.grad(loss, leaves), grads):
            assert torch.equal(g, h)
    loss = softmax_xent(transformer.forward(cfg, params, batch["tokens"],
                                            tp=one), batch["labels"])
    for g, h in zip(torch.autograd.grad(loss, leaves), grads):
        assert torch.equal(g, h)


def test_other_families_and_zero3_raise():
    """Training the hybrid family split is the tensor-parallel step (its
    forward on a model axis of one rank through the split code path is
    the plain one's); serving it under a mesh still raises, naming the
    serving half of ROADMAP item 6."""
    from repro_torch.train import serve as serve_fns
    cfg = configs.get("hymba-1.5b", reduced=True)
    params = transformer.init(cfg, 0, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    assert not tp_lib.serves_split(cfg)
    assert torch.equal(transformer.forward(cfg, params, tokens),
                       transformer.forward(
                           cfg, params, tokens,
                           tp=tp_lib.ModelParallel(None, 1, 0)))

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 2)
    with pytest.raises(NotImplementedError, match="item 6, its serving half"):
        serve_fns.mesh_context(cfg, Mesh())
    with pytest.raises(NotImplementedError, match="item 6, its serving half"):
        transformer.prefill(cfg, params, tokens, 8,
                            tp=tp_lib.ModelParallel(None, 2, 0))


def test_param_specs_split_smollm_mid_head():
    """At model 4, smollm-360m's k_proj (320 columns, 5 heads of 64) is
    split 80 a rank: the forward must gather it to whole heads."""
    cfg = configs.get("smollm-360m")

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 4)
    specs = param_specs(cfg, transformer.init(cfg, device="meta"), Mesh())
    assert specs["blocks/attn/k_proj/w"] == (None, None, "model")
    assert (cfg.n_kv_heads * cfg.hd // 4) % cfg.hd != 0
    assert cfg.n_heads % 4 != 0
