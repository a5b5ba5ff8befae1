"""The port's dry run (``python -m repro_torch.launch.dryrun``) in
subprocesses on the fake 256-rank world: smollm-360m's train_4k cell (at
the reduced widths: a full-width train cell walks ~1.4M fake ops), its
decode_32k cell at full width and its long_500k cell (a recorded skip).
Each JSON holds the reference's keys, passes the asserts of
``tests/test_system.py::test_dryrun_artifacts_complete_and_green``, and
carries the reference's ``params``, ``active_params``, ``tokens_per_step``
and ``plan_stats``; the report's rows equal the reference report's on the
same dicts; nothing is written under ``experiments/dryrun``."""

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import report as treport

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.core import api as rapi  # noqa: E402
from repro.launch import report as rreport  # noqa: E402
from repro.launch import roofline as rroofline  # noqa: E402
from repro.models import model_fns as rmodel_fns  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"
# (shape, extra CLI flags): the train cell at the reduced widths
RUNS = [("train_4k", ["--reduced"]), ("decode_32k", []), ("long_500k", [])]
TIMEOUT_S = 180
# the reference's result keys (src/repro/launch/dryrun.py:203-291)
CELL_KEYS = {"arch", "shape", "mesh", "opt", "kind"}
OK_KEYS = CELL_KEYS | {"ok", "num_devices", "timings_s", "memory_analysis",
                       "hbm_utilization", "fits_hbm", "roofline", "params",
                       "active_params", "tokens_per_step"}


def _run(outdir, shape, flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "single", "--outdir", str(outdir),
         *flags], env=env, cwd=str(outdir), capture_output=True, text=True,
        timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{shape: the cell's JSON}, the three CLI runs side by side."""
    outdir = tmp_path_factory.mktemp("torch_dryrun")
    with ThreadPoolExecutor(len(RUNS)) as ex:
        procs = list(ex.map(lambda r: _run(outdir, *r), RUNS))
    for (shape, _), p in zip(RUNS, procs):
        assert p.returncode == 0, (shape, p.stdout[-2000:], p.stderr[-2000:])
    out = {}
    for shape, _ in RUNS:
        with open(outdir / "single" / f"{ARCH}__{shape}__owner.json") as f:
            out[shape] = json.load(f)
    assert not (outdir / "dryrun").exists()
    return out


def _ref_cfg(shape):
    reduced = dict(RUNS)[shape] == ["--reduced"]
    serve = {} if shape == "train_4k" else dict(param_dtype="bfloat16",
                                                compute_dtype="bfloat16")
    return rconfigs.get(ARCH, reduced=reduced, **serve)


def test_result_dir_is_the_ports():
    assert tdryrun.RESULT_DIR == str(ROOT / "experiments" / "torch_dryrun")
    assert treport.RESULT_DIR == tdryrun.RESULT_DIR


def test_schema_equals_reference(cells):
    """Top-level keys, the ``Roofline`` fields and the memory keys."""
    assert set(cells["long_500k"]) == CELL_KEYS | {"skipped"}
    assert set(cells["decode_32k"]) == OK_KEYS
    assert set(cells["train_4k"]) == OK_KEYS | {"plan_stats"}
    fields = {f.name for f in dataclasses.fields(rroofline.Roofline)}
    ma = SimpleNamespace(**{k: 1 for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes")})
    mem_keys = set(rroofline.memory_analysis_dict(
        SimpleNamespace(memory_analysis=lambda: ma)))
    for shape in ("train_4k", "decode_32k"):
        d = cells[shape]
        assert set(d["roofline"]) == fields
        assert set(d["memory_analysis"]) == mem_keys
        assert set(d["timings_s"]) == {"build", "lower", "compile"}


def test_artifacts_green(cells):
    """``test_dryrun_artifacts_complete_and_green``'s asserts, per cell."""
    for d in cells.values():
        if d.get("skipped"):
            assert d["shape"] == "long_500k"
            continue
        assert d.get("ok"), d.get("error")
        r = d["roofline"]
        assert r["compute_s"] >= 0 and r["memory_s"] > 0
        assert r["dominant"] in ("compute", "memory", "collective")
        assert d["memory_analysis"]["total_bytes"] > 0
        assert d["num_devices"] == 256
        assert d["hbm_utilization"] == \
            d["memory_analysis"]["total_bytes"] / 80e9
    train = cells["train_4k"]["roofline"]
    assert train["flops"] > 0 and train["coll_bytes"] > 0
    assert train["kernel_adjusted_compute_s"] < train["compute_s"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_counts_equal_reference(cells, shape):
    cfg, d = _ref_cfg(shape), cells[shape]
    sp = tdryrun.SHAPES[shape]
    assert d["params"] == cfg.param_count()
    assert d["active_params"] == cfg.active_param_count()
    assert d["tokens_per_step"] == sp.global_batch * (
        sp.seq_len if sp.kind != "decode" else 1)


def test_plan_stats_equal_reference(cells):
    cfg = _ref_cfg("train_4k")
    shapes = jax.eval_shape(partial(rmodel_fns(cfg).init, cfg),
                            jax.random.PRNGKey(0))
    plan = rapi.dedicate_params(shapes, num_owners=256, strategy="greedy")
    want = json.loads(json.dumps(plan.stats, default=str))
    assert cells["train_4k"]["plan_stats"] == want


def test_report_rows_equal_reference(cells, monkeypatch):
    """The reference's table functions on the same dicts give the same
    rows but for the header (cards, not chips; "walk s")."""
    by_key = {(d["arch"], d["shape"]): d for d in cells.values()}
    monkeypatch.setattr(rreport, "load", lambda mesh: by_key)
    got = treport.dryrun_table("single", by_key).splitlines()
    want = rreport.dryrun_table("single").splitlines()
    assert len(got) == len(want) == 4 + 3
    assert got[4:] == want[4:]
    assert "cards" in got[0] and "card" in got[2]
    got = treport.roofline_table("single", by_key).splitlines()
    want = rreport.roofline_table("single").splitlines()
    assert len(got) == len(want) == 2 + 2
    assert got[2:] == want[2:]


def test_big_arch_cell_walks_zero3(tmp_path):
    """A ``BIG_ARCHS`` train cell (reduced nemotron-4-340b, one layer, on
    the fake 256-rank world) walks the reference's >= 340 B policy, and
    its layout detail names ZeRO-3."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "nemotron-4-340b", "--shape", "train_4k", "--mesh", "single",
         "--reduced", "--layers", "1", "--outdir", str(tmp_path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    d = json.loads((tmp_path / "single" /
                    "nemotron-4-340b__train_4k__owner__1layers.json")
                   .read_text())
    assert d["ok"], d.get("traceback")
    assert "nemotron-4-340b" in tdryrun.BIG_ARCHS
    assert "with ZeRO-3" in d["roofline"]["detail"]["layout"]


SERVE_WALK = """
import json, sys
from repro_torch import configs
from repro_torch.launch.dryrun import walk_cell
out = {}
for arch in ("qwen2.5-14b", "deepseek-v3-671b"):
    cfg = configs.get(arch, n_layers=2, param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    for split in (True, False):
        r = walk_cell(cfg, arch, "decode_32k", (16, 16), "owner",
                      split=split)
        out[f"{arch}/{split}"] = {
            "mem": r["memory_analysis"],
            "layout": r["roofline"]["detail"]["layout"]}
print(json.dumps(out))
"""


def test_serve_cells_walk_split_layout():
    """The dry run's decode_32k cells of a dense and an MoE arch (two
    layers at their widths, bf16, on a fake (16, 16) world) walk the
    reference's serving layout: the parameters as their parts by
    ``param_specs`` and the cache by ``cache_specs``, each card's
    parameters 1 / 16 or less of the walk that keeps them whole and each
    card's predicted bytes far below it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", SERVE_WALK], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    for arch in ("qwen2.5-14b", "deepseek-v3-671b"):
        split, whole = got[f"{arch}/True"], got[f"{arch}/False"]
        assert "split by param_specs" in split["layout"]
        assert "cache_specs" in split["layout"]
        assert "replicated" in whole["layout"]
        cfg = tdryrun.configs.get(arch, n_layers=2)
        param_bytes = 2 * cfg.param_count()
        # the arguments: this card's parameters and its cache part
        assert whole["mem"]["argument_size_in_bytes"] >= param_bytes
        assert split["mem"]["argument_size_in_bytes"] - param_bytes / 16 < \
            whole["mem"]["argument_size_in_bytes"] - param_bytes
        assert split["mem"]["total_bytes"] < whole["mem"]["total_bytes"] / 4
