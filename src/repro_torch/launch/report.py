"""The §Dry-run and §Roofline tables from the port's dry-run artifacts
under experiments/torch_dryrun/ (port of ``repro.launch.report``,
``src/repro/launch/report.py``).  Every number in them is a dry-run
prediction from the H100 datasheet constants of ``launch/mesh.py``, per
card, not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.report
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULT_DIR

ARCH_ORDER = ["hymba-1.5b", "qwen2.5-14b", "nemotron-4-340b", "smollm-360m",
              "stablelm-1.6b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
              "xlstm-350m", "seamless-m4t-large-v2", "llava-next-mistral-7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh, result_dir: str = RESULT_DIR):
    out = {}
    for fp in glob.glob(os.path.join(result_dir, mesh, "*.json")):
        with open(fp) as f:
            d = json.load(f)
        out[(d["arch"], d["shape"])] = d
    return out


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(mesh, cells=None):
    """One row a cell; ``cells`` as ``load`` returns them (default: the
    artifacts of ``mesh``).  "walk s" is the host seconds of the walked
    call (``timings_s["compile"]``)."""
    cells = load(mesh) if cells is None else cells
    rows = [f"#### Mesh `{mesh}` "
            f"({'2×16×16 = 512 cards' if mesh == 'multi' else '16×16 = 256 cards'})",
            "",
            "| arch | shape | status | HBM GiB/card (util) | per-card GFLOPs | "
            "coll GiB/card | walk s |",
            "|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            d = cells.get((a, s))
            if d is None:
                continue
            if d.get("skipped"):
                rows.append(f"| {a} | {s} | SKIP (sub-quadratic rule) "
                            f"| — | — | — | — |")
                continue
            if not d.get("ok"):
                rows.append(f"| {a} | {s} | **FAIL** {d.get('error','')[:40]}"
                            f" | — | — | — | — |")
                continue
            r = d["roofline"]
            mem = d["memory_analysis"]["total_bytes"]
            util = d["hbm_utilization"]
            flag = "" if d["fits_hbm"] else " ⚠"
            rows.append(
                f"| {a} | {s} | ok | {fmt_bytes(mem)} ({util:.2f}×){flag} | "
                f"{r['flops']/1e9:.0f} | {r['coll_bytes']/2**30:.1f} | "
                f"{d['timings_s']['compile']:.0f} |")
    return "\n".join(rows)


def roofline_table(mesh="single", cells=None):
    cells = load(mesh) if cells is None else cells
    rows = ["| arch | shape | compute s | memory s | collective s | dominant"
            " | MODEL_FLOPS/card | useful ratio | kernel-adj compute s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            d = cells.get((a, s))
            if d is None or d.get("skipped") or not d.get("ok"):
                continue
            r = d["roofline"]
            kadj = r.get("kernel_adjusted_compute_s")
            head = (f"| {a} | {s} | {r['compute_s']:.4f} | "
                    f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
                    f"**{r['dominant']}** | {r['model_flops']:.3e} | "
                    f"{r['useful_ratio']:.2f} |")
            rows.append(head + (f" {kadj:.4f} |" if kadj else " — |"))
    return "\n".join(rows)


def summary(result_dir: str = RESULT_DIR):
    out = {}
    for mesh in ("single", "multi"):
        cells = load(mesh, result_dir)
        ok = sum(1 for d in cells.values() if d.get("ok"))
        skip = sum(1 for d in cells.values() if d.get("skipped"))
        fail = len(cells) - ok - skip
        out[mesh] = (ok, skip, fail, len(cells))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=RESULT_DIR,
                    help="the dry run's --outdir")
    args = ap.parse_args(argv)
    s = summary(args.outdir)
    print("## §Dry-run (predictions from the H100 datasheet constants)\n")
    for mesh, (ok, skip, fail, total) in s.items():
        print(f"- **{mesh}**: {ok} ok, {skip} skipped (assignment rule), "
              f"{fail} failed, {total} cells")
    print()
    for mesh in ("single", "multi"):
        print(dryrun_table(mesh, load(mesh, args.outdir)))
        print()
    print("## §Roofline (single mesh, per card)\n")
    print(roofline_table("single", load("single", args.outdir)))


if __name__ == "__main__":
    main()
