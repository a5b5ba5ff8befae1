#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                    # every phase, one CUDA card
    python3 chip_smoke.py --phases kernels   # a subset (device always runs)

Phases, each printing one JSON line and asserting what it checks:

  device   card name and power limit (nvidia-smi), and the build of every
           kernel in ``src/repro_torch/kernels/csrc`` (one nvcc per source,
           all in parallel, into the ignored ``build/repro_torch/``).
  kernels  each Hopper kernel against its plain PyTorch version on the card
           at the slice's shapes, plus bf16 (2e-2), unaligned (the fp32
           pad path: syrk (2, 101, 211), symmul m = 198) and
           block-invariance cases, on inputs whose products are O(1) so the
           tolerance is small against every term of each product
           (asserted).  Every fp32 product (3xTF32 on the tensor cores)
           must be within 1e-5 · max|want|, which one TF32 pass misses by
           >= 10x (asserted on the plain emulation of one TF32 product).
           The syrk's rows are heavy-tailed (cubed Gaussians, unit norm):
           Gaussian rows give G near I, where the contraction averages one
           TF32 pass's rounding away and the gate could not tell it from
           fp32.  Times the kernel, the plain version and one
           ``torch.matmul`` of the same product (a yardstick only, never
           called by the port), beside the tensor-core bound and the bound
           of fp32 FFMA outside them.
  blocks   every candidate block pair timed at the slice's shapes (the
           autotuner's measured backend), beside the analytical choice.
  gram_ns  Gram NS with the kernels against the plain path (1e-4) and
           against standard NS (2e-3), at (32, 960, 2560) and (3, 64, 192).
  train    full-width smollm-360m (32 layers, d_model 960, vocab 49152,
           fp32, remat) from seed 0, trained 3 steps by
           Muon(variant="muon", mode="owner", pipeline="fused") with the
           kernels on, batch 8 x 512; asserts finite losses and exactly
           7 syrk / 35 gram_poly / 84 symmul launches per step.
  adamw    the same training with the elementwise AdamW baseline (no Gram
           kernels launched): the yardstick of the optimizer's overhead.

Then a ``{"kernels": [...]}`` summary line (``launches`` is null unless the
train phase ran), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero.  Without
a CUDA card, or without the repository's ``src/`` beside it, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks (dense): TF32 and bf16 on the tensor cores, fp32
# FFMA outside them, HBM3 bandwidth.
TF32_FLOPS, BF16_FLOPS, FFMA_FLOPS = 495e12, 989e12, 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 at fp32 accuracy on the tensor cores takes three TF32 products
# (3xTF32); bf16 one bf16 product.
TENSOR_CORE_PASSES = {"float32": (3, TF32_FLOPS), "bfloat16": (1, BF16_FLOPS)}
SCALED_GATE = 1e-5     # fp32 products: max err <= 1e-5 · max|want|

KERNELS = {
    "gram_syrk": dict(source="src/repro_torch/kernels/csrc/gram_syrk.cu",
                      replaces="src/repro/kernels/gram_syrk.py:56",
                      counter="syrk"),
    "symmul_plain": dict(source="src/repro_torch/kernels/csrc/symmul.cu",
                         replaces="src/repro/kernels/symmul.py:105",
                         counter="symmul"),
    "symmul_gram_poly": dict(source="src/repro_torch/kernels/csrc/symmul.cu",
                             replaces="src/repro/kernels/symmul.py:105",
                             counter="gram_poly"),
}
LAUNCHES_PER_STEP = {"syrk": 7, "gram_poly": 35, "symmul": 84}
TRAIN_STEPS = 3
PHASES = ("kernels", "blocks", "gram_ns", "train", "adamw")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Registers and spills of every kernel in one ``nvcc -Xptxas -v`` log,
    and ptxas's performance notes (C75xx: e.g. wgmma serialised, or a wait
    injected), keyed by the kernel's name (demangled where ``c++filt``
    exists, without namespace and parameters)."""
    rows, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", ln)
        if entry:
            name = entry.group(1)
            rows.setdefault(name, [])
            continue
        note = re.search(r"\(C75\d\d\).*", ln)
        if note:
            owner = re.search(r"function '(\w+)'", ln)
            rows.setdefault(owner.group(1) if owner else name, []).append(
                re.sub(r" in the function '\w+'", "", note.group(0)))
        elif name is not None and ("registers" in ln or "spill" in ln):
            rows[name].append(ln.split(":", 1)[-1].strip())
    names = list(rows)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = names
    if len(plain) != len(names):
        plain = names
    short = (re.sub(r"^void |\(.*\)$", "",
                    p.replace("(anonymous namespace)::", "")) for p in plain)
    return {k: "; ".join(rows[n]) for n, k in zip(names, short)}


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call, CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(name: str, shape, dtype: str, out_bytes: int
          ) -> tuple[float, str, float]:
    """Least time on the card, ms: the larger of the symmetric-kernel
    operations on the tensor cores at the operand type's accuracy (fp32:
    three TF32 products at 495 TFLOP/s; bf16: one at 989) and the bytes
    (each input read once, each output written once) over the HBM rate;
    which of the two bounds it; and the same bound with the operations as
    fp32 FFMA at 67 TFLOP/s, off the tensor cores."""
    in_bytes = 2 if dtype == "bfloat16" else 4
    if name == "gram_syrk":
        b, m, n = shape
        flops = b * m * m * n                   # half of 2·m²·n
        nbytes = b * m * n * in_bytes + b * m * m * out_bytes
    else:
        b, m, _ = shape
        flops = b * m ** 3                      # half of 2·m³
        n_in = 2 if name == "symmul_plain" else 1
        nbytes = n_in * b * m * m * in_bytes + b * m * m * out_bytes
    passes, peak = TENSOR_CORE_PASSES[dtype]
    t_ops = passes * flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ffma = max(flops / FFMA_FLOPS * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", t_ffma
    return t_bytes, "bytes", t_ffma


def max_abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_sensitive(tag: str, term, want, rtol: float, atol: float) -> None:
    """The gate must see ``term``, the part of the output that the kernel's
    product contributes: its largest entry is at least 10 times the
    comparison's allowance, so a kernel that drops the product, or half of
    its contraction, fails ``check_close``."""
    allowance = atol + rtol * float(want.float().abs().max())
    largest = float(term.float().abs().max())
    if largest < 10 * allowance:
        raise AssertionError(f"{tag}: product term {largest:.3e} is within "
                             f"10x the allowance {allowance:.3e}")


def check_close(tag: str, got, want, rtol: float, atol: float) -> float:
    import torch
    err = max_abs_err(got, want)
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{tag}: non-finite output")
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: max abs err {err:.3e} exceeds "
                             f"rtol {rtol} / atol {atol}")
    return err


def scaled_allowance(want, scaled: float) -> float:
    return scaled * float(want.float().abs().max())


def check_scaled(tag: str, got, want, scaled: float) -> float:
    """max|got − want| <= ``scaled`` · max|want|: the gate of the fp32
    tensor-core products, relative to the output's scale."""
    import torch
    err = max_abs_err(got, want)
    allowance = scaled_allowance(want, scaled)
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{tag}: non-finite output")
    if err > allowance:
        raise AssertionError(f"{tag}: max abs err {err:.3e} exceeds "
                             f"{scaled} · max|want| = {allowance:.3e}")
    return err


def check_rejects_tf32(tag: str, one_pass, want, scaled: float) -> float:
    """The gate tells TF32 from fp32: the plain version run on TF32-rounded
    operands (one TF32 product) misses the allowance by at least 10x.
    Returns that ratio."""
    ratio = max_abs_err(one_pass, want) / scaled_allowance(want, scaled)
    if ratio < 10:
        raise AssertionError(f"{tag}: one TF32 pass is only {ratio:.1f}x "
                             f"the allowance; the gate cannot tell it from "
                             f"fp32")
    return ratio


# ----------------------------------------------------------------- kernels

def gram_inputs(torch, gen, b, m, n, dtype, coeffs):
    """x (b, m, n), G = X Xᵀ and P = aI + bG + cG² in ``dtype``.  X is
    scaled by 1/sqrt(n), so G is near I and P, PG and G² are O(1): the
    absolute tolerance stays far below every product's entries.  (The main
    path's X₀ has unit Frobenius norm, so its G is smaller by m; the
    products scale with their inputs, so relative errors are the same.)"""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram_syrk import syrk_plain
    from repro_torch.kernels.symmul import symmul_plain
    x = torch.randn(b, m, n, generator=gen, device=gen.device) / math.sqrt(n)
    g = ref.mirror_lower(syrk_plain(x))
    p = ref.mirror_lower(symmul_plain(g, g, epilogue="gram_poly",
                                      coeffs=coeffs))
    return x.to(dtype), g.to(dtype), p.to(dtype)


def syrk_inputs(torch, gen, b, m, n):
    """x (b, m, n) fp32 with heavy-tailed rows: cubed Gaussians, each row
    scaled to unit norm, so G = X Xᵀ has unit diagonal and its largest
    off-diagonal entries come from a few large terms, which one TF32 pass
    rounds by far more than the fp32 gate allows."""
    x = torch.randn(b, m, n, generator=gen, device=gen.device) ** 3
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def kernel_cases(torch, gen):
    """(kernel name, shape, dtype, tol, kernel fn, plain fn, library fn,
    product term, one-TF32-pass fn or None) at the slice's shapes, plus
    bf16 and unaligned cases.  The product term is what the kernel's product
    adds to the output: all of it for syrk and symmul, c·G² for gram_poly.
    ``tol`` is rtol/atol, or ``scaled`` for the fp32 tensor-core products."""
    from repro_torch.core.coefficients import get_coefficients
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_syrk import syrk_plain, syrk_tf32_emulated
    from repro_torch.kernels.symmul import symmul_plain, symmul_tf32_emulated

    coeffs = get_coefficients("polar_express", 5)[0]   # largest: 8.3/-23.6/17.3

    tc32 = dict(scaled=SCALED_GATE)
    bf16 = dict(rtol=2e-2, atol=2e-2)
    cases = []
    for shape, dtype, tol in [((32, 960, 960), torch.float32, tc32),
                              ((32, 320, 960), torch.float32, tc32),
                              ((32, 960, 2560), torch.float32, tc32),
                              ((8, 320, 960), torch.bfloat16, bf16),
                              ((2, 100, 212), torch.float32, tc32),
                              ((2, 101, 211), torch.float32, tc32)]:
        tc = dtype == torch.float32
        x = (syrk_inputs(torch, gen, *shape) if tc else
             gram_inputs(torch, gen, *shape, dtype, coeffs)[0])
        cases.append(("gram_syrk", shape, dtype, tol,
                      lambda x=x: ops.syrk(x),
                      lambda x=x: syrk_plain(x),
                      lambda x=x: torch.matmul(x, x.mT),
                      lambda x=x: syrk_plain(x),
                      (lambda x=x: syrk_tf32_emulated(x, passes=1))
                      if tc else None))
    for (b, m), dtype, tol in [((32, 960), torch.float32, tc32),
                               ((32, 320), torch.float32, tc32),
                               ((8, 320), torch.bfloat16, bf16),
                               ((2, 200), torch.float32, tc32),
                               ((2, 198), torch.float32, tc32)]:
        _, g, p = gram_inputs(torch, gen, b, m, 2 * m, dtype, coeffs)
        tc = dtype == torch.float32
        cases.append(("symmul_plain", (b, m, m), dtype, tol,
                      lambda p=p, g=g: ops.symmul(p, g),
                      lambda p=p, g=g: symmul_plain(p, g),
                      lambda p=p, g=g: torch.matmul(p, g),
                      lambda p=p, g=g: symmul_plain(p, g),
                      (lambda p=p, g=g: symmul_tf32_emulated(p, g, passes=1))
                      if tc else None))
        cases.append(("symmul_gram_poly", (b, m, m), dtype, tol,
                      lambda g=g: ops.gram_poly(g, *coeffs),
                      lambda g=g: symmul_plain(g, g, epilogue="gram_poly",
                                               coeffs=coeffs),
                      lambda g=g: torch.matmul(g, g),
                      lambda g=g: coeffs[2] * symmul_plain(g.float(),
                                                           g.float()),
                      (lambda g=g: symmul_tf32_emulated(
                          g, g, epilogue="gram_poly", coeffs=coeffs,
                          passes=1)) if tc else None))
    return cases


def phase_kernels(torch) -> dict:
    from repro_torch.core.coefficients import get_coefficients
    from repro_torch.device import dtype_name
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels.gram_syrk import syrk_plain
    from repro_torch.kernels.symmul import symmul_plain

    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for (name, shape, dtype, tol, kern, plain, lib, term,
         one_pass) in kernel_cases(torch, gen):
        got = kern()
        torch.cuda.synchronize()
        want = ref.mirror_lower(plain())
        tag = f"{name}{list(shape)} {dtype}"
        row = {}
        if "scaled" in tol:
            allowance = scaled_allowance(want, tol["scaled"])
            check_sensitive(tag, term(), want, 0.0, allowance)
            err = check_scaled(tag, got, want, tol["scaled"])
            row["tf32_one_pass_x_allowance"] = check_rejects_tf32(
                tag, ref.mirror_lower(one_pass()), want, tol["scaled"])
        else:
            check_sensitive(tag, term(), want, **tol)
            err = check_close(tag, got, want, **tol)
        dt = dtype_name(dtype)
        b_ms, b_by, ffma_ms = bound(name, shape, dt, got.element_size())
        blocks = autotune.lookup(KERNELS[name]["counter"], shape[1], shape[2],
                                 dt, arch=autotune.device_arch("cuda"))
        rows.append({"phase": "kernels", "kernel": name, "shape": list(shape),
                     "blocks": list(blocks), "dtype": dt, "max_err": err,
                     "max_abs_want": float(want.float().abs().max()),
                     **tol, **row,
                     "kernel_ms": time_ms(kern), "plain_ms": time_ms(plain),
                     "library_ms": time_ms(lib), "bound_ms": b_ms,
                     "bound_by": b_by, "bound_ffma_ms": ffma_ms})
        emit(rows[-1])

    # summary per kernel: its largest main-path shape (fp32, batch 32), with
    # the largest error over all its main-path shapes
    summary = {}
    for name in KERNELS:
        main = [r for r in rows if r["kernel"] == name
                and r["dtype"] == "float32" and r["shape"][0] == 32]
        summary[name] = {**max(main, key=lambda r: math.prod(r["shape"])),
                         "max_abs_err": max(r["max_err"] for r in main)}

    # block invariance: the two candidate pairs agree with the plain version
    # and with each other
    coeffs = get_coefficients("polar_express", 5)[0]
    x = syrk_inputs(torch, gen, 4, 320, 960)
    _, g, _ = gram_inputs(torch, gen, 4, 320, 960, torch.float32, coeffs)
    pairs = list(autotune.INSTANTIATED_BLOCKS)
    for name, fn, plain in [
            ("gram_syrk", lambda bm, bk: ops.syrk(x, block_m=bm, block_k=bk),
             lambda: syrk_plain(x)),
            ("symmul_plain",
             lambda bm, bk: ops.symmul(g, g, block_m=bm, block_k=bk),
             lambda: symmul_plain(g, g))]:
        want = ref.mirror_lower(plain())
        outs = [fn(*pair) for pair in pairs]
        errs = [check_scaled(f"{name} block {pair}", out, want, SCALED_GATE)
                for pair, out in zip(pairs, outs)]
        errs.append(check_scaled(f"{name} block pairs", outs[0], outs[1],
                                 SCALED_GATE))
        emit({"phase": "kernels", "check": "block_invariance",
              "kernel": name, "blocks": [list(pair) for pair in pairs],
              "max_err": max(errs)})
    return summary


def phase_blocks(torch) -> None:
    """Every candidate block pair timed at the main path's shapes (the
    autotuner's ``measured`` backend), beside the analytical choice."""
    from repro_torch.kernels import autotune
    for mode, m, k in [("syrk", 960, 2560), ("syrk", 960, 960),
                       ("syrk", 320, 960), ("symmul", 960, 960),
                       ("gram_poly", 960, 960), ("symmul", 320, 320),
                       ("gram_poly", 320, 320)]:
        ms = {f"{bm}x{bk}": autotune.measure_cuda(mode, bm, bk, m, k,
                                                  "float32", batch=32)
              for bm, bk in autotune.candidate_blocks(mode, m, k)}
        emit({"phase": "blocks", "mode": mode, "batch": 32, "m": m, "k": k,
              "ms": ms, "measured_best": min(ms, key=ms.get),
              "analytical": "x".join(map(str, autotune.lookup(
                  mode, m, k, "float32", arch=autotune.device_arch("cuda"))))})


# ----------------------------------------------------------------- gram ns

def phase_gram_ns(torch) -> None:
    from repro_torch.core.gram_ns import GramNSConfig, gram_newton_schulz
    from repro_torch.core.newton_schulz import newton_schulz

    gen = torch.Generator("cuda").manual_seed(1)
    for shape in [(32, 960, 2560), (3, 64, 192)]:
        m = torch.randn(*shape, generator=gen, device="cuda")
        k_cfg = GramNSConfig(num_steps=5, use_kernels=True)
        p_cfg = GramNSConfig(num_steps=5)
        kern = lambda: gram_newton_schulz(m, k_cfg, assume_short_fat=True)  # noqa: E731
        plain = lambda: gram_newton_schulz(m, p_cfg, assume_short_fat=True)  # noqa: E731
        got, want = kern(), plain()
        std = newton_schulz(m, num_steps=5)
        err_plain = check_close(f"gram_ns{list(shape)} kernel vs plain",
                                got, want, 1e-4, 1e-4)
        err_std = check_close(f"gram_ns{list(shape)} kernel vs standard NS",
                              got, std, 2e-3, 2e-3)
        emit({"phase": "gram_ns", "shape": list(shape), "dtype": "float32",
              "max_err_vs_plain": err_plain, "max_err_vs_standard": err_std,
              "kernel_ms": time_ms(kern, reps=5, warmup=1),
              "plain_ms": time_ms(plain, reps=5, warmup=1)})


# ------------------------------------------------------------------- train

def phase_train(torch, steps: int, variant: str) -> dict:
    """Train full-width smollm-360m ``steps`` steps with ``variant`` ('muon':
    the main path, kernel launches counted; 'adamw': the elementwise
    baseline, which must launch none).  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    from repro_torch.train.step import init_state, make_train_step

    cfg = configs.get("smollm-360m")
    plan = api.dedicate_params(transformer.init(cfg, device="meta"))
    opt = api.Muon(plan, config=MuonConfig(
        variant=variant, mode="owner", pipeline="fused",
        ns=GramNSConfig(use_kernels=True)), device="cuda")
    state = init_state(cfg, opt, seed=0, device="cuda")
    step = make_train_step(cfg, opt, device="cuda")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)

    # time the optimizer transform inside the step (synchronised around it)
    opt_ms = []
    update = opt.update

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    opt.update = timed_update

    torch.cuda.reset_peak_memory_stats()
    loss_ema, step_ms = [], []
    reset_launches()
    for i in range(steps):
        batch = batch_for_step(dcfg, i, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        loss_ema.append(float(state.loss_ema))
    launches = dict(LAUNCHES)

    # the EMA is finite exactly when every step's loss so far is
    for i, loss in enumerate(loss_ema):
        if not math.isfinite(loss):
            raise AssertionError(f"{variant} step {i}: loss_ema {loss}")
    for p, v in tree.flatten(state.params):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{variant}: parameter {p} is not finite")
    per_step = LAUNCHES_PER_STEP if variant == "muon" else \
        dict.fromkeys(LAUNCHES_PER_STEP, 0)
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{variant}: kernel launches {launches}, "
                             f"expected {want} over {steps} steps")
    emit({"phase": "train", "variant": variant, "arch": cfg.name,
          "params": cfg.param_count(), "seq_len": dcfg.seq_len,
          "global_batch": dcfg.global_batch, "steps": steps,
          "loss_ema": loss_ema, "step_ms": step_ms, "optimizer_ms": opt_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches,
          "launches_per_step": {k: v // steps for k, v in launches.items()}})
    return launches


# -------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.device import strict_fp32
    from repro_torch.kernels import build

    strict_fp32()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    per_source = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: ptxas_report(build.library_path(n).with_suffix(".log")
                             .read_text())
             for n in build.SOURCES
             if build.library_path(n).with_suffix(".log").exists()}
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_s_per_source": per_source, "ptxas": ptxas})

    summary, launches = {}, None
    if "kernels" in phases:
        summary = phase_kernels(torch)
    if "blocks" in phases:
        phase_blocks(torch)
    if "gram_ns" in phases:
        phase_gram_ns(torch)
    if "train" in phases:
        launches = phase_train(torch, TRAIN_STEPS, "muon")
    if "adamw" in phases:
        torch.cuda.empty_cache()
        phase_train(torch, TRAIN_STEPS, "adamw")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"],
         "launches": None if launches is None else launches[meta["counter"]],
         "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "shape": row["shape"]}
        for name, meta in KERNELS.items()
        if (row := summary.get(name)) is not None]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
