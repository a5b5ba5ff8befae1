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
           against standard NS (2e-3), at (32, 960, 2560) and (3, 64, 192);
           the per-matrix Frobenius normalization timed beside one batched
           ``vector_norm`` of the stack (the formula it replaced).
  train    full-width smollm-360m (32 layers, d_model 960, vocab 49152,
           fp32, remat) from seed 0, trained 3 steps by
           Muon(variant="muon", mode="owner", pipeline="fused") with the
           kernels on, batch 8 x 512; asserts finite losses and exactly
           7 syrk / 35 gram_poly / 84 symmul launches per step.
  adamw    the same training with the elementwise AdamW baseline (no Gram
           kernels launched): the yardstick of the optimizer's overhead.
  variants the same training with muon and each of normuon, muonbp
           (period 2, so step 2 reuses the cached polar map), dion2 (Gram
           NS on the rank-r factors, r = 240 / 80) and adamuon: 7 / 35 /
           84 launches a step, 0 / 0 / 0 on MuonBP's reuse step.  Then each
           first-step update with the kernels against the same variant's
           with the plain Gram NS (use_kernels=False) on the same
           gradients: within 10x what one ulp on the gradients moves the
           plain update, a gate that one TF32 pass per product misses by
           >= 10x (AdaMuon, whose first step maps each entry to about
           sign(o): what o's relative difference explains, above 1e-4 ·
           max|update|).  Dion2's batched QR timed.
  mesh     every visible card, one NCCL process each (spawned; they load
           the kernels the parent built), on a ("data", "model") =
           (cards, 1) mesh: one Muon update from the same full-width
           gradients with and without the mesh (bitwise on one card,
           1e-6 otherwise), the same gradients placed by ``param_specs``
           on a (1, cards) mesh (NCCL all-to-alls; 1e-6), then the training
           above under the mesh, data-parallel, by Muon (7 / 35 / 84
           launches a step on every rank), Muon-AG (gather mode) and AdamW,
           timed on every rank, and on rank 0 the same Muon training
           without the mesh: losses within 1e-5 relative (also of the train
           phase) and step 1's updates within 1e-4 · max|update|.

Then a ``{"kernels": [...]}`` summary line (``launches`` is null unless the
train phase ran), the nvidia-smi line (the first card's; the device line
lists every card), and last
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
PHASES = ("kernels", "blocks", "gram_ns", "train", "adamw", "variants",
          "mesh")
# the stateful variants and their knobs in the variants phase
VARIANT_RUNS = {"normuon": {}, "muonbp": {"muonbp_period": 2},
                "dion2": {}, "adamuon": {}}
VARIANT_GATE = 1e-4            # AdaMuon's floor: 1e-4 · max|update|
# kernel vs plain Gram NS update: within this many times the plain path's
# own move under one ulp on the gradients; one TF32 pass this many times
# outside that
VARIANT_SPREAD = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> list[str]:
    """One "name, power limit" line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()


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


def wall_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call on the host clock, synchronised
    before and after: what a caller waiting for the result sees, host
    launch costs included."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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
    # muon's shapes, then Dion2's r×n factors (r = 240, 80)
    for shape, dtype, tol in [((32, 960, 960), torch.float32, tc32),
                              ((32, 320, 960), torch.float32, tc32),
                              ((32, 960, 2560), torch.float32, tc32),
                              ((32, 240, 2560), torch.float32, tc32),
                              ((32, 240, 960), torch.float32, tc32),
                              ((32, 80, 960), torch.float32, tc32),
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
                               ((32, 240), torch.float32, tc32),
                               ((32, 80), torch.float32, tc32),
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
                       ("gram_poly", 320, 320), ("syrk", 240, 2560),
                       ("syrk", 240, 960), ("syrk", 80, 960),
                       ("symmul", 240, 240), ("gram_poly", 240, 240),
                       ("symmul", 80, 80), ("gram_poly", 80, 80)]:
        ms = {f"{bm}x{bk}": autotune.measure_cuda(mode, bm, bk, m, k,
                                                  "float32", batch=32)
              for bm, bk in autotune.candidate_blocks(mode, m, k)}
        emit({"phase": "blocks", "mode": mode, "batch": 32, "m": m, "k": k,
              "ms": ms, "measured_best": min(ms, key=ms.get),
              "analytical": "x".join(map(str, autotune.lookup(
                  mode, m, k, "float32", arch=autotune.device_arch("cuda"))))})


# ----------------------------------------------------------------- gram ns

def phase_gram_ns(torch) -> None:
    from repro_torch.core import gram_ns
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

    # X₀ = X / ‖X‖_F by one reduction per matrix (batch-invariant) against
    # one batched vector_norm of the stack, the formula it replaced; at the
    # main path's group shapes, 7 groups a step: 2 + 2 + 3 of these
    cfg = GramNSConfig()
    for m, n in [(960, 2560), (960, 960), (320, 960)]:
        x = torch.randn(32, m, n, generator=gen, device="cuda")
        new = lambda x=x: gram_ns.normalize(x, cfg)  # noqa: E731
        old = lambda x=x: x / (torch.linalg.vector_norm(  # noqa: E731
            x, dim=(-2, -1), keepdim=True, dtype=torch.float32) + 1e-7)
        emit({"phase": "gram_ns", "check": "normalize", "shape": [32, m, n],
              "per_matrix_ms": time_ms(new), "batched_ms": time_ms(old),
              "per_matrix_wall_ms": wall_ms(new),
              "batched_wall_ms": wall_ms(old),
              "max_abs_diff": max_abs_err(new(), old())})


# ------------------------------------------------------------------- train

def expected_launches(variant: str, mode: str, step: int,
                      knobs: dict) -> dict:
    """Kernel launches of one train step: ``LAUNCHES_PER_STEP`` for every
    Gram NS variant in owner mode (Dion2 runs the same iteration on its
    factors), none on MuonBP's reuse steps (one plain matmul), none for
    AdamW or the gather baseline (full-matrix NS, no kernel)."""
    none = dict.fromkeys(LAUNCHES_PER_STEP, 0)
    if variant == "adamw" or mode != "owner":
        return none
    if variant == "muonbp" and step % knobs.get("muonbp_period", 4):
        return none
    return dict(LAUNCHES_PER_STEP)


def train_run(torch, variant: str, mode: str = "owner", mesh=None, *,
              capture: bool = False, knobs: dict | None = None) -> dict:
    """Train full-width smollm-360m (seed 0, batch 8 x 512, kernels on)
    ``TRAIN_STEPS`` steps with ``variant`` / ``mode`` and the MuonConfig
    fields ``knobs``, under ``mesh`` when given (each rank on its rows of
    the batch).  The launch counters are set to 0 before each step and read
    after it, and must equal ``expected_launches``.  Returns losses, times
    (synchronised host clock around each step and around ``opt.update``),
    launches, peak memory, the plan and the model config and, with
    ``capture``, the first step's updates (this rank's parts)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    from repro_torch.train.step import init_state, make_train_step

    cfg = configs.get("smollm-360m")
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               mesh=mesh)
    knobs = knobs or {}
    opt = api.Muon(plan, mesh, config=MuonConfig(
        variant=variant, mode=mode, pipeline="fused",
        ns=GramNSConfig(use_kernels=True), **knobs), device="cuda")
    state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh)
    step = make_train_step(cfg, opt, mesh, device="cuda")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)

    # time the optimizer transform inside the step (synchronised around it)
    opt_ms, first = [], {}
    update = opt.update

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        if capture and not first:
            first.update({p: (u.to_local() if isinstance(u, DTensor)
                              else u).clone()
                          for p, u in tree.flatten(out[0])})
        return out
    opt.update = timed_update

    torch.cuda.reset_peak_memory_stats()
    loss_ema, step_ms, launches = [], [], []
    for i in range(TRAIN_STEPS):
        batch = batch_for_step(dcfg, i, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(LAUNCHES))
        loss_ema.append(float(state.loss_ema))

    tag = f"{variant}/{mode}" + ("" if mesh is None else " on the mesh")
    # the EMA is finite exactly when every step's loss so far is
    for i, loss in enumerate(loss_ema):
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} step {i}: loss_ema {loss}")
    for p, v in tree.flatten(state.params):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: parameter {p} is not finite")
    for i, got in enumerate(launches):
        want = expected_launches(variant, mode, i, knobs)
        if got != want:
            raise AssertionError(f"{tag} step {i}: kernel launches {got}, "
                                 f"expected {want}")
    return {"arch": cfg.name, "params": cfg.param_count(),
            "seq_len": dcfg.seq_len, "global_batch": dcfg.global_batch,
            "loss_ema": loss_ema, "step_ms": step_ms, "optimizer_ms": opt_ms,
            "launches": {k: sum(d[k] for d in launches)
                         for k in LAUNCHES_PER_STEP},
            "launches_by_step": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_updates": first, "plan": plan, "cfg": cfg}


def phase_train(torch, variant: str) -> dict:
    """Train full-width smollm-360m with ``variant`` ('muon': the main path,
    kernel launches counted; 'adamw': the elementwise baseline, which must
    launch none).  Returns the run."""
    run = train_run(torch, variant)
    launches = run["launches"]
    emit({"phase": "train", "variant": variant, "arch": run["arch"],
          "params": run["params"], "seq_len": run["seq_len"],
          "global_batch": run["global_batch"], "steps": TRAIN_STEPS,
          "loss_ema": run["loss_ema"], "step_ms": run["step_ms"],
          "optimizer_ms": run["optimizer_ms"],
          "peak_mem_gb": run["peak_mem_gb"], "launches": launches,
          "launches_per_step": {k: v // TRAIN_STEPS
                                for k, v in launches.items()}})
    return run


def adamuon_vs_o(got: dict, want: dict, o_got: dict, o_want: dict,
                 gate: float) -> dict:
    """AdaMuon's first update maps each entry o of the orthogonalized update
    to about sign(o) (v = (1 − β₂)o², bias correction 1 − β₂), so an entry
    carries o's *relative* difference between two paths into its own.
    With ``o_got`` / ``o_want`` plain Muon's updates on the same gradients
    (u = −lr·s·o) and rho an entry's relative difference of o, every entry
    must be within gate · max|update| + min(2·rho, 2) · max(|got|, |want|):
    at most a sign flip, or, where |o| is near eps = 1e-8, the step from
    o/eps to ±1.  Returns the counts and largest differences of the entries
    whose o agrees within ``gate`` ("held") and of the others."""
    import torch
    top = max(float(v.float().abs().max()) for v in want.values())
    allow = gate * top
    held_d = other_d = 0.0
    n_other = n_all = 0
    bad = []
    for p, w in want.items():
        g, w = got[p].float(), w.float()
        d = (g - w).abs()
        rho = torch.zeros_like(w)
        if p in o_want:
            oa, ob = o_got[p].float(), o_want[p].float()
            rho = torch.where(ob == 0, torch.full_like(ob, math.inf),
                              (oa - ob).abs() / ob.abs())
        bound = allow + torch.clamp(2 * rho, max=2.0) * \
            torch.maximum(g.abs(), w.abs())
        if bool((d > bound).any()):
            bad.append(p)
        held = rho <= gate
        n_all += w.numel()
        n_other += int((~held).sum())
        held_d = max(held_d, float(d[held].max()) if held.any() else 0.0)
        other_d = max(other_d, float(d[~held].max()) if (~held).any()
                      else 0.0)
    return {"max_abs_update": top, "allowance": allow,
            "held_max_abs_diff": held_d, "excepted": n_other,
            "entries": n_all, "excepted_max_abs_diff": other_d,
            "outside": bad}


def one_ulp_up(torch, t, gen):
    """``t`` with a random half of its entries moved one ulp up."""
    half = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    return torch.where(half, torch.nextafter(t, torch.full_like(t, math.inf)),
                       t)


def phase_variants(torch) -> None:
    """Muon (the baseline) and each stateful variant train full-width
    smollm-360m like the train phase (launches asserted per step by
    ``train_run``).  Then, on the first step's gradients (seed-0
    parameters, batch 0), each variant's update with the kernels is held
    against the same variant's with the plain Gram NS (``use_kernels=
    False``).  The gate is calibrated on the plain path itself: max|Δ| at
    most ``VARIANT_SPREAD`` times what one ulp on half the gradients moves
    the plain update, and the plain path with one TF32 pass per product
    (``allow_tf32``) at least ``VARIANT_SPREAD`` times outside that gate,
    so the gate tells TF32 from fp32.  AdaMuon, whose first step turns
    each entry into about sign(o), is held by ``adamuon_vs_o``.  Dion2's
    batched QR is timed at its (32, m, r) shapes."""
    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import transformer
    from repro_torch.train.step import make_loss_fn

    runs = {"muon": {}, **VARIANT_RUNS}
    lines = {}
    for variant, knobs in runs.items():
        torch.cuda.empty_cache()
        run = train_run(torch, variant, knobs=knobs)
        lines[variant] = {
            "phase": "variants", "variant": variant, "knobs": knobs,
            "arch": run["arch"], "steps": TRAIN_STEPS,
            "loss_ema": run["loss_ema"], "step_ms": run["step_ms"],
            "optimizer_ms": run["optimizer_ms"],
            "peak_mem_gb": run["peak_mem_gb"],
            "launches_by_step": run["launches_by_step"]}
        plan, cfg = run["plan"], run["cfg"]
        del run
    torch.cuda.empty_cache()

    # the first step's gradients, as train_run's first step computes them
    params = transformer.init(cfg, seed=0, device="cuda")
    leaves = [v.requires_grad_(True) for _, v in tree.flatten(params)]
    batch = batch_for_step(DataConfig(vocab=cfg.vocab, seq_len=512,
                                      global_batch=8), 0, device="cuda")
    grads = torch.autograd.grad(make_loss_fn(cfg)(params, batch), leaves)
    grads = tree.rebuild(params, dict(zip(
        (p for p, _ in tree.flatten(params)), grads)))
    gen = torch.Generator("cuda").manual_seed(5)
    grads_ulp = tree.tree_map(lambda g: one_ulp_up(torch, g, gen), grads)
    params = tree.tree_map(lambda v: v.detach(), params)

    def update(variant, knobs, use_kernels, g=grads, tf32=False):
        opt = api.Muon(plan, config=MuonConfig(
            variant=variant, mode="owner", pipeline="fused",
            ns=GramNSConfig(use_kernels=use_kernels), **knobs),
            device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            u, _ = opt.update(g, opt.init(params), params)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return dict(tree.flatten(u))

    failures = []
    for variant, knobs in runs.items():
        line = lines[variant]
        u_kern = update(variant, knobs, True)
        u_plain = update(variant, knobs, False)
        if variant == "adamuon":
            matrices = set(plan.leaves)
            o_kern, o_plain = (
                {p: v for p, v in update("muon", {}, k).items()
                 if p in matrices} for k in (True, False))
            cmp = adamuon_vs_o(u_kern, u_plain, o_kern, o_plain,
                               VARIANT_GATE)
            ok = not cmp["outside"]
            line.update({f"step1_{k}": v for k, v in cmp.items()})
            why = f"entries beyond what o explains in {cmp['outside']}"
        else:
            d, top, same = max_diff(u_kern, u_plain)
            spread = max_diff(update(variant, knobs, False, grads_ulp),
                              u_plain)[0]
            tf32 = max_diff(update(variant, knobs, False, tf32=True),
                            u_plain)[0]
            ok = d <= VARIANT_SPREAD * spread and \
                tf32 >= VARIANT_SPREAD * VARIANT_SPREAD * spread
            line.update({"step1_kernel_vs_plain_max_abs_diff": d,
                         "step1_max_abs_update": top, "bitwise": same,
                         "step1_plain_one_ulp_spread": spread,
                         "step1_plain_tf32_max_abs_diff": tf32,
                         "spread_factor": VARIANT_SPREAD,
                         "kernel_over_spread": d / spread if spread else None,
                         "tf32_over_gate": tf32 / (VARIANT_SPREAD * spread)
                         if spread else None,
                         "kernel_vs_plain_over_max_update": d / top})
            why = (f"kernel vs plain {d:.3e}, one-ulp spread {spread:.3e}, "
                   f"one TF32 pass {tf32:.3e}")
        emit({**line, "ok": ok})
        if not ok:
            failures.append(f"{variant}: {why}")
        del u_kern, u_plain

    qr = {}
    for b, m, r in [(32, 960, 240), (32, 320, 80)]:
        z = torch.randn(b, m, r, generator=gen, device="cuda")
        qr[f"{b}x{m}x{r}"] = {"ms": time_ms(lambda z=z: torch.linalg.qr(z)),
                              "wall_ms": wall_ms(
                                  lambda z=z: torch.linalg.qr(z))}
    emit({"phase": "variants", "check": "dion2_qr",
          "calls_per_step": {"32x960x240": 5, "32x320x80": 2}, "qr": qr})
    if failures:
        raise AssertionError("; ".join(failures))


# -------------------------------------------------------------------- mesh

MESH_TIMEOUT_S = 180           # every NCCL collective of the phase
SAME_GRADIENT_GATE = 1e-6      # max|Δ| of one update, absolute
LOSS_GATE = 1e-5               # relative, per step's loss_ema
STEP_UPDATE_GATE = 1e-4        # max|Δ| <= 1e-4 · max|update|, all leaves


def leaf_diffs(a: dict, b: dict) -> dict:
    """{path: (max|a − b|, max|b|, bitwise equal)} over two {path: tensor}
    dicts."""
    import torch
    return {p: (float((a[p].float() - v.float()).abs().max()),
                float(v.float().abs().max()), torch.equal(a[p], v))
            for p, v in b.items()}


def max_diff(a: dict, b: dict) -> tuple[float, float, bool]:
    """(max|a − b|, max|b|, bitwise equal) over all leaves."""
    rows = leaf_diffs(a, b).values()
    return (max(r[0] for r in rows), max(r[1] for r in rows),
            all(r[2] for r in rows))


def phase_mesh(torch, train_losses) -> None:
    """Every visible card, one NCCL rank each (spawned processes that load
    the kernels the parent built).  A rank that fails fails the run."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    mp.start_processes(mesh_rank, args=(world, free_port(), train_losses),
                       nprocs=world, start_method="spawn", join=True)


def mesh_rank(rank: int, world: int, port: int, train_losses) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.device import strict_fp32
    from repro_torch.launch.mesh import init_process_group

    strict_fp32()
    init_process_group("cuda", rank=rank, world_size=world,
                       init_method=f"tcp://localhost:{port}",
                       timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    # on a failure the process exits without destroy_process_group, which
    # would wait for peers blocked in a collective; the parent then ends
    # every rank
    mesh_checks(torch, dist, rank, world, train_losses)
    dist.destroy_process_group()


def mesh_checks(torch, dist, rank: int, world: int, train_losses) -> None:
    """The ``mesh`` phase on one rank: a ("data", "model") = (world, 1) mesh
    (the owners are the ranks, the batch split over them).

    1. One Muon update from the same full-width gradients (replicated,
       from a seed) with the mesh and without it: bitwise at world 1 (the
       collectives of one rank are copies), max|Δ| <= 1e-6 otherwise.
    2. The same gradients placed by ``param_specs`` on a (1, world) mesh,
       so the owner transposes are NCCL all-to-alls: max|Δ| <= 1e-6 against
       the update of 1.
    3. Full-width smollm-360m trained 3 steps under the mesh by Muon (owner
       mode, 7 / 35 / 84 launches a step on every rank), Muon-AG (gather
       mode) and AdamW, timed on every rank; then, on rank 0 alone, the
       same Muon training without the mesh (``train_vs_single``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, transformer

    lead = rank == 0
    mesh = make_mesh((world, 1), ("data", "model"), "cuda")
    cfg = configs.get("smollm-360m")
    shapes = transformer.init(cfg, device="meta")
    mcfg = MuonConfig(variant="muon", mode="owner", pipeline="fused",
                      ns=GramNSConfig(use_kernels=True))

    def update(m, params, grads):
        opt = api.Muon(api.dedicate_params(shapes, mesh=m), m, config=mcfg,
                       device="cuda")
        u, _ = opt.update(grads, opt.init(params), params)
        return {p: v.full_tensor() if isinstance(v, DTensor) else v
                for p, v in tree.flatten(u)}

    # 1 + 2: one update from the same gradients
    params = transformer.init(cfg, seed=0, device="cuda")
    gen = torch.Generator("cuda").manual_seed(7)
    grads = tree.tree_map(lambda v: torch.randn(
        v.shape, generator=gen, device="cuda") * 1e-3, params)
    u_one = update(None, params, grads)
    u_mesh = update(mesh, params, grads)
    d, top, same = max_diff(u_mesh, u_one)
    tp = make_mesh((1, world), ("data", "model"), "cuda")
    specs = sharding.param_specs(cfg, shapes, tp)
    u_tp = update(tp, sharding.place(params, specs, tp),
                  sharding.place(grads, specs, tp))
    d_tp, _, same_tp = max_diff(u_tp, u_mesh)
    if lead:
        emit({"phase": "mesh", "check": "same_gradient_update",
              "world": world, "mesh": [world, 1], "bitwise": same,
              "max_abs_diff": d, "max_abs_update": top,
              "gate": SAME_GRADIENT_GATE,
              "per_leaf_max_abs_diff": {p: r[0] for p, r in
                                        leaf_diffs(u_mesh, u_one).items()}})
        emit({"phase": "mesh", "check": "param_specs_update",
              "mesh": [1, world],
              "sharded_leaves": sum(any(e is not None for e in s)
                                    for s in specs.values()),
              "bitwise": same_tp, "max_abs_diff": d_tp,
              "gate": SAME_GRADIENT_GATE})
        batch_invariance(torch, 32 // world if world > 1 else 8)
    if world == 1 and not same:
        raise AssertionError(f"mesh of one: update differs by {d:.3e}")
    for what, diff in [("mesh", d), ("param_specs", d_tp)]:
        if diff > SAME_GRADIENT_GATE:
            raise AssertionError(f"{what} update differs by {diff:.3e} > "
                                 f"{SAME_GRADIENT_GATE}")
    del u_one, u_mesh, u_tp, params, grads

    # 3: training under the mesh, every rank timed
    runs = {}
    for variant, mode in [("muon", "owner"), ("muon", "gather"),
                          ("adamw", "owner")]:
        name = "adamw" if variant == "adamw" else mode
        run = train_run(torch, variant, mode, mesh, capture=name == "owner")
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, timing)
        runs[name] = run
        if lead:
            emit({"phase": "mesh", "mode": name, "world": world,
                  "mesh": [world, 1], "loss_ema": run["loss_ema"],
                  "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                                        run["launches"].items()},
                  "per_rank": per_rank})
        torch.cuda.empty_cache()

    failure = None
    if lead:
        single = train_run(torch, "muon", "owner", capture=True)
        matrices = set(api.dedicate_params(shapes).leaves)
        failure = train_vs_single(runs, single, world, train_losses,
                                  matrices)
    failures = [None] * world
    dist.all_gather_object(failures, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])


def batch_invariance(torch, rows: int) -> None:
    """Which stage of the owner-local Gram NS depends on how many matrices
    one call holds: the first ``rows`` of a (32, m, n) stack alone against
    the same rows inside the whole stack, stage by stage (a diagnostic of
    the same-gradient update across ranks, not a gate)."""
    from repro_torch.core import gram_ns
    from repro_torch.core.gram_ns import GramNSConfig

    cfg = GramNSConfig(use_kernels=True)
    gen = torch.Generator("cuda").manual_seed(3)
    out = {}
    for m, n in [(960, 2560), (960, 960), (320, 960)]:
        x = torch.randn(32, m, n, generator=gen, device="cuda")
        stages = {}
        for tag, xs in [("part", x[:rows]), ("whole", x)]:
            x0 = gram_ns.normalize(xs, cfg)
            g = gram_ns._ops(cfg)[0](x0)
            q = gram_ns.gram_iterate(g, cfg)
            stages[tag] = {"normalize": x0, "syrk": g, "iterate": q,
                           "finish": gram_ns._rect_dot(q, x0)}
        out[f"{m}x{n}"] = {
            k: float((v - stages["whole"][k][:rows]).abs().max())
            for k, v in stages["part"].items()}
    emit({"phase": "mesh", "check": "batch_invariance", "rows": rows,
          "of": 32, "max_abs_diff_by_stage": out})


def train_vs_single(runs: dict, single: dict, world: int, train_losses,
                    matrices: set):
    """Rank 0: emit the mesh runs against the same training on one card
    without the mesh, then the first gate missed (None if none): losses
    within 1e-5 relative (also of the train phase); step 1's updates
    within 1e-4 · max|update| (the gradient sums change order with the
    batch split), reported per leaf with the rule that made it (Muon's
    Newton-Schulz and AdamW's first step, -lr · g / (|g| + eps), both
    magnify a rounding-size change of the gradient).  The model's backward
    may add with atomics, so two runs without the mesh may differ too
    (``run_to_run_rel``)."""
    def rel_diff(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    mesh_loss = runs["owner"]["loss_ema"]
    rel = rel_diff(mesh_loss, single["loss_ema"])
    rel_train = None if train_losses is None else \
        rel_diff(mesh_loss, train_losses)
    per_leaf = leaf_diffs(runs["owner"]["first_updates"],
                          single["first_updates"])
    d_up = max(r[0] for r in per_leaf.values())
    top_up = max(r[1] for r in per_leaf.values())
    # steps 2-3: step 1 pays first-call costs
    steady = {name: {k: sum(r[k][1:]) / len(r[k][1:])
                     for k in ("step_ms", "optimizer_ms")}
              for name, r in [*runs.items(), ("single_owner", single)]}
    emit({"phase": "mesh", "check": "train_vs_single", "world": world,
          "loss_ema_mesh": mesh_loss, "loss_ema_single": single["loss_ema"],
          "train_phase_loss_ema": train_losses, "loss_rel_diff": rel,
          "loss_rel_diff_train_phase": rel_train,
          "run_to_run_rel": None if train_losses is None else
          rel_diff(single["loss_ema"], train_losses),
          "loss_gate": LOSS_GATE, "step1_update_max_abs_diff": d_up,
          "step1_max_abs_update": top_up,
          "update_gate": STEP_UPDATE_GATE,
          "step1_per_leaf": {p: {"max_abs_diff": r[0], "max_abs_update": r[1],
                                 "bitwise": r[2],
                                 "rule": "muon" if p in matrices else "adamw"}
                             for p, r in per_leaf.items()},
          "single_step_ms": single["step_ms"],
          "single_optimizer_ms": single["optimizer_ms"],
          "rank0_steady_mean_ms": steady,
          "owner_over_adamw": {k: steady["owner"][k] / steady["adamw"][k]
                               for k in ("step_ms", "optimizer_ms")},
          "gather_over_owner": {k: steady["gather"][k] / steady["owner"][k]
                                for k in ("step_ms", "optimizer_ms")},
          "mesh_minus_single_ms": {
              k: steady["owner"][k] - steady["single_owner"][k]
              for k in ("step_ms", "optimizer_ms")}})
    for name, r in [("the same run without the mesh", rel),
                    ("the train phase", rel_train)]:
        if r is not None and r > LOSS_GATE:
            return (f"mesh losses {mesh_loss} vs {name}: {r:.3e} relative "
                    f"> {LOSS_GATE}")
    if d_up > STEP_UPDATE_GATE * top_up:
        return (f"step 1 updates differ by {d_up:.3e} > "
                f"{STEP_UPDATE_GATE} x {top_up:.3e}")
    return None


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
    emit({"phase": "device", "nvidia_smi": smi[0], "nvidia_smi_all": smi,
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
    train_losses = None
    if "train" in phases:
        run = phase_train(torch, "muon")
        launches, train_losses = run["launches"], run["loss_ema"]
        del run
    if "adamw" in phases:
        torch.cuda.empty_cache()
        phase_train(torch, "adamw")
    if "variants" in phases:
        phase_variants(torch)
    if "mesh" in phases:
        phase_mesh(torch, train_losses)

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
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
