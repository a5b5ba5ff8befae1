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
  pipeline the bucketed schedule (``pipeline="bucketed"``), one card: 3
           training steps bucketed, fused at ``accum_steps=2`` and bucketed
           with prestaging at ``accum_steps=2`` (7 / 35 / 84 launches a
           step), timed beside the train phase; one update from the same
           full-width gradients bucketed and fused, and two saved microbatch
           gradients accumulated prestaged and unstaged: bitwise equal.
  resilience
           the resilient loop (``runtime/resilient.py``) at full width,
           muon with 4 owners in one process, kernels on, through the
           drill slow@4:r3x4.0; unslow@10:r3; kill@12:r1; readd@16;
           preempt@22 over 24 steps with a checkpoint every 8 (keep 2,
           under the ignored ``build/``, deleted at the end; the free
           disk checked first): 30 executed steps, a rebalance, one kill,
           readd and preempt each (the preempt restores the step-16
           checkpoint written at 3 owners through
           ``reshard_owner_state``), 7 / 35 / 84 launches in every
           executed step; parameters, loss curve and logical momentum rows
           bitwise equal to an unfaulted 24-step run.  Prints each save's
           synchronous snapshot and asynchronous write, each restore and
           reshard, each recovery's latency and the steady step.  Then
           ``python -m repro_torch.launch.train`` (greedy, batch 8 x 512)
           as subprocesses: 3 steps with a checkpoint, resumed to 6, and 6
           straight: loss_ema and every parameter's float64 sum bitwise
           equal.  Prints the phase's seconds.
  mesh     every visible card, one NCCL process each (spawned; they load
           the kernels the parent built), on a ("data", "model") =
           (cards, 1) mesh: one Muon update from the same full-width
           gradients with and without the mesh (bitwise on one card,
           1e-6 otherwise), the same gradients placed by ``param_specs``
           on a (1, cards) mesh (NCCL all-to-alls; 1e-6), on both meshes
           the bucketed update bitwise equal to the fused one on every
           rank, then the training above under the mesh, data-parallel, by
           Muon (fused, bucketed, fused and bucketed-prestaged at
           ``accum_steps=2``; 7 / 35 / 84 launches a step on every rank),
           Muon-AG (gather mode) and AdamW, timed on every rank, with each
           step's allocator calls and garbage collections.  On every rank
           the bucketed training equals the fused one, and the prestaged
           one its own run with every collective waited as issued,
           bitwise (losses, first updates, last parameters); the
           prestaged one is within rounding of the unstaged one (bitwise
           on one card; on more, loss_ema within 1e-5, AdamW's first
           updates bitwise, Muon's within 10x the one-ulp spread below,
           the last parameters printed beside 5e-5).  On rank 0 the same
           Muon training on one
           card, of the whole batch and of the batch in ``cards``
           microbatches (microbatch r = rank r's rows, checked): losses
           within 1e-5 relative of the first (also of the train phase);
           step 1's updates against it printed per leaf beside 1e-4 ·
           max|update|; step 1 held against the second by ``step_gate``
           (averaged gradients within the reordering bound of a sum over
           the ranks, Muon updates within 10x the one-ulp spread, AdamW
           entries within what their gradients explain), which the sum
           where the mean belongs and a dropped rank must each miss by
           >= 10x on more than one card.  ``--trace adamw,owner`` writes
           ``torch.profiler`` traces of those mesh runs (rank 0) into
           ``--trace-dir`` (default ``build/traces``).  The owner run's
           last state is saved by every rank with the checkpoint manager
           (owner rows in row blocks) and restored by rank 0 in one
           process onto a plan of ``cards`` owners: its logical momentum
           rows bitwise those of an all-gather taken in the run.

Then a ``{"kernels": [...]}`` summary line (``launches`` is null unless the
train phase ran), the nvidia-smi line (the first card's; the device line
lists every card), and last
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero.  Without
a CUDA card, or without the repository's ``src/`` beside it, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
          "pipeline", "resilience", "mesh")
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


def allocator_counts(torch) -> dict:
    """The caching allocator's device calls and reserved bytes so far."""
    st = torch.cuda.memory_stats()
    return {"cuda_mallocs": st.get("num_device_alloc", 0),
            "cuda_frees": st.get("num_device_free", 0),
            "alloc_retries": st.get("num_alloc_retries", 0),
            "reserved_gb": st.get("reserved_bytes.all.current", 0) / 1e9}


class GcClock:
    """Collections of Python's cyclic garbage collector and their host
    time, per generation, since ``reset()`` (a ``gc.callbacks`` hook)."""

    def __init__(self):
        self.reset()
        self._t0 = None

    def reset(self) -> None:
        self.counts, self.ms = [0, 0, 0], [0.0, 0.0, 0.0]

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.counts[g] += 1
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def read(self) -> dict:
        return {"collections": list(self.counts), "ms": list(self.ms)}


def trace_summary(prof, steps: int, top: int = 8) -> list:
    """Per step (a ``record_function`` range "step<i>"), the ``top`` ops by
    self host time and by self device time, ms."""
    events = list(prof.events())
    out = []
    for i in range(steps):
        rng = next((e.time_range for e in events if e.name == f"step{i}"),
                   None)
        if rng is None:
            out.append(None)
            continue
        host, dev = {}, {}
        for e in events:
            if e.name.startswith("step") or not (
                    rng.start <= e.time_range.start <= rng.end):
                continue
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
            dev[e.name] = dev.get(e.name, 0.0) + e.self_device_time_total
        out.append({
            "range_ms": (rng.end - rng.start) / 1e3,
            "host_self_ms": {k: v / 1e3 for k, v in sorted(
                host.items(), key=lambda kv: -kv[1])[:top]},
            "device_self_ms": {k: v / 1e3 for k, v in sorted(
                dev.items(), key=lambda kv: -kv[1])[:top] if v > 0},
            "device_busy_ms": sum(dev.values()) / 1e3})
    return out


def capture_grads(grads, mesh) -> dict:
    """{path: (mean gradient, sum over the ranks of |gradient|, this rank's
    gradient)} of one step's gradients as the optimizer receives them: a
    ``Partial`` ``DTensor``'s pending reduction done by
    ``owner_comms.reduce_partial`` (a copy, ``all_reduce``, ``div_``), a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.core import tree
    from repro_torch.core.owner_comms import reduce_partial
    out = {}
    for p, g in tree.flatten(grads):
        if not isinstance(g, DTensor):
            out[p] = (g.clone(), g.abs(), g.clone())
            continue
        local, pl = g.to_local(), g.placements
        summed = [Partial("sum") if q.is_partial() else q for q in pl]
        out[p] = (reduce_partial(local, pl, mesh),
                  reduce_partial(local.abs(), summed, mesh), local.clone())
    return out


def train_run(torch, variant: str, mode: str = "owner", mesh=None, *,
              capture: bool | str = False, grads: bool = False,
              knobs: dict | None = None,
              trace: str | None = None, pipeline: str = "fused",
              accum_steps: int = 1, prestage: bool | None = None,
              steps: int = TRAIN_STEPS, keep_state: bool = False) -> dict:
    """Train full-width smollm-360m (seed 0, batch 8 x 512, kernels on)
    ``steps`` steps with ``variant`` / ``mode`` / ``pipeline`` and
    the MuonConfig fields ``knobs``, under ``mesh`` when given (each rank
    on its rows of the batch), in ``accum_steps`` microbatches, staged to
    the owners per microbatch when ``prestage`` (``make_train_step``).  The
    launch counters are set to 0 before each step and read after it, and
    must equal ``expected_launches``.  Returns losses, times (synchronised
    host clock around each step and around ``opt.update`` /
    ``opt.update_staged``), launches, the caching allocator's device calls
    and Python's garbage collections per step, peak memory, the plan and
    the model config; with ``capture``, the first step's updates (this
    rank's parts; kept on the card, or copied to the host with
    ``capture="host"``) and the last step's parameters (on the host); with
    ``grads``, the first step's gradients (``capture_grads``).  Like a
    training launcher, it exempts what is alive before the steps (torch's
    modules, this run's model, optimizer and state) from Python's cyclic
    garbage collector for the timed steps (``gc.freeze``), and hands it
    back after them (``gc.unfreeze``), so nothing of the run outlives it.
    With ``trace`` (a file path) the steps run under ``torch.profiler``
    (host and device), the Chrome trace is written there and a per-step
    summary returned.  With ``keep_state`` the last ``TrainState`` is
    returned too."""
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
        variant=variant, mode=mode, pipeline=pipeline,
        ns=GramNSConfig(use_kernels=True), **knobs), device="cuda")
    state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh)
    step = make_train_step(cfg, opt, mesh, accum_steps=accum_steps,
                           prestage=prestage, device="cuda")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)

    # time the optimizer transform inside the step (synchronised around it)
    opt_ms, first, first_grads = [], {}, {}

    def keep(t):
        return t.to("cpu") if capture == "host" else t.clone()

    def timed(update, staged: bool):
        def run(*a, **kw):
            if grads and not staged and not first_grads:
                first_grads.update(capture_grads(a[0], mesh))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = update(*a, **kw)
            torch.cuda.synchronize()
            opt_ms.append((time.perf_counter() - t0) * 1e3)
            if capture and not first:
                first.update({p: keep(u.to_local() if isinstance(u, DTensor)
                                      else u)
                              for p, u in tree.flatten(out[0])})
            return out
        return run
    opt.update = timed(opt.update, False)
    opt.update_staged = timed(opt.update_staged, True)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    gc.freeze()
    torch.cuda.reset_peak_memory_stats()
    loss_ema, step_ms, launches, allocator, collector = [], [], [], [], []
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    for i in range(steps):
        batch = batch_for_step(dcfg, i, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        before = allocator_counts(torch)
        gc_clock.reset()
        reset_launches()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"step{i}"):
            state = step(state, batch)
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(LAUNCHES))
        loss_ema.append(float(state.loss_ema))
        after = allocator_counts(torch)
        allocator.append({k: after[k] - before[k] if k != "reserved_gb"
                          else after[k] for k in after})
        collector.append(gc_clock.read())
    gc.callbacks.remove(gc_clock)
    gc.unfreeze()
    # the timed wrappers close over ``opt``'s own methods: drop them, or the
    # cycle keeps this run's captures alive until a full collection
    del opt.update, opt.update_staged
    traced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        out = Path(trace)
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
        traced = {"file": str(out),
                  "steps": trace_summary(prof, steps)}

    tag = f"{variant}/{mode}/{pipeline}/accum {accum_steps}" + (
        "" if mesh is None else " on the mesh")
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
            "launches_by_step": launches, "allocator_by_step": allocator,
            "gc_by_step": collector,
            "trace": traced,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_updates": first, "first_grads": first_grads,
            "final_params": {p: v.detach().to("cpu") for p, v in
                             tree.flatten(state.params)} if capture else {},
            "plan": plan, "cfg": cfg, "data": dcfg,
            "state": state if keep_state else None}


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
          "allocator_by_step": run["allocator_by_step"],
          "gc_by_step": run["gc_by_step"],
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


# ---------------------------------------------------------------- pipeline

def microbatch_grads(torch, cfg, params, dcfg, parts: int) -> list:
    """The first step's gradients (``params``, batch 0) of each of
    ``parts`` microbatches, split as ``make_train_step`` splits them,
    as {path: tensor} dicts."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.train.step import make_loss_fn
    paths, leaves = zip(*tree.flatten(params))
    batch = batch_for_step(dcfg, 0, device="cuda")
    loss_fn = make_loss_fn(cfg)
    out = []
    for i in range(parts):
        mb = {k: v.reshape((parts, -1) + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        out.append(dict(zip(paths, torch.autograd.grad(loss_fn(params, mb),
                                                       leaves))))
    return out


def phase_pipeline(torch, fused=None) -> None:
    """The bucketed schedule on one card (no mesh), full-width smollm-360m:

    1. 3 training steps each with ``pipeline="bucketed"``, with fused and
       ``accum_steps=2``, and bucketed with prestaging forced on at
       ``accum_steps=2`` (7 / 35 / 84 launches a step asserted by
       ``train_run``), timed beside the train phase's fused run.
    2. One update from the same full-width first-step gradients with
       bucketed and with fused: bitwise equal, updates and momentum.
    3. Two saved microbatch gradients accumulated unstaged (sum, 1/2,
       ``opt.update``) and prestaged (``stage_in_all`` per microbatch, sum,
       1/2, ``opt.update_staged``): bitwise equal."""
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.core.pipeline import BucketPipeline, wait_all
    from repro_torch.models import transformer

    base = None if fused is None else {
        k: fused[k] for k in ("step_ms", "optimizer_ms", "peak_mem_gb")}
    for name, kw in [("bucketed", dict(pipeline="bucketed")),
                     ("fused_accum2", dict(accum_steps=2)),
                     ("bucketed_prestaged_accum2",
                      dict(pipeline="bucketed", accum_steps=2,
                           prestage=True))]:
        torch.cuda.empty_cache()
        run = train_run(torch, "muon", **kw)
        emit({"phase": "pipeline", "run": name, **kw,
              "loss_ema": run["loss_ema"], "step_ms": run["step_ms"],
              "optimizer_ms": run["optimizer_ms"],
              "peak_mem_gb": run["peak_mem_gb"],
              "gc_by_step": run["gc_by_step"],
              "launches_per_step": {k: v // TRAIN_STEPS
                                    for k, v in run["launches"].items()},
              "train_phase_fused": base})
        plan, cfg, dcfg = run["plan"], run["cfg"], run["data"]
        del run
    torch.cuda.empty_cache()

    params = transformer.init(cfg, seed=0, device="cuda")
    params = tree.tree_map(lambda v: v.requires_grad_(True), params)
    g0, g1 = microbatch_grads(torch, cfg, params, dcfg, 2)
    full = microbatch_grads(torch, cfg, params, dcfg, 1)[0]
    params = tree.tree_map(lambda v: v.detach(), params)

    def muon(pipeline):
        return api.Muon(plan, config=MuonConfig(
            variant="muon", mode="owner", pipeline=pipeline,
            ns=GramNSConfig(use_kernels=True)), device="cuda")

    def flat(t):
        return dict(tree.flatten(t))

    opt_f, opt_b = muon("fused"), muon("bucketed")
    grads = tree.rebuild(params, full)
    u_f, s_f = opt_f.update(grads, opt_f.init(params), params)
    u_b, s_b = opt_b.update(grads, opt_b.init(params), params)
    d, top, same = max_diff(flat(u_b), flat(u_f))
    same_mom = all(torch.equal(s_b.momentum[k], v)
                   for k, v in s_f.momentum.items())
    del u_f, u_b, s_f, s_b, grads, full

    # accumulation: unstaged (the train step's sum) and prestaged
    acc = {p: torch.zeros_like(v, dtype=torch.float32) for p, v in g0.items()}
    for g in (g0, g1):
        for p, v in g.items():
            acc[p] += v.float()
    u_un, s_un = opt_b.update(tree.rebuild(params, {
        p: v * 0.5 for p, v in acc.items()}), opt_b.init(params), params)
    del acc
    pipe = BucketPipeline(plan, opt_b.config, None, opt_b.variant,
                          device="cuda")
    staged = pipe.zeros_staged(torch.float32)
    rest = {p: torch.zeros_like(v, dtype=torch.float32) for p, v in
            g0.items() if p not in plan.leaves}
    for g in (g0, g1):
        for k, v in wait_all(pipe.stage_in_all(
                {p: v for p, v in g.items() if p in plan.leaves},
                dtype=torch.float32)).items():
            staged[k] += v
        for p in rest:
            rest[p] += g[p].float()
    u_st, s_st = opt_b.update_staged(
        {k: v * 0.5 for k, v in staged.items()},
        {p: v * 0.5 for p, v in rest.items()}, opt_b.init(params), params)
    d_st, _, same_st = max_diff(flat(u_st), flat(u_un))
    same_st_mom = all(torch.equal(s_st.momentum[k], v)
                      for k, v in s_un.momentum.items())
    emit({"phase": "pipeline", "check": "bitwise",
          "bucketed_vs_fused": {"bitwise": same, "momentum_bitwise":
                                same_mom, "max_abs_diff": d,
                                "max_abs_update": top},
          "prestaged_vs_unstaged_accum2": {
              "bitwise": same_st, "momentum_bitwise": same_st_mom,
              "max_abs_diff": d_st}})
    if not (same and same_mom and same_st and same_st_mom):
        raise AssertionError(
            f"bucketed vs fused {d:.3e} (momentum {same_mom}), prestaged vs "
            f"unstaged {d_st:.3e} (momentum {same_st_mom}): not bitwise")


# -------------------------------------------------------------- resilience

RESILIENCE_DRILL = ("slow@4:r3x4.0; unslow@10:r3; kill@12:r1; readd@16; "
                    "preempt@22")
RESILIENCE_STEPS = 24
RESILIENCE_OWNERS = 4
RESILIENCE_RUN = dict(ckpt_every=8, window=4, cooldown=4, threshold=1.3)
RESILIENCE_KEEP = 2
# steps 0..21, then 16..23 again from the step-16 checkpoint
RESILIENCE_EXECUTED = 30
RESILIENCE_RESUMED = 16
# the launcher: 3 steps with a checkpoint, resumed to 6, against 6 straight
LAUNCHER_STEPS, LAUNCHER_CKPT_EVERY = 6, 3
LAUNCHER_TIMEOUT_S = 300


def logical_rows(torch, plan, bufs: dict) -> dict:
    """{group: the logical (count, m, n) rows of an owner-major buffer}."""
    from repro_torch.core.owner_comms import group_key_str
    return {group_key_str(k): bufs[group_key_str(k)].index_select(
        0, torch.as_tensor(g.unpack_index, device=bufs[group_key_str(k)].device))
        for k, g in plan.groups.items()}


def tree_nbytes(torch, t) -> int:
    """Bytes of every tensor and array leaf of a checkpoint tree."""
    import numpy as np
    out = 0
    stack = [t]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, tuple):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            out += node.numel() * node.element_size()
        elif isinstance(node, np.ndarray):
            out += node.nbytes
    return out


def resilient_loop(torch, faults, ckpt_dir, launches: list, events: dict):
    """A ``ResilientLoop`` at full width (seed 0, batch 8 x 512, muon,
    ``RESILIENCE_OWNERS`` owners in this process, kernels on) whose step
    function records each step's kernel launches into ``launches``
    (counters set to 0 just before the step and read just after), and
    whose restores and ``reshard_owner_state`` calls are timed into
    ``events`` (synchronised host clock)."""
    from repro_torch import configs
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.runtime.resilient import ResilientConfig, ResilientLoop

    class Counted(ResilientLoop):
        def _install(self, plan):
            super()._install(plan)
            step_fn = self.step_fn

            def counted(state, batch):
                reset_launches()
                out = step_fn(state, batch)
                launches.append(dict(LAUNCHES))
                return out
            self.step_fn = counted

        def _restore_from_checkpoint(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events["context"] = "restore"
            try:
                return super()._restore_from_checkpoint()
            finally:
                events["context"] = "live"
                torch.cuda.synchronize()
                events["restore_ms"].append(
                    (time.perf_counter() - t0) * 1e3)

    cfg = configs.get("smollm-360m")
    return Counted(
        cfg, DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8),
        muon=MuonConfig(variant="muon", ns=GramNSConfig(use_kernels=True)),
        run=ResilientConfig(steps=RESILIENCE_STEPS, **(
            RESILIENCE_RUN if ckpt_dir else {})),
        num_owners=RESILIENCE_OWNERS,
        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
        ckpt_keep=RESILIENCE_KEEP, faults=faults, device="cuda")


def timed_reshard(torch, events: dict):
    """Wrap ``api.reshard_owner_state`` (looked up at each call by the
    loop) to time each call into ``events['reshards']``; returns the
    original to put back."""
    from repro_torch.core import api
    inner = api.reshard_owner_state

    def reshard(state, old_plan, new_plan, mesh=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(state, old_plan, new_plan, mesh)
        torch.cuda.synchronize()
        events["reshards"].append({
            "context": events["context"],
            "owners": [old_plan.num_owners, new_plan.num_owners],
            "ms": (time.perf_counter() - t0) * 1e3})
        return out
    api.reshard_owner_state = reshard
    return inner


def phase_resilience(torch, smi: str) -> None:
    """The resilient loop at full width on one card, then the launcher.

    1. The drill ``RESILIENCE_DRILL`` over ``RESILIENCE_STEPS`` steps with a
       checkpoint every 8 into a fresh directory under the ignored
       ``build/`` (``keep=2``; deleted at the end; the free disk checked
       first against three checkpoints): 30 executed steps, at least one
       rebalance (its makespans printed, not gated: they rest on
       wall-clock speeds), one kill, readd and preempt each, the preempt
       resuming the step-16 checkpoint written at 3 owners (so the restore
       goes through ``reshard_owner_state``), 7 / 35 / 84 launches in every
       executed step.  Parameters, loss curve and logical momentum rows
       bitwise equal to an unfaulted ``RESILIENCE_STEPS``-step run.
       Printed: each save's synchronous snapshot and asynchronous write,
       each restore and reshard, each recovery's latency, the steady step.
    2. ``python -m repro_torch.launch.train --strategy greedy --batch 8
       --seq 512`` as subprocesses: 3 steps with a checkpoint, ``--resume``
       to 6, and 6 straight: the final loss_ema and every parameter's
       float64 sum bitwise equal, 7 / 35 / 84 launches a step."""
    import shutil

    import numpy as np

    from repro_torch.core import api, tree
    from repro_torch.runtime.faults import FaultPlan

    t_phase = time.perf_counter()
    ckpt = ROOT / "build" / "resilience_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    events = {"context": "live", "reshards": [], "restore_ms": []}
    inner = timed_reshard(torch, events)
    try:
        launches: list = []
        loop = resilient_loop(torch, FaultPlan.parse(RESILIENCE_DRILL), ckpt,
                              launches, events)
        nbytes = tree_nbytes(torch, loop._checkpoint_tree())
        free = shutil.disk_usage(ckpt).free
        emit({"phase": "resilience", "check": "disk",
              "checkpoint_bytes": nbytes, "checkpoint_gb": nbytes / 1e9,
              "disk_free_gb": free / 1e9,
              "need_gb": (RESILIENCE_KEEP + 1) * nbytes / 1e9})
        if free < (RESILIENCE_KEEP + 1) * nbytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free under build/, "
                                 f"the drill needs "
                                 f"{(RESILIENCE_KEEP + 1) * nbytes / 1e9:.1f}")
        report = loop.run()
        saves = list(loop.mgr.timings)
        faulted = {"params": {p: v.detach() for p, v in
                              tree.flatten(loop.state.params)},
                   "rows": logical_rows(torch, loop.plan,
                                        loop.state.opt_state.momentum),
                   "losses": report.loss_curve(), "plan": loop.plan}
        del loop
        torch.cuda.empty_cache()
        plain_launches: list = []
        plain = resilient_loop(torch, None, None, plain_launches, events)
        plain_report = plain.run()
    finally:
        api.reshard_owner_state = inner
        shutil.rmtree(ckpt, ignore_errors=True)

    kinds = [r["kind"] for r in report.recoveries]
    preempt = next((r for r in report.recoveries if r["kind"] == "preempt"),
                   {})
    restore_reshards = [r for r in events["reshards"]
                        if r["context"] == "restore"]
    params_same = all(torch.equal(v, dict(tree.flatten(
        plain.state.params))[p]) for p, v in faulted["params"].items())
    plain_rows = logical_rows(torch, plain.plan,
                              plain.state.opt_state.momentum)
    rows_same = faulted["rows"].keys() == plain_rows.keys() and all(
        torch.equal(v, plain_rows[k]) for k, v in faulted["rows"].items())
    losses_same = faulted["losses"] == plain_report.loss_curve()
    want = dict(LAUNCHES_PER_STEP)
    bad_launches = [i for i, d in enumerate(launches) if d != want]
    bad_plain = [i for i, d in enumerate(plain_launches) if d != want]
    emit({"phase": "resilience", "check": "drill", "nvidia_smi": smi,
          "drill": RESILIENCE_DRILL, "steps": report.steps,
          "executed_steps": report.executed_steps,
          "recoveries": [{**r, "latency_ms": r["latency_s"] * 1e3}
                         for r in report.recoveries],
          "rebalances": [{**r, "latency_ms": r["latency_s"] * 1e3}
                         for r in report.rebalances],
          "checkpoints": report.checkpoints,
          "saves": [{"step": t["step"],
                     "snapshot_ms": t["snapshot_s"] * 1e3,
                     "write_ms": t.get("write_s", float("nan")) * 1e3}
                    for t in saves],
          "restore_ms": events["restore_ms"],
          "reshards": events["reshards"],
          "launches_per_step": launches,
          "steady_step_ms": float(np.median(report.step_times[1:]) * 1e3),
          "plain_steady_step_ms": float(
              np.median(plain_report.step_times[1:]) * 1e3),
          "step_ms": [t * 1e3 for t in report.step_times],
          "losses": faulted["losses"],
          "bitwise": {"params": params_same, "momentum_rows": rows_same,
                      "loss_curve": losses_same}})
    failures = []
    if report.steps != RESILIENCE_STEPS or \
            report.executed_steps != RESILIENCE_EXECUTED:
        failures.append(f"steps {report.steps}, executed "
                        f"{report.executed_steps}")
    if not report.rebalances:
        failures.append("no rebalance")
    if sorted(kinds) != ["kill", "preempt", "readd"]:
        failures.append(f"recoveries {kinds}")
    if preempt.get("resumed_step") != RESILIENCE_RESUMED:
        failures.append(f"preempt resumed at {preempt.get('resumed_step')}")
    if [r["owners"] for r in restore_reshards] != [[3, RESILIENCE_OWNERS]]:
        failures.append(f"restore reshards {restore_reshards}")
    if bad_launches or bad_plain or \
            len(launches) != RESILIENCE_EXECUTED:
        failures.append(f"launches off {want} at executed steps "
                        f"{bad_launches} (drill), {bad_plain} (plain)")
    if not (params_same and rows_same and losses_same):
        failures.append(f"drill not bitwise the unfaulted run: params "
                        f"{params_same}, momentum rows {rows_same}, loss "
                        f"curve {losses_same}")
    del faulted, plain, plain_rows
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("resilience drill: " + "; ".join(failures))
    launcher_restart(torch, smi)
    emit({"phase": "resilience", "check": "seconds",
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})


def launcher_run(args: list, tag: str) -> dict:
    """One ``python -m repro_torch.launch.train`` subprocess at full width
    on the card; its ``[result]`` line and its seconds."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--strategy",
           "greedy", "--batch", "8", "--seq", "512", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                         text=True, timeout=LAUNCHER_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"launcher {tag} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = out.stdout.strip().splitlines()[-1]
    if not line.startswith("[result] "):
        raise AssertionError(f"launcher {tag}: no result line:\n"
                             f"{out.stdout[-3000:]}")
    return {**json.loads(line[len("[result] "):]), "seconds": seconds}


def launcher_restart(torch, smi: str) -> None:
    """The launcher stopped after a checkpoint and resumed, against the same
    steps in one run: bitwise (loss_ema, every parameter's float64 sum)."""
    import shutil
    ckpt = ROOT / "build" / "launcher_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        first = launcher_run(["--steps", str(LAUNCHER_CKPT_EVERY),
                              "--ckpt-dir", str(ckpt), "--ckpt-every",
                              str(LAUNCHER_CKPT_EVERY)], "first")
        # resumed with no checkpoint due before its end (a save costs ≈ 4 s)
        resumed = launcher_run(["--steps", str(LAUNCHER_STEPS), "--resume",
                                "--ckpt-dir", str(ckpt), "--ckpt-every",
                                str(LAUNCHER_STEPS + 1)], "resumed")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    straight = launcher_run(["--steps", str(LAUNCHER_STEPS)], "straight")
    runs = {"first": first, "resumed": resumed, "straight": straight}
    emit({"phase": "resilience", "check": "launcher", "nvidia_smi": smi,
          "runs": {k: {f: r[f] for f in ("steps", "executed_steps",
                                         "loss_ema", "launches", "seconds")}
                   for k, r in runs.items()},
          "bitwise": {"loss_ema": resumed["loss_ema"] == straight["loss_ema"],
                      "param_sums": resumed["param_sums"]
                      == straight["param_sums"]}})
    for k, r in runs.items():
        want = {n: v * r["executed_steps"] for n, v in
                LAUNCHES_PER_STEP.items()}
        if r["launches"] != want:
            raise AssertionError(f"launcher {k}: launches {r['launches']}, "
                                 f"expected {want}")
    if resumed["executed_steps"] != LAUNCHER_STEPS - LAUNCHER_CKPT_EVERY:
        raise AssertionError(f"resumed run executed "
                             f"{resumed['executed_steps']} steps")
    if resumed["loss_ema"] != straight["loss_ema"] or \
            resumed["param_sums"] != straight["param_sums"]:
        raise AssertionError("the resumed launcher run is not bitwise the "
                             "straight one")


# -------------------------------------------------------------------- mesh

MESH_TIMEOUT_S = 180           # every NCCL collective of the phase
MESH_STEPS = 5                 # training steps of each mesh-phase run
# (name, variant, mode, train_run keywords) of the mesh phase's training
MESH_RUNS = [("owner", "muon", "owner", {}),
             ("owner_bucketed", "muon", "owner", {"pipeline": "bucketed"}),
             ("owner_accum2", "muon", "owner", {"accum_steps": 2}),
             ("owner_bucketed_prestaged_accum2", "muon", "owner",
              {"pipeline": "bucketed", "accum_steps": 2, "prestage": True}),
             ("owner_bucketed_prestaged_accum2_sync", "muon", "owner",
              {"pipeline": "bucketed", "accum_steps": 2, "prestage": True,
               "knobs": {"pipeline_barriers": False}}),
             ("gather", "muon", "gather", {}),
             ("adamw", "adamw", "owner", {})]
# (run, reference run) pairs of ``pipeline_pairs``, and its gates (the gloo
# test's loss_ema gate; its parameter gate is printed)
PIPELINE_PAIRS = [("owner_bucketed", "owner"),
                  ("owner_bucketed_prestaged_accum2",
                   "owner_bucketed_prestaged_accum2_sync"),
                  ("owner_bucketed_prestaged_accum2", "owner_accum2")]
PIPELINE_PAIRS_RUNS = {r for pair in PIPELINE_PAIRS for r in pair}
PAIR_LOSS_ATOL, PAIR_PARAM_ATOL = 1e-5, 5e-5
SAME_GRADIENT_GATE = 1e-6      # max|Δ| of one update, absolute
LOSS_GATE = 1e-5               # relative, per step's loss_ema
STEP_UPDATE_GATE = 1e-4        # AdamW leaves' floor: 1e-4 · max|update|
STEP_SPREAD = 10               # Muon leaves: 10x the one-ulp spread
STEP_FAULT = 10                # a planted fault misses the step gate 10x


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


def phase_mesh(torch, train_losses, trace: dict | None = None) -> None:
    """Every visible card, one NCCL rank each (spawned processes that load
    the kernels the parent built).  A rank that fails fails the run."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    mp.start_processes(mesh_rank, args=(world, free_port(), train_losses,
                                        trace),
                       nprocs=world, start_method="spawn", join=True)


def mesh_rank(rank: int, world: int, port: int, train_losses,
              trace: dict | None) -> None:
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
    mesh_checks(torch, dist, rank, world, train_losses, trace)
    dist.destroy_process_group()


def mesh_checks(torch, dist, rank: int, world: int, train_losses,
                trace: dict | None = None) -> None:
    """The ``mesh`` phase on one rank: a ("data", "model") = (world, 1) mesh
    (the owners are the ranks, the batch split over them).

    1. One Muon update from the same full-width gradients (replicated,
       from a seed) with the mesh and without it: bitwise at world 1 (the
       collectives of one rank are copies), max|Δ| <= 1e-6 otherwise.
    2. The same gradients placed by ``param_specs`` on a (1, world) mesh,
       so the owner transposes are NCCL all-to-alls: max|Δ| <= 1e-6 against
       the update of 1.  On both meshes the bucketed pipeline's update
       (its collectives overlapped on more than one rank) equals the fused
       one bitwise on every rank.
    3. Full-width smollm-360m trained ``MESH_STEPS`` steps under the mesh
       by each of ``MESH_RUNS`` (owner mode: 7 / 35 / 84 launches a step on
       every rank), timed on every rank; ``pipeline_pairs``: on every rank
       bucketed equals fused and prestaged equals its run without overlap
       bitwise, and prestaged is within rounding of unstaged.
    4. On rank 0 alone, the same Muon training on one card, of the whole
       batch and of the same batch in ``world`` microbatches, the step
       gate, and the prestaged run's step-1 Muon updates against the
       one-ulp spread (``train_vs_single``)."""
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

    def update(m, params, grads, pipeline="fused"):
        opt = api.Muon(api.dedicate_params(shapes, mesh=m), m,
                       config=dataclasses.replace(mcfg, pipeline=pipeline),
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
    tp_params = sharding.place(params, specs, tp)
    tp_grads = sharding.place(grads, specs, tp)
    u_tp = update(tp, tp_params, tp_grads)
    d_tp, _, same_tp = max_diff(u_tp, u_mesh)
    # the bucketed pipeline on both meshes, against the fused update
    bucketed = {"mesh": max_diff(update(mesh, params, grads, "bucketed"),
                                 u_mesh),
                "param_specs": max_diff(update(tp, tp_params, tp_grads,
                                               "bucketed"), u_tp)}
    bucketed_ok = [None] * world
    dist.all_gather_object(bucketed_ok, {k: v[2] for k, v in
                                         bucketed.items()})
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
        emit({"phase": "mesh", "check": "same_gradient_bucketed_vs_fused",
              "world": world, "bitwise_by_rank": bucketed_ok,
              "max_abs_diff": {k: v[0] for k, v in bucketed.items()}})
        batch_invariance(torch, 32 // world if world > 1 else 8)
    if world == 1 and not same:
        raise AssertionError(f"mesh of one: update differs by {d:.3e}")
    for what, diff in [("mesh", d), ("param_specs", d_tp)]:
        if diff > SAME_GRADIENT_GATE:
            raise AssertionError(f"{what} update differs by {diff:.3e} > "
                                 f"{SAME_GRADIENT_GATE}")
    if not all(all(r.values()) for r in bucketed_ok):
        raise AssertionError(f"bucketed update is not the fused one bitwise "
                             f"on every rank: {bucketed_ok}")
    del u_one, u_mesh, u_tp, params, grads, tp_params, tp_grads

    # 3: training under the mesh, every rank timed
    runs = {}
    for name, variant, mode, kw in MESH_RUNS:
        owner = name == "owner"
        run = train_run(torch, variant, mode, mesh,
                        capture=True if owner else
                        "host" if name in PIPELINE_PAIRS_RUNS else False,
                        grads=owner, keep_state=owner,
                        trace=(trace or {}).get(name) if lead else None,
                        steps=MESH_STEPS, **kw)
        if owner:
            mesh_checkpoint(torch, dist, run.pop("state"), run["plan"], mesh,
                            rank, world, shapes)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches",
                                      "allocator_by_step", "gc_by_step",
                                      "trace")}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, timing)
        if not lead:
            run.pop("first_grads")
        runs[name] = run
        if lead:
            emit({"phase": "mesh", "mode": name, **kw, "world": world,
                  "mesh": [world, 1], "loss_ema": run["loss_ema"],
                  "launches_per_step": {k: v // MESH_STEPS for k, v in
                                        run["launches"].items()},
                  "per_rank": per_rank})
        torch.cuda.empty_cache()
    matrices = set(api.dedicate_params(shapes).leaves)
    pairs = pipeline_pairs(torch, dist, runs, rank, world, matrices)

    # 4: the one-card references of step 1 (rank 0): the whole batch in
    # one step, and the same batch in ``world`` microbatches, microbatch r
    # being rank r's rows (checked on every rank first)
    split_ok = [None] * world
    dist.all_gather_object(split_ok, microbatch_is_rank_rows(
        torch, runs["owner"]["data"], mesh, world, rank))
    failure = None
    if lead:
        if not all(split_ok):
            failure = f"microbatch r is not rank r's rows: {split_ok}"
        else:
            single = train_run(torch, "muon", "owner", capture=True,
                               steps=MESH_STEPS)
            torch.cuda.empty_cache()
            accum = train_run(torch, "muon", "owner", capture=True,
                              grads=True, accum_steps=world,
                              steps=MESH_STEPS)
            torch.cuda.empty_cache()
            failure = train_vs_single(torch, runs, single, accum, world,
                                      train_losses, matrices, pairs)
    failures = [None] * world
    dist.all_gather_object(failures, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])


def mesh_checkpoint(torch, dist, state, plan, mesh, rank: int, world: int,
                    shapes) -> None:
    """Every rank saves the owner run's last state with the checkpoint
    manager (its owner rows as row blocks, rank 0 the replicated leaves),
    after an all-gather of every rank's momentum rows; rank 0 restores the
    checkpoint in one process onto a plan of ``world`` owners, whose
    logical momentum rows must be bitwise those of the all-gather."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager, RowBlocks
    from repro_torch.core import api
    from repro_torch.core.owner_comms import OwnerLayout
    from repro_torch.runtime.resilient import OWNER_PREFIXES

    d = ROOT / "build" / "mesh_ckpt"
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    dist.barrier()
    layout = OwnerLayout(plan, mesh)
    gathered = {k: layout.gather_rows(v)
                for k, v in state.opt_state.momentum.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(str(d), keep=1).save(
        state.step, {"train": state._asdict(),
                     "meta": {"num_owners": np.asarray(world, np.int64)}},
        block=True, row_blocks=RowBlocks(OWNER_PREFIXES,
                                         layout.owner_index(), world))
    save_ms = (time.perf_counter() - t0) * 1e3
    failure = None
    if rank == 0:
        t0 = time.perf_counter()
        restored = CheckpointManager(str(d)).restore(device="cuda")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        one = api.dedicate_params(shapes, num_owners=world,
                                  strategy="greedy")
        got = logical_rows(torch, one,
                           restored["train"]["opt_state"].momentum)
        want = logical_rows(torch, plan, gathered)
        same = got.keys() == want.keys() and all(
            torch.equal(got[k], v) for k, v in want.items())
        emit({"phase": "mesh", "check": "checkpoint", "world": world,
              "step": restored["train"]["step"], "save_ms": save_ms,
              "restore_one_process_ms": restore_ms,
              "momentum_rows_bitwise": same})
        del restored, got, want
        shutil.rmtree(d, ignore_errors=True)
        if not same:
            failure = ("the checkpoint restored in one process differs from "
                       "the all-gathered momentum rows")
    del gathered
    failures = [None] * world
    dist.all_gather_object(failures, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])


def pipeline_pairs(torch, dist, runs: dict, rank: int, world: int,
                   matrices: set) -> dict:
    """Every rank: the schedules that must not change a bit, and the
    prestaged accumulation that changes rounding only.

    * bucketed against fused, and prestaged with its collectives
      overlapped against the same prestaged run with every move waited as
      it is issued (``pipeline_barriers=False``): the same collectives on
      the same data, so each step's loss_ema, this rank's first updates and
      the last parameters must be bitwise equal.  A missing stream wait or
      a buffer freed in flight would change values here.
    * prestaged against unstaged at ``accum_steps=2`` ("reduce-scatter each
      microbatch, then sum" against "sum, then reduce-scatter"): bitwise
      at world 1 (no collective runs); on more ranks each step's loss_ema
      within ``PAIR_LOSS_ATOL``, the first updates of the AdamW leaves
      (reduced the same way on both sides) bitwise, and the Muon leaves'
      largest first-update difference returned for ``train_vs_single`` to
      hold against the one-ulp spread.  The last parameters' difference
      is printed per leaf beside ``PAIR_PARAM_ATOL``, the gloo test's gate
      on a reduced model after 2 steps, and is not a gate: at full width
      five steps magnify the step-1 rounding difference past it.
    Rank 0 prints every rank's rows; a miss on any rank fails the run."""
    host = {"owner": {p: v.to("cpu") for p, v in
                      runs["owner"]["first_updates"].items()}}
    rows = {}
    for name, ref in PIPELINE_PAIRS:
        a, b = runs[name], runs[ref]
        upd = leaf_diffs(a["first_updates"],
                         host.get(ref, b["first_updates"]))
        par = leaf_diffs(a["final_params"], b["final_params"])
        loss = max(abs(x - y) for x, y in zip(a["loss_ema"], b["loss_ema"]))
        bitwise = (a["loss_ema"] == b["loss_ema"]
                   and all(r[2] for r in upd.values())
                   and all(r[2] for r in par.values()))
        row = {"bitwise": bitwise, "loss_ema_max_abs_diff": loss,
               "first_update_max_abs_diff": max(r[0] for r in upd.values()),
               "param_max_abs_diff": max(r[0] for r in par.values())}
        if ref == "owner_accum2" and world > 1:
            row["ok"] = loss <= PAIR_LOSS_ATOL and all(
                r[2] for p, r in upd.items() if p not in matrices)
            row["muon_first_update_max_abs_diff"] = max(
                r[0] for p, r in upd.items() if p in matrices)
            row["param_max_abs_diff_by_leaf"] = {p: r[0]
                                                 for p, r in par.items()}
        else:
            row["ok"] = bitwise
        rows[f"{name}_vs_{ref}"] = row
    for name in PIPELINE_PAIRS_RUNS:
        runs[name]["final_params"] = {}
        if name != "owner":
            runs[name]["first_updates"] = {}
    per_rank = [None] * world
    dist.all_gather_object(per_rank, rows)
    if rank == 0:
        emit({"phase": "mesh", "check": "pipeline_pairs", "world": world,
              "loss_atol": PAIR_LOSS_ATOL,
              "param_atol_printed": PAIR_PARAM_ATOL, "per_rank": per_rank})
    missed = [(r, k) for r, rr in enumerate(per_rank)
              for k, v in rr.items() if not v["ok"]]
    if missed:
        raise AssertionError(f"pipeline pairs missed (rank, pair): {missed}")
    return rows


def microbatch_is_rank_rows(torch, dcfg, mesh, world: int, rank: int
                            ) -> bool:
    """Microbatch ``rank`` of ``world`` of batch 0, as ``make_train_step``
    splits it, equals this rank's rows from ``batch_for_step(mesh=)``."""
    from repro_torch.data.pipeline import batch_for_step
    whole = batch_for_step(dcfg, 0, device="cuda")
    mine = batch_for_step(dcfg, 0, device="cuda", mesh=mesh)
    return all(torch.equal(v.reshape((world, -1) + tuple(v.shape[1:]))[rank],
                           mine[k]) for k, v in whole.items())


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


def step_gate(torch, mesh_g: dict, ref_g: dict, abs_sum: dict,
              mesh_u: dict, ref_u: dict, spread: float, matrices: set,
              world: int) -> dict:
    """Step 1 of the ``world``-rank training against one card running the
    same batch as ``world`` microbatches (microbatch r = rank r's rows), on
    the same seed-0 parameters.  Three ratios, each at most 1 to pass:

    * gradients: each entry of the averaged gradient within what reordering
      a sum of ``world`` fp32 terms can change, (world − 1) · eps ·
      Σ_r |g_r| / world (eps = 2⁻²³; ``abs_sum`` is Σ_r |g_r|): both sides
      add the same per-rank gradients, in another order;
    * Muon leaves: max|Δ update| within ``STEP_SPREAD`` times ``spread``,
      what one ulp on half the one-card gradients moves the one-card update;
    * AdamW leaves: each entry within 1e-4 · max|update| plus what its
      gradient's relative difference rho explains, min(2·rho, 2) ·
      max(|u|, |u_ref|) (AdamW's first step maps g to about −lr · sign(g),
      so at most a sign flip where |g| is at rounding size).

    Returns the ratios, ``factor`` (their largest) and per-leaf rows."""
    eps = 2.0 ** -23
    rows, ratios = {}, {"grad": 0.0, "muon": 0.0, "adamw": 0.0}

    def ratio(d, bound):
        r = torch.where(d == 0, torch.zeros_like(d), d / bound)
        return float(r.max()) if r.numel() else 0.0

    top_adamw = max((float(ref_u[p].float().abs().max()) for p in ref_u
                     if p not in matrices), default=0.0)
    d_muon = 0.0
    for p, gr in ref_g.items():
        gr, gm = gr.float(), mesh_g[p].float()
        dg = (gm - gr).abs()
        g_ratio = ratio(dg, (world - 1) * eps * abs_sum[p].float() / world)
        ur, um = ref_u[p].float(), mesh_u[p].float()
        du = (um - ur).abs()
        row = {"grad_max_abs_diff": float(dg.max()),
               "grad_ulps_of_max": float(dg.max()) / (
                   float(gr.abs().max()) * eps or 1.0),
               "grad_ratio": g_ratio, "update_max_abs_diff": float(du.max()),
               "max_abs_update": float(ur.abs().max()),
               "rule": "muon" if p in matrices else "adamw"}
        ratios["grad"] = max(ratios["grad"], g_ratio)
        if p in matrices:
            d_muon = max(d_muon, float(du.max()))
        else:
            rho = torch.where(dg == 0, torch.zeros_like(dg),
                              dg / gr.abs())
            bound = STEP_UPDATE_GATE * top_adamw + torch.clamp(
                2 * rho, max=2.0) * torch.maximum(um.abs(), ur.abs())
            row["adamw_ratio"] = ratio(du, bound)
            ratios["adamw"] = max(ratios["adamw"], row["adamw_ratio"])
        rows[p] = row
    ratios["muon"] = 0.0 if d_muon == 0 else d_muon / (STEP_SPREAD * spread)
    return {"ratios": ratios, "factor": max(ratios.values()),
            "muon_max_abs_diff": d_muon, "spread": spread,
            "spread_factor": STEP_SPREAD, "adamw_floor": STEP_UPDATE_GATE,
            "per_leaf": rows}


def train_vs_single(torch, runs: dict, single: dict, accum: dict,
                    world: int, train_losses, matrices: set, pairs: dict):
    """Rank 0: emit the mesh runs against the same training on one card,
    then the first gate missed (None if none).

    * Losses within 1e-5 relative of the one-card run of the whole batch
      (and of the train phase).
    * Step 1's updates against that run, max|Δ| per leaf beside
      1e-4 · max|update|: printed, not a gate (the batch split changes
      each matmul's batch and the gradient sum's order, and Newton-Schulz
      and AdamW's first step magnify a rounding-size change).
    * The gate (``step_gate``): step 1's averaged gradients and updates
      against the one-card run of the same batch in ``world``
      microbatches.  Two planted faults, the sum where the mean belongs
      and rank 0's gradient dropped, each taken through the one-card
      optimizer, must miss it by ``STEP_FAULT``x (on more than one rank:
      at world 1 the sum is the mean and the gate is vacuous).
    * The prestaged run's step-1 Muon updates (``pairs``, rank 0's
      ``pipeline_pairs`` rows) within ``STEP_SPREAD`` times the same
      one-ulp spread of the unstaged run's, on more than one rank."""
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.models import transformer

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
              for name, r in [*runs.items(), ("single_owner", single),
                              ("single_owner_accum", accum)]}
    emit({"phase": "mesh", "check": "train_vs_single", "world": world,
          "loss_ema_mesh": mesh_loss, "loss_ema_single": single["loss_ema"],
          "loss_ema_single_accum": accum["loss_ema"],
          "train_phase_loss_ema": train_losses, "loss_rel_diff": rel,
          "loss_rel_diff_train_phase": rel_train,
          "run_to_run_rel": None if train_losses is None else
          rel_diff(single["loss_ema"], train_losses),
          "loss_gate": LOSS_GATE, "step1_update_max_abs_diff": d_up,
          "step1_max_abs_update": top_up,
          "update_floor_printed": STEP_UPDATE_GATE,
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

    # the gate: one-card updates of the accumulated run's gradients, their
    # one-ulp spread, and the planted faults
    plan, cfg = accum["plan"], accum["cfg"]
    params = transformer.init(cfg, seed=0, device="cuda")
    opt = api.Muon(plan, config=MuonConfig(
        variant="muon", mode="owner", pipeline="fused",
        ns=GramNSConfig(use_kernels=True)), device="cuda")

    def update(grads: dict) -> dict:
        u, _ = opt.update(tree.rebuild(params, grads), opt.init(params),
                          params)
        return dict(tree.flatten(u))

    ref_g = {p: v[0] for p, v in accum["first_grads"].items()}
    mesh = runs["owner"]["first_grads"]
    mesh_g = {p: v[0] for p, v in mesh.items()}
    abs_sum = {p: v[1] for p, v in mesh.items()}
    ref_u = accum["first_updates"]
    u_base = update(ref_g)
    recomputed_bitwise = max_diff(u_base, ref_u)[2]
    gen = torch.Generator("cuda").manual_seed(11)
    u_ulp = update({p: one_ulp_up(torch, g, gen) for p, g in ref_g.items()})
    spread = max(float((u_ulp[p] - u_base[p]).abs().max()) for p in matrices)
    del u_ulp
    gate = step_gate(torch, mesh_g, ref_g, abs_sum,
                     runs["owner"]["first_updates"], ref_u, spread, matrices,
                     world)
    faults = {}
    for fault, grads in [
            ("sum_for_mean", {p: g * world for p, g in mesh_g.items()}),
            ("rank0_dropped", {p: (g * world - mesh[p][2]) / world
                               for p, g in mesh_g.items()})]:
        fg = step_gate(torch, grads, ref_g, abs_sum, update(grads), ref_u,
                       spread, matrices, world)
        faults[fault] = {"factor": fg["factor"], "ratios": fg["ratios"]}
    prestaged = pairs["owner_bucketed_prestaged_accum2_vs_owner_accum2"]
    d_pre = prestaged.get("muon_first_update_max_abs_diff")
    pre_ratio = None if d_pre is None else d_pre / (STEP_SPREAD * spread)
    emit({"phase": "mesh", "check": "step_gate", "world": world,
          "prestaged_vs_unstaged_muon_ratio": pre_ratio,
          "reference": f"one card, accum_steps={world}",
          "recomputed_update_bitwise": recomputed_bitwise,
          "loss_ema_accum": accum["loss_ema"],
          "fault_factor_required": STEP_FAULT if world > 1 else None,
          **gate, "faults": faults})

    for name, r in [("the same run without the mesh", rel),
                    ("the train phase", rel_train)]:
        if r is not None and r > LOSS_GATE:
            return (f"mesh losses {mesh_loss} vs {name}: {r:.3e} relative "
                    f"> {LOSS_GATE}")
    if gate["factor"] > 1:
        return f"step 1 misses the step gate: ratios {gate['ratios']}"
    if pre_ratio is not None and pre_ratio > 1:
        return (f"prestaged step-1 Muon updates differ by {d_pre:.3e}, "
                f"{pre_ratio:.3f} of {STEP_SPREAD}x the one-ulp spread")
    weak = {f: v["factor"] for f, v in faults.items()
            if v["factor"] < STEP_FAULT}
    if world > 1 and weak:
        return f"planted faults within {STEP_FAULT}x of the gate: {weak}"
    return None


# -------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--trace", default="",
                    help="comma-separated mesh-phase runs (of "
                         + ",".join(r[0] for r in MESH_RUNS) + ") to trace "
                         "with torch.profiler (rank 0)")
    ap.add_argument("--trace-dir", default=str(ROOT / "build" / "traces"),
                    help="where --trace writes its .json.gz files")
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
    train_losses = fused = None
    if "train" in phases:
        run = phase_train(torch, "muon")
        launches, train_losses = run["launches"], run["loss_ema"]
        fused = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                     "peak_mem_gb")}
        del run
    if "adamw" in phases:
        torch.cuda.empty_cache()
        phase_train(torch, "adamw")
    if "variants" in phases:
        phase_variants(torch)
    if "pipeline" in phases:
        phase_pipeline(torch, fused)
    if "resilience" in phases:
        torch.cuda.empty_cache()
        phase_resilience(torch, smi[0])
    if "mesh" in phases:
        world = torch.cuda.device_count()
        phase_mesh(torch, train_losses, {
            t: str(Path(args.trace_dir) / f"trace_{t}_mesh{world}.json.gz")
            for t in args.trace.split(",") if t})

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
