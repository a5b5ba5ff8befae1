#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                    # every phase, one CUDA card
    python3 chip_smoke.py --phases kernels   # a subset (device always runs)

Phases, each printing one JSON line and asserting what it checks:

  device   card name and power limit (nvidia-smi), and the build of every
           kernel in ``src/repro_torch/kernels/csrc`` (one nvcc per source,
           all in parallel, into the ignored ``build/repro_torch/``).
  kernels  each Hopper kernel against its plain PyTorch version on the card
           at the slice's shapes, plus bf16 (``BF16_GATE``: 2^-7 of the
           largest entry off the diagonal and on it apart, against the
           plain version's fp32 product), unaligned (the pad path, fp32
           and bf16: syrk (2, 101, 211), symmul m = 198), a bf16 symmul
           whose B is not symmetric, and block-invariance cases (both
           pairs of each input type), on inputs whose products are O(1)
           so the tolerance is small against every term of each product
           (asserted).  Every fp32 product (3xTF32 on the tensor cores)
           must be within 5e-6 · max|exact| of the exact (float64)
           product, which one TF32 pass misses by >= 10x (asserted on the
           plain emulation of one TF32 product); the plain fp32 version's
           own distance from it is printed beside.
           The syrk's rows are heavy-tailed (cubed Gaussians, unit norm):
           Gaussian rows give G near I, where the contraction averages one
           TF32 pass's rounding away and the gate could not tell it from
           fp32.  Times the kernel, the plain version and one
           ``torch.matmul`` of the same product (a yardstick only, never
           called by the port), beside the tensor-core bound and the bound
           of fp32 FFMA outside them.  Then the bf16 kernels at
           nemotron-4-340b's owner shapes on (2, 2) (``owner_kernels``:
           SYRK (1, 18432, 73728), (1, 18432, 18432), (1, 1536, 18432),
           symmul and gram_poly at m = 18432 and 1536; median of 5), the
           >= 340 B policy's Gram NS, as the four-card zero3 phase
           prints them.
  blocks   every candidate block pair timed at the slice's shapes (the
           autotuner's measured backend), beside the analytical choice;
           the bf16 pairs at nemotron's owner shapes too.
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
  dropin   the same two trainings through the front door,
           ``MuonOptimizer`` (``core/optim.py``), in a plain PyTorch loop
           (``loss.backward(); opt.step(); opt.zero_grad()``): every step's
           loss EMA and the last parameters bitwise the train / adamw
           phase's run, 7 / 84 / 35 launches a step for Muon (none for
           AdamW), step and optimizer ms printed beside the train phase's.
  dryrun   the dry run held against the card on the train phase's
           configuration: one step of it walked on the host under
           ``FakeTensorMode`` by the op walker (``launch/op_walker.py``;
           the kernel wrappers take their plain versions) predicts FLOPs by
           dtype, bytes, the peak of live bytes and the H100 roofline
           terms; 3 steps on the card, timed as the train phase times
           them, measure ``max_memory_allocated`` (launches from the
           plan); one more step walked on the card, with the caching
           allocator's peak inside each op beside the walker's live bytes
           (what the walker cannot see).  Gates: forward + backward FLOPs
           (the step without ``opt.update``) on the card equal the host's
           exactly; the predicted peak within 10% of the measured one.
           Prints step ms, each roofline term, the kernel-adjusted compute
           term, both peaks and the step's share of the roofline time.
           The production cells smollm-360m train_4k (single mesh) and
           deepseek-v3-671b decode_32k (multi) run as
           ``python -m repro_torch.launch.dryrun`` subprocesses started
           with the script (host only: a fake world of fake tensors),
           each gated on ok; HBM utilization and the dominant term
           printed.
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
  moe      DeepSeek-V3 at its published widths (d_model 7168, 128 heads,
           MLA ranks 1536 / 512, qk 128 + 64, v 128, d_expert 2048, top-8,
           1 shared, vocab 129280, bf16), cut to 2 layers and 16 routed
           experts: its 19 Gram kernel shapes (SYRK at the 7 (B, m, n) of
           its 11 groups, symmul and gram_poly at their 6 (B, m, m)) held
           like the kernels phase's, median of 20; the sort-based dispatch
           in fp32 on 64 tokens against a per-token loop (1e-5 of max, at a
           capacity factor that drops nothing; drops at 1.25 printed);
           whether two forward / backward passes agree bitwise (printed);
           the first Muon update of every group with the kernels against
           the plain Gram NS, in fp32, within 10x the plain path's one-ulp
           spread per group, one TF32 pass >= 10x outside; bucketed ==
           fused, bitwise; then 3 Muon steps (owner, fused, one owner,
           11 / 55 / 132 launches asserted per step, from the plan) and 3
           AdamW steps, batch 4 x 1024, remat, seed 0, the optimizer
           releasing each spent state (``donate``), timed with tokens/s and
           peak memory.
  families the hybrid, xLSTM, encoder-decoder and VLM families at their
           published widths, fp32, seed 0 (``FAMILY_RUNS``): hymba-1.5b
           (16 of 32 layers, global layers 0 and 15, batch 2 x 2048, so
           the 1024 window binds on its 14 windowed layers and the
           chunked attention runs),
           xlstm-350m (24 layers, 8 x 512), seamless-m4t-large-v2
           (24 + 24 layers, frames 2 x 4096 x 1024, decoder 2 x 512) and
           llava-next-mistral-7b (4 of 32 layers, the cut stated in its
           config line; patches 2 x 2880 x 1024 + 2 x 512 tokens).  The
           three kernels at every Gram group shape of the four plans
           (m = 100 ... 4096, n up to 14336), held like the moe phase's,
           median of 20; hymba's ``linear_scan`` against the recurrence
           stepped in float64 (h and both gradients) and its chunked
           windowed attention against the unchunked masked softmax;
           xLSTM's mLSTM parallel form and sLSTM loop against float64
           sequential recurrences (each within 1e-5 · max|exact|); hymba's
           first Muon update with the kernels within 2x the plain fp32
           path's RMS distance from the exact one (one TF32 pass >= 10x
           outside), bucketed == fused bitwise; then 3 Muon steps of
           each (owner, fused, one owner, launches from the plan asserted
           per step) and 3 AdamW steps of hymba, with ``donate``, timed
           with tokens/s and peak memory.  ``--trace`` with an arch's name
           traces its Muon steps (device busy and idle share).
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
           rows bitwise those of an all-gather taken in the run.  The
           front door (``MuonOptimizer``, ``grads="partial"``: each rank's
           own backward, no DDP) trains the same steps: every rank's loss
           EMA and parameters bitwise the fused owner run's.

  serve    the contiguous serving tier (``repro_torch.serve``) on
           full-width smollm-360m, fp32 parameters from seed 0, bf16
           cache, 8 slots of 2304 positions, packs of 4, chunks of 1536:
           a warm-up run, then 24 synthetic requests (prompts 128 / 256 /
           512, 16-64 new tokens) plus one 2048-token prompt streamed
           1536 + 512, timed (the summary: tokens/s, TTFT, decode step,
           occupancy; peak GB; no Gram kernel launched); the same queue
           with logits recorded, 4 requests (the chunked one among them)
           replayed alone at the shapes they were served at, bitwise, and
           their batch-1 solo distance printed; prefill's last logits
           against the training forward's and chunked against one-shot
           prefill of the long prompt, within 2e-2 · max|logit|;
           continuous against ``run_oneshot`` on 24 uniform 256-token
           prompts (fewer decode steps, the same tokens).  ``--trace
           serve`` traces 5 decode steps (kernels a step, device idle).
  serve_families
           one model a family at its published widths, bf16 caches, 3
           slots, 6 requests of 4-16 new tokens (``SERVE_FAMILY_RUNS``):
           DeepSeek-V3 (the moe phase's cut), hymba-1.5b (8 layers;
           prompts 1280, past its 1024 window), xlstm-350m (8 layers: 7
           mLSTM, 1 sLSTM), seamless-m4t-large-v2 (12 + 12 layers,
           512-frame prompts) and llava-next-mistral-7b (4 layers, 2880
           patches a request); each served twice with logits recorded
           (bitwise equal), every request replayed at its served shape
           (bitwise; not DeepSeek-V3, whose rows share expert capacity),
           prefill against the training forward; then paged (blocks of
           16, watermark 0): every request bitwise equal to the
           contiguous run of the same schedule, and a drill preempting
           every 2 decode steps that completes (xlstm's preempted requests
           bitwise equal to the unpreempted run); seamless must refuse
           the paged tier; one model freed before the next.
  serve_paged
           the paged tier (``repro_torch.serve.paged``) on the serve
           phase's smollm-360m: (a) its queue contiguous and paged
           (watermark 0, the long prompt streamed into its block table),
           every logit bitwise equal, the same admissions and decode
           steps, both decode-step medians (the gather's cost); (c) the
           paged run with a preemption every 8 decode steps, every
           preempted request replayed at the shapes it was served at
           (each stint: first prefill, the resume's re-prefill) bitwise,
           its distance from (a) up to the first differing greedy token
           printed; (b) equal cache bytes, 2.68 GB of bf16 K / V: 8
           contiguous slots of 8192 positions against 32 paged slots over
           4096 blocks of 16, on 40 chat requests (prompts 256 / 512 /
           1024, 32-64 new tokens) and 8 of 6144 tokens (chunks of 2048,
           128 new): both complete, the same tokens, the paged tier with a
           higher concurrent_mean and fewer decode steps; tokens/s, TTFT,
           decode step, pool occupancy, preemptions and peak GB printed.
           ``--trace serve_paged`` traces 5 decode steps of both (b)
           tiers at full slots.

  tp       the tensor-parallel step (``train/step.py`` under a mesh whose
           'model' axis has every card; one NCCL rank a card, spawned as
           the mesh phase's): first the three kernels at the (B, m, n)
           of one owner's rows of qwen2.5-14b on (1, 4) on this card
           (held and timed as the families phase's); then full-width
           smollm-360m 3 steps on (1, cards), sequence-sharded attention
           (15 heads), launches from the plan; on one card bitwise the
           train phase's run; on four also (2, 2), each mesh's step 1
           loss, gradients and updates and last parameters held to one
           card on the same batches by ``tp_gate`` (10x what one ulp on
           half the parameters moves the one-card run, per leaf).

  tp_qwen  four cards only (on other counts a "skipped" line):
           qwen2.5-14b at its published widths on (1, 4), batch 1 x
           2048, head-parallel: cut to 4 layers, held to one card by
           ``tp_gate``; cut to 44 of 48 layers, 16 Muon and 16 AdamW
           steps with ``donate`` (the mean loss of the last 4 steps
           below the first 4's, launches from the plan, step /
           optimizer ms and peak GB per card beside the dry run's
           predicted peak for the same runs, two ``tp_predict``
           subprocesses started with the script).

  tp_moe   DeepSeek-V3's expert-parallel step (the MoE family under a
           mesh whose 'model' axis has more than one rank: experts, router
           and MLA split by ``param_specs``, the dispatch ranking tokens
           over the data axes), one NCCL rank a card.  (a) the moe phase's
           cut (2 layers, 16 experts, bf16, capacity factor 1.25, batch 4
           x 1024, 3 Muon steps, ``donate``), each step's drops printed:
           on one card on (1, 1), bitwise the moe phase's run (its
           loss_ema and a digest of every parameter's bits); on four on
           (1, 4) and (2, 2), each held to one card's run of the whole
           batch by ``tp_gate``.  (b) four cards only: all 256 routed
           experts (64 a card) on (1, 4), as many layers as the dry run's
           walk (``tp_moe_predict``, eight host subprocesses started with
           the script) predicts within 80 GB a card for Muon and AdamW;
           the three kernels at its owner shapes on card 0 (as ``tp``'s);
           16 Muon and 16 AdamW steps with ``donate``, the loss falling
           (``loss_falls``), launches from the plan, step / optimizer ms,
           peaks within ``PEAK_GATE`` of the prediction.

  zero3    ZeRO-3 (``init_state(..., zero3=True)``, ``grad_specs`` =
           ``param_specs(..., zero3=True)``: the block weights also split
           over 'data', gathered a layer at a time), one NCCL rank a
           card.  One card: full-width smollm-360m 3 steps on (1, 1),
           7 / 84 / 35 launches a step, loss_ema and ``param_digest``
           bitwise the train phase's run.  Four cards: (a) smollm-360m on
           (2, 2) and (4, 1) and the moe phase's DeepSeek-V3 cut on (2, 2)
           (drops printed), each held to one card by ``tp_gate``; (b)
           nemotron-4-340b at its published widths on (2, 2) under the
           reference's >= 340 B policy (bf16 parameters, momentum, packs
           and Gram NS, ``owner_chunk=8``, gradients accumulated in bf16
           over 2 microbatches of 4 x seq), as deep as the dry run's walk
           (``zero3_predict``, eight host subprocesses started with the
           script) puts within 80 GB a card, the sequence cut before the
           width (the vocabulary, halved: at 256000 the two-way split
           embedding and head alone take 66 GB a card, ``NEMO_CUTS``);
           first the three kernels at its owner shapes in bf16 on
           card 0 (against the plain versions by ``BF16_GATE``, timed);
           3 steps,
           finite losses, launches from the plan, the peak within
           ``PEAK_GATE`` of the walk's, beside the walk's peak of the same
           cut without ZeRO-3; step 1 held to a (1, 4) run of the same cut
           without ZeRO-3 by ``tp_gate`` (on a grid of every leaf's
           entries, the first and last 256 and 256 spread over each dim,
           each from the rank that holds it).
  tp_families
           the hybrid, xLSTM, encoder-decoder and VLM families through the
           tensor-parallel step (fp32, remat, the kernels on, 3 Muon
           steps).  One card, in this process: hymba (2 layers, 1 x
           2048), xlstm (8, 4 x 512), seamless (2 + 2, 1 x 512) and llava
           (2, 1 x 512) at their widths on a (1, 1) world, losses and
           ``param_digest`` bitwise the same runs without a mesh.  Four
           cards, one NCCL rank a card: llava cut to 4 layers on (1, 4)
           held to one card by ``tp_gate``; (a) llava at its published
           widths and all 32 layers on (1, 4),
           batch 2 x (2880 patches + 512 tokens): step / optimizer ms,
           tokens / s, launches and the peak a card within ``PEAK_GATE``
           of the walk's (``tp_llava_predict``, a host subprocess started
           with the script) and under 80 GB; (b) hymba (16 layers) and
           xlstm on (1, 4), seamless on (2, 2), each held to one card
           alike; first (c) the three kernels at llava's owner shapes on
           (1, 4), on card 0.
  serve_mesh
           serving under a mesh (``Scheduler(..., mesh=mesh)``, the
           contiguous tier), one NCCL rank a card.  One card: smollm-360m
           at the serve phase's settings on a (1, 1) world, every logit
           and token bitwise the one-card scheduler on the serve queue.
           Four cards (``SERVE_MESH_RUNS``): (a) qwen2.5-14b, all 48
           layers, bf16, 16 slots of 32768 on (1, 4): a 103 GB cache, KV
           heads split (TTFT, decode step, tokens/s, 5 decode steps traced
           on rank 0, the decode peak a card beside the walk's,
           ``serve_mesh_predict``); (b) DeepSeek-V3, 1 layer, 256 experts,
           on (1, 4): MLA's latent by sequence, experts split; (c)
           smollm-360m 32 x 2304 on (2, 2): KV by sequence, slots over
           'data'.  Each mesh run held to rank 0's one-card run of the same
           requests and parameters by ``serve_gate``.

Then a ``{"kernels": [...]}`` summary line (``launches`` is null unless the
train phase ran; ``launches_moe`` / ``launches_families`` those of the moe
and families phases' Muon runs), the nvidia-smi line (the first card's;
the device line lists every card), and last
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
import os
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
SCALED_GATE = 1e-5     # fp32 products against each other: 1e-5 · max|want|
# fp32 products against the exact product (the plain version in float64):
# max err <= 5e-6 · max|exact|.  Against the plain fp32 version the gate
# was 1e-5, which the plain version's own rounding misses at contractions
# past ~16k (2.2e-5 at n = 24576, 2.7e-5 at 32768: PERF.md §6); one
# TF32 pass stays >= 10x outside this one at every shape
EXACT_GATE = 5e-6
# bf16 products (fp32 accumulation, one rounding of the output) against the
# plain version's fp32 product of the same bf16 operands, before its cast:
# max err <= 2^-7 · max|want| over the off-diagonal entries, and over the
# diagonal apart, each at its own scale (twice bf16's unit roundoff).  A
# Gram matrix's diagonal is O(1) and its other entries O(1/sqrt(n)), so a
# gate at the diagonal's scale would pass a kernel that left tiles out
BF16_GATE = 2.0 ** -7

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
# smollm-360m's launches a step (``plan_launches`` of its 7 groups)
LAUNCHES_PER_STEP = {"syrk": 7, "gram_poly": 35, "symmul": 84}
TRAIN_STEPS = 3
PHASES = ("kernels", "blocks", "gram_ns", "train", "adamw", "dropin",
          "dryrun",
          "variants", "pipeline", "resilience", "moe", "families", "serve",
          "serve_families", "serve_paged", "mesh", "tp", "tp_qwen", "tp_moe",
          "zero3", "tp_families", "serve_mesh")
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
    return float((got.double() - want.double()).abs().max())


def rms_err(got, want) -> float:
    """Root mean square of got − want, in float64."""
    return float((got.double() - want.double()).square().mean().sqrt())


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


def check_parts(tag: str, got, want, term, scaled: float) -> dict:
    """``BF16_GATE``'s comparison: max|got − want| <= ``scaled`` ·
    max|want| over the off-diagonal entries and over the diagonal, each
    part at its own scale; and the off-diagonal part of ``term`` (what the
    kernel's product adds there) is at least 10 times its allowance, so a
    kernel that drops it, or maps a tile wrongly, fails.  Returns the
    errors and allowances."""
    import torch
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{tag}: non-finite output")

    def largest(t) -> tuple[float, float]:
        """max|t| (off the diagonal, on it)."""
        t = t.float().abs()
        diag = t.diagonal(dim1=-2, dim2=-1)
        on = float(diag.max())
        diag.zero_()
        return float(t.max()), on
    err_off, err_diag = largest(got.float() - want.float())
    want_off, want_diag = largest(want)
    term_off = largest(term)[0]
    row = {"max_err_offdiag": err_off, "allowance_offdiag": scaled * want_off,
           "max_err_diag": err_diag, "allowance_diag": scaled * want_diag}
    if term_off < 10 * row["allowance_offdiag"]:
        raise AssertionError(f"{tag}: off-diagonal product term "
                             f"{term_off:.3e} is within 10x the allowance "
                             f"{row['allowance_offdiag']:.3e}")
    for part in ("offdiag", "diag"):
        if row[f"max_err_{part}"] > row[f"allowance_{part}"]:
            raise AssertionError(
                f"{tag}: max abs err {row[f'max_err_{part}']:.3e} "
                f"{'off' if part == 'offdiag' else 'on'} the diagonal "
                f"exceeds {scaled} · max|want| there = "
                f"{row[f'allowance_{part}']:.3e}")
    return row


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


def exact_syrk(x):
    """X Xᵀ in float64: the exact product of fp32 inputs, to fp32 output
    precision."""
    xd = x.double()
    return xd @ xd.mT


def exact_symmul(a, b):
    return a.double() @ b.double()


def exact_gram_poly(g, coeffs):
    """a·I + b·G + c·G² in float64."""
    a, b, c = coeffs
    gd = g.double()
    out = c * (gd @ gd) + b * gd
    out.diagonal(dim1=-2, dim2=-1).add_(a)
    return out


def kernel_cases(torch, gen):
    """(kernel name, shape, dtype, tol, kernel fn, plain fn, library fn,
    product term, one-TF32-pass fn or None, exact fn or None) at the
    slice's shapes, plus bf16, unaligned (fp32 and bf16: the pad path)
    and one bf16 symmul whose B is not symmetric (``nonsymmetric_case``).
    The product term is what the kernel's product adds to the output: all
    of it for syrk and symmul, c·G² for gram_poly.  ``tol`` is ``parts``
    (``BF16_GATE``) against the plain version's fp32 product (the exact fn
    of bf16), or ``scaled`` against the exact product for the fp32
    tensor-core products."""
    from repro_torch.core.coefficients import get_coefficients
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_syrk import syrk_plain, syrk_tf32_emulated
    from repro_torch.kernels.symmul import symmul_plain, symmul_tf32_emulated

    coeffs = get_coefficients("polar_express", 5)[0]   # largest: 8.3/-23.6/17.3

    tc32 = dict(scaled=EXACT_GATE)
    bf16 = dict(parts=BF16_GATE)
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
                              ((2, 101, 211), torch.float32, tc32),
                              ((2, 101, 211), torch.bfloat16, bf16)]:
        tc = dtype == torch.float32
        x = (syrk_inputs(torch, gen, *shape) if tc else
             gram_inputs(torch, gen, *shape, dtype, coeffs)[0])
        cases.append(("gram_syrk", shape, dtype, tol,
                      lambda x=x: ops.syrk(x),
                      lambda x=x: syrk_plain(x),
                      lambda x=x: torch.matmul(x, x.mT),
                      lambda x=x: syrk_plain(x),
                      (lambda x=x: syrk_tf32_emulated(x, passes=1))
                      if tc else None,
                      (lambda x=x: exact_syrk(x)) if tc else
                      (lambda x=x: syrk_plain(x, out_dtype=torch.float32))))
    for (b, m), dtype, tol in [((32, 960), torch.float32, tc32),
                               ((32, 320), torch.float32, tc32),
                               ((32, 240), torch.float32, tc32),
                               ((32, 80), torch.float32, tc32),
                               ((8, 320), torch.bfloat16, bf16),
                               ((2, 200), torch.float32, tc32),
                               ((2, 198), torch.float32, tc32),
                               ((2, 198), torch.bfloat16, bf16)]:
        _, g, p = gram_inputs(torch, gen, b, m, 2 * m, dtype, coeffs)
        tc = dtype == torch.float32
        cases.append(("symmul_plain", (b, m, m), dtype, tol,
                      lambda p=p, g=g: ops.symmul(p, g),
                      lambda p=p, g=g: symmul_plain(p, g),
                      lambda p=p, g=g: torch.matmul(p, g),
                      lambda p=p, g=g: symmul_plain(p, g),
                      (lambda p=p, g=g: symmul_tf32_emulated(p, g, passes=1))
                      if tc else None,
                      (lambda p=p, g=g: exact_symmul(p, g)) if tc else
                      (lambda p=p, g=g: symmul_plain(
                          p, g, out_dtype=torch.float32))))
        cases.append(("symmul_gram_poly", (b, m, m), dtype, tol,
                      lambda g=g: ops.gram_poly(g, *coeffs),
                      lambda g=g: symmul_plain(g, g, epilogue="gram_poly",
                                               coeffs=coeffs),
                      lambda g=g: torch.matmul(g, g),
                      lambda g=g: coeffs[2] * symmul_plain(g.float(),
                                                           g.float()),
                      (lambda g=g: symmul_tf32_emulated(
                          g, g, epilogue="gram_poly", coeffs=coeffs,
                          passes=1)) if tc else None,
                      (lambda g=g: exact_gram_poly(g, coeffs)) if tc else
                      (lambda g=g: symmul_plain(
                          g, g, epilogue="gram_poly", coeffs=coeffs,
                          out_dtype=torch.float32))))
    cases.append(nonsymmetric_case(torch, gen, 4, 328))
    return cases


def nonsymmetric_case(torch, gen, b, m):
    """A ``kernel_cases`` tuple of bf16 symmul whose B is not symmetric, so
    A·B differs from A·Bᵀ everywhere (the Gram products' symmetric P and G
    cannot tell them apart): A Gaussian, B Gaussian / sqrt(m), products
    O(1); under ``BF16_GATE``.  A kernel that read B's MN-major slices
    transposed fails it.  m = 328 leaves a ragged last tile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.symmul import symmul_plain
    a = torch.randn(b, m, m, generator=gen, device=gen.device)
    bb = torch.randn(b, m, m, generator=gen, device=gen.device) / math.sqrt(m)
    a, bb = a.to(torch.bfloat16), bb.to(torch.bfloat16)
    return ("symmul_plain", (b, m, m), torch.bfloat16,
            dict(parts=BF16_GATE, b_symmetric=False),
            lambda: ops.symmul(a, bb), lambda: symmul_plain(a, bb),
            lambda: torch.matmul(a, bb), lambda: symmul_plain(a, bb), None,
            lambda: symmul_plain(a, bb, out_dtype=torch.float32))


def check_kernel_case(torch, case, reps: int = 10) -> dict:
    """Hold one ``kernel_cases`` case to the gate its ``tol`` names: the
    fp32 tensor-core products against the exact (float64) product, where
    one TF32 pass must miss the gate by >= 10x, and the plain fp32
    version's own distance is printed beside; bf16 against the plain
    version's fp32 product, by parts (``check_parts``).  Times the kernel, the plain version and the library product
    (median of ``reps``), beside the bounds.  Returns the row."""
    from repro_torch.device import dtype_name
    from repro_torch.kernels import autotune, ref
    name, shape, dtype, tol, kern, plain, lib, term, one_pass, exact = case
    got = kern()
    torch.cuda.synchronize()
    tag = f"{name}{list(shape)} {dtype}"
    row = {}
    if "scaled" in tol:
        want = ref.mirror_lower(plain())
        truth = exact()
        allowance = scaled_allowance(truth, tol["scaled"])
        check_sensitive(tag, term(), truth, 0.0, allowance)
        err = check_scaled(tag, got, truth, tol["scaled"])
        row["plain_err"] = max_abs_err(want, truth)
        row["kernel_vs_plain"] = max_abs_err(got, want)
        row["tf32_one_pass_x_allowance"] = check_rejects_tf32(
            tag, ref.mirror_lower(one_pass()), truth, tol["scaled"])
        want = truth
        del truth
    else:
        want = ref.mirror_lower(exact())
        row = check_parts(tag, got, want, term(), tol["parts"])
        err = max(row["max_err_offdiag"], row["max_err_diag"])
    dt = dtype_name(dtype)
    b_ms, b_by, ffma_ms = bound(name, shape, dt, got.element_size())
    blocks = autotune.lookup(KERNELS[name]["counter"], shape[1], shape[2],
                             dt, arch=autotune.device_arch("cuda"))
    max_want = float(want.float().abs().max())
    del got, want
    return {"kernel": name, "shape": list(shape), "blocks": list(blocks),
            "dtype": dt, "max_err": err, "max_abs_want": max_want,
            **tol, **row,
            "kernel_ms": time_ms(kern, reps), "plain_ms": time_ms(plain, reps),
            "library_ms": time_ms(lib, reps), "reps": reps, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ffma_ms": ffma_ms}


def phase_kernels(torch) -> dict:
    from repro_torch.core.coefficients import get_coefficients
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels.gram_syrk import syrk_plain
    from repro_torch.kernels.symmul import symmul_plain

    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for case in kernel_cases(torch, gen):
        rows.append({"phase": "kernels", **check_kernel_case(torch, case)})
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
    pairs = list(autotune.INSTANTIATED_BLOCKS[4])
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

    # the bf16 pairs, each by parts against the plain version's fp32
    # product (symmul's B not symmetric; m = 328 leaves a ragged tile)
    xb = gram_inputs(torch, gen, 4, 328, 960, torch.bfloat16, coeffs)[0]
    ab = torch.randn(4, 328, 328, generator=gen, device="cuda").to(
        torch.bfloat16)
    bb = xb[..., :328]
    for name, fn, plain in [
            ("gram_syrk", lambda bm, bk: ops.syrk(xb, block_m=bm, block_k=bk),
             lambda: syrk_plain(xb, out_dtype=torch.float32)),
            ("symmul_plain",
             lambda bm, bk: ops.symmul(ab, bb, block_m=bm, block_k=bk),
             lambda: symmul_plain(ab, bb, out_dtype=torch.float32))]:
        want = ref.mirror_lower(plain())
        pairs = list(autotune.INSTANTIATED_BLOCKS[2])
        parts = [check_parts(f"{name} bf16 block {pair}", fn(*pair), want,
                             want, BF16_GATE) for pair in pairs]
        emit({"phase": "kernels", "check": "block_invariance",
              "kernel": name, "dtype": "bfloat16",
              "blocks": [list(pair) for pair in pairs],
              "max_err": max(max(r["max_err_offdiag"], r["max_err_diag"])
                             for r in parts)})

    # nemotron-4-340b's owner shapes on (2, 2) in bf16, the >= 340 B
    # policy's Gram NS: the rows the four-card zero3 phase prints, here on
    # one card (the 73728-long contraction held and timed)
    del x, g, xb, ab, bb, want
    torch.cuda.empty_cache()
    owner_kernels(torch, nemo_config(2, NEMO_VOCAB // 2), NEMO_MESH,
                  {"phase": "kernels", "arch": NEMO, "n_layers": 2},
                  dtype=torch.bfloat16, reps=NEMO_KERNEL_REPS)
    return summary


def phase_blocks(torch) -> None:
    """Every candidate block pair timed at the main path's shapes (the
    autotuner's ``measured`` backend), beside the analytical choice; then
    the bf16 pairs at nemotron-4-340b's owner shapes (batch 1), the
    >= 340 B policy's."""
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
    for mode, m, k in [("syrk", 18432, 73728), ("syrk", 18432, 18432),
                       ("syrk", 1536, 18432), ("symmul", 18432, 18432),
                       ("gram_poly", 18432, 18432), ("symmul", 1536, 1536),
                       ("gram_poly", 1536, 1536)]:
        ms = {f"{bm}x{bk}": autotune.measure_cuda(mode, bm, bk, m, k,
                                                  "bfloat16", batch=1, reps=5)
              for bm, bk in autotune.candidate_blocks(mode, m, k, 2)}
        torch.cuda.empty_cache()
        emit({"phase": "blocks", "mode": mode, "dtype": "bfloat16",
              "batch": 1, "m": m, "k": k, "ms": ms,
              "measured_best": min(ms, key=ms.get),
              "analytical": "x".join(map(str, autotune.lookup(
                  mode, m, k, "bfloat16",
                  arch=autotune.device_arch("cuda"))))})


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

def plan_launches(plan, ns_steps: int = 5) -> dict:
    """Kernel launches of one owner Gram NS step over ``plan``'s groups
    (``core/gram_ns.py``): per group one SYRK, one gram_poly per NS step,
    and three symmul per step but the first (Q' = PQ, T = PG, G' = PT;
    the last step needs no T or G', the first no Q')."""
    g = len(plan.groups)
    return {"syrk": g, "gram_poly": g * ns_steps,
            "symmul": g * 3 * (ns_steps - 1)}


def expected_launches(variant: str, mode: str, step: int,
                      knobs: dict, per_step: dict | None = None) -> dict:
    """Kernel launches of one train step: ``per_step`` (``plan_launches``;
    default ``LAUNCHES_PER_STEP``, smollm-360m's) for every Gram NS variant
    in owner mode (Dion2 runs the same iteration on its factors), none on
    MuonBP's reuse steps (one plain matmul), none for AdamW or the gather
    baseline (full-matrix NS, no kernel)."""
    per_step = per_step or LAUNCHES_PER_STEP
    none = dict.fromkeys(per_step, 0)
    if variant == "adamw" or mode != "owner":
        return none
    if variant == "muonbp" and step % knobs.get("muonbp_period", 4):
        return none
    return dict(per_step)


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
    """Per step (a ``record_function`` range "step<i>"), the ``top`` ops
    and kernels by self host time and by self device time, ms, the
    device's busy time: the sum over kernel events alone (an op's self
    device time is its kernels' again), and the number of those kernel
    events (launches)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    out = []
    for i in range(steps):
        rng = next((e.time_range for e in events if e.name == f"step{i}"),
                   None)
        if rng is None:
            out.append(None)
            continue
        host, dev, busy, kernels = {}, {}, 0.0, 0
        for e in events:
            if e.name.startswith("step") or not (
                    rng.start <= e.time_range.start <= rng.end):
                continue
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
            dev[e.name] = dev.get(e.name, 0.0) + e.self_device_time_total
            if e.device_type == DeviceType.CUDA:
                busy += e.self_device_time_total
                kernels += 1
        out.append({
            "range_ms": (rng.end - rng.start) / 1e3,
            "host_self_ms": {k: v / 1e3 for k, v in sorted(
                host.items(), key=lambda kv: -kv[1])[:top]},
            "device_self_ms": {k: v / 1e3 for k, v in sorted(
                dev.items(), key=lambda kv: -kv[1])[:top] if v > 0},
            "device_busy_ms": busy / 1e3, "kernels": kernels,
            "device_idle_share": 1 - busy / (rng.end - rng.start)})
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


def sample_grid(n: int, k: int) -> list:
    """The indices of a dim of ``n`` entries that a sampled capture keeps:
    all of them where ``n`` <= 3k; else the first k, the last k and k
    spread evenly from the first to the last."""
    if n <= 3 * k:
        return list(range(n))
    spread = {round(i * (n - 1) / (k - 1)) for i in range(k)}
    return sorted(set(range(k)) | spread | set(range(n - k, n)))


def sampled_part(torch, u, k: int) -> tuple:
    """(global shape, global indices a dim, values on the host) of the
    entries of ``sample_grid(n, k)`` (each dim's) that this rank's part of
    the ``DTensor`` ``u`` holds; a pending mean over a data axis taken on
    them (the ranks that share the part take the same entries)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    t = u.to_local()
    _, offset = compute_local_shape_and_global_offset(
        u.shape, u.device_mesh, u.placements)
    indices = []
    for d, (n, lo) in enumerate(zip(u.shape, offset)):
        here = [i for i in sample_grid(n, k) if lo <= i < lo + t.shape[d]]
        indices.append(here)
        t = t.index_select(d, torch.tensor([i - lo for i in here],
                                           device=t.device))
    if any(q.is_partial() for q in u.placements):
        t = t.float().contiguous()
        for i, q in enumerate(u.placements):
            if q.is_partial():
                torch.distributed.all_reduce(
                    t, group=u.device_mesh.get_group(i))
                t /= u.device_mesh.size(i) if q.reduce_op == "avg" else 1
    return tuple(u.shape), indices, t.to("cpu")


def sampled_whole(torch, dist, world: int, parts: dict,
                  k: int) -> dict | None:
    """Rank 0: {path: the leaf on its whole ``sample_grid(n, k)`` grid}
    from every rank's ``sampled_part`` captures ``parts`` ({path:
    capture}); every entry of the grid must come from some rank.  None on
    the other ranks."""
    every = _gathered(dist, world, parts)
    if dist.get_rank() != 0:
        return None
    out = {}
    for p, (shape, _, values) in parts.items():
        grids = [sample_grid(n, k) for n in shape]
        at = [{g: j for j, g in enumerate(grid)} for grid in grids]
        whole = torch.zeros([len(g) for g in grids], dtype=values.dtype)
        seen = torch.zeros(whole.shape, dtype=torch.bool)
        for caps in every:
            _, indices, v = caps[p]
            pos = tuple(torch.tensor([at[d][i] for i in idx]).view(
                [-1 if e == d else 1 for e in range(len(shape))])
                for d, idx in enumerate(indices))
            whole[pos] = v
            seen[pos] = True
        if not bool(seen.all()):
            raise AssertionError(f"{p}: {int((~seen).sum())} sampled "
                                 f"entries held by no rank")
        out[p] = whole
    return out


def train_run(torch, variant: str, mode: str = "owner", mesh=None, *,
              capture: bool | str = False, grads: bool = False,
              knobs: dict | None = None,
              trace: str | None = None, pipeline: str = "fused",
              accum_steps: int = 1, prestage: bool | None = None,
              steps: int = TRAIN_STEPS, keep_state: bool = False,
              cfg=None, dcfg=None, donate: bool = False,
              inputs=None, tensor_parallel: bool = False,
              zero3: bool = False, accum_dtype=None, ns: dict | None = None,
              sample: int | None = None,
              init_hook=None, before_step=None,
              digest: bool = False) -> dict:
    """Train full-width smollm-360m (seed 0, batch 8 x 512, kernels on; or
    the model ``cfg`` on the data ``dcfg``, each batch joined by
    ``inputs(step)``'s tensors (patches or frames) when given, the
    optimizer releasing each spent state with ``donate``)
    ``steps`` steps with ``variant`` / ``mode`` / ``pipeline`` and
    the MuonConfig fields ``knobs``, under ``mesh`` when given (each rank
    on its rows of the batch), in ``accum_steps`` microbatches, staged to
    the owners per microbatch when ``prestage`` (``make_train_step``).  The
    launch counters are set to 0 before each step and read after it, and
    must equal ``expected_launches`` of the plan (``plan_launches``).
    Returns losses, times (synchronised host clock around each step and
    around ``opt.update`` /
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
    ``tensor_parallel``: the step of ``train/step.py`` tensor-parallel over
    ``mesh``'s 'model' axis (``grad_specs`` from ``param_specs``, even on
    a model axis of one rank); the captures are then whole tensors
    (gathered over the mesh, on the host), or with ``sample`` each rank's
    entries of its part on the grid ``sample_grid(n, sample)`` of every
    dim, as ``sampled_part`` takes them (put together over the ranks by
    ``sampled_whole``).  ``zero3``: the
    parameters split by ``param_specs(..., zero3=True)`` (with
    ``tensor_parallel``; ``init_state(..., zero3=True)``), ``accum_dtype``
    the microbatches' accumulation dtype (fp32 unless given), ``ns`` more
    ``GramNSConfig`` fields.  ``init_hook(params)`` runs on
    the initial parameters (in place) before the first step;
    ``before_step(state, batch)`` before each step, outside its clock and
    its launch count.  ``digest``: ``param_digest`` of the last
    parameters (this rank's parts).
    With ``trace`` (a file path) the steps run under ``torch.profiler``
    (host and device), the Chrome trace is written there and a per-step
    summary returned.  With ``keep_state`` the last ``TrainState``, the
    step function and the optimizer are returned too."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model_fns, sharding
    from repro_torch.train.step import (init_state, make_train_step,
                                        placed_params)

    cfg = cfg or configs.get("smollm-360m")
    shapes = model_fns(cfg).init(cfg, device="meta")
    plan = api.dedicate_params(shapes, mesh=mesh)
    specs = sharding.param_specs(cfg, shapes, mesh, zero3=zero3) \
        if tensor_parallel else None
    per_step = plan_launches(plan)
    knobs = knobs or {}
    opt = api.Muon(plan, mesh, config=MuonConfig(
        variant=variant, mode=mode, pipeline=pipeline,
        ns=GramNSConfig(use_kernels=True, **(ns or {})), **knobs),
        device="cuda")
    state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh,
                       zero3=zero3)
    if init_hook is not None:
        with torch.no_grad():
            init_hook(state.params)
    step = make_train_step(cfg, opt, mesh, accum_steps=accum_steps,
                           prestage=prestage, donate=donate, device="cuda",
                           grad_specs=specs,
                           accum_dtype=accum_dtype or torch.float32)
    dcfg = dcfg or DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)

    # time the optimizer transform inside the step (synchronised around it)
    opt_ms, first, first_grads = [], {}, {}

    def keep(t):
        if sample is not None:
            return t
        return t.to("cpu") if capture == "host" else t.clone()

    whole = specs is not None and sample is None

    def part(u):
        if not isinstance(u, DTensor):
            return u
        if whole:
            return u.full_tensor()
        if sample is not None:
            return sampled_part(torch, u, sample)
        return u.to_local()

    def timed(update, staged: bool):
        def run(*a, **kw):
            if grads and not staged and not first_grads:
                if specs is not None:
                    first_grads.update({p: (keep(part(g)),)
                                        for p, g in tree.flatten(a[0])})
                elif capture == "host" and mesh is None:
                    # straight to the host: three copies of a model that
                    # fills the card would not fit beside it
                    first_grads.update({p: (keep(g),)
                                        for p, g in tree.flatten(a[0])})
                else:
                    first_grads.update(capture_grads(a[0], mesh))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = update(*a, **kw)
            torch.cuda.synchronize()
            opt_ms.append((time.perf_counter() - t0) * 1e3)
            if capture and not first:
                first.update({p: keep(part(u))
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
        if inputs is not None:
            batch.update(inputs(i))
        if before_step is not None:
            before_step(state, batch)
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

    def final_params(params):
        if sample is not None:
            return {p: sampled_part(torch, v, sample) for p, v in
                    tree.flatten(placed_params(params, specs, mesh))}
        if whole:
            params = placed_params(params, specs, mesh)
        return {p: (v.full_tensor() if whole else v.detach()).to("cpu")
                for p, v in tree.flatten(params)}

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
        want = expected_launches(variant, mode, i, knobs, per_step)
        if got != want:
            raise AssertionError(f"{tag} step {i}: kernel launches {got}, "
                                 f"expected {want}")
    return {"arch": cfg.name, "params": cfg.param_count(),
            "seq_len": dcfg.seq_len, "global_batch": dcfg.global_batch,
            "loss_ema": loss_ema, "step_ms": step_ms, "optimizer_ms": opt_ms,
            "launches": {k: sum(d[k] for d in launches)
                         for k in per_step},
            "launches_by_step": launches, "allocator_by_step": allocator,
            "gc_by_step": collector,
            "trace": traced,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_updates": first, "first_grads": first_grads,
            "final_params": final_params(state.params) if capture else {},
            "digest": param_digest(torch, state.params) if digest else None,
            "plan": plan, "cfg": cfg, "data": dcfg,
            "state": state if keep_state else None,
            "step": step if keep_state else None,
            "opt": opt if keep_state else None}


def param_digest(torch, params) -> dict:
    """{path: (numel, a position-weighted int64 sum of the bits)} of each
    leaf: equal digests say two runs' parameters are equal bit for bit
    (up to a hash collision) without keeping a copy.  Chunked, so the
    temporaries stay small beside a model that fills the card."""
    from repro_torch.core import tree
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    with torch.no_grad():
        for p, v in tree.flatten(params):
            bits = v.detach().contiguous().view(ints[v.element_size()])
            bits = bits.reshape(-1)
            total = 0
            for i in range(0, bits.numel(), 1 << 26):
                part = bits[i:i + (1 << 26)].long()
                w = torch.arange(i, i + part.numel(), device=part.device)
                total += int((part * (w % 65521 + 1)).sum())
            out[p] = (bits.numel(), total)
    return out


def phase_train(torch, variant: str) -> dict:
    """Train full-width smollm-360m with ``variant`` ('muon': the main path,
    kernel launches counted; 'adamw': the elementwise baseline, which must
    launch none).  Returns the run (with the last parameters'
    ``param_digest``)."""
    run = train_run(torch, variant, digest=True)
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


def dropin_run(torch, variant: str, mesh=None, *,
               steps: int = TRAIN_STEPS) -> dict:
    """``train_run``'s training (full-width smollm-360m, seed 0, batch
    8 x 512, kernels on, ``variant`` in owner mode, fused) through the
    front door, ``core.optim.MuonOptimizer``, in the loop a PyTorch user
    writes: the loss of ``make_loss_fn``, ``loss.backward()``,
    ``opt.step()``, ``opt.zero_grad()``.  Under ``mesh`` (data axes only)
    each rank runs its rows; its own gradients go to the optimizer
    (``grads="partial"``).  The launch counters
    are set to 0 before each step and read after it.  Returns the loss EMA
    as the train step keeps it (the loss averaged over the data ranks),
    step and optimizer times (synchronised host clock around the whole
    iteration and around ``Muon.update``), launches per step, the last
    parameters' ``param_digest`` and, under ``mesh``, the parameters
    themselves (on the host)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model_fns
    from repro_torch.models.sharding import dp_axes
    from repro_torch.train.step import make_loss_fn

    cfg = configs.get("smollm-360m")
    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           model_fns(cfg).init(cfg, 0, "cuda"))
    opt = api.MuonOptimizer(params, mesh, config=MuonConfig(
        variant=variant, mode="owner", pipeline="fused",
        ns=GramNSConfig(use_kernels=True)), device="cuda")
    loss_fn = make_loss_fn(cfg, mesh)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)
    dp = [] if mesh is None else [
        i for i, a in enumerate(mesh.mesh_dim_names) if a in dp_axes(mesh)]
    opt_ms = []
    update = opt.muon.update

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    opt.muon.update = timed
    ema, loss_ema, step_ms, launches = None, [], [], []
    for i in range(steps):
        batch = batch_for_step(dcfg, i, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        loss = loss_fn(params, batch)
        loss.backward()
        opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(LAUNCHES))
        loss = loss.detach()
        for d in dp:
            dist.all_reduce(loss, group=mesh.get_group(d))
            loss /= mesh.size(d)
        ema = loss if i == 0 else 0.98 * ema + 0.02 * loss
        loss_ema.append(float(ema))
    del opt.muon.update
    per_step = plan_launches(opt.plan)
    for i, got in enumerate(launches):
        want = expected_launches(variant, "owner", i, {}, per_step)
        if got != want:
            raise AssertionError(f"dropin {variant} step {i}: kernel "
                                 f"launches {got}, expected {want}")
    return {"loss_ema": loss_ema, "step_ms": step_ms, "optimizer_ms": opt_ms,
            "launches_by_step": launches,
            "digest": param_digest(torch, params),
            "final_params": {} if mesh is None else {
                p: v.detach().to("cpu") for p, v in tree.flatten(params)}}


def phase_dropin(torch, smi: str, train_runs: dict) -> None:
    """The front door (``MuonOptimizer``) in a plain PyTorch loop, for
    ``muon`` and the ``adamw`` baseline: the step losses and the last
    parameters bitwise the train phase's run of the same variant
    (``train_runs[variant]``; trained here when that phase did not run),
    and ``LAUNCHES_PER_STEP`` (none for AdamW) from the front door's
    steps.  Prints both runs' step and optimizer times."""
    for variant in ("muon", "adamw"):
        ref = train_runs.get(variant)
        if ref is None:
            ref = train_run(torch, variant, digest=True)
            torch.cuda.empty_cache()
        run = dropin_run(torch, variant)
        torch.cuda.empty_cache()
        losses = run["loss_ema"] == ref["loss_ema"]
        params = run["digest"] == ref["digest"]
        emit({"phase": "dropin", "variant": variant, "nvidia_smi": smi,
              "steps": TRAIN_STEPS, "loss_ema": run["loss_ema"],
              "train_loss_ema": ref["loss_ema"], "losses_bitwise": losses,
              "params_bitwise": params,
              "launches_by_step": run["launches_by_step"],
              "step_ms": run["step_ms"], "optimizer_ms": run["optimizer_ms"],
              "train_step_ms": ref["step_ms"],
              "train_optimizer_ms": ref["optimizer_ms"]})
        if not (losses and params):
            raise AssertionError(
                f"dropin {variant}: the front door is not the train step "
                f"bitwise (losses {losses}, parameters {params})")


# ------------------------------------------------------------------ dryrun

# the dry run's production cells (arch, shape, mesh), each one
# ``python -m repro_torch.launch.dryrun`` on the host: a fake world of fake
# tensors, no card
DRYRUN_CELLS = [("smollm-360m", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi")]
DRYRUN_CELL_TIMEOUT_S = 600    # from the script's start
PEAK_GATE = 0.10               # predicted peak vs max_memory_allocated


def start_dryrun_cells() -> list:
    """One dry-run subprocess per ``DRYRUN_CELLS`` cell, started at once;
    JSONs and logs under the ignored ``build/dryrun_cells``."""
    outdir = ROOT / "build" / "dryrun_cells"
    outdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cells = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = open(outdir / f"{arch}__{shape}__{mesh}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--mesh", mesh, "--force",
             "--outdir", str(outdir)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        cells.append({"cell": (arch, shape, mesh), "proc": proc, "log": log,
                      "t0": time.perf_counter()})
    return cells


def stop_dryrun_cells(cells: list) -> None:
    """Kill whatever of ``start_dryrun_cells`` still runs."""
    for c in cells:
        if c["proc"].poll() is None:
            c["proc"].kill()
            c["proc"].wait()
        c["log"].close()


def walked_step(step, opt, state, batch, walker):
    """One ``step(state, batch)`` under ``walker`` (``launch.op_walker``,
    ``state`` and ``batch`` counted as arguments): (new state, the costs of
    ``opt.update`` alone)."""
    inner = []
    update = opt.update

    def counted(*a, **kw):
        before = walker.costs.snapshot()
        out = update(*a, **kw)
        inner.append(walker.costs.minus(before))
        return out
    opt.update = counted
    try:
        walker.track_arguments((state, batch))
        with walker:
            new = step(state, batch)
    finally:
        del opt.update
    return new, inner[0]


def allocator_probe(torch):
    """An ``OpWalker`` that also asks the CUDA caching allocator, around
    each top-level op, for its peak inside the op: ``invisible`` keeps the
    ops whose peak passed the walker's live bytes the most (temporaries a
    kernel allocates for itself, which no dispatch mode sees), and
    ``allocator_peak`` the allocator's peak over the walk, both net of
    what was allocated before the walk and is not tracked (``offset``)."""
    from repro_torch.launch.op_walker import OpWalker, _tensors

    class Probe(OpWalker):
        def __init__(self):
            super().__init__()
            self.depth, self.offset, self.allocator_peak = 0, None, 0
            self.invisible = []

        def track_arguments(self, tree) -> None:
            super().track_arguments(tree)
            torch.cuda.synchronize()
            self.offset = torch.cuda.memory_allocated() - self.live

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.depth:
                return super().__torch_dispatch__(func, types, args, kwargs)
            before = self.live
            torch.cuda.reset_peak_memory_stats()
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            peak = torch.cuda.max_memory_allocated() - self.offset
            self.allocator_peak = max(self.allocator_peak, peak)
            excess = peak - max(before, self.live)
            if excess > 0:
                self.invisible.append((excess, str(func), [
                    list(t.shape) for t in _tensors(args)][:3], peak))
                self.invisible = sorted(self.invisible, reverse=True)[:8]
            return out
    return Probe()


def predict_step(torch, cfg):
    """One owner-mode Muon step of ``cfg`` (seed 0, batch 8 x 512, kernels
    on) walked on the host under ``FakeTensorMode``: shapes only, so every
    kernel wrapper takes its plain version.  Returns (walker, costs of
    ``opt.update``, memory dict, plan)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.launch.op_walker import OpWalker
    from repro_torch.models import model_fns
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import TrainState

    plan = api.dedicate_params(model_fns(cfg).init(cfg, device="meta"))
    opt = api.Muon(plan, None, config=MuonConfig(
        variant="muon", mode="owner", pipeline="fused",
        ns=GramNSConfig(use_kernels=True)), device="cpu")
    with FakeTensorMode():
        params = tree.tree_map(lambda v: v.requires_grad_(True),
                               model_fns(cfg).init(cfg, 0, device="cpu"))
        state = TrainState(0, params, opt.init(params),
                           torch.zeros((), dtype=torch.float32))
        batch = {k: torch.zeros((8, 512), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = make_train_step(cfg, opt, None, device="cpu")
        walker = OpWalker()
        new, update = walked_step(step, opt, state, batch, walker)
        mem = walker.memory(new)
    return walker, update, mem, plan


def dryrun_cell_results(cells: list) -> list:
    """Wait for each production cell (``DRYRUN_CELL_TIMEOUT_S`` from its
    start) and read its JSON: ok, or a skip the reference makes too."""
    from repro_torch import configs
    from repro_torch.configs.shapes import cell_supported
    rows = []
    for c in cells:
        arch, shape, mesh = c["cell"]
        left = DRYRUN_CELL_TIMEOUT_S - (time.perf_counter() - c["t0"])
        try:
            rc = c["proc"].wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dry-run cell {c['cell']} still running "
                                 f"after {DRYRUN_CELL_TIMEOUT_S} s") from None
        seconds = time.perf_counter() - c["t0"]
        path = ROOT / "build" / "dryrun_cells" / mesh / \
            f"{arch}__{shape}__owner.json"
        if rc != 0 or not path.exists():
            c["log"].flush()
            tail = Path(c["log"].name).read_text()[-2000:]
            raise AssertionError(f"dry-run cell {c['cell']} exit {rc}: "
                                 f"{tail}")
        d = json.loads(path.read_text())
        if d.get("skipped"):
            if not cell_supported(configs.get(arch), shape):
                raise AssertionError(f"{c['cell']} skipped: {d['skipped']}")
        elif not d.get("ok"):
            raise AssertionError(f"dry-run cell {c['cell']} failed: "
                                 f"{d.get('error')}")
        r = d.get("roofline", {})
        rows.append({"cell": [arch, shape, mesh], "ok": d.get("ok"),
                     "skipped": d.get("skipped"),
                     "hbm_utilization": d.get("hbm_utilization"),
                     "dominant": r.get("dominant"),
                     "dominant_s": r.get(f"{r.get('dominant')}_s"),
                     "terms_s": {k: r.get(k) for k in (
                         "compute_s", "memory_s", "collective_s",
                         "kernel_adjusted_compute_s")},
                     "walk_s": d.get("timings_s", {}).get("compile"),
                     "host_seconds": seconds})
    return rows


def phase_dryrun(torch, smi: str, cells: list) -> None:
    """The dry run held against the card on the main path (full-width
    smollm-360m, fp32, remat, owner Muon with the kernels, 8 x 512, seed
    0): (1) predict one step on the host under ``FakeTensorMode`` with the
    op walker (FLOPs by dtype, bytes, peak live bytes, the H100 roofline);
    (2) measure ``TRAIN_STEPS`` steps on the card as ``train_run`` does
    (launches from the plan, peak ``max_memory_allocated``); (3) walk one
    more step on the card.  Gates: forward + backward FLOPs (the step
    without ``opt.update``) on the card equal the host's exactly; the
    predicted peak within ``PEAK_GATE`` of the measured one.  Then the
    production cells of ``DRYRUN_CELLS``, gated on ok."""
    from repro_torch import configs
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import ns_flops_for_plan

    t_phase = time.perf_counter()
    cfg = configs.get("smollm-360m")
    t0 = time.perf_counter()
    host, host_update, mem, plan = predict_step(torch, cfg)
    predict_s = time.perf_counter() - t0
    nsr, nsk = ns_flops_for_plan(plan, 5, 1)
    roof = roofline.analyze(host.costs, num_devices=1,
                            model_flops=6.0 * cfg.param_count() * 8 * 512,
                            ns_flops_raw=nsr, ns_flops_kernel=nsk)

    run = train_run(torch, "muon", keep_state=True)
    measured = torch.cuda.max_memory_allocated()
    card = allocator_probe(torch)
    batch = batch_for_step(run["data"], TRAIN_STEPS, device="cuda")
    state, card_update = walked_step(run["step"], run["opt"], run["state"],
                                     batch, card)
    torch.cuda.synchronize()
    del state, batch
    run["state"] = run["step"] = run["opt"] = None

    host_fb = host.costs.flops - host_update.flops
    card_fb = card.costs.flops - card_update.flops
    predicted = mem["total_bytes"]
    step_ms = sorted(run["step_ms"])[len(run["step_ms"]) // 2]
    terms = {"compute": roof.compute_s, "memory": roof.memory_s,
             "collective": roof.collective_s}
    emit({"phase": "dryrun", "arch": cfg.name, "steps": TRAIN_STEPS,
          "step_ms": run["step_ms"], "step_ms_median": step_ms,
          "optimizer_ms": run["optimizer_ms"],
          "launches_per_step": {k: v // TRAIN_STEPS
                                for k, v in run["launches"].items()},
          "predicted": {
              "flops": host.costs.flops,
              "flops_by_dtype": host.costs.flops_by_dtype,
              "flops_fwd_bwd": host_fb, "flops_update": host_update.flops,
              "bytes": host.costs.bytes, "peak_gb": predicted / 1e9,
              "memory": mem, "compute_s": roof.compute_s,
              "memory_s": roof.memory_s, "collective_s": roof.collective_s,
              "kernel_adjusted_compute_s": roof.kernel_adjusted_compute_s,
              "dominant": roof.dominant, "useful_ratio": roof.useful_ratio,
              "host_s": predict_s},
          "card": {"flops_fwd_bwd": card_fb,
                   "flops_update_seen": card_update.flops,
                   "bytes": card.costs.bytes,
                   "walked_peak_gb": card.peak / 1e9,
                   "allocator_peak_gb": card.allocator_peak / 1e9,
                   "untracked_gb": card.offset / 1e9,
                   "invisible": [{"gb": e / 1e9, "op": op, "shapes": sh,
                                  "allocator_gb": pk / 1e9}
                                 for e, op, sh, pk in card.invisible]},
          "measured_peak_gb": measured / 1e9,
          "peak_predicted_over_measured": predicted / measured,
          "roofline_share": max(terms.values()) / (step_ms / 1e3),
          "nvidia_smi": smi})
    if card_fb != host_fb:
        raise AssertionError(f"forward + backward FLOPs on the card "
                             f"{card_fb} != the host's fake-mode {host_fb}")
    if abs(predicted - measured) > PEAK_GATE * measured:
        raise AssertionError(f"predicted peak {predicted / 1e9:.3f} GB is "
                             f"not within {PEAK_GATE:.0%} of the measured "
                             f"{measured / 1e9:.3f} GB")
    del run
    gc.collect()
    emit({"phase": "dryrun", "cells": dryrun_cell_results(cells),
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})


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
    want = plan_launches(plain.plan)
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
       The front door (``mesh_dropin``): every rank's loss EMA and
       parameters bitwise the owner run's.
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
    mesh_dropin(torch, dist, runs["owner"], mesh, rank, world)
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


def mesh_dropin(torch, dist, owner: dict, mesh, rank: int,
                world: int) -> None:
    """The front door on the mesh (``dropin_run``, ``grads="partial"``)
    over the owner run's steps: this rank's loss EMA and last parameters
    bitwise the owner run's (``owner``), on every rank."""
    run = dropin_run(torch, "muon", mesh, steps=MESH_STEPS)
    torch.cuda.empty_cache()
    mine = {"losses_bitwise": run["loss_ema"] == owner["loss_ema"],
            "params_bitwise": all(
                torch.equal(v, owner["final_params"][p])
                for p, v in run["final_params"].items()),
            "step_ms": run["step_ms"], "optimizer_ms": run["optimizer_ms"]}
    per_rank = [None] * world
    dist.all_gather_object(per_rank, mine)
    if rank == 0:
        emit({"phase": "mesh", "check": "dropin", "world": world,
              "mesh": [world, 1], "grads": "partial",
              "loss_ema": run["loss_ema"], "owner_loss_ema":
              owner["loss_ema"], "owner_step_ms": owner["step_ms"],
              "owner_optimizer_ms": owner["optimizer_ms"],
              "per_rank": per_rank})
    bad = [r for r, m in enumerate(per_rank)
           if not (m["losses_bitwise"] and m["params_bitwise"])]
    if bad:
        raise AssertionError(f"mesh dropin: ranks {bad} differ from the "
                             f"mesh step: {per_rank}")


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


TP_SPREAD = 10                 # tp step: 10x the one-ulp spread, per leaf
TP_QUANTITIES = ("loss", "grads", "updates", "params", "loss_ema")


def tp_gate(torch, tp: dict, ref: dict, spread: dict,
            matrices: set, ulp: float = 2.0 ** -23) -> dict:
    """The tensor-parallel training against one card's on the same batch
    and parameters.  ``tp``, ``ref`` and ``spread`` each map every quantity
    of ``TP_QUANTITIES`` (step 1's loss, gradients and updates; the
    ``loss_ema`` and the parameters after the last step) to {path: whole
    tensor} (the scalars under ""): the tensor-parallel run, the one-card
    run, and the one-card run from the same parameters with a random half
    of their entries one ulp up.  ``matrices``: the Muon leaves (the
    plan's); the others are AdamW's.

    The tensor-parallel forward differs from one card's by rounding only:
    each row-parallel output is a sum of ``tp`` partial products reduced
    over the model axis where one card takes one product, and the vocab
    and the query rows split the softmaxes' sums.  Each reordered sum
    moves its result by a few ulps of its terms, as one ulp on the
    parameters does.  So each leaf of each quantity passes where
    max|tp − ref| <= ``TP_SPREAD`` · max(max|spread − ref|, one ulp of
    max|ref|), that ulp ``ulp`` · max|ref| (fp32's unless the quantities
    are coarser).  An AdamW leaf's step-1 update is −lr · g / (|g| + eps),
    about −lr · sign(g): where |g| is at rounding size a few ulps of the
    gradient move it by up to a sign flip, which no one-ulp run need
    reproduce.  So each of its entries is also allowed what its
    gradient's relative difference rho explains, min(2·rho, 2) ·
    max(|u|, |u_ref|), as ``step_gate``'s AdamW rule.  Returns the worst
    ratio (|Δ| over that bound) per quantity, ``factor`` (their largest;
    <= 1 passes) and per-leaf rows."""
    ratios, rows = {}, {}
    for q in TP_QUANTITIES:
        worst = 0.0
        for p, want in ref[q].items():
            want = want.to("cpu", torch.float64)
            got = tp[q][p].to("cpu", torch.float64)
            diff = (got - want).abs()
            d = float(diff.max())
            s = float((spread[q][p].to("cpu", torch.float64)
                       - want).abs().max())
            bound = TP_SPREAD * max(s, ulp * float(want.abs().max()))
            if q == "updates" and p not in matrices:
                g = ref["grads"][p].to("cpu", torch.float64)
                dg = (tp["grads"][p].to("cpu", torch.float64) - g).abs()
                rho = torch.where(dg == 0, torch.zeros_like(dg),
                                  dg / g.abs())
                entry = bound + torch.clamp(2 * rho, max=2.0) * \
                    torch.maximum(got.abs(), want.abs())
                r = float(torch.where(diff == 0, torch.zeros_like(diff),
                                      diff / entry).max())
            else:
                r = d / bound if bound else (0.0 if d == 0 else math.inf)
            rows[f"{q}/{p}" if p else q] = {"max_abs_diff": d, "spread": s,
                                            "ratio": r}
            worst = max(worst, r)
        ratios[q] = worst
    return {"ratios": ratios, "factor": max(ratios.values()),
            "spread_factor": TP_SPREAD, "per_leaf": rows}


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


# ---------------------------------------------------------------------- tp

TP_TIMEOUT_S = 600             # every NCCL collective of the phase
# qwen2.5-14b at its published widths on (1, 4): fp32, remat, donate,
# batch 1 x 2048, and the host predictions of the same runs
# (``tp_predict``: the dry run's walk on a fake world of (1, 4)).  The walk
# gives 82.8 GB (Muon) and 84.0 GB (AdamW) a card at 48 layers, 78.0 /
# 79.3 at 45 and 70.3 / 71.3 at 40: 1.6 GB a layer.  The Muon run at 45
# read 0.7% over its prediction, which would put AdamW within 0.1 GB of
# 80 GB, so 44 layers (76.4 / 77.7 by the same slope)
TP_QWEN = "qwen2.5-14b"
TP_QWEN_LAYERS = 44
TP_QWEN_BATCH, TP_QWEN_SEQ = 1, 2048
# each optimizer's steps, and the steps averaged at each end of the run
# for the loss gate (``loss_falls``): one batch of 2048 tokens a step moves
# a step's loss by a few hundredths either way
TP_QWEN_STEPS = 16
TP_QWEN_WINDOW = 4
TP_QWEN_MESH = (1, 4)
# the same widths, few enough layers for one card: the (1, 4) run held to
# one card by ``tp_gate``, as smollm's, both releasing each spent state
# (without ``donate`` the one-card run outgrew 80 GB at 4 layers)
TP_QWEN_CMP_LAYERS = 4
TP_PREDICT_TIMEOUT_S = 1000    # from the script's start




def start_walks(subdir: str, calls: dict) -> list:
    """Each of ``calls`` ({cell: (the name of a walk function of this
    script, its arguments but the last)}) in a subprocess of its own,
    started at once, the JSON path its last argument; JSONs and logs under
    the ignored ``build/<subdir>`` (read by ``tp_predictions``)."""
    outdir = ROOT / "build" / subdir
    outdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cells = []
    for name, (fn, args) in calls.items():
        path = outdir / f"{name}.json"
        log = open(outdir / f"{name}.log", "w")
        code = (f"import chip_smoke; "
                f"chip_smoke.{fn}(*{args!r}, {str(path)!r})")
        proc = subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", code],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        cells.append({"cell": name, "proc": proc, "log": log, "path": path,
                      "t0": time.perf_counter()})
    return cells


def start_tp_predictions() -> list:
    """The host's predicted peak of the qwen runs (Muon, AdamW), each
    ``tp_predict`` (``start_walks``)."""
    return start_walks("tp_predict", {opt: ("tp_predict", (opt,))
                                      for opt in ("owner", "adamw")})


def tp_predict(opt: str, out: str) -> None:
    """The dry run's walk of one qwen run (``launch.dryrun.walk_cell``):
    ``TP_QWEN_LAYERS`` layers, a ``TP_QWEN_BATCH`` x ``TP_QWEN_SEQ`` batch
    on a fake world of ``TP_QWEN_MESH``, ``opt``'s optimizer; its JSON to
    ``out``."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import walk_cell
    cfg = configs.get(TP_QWEN, n_layers=TP_QWEN_LAYERS)
    shape = ShapeSpec("tp_qwen", TP_QWEN_SEQ, TP_QWEN_BATCH, "train")
    result = walk_cell(cfg, TP_QWEN, shape, TP_QWEN_MESH, opt)
    Path(out).write_text(json.dumps(result, default=str))


def tp_predictions(cells: list) -> dict:
    """{cell: predicted peak GB} of ``start_tp_predictions`` ("owner" /
    "adamw") or ``start_tp_moe_predictions``."""
    out = {}
    for c in cells:
        left = TP_PREDICT_TIMEOUT_S - (time.perf_counter() - c["t0"])
        try:
            rc = c["proc"].wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"tp prediction {c['cell']} still running "
                                 f"after {TP_PREDICT_TIMEOUT_S} s") from None
        path = c["path"]
        if rc != 0 or not path.exists():
            c["log"].flush()
            raise AssertionError(f"tp prediction {c['cell']} exit {rc}: "
                                 f"{Path(c['log'].name).read_text()[-2000:]}")
        d = json.loads(path.read_text())
        # the walk's own build and walk, not the wait for it
        out[c["cell"]] = {"peak_gb": d["memory_analysis"]["total_bytes"] / 1e9,
                          "walk_seconds": d["timings_s"]["build"]
                          + d["timings_s"]["compile"]}
    return out


def phase_tp(torch, smi: str) -> None:
    """Every visible card, one NCCL rank each (spawned, as the mesh
    phase's), through the tensor-parallel step (``tp_checks``), after
    the kernels at qwen2.5-14b's owner shapes on this card."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    tp_kernels(torch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(nccl_rank, args=(world, free_port(), "tp_checks"),
                       nprocs=world, start_method="spawn", join=True)
    emit({"phase": "tp", "check": "done", "world": world,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})


def phase_tp_qwen(torch, smi: str, cells: list) -> None:
    """Four cards, one NCCL rank each: qwen2.5-14b at its published
    widths on ``TP_QWEN_MESH`` (``tp_qwen_checks``), then the host's
    predicted peaks of its runs (``cells``: ``start_tp_predictions``)
    beside the measured ones.  On other counts it says so and passes."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    if world != math.prod(TP_QWEN_MESH):
        emit({"phase": "tp_qwen", "skipped": f"needs "
              f"{math.prod(TP_QWEN_MESH)} cards, {world} visible"})
        return
    out = ROOT / "build" / "tp_phase"
    out.mkdir(parents=True, exist_ok=True)
    measured = out / "qwen.json"
    measured.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(nccl_rank, args=(world, free_port(), "tp_qwen_checks",
                                        measured),
                       nprocs=world, start_method="spawn", join=True)
    seconds = time.perf_counter() - t0
    predicted = tp_predictions(cells)
    got = json.loads(measured.read_text())
    emit({"phase": "tp_qwen", "check": "qwen_peak_vs_dryrun",
          "arch": TP_QWEN, "mesh": list(TP_QWEN_MESH),
          "n_layers": TP_QWEN_LAYERS,
          "predicted_peak_gb": {k: v["peak_gb"] for k, v in
                                predicted.items()},
          "measured_peak_gb_per_card": got,
          "predicted_over_measured": {
              k: predicted[k]["peak_gb"] / max(got[k]) for k in predicted},
          "prediction_walk_seconds": {k: v["walk_seconds"] for k, v in
                                      predicted.items()},
          "world": world, "seconds": seconds, "nvidia_smi": smi})


def tp_kernels(torch) -> None:
    """The three kernels at the (B, m, n) of one owner's rows of each Gram
    group of qwen2.5-14b on ``TP_QWEN_MESH`` (``TP_QWEN_LAYERS``
    layers: B = ceil(layers / 4)), on this card (``owner_kernels``)."""
    from repro_torch import configs
    owner_kernels(torch, configs.get(TP_QWEN, n_layers=TP_QWEN_LAYERS),
                  TP_QWEN_MESH, {"phase": "tp", "arch": TP_QWEN,
                                 "n_layers": TP_QWEN_LAYERS})


def owner_kernels(torch, cfg, mesh_shape, line: dict, dtype=None,
                  reps: int | None = None) -> None:
    """The three kernels at the (B, m, n) of one owner's rows of each Gram
    group of ``cfg`` over the cards of ``mesh_shape``, on this card, held
    and timed as the families phase's (median of ``reps``), each
    with its launches a step on every rank (from the plan); in ``dtype``
    (``gram_kernel_cases``); each row printed after ``line``."""
    from repro_torch.core import api
    from repro_torch.models import transformer
    owners = math.prod(mesh_shape)
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=owners)
    syrk, gram = {}, {}
    for g in plan.groups.values():
        rows = g.packed_size // owners
        syrk[(rows, *g.key)] = syrk.get((rows, *g.key), 0) + 1
        gram[(rows, g.key[0])] = gram.get((rows, g.key[0]), 0) + 1
    per_group = plan_launches(plan)
    per_group = {k: v // len(plan.groups) for k, v in per_group.items()}
    counter = {name: meta["counter"] for name, meta in KERNELS.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    for case in gram_kernel_cases(torch, gen, list(syrk), list(gram), dtype):
        name, shape = case[0], case[1]
        groups = syrk[shape] if name == "gram_syrk" else gram[shape[:2]]
        emit({**line, "mesh": list(mesh_shape),
              "launches_per_step": groups * per_group[counter[name]],
              **check_kernel_case(torch, case, reps or FAMILY_REPS)})
        del case
        torch.cuda.empty_cache()




def nccl_rank(rank: int, world: int, port: int, part: str, *args) -> None:
    """One NCCL rank of a phase spawned one rank a card: ``part`` (the
    name of a function of this script) called with (torch, dist, rank,
    world, *args)."""
    sys.path.insert(0, str(ROOT / "src"))
    # the published-width runs fill the card: grow segments in place rather
    # than keep freed blocks of each size apart (read when the allocator
    # starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.device import strict_fp32
    from repro_torch.launch.mesh import init_process_group

    strict_fp32()
    init_process_group("cuda", rank=rank, world_size=world,
                       init_method=f"tcp://localhost:{port}",
                       timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    globals()[part](torch, dist, rank, world, *args)
    dist.destroy_process_group()


def tp_quantities(torch, run: dict) -> dict:
    """``tp_gate``'s quantities of a ``train_run`` with whole captures."""
    return {"loss": {"": torch.tensor(run["loss_ema"][0])},
            "grads": {p: g[0] for p, g in run["first_grads"].items()},
            "updates": run["first_updates"], "params": run["final_params"],
            "loss_ema": {"": torch.tensor(run["loss_ema"][-1])}}


def tp_checks(torch, dist, rank: int, world: int) -> None:
    """The ``tp`` phase on one rank.

    1. Full-width smollm-360m (fp32, remat, owner Muon with the kernels,
       seed 0, 8 x 512) ``TRAIN_STEPS`` steps through the tensor-parallel
       step on a (1, world) mesh, and on four cards also (2, 2): 15
       heads, so the sequence-sharded attention wherever the model axis
       has more than one rank.  Launches from the plan every step
       (``train_run``); step ms, optimizer ms and peak GB per rank.
    2. One card: the parameters after the steps bitwise those of the
       train phase's run (the same ``train_run`` without a mesh).
    3. More cards, rank 0: each mesh run against one card's on the same
       batches (in ``data`` microbatches, as the mesh splits them) by
       ``tp_gate``: step 1's loss, gradients and updates, the last
       loss_ema and parameters, within ``TP_SPREAD`` x what one ulp on a
       random half of the parameters moves the one-card run."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh

    lead = rank == 0
    shapes = [(1, world)] + ([(2, world // 2)] if world == 4 else [])
    runs = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        run = train_run(torch, "muon", "owner", mesh, capture="host",
                        grads=True, tensor_parallel=True)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, timing)
        if lead:
            emit({"phase": "tp", "arch": run["arch"], "mesh": list(shape),
                  "attention": "head-parallel" if run["cfg"].n_heads %
                  shape[1] == 0 else "sequence-sharded",
                  "loss_ema": run["loss_ema"],
                  "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                                        run["launches"].items()},
                  "per_rank": per_rank})
            runs[shape] = run
        del run
        torch.cuda.empty_cache()

    failure = None
    if lead and world == 1:
        single = train_run(torch, "muon", "owner", capture="host")
        tp = runs[(1, 1)]
        same = all(torch.equal(tp["final_params"][p], v)
                   for p, v in single["final_params"].items())
        emit({"phase": "tp", "check": "world1_vs_train_phase",
              "bitwise_params": same,
              "loss_ema": tp["loss_ema"], "train_loss_ema": single["loss_ema"],
              "launches": tp["launches"],
              "plan_launches_per_step": plan_launches(tp["plan"])})
        if not same or tp["loss_ema"] != single["loss_ema"]:
            failure = ("tensor-parallel step on one card is not the train "
                       "phase's run bitwise")
    elif lead:
        failure = tp_vs_single(torch, runs)
    failures = [None] * world
    dist.all_gather_object(failures, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])
    runs.clear()


def tp_qwen_checks(torch, dist, rank: int, world: int,
                   measured: Path) -> None:
    """The ``tp_qwen`` phase on one rank of four: qwen2.5-14b at its
    published widths on ``TP_QWEN_MESH``, head-parallel (40 / 8 heads),
    batch ``TP_QWEN_BATCH`` x ``TP_QWEN_SEQ``.

    1. Cut to ``TP_QWEN_CMP_LAYERS`` layers, ``TRAIN_STEPS`` steps held
       to one card on the same batches by ``tp_gate`` (``tp_vs_single``),
       as ``tp_checks`` holds smollm-360m.
    2. Cut to ``TP_QWEN_LAYERS`` layers, ``TP_QWEN_STEPS`` Muon steps and
       as many AdamW steps, each releasing its spent state (``donate``):
       the loss finite and falling (``loss_falls``), launches from the
       plan, step / optimizer ms and peak GB per card (the peaks written
       to ``measured`` for the parent)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh

    lead = rank == 0
    # qwen at its widths, cut to fit one card: (1, 4) against one card
    mesh = make_mesh(TP_QWEN_MESH, ("data", "model"), "cuda")
    cfg = configs.get(TP_QWEN, n_layers=TP_QWEN_CMP_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TP_QWEN_SEQ,
                      global_batch=TP_QWEN_BATCH)
    run = train_run(torch, "muon", "owner", mesh, cfg=cfg, dcfg=dcfg,
                    donate=True, capture="host", grads=True,
                    tensor_parallel=True)
    timing = {k: run[k] for k in ("step_ms", "optimizer_ms", "peak_mem_gb")}
    per_rank = [None] * world
    dist.all_gather_object(per_rank, timing)
    failure = None
    if lead:
        emit({"phase": "tp_qwen", "arch": TP_QWEN,
              "n_layers": TP_QWEN_CMP_LAYERS, "mesh": list(TP_QWEN_MESH),
              "attention": "head-parallel", "loss_ema": run["loss_ema"],
              "per_rank": per_rank})
        failure = tp_vs_single(torch, {TP_QWEN_MESH: run}, cfg=cfg,
                               dcfg=dcfg, donate=True)
    del run
    failures = [None] * world
    dist.all_gather_object(failures, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])
    gc.collect()
    torch.cuda.empty_cache()

    # qwen at its widths, TP_QWEN_LAYERS layers: what one card cannot hold
    cfg = configs.get(TP_QWEN, n_layers=TP_QWEN_LAYERS)
    peaks, rows, missed = {}, {}, []
    for variant in ("muon", "adamw"):
        run = train_run(torch, variant, "owner", mesh, cfg=cfg, dcfg=dcfg,
                        donate=True, tensor_parallel=True,
                        steps=TP_QWEN_STEPS)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, timing)
        falls = loss_falls(run["loss_ema"], TP_QWEN_WINDOW)
        rows[variant] = {"loss_ema": run["loss_ema"], **falls,
                         "per_rank": per_rank}
        peaks["owner" if variant == "muon" else "adamw"] = [
            r["peak_mem_gb"] for r in per_rank]
        if lead:
            emit({"phase": "tp_qwen", "arch": TP_QWEN, "variant": variant,
                  "mesh": list(TP_QWEN_MESH), "n_layers": TP_QWEN_LAYERS,
                  **rows[variant]})
        if not falls["falls"]:
            missed.append(f"{TP_QWEN} {variant}: the mean loss of the last "
                          f"{TP_QWEN_WINDOW} steps is not below the first "
                          f"{TP_QWEN_WINDOW}'s: {falls}")
        del run
        gc.collect()
        torch.cuda.empty_cache()
    if missed:
        raise AssertionError("; ".join(missed))
    if lead:
        steady = {v: [{k: sum(r[k][1:]) / len(r[k][1:])
                       for k in ("step_ms", "optimizer_ms")}
                      for r in rows[v]["per_rank"]] for v in rows}
        emit({"phase": "tp_qwen", "arch": TP_QWEN,
              "mesh": list(TP_QWEN_MESH), "n_layers": TP_QWEN_LAYERS,
              "cut": None if TP_QWEN_LAYERS == 48 else
              f"{TP_QWEN_LAYERS} of 48 layers",
              "batch": [TP_QWEN_BATCH, TP_QWEN_SEQ],
              "params": cfg.param_count(), "attention": "head-parallel",
              "loss_ema": {v: r["loss_ema"] for v, r in rows.items()},
              "steady_mean_ms_per_rank": steady,
              "owner_over_adamw_per_rank": [
                  {k: m[k] / a[k] for k in m}
                  for m, a in zip(steady["muon"], steady["adamw"])]})
        measured.write_text(json.dumps(peaks))


def loss_falls(loss_ema: list, window: int) -> dict:
    """Each step's loss, recovered from the EMA the step keeps (ema_0 =
    loss_0, ema_k = 0.98 ema_(k-1) + 0.02 loss_k), and whether the mean of
    the last ``window`` steps' losses is below the mean of the first
    ``window``'s: a fall over the run, where one step's batch alone moves
    the loss by a few hundredths either way."""
    losses = [loss_ema[0]] + [(b - 0.98 * a) / 0.02
                              for a, b in zip(loss_ema, loss_ema[1:])]
    first = sum(losses[:window]) / window
    last = sum(losses[-window:]) / window
    return {"step_losses": losses, "first_mean": first, "last_mean": last,
            "falls": last < first}


def tp_vs_single(torch, runs: dict, accum: int | None = None,
                 drops: bool = False, **kw):
    """Rank 0: each mesh run against one card's on the same batches
    (``tp_gate``; ``kw`` to ``train_run``: the model and data of the
    runs), the batch in as many microbatches as the mesh has data ranks
    (``accum`` instead where given: 1 for the MoE family, whose dispatch
    spans the data ranks); the first gate missed, or None.  ``drops``:
    the one-card run's MoE drops a step printed beside."""
    from repro_torch.core import tree

    gen = torch.Generator("cuda").manual_seed(11)

    def ulp(params):
        for _, v in tree.flatten(params):
            v.copy_(one_ulp_up(torch, v, gen))
    refs, dropped = {}, []
    for parts in sorted({accum or shape[0] for shape in runs}):
        refs[parts] = [train_run(
            torch, "muon", "owner", capture="host", grads=True,
            accum_steps=parts, init_hook=hook,
            before_step=drop_counter(torch, kw["cfg"], None, dropped, [])
            if drops and hook is None and not dropped else None, **kw)
            for hook in (None, ulp)]
        torch.cuda.empty_cache()
    failure = None
    for shape, run in runs.items():
        ref, spread = refs[accum or shape[0]]
        gate = tp_gate(torch, tp_quantities(torch, run),
                       tp_quantities(torch, ref),
                       tp_quantities(torch, spread), set(run["plan"].leaves))
        worst = sorted(gate["per_leaf"].items(),
                       key=lambda kv: -kv[1]["ratio"])[:8]
        emit({"phase": "tp", "check": "tp_vs_single", "arch": run["arch"],
              "n_layers": run["cfg"].n_layers, "mesh": list(shape),
              "reference": f"one card, accum_steps={accum or shape[0]}",
              "ratios": gate["ratios"], "factor": gate["factor"],
              "spread_factor": gate["spread_factor"],
              "worst_leaves": dict(worst),
              "loss_ema_tp": run["loss_ema"], "loss_ema_single": ref["loss_ema"],
              "single_dropped_by_step": dropped or None,
              "single_step_ms": ref["step_ms"],
              "single_optimizer_ms": ref["optimizer_ms"]})
        if gate["factor"] > 1 and failure is None:
            failure = (f"tensor-parallel step of {run['arch']} on {shape} "
                       "misses the gate: "
                       f"ratios {gate['ratios']}")
    return failure


# ------------------------------------------------------------------ tp_moe

# DeepSeek-V3's expert-parallel step.  (a) the moe phase's cut
# (``moe_config``: 2 layers, 16 experts) on each mesh of ``TP_MOE_MESHES``,
# held to one card by ``tp_gate``; (b) all 256 routed experts on
# ``TP_MOE_MESH`` (64 a card) at the depth the dry run's walk
# (``tp_moe_predict``) puts within ``HBM_BYTES`` a card for both
# optimizers: the first of ``TP_MOE_CUTS`` (layers, experts) that fits,
# else the first of ``TP_MOE_FALLBACKS`` (the experts cut in multiples of
# 4), walked only then
TP_MOE_MESHES = [(1, 4), (2, 2)]
TP_MOE_MESH = (1, 4)
TP_MOE_CUTS = [(2, 256), (1, 256)]
TP_MOE_FALLBACKS = [(1, 224), (1, 192)]
TP_MOE_STEPS = 16
TP_MOE_WINDOW = 4


def tp_moe_config(layers: int, experts: int):
    """DeepSeek-V3 at its published widths, ``layers`` layers and
    ``experts`` routed experts (bf16, remat, capacity factor 1.25)."""
    from repro_torch import configs
    base = configs.get("deepseek-v3-671b")
    return configs.get("deepseek-v3-671b", n_layers=layers,
                       moe=dataclasses.replace(base.moe, n_experts=experts))




def start_tp_moe_predictions(cuts=TP_MOE_CUTS) -> list:
    """The host's predicted peak of each (b) candidate of ``cuts`` for
    Muon and AdamW (``tp_moe_predict``, ``start_walks``)."""
    return start_walks("tp_moe_predict", {
        f"{opt}_{layers}x{experts}": ("tp_moe_predict",
                                      (opt, layers, experts))
        for layers, experts in cuts for opt in ("owner", "adamw")})


def tp_moe_predict(opt: str, layers: int, experts: int, out: str) -> None:
    """The dry run's walk (``launch.dryrun.walk_cell``) of one (b) run:
    ``tp_moe_config(layers, experts)``, batch ``MOE_BATCH`` x ``MOE_SEQ``
    in one microbatch on a fake world of ``TP_MOE_MESH``, with
    ``train_run``'s optimizer settings for ``opt`` ("owner": Muon,
    "adamw"); its JSON to ``out``."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.launch.dryrun import walk_cell
    muon = MuonConfig(variant="muon" if opt == "owner" else "adamw",
                      mode="owner", pipeline="fused",
                      autotune_prewarm=False,
                      ns=GramNSConfig(use_kernels=True))
    shape = ShapeSpec("tp_moe", MOE_SEQ, MOE_BATCH, "train")
    result = walk_cell(tp_moe_config(layers, experts), "deepseek-v3-671b",
                       shape, TP_MOE_MESH, opt, muon=muon, accum=1)
    Path(out).write_text(json.dumps(result, default=str))


def tp_moe_cut(predicted: dict) -> tuple:
    """The first (layers, experts) of ``TP_MOE_CUTS`` whose predicted
    peaks (Muon and AdamW) are both within ``HBM_BYTES``, else of
    ``TP_MOE_FALLBACKS``, walked now and added to ``predicted``."""
    from repro_torch.launch.mesh import HBM_BYTES

    def fits(cut):
        return max(predicted[f"{o}_{cut[0]}x{cut[1]}"]["peak_gb"]
                   for o in ("owner", "adamw")) * 1e9 <= HBM_BYTES
    for cut in TP_MOE_CUTS:
        if fits(cut):
            return cut
    cells = start_tp_moe_predictions(TP_MOE_FALLBACKS)
    try:
        predicted.update(tp_predictions(cells))
    finally:
        stop_dryrun_cells(cells)
    for cut in TP_MOE_FALLBACKS:
        if fits(cut):
            return cut
    raise AssertionError(f"no cut of {TP_MOE_CUTS + TP_MOE_FALLBACKS} is "
                         f"predicted within {HBM_BYTES / 1e9} GB a card: "
                         f"{predicted}")


def drop_counter(torch, cfg, mesh, rows: list, slots: list, specs=None):
    """A ``train_run`` ``before_step`` hook: each step's MoE assignments
    beyond capacity, summed over the layers, on this rank's tokens (under
    the global rule on a mesh), from a forward without gradients on the
    step's parameters (placed by ``specs``, default ``param_specs``) and
    batch; appended to ``rows``, and the slots of each layer's expert
    buffers on this rank to ``slots``."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.train.step import make_loss_fn
    loss_fn = make_loss_fn(cfg, mesh, specs)

    def hook(state, batch):
        with torch.no_grad(), moe_lib.recording() as rec:
            loss_fn(state.params, batch)
        rows.append(int(sum(int(r["dropped"]) for r in rec)))
        slots.append([r["slots"] for r in rec])
    return hook


def phase_tp_moe(torch, smi: str, cells: list, moe_run) -> None:
    """Every visible card, one NCCL rank each (spawned, as the tp phase's):
    DeepSeek-V3 through the expert-parallel step (``tp_moe_checks``).  On
    one card (1, 1), bitwise the moe phase's run (``moe_run``: its
    loss_ema and ``param_digest``; run here where that phase did not).
    On four, (a) then, after the predictions of ``cells``
    (``start_tp_moe_predictions``) pick the (b) cut and its kernels run on
    this card, (b); its peaks beside the predictions, within
    ``PEAK_GATE``."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    out = ROOT / "build" / "tp_phase"
    out.mkdir(parents=True, exist_ok=True)
    measured = out / "moe.json"
    measured.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(nccl_rank, args=(world, free_port(), "tp_moe_checks",
                                        moe_run),
                       nprocs=world, start_method="spawn", join=True)
    if world != math.prod(TP_MOE_MESH):
        emit({"phase": "tp_moe", "check": "done", "world": world,
              "skipped": f"(b) needs {math.prod(TP_MOE_MESH)} cards",
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
        return
    predicted = tp_predictions(cells)
    layers, experts = tp_moe_cut(predicted)
    emit({"phase": "tp_moe", "check": "cut", "n_layers": layers,
          "n_experts": experts, "cuts": TP_MOE_CUTS,
          "fallbacks": TP_MOE_FALLBACKS,
          "predicted_peak_gb": {k: v["peak_gb"] for k, v in
                                predicted.items()},
          "prediction_walk_seconds": {k: v["walk_seconds"] for k, v in
                                      predicted.items()}})
    # the kernels at its owner shapes: the experts' groups (64·layers,
    # 2048, 7168) at 256 experts
    owner_kernels(torch, tp_moe_config(layers, experts), TP_MOE_MESH,
                  {"phase": "tp_moe", "arch": "deepseek-v3-671b",
                   "n_layers": layers, "n_experts": experts})
    torch.cuda.empty_cache()
    mp.start_processes(nccl_rank, args=(world, free_port(),
                                        "tp_moe_published", layers, experts,
                                        measured),
                       nprocs=world, start_method="spawn", join=True)
    got = json.loads(measured.read_text())
    ratio = {o: predicted[f"{o}_{layers}x{experts}"]["peak_gb"] / max(got[o])
             for o in got}
    emit({"phase": "tp_moe", "check": "peak_vs_dryrun",
          "arch": "deepseek-v3-671b", "mesh": list(TP_MOE_MESH),
          "n_layers": layers, "n_experts": experts,
          "measured_peak_gb_per_card": got,
          "predicted_over_measured": ratio, "gate": PEAK_GATE,
          "world": world, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    missed = {o: r for o, r in ratio.items() if abs(r - 1) > PEAK_GATE}
    if missed:
        raise AssertionError(f"(b) peaks off the dry run's by more than "
                             f"{PEAK_GATE}: {missed}")




def _gathered(dist, world: int, obj) -> list:
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def tp_moe_checks(torch, dist, rank: int, world: int, moe_run) -> None:
    """(a) on one rank: ``moe_config()`` (the moe phase's DeepSeek-V3, batch
    ``MOE_BATCH`` x ``MOE_SEQ``, ``TRAIN_STEPS`` Muon steps, ``donate``)
    through the expert-parallel step, launches from the plan, the drops
    of each step (the global rule) printed.  One card: on (1, 1), bitwise
    the moe phase's run.  Four: on each mesh of ``TP_MOE_MESHES``, held
    to one card's run of the whole batch (one dispatch, as the reference's)
    by ``tp_gate``."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib

    cfg = moe_config()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH)
    lead = rank == 0
    shapes = [(1, 1)] if world == 1 else TP_MOE_MESHES
    assignments = cfg.n_layers * MOE_BATCH * MOE_SEQ * cfg.moe.top_k
    tokens = MOE_BATCH * MOE_SEQ
    cap = moe_lib.capacity(cfg.moe, tokens)
    runs, failure = {}, None
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        drops, slots = [], []
        run = train_run(torch, "muon", "owner", mesh, cfg=cfg, dcfg=dcfg,
                        donate=True, capture="host" if world > 1 else False,
                        grads=world > 1, tensor_parallel=True,
                        digest=world == 1,
                        before_step=drop_counter(torch, cfg, mesh, drops,
                                                 slots))
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb")}
        per_rank = _gathered(dist, world, {**timing, "dropped": drops,
                                           "slots": slots})
        if lead:
            # model ranks repeat their data rank's count
            glob = [sum(r["dropped"][i] for j, r in enumerate(per_rank)
                        if j % shape[1] == 0) for i in range(len(drops))]
            emit({"phase": "tp_moe", "arch": run["arch"], "mesh": list(shape),
                  "n_layers": cfg.n_layers, "n_experts": cfg.moe.n_experts,
                  "loss_ema": run["loss_ema"],
                  "dropped_by_step": glob, "assignments_per_step": assignments,
                  "capacity": cfg.moe.capacity_factor,
                  # a buffer's slots a layer: each rank's (``per_rank``)
                  # against C of the global batch and min(C, T) of a rank
                  "capacity_slots": cap,
                  "rank_rows_bound": min(cap, tokens // shape[0]),
                  "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                                        run["launches"].items()},
                  "per_rank": per_rank})
            runs[shape] = run
        del run
        gc.collect()
        torch.cuda.empty_cache()
    if lead and world == 1:
        tp = runs[(1, 1)]
        if moe_run is None:
            single = train_run(torch, "muon", cfg=cfg, dcfg=dcfg,
                               donate=True, digest=True)
            moe_run = {k: single[k] for k in ("loss_ema", "digest")}
            del single
        same = tp["digest"] == moe_run["digest"] and \
            tp["loss_ema"] == moe_run["loss_ema"]
        emit({"phase": "tp_moe", "check": "world1_vs_moe_phase",
              "bitwise_params": tp["digest"] == moe_run["digest"],
              "loss_ema": tp["loss_ema"],
              "moe_phase_loss_ema": moe_run["loss_ema"]})
        if not same:
            failure = ("the expert-parallel step on one card is not the moe "
                       "phase's run bitwise")
    elif lead:
        failure = tp_vs_single(torch, runs, accum=1, drops=True, cfg=cfg,
                               dcfg=dcfg, donate=True)
    runs.clear()
    failures = _gathered(dist, world, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])


def tp_moe_published(torch, dist, rank: int, world: int, layers: int,
                     experts: int, measured: Path) -> None:
    """(b) on one rank of four: ``tp_moe_config(layers, experts)`` on
    ``TP_MOE_MESH``, batch ``MOE_BATCH`` x ``MOE_SEQ``, ``TP_MOE_STEPS``
    Muon and as many AdamW steps with ``donate``: the loss falling
    (``loss_falls``), launches from the plan, step / optimizer ms and peak
    GB per card (the peaks written to ``measured`` for the parent)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh

    lead = rank == 0
    mesh = make_mesh(TP_MOE_MESH, ("data", "model"), "cuda")
    cfg = tp_moe_config(layers, experts)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH)
    peaks, rows, missed = {}, {}, []
    for variant in ("muon", "adamw"):
        run = train_run(torch, variant, "owner", mesh, cfg=cfg, dcfg=dcfg,
                        donate=True, tensor_parallel=True,
                        steps=TP_MOE_STEPS)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        per_rank = _gathered(dist, world, timing)
        falls = loss_falls(run["loss_ema"], TP_MOE_WINDOW)
        rows[variant] = {"loss_ema": run["loss_ema"], **falls,
                         "per_rank": per_rank}
        peaks["owner" if variant == "muon" else "adamw"] = [
            r["peak_mem_gb"] for r in per_rank]
        if lead:
            emit({"phase": "tp_moe", "arch": cfg.name, "variant": variant,
                  "mesh": list(TP_MOE_MESH), "n_layers": layers,
                  "n_experts": experts, **rows[variant]})
        if not falls["falls"]:
            missed.append(f"{cfg.name} {variant}: the mean loss of the last "
                          f"{TP_MOE_WINDOW} steps is not below the first "
                          f"{TP_MOE_WINDOW}'s: {falls}")
        del run
        gc.collect()
        torch.cuda.empty_cache()
    if missed:
        raise AssertionError("; ".join(missed))
    if lead:
        steady = {v: [{k: sum(r[k][1:]) / len(r[k][1:])
                       for k in ("step_ms", "optimizer_ms")}
                      for r in rows[v]["per_rank"]] for v in rows}
        emit({"phase": "tp_moe", "arch": cfg.name,
              "mesh": list(TP_MOE_MESH), "n_layers": layers,
              "n_experts": experts,
              "cut": {"n_layers": [layers, 61], "n_experts": [experts, 256],
                      "note": "[cut, published]; every width as published"},
              "batch": [MOE_BATCH, MOE_SEQ], "params": cfg.param_count(),
              "loss_ema": {v: r["loss_ema"] for v, r in rows.items()},
              "steady_mean_ms_per_rank": steady,
              "owner_over_adamw_per_rank": [
                  {k: m[k] / a[k] for k in m}
                  for m, a in zip(steady["muon"], steady["adamw"])]})
        measured.write_text(json.dumps(peaks))


# ------------------------------------------------------------------ zero3

# ZeRO-3 (``param_specs(..., zero3=True)``: the block weights also split
# over 'data', gathered a layer at a time).  One card: smollm-360m on
# (1, 1), bitwise the train phase's run.  Four cards: (a) smollm-360m on
# each mesh of ``ZERO3_MESHES`` and the moe phase's DeepSeek-V3 cut on
# ``ZERO3_MOE_MESH``, each held to one card by ``tp_gate``; (b)
# nemotron-4-340b (arXiv:2402.16819) at its published widths on
# ``NEMO_MESH`` under the reference's >= 340 B policy (bf16 parameters,
# ``NEMO_MUON`` state, ``NEMO_NS`` Gram NS, bf16 accumulation of
# ``NEMO_ACCUM`` microbatches), at the first (layers, sequence,
# vocabulary) of ``NEMO_CUTS`` whose walk (``zero3_predict``) fits
# ``HBM_BYTES``: the depth first, the sequence before the width.  On
# (2, 2) the vocabulary-parallel embedding and head are split two ways,
# and their fp32 AdamW moments, bf16 parameters, gradients and updates
# take 66 GB a card at the published 256000 (the walk: 103 GB at one
# layer, whatever the sequence: the peak is the optimizer's), so the
# vocabulary is the one width cut, in halves.  Step 1 is held to a run of
# the same cut on ``NEMO_CMP_MESH`` (tensor-parallel only) by
# ``tp_gate``, on a grid of entries of every leaf (``NEMO_SAMPLE``), each
# from the rank that holds it (whole captures of 10 B parameters would not
# fit beside the run)
ZERO3_MESHES = [(2, 2), (4, 1)]
ZERO3_MOE_MESH = (2, 2)
NEMO = "nemotron-4-340b"
NEMO_MESH, NEMO_CMP_MESH = (2, 2), (1, 4)
NEMO_VOCAB = 256000
# the first, the least of the published vocabulary's, is the witness that
# it fits at no depth or sequence
NEMO_CUTS = [(1, 2048, NEMO_VOCAB), (2, 4096, NEMO_VOCAB // 2),
             (1, 4096, NEMO_VOCAB // 2), (2, 4096, NEMO_VOCAB // 4)]
NEMO_BATCH, NEMO_ACCUM, NEMO_STEPS = 4, 2, 3
NEMO_MUON = dict(momentum_dtype="bfloat16", pack_dtype="bfloat16")
NEMO_NS = dict(compute_dtype="bfloat16", owner_chunk=8)
# (b)'s gate takes each dim's first and last NEMO_SAMPLE entries and
# NEMO_SAMPLE spread over it (``sample_grid``): every rank's part, far
# offsets included
NEMO_SAMPLE = 256
# median of this many timed calls at nemotron's owner shapes (one SYRK of
# (1, 18432, 73728) in fp32 takes about a second)
NEMO_KERNEL_REPS = 5


def nemo_config(layers: int, vocab: int):
    """nemotron-4-340b at its published widths, ``layers`` layers and a
    vocabulary of ``vocab`` (bf16, remat)."""
    from repro_torch import configs
    return configs.get(NEMO, n_layers=layers, vocab=vocab)




def start_zero3_predictions() -> list:
    """The host's predicted peak of each (b) candidate of ``NEMO_CUTS`` on
    ``NEMO_MESH`` with ZeRO-3 and without (``zero3_predict``,
    ``start_walks``)."""
    return start_walks("zero3_predict", {
        f"{'zero3' if zero3 else 'tp'}_{layers}x{seq}x{vocab}":
        ("zero3_predict", (layers, seq, vocab, zero3))
        for layers, seq, vocab in NEMO_CUTS for zero3 in (True, False)})


def nemo_muon():
    """(b)'s ``MuonConfig``: ``train_run``'s, under the >= 340 B policy."""
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    return MuonConfig(variant="muon", mode="owner", pipeline="fused",
                      autotune_prewarm=False,
                      ns=GramNSConfig(use_kernels=True, **NEMO_NS),
                      **NEMO_MUON)


def zero3_predict(layers: int, seq: int, vocab: int, zero3: bool,
                  out: str) -> None:
    """The dry run's walk (``launch.dryrun.walk_cell``) of one (b) run:
    ``nemo_config(layers, vocab)``, batch ``NEMO_BATCH`` x ``seq`` in
    ``NEMO_ACCUM`` microbatches on a fake world of ``NEMO_MESH``, with
    ``nemo_muon``'s settings, with ZeRO-3 (and bf16 accumulation) or
    without; its JSON to ``out``."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import walk_cell
    shape = ShapeSpec("zero3", seq, NEMO_BATCH, "train")
    result = walk_cell(nemo_config(layers, vocab), NEMO, shape, NEMO_MESH,
                       "owner", muon=nemo_muon(), accum=NEMO_ACCUM,
                       zero3=zero3)
    Path(out).write_text(json.dumps(result, default=str))


def zero3_cut(predicted: dict) -> tuple:
    """The first (layers, sequence, vocabulary) of ``NEMO_CUTS`` whose
    predicted peak with ZeRO-3 is within ``HBM_BYTES``."""
    from repro_torch.launch.mesh import HBM_BYTES
    for cut in NEMO_CUTS:
        if predicted["zero3_{}x{}x{}".format(*cut)]["peak_gb"] * 1e9 <= \
                HBM_BYTES:
            return cut
    raise AssertionError(f"no cut of {NEMO_CUTS} is predicted within "
                         f"{HBM_BYTES / 1e9} GB a card: {predicted}")


def phase_zero3(torch, smi: str, cells: list, train_ref) -> None:
    """Every visible card, one NCCL rank each (spawned, as the tp phase's),
    through the ZeRO-3 step.  One card: (1, 1) bitwise the train phase's
    run (``train_ref``: its loss_ema and ``param_digest``; run here where
    that phase did not).  Four: (a) (``zero3_gates``), then, after the
    predictions of ``cells`` (``start_zero3_predictions``) pick the (b)
    cut and its kernels run on this card in bf16, (b)
    (``zero3_published``); its peaks beside the walk's, within
    ``PEAK_GATE``, and the walk's peak of the same cut without ZeRO-3."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    if world != math.prod(NEMO_MESH):
        mp.start_processes(nccl_rank, args=(world, free_port(), "zero3_one",
                                            train_ref),
                           nprocs=world, start_method="spawn", join=True)
        emit({"phase": "zero3", "check": "done", "world": world,
              "skipped": f"(a) and (b) need {math.prod(NEMO_MESH)} cards",
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
        return
    mp.start_processes(nccl_rank, args=(world, free_port(), "zero3_gates"),
                       nprocs=world, start_method="spawn", join=True)
    predicted = tp_predictions(cells)
    layers, seq, vocab = zero3_cut(predicted)
    tag = f"{layers}x{seq}x{vocab}"
    emit({"phase": "zero3", "check": "cut", "arch": NEMO,
          "n_layers": layers, "seq_len": seq, "vocab": vocab,
          "published": {"n_layers": 96, "vocab": NEMO_VOCAB},
          "cuts": NEMO_CUTS,
          "predicted_peak_gb": {k: v["peak_gb"] for k, v in
                                predicted.items()},
          "prediction_walk_seconds": {k: v["walk_seconds"] for k, v in
                                      predicted.items()}})
    owner_kernels(torch, nemo_config(layers, vocab), NEMO_MESH,
                  {"phase": "zero3", "arch": NEMO, "n_layers": layers},
                  dtype=torch.bfloat16, reps=NEMO_KERNEL_REPS)
    torch.cuda.empty_cache()
    out = ROOT / "build" / "zero3_phase"
    out.mkdir(parents=True, exist_ok=True)
    measured = out / "nemo.json"
    measured.unlink(missing_ok=True)
    mp.start_processes(nccl_rank, args=(world, free_port(), "zero3_published",
                                        layers, seq, vocab, measured),
                       nprocs=world, start_method="spawn", join=True)
    got = json.loads(measured.read_text())
    want = predicted[f"zero3_{tag}"]["peak_gb"]
    ratio = want / max(got)
    emit({"phase": "zero3", "check": "peak_vs_dryrun", "arch": NEMO,
          "mesh": list(NEMO_MESH), "n_layers": layers, "seq_len": seq,
          "vocab": vocab, "measured_peak_gb_per_card": got,
          "predicted_peak_gb": want,
          "predicted_over_measured": ratio, "gate": PEAK_GATE,
          "predicted_peak_gb_without_zero3":
          predicted[f"tp_{tag}"]["peak_gb"],
          "world": world, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    if abs(ratio - 1) > PEAK_GATE:
        raise AssertionError(f"(b) peak off the dry run's by more than "
                             f"{PEAK_GATE}: {ratio}")




def zero3_one(torch, dist, rank: int, world: int, train_ref) -> None:
    """One card: full-width smollm-360m (``train_run``'s, 3 steps) through
    the ZeRO-3 step on (1, 1), launches from the plan every step; its
    loss_ema and ``param_digest`` bitwise the train phase's run
    (``train_ref``; run here without it)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    run = train_run(torch, "muon", "owner", mesh, tensor_parallel=True,
                    zero3=True, digest=True)
    if train_ref is None:
        single = train_run(torch, "muon", digest=True)
        train_ref = {k: single[k] for k in ("loss_ema", "digest")}
        del single
    same = run["digest"] == train_ref["digest"] and \
        run["loss_ema"] == train_ref["loss_ema"]
    emit({"phase": "zero3", "check": "world1_vs_train_phase",
          "arch": run["arch"], "bitwise_params":
          run["digest"] == train_ref["digest"],
          "loss_ema": run["loss_ema"],
          "train_loss_ema": train_ref["loss_ema"],
          "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                                run["launches"].items()},
          "step_ms": run["step_ms"], "optimizer_ms": run["optimizer_ms"],
          "peak_mem_gb": run["peak_mem_gb"]})
    if not same:
        raise AssertionError("the ZeRO-3 step on one card is not the train "
                             "phase's run bitwise")


def zero3_gates(torch, dist, rank: int, world: int) -> None:
    """(a) on one rank of four: full-width smollm-360m (``TRAIN_STEPS``
    steps) on each mesh of ``ZERO3_MESHES``, then the moe phase's
    DeepSeek-V3 cut (``moe_config``, ``donate``, drops printed) on
    ``ZERO3_MOE_MESH``, each through the ZeRO-3 step and held to one
    card's run on the same batches by ``tp_gate`` (``tp_vs_single``:
    smollm's batch in as many microbatches as the mesh has data ranks,
    DeepSeek-V3's whole, one dispatch)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_fns
    from repro_torch.models.sharding import param_specs

    lead = rank == 0
    failures = []

    def run_on(shape, **kw):
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        extra = kw.pop("drops", None)
        before = None
        if extra is not None:
            cfg = kw["cfg"]
            specs = param_specs(cfg, model_fns(cfg).init(cfg, device="meta"),
                                mesh, zero3=True)
            before = drop_counter(torch, cfg, mesh, *extra, specs=specs)
        run = train_run(torch, "muon", "owner", mesh, capture="host",
                        grads=True, tensor_parallel=True, zero3=True,
                        before_step=before, **kw)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb")}
        per_rank = _gathered(dist, world, {
            **timing, "dropped": None if extra is None else extra[0]})
        if lead:
            # the global rule drops the last data ranks' assignments;
            # model ranks repeat their data rank's count
            emit({"phase": "zero3", "arch": run["arch"], "mesh": list(shape),
                  "n_layers": run["cfg"].n_layers, "loss_ema": run["loss_ema"],
                  "dropped_by_step": None if extra is None else [
                      sum(r["dropped"][i] for j, r in enumerate(per_rank)
                          if j % shape[1] == 0)
                      for i in range(len(extra[0]))],
                  "launches_per_step": {k: v // TRAIN_STEPS for k, v in
                                        run["launches"].items()},
                  "per_rank": per_rank})
        return run if lead else None

    runs = {shape: run_on(shape) for shape in ZERO3_MESHES}
    if lead:
        failures.append(tp_vs_single(torch, runs))
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_config()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH)
    moe_runs = {ZERO3_MOE_MESH: run_on(ZERO3_MOE_MESH, cfg=cfg, dcfg=dcfg,
                                       donate=True, drops=([], []))}
    gc.collect()
    torch.cuda.empty_cache()
    if lead:
        failures.append(tp_vs_single(torch, moe_runs, accum=1, drops=True,
                                     cfg=cfg, dcfg=dcfg, donate=True))
    moe_runs.clear()
    failed = _gathered(dist, world, [f for f in failures if f])
    if failed[0]:
        raise AssertionError("; ".join(failed[0]))


def zero3_published(torch, dist, rank: int, world: int, layers: int,
                    seq: int, vocab: int, measured: Path) -> None:
    """(b) on one rank of four: ``nemo_config(layers, vocab)``, batch
    ``NEMO_BATCH`` x ``seq`` in ``NEMO_ACCUM`` microbatches, ``NEMO_STEPS``
    Muon steps with ``donate`` under the >= 340 B policy, through the
    ZeRO-3 step on ``NEMO_MESH`` (finite losses, launches from the plan,
    step / optimizer ms and peak GB per card, the peaks written to
    ``measured`` for the parent); then the same on ``NEMO_CMP_MESH``
    without ZeRO-3, from the same parameters and from them with a random
    half of their entries one ulp up: step 1 held to it by ``tp_gate``
    on every leaf's ``sample_grid(n, NEMO_SAMPLE)`` entries, each taken
    from the rank that holds it (``sampled_part``, ``sampled_whole``)."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh

    lead = rank == 0
    cfg = nemo_config(layers, vocab)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=NEMO_BATCH)
    common = dict(cfg=cfg, dcfg=dcfg, donate=True, tensor_parallel=True,
                  steps=NEMO_STEPS, accum_steps=NEMO_ACCUM,
                  accum_dtype=torch.bfloat16, knobs=NEMO_MUON, ns=NEMO_NS,
                  capture="host", grads=True, sample=NEMO_SAMPLE)
    gen = torch.Generator("cuda").manual_seed(11)

    def ulp(params):
        for _, v in tree.flatten(params):
            v.copy_(one_ulp_up(torch, v, gen))
    runs, rows = {}, {}
    for name, shape, zero3, hook in (
            ("zero3", NEMO_MESH, True, None),
            ("tp", NEMO_CMP_MESH, False, None),
            ("tp_ulp", NEMO_CMP_MESH, False, ulp)):
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        run = train_run(torch, "muon", "owner", mesh, zero3=zero3,
                        init_hook=hook, **common)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        rows[name] = {"loss_ema": run["loss_ema"],
                      "per_rank": _gathered(dist, world, timing)}
        whole = {q: sampled_whole(torch, dist, world, caps, NEMO_SAMPLE)
                 for q, caps in (("grads", {p: g[0] for p, g in
                                            run["first_grads"].items()}),
                                 ("updates", run["first_updates"]),
                                 ("params", run["final_params"]))}
        if lead:
            # the sampled entries: how far the bf16 Gram NS's first update
            # and the parameters after the steps reach
            emit({"phase": "zero3", "arch": cfg.name, "run": name,
                  "mesh": list(shape), "n_layers": layers, "seq_len": seq,
                  "vocab": vocab,
                  "batch": NEMO_BATCH, "accum_steps": NEMO_ACCUM,
                  "params": cfg.param_count(),
                  "max_abs_update_step1": {
                      p: float(u.float().abs().max())
                      for p, u in whole["updates"].items()},
                  "max_abs_param_last": {
                      p: float(v.float().abs().max())
                      for p, v in whole["params"].items()},
                  **rows[name]})
            runs[name] = {"loss": {"": torch.tensor(run["loss_ema"][0])},
                          **whole,
                          "loss_ema": {"": torch.tensor(run["loss_ema"][-1])}}
            matrices = set(run["plan"].leaves)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    failure = None
    if lead:
        measured.write_text(json.dumps(
            [r["peak_mem_gb"] for r in rows["zero3"]["per_rank"]]))
        # every quantity but the loss is bf16 (parameters, bf16-accumulated
        # gradients, updates): one ulp of them is bf16's
        gate = tp_gate(torch, runs["zero3"], runs["tp"], runs["tp_ulp"],
                       matrices, ulp=torch.finfo(torch.bfloat16).eps)
        worst = sorted(gate["per_leaf"].items(),
                       key=lambda kv: -kv[1]["ratio"])[:8]
        emit({"phase": "zero3", "check": "zero3_vs_tp", "arch": cfg.name,
              "n_layers": layers, "seq_len": seq, "mesh": list(NEMO_MESH),
              "reference": f"{list(NEMO_CMP_MESH)} without ZeRO-3",
              "sample": NEMO_SAMPLE, "ratios": gate["ratios"],
              "factor": gate["factor"], "worst_leaves": dict(worst)})
        if gate["factor"] > 1:
            failure = (f"ZeRO-3 step of {cfg.name} misses the gate: "
                       f"ratios {gate['ratios']}")
    failures = _gathered(dist, world, failure)
    if failures[0] is not None:
        raise AssertionError(failures[0])


# -------------------------------------------------------------------- main

# --------------------------------------------------------------------- moe

# DeepSeek-V3 at its published widths, cut in depth and experts: 2 layers
# (every layer is MoE, so one is a whole period; two keep L > 1 in every
# stacked group) and 16 routed experts (each layer's 256 as if divided
# over 16 cards: the reference's own MoEConfig override, 16 router outputs)
MOE_LAYERS, MOE_EXPERTS = 2, 16
MOE_BATCH, MOE_SEQ = 4, 1024
MOE_ADAMW_STEPS = 3
MOE_REPS = 20
# its Gram groups: SYRK (B, m, n), and (B, m) of symmul / gram_poly
MOE_SYRK = [(32, 2048, 7168), (2, 2048, 7168), (2, 1536, 7168),
            (2, 1536, 24576), (2, 576, 7168), (2, 512, 32768),
            (2, 7168, 16384)]
MOE_GRAM = [(32, 2048), (2, 2048), (2, 1536), (2, 576), (2, 512), (2, 7168)]
MOE_DISPATCH_TOKENS = 64
MOE_DISPATCH_RTOL = 1e-5
# the kernel update's RMS distance from the exact (float64) update, at most
# this many times the plain fp32 path's own: the kernels are no less
# accurate than IEEE fp32 math.  The variants phase's gate (10x the plain
# path's one-ulp spread) assumes the plain path's rounding is below that
# spread, which its fp32 sums over n up to 32768 are not (PERF.md §6)
EXACT_UPDATE_FACTOR = 1
# the families phase's factor: at hymba's m = 100 and 132 the Gram
# products contract over so few terms that fp32's accumulation error no
# longer hides 3xTF32's per-product representation error (≈ 2^-22 against
# fp32's 2^-24 rounding), and the kernel update sits 1.04-1.11x the plain
# path's distance (PERF.md §6); every m >= 320 group reads 0.22-0.38
FAMILY_UPDATE_FACTOR = 2


def moe_config():
    """DeepSeek-V3 at its published widths, ``MOE_LAYERS`` layers and
    ``MOE_EXPERTS`` routed experts (bf16, remat, capacity factor 1.25)."""
    from repro_torch import configs
    base = configs.get("deepseek-v3-671b")
    return configs.get("deepseek-v3-671b", n_layers=MOE_LAYERS,
                       moe=dataclasses.replace(base.moe,
                                               n_experts=MOE_EXPERTS))


def gram_kernel_cases(torch, gen, syrk_shapes, gram_shapes, dtype=None):
    """``kernel_cases`` tuples at a model's Gram shapes (SYRK at each
    (B, m, n), symmul and gram_poly at each (B, m)), one at a time (their
    inputs reach several GB), fp32 under the scaled gate; with ``dtype``
    bf16, bf16 under ``BF16_GATE`` (``bf16_gram_cases``)."""
    from repro_torch.core.coefficients import get_coefficients
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_syrk import syrk_plain, syrk_tf32_emulated
    from repro_torch.kernels.symmul import symmul_plain, symmul_tf32_emulated
    coeffs = get_coefficients("polar_express", 5)[0]
    if dtype == torch.bfloat16:
        yield from bf16_gram_cases(torch, gen, syrk_shapes, gram_shapes,
                                   coeffs)
        return
    tc32 = dict(scaled=EXACT_GATE)
    for shape in syrk_shapes:
        x = syrk_inputs(torch, gen, *shape)
        yield ("gram_syrk", shape, torch.float32, tc32,
               lambda x=x: ops.syrk(x), lambda x=x: syrk_plain(x),
               lambda x=x: torch.matmul(x, x.mT), lambda x=x: syrk_plain(x),
               lambda x=x: syrk_tf32_emulated(x, passes=1),
               lambda x=x: exact_syrk(x))
        del x
    for b, m in gram_shapes:
        _, g, p = gram_inputs(torch, gen, b, m, 2 * m, torch.float32, coeffs)
        yield ("symmul_plain", (b, m, m), torch.float32, tc32,
               lambda p=p, g=g: ops.symmul(p, g),
               lambda p=p, g=g: symmul_plain(p, g),
               lambda p=p, g=g: torch.matmul(p, g),
               lambda p=p, g=g: symmul_plain(p, g),
               lambda p=p, g=g: symmul_tf32_emulated(p, g, passes=1),
               lambda p=p, g=g: exact_symmul(p, g))
        yield ("symmul_gram_poly", (b, m, m), torch.float32, tc32,
               lambda g=g: ops.gram_poly(g, *coeffs),
               lambda g=g: symmul_plain(g, g, epilogue="gram_poly",
                                        coeffs=coeffs),
               lambda g=g: torch.matmul(g, g),
               lambda g=g: coeffs[2] * symmul_plain(g, g),
               lambda g=g: symmul_tf32_emulated(
                   g, g, epilogue="gram_poly", coeffs=coeffs, passes=1),
               lambda g=g: exact_gram_poly(g, coeffs))
        del g, p


def bf16_gram_cases(torch, gen, syrk_shapes, gram_shapes, coeffs):
    """``gram_kernel_cases`` in bf16 (the bf16 wgmma mainloop, as the
    >= 340 B policy's Gram NS runs): each kernel against its plain
    version's fp32 product by parts (``BF16_GATE``), the library product
    one bf16 ``torch.matmul``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_syrk import syrk_plain
    from repro_torch.kernels.symmul import symmul_plain
    bf16, f32, tol = torch.bfloat16, torch.float32, dict(parts=BF16_GATE)
    for shape in syrk_shapes:
        x = gram_inputs(torch, gen, *shape, bf16, coeffs)[0]
        yield ("gram_syrk", shape, bf16, tol, lambda x=x: ops.syrk(x),
               lambda x=x: syrk_plain(x), lambda x=x: torch.matmul(x, x.mT),
               lambda x=x: syrk_plain(x), None,
               lambda x=x: syrk_plain(x, out_dtype=f32))
        del x
    for b, m in gram_shapes:
        _, g, p = gram_inputs(torch, gen, b, m, 2 * m, bf16, coeffs)
        yield ("symmul_plain", (b, m, m), bf16, tol,
               lambda p=p, g=g: ops.symmul(p, g),
               lambda p=p, g=g: symmul_plain(p, g),
               lambda p=p, g=g: torch.matmul(p, g),
               lambda p=p, g=g: symmul_plain(p, g), None,
               lambda p=p, g=g: symmul_plain(p, g, out_dtype=f32))
        yield ("symmul_gram_poly", (b, m, m), bf16, tol,
               lambda g=g: ops.gram_poly(g, *coeffs),
               lambda g=g: symmul_plain(g, g, epilogue="gram_poly",
                                        coeffs=coeffs),
               lambda g=g: torch.matmul(g, g),
               lambda g=g: coeffs[2] * symmul_plain(g.float(), g.float()),
               None,
               lambda g=g: symmul_plain(g, g, epilogue="gram_poly",
                                        coeffs=coeffs, out_dtype=f32))
        del g, p


def moe_dispatch(torch, cfg, gen) -> dict:
    """The sort-based dispatch at full width in fp32 on
    ``MOE_DISPATCH_TOKENS`` tokens, at a capacity factor that drops nothing
    (C = T), against a per-token loop: softmax, top-k, gates renormalised,
    the chosen experts' SwiGLU outputs summed in k order plus the shared
    expert's; within ``MOE_DISPATCH_RTOL`` · max|want|.  Counts the
    assignments dropped at the configured capacity factor, on these tokens
    and on a batch of the training phase's size."""
    import torch.nn.functional as F

    from repro_torch.models import layers, moe as moe_lib
    c = cfg.moe
    nodrop = dataclasses.replace(c, capacity_factor=c.n_experts / c.top_k)
    p = moe_lib.moe_init(gen, c, dtype=torch.float32, device="cuda")
    x = torch.randn(1, MOE_DISPATCH_TOKENS, c.d_model, generator=gen,
                    device="cuda")
    ex = p["experts"]
    with torch.no_grad():
        got = moe_lib.moe(p, nodrop, x)[0]
        rows = []
        for v in x[0]:
            g, e = torch.topk(torch.softmax(v @ p["router_w"], -1), c.top_k)
            g = g / g.sum()
            y = torch.zeros_like(v)
            for gk, ek in zip(g, e.tolist()):
                h = F.silu(v @ ex["gate_proj"]["w"][ek]) * \
                    (v @ ex["up_proj"]["w"][ek])
                y = y + gk * (h @ ex["down_proj"]["w"][ek])
            rows.append(y + layers.mlp(p["shared"], v, "swiglu"))
        want = torch.stack(rows)
        err = max_abs_err(got, want)
        top = float(want.abs().max())
        big = torch.randn(MOE_BATCH, MOE_SEQ, c.d_model, generator=gen,
                          device="cuda")
        out = {"tokens": MOE_DISPATCH_TOKENS, "max_abs_err": err,
               "max_abs_want": top, "rtol": MOE_DISPATCH_RTOL,
               "dropped_nodrop_cf": moe_lib.dropped(p, nodrop, x),
               "capacity_factor": c.capacity_factor,
               "dropped": moe_lib.dropped(p, c, x),
               "assignments": MOE_DISPATCH_TOKENS * c.top_k,
               "dropped_train_size": moe_lib.dropped(p, c, big),
               "assignments_train_size": MOE_BATCH * MOE_SEQ * c.top_k,
               "capacity_train_size": moe_lib.capacity(c, MOE_BATCH
                                                       * MOE_SEQ)}
    if not (err <= MOE_DISPATCH_RTOL * top and out["dropped_nodrop_cf"] == 0):
        raise AssertionError(f"moe dispatch vs per-token loop: {out}")
    return out


def first_grads(torch, cfg, dcfg, plan):
    """Seed-0 parameters and batch 0's gradients, twice: whether the two
    forward / backward passes agree bit for bit (printed, not gated), and
    the Muon matrices' gradients and parameters in fp32 (exact casts of
    the bf16 ones)."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import model_fns
    from repro_torch.train.step import make_loss_fn
    params = model_fns(cfg).init(cfg, seed=0, device="cuda")
    paths, leaves = zip(*tree.flatten(params))
    for v in leaves:
        v.requires_grad_(True)
    batch = batch_for_step(dcfg, 0, device="cuda")
    loss_fn = make_loss_fn(cfg)
    runs = []
    for _ in range(2):
        loss = loss_fn(params, batch)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = runs
    same = bool(torch.equal(l0, l1)) and all(
        torch.equal(a, b) for a, b in zip(g0, g1))
    differ = [p for p, a, b in zip(paths, g0, g1) if not torch.equal(a, b)]
    del runs, g1
    grads = {p: g.float() for p, g in zip(paths, g0) if p in plan.leaves}
    pm = {p: v.detach().float() for p, v in zip(paths, leaves)
          if p in plan.leaves}
    return grads, pm, {"bitwise": same, "loss": float(l0),
                       "leaves_differing": differ}


def exact_gram_ns(x, coeffs):
    """``core/gram_ns.py``'s recurrence in float64 without kernels: X₀ =
    X / (‖X‖_F + 1e-7) per matrix, G₀ = X₀X₀ᵀ, per step P = aI + bG + cG²,
    Q' = PQ, T = PG, G' = PT, then Q_k X₀; ``x`` (B, m, n) with m <= n."""
    x0 = x / (x.square().sum(dim=(-2, -1), keepdim=True).sqrt() + 1e-7)
    g = x0 @ x0.mT
    q = None
    for i, (a, b, c) in enumerate(coeffs):
        p = c * (g @ g) + b * g
        p.diagonal(dim1=-2, dim2=-1).add_(a)
        q = p if q is None else p @ q
        if i != len(coeffs) - 1:
            g = p @ (p @ g)
    return q @ x0


def exact_updates(torch, plan, grads, pm, cfg):
    """{path: update} of one group at a time: the first Muon update (zero
    momentum) computed in float64, the exact value the fp32 paths
    approximate."""
    from repro_torch.core.owner_comms import pack_group, unpack_group
    from repro_torch.core.update_rules import momentum_update, scale_factor
    coeffs = cfg.ns.coeffs()
    for key, grp in plan.groups.items():
        eff = {}
        for p in grp.leaf_paths:
            g64 = grads[p].double()
            eff[p] = momentum_update(torch.zeros_like(g64), g64, cfg)[1]
        o = exact_gram_ns(pack_group(plan, key, eff), coeffs)
        del eff
        o *= scale_factor(*grp.key, cfg.scale_mode)
        yield key, {p: -cfg.learning_rate * (
            u + cfg.weight_decay * pm[p].double())
            for p, u in unpack_group(plan, key, o).items()}
        del o


def updates_vs_exact(torch, plan, grads, pm,
                     factor: float = EXACT_UPDATE_FACTOR
                     ) -> tuple[dict, list]:
    """The first Muon update of every group from the same gradients, in
    fp32 (the parameters passed as fp32 copies, so no bf16 rounding hides
    a difference): with the kernels, with the plain Gram NS, and with the
    plain Gram NS at one TF32 pass per product, each held against the
    exact (float64) update by the RMS of the difference (a max over
    entries swings with the few entries along a matrix's smallest
    singular directions).  Per group the kernel path must be within
    ``factor`` times the plain fp32 path's own distance from
    it, and one TF32 pass at least ``VARIANT_SPREAD`` times outside that
    allowance over all groups.  The variants phase's gate (the kernel
    update within ``VARIANT_SPREAD`` times what one ulp on half the
    gradients moves the plain update) is printed per group.  Then
    ``pipeline="bucketed"`` (one stage per Gram bucket) against the fused
    update, bitwise."""
    from repro_torch.core import api
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    gen = torch.Generator("cuda").manual_seed(5)

    def opt_for(use_kernels, pipeline="fused"):
        return api.Muon(plan, config=MuonConfig(
            pipeline=pipeline, ns=GramNSConfig(use_kernels=use_kernels)),
            device="cuda")

    def update(use_kernels, g=grads, tf32=False, pipeline="fused"):
        opt = opt_for(use_kernels, pipeline)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return opt.update(g, opt.init(pm), pm, donate=True)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    plain = update(False)
    g_ulp = {p: one_ulp_up(torch, g, gen) for p, g in grads.items()}
    spread = leaf_diffs(update(False, g_ulp), plain)
    del g_ulp
    tf32 = update(False, tf32=True)
    kern = update(True)
    bucketed = update(True, pipeline="bucketed")
    same_bucketed = all(torch.equal(bucketed[p], v) for p, v in kern.items())
    del bucketed
    rows, failures = {}, []
    top_allow = top_tf32 = 0.0
    for key, exact in exact_updates(torch, plan, grads, pm,
                                    opt_for(False).config):
        for p, want in exact.items():
            e_kern = rms_err(kern[p], want)
            e_plain = rms_err(plain[p], want)
            e_tf32 = rms_err(tf32[p], want)
            d = max_abs_err(kern[p], plain[p])
            allow = factor * e_plain
            top_allow, top_tf32 = max(top_allow, allow), max(top_tf32,
                                                             e_tf32)
            rows[p] = {"kernel_vs_exact_rms": e_kern,
                       "plain_vs_exact_rms": e_plain,
                       "tf32_vs_exact_rms": e_tf32,
                       "kernel_vs_exact_max": max_abs_err(kern[p], want),
                       "plain_vs_exact_max": max_abs_err(plain[p], want),
                       "rms_update": float(want.square().mean().sqrt()),
                       "kernel_over_plain": e_kern / e_plain
                       if e_plain else math.inf,
                       "kernel_vs_plain": d,
                       "plain_one_ulp_spread": spread[p][0],
                       "kernel_over_spread": d / spread[p][0]
                       if spread[p][0] else math.inf}
            if e_kern > allow:
                failures.append(f"{p}: kernel update {e_kern:.3e} from the "
                                f"exact one, the plain path {e_plain:.3e}")
        del exact
    tf32_over_gate = top_tf32 / top_allow if top_allow else math.inf
    if tf32_over_gate < VARIANT_SPREAD:
        failures.append(f"one TF32 pass {top_tf32:.3e} is only "
                        f"{tf32_over_gate:.1f}x the allowance")
    if not same_bucketed:
        failures.append("bucketed update != fused update")
    return {"groups": rows, "factor": factor,
            "tf32_over_gate": tf32_over_gate,
            "bucketed_bitwise_fused": same_bucketed,
            "buckets": len(plan.buckets)}, failures


def phase_moe(torch, smi: str) -> dict:
    """DeepSeek-V3 at its published widths (``moe_config``) on one card:
    the kernels at its Gram shapes, the dispatch against a per-token loop,
    the kernel update against the plain one and bucketed against fused,
    then ``TRAIN_STEPS`` Muon steps (owner, fused, one owner, kernels on,
    launches asserted per step from the plan) and ``MOE_ADAMW_STEPS``
    AdamW steps, batch ``MOE_BATCH`` x ``MOE_SEQ``, remat on, seed 0, the
    optimizer releasing each spent state (``donate``).  Returns the Muon
    run's launches, and its loss_ema and ``param_digest`` (for the tp_moe
    phase's one-card check)."""
    from repro_torch.core import api
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    cfg = moe_config()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH)
    plan = api.dedicate_params(transformer.init(cfg, device="meta"))
    cut = {"arch": cfg.name, "n_layers": [cfg.n_layers, 61],
           "n_experts": [cfg.moe.n_experts, 256],
           "note": "[cut, published]; every width as published",
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "mla": dataclasses.asdict(cfg.mla), "d_expert": cfg.moe.d_expert,
           "top_k": cfg.moe.top_k, "n_shared": cfg.moe.n_shared,
           "vocab": cfg.vocab, "dtype": cfg.param_dtype,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "groups": {k: [plan.groups[k].count, *plan.groups[k].key]
                      for k in plan.groups},
           "buckets": sorted(plan.buckets),
           "launches_per_step": plan_launches(plan)}
    emit({"phase": "moe", "config": cut, "nvidia_smi": smi})

    gen = torch.Generator("cuda").manual_seed(0)
    for case in gram_kernel_cases(torch, gen, MOE_SYRK, MOE_GRAM):
        emit({"phase": "moe", "nvidia_smi": smi,
              **check_kernel_case(torch, case, MOE_REPS)})
        del case
        torch.cuda.empty_cache()

    emit({"phase": "moe", "check": "dispatch",
          **moe_dispatch(torch, cfg, gen)})
    torch.cuda.empty_cache()

    grads, pm, passes = first_grads(torch, cfg, dcfg, plan)
    emit({"phase": "moe", "check": "two_passes", **passes})
    torch.cuda.empty_cache()
    cmp, failures = updates_vs_exact(torch, plan, grads, pm)
    del grads, pm
    torch.cuda.empty_cache()
    emit({"phase": "moe", "check": "update", "ok": not failures, **cmp})
    if failures:
        raise AssertionError("; ".join(failures))

    lines = {}
    for variant, steps in (("muon", TRAIN_STEPS), ("adamw", MOE_ADAMW_STEPS)):
        torch.cuda.empty_cache()
        run = train_run(torch, variant, cfg=cfg, dcfg=dcfg, steps=steps,
                        donate=True, digest=variant == "muon")
        tokens = MOE_BATCH * MOE_SEQ
        lines[variant] = {
            "phase": "moe", "variant": variant, "arch": run["arch"],
            "steps": steps, "loss_ema": run["loss_ema"],
            "step_ms": run["step_ms"], "optimizer_ms": run["optimizer_ms"],
            "tokens_per_s": [tokens / (t / 1e3) for t in run["step_ms"]],
            "peak_mem_gb": run["peak_mem_gb"],
            "launches_by_step": run["launches_by_step"],
            "nvidia_smi": smi}
        emit(lines[variant])
        if variant == "muon":
            launches = run["launches"]
            muon = {k: run[k] for k in ("loss_ema", "digest")}
        del run
    torch.cuda.empty_cache()
    emit({"phase": "moe", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return launches, muon


# ----------------------------------------------------------------- families
# hymba, xLSTM, the encoder-decoder and the VLM at their published widths,
# fp32, remat as configured, seed 0, Muon owner / fused / one owner.  Each
# run's batch and sequence; ``cut``: {field: (cut, published, why)}.
FAMILY_RUNS = {
    "hymba-1.5b": dict(batch=2, seq=2048, adamw=True, cut={"n_layers": (
        16, 32, "the one-card script's time: 16 layers keep global layers "
        "0 and 15 and every group shape but its depth")}),
    "xlstm-350m": dict(batch=8, seq=512, cut={}),
    "seamless-m4t-large-v2": dict(batch=2, seq=512, cut={}),
    "llava-next-mistral-7b": dict(batch=2, seq=512, cut={"n_layers": (
        4, 32, "fp32 parameters, gradients and momentum of 7.26 B "
        "parameters are ~87 GB, past the card's 80 GB; 4 rather than 8 "
        "for the one-card script's time")}),
}
FAMILY_REPS = 20
# the fp32 mixers (the SSM's doubling scan and its reverse-scan gradients,
# the mLSTM's parallel form, the sLSTM loop) and the chunked windowed
# attention against their float64 sequential / unchunked references:
# max|err| <= MIXER_GATE · max|exact|
MIXER_GATE = 1e-5


def family_config(arch: str):
    from repro_torch import configs
    cut = FAMILY_RUNS[arch]["cut"]
    return configs.get(arch, **{k: v[0] for k, v in cut.items()})


def family_inputs(torch, cfg, batch: int, mesh=None):
    """``inputs(step)`` of ``train_run`` for a frontend config: patches or
    frames (batch, frontend_len, frontend_dim), standard normal from a
    generator seeded by the step (under ``mesh``, this rank's rows of
    them, as ``models.sharding.local_batch`` takes the tokens'); None
    without a frontend."""
    from repro_torch.models.sharding import local_batch
    if cfg.frontend is None:
        return None
    key = "patches" if cfg.frontend == "patch" else "frames"

    def inputs(step: int) -> dict:
        gen = torch.Generator("cuda").manual_seed(1000 + step)
        whole = torch.randn(batch, cfg.frontend_len, cfg.frontend_dim,
                            generator=gen, device="cuda")
        return {key: whole if mesh is None else
                local_batch(whole, mesh).contiguous()}
    return inputs


def family_shapes(plans: dict) -> tuple[dict, dict]:
    """{(B, m, n): archs} of every group's SYRK and {(B, m): archs} of its
    symmul / gram_poly, over ``plans`` (one owner: B is the group's
    count)."""
    syrk, gram = {}, {}
    for arch, plan in plans.items():
        for g in plan.groups.values():
            for table, shape in ((syrk, (g.count, *g.key)),
                                 (gram, (g.count, g.key[0]))):
                archs = table.setdefault(shape, [])
                if arch not in archs:
                    archs.append(arch)
    return syrk, gram


def gated(tag: str, got, exact, gate: float = MIXER_GATE) -> dict:
    """``check_scaled`` at ``gate``, as a row."""
    err = check_scaled(tag, got, exact, gate)
    allowance = scaled_allowance(exact, gate)
    return {"max_abs_err": err, "max_abs_exact": allowance / gate,
            "err_over_allowance": err / allowance}


def scan_check(torch, cfg, gen, batch: int, seq: int,
               device: str = "cuda") -> dict:
    """``linear_scan`` (doubling scan, reverse-scan backward) on one hymba
    layer's recurrence at full width — a_bar and Δx·B (batch, seq,
    d_inner, d_state) from the layer's seeded parameters on standard-normal
    activations — against the recurrence stepped in float64 under
    autograd: h and the gradients of a and b for a random cotangent.  The
    fp32 sequential loop's distance is printed beside."""
    from repro_torch.models import ssm as ssm_lib
    p = ssm_lib.ssm_init(gen, cfg.ssm, device=device)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=device)
    with torch.no_grad():
        a, b = ssm_lib._scan_operands(p, cfg.ssm, x)[2:4]
    del p, x
    w = torch.randn(a.shape, generator=gen, device=device)
    a.requires_grad_(True)
    b.requires_grad_(True)
    h = ssm_lib.linear_scan(a, b)
    da, db = torch.autograd.grad(h, (a, b), w)
    h = h.detach()
    a64 = a.detach().double().requires_grad_(True)
    b64 = b.detach().double().requires_grad_(True)
    steps, prev = [], torch.zeros_like(a64[:, 0])
    for t in range(seq):
        prev = a64[:, t] * prev + b64[:, t]
        steps.append(prev)
    h64 = torch.stack(steps, dim=1)
    del steps, prev
    da64, db64 = torch.autograd.grad(h64, (a64, b64), w.double())
    h64 = h64.detach()
    del a64, b64, w
    with torch.no_grad():
        loop32, prev = torch.empty_like(h), torch.zeros_like(h[:, 0])
        for t in range(seq):
            prev = a[:, t] * prev + b[:, t]
            loop32[:, t] = prev
    out = {"shape": list(h.shape),
           "h": gated("linear_scan h", h, h64),
           "grad_a": gated("linear_scan grad a", da, da64),
           "grad_b": gated("linear_scan grad b", db, db64),
           "fp32_loop_h_err": max_abs_err(loop32, h64)}
    del h64, da64, db64, loop32, h, da, db
    if device == "cuda":
        w = torch.randn(a.shape, generator=gen, device=device)

        def fwd():
            with torch.no_grad():
                ssm_lib.linear_scan(a, b)

        def fwd_bwd():
            torch.autograd.grad(ssm_lib.linear_scan(a, b), (a, b), w)
        out["forward_ms"] = time_ms(fwd)
        out["forward_backward_ms"] = time_ms(fwd_bwd)
        out["tensor_gb"] = a.numel() * a.element_size() / 1e9
    return out


def window_check(torch, cfg, gen, batch: int, seq: int,
                 device: str = "cuda") -> dict:
    """The chunked online-softmax attention with hymba's sliding window
    against the unchunked masked softmax, fp32, at full width (batch, seq,
    n_heads, head_dim; GQA as configured); the window must move the output
    by at least 10x the allowance, so a chunked path that dropped it would
    fail."""
    from repro_torch.models import layers
    H, KV, hd, win = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    q = torch.randn(batch, seq, KV, H // KV, hd, generator=gen,
                    device=device)
    k = torch.randn(batch, seq, KV, hd, generator=gen, device=device)
    v = torch.randn(batch, seq, KV, hd, generator=gen, device=device)
    pos = torch.arange(seq, device=device)
    scale = 1.0 / math.sqrt(hd)
    with torch.no_grad():
        got = layers._chunked_sdpa(q, k, v, scale, pos, pos, True, win)
        want = layers._dense_sdpa(q, k, v, scale, pos, pos, True, win)
        full = layers._dense_sdpa(q, k, v, scale, pos, pos, True, None)
    out = {"shape": [batch, seq, H, hd], "window": win,
           **gated("chunked windowed attention", got, want)}
    out["window_moves_output"] = max_abs_err(full, want)
    if out["window_moves_output"] < 10 * MIXER_GATE * out["max_abs_exact"]:
        raise AssertionError(f"the window moves the output by only "
                             f"{out['window_moves_output']:.3e}")
    if device == "cuda":
        with torch.no_grad():
            out["chunked_forward_ms"] = time_ms(lambda: layers._chunked_sdpa(
                q, k, v, scale, pos, pos, True, win))
            out["dense_forward_ms"] = time_ms(lambda: layers._dense_sdpa(
                q, k, v, scale, pos, pos, True, win))
    return out


def mlstm_sequential(q, k, v, ig, fg):
    """The stabilised mLSTM recurrence stepped in time (float64 in, out):
    m_t = max(f_t + m_{t−1}, i_t), C_t = e^{f_t + m_{t−1} − m_t}·C_{t−1}
    + e^{i_t − m_t}·v_t k_tᵀ, n_t likewise with k_t,
    y_t = C_t q_t / max(|n_t·q_t|, 1)."""
    import torch
    B, S, H, hd = q.shape
    C = q.new_zeros(B, H, hd, hd)
    n = q.new_zeros(B, H, hd)
    m = q.new_full((B, H), -math.inf)
    ys = []
    for t in range(S):
        mt = torch.maximum(fg[:, t] + m, ig[:, t])
        fw = torch.exp(fg[:, t] + m - mt)[..., None]
        iw = torch.exp(ig[:, t] - mt)[..., None]
        C = fw[..., None] * C + iw[..., None] * (
            v[:, t, :, :, None] * k[:, t, :, None, :])
        n = fw * n + iw * k[:, t]
        den = torch.abs((n * q[:, t]).sum(-1)).clamp(min=1.0)
        ys.append((C @ q[:, t, :, :, None])[..., 0] / den[..., None])
        m = mt
    return torch.stack(ys, dim=1)


def slstm_sequential(p, x):
    """The sLSTM recurrence stepped in time in float64 (``p`` and ``x``
    float64): y = o_proj(h_1 … h_S)."""
    import torch
    B, S, d = x.shape
    wx = x @ p["w_proj"]["w"] + p["gate_bias"]
    c, n, h = (x.new_zeros(B, d) for _ in range(3))
    m = x.new_full((B, d), -math.inf)
    ys = []
    for t in range(S):
        zi, ii, fi, oi = (wx[:, t] + h @ p["r_proj"]["w"]).chunk(4, dim=-1)
        lf = torch.nn.functional.logsigmoid(fi)
        mn = torch.maximum(lf + m, ii)
        c = torch.exp(lf + m - mn) * c + torch.exp(ii - mn) * torch.tanh(zi)
        n = torch.exp(lf + m - mn) * n + torch.exp(ii - mn)
        h = torch.sigmoid(oi) * c / n.clamp(min=1.0)
        m = mn
        ys.append(h)
    return torch.stack(ys, dim=1) @ p["o_proj"]["w"]


def xlstm_check(torch, cfg, gen, batch: int, seq: int,
                device: str = "cuda") -> dict:
    """One mLSTM and one sLSTM block's core at full width, seeded
    parameters, standard-normal activations (batch, seq, d_model): the
    mLSTM's parallel form (``mlstm_core``) on the block's q, k, v and gates
    against ``mlstm_sequential`` in float64 on the same operands, and
    ``slstm`` (fp32) against ``slstm_sequential`` in float64."""
    from repro_torch.core import tree
    from repro_torch.models import xlstm
    xc = cfg.xlstm
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=device)
    pm = xlstm.mlstm_init(gen, xc, device=device)
    ps = xlstm.slstm_init(gen, xc, device=device)
    with torch.no_grad():
        ops = xlstm._mlstm_operands(pm, xc, x)
        y = xlstm.mlstm_core(*ops)
        y64 = mlstm_sequential(*(t.double() for t in ops))
        s = xlstm.slstm(ps, xc, x)
        s64 = slstm_sequential(tree.tree_map(lambda t: t.double(), ps),
                               x.double())
    out = {"shape": [batch, seq, cfg.d_model], "heads": xc.n_heads,
           "mlstm": gated("mLSTM parallel form", y, y64),
           "slstm": gated("sLSTM loop", s, s64)}
    if device == "cuda":
        xg = x.clone().requires_grad_(True)

        def fwd_bwd(fn, p):
            leaves = [v.requires_grad_(True) for _, v in tree.flatten(p)]
            return lambda: torch.autograd.grad(fn(p, xc, xg).sum(),
                                               [xg] + leaves)
        out["mlstm_forward_backward_ms"] = wall_ms(
            fwd_bwd(xlstm.mlstm, pm), 5)
        out["slstm_forward_backward_ms"] = wall_ms(
            fwd_bwd(xlstm.slstm, ps), 3, 1)
    return out


def phase_families(torch, smi: str, trace: dict | None = None) -> dict:
    """The hybrid, xLSTM, encoder-decoder and VLM families at their
    published widths on one card (``FAMILY_RUNS``): the Gram kernels at
    every group shape of their plans, hymba's scan and windowed attention
    and xLSTM's mixers against float64 references, hymba's kernel update
    against the plain and the exact one and bucketed against fused, then
    ``TRAIN_STEPS`` Muon steps of each (owner, fused, one owner, kernels
    on, launches asserted per step from the plan) and AdamW steps of
    hymba, the optimizer releasing each spent state (``donate``); the Muon
    run of each arch named in ``trace`` ({arch: file}) under
    ``torch.profiler``.  Returns each Muon run's launches."""
    from repro_torch import configs
    from repro_torch.core import api
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model_fns

    t_phase = time.perf_counter()
    cfgs, plans = {}, {}
    for arch, run in FAMILY_RUNS.items():
        cfg = cfgs[arch] = family_config(arch)
        plan = plans[arch] = api.dedicate_params(
            model_fns(cfg).init(cfg, device="meta"))
        emit({"phase": "families", "config": {
            "arch": arch, "family": cfg.family,
            "cut": {k: {"cut": v[0], "published": v[1], "why": v[2]}
                    for k, v in run["cut"].items()},
            "note": "every other width and depth as published",
            "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "sliding_window": cfg.sliding_window,
            "global_layers": list(cfg.global_layers),
            "ssm": None if cfg.ssm is None else dataclasses.asdict(cfg.ssm),
            "xlstm": None if cfg.xlstm is None
            else dataclasses.asdict(cfg.xlstm),
            "frontend": None if cfg.frontend is None else
            [cfg.frontend, cfg.frontend_len, cfg.frontend_dim],
            "batch": run["batch"], "seq_len": run["seq"],
            "dtype": cfg.param_dtype, "remat": cfg.remat,
            "params": cfg.param_count(),
            "published_params": configs.get(arch).param_count(),
            "groups": {k: [g.count, *g.key] for k, g in plan.groups.items()},
            "buckets": sorted(plan.buckets),
            "launches_per_step": plan_launches(plan)}, "nvidia_smi": smi})

    gen = torch.Generator("cuda").manual_seed(0)
    syrk, gram = family_shapes(plans)
    for case in gram_kernel_cases(torch, gen, syrk, gram):
        shape = case[1]
        archs = syrk[shape] if case[0] == "gram_syrk" else gram[shape[:2]]
        emit({"phase": "families", "archs": archs, "nvidia_smi": smi,
              **check_kernel_case(torch, case, FAMILY_REPS)})
        del case
        torch.cuda.empty_cache()

    hy, hrun = cfgs["hymba-1.5b"], FAMILY_RUNS["hymba-1.5b"]
    emit({"phase": "families", "arch": hy.name, "check": "linear_scan",
          **scan_check(torch, hy, gen, hrun["batch"], hrun["seq"])})
    torch.cuda.empty_cache()
    emit({"phase": "families", "arch": hy.name, "check": "window",
          **window_check(torch, hy, gen, hrun["batch"], hrun["seq"])})
    torch.cuda.empty_cache()
    xl, xrun = cfgs["xlstm-350m"], FAMILY_RUNS["xlstm-350m"]
    emit({"phase": "families", "arch": xl.name, "check": "mixers",
          **xlstm_check(torch, xl, gen, xrun["batch"], xrun["seq"])})
    torch.cuda.empty_cache()

    hdata = DataConfig(vocab=hy.vocab, seq_len=hrun["seq"],
                       global_batch=hrun["batch"])
    grads, pm, passes = first_grads(torch, hy, hdata, plans[hy.name])
    emit({"phase": "families", "arch": hy.name, "check": "two_passes",
          **passes})
    torch.cuda.empty_cache()
    cmp, failures = updates_vs_exact(torch, plans[hy.name], grads, pm,
                                     FAMILY_UPDATE_FACTOR)
    del grads, pm
    torch.cuda.empty_cache()
    emit({"phase": "families", "arch": hy.name, "check": "update",
          "ok": not failures, **cmp})
    if failures:
        raise AssertionError("; ".join(failures))

    launches = {}
    for arch, run in FAMILY_RUNS.items():
        cfg = cfgs[arch]
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                          global_batch=run["batch"])
        tokens = run["batch"] * run["seq"]
        positions = tokens + (run["batch"] * cfg.frontend_len
                              if cfg.frontend is not None else 0)
        for variant in ("muon", "adamw") if run.get("adamw") else ("muon",):
            gc.collect()
            torch.cuda.empty_cache()
            traced = (trace or {}).get(arch) if variant == "muon" else None
            out = train_run(torch, variant, cfg=cfg, dcfg=dcfg,
                            donate=True, trace=traced,
                            inputs=family_inputs(torch, cfg, run["batch"]))
            emit({"phase": "families", "variant": variant, "arch": arch,
                  "steps": TRAIN_STEPS, "loss_ema": out["loss_ema"],
                  "step_ms": out["step_ms"],
                  "optimizer_ms": out["optimizer_ms"],
                  "tokens_per_s": [tokens / (t / 1e3)
                                   for t in out["step_ms"]],
                  "positions_per_s": [positions / (t / 1e3)
                                      for t in out["step_ms"]],
                  "peak_mem_gb": out["peak_mem_gb"],
                  "launches_by_step": out["launches_by_step"],
                  "trace": out["trace"], "nvidia_smi": smi})
            if variant == "muon":
                launches[arch] = out["launches"]
            del out
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return launches


# ------------------------------------------------------------------ serving
# The contiguous serving tier (``repro_torch.serve``): smollm-360m at full
# width (``serve``), then one model a family at its published widths
# (``serve_families``).  Parameters random from seed 0, caches bf16.
SERVE_ARCH = "smollm-360m"
SERVE_CONFIG = dict(num_slots=8, max_len=2304, prefill_pack=4,
                    chunk_len=1536)
SERVE_QUEUE = dict(n=24, prompt_lens=(128, 256, 512), new_tokens=(16, 64),
                   seed=0)
# one more request whose prompt streams through chunks of 1536 + 512: its
# first chunk takes the chunked attention over the bf16 cache
SERVE_LONG, SERVE_LONG_NEW = 2048, 32
SERVE_WARMUP = dict(n=4, prompt_lens=(128,), new_tokens=(4, 4), seed=1)
SERVE_ONESHOT = dict(n=24, prompt_lens=(256,), new_tokens=(16, 64), seed=0)
SERVE_REPLAYS = 4
SERVE_TRACE_STEPS = 5
# prefill's last logits against the training forward's, and chunked against
# one-shot prefill: max|Δ| <= SERVE_GATE · max|logit| (the port's bf16
# tolerance: the prefill attends over a bf16 cache, forward over fp32 k / v)
SERVE_GATE = 2e-2
# one model a family, published widths, bf16 caches, 3 slots, 6 requests
# of 4-16 new tokens; ``cut`` as FAMILY_RUNS' ({field: (cut, published,
# why)}), "moe" for moe_config's
SERVE_FAMILY_RUNS = {
    "deepseek-v3-671b": dict(prompt_lens=(256, 512), max_len=1024, cut="moe"),
    "hymba-1.5b": dict(prompt_lens=(1280,), max_len=1536, cut={"n_layers": (
        8, 32, "the one-card script's time (room for the tp_families "
        "phase): global layer 0 and seven windowed layers")}),
    "xlstm-350m": dict(prompt_lens=(512,), max_len=576, cut={"n_layers": (
        8, 24, "the one-card script's time (room for the tp_families "
        "phase): 7 mLSTM blocks and one sLSTM block, each kind")}),
    "seamless-m4t-large-v2": dict(prompt_lens=(512,), max_len=576,
                                  enc_len=512, cut={
                                      "n_layers": (12, 24, "the one-card "
                                                   "script's time"),
                                      "n_enc_layers": (12, 24, "as the "
                                                       "decoder's")}),
    "llava-next-mistral-7b": dict(prompt_lens=(128,), max_len=3136,
                                  cut=FAMILY_RUNS["llava-next-mistral-7b"][
                                      "cut"]),
}
SERVE_FAMILY_QUEUE = dict(n=6, new_tokens=(4, 16), seed=0)
SERVE_FAMILY_SLOTS = 3
# The paged tier (``repro_torch.serve.paged``): blocks of 16 tokens; the
# families' paged runs drill a preemption every 2 decode steps
PAGED_BLOCK = 16
SERVE_FAMILY_DRILL_EVERY = 2
# serve_paged (c): the same-schedule run again, a preemption every 8 steps
PAGED_DRILL_EVERY = 8
# serve_paged (b), equal cache bytes: 8 contiguous slots of 8192 positions
# against 32 paged slots over 4096 blocks of 16, 65,536 tokens of bf16 K / V
# either way; 40 chat requests with one long request after every 5th
PAGED_MAX_LEN, PAGED_CHUNK = 8192, 2048
PAGED_CONTIGUOUS_SLOTS, PAGED_SLOTS, PAGED_POOL = 8, 32, 4096
PAGED_CHAT = dict(n=40, prompt_lens=(256, 512, 1024), new_tokens=(32, 64),
                  seed=0)
PAGED_LONG, PAGED_LONG_NEW, PAGED_LONG_EVERY = 6144, 128, 5


def serve_queue(cfg, n: int, prompt_lens, new_tokens, seed: int,
                extra=()):
    """``RequestQueue.synthetic`` plus ``extra`` requests; enc-dec frames
    as ``synthetic`` draws them (length = prompt length), patch prefixes
    (frontend_len, frontend_dim) · 0.1 from ``seed``, one a request (as
    ``examples/serve_decode.py`` attaches them)."""
    import numpy as np

    from repro_torch.serve import RequestQueue
    kw = dict(frontend_dim=cfg.frontend_dim) if cfg.encdec else {}
    queue = RequestQueue.synthetic(n, cfg.vocab, prompt_lens=prompt_lens,
                                   new_tokens=new_tokens, seed=seed, **kw)
    reqs = list(queue._pending) + list(extra)
    if cfg.frontend == "patch":
        rng = np.random.default_rng(seed)
        for r in reqs:
            r.frames = (rng.standard_normal(
                (cfg.frontend_len, cfg.frontend_dim)) * 0.1).astype(
                    np.float32)
    return RequestQueue(reqs)


def served_run(torch, cfg, params, scfg, queue) -> tuple:
    """One scheduler run from a cleared allocator peak, recording each
    request's stints by wrapping the scheduler's prefill, chunk and insert
    calls: (metrics, {rid: ((kind, batch, row, slot, start), ...)}, peak
    GB, Gram-kernel launches during the run).  A stint is one admission:
    its prefill ("group" at (batch, row), "chunk", or "restore" for a
    recurrent-only resume), its slot, and the count of tokens generated
    when it began (1 at the first admission; a paged resume starts
    another stint)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import Scheduler
    sched = Scheduler(cfg, params, scfg)
    stints, pending = {}, {}
    group_fn, chunk_fn = sched._prefill_group, sched._prefill_chunked
    paged_fn = sched._prefill_chunked_paged
    insert_fn = sched.slots.insert
    prefilled_fn = getattr(sched.slots, "insert_prefilled", None)

    def prefill_group(group):
        for row, r in enumerate(group):
            pending[r.rid] = ("group", len(group), row)
        return group_fn(group)

    def prefill_chunked(req):
        pending[req.rid] = ("chunk", 1, 0)
        return chunk_fn(req)

    def prefill_chunked_paged(req):
        pending[req.rid] = ("chunk", 1, 0)
        return paged_fn(req)

    def record(req, i, resume):
        kind = pending.pop(req.rid, ("restore", 1, 0))
        start = 1 if resume is None else resume.generated
        stints.setdefault(req.rid, []).append(kind + (i, start))
        return i

    def insert(req, row_cache, row, first_token, pos, **kw):
        return record(req, insert_fn(req, row_cache, row, first_token, pos,
                                     **kw), kw.get("resume"))

    def insert_prefilled(req, table, first_token, pos, **kw):
        return record(req, prefilled_fn(req, table, first_token, pos, **kw),
                      kw.get("resume"))

    sched._prefill_group = prefill_group
    sched._prefill_chunked = prefill_chunked
    sched._prefill_chunked_paged = prefill_chunked_paged
    sched.slots.insert = insert
    if prefilled_fn is not None:
        sched.slots.insert_prefilled = insert_prefilled
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics = sched.run(queue)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del sched
    return metrics, {k: tuple(v) for k, v in stints.items()}, peak, launches


def replay_served(torch, cfg, params, scfg, req, stints, tokens) -> list:
    """The request alone at the shapes it was served at, through the
    contiguous cache, fed the served ``tokens``: each stint's prefill of
    the prompt plus the tokens fed before it, at its group size and row
    with the other rows zero (or batch 1 and the same chunks), its row
    written into slot ``slot`` of a ``num_slots`` decode cache (a resume
    then restores the recurrent rows saved from the previous stint's
    slot), decode in that row with every other row idle.  Logits of each
    token, on the host."""
    import numpy as np

    from repro_torch.core import tree
    from repro_torch.models import model_fns
    from repro_torch.models.transformer import PAGED_CACHE_KEYS
    from repro_torch.serve.scheduler import _frontend_key as serve_key
    from repro_torch.serve.scheduler import _prefix_len as serve_prefix
    from repro_torch.train import serve as serve_fns
    m, key = model_fns(cfg), serve_key(cfg)
    dev = torch.device("cuda")
    out, prev = [], None
    with torch.inference_mode():
        lens = (scfg.max_len, scfg.enc_len) if cfg.encdec else \
            (scfg.max_len,)
        dcache = m.init_cache(cfg, scfg.num_slots, *lens, scfg.cache_dtype,
                              device=dev)
        leaves = dict(tree.flatten(dcache))
        recurrent = [p for p in leaves
                     if p.split("/")[0] not in PAGED_CACHE_KEYS]
        for s, (kind, batch, row, slot, start) in enumerate(stints):
            end = stints[s + 1][4] if s + 1 < len(stints) else len(tokens)
            fed = np.concatenate([req.tokens,
                                  np.asarray(tokens[:start - 1], np.int32)])
            saved = None if prev is None else \
                {p: leaves[p][:, prev].clone() for p in recurrent}
            if kind == "chunk":
                cache = m.init_cache(cfg, 1, scfg.max_len, scfg.cache_dtype,
                                     device=dev)
                for off in range(0, len(fed), scfg.chunk_len):
                    logits, cache = serve_fns.prefill_chunk_fn(
                        cfg, params, torch.from_numpy(
                            fed[None, off:off + scfg.chunk_len]).to(dev),
                        cache, off)
            elif kind == "group":
                toks = np.zeros((batch, len(fed)), np.int32)
                toks[row] = fed
                kw = {}
                if key is not None:
                    fr = np.zeros((batch,) + req.frames.shape, np.float32)
                    fr[row] = req.frames
                    kw[key] = torch.from_numpy(fr).to(dev)
                logits, cache = serve_fns.prefill_fn(
                    cfg, params, torch.from_numpy(toks).to(dev),
                    scfg.max_len, cache_dtype=scfg.cache_dtype, **kw)
            if kind != "restore":
                rows = dict(tree.flatten(cache))
                for path, leaf in leaves.items():
                    leaf[:, slot] = rows[path][:, row]
                del cache, rows
            if s == 0:
                out.append(logits[row].cpu().numpy())
            for path, v in (saved or {}).items():
                leaves[path][:, slot] = v
            tok = np.zeros(scfg.num_slots, np.int32)
            pos = np.zeros(scfg.num_slots, np.int32)
            pos[slot] = len(fed) + serve_prefix(cfg)
            for g in range(start, end):
                tok[slot] = tokens[g - 1]
                logits, _ = serve_fns.decode_fn(
                    cfg, params, torch.from_numpy(tok).to(dev), dcache,
                    torch.from_numpy(pos).to(dev))
                out.append(logits[slot].cpu().numpy())
                pos[slot] += 1
            prev = slot
    return out


def solo_run(torch, cfg, params, scfg, req, tokens) -> list:
    """Batch-1 prefill of the whole prompt and scalar-pos batch-1 decode,
    fed the served ``tokens``: logits of each token, on the host."""
    from repro_torch.serve.scheduler import _frontend_key as serve_key
    from repro_torch.serve.scheduler import _prefix_len as serve_prefix
    from repro_torch.train import serve as serve_fns
    dev = torch.device("cuda")
    key = serve_key(cfg)
    kw = {} if key is None else {key: torch.from_numpy(req.frames[None])
                                 .to(dev)}
    with torch.inference_mode():
        logits, cache = serve_fns.prefill_fn(
            cfg, params, torch.from_numpy(req.tokens[None]).to(dev),
            scfg.max_len, cache_dtype=scfg.cache_dtype, **kw)
        out = [logits[0].cpu().numpy()]
        for i, t in enumerate(tokens[:-1]):
            logits, cache = serve_fns.decode_fn(
                cfg, params, torch.tensor([t], dtype=torch.int32,
                                          device=dev), cache,
                req.prompt_len + serve_prefix(cfg) + i)
            out.append(logits[0].cpu().numpy())
    return out


def replay_check(torch, cfg, params, scfg, metrics, reqs, shapes,
                 rids, solo: bool = True) -> dict:
    """Replay at served shape for ``rids``, asserted bitwise (logits and
    greedy tokens), and the batch-1 solo run's distance, printed: max
    |Δ| / max|logit| and the tokens whose greedy choice differs.  With
    ``solo=False`` the solo run is skipped (preempted requests: their
    distance from the unpreempted run is ``first_divergence``'s)."""
    import numpy as np
    rows, worst, flips = [], 0.0, 0
    for rid in rids:
        rec, req = metrics.requests[rid], reqs[rid]
        got = replay_served(torch, cfg, params, scfg, req, shapes[rid],
                            rec.tokens)
        same = len(got) == len(rec.logits) and all(
            np.array_equal(a, b) for a, b in zip(got, rec.logits))
        if not same or [int(np.argmax(a)) for a in got] != rec.tokens:
            bad = next((i for i, (a, b) in enumerate(zip(got, rec.logits))
                        if not np.array_equal(a, b)), None)
            raise AssertionError(f"{cfg.name} rid {rid} {shapes[rid]}: "
                                 f"served logits != replay at token {bad}")
        if not solo:
            rows.append({"rid": rid, "stints": [list(x) for x in
                                                shapes[rid]],
                         "tokens": len(got), "replay_bitwise": True})
            continue
        solo_out = solo_run(torch, cfg, params, scfg, req, rec.tokens)
        dist = max(float(np.abs(a - b).max() / np.abs(a).max())
                   for a, b in zip(solo_out, rec.logits))
        flip = sum(int(np.argmax(a)) != t
                   for a, t in zip(solo_out, rec.tokens))
        worst, flips = max(worst, dist), flips + flip
        rows.append({"rid": rid, "shape": list(shapes[rid][0][:4]),
                     "prompt_len": req.prompt_len, "tokens": len(got),
                     "replay_bitwise": True, "solo_max_rel": dist,
                     "solo_greedy_flips": flip})
    if not solo:
        return {"replays": rows}
    return {"replays": rows, "solo_max_rel": worst,
            "solo_greedy_flips": flips}


def logits_gate(tag: str, got, want) -> dict:
    """max|got − want| <= SERVE_GATE · max|want|, as a row."""
    err = float((got.double() - want.double()).abs().max())
    allowance = SERVE_GATE * float(want.abs().max())
    if not err <= allowance:
        raise AssertionError(f"{tag}: max|Δ| {err:.4g} > {allowance:.4g}")
    return {"max_abs_err": err, "allowance": allowance,
            "err_over_allowance": err / allowance}


def prefill_vs_forward(torch, cfg, params, req, max_len: int,
                       cache_dtype) -> dict:
    """A batch-1 prefill's last-token logits against the training
    ``forward``'s at that position (fp32 k / v), ``logits_gate``."""
    from repro_torch.models import model_fns
    from repro_torch.serve.scheduler import _frontend_key as serve_key
    from repro_torch.train import serve as serve_fns
    dev = torch.device("cuda")
    key = serve_key(cfg)
    kw = {} if key is None else {key: torch.from_numpy(req.frames[None])
                                 .to(dev)}
    toks = torch.from_numpy(req.tokens[None]).to(dev)
    with torch.inference_mode():
        got, _ = serve_fns.prefill_fn(cfg, params, toks, max_len,
                                      cache_dtype=cache_dtype, **kw)
        want = model_fns(cfg).forward(cfg, params, toks, **kw)[:, -1]
    return logits_gate(f"{cfg.name} prefill vs forward", got, want)


def serve_summary(metrics) -> dict:
    s = metrics.summary()
    return {k: s[k] for k in (
        "requests", "tokens", "wall_s", "tokens_per_sec", "ttft_ms_median",
        "ttft_ms_p90", "per_token_ms_median", "decode_step_us_median",
        "decode_step_us_p90", "decode_steps", "slot_occupancy",
        "concurrent_mean", "rejected")}


def check_complete(tag: str, metrics) -> None:
    for rec in metrics.requests.values():
        if rec.rejected or rec.generated != rec.requested:
            raise AssertionError(f"{tag} rid {rec.rid}: {rec.generated} of "
                                 f"{rec.requested} tokens"
                                 + (" (rejected)" if rec.rejected else ""))


def trace_decode(torch, cfg, params, scfg, trace: str) -> dict:
    """``SERVE_TRACE_STEPS`` decode steps at full slots (8 prompts of 256,
    budgets past the traced steps) under ``torch.profiler``: per step the
    device busy time, idle share and kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Scheduler
    n = scfg.num_slots
    queue = serve_queue(cfg, n, (256,), (SERVE_TRACE_STEPS + 2,) * 2, 2)
    sched = Scheduler(cfg, params, scfg)
    step, steps = sched._decode_step, [0]

    def traced(metrics, t0):
        if steps[0] >= SERVE_TRACE_STEPS:
            return step(metrics, t0)
        with torch.profiler.record_function(f"step{steps[0]}"):
            step(metrics, t0)
        steps[0] += 1
    sched._decode_step = traced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.run(queue)
    out = Path(trace)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    return {"file": str(out), "steps": trace_summary(prof, SERVE_TRACE_STEPS)}


def serve_long_request(cfg):
    """The serve phase's ``SERVE_LONG``-token prompt (rid after the
    queue's), drawn from ``SERVE_QUEUE``'s seed + 1."""
    import numpy as np

    from repro_torch.serve import Request
    return Request(
        rid=SERVE_QUEUE["n"], max_new_tokens=SERVE_LONG_NEW,
        tokens=np.random.default_rng(SERVE_QUEUE["seed"] + 1).integers(
            0, cfg.vocab, SERVE_LONG).astype(np.int32))


def phase_serve(torch, smi: str, trace: str | None = None) -> None:
    """smollm-360m at full width through the contiguous serving tier
    (``SERVE_CONFIG``, bf16 cache): a warm-up run, then the timed run of
    ``SERVE_QUEUE`` plus one ``SERVE_LONG``-token chunked prompt
    (summary, peak GB); the same queue again with logits recorded, and
    ``SERVE_REPLAYS`` requests (the chunked one among them) replayed at
    their served shapes, bitwise; the batch-1 solo distance printed;
    prefill against the training forward and chunked against one-shot
    prefill of the long prompt (``SERVE_GATE``); continuous against
    ``run_oneshot`` on ``SERVE_ONESHOT``; ``trace`` traces decode steps."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve import RequestQueue, ServeConfig, Scheduler, \
        run_oneshot
    from repro_torch.train import serve as serve_fns

    t_phase = time.perf_counter()
    cfg = configs.get(SERVE_ARCH)
    params = transformer.init(cfg, seed=0, device="cuda")
    scfg = ServeConfig(cache_dtype=torch.bfloat16, **SERVE_CONFIG)
    long_req = serve_long_request(cfg)

    def timed_queue():
        return serve_queue(cfg, **SERVE_QUEUE, extra=[long_req])
    emit({"phase": "serve", "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "params": cfg.param_count(),
        "param_dtype": cfg.param_dtype, "cache_dtype": "bfloat16",
        **SERVE_CONFIG, "queue": {**SERVE_QUEUE, "long_prompt": SERVE_LONG,
                                  "long_new_tokens": SERVE_LONG_NEW},
        "seed": 0}, "nvidia_smi": smi})

    served_run(torch, cfg, params, scfg, serve_queue(cfg, **SERVE_WARMUP))
    metrics, shapes, peak, launches = served_run(torch, cfg, params, scfg,
                                                 timed_queue())
    check_complete("serve", metrics)
    if any(launches.values()):
        raise AssertionError(f"serving launched Gram kernels: {launches}")
    if shapes[long_req.rid][0][0] != "chunk":
        raise AssertionError(f"the long prompt was not chunked: {shapes}")
    emit({"phase": "serve", "run": "continuous", **serve_summary(metrics),
          "prefill_calls": len(metrics.prefill_s), "peak_mem_gb": peak,
          "gram_launches": launches, "nvidia_smi": smi})

    rscfg = dataclasses.replace(scfg, record_logits=True)
    queue = timed_queue()
    reqs = {r.rid: r for r in queue._pending}
    rec, rshapes, _, _ = served_run(torch, cfg, params, rscfg, queue)
    check_complete("serve (recorded)", rec)
    same_tokens = all(rec.requests[r].tokens == metrics.requests[r].tokens
                      for r in rec.requests) and rshapes == shapes
    by_kind = {}
    for rid, s in rshapes.items():
        by_kind.setdefault(s[0][:2], rid)
    rids = [long_req.rid] + [r for r in by_kind.values()
                             if r != long_req.rid]
    rids += [r for r in rshapes if r not in rids]
    emit({"phase": "serve", "check": "replay",
          "runs_same_tokens_and_shapes": same_tokens,
          **replay_check(torch, cfg, params, rscfg, rec, reqs, rshapes,
                         rids[:SERVE_REPLAYS]), "nvidia_smi": smi})
    del rec
    gc.collect()
    torch.cuda.empty_cache()

    fwd = prefill_vs_forward(torch, cfg, params, long_req, scfg.max_len,
                             scfg.cache_dtype)
    toks = torch.from_numpy(long_req.tokens[None]).cuda()
    with torch.inference_mode():
        full, _ = serve_fns.prefill_fn(cfg, params, toks, scfg.max_len,
                                       cache_dtype=scfg.cache_dtype)
        cache = transformer.init_cache(cfg, 1, scfg.max_len,
                                       scfg.cache_dtype, device="cuda")
        for off in range(0, SERVE_LONG, scfg.chunk_len):
            chunked, cache = serve_fns.prefill_chunk_fn(
                cfg, params, toks[:, off:off + scfg.chunk_len], cache, off)
    del cache
    emit({"phase": "serve", "check": "prefill", "prompt_len": SERVE_LONG,
          "vs_forward": fwd,
          "chunked_vs_one_shot": logits_gate("chunked vs one-shot prefill",
                                             chunked, full),
          "nvidia_smi": smi})
    torch.cuda.empty_cache()

    oq = serve_queue(cfg, **SERVE_ONESHOT)
    reqs = sorted(oq._pending, key=lambda r: r.rid)
    cont = Scheduler(cfg, params, scfg).run(RequestQueue(
        [dataclasses.replace(r) for r in reqs]))
    check_complete("serve continuous (uniform)", cont)
    with torch.inference_mode():
        base = run_oneshot(cfg, params, reqs, scfg.num_slots, scfg.max_len,
                           cache_dtype=scfg.cache_dtype)
    check_complete("serve oneshot", base)
    cs, bs = cont.summary(), base.summary()
    if cs["tokens"] != bs["tokens"] or \
            not cs["decode_steps"] < bs["decode_steps"]:
        raise AssertionError(f"continuous {cs['decode_steps']} steps / "
                             f"{cs['tokens']} tokens against one-shot "
                             f"{bs['decode_steps']} / {bs['tokens']}")
    emit({"phase": "serve", "check": "oneshot",
          "continuous": serve_summary(cont), "oneshot": serve_summary(base),
          "nvidia_smi": smi})
    if trace:
        emit({"phase": "serve", "trace": trace_decode(torch, cfg, params,
                                                      scfg, trace),
              "nvidia_smi": smi})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})


def serve_family_config(arch: str):
    from repro_torch import configs
    cut = SERVE_FAMILY_RUNS[arch]["cut"]
    if cut == "moe":
        return moe_config(), {"n_layers": (MOE_LAYERS, 61, "the moe "
                                           "phase's cut"),
                              "n_experts": (MOE_EXPERTS, 256, "the moe "
                                            "phase's cut")}
    return configs.get(arch, **{k: v[0] for k, v in cut.items()}), cut


def same_logits(tag: str, got, want, rids=None) -> None:
    """Each request's greedy tokens and logits in ``got`` bit for bit
    those of ``want`` (every request, or ``rids``)."""
    import numpy as np
    for rid in (list(want.requests) if rids is None else rids):
        a, b = got.requests[rid], want.requests[rid]
        if a.tokens != b.tokens or len(a.logits) != len(b.logits):
            raise AssertionError(f"{tag} rid {rid}: tokens differ")
        bad = next((i for i, (x, y) in enumerate(zip(a.logits, b.logits))
                    if not np.array_equal(x, y)), None)
        if bad is not None:
            raise AssertionError(f"{tag} rid {rid}: logits differ at token "
                                 f"{bad}")


def pool_summary(metrics) -> dict:
    s = metrics.summary()
    return {k: s.get(k) for k in ("pool_blocks", "pool_occupancy",
                                  "frag_pct", "preemptions")}


def check_paged(tag: str, metrics, pool_blocks: int | None) -> None:
    """The run served from a pool of ``pool_blocks`` blocks and used it
    (None: a pure-recurrent family, which pages nothing)."""
    s = metrics.summary()
    if pool_blocks is None:
        if s.get("pool_blocks"):
            raise AssertionError(f"{tag}: a recurrent cache was paged")
        return
    if s.get("pool_blocks") != pool_blocks or not s["pool_occupancy"] > 0:
        raise AssertionError(f"{tag}: not served from the pool: "
                             f"{pool_summary(metrics)}")


def family_paged(torch, cfg, params, scfg, run, contiguous,
                 stints) -> dict:
    """A family's paged runs on the serve_families queue: blocks of
    ``PAGED_BLOCK``, watermark 0, gated bitwise against the contiguous
    run of the same schedule; then the ``SERVE_FAMILY_DRILL_EVERY`` drill,
    gated on completion.  xLSTM's resume restores the exact state, so its
    preempted requests are also gated bitwise against their unpreempted
    run: the same admission (prefill group and row) decoded to the end in
    its first slot (``replay_served`` of the first stint).  Enc-dec must
    refuse the paged tier."""
    import numpy as np

    from repro_torch.serve import Scheduler

    pscfg = dataclasses.replace(scfg, kv="paged", block_size=PAGED_BLOCK,
                                watermark=0.0)
    if cfg.encdec:
        try:
            Scheduler(cfg, params, pscfg)
        except NotImplementedError as e:
            return {"refused": str(e)}
        raise AssertionError(f"{cfg.name}: enc-dec served kv='paged'")
    blocks = None if cfg.family == "ssm" else \
        SERVE_FAMILY_SLOTS * math.ceil(scfg.max_len / PAGED_BLOCK)

    def queue():
        return serve_queue(cfg, prompt_lens=run["prompt_lens"],
                           **SERVE_FAMILY_QUEUE)
    paged, pstints, peak, launches = served_run(torch, cfg, params, pscfg,
                                                queue())
    check_complete(f"{cfg.name} paged", paged)
    if any(launches.values()):
        raise AssertionError(f"serving launched Gram kernels: {launches}")
    check_paged(f"{cfg.name} paged", paged, blocks)
    if pstints != stints:
        raise AssertionError(f"{cfg.name}: paged admissions differ")
    same_logits(f"{cfg.name} paged vs contiguous", paged, contiguous)
    dscfg = dataclasses.replace(pscfg, preempt_every=SERVE_FAMILY_DRILL_EVERY)
    dq = queue()
    reqs = {r.rid: r for r in dq._pending}
    drill, dstints, _, _ = served_run(torch, cfg, params, dscfg, dq)
    check_complete(f"{cfg.name} drill", drill)
    preempted = [rid for rid, v in dstints.items() if len(v) > 1]
    if not drill.preemptions >= 1 or not preempted:
        raise AssertionError(f"{cfg.name}: the drill preempted nothing")
    for rid in preempted if cfg.family == "ssm" else ():
        rec = drill.requests[rid]
        want = replay_served(torch, cfg, params, dscfg, reqs[rid],
                             dstints[rid][:1], rec.tokens)
        if [int(np.argmax(a)) for a in want] != rec.tokens or not all(
                np.array_equal(a, b) for a, b in zip(want, rec.logits)):
            raise AssertionError(f"{cfg.name} rid {rid}: preempted != "
                                 "unpreempted run")
    return {**serve_summary(paged), **pool_summary(paged),
            "peak_mem_gb": peak, "block_size": PAGED_BLOCK,
            "gram_launches": launches, "bitwise_vs_contiguous": True,
            "drill": {"preempt_every": SERVE_FAMILY_DRILL_EVERY,
                      "preemptions": drill.preemptions,
                      "preempted": preempted, "complete": True,
                      "bitwise_vs_unpreempted":
                          True if cfg.family == "ssm" else None,
                      "decode_steps": drill.decode_steps}}


def phase_serve_families(torch, smi: str) -> None:
    """One model a family at its published widths (``SERVE_FAMILY_RUNS``),
    bf16 caches, ``SERVE_FAMILY_SLOTS`` slots, ``SERVE_FAMILY_QUEUE``: the
    same queue served twice with logits recorded (bitwise equal), every
    request replayed at its served shape (bitwise; DeepSeek-V3, whose rows
    share expert capacity, only the two runs), prefill against the
    training forward; TTFT, decode step, tokens/s and peak GB printed;
    then ``family_paged``'s paged runs.  Each model is freed before the
    next."""
    import numpy as np

    from repro_torch.models import model_fns
    from repro_torch.serve import ServeConfig

    t_phase = time.perf_counter()
    for arch, run in SERVE_FAMILY_RUNS.items():
        t_arch = time.perf_counter()
        cfg, cut = serve_family_config(arch)
        params = model_fns(cfg).init(cfg, seed=0, device="cuda")
        scfg = ServeConfig(num_slots=SERVE_FAMILY_SLOTS,
                           max_len=run["max_len"],
                           prefill_pack=SERVE_FAMILY_SLOTS,
                           cache_dtype=torch.bfloat16,
                           enc_len=run.get("enc_len"), record_logits=True)
        emit({"phase": "serve_families", "config": {
            "arch": cfg.name, "family": cfg.family,
            "cut": {k: {"cut": v[0], "published": v[1], "why": v[2]}
                    for k, v in cut.items()},
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "params": cfg.param_count(),
            "param_dtype": cfg.param_dtype, "cache_dtype": "bfloat16",
            "prompt_lens": list(run["prompt_lens"]),
            "max_len": run["max_len"], "enc_len": run.get("enc_len"),
            "frontend": None if cfg.frontend is None else
            [cfg.frontend, cfg.frontend_len, cfg.frontend_dim],
            "num_slots": SERVE_FAMILY_SLOTS, **SERVE_FAMILY_QUEUE},
            "nvidia_smi": smi})
        runs = []
        for _ in range(2):
            queue = serve_queue(cfg, prompt_lens=run["prompt_lens"],
                                **SERVE_FAMILY_QUEUE)
            reqs = {r.rid: r for r in queue._pending}
            runs.append(served_run(torch, cfg, params, scfg, queue))
            check_complete(cfg.name, runs[-1][0])
        (m1, s1, _, _), (m2, s2, peak, launches) = runs
        for rid, r in m1.requests.items():
            o = m2.requests[rid]
            if s1 != s2 or r.tokens != o.tokens or not all(
                    np.array_equal(a, b) for a, b in zip(r.logits,
                                                         o.logits)):
                raise AssertionError(f"{cfg.name} rid {rid}: two runs of "
                                     "one schedule differ")
        if any(launches.values()):
            raise AssertionError(f"serving launched Gram kernels: "
                                 f"{launches}")
        replays = None
        if cfg.moe is None:
            replays = replay_check(torch, cfg, params, scfg, m2, reqs, s2,
                                   list(s2))
        fwd = prefill_vs_forward(torch, cfg, params, reqs[0], scfg.max_len,
                                 scfg.cache_dtype)
        emit({"phase": "serve_families", "arch": cfg.name,
              **serve_summary(m2), "record_logits": True,
              "prefill_calls": len(m2.prefill_s), "peak_mem_gb": peak,
              "two_runs_bitwise": True, "replay": replays,
              "prefill_vs_forward": fwd, "gram_launches": launches,
              "seconds": time.perf_counter() - t_arch, "nvidia_smi": smi})
        t_paged = time.perf_counter()
        emit({"phase": "serve_families", "arch": cfg.name, "kv": "paged",
              **family_paged(torch, cfg, params, scfg, run, m2, s2),
              "seconds": time.perf_counter() - t_paged, "nvidia_smi": smi})
        del params, runs, m1, m2, reqs, queue
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_families",
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})


def equal_memory_queue(cfg):
    """serve_paged (b)'s workload, all at t = 0: ``PAGED_CHAT``'s chat
    requests with one ``PAGED_LONG``-token request (``PAGED_LONG_NEW`` new
    tokens, drawn from the chat seed + 1) after every
    ``PAGED_LONG_EVERY``-th, numbered in queue order."""
    import numpy as np

    from repro_torch.serve import Request, RequestQueue
    chats = RequestQueue.synthetic(PAGED_CHAT["n"], cfg.vocab,
                                   prompt_lens=PAGED_CHAT["prompt_lens"],
                                   new_tokens=PAGED_CHAT["new_tokens"],
                                   seed=PAGED_CHAT["seed"])._pending
    rng = np.random.default_rng(PAGED_CHAT["seed"] + 1)
    reqs = []
    for i, r in enumerate(chats):
        reqs.append(r)
        if (i + 1) % PAGED_LONG_EVERY == 0:
            reqs.append(Request(rid=0, max_new_tokens=PAGED_LONG_NEW,
                                tokens=rng.integers(0, cfg.vocab, PAGED_LONG)
                                .astype(np.int32)))
    return RequestQueue([dataclasses.replace(r, rid=k, arrival=0.0)
                         for k, r in enumerate(reqs)])


def first_divergence(got, want, rids) -> dict:
    """Each request of ``got`` against ``want`` up to its first differing
    greedy token (that token's logits included: the inputs before it are
    the same): max |Δ| / max|logit| and where the tokens part."""
    import numpy as np
    rows = []
    for rid in rids:
        a, b = got.requests[rid], want.requests[rid]
        first = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                      if x != y), None)
        n = len(a.logits) if first is None else first + 1
        rel = max(float(np.abs(x - y).max() / np.abs(y).max())
                  for x, y in zip(a.logits[:n], b.logits[:n]))
        rows.append({"rid": rid, "max_rel": rel, "compared": n,
                     "first_differing_token": first})
    return {"per_request": rows,
            "max_rel": max((r["max_rel"] for r in rows), default=0.0),
            "requests_parting": sum(r["first_differing_token"] is not None
                                    for r in rows)}


def phase_serve_paged(torch, smi: str, trace: str | None = None) -> None:
    """smollm-360m at full width through the paged tier
    (``repro_torch.serve.paged``), bf16 K / V in blocks of ``PAGED_BLOCK``:
    (a) the serve phase's queue (24 requests + the 2048-token prompt,
    which streams 1536 + 512 straight into its block table) contiguous and
    paged at watermark 0, logits recorded: the same admissions and decode
    steps and every logit bit for bit, both decode-step medians printed
    (the gather's cost); (c) the paged run again with a preemption every
    ``PAGED_DRILL_EVERY`` decode steps: complete, every preempted request
    equal to its replay at the shapes it was served at (its stints), bit
    for bit, and its distance from (a) up to the first differing greedy
    token printed; (b) equal cache bytes: 8 contiguous slots of 8192
    positions against 32 paged slots over 4096 blocks (2.68 GB of bf16
    K / V each) on ``equal_memory_queue``: both complete with nothing
    rejected and the same tokens, the paged tier with a higher
    ``concurrent_mean`` and fewer decode steps; tokens/s, TTFT, decode
    step, pool occupancy, preemptions and peak GB printed.  ``trace``
    (a directory) traces decode steps of both equal-memory tiers."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig

    t_phase = time.perf_counter()
    cfg = configs.get(SERVE_ARCH)
    params = transformer.init(cfg, seed=0, device="cuda")
    long_req = serve_long_request(cfg)
    cscfg = ServeConfig(cache_dtype=torch.bfloat16, record_logits=True,
                        **SERVE_CONFIG)
    pscfg = dataclasses.replace(cscfg, kv="paged", block_size=PAGED_BLOCK,
                                watermark=0.0)
    blocks = SERVE_CONFIG["num_slots"] * SERVE_CONFIG["max_len"] // PAGED_BLOCK
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2   # a token
    emit({"phase": "serve_paged", "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_dtype": cfg.param_dtype, "cache_dtype": "bfloat16",
        "kv_bytes_per_token": kv_bytes, "block_size": PAGED_BLOCK,
        "same_schedule": {**SERVE_CONFIG, "pool_blocks": blocks,
                          "watermark": 0.0, "queue": SERVE_QUEUE,
                          "long_prompt": SERVE_LONG},
        "drill_every": PAGED_DRILL_EVERY,
        "equal_memory": {
            "max_len": PAGED_MAX_LEN, "chunk_len": PAGED_CHUNK,
            "contiguous_slots": PAGED_CONTIGUOUS_SLOTS,
            "paged_slots": PAGED_SLOTS, "pool_blocks": PAGED_POOL,
            "chat": PAGED_CHAT, "long": [PAGED_LONG, PAGED_LONG_NEW,
                                         PAGED_LONG_EVERY],
            "cache_gb": PAGED_POOL * PAGED_BLOCK * kv_bytes / 1e9},
        "seed": 0}, "nvidia_smi": smi})

    def queue():
        return serve_queue(cfg, **SERVE_QUEUE, extra=[long_req])
    served_run(torch, cfg, params, pscfg, serve_queue(cfg, **SERVE_WARMUP))
    cont, cstints, cpeak, _ = served_run(torch, cfg, params, cscfg, queue())
    paged, pstints, ppeak, launches = served_run(torch, cfg, params, pscfg,
                                                 queue())
    check_complete("serve_paged contiguous", cont)
    check_complete("serve_paged paged", paged)
    check_paged("serve_paged paged", paged, blocks)
    if any(launches.values()):
        raise AssertionError(f"serving launched Gram kernels: {launches}")
    if pstints != cstints or pstints[long_req.rid][0][0] != "chunk":
        raise AssertionError("paged admissions differ from contiguous")
    if paged.active_per_step != cont.active_per_step:
        raise AssertionError("paged decode steps differ from contiguous")
    same_logits("serve_paged paged vs contiguous", paged, cont)
    cs, ps = serve_summary(cont), serve_summary(paged)
    emit({"phase": "serve_paged", "check": "same_schedule",
          "logits_bitwise": True, "contiguous": {**cs, "peak_mem_gb": cpeak},
          "paged": {**ps, **pool_summary(paged), "peak_mem_gb": ppeak},
          "decode_step_us_median": [cs["decode_step_us_median"],
                                    ps["decode_step_us_median"]],
          "decode_step_paged_over_contiguous":
              ps["decode_step_us_median"] / cs["decode_step_us_median"],
          "nvidia_smi": smi})

    dscfg = dataclasses.replace(pscfg, preempt_every=PAGED_DRILL_EVERY)
    dq = queue()
    reqs = {r.rid: r for r in dq._pending}
    drill, dstints, _, _ = served_run(torch, cfg, params, dscfg, dq)
    check_complete("serve_paged drill", drill)
    preempted = [rid for rid, v in dstints.items() if len(v) > 1]
    if not drill.preemptions >= 1 or not preempted:
        raise AssertionError("the drill preempted nothing")
    emit({"phase": "serve_paged", "check": "drill",
          **serve_summary(drill), **pool_summary(drill),
          "preempted": preempted,
          **replay_check(torch, cfg, params, dscfg, drill, reqs, dstints,
                         preempted, solo=False),
          "vs_unpreempted": first_divergence(drill, paged, preempted),
          "nvidia_smi": smi})
    del cont, paged, drill, reqs, dq
    gc.collect()
    torch.cuda.empty_cache()

    ecfg = ServeConfig(num_slots=PAGED_CONTIGUOUS_SLOTS,
                       max_len=PAGED_MAX_LEN, prefill_pack=4,
                       chunk_len=PAGED_CHUNK, cache_dtype=torch.bfloat16)
    epcfg = dataclasses.replace(ecfg, num_slots=PAGED_SLOTS, kv="paged",
                                block_size=PAGED_BLOCK, pool_blocks=PAGED_POOL)
    ec, _, ecpeak, _ = served_run(torch, cfg, params, ecfg,
                                  equal_memory_queue(cfg))
    ep, _, eppeak, _ = served_run(torch, cfg, params, epcfg,
                                  equal_memory_queue(cfg))
    check_complete("serve_paged equal-memory contiguous", ec)
    check_complete("serve_paged equal-memory paged", ep)
    check_paged("serve_paged equal-memory paged", ep, PAGED_POOL)
    ecs, eps = ec.summary(), ep.summary()
    if eps["tokens"] != ecs["tokens"] or \
            not eps["concurrent_mean"] > ecs["concurrent_mean"] or \
            not eps["decode_steps"] < ecs["decode_steps"]:
        raise AssertionError(
            f"equal memory: paged concurrent_mean {eps['concurrent_mean']} "
            f"/ {eps['decode_steps']} steps / {eps['tokens']} tokens "
            f"against contiguous {ecs['concurrent_mean']} / "
            f"{ecs['decode_steps']} / {ecs['tokens']}")
    emit({"phase": "serve_paged", "check": "equal_memory",
          "contiguous": {**serve_summary(ec), **pool_summary(ec),
                         "peak_mem_gb": ecpeak,
                         "cache_gb": PAGED_CONTIGUOUS_SLOTS * PAGED_MAX_LEN
                         * kv_bytes / 1e9},
          "paged": {**serve_summary(ep), **pool_summary(ep),
                    "peak_mem_gb": eppeak,
                    "cache_gb": PAGED_POOL * PAGED_BLOCK * kv_bytes / 1e9},
          "nvidia_smi": smi})
    if trace:
        emit({"phase": "serve_paged", "trace": {
            tier: trace_decode(torch, cfg, params, tcfg, str(
                Path(trace) / f"trace_serve_{tier}.json.gz"))
            for tier, tcfg in (("contiguous", ecfg), ("paged", epcfg))},
            "nvidia_smi": smi})
    del params, ec, ep
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_paged", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})

# ------------------------------------------------------------ serve_mesh
# Serving under a mesh (``Scheduler(..., mesh=mesh)``, the contiguous
# tier): on one card a (1, 1) world at the serve phase's settings, bitwise
# the one-card scheduler; on four cards three runs, each held to one card
# on the same requests and parameters by ``serve_gate``.  Each run: its
# config (``serve_mesh_config``), mesh, slots x max_len, chunk and pack,
# queue (``serve_queue``'s arguments) and its one-card reference's slots
# x max_len where one card cannot hold the mesh run's cache.
SERVE_MESH_RUNS = {
    # qwen2.5-14b, all 48 layers at its widths, bf16 parameters and cache:
    # 16 slots of 32768 positions, 103.1 GB of K / V, 25.8 GB a card with
    # its 8 KV heads 2 a card; 16 prompts of 512-4000 tokens (chunks of
    # 2048), 64 new tokens each.  One card holds the same requests at 8
    # slots of 4096 (6.4 GB of cache beside 29.5 GB of weights)
    "a": dict(arch="qwen2.5-14b", mesh=(1, 4), num_slots=16,
              max_len=32768, chunk_len=2048, prefill_pack=4,
              queue=dict(n=16, prompt_lens=(512, 1536, 4000),
                         new_tokens=(64, 64), seed=0),
              one_card=dict(num_slots=8, max_len=4096)),
    # DeepSeek-V3 at its widths, the tp_moe phase's cut (1 layer, all 256
    # experts), bf16: the MLA latent by sequence (1024 rows a card), the
    # experts 64 a card
    "b": dict(arch="deepseek-v3-671b", mesh=(1, 4), num_slots=8,
              max_len=4096, chunk_len=2048, prefill_pack=4,
              queue=dict(n=12, prompt_lens=(256, 512, 3000),
                         new_tokens=(16, 32), seed=0), one_card={}),
    # smollm-360m (fp32 parameters, bf16 cache) on (2, 2): 5 KV heads on
    # 2 ranks, so the sequence split (1152 rows a card), and 16 of the 32
    # slots a data rank
    "c": dict(arch="smollm-360m", mesh=(2, 2), num_slots=32,
              max_len=SERVE_CONFIG["max_len"], chunk_len=1536,
              prefill_pack=4,
              queue=dict(n=48, prompt_lens=(128, 256, 512, 2048),
                         new_tokens=(16, 64), seed=0), one_card={}),
}
SERVE_MESH_TRACE_FROM = 8       # run (a)'s decode steps traced on rank 0
SERVE_MESH_TRACE_STEPS = 5
SERVE_MESH_SPREAD_SEED = 5


def serve_mesh_config(name: str):
    """The config of ``SERVE_MESH_RUNS[name]``: qwen in bf16, DeepSeek-V3
    at the tp_moe phase's cut (1 layer, 256 experts), smollm as the serve
    phase's."""
    from repro_torch import configs
    arch = SERVE_MESH_RUNS[name]["arch"]
    if arch == "deepseek-v3-671b":
        return tp_moe_config(1, 256)
    if arch == "qwen2.5-14b":
        return configs.get(arch, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    return configs.get(arch)


def serve_mesh_scfg(torch, run: dict, one_card: bool = False,
                    record: bool = False):
    from repro_torch.serve import ServeConfig
    geometry = {k: run[k] for k in ("num_slots", "max_len", "chunk_len",
                                    "prefill_pack")}
    if one_card:
        geometry.update(run["one_card"])
    return ServeConfig(cache_dtype=torch.bfloat16, record_logits=record,
                       **geometry)


def serve_gate(mesh_rec, one_rec, spread_rec, ulp: float = 2.0 ** -23
               ) -> dict:
    """The mesh run's logits against one card's on the same requests and
    parameters, token by token.  ``*_rec``: {rid: (tokens, logits)} of the
    mesh run, the one-card run and the one-card run from the parameters
    with a random half of their entries one ulp up.  The mesh's forward
    differs from one card's by rounding only (row-parallel partial sums
    reduced over 'model', the vocab's columns gathered, the partials of a
    sequence split merged), as one ulp on the parameters moves it.  Step
    i passes where max|mesh − one| <= ``TP_SPREAD`` · b_i, b_i =
    max(max|spread − one|, ``ulp`` · max|one|).  The greedy tokens must
    be the same wherever the one-card top-2 margin is at least
    ``TP_SPREAD`` · b_i; where it is under (a near tie either run may
    break its own way) a different token ends that request's comparison,
    as does the spread run's first different token (its later logits
    follow other inputs).  Returns the worst ratio (max|Δ| over its
    bound), the steps compared, the near ties and the failures."""
    import numpy as np
    worst, steps, ties, bad = 0.0, 0, [], []
    for rid, (one_toks, one_logits) in one_rec.items():
        m_toks, m_logits = mesh_rec[rid]
        s_toks, s_logits = spread_rec[rid]
        for i, one in enumerate(one_logits):
            if i >= len(m_logits) or i >= len(s_logits):
                bad.append(f"rid {rid}: {len(m_logits)} mesh / "
                           f"{len(s_logits)} spread of {len(one_logits)} "
                           "tokens")
                break
            d = float(np.abs(m_logits[i] - one).max())
            s = float(np.abs(s_logits[i] - one).max())
            bound = TP_SPREAD * max(s, ulp * float(np.abs(one).max()))
            worst = max(worst, d / bound)
            steps += 1
            top = np.partition(one, -2)[-2:]
            margin = float(top[1] - top[0])
            if margin < bound:
                ties.append({"rid": rid, "step": i, "margin": margin,
                             "bound": bound})
            if m_toks[i] != one_toks[i]:
                if margin >= bound:
                    bad.append(f"rid {rid} step {i}: token {m_toks[i]} != "
                               f"{one_toks[i]} at margin {margin:.4g} >= "
                               f"{bound:.4g}")
                break
            if s_toks[i] != one_toks[i]:
                break
    return {"factor": worst, "steps": steps,
            "tokens": sum(len(t) for t, _ in one_rec.values()),
            "near_ties": ties, "failures": bad, "spread_factor": TP_SPREAD}


def serve_mesh_predict(out: str) -> None:
    """The dry run's walk (``launch.dryrun.walk_cell``) of run (a)'s decode
    step: ``serve_mesh_config("a")``, ``num_slots`` x ``max_len`` on a fake
    world of its mesh, the parameters and the cache as their parts; its
    JSON to ``out``."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import walk_cell
    run = SERVE_MESH_RUNS["a"]
    shape = ShapeSpec("serve_mesh_a", run["max_len"], run["num_slots"],
                      "decode")
    result = walk_cell(serve_mesh_config("a"), run["arch"], shape,
                       run["mesh"], "owner")
    Path(out).write_text(json.dumps(result, default=str))


def start_serve_mesh_predictions() -> list:
    """Run (a)'s predicted peak (``serve_mesh_predict``,
    ``start_walks``)."""
    return start_walks("serve_mesh_predict",
                       {"serve_a": ("serve_mesh_predict", ())})


def recorded(metrics) -> dict:
    """{rid: (tokens, logits)} of a run with ``record_logits``."""
    return {r: (v.tokens, v.logits) for r, v in metrics.requests.items()}


def serve_mesh_timed(torch, sched, queue, trace: bool) -> tuple:
    """``sched.run(queue)`` from a cleared peak: (metrics, {"peak_gb": the
    run's peak, "decode_peak_gb": the peak from the first decode step on
    (what the dry run's decode walk predicts where every request was
    admitted before it)}, the traced decode steps' ``trace_summary`` or
    None).  With ``trace`` ``SERVE_MESH_TRACE_STEPS`` decode steps from
    the ``SERVE_MESH_TRACE_FROM``-th on run under ``torch.profiler``
    (this rank's host and card)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, count, peaks = sched._decode_step, [0], {}

    def watched(metrics, t0):
        i = count[0]
        count[0] += 1
        if i == 0:
            torch.cuda.synchronize()
            peaks["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        i -= SERVE_MESH_TRACE_FROM
        if not (trace and 0 <= i < SERVE_MESH_TRACE_STEPS):
            return step(metrics, t0)
        if i == 0:
            prof.start()
        with torch.profiler.record_function(f"step{i}"):
            step(metrics, t0)
        torch.cuda.synchronize()
        if i == SERVE_MESH_TRACE_STEPS - 1:
            prof.stop()
    sched._decode_step = watched
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = sched.run(queue)
    torch.cuda.synchronize()
    peaks["decode_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    peaks["peak_gb"] = max(peaks.get("peak_gb", 0.0),
                           peaks["decode_peak_gb"])
    summary = trace_summary(prof, SERVE_MESH_TRACE_STEPS) \
        if trace and count[0] > SERVE_MESH_TRACE_FROM else None
    return metrics, peaks, summary


def serve_mesh_one(torch, dist, rank: int, world: int) -> None:
    """One card: smollm-360m at the serve phase's settings (``SERVE_CONFIG``,
    bf16 cache) on a (1, 1) NCCL world through ``Scheduler(..., mesh=)``,
    bitwise the one-card scheduler on the serve phase's queue (its
    ``SERVE_QUEUE`` and the chunked ``SERVE_LONG`` prompt): every logit
    and every token."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.serve import Scheduler, ServeConfig
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg = configs.get(SERVE_ARCH)
    params = transformer.init(cfg, seed=0, device="cuda")
    scfg = ServeConfig(cache_dtype=torch.bfloat16, record_logits=True,
                       **SERVE_CONFIG)

    def queue():
        return serve_queue(cfg, **SERVE_QUEUE,
                           extra=[serve_long_request(cfg)])
    t0 = time.perf_counter()
    plain = Scheduler(cfg, params, scfg).run(queue())
    on_mesh = Scheduler(cfg, params, scfg, mesh=mesh).run(queue())
    check_complete("serve_mesh (1, 1)", on_mesh)
    same = all(plain.requests[r].tokens == v.tokens and all(
        np.array_equal(a, b) for a, b in zip(plain.requests[r].logits,
                                             v.logits))
        for r, v in on_mesh.requests.items())
    emit({"phase": "serve_mesh", "check": "one_by_one_bitwise_one_card",
          "arch": cfg.name, "mesh": [1, 1], **SERVE_CONFIG,
          "requests": len(on_mesh.requests),
          "tokens": on_mesh.summary()["tokens"], "bitwise": same,
          "seconds": time.perf_counter() - t0})
    if not same:
        raise AssertionError("serve_mesh: the (1, 1) mesh run is not "
                             "bitwise the one-card scheduler's")


def serve_mesh_run(torch, dist, rank: int, world: int, name: str,
                   measured: Path) -> str | None:
    """Run ``name`` of ``SERVE_MESH_RUNS`` on this rank: the parameters
    as this rank's parts (``init_parts``, bitwise the slices of the
    one-card ``init``), a timed run (peak GB, TTFT, decode step, tokens/s;
    run (a) traces decode steps on rank 0), then a run with its logits
    recorded; rank 0 then serves the same requests on its card alone from
    the whole parameters, and again from them with a random half of their
    entries one ulp up, and holds the mesh run to it (``serve_gate``).
    Returns rank 0's failure, or None."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.core import tree
    from repro_torch.serve import Scheduler
    from repro_torch.train import serve as serve_fns
    from repro_torch.train.step import init_parts
    run = SERVE_MESH_RUNS[name]
    lead = rank == 0
    cfg = serve_mesh_config(name)
    mesh = make_mesh(run["mesh"], ("data", "model"), "cuda")
    ctx = serve_fns.mesh_context(cfg, mesh)
    params = init_parts(cfg, 0, "cuda", ctx.specs, mesh)
    scfg = serve_mesh_scfg(torch, run)

    def queue():
        return serve_queue(cfg, **run["queue"])
    t0 = time.perf_counter()
    sched = Scheduler(cfg, params, scfg, mesh=mesh)
    cache_gb = sum(v.numel() * v.element_size()
                   for v in sched.slots.cache.values()) / 1e9
    timed, peaks, steps = serve_mesh_timed(torch, sched, queue(),
                                           trace=lead and name == "a")
    check_complete(f"serve_mesh ({name})", timed)
    del sched
    sched = Scheduler(cfg, params, dataclasses.replace(
        scfg, record_logits=True), mesh=mesh)
    mesh_rec = recorded(sched.run(queue()))
    mesh_s = time.perf_counter() - t0
    del sched, params
    gc.collect()
    torch.cuda.empty_cache()
    per_rank = [None] * world
    dist.all_gather_object(per_rank, {**peaks, "cache_gb": cache_gb})
    failure = None
    if lead:
        s = serve_summary(timed)
        emit({"phase": "serve_mesh", "run": name, "arch": cfg.name,
              "n_layers": cfg.n_layers, "mesh": list(run["mesh"]),
              "param_dtype": cfg.param_dtype, "cache_dtype": "bfloat16",
              "num_slots": scfg.num_slots, "max_len": scfg.max_len,
              "whole_cache_gb": cache_gb * world,
              "per_rank": per_rank, "queue": run["queue"], **s,
              "trace": steps, "seconds": mesh_s})
        if name == "a":
            measured.write_text(json.dumps(per_rank))
        t1 = time.perf_counter()
        whole = transformer.init(cfg, seed=0, device="cuda")
        one_scfg = serve_mesh_scfg(torch, run, one_card=True, record=True)
        one = recorded(Scheduler(cfg, whole, one_scfg).run(queue()))
        gen = torch.Generator("cuda").manual_seed(SERVE_MESH_SPREAD_SEED)
        with torch.no_grad():
            for _, v in tree.flatten(whole):
                if v.is_floating_point():
                    v.copy_(one_ulp_up(torch, v, gen))
        spread = recorded(Scheduler(cfg, whole, one_scfg).run(queue()))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        gate = serve_gate(mesh_rec, one, spread)
        emit({"phase": "serve_mesh", "run": name, "check": "vs_one_card",
              "one_card": {"num_slots": one_scfg.num_slots,
                           "max_len": one_scfg.max_len},
              **{k: v for k, v in gate.items() if k != "near_ties"},
              "near_ties": gate["near_ties"][:8],
              "n_near_ties": len(gate["near_ties"]),
              "seconds": time.perf_counter() - t1})
        if gate["failures"] or not gate["factor"] <= 1.0:
            failure = (f"serve_mesh ({name}): factor {gate['factor']:.4g}, "
                       f"{gate['failures'][:4]}")
    return failure


def serve_mesh_checks(torch, dist, rank: int, world: int,
                      measured: Path) -> None:
    """The ``serve_mesh`` phase on one rank: on one card the (1, 1) check
    (``serve_mesh_one``), on four the runs of ``SERVE_MESH_RUNS``, each
    failure raised on every rank once its run has ended everywhere."""
    if world == 1:
        serve_mesh_one(torch, dist, rank, world)
        return
    for name in SERVE_MESH_RUNS:
        failure = serve_mesh_run(torch, dist, rank, world, name, measured)
        failures = [None] * world
        dist.all_gather_object(failures, failure)
        if failures[0] is not None:
            raise AssertionError(failures[0])


# ------------------------------------------------------------- tp_families
# The hybrid, xLSTM, encoder-decoder and VLM families through the
# tensor-parallel step (``models/ssm.py:_ssm_tp``, ``xlstm.py:_mlstm_tp`` /
# ``_slstm_tp``, the cross attention and the frontend split), fp32, remat,
# the kernels on, seed 0, 3 Muon steps.  One card: each family at
# ``TP_FAMILY_ONE_CARD``'s depth on a (1, 1) world, bitwise the same run
# without a mesh (losses and ``param_digest``).  Four cards: (a) llava at
# its published widths and all 32 layers on ``TP_LLAVA_MESH`` (7.26 B
# parameters: fp32 parameters, gradients and momentum ~87 GB whole, ~22
# a card split), batch 2 x (2880 patches + 512 tokens), its peak a card
# beside the dry run's walk (``tp_llava_predict``, started with the
# script); before it llava cut to ``TP_LLAVA_CMP_LAYERS`` layers held to
# one card by ``tp_gate``; (b) ``TP_FAMILY_RUNS`` each held to one card by
# ``tp_gate``; (c) the kernels at llava's owner shapes on (1, 4)
TP_LLAVA = "llava-next-mistral-7b"
TP_LLAVA_MESH = (1, 4)
TP_LLAVA_LAYERS = 32
TP_LLAVA_CMP_LAYERS = 4
TP_LLAVA_BATCH, TP_LLAVA_SEQ = 2, 512
TP_FAMILY_RUNS = {
    "hymba-1.5b": dict(mesh=(1, 4), batch=2, seq=2048, cut={"n_layers": 16}),
    "xlstm-350m": dict(mesh=(1, 4), batch=8, seq=512, cut={}),
    "seamless-m4t-large-v2": dict(mesh=(2, 2), batch=2, seq=512, cut={}),
}
# the (1, 1) world's cuts (depth; batch x sequence): every kind of block
# of each family (hymba's global layer 0 and its window inside 2048
# positions, one sLSTM block of xlstm's eight, seamless's 4096 frames,
# llava's 2880 patches), small enough for ~30 s of phase
TP_FAMILY_ONE_CARD = {
    "hymba-1.5b": (dict(n_layers=2), 1, 2048),
    "xlstm-350m": (dict(n_layers=8), 4, 512),
    "seamless-m4t-large-v2": (dict(n_layers=2, n_enc_layers=2), 1, 512),
    "llava-next-mistral-7b": (dict(n_layers=2), 1, 512)}


def tp_family_data(cfg, batch: int, seq: int):
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)


def start_tp_family_predictions() -> list:
    """The host's predicted peak a card of (a) (``tp_llava_predict``,
    ``start_walks``)."""
    return start_walks("tp_families_predict",
                       {"tp_llava": ("tp_llava_predict", ())})


def tp_llava_predict(out: str) -> None:
    """The dry run's walk of (a) (``launch.dryrun.walk_cell``): llava at
    ``TP_LLAVA_LAYERS`` layers, ``TP_LLAVA_BATCH`` x ``TP_LLAVA_SEQ``
    tokens and their patches on a fake world of ``TP_LLAVA_MESH``, owner
    Muon, one microbatch; its JSON to ``out``."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import walk_cell
    cfg = configs.get(TP_LLAVA, n_layers=TP_LLAVA_LAYERS)
    shape = ShapeSpec("tp_llava", TP_LLAVA_SEQ, TP_LLAVA_BATCH, "train")
    result = walk_cell(cfg, TP_LLAVA, shape, TP_LLAVA_MESH, "owner",
                       accum=1)
    Path(out).write_text(json.dumps(result, default=str))


def phase_tp_families(torch, smi: str, cells: list) -> None:
    """On one card the (1, 1) world (``tp_families_one``) in this process;
    on four, one NCCL rank a card (spawned, as the tp phase's): the
    kernels at llava's owner shapes on this card (c), then (a) and (b)
    (``tp_families_checks``) and (a)'s predicted peak (``cells``:
    ``start_tp_family_predictions``) beside the measured one.  Other card
    counts say so and pass."""
    import torch.multiprocessing as mp
    from repro_torch import configs
    from repro_torch.launch.mesh import HBM_BYTES, free_port
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    if world == 1:
        import datetime

        import torch.distributed as dist
        from repro_torch.launch.mesh import init_process_group
        init_process_group("cuda", rank=0, world_size=1,
                           init_method=f"tcp://localhost:{free_port()}",
                           timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
        try:
            tp_families_one(torch, dist, 0, 1)
        finally:
            dist.destroy_process_group()
        emit({"phase": "tp_families", "check": "done", "world": world,
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
        return
    if world != math.prod(TP_LLAVA_MESH):
        emit({"phase": "tp_families", "skipped": f"needs 1 or "
              f"{math.prod(TP_LLAVA_MESH)} cards, {world} visible"})
        return
    owner_kernels(torch, configs.get(TP_LLAVA, n_layers=TP_LLAVA_LAYERS),
                  TP_LLAVA_MESH, {"phase": "tp_families", "arch": TP_LLAVA,
                                  "n_layers": TP_LLAVA_LAYERS})
    gc.collect()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "tp_phase"
    out.mkdir(parents=True, exist_ok=True)
    measured = out / "llava.json"
    measured.unlink(missing_ok=True)
    t1 = time.perf_counter()
    mp.start_processes(nccl_rank, args=(world, free_port(),
                                        "tp_families_checks", measured),
                       nprocs=world, start_method="spawn", join=True)
    seconds = time.perf_counter() - t1
    predicted = tp_predictions(cells)["tp_llava"]
    got = json.loads(measured.read_text())
    ratio = predicted["peak_gb"] / max(got)
    emit({"phase": "tp_families", "check": "llava_peak_vs_dryrun",
          "arch": TP_LLAVA, "mesh": list(TP_LLAVA_MESH),
          "n_layers": TP_LLAVA_LAYERS, "predicted_peak_gb": predicted,
          "measured_peak_gb_per_card": got,
          "predicted_over_measured": ratio, "peak_gate": PEAK_GATE,
          "world": world, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    if abs(ratio - 1) > PEAK_GATE or max(got) > HBM_BYTES / 1e9:
        raise AssertionError(f"llava's peak {got} GB a card against the "
                             f"walk's {predicted['peak_gb']:.2f}: off by "
                             f"more than {PEAK_GATE:.0%} or past the card")


def tp_family_run(torch, arch: str, cut: dict, batch: int, seq: int,
                  mesh=None, **kw) -> dict:
    """``train_run`` of ``arch`` cut by ``cut`` (Muon, owner, donate), its
    patches or frames from ``family_inputs``; on ``mesh`` the
    tensor-parallel step."""
    from repro_torch import configs
    cfg = configs.get(arch, **cut)
    return train_run(torch, "muon", "owner", mesh, cfg=cfg,
                     dcfg=tp_family_data(cfg, batch, seq), donate=True,
                     inputs=family_inputs(torch, cfg, batch, mesh),
                     tensor_parallel=mesh is not None, **kw)


def tp_families_one(torch, dist, rank: int, world: int) -> None:
    """One card: each family at ``TP_FAMILY_ONE_CARD``'s depth through the
    tensor-parallel step on a (1, 1) world (the split code paths with a
    model axis of one rank) and without a mesh, on the same batches:
    losses and ``param_digest`` bitwise, launches from the plan each
    step (``train_run``)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    for arch, (cut, batch, seq) in TP_FAMILY_ONE_CARD.items():
        pair = []
        for m in (mesh, None):
            r = tp_family_run(torch, arch, cut, batch, seq, m, digest=True)
            pair.append({k: r[k] for k in ("loss_ema", "digest", "step_ms",
                                            "optimizer_ms", "launches",
                                            "peak_mem_gb")})
            del r
            gc.collect()
            torch.cuda.empty_cache()
        tp, one = pair
        same = tp["loss_ema"] == one["loss_ema"] and \
            tp["digest"] == one["digest"]
        emit({"phase": "tp_families", "arch": arch, "mesh": [1, 1],
              "cut": cut, "batch": [batch, seq],
              "bitwise_vs_no_mesh": same, "loss_ema": tp["loss_ema"],
              "step_ms": tp["step_ms"], "optimizer_ms": tp["optimizer_ms"],
              "no_mesh_step_ms": one["step_ms"],
              "launches": tp["launches"], "peak_mem_gb": tp["peak_mem_gb"]})
        if not same:
            raise AssertionError(f"{arch} on a (1, 1) world is not the run "
                                 "without a mesh bitwise")


def tp_families_checks(torch, dist, rank: int, world: int,
                       measured: Path) -> None:
    """The ``tp_families`` phase on one rank of four.

    1. llava at its widths cut to ``TP_LLAVA_CMP_LAYERS`` layers on
       ``TP_LLAVA_MESH``, held to one card on the same batches by
       ``tp_gate`` (``tp_vs_single``).
    2. (a) llava at ``TP_LLAVA_LAYERS`` layers on ``TP_LLAVA_MESH``:
       step ms, optimizer ms, tokens / s, peak GB and launches per rank
       (the peaks written to ``measured`` for the parent).
    3. (b) each of ``TP_FAMILY_RUNS`` on its mesh, held to one card alike
       (the batch in as many microbatches as the mesh has data ranks).
    Every run is made and printed before a missed gate fails the phase."""
    from repro_torch.launch.mesh import make_mesh

    lead = rank == 0
    missed = []

    def gated_run(arch, cut, batch, seq, shape):
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        t0 = time.perf_counter()
        run = tp_family_run(torch, arch, cut, batch, seq, mesh,
                            capture="host", grads=True)
        timing = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                      "peak_mem_gb", "launches")}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, timing)
        failure = None
        if lead:
            cfg = run["cfg"]
            emit({"phase": "tp_families", "arch": arch, "mesh": list(shape),
                  "cut": cut, "batch": [batch, seq],
                  "n_layers": cfg.n_layers, "loss_ema": run["loss_ema"],
                  "per_rank": per_rank,
                  "seconds": time.perf_counter() - t0})
            failure = tp_vs_single(
                torch, {tuple(shape): run}, cfg=cfg,
                dcfg=tp_family_data(cfg, batch, seq), donate=True,
                inputs=family_inputs(torch, cfg, batch))
        del run
        failures = [None] * world
        dist.all_gather_object(failures, failure)
        if failures[0] is not None:
            missed.append(failures[0])
        gc.collect()
        torch.cuda.empty_cache()

    gated_run(TP_LLAVA, {"n_layers": TP_LLAVA_CMP_LAYERS}, TP_LLAVA_BATCH,
              TP_LLAVA_SEQ, TP_LLAVA_MESH)

    # (a): llava at its published depth, what one card cannot hold
    mesh = make_mesh(TP_LLAVA_MESH, ("data", "model"), "cuda")
    run = tp_family_run(torch, TP_LLAVA, {"n_layers": TP_LLAVA_LAYERS},
                        TP_LLAVA_BATCH, TP_LLAVA_SEQ, mesh)
    cfg = run["cfg"]
    timing = {k: run[k] for k in ("step_ms", "optimizer_ms", "peak_mem_gb",
                                  "launches")}
    per_rank = [None] * world
    dist.all_gather_object(per_rank, timing)
    if lead:
        tokens = TP_LLAVA_BATCH * TP_LLAVA_SEQ
        positions = TP_LLAVA_BATCH * (TP_LLAVA_SEQ + cfg.frontend_len)
        steady = [{k: sum(r[k][1:]) / len(r[k][1:])
                   for k in ("step_ms", "optimizer_ms")} for r in per_rank]
        emit({"phase": "tp_families", "check": "llava_full_depth",
              "arch": TP_LLAVA, "mesh": list(TP_LLAVA_MESH),
              "n_layers": cfg.n_layers, "params": cfg.param_count(),
              "batch": [TP_LLAVA_BATCH, TP_LLAVA_SEQ],
              "patches": [cfg.frontend_len, cfg.frontend_dim],
              "loss_ema": run["loss_ema"], "per_rank": per_rank,
              "steady_mean_ms_per_rank": steady,
              "tokens_per_s": [tokens / (t / 1e3) for t in
                               per_rank[0]["step_ms"]],
              "positions_per_s": [positions / (t / 1e3) for t in
                                  per_rank[0]["step_ms"]],
              "launches_per_step": run["launches_by_step"]})
        measured.write_text(json.dumps([r["peak_mem_gb"]
                                        for r in per_rank]))
    del run
    gc.collect()
    torch.cuda.empty_cache()

    for arch, r in TP_FAMILY_RUNS.items():
        gated_run(arch, r["cut"], r["batch"], r["seq"], r["mesh"])
    if missed:
        raise AssertionError("; ".join(missed))


def phase_serve_mesh(torch, smi: str, cells: list) -> None:
    """Every visible card, one NCCL rank each (spawned, as the tp
    phases'): on one card ``serve_mesh_one``, on four the runs of
    ``SERVE_MESH_RUNS``, then run (a)'s peak on each card beside the host
    walk's prediction of its decode step (``cells``:
    ``start_serve_mesh_predictions``).  Other counts say so and pass."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world = torch.cuda.device_count()
    if world not in (1, 4):
        emit({"phase": "serve_mesh", "skipped": f"needs 1 or 4 cards, "
              f"{world} visible"})
        return
    out = ROOT / "build" / "serve_mesh"
    out.mkdir(parents=True, exist_ok=True)
    measured = out / "peaks.json"
    measured.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(nccl_rank, args=(world, free_port(),
                                        "serve_mesh_checks", measured),
                       nprocs=world, start_method="spawn", join=True)
    line = {"phase": "serve_mesh", "world": world,
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    if world == 4:
        predicted = tp_predictions(cells)["serve_a"]["peak_gb"]
        got = json.loads(measured.read_text())
        decode = [r["decode_peak_gb"] for r in got]
        line.update({"check": "a_peak_vs_dryrun",
                     "predicted_decode_peak_gb": predicted,
                     "measured_decode_peak_gb_per_card": decode,
                     "measured_run_peak_gb_per_card":
                         [r["peak_gb"] for r in got],
                     "predicted_over_measured": predicted / max(decode)})
    emit(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--trace", default="",
                    help="comma-separated mesh-phase runs (of "
                         + ",".join(r[0] for r in MESH_RUNS) + "; rank 0), "
                         "families-phase archs (of "
                         + ",".join(FAMILY_RUNS) + "; their Muon run) and "
                         "'serve' / 'serve_paged' (decode steps of the "
                         "serve phase / of both equal-memory tiers) to "
                         "trace with torch.profiler")
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

    # the dry run's production cells and the tp phases' predictions are
    # host work (a fake world of fake tensors): started first, they run
    # beside the card phases
    cells = start_dryrun_cells() if "dryrun" in phases else []
    four = torch.cuda.device_count() == math.prod(TP_QWEN_MESH)
    tp_cells = (start_tp_predictions() if "tp_qwen" in phases and four
                else []) + (start_tp_moe_predictions()
                            if "tp_moe" in phases and four else []) + \
        (start_zero3_predictions() if "zero3" in phases and four else []) + \
        (start_tp_family_predictions() if "tp_families" in phases and four
         else []) + \
        (start_serve_mesh_predictions() if "serve_mesh" in phases and four
         else [])
    try:
        return run_phases(torch, args, phases, cells, tp_cells)
    finally:
        stop_dryrun_cells(cells + tp_cells)


def run_phases(torch, args, phases: list, cells: list,
               tp_cells: list) -> int:
    """The device line, each phase of ``phases`` in ``PHASES`` order, the
    kernels summary and the closing lines; ``cells`` are the running
    ``start_dryrun_cells`` processes, ``tp_cells`` the
    ``start_tp_predictions`` / ``start_tp_moe_predictions`` /
    ``start_zero3_predictions`` ones."""
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
    train_runs = {}              # the dropin phase's references
    keep = ("loss_ema", "digest", "step_ms", "optimizer_ms")
    if "train" in phases:
        run = phase_train(torch, "muon")
        launches, train_losses = run["launches"], run["loss_ema"]
        fused = {k: run[k] for k in ("step_ms", "optimizer_ms",
                                     "peak_mem_gb")}
        train_runs["muon"] = {k: run[k] for k in keep}
        del run
    if "adamw" in phases:
        torch.cuda.empty_cache()
        run = phase_train(torch, "adamw")
        train_runs["adamw"] = {k: run[k] for k in keep}
        del run
    if "dropin" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_dropin(torch, smi[0], train_runs)
    if "dryrun" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_dryrun(torch, smi[0], cells)
    if "variants" in phases:
        phase_variants(torch)
    if "pipeline" in phases:
        phase_pipeline(torch, fused)
    if "resilience" in phases:
        torch.cuda.empty_cache()
        phase_resilience(torch, smi[0])
    moe_launches = moe_run = None
    if "moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        moe_launches, moe_run = phase_moe(torch, smi[0])
        torch.cuda.empty_cache()
    family_launches = None
    if "families" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        family_launches = phase_families(torch, smi[0], {
            t: str(Path(args.trace_dir) / f"trace_{t}.json.gz")
            for t in args.trace.split(",") if t in FAMILY_RUNS})
        torch.cuda.empty_cache()
    if "serve" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve(torch, smi[0], str(Path(args.trace_dir)
                                       / "trace_serve.json.gz")
                    if "serve" in args.trace.split(",") else None)
    if "serve_families" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_families(torch, smi[0])
    if "serve_paged" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_paged(torch, smi[0], args.trace_dir
                          if "serve_paged" in args.trace.split(",")
                          else None)
    if "mesh" in phases:
        world = torch.cuda.device_count()
        phase_mesh(torch, train_losses, {
            t: str(Path(args.trace_dir) / f"trace_{t}_mesh{world}.json.gz")
            for t in args.trace.split(",")
            if t and t not in FAMILY_RUNS
            and t not in ("serve", "serve_paged")})
    if "tp" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp(torch, smi[0])
    if "tp_qwen" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp_qwen(torch, smi[0],
                      [c for c in tp_cells if c["cell"] in ("owner", "adamw")])
    if "tp_moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp_moe(torch, smi[0],
                     [c for c in tp_cells if c["cell"].startswith(
                         ("owner_", "adamw_"))], moe_run)
    if "zero3" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_zero3(torch, smi[0],
                    [c for c in tp_cells if c["cell"].startswith(
                        ("zero3_", "tp_"))], train_runs.get("muon"))
    if "tp_families" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp_families(torch, smi[0], [c for c in tp_cells
                                          if c["cell"] == "tp_llava"])
    if "serve_mesh" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_mesh(torch, smi[0], [c for c in tp_cells
                                         if c["cell"] == "serve_a"])

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"],
         "launches": None if launches is None else launches[meta["counter"]],
         "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "shape": row["shape"],
         "launches_moe": None if moe_launches is None
         else moe_launches[meta["counter"]],
         "launches_families": None if family_launches is None
         else {a: n[meta["counter"]] for a, n in family_launches.items()}}
        for name, meta in KERNELS.items()
        if (row := summary.get(name)) is not None]})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
