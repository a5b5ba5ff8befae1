"""Production training launcher on the resilient supervisor loop (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 50 --opt owner --ckpt-dir build/ckpt [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  The run is supervised by
``runtime/resilient.py``: streaming deterministic pipeline with a
checkpointable cursor, rotating async checkpoints (train tree + data
state), straggler monitoring with online re-dedication, and recovery from
owner loss / preemption.  ``--faults`` injects a scripted adversity drill
(``runtime/faults.py`` DSL).

``--mesh`` runs one process per rank under a ``torch.distributed`` launch
(``torchrun``, or ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` set by the caller; rank r takes card r): the reference's
("data", "model") mesh, ``remesh()``'s largest model axis up to
``--prefer-model`` (16, the reference's default: (1, 4) on four cards;
``--prefer-model 2`` gives (2, 2)), tensor-parallel over 'model' and
data-parallel over 'data' (the MoE family's experts split over 'model';
every family the token pipeline feeds splits, the hybrid and xLSTM ones
included); the ``[mesh]`` line says which mesh ran.  ``--faults`` kill /
readd raise there (ROADMAP item 8); ``--resume`` restores a checkpoint
written at any world size and mesh shape.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2.5-14b --mesh --batch 4 --seq 2048 --steps 10

The last line is ``[result] {json}``: the steps, the final ``loss_ema``,
a float64 sum of every parameter (which two runs compare bit for bit) and
the Gram kernels' launches over the run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import tree
from repro_torch.core.gram_ns import GramNSConfig
from repro_torch.core.muon import MuonConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.resilient import ResilientConfig, ResilientLoop


def make_mesh(device: torch.device, prefer_model: int):
    """The ("data", "model") mesh of a ``torch.distributed`` launch
    (``remesh(prefer_model=...)``); raises unless the environment names
    this process's rank and the world."""
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.runtime.elastic import remesh
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise SystemExit(f"--mesh needs a torch.distributed launch "
                         f"(torchrun); {', '.join(missing)} not set")
    init_process_group(device.type, rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]),
                       init_method="env://")
    return remesh(prefer_model=prefer_model, device_type=device.type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--opt", default="owner",
                    choices=["owner", "gather", "adamw"])
    ap.add_argument("--variant", default="muon",
                    help="optimizer variant (registry in core/api.py)")
    ap.add_argument("--strategy", default="load_balance",
                    choices=["load_balance", "greedy", "lpt", "round_robin",
                             "rank0", "xor"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--pipeline", default="fused",
                    choices=["fused", "bucketed"])
    ap.add_argument("--owners", type=int, default=None,
                    help="owner slots when running without a mesh "
                         "(default: the visible cards, 1 on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="one rank per process under a torch.distributed "
                         "launch, tensor-parallel over the mesh's 'model' "
                         "axis and data-parallel over 'data'")
    ap.add_argument("--prefer-model", type=int, default=16,
                    help="largest 'model' axis --mesh builds (remesh)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault-injection drill, e.g. "
                         "'slow@8:r3x4.0; kill@30:r1; readd@40; preempt@52'")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="disable online straggler re-dedication")
    ap.add_argument("--rebalance-window", type=int, default=20)
    ap.add_argument("--rebalance-threshold", type=float, default=1.3)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=args.reduced)
    if cfg.frontend is not None or cfg.encdec:
        raise SystemExit(f"{args.arch} reads patches or frames, which the "
                         "token pipeline does not make")
    mesh = None
    if args.mesh:
        mesh = make_mesh(device, args.prefer_model)
        print(f"[mesh] {dict(zip(mesh.mesh_dim_names, mesh.shape))}",
              flush=True)
    # the Hopper kernels on the card; a CPU tensor runs each kernel's plain
    # version
    mcfg = MuonConfig(mode=args.opt, variant=args.variant,
                      learning_rate=args.lr, pipeline=args.pipeline,
                      ns=GramNSConfig(use_kernels=True))
    rcfg = ResilientConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        strategy=args.strategy, accum_steps=args.accum,
        rebalance=not args.no_rebalance, window=args.rebalance_window,
        threshold=args.rebalance_threshold)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    faults = FaultPlan.parse(args.faults) if args.faults else None
    owners = args.owners or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)

    loop = ResilientLoop(
        cfg, dcfg, muon=mcfg, run=rcfg, num_owners=owners, mesh=mesh,
        ckpt_dir=args.ckpt_dir, faults=faults, resume=args.resume,
        log=lambda *a: print(*a, flush=True), device=device)
    print(f"[plan] {loop.plan.stats}")
    if args.resume and loop.state.step:
        print(f"[resume] step {loop.state.step}")

    # Everything alive now lives for the whole run; exempt it from Python's
    # cyclic GC, whose full collections would scan torch's module objects
    # and stall the host for 100 ms or more.
    gc.collect()
    gc.freeze()
    reset_launches()
    report = loop.run()
    if report.rebalances:
        print(f"[rebalances] {len(report.rebalances)} "
              f"(last speeds {np.round(report.rebalances[-1]['speed'], 3)})")
    if report.recoveries:
        print(f"[recoveries] "
              f"{[(r['kind'], r['step']) for r in report.recoveries]}")
    print(f"[done] steps={report.steps} owners={report.final_owner_count} "
          f"loss_ema={float(loop.state.loss_ema):.4f} "
          f"avg_step={np.mean(report.step_times or [0.0])*1e3:.0f} ms")
    with torch.no_grad():
        sums = {p: v.double().sum() for p, v in tree.flatten(loop.state.params)}
        if loop.specs is not None:
            # a split parameter's sum is its parts' over the model axis
            import torch.distributed as dist
            group = mesh.get_group("model")
            for p, spec in loop.specs.items():
                if any(e is not None for e in spec):
                    dist.all_reduce(sums[p], group=group)
        sums = {p: float(v) for p, v in sums.items()}
    print("[result] " + json.dumps({
        "steps": report.steps, "executed_steps": report.executed_steps,
        "loss_ema": float(loop.state.loss_ema), "param_sums": sums,
        "launches": dict(LAUNCHES)}),
        flush=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
