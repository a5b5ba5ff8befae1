"""Multi-rank checks of the PyTorch port, one gloo process per rank.

Run by ``tests/test_torch_mesh_*.py`` through ``launch``, the way
``tests/test_distributed.py`` runs ``dist_check.py``:

    python tests/torch_dist_check.py owner --rank R --world W --port P \\
        --mesh 2,4 --out DIR
    python tests/torch_dist_check.py train --rank R --world W --port P \\
        --mesh 2,1 --out DIR
    python tests/torch_dist_check.py variants --rank R --world W \\
        --port P --mesh 2,2 --out DIR
    python tests/torch_dist_check.py pipeline --rank R --world W \\
        --port P --mesh 2,2 --out DIR
    python tests/torch_dist_check.py checkpoint --rank R --world W \\
        --port P --mesh 2,2 --out DIR
    python tests/torch_dist_check.py restore --rank R --world W \\
        --port P --mesh 1,2 --out DIR/restore
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_check.py jax --mesh 2,4 --out DIR

``owner`` is the twin of ``dist_check.py``'s checks 1–5 on a
("data", "model") mesh with its tree, gradients and tensor-parallel specs,
plus the port's own invariants; ``train`` runs the data-parallel train step
of the reduced smollm-360m; ``variants`` runs every stateful optimizer
variant 3 steps on the mesh (and, on rank 0, in one process on the same
plan); ``pipeline`` runs the bucketed schedule against the fused one, its
event order, prestaged accumulation and AdamW's train step;
``checkpoint`` runs the resilient loop on the mesh (a rebalance, then a
checkpoint written in owner row blocks into DIR/ckpt), reshards an
owner-layout state on the mesh against the one-process reshard, and
kills an owner on the mesh; ``restore`` resumes that checkpoint on
another mesh (the checkpoint of DIR's parent); ``jax`` runs
the reference's own multi-device owner update on an Auto-axis mesh.  Each
writes ``rank<R>.npz`` and ``rank<R>.json`` (``jax.npz``) into DIR; the
tests read them.  Every
process group and every wait has a timeout, so a collective that hangs
fails one test.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PG_TIMEOUT = datetime.timedelta(seconds=120)
AXES = ("data", "model")

# dist_check.py's training specs: TP on the hidden axes, replicated elsewhere
SPECS = {"blocks/wq": (None, None, "model"),
         "blocks/wo": (None, "model", None),
         "blocks/up": (None, None, "model"),
         "blocks/down": (None, "model", None),
         "blocks/norm_scale": (None, None), "embed_table": ("model", None)}
LR, MOMENTUM, NS_STEPS = 0.1, 0.9, 5


def dist_tree() -> dict:
    """dist_check.py's tree, drawn with numpy (the same in both packages)."""
    rng = np.random.default_rng(0)

    def n(*s):
        return (rng.standard_normal(s) * 0.02).astype(np.float32)
    return {"blocks": {"wq": n(8, 64, 64), "wo": n(8, 64, 64),
                       "up": n(8, 64, 256), "down": n(8, 256, 64),
                       "norm_scale": np.ones((8, 64), np.float32)},
            "embed_table": n(128, 64)}


def dist_grads(seed: int = 1) -> dict:
    """Gradients for ``dist_tree``, drawn leaf by leaf in path order."""
    rng = np.random.default_rng(seed)

    def n(shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    blocks = dist_tree()["blocks"]
    return {"blocks": {k: n(blocks[k].shape) for k in sorted(blocks)},
            "embed_table": n((128, 64))}


def launch(mode: str, world: int, mesh: tuple, out: Path,
           timeout: float = 240.0) -> None:
    """Run ``mode`` on ``world`` gloo ranks (one process each, logs in
    ``out``); raise with the logs if one fails or the deadline passes, and
    leave no process behind."""
    from repro_torch.launch.mesh import free_port
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, "--rank", str(r), "--world",
             str(world), "--port", str(port), "--mesh",
             ",".join(map(str, mesh)), "--out", str(out)],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        text = "\n".join(f"--- rank {r} (exit {rc})\n"
                         + (out / f"rank{r}.log").read_text()[-4000:]
                         for r, rc in enumerate(rcs))
        raise AssertionError(f"{mode} world {mesh} failed:\n{text}")


def run_jax(mesh: tuple, out: Path, timeout: float = 240.0) -> None:
    """The reference's owner update on ``mesh`` host devices, into
    ``out/jax.npz``."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{int(np.prod(mesh))}")
    proc = subprocess.run(
        [sys.executable, __file__, "jax", "--mesh", ",".join(map(str, mesh)),
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"jax reference failed:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")


def load(out: Path, world: int) -> dict:
    """{'json': [per rank], 'npz': [per rank]} written by a launch."""
    return {"json": [json.loads((out / f"rank{r}.json").read_text())
                     for r in range(world)],
            "npz": [dict(np.load(out / f"rank{r}.npz"))
                    for r in range(world)]}


# ------------------------------------------------------------------ ranks

def _setup(args):
    import torch
    from repro_torch.launch.mesh import init_process_group, make_mesh
    torch.set_num_threads(1)
    init_process_group("cpu", rank=args.rank, world_size=args.world,
                       init_method=f"tcp://localhost:{args.port}",
                       timeout=PG_TIMEOUT)
    return make_mesh(args.mesh, AXES, "cpu")


def _full(v):
    from torch.distributed.tensor import DTensor
    return (v.full_tensor() if isinstance(v, DTensor) else v).detach()


def _flat_np(prefix: str, t) -> dict:
    from repro_torch.core import tree
    return {f"{prefix}/{p}": _full(v).numpy() for p, v in tree.flatten(t)}


class CommRecorder:
    """``CommDebugMode`` that also keeps (op, bytes received) of every c10d
    collective: the output buffer's size."""

    def __new__(cls):
        from torch.distributed.tensor.debug import CommDebugMode

        class Recorder(CommDebugMode):
            def __init__(self):
                super().__init__()
                self.records = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if getattr(func, "namespace", "") == "c10d":
                    out = args[0] if args else None
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    nbytes = sum(t.numel() * t.element_size() for t in outs
                                 if hasattr(t, "numel"))
                    self.records.append([func.overloadpacket.__name__,
                                         int(nbytes)])
                return super().__torch_dispatch__(func, types, args, kwargs)
        return Recorder()


def owner_rank(args) -> None:
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.core.owner_comms import group_key_str
    from repro_torch.models.sharding import place, placements

    mesh = _setup(args)
    P = tree.tree_map(torch.from_numpy, dist_tree())
    G = tree.tree_map(torch.from_numpy, dist_grads())
    Pd, Gd = place(P, SPECS, mesh), place(G, SPECS, mesh)
    cfg = MuonConfig(mode="owner", learning_rate=LR, momentum=MOMENTUM,
                     ns=GramNSConfig(num_steps=NS_STEPS))

    def muon(plan, m, **kw):
        return api.Muon(plan, m, config=dataclasses.replace(cfg, **kw),
                        device="cpu")

    plan = api.dedicate_params(P, mesh=mesh, strategy="greedy")
    opt = muon(plan, mesh)
    state = opt.init(Pd)
    rec = CommRecorder()
    with rec:
        upd, state2 = opt.update(Gd, state, Pd)
    _, state3 = opt.update(Gd, state2, Pd)

    opt_g = muon(plan, mesh, mode="gather")
    rec_g = CommRecorder()
    with rec_g:
        upd_g, _ = opt_g.update(Gd, opt_g.init(Pd), Pd)

    # DP x TP: gradients still to be averaged over 'data' (every data rank
    # holds the same part, so the average is exact), shards over 'model'
    Gp = tree.rebuild(G, {
        p: DTensor.from_local(
            g.to_local(), mesh,
            (Partial("avg"),) + tuple(placements(SPECS[p], mesh))[1:],
            run_check=False, shape=g.shape, stride=g.stride())
        for p, g in tree.flatten(Gd)})
    rec_p = CommRecorder()
    with rec_p:
        upd_p, _ = opt.update(Gp, opt.init(Pd), Pd)

    opt_f = muon(plan, mesh, ns=GramNSConfig(num_steps=NS_STEPS,
                                             bucket_fusion=True))
    upd_f, _ = opt_f.update(Gd, opt_f.init(Pd), Pd)
    upd_r, _ = opt.update(G, opt.init(P), P)       # replicated gradients

    plan_lb = api.dedicate_params(P, mesh=mesh, strategy="load_balance",
                                  physical_layout="assignment")
    opt_lb = muon(plan_lb, mesh)
    upd_lb, state_lb = opt_lb.update(Gd, opt_lb.init(Pd), Pd)

    try:
        opt_c = muon(plan, mesh, compress_grads=True)
        opt_c.update(Gp, opt_c.init(Pd), Pd)
        compress_partial = "no error"
    except ValueError as e:
        compress_partial = str(e)

    owner_index = 0
    for i in range(mesh.ndim):
        owner_index = owner_index * mesh.size(i) + mesh.get_local_rank(i)
    arrays = {f"mom/{k}": v.numpy() for k, v in state2.momentum.items()}
    arrays.update({f"mom_lb/{k}": v.numpy()
                   for k, v in state_lb.momentum.items()})
    for name, u in [("owner", upd), ("gather_mesh", upd_g), ("fused", upd_f),
                    ("replicated", upd_r), ("partial", upd_p),
                    ("lb", upd_lb)]:
        arrays.update(_flat_np(name, u))
    if args.rank == 0:
        # one process: gather mode on one owner, and the same plans
        plan1 = api.dedicate_params(P, num_owners=1, strategy="rank0")
        opt1 = muon(plan1, None, mode="gather")
        arrays.update(_flat_np("gather_1", opt1.update(G, opt1.init(P),
                                                       P)[0]))
        for name, pl in [("nomesh", plan), ("lb_nomesh", plan_lb)]:
            o = muon(pl, None)
            u, st = o.update(G, o.init(P), P)
            arrays.update(_flat_np(name, u))
            arrays.update({f"{name}_mom/{k}": v.numpy()
                           for k, v in st.momentum.items()})
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    info = {
        "owner_index": owner_index, "num_owners": plan.num_owners,
        "compress_partial": compress_partial,
        "step_after_two": state3.step,
        "rows": {group_key_str(k): [state2.momentum[group_key_str(k)].shape[0],
                                    g.packed_size]
                 for k, g in plan.groups.items()},
        "lb_pack_identity": {
            group_key_str(k): bool(np.array_equal(
                g.pack_index[:g.count], np.arange(g.count)))
            for k, g in plan_lb.groups.items()},
        "update_bytes": {p: v.to_local().numel() * v.to_local().element_size()
                         for p, v in tree.flatten(upd) if p in plan.leaves},
        "packed_over_count": {p: plan.groups[p].packed_size
                              / plan.groups[p].count for p in plan.leaves},
        "matrix_leaves": sorted(plan.leaves),
        "comm": {"owner": rec.records, "gather": rec_g.records,
                 "partial": rec_p.records},
        "comm_counts": {"owner": {str(k): v for k, v in
                                  rec.get_comm_counts().items()},
                        "gather": {str(k): v for k, v in
                                   rec_g.get_comm_counts().items()}},
    }
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def train_rank(args) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.muon import MuonConfig
    from repro_torch.core.owner_comms import group_key_str
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import transformer
    from repro_torch.train.step import init_state, make_train_step

    mesh = _setup(args)
    cfg = configs.get("smollm-360m", reduced=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    mcfg = MuonConfig(learning_rate=0.02, momentum=0.95)
    shapes = transformer.init(cfg, device="meta")

    def train(m):
        plan = api.dedicate_params(shapes, mesh=m)
        opt = api.Muon(plan, m, config=mcfg, device="cpu")
        state = init_state(cfg, opt, seed=0, device="cpu", mesh=m)
        step = make_train_step(cfg, opt, m, device="cpu")
        losses = []
        for i in range(3):
            state = step(state, batch_for_step(dcfg, i, device="cpu",
                                               mesh=m))
            losses.append(float(state.loss_ema))
        return plan, state, losses

    plan, state, losses = train(mesh)
    arrays = {f"params/{p}": v.detach().numpy()
              for p, v in tree.flatten(state.params)}
    arrays.update({f"mom/{k}": v.numpy()
                   for k, v in state.opt_state.momentum.items()})
    info = {"losses": losses, "step": state.step, "rank": args.rank,
            "opt_step": state.opt_state.step,
            "local_tokens": int(batch_for_step(dcfg, 0, device="cpu",
                                               mesh=mesh)["tokens"].shape[0]),
            "num_owners": plan.num_owners,
            "rows": {group_key_str(k): [
                state.opt_state.momentum[group_key_str(k)].shape[0],
                g.packed_size] for k, g in plan.groups.items()}}
    if args.rank == 0:
        plan1, single, losses1 = train(None)
        info["single_losses"] = losses1
        arrays.update({f"single/{p}": v.detach().numpy()
                       for p, v in tree.flatten(single.params)})
        arrays.update({f"single_mom/{k}": v.numpy()
                       for k, v in single.opt_state.momentum.items()})
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


VARIANTS = ("normuon", "muonbp", "dion2", "adamuon")
VARIANT_STEPS = 3


def variants_rank(args) -> None:
    """Each stateful variant (MuonBP with period 2: refresh, reuse,
    refresh) 3 steps on the mesh from tensor-parallel, replicated and
    ``Partial`` (data-parallel) gradients, a fresh gradient each step;
    saves every step's update and this rank's variant-state rows after each
    step.  Rank 0 also runs the same plan in one process."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.models.sharding import place, placements

    mesh = _setup(args)
    P = tree.tree_map(torch.from_numpy, dist_tree())
    Pd = place(P, SPECS, mesh)
    plan = api.dedicate_params(P, mesh=mesh, strategy="greedy")
    base = MuonConfig(mode="owner", learning_rate=LR, momentum=MOMENTUM,
                      muonbp_period=2, ns=GramNSConfig(num_steps=NS_STEPS))

    def grads(t: int, kind: str):
        G = tree.tree_map(torch.from_numpy, dist_grads(1 + t))
        if kind == "replicated":
            return G
        Gd = place(G, SPECS, mesh)
        if kind == "tp":
            return Gd
        # every data rank holds the same part, so the average is exact
        return tree.rebuild(G, {
            p: DTensor.from_local(
                g.to_local(), mesh,
                (Partial("avg"),) + tuple(placements(SPECS[p], mesh))[1:],
                run_check=False, shape=g.shape, stride=g.stride())
            for p, g in tree.flatten(Gd)})

    def run(variant, m, kind, params):
        opt = api.Muon(plan, m, config=dataclasses.replace(
            base, variant=variant), device="cpu")
        state, out = opt.init(params), {}
        for t in range(VARIANT_STEPS):
            upd, state = opt.update(grads(t, kind), state, params)
            out.update(_flat_np(f"{variant}/{kind}/upd{t}", upd))
            out.update({f"{variant}/{kind}/state{t}/{p}": v.numpy()
                        for p, v in tree.flatten(state.variant_state)})
        return out

    arrays = {}
    for variant in VARIANTS:
        for kind in ("tp", "replicated", "partial"):
            arrays.update(run(variant, mesh, kind, Pd if kind != "replicated"
                              else P))
        if args.rank == 0:
            single = run(variant, None, "replicated", P)
            arrays.update({k.replace("/replicated/", "/nomesh/", 1): v
                           for k, v in single.items()})
    owner_index = 0
    for i in range(mesh.ndim):
        owner_index = owner_index * mesh.size(i) + mesh.get_local_rank(i)
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(
        {"owner_index": owner_index, "num_owners": plan.num_owners}))


PIPELINE_VARIANTS = ("muon", "normuon", "muonbp", "dion2", "adamuon",
                     "adamw")
PIPELINE_KINDS = ("tp", "partial")
# dist_tree plus a (64, 32) leaf: a second Gram bucket (m = 32)
PIPELINE_SPECS = {**SPECS, "blocks/wk": (None, None, "model")}


def pipeline_tree() -> dict:
    t = dist_tree()
    t["blocks"]["wk"] = (np.random.default_rng(2).standard_normal(
        (8, 64, 32)) * 0.02).astype(np.float32)
    return t


def pipeline_grads(seed: int) -> dict:
    g = dist_grads(seed)
    g["blocks"]["wk"] = (np.random.default_rng(1000 + seed).standard_normal(
        (8, 64, 32)) * 0.1).astype(np.float32)
    return g


def _dp_grads(G, mesh, kind: str):
    """``G`` placed by ``PIPELINE_SPECS`` ("tp") or, for "partial", as
    gradients still to be averaged over 'data' (every data rank holds the
    same part, so the average is exact) and sharded over 'model'."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.core import tree
    from repro_torch.models.sharding import place, placements
    Gd = place(G, PIPELINE_SPECS, mesh)
    if kind == "tp":
        return Gd
    return tree.rebuild(G, {
        p: DTensor.from_local(
            g.to_local(), mesh,
            (Partial("avg"),)
            + tuple(placements(PIPELINE_SPECS[p], mesh))[1:],
            run_check=False, shape=g.shape, stride=g.stride())
        for p, g in tree.flatten(Gd)})


def pipeline_rank(args) -> None:
    """The bucketed schedule on the mesh.

    1. Every registry variant (MuonBP period 2) 3 steps fused and bucketed
       from tensor-parallel and ``Partial`` gradients: each step's update
       and this rank's momentum / variant-state rows.
    2. The collectives (op, bytes) of muon's first step, fused and
       bucketed, for both kinds.
    3. The schedule's issue / wait / compute events (``on_event``).
    4. The reduced smollm-360m train step, bucketed, ``accum_steps=2``,
       with and without prestaging, 2 steps.
    5. AdamW's train step (3 steps) against the clone-and-all-reduce path
       recomputed here: local gradients, each reduced by a copy,
       ``all_reduce`` and ``div_``, then ``adamw_update``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig, _matrix_and_rest, _split
    from repro_torch.core.pipeline import BucketPipeline
    from repro_torch.core.update_rules import adamw_update
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import transformer
    from repro_torch.models.sharding import place
    from repro_torch.train.step import (init_state, make_loss_fn,
                                        make_train_step)

    mesh = _setup(args)
    P = tree.tree_map(torch.from_numpy, pipeline_tree())
    Pd = place(P, PIPELINE_SPECS, mesh)
    plan = api.dedicate_params(P, mesh=mesh, strategy="greedy")
    base = MuonConfig(mode="owner", learning_rate=LR, momentum=MOMENTUM,
                      muonbp_period=2, ns=GramNSConfig(num_steps=NS_STEPS))
    arrays, info = {}, {"comm": {}}

    # 1 + 2
    for variant in PIPELINE_VARIANTS:
        for kind in PIPELINE_KINDS:
            for pipe in ("fused", "bucketed"):
                opt = api.Muon(plan, mesh, config=dataclasses.replace(
                    base, variant=variant, pipeline=pipe), device="cpu")
                state, tag = opt.init(Pd), f"{variant}/{kind}/{pipe}"
                for t in range(VARIANT_STEPS):
                    G = _dp_grads(tree.tree_map(torch.from_numpy,
                                                pipeline_grads(1 + t)),
                                  mesh, kind)
                    if variant == "muon" and t == 0:
                        rec = CommRecorder()
                        with rec:
                            upd, state = opt.update(G, state, Pd)
                        info["comm"][tag] = rec.records
                    else:
                        upd, state = opt.update(G, state, Pd)
                    arrays.update(_flat_np(f"{tag}/upd{t}", upd))
                    arrays.update({f"{tag}/state{t}/mom/{k}": v.numpy()
                                   for k, v in state.momentum.items()})
                    arrays.update({f"{tag}/state{t}/vs/{p}": v.numpy()
                                   for p, v in
                                   tree.flatten(state.variant_state)})

    # 3
    opt = api.Muon(plan, mesh, config=dataclasses.replace(
        base, pipeline="bucketed"), device="cpu")
    pipe = BucketPipeline(plan, opt.config, mesh, opt.variant)
    events = []
    pipe.on_event = lambda what, b: events.append([what, b])
    G = _dp_grads(tree.tree_map(torch.from_numpy, pipeline_grads(1)), mesh,
                  "partial")
    gm, _ = _matrix_and_rest(plan, G)
    pm, _ = _matrix_and_rest(plan, Pd)
    gm_local, gm_pl = _split(pipe.layout, gm)
    pm_local, _ = _split(pipe.layout, pm)
    pipe.run_from_grads(gm_local, gm_pl, pm_local, opt.init(Pd))
    info.update({"events": events, "overlap": pipe.overlap,
                 "buckets": len(pipe.schedule)})

    # 4
    cfg = configs.get("smollm-360m", reduced=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    shapes = transformer.init(cfg, device="meta")
    tplan = api.dedicate_params(shapes, mesh=mesh)
    losses, scatters = {}, {}
    for prestage in (False, True):
        opt = api.Muon(tplan, mesh, config=MuonConfig(
            learning_rate=0.02, momentum=0.95, pipeline="bucketed"),
            device="cpu")
        state = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh)
        step = make_train_step(cfg, opt, mesh, accum_steps=2,
                               prestage=prestage, device="cpu")
        losses[str(prestage)] = []
        for i in range(2):
            before = {p: v.detach().clone()
                      for p, v in tree.flatten(state.params)}
            batch = batch_for_step(dcfg, i, device="cpu", mesh=mesh)
            if i == 0:
                rec = CommRecorder()
                with rec:
                    state = step(state, batch)
                scatters[str(prestage)] = sum(
                    op == "_reduce_scatter_base_" for op, _ in rec.records)
            else:
                state = step(state, batch)
            losses[str(prestage)].append(float(state.loss_ema))
            arrays.update({f"prestage{prestage}/upd{i}/{p}":
                           (v.detach() - before[p]).numpy()
                           for p, v in tree.flatten(state.params)})
        arrays.update({f"prestage{prestage}/params/{p}": v.detach().numpy()
                       for p, v in tree.flatten(state.params)})
    info.update({"prestage_losses": losses,
                 "prestage_reduce_scatters": scatters})

    # 5
    opt = api.Muon(tplan, mesh, config=MuonConfig(variant="adamw"),
                   device="cpu")
    state = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh)
    step = make_train_step(cfg, opt, mesh, device="cpu")
    ref = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh)
    loss_fn = make_loss_fn(cfg)
    data = mesh.get_group(0)
    ref_adamw = ref.opt_state.adamw
    for i in range(3):
        batch = batch_for_step(dcfg, i, device="cpu", mesh=mesh)
        state = step(state, batch)
        paths, leaves = zip(*tree.flatten(ref.params))
        grads = torch.autograd.grad(loss_fn(ref.params, batch), leaves)
        reduced = {}
        for p, g in zip(paths, grads):
            out = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, group=data)
            reduced[p] = out.div_(mesh.size(0))
        upd, ref_adamw = adamw_update(reduced, ref_adamw,
                                      dict(zip(paths, leaves)), i,
                                      opt.config)
        with torch.no_grad():
            for p, v in zip(paths, leaves):
                v.add_(upd[p])
    for name, params, adamw, n in [
            ("adamw_step", state.params, state.opt_state.adamw,
             state.opt_state.step),
            ("adamw_clone", ref.params, ref_adamw, 3)]:
        arrays.update({f"{name}/params/{p}": v.detach().numpy()
                       for p, v in tree.flatten(params)})
        arrays.update({f"{name}/mu/{p}": v.numpy()
                       for p, v in adamw.mu.items()})
        arrays.update({f"{name}/nu/{p}": v.numpy()
                       for p, v in adamw.nu.items()})
        info[f"{name}_opt_step"] = n

    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


CKPT_LAYERS, CKPT_STEPS = 4, 4
CKPT_SPEED = (1.0, 1.0, 1.0, 0.25)


def _resilient_loop(mesh, ckpt_dir=None, *, faults=None, steps=CKPT_STEPS,
                    resume=False, **run):
    """The port's resilient loop on the reduced smollm-360m (NorMuon, so a
    variant-state buffer rides beside the momentum)."""
    from repro_torch import configs
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.resilient import ResilientConfig, ResilientLoop
    cfg = configs.get("smollm-360m", reduced=True, n_layers=CKPT_LAYERS)
    return ResilientLoop(
        cfg, DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
        muon=MuonConfig(variant="normuon"),
        run=ResilientConfig(steps=steps, ckpt_every=steps, **run),
        mesh=mesh, ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
        faults=None if faults is None else FaultPlan.parse(faults),
        resume=resume, device="cpu")


def _owner_arrays(loop) -> dict:
    """This rank's owner rows of the momentum and NorMuon's ``v``, and the
    parameters."""
    from repro_torch.core import tree
    st = loop.state.opt_state
    out = {f"mom/{k}": v.numpy() for k, v in st.momentum.items()}
    out.update({f"v/{k}": v.numpy()
                for k, v in st.variant_state["v"].items()})
    out.update({f"params/{p}": v.detach().numpy()
                for p, v in tree.flatten(loop.state.params)})
    return out


def _mesh_info(loop) -> dict:
    from repro_torch.core.owner_comms import OwnerLayout
    return {"owner_index": OwnerLayout(loop.plan, loop.mesh).owner_index(),
            "num_owners": loop.num_owners, "step": loop.state.step}


def checkpoint_rank(args) -> None:
    """1. The resilient loop on the mesh, NorMuon, ``CKPT_STEPS`` steps,
       slow@0 on owner slot 3 (a rebalance, decided alike on every rank),
       a checkpoint at the end written in owner row blocks into
       DIR/ckpt; this rank's owner rows and parameters saved.
    2. An owner-layout state on the 'assignment' physical layout resharded
       on the mesh onto a plan re-solved with slow owner speeds, against
       the one-process reshard of the same rows: bitwise, every group.
    3. A kill on the mesh raises NotImplementedError."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.muon import AdamWState, MuonState
    from repro_torch.core.owner_comms import OwnerLayout, group_key_str
    from repro_torch.data.pipeline import Pipeline, batch_for_step

    mesh = _setup(args)
    loop = _resilient_loop(mesh, Path(args.out) / "ckpt",
                           faults="slow@0:r3x4.0", window=2, cooldown=1)
    report = loop.run()
    arrays = _owner_arrays(loop)
    info = {**_mesh_info(loop), "rebalances": len(report.rebalances),
            "rebalance_steps": [r["step"] for r in report.rebalances],
            "checkpoints": report.checkpoints,
            "losses": report.loss_curve()}

    # 2: reshard on the mesh against one process, non-trivial layouts
    plans = [api.dedicate_params(loop.shapes, mesh=mesh, strategy="greedy",
                                 speed=speed, physical_layout="assignment")
             for speed in (None, np.asarray(CKPT_SPEED))]
    rng = np.random.default_rng(5)
    full = {group_key_str(k): torch.from_numpy(rng.standard_normal(
        (g.packed_size,) + tuple(g.key)).astype(np.float32))
        for k, g in plans[0].groups.items()}

    def state(bufs):
        return MuonState(0, bufs, AdamWState({}, {}), None, None)
    old = OwnerLayout(plans[0], mesh)
    got = api.reshard_owner_state(
        state({k: old.local_block(v) for k, v in full.items()}),
        plans[0], plans[1], mesh)
    want = api.reshard_owner_state(state(full), plans[0], plans[1])
    new = OwnerLayout(plans[1], mesh)
    info["mesh_reshard_bitwise"] = {
        k: bool(torch.equal(got.momentum[k], new.local_block(v)))
        for k, v in want.momentum.items()}
    info["layouts_differ"] = any(
        not np.array_equal(plans[0].groups[k].pack_index,
                           plans[1].groups[k].pack_index)
        for k in plans[0].groups)

    # the prefetching pipeline yields this rank's rows of each batch
    pipe = Pipeline(loop.data_cfg, mesh=mesh, start_step=3, device="cpu")
    try:
        info["pipeline_rows"] = all(
            all(torch.equal(v, want[k]) for k, v in next(pipe).items())
            for want in (batch_for_step(loop.data_cfg, s, device="cpu",
                                        mesh=mesh) for s in (3, 4)))
    finally:
        pipe.close()

    # remesh over the world and over a subset of it
    from repro_torch.runtime.elastic import remesh
    full, flat, sub = (remesh(device_type="cpu"),
                       remesh(prefer_model=1, device_type="cpu"),
                       remesh(ranks=[0, 1], device_type="cpu"))
    info["remesh"] = {
        "full": [list(full.shape), list(full.mesh_dim_names)],
        "flat": list(flat.shape), "sub": list(sub.shape),
        "sub_coordinate": sub.get_coordinate()}

    # 3: kill on a live world
    try:
        _resilient_loop(mesh, faults="kill@1:r1", steps=2).run()
        info["kill_error"] = None
    except NotImplementedError as e:
        info["kill_error"] = str(e)
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def restore_rank(args) -> None:
    """Resume the ``checkpoint`` mode's checkpoint (DIR's parent/ckpt) on
    this mesh: the owner count may differ; save this rank's rows."""
    mesh = _setup(args)
    loop = _resilient_loop(mesh, Path(args.out).parent / "ckpt",
                           resume=True)
    loop.pipe.close()
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **_owner_arrays(loop))
    (Path(args.out) / f"rank{args.rank}.json").write_text(
        json.dumps(_mesh_info(loop)))


def jax_reference(args) -> None:
    """The reference's owner update inside jit on an Auto-axis mesh (jax
    0.9's ``make_mesh`` default is Explicit axes, which its owner layout's
    sharding constraints reject)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as Pspec

    from repro.core import api
    from repro.core.gram_ns import GramNSConfig
    from repro.core.muon import MuonConfig

    mesh = jax.make_mesh(tuple(args.mesh), AXES,
                         axis_types=(AxisType.Auto,) * len(AXES))
    params = jax.tree.map(jnp.asarray, dist_tree())
    grads = jax.tree.map(jnp.asarray, dist_grads())
    specs = {"blocks": {k.split("/")[1]: Pspec(*v) for k, v in SPECS.items()
                        if k.startswith("blocks/")},
             "embed_table": Pspec(*SPECS["embed_table"])}
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, Pspec))
    params_sh, grads_sh = jax.device_put(params, sh), jax.device_put(grads,
                                                                     sh)
    plan = api.dedicate_params(params, mesh=mesh, strategy="greedy")
    opt = api.Muon(plan, mesh=mesh, config=MuonConfig(
        mode="owner", learning_rate=LR, momentum=MOMENTUM,
        ns=GramNSConfig(num_steps=NS_STEPS)))
    state = jax.jit(opt.init)(params_sh)
    upd, state2 = jax.jit(opt.update)(grads_sh, state, params_sh)
    arrays = {}
    for kp, v in jax.tree_util.tree_leaves_with_path(upd):
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        arrays[f"owner/{path}"] = np.asarray(jax.device_get(v))
    for k, v in state2.momentum.items():
        arrays[f"mom/{k}"] = np.asarray(jax.device_get(v))
    np.savez(Path(args.out) / "jax.npz", **arrays)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("owner", "train", "variants", "pipeline",
                                     "checkpoint", "restore", "jax"))
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    # yield the CPU to the test processes running beside these worlds
    # (several tests compare solver results that a time limit bounds)
    os.nice(10)
    if args.mode == "jax":
        jax_reference(args)
        return
    import torch.distributed as dist
    try:
        {"owner": owner_rank, "train": train_rank,
         "variants": variants_rank, "pipeline": pipeline_rank,
         "checkpoint": checkpoint_rank,
         "restore": restore_rank}[args.mode](args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------ owner checks
# Each takes the loaded result of an ``owner`` launch and asserts one
# property; tests/test_torch_mesh_owner*.py run them on two mesh shapes.

def _arrays(z: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in z.items()
            if k.startswith(prefix + "/")}


def check_owner_matches_gather(res):
    """dist_check 1: owner mode on the mesh == one-process gather mode
    (rtol 5e-3 / atol 5e-4, dist_check's tolerance)."""
    z = res["npz"][0]
    want = _arrays(z, "gather_1")
    got = _arrays(z, "owner")
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=5e-3, atol=5e-4,
                                   err_msg=p)


def check_momentum_rows(res):
    """dist_check 2: each momentum buffer holds packed_size / D rows on
    every rank, and they are the rows of that rank's owner slot in the
    one-process stack of the same plan, bit for bit."""
    z0 = res["npz"][0]
    for info, z in zip(res["json"], res["npz"]):
        oi = info["owner_index"]
        for skey, (rows, packed) in info["rows"].items():
            assert rows == packed // info["num_owners"], (skey, rows, packed)
            full = z0[f"nomesh_mom/{skey}"]
            np.testing.assert_array_equal(
                z[f"mom/{skey}"], full[oi * rows:(oi + 1) * rows])


def _ops(records) -> dict:
    out = {}
    for op, nbytes in records:
        count, total = out.get(op, (0, 0))
        out[op] = (count + 1, total + nbytes)
    return out


def check_owner_collectives(res):
    """dist_check 3: the owner step moves gradients with all-to-alls (and
    reduce-scatters), and all-gathers no more bytes than publishing the
    updates takes (each rank's part of every padded update stack)."""
    for info in res["json"]:
        ops = _ops(info["comm"]["owner"])
        assert set(ops) <= {"alltoall_base_", "_reduce_scatter_base_",
                            "_allgather_base_"}, ops
        assert ops["alltoall_base_"][0] >= len(info["matrix_leaves"])
        publish = sum(b * info["packed_over_count"][p]
                      for p, b in info["update_bytes"].items())
        assert ops.get("_allgather_base_", (0, 0))[1] <= publish, \
            (ops, publish)
        counted = info["comm_counts"]["owner"]
        assert counted.get("c10d.alltoall_base_", 0) == \
            ops["alltoall_base_"][0]


def check_gather_all_gathers(res):
    """dist_check 3, the baseline: gather mode (Muon-AG) all-gathers every
    matrix gradient whole and moves nothing to owners."""
    z = res["npz"][0]
    full = sum(v.nbytes for v in _arrays(z, "gather_1").values()
               if v.ndim == 3)
    for info in res["json"]:
        ops = _ops(info["comm"]["gather"])
        assert "alltoall_base_" not in ops, ops
        assert ops["_allgather_base_"][0] >= len(info["matrix_leaves"])
        assert ops["_allgather_base_"][1] >= full, (ops, full)


def check_partial_gradients_reduce_scatter(res):
    """Data-parallel gradients (Partial over 'data') reach their owners by
    one reduce-scatter per group, AdamW reduces its leaves by all-reduce,
    and the update equals the replicated-gradient one bit for bit."""
    z = res["npz"][0]
    for info in res["json"]:
        ops = _ops(info["comm"]["partial"])
        n_groups = len(info["rows"])
        assert ops["_reduce_scatter_base_"][0] == n_groups, ops
        assert ops["allreduce_"][0] == 2, ops   # norm_scale, embed_table
    want, got = _arrays(z, "nomesh"), _arrays(z, "partial")
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def check_second_step(res):
    """dist_check 4: a second step advances the step counter."""
    assert all(info["step_after_two"] == 2 for info in res["json"])


def check_bucket_fusion(res):
    """dist_check 5: bucket fusion of the local owner rows == per group
    (rtol 1e-4 / atol 1e-5)."""
    z = res["npz"][0]
    want, got = _arrays(z, "owner"), _arrays(z, "fused")
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-4, atol=1e-5,
                                   err_msg=p)


def check_owner_bitwise_without_mesh(res):
    """Owner mode on the mesh, from tensor-parallel or replicated gradients,
    == owner mode in one process on the same plan, bit for bit: each
    matrix's Newton-Schulz is the same arithmetic on fewer rows."""
    z = res["npz"][0]
    want = _arrays(z, "nomesh")
    for name in ("owner", "replicated"):
        got = _arrays(z, name)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"{name}: {p}")


def check_gather_mesh_bitwise(res):
    """Gather mode on the mesh == gather mode in one process, bit for bit
    (every rank runs the same full-matrix NS on the gathered gradient)."""
    z = res["npz"][0]
    want, got = _arrays(z, "gather_1"), _arrays(z, "gather_mesh")
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def check_load_balance_owner_order(res):
    """A plan whose pack_index permutes the stack (load_balance, assignment
    layout): the permutation is applied while the stack is local, so each
    rank's owner rows and the update match the one-process plan."""
    z0 = res["npz"][0]
    assert not all(res["json"][0]["lb_pack_identity"].values())
    want, got = _arrays(z0, "lb_nomesh"), _arrays(z0, "lb")
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    for info, z in zip(res["json"], res["npz"]):
        oi = info["owner_index"]
        for skey, loc in _arrays(z, "mom_lb").items():
            rows = loc.shape[0]
            np.testing.assert_array_equal(
                loc, z0[f"lb_nomesh_mom/{skey}"][oi * rows:(oi + 1) * rows])


def check_compress_partial_raises(res):
    """compress_grads would reduce Partial gradients in bf16: it raises,
    naming the ROADMAP entry."""
    assert all("ROADMAP item 6" in info["compress_partial"]
               for info in res["json"])


OWNER_CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_owner_matches_gather, check_momentum_rows, check_owner_collectives,
    check_gather_all_gathers, check_partial_gradients_reduce_scatter,
    check_second_step, check_bucket_fusion, check_owner_bitwise_without_mesh,
    check_gather_mesh_bitwise, check_load_balance_owner_order,
    check_compress_partial_raises)}


if __name__ == "__main__":
    main()
