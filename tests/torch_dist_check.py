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
    python tests/torch_dist_check.py moe --rank R --world W \\
        --port P --mesh 2,2 --out DIR
    python tests/torch_dist_check.py tp --rank R --world W \\
        --port P --mesh 1,4 --out DIR [--configs qwen256,smollm3h]
    python tests/torch_dist_check.py tp_restore --rank R --world W \\
        --port P --mesh 2,1 --out DIR/restore [--ckpt dsv3]
    python tests/torch_dist_check.py tp_families --rank R --world W \\
        --port P --mesh 1,2 --out DIR --configs hymba,hymba3h,xlstm,...
    python tests/torch_dist_check.py optim --rank R --world W \\
        --port P --mesh 2,1 --out DIR
    python tests/torch_dist_check.py owner_pad --rank R --world W \\
        --port P --mesh 2,2 --out DIR
    python tests/torch_dist_check.py serve --rank R --world W \\
        --port P --mesh 1,4 --out DIR [--configs qwen256,dsv3]
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dist_check.py jax_tp --mesh 1,4 --out DIR
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_check.py jax --mesh 2,4 --out DIR
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_check.py jax_moe --mesh 2,4 --out DIR

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
another mesh (the checkpoint of DIR's parent); ``moe`` runs 2 Muon steps
of the reduced Kimi-K2 with its expert leaves sharded on E over "model"
(expert parallelism), replicated, and data-parallel; ``jax`` runs
the reference's own multi-device owner update on an Auto-axis mesh, and
``jax_moe`` its update of ``moe``'s parameters and gradients; ``tp``
runs the tensor-parallel train step of the dense and MoE families
(``TP_CONFIGS``; the MoE experts split over "model") against its
one-process run, and ``models/tp.py``'s Functions, and saves a checkpoint
that ``tp_restore`` resumes on another mesh (``--ckpt NAME``: that config's,
on the ``tp`` world's mesh); ``tp_families`` runs ``tp`` on the
hybrid, xLSTM, encoder-decoder and VLM families (``FAMILY_CONFIGS``), with
their split pieces against float64 in place of the Functions and a
checkpoint of the split hybrid; ``jax_tp`` runs the reference's sharded train
step on the same inputs; ``optim`` runs ``MuonOptimizer`` on a
data-only mesh against the data-parallel train step; ``owner_pad``
moves expert-split stacks that pad or permute over the owners; ``serve``
and ``jax_serve`` serve under a mesh (``torch_serve_check.py``).  Each
writes ``rank<R>.npz`` and ``rank<R>.json`` (``jax.npz``) into DIR; the
tests read them.  Every
process group and every wait has a timeout, so a collective that hangs
fails one test.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
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


# a rank whose store could not bind its port (another process took it
# between ``free_port`` and the bind): the world is started again
PORT_TAKEN = "EADDRINUSE"
LAUNCH_ATTEMPTS = 3


def launch(mode: str, world: int, mesh: tuple, out: Path,
           timeout: float = 240.0, extra: tuple = ()) -> None:
    """Run ``mode`` on ``world`` gloo ranks (one process each, logs in
    ``out``, ``extra`` appended to each command line); raise with the logs
    if one fails or the deadline passes, and leave no process behind.  A
    world whose port was taken before its store bound it is started again
    on another port (up to ``LAUNCH_ATTEMPTS`` times)."""
    out.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + timeout
    for attempt in range(LAUNCH_ATTEMPTS):
        rcs = _launch_once(mode, world, mesh, out, deadline, extra)
        if all(rc == 0 for rc in rcs):
            return
        logs = [(out / f"rank{r}.log").read_text() for r in range(world)]
        if attempt + 1 < LAUNCH_ATTEMPTS and \
                any(PORT_TAKEN in t for t in logs):
            continue
        text = "\n".join(f"--- rank {r} (exit {rc})\n" + t[-4000:]
                         for r, (rc, t) in enumerate(zip(rcs, logs)))
        raise AssertionError(f"{mode} world {mesh} failed:\n{text}")


def _launch_once(mode, world, mesh, out, deadline, extra) -> list:
    """One start of ``launch``'s world; its ranks' exit codes.  The first
    rank to fail ends the others (they would wait on it until their
    process group's timeout)."""
    from repro_torch.launch.mesh import free_port
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, "--rank", str(r), "--world",
             str(world), "--port", str(port), "--mesh",
             ",".join(map(str, mesh)), "--out", str(out), *extra],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or \
                    any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    return [p.returncode for p in procs]


def run_jax(mesh: tuple, out: Path, timeout: float = 240.0,
            mode: str = "jax", extra: tuple = ()) -> None:
    """The reference's owner update (``mode`` "jax" or "jax_moe") or
    sharded train step ("jax_tp") on ``mesh`` host devices, into
    ``out/jax.npz``."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{int(np.prod(mesh))}")
    proc = subprocess.run(
        [sys.executable, __file__, mode, "--mesh", ",".join(map(str, mesh)),
         "--out", str(out), *extra], env=env, capture_output=True,
        text=True, timeout=timeout)
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


def step_specs(cfg, mesh):
    """The parameters' specs where the train step of ``cfg`` on ``mesh``
    is tensor-parallel (``models.tp.tensor_parallel``), else None."""
    from repro_torch.models import model_fns
    from repro_torch.models.sharding import param_specs
    from repro_torch.models.tp import tensor_parallel
    if not tensor_parallel(mesh):
        return None
    return param_specs(cfg, model_fns(cfg).init(cfg, device="meta"), mesh)


def whole_np(t, specs, mesh) -> dict:
    """{path: float32 numpy array} of ``t``'s leaves whole: where
    ``specs`` (``step_specs``) split a leaf, its parts gathered over the
    mesh."""
    import torch

    from repro_torch.core import tree
    from repro_torch.train.step import placed_params
    out = {}
    for p, v in tree.flatten(t):
        v = v.detach()
        if specs is not None:
            v = _full(placed_params({"x": v}, {"x": specs[p]}, mesh)["x"])
        out[p] = v.to(torch.float32).numpy()
    return out


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
    # whole parameters: on (2, 2) the step is tensor-parallel
    arrays = {f"params/{p}": v for p, v in
              whole_np(state.params, step_specs(cfg, mesh), mesh).items()}
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
    loss_fn = make_loss_fn(cfg, mesh)
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
    parameters whole (on a 'model' axis of more than one rank the step is
    tensor-parallel)."""
    st = loop.state.opt_state
    out = {f"mom/{k}": v.numpy() for k, v in st.momentum.items()}
    out.update({f"v/{k}": v.numpy()
                for k, v in st.variant_state["v"].items()})
    out.update({f"params/{p}": v for p, v in
                whole_np(loop.state.params, loop.specs, loop.mesh).items()})
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


MOE_ARCH = "kimi-k2-1t-a32b"
MOE_STEPS = 2
MOE_KINDS = ("ep", "replicated", "partial")


def moe_tree() -> dict:
    """The reduced Kimi-K2's parameters drawn with numpy leaf by leaf in
    path order (the same in both packages; shapes from the port's init)."""
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.models import transformer
    shapes = transformer.init(configs.get(MOE_ARCH, reduced=True),
                              device="meta")
    rng = np.random.default_rng(0)
    return tree.rebuild(shapes, {
        p: (rng.standard_normal(tuple(v.shape)) * 0.02).astype(np.float32)
        for p, v in tree.flatten(shapes)})


def moe_grads(seed: int) -> dict:
    """Gradients for ``moe_tree``, drawn leaf by leaf in path order."""
    from repro_torch.core import tree
    rng = np.random.default_rng(seed)
    t = moe_tree()
    return tree.rebuild(t, {
        p: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        for p, v in tree.flatten(t)})


def moe_rank(args) -> None:
    """2 Muon steps of the reduced Kimi-K2 on the mesh from gradients
    placed by ``param_specs`` (experts sharded on E over "model", the
    attention and shared experts tensor-parallel: "ep"), replicated, and
    ``Partial`` over "data" with the same "model" shards ("partial"); rank
    0 also runs the same plan in one process."""
    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.core.owner_comms import OwnerLayout, stacked_placements
    from repro_torch.models.sharding import param_specs, place, placements

    mesh = _setup(args)
    cfg = configs.get(MOE_ARCH, reduced=True)
    P = tree.tree_map(torch.from_numpy, moe_tree())
    specs = param_specs(cfg, P, mesh)
    Pd = place(P, specs, mesh)
    plan = api.dedicate_params(P, mesh=mesh, strategy="greedy")
    mcfg = MuonConfig(mode="owner", learning_rate=LR, momentum=MOMENTUM,
                      ns=GramNSConfig(num_steps=NS_STEPS))

    def grads(t: int, kind: str):
        G = tree.tree_map(torch.from_numpy, moe_grads(1 + t))
        if kind == "replicated":
            return G
        Gd = place(G, specs, mesh)
        if kind == "ep":
            return Gd
        # every data rank holds the same part, so the average is exact
        return tree.rebuild(G, {
            p: DTensor.from_local(
                g.to_local(), mesh,
                (Partial("avg"),) + tuple(placements(specs[p], mesh))[1:],
                run_check=False, shape=g.shape, stride=g.stride())
            for p, g in tree.flatten(Gd)})

    def run(kind, m, params):
        opt = api.Muon(plan, m, config=mcfg, device="cpu")
        state, out = opt.init(params), {}
        for t in range(MOE_STEPS):
            upd, state = opt.update(grads(t, kind), state, params)
            out.update(_flat_np(f"{kind}/upd{t}", upd))
        return out

    arrays = {}
    for kind in MOE_KINDS:
        arrays.update(run(kind, mesh, P if kind == "replicated" else Pd))
    if args.rank == 0:
        single = run("replicated", None, P)
        arrays.update({k.replace("replicated/", "nomesh/", 1): v
                       for k, v in single.items()})
    layout = OwnerLayout(plan, mesh)
    experts = {p: [str(q) for q in stacked_placements(
        plan.leaves[p], placements(specs[p], mesh))]
        for p in plan.leaves if "experts" in p}
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(
        {"rank": args.rank, "coord": [mesh.get_local_rank(i)
                                      for i in range(mesh.ndim)],
         "owner_index": layout.owner_index(),
         "block_peers": layout._block_peers([1]),
         "expert_stacked": experts}))


def jax_moe_reference(args) -> None:
    """The reference's owner update of ``moe_tree`` / ``moe_grads`` for
    ``MOE_STEPS`` steps inside jit on an Auto-axis mesh, with its
    ``param_specs`` as the parameters' and gradients' shardings and as the
    plan's training specs (its ``_lead_perm`` / ``_stacked_spec`` path)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as Pspec

    from repro import configs
    from repro.core import api
    from repro.core.dedication import _key_str
    from repro.core.gram_ns import GramNSConfig
    from repro.core.muon import MuonConfig
    from repro.models.sharding import param_specs

    mesh = jax.make_mesh(tuple(args.mesh), AXES,
                         axis_types=(AxisType.Auto,) * len(AXES))
    cfg = configs.get(MOE_ARCH, reduced=True)
    params = jax.tree.map(jnp.asarray, moe_tree())
    specs = param_specs(cfg, params, mesh)
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, Pspec))
    params_sh = jax.device_put(params, sh)
    plan = api.dedicate_params(params, mesh=mesh, strategy="greedy")
    plan.train_specs = {
        "/".join(_key_str(k) for k in kp): spec
        for kp, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, Pspec))}
    opt = api.Muon(plan, mesh=mesh, config=MuonConfig(
        mode="owner", learning_rate=LR, momentum=MOMENTUM,
        ns=GramNSConfig(num_steps=NS_STEPS)))
    state = jax.jit(opt.init)(params_sh)
    update = jax.jit(opt.update)
    arrays = {}
    for t in range(MOE_STEPS):
        grads = jax.device_put(jax.tree.map(jnp.asarray, moe_grads(1 + t)),
                               sh)
        upd, state = update(grads, state, params_sh)
        for kp, v in jax.tree_util.tree_leaves_with_path(upd):
            path = "/".join(str(getattr(k, "key", k)) for k in kp)
            arrays[f"upd{t}/{path}"] = np.asarray(jax.device_get(v))
    np.savez(Path(args.out) / "jax.npz", **arrays)


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


# ------------------------------------------------------ tensor parallelism

# the configs of the tensor-parallel step: head-parallel with the vocab
# split (its 2 KV heads gathered at model 4), sequence-sharded (3 heads),
# and head-parallel without a vocab split; ``guarded`` (model 4 only)
# leaves every leaf whole where param_specs' guard keeps it: q / k / v / o
# (18 and 6 columns), the MLP (30) and the vocab (257)
TP_CONFIGS = {
    "qwen256": ("qwen2.5-14b", dict(vocab=256)),
    "smollm3h": ("smollm-360m", dict(d_model=48, n_heads=3, n_kv_heads=1,
                                     head_dim=16)),
    "qwen257": ("qwen2.5-14b", {}),
    "guarded": ("smollm-360m", dict(d_model=20, n_heads=3, n_kv_heads=1,
                                    head_dim=6, d_ff=30)),
    # the MoE family, expert-parallel: reduced DeepSeek-V3 (MLA, 4 heads,
    # 4 experts, top-2, 1 shared) and Kimi-K2 (GQA 4 / 2); ``dsv3g`` with
    # 3 heads and 6 experts (model 4: q_b / kv_b / o split mid-head, so
    # the sequence-sharded MLA, and the experts whole); ``dsv3drop`` at
    # capacity factor 0.5, where the dispatch drops assignments
    "dsv3": ("deepseek-v3-671b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "dsv3g": ("deepseek-v3-671b", dict(n_heads=3, n_kv_heads=3,
                                       mla=dict(n_heads=3),
                                       moe=dict(n_experts=6))),
    "dsv3drop": ("deepseek-v3-671b", dict(moe=dict(capacity_factor=0.5))),
    # ``dsv3drop`` in two microbatches (``TP_ACCUM``), each dispatched
    # over the data ranks' rows of the global batch's block; ``dsv3e16``
    # with 16 experts, so several a rank in the owner layouts at model 4
    "dsv3acc": ("deepseek-v3-671b", dict(moe=dict(capacity_factor=0.5))),
    "dsv3e16": ("deepseek-v3-671b", dict(moe=dict(n_experts=16))),
    # 3 layers of 2 experts: at (2, 2) each expert leaf's 6 matrices over
    # 4 owners, so the owner layout pads the E-split stack (``_route``)
    "dsv3e2": ("deepseek-v3-671b", dict(n_layers=3, moe=dict(n_experts=2))),
    # ZeRO-3 (``zero3``): reduced nemotron-4-340b (4 / 2 heads of 24,
    # squared-ReLU MLP of 384) with vocab 256, so the head splits; with
    # remat, so the backward gathers each layer again; and in two
    # microbatches accumulated in bf16 (``TP_ACCUM_DTYPE``), the
    # reference's >= 340 B policy; and in two microbatches on the
    # bucketed schedule (``TP_PIPELINE``), whose prestaging stages each
    # microbatch's gradients, split over 'data', to the owners
    "nemo": ("nemotron-4-340b", dict(vocab=256)),
    "nemoremat": ("nemotron-4-340b", dict(vocab=256, remat=True)),
    "nemoacc": ("nemotron-4-340b", dict(vocab=256)),
    "nemostage": ("nemotron-4-340b", dict(vocab=256)),
    # the hybrid, xLSTM, encoder-decoder and VLM families
    # (``tp_families``): reduced hymba (4 / 2 heads: head-parallel at
    # model 2, KV-gathered at 4; the SSM's channels split), its 3-head
    # variant (sequence-sharded, with the window and the global layers),
    # xlstm (4 heads: head-parallel mLSTM, the sLSTM's gathers), seamless
    # and llava with vocab 256 (split over 'model')
    "hymba": ("hymba-1.5b", {}),
    "hymba3h": ("hymba-1.5b", dict(d_model=48, n_heads=3, n_kv_heads=1,
                                   head_dim=16, ssm=dict(d_model=48))),
    "xlstm": ("xlstm-350m", {}),
    "seamless": ("seamless-m4t-large-v2", dict(vocab=256)),
    "llava": ("llava-next-mistral-7b", dict(vocab=256)),
}
FAMILY_CONFIGS = ("hymba", "hymba3h", "xlstm", "seamless", "llava")
FAMILY_CKPT = "hymba"
# microbatches a step of the configs named (1 for the others)
TP_ACCUM = {"dsv3acc": 2, "nemoacc": 2, "nemostage": 2}
# the dtype their gradients are accumulated in (float32 for the others)
TP_ACCUM_DTYPE = {"nemoacc": "bfloat16"}
# the optimizer's schedule of the configs named (the config's for the
# others: fused)
TP_PIPELINE = {"nemostage": "bucketed"}
TP_STEPS, TP_BATCH, TP_SEQ = 3, 4, 16
TP_LR, TP_MOMENTUM = 0.02, 0.95
TP_CKPT = "qwen256"


def tp_config(name: str, jax: bool = False):
    """``name``'s reduced config in the port or (``jax``) the reference; a
    dict override replaces fields of the nested MLA / MoE config."""
    import dataclasses
    arch, kw = TP_CONFIGS[name]
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    base = configs.get(arch, reduced=True)
    kw = {k: dataclasses.replace(getattr(base, k), **v)
          if isinstance(v, dict) else v for k, v in kw.items()}
    return configs.get(arch, reduced=True, **kw)


def tp_params(name: str) -> dict:
    """``name``'s parameters drawn with numpy, leaf by leaf in path order
    (the same in both packages): weights N(0, 1/fan_in), embeddings
    N(0, 0.02²), biases N(0, 0.02²), norm scales, the hybrid's mix scales
    and the SSM's skip 1 + N(0, 0.1²), the SSM's ``a_log`` log(1..d_state)
    + N(0, 0.1²) (its init's, perturbed)."""
    from repro_torch.core import tree
    from repro_torch.models import model_fns
    rng = np.random.default_rng(0)
    flat = {}
    cfg = tp_config(name)
    for p, v in tree.flatten(model_fns(cfg).init(cfg, device="meta")):
        shape, leaf = tuple(v.shape), p.rsplit("/", 1)[-1]
        x = rng.standard_normal(shape)
        if leaf == "w":
            x = x / np.sqrt(shape[-2])
        elif leaf in ("norm_scale", "mix_scale", "d_skip"):
            x = 1.0 + 0.1 * x
        elif leaf == "a_log":
            x = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * x
        else:
            x = 0.02 * x
        flat[p] = x.astype(np.float32)
    return _nest(flat)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for p, v in flat.items():
        *parents, last = p.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def tp_batch(name: str, step: int) -> dict:
    """Global batch ``step``: tokens and next-token labels, and for a
    frontend config its patches or frames (TP_BATCH, frontend_len,
    frontend_dim), standard normal."""
    cfg = tp_config(name)
    rng = np.random.default_rng(100 + step)
    seq = rng.integers(0, cfg.vocab, (TP_BATCH, TP_SEQ + 1))
    out = {"tokens": seq[:, :-1].astype(np.int32),
           "labels": seq[:, 1:].astype(np.int32)}
    if cfg.frontend is not None:
        key = "patches" if cfg.frontend == "patch" else "frames"
        out[key] = rng.standard_normal(
            (TP_BATCH, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def tp_muon_config():
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    return MuonConfig(mode="owner", learning_rate=TP_LR,
                      momentum=TP_MOMENTUM,
                      ns=GramNSConfig(num_steps=NS_STEPS))


def tp_train(name: str, mesh, params_np: dict, steps: int = TP_STEPS,
             zero3: bool = False):
    """The port's train step of ``name`` from the numpy parameters
    ``params_np``: tensor-parallel over ``mesh`` (its 'model' axis, even of
    one rank; with ``zero3`` the block weights also split over 'data',
    ``param_specs(..., zero3=True)``), or in one process without a mesh.
    Returns whole tensors: {quantity: {path: tensor}} for
    ``chip_smoke.tp_gate``, plus the per-step ``loss_ema``, the gradients'
    placements and whether each AdamW moment is shaped as its parameter's
    part; also the last state and its parts' shapes."""
    import torch

    from repro_torch.core import api, tree
    from repro_torch.models import model_fns
    from repro_torch.models.sharding import (local_batch, local_part,
                                             param_specs)
    from repro_torch.train.step import make_train_step, placed_params
    from repro_torch.train.train_state import TrainState

    cfg = tp_config(name)
    shapes = model_fns(cfg).init(cfg, device="meta")
    plan = api.dedicate_params(shapes, mesh=mesh, strategy="greedy")
    opt = api.Muon(plan, mesh, config=tp_muon_config(), device="cpu")
    full = tree.tree_map(torch.from_numpy, params_np)
    specs = None if mesh is None else param_specs(cfg, shapes, mesh,
                                                  zero3=zero3)
    params = tree.tree_map(lambda v: v.clone().requires_grad_(True), full) \
        if mesh is None else tree.rebuild(full, {
            p: local_part(v, specs[p], mesh).clone().requires_grad_(True)
            for p, v in tree.flatten(full)})
    state = TrainState(0, params, opt.init(
        params if mesh is None else placed_params(params, specs, mesh)),
        torch.zeros(()))
    step = make_train_step(
        cfg, opt, mesh, device="cpu", grad_specs=specs,
        accum_steps=TP_ACCUM.get(name, 1), pipeline=TP_PIPELINE.get(name),
        accum_dtype=getattr(torch, TP_ACCUM_DTYPE.get(name, "float32")))
    first = {}
    update = opt.update

    def captured(grads, *a, **kw):
        out = update(grads, *a, **kw)
        if not first:
            first["grads"] = {p: _full(g) for p, g in tree.flatten(grads)}
            first["placements"] = {
                p: [str(q) for q in g.placements] if hasattr(
                    g, "placements") else None
                for p, g in tree.flatten(grads)}
            first["updates"] = {p: _full(u) for p, u in tree.flatten(out[0])}
        return out
    opt.update = captured
    ema = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in
                 tp_batch(name, i).items()}
        if mesh is not None:
            batch = {k: local_batch(v, mesh) for k, v in batch.items()}
        state = step(state, batch)
        ema.append(float(state.loss_ema))
    del opt.update

    def whole(p, v):
        return v.detach() if mesh is None else _full(
            placed_params({"x": v}, {"x": specs[p]}, mesh)["x"])
    adamw_local = {p: list(v.shape) for p, v in
                   state.opt_state.adamw.mu.items()}
    local = {p: list(v.shape) for p, v in tree.flatten(state.params)}
    # the prestaged schedule hands the optimizer owner rows, not
    # gradients: nothing of them is captured
    first = first or {"grads": {}, "placements": {}, "updates": {}}
    return {"loss": {"": torch.tensor(ema[0])},
            "grads": first["grads"], "updates": first["updates"],
            "params": {p: whole(p, v) for p, v in
                       tree.flatten(state.params)},
            "loss_ema": {"": torch.tensor(ema[-1])},
            "ema": ema, "placements": first["placements"],
            "adamw_local_shapes": adamw_local == {
                p: local[p] for p in adamw_local},
            "specs": None if specs is None else
            {p: list(s) for p, s in specs.items()},
            "opt_state": state.opt_state, "plan": plan, "state": state,
            "local_shapes": local}


def ulp_params(params_np: dict, rng=None) -> dict:
    """``params_np`` with a random half of every leaf's entries one ulp
    up."""
    rng = rng or np.random.default_rng(11)

    def up(x):
        if isinstance(x, dict):
            return ulp_params(x, rng)
        half = rng.random(x.shape) < 0.5
        return np.where(half, np.nextafter(x, np.float32(np.inf)), x)
    return {k: up(v) for k, v in params_np.items()}


def _tp_functions(mesh) -> dict:
    """Each Function of ``models/tp.py`` on this rank of a model axis of
    two, float64, against the unsplit computation: max|Δ| of the forward
    and of the gradient."""
    import torch

    from repro_torch.models import tp as T
    mp = T.model_parallel(mesh)
    n, r = mp.size, mp.rank
    rng = np.random.default_rng(7)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    X = draw(2, 8, 6)                      # (B, S, F), the same everywhere
    R = [draw(2, 8, 6) for _ in range(n)]  # each rank's loss weights

    def chunk(t, dim, i):
        return t.chunk(n, dim=dim)[i]

    def run(fn, x, weight):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * weight).sum().backward()
        return y.detach(), x.grad

    def err(a, b):
        return float((a - b).abs().max())
    out = {}
    # copy: replicated X used by each rank's own loss; dL/dX = sum_r R_r
    y, g = run(lambda x: T.copy_to_model(x, mp), X, R[r])
    out["copy_to_model"] = [err(y, X), err(g, sum(R))]
    # reduce: rank parts X_r summed; one replicated loss R_0
    parts = [draw(2, 8, 6) for _ in range(n)]
    y, g = run(lambda x: T.reduce_from_model(x, mp), parts[r], R[0])
    out["reduce_from_model"] = [err(y, sum(parts)), err(g, R[0])]
    for dim in (1, -1):
        y, g = run(lambda x: T.gather_from_model(x, mp, dim),
                   chunk(X, dim, r), R[0])
        out[f"gather_from_model_{dim}"] = [err(y, X),
                                           err(g, chunk(R[0], dim, r))]
        y, g = run(lambda x: T.gather_from_model(x, mp, dim,
                                                 reduce_grad=True),
                   chunk(X, dim, r), R[r])
        out[f"gather_from_model_reduce_grad_{dim}"] = [
            err(y, X), err(g, chunk(sum(R), dim, r))]
        y, g = run(lambda x: T.split_to_model(x, mp, dim), X,
                   chunk(R[r], dim, r))
        out[f"split_to_model_{dim}"] = [
            err(y, chunk(X, dim, r)),
            err(g, torch.cat([chunk(R[i], dim, i) for i in range(n)], dim))]
    # the all-to-alls: one loss sum(X * R_0) split either way
    y, g = run(lambda x: T.seq_to_features(x, mp), chunk(X, 1, r),
               chunk(R[0], 2, r))
    out["seq_to_features"] = [err(y, chunk(X, 2, r)),
                              err(g, chunk(R[0], 1, r))]
    y, g = run(lambda x: T.features_to_seq(x, mp), chunk(X, 2, r),
               chunk(R[0], 1, r))
    out["features_to_seq"] = [err(y, chunk(X, 1, r)),
                              err(g, chunk(R[0], 2, r))]
    return out


def _tp_ckpt_loop(mesh, ckpt_dir, *, resume: bool = False,
                  name: str = TP_CKPT):
    """The resilient loop on ``name`` (``TP_CKPT``: Muon with AdamW leaves
    split, biases and the embedding), 2 steps, a checkpoint at the end."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.resilient import ResilientConfig, ResilientLoop
    cfg = tp_config(name)
    return ResilientLoop(
        cfg, DataConfig(vocab=cfg.vocab, seq_len=TP_SEQ,
                        global_batch=TP_BATCH),
        muon=tp_muon_config(), run=ResilientConfig(steps=2, ckpt_every=2),
        mesh=mesh, ckpt_dir=str(ckpt_dir), resume=resume, device="cpu")


def _tp_ckpt_arrays(loop) -> dict:
    """The loop's parameters and AdamW moments, whole."""
    st = loop.state
    out = {"step": np.asarray(st.step),
           "loss_ema": np.asarray(float(st.loss_ema))}
    for prefix, t in (("params", st.params), ("mu", st.opt_state.adamw.mu),
                      ("nu", st.opt_state.adamw.nu)):
        out.update({f"{prefix}/{p}": v for p, v in
                    whole_np(t, loop.specs, loop.mesh).items()})
    return out


def tp_rank(args, functions=None, ckpt: str = TP_CKPT) -> None:
    """The tensor-parallel step on a ("data", "model") mesh.

    1. On a model axis of two (mesh (1, 2)): each Function of
       ``models/tp.py`` against the unsplit float64 computation
       (``functions``: another such check, ``_tp_functions`` by default).
    2. Each of ``args.configs`` trained ``TP_STEPS`` steps from
       ``tp_params`` on ``tp_batch``: loss_ema per step, step 1's
       gradients (and their placements) and updates, the last parameters;
       whether the AdamW moments are shaped as the parameters' parts and
       ``init_state``'s parts are the slices of the one-process ``init``.
       Rank 0 also runs each in one process, and from the parameters one
       ulp up, and holds the mesh run to them (``chip_smoke.tp_gate``).
    3. At (1, 2): the resilient loop on ``ckpt`` (``TP_CKPT`` by default)
       with a checkpoint into DIR/ckpt, its whole parameters and AdamW
       moments saved.
    ``--train-only``: 2 alone, without the one-process runs and the
    ``init_state`` check.  ``--ckpt NAME``: 3 on this mesh with that
    config, and not 1."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import api, tree
    from repro_torch.models import model_fns
    from repro_torch.models.sharding import local_part, param_specs
    from repro_torch.train.step import init_state

    mesh = _setup(args)
    info, arrays = {"rank": args.rank, "configs": {}}, {}
    extras = not args.train_only
    if extras and tuple(args.mesh) == (1, 2) and not args.ckpt:
        info["functions"] = (functions or _tp_functions)(mesh)
    for name in args.configs.split(","):
        cfg = tp_config(name)
        params_np = tp_params(name)
        got = tp_train(name, mesh, params_np)
        row = {"ema": got["ema"], "placements": got["placements"],
               "specs": got["specs"],
               "adamw_local_shapes": got["adamw_local_shapes"]}
        if args.rank == 0:
            arrays.update({f"{name}/params/{p}": v.numpy()
                           for p, v in got["params"].items()})
        info["configs"][name] = row
        if mesh is not None:
            row.update(padded_owner_checks(cfg, got["plan"],
                                           got["opt_state"], mesh))
        if not extras:
            continue
        # init_state's parts against the one-process init's slices
        shapes = model_fns(cfg).init(cfg, device="meta")
        opt = api.Muon(api.dedicate_params(shapes, mesh=mesh), mesh,
                       config=tp_muon_config(), device="cpu")
        st = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh)
        specs = param_specs(cfg, shapes, mesh)
        whole = dict(tree.flatten(model_fns(cfg).init(cfg, 0, "cpu")))
        row["init_parts_bitwise"] = all(
            torch.equal(v.detach(), local_part(whole[p], specs[p], mesh))
            for p, v in tree.flatten(st.params))
        row["local_numel"] = sum(v.numel() for _, v in
                                 tree.flatten(st.params))
        if args.rank == 0:
            ref = tp_train(name, None, params_np)
            spread = tp_train(name, None, ulp_params(params_np))
            keep = chip_smoke.TP_QUANTITIES
            gate = chip_smoke.tp_gate(torch, {k: got[k] for k in keep},
                                      {k: ref[k] for k in keep},
                                      {k: spread[k] for k in keep},
                                      set(opt.plan.leaves))
            row.update({"gate": gate, "single_ema": ref["ema"],
                        "single_placements": ref["placements"]})
    if args.ckpt or (extras and tuple(args.mesh) == (1, 2)):
        loop = _tp_ckpt_loop(mesh, Path(args.out) / "ckpt",
                             name=args.ckpt or ckpt)
        loop.run()
        loop.mgr.wait()
        arrays.update({f"ckpt/{k}": v
                       for k, v in _tp_ckpt_arrays(loop).items()})
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def tp_families_rank(args) -> None:
    """``tp_rank`` on the hybrid, xLSTM, encoder-decoder and VLM families
    (``FAMILY_CONFIGS``): at (1, 2) the new split pieces against their
    unsplit float64 computation (``_tp_pieces``) and a checkpoint of the
    split hybrid (``FAMILY_CKPT``)."""
    tp_rank(args, _tp_pieces, FAMILY_CKPT)


# the split pieces against the unsplit float64 computation: the mixers'
# fp32 internals (gates, scans, exponents) set the rounding, so the gate is
# relative to the largest entry
PIECES_TOL = 1e-5


def tp_pieces_rank(args) -> None:
    """``_tp_pieces`` alone on this mesh's model axis (any extent: the
    families world runs them at two ranks)."""
    mesh = _setup(args)
    info = {"rank": args.rank, "functions": _tp_pieces(mesh)}
    np.savez(Path(args.out) / f"rank{args.rank}.npz")
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def _tp_pieces(mesh) -> dict:
    """The families' split pieces on this rank of a model axis of two or
    more (shapes that split over 2, 3 and 4 ranks), float64 parameters
    and inputs, against the whole computation on the
    same values, forward and backward (every leaf's gradient as this
    rank's part of the whole one, the inputs' whole): [forward, gradient]
    max|Δ| over max|want| each.

    * ``halves_to_channels`` alone (the SSM's regrouping);
    * the SSM mixer split by ``param_specs`` (regrouping, channel-local
      scan, ``x_proj`` read in part and its gradient summed);
    * the mLSTM head-parallel (4 heads) and with whole heads gathered
      (3 heads), ``if_gate_bias`` gathered whole;
    * the sLSTM, ``wx`` and ``r_proj`` gathered;
    * cross attention head-parallel (4 heads) and sequence-sharded (3).

    Where a case's heads or channels do not divide the axis it takes its
    gathered or whole path.  And two planted faults, each of which must
    show (``faults``): the SSM with ``x_proj``'s gradient left unreduced
    over 'model' (its error on x_proj's gradient), and where the 4 heads
    divide the axis the mLSTM reading this rank's part of
    ``if_gate_bias`` as the gates of its own heads (the forward's
    error)."""
    import torch

    from repro_torch.core import tree
    from repro_torch.models import layers, ssm as S, tp as T, xlstm as X
    from repro_torch.models.sharding import local_part, param_specs
    mp = T.model_parallel(mesh)
    n, r = mp.size, mp.rank
    rng = np.random.default_rng(7)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    def rel(a, b):
        scale = float(b.abs().max())
        return float((a - b).abs().max()) / (scale or 1.0)
    out, faults = {}, {}
    # 1. the regrouping alone: one loss on every rank's own weights
    B, Sq, F_ = 2, 12, 12
    Xw = draw(B, Sq, 2 * F_)
    R = [draw(2, B, Sq, F_ // n) for _ in range(n)]
    x = Xw.chunk(n, -1)[r].clone().requires_grad_(True)
    y = T.halves_to_channels(x, mp)
    (y * R[r]).sum().backward()
    want = torch.stack([Xw[..., :F_].chunk(n, -1)[r],
                        Xw[..., F_:].chunk(n, -1)[r]])
    G = torch.cat([torch.cat([R[i][h] for i in range(n)], -1)
                   for h in (0, 1)], -1)
    out["halves_to_channels"] = [rel(y, want), rel(x.grad, G.chunk(n, -1)[r])]

    def case(params, split_fn, whole_fn, inputs, leaf=None):
        """[forward, gradient] errors of ``split_fn`` on this rank's parts
        against ``whole_fn``, one replicated loss sum(y · W), each
        gradient's max|Δ| over the largest entry of every gradient of the
        piece (a gate bias's gradient is a sum over positions that the
        stabiliser nearly cancels: its own scale is rounding's); with
        ``leaf``, that leaf's gradient error alone as a third entry."""
        params = tree.tree_map(lambda v: v.double() + 0.1 * draw(*v.shape),
                               params)
        specs = param_specs(None, params, mesh)
        whole = tree.tree_map(lambda v: v.clone().requires_grad_(True),
                              params)
        parts = tree.rebuild(params, {
            p: local_part(v, specs[p], mesh).clone().requires_grad_(True)
            for p, v in tree.flatten(params)})
        xs_w = [v.clone().requires_grad_(True) for v in inputs]
        xs_p = [v.clone().requires_grad_(True) for v in inputs]
        yw, yp = whole_fn(whole, *xs_w), split_fn(parts, *xs_p)
        W = draw(*yw.shape)
        (yw * W).sum().backward()
        (yp * W).sum().backward()
        grads = {p: (v.grad, local_part(dict(tree.flatten(whole))[p].grad,
                                        specs[p], mesh))
                 for p, v in tree.flatten(parts)}
        grads.update({f"input{i}": (a.grad, b.grad)
                      for i, (a, b) in enumerate(zip(xs_p, xs_w))})
        scale = max(float(b.abs().max()) for _, b in grads.values())
        errs = {k: float((a - b).abs().max()) / scale
                for k, (a, b) in grads.items()}
        row = [rel(yp, yw), max(errs.values())]
        return row + [errs[leaf]] if leaf else row

    gen = torch.Generator().manual_seed(0)
    scfg = S.SSMConfig(d_model=24, d_state=4)
    sp = S.ssm_init(gen, scfg)
    xin = [draw(B, Sq, 24)]
    out["ssm"] = case(sp, lambda p, x: S.ssm(p, scfg, x, tp=mp),
                      lambda p, x: S.ssm(p, scfg, x), xin)
    for tag, heads, d in (("mlstm", 4, 16), ("mlstm_gathered", 3, 24)):
        xcfg = X.XLSTMConfig(d_model=d, n_heads=heads)
        out[tag] = case(X.mlstm_init(gen, xcfg),
                        lambda p, x: X.mlstm(p, xcfg, x, tp=mp),
                        lambda p, x: X.mlstm(p, xcfg, x), [draw(B, Sq, d)])
    xcfg = X.XLSTMConfig(d_model=16, n_heads=4)
    out["slstm"] = case(X.slstm_init(gen, xcfg),
                        lambda p, x: X.slstm(p, xcfg, x, tp=mp),
                        lambda p, x: X.slstm(p, xcfg, x), [draw(B, Sq, 16)])
    for tag, heads in (("cross_attention", 4), ("cross_attention_seq", 3)):
        acfg = layers.AttnConfig(16, heads, heads, 4, causal=False)
        out[tag] = case(
            layers.attention_init(gen, acfg),
            lambda p, x, k: layers.attention(p, acfg, x, xk=k, tp=mp),
            lambda p, x, k: layers.attention(p, acfg, x, xk=k),
            [draw(B, Sq, 16), draw(B, 6, 16)])
    out["faults"] = faults
    rows_of_whole = S._rows_of_whole
    S._rows_of_whole = lambda w, tp, rows: w[tp.rank * rows:
                                            (tp.rank + 1) * rows]
    try:
        faults["ssm_x_proj_unreduced"] = case(
            sp, lambda p, x: S.ssm(p, scfg, x, tp=mp),
            lambda p, x: S.ssm(p, scfg, x), xin, leaf="x_proj/w")[2]
    finally:
        S._rows_of_whole = rows_of_whole
    if 4 % n:
        return out

    def heads_bias(b, H, tp):
        # the fault: this rank's part read as [i ; f] of its own heads
        h = H // tp.size
        i, f = b.chunk(2)
        whole = torch.zeros(2 * H, dtype=b.dtype)
        whole[tp.rank * h:(tp.rank + 1) * h] = i
        whole[H + tp.rank * h:H + (tp.rank + 1) * h] = f
        return whole
    whole_gate_bias = X._whole_gate_bias
    X._whole_gate_bias = heads_bias
    try:
        faults["mlstm_bias_as_heads_part"] = case(
            X.mlstm_init(gen, xcfg), lambda p, x: X.mlstm(p, xcfg, x, tp=mp),
            lambda p, x: X.mlstm(p, xcfg, x), [draw(B, Sq, 16)])[0]
    finally:
        X._whole_gate_bias = whole_gate_bias
    return out


def _branch_recorder(rec: list):
    """Wrap the mLSTM's and sLSTM's cores to append, per call, each
    branch decision of their forward to ``rec``: the normaliser's clamp
    |den| > 1 (with |den| itself) and cummax's argmax (the mLSTM, heads
    last but den's (B, H, S)); max(lf + m, i) and n > 1 per step (the
    sLSTM).  Wraps ``Muon.update`` to append ("step", {path: whole
    gradient}) after each step.  Returns the undo."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import api, tree
    from repro_torch.models import layers, xlstm as X
    core, loop, update = X.mlstm_core, X._slstm_loop, api.Muon.update

    def mlstm_core(q, k, v, ig, fg, state=None):
        with torch.no_grad():
            shifted = ig.double() - torch.cumsum(fg.double(), dim=1)
            run = torch.cummax(shifted, dim=1)
            S = q.shape[1]
            logd = (shifted.transpose(1, 2)[:, :, None, :]
                    - run.values.transpose(1, 2)[:, :, :, None])
            causal = torch.ones(S, S, dtype=torch.bool).tril()
            d = torch.exp(torch.where(causal, logd, float("-inf")).float())
            den = (torch.matmul(q.float().transpose(1, 2),
                                k.float().transpose(1, 2).mT) * d).sum(-1)
            rec.append(("mlstm", {"den": den.abs().numpy(),
                                  "argmax": run.indices.numpy()}))
        return core(q, k, v, ig, fg, state)

    def slstm_loop(wx, r_proj, dtype, state=None):
        with torch.no_grad():
            B, S, d4 = wx.shape
            c, n, h = (torch.zeros(B, d4 // 4) for _ in range(3))
            m = torch.full((B, d4 // 4), -1e30)
            keep, clamp = [], []
            for t in range(S):
                zi, ii, fi, oi = (wx[:, t].float() + layers.linear(
                    r_proj, h.to(dtype)).float()).chunk(4, dim=-1)
                lf = F.logsigmoid(fi)
                keep.append((lf + m >= ii).numpy())
                mn = torch.maximum(lf + m, ii)
                c = torch.exp(lf + m - mn) * c + \
                    torch.exp(ii - mn) * torch.tanh(zi)
                n = torch.exp(lf + m - mn) * n + torch.exp(ii - mn)
                clamp.append((n > 1).numpy())
                h, m = torch.sigmoid(oi) * c / torch.clamp(n, min=1.0), mn
            rec.append(("slstm", {"keep_m": np.stack(keep),
                                  "n_gt1": np.stack(clamp)}))
        return loop(wx, r_proj, dtype, state)

    def counted(self, grads, *a, **kw):
        rec.append(("step", {p: _full(g).numpy().copy()
                             for p, g in tree.flatten(grads)}))
        return update(self, grads, *a, **kw)
    X.mlstm_core, X._slstm_loop, api.Muon.update = (mlstm_core, slstm_loop,
                                                   counted)

    def undo():
        X.mlstm_core, X._slstm_loop, api.Muon.update = core, loop, update
    return undo


def _branch_flips(split: list, one: list) -> list:
    """The calls of ``split`` (its mLSTM records' heads whole) whose
    branch decisions differ from ``one``'s: [{step, mixer, branch,
    entries, margin}], the margin the smallest ||den| − 1| of one
    process's call (the mLSTM)."""
    flips, step = [], 1
    for (kind, a), (_, b) in zip(split, one):
        if kind == "step":
            step += 1
            continue
        pairs = ({"den_clamp": (a["den"] > 1, b["den"] > 1),
                  "cummax_argmax": (a["argmax"], b["argmax"])}
                 if kind == "mlstm" else
                 {"max_keeps_m": (a["keep_m"], b["keep_m"]),
                  "n_clamp": (a["n_gt1"], b["n_gt1"])})
        for branch, (x, y) in pairs.items():
            entries = int((x != y).sum())
            if entries:
                flips.append({
                    "step": step, "mixer": kind, "branch": branch,
                    "entries": entries,
                    "margin": float(np.abs(b["den"] - 1).min())
                    if kind == "mlstm" else None})
    return flips


def _widest_parting(split: dict, one: dict, steps: list) -> dict:
    """Per leaf, the entry whose last parameter parts most between the
    two runs' ``split`` and ``one`` ({path: array}): its index, distance,
    and each step's gradient there in both runs beside that step's
    largest gradient of the leaf in one process (``steps``: [(split's,
    one's) {path: gradient}])."""
    out = {}
    for leaf in one:
        diff = np.abs(split[leaf] - one[leaf])
        at = np.unravel_index(int(diff.argmax()), diff.shape)
        out[leaf] = {
            "index": [int(i) for i in at], "distance": float(diff[at]),
            "grads_split": [float(a[leaf][at]) for a, _ in steps],
            "grads_one": [float(b[leaf][at]) for _, b in steps],
            "grad_scale": [float(np.abs(b[leaf]).max()) for _, b in steps]}
    return out


def tp_branches_rank(args) -> None:
    """Where ``args.configs``' split step parts from one process: each
    trained ``TP_STEPS`` steps on this mesh and, on rank 0, in one
    process, every branch decision of the mixers and every step's
    gradients recorded (``_branch_recorder``; the mLSTM's heads gathered
    over the model ranks, which needs one data rank); rank 0 writes per
    config the branch flips (``_branch_flips``) and each leaf's entry
    that parts most (``_widest_parting``)."""
    import torch.distributed as dist
    mesh = _setup(args)
    info = {"rank": args.rank, "configs": {}}
    for name in args.configs.split(","):
        rec: list = []
        undo = _branch_recorder(rec)
        try:
            got = tp_train(name, mesh, tp_params(name))
            parts = [None] * args.world
            dist.all_gather_object(parts, rec)
            if args.rank != 0:
                continue
            if any(k == "mlstm" for k, _ in rec) and args.mesh[0] != 1:
                raise ValueError("the recorded heads need one data rank")
            split = [(k, a if k != "mlstm" else {
                "den": np.concatenate([p[i][1]["den"] for p in parts], 1),
                "argmax": np.concatenate([p[i][1]["argmax"] for p in parts],
                                         -1)})
                for i, (k, a) in enumerate(rec)]
            rec.clear()
            one = tp_train(name, None, tp_params(name))
            steps = list(zip(*([a for k, a in r if k == "step"]
                               for r in (split, rec))))
            info["configs"][name] = {
                "flips": _branch_flips(split, rec),
                "widest": _widest_parting(
                    *({p: v.numpy() for p, v in r["params"].items()}
                      for r in (got, one)), steps)}
        finally:
            undo()
    np.savez(Path(args.out) / f"rank{args.rank}.npz")
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def padded_owner_checks(cfg, plan, state, mesh) -> dict:
    """The owner layout's padded E-split groups after training: which
    groups pad (``padded``); whether every momentum row at a pad position
    of this rank's owner block is zero (``pad_rows_zero``); and whether
    ``reshard_owner_state`` to the plan's permuted layout
    (``physical_layout="assignment"``) and back is bitwise the state
    (``reshard_roundtrip``), the permuted state's logical rows bitwise
    the state's."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.owner_comms import OwnerLayout, group_key_str
    from repro_torch.models import model_fns
    layout = OwnerLayout(plan, mesh)
    cap_of = {group_key_str(k): g.packed_size // layout.shards
              for k, g in plan.groups.items()}
    padded = sorted(group_key_str(k) for k, g in plan.groups.items()
                    if "/experts/" in k and g.packed_size != g.count)
    o = layout.owner_index()
    zero = True
    for k, g in plan.groups.items():
        cap = cap_of[group_key_str(k)]
        pad = torch.from_numpy(g.pack_index[o * cap:(o + 1) * cap] < 0)
        zero &= bool((state.momentum[group_key_str(k)][pad] == 0).all())
    roundtrip = None
    if padded:
        other = api.dedicate_params(model_fns(cfg).init(cfg, device="meta"),
                                    mesh=mesh, strategy="greedy",
                                    physical_layout="assignment")
        moved = api.reshard_owner_state(state, plan, other, mesh)
        back = api.reshard_owner_state(moved, other, plan, mesh)
        new_layout = OwnerLayout(other, mesh)
        same = []          # every rank gathers every group (collectives)
        for k in plan.groups:
            s = group_key_str(k)
            rows = layout.gather_rows(state.momentum[s])[
                torch.from_numpy(plan.groups[k].unpack_index)]
            moved_rows = new_layout.gather_rows(moved.momentum[s])[
                torch.from_numpy(other.groups[k].unpack_index)]
            same.append(torch.equal(back.momentum[s], state.momentum[s])
                        and torch.equal(rows, moved_rows))
        roundtrip = all(same)
    return {"padded": padded, "pad_rows_zero": zero,
            "reshard_roundtrip": roundtrip}


def tp_restore_rank(args) -> None:
    """Resume the ``tp`` mode's checkpoint (DIR's parent/ckpt; of
    ``--ckpt``'s config) on this mesh and, on rank 0, in one process: whole parameters and AdamW
    moments saved (``restored/``, ``single/``).  The bytes of every array
    the mesh's restore made on this rank's host (``assembled``), beside
    the bytes of each leaf this rank holds after it and of the whole
    leaf."""
    from repro_torch.checkpoint import manager
    from repro_torch.core import tree

    mesh = _setup(args)
    ckpt = Path(args.out).parent / "ckpt"
    made = {}
    assemble = manager._assemble

    def counted(d, meta, *region):
        arr = assemble(d, meta, *region)
        made[meta["file"]] = [int(arr.nbytes),
                              int(np.prod(meta["shape"])) * arr.itemsize]
        return arr
    manager._assemble = counted
    name = args.ckpt or TP_CKPT
    try:
        loop = _tp_ckpt_loop(mesh, ckpt, resume=True, name=name)
    finally:
        manager._assemble = assemble
    loop.pipe.close()
    held = {}
    for prefix, t in (("train/params", loop.state.params),
                      ("train/opt_state/adamw/mu",
                       loop.state.opt_state.adamw.mu),
                      ("train/opt_state/adamw/nu",
                       loop.state.opt_state.adamw.nu)):
        for p, v in tree.flatten(t):
            path = f"{prefix}/{p}"
            held[path] = {"split": loop.specs is not None and any(
                e is not None for e in loop.specs[p]),
                "bytes": v.numel() * v.element_size(),
                "assembled_whole": made[manager._leaf_file(path)]}
    arrays = {f"restored/{k}": v for k, v in _tp_ckpt_arrays(loop).items()}
    if args.rank == 0:
        one = _tp_ckpt_loop(None, ckpt, resume=True, name=name)
        one.pipe.close()
        arrays.update({f"single/{k}": v
                       for k, v in _tp_ckpt_arrays(one).items()})
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps({
        "rank": args.rank, "held": held,
        "assembled_bytes": sum(a for a, _ in made.values()),
        "whole_bytes": sum(w for _, w in made.values())}))


CKPT_PARTS = ("train/params", "train/opt_state/adamw/mu",
              "train/opt_state/adamw/nu")
CKPT_MOMENTUM = "train/opt_state/momentum"


def _split_paths(specs: dict) -> dict:
    """{checkpoint path: spec} of the leaves a checkpoint holds in parts
    (``CKPT_PARTS``), as the resilient loop's ``_parts`` places them."""
    return {f"{pre}/{p}": tuple(spec) for pre in CKPT_PARTS
            for p, spec in specs.items() if any(e is not None for e in spec)}


def _local_shape(shape, spec, mesh) -> tuple:
    from repro_torch.models.sharding import placements
    out = list(shape)
    for i, q in enumerate(placements(spec, mesh)):
        if q.is_shard():
            out[q.dim] //= mesh.size(i)
    return tuple(out)


def zero3_save(got: dict, mesh, ckpt_dir: Path) -> dict:
    """Save ``tp_train``'s last state (``got``) with the checkpoint
    manager, each rank writing its parts of the split leaves
    (``shard_range``) and its block of the owner rows; returns the whole
    arrays (rank 0 keeps them): parameters, AdamW moments, momentum rows."""
    import torch

    from repro_torch.checkpoint.manager import (CheckpointManager, LeafPart,
                                                RowBlocks, _flatten)
    from repro_torch.core.owner_comms import OwnerLayout
    from repro_torch.models.sharding import shard_range
    state, specs = got["state"], {p: tuple(s) for p, s in
                                  got["specs"].items()}
    layout = OwnerLayout(got["plan"], mesh)
    tree_ = {"train": state._asdict()}
    placed = _split_paths(specs)
    leaves: list = []
    _flatten(tree_, (), leaves)
    parts = {path: LeafPart(*shard_range(placed[path], mesh,
                                         tuple(leaf.shape)))
             for path, leaf in leaves if path in placed}
    mgr = CheckpointManager(str(ckpt_dir))
    mgr.save(state.step, tree_, parts=parts, row_blocks=RowBlocks(
        (CKPT_MOMENTUM,), layout.owner_index(), layout.shards))
    mgr.wait()
    out = {}
    for pre, t in (("train/params", state.params),
                   ("train/opt_state/adamw/mu", state.opt_state.adamw.mu),
                   ("train/opt_state/adamw/nu", state.opt_state.adamw.nu)):
        out.update({f"{pre}/{p}": v for p, v in
                    whole_np(t, specs, mesh).items()})
    for k, v in state.opt_state.momentum.items():
        out[f"{CKPT_MOMENTUM}/{k}"] = layout.gather_rows(v).to(
            torch.float32).numpy()
    return out


def zero3_rank(args) -> None:
    """ZeRO-3 (``param_specs(..., zero3=True)``) on a ("data", "model")
    mesh: each of ``args.configs`` trained ``TP_STEPS`` steps from
    ``tp_params`` on ``tp_batch`` by ``tp_train(..., zero3=True)``:
    loss_ema per step, step 1's gradients' placements, the last
    parameters (rank 0), each leaf's part as a share of the whole, AdamW
    moments shaped as the parts, ``padded_owner_checks``, and
    ``init_state(..., zero3=True)``'s parts bitwise the slices of the
    one-process ``init``.  On a mesh of one rank also the one-process
    step of each, and whether the two agree bitwise.  ``--ckpt NAME``:
    that config's last state checkpointed into DIR/ckpt (``zero3_save``),
    its whole arrays saved beside."""
    import torch

    from repro_torch.core import api, tree
    from repro_torch.models import transformer
    from repro_torch.models.sharding import local_part, param_specs
    from repro_torch.train.step import init_state

    mesh = _setup(args)
    info, arrays = {"rank": args.rank, "configs": {}}, {}
    for name in args.configs.split(","):
        cfg = tp_config(name)
        params_np = tp_params(name)
        got = tp_train(name, mesh, params_np, zero3=True)
        shapes = transformer.init(cfg, device="meta")
        whole_shapes = {p: v.shape for p, v in tree.flatten(shapes)}
        row = {"ema": got["ema"], "placements": got["placements"],
               "specs": got["specs"],
               "adamw_local_shapes": got["adamw_local_shapes"],
               "share": {p: math.prod(s) / math.prod(whole_shapes[p])
                         for p, s in got["local_shapes"].items()}}
        row.update(padded_owner_checks(cfg, got["plan"], got["opt_state"],
                                       mesh))
        opt = api.Muon(api.dedicate_params(shapes, mesh=mesh), mesh,
                       config=tp_muon_config(), device="cpu")
        st = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh,
                        zero3=True)
        specs = param_specs(cfg, shapes, mesh, zero3=True)
        whole = dict(tree.flatten(transformer.init(cfg, 0, "cpu")))
        row["init_parts_bitwise"] = all(
            torch.equal(v.detach(), local_part(whole[p], specs[p], mesh))
            for p, v in tree.flatten(st.params))
        if args.rank == 0:
            arrays.update({f"{name}/params/{p}": v.numpy()
                           for p, v in got["params"].items()})
            arrays.update({f"{name}/grads/{p}": v.to(torch.float32).numpy()
                           for p, v in got["grads"].items()
                           if TP_ACCUM.get(name, 1) == 1})
        if mesh.size() == 1:
            one = tp_train(name, None, params_np)
            row["single_ema"] = one["ema"]
            row["single_bitwise"] = one["ema"] == got["ema"] and all(
                torch.equal(v, got["params"][p])
                for p, v in one["params"].items())
        if name == args.ckpt:
            saved = zero3_save(got, mesh, Path(args.out) / "ckpt")
            if args.rank == 0:
                arrays.update({f"ckpt/{k}": v for k, v in saved.items()})
        info["configs"][name] = row
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def zero3_restore_rank(args) -> None:
    """Restore ``zero3``'s checkpoint of ``--ckpt`` (DIR's parent/ckpt) on
    this mesh, each rank asking for its ZeRO-3 part of every split leaf
    alone: whether each part is bitwise its slice of the saved whole
    array, every other leaf (the owner rows reassembled whole) bitwise the
    saved one, and the bytes each array read made on this rank's host
    beside the whole leaf's.  Rank 0 also restores in one process (every
    leaf whole) and compares the same way."""
    import torch

    from repro_torch.checkpoint import manager
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.models import transformer
    from repro_torch.models.sharding import param_specs, shard_range

    mesh = _setup(args)
    parent = Path(args.out).parent
    saved = {k[len("ckpt/"):]: v for k, v in
             np.load(parent / "rank0.npz").items() if k.startswith("ckpt/")}
    cfg = tp_config(args.ckpt)
    specs = param_specs(cfg, transformer.init(cfg, device="meta"), mesh,
                        zero3=True)
    placed = {p: spec for p, spec in _split_paths(specs).items()
              if p in saved}
    regions = {}
    for path, spec in placed.items():
        local = _local_shape(saved[path].shape, spec, mesh)
        regions[path] = (shard_range(spec, mesh, local)[1], local)
    made = {}
    assemble = manager._assemble

    def counted(d, meta, *region):
        arr = assemble(d, meta, *region)
        made[meta["file"]] = [int(arr.nbytes),
                              int(np.prod(meta["shape"])) * arr.itemsize]
        return arr

    def compare(got_tree, parts) -> dict:
        leaves: list = []
        _flatten(got_tree, (), leaves)
        out = {}
        for path, v in leaves:
            if path not in saved:
                continue
            want = saved[path]
            if path in parts:
                start, shape = parts[path]
                want = want[tuple(slice(a, a + n)
                                  for a, n in zip(start, shape))]
            out[path] = bool(np.array_equal(
                v.detach().to(torch.float32).numpy(), want))
        return out
    manager._assemble = counted
    try:
        mgr = CheckpointManager(str(parent / "ckpt"))
        got = mgr.restore(parts=regions, device="cpu")
    finally:
        manager._assemble = assemble
    info = {"rank": args.rank, "bitwise": compare(got, regions),
            "read": {p: made[manager._leaf_file(p)] for p in placed},
            "compared": sorted(saved)}
    if args.rank == 0:
        whole = CheckpointManager(str(parent / "ckpt")).restore(device="cpu")
        info["single_bitwise"] = compare(whole, {})
    np.savez(Path(args.out) / f"rank{args.rank}.npz")
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


# expert-split leaves (L, E, m, n), E split over "model": 6, 2, 8 and 14
# matrices over the 4 owners of a (2, 2) mesh (padded, or whole blocks)
PAD_LEAVES = {"a": (3, 2, 8, 12), "b": (1, 2, 12, 8), "c": (2, 4, 8, 8),
              "g": (7, 2, 16, 16)}


def owner_pad_rank(args) -> None:
    """``OwnerLayout.pack`` / ``unpack`` of ``PAD_LEAVES``' gradients
    (``Partial("avg")`` over "data", E split over "model"), under a
    contiguous plan and one whose ``pack_index`` permutes the stack
    (``physical_layout="assignment"``): this rank's owner rows bitwise
    its block of the one-process ``pack_group`` of the averaged
    gradients, and the publish bitwise its part of them."""
    import torch
    from torch.distributed.tensor import Partial, Shard

    from repro_torch.core import api
    from repro_torch.core.owner_comms import (OwnerLayout, _lead_perm,
                                              group_key_str, pack_group)
    mesh = _setup(args)
    rng = np.random.default_rng(5)
    parts = {p: [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for _ in range(mesh.size(0))] for p, s in PAD_LEAVES.items()}
    d, m = mesh.get_local_rank(0), mesh.get_local_rank(1)
    out = {}
    for physical in ("contiguous", "assignment"):
        plan = api.dedicate_params(
            {p: torch.empty(s, device="meta") for p, s in PAD_LEAVES.items()},
            mesh=mesh, strategy="greedy", physical_layout=physical)
        layout = OwnerLayout(plan, mesh)
        for key, g in plan.groups.items():
            pl = {p: (Partial("avg"), Shard(1)) for p in g.leaf_paths}
            mine = {p: parts[p][d].chunk(mesh.size(1), dim=1)[m].contiguous()
                    for p in g.leaf_paths}
            avg = {p: sum(parts[p]) / len(parts[p]) for p in g.leaf_paths}
            rows = layout.pack(key, mine, pl)
            want = layout.local_block(pack_group(
                plan, key, avg,
                {p: _lead_perm(plan.leaves[p], pl[p]) for p in g.leaf_paths}))
            back = layout.unpack(key, rows, pl)
            out[f"{physical}/{group_key_str(key)}"] = {
                "padded": g.packed_size != g.count,
                "permuted": not np.array_equal(g.pack_index[:g.count],
                                               np.arange(g.count)),
                "pack_bitwise": torch.equal(rows, want),
                "publish_bitwise": all(
                    torch.equal(back[p], avg[p].chunk(mesh.size(1),
                                                      dim=1)[m])
                    for p in g.leaf_paths)}
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(
        {"rank": args.rank, "groups": out}))
    np.savez(Path(args.out) / f"rank{args.rank}.npz")


def optim_rank(args) -> None:
    """``MuonOptimizer`` on a data-only mesh against the data-parallel
    ``make_train_step`` of the reduced smollm-360m, ``TP_STEPS`` steps
    from seed 0 on this rank's rows: with ``grads="partial"`` (each
    rank's own backward) bitwise; with ``grads="replicated"`` under
    ``DistributedDataParallel`` (its averaged gradients), the largest
    difference a leaf relative to the leaf's largest magnitude."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from repro_torch import configs
    from repro_torch.core import api, tree
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import transformer
    from repro_torch.train.step import (init_state, make_loss_fn,
                                        make_train_step)

    mesh = _setup(args)
    cfg = configs.get("smollm-360m", reduced=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    mcfg = tp_muon_config()
    shapes = transformer.init(cfg, device="meta")

    def batch(i):
        return batch_for_step(dcfg, i, device="cpu", mesh=mesh)
    opt = api.Muon(api.dedicate_params(shapes, mesh=mesh), mesh,
                   config=mcfg, device="cpu")
    state = init_state(cfg, opt, seed=0, device="cpu", mesh=mesh)
    step = make_train_step(cfg, opt, mesh, device="cpu")
    want = []
    for i in range(TP_STEPS):
        state = step(state, batch(i))
        want.append(state.loss_ema)

    loss_fn = make_loss_fn(cfg, mesh)

    def ema_of(losses):
        ema = None
        for loss in losses:
            for d in range(mesh.ndim):
                torch.distributed.all_reduce(loss, group=mesh.get_group(d))
                loss /= mesh.size(d)
            ema = loss if ema is None else 0.98 * ema + 0.02 * loss
        return ema

    params = tree.tree_map(lambda v: v.requires_grad_(True),
                           transformer.init(cfg, 0, "cpu"))
    front = api.MuonOptimizer(params, mesh, config=mcfg, device="cpu")
    losses = []
    for i in range(TP_STEPS):
        loss = loss_fn(params, batch(i))
        loss.backward()
        front.step()
        front.zero_grad()
        losses.append(loss.detach())
    partial = torch.equal(ema_of(losses), want[-1]) and all(
        torch.equal(a, b.detach()) for (_, a), (_, b) in
        zip(tree.flatten(params), tree.flatten(state.params)))

    class Tree(torch.nn.Module):
        """The parameter tree as a module whose forward is the loss."""

        def __init__(self, t):
            super().__init__()
            for k, v in t.items():
                if isinstance(v, dict):
                    self.add_module(k, Tree(v))
                else:
                    self.register_parameter(k, torch.nn.Parameter(v))

        def forward(self, b):
            return loss_fn(tree.from_named(self.named_parameters()), b)
    model = Tree(transformer.init(cfg, 0, "cpu"))
    ddp = DistributedDataParallel(model)
    opt = api.MuonOptimizer(model, mesh, config=mcfg, device="cpu",
                            grads="replicated")
    losses = []
    for i in range(TP_STEPS):
        loss = ddp(batch(i))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.detach())
    got = dict(tree.flatten(tree.from_named(model.named_parameters())))
    rel = max(float((got[p].detach() - v.detach()).abs().max()
                    / v.detach().abs().max())
              for p, v in tree.flatten(state.params))
    ema_rel = abs(float(ema_of(losses) / want[-1]) - 1)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps({
        "rank": args.rank, "partial_bitwise": partial,
        "ddp_max_rel": rel, "ddp_ema_rel": ema_rel,
        "ema": [float(x) for x in want]}))
    np.savez(Path(args.out) / f"rank{args.rank}.npz")


def jax_tp_reference(args) -> None:
    """The reference's sharded train step (``init_state``'s placements,
    ``make_train_step(..., grad_specs=param_specs(...))``; with
    ``--zero3`` ``param_specs(..., zero3=True)``, and the accumulation
    dtype of ``TP_ACCUM_DTYPE``) of each of ``args.configs`` on an
    Auto-axis mesh of ``args.mesh``, from ``tp_params`` on ``tp_batch``,
    ``TP_STEPS`` steps: loss_ema per step and the last parameters, into
    ``jax.npz``; with ``--zero3`` also, for a config of one microbatch, the
    gradients of step 1's loss (the reference's sharded loss function on
    the placed parameters)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as Pspec

    from repro.core import api
    from repro.core.gram_ns import GramNSConfig
    from repro.core.muon import MuonConfig
    from repro.models.sharding import batch_spec, param_specs
    from repro.train.step import make_loss_fn, make_train_step
    from repro.train.train_state import TrainState

    n = int(np.prod(args.mesh))
    mesh = jax.make_mesh(tuple(args.mesh), AXES,
                         axis_types=(AxisType.Auto,) * len(AXES),
                         devices=jax.devices()[:n])
    arrays = {}
    for name in args.configs.split(","):
        cfg = tp_config(name, jax=True)
        params = jax.tree.map(jnp.asarray, tp_params(name))
        specs = param_specs(cfg, params, mesh, zero3=args.zero3)
        params = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, Pspec)))
        plan = api.dedicate_params(params, mesh=mesh, strategy="greedy")
        opt = api.Muon(plan, mesh=mesh, config=MuonConfig(
            mode="owner", learning_rate=TP_LR, momentum=TP_MOMENTUM,
            ns=GramNSConfig(num_steps=NS_STEPS)))
        state = TrainState(jnp.zeros((), jnp.int32), params,
                           jax.jit(opt.init)(params),
                           jnp.zeros((), jnp.float32))
        step = make_train_step(
            cfg, opt, mesh, grad_specs=specs,
            accum_steps=TP_ACCUM.get(name, 1), pipeline=TP_PIPELINE.get(name),
            accum_dtype=getattr(jnp, TP_ACCUM_DTYPE.get(name, "float32")))
        ema = []
        for i in range(TP_STEPS):
            batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, Pspec(*batch_spec(mesh, TP_BATCH), None)))
                for k, v in tp_batch(name, i).items()}
            if i == 0 and args.zero3 and TP_ACCUM.get(name, 1) == 1:
                grads = jax.jit(jax.grad(make_loss_fn(cfg, mesh)))(
                    state.params, batch)
                for kp, v in jax.tree_util.tree_leaves_with_path(grads):
                    path = "/".join(str(getattr(k, "key", k)) for k in kp)
                    arrays[f"{name}/grads/{path}"] = np.asarray(
                        jax.device_get(v))
            state = step(state, batch)
            ema.append(float(state.loss_ema))
        arrays[f"{name}/ema"] = np.asarray(ema)
        for kp, v in jax.tree_util.tree_leaves_with_path(state.params):
            path = "/".join(str(getattr(k, "key", k)) for k in kp)
            arrays[f"{name}/params/{path}"] = np.asarray(jax.device_get(v))
    np.savez(Path(args.out) / "jax.npz", **arrays)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("owner", "train", "variants", "pipeline",
                                     "checkpoint", "restore", "moe", "jax",
                                     "jax_moe", "tp", "tp_restore",
                                     "jax_tp", "optim", "owner_pad",
                                     "zero3", "zero3_restore", "serve",
                                     "jax_serve", "tp_families",
                                     "tp_pieces", "tp_branches"))
    ap.add_argument("--configs", default=",".join(TP_CONFIGS),
                    help="tp / jax_tp: comma-separated TP_CONFIGS names; "
                         "serve / jax_serve: torch_serve_check.CASES names")
    ap.add_argument("--ckpt", default="",
                    help="tp / tp_restore: the TP_CONFIGS name to "
                         "checkpoint (tp: on this mesh) and restore")
    ap.add_argument("--zero3", action="store_true",
                    help="jax_tp: the ZeRO-3 specs (param_specs(..., "
                         "zero3=True))")
    ap.add_argument("--train-only", action="store_true",
                    help="tp: the training runs alone (no one-process "
                         "references, Functions or checkpoint)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    # yield the CPU to the test processes running beside these worlds
    # (several tests compare solver results that a time limit bounds)
    os.nice(10)
    import torch_serve_check
    if args.mode in ("jax", "jax_moe", "jax_tp", "jax_serve"):
        {"jax": jax_reference, "jax_moe": jax_moe_reference,
         "jax_tp": jax_tp_reference,
         "jax_serve": torch_serve_check.jax_serve_reference}[args.mode](args)
        return
    import torch.distributed as dist
    try:
        {"owner": owner_rank, "train": train_rank,
         "variants": variants_rank, "pipeline": pipeline_rank,
         "checkpoint": checkpoint_rank, "restore": restore_rank,
         "moe": moe_rank, "tp": tp_rank, "tp_families": tp_families_rank,
         "tp_pieces": tp_pieces_rank, "tp_branches": tp_branches_rank,
         "tp_restore": tp_restore_rank, "optim": optim_rank,
         "owner_pad": owner_pad_rank, "zero3": zero3_rank,
         "zero3_restore": zero3_restore_rank,
         "serve": torch_serve_check.serve_rank}[args.mode](args)
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
