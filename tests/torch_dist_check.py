"""Multi-rank checks of the PyTorch port, one gloo process per rank.

Run by ``tests/test_torch_mesh_*.py`` through ``launch``, the way
``tests/test_distributed.py`` runs ``dist_check.py``:

    python tests/torch_dist_check.py owner --rank R --world W --port P \\
        --mesh 2,4 --out DIR
    python tests/torch_dist_check.py train --rank R --world W --port P \\
        --mesh 2,1 --out DIR
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_check.py jax --mesh 2,4 --out DIR

``owner`` is the twin of ``dist_check.py``'s checks 1–5 on a
("data", "model") mesh with its tree, gradients and tensor-parallel specs,
plus the port's own invariants; ``train`` runs the data-parallel train step
of the reduced smollm-360m; ``jax`` runs the reference's own multi-device
owner update on an Auto-axis mesh.  Each writes ``rank<R>.npz`` and
``rank<R>.json`` (``jax.npz``) into DIR; the tests read them.  Every
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
    ap.add_argument("mode", choices=("owner", "train", "jax"))
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
        (owner_rank if args.mode == "owner" else train_rank)(args)
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
