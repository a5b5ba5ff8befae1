"""Production-mesh dry run (port of ``repro.launch.dryrun``,
``src/repro/launch/dryrun.py``): every (architecture × input shape × mesh)
cell traced once on a fake world of 256 or 512 ranks, its per-card FLOPs,
bytes, collective bytes and peak memory recorded for the §Dry-run and
§Roofline tables (``launch/report.py``).

The reference lowers and compiles each cell with XLA on 512 host devices.
The port runs eagerly, so a cell is one call of the port's own step
function under ``launch/op_walker.py``'s ``OpWalker``, with two stand-ins
that make it cost nothing but host time:

* the world is fake: ``torch.distributed`` with the "fake" backend
  (``FakeStore``, this process rank 0 of 256 or 512), so the mesh
  (``launch/mesh.make_production_mesh``) and every collective are real
  calls that move nothing;
* the tensors are fake: everything is built under ``FakeTensorMode`` on
  the CPU, so nothing is allocated and no card is touched.  Every kernel
  wrapper sees a CPU tensor and takes its plain version, as the reference
  lowers its pure-jnp Gram NS path; the roofline's kernel-adjusted term
  puts the symmetric kernels back.

Train cells run ``train/step.make_train_step`` with ``Muon`` in owner /
gather / AdamW mode, once; the costs are those of rank 0.  Serve cells run
``train/serve.prefill_fn`` / ``decode_fn`` on one rank's rows.  The
batch is split over the mesh's data axes (``models.sharding.dp_axes``), a
batch smaller than the data-parallel size run whole on each card.  Every
family's train cells walk the tensor-parallel step: parameters split by
``param_specs`` over the 'model' axis (16 cards) and the forward's
collectives on it (the MoE experts split over that axis: expert
parallelism).  The dense and MoE families' serve cells walk the
tensor-parallel forward too, a decode cache split by ``cache_specs``.
nemotron-4-340b's, deepseek-v3-671b's and kimi-k2-1t-a32b's cells
(``BIG_ARCHS``) run the reference's >= 340 B memory policy: ZeRO-3
(``param_specs(..., zero3=True)``: the block weights also split over
'data', gathered a layer at a time) and, in training, bf16 gradient
accumulation and bf16 optimizer state; their ``detail`` says so.  The
other families' serve cells keep the parameters replicated on every card
(their serving under a mesh is ROADMAP item 6's serving half): a model
of more than ~10 B parameters does not fit a card in that layout, and
``fits_hbm`` says so.  The eager step has no lowering: a cell's
``timings_s`` hold ``build`` (parameters, optimizer state and
inputs), ``lower`` (0) and ``compile`` (the walked call, where the
reference compiles).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single --opt owner
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results land in experiments/torch_dryrun/<mesh>/<arch>__<shape>__<opt>.json,
one file per cell, written as each cell ends (reruns skip finished cells
unless --force).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cell_supported,
                                        input_specs)
from repro_torch.core import api, tree
from repro_torch.core.gram_ns import GramNSConfig, gram_ns_flops
from repro_torch.core.muon import MuonConfig
from repro_torch.launch import roofline
from repro_torch.launch.mesh import HBM_BYTES, axis_sizes, \
    make_production_mesh
from repro_torch.launch.op_walker import OpWalker
from repro_torch.models import model_fns
from repro_torch.models.sharding import dp_axes, local_part, param_specs
from repro_torch.models.tp import model_extent, serves_split, tensor_parallel
from repro_torch.train.train_state import TrainState

RESULT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "../../..", "experiments",
    "torch_dryrun"))

# Memory policy of the reference (its docs/DESIGN.md §8): the >= 340B
# configs split their weights over 'data' too (ZeRO-3), accumulate their
# gradients in bf16 and keep bf16 optimizer state and NS math end to end.
BIG_ARCHS = {"nemotron-4-340b", "deepseek-v3-671b", "kimi-k2-1t-a32b"}
MID_ARCHS = {"qwen2.5-14b", "llava-next-mistral-7b"}
MESH_WORLD = {"single": 256, "multi": 512}


def opt_config(arch_id: str, mode: str) -> MuonConfig:
    """The reference's optimizer settings of a cell.  The kernel autotuner
    is not prewarmed: the dry run traces the plain Gram NS path."""
    if arch_id in BIG_ARCHS:
        return MuonConfig(mode=mode, momentum_dtype="bfloat16",
                          pack_dtype="bfloat16", autotune_prewarm=False,
                          ns=GramNSConfig(compute_dtype="bfloat16",
                                          owner_chunk=8))
    return MuonConfig(mode=mode, autotune_prewarm=False)


def accum_steps(arch_id: str) -> int:
    # global microbatch stays divisible by DP on both meshes (>= 32)
    if arch_id in BIG_ARCHS or arch_id in MID_ARCHS:
        return 8
    return 4


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a "fake" default process group of
    ``world_size`` ranks, destroyed on exit.  Its collectives move
    nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_rows(global_batch: int, mesh) -> int:
    """One rank's rows: the batch split over the data axes, or the whole
    batch where it is smaller than them."""
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    return global_batch // dp if global_batch % dp == 0 else global_batch


def rank_inputs(cfg, shape, mesh) -> dict:
    """``input_specs`` of ``shape`` (a name of ``SHAPES`` or a
    ``ShapeSpec``) as this rank's zero-filled tensors (fake under the dry
    run's ``FakeTensorMode``); the decode cell's ``pos`` is the last cache
    position, a Python int, as the serving loop passes it."""
    sp = _spec(shape)
    rows = local_rows(sp.global_batch, mesh)
    out = {}
    for k, v in input_specs(cfg, sp).items():
        if k == "pos":
            out[k] = sp.seq_len - 1
            continue
        out[k] = torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype)
    return out


def build_train_cell(cfg, arch_id, shape, mesh, mode, muon=None,
                     accum=None, zero3: bool = False):
    """(fn, example_args, plan) of one training cell, built under the
    caller's ``FakeTensorMode``: the state from ``init`` directly (not
    ``init_state``, whose cross-rank checksum reads a collective's
    result), cut to this rank's parts where the step is tensor-parallel,
    the step with the buffers of the spent state released (``donate``).
    ``muon`` / ``accum`` replace the arch's optimizer settings
    (``opt_config``) and microbatches (``accum_steps``); ``zero3``: the
    parameters split by ``param_specs(..., zero3=True)`` and the gradients
    accumulated in bf16 (``walk_cell`` sets it on a production mesh for
    ``BIG_ARCHS``, the reference's rule)."""
    from repro_torch.train.step import make_train_step, placed_params
    m = model_fns(cfg)
    params = m.init(cfg, 0, device="cpu")
    plan = api.dedicate_params(params, mesh=mesh, strategy="greedy")
    opt = api.Muon(plan, mesh, config=muon or opt_config(arch_id, mode),
                   device="cpu")
    specs = None
    if zero3 or tensor_parallel(mesh):
        specs = param_specs(cfg, params, mesh, zero3=zero3)
        params = tree.rebuild(params, {
            p: local_part(v, specs[p], mesh).clone()
            for p, v in tree.flatten(params)})
        for _, v in tree.flatten(params):
            v.requires_grad_(True)
        opt_state = opt.init(placed_params(params, specs, mesh))
    else:
        params = tree.tree_map(lambda v: v.requires_grad_(True), params)
        opt_state = opt.init(params)
    state = TrainState(0, params, opt_state,
                       torch.zeros((), dtype=torch.float32))
    inputs = rank_inputs(cfg, shape, mesh)
    # the arch's microbatches, as many as this rank's rows allow
    accum = accum or math.gcd(accum_steps(arch_id),
                              inputs["tokens"].shape[0])
    step = make_train_step(cfg, opt, mesh, accum_steps=accum, donate=True,
                           device="cpu", grad_specs=specs,
                           accum_dtype=torch.bfloat16 if zero3
                           else torch.float32)
    return step, (state, inputs), plan


def build_serve_cell(cfg, arch_id, shape, mesh, zero3: bool = False,
                     split: bool = True):
    """(fn, example_args) of one prefill or decode cell on this rank's
    rows; parameters in the serving dtype (bf16).  The dense and MoE
    families (``split``, their tensor-parallel forward) serve on the
    reference's layout (``src/repro/launch/dryrun.py:134-175``): the
    parameters this rank's parts by ``param_specs`` (ZeRO-3's with
    ``zero3``), the decode cache this rank's part by ``cache_specs``
    (``train.serve.init_cache_part``), the mesh serving functions on the
    fake world.  The other families, or ``split=False``, keep every
    parameter whole on every card and the cache's rows of this rank."""
    from repro_torch.train import serve as serve_fns
    m = model_fns(cfg)
    sp = _spec(shape)
    params = m.init(cfg, 0, device="cpu")
    inputs = rank_inputs(cfg, sp, mesh)
    rows = inputs["tokens" if sp.kind == "prefill" else "token"].shape[0]
    ctx = None
    if split and serves_split(cfg):
        ctx = serve_fns.mesh_context(cfg, mesh, zero3=zero3)
        params = tree.tree_map(lambda v: v.clone(),
                               serve_fns.local_params(params, ctx))
        if rows == sp.global_batch:      # every data rank runs it whole
            ctx = ctx.whole_batch()
    if sp.kind == "prefill":
        max_len = sp.seq_len + (cfg.frontend_len if cfg.frontend == "patch"
                                else 0)
        kw = {} if ctx is None else {"ctx": ctx}

        def fn(params, inputs):
            return serve_fns.prefill_fn(
                cfg, params, inputs["tokens"], max_len, **kw,
                **{k: v for k, v in inputs.items() if k != "tokens"})
        return fn, (params, inputs)

    # decode: one token against a seq_len-deep cache
    kw = {}
    if ctx is not None:
        cache, _ = serve_fns.init_cache_part(cfg, sp.global_batch,
                                             sp.seq_len, mesh,
                                             torch.bfloat16, "cpu")
        kw = dict(ctx=ctx, max_len=sp.seq_len)
    elif cfg.encdec:
        cache = m.init_cache(cfg, rows, sp.seq_len, sp.seq_len,
                             torch.bfloat16, device="cpu")
    else:
        cache = m.init_cache(cfg, rows, sp.seq_len, torch.bfloat16,
                             device="cpu")

    def fn(params, token, cache, pos):
        return serve_fns.decode_fn(cfg, params, token, cache, pos, **kw)
    return fn, (params, inputs["token"], cache, inputs["pos"])


def ns_flops_for_plan(plan, ns_steps: int, num_devices: int):
    """Per-card Gram NS FLOPs of ``plan`` as full GEMMs and as the
    symmetric kernels compute them (``src/repro/launch/dryrun.py:188``)."""
    raw = kern = 0.0
    for g in plan.groups.values():
        m, n = g.key
        f = gram_ns_flops(m, n, ns_steps, batch=g.packed_size)
        raw += f["gram_full_gemm"]
        kern += f["gram_symmetric_kernel"]
    return raw / num_devices, kern / num_devices


def _spec(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def _fake_mesh(mesh_kind):
    """The mesh of ``mesh_kind`` over the fake world: the production
    "single" / "multi" mesh, or a (data, model) shape."""
    if mesh_kind in MESH_WORLD:
        return make_production_mesh(multi_pod=(mesh_kind == "multi"))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(mesh_kind),
                            mesh_dim_names=("data", "model"))


def walk_cell(cfg, arch_id: str, shape, mesh_kind, mode: str, *,
              muon=None, accum=None, zero3: bool | None = None,
              split: bool = True) -> dict:
    """Build and walk one cell on the fake world; the result's fields
    (``ok`` and after), or an exception.  ``shape``: a name of ``SHAPES``
    or a ``ShapeSpec``; ``mesh_kind``: "single", "multi" or a (data,
    model) shape (``_fake_mesh``), as ``chip_smoke.py`` predicts a run on
    the cards it has (``muon`` / ``accum`` / ``zero3``: that run's
    optimizer settings, microbatches and ZeRO-3 with bf16 accumulation,
    ``build_train_cell``).  ``zero3`` None: the arch's memory policy
    (``BIG_ARCHS``) on a production mesh, none on a (data, model)
    shape.  ``split=False`` walks a serve cell with the parameters and
    the cache whole over 'model' (``build_serve_cell``), the layout the
    split one is held against."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sp = _spec(shape)
    world = MESH_WORLD.get(mesh_kind) or math.prod(mesh_kind)
    with fake_world(world):
        # the mesh reads its rank map, so it is built on real tensors
        mesh = _fake_mesh(mesh_kind)
        ndev = mesh.size()
        with FakeTensorMode():
            t0 = time.time()
            plan = None
            if zero3 is None:
                zero3 = mesh_kind in MESH_WORLD and arch_id in BIG_ARCHS
            if sp.kind == "train":
                fn, args, plan = build_train_cell(cfg, arch_id, sp, mesh,
                                                  mode, muon, accum, zero3)
            else:
                fn, args = build_serve_cell(cfg, arch_id, sp, mesh, zero3,
                                            split)
            t_build = time.time() - t0

            t0 = time.time()
            walker = OpWalker()
            walker.track_arguments(args)
            with walker:
                out = fn(*args)
            t_walk = time.time() - t0
            mem = roofline.memory_analysis_dict(walker, out)
            del out, args, fn

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    model_flops = (6.0 if sp.kind == "train" else 2.0) * n_active * \
        tokens / ndev
    nsr = nsk = 0.0
    if plan is not None and mode == "owner":
        nsr, nsk = ns_flops_for_plan(plan, 5, ndev)
    ns_dtype = (muon or opt_config(arch_id, mode)).ns.compute_dtype
    r = roofline.analyze(walker.costs, num_devices=ndev,
                         model_flops=model_flops, ns_flops_raw=nsr,
                         ns_flops_kernel=nsk, ns_dtype=ns_dtype)
    rows = local_rows(sp.global_batch, mesh)
    batch = (f"{rows} of {sp.global_batch} rows a card (the batch over "
             f"{dp_axes(mesh)}"
             f"{'' if rows < sp.global_batch else ', smaller than them: whole'})")
    if sp.kind == "train" and zero3:
        r.detail["layout"] = (
            f"parameters split by param_specs over 'model' "
            f"({model_extent(mesh)} cards), with ZeRO-3 (the block weights "
            f"also over 'data', {axis_sizes(mesh)['data']} cards, gathered "
            f"a layer at a time; bf16 gradient accumulation); {batch}; "
            "the tensor-parallel forward")
    elif sp.kind == "train" and tensor_parallel(mesh):
        r.detail["layout"] = (
            f"parameters split by param_specs over 'model' "
            f"({model_extent(mesh)} cards); {batch}; the tensor-parallel "
            "forward")
    elif sp.kind != "train" and split and serves_split(cfg):
        zero = (f", with ZeRO-3 (the block weights also over 'data', "
                f"{axis_sizes(mesh)['data']} cards, gathered a layer at a "
                "time)") if zero3 else ""
        r.detail["layout"] = (
            f"parameters split by param_specs over 'model' "
            f"({model_extent(mesh)} cards){zero}; the decode cache by "
            "cache_specs (slots over the data axes, KV heads or sequence "
            f"over 'model'); {batch}; the tensor-parallel forward")
    else:
        r.detail["layout"] = (
            f"parameters replicated on every card; {batch}; "
            + ("the model axis spreads the owners only" if sp.kind == "train"
               else "no serving under a mesh (ROADMAP item 6, its serving "
               "half)"))
    result = {
        "ok": True,
        "num_devices": ndev,
        "timings_s": {"build": t_build, "lower": 0.0, "compile": t_walk},
        "memory_analysis": mem,
        "hbm_utilization": mem["total_bytes"] / HBM_BYTES,
        "fits_hbm": mem["total_bytes"] <= HBM_BYTES,
        "roofline": r.to_dict(),
        "params": n_params, "active_params": n_active,
        "tokens_per_step": tokens,
    }
    if plan is not None:
        result["plan_stats"] = plan.stats
    return result


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, mode: str,
             outdir: str, force: bool = False, reduced: bool = False,
             layers: int | None = None) -> dict:
    """One cell's JSON (read back if written and not ``force``); a failure
    is recorded with its traceback (``src/repro/launch/dryrun.py:199``).
    ``reduced``: the arch's reduced config (the CPU tests' widths) at the
    cell's shapes; ``layers``: the config cut to that many layers, its
    widths kept (a JSON of its own)."""
    tag = f"{arch_id}__{shape_name}__{mode}" + \
        (f"__{layers}layers" if layers else "")
    mesh_dir = os.path.join(outdir, mesh_kind)
    os.makedirs(mesh_dir, exist_ok=True)
    out_path = os.path.join(mesh_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    sp = SHAPES[shape_name]
    serve_dtypes = (dict(param_dtype="bfloat16", compute_dtype="bfloat16")
                    if sp.kind != "train" else {})
    cfg = configs.get(arch_id, reduced=reduced, **serve_dtypes,
                      **({"n_layers": layers} if layers else {}))
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
              "opt": mode, "kind": sp.kind}

    skip = cell_supported(cfg, shape_name)
    if skip:
        result["skipped"] = skip
        _write(out_path, result)
        return result

    try:
        result.update(walk_cell(cfg, arch_id, shape_name, mesh_kind, mode))
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        result.update({"ok": False, "error": repr(e),
                       "traceback": traceback.format_exc()})
    _write(out_path, result)
    return result


def _write(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=str)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--opt", default="owner",
                    choices=["owner", "gather", "adamw"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--outdir", default=RESULT_DIR)
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs (CPU-test widths)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this many layers (its widths "
                         "kept): a full-width cell's cost a layer")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    cells = [(a, s, mk) for mk in meshes for a in archs for s in shapes]
    if args.list:
        for c in cells:
            print(*c)
        return

    n_ok = n_skip = n_fail = 0
    for a, s, mk in cells:
        t0 = time.time()
        r = run_cell(a, s, mk, args.opt, args.outdir, force=args.force,
                     reduced=args.reduced, layers=args.layers)
        dt = time.time() - t0
        if r.get("skipped"):
            n_skip += 1
            status = "SKIP " + r["skipped"][:40]
        elif r.get("ok"):
            n_ok += 1
            ra = r["roofline"]
            status = (f"ok mem={r['hbm_utilization']:.2f}HBM "
                      f"dom={ra['dominant']} "
                      f"c={ra['compute_s']:.4f}s m={ra['memory_s']:.4f}s "
                      f"x={ra['collective_s']:.4f}s")
        else:
            n_fail += 1
            status = "FAIL " + r.get("error", "?")[:80]
        print(f"[{mk:6s}] {a:24s} {s:12s} {dt:7.1f}s  {status}",
              flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")


if __name__ == "__main__":
    main()
