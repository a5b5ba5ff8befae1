"""Serving example of the PyTorch port: one-shot batch or continuous
batching (twin of ``examples/serve_decode.py``).

    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
    PYTHONPATH=src python examples/torch_serve_decode.py --arch xlstm-350m \
        --mode continuous --requests 12 --rate 50 --device cpu
    PYTHONPATH=src python examples/torch_serve_decode.py --mode continuous \
        --kv paged --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \
        examples/torch_serve_decode.py --mode continuous --mesh 1,4 [--full]

``--mode oneshot`` (default) prefills a batch of prompts together and
decodes in lockstep.  ``--mode continuous`` drives the same reduced model
through the serving tier (``repro_torch.serve``): a synthetic workload
flows through the slot scheduler — insert on free, evict on budget,
recycle cache rows — and the summary reports TTFT / throughput / slot
occupancy.  ``--kv paged`` serves from the paged block pool
(``repro_torch.serve.paged``) and also reports pool occupancy and
preemptions.  ``--mesh D,M`` (continuous, under ``torchrun``: one process
a card, or a gloo process a rank with ``--device cpu``) serves the dense
and MoE families on a ("data", "model") mesh: each rank draws and keeps
its parameter parts and its part of the slot cache, and rank 0 prints.
``--full`` takes the arch's published widths in bf16 instead of the
reduced config.  Runs on CUDA unless ``--device cpu``; parameters are
random from ``--seed``.
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_process_group, make_mesh
from repro_torch.models import model_fns
from repro_torch.serve import RequestQueue, Scheduler, ServeConfig, run_oneshot
from repro_torch.train.serve import mesh_context
from repro_torch.train.step import init_parts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--mode", default="oneshot",
                    choices=["oneshot", "continuous"])
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch (oneshot) / decode slots (continuous)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=12,
                    help="continuous: synthetic workload size")
    ap.add_argument("--rate", type=float, default=None,
                    help="continuous: arrivals/sec (default: all at t=0)")
    ap.add_argument("--kv", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="continuous: cache layout, contiguous per-slot "
                         "rows or the paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per cache block")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged: pool size in blocks (default: the "
                         "contiguous reservation's bytes)")
    ap.add_argument("--mesh", default=None,
                    help="continuous: D,M, a (data, model) mesh of a "
                         "torchrun world (dense and MoE families)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths in bf16")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, param_dtype="bfloat16",
                      compute_dtype="bfloat16") if args.full else \
        configs.get(args.arch, reduced=True)
    mesh = None
    if args.mesh is not None:
        if args.mode != "continuous":
            raise SystemExit("--mesh serves through the scheduler: "
                             "--mode continuous")
        mesh = join_mesh(device, tuple(int(x) for x in
                                       args.mesh.split(",")))
        params = init_parts(cfg, args.seed, device,
                            mesh_context(cfg, mesh).specs, mesh)
    else:
        params = model_fns(cfg).init(cfg, seed=args.seed, device=device)
    S = args.prompt_len
    max_len = S + args.new_tokens + 8
    if cfg.frontend is not None and not cfg.encdec:
        max_len += cfg.frontend_len
    enc_kw = dict(frontend_dim=cfg.frontend_dim) \
        if (cfg.encdec or cfg.frontend is not None) else {}
    if cfg.frontend == "patch":
        # patch prompts carry a fixed image prefix, not per-token frames
        enc_kw = {}

    def attach_patches(reqs):
        rng = np.random.default_rng(args.seed + 1)
        for r in reqs:
            r.frames = (rng.standard_normal(
                (cfg.frontend_len, cfg.frontend_dim)) * 0.1).astype(
                    np.float32)

    if args.mode == "oneshot":
        queue = RequestQueue.synthetic(
            args.batch, cfg.vocab, prompt_lens=(S,),
            new_tokens=(args.new_tokens + 1, args.new_tokens + 1),
            seed=1, **enc_kw)
        queue.poll(0.0)
        reqs = [queue.pop_group(1)[0] for _ in range(len(queue))]
        if cfg.frontend == "patch":
            attach_patches(reqs)
        metrics = run_oneshot(cfg, params, reqs, batch=args.batch,
                              max_len=max_len)
        s = metrics.summary()
        print(f"oneshot[{device.type}]: batch={args.batch} prompt={S} "
              f"new={args.new_tokens}")
        print(f"decoded {s['tokens']} tokens in {s['wall_s']:.2f}s "
              f"({s['per_token_ms_median']:.1f} ms/token median)")
        rec = next(iter(metrics.requests.values()))
        print("sample token ids:", rec.tokens[:16])
        return

    queue = RequestQueue.synthetic(
        args.requests, cfg.vocab, prompt_lens=(S,),
        new_tokens=(2, args.new_tokens), rate=args.rate, seed=1, **enc_kw)
    if cfg.frontend == "patch":
        attach_patches(queue._pending)
    scfg = ServeConfig(num_slots=args.batch, max_len=max_len,
                       enc_len=S if cfg.encdec else None, kv=args.kv,
                       block_size=args.block_size,
                       pool_blocks=args.pool_blocks)
    metrics = Scheduler(cfg, params, scfg, mesh=mesh).run(queue)
    if mesh is not None and dist.get_rank() != 0:
        return
    s = metrics.summary()
    print(f"continuous[{device.type}]: slots={args.batch} kv={args.kv} "
          f"mesh={args.mesh} "
          f"requests={s['requests']} (rate={args.rate or 'all-at-once'})")
    print(f"  tokens            {s['tokens']}  in {s['wall_s']:.2f}s")
    print(f"  tokens/sec        {s['tokens_per_sec']:.1f}")
    print(f"  ttft ms           {s['ttft_ms_median']:.1f} median / "
          f"{s['ttft_ms_p90']:.1f} p90")
    print(f"  per-token ms      {s['per_token_ms_median']:.1f} median")
    print(f"  decode steps      {s['decode_steps']}  "
          f"(occupancy {s['slot_occupancy']:.2f})")
    if args.kv == "paged" and s.get("pool_blocks"):
        print(f"  pool              {s['pool_blocks']} blocks "
              f"(occupancy {s['pool_occupancy']:.2f}, frag "
              f"{s['frag_pct']:.1f}%, preemptions {s['preemptions']})")
    rec = next(iter(metrics.requests.values()))
    print("sample token ids:", rec.tokens[:16])


def join_mesh(device, shape):
    """The ("data", "model") mesh of ``shape`` over a torchrun world."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise SystemExit(f"--mesh needs a torchrun launch; "
                         f"{', '.join(missing)} not set")
    init_process_group(device.type, rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]),
                       init_method="env://")
    return make_mesh(shape, ("data", "model"), device.type)


if __name__ == "__main__":
    try:
        with torch.inference_mode():
            main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
