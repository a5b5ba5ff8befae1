"""Serving example of the PyTorch port: one-shot batch or continuous
batching (twin of ``examples/serve_decode.py``).

    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
    PYTHONPATH=src python examples/torch_serve_decode.py --arch xlstm-350m \
        --mode continuous --requests 12 --rate 50 --device cpu
    PYTHONPATH=src python examples/torch_serve_decode.py --mode continuous \
        --kv paged --device cpu

``--mode oneshot`` (default) prefills a batch of prompts together and
decodes in lockstep.  ``--mode continuous`` drives the same reduced model
through the serving tier (``repro_torch.serve``): a synthetic workload
flows through the slot scheduler — insert on free, evict on budget,
recycle cache rows — and the summary reports TTFT / throughput / slot
occupancy.  ``--kv paged`` serves from the paged block pool
(``repro_torch.serve.paged``) and also reports pool occupancy and
preemptions.  Runs on CUDA unless ``--device cpu``; parameters are random
from ``--seed``.
"""

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model_fns
from repro_torch.serve import RequestQueue, Scheduler, ServeConfig, run_oneshot


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
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=True)
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
    metrics = Scheduler(cfg, params, scfg).run(queue)
    s = metrics.summary()
    print(f"continuous[{device.type}]: slots={args.batch} kv={args.kv} "
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


if __name__ == "__main__":
    with torch.inference_mode():
        main()
