"""Quickstart of the PyTorch port: the three-line DMuon API (paper Fig. 1a)
on a tiny LM.

    PYTHONPATH=src python examples/torch_quickstart.py \
        [--variant muon|normuon|muonbp|dion2|adamuon|adamw] \
        [--pipeline fused|bucketed] [--steps 20] [--device cpu]

Builds the reduced smollm-360m config, dedicates parameters, trains with
owner-centric DMuon (or a registered optimizer variant) and prints the loss
curve.  Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import gc
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import api  # noqa: E402  (the drop-in module)
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variant", default="muon",
                    choices=sorted(api.VARIANTS),
                    help="optimizer variant (see the registry in core/api.py)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pipeline", default="fused",
                    choices=["fused", "bucketed"],
                    help="optimizer-step schedule (core/pipeline.py)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: CUDA)")
    args = ap.parse_args()

    cfg = configs.get("smollm-360m", reduced=True)
    shapes = transformer.init(cfg, device="meta")

    # --- the paper's three lines -----------------------------------------
    plan = api.dedicate_params(shapes)                      # 1. dedicate
    opt = api.Muon(plan, config=MuonConfig(                 # 2. construct
        learning_rate=0.02, momentum=0.95, variant=args.variant,
        pipeline=args.pipeline), device=args.device)
    state = init_state(cfg, opt, seed=0, device=args.device)  # 3. init
    # ----------------------------------------------------------------------

    print(f"variant: {args.variant} — {opt.variant.description}")
    print(f"matrices under Muon: {plan.stats['num_matrices']} in "
          f"{plan.stats['num_groups']} groups; "
          f"{plan.stats['num_adamw_leaves']} AdamW leaves")

    step = make_train_step(cfg, opt, device=args.device)
    # Everything alive now lives for the whole run; exempt it from Python's
    # cyclic GC, whose full collections would otherwise scan torch's
    # ~240,000 module objects and stall the host for 100 ms or more.
    gc.collect()
    gc.freeze()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    for i in range(args.steps):
        state = step(state, batch_for_step(dcfg, i, device=args.device))
        if i % 5 == 4:
            print(f"step {state.step:3d}  loss_ema "
                  f"{float(state.loss_ema):.4f}")
    print("done.")


if __name__ == "__main__":
    main()
