"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config); port of
``repro.configs.kimi_k2_1t``.

61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840,
MoE 384 routed top-8 + 1 shared.  Largest shape census → the primary MILP
load-balance stress case.  Full attention ⇒ long_500k skipped.
ZeRO-3 params + bf16 master/momentum required to fit 16 GB/chip.
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=128,
        moe=MoEConfig(d_model=7168, d_expert=2048, n_experts=384, top_k=8,
                      n_shared=1),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=257, head_dim=16,
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=4, top_k=2,
                      n_shared=1, capacity_factor=4.0),
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
