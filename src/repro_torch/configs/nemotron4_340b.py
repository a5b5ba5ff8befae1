"""nemotron-4-340b [dense] — GQA + squared-ReLU MLP (arXiv:2402.16819);
port of ``repro.configs.nemotron4_340b``.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Full attention ⇒ long_500k skipped.  ZeRO-3 parameter sharding + bf16 states
required at 256–512 chips.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "nemotron-4-340b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_ff=73728, vocab=256000, head_dim=192,
        act="squared_relu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab=257, head_dim=24, act="squared_relu",
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
