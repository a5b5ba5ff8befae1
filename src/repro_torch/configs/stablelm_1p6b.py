"""stablelm-1.6b [dense] — MHA (kv = heads) (hf:stabilityai/stablelm-2-1_6b);
port of ``repro.configs.stablelm_1p6b``.

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
Full attention ⇒ long_500k skipped.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "stablelm-1.6b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, head_dim=64,
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=257, head_dim=16,
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
