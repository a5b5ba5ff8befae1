"""qwen2.5-14b [dense] — GQA with QKV bias (Qwen2.5 technical report); port
of ``repro.configs.qwen2p5_14b``.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
Full attention ⇒ long_500k skipped.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "qwen2.5-14b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=257, head_dim=16, qkv_bias=True,
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
