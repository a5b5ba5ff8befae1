"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM); port of
``repro.configs.smollm_360m``.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.  Tied embeddings.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "smollm-360m"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab=49152, head_dim=64,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=257, head_dim=16, tie_embeddings=True,
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
