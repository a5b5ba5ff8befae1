"""llava-next-mistral-7b [vlm] — anyres tiling, mistral backbone
(hf:llava-hf/llava-v1.6-mistral-7b-hf); port of
``repro.configs.llava_next_mistral_7b``.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision frontend is a stub: callers pass precomputed patch embeddings
(B, 2880, 1024) — anyres 4 tiles + base image × 576 CLIP-L patches —
projected by the 2-layer MLP connector.  Full attention ⇒ long_500k
skipped.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "llava-next-mistral-7b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        frontend="patch", frontend_dim=1024, frontend_len=2880,
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=257, head_dim=16,
        frontend="patch", frontend_dim=32, frontend_len=8,
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
