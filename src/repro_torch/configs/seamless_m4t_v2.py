"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
(arXiv:2308.11596); port of ``repro.configs.seamless_m4t_v2``.

24L d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.
The audio frontend is a stub: callers pass precomputed frame embeddings
(B, S_enc, 1024).  Enc-dec: 24 encoder + 24 decoder layers.  Full
attention ⇒ long_500k skipped.
"""

from repro_torch.models.transformer import ArchConfig

ARCH_ID = "seamless-m4t-large-v2"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, head_dim=64,
        encdec=True, n_enc_layers=24,
        frontend="frame", frontend_dim=1024, frontend_len=4096,
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=257, head_dim=16,
        encdec=True, n_enc_layers=2,
        frontend="frame", frontend_dim=32, frontend_len=8,
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
