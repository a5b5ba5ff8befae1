"""hymba-1.5b [hybrid] — parallel attention ‖ mamba heads (arXiv:2411.13676);
port of ``repro.configs.hymba_1p5b``.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention everywhere except 3 global-attention layers
(first/middle/last, per the Hymba paper) → sub-quadratic ⇒ runs long_500k.
"""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ArchConfig

ARCH_ID = "hymba-1.5b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64,
        sliding_window=1024, global_layers=(0, 15, 31),
        ssm=SSMConfig(d_model=1600, d_state=16, expand=2),
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=257, head_dim=16,
        sliding_window=8, global_layers=(0, 3),
        ssm=SSMConfig(d_model=64, d_state=4, expand=2),
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
