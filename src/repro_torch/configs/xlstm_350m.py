"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517); port of
``repro.configs.xlstm_350m``.

24L d_model=1024 4H d_ff=0 (block-internal ff_mult=2) vocab=50304.
Recurrent O(1) state ⇒ runs long_500k.  Layout: one sLSTM block every 8
(21 mLSTM + 3 sLSTM, the paper's [7:1]-style interleave).
"""

from repro_torch.models.transformer import ArchConfig
from repro_torch.models.xlstm import XLSTMConfig

ARCH_ID = "xlstm-350m"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        xlstm=XLSTMConfig(d_model=1024, n_heads=4, slstm_every=8,
                          ff_mult=2.0),
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="ssm",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=257,
        xlstm=XLSTMConfig(d_model=64, n_heads=4, slstm_every=4,
                          ff_mult=2.0),
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
