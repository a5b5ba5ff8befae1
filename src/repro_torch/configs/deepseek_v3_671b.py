"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8
(arXiv:2412.19437); port of ``repro.configs.deepseek_v3_671b``.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
Deviations from the paper: all 61 layers MoE (paper: first 3 dense);
MTP auxiliary head omitted (training-objective feature, orthogonal to the
optimizer-systems reproduction); sort-based token-choice dispatch (moe.py).
Full attention ⇒ long_500k skipped.  ZeRO-3 + bf16 states at mesh scale.
"""

from repro_torch.models.layers import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ArchConfig

ARCH_ID = "deepseek-v3-671b"


def config(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID, family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab=129280,
        attn_kind="mla",
        mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(d_model=7168, d_expert=2048, n_experts=256, top_k=8,
                      n_shared=1),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(overrides)
    return ArchConfig(**base)


def reduced(**overrides) -> ArchConfig:
    base = dict(
        name=ARCH_ID + "-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=257,
        attn_kind="mla",
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32,
                      kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=4, top_k=2,
                      n_shared=1, capacity_factor=4.0),
        remat=False,
    )
    base.update(overrides)
    return ArchConfig(**base)
