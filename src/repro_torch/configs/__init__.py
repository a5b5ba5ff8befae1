"""Architecture registry of the port (port of ``repro.configs``): the 10
architectures of the reference, in its order — dense, MoE, hybrid (hymba),
ssm (xlstm), encoder-decoder (seamless) and vlm (llava).

Usage:  cfg = configs.get("deepseek-v3-671b")                # full width
        cfg = configs.get("deepseek-v3-671b", reduced=True)  # CPU tests
"""

from repro_torch.configs import (deepseek_v3_671b, hymba_1p5b, kimi_k2_1t,
                                 llava_next_mistral_7b, nemotron4_340b,
                                 qwen2p5_14b, seamless_m4t_v2, smollm_360m,
                                 stablelm_1p6b, xlstm_350m)

_MODULES = (hymba_1p5b, qwen2p5_14b, nemotron4_340b, smollm_360m,
            stablelm_1p6b, deepseek_v3_671b, kimi_k2_1t, xlstm_350m,
            seamless_m4t_v2, llava_next_mistral_7b)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get(arch_id: str, reduced: bool = False, **overrides):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    m = REGISTRY[arch_id]
    return (m.reduced if reduced else m.config)(**overrides)
