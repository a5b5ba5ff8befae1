"""Architecture registry of the port (port of ``repro.configs``).  Holds the
ported architectures: the dense and MoE families.  The reference's hybrid
(hymba), ssm (xlstm), encoder-decoder (seamless) and vlm (llava) configs
wait for ROADMAP item 9.

Usage:  cfg = configs.get("deepseek-v3-671b")                # full width
        cfg = configs.get("deepseek-v3-671b", reduced=True)  # CPU tests
"""

from repro_torch.configs import (deepseek_v3_671b, kimi_k2_1t,
                                 nemotron4_340b, qwen2p5_14b, smollm_360m,
                                 stablelm_1p6b)

_MODULES = (qwen2p5_14b, nemotron4_340b, smollm_360m, stablelm_1p6b,
            deepseek_v3_671b, kimi_k2_1t)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get(arch_id: str, reduced: bool = False, **overrides):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    m = REGISTRY[arch_id]
    return (m.reduced if reduced else m.config)(**overrides)
