"""Architecture registry of the port (port of ``repro.configs``).  Holds the
ported architectures only; the reference's other nine wait for ROADMAP
item 9.

Usage:  cfg = configs.get("smollm-360m")                 # full width
        cfg = configs.get("smollm-360m", reduced=True)   # CPU tests
"""

from repro_torch.configs import smollm_360m

_MODULES = (smollm_360m,)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get(arch_id: str, reduced: bool = False, **overrides):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    m = REGISTRY[arch_id]
    return (m.reduced if reduced else m.config)(**overrides)
