"""Model zoo (port of ``repro.models``): the decoder backbone of the dense
and MoE families."""

from repro_torch.models.transformer import ArchConfig  # noqa: F401


def model_fns(cfg):
    """The backbone module for ``cfg`` (init / forward)."""
    from repro_torch.models import transformer
    return transformer
