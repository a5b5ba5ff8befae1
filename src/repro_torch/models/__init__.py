"""Model zoo (port of ``repro.models``): the decoder backbone
(``transformer.py``: dense, MoE, hybrid, xLSTM and VLM families) and the
encoder-decoder (``encdec.py``)."""

from repro_torch.models.transformer import ArchConfig  # noqa: F401


def model_fns(cfg):
    """The backbone module for ``cfg`` (init / forward): ``encdec`` for an
    encoder-decoder config, ``transformer`` otherwise."""
    if cfg.encdec:
        from repro_torch.models import encdec
        return encdec
    from repro_torch.models import transformer
    return transformer
