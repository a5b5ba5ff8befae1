"""Assigned input shapes and per-(arch × shape) input specs (port of
``repro.configs.shapes``, ``src/repro/configs/shapes.py``).

LM transformer shapes are seq_len × global_batch:
    train_4k     seq 4,096   gb 256   (training)        -> train_step
    prefill_32k  seq 32,768  gb 32    (inference)       -> serve prefill
    decode_32k   seq 32,768  gb 128   (inference)       -> serve decode (1 new
                                                           token, 32k KV cache)
    long_500k    seq 524,288 gb 1     (long-context)    -> decode; SSM/hybrid
                                                           only (sub-quadratic
                                                           rule); skips noted

``input_specs`` returns ``device="meta"`` tensors (shapes and dtypes, no
allocation) for every model input of the given (arch, shape): the dry
run's counterpart of the reference's ``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import as_dtype
from repro_torch.models.transformer import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> Optional[str]:
    """None if (arch, shape) runs; otherwise the skip reason (recorded).
    Reference: ``src/repro/configs/shapes.py:44``."""
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return "full-attention arch: long_500k skipped per assignment rule"
    return None


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape) -> Dict[str, torch.Tensor]:
    """Model inputs for the step function of this (arch, shape) cell, as
    meta tensors: int32 tokens, ``cfg.compute_dtype`` patches and frames,
    the decode cell's ``token`` (B,) and 0-d ``pos``.  Reference:
    ``src/repro/configs/shapes.py:55``.  ``shape``: a name of ``SHAPES``
    or a ``ShapeSpec`` of other sizes."""
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    tok = torch.int32
    emb = as_dtype(cfg.compute_dtype)

    if sp.kind == "train":
        specs = {"tokens": _sd((B, S), tok), "labels": _sd((B, S), tok)}
        if cfg.frontend == "patch":
            specs["patches"] = _sd((B, cfg.frontend_len, cfg.frontend_dim), emb)
        if cfg.frontend == "frame" or cfg.encdec:
            specs["frames"] = _sd((B, cfg.frontend_len, cfg.frontend_dim), emb)
        return specs

    if sp.kind == "prefill":
        specs = {"tokens": _sd((B, S), tok)}
        if cfg.frontend == "patch":
            specs["patches"] = _sd((B, cfg.frontend_len, cfg.frontend_dim), emb)
        if cfg.encdec:
            specs["frames"] = _sd((B, S, cfg.frontend_dim), emb)
        return specs

    # decode: one new token against a seq_len-deep cache
    return {"token": _sd((B,), tok), "pos": _sd((), torch.int32)}
