"""Serving-step functions (port of ``repro.train.serve``): prefill, chunked
prefill and decode over the decode cache of ``models.model_fns(cfg)``, and
the cache's shapes without allocation.

The reference's ``cache_shardings`` places the cache on a mesh; the port
serves on one card (a sharded forward is ROADMAP item 6), and its shape
rules are ``models.sharding.cache_specs``.
"""

from __future__ import annotations

import torch

from repro_torch.models import model_fns


def prefill_fn(cfg, params, tokens, max_len: int, *,
               cache_dtype=torch.bfloat16, **kwargs):
    """Prefill of ``tokens`` (B, S) into a fresh cache of ``max_len``
    positions: (last-token logits, cache).  ``frames`` (enc-dec, audio
    frontend) or ``patches`` (VLM) as keywords."""
    m = model_fns(cfg)
    if cfg.encdec:
        return m.prefill(cfg, params, tokens, frames=kwargs["frames"],
                         max_len=max_len, cache_dtype=cache_dtype)
    if cfg.family == "ssm":
        return m.prefill(cfg, params, tokens, max_len)
    return m.prefill(cfg, params, tokens, max_len,
                     cache_dtype=cache_dtype, **kwargs)


def prefill_chunk_fn(cfg, params, tokens, cache, pos, block_tables=None):
    """Chunked-prefill continuation: write a prompt chunk at
    [pos, pos + S) of an existing cache (decoder-only, token-only).
    ``block_tables`` (1, W) writes the chunk straight into a paged pool
    cache through the request's block table (serve/paged.py)."""
    if cfg.encdec:
        raise NotImplementedError(
            "chunked prefill covers decoder-only families; enc-dec prompts "
            "prefill in one shot")
    return model_fns(cfg).prefill_chunk(cfg, params, tokens, cache, pos,
                                        block_tables=block_tables)


def decode_fn(cfg, params, token, cache, pos, block_tables=None):
    """One decode step; ``pos`` is a scalar, or a (B,) tensor of per-slot
    positions when driven by the continuous-batching scheduler.  With
    ``block_tables`` (B, W) the attention cache is the paged pool layout
    (serve/paged.py) instead of contiguous per-slot rows."""
    return model_fns(cfg).decode_step(cfg, params, token, cache, pos,
                                      block_tables=block_tables)


def make_cache_shapes(cfg, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16):
    """The decode cache as ``device="meta"`` tensors (shapes and dtypes,
    no allocation); enc-dec caches take ``enc_len = max_len``, as the
    reference's."""
    m = model_fns(cfg)
    if cfg.encdec:
        return m.init_cache(cfg, batch, max_len, max_len, cache_dtype,
                            device="meta")
    return m.init_cache(cfg, batch, max_len, cache_dtype, device="meta")
