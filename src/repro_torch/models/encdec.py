"""Encoder-decoder backbone, seamless-m4t style (port of
``repro.models.encdec``; the audio frontend is a stub).

The encoder projects precomputed frame embeddings (B, S_enc, frontend_dim)
to d_model and runs non-causal self-attention blocks, with rope (the
reference's ``attention`` applies rope to every self attention).  Decoder
blocks are causal self-attention, cross-attention over the encoder output
(queries from the decoder, keys and values from ``enc_out``, no rope, no
mask) and an MLP.  ``init`` / ``forward`` / ``init_cache`` / ``prefill`` /
``decode_step`` mirror ``transformer.py``; the stacked ``enc_blocks`` /
``dec_blocks`` are unbound once per call.  The decode cache holds the
self-attention ``k`` / ``v`` (L, B, S_max, KV, hd) and the cross K / V
``cross_k`` / ``cross_v`` (L, B, S_enc, KV, hd), computed once at prefill
in the cache dtype.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, as_dtype, resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import AttnConfig
from repro_torch.models.transformer import (  # noqa: F401  (one crossing)
    ArchConfig, _check_family, _rope_for, apply_layer, frontend,
    frontend_init, params_from_numpy, params_to_numpy, unbound_layers)
from repro_torch.models.transformer import _embed, _last_logits, _split

Params = Dict[str, Any]


def _enc_attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      causal=False, rope_theta=cfg.rope_theta)


def _check(cfg: ArchConfig) -> None:
    _check_family(cfg)
    if not cfg.encdec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder: use "
                         "models.transformer (models.model_fns)")


def init(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random parameters as ``transformer.init`` draws them (shapes, paths
    and dtypes of the reference's ``encdec.init``)."""
    _check(cfg)
    device = resolve_device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device).manual_seed(seed)
    kw = dict(dtype=as_dtype(cfg.param_dtype), device=device)
    d, n_enc, L = cfg.d_model, cfg.n_enc_layers or cfg.n_layers, cfg.n_layers

    def block(n: int, cross: bool) -> Params:
        b = {"attn_norm": layers.rmsnorm_init(d, lead=(n,), **kw),
             "attn": layers.attention_init(
                 gen, _enc_attn_cfg(cfg) if not cross else cfg.attn_cfg(),
                 lead=(n,), **kw),
             "mlp_norm": layers.rmsnorm_init(d, lead=(n,), **kw),
             "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.act, lead=(n,),
                                    **kw)}
        if cross:
            b["cross_norm"] = layers.rmsnorm_init(d, lead=(n,), **kw)
            b["cross_attn"] = layers.attention_init(gen, _enc_attn_cfg(cfg),
                                                    lead=(n,), **kw)
        return b

    return {"frontend_proj": frontend_init(gen, cfg, kw),
            "embed": layers.embed_init(gen, cfg.vocab, d, **kw),
            "enc_blocks": block(n_enc, cross=False),
            "dec_blocks": block(L, cross=True),
            "enc_norm": layers.rmsnorm_init(d, **kw),
            "final_norm": layers.rmsnorm_init(d, **kw),
            "lm_head": layers.embed_init(gen, cfg.vocab, d, **kw)}


def _enc_block(cfg: ArchConfig, bp: Params, h: torch.Tensor, rope_cs,
               tp=None):
    a = layers.rmsnorm(bp["attn_norm"], h, cfg.norm_eps)
    h = h + layers.attention(bp["attn"], _enc_attn_cfg(cfg), a,
                             rope_cs=rope_cs, tp=tp)
    m = layers.rmsnorm(bp["mlp_norm"], h, cfg.norm_eps)
    return h + layers.mlp(bp["mlp"], m, cfg.act, tp=_split(tp, cfg.d_ff))


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor,
           tp=None) -> torch.Tensor:
    """frames: (B, S_enc, frontend_dim) -> (B, S_enc, d_model).  ``tp``:
    ``forward``'s (training only)."""
    _check(cfg)
    x = frontend(params["frontend_proj"],
                 frames.to(as_dtype(cfg.compute_dtype)),
                 tp=_split(tp, cfg.d_model))
    rope_cs = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    for bp in unbound_layers(params["enc_blocks"]):
        body = functools.partial(_enc_block, cfg, bp, rope_cs=rope_cs, tp=tp)
        x = apply_layer(body, x, remat=cfg.remat)
    return layers.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_block(cfg: ArchConfig, bp: Params, h: torch.Tensor,
               enc_out: Optional[torch.Tensor], rope_cs, *, self_cache=None,
               cross_cache=None, pos=None, tp=None):
    """Decoder block over ``enc_out``, or over the precomputed
    ``cross_cache`` with the self-attention ``self_cache`` written at
    ``pos`` (then returns (h, self_cache)).  ``tp``: the training path's
    model axis (no cache)."""
    a = layers.rmsnorm(bp["attn_norm"], h, cfg.norm_eps)
    if self_cache is None:
        h = h + layers.attention(bp["attn"], cfg.attn_cfg(), a,
                                 rope_cs=rope_cs, tp=tp)
    else:
        out, self_cache = layers.attention(bp["attn"], cfg.attn_cfg(), a,
                                           cache=self_cache, pos=pos,
                                           rope_cs=rope_cs)
        h = h + out
    c = layers.rmsnorm(bp["cross_norm"], h, cfg.norm_eps)
    if cross_cache is None:
        h = h + layers.attention(bp["cross_attn"], _enc_attn_cfg(cfg), c,
                                 xk=enc_out, tp=tp)
    else:
        h = h + layers.attention(bp["cross_attn"], _enc_attn_cfg(cfg), c,
                                 cache=cross_cache, static_cache=True)[0]
    m = layers.rmsnorm(bp["mlp_norm"], h, cfg.norm_eps)
    h = h + layers.mlp(bp["mlp"], m, cfg.act, tp=_split(tp, cfg.d_ff))
    return h if self_cache is None else (h, self_cache)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            frames: torch.Tensor, patches: Optional[torch.Tensor] = None,
            tp=None) -> torch.Tensor:
    """Training: frames (B, S_enc, F) + decoder tokens (B, S_dec) ->
    (B, S_dec, vocab) fp32 logits.

    ``tp`` (a ``models.tp.ModelParallel``): the tensor-parallel forward,
    ``params`` this rank's parts as ``models.sharding.param_specs`` places
    them and the activations between blocks (the encoder's output too)
    replicated over the model axis: the frontend, every attention (the
    encoder's non-causal self attention, the decoder's causal one, the
    cross attention: q from the decoder, k / v from the replicated
    ``enc_out``) and MLP as ``transformer.forward``'s; the embedding and
    the head vocab-parallel where the vocabulary divides the axis (the
    logits then this rank's (B, S_dec, V/tp) columns), whole otherwise."""
    vocab_tp = _split(tp, cfg.vocab)
    enc_out = encode(cfg, params, frames, tp)
    x = layers.embed(params["embed"], tokens, tp=vocab_tp).to(
        as_dtype(cfg.compute_dtype))
    rope_cs = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    for bp in unbound_layers(params["dec_blocks"]):
        body = functools.partial(_dec_block, cfg, bp, rope_cs=rope_cs, tp=tp)
        x = apply_layer(body, x, enc_out, remat=cfg.remat)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["lm_head"], x, tp=vocab_tp)


# ------------------------------------------------------------ serving paths

def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None):
    """Zeroed decode cache (module docstring) on ``device`` (CUDA unless
    given; ``"meta"`` builds shapes only)."""
    _check(cfg)
    device = resolve_device(device)
    kw = dict(dtype=as_dtype(dtype), device=device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((L, batch, max_len, KV, hd), **kw),
            "v": torch.zeros((L, batch, max_len, KV, hd), **kw),
            "cross_k": torch.zeros((L, batch, enc_len, KV, hd), **kw),
            "cross_v": torch.zeros((L, batch, enc_len, KV, hd), **kw)}


def _dec_scan(cfg: ArchConfig, params: Params, x: torch.Tensor, cache, *,
              pos, positions: torch.Tensor):
    """The decoder blocks over the cache, each layer on its own views."""
    rope_cs = _rope_for(cfg, positions)
    views = [cache[k].unbind(0) for k in ("k", "v", "cross_k", "cross_v")]
    for l, bp in enumerate(unbound_layers(params["dec_blocks"])):
        kc, vc, ck, cv = (v[l] for v in views)
        x, _ = _dec_block(cfg, bp, x, None, rope_cs, self_cache=(kc, vc),
                          cross_cache=(ck, cv), pos=pos)
    return x, cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            frames: torch.Tensor, max_len: int, cache_dtype=torch.bfloat16):
    """Encode the frames, compute every layer's cross K / V once (in the
    cache dtype) and consume the decoder prompt: (last-token logits, cache)."""
    B, S = tokens.shape
    enc_out = encode(cfg, params, frames)
    cache = init_cache(cfg, B, max_len, enc_out.shape[1], cache_dtype,
                       device=enc_out.device)
    acfg = _enc_attn_cfg(cfg)
    ck, cv = cache["cross_k"].unbind(0), cache["cross_v"].unbind(0)
    for l, bp in enumerate(unbound_layers(params["dec_blocks"])):
        shape = (B, -1, acfg.n_kv_heads, acfg.head_dim)
        ck[l].copy_(layers.linear(bp["cross_attn"]["k_proj"], enc_out)
                    .reshape(shape))
        cv[l].copy_(layers.linear(bp["cross_attn"]["v_proj"], enc_out)
                    .reshape(shape))
    x = _embed(cfg, params, tokens)
    x, cache = _dec_scan(cfg, params, x, cache, pos=0,
                         positions=torch.arange(S, device=x.device))
    return _last_logits(cfg, params, x), cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor, cache,
                pos, block_tables=None):
    """pos: a scalar shared position, or a (B,) tensor of per-slot
    positions (continuous batching: the self-attention rows advance
    independently).  The paged cache covers decoder-only families."""
    if block_tables is not None:
        raise NotImplementedError(
            "paged slots cover decoder-only families; enc-dec keeps the "
            "contiguous SlotManager")
    x = _embed(cfg, params, token[:, None])
    x, cache = _dec_scan(cfg, params, x, cache, pos=pos,
                         positions=layers._query_positions(pos, 1, x.device))
    return _last_logits(cfg, params, x), cache
