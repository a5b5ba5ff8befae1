"""Decoder-LM backbone (port of ``repro.models.transformer``):
``ArchConfig``, ``init``, ``forward`` and the serving entry points
``init_cache``, ``prefill``, ``prefill_chunk`` and ``decode_step``.

  dense   — GQA/MHA attention + MLP (swiglu or squared-relu, optional biases)
  moe     — attention (MLA for deepseek) + MoE FFN with shared experts
  hybrid  — hymba: attention ‖ Mamba SSM on the same normed input, mixed by
            ``mix_scale``; sliding-window attention except on
            ``global_layers``
  ssm     — xlstm: mLSTM blocks with an sLSTM block every ``slstm_every``
            (own layer loop, ``_xlstm_forward``)
  vlm     — dense backbone over [projected patches ; token embeddings],
            logits of the token positions only
  audio   — the encoder-decoder, ``models/encdec.py`` (``model_fns``)

Parameters are a nested dict of tensors laid out as the reference's pytree:
per-layer leaves stacked ``(L, ...)`` under ``blocks`` (``mlstm_blocks`` /
``slstm_blocks`` for xlstm; MoE experts ``(L, E, m, n)``), linear weights
``(in, out)``.  The reference's ``lax.scan`` over the stacked blocks is a
Python loop over the layers, each stacked leaf cut into its L layers once
per forward (``unbind``: its backward stacks the L gradients once, where
indexing ``w[l]`` per layer would zero-fill a full-size gradient of every
leaf L times); its ``jax.checkpoint`` is ``torch.utils.checkpoint``
(non-reentrant).

The decode cache is a dict of stacked (L, B, ...) leaves, batch on axis 1:
``k`` / ``v`` (L, B, S_max, KV, hd), or MLA's ``ckv`` (L, B, S_max, r) and
``krope`` (L, B, S_max, 1, rd); hybrid adds the SSM's ``conv``
(L, B, K-1, d_inner) and ``ssm_h`` (L, B, d_inner, d_state); xlstm holds
``mlstm`` (C, n, m) and ``slstm`` (c, n, h, m) tuples of (n, B, ...)
leaves.  The paged cache (``init_paged_cache``) keeps the attention
leaves as (L, P, bs, ...) block pools shared by every slot and read
through per-slot block tables (``block_tables=``); the recurrent leaves
stay (L, B, ...).  The serving entry points run under
``torch.inference_mode``, loop over the layers once with a per-layer view
of every leaf, write the cache in place and return it (the reference
donates it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree
from repro_torch.device import DeviceLike, as_dtype, resolve_device
from repro_torch.models import layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.models import tp as tp_lib, xlstm as xlstm_lib
from repro_torch.models.layers import AttnConfig, MLAConfig

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    act: str = "swiglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # attention variants
    attn_kind: str = "gqa"          # gqa | mla
    mla: Optional[MLAConfig] = None
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()   # hymba: full-attn layer indices
    # moe
    moe: Optional[moe_lib.MoEConfig] = None
    # ssm / hybrid
    ssm: Optional[ssm_lib.SSMConfig] = None
    # xlstm
    xlstm: Optional[xlstm_lib.XLSTMConfig] = None
    # multimodal stub frontend
    frontend: Optional[str] = None  # 'patch' | 'frame'
    frontend_dim: int = 1024
    frontend_len: int = 576
    # encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    # the reference's GSPMD activation pins
    # (``src/repro/models/transformer.py:70-76``): the batch axes pinned at
    # every block boundary, and the sequence-sharded attention axis.  The
    # port's tensor-parallel forward (``forward(..., tp=...)``) decides its
    # layout from the head counts and reads neither.
    act_batch_axes: Optional[Tuple[str, ...]] = None
    act_seq_axis: Optional[str] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, qkv_bias=self.qkv_bias,
                          rope_theta=self.rope_theta,
                          sliding_window=self.sliding_window,
                          batch_axes=self.act_batch_axes,
                          seq_axis=self.act_seq_axis)

    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (the reference's rule)."""
        return self.family in ("ssm",) or (
            self.family == "hybrid" and self.sliding_window is not None)

    def param_count(self) -> int:
        """Total parameters of ``model_fns(self).init``, from shapes alone
        (meta tensors).  For the encoder-decoder that is ``encdec.init``:
        the reference's ``param_count`` always counts ``transformer.init``,
        which leaves out the encoder and the cross-attention."""
        from repro_torch.models import model_fns
        params = model_fns(self).init(self, device="meta")
        return int(sum(math.prod(v.shape) for _, v in tree.flatten(params)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        n = self.param_count()
        if self.moe is None:
            return n
        c = self.moe
        per_expert = 3 * c.d_model * c.d_expert
        inactive = (c.n_experts - c.top_k) * per_expert * self.n_layers
        return n - inactive


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the reference's "
                         f"are {FAMILIES}")


def _check_decoder(cfg: ArchConfig) -> None:
    _check_family(cfg)
    if cfg.encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: use "
                         "models.encdec (models.model_fns)")


def init(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (JAX's PRNG is not reproduced; ``params_from_numpy`` carries the
    reference's init over instead).  ``device="meta"`` builds shapes only."""
    _check_decoder(cfg)
    device = resolve_device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device).manual_seed(seed)
    dt = as_dtype(cfg.param_dtype)
    L, d = cfg.n_layers, cfg.d_model
    kw = dict(dtype=dt, device=device)
    p: Params = {"embed": layers.embed_init(gen, cfg.vocab, d, **kw),
                 "final_norm": layers.rmsnorm_init(d, **kw)}
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.embed_init(gen, cfg.vocab, d, **kw)
    if cfg.family == "ssm":
        n_s = L // cfg.xlstm.slstm_every
        p["mlstm_blocks"] = _xlstm_block_init(cfg, gen, "mlstm", L - n_s, kw)
        if n_s:
            p["slstm_blocks"] = _xlstm_block_init(cfg, gen, "slstm", n_s, kw)
    else:
        p["blocks"] = _block_init(cfg, gen, kw)
    if cfg.frontend is not None:
        p["frontend_proj"] = frontend_init(gen, cfg, kw)
    return p


def _block_init(cfg: ArchConfig, gen, kw) -> Params:
    L, d = cfg.n_layers, cfg.d_model
    blocks = {"attn_norm": layers.rmsnorm_init(d, lead=(L,), **kw),
              "mlp_norm": layers.rmsnorm_init(d, lead=(L,), **kw)}
    if cfg.attn_kind == "mla":
        blocks["attn"] = layers.mla_init(gen, cfg.mla, lead=(L,), **kw)
    else:
        blocks["attn"] = layers.attention_init(gen, cfg.attn_cfg(),
                                               lead=(L,), **kw)
    if cfg.family == "hybrid":
        blocks["ssm"] = ssm_lib.ssm_init(gen, cfg.ssm, lead=(L,), **kw)
        blocks["mix_scale"] = torch.ones((L, 2), **kw)  # attn / ssm balance
    if cfg.moe is not None:
        blocks["moe"] = moe_lib.moe_init(gen, cfg.moe, lead=(L,), **kw)
    else:
        blocks["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, cfg.act,
                                        lead=(L,), **kw)
    return blocks


def _xlstm_block_init(cfg: ArchConfig, gen, kind: str, n: int,
                      kw) -> Params:
    xc, d = cfg.xlstm, cfg.d_model
    core = (xlstm_lib.mlstm_init if kind == "mlstm" else
            xlstm_lib.slstm_init)(gen, xc, lead=(n,), **kw)
    return {"attn_norm": layers.rmsnorm_init(d, lead=(n,), **kw),
            "core": core,
            "mlp_norm": layers.rmsnorm_init(d, lead=(n,), **kw),
            "mlp": layers.mlp_init(gen, d, int(xc.ff_mult * d), "gelu",
                                   lead=(n,), **kw)}


def frontend_init(gen, cfg: ArchConfig, kw) -> Params:
    """The 2-layer connector of the stub frontends (patches or frames)."""
    return {"fc1": layers.linear_init(gen, cfg.frontend_dim, cfg.d_model,
                                      **kw),
            "fc2": layers.linear_init(gen, cfg.d_model, cfg.d_model, **kw)}


def frontend(p: Params, emb: torch.Tensor, tp=None) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(emb))): patch or frame embeddings to d_model.
    With ``tp`` (where ``param_specs`` splits d_model over the model axis)
    ``fc1`` is column-parallel and ``fc2`` row-parallel: this rank's
    d_model / tp hidden columns, one reduction of the (B, P, d) output."""
    if tp is not None:
        return tp_lib.reduce_from_model(
            frontend(p, tp_lib.copy_to_model(emb, tp)), tp)
    return layers.linear(p["fc2"], F.gelu(layers.linear(p["fc1"], emb),
                                          approximate="tanh"))


def _block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, rope_cs,
                 global_layer: bool = False, *, cache=None, ssm_state=None,
                 pos=None, block_table=None, tp=None, dp=None,
                 cache_rows=None):
    """Residual block; ``global_layer`` drops the sliding window (hymba's
    ``global_layers``, the reference's per-layer window flag).  With this
    layer's ``cache`` (and hybrid's ``ssm_state``) written at ``pos``
    (through ``block_table`` for a paged cache), returns
    (x, cache, new_ssm_state); x alone otherwise.  With ``tp`` (the
    training path; serving: the dense and MoE families) the block's leaves
    are this rank's parts and ``x`` is replicated over the model axis: the
    attention (GQA or MLA), the hybrid's SSM (``ssm._ssm_tp``) and the MLP
    or MoE each reduce their row-parallel partial sums once, before the
    mix and the residual add (the hybrid's mix then is one card's:
    s[0]·attn + s[1]·ssm in fp32 from the two reduced outputs); a
    ``cache`` is then this rank's part
    (``cache_rows``: the rows it holds where it is split by sequence,
    ``layers.cache_row_range``).  ``dp``: the data axes the MoE dispatch
    ranks its tokens over (``moe.moe``)."""
    h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    kw = {} if cache is None else dict(cache=cache, pos=pos,
                                       block_table=block_table)
    if tp is not None:
        kw["tp"] = tp
        if cache is not None:
            kw["cache_rows"] = cache_rows
    if cfg.attn_kind == "mla":
        attn_out = layers.mla_attention(p["attn"], cfg.mla, h,
                                        rope_cs=rope_cs, **kw)
    else:
        acfg = cfg.attn_cfg()
        if global_layer:
            acfg = dataclasses.replace(acfg, sliding_window=None)
        attn_out = layers.attention(p["attn"], acfg, h, rope_cs=rope_cs,
                                    **kw)
    if cache is not None:
        attn_out, cache = attn_out
    if cfg.family == "hybrid":
        if cache is None:
            ssm_out = ssm_lib.ssm(p["ssm"], cfg.ssm, h, tp=tp)
        else:
            ssm_out, ssm_state = ssm_lib.ssm(p["ssm"], cfg.ssm, h,
                                             state=ssm_state)
        s = p["mix_scale"].float()
        attn_out = (s[0] * attn_out.float()
                    + s[1] * ssm_out.float()).to(x.dtype)
    x = x + attn_out
    h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    if cfg.moe is not None:
        x = x + moe_lib.moe(p["moe"], cfg.moe, h, tp=tp, dp=dp)
    else:
        x = x + layers.mlp(p["mlp"], h, cfg.act, tp=_split(tp, cfg.d_ff))
    return x if cache is None else (x, cache, ssm_state)


def _gathered_block(zero, cfg: ArchConfig, p: Params, x: torch.Tensor,
                    *args, **kwargs):
    """``_block_apply`` on this layer's ZeRO-3 parts gathered whole."""
    return _block_apply(cfg, tp_lib.gather_layer(p, zero), x, *args,
                        **kwargs)


def _split(tp, width: int):
    """``tp`` where ``param_specs`` splits a leaf of ``width`` over the
    model axis, else None (the leaf is whole on every rank)."""
    return tp if tp is not None and tp.divides(width) else None


def _serve_tp(cfg: ArchConfig, tp):
    """The serving entry points' model axis: ``tp`` where it has more than
    one rank (refused for a family that does not serve under a mesh,
    ``models.tp.serves_split``), else None, so a model axis of one rank
    runs the one-card code bitwise."""
    if tp is None or tp.size == 1:
        return None
    if not tp_lib.serves_split(cfg):
        raise NotImplementedError(
            f"serving the {cfg.family} family under a mesh is not ported "
            "(ROADMAP item 6, its serving half; the training half is "
            "ported): serve it on one card")
    return tp


def _xlstm_block(cfg: ArchConfig, p: Params, x: torch.Tensor, kind: str,
                 state=None, tp=None):
    """mLSTM or sLSTM block; with a carried ``state`` returns
    (x, new_state), x alone otherwise.  ``tp``: the training path's model
    axis (the leaves this rank's parts; the block MLP column / row
    parallel where its width divides the axis)."""
    h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    core = xlstm_lib.mlstm if kind == "mlstm" else xlstm_lib.slstm
    if state is None:
        out = core(p["core"], cfg.xlstm, h, tp=tp)
    else:
        out, state = core(p["core"], cfg.xlstm, h, state=state)
    x = x + out
    h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    x = x + layers.mlp(p["mlp"], h, "gelu",
                       tp=_split(tp, int(cfg.xlstm.ff_mult * cfg.d_model)))
    return x if state is None else (x, state)


def _rope_angles(hd: int, positions: torch.Tensor, theta: float):
    """cos / sin (..., hd/2) of ``positions`` (S,) or per-row (B, S),
    computed from the positions directly (no table)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rope_for(cfg: ArchConfig, positions: torch.Tensor):
    """Self-attention rope: q and k share the same positions."""
    hd = cfg.mla.qk_rope_dim if cfg.attn_kind == "mla" else cfg.hd
    cos, sin = _rope_angles(hd, positions, cfg.rope_theta)
    return (cos, sin, cos, sin)


def unbound_layers(stacked: Params) -> list:
    """Per-layer parameter trees of a stacked ``(L, ...)`` tree, each leaf
    unbound once (one stacking backward per leaf)."""
    paths, leaves = zip(*tree.flatten(stacked))
    per_layer = [leaf.unbind(0) for leaf in leaves]
    return [tree.rebuild(stacked, {p: w[l] for p, w in zip(paths, per_layer)})
            for l in range(len(per_layer[0]))]


def apply_layer(body, x: torch.Tensor, *args, remat: bool) -> torch.Tensor:
    """``body(x, *args)``, recomputed in the backward under ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(body, x, *args, use_reentrant=False)
    return body(x, *args)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, tp=None,
            dp=None, zero=None) -> torch.Tensor:
    """Training forward: (B, S) tokens -> (B, S, vocab) fp32 logits.  With
    a frontend, the projected ``patches`` (or ``frames``) (B, P, F) are
    prepended to the token embeddings, and the logits cover the S token
    positions only (the reference cuts its full-sequence logits to them;
    norm and head act per position, so the port cuts before them).

    ``tp`` (a ``models.tp.ModelParallel``; every decoder family): the
    tensor-parallel forward (``src/repro/models/transformer.py:310-335``
    under GSPMD; the MoE experts split over the axis).  ``params`` are
    this rank's parts as ``models.sharding.param_specs`` places them, the
    activations between blocks replicated over the model axis (the patch
    or frame prefix too, after the frontend's one reduction), and the
    logits this rank's (B, S, V/tp) vocab columns where the vocab divides
    the axis (whole otherwise).  Under ``remat`` the recompute issues each
    block's collectives again, in the same order (non-reentrant
    checkpointing).

    ``dp`` (a ``models.tp.DataParallel``): ``tokens`` are this rank's rows
    of a batch split over the data axes; the MoE dispatch ranks them over
    the global batch, as the reference's ``jit`` of the whole batch does.

    ``zero`` (a ``models.tp.ZeroShards``; ZeRO-3, with ``tp``): the block
    weights it names are also split over 'data'.  Each layer's parts are
    gathered whole inside the layer's body (``models.tp.gather_layer``),
    so under ``remat`` the whole weights are dropped after the layer's
    forward and gathered again in its backward, whose reduce-scatters
    then return each gradient to its part, layer by layer in the loop's
    order: at most one layer's weights are whole at a time (FSDP's
    schedule).  Without ``remat`` (the reduced configs) autograd keeps
    every layer's whole weights for the backward.  The embedding, the
    head and the norms are never split over 'data'.
    """
    _check_decoder(cfg)
    vocab_tp = _split(tp, cfg.vocab)
    x = _embed(cfg, params, tokens, patches if patches is not None
               else frames, tp=vocab_tp,
               frontend_tp=_split(tp, cfg.d_model))
    n_prefix = x.shape[1] - tokens.shape[1]
    if cfg.family == "ssm":
        x = _xlstm_forward(cfg, params, x, tp)
    else:
        rope_cs = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
        hybrid = cfg.family == "hybrid"
        block = _block_apply if zero is None else \
            functools.partial(_gathered_block, zero)
        for l, bp in enumerate(unbound_layers(params["blocks"])):
            body = functools.partial(
                block, cfg, bp, rope_cs=rope_cs,
                global_layer=hybrid and l in cfg.global_layers, tp=tp,
                dp=dp)
            x = apply_layer(body, x, remat=cfg.remat)
    x = layers.rmsnorm(params["final_norm"], x[:, n_prefix:], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return layers.unembed(head, x, tp=vocab_tp)


def _xlstm_forward(cfg: ArchConfig, params: Params, x: torch.Tensor,
                   tp=None) -> torch.Tensor:
    """Segments of ``slstm_every − 1`` mLSTM blocks, each followed by one
    sLSTM block, then any trailing mLSTM blocks; remat on the mLSTM blocks
    only, as in the reference.  ``tp``: ``forward``'s."""
    every = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // every
    mb = unbound_layers(params["mlstm_blocks"])
    sb = unbound_layers(params["slstm_blocks"]) if n_s else []

    def m_run(x, blocks):
        for bp in blocks:
            body = functools.partial(_xlstm_block, cfg, bp, kind="mlstm",
                                     tp=tp)
            x = apply_layer(body, x, remat=cfg.remat)
        return x

    seg = every - 1
    for s_i in range(n_s):
        x = m_run(x, mb[s_i * seg:(s_i + 1) * seg])
        x = _xlstm_block(cfg, sb[s_i], x, "slstm", tp=tp)
    return m_run(x, mb[n_s * seg:])


# ------------------------------------------------------------ serving paths

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None, *, tp=None):
    """Zeroed decode cache (module docstring) of ``batch`` rows of
    ``max_len`` positions on ``device`` (CUDA unless given; ``"meta"``
    builds shapes only).  The xLSTM memories and the SSM states are fp32
    whatever ``dtype``, as the reference's.

    ``tp`` (a ``models.tp.ModelParallel``; the dense and MoE families):
    this rank's part over the model axis as ``models.sharding.cache_specs``
    places it, the batch whole: the KV heads split where they divide the
    axis, else the sequence where ``max_len`` does
    (``layers.cache_row_range``), else the whole cache; MLA's latent and rope
    key by sequence, or whole."""
    _check_decoder(cfg)
    tp = _serve_tp(cfg, tp)
    kv_heads = cfg.n_kv_heads
    if tp is not None:
        rows = layers.cache_row_range(
            1 if cfg.attn_kind == "mla" else kv_heads, max_len, tp)
        if rows is not None:
            max_len = rows[1] - rows[0]
        elif cfg.attn_kind != "mla" and tp.divides(kv_heads):
            kv_heads //= tp.size
    device = resolve_device(device)
    dtype = as_dtype(dtype)
    L = cfg.n_layers
    zeros = functools.partial(torch.zeros, device=device)
    if cfg.family == "ssm":
        n_s = L // cfg.xlstm.slstm_every
        return {"mlstm": xlstm_lib.mlstm_init_state(cfg.xlstm, batch,
                                                    lead=(L - n_s,),
                                                    device=device),
                "slstm": xlstm_lib.slstm_init_state(cfg.xlstm, batch,
                                                    lead=(max(n_s, 1),),
                                                    device=device)}
    eff_len = max_len
    if cfg.sliding_window is not None and not cfg.global_layers:
        eff_len = min(max_len, cfg.sliding_window)
    cache: Dict[str, Any] = {}
    if cfg.attn_kind == "mla":
        cache["ckv"] = zeros((L, batch, eff_len, cfg.mla.kv_lora_rank),
                             dtype=dtype)
        cache["krope"] = zeros((L, batch, eff_len, 1, cfg.mla.qk_rope_dim),
                               dtype=dtype)
    else:
        kvshape = (L, batch, eff_len, kv_heads, cfg.hd)
        cache["k"] = zeros(kvshape, dtype=dtype)
        cache["v"] = zeros(kvshape, dtype=dtype)
    if cfg.family == "hybrid":
        cache["conv"], cache["ssm_h"] = ssm_lib.ssm_init_state(
            cfg.ssm, batch, lead=(L,), device=device)
    return cache


# cache leaves carrying a sequence axis: the ones the paged allocator
# (serve/paged.py) stores block-granular; the recurrent leaves (conv /
# ssm_h, the xLSTM memories) are O(1) per slot and stay batch-contiguous
PAGED_CACHE_KEYS = ("k", "v", "ckv", "krope")


def init_paged_cache(cfg: ArchConfig, batch: int, num_blocks: int,
                     block_size: int, dtype=torch.bfloat16,
                     device: DeviceLike = None):
    """Decode cache whose attention leaves are block pools
    (``repro.models.transformer.init_paged_cache``, transformer.py:370):
    (L, P, bs, ...) physical blocks shared by every slot through
    per-request block tables (serve/paged.py), on ``device`` (CUDA unless
    given).  Block 0 is the reserved null block: free slots' idle writes
    land there and no live table maps it, so callers size ``num_blocks``
    as ``pool_blocks + 1``.  Hybrid's ``conv`` / ``ssm_h`` keep
    ``init_cache``'s (L, batch, ...) layout.  Pure-recurrent families
    (ssm) have no sequence axis to page."""
    _check_decoder(cfg)
    if cfg.family == "ssm":
        raise ValueError("ssm caches are O(1) recurrent state — nothing to "
                         "page; use init_cache")
    if cfg.sliding_window is not None and not cfg.global_layers:
        # init_cache shrinks these to a rolling window buffer; paging a
        # rolling buffer would remap blocks every window step
        raise NotImplementedError(
            "paged cache does not cover rolling sliding-window buffers")
    device = resolve_device(device)
    dtype = as_dtype(dtype)
    L = cfg.n_layers
    zeros = functools.partial(torch.zeros, device=device, dtype=dtype)
    cache: Dict[str, Any] = {}
    if cfg.attn_kind == "mla":
        cache["ckv"] = zeros((L, num_blocks, block_size,
                              cfg.mla.kv_lora_rank))
        cache["krope"] = zeros((L, num_blocks, block_size, 1,
                                cfg.mla.qk_rope_dim))
    else:
        kvshape = (L, num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
        cache["k"] = zeros(kvshape)
        cache["v"] = zeros(kvshape)
    if cfg.family == "hybrid":
        cache["conv"], cache["ssm_h"] = ssm_lib.ssm_init_state(
            cfg.ssm, batch, lead=(L,), device=device)
    return cache


def _cache_scan(cfg: ArchConfig, params: Params, x: torch.Tensor, cache, *,
                pos, positions: torch.Tensor, block_tables=None, tp=None,
                dp=None, zero=None, max_len: Optional[int] = None):
    """The blocks over the decode cache, one layer at a time, each reading
    and writing its own view of every leaf: shared by prefill (pos 0),
    chunked prefill (a scalar offset) and decode (a scalar, or a (B,)
    tensor of per-slot positions).  ``block_tables`` (B, W) reads and
    writes the attention leaves as (L, P, bs, ...) pools, one table for
    every layer.  ``tp`` / ``dp`` / ``zero``: the mesh context of the
    serving entry points (``prefill``), the cache this rank's part of a
    ``max_len``-position cache (``init_cache(..., tp=...)``)."""
    rope_cs = _rope_for(cfg, positions)
    keys = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    kv = [cache[k].unbind(0) for k in keys]
    hybrid = cfg.family == "hybrid"
    if hybrid:
        conv, ssm_h = cache["conv"].unbind(0), cache["ssm_h"].unbind(0)
    mesh_kw = {}
    if tp is not None:
        mesh_kw = dict(tp=tp, cache_rows=layers.cache_row_range(
            1 if cfg.attn_kind == "mla" else cfg.n_kv_heads,
            _whole_len(cfg, kv[0][0], tp, max_len), tp))
    if dp is not None and cfg.moe is not None:
        mesh_kw["dp"] = dp
    block = _block_apply if zero is None else \
        functools.partial(_gathered_block, zero)
    for l, bp in enumerate(unbound_layers(params["blocks"])):
        state = (conv[l], ssm_h[l]) if hybrid else None
        x, _, state = block(
            cfg, bp, x, rope_cs,
            global_layer=hybrid and l in cfg.global_layers,
            cache=(kv[0][l], kv[1][l]), ssm_state=state, pos=pos,
            block_table=block_tables, **mesh_kw)
        if hybrid:
            conv[l].copy_(state[0])
            ssm_h[l].copy_(state[1])
    return x, cache


def _whole_len(cfg: ArchConfig, leaf: torch.Tensor, tp,
               max_len: Optional[int]) -> int:
    """The positions of the whole cache of which ``leaf`` (one layer's
    (B, rows, ...) attention leaf) is this rank's part.  A GQA cache whose
    KV heads split holds every row; otherwise its rows alone cannot tell a
    sequence split from a whole cache, so the caller names ``max_len``."""
    if cfg.attn_kind != "mla" and tp.divides(cfg.n_kv_heads):
        return leaf.shape[1]
    if max_len is None:
        raise ValueError("a tensor-parallel cache split by sequence or "
                         "whole needs its max_len")
    return max_len


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
           prefix: Optional[torch.Tensor] = None, tp=None,
           frontend_tp=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, after the projected frontend
    ``prefix`` (patches or frames) where given; with ``tp``, from this
    rank's vocab rows (``layers.embed``); with ``frontend_tp``, the
    frontend split (``frontend``)."""
    x = layers.embed(params["embed"], tokens, tp=tp).to(
        as_dtype(cfg.compute_dtype))
    if cfg.frontend is not None and prefix is not None:
        pe = frontend(params["frontend_proj"], prefix.to(x.dtype),
                      tp=frontend_tp)
        x = torch.cat([pe, x], dim=1)
    return x


def _last_logits(cfg: ArchConfig, params: Params, x: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """fp32 logits (B, vocab) of the last position; with ``tp`` (the vocab
    split over the model axis) each rank's columns gathered whole, so every
    rank samples the same token."""
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    vocab_tp = _split(tp, cfg.vocab)
    logits = layers.unembed(head, x, tp=vocab_tp)[:, 0]
    if vocab_tp is None:
        return logits
    return tp_lib.gather_from_model(logits, vocab_tp, -1)


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_len: int, *, patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16, tp=None, dp=None, zero=None):
    """Process the prompt: (last-token logits (B, vocab) fp32, a filled
    cache of ``max_len`` positions).  VLM / audio-frontend archs prepend
    the projected patch / frame embeddings; the cache then covers prefix +
    prompt, and decode positions continue at ``frontend_len + S``.

    Under a mesh (the dense and MoE families; ``src/repro/train/serve.py``
    under GSPMD): ``tp`` (a ``models.tp.ModelParallel``) runs the
    tensor-parallel forward on this rank's parameter parts
    (``param_specs``) and fills this rank's part of the cache
    (``init_cache(..., tp=...)``); the embedding and the head are
    vocab-parallel and the logits gathered whole.  ``dp`` (a
    ``models.tp.DataParallel``): ``tokens`` are this rank's rows of a batch
    split over the data axes, which the MoE dispatch ranks over the whole
    batch.  ``zero`` (a ``models.tp.ZeroShards``): the block weights split
    over 'data' too, gathered a layer at a time (ZeRO-3)."""
    _check_decoder(cfg)
    tp = _serve_tp(cfg, tp)
    x = _embed(cfg, params, tokens, patches if patches is not None
               else frames, tp=_split(tp, cfg.vocab))
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, max_len, cache_dtype, device=x.device, tp=tp)
    if cfg.family == "ssm":
        x, cache = _xlstm_serve(cfg, params, x, cache)
    else:
        x, cache = _cache_scan(cfg, params, x, cache, pos=0,
                               positions=torch.arange(S, device=x.device),
                               tp=tp, dp=dp, zero=zero, max_len=max_len)
    return _last_logits(cfg, params, x, tp), cache


@torch.inference_mode()
def prefill_chunk(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  cache, pos, block_tables=None, *, tp=None, dp=None,
                  zero=None, max_len: Optional[int] = None):
    """Continue a prefill: write a prompt chunk at positions
    [pos, pos + S) of an existing cache (chunked prefill of prompts too
    long for one call).  Token-only: frontend archs prepend their prefix in
    the first full prefill.  ``block_tables`` (1, W): write the chunk
    straight into a paged pool cache through the request's block table
    (serve/paged.py's admission path).  Returns (chunk-final logits,
    cache).  ``tp`` / ``dp`` / ``zero`` as ``prefill``'s, the cache this
    rank's part of a ``max_len``-position cache (needed where the KV heads
    do not divide the model axis)."""
    _check_decoder(cfg)
    if cfg.frontend is not None:
        raise ValueError("chunked prefill is token-only")
    tp = _serve_tp(cfg, tp)
    x = _embed(cfg, params, tokens, tp=_split(tp, cfg.vocab))
    S = x.shape[1]
    if cfg.family == "ssm":
        x, cache = _xlstm_serve(cfg, params, x, cache)
    else:
        x, cache = _cache_scan(
            cfg, params, x, cache, pos=pos,
            positions=layers._query_positions(pos, S, x.device),
            block_tables=_tables(block_tables, x.device), tp=tp, dp=dp,
            zero=zero, max_len=max_len)
    return _last_logits(cfg, params, x, tp), cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                cache, pos, block_tables=None, *, tp=None, dp=None,
                zero=None, max_len: Optional[int] = None):
    """One decode step: (B,) token ids + cache + pos -> (logits (B, vocab)
    fp32, cache).  pos is a scalar (every row at the same depth) or a (B,)
    tensor of per-row positions (slot-based continuous batching).
    ``block_tables`` (B, W) reads and writes the attention cache through
    per-slot block tables over a paged pool (serve/paged.py); recurrent
    state is unaffected.  ``tp`` / ``dp`` / ``zero`` / ``max_len`` as
    ``prefill_chunk``'s: with ``dp`` the rows are this rank's slots of the
    decode batch split over the data axes."""
    _check_decoder(cfg)
    tp = _serve_tp(cfg, tp)
    x = _embed(cfg, params, token[:, None], tp=_split(tp, cfg.vocab))
    if cfg.family == "ssm":
        x, cache = _xlstm_serve(cfg, params, x, cache)
    else:
        x, cache = _cache_scan(
            cfg, params, x, cache, pos=pos,
            positions=layers._query_positions(pos, 1, x.device),
            block_tables=_tables(block_tables, x.device), tp=tp, dp=dp,
            zero=zero, max_len=max_len)
    return _last_logits(cfg, params, x, tp), cache


def _tables(block_tables, device):
    """Block tables as int64 indices on ``device`` (None stays None)."""
    if block_tables is None:
        return None
    return torch.as_tensor(block_tables, device=device).long()


def _xlstm_serve(cfg: ArchConfig, params: Params, x: torch.Tensor, cache):
    """xLSTM prefill and decode share the recurrent path (state in, state
    out): the layer order of ``_xlstm_forward``, each block continuing
    from its own view of the carried state, written back in place."""
    every = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // every
    mb = unbound_layers(params["mlstm_blocks"])
    sb = unbound_layers(params["slstm_blocks"]) if n_s else []
    m_state = [leaf.unbind(0) for leaf in cache["mlstm"]]
    s_state = [leaf.unbind(0) for leaf in cache["slstm"]]

    def run(x, bp, kind, views, i):
        x, new = _xlstm_block(cfg, bp, x, kind,
                              state=tuple(v[i] for v in views))
        for v, n in zip(views, new):
            v[i].copy_(n)
        return x

    seg = every - 1
    for s_i in range(n_s):
        for l in range(s_i * seg, (s_i + 1) * seg):
            x = run(x, mb[l], "mlstm", m_state, l)
        x = run(x, sb[s_i], "slstm", s_state, s_i)
    for l in range(n_s * seg, len(mb)):
        x = run(x, mb[l], "mlstm", m_state, l)
    return x, cache


def params_from_numpy(t, device: DeviceLike = None,
                      requires_grad: bool = False) -> Params:
    """The port's parameters from the reference's ``init`` output converted
    to a nested dict of numpy arrays (same paths, same layout).  bf16 arrays
    (numpy's ``bfloat16`` extension type, which torch cannot read) cross
    bit for bit through their 16-bit patterns."""
    device = resolve_device(device)

    def conv(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            v = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            v = torch.from_numpy(a)
        v = v.to(device)
        return v.requires_grad_(requires_grad) if v.is_floating_point() else v
    return tree.tree_map(conv, t)


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Inverse of ``params_from_numpy``: a nested dict of numpy arrays."""
    return tree.tree_map(lambda v: v.detach().cpu().numpy(), params)
