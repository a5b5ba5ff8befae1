"""Decoder-LM backbone (port of the training paths of
``repro.models.transformer``): ``ArchConfig``, ``init`` and ``forward``.

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
(non-reentrant).  The cache, prefill and decode entry points wait for
ROADMAP item 10.
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
from repro_torch.models import xlstm as xlstm_lib
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

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, qkv_bias=self.qkv_bias,
                          rope_theta=self.rope_theta,
                          sliding_window=self.sliding_window)

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


def frontend(p: Params, emb: torch.Tensor) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(emb))): patch or frame embeddings to d_model."""
    return layers.linear(p["fc2"], F.gelu(layers.linear(p["fc1"], emb),
                                          approximate="tanh"))


def _block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, rope_cs,
                 global_layer: bool = False):
    """Residual block; ``global_layer`` drops the sliding window (hymba's
    ``global_layers``, the reference's per-layer window flag)."""
    h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn_out = layers.mla_attention(p["attn"], cfg.mla, h,
                                        rope_cs=rope_cs)
    else:
        acfg = cfg.attn_cfg()
        if global_layer:
            acfg = dataclasses.replace(acfg, sliding_window=None)
        attn_out = layers.attention(p["attn"], acfg, h, rope_cs=rope_cs)
    if cfg.family == "hybrid":
        ssm_out = ssm_lib.ssm(p["ssm"], cfg.ssm, h)
        s = p["mix_scale"].float()
        attn_out = (s[0] * attn_out.float()
                    + s[1] * ssm_out.float()).to(x.dtype)
    x = x + attn_out
    h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_lib.moe(p["moe"], cfg.moe, h)
    return x + layers.mlp(p["mlp"], h, cfg.act)


def _xlstm_block(cfg: ArchConfig, p: Params, x: torch.Tensor, kind: str):
    h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    core = xlstm_lib.mlstm if kind == "mlstm" else xlstm_lib.slstm
    x = x + core(p["core"], cfg.xlstm, h)
    h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, "gelu")


def _rope_angles(hd: int, positions: torch.Tensor, theta: float):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions.float()[:, None] * inv[None, :]
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
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward: (B, S) tokens -> (B, S, vocab) fp32 logits.  With
    a frontend, the projected ``patches`` (or ``frames``) (B, P, F) are
    prepended to the token embeddings, and the logits cover the S token
    positions only (the reference cuts its full-sequence logits to them;
    norm and head act per position, so the port cuts before them)."""
    _check_decoder(cfg)
    x = layers.embed(params["embed"], tokens).to(as_dtype(cfg.compute_dtype))
    n_prefix = 0
    if cfg.frontend is not None:
        emb = patches if patches is not None else frames
        pe = frontend(params["frontend_proj"], emb.to(x.dtype))
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    if cfg.family == "ssm":
        x = _xlstm_forward(cfg, params, x)
    else:
        rope_cs = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
        hybrid = cfg.family == "hybrid"
        for l, bp in enumerate(unbound_layers(params["blocks"])):
            body = functools.partial(
                _block_apply, cfg, bp, rope_cs=rope_cs,
                global_layer=hybrid and l in cfg.global_layers)
            x = apply_layer(body, x, remat=cfg.remat)
    x = layers.rmsnorm(params["final_norm"], x[:, n_prefix:], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return layers.unembed(head, x)


def _xlstm_forward(cfg: ArchConfig, params: Params,
                   x: torch.Tensor) -> torch.Tensor:
    """Segments of ``slstm_every − 1`` mLSTM blocks, each followed by one
    sLSTM block, then any trailing mLSTM blocks; remat on the mLSTM blocks
    only, as in the reference."""
    every = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // every
    mb = unbound_layers(params["mlstm_blocks"])
    sb = unbound_layers(params["slstm_blocks"]) if n_s else []

    def m_run(x, blocks):
        for bp in blocks:
            body = functools.partial(_xlstm_block, cfg, bp, kind="mlstm")
            x = apply_layer(body, x, remat=cfg.remat)
        return x

    seg = every - 1
    for s_i in range(n_s):
        x = m_run(x, mb[s_i * seg:(s_i + 1) * seg])
        x = _xlstm_block(cfg, sb[s_i], x, "slstm")
    return m_run(x, mb[n_s * seg:])


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
