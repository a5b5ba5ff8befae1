"""Decoder-LM backbone of the dense and MoE families (port of their paths
in ``repro.models.transformer``): ``ArchConfig``, ``init`` and ``forward``.

  dense — GQA/MHA attention + MLP (swiglu or squared-relu, optional biases)
  moe   — attention (MLA for deepseek) + MoE FFN with shared experts

Parameters are a nested dict of tensors laid out as the reference's pytree:
per-layer leaves stacked ``(L, ...)`` under ``blocks`` (MoE experts
``(L, E, m, n)``), linear weights ``(in, out)``.  The reference's
``lax.scan`` over the stacked blocks is a Python loop over the layers, each
stacked leaf cut into its L layers once per forward (``unbind``: its
backward stacks the L gradients once, where indexing ``w[l]`` per layer
would zero-fill a full-size gradient of every leaf L times); its
``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant).  The
hybrid, ssm, vlm and encoder-decoder families wait for ROADMAP item 9.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree
from repro_torch.device import DeviceLike, as_dtype, resolve_device
from repro_torch.models import layers, moe as moe_lib
from repro_torch.models.layers import AttnConfig, MLAConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # 'dense' | 'moe' are ported
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
    # moe
    moe: Optional[moe_lib.MoEConfig] = None
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

    def param_count(self) -> int:
        """Total parameters, from shapes alone (meta tensors)."""
        params = init(self, device="meta")
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
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} is not ported yet "
                         "(ROADMAP item 9); 'dense' and 'moe' are")


def init(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (JAX's PRNG is not reproduced; ``params_from_numpy`` carries the
    reference's init over instead).  ``device="meta"`` builds shapes only."""
    _check_family(cfg)
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
    blocks = {"attn_norm": layers.rmsnorm_init(d, lead=(L,), **kw),
              "mlp_norm": layers.rmsnorm_init(d, lead=(L,), **kw)}
    if cfg.attn_kind == "mla":
        blocks["attn"] = layers.mla_init(gen, cfg.mla, lead=(L,), **kw)
    else:
        blocks["attn"] = layers.attention_init(gen, cfg.attn_cfg(),
                                               lead=(L,), **kw)
    if cfg.moe is not None:
        blocks["moe"] = moe_lib.moe_init(gen, cfg.moe, lead=(L,), **kw)
    else:
        blocks["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, cfg.act,
                                        lead=(L,), **kw)
    p["blocks"] = blocks
    return p


def _block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, rope_cs):
    h = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        x = x + layers.mla_attention(p["attn"], cfg.mla, h, rope_cs=rope_cs)
    else:
        x = x + layers.attention(p["attn"], cfg.attn_cfg(), h,
                                 rope_cs=rope_cs)
    h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_lib.moe(p["moe"], cfg.moe, h)
    return x + layers.mlp(p["mlp"], h, cfg.act)


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


def forward(cfg: ArchConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: (B, S) tokens -> (B, S, vocab) fp32 logits."""
    _check_family(cfg)
    x = layers.embed(params["embed"], tokens).to(as_dtype(cfg.compute_dtype))
    S = x.shape[1]
    rope_cs = _rope_for(cfg, torch.arange(S, device=x.device))
    paths, leaves = zip(*tree.flatten(params["blocks"]))
    per_layer = [leaf.unbind(0) for leaf in leaves]
    for l in range(cfg.n_layers):
        bp = tree.rebuild(params["blocks"],
                          {p: w[l] for p, w in zip(paths, per_layer)})
        body = functools.partial(_block_apply, cfg, bp, rope_cs=rope_cs)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, use_reentrant=False)
        else:
            x = body(x)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return layers.unembed(head, x)


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
