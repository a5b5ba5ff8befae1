"""Dense model building blocks (port of the dense subset of
``repro.models.layers``), as plain tensor functions over dict parameters.

Conventions kept from the reference so both packages compute the same thing:
  * linear weights are stored (in_dim, out_dim) and apply as ``x @ w``;
  * stacked-layer leaves carry a leading L dim;
  * rotary embeddings split the head dim into halves (no interleave);
  * attention is plain einsum + softmax with a -1e30 mask, in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------- utilities

def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, output in x.dtype."""
    return torch.matmul(x, w.to(x.dtype))


def linear_init(gen: Optional[torch.Generator], d_in: int, d_out: int, *,
                lead: tuple = (), bias: bool = False,
                dtype=torch.float32, device="cpu") -> Params:
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": (normal(gen, lead + (d_in, d_out), device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal fp32 samples; shape-only (uninitialised) on ``meta``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def rmsnorm_init(d: int, *, lead: tuple = (), dtype=torch.float32,
                 device="cpu") -> Params:
    return {"norm_scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["norm_scale"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32,
               device="cpu") -> Params:
    return {"embedding": (normal(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["embedding"])


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied or untied output head: logits in fp32."""
    return torch.matmul(x.float(), p["embedding"].float().mT)


# ------------------------------------------------------------------- rotary

def rope_freqs(head_dim: int, max_pos: int, theta: float = 10000.0,
               device="cpu"):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)                     # (S, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd/2) already position-gathered."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None = full causal
    causal: bool = True


def attention_init(gen, cfg: AttnConfig, *, lead: tuple = (),
                   dtype=torch.float32, device="cpu") -> Params:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "q_proj": linear_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
        "k_proj": linear_init(gen, d, KV * hd, bias=cfg.qkv_bias, **kw),
        "v_proj": linear_init(gen, d, KV * hd, bias=cfg.qkv_bias, **kw),
        "o_proj": linear_init(gen, H * hd, d, **kw),
    }


_Q_CHUNK = 1024
_KV_CHUNK = 1024


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    best = 1
    for c in range(1, min(n, target) + 1):
        if n % c == 0:
            best = c
    return best


def _block_mask(qpos, kpos, *, causal, window):
    """(qlen, klen) boolean mask from absolute positions, or None."""
    if not causal:
        return None
    ok = qpos[:, None] >= kpos[None, :]
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def _sdpa(q, k, v, *, scale, qpos=None, kpos=None, causal=False,
          window=None):
    """q: (B,S,H,hd); k,v: (B,T,KV,·); GQA by head-group repetition.  Long
    sequences take the chunked online-softmax path."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    hv = v.shape[-1]
    qg = q.reshape(B, S, KV, rep, hd)
    if qpos is None:
        qpos = torch.arange(S, device=q.device)
    if kpos is None:
        kpos = torch.arange(T, device=q.device)

    if S > _Q_CHUNK and T > _KV_CHUNK:
        out = _chunked_sdpa(qg, k, v, scale, qpos, kpos, causal, window)
        return out.reshape(B, S, H, hv).to(q.dtype)

    logits = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k.float()) * scale
    mask = _block_mask(qpos, kpos, causal=causal, window=window)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v.float())
    return out.reshape(B, S, H, hv).to(q.dtype)


def _chunked_sdpa(qg, k, v, scale, qpos, kpos, causal, window):
    """Online-softmax attention over query blocks × KV blocks with fp32
    running (max, denom, acc): O(S·chunk) memory instead of O(S·T)."""
    B, S, G, R, hd = qg.shape
    T = k.shape[1]
    hv = v.shape[-1]
    qc, kc = _pick_chunk(S, _Q_CHUNK), _pick_chunk(T, _KV_CHUNK)
    outs = []
    for q0 in range(0, S, qc):
        q_i = qg[:, q0:q0 + qc].float()
        m = q_i.new_full((B, qc, G, R), -1e30)
        l = q_i.new_zeros((B, qc, G, R))
        acc = q_i.new_zeros((B, qc, G, R, hv))
        for k0 in range(0, T, kc):
            logits = torch.einsum("bqgrh,bkgh->bqgrk", q_i,
                                  k[:, k0:k0 + kc].float()) * scale
            ok = _block_mask(qpos[q0:q0 + qc], kpos[k0:k0 + kc],
                             causal=causal, window=window)
            if ok is not None:
                logits = logits.masked_fill(~ok[None, :, None, None, :], -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            v_j = v[:, k0:k0 + kc]
            acc = acc * corr[..., None] + torch.einsum(
                "bqgrk,bkgh->bqgrh", p.to(v_j.dtype), v_j).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1)


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor, *,
              rope_cs=None) -> torch.Tensor:
    """Causal self attention of the training forward (no cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["q_proj"], x).reshape(B, S, H, hd)
    k = linear(p["k_proj"], x).reshape(B, S, KV, hd)
    v = linear(p["v_proj"], x).reshape(B, S, KV, hd)
    if rope_cs is not None:
        cos_q, sin_q, cos_k, sin_k = rope_cs
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    pos = torch.arange(S, device=x.device)
    out = _sdpa(q, k, v, scale=1.0 / math.sqrt(hd), qpos=pos, kpos=pos,
                causal=cfg.causal, window=cfg.sliding_window)
    return linear(p["o_proj"], out.reshape(B, S, H * hd))


# --------------------------------------------------------------------- MLPs

def mlp_init(gen, d: int, d_ff: int, act: str, *, lead: tuple = (),
             dtype=torch.float32, device="cpu") -> Params:
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"up_proj": linear_init(gen, d, d_ff, **kw),
         "down_proj": linear_init(gen, d_ff, d, **kw)}
    if act == "swiglu":
        p["gate_proj"] = linear_init(gen, d, d_ff, **kw)
    return p


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = linear(p["up_proj"], x)
    if act == "swiglu":
        h = F.silu(linear(p["gate_proj"], x)) * up
    elif act == "squared_relu":
        h = torch.square(F.relu(up))
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return linear(p["down_proj"], h)
