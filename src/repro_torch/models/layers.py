"""Model building blocks (port of ``repro.models.layers``: linear, norms,
rotary, GQA self and cross attention, DeepSeek's MLA and the MLPs), as
plain tensor functions over dict parameters.

Conventions kept from the reference so both packages compute the same thing:
  * linear weights are stored (in_dim, out_dim) and apply as ``x @ w``;
  * stacked-layer leaves carry a leading L dim;
  * rotary embeddings split the head dim into halves (no interleave);
  * attention is plain einsum + softmax with a -1e30 mask, in fp32;
  * attention caches are preallocated (B, S_max, KV, hd) rows written at
    the decode position, or (P, bs, KV, hd) block pools read through
    per-row block tables (``block_table``, the paged cache).  The
    reference donates them to its jitted functions; the port writes them
    in place and returns them as well.

``attention``, ``mla_attention``, ``mlp``, ``embed`` and ``unembed`` take
``tp``, a
``models.tp.ModelParallel`` (default None, the one-card code path): their
leaves are then this rank's parts as ``models.sharding.param_specs``
splits them over the 'model' axis, and they issue the collectives GSPMD
inserts in the reference (``models/tp.py``).  The caller passes ``tp`` to
``mlp``, ``embed`` and ``unembed`` only where the specs split them (their
width divides the axis); ``attention`` reads each projection's split off
its config, as ``mla_attention`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import tp as tp_lib

Params = Dict[str, Any]

# a function every random leaf ``normal`` draws passes through first
# (``drawing``), or None
_DRAW = contextvars.ContextVar("draw", default=None)


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
    """Standard normal fp32 samples; shape-only (uninitialised) on ``meta``.
    Inside ``drawing(keep)`` the samples are ``keep(samples)``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    keep = _DRAW.get()
    return x if keep is None else keep(x)


@contextlib.contextmanager
def drawing(keep):
    """Within the block every random leaf is ``keep(whole draw)`` as soon
    as it is drawn: the generator draws what it always draws, and what the
    init does next (a scale, a cast: elementwise) acts on what ``keep``
    returned.  ``train.step.init_state`` keeps each leaf's shard, so one
    whole leaf at a time is ever on the card."""
    token = _DRAW.set(keep)
    try:
        yield
    finally:
        _DRAW.reset(token)


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


def embed(p: Params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token embeddings.  With ``tp`` the table is this rank's rows of the
    vocab: tokens outside them look up nothing (zeros), and the sum over
    the model axis is every token's row."""
    if tp is None:
        return F.embedding(tokens.long(), p["embedding"])
    w = p["embedding"]
    local = tokens.long() - tp.rank * w.shape[0]
    outside = (local < 0) | (local >= w.shape[0])
    rows = F.embedding(local.masked_fill(outside, 0), w)
    return tp_lib.reduce_from_model(rows.masked_fill(outside[..., None], 0),
                                    tp)


def unembed(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Tied or untied output head: logits in fp32.  With ``tp``, this
    rank's vocab columns (B, S, V/tp)."""
    if tp is not None:
        x = tp_lib.copy_to_model(x, tp)
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
    # the reference's GSPMD pins of sequence-sharded attention
    # (``src/repro/models/layers.py:116-119``): its activation batch axes
    # and the axis its query rows split over.  The port's tensor-parallel
    # attention shards the rows wherever the heads do not divide the model
    # axis, whatever these say.
    batch_axes: Optional[tuple] = None
    seq_axis: Optional[str] = None


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


def _block_len(n: int, target: int) -> int:
    """Block length for n rows: the reference's largest divisor of n up to
    ``target``, or ``target`` with a shorter last block where that divisor
    is below half of it (a prime n, such as a resumed request's prompt
    plus its generated tokens, would otherwise loop over n blocks of one
    row each)."""
    c = _pick_chunk(n, target)
    return c if 2 * c >= min(n, target) else target


def _block_mask(qpos, kpos, *, causal, window):
    """Boolean mask from absolute positions, or None.  qpos is (qlen,) —
    or (B, qlen) when decode rows sit at per-slot positions (continuous
    batching) — giving a (qlen, klen) / (B, qlen, klen) mask."""
    if not causal:
        return None
    ok = qpos[..., :, None] >= kpos
    if window is not None:
        ok = ok & (kpos > qpos[..., :, None] - window)
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

    attend = _chunked_sdpa if S > _Q_CHUNK and T > _KV_CHUNK else \
        _dense_sdpa
    out = attend(qg, k, v, scale, qpos, kpos, causal, window)
    return out.reshape(B, S, H, hv).to(q.dtype)


def _dense_sdpa(qg, k, v, scale, qpos, kpos, causal, window):
    """Softmax over the whole (S, T) logits with a -1e30 mask, fp32:
    (B, S, G, R, hv)."""
    logits = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k.float()) * scale
    mask = _block_mask(qpos, kpos, causal=causal, window=window)
    if mask is not None:
        # (S, T) shared positions, or (B, S, T) per-row decode positions
        if mask.ndim == 3:
            mask = mask[:, None, None]
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bgrst,btgh->bsgrh", probs, v.float())


def _chunked_sdpa(qg, k, v, scale, qpos, kpos, causal, window):
    """Online-softmax attention over query blocks × KV blocks with fp32
    running (max, denom, acc): O(S·chunk) memory instead of O(S·T)."""
    S, T = qg.shape[1], k.shape[1]
    _, l, acc = _online_softmax(qg, k, v, scale, qpos, kpos, causal, window,
                                _block_len(S, _Q_CHUNK),
                                _block_len(T, _KV_CHUNK))
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _online_softmax(qg, k, v, scale, qpos, kpos, causal, window, qc, kc,
                    round_p: bool = True):
    """``_chunked_sdpa``'s loop over query blocks of ``qc`` rows × KV blocks
    of ``kc``: the running (row max (B, S, G, R), sum of exponentials,
    probability-weighted V (B, S, G, R, hv)) in fp32, unnormalised.  A row
    that sees no key keeps max -1e30 (the mask's fill), never NaN.
    ``round_p``: the probabilities cross to the product in the value
    dtype (the chunked path's rule); fp32 otherwise (the dense path's)."""
    B, S, G, R, hd = qg.shape
    T = k.shape[1]
    hv = v.shape[-1]
    ms, ls, accs = [], [], []
    for q0 in range(0, S, qc):
        q_i = qg[:, q0:q0 + qc].float()
        n = q_i.shape[1]
        m = q_i.new_full((B, n, G, R), -1e30)
        l = q_i.new_zeros((B, n, G, R))
        acc = q_i.new_zeros((B, n, G, R, hv))
        for k0 in range(0, T, kc):
            logits = torch.einsum("bqgrh,bkgh->bqgrk", q_i,
                                  k[:, k0:k0 + kc].float()) * scale
            ok = _block_mask(qpos[..., q0:q0 + qc], kpos[k0:k0 + kc],
                             causal=causal, window=window)
            if ok is not None:
                ok = ok[None] if ok.ndim == 2 else ok
                logits = logits.masked_fill(~ok[:, :, None, None, :], -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            # the probabilities cross to the product in the value dtype, as
            # the reference's; the product itself is fp32 (bf16 values are
            # exact in fp32), as its preferred_element_type=float32
            v_j = v[:, k0:k0 + kc]
            if round_p:
                p = p.to(v_j.dtype).float()
            acc = acc * corr[..., None] + torch.einsum(
                "bqgrk,bkgh->bqgrh", p, v_j.float())
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.cat(ms, dim=1), torch.cat(ls, dim=1), torch.cat(accs, dim=1)


def _sdpa_rows(q, k, v, *, scale, qpos, kpos, causal, window, tp):
    """Attention of the whole (B, S, H, hd) queries ``q`` over the key rows
    at ``kpos`` that this rank holds (``k`` / ``v`` (B, T, KV, ·)), merged
    with every other rank's rows over the model axis ``tp``: each rank's
    partial (row max, sum of exponentials, weighted V) from
    ``_online_softmax``, all-gathered and merged by log-sum-exp in rank
    order, so every rank gets the same bits.  A rank whose rows a query
    cannot see contributes exp(-1e30 − max) = 0.  The probabilities meet
    V as ``_sdpa`` would on the whole cache: in the value dtype where it
    takes the chunked path, in fp32 where the dense one.  (B, S, H, hv) in
    q's dtype."""
    B, S, H, hd = q.shape
    T, KV, hv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(B, S, KV, H // KV, hd)
    qc = _block_len(S, _Q_CHUNK) if S > _Q_CHUNK else S
    kc = _block_len(T, _KV_CHUNK) if T > _KV_CHUNK else T
    chunked = S > _Q_CHUNK and T * tp.size > _KV_CHUNK
    m, l, acc = _online_softmax(qg, k, v, scale, qpos, kpos, causal, window,
                                qc, kc, round_p=chunked)
    part = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    every = tp_lib.gather_stack(part, tp)          # (n, B, S, G, R, hv + 2)
    ms, ls, accs = every[..., 0], every[..., 1], every[..., 2:]
    w = torch.exp(ms - ms.amax(0))
    l = (ls * w).sum(0)
    acc = (accs * w[..., None]).sum(0)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, hv).to(q.dtype)


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def _query_positions(pos, S: int, device) -> torch.Tensor:
    """Absolute positions of S new queries written at ``pos``: (S,) for a
    scalar offset (None is 0), (B, S) for a (B,) vector of per-row
    positions."""
    ar = torch.arange(S, device=device)
    if _is_vector(pos):
        return pos.to(device)[:, None] + ar
    return ar + (0 if pos is None else int(pos))


def _cache_write(leaf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write the rows ``new`` (B, S, ...) into the cache ``leaf``
    (B, S_max, ...) in place, in the cache's dtype: at [pos, pos + S) for a
    scalar ``pos``, or row b at ``pos[b]`` for a (B,) vector (S == 1, slot
    decode)."""
    new = new.to(leaf.dtype)
    if _is_vector(pos):
        if new.shape[1] != 1:
            raise ValueError("vector pos is a single-token decode path")
        rows = torch.arange(leaf.shape[0], device=leaf.device)
        leaf[rows, pos.to(leaf.device)] = new[:, 0]
    else:
        p = int(pos)
        leaf[:, p:p + new.shape[1]] = new
    return leaf


def cache_row_range(kv_heads: int, max_len: int,
                    tp) -> Optional[Tuple[int, int]]:
    """[lo, hi): the rows of a ``max_len``-position attention cache this
    rank holds where ``models.sharding.cache_specs`` splits its sequence
    over the model axis ``tp``: the ``kv_heads`` do not divide the axis
    and ``max_len`` does (MLA's latent and rope key: ``kv_heads`` 1).
    None where it holds every row: the heads split (``tp`` divides them),
    nothing divides (the cache whole on every rank), or no ``tp``."""
    if tp is None or tp.divides(kv_heads) or not tp.divides(max_len):
        return None
    n = max_len // tp.size
    return tp.rank * n, (tp.rank + 1) * n


def _cache_write_rows(leaf: torch.Tensor, new: torch.Tensor, pos,
                      lo: int) -> torch.Tensor:
    """``_cache_write`` into this rank's rows [lo, lo + leaf.shape[1]) of a
    cache split by sequence: the new rows (B, S, ...) at global positions
    [pos, pos + S) (a scalar ``pos``) or row b at ``pos[b]`` (a (B,)
    vector, S == 1) land here only where they fall in that range.  The
    vector write reads and rewrites each row's clamped local index and
    keeps its old value where the position is another rank's, so no host
    sync decides who writes."""
    new = new.to(leaf.dtype)
    rows = leaf.shape[1]
    if _is_vector(pos):
        if new.shape[1] != 1:
            raise ValueError("vector pos is a single-token decode path")
        pos = pos.to(leaf.device).long()
        own = (pos >= lo) & (pos < lo + rows)
        b = torch.arange(leaf.shape[0], device=leaf.device)
        idx = (pos - lo).clamp(0, rows - 1)
        own = own.reshape((-1,) + (1,) * (new.ndim - 2))
        leaf[b, idx] = torch.where(own, new[:, 0], leaf[b, idx])
    else:
        p = int(pos)
        a, e = max(p, lo), min(p + new.shape[1], lo + rows)
        if a < e:
            leaf[:, a - lo:e - lo] = new[:, a - p:e - p]
    return leaf


def _paged_write(leaf: torch.Tensor, new: torch.Tensor, block_table,
                 pos, block_size: int) -> torch.Tensor:
    """Scatter new rows into a paged pool leaf, in place, in its dtype
    (``repro.models.layers._paged_write``, layers.py:162).

    leaf: (P, bs, ...) physical block pool; new: (B, S, ...) freshly
    projected rows; block_table: (B, W) integer.  A (B,) ``pos`` (decode,
    S == 1): row b writes at block ``block_table[b, pos[b] // bs]``,
    offset ``pos[b] % bs``.  A scalar ``pos`` (chunked prefill, B == 1):
    the S rows write at logical positions pos + arange(S) through row 0's
    table.  Live tables are injective (``serve.paged.BlockPool``), so live
    rows never share a target.  Free slots idle on the null block 0 with
    all-null tables at pos 0, so their writes share (0, 0): on CUDA those
    duplicate indices land in any order, which is harmless only because no
    live table maps block 0 and nothing reads it unmasked."""
    new = new.to(leaf.dtype)
    if _is_vector(pos):
        if new.shape[1] != 1:
            raise ValueError("vector pos is a single-token decode path")
        pos = pos.to(leaf.device).long()
        rows = torch.arange(pos.shape[0], device=leaf.device)
        blocks = block_table[rows, pos // block_size]
        leaf[blocks, pos % block_size] = new[:, 0]
    else:
        p = int(pos) + torch.arange(new.shape[1], device=leaf.device)
        leaf[block_table[0, p // block_size], p % block_size] = new[0]
    return leaf


def _paged_read(leaf: torch.Tensor, block_table) -> torch.Tensor:
    """A slot-contiguous (B, W·bs, ...) view gathered from the (P, bs, ...)
    pool (``repro.models.layers._paged_read``, layers.py:182): logical
    block j of row b is ``leaf[block_table[b, j]]``.  Entries past a
    slot's allocated length point at the null block; the causal mask
    (kpos <= qpos) keeps them out of every softmax."""
    B, W = block_table.shape
    return leaf[block_table].reshape((B, W * leaf.shape[1])
                                     + leaf.shape[2:])


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor, *,
              xk: Optional[torch.Tensor] = None,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              pos=None, rope_cs=None, static_cache: bool = False,
              block_table=None, tp=None, cache_rows=None):
    """Self (``xk`` None) or cross attention with an optional KV cache, as
    the reference's ``attention``: self attention is causal, with the
    sliding window, unless ``cfg.causal`` is off, and rotary when
    ``rope_cs`` is given; cross attention projects keys and values from
    ``xk`` (no rope, no mask).

    cache: (k_cache, v_cache) of (B, S_max, KV, hd); pos: the write
    position, a scalar shared by every row (prefill, lockstep decode) or a
    (B,) tensor of per-row positions (slot decode, S == 1).  The new k / v
    are written into the cache first (in place, in its dtype) and attention
    then reads the whole cache back, masked by position.  static_cache:
    attend over the cache as it is (the decoder's precomputed cross K / V).
    block_table: (B, W) integer map of each row's logical cache blocks to
    physical pool blocks; the cache is then (P, bs, KV, hd) pools shared
    by every row, written through ``_paged_write`` and read back as a
    gathered (B, W·bs, KV, hd) view (self attention only).

    Returns the output (B, S, d), or (output, cache) when a cache is given.

    tp: a ``models.tp.ModelParallel``: the projections split over the
    model axis, self or cross attention without a cache (the training
    path, ``_attention_tp``), or self attention with this rank's part of a
    contiguous cache (the serving path, ``_attention_cached_tp``;
    ``cache_rows`` the rows it holds where the cache is split by sequence,
    ``cache_row_range``).
    """
    if tp is not None:
        if block_table is not None or static_cache or (
                xk is not None and cache is not None):
            raise ValueError("tensor-parallel attention is self attention "
                             "over a contiguous cache or none, or cross "
                             "attention without a cache")
        if cache is None:
            return _attention_tp(p, cfg, x, rope_cs, tp, xk)
        return _attention_cached_tp(p, cfg, x, cache, pos, rope_cs, tp,
                                    cache_rows)
    if block_table is not None and (cache is None or xk is not None):
        raise ValueError("the paged cache is a self-attention cache path")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    q = linear(p["q_proj"], x).reshape(B, S, H, hd)
    if static_cache:
        k, v = cache
        out = _sdpa(q, k, v, scale=scale)
        return linear(p["o_proj"], out.reshape(B, S, H * hd)), cache

    src = x if xk is None else xk
    T = src.shape[1]
    k = linear(p["k_proj"], src).reshape(B, T, KV, hd)
    v = linear(p["v_proj"], src).reshape(B, T, KV, hd)
    if rope_cs is not None and xk is None:
        cos_q, sin_q, cos_k, sin_k = rope_cs
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    if block_table is not None:
        bs = cache[0].shape[1]
        k = _paged_read(_paged_write(cache[0], k, block_table, pos, bs),
                        block_table)
        v = _paged_read(_paged_write(cache[1], v, block_table, pos, bs),
                        block_table)
    elif cache is not None and xk is None:
        k = _cache_write(cache[0], k, pos)
        v = _cache_write(cache[1], v, pos)
    if xk is not None or not cfg.causal:
        out = _sdpa(q, k, v, scale=scale)
    else:
        out = _sdpa(q, k, v, scale=scale,
                    qpos=_query_positions(pos, S, x.device),
                    kpos=torch.arange(k.shape[1], device=x.device),
                    causal=True, window=cfg.sliding_window)
    out = linear(p["o_proj"], out.reshape(B, S, H * hd))
    return out if cache is None else (out, cache)


def _whole(t: torch.Tensor, split: bool, tp) -> torch.Tensor:
    """The whole (B, T, F) of a column projection's output on every rank,
    for a computation of each rank's own: gathered (the backward
    reduce-scatters the ranks' partial gradients) or, where it was whole,
    passed through ``copy_to_model`` (the backward sums them)."""
    if split:
        return tp_lib.gather_from_model(t, tp, -1, reduce_grad=True)
    return tp_lib.copy_to_model(t, tp)


def _gathered(t: torch.Tensor, split: bool, tp) -> torch.Tensor:
    """A column projection's (B, T, F) output whole on every rank (the
    serving path: no gradient)."""
    return tp_lib.gather_from_model(t, tp, -1) if split else t


def _row_parallel(p: Params, out: torch.Tensor, split: bool, tp,
                  local: bool = False) -> torch.Tensor:
    """The row-parallel out-projection of ``out`` (B, S, F): where its rows
    are split, this rank's F / tp columns of ``out`` (``out`` already them
    with ``local``) through its rows, the partial sums reduced over the
    model axis; whole otherwise."""
    if not split:
        return linear(p, out)
    if not local:
        w = out.shape[-1] // tp.size
        out = out[..., tp.rank * w:(tp.rank + 1) * w]
    return tp_lib.reduce_from_model(linear(p, out), tp)


def _attention_cached_tp(p: Params, cfg: AttnConfig, x: torch.Tensor, cache,
                         pos, rope_cs, tp, rows):
    """Self attention of the replicated (B, S, d) ``x`` over this rank's
    part of the cache placed by ``cache_specs`` (the serving path, under
    ``torch.inference_mode``): q / k / v column-parallel, o row-parallel,
    as ``_attention_tp``.  Three layouts:

    * heads split (the KV heads divide the axis, so the query heads do):
      each rank writes and attends its own heads, no collective inside;
    * sequence split (``rows`` [lo, hi)): the new k / v and the queries
      are gathered to whole heads, each rank writes the new rows that fall
      in its range and attends its rows, masked by global position, and
      the partials merge over the axis (``_sdpa_rows``);
    * whole (nothing divides): the cache is the same on every rank, which
      attends as one card does on the whole heads.

    The rotary embeddings take each query's and key's global position
    (``rope_cs``, the same on every rank)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = tp.size
    q_split, kv_split = tp.divides(H * hd), tp.divides(KV * hd)
    heads = tp.divides(KV)
    q = linear(p["q_proj"], x)
    k, v = linear(p["k_proj"], x), linear(p["v_proj"], x)
    if heads:
        q = q.reshape(B, S, H // n, hd)
        k, v = (t.reshape(B, S, KV // n, hd) for t in (k, v))
    else:
        q = _gathered(q, q_split, tp).reshape(B, S, H, hd)
        k, v = (_gathered(t, kv_split, tp).reshape(B, S, KV, hd)
                for t in (k, v))
    cos_q, sin_q, cos_k, sin_k = rope_cs
    q, k = apply_rope(q, cos_q, sin_q), apply_rope(k, cos_k, sin_k)
    scale = 1.0 / math.sqrt(hd)
    qpos = _query_positions(pos, S, x.device)
    if rows is None or heads:
        k_c, v_c = _cache_write(cache[0], k, pos), _cache_write(cache[1], v,
                                                                pos)
        out = _sdpa(q, k_c, v_c, scale=scale, qpos=qpos,
                    kpos=torch.arange(k_c.shape[1], device=x.device),
                    causal=cfg.causal, window=cfg.sliding_window)
    else:
        lo, hi = rows
        k_c = _cache_write_rows(cache[0], k, pos, lo)
        v_c = _cache_write_rows(cache[1], v, pos, lo)
        out = _sdpa_rows(q, k_c, v_c, scale=scale, qpos=qpos,
                         kpos=torch.arange(lo, hi, device=x.device),
                         causal=cfg.causal, window=cfg.sliding_window, tp=tp)
    out = _row_parallel(p["o_proj"], out.reshape(B, S, -1), q_split, tp,
                        local=heads)
    return out, cache


def _kv_groups(k: torch.Tensor, n_heads: int, tp) -> torch.Tensor:
    """The KV heads that this rank's ``n_heads / tp`` query heads read,
    from all of them (B, T, KV, hd): whole groups in order where the local
    heads cover each group they touch equally (``_sdpa``'s grouping), else
    one KV head per query head."""
    KV = k.shape[2]
    rep, local = n_heads // KV, n_heads // tp.size
    groups = [(tp.rank * local + i) // rep for i in range(local)]
    uniq = sorted(set(groups))
    per = local // len(uniq)
    if local % len(uniq) == 0 and groups == [uniq[i // per]
                                             for i in range(local)]:
        return k[:, :, uniq[0]:uniq[-1] + 1]
    return k[:, :, groups]


def _attention_tp(p: Params, cfg: AttnConfig, x: torch.Tensor, rope_cs, tp,
                  xk: Optional[torch.Tensor] = None):
    """Self attention of the replicated (B, S, d) ``x`` with the
    projections split by ``param_specs`` over the model axis: q / k / v
    column-parallel (a projection whose width does not divide the axis is
    whole on every rank), o row-parallel, its partial sums reduced once.
    With ``xk`` (B, T, d), replicated too: cross attention, k and v from
    ``xk``, no rope and no mask (the encoder-decoder's).  Three layouts
    (the reference's GSPMD choices,
    ``src/repro/models/layers.py:358-383``):

    * head-parallel, where ``n_heads`` and ``n_kv_heads`` divide the axis:
      each rank attends with its own heads;
    * KV-gathered, where only ``n_kv_heads`` does not: k and v are
      gathered, each rank keeps the KV heads its query heads read;
    * sequence-sharded, where ``n_heads`` does not (the reference's
      ``seq_axis="model"`` pin): q goes to whole heads of this rank's S/tp
      query rows (an all-to-all), k and v to whole heads of every row (a
      gather), so a split that falls mid-head is undone before the
      reshape; each rank attends its rows against every key at their own
      causal offsets, and the all-to-all back gives o its feature split.
      The S query rows must split over the axis (a VLM's patch prefix
      counts among them); a length that does not raises ``ValueError``.

    Rotary embeddings act within a head, so they follow the gathers; each
    query row keeps its global position."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = tp.size
    # column-parallel: a split projection takes this rank's columns from
    # x through copy_to_model; a whole one is computed alike everywhere
    x_in = tp_lib.copy_to_model(x, tp)
    src, src_in = (x, x_in) if xk is None else \
        (xk, tp_lib.copy_to_model(xk, tp))
    T = src.shape[1]
    q_split, kv_split = tp.divides(H * hd), tp.divides(KV * hd)
    q = linear(p["q_proj"], x_in if q_split else x)
    k, v = (linear(p[n], src_in if kv_split else src)
            for n in ("k_proj", "v_proj"))
    rope = rope_cs is not None and xk is None
    if rope:
        cos_q, sin_q, cos_k, sin_k = rope_cs
    causal = cfg.causal and xk is None
    scale = 1.0 / math.sqrt(hd)
    if tp.divides(H):
        q = q.reshape(B, S, H // n, hd)
        if tp.divides(KV):
            k, v = (t.reshape(B, T, KV // n, hd) for t in (k, v))
        else:
            k, v = (_kv_groups(_whole(t, kv_split, tp).reshape(B, T, KV, hd),
                               H, tp) for t in (k, v))
        if rope:
            q, k = apply_rope(q, cos_q, sin_q), apply_rope(k, cos_k, sin_k)
        out = _sdpa(q, k, v, scale=scale,
                    qpos=torch.arange(S, device=x.device),
                    kpos=torch.arange(T, device=x.device),
                    causal=causal, window=cfg.sliding_window)
        out = out.reshape(B, S, (H // n) * hd)
    else:
        if S % n:
            raise ValueError(f"sequence-sharded attention splits {S} "
                             f"positions over {n} ranks")
        rows = S // n
        r0 = tp.rank * rows
        q = tp_lib.features_to_seq(q, tp) if q_split else \
            tp_lib.split_to_model(q, tp, 1)
        q = q.reshape(B, rows, H, hd)
        k, v = (_whole(t, kv_split, tp).reshape(B, T, KV, hd)
                for t in (k, v))
        if rope:
            q = apply_rope(q, cos_q[r0:r0 + rows], sin_q[r0:r0 + rows])
            k = apply_rope(k, cos_k, sin_k)
        out = _sdpa(q, k, v, scale=scale,
                    qpos=torch.arange(r0, r0 + rows, device=x.device),
                    kpos=torch.arange(T, device=x.device),
                    causal=causal, window=cfg.sliding_window)
        out = out.reshape(B, rows, H * hd)
        out = tp_lib.seq_to_features(out, tp) if q_split else \
            tp_lib.gather_from_model(out, tp, 1)
    if q_split:     # o_proj's rows split as q_proj's columns
        return tp_lib.reduce_from_model(linear(p["o_proj"], out), tp)
    return linear(p["o_proj"], out)


# -------------------------------------------------------- MLA (DeepSeek-V3)

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def mla_init(gen, cfg: MLAConfig, *, lead: tuple = (), dtype=torch.float32,
             device="cpu") -> Params:
    H = cfg.n_heads
    qh = cfg.qk_nope_dim + cfg.qk_rope_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "q_a_proj": linear_init(gen, cfg.d_model, cfg.q_lora_rank, **kw),
        "q_a_norm": rmsnorm_init(cfg.q_lora_rank, **kw),
        "q_b_proj": linear_init(gen, cfg.q_lora_rank, H * qh, **kw),
        "kv_a_proj": linear_init(gen, cfg.d_model,
                                 cfg.kv_lora_rank + cfg.qk_rope_dim, **kw),
        "kv_a_norm": rmsnorm_init(cfg.kv_lora_rank, **kw),
        "kv_b_proj": linear_init(gen, cfg.kv_lora_rank,
                                 H * (cfg.qk_nope_dim + cfg.v_head_dim), **kw),
        "o_proj": linear_init(gen, H * cfg.v_head_dim, cfg.d_model, **kw),
    }


def mla_attention(p: Params, cfg: MLAConfig, x: torch.Tensor, *,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  pos=None, rope_cs=None, block_table=None, tp=None,
                  cache_rows=None):
    """Multi-head Latent Attention: q through the rank-``q_lora_rank``
    bottleneck, k and v expanded from the normalised latent ``c_kv`` plus
    one rope key shared by every head.  The v head dim may differ from the
    qk dim (``_sdpa`` reads it off v).  The cache holds (c_kv, k_rope):
    the latent (B, S_max, kv_lora) and the shared rope key
    (B, S_max, 1, rope_dim), written at ``pos`` as ``attention``'s; k and v
    are then expanded from the whole cache, in its dtype.  With
    ``block_table`` both leaves are (P, bs, ...) pools read through the
    per-row tables, as ``attention``'s.  Returns the output, or
    (output, cache) when a cache is given.

    tp: a ``models.tp.ModelParallel``: the projections split over the
    model axis, without a cache (the training path, ``_mla_tp``) or with
    this rank's part of a contiguous one (the serving path,
    ``_mla_cached_tp``; ``cache_rows`` as ``attention``'s)."""
    if tp is not None:
        if block_table is not None:
            raise ValueError("tensor-parallel MLA reads a contiguous cache "
                             "or none")
        if cache is None:
            return _mla_tp(p, cfg, x, rope_cs, tp)
        return _mla_cached_tp(p, cfg, x, cache, pos, rope_cs, tp,
                              cache_rows)
    if block_table is not None and cache is None:
        raise ValueError("block_table needs the paged cache")
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    q = linear(p["q_b_proj"], rmsnorm(p["q_a_norm"], linear(p["q_a_proj"], x)))
    q = q.reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]

    kv_a = linear(p["kv_a_proj"], x)
    c_kv, k_rope = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    c_kv = rmsnorm(p["kv_a_norm"], c_kv)
    k_rope = k_rope.reshape(B, S, 1, rd)
    if rope_cs is not None:
        cos_q, sin_q, cos_k, sin_k = rope_cs
        q_rope = apply_rope(q_rope, cos_q, sin_q)
        k_rope = apply_rope(k_rope, cos_k, sin_k)
    if block_table is not None:
        bs = cache[0].shape[1]
        c_kv = _paged_read(_paged_write(cache[0], c_kv, block_table, pos,
                                        bs), block_table)
        k_rope = _paged_read(_paged_write(cache[1], k_rope, block_table, pos,
                                          bs), block_table)
    elif cache is not None:
        c_kv = _cache_write(cache[0], c_kv, pos)
        k_rope = _cache_write(cache[1], k_rope, pos)

    T = c_kv.shape[1]
    kv = linear(p["kv_b_proj"], c_kv).reshape(B, T, H, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k = torch.cat([k_nope, k_rope.expand(B, T, H, rd)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = _sdpa(qf, k, v, scale=1.0 / math.sqrt(nd + rd),
                qpos=_query_positions(pos, S, x.device),
                kpos=torch.arange(T, device=x.device), causal=True)
    out = linear(p["o_proj"], out.reshape(B, S, H * vd))
    return out if cache is None else (out, cache)


def _mla_tp(p: Params, cfg: MLAConfig, x: torch.Tensor, rope_cs, tp):
    """MLA of the replicated (B, S, d) ``x`` with the projections split by
    ``param_specs`` over the model axis (each whole where its width does
    not divide the axis): ``q_a_proj`` / ``kv_a_proj`` column-parallel,
    gathered whole before their norms (replicated parameters, so applied
    where every rank computes alike) and the latent / rope split (kv_a's
    columns may split across that boundary); ``q_b_proj`` / ``kv_b_proj``
    column-parallel, ``o_proj`` row-parallel, reduced once.  As
    ``_attention_tp``: head-parallel where ``n_heads`` divides the axis
    (each rank's q_b / kv_b columns are its heads; the rope key, shared by
    every head, is whole on every rank); sequence-sharded otherwise, q to
    whole heads of this rank's S/tp query rows, k and v to whole heads of
    every row, so a split that falls mid-head is undone before the
    reshape, and the output back to o's feature split."""
    B, S, _ = x.shape
    H, n = cfg.n_heads, tp.size
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    x_in = tp_lib.copy_to_model(x, tp)
    qb_split, kvb_split = tp.divides(H * (nd + rd)), tp.divides(H * (nd + vd))
    o_split = tp.divides(H * vd)

    def down(name, width):
        """The whole down-projection, alike on every rank."""
        if not tp.divides(width):
            return linear(p[name], x)
        return tp_lib.gather_from_model(linear(p[name], x_in), tp, -1)

    def own(t, split):
        """``t`` (alike everywhere) into a split projection's input."""
        return tp_lib.copy_to_model(t, tp) if split else t
    q_a = rmsnorm(p["q_a_norm"], down("q_a_proj", cfg.q_lora_rank))
    q = linear(p["q_b_proj"], own(q_a, qb_split))
    kv_a = down("kv_a_proj", r + rd)
    c_kv = rmsnorm(p["kv_a_norm"], kv_a[..., :r])
    kv = linear(p["kv_b_proj"], own(c_kv, kvb_split))
    # the rope key, read by each rank's own heads or rows
    k_rope = tp_lib.copy_to_model(kv_a[..., r:].reshape(B, S, 1, rd), tp)
    cos_q, sin_q, cos_k, sin_k = rope_cs
    k_rope = apply_rope(k_rope, cos_k, sin_k)
    scale = 1.0 / math.sqrt(nd + rd)
    if tp.divides(H):   # every head-dim projection splits with the heads
        h = H // n
        q = q.reshape(B, S, h, nd + rd)
        kv = kv.reshape(B, S, h, nd + vd)
        qpos = torch.arange(S, device=x.device)
        q_cs = cos_q, sin_q
    else:
        if S % n:
            raise ValueError(f"sequence-sharded MLA splits {S} positions "
                             f"over {n} ranks")
        h, rows = H, S // n
        r0 = tp.rank * rows
        q = tp_lib.features_to_seq(q, tp) if qb_split else \
            tp_lib.split_to_model(q, tp, 1)
        q = q.reshape(B, rows, H, nd + rd)
        kv = (_whole(kv, True, tp) if kvb_split else
              tp_lib.copy_to_model(kv, tp)).reshape(B, S, H, nd + vd)
        qpos = torch.arange(r0, r0 + rows, device=x.device)
        q_cs = cos_q[r0:r0 + rows], sin_q[r0:r0 + rows]
    q = torch.cat([q[..., :nd], apply_rope(q[..., nd:], *q_cs)], dim=-1)
    k = torch.cat([kv[..., :nd], k_rope.expand(B, S, h, rd)], dim=-1)
    out = _sdpa(q, k, kv[..., nd:], scale=scale, qpos=qpos,
                kpos=torch.arange(S, device=x.device), causal=True)
    out = out.reshape(B, q.shape[1], h * vd)
    if not tp.divides(H):
        out = tp_lib.seq_to_features(out, tp) if o_split else \
            tp_lib.gather_from_model(out, tp, 1)
    if o_split:
        return tp_lib.reduce_from_model(linear(p["o_proj"], out), tp)
    return linear(p["o_proj"], out)


def _mla_cached_tp(p: Params, cfg: MLAConfig, x: torch.Tensor, cache, pos,
                   rope_cs, tp, rows):
    """MLA of the replicated (B, S, d) ``x`` over this rank's part of the
    cache placed by ``cache_specs`` (the serving path): the latent and the
    rope key are split by sequence (``rows``) or whole, while ``kv_b_proj``
    is split by heads.  The down-projections are gathered whole (as
    ``_mla_tp``'s), each rank writes the new latent / rope rows that fall
    in its range, and the cache's rows are then all-gathered over the axis,
    so each rank expands the whole latent through its own ``kv_b_proj``
    columns and attends its own heads (head-parallel where the heads divide
    the axis).  Where they do not, the q_b / kv_b outputs are gathered to
    whole heads and every rank attends all of them alike."""
    B, S, _ = x.shape
    H, n = cfg.n_heads, tp.size
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    qb_split, kvb_split = tp.divides(H * (nd + rd)), tp.divides(H * (nd + vd))

    def down(name, width):
        """The whole down-projection, alike on every rank."""
        return _gathered(linear(p[name], x), tp.divides(width), tp)
    q = linear(p["q_b_proj"], rmsnorm(p["q_a_norm"],
                                      down("q_a_proj", cfg.q_lora_rank)))
    kv_a = down("kv_a_proj", r + rd)
    c_kv = rmsnorm(p["kv_a_norm"], kv_a[..., :r])
    cos_q, sin_q, cos_k, sin_k = rope_cs
    k_rope = apply_rope(kv_a[..., r:].reshape(B, S, 1, rd), cos_k, sin_k)
    if rows is None:
        c_kv = _cache_write(cache[0], c_kv, pos)
        k_rope = _cache_write(cache[1], k_rope, pos)
    else:
        c_kv, k_rope = (tp_lib.gather_from_model(
            _cache_write_rows(leaf, new, pos, rows[0]), tp, 1)
            for leaf, new in zip(cache, (c_kv, k_rope)))
    T = c_kv.shape[1]
    heads = tp.divides(H)
    h = H // n if heads else H
    kv = linear(p["kv_b_proj"], c_kv)
    if not heads:
        q, kv = _gathered(q, qb_split, tp), _gathered(kv, kvb_split, tp)
    q = q.reshape(B, S, h, nd + rd)
    kv = kv.reshape(B, T, h, nd + vd)
    qf = torch.cat([q[..., :nd], apply_rope(q[..., nd:], cos_q, sin_q)],
                   dim=-1)
    k = torch.cat([kv[..., :nd], k_rope.expand(B, T, h, rd)], dim=-1)
    out = _sdpa(qf, k, kv[..., nd:], scale=1.0 / math.sqrt(nd + rd),
                qpos=_query_positions(pos, S, x.device),
                kpos=torch.arange(T, device=x.device), causal=True)
    out = _row_parallel(p["o_proj"], out.reshape(B, S, h * vd),
                        tp.divides(H * vd), tp, local=heads)
    return out, cache


# --------------------------------------------------------------------- MLPs

def mlp_init(gen, d: int, d_ff: int, act: str, *, lead: tuple = (),
             dtype=torch.float32, device="cpu") -> Params:
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"up_proj": linear_init(gen, d, d_ff, **kw),
         "down_proj": linear_init(gen, d_ff, d, **kw)}
    if act == "swiglu":
        p["gate_proj"] = linear_init(gen, d, d_ff, **kw)
    return p


def mlp(p: Params, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """The MLP of ``act``.  With ``tp``: up / gate column-parallel, down
    row-parallel, its partial sums reduced over the model axis."""
    if tp is not None:
        return tp_lib.reduce_from_model(
            mlp(p, tp_lib.copy_to_model(x, tp), act), tp)
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
