"""The port's cache paths of the building blocks against the reference's,
on the same numpy parameters and inputs: attention and MLA with a cache at
a scalar and a (B,) vector ``pos`` (outputs and cache leaves), the
per-row (B, qlen, klen) mask, the SSM continuing from a carried (conv, h)
state, the mLSTM / sLSTM state round trips, and the bf16 chunked attention
(the block product kept in fp32, as the reference's
``preferred_element_type=float32``).

Tolerances: fp32 outputs and caches 1e-4 (the port's logits parity); a
sequence run in two pieces with the state carried across against one
float64 run within 1e-5 · max|exact|; the bf16 attention's RMS error
against float64 at most 1.05x the reference's.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
T_MAX = 12


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_np(x):
    """float32 numpy values rounded to bf16 (exact in both packages)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


# ----------------------------------------------- the bf16 chunked attention

def _rms_vs_exact(out, q, k, v, scale):
    """RMS of ``out`` against causal softmax attention in float64."""
    qd, kd, vd = (torch.from_numpy(a).double() for a in (q, k, v))
    S = q.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", qd, kd) * scale
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
    exact = torch.einsum("bhst,bthd->bshd", probs, vd)
    return float(torch.sqrt(((out.double() - exact) ** 2).mean()))


@pytest.mark.parametrize("S", [2048, 1024])
def test_bf16_attention_error_no_larger_than_reference(S):
    """bf16 causal q / k / v (1, S, 4, 64) through both packages' _sdpa:
    at S = 2048 both take the chunked online softmax (the port rounded
    each block's P·V product to bf16 before it joined the fp32 accumulator,
    1.27x the reference's RMS error), at 1024 the dense softmax."""
    rng = _rng(3)
    q, k, v = (_bf16_np(rng.standard_normal((1, S, 4, 64)).astype(
        np.float32)) for _ in range(3))
    scale = 1 / 8.0
    pos = np.arange(S)
    want = jlayers._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         scale=scale, qpos=jnp.asarray(pos),
                         kpos=jnp.asarray(pos), causal=True)
    got = tlayers._sdpa(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                        scale=scale, qpos=torch.from_numpy(pos),
                        kpos=torch.from_numpy(pos), causal=True)
    assert got.dtype == torch.bfloat16
    ref_err = _rms_vs_exact(torch.from_numpy(np.asarray(want, np.float32)),
                            q, k, v, scale)
    port_err = _rms_vs_exact(got.float(), q, k, v, scale)
    assert port_err <= 1.05 * ref_err, (port_err, ref_err, port_err / ref_err)


@pytest.mark.parametrize("T", [1031, 1536])
def test_chunked_attention_blocks_a_prime_length(T, monkeypatch):
    """A prime query length past 1024 (a resumed request's prompt plus its
    generated tokens) takes two query blocks (1024 rows and a shorter
    last one), not 1031 blocks of one row, and so does a prime key length;
    the output matches the dense softmax (1e-5) and the reference (1e-4).
    The divisor-only blocking took 1031 query blocks of one row (4,124
    einsums at T = 1536, 2,125,922 at T = 1031)."""
    S = 1031
    rng = _rng(9)
    q = rng.standard_normal((1, S, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, T, 2, 8)).astype(np.float32)
            for _ in range(2))
    qpos, kpos = np.arange(S) + (T - S), np.arange(T)
    calls, einsum = [], torch.einsum

    def counted(*a, **kw):
        calls.append(1)
        return einsum(*a, **kw)
    monkeypatch.setattr(torch, "einsum", counted)
    got = tlayers._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=0.35,
                        qpos=torch.from_numpy(qpos),
                        kpos=torch.from_numpy(kpos), causal=True)
    monkeypatch.undo()
    assert len(calls) == 2 * 2 * 2      # q blocks × kv blocks × 2 einsums
    dense = tlayers._dense_sdpa(
        torch.from_numpy(q).reshape(1, S, 2, 2, 8), torch.from_numpy(k),
        torch.from_numpy(v), 0.35, torch.from_numpy(qpos),
        torch.from_numpy(kpos), True, None).reshape(1, S, 4, 8)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.35, qpos=jnp.asarray(qpos),
                         kpos=jnp.asarray(kpos), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_block_mask_takes_per_row_positions():
    """A (B, qlen) qpos gives a (B, qlen, klen) mask, row b that of its own
    positions, windowed too."""
    kpos = torch.arange(10)
    qpos = torch.tensor([[3], [7], [9]])
    for window in (None, 4):
        got = tlayers._block_mask(qpos, kpos, causal=True, window=window)
        assert got.shape == (3, 1, 10)
        for b in range(3):
            want = tlayers._block_mask(qpos[b], kpos, causal=True,
                                       window=window)
            assert torch.equal(got[b], want)
        ref = jlayers._block_mask(jnp.asarray(qpos.numpy()),
                                  jnp.asarray(kpos.numpy()), causal=True,
                                  window=window, window_enabled=None)
        assert np.array_equal(np.asarray(ref), got.numpy())


# -------------------------------------------------- attention with a cache

def _attn_params(cfg_kw, seed=0):
    jcfg = jlayers.AttnConfig(**cfg_kw)
    tcfg = tlayers.AttnConfig(**{k: v for k, v in cfg_kw.items()})
    jp = jlayers.attention_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), device="cpu")


def _rope(hd, positions):
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    jc = jt._rope_angles(hd, jnp.asarray(positions), 10000.0)
    tc = tt._rope_angles(hd, torch.from_numpy(np.asarray(positions)),
                         10000.0)
    return (jc[0], jc[1], jc[0], jc[1]), (tc[0], tc[1], tc[0], tc[1])


@pytest.mark.parametrize("window", [None, 4])
def test_attention_with_cache_matches_reference(window):
    """A 5-token prefill at pos 0, a 3-token chunk at pos 5, then one token
    a row at per-row positions (8, 2, 6): outputs and both cache leaves
    after each, against the reference."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              sliding_window=window)
    jcfg, tcfg, jp, tp = _attn_params(kw)
    B = 3
    jc = (jnp.zeros((B, T_MAX, 2, 8)),) * 2
    tc = (torch.zeros(B, T_MAX, 2, 8), torch.zeros(B, T_MAX, 2, 8))
    rng = _rng(1)
    steps = [(0, 5), (5, 3), (np.array([8, 2, 6], np.int32), 1)]
    for pos, S in steps:
        x = rng.standard_normal((B, S, 32)).astype(np.float32)
        positions = (pos[:, None] + np.arange(S) if np.ndim(pos)
                     else pos + np.arange(S))
        jrope, trope = _rope(8, positions)
        jpos = jnp.asarray(pos)
        tpos = torch.from_numpy(pos) if np.ndim(pos) else pos
        jout, jc = jlayers.attention(jp, jcfg, jnp.asarray(x), cache=jc,
                                     pos=jpos, rope_cs=jrope)
        tout, tc = tlayers.attention(tp, tcfg, torch.from_numpy(x),
                                     cache=tc, pos=tpos, rope_cs=trope)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_attention_writes_the_cache_in_place_and_static_reads_it():
    """The cache tensors are written in place (and returned); a static
    cache (the decoder's cross K / V) is read as it is, unchanged, and the
    output equals cross attention over the keys it holds."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8, causal=False)
    jcfg, tcfg, jp, tp = _attn_params(kw, seed=2)
    rng = _rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    enc = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    k = tlayers.linear(tp["k_proj"], enc).reshape(2, 5, 4, 8)
    v = tlayers.linear(tp["v_proj"], enc).reshape(2, 5, 4, 8)
    cache = (k.clone(), v.clone())
    out, back = tlayers.attention(tp, tcfg, x, cache=cache,
                                  static_cache=True)
    assert back is cache and torch.equal(cache[0], k)
    want = tlayers.attention(tp, tcfg, x, xk=enc)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jout, _ = jlayers.attention(jp, jcfg, jnp.asarray(x.numpy()),
                                cache=(jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy())),
                                static_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    self_cfg = tlayers.AttnConfig(32, 4, 4, 8)
    kc, vc = torch.zeros(2, 6, 4, 8), torch.zeros(2, 6, 4, 8)
    _, (k2, v2) = tlayers.attention(tp, self_cfg, x, cache=(kc, vc), pos=1)
    assert k2 is kc and v2 is vc
    assert torch.count_nonzero(kc[:, 1:4]) > 0
    assert not torch.count_nonzero(kc[:, 0]) and not torch.count_nonzero(
        kc[:, 4:])


def test_mla_with_cache_matches_reference():
    """MLA (reduced DeepSeek-V3's ranks) with its (c_kv, k_rope) cache:
    prefill of 4, a chunk of 2 at pos 4, one token a row at (6, 1, 3)."""
    cfg_kw = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    jcfg, tcfg = jlayers.MLAConfig(**cfg_kw), tlayers.MLAConfig(**cfg_kw)
    jp = jlayers.mla_init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(_np(jp), device="cpu")
    B = 3
    jc = (jnp.zeros((B, T_MAX, 16)), jnp.zeros((B, T_MAX, 1, 8)))
    tc = (torch.zeros(B, T_MAX, 16), torch.zeros(B, T_MAX, 1, 8))
    rng = _rng(6)
    for pos, S in [(0, 4), (4, 2), (np.array([6, 1, 3], np.int32), 1)]:
        x = rng.standard_normal((B, S, 64)).astype(np.float32)
        positions = (pos[:, None] + np.arange(S) if np.ndim(pos)
                     else pos + np.arange(S))
        jrope, trope = _rope(8, positions)
        tpos = torch.from_numpy(pos) if np.ndim(pos) else pos
        jout, jc = jlayers.mla_attention(jp, jcfg, jnp.asarray(x), cache=jc,
                                         pos=jnp.asarray(pos), rope_cs=jrope)
        tout, tc = tlayers.mla_attention(tp, tcfg, torch.from_numpy(x),
                                         cache=tc, pos=tpos, rope_cs=trope)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_paged_attention_matches_reference(kind):
    """``attention`` / ``mla_attention`` over (P, bs, ...) pools through
    block tables: a 5-token chunk through row 0's table (scalar pos), then
    one token a row at per-row positions with the other tables (a free row
    on the all-null table), outputs and pool leaves against the
    reference's; a cross-attention call with a table raises."""
    P, bs, W, B = 9, 4, 3, 3
    tables = np.array([[3, 7, 1], [5, 0, 0], [0, 0, 0]], np.int32)
    if kind == "gqa":
        jcfg, tcfg, jp, tp = _attn_params(
            dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8))
        shapes, d, hd = [(P, bs, 2, 8)] * 2, 32, 8
        jfn, tfn = jlayers.attention, tlayers.attention
    else:
        kw = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        jcfg, tcfg = jlayers.MLAConfig(**kw), tlayers.MLAConfig(**kw)
        jp = jlayers.mla_init(jax.random.PRNGKey(5), jcfg)
        tp = params_from_numpy(_np(jp), device="cpu")
        shapes, d, hd = [(P, bs, 16), (P, bs, 1, 8)], 64, 8
        jfn, tfn = jlayers.mla_attention, tlayers.mla_attention
    rng = _rng(8)
    init = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    jc = tuple(jnp.asarray(a) for a in init)
    tc = tuple(torch.from_numpy(a.copy()) for a in init)
    steps = [(0, 5, tables[:1]), (np.array([5, 2, 0], np.int32), 1, tables)]
    for pos, S, bt in steps:
        rows = bt.shape[0]
        x = rng.standard_normal((rows, S, d)).astype(np.float32)
        positions = (pos[:, None] + np.arange(S) if np.ndim(pos)
                     else pos + np.arange(S))
        jrope, trope = _rope(hd, positions)
        tpos = torch.from_numpy(pos) if np.ndim(pos) else pos
        jout, jc = jfn(jp, jcfg, jnp.asarray(x), cache=jc,
                       pos=jnp.asarray(pos), rope_cs=jrope,
                       block_table=jnp.asarray(bt))
        tout, tc2 = tfn(tp, tcfg, torch.from_numpy(x), cache=tc, pos=tpos,
                        rope_cs=trope,
                        block_table=torch.from_numpy(bt).long())
        assert all(a is b for a, b in zip(tc2, tc))      # written in place
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if kind == "gqa":
        with pytest.raises(ValueError, match="self-attention"):
            tlayers.attention(tp, tcfg, torch.zeros(1, 1, 32),
                              xk=torch.zeros(1, 2, 32), cache=tc, pos=0,
                              block_table=torch.zeros(1, 1,
                                                      dtype=torch.long))


# ------------------------------------------------------------- SSM state

SSM = dict(d_model=64, d_state=4, expand=2)   # reduced hymba's


def test_ssm_state_matches_reference_and_splits():
    """``ssm(state=)`` from a nonzero (conv, h) against the reference
    (output and both new states), and a sequence in two pieces with the
    state carried equal to one run (1e-5 of max)."""
    jcfg, tcfg = jssm.SSMConfig(**SSM), tssm.SSMConfig(**SSM)
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    jp = {**jp, "dt_bias": jp["dt_bias"] + 0.3}
    tp = params_from_numpy(_np(jp), device="cpu")
    rng = _rng(7)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 128)).astype(np.float32) * 0.5
    h = rng.standard_normal((2, 128, 4)).astype(np.float32) * 0.5
    jout, (jconv, jh) = jssm.ssm(jp, jcfg, jnp.asarray(x),
                                 state=(jnp.asarray(conv), jnp.asarray(h)))
    tout, (tconv, th) = tssm.ssm(tp, tcfg, torch.from_numpy(x),
                                 state=(torch.from_numpy(conv),
                                        torch.from_numpy(h)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)

    state0 = tssm.ssm_init_state(tcfg, 2, device="cpu")
    whole, (c_w, h_w) = tssm.ssm(tp, tcfg, torch.from_numpy(x), state=state0)
    assert torch.equal(whole, tssm.ssm(tp, tcfg, torch.from_numpy(x)))
    a, st = tssm.ssm(tp, tcfg, torch.from_numpy(x[:, :5]), state=state0)
    b, (c_s, h_s) = tssm.ssm(tp, tcfg, torch.from_numpy(x[:, 5:]), state=st)
    got = torch.cat([a, b], 1)
    scale = float(whole.abs().max())
    assert float((got - whole).abs().max()) <= 1e-5 * scale
    assert torch.equal(c_s, c_w)
    assert float((h_s - h_w).abs().max()) <= 1e-5 * float(h_w.abs().max())


def test_state_inits_match_reference():
    xc = dict(d_model=64, n_heads=4, slstm_every=4)
    for want, got in [
            (jssm.ssm_init_state(jssm.SSMConfig(**SSM), 3),
             tssm.ssm_init_state(tssm.SSMConfig(**SSM), 3, device="cpu")),
            (jxlstm.mlstm_init_state(jxlstm.XLSTMConfig(**xc), 3),
             txlstm.mlstm_init_state(txlstm.XLSTMConfig(**xc), 3,
                                     device="cpu")),
            (jxlstm.slstm_init_state(jxlstm.XLSTMConfig(**xc), 3),
             txlstm.slstm_init_state(txlstm.XLSTMConfig(**xc), 3,
                                     device="cpu"))]:
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert g.shape == w.shape and str(g.dtype)[6:] == str(w.dtype)
            assert np.array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------- xLSTM state

XC = dict(d_model=64, n_heads=4, slstm_every=4)   # reduced xlstm-350m's


def _xlstm_params(kind, seed=1):
    cfg = jxlstm.XLSTMConfig(**XC)
    init = jxlstm.mlstm_init if kind == "mlstm" else jxlstm.slstm_init
    jp = init(jax.random.PRNGKey(seed), cfg)
    if kind == "mlstm":     # input gates up, forget gates well below 0
        jp = {**jp, "if_gate_bias": jp["if_gate_bias"].at[:4].add(0.5)
              .at[4:].add(-1.0)}
    return cfg, txlstm.XLSTMConfig(**XC), jp


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_state_matches_reference(kind):
    """Each cell from a carried state (a 6-token prefill's) over 4 more
    tokens: output and every state leaf against the reference."""
    jcfg, tcfg, jp = _xlstm_params(kind)
    tp = params_from_numpy(_np(jp), device="cpu")
    jcore = jxlstm.mlstm if kind == "mlstm" else jxlstm.slstm
    tcore = txlstm.mlstm if kind == "mlstm" else txlstm.slstm
    jinit = (jxlstm.mlstm_init_state(jcfg, 2) if kind == "mlstm"
             else jxlstm.slstm_init_state(jcfg, 2))
    tinit = (txlstm.mlstm_init_state(tcfg, 2, device="cpu")
             if kind == "mlstm" else
             txlstm.slstm_init_state(tcfg, 2, device="cpu"))
    rng = _rng(8)
    jst, tst = jinit, tinit
    for S in (6, 4, 1):
        x = rng.standard_normal((2, S, 64)).astype(np.float32)
        jout, jst = jcore(jp, jcfg, jnp.asarray(x), state=jst)
        tout, tst = tcore(tp, tcfg, torch.from_numpy(x), state=tst)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_state_round_trip_equals_one_run(kind):
    """A 12-token sequence in pieces of 7 and 5 (the state carried across)
    against one float64 run of the same cell: within 1e-5 · max|exact|;
    no (B, S, H, hd, hd) tensor for the mLSTM."""
    _, tcfg, jp = _xlstm_params(kind)
    tp = params_from_numpy(_np(jp), device="cpu")
    tp64 = {k: ({kk: vv.double() for kk, vv in v.items()}
                if isinstance(v, dict) else v.double())
            for k, v in tp.items()}
    core = txlstm.mlstm if kind == "mlstm" else txlstm.slstm
    init = (txlstm.mlstm_init_state if kind == "mlstm"
            else txlstm.slstm_init_state)
    x = torch.from_numpy(_rng(9).standard_normal((2, 12, 64)))
    exact = core(tp64, tcfg, x)
    st = init(tcfg, 2, device="cpu")
    a, st = core(tp, tcfg, x[:, :7].float(), state=st)
    b, st = core(tp, tcfg, x[:, 7:].float(), state=st)
    got = torch.cat([a, b], 1).double()
    err = float((got - exact).abs().max())
    assert err <= 1e-5 * float(exact.abs().max()), err
    if kind == "mlstm":
        C, n, m = st
        assert C.shape == (2, 4, 16, 16) and n.shape == (2, 4, 16)
        assert m.shape == (2, 4)
