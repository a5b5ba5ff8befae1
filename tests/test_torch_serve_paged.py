"""The port's paged serving tier (``repro_torch.serve.paged`` and
``ServeConfig(kv="paged")``), on the CPU at reduced widths with fp32
caches.

Twins of ``tests/test_serve.py``'s paged tests: requests complete under
the ``preempt_every`` drill (grouped KV, MLA latents, pure-recurrent
state), pool pressure preempts, over-length prompts are rejected, paged
beats contiguous concurrency at equal cache bytes, the slot manager's
units, ``prepare_decode`` preempting the youngest, enc-dec refused.

Parity, as the contiguous tier settled it (a batch-1 solo run is another
shape, so it is not the reference point):

1. Paged == contiguous on the same schedule, bit for bit: the same queue,
   slots and ``max_len`` (a whole number of blocks), the default pool and
   ``watermark=0``, so admission is identical; the gathered (B, W·bs, ...)
   view has the contiguous cache's length, so the same kernels run on the
   same values.
2. A preempted request equals its replay at the shapes it was served at,
   bit for bit: each stint's prefill (the first admission, then the
   resume's re-prefill of prompt + generated tokens) at its group size and
   row or in the same chunks, then decode at ``num_slots`` in its slot row
   with the other rows idle; a hybrid's resume restores its saved
   recurrent rows.  xLSTM's resume restores the whole state, so it is held
   bitwise to the unpreempted run.
3. The port against the reference at 1e-4 (fp32) / 2e-2 (bf16):
   ``_paged_write`` / ``_paged_read``, ``init_paged_cache``, and paged
   ``decode_fn`` / ``prefill_chunk_fn`` (logits and pool leaves).
4. The allocator's decisions equal the reference's on the same queue:
   admissions (slot, block ids), preemptions, table growth, metrics.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.transformer import PAGED_CACHE_KEYS  # noqa: E402
from repro_torch.serve import (PagedSlotManager, Request,  # noqa: E402
                               RequestQueue, Scheduler, ServeConfig)
from repro_torch.serve.paged import NULL_BLOCK  # noqa: E402
from repro_torch.serve.scheduler import _frontend_key as _key  # noqa: E402
from repro_torch.serve.scheduler import _prefix_len as _prefix  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

F32 = torch.float32
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SAME_SCHEDULE_ARCHS = ["smollm-360m", "deepseek-v3-671b", "hymba-1.5b",
                       "xlstm-350m", "llava-next-mistral-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(arch):
    cfg = tconfigs.get(arch, reduced=True)
    return cfg, model_fns(cfg).init(cfg, seed=0, device="cpu")


def _req(rid, n, budget=4, arrival=0.0):
    return Request(rid=rid, tokens=np.arange(n, dtype=np.int32),
                   max_new_tokens=budget, arrival=arrival)


def _queue(cfg, n=7, seed=3, new_tokens=(2, 6)):
    """n requests (prompts 4 / 8, and 12 that stream in chunks of 8 for
    token-only decoders), patch prefixes for the VLM."""
    lens = (4, 8) if cfg.frontend is not None else (4, 8, 12)
    queue = RequestQueue.synthetic(n, cfg.vocab, prompt_lens=lens,
                                   new_tokens=new_tokens, seed=seed)
    if cfg.frontend == "patch":
        rng = np.random.default_rng(seed)
        for r in queue._pending:
            r.frames = (rng.standard_normal(
                (cfg.frontend_len, cfg.frontend_dim)) * 0.1).astype(
                    np.float32)
    return queue


def _scfg(cfg, **kw):
    base = dict(num_slots=3, max_len=32, prefill_pack=2,
                chunk_len=None if cfg.frontend is not None else 8,
                cache_dtype=F32, record_logits=True, block_size=8)
    return ServeConfig(**{**base, **kw})


def serve_stints(cfg, params, queue, scfg):
    """Run the scheduler, recording each request's stints: a list of
    (kind, batch, row, slot, start) per rid, ``kind`` "group" / "chunk"
    for a prefill at (batch, row), "restore" for a recurrent-only resume;
    ``start`` is the count of tokens generated when the stint began.
    Returns (metrics, stints, scheduler)."""
    sched = Scheduler(cfg, params, scfg)
    stints, pending = {}, {}
    group_fn, chunk_fn = sched._prefill_group, sched._prefill_chunked
    paged_fn = sched._prefill_chunked_paged
    insert_fn = sched.slots.insert
    prefilled_fn = getattr(sched.slots, "insert_prefilled", None)

    def prefill_group(group):
        for row, r in enumerate(group):
            pending[r.rid] = ("group", len(group), row)
        return group_fn(group)

    def prefill_chunked(req):
        pending[req.rid] = ("chunk", 1, 0)
        return chunk_fn(req)

    def prefill_chunked_paged(req):
        pending[req.rid] = ("chunk", 1, 0)
        return paged_fn(req)

    def record(req, i, resume):
        kind = pending.pop(req.rid, ("restore", 1, 0))
        start = 1 if resume is None else resume.generated
        stints.setdefault(req.rid, []).append(kind + (i, start))
        return i

    def insert(req, row_cache, row, first_token, pos, **kw):
        return record(req, insert_fn(req, row_cache, row, first_token, pos,
                                     **kw), kw.get("resume"))

    def insert_prefilled(req, table, first_token, pos, **kw):
        return record(req, prefilled_fn(req, table, first_token, pos, **kw),
                      kw.get("resume"))

    sched._prefill_group = prefill_group
    sched._prefill_chunked = prefill_chunked
    sched._prefill_chunked_paged = prefill_chunked_paged
    sched.slots.insert = insert
    if prefilled_fn is not None:
        sched.slots.insert_prefilled = insert_prefilled
    return sched.run(queue), stints, sched


@torch.inference_mode()
def replay_stints(cfg, params, scfg, req, stints, tokens):
    """The request alone at the shapes it was served at, through the
    contiguous functions, fed the served ``tokens``: each stint's prefill
    (of the prompt plus the tokens fed before it) at its group size and
    row or in chunks, its row written into slot ``slot`` of a
    ``num_slots`` decode cache (a resume then restores the recurrent rows
    saved from the previous stint's slot), decode in that row with the
    other rows idle.  Logits of each token."""
    m, key, prefix = model_fns(cfg), _key(cfg), _prefix(cfg)
    dcache = m.init_cache(cfg, scfg.num_slots, scfg.max_len,
                          scfg.cache_dtype, device="cpu")
    rec_paths = [p for p, _ in tree.flatten(dcache)
                 if p.split("/")[0] not in PAGED_CACHE_KEYS]
    out, prev = [], None
    for s, (kind, batch, row, slot, start) in enumerate(stints):
        end = stints[s + 1][4] if s + 1 < len(stints) else len(tokens)
        fed = np.concatenate([req.tokens,
                              np.asarray(tokens[:start - 1], np.int32)])
        leaves = dict(tree.flatten(dcache))
        saved = None if prev is None else \
            {p: leaves[p][:, prev].clone() for p in rec_paths}
        if kind == "chunk":
            cache = m.init_cache(cfg, 1, scfg.max_len, scfg.cache_dtype,
                                 device="cpu")
            for off in range(0, len(fed), scfg.chunk_len):
                logits, cache = tserve.prefill_chunk_fn(
                    cfg, params, torch.from_numpy(
                        fed[None, off:off + scfg.chunk_len]), cache, off)
        elif kind == "group":
            toks = np.zeros((batch, len(fed)), np.int32)
            toks[row] = fed
            kw = {}
            if key is not None:
                fr = np.zeros((batch,) + req.frames.shape, np.float32)
                fr[row] = req.frames
                kw[key] = torch.from_numpy(fr)
            logits, cache = tserve.prefill_fn(
                cfg, params, torch.from_numpy(toks), scfg.max_len,
                cache_dtype=scfg.cache_dtype, **kw)
        if kind != "restore":
            rows = dict(tree.flatten(cache))
            for p, leaf in leaves.items():
                leaf[:, slot] = rows[p][:, row]
        if s == 0:
            out.append(logits[row].numpy())
        if saved is not None:
            for p, v in saved.items():
                leaves[p][:, slot] = v
        tok = np.zeros(scfg.num_slots, np.int32)
        pos = np.zeros(scfg.num_slots, np.int32)
        pos[slot] = len(fed) + prefix
        for g in range(start, end):
            tok[slot] = tokens[g - 1]
            logits, _ = tserve.decode_fn(cfg, params, torch.from_numpy(tok),
                                         dcache, torch.from_numpy(pos))
            out.append(logits[slot].numpy())
            pos[slot] += 1
        prev = slot
    return out


def _assert_same_logits(a, b, what):
    assert list(a.requests) == list(b.requests), what
    for rid, rec in a.requests.items():
        other = b.requests[rid]
        assert rec.tokens == other.tokens, (what, rid)
        assert len(rec.logits) == len(other.logits), (what, rid)
        for i, (x, y) in enumerate(zip(rec.logits, other.logits)):
            assert np.array_equal(x, y), f"{what} rid {rid} token {i}"


# ------------------------------------------------ twins of test_serve.py

@pytest.fixture(scope="module",
                params=["smollm-360m", "deepseek-v3-671b", "xlstm-350m"])
def served_paged(request):
    """The slot workload on the paged allocator, with the
    ``preempt_every`` drill forcing preempt → requeue → resume cycles."""
    cfg, params = _build(request.param)
    queue = _queue(cfg)
    reqs = {r.rid: r for r in queue._pending}
    scfg = _scfg(cfg, kv="paged", preempt_every=4)
    metrics, stints, sched = serve_stints(cfg, params, queue, scfg)
    return cfg, params, scfg, metrics, reqs, stints


def test_paged_requests_complete(served_paged):
    cfg, params, scfg, metrics, reqs, stints = served_paged
    assert len(metrics.requests) == 7
    for rec in metrics.requests.values():
        assert rec.generated == rec.requested
        assert not rec.rejected
    s = metrics.summary()
    assert s["preemptions"] >= 1
    assert s["preemptions"] == sum(r.preemptions
                                   for r in metrics.requests.values())
    assert s["preemptions"] == sum(len(v) - 1 for v in stints.values())
    if cfg.family != "ssm":
        assert s["pool_blocks"] > 0
        assert 0.0 <= s["pool_occupancy"] <= 1.0


def test_paged_pool_pressure_preempts():
    """An under-provisioned pool (1.5 slots' worth of blocks for 4 slots)
    forces organic preemption, with no drill, and every request still
    completes with its full budget."""
    cfg, params = _build("smollm-360m")
    queue = RequestQueue.synthetic(8, cfg.vocab, prompt_lens=(4, 8),
                                   new_tokens=(8, 20), seed=5)
    scfg = ServeConfig(num_slots=4, max_len=32, prefill_pack=2,
                       cache_dtype=F32, kv="paged", block_size=8,
                       pool_blocks=6)
    metrics = Scheduler(cfg, params, scfg).run(queue)
    assert metrics.preemptions >= 1
    for rec in metrics.requests.values():
        assert rec.generated == rec.requested


def test_overlength_rejected_gracefully_paged():
    """A prompt that alone fills the cache is rejected at admission, with
    the ``rejected`` marker, instead of raising out of insert; later
    fitting requests are unaffected."""
    cfg, params = _build("smollm-360m")
    q = RequestQueue()
    q.push(_req(0, 40, budget=4))       # 40 >= max_len 32: over-length
    q.push(_req(1, 8, budget=4))
    scfg = ServeConfig(num_slots=2, max_len=32, cache_dtype=F32,
                       kv="paged", block_size=8)
    metrics = Scheduler(cfg, params, scfg).run(q)
    r0, r1 = metrics.requests[0], metrics.requests[1]
    assert r0.rejected and r0.generated == 0
    assert r0.t_first is None and r0.t_done is not None
    assert not r1.rejected and r1.generated == 4
    assert metrics.summary()["rejected"] == 1


def test_paged_beats_contiguous_concurrency_equal_memory():
    """At equal cache bytes (12 blocks × 8 tokens), the paged tier keeps
    strictly more requests in flight than the contiguous tier on a bimodal
    long + short workload: short requests reserve only the blocks they
    touch."""
    cfg, params = _build("smollm-360m")

    def wl():
        return RequestQueue.synthetic(12, cfg.vocab, prompt_lens=(4,),
                                      budgets=(4, 4, 4, 24), seed=11)
    cont = Scheduler(cfg, params, ServeConfig(
        num_slots=3, max_len=32, cache_dtype=F32)).run(wl())
    paged = Scheduler(cfg, params, ServeConfig(
        num_slots=6, max_len=32, cache_dtype=F32, kv="paged",
        block_size=8, pool_blocks=12)).run(wl())
    cs, ps = cont.summary(), paged.summary()
    assert ps["tokens"] == cs["tokens"]
    assert ps["concurrent_mean"] > cs["concurrent_mean"], (cs, ps)
    assert ps["decode_steps"] < cs["decode_steps"], (cs, ps)
    for rec in paged.requests.values():
        assert rec.generated == rec.requested


def _prefilled_row(cfg, params):
    _, rcache = ttransformer.prefill(cfg, params,
                                     torch.zeros(1, 4, dtype=torch.int32),
                                     16, cache_dtype=F32)
    return rcache


def test_paged_slot_units():
    """PagedSlotManager lifecycle: block accounting across insert /
    advance / evict, table release, the null-block invariant, the
    prefilled row scattered into its blocks."""
    cfg, params = _build("smollm-360m")
    sm = PagedSlotManager(cfg, 2, max_len=16, block_size=4,
                          cache_dtype=F32, device="cpu")
    assert sm.max_len == 16 and sm.blocks_per_slot == 4
    assert sm.pool.num_blocks == 8 and sm.pool.num_free == 8
    assert sm.cache["k"].shape[1:3] == (9, 4)          # P + null, bs
    rcache = _prefilled_row(cfg, params)
    i = sm.insert(_req(0, 4), rcache, 0, first_token=1, pos=4)
    assert sm.tables[i].num_blocks == 2          # covers positions 0..4
    assert sm.pool.num_free == 6
    assert NULL_BLOCK not in sm.tables[i].blocks
    view = tlayers._paged_read(sm.cache["k"][0], torch.tensor(
        [sm.tables[i].blocks]))
    assert torch.equal(view[0], rcache["k"][0, 0, :8])
    bt = sm.block_tables()
    assert bt.shape == (2, 4)
    assert (bt[1 - i] == NULL_BLOCK).all()       # free slot: all-null row
    assert sm.pool_stats() == (8, 4, 8, 2)
    sm.evict(i)
    assert sm.pool.num_free == 8 and sm.tables[i] is None
    # exhaustion: two full-length tables drain the pool
    a = sm.insert(_req(1, 4), rcache, 0, first_token=1, pos=15)
    b = sm.insert(_req(2, 4), rcache, 0, first_token=1, pos=11)
    assert sm.pool.num_free == 1
    sm.pos[b] = 15                               # next write needs a block
    assert sm.prepare_decode() == []             # 1 free block: fits
    assert sm.pool.num_free == 0
    assert sm.tables[a].num_blocks == 4 and sm.tables[b].num_blocks == 4


def test_paged_prepare_decode_preempts_youngest():
    cfg, params = _build("smollm-360m")
    sm = PagedSlotManager(cfg, 2, max_len=16, block_size=4, pool_blocks=5,
                          cache_dtype=F32, device="cpu")
    rcache = _prefilled_row(cfg, params)
    a = sm.insert(_req(0, 4), rcache, 0, first_token=1, pos=7)   # 2 blocks
    b = sm.insert(_req(1, 4), rcache, 0, first_token=1, pos=7)   # 2 blocks
    sm.advance(a, 3)                             # pos 8: needs a 3rd block
    sm.advance(b, 3)
    preempted = sm.prepare_decode()
    assert [p.request.rid for p in preempted] == [1]   # youngest evicted
    assert sm.slots[b] is None and sm.num_active == 1
    assert preempted[0].generated == 2 and preempted[0].tokens == [1, 3]
    assert preempted[0].recurrent is None        # nothing recurrent: dense
    assert sm.tables[a].num_blocks == 3


def test_paged_preempt_saves_exact_recurrent_rows():
    """A hybrid's preemption copies its slot's conv / ssm_h rows out of the
    live cache, and a resume writes them back into its new slot."""
    cfg, params = _build("hymba-1.5b")
    sm = PagedSlotManager(cfg, 2, max_len=16, block_size=4,
                          cache_dtype=F32, device="cpu")
    rcache = _prefilled_row(cfg, params)
    a = sm.insert(_req(0, 4), rcache, 0, first_token=1, pos=4)
    want = {k: sm.cache[k][:, a].clone() for k in ("conv", "ssm_h")}
    assert torch.equal(want["ssm_h"], rcache["ssm_h"][:, 0])
    ps = sm.preempt(a)
    for k in ("conv", "ssm_h"):
        sm.cache[k].zero_()                      # the slot is reused
        assert torch.equal(ps.recurrent[k], want[k])
    j = sm.insert(_req(0, 4), None, 0, first_token=1, pos=4, resume=ps)
    for k in ("conv", "ssm_h"):
        assert torch.equal(sm.cache[k][:, j], want[k])
    assert sm.slots[j].seq == ps.seq and sm.pool.num_live == 2


def test_paged_encdec_unsupported():
    cfg, params = _build("seamless-m4t-large-v2")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        PagedSlotManager(cfg, 2, max_len=16, enc_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Scheduler(cfg, params, ServeConfig(kv="paged", enc_len=8))


def test_paged_requires_a_full_length_pool():
    cfg, _ = _build("smollm-360m")
    with pytest.raises(ValueError, match="cannot hold one full-length"):
        PagedSlotManager(cfg, 2, max_len=16, block_size=4, pool_blocks=3,
                         device="cpu")


# -------------------------------------------- parity 1: same schedule

@pytest.mark.parametrize("arch", SAME_SCHEDULE_ARCHS)
def test_paged_equals_contiguous_same_schedule_bitwise(arch):
    """The same queue through the contiguous and the paged tier (default
    pool, ``watermark=0``): every request's logits bit for bit, the same
    admissions and decode steps, and the paged run really on the pool."""
    cfg, params = _build(arch)
    cont, cstints, _ = serve_stints(cfg, params, _queue(cfg), _scfg(cfg))
    paged, pstints, sched = serve_stints(
        cfg, params, _queue(cfg), _scfg(cfg, kv="paged", watermark=0.0))
    assert cstints == pstints
    assert paged.active_per_step == cont.active_per_step
    _assert_same_logits(cont, paged, arch)
    if cfg.family != "ssm":
        assert sched._use_tables
        pool = sched.slots.cache[PAGED_CACHE_KEYS[0] if cfg.attn_kind !=
                                 "mla" else "ckv"]
        assert pool.shape[1] == sched.slots.pool.num_blocks + 1
        assert paged.summary()["pool_occupancy"] > 0
    kinds = {s[0] for v in pstints.values() for s in v}
    assert "chunk" in kinds or cfg.frontend is not None


# ------------------------------------------------- parity 2: drill replay

@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "llava-next-mistral-7b"])
def test_drill_equals_replay_at_served_shape_bitwise(arch):
    """Under ``preempt_every=2`` every request, preempted ones included,
    equals its replay at the shapes it was served at, bit for bit."""
    cfg, params = _build(arch)
    queue = _queue(cfg, new_tokens=(4, 8))
    reqs = {r.rid: r for r in queue._pending}
    scfg = _scfg(cfg, kv="paged", preempt_every=2)
    metrics, stints, _ = serve_stints(cfg, params, queue, scfg)
    assert metrics.preemptions >= 2
    resumed = [rid for rid, v in stints.items() if len(v) > 1]
    assert resumed
    if cfg.frontend is None:   # a resume re-prefilled in chunks
        assert any(s[0] == "chunk" for rid in resumed
                   for s in stints[rid][1:])
    for rid, rec in metrics.requests.items():
        assert rec.generated == rec.requested
        got = replay_stints(cfg, params, scfg, reqs[rid], stints[rid],
                            rec.tokens)
        assert [int(np.argmax(g)) for g in got] == rec.tokens, rid
        for i, (a, b) in enumerate(zip(got, rec.logits)):
            assert np.array_equal(a, b), \
                f"rid {rid} token {i} ({stints[rid]}): served != replay"


def test_xlstm_drill_equals_unpreempted_bitwise():
    """xLSTM's resume restores the exact recurrent state with no
    recompute, so each preempted request equals its unpreempted run, bit
    for bit: the same admission (prefill group and row) decoded to the end
    in its first slot."""
    cfg, params = _build("xlstm-350m")
    queue = _queue(cfg)
    reqs = {r.rid: r for r in queue._pending}
    scfg = _scfg(cfg, kv="paged", preempt_every=2)
    metrics, stints, _ = serve_stints(cfg, params, queue, scfg)
    assert metrics.preemptions >= 2
    resumed = [rid for rid, v in stints.items() if len(v) > 1]
    assert resumed and all(s[0] == "restore" for rid in resumed
                           for s in stints[rid][1:])
    for rid in resumed:
        rec = metrics.requests[rid]
        want = replay_stints(cfg, params, scfg, reqs[rid], stints[rid][:1],
                             rec.tokens)
        assert [int(np.argmax(w)) for w in want] == rec.tokens, rid
        for a, b in zip(rec.logits, want):
            assert np.array_equal(a, b), rid


# --------------------------------------- parity 3: port vs the reference

def _both(arch):
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    jp = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = ttransformer.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    return jcfg, tcfg, jp, tp


def _to_np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _assert_tree(got, want, tol=TOL, what=""):
    want = dict(tree.flatten(jax.tree.map(np.asarray, want)))
    got = dict(tree.flatten(got))
    assert set(got) == set(want), what
    for p, g in got.items():
        w = want[p].astype(np.float32)
        assert tuple(g.shape) == w.shape, (what, p)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_to_np(g), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"{what} {p}")


@pytest.mark.parametrize("tail", [(3,), (2, 4)])
def test_paged_write_and_read_match_reference(tail):
    """Scalar-pos chunk writes through row 0's table and vector-pos writes
    (one row on the null table) into a (P, bs, ...) pool, then the
    gathered view, against the reference's."""
    rng = np.random.default_rng(4)
    P, bs = 7, 4
    tables = np.array([[2, 5, 1], [6, 3, 0], [0, 0, 0]], np.int32)
    pool = rng.standard_normal((P, bs) + tail).astype(np.float32)
    jleaf, tleaf = jnp.asarray(pool), torch.from_numpy(pool.copy())
    for pos, bt in [(1, tables[:1]), (np.array([9, 5, 0], np.int32),
                                      tables)]:
        S = 6 if np.ndim(pos) == 0 else 1
        new = rng.standard_normal((bt.shape[0], S) + tail).astype(np.float32)
        jleaf = jlayers._paged_write(jleaf, jnp.asarray(new),
                                     jnp.asarray(bt), jnp.asarray(pos), bs)
        out = tlayers._paged_write(tleaf, torch.from_numpy(new),
                                   torch.from_numpy(bt).long(),
                                   torch.from_numpy(pos) if np.ndim(pos)
                                   else pos, bs)
        assert out is tleaf
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), **TOL)
        np.testing.assert_allclose(
            tlayers._paged_read(tleaf, torch.from_numpy(bt).long()).numpy(),
            np.asarray(jlayers._paged_read(jleaf, jnp.asarray(bt))), **TOL)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b",
                                  "hymba-1.5b", "llava-next-mistral-7b"])
def test_init_paged_cache_matches_reference(arch):
    jcfg, tcfg = (jconfigs.get(arch, reduced=True),
                  tconfigs.get(arch, reduced=True))
    for jdt, tdt in [(jnp.float32, F32), (jnp.bfloat16, torch.bfloat16)]:
        want = jtransformer.init_paged_cache(jcfg, 3, 9, 4, jdt)
        got = ttransformer.init_paged_cache(tcfg, 3, 9, 4, tdt, device="cpu")
        want = dict(tree.flatten(want))
        got = dict(tree.flatten(got))
        assert set(got) == set(want)
        for p, g in got.items():
            assert tuple(g.shape) == want[p].shape, (arch, p)
            assert str(g.dtype).split(".")[-1] == str(want[p].dtype), p
            assert not g.count_nonzero() and not np.asarray(want[p]).any()


def test_init_paged_cache_refuses_what_cannot_page():
    cfg = tconfigs.get("xlstm-350m", reduced=True)
    with pytest.raises(ValueError, match="nothing to page"):
        ttransformer.init_paged_cache(cfg, 2, 5, 4, device="cpu")
    rolling = dataclasses.replace(tconfigs.get("hymba-1.5b", reduced=True),
                                  global_layers=())
    with pytest.raises(NotImplementedError, match="rolling"):
        ttransformer.init_paged_cache(rolling, 2, 5, 4, device="cpu")


def _pools(jcfg, tcfg, batch, dtype, seed):
    """The same random (L, P, bs, ...) pools (and recurrent rows) in both
    packages."""
    shapes = jtransformer.init_paged_cache(jcfg, batch, 9, 4, jnp.float32)
    rng = np.random.default_rng(seed)
    vals = {p: (rng.standard_normal(np.shape(v)) * 0.5).astype(np.float32)
            for p, v in tree.flatten(shapes)}
    jcache = tree.rebuild(shapes, {p: jnp.asarray(v).astype(
        dtype[0] if p in PAGED_CACHE_KEYS else jnp.float32)
        for p, v in vals.items()})
    tcache = tree.rebuild(shapes, {p: torch.from_numpy(v.copy()).to(
        dtype[1] if p in PAGED_CACHE_KEYS else F32)
        for p, v in vals.items()})
    return jcache, tcache


@pytest.mark.parametrize("arch,dtype", [
    ("smollm-360m", "float32"), ("deepseek-v3-671b", "float32"),
    ("hymba-1.5b", "float32"), ("llava-next-mistral-7b", "float32"),
    ("smollm-360m", "bfloat16")])
def test_paged_decode_matches_reference(arch, dtype):
    """Two paged decode steps over 3 slots at per-slot positions (one slot
    free, on the all-null table), logits and every pool / recurrent leaf
    against the reference's."""
    jcfg, tcfg, jp, tp = _both(arch)
    dts = ((jnp.float32, F32) if dtype == "float32"
           else (jnp.bfloat16, torch.bfloat16))
    tol = TOL if dtype == "float32" else BF16_TOL
    jc, tc = _pools(jcfg, tcfg, 3, dts, seed=1)
    tables = np.array([[4, 1, 7], [2, 8, 0], [0, 0, 0]], np.int32)
    pos = np.array([9, 5, 0], np.int32)
    tok = np.array([3, 11, 0], np.int32)
    decode = jax.jit(lambda p, t, c, q, bt: jserve.decode_fn(
        jcfg, p, t, c, q, block_tables=bt))
    for step in range(2):
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                        jnp.asarray(tables))
        tl, tc = tserve.decode_fn(tcfg, tp, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos),
                                  block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"{arch} step {step}")
        _assert_tree(tc, jc, tol, what=f"{arch} step {step}")
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + np.array([1, 1, 0], np.int32)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b",
                                  "hymba-1.5b"])
def test_paged_prefill_chunk_matches_reference(arch):
    """A 10-token prompt in chunks of 4 / 4 / 2 through a batch-1 block
    table into the pool, logits and leaves after each chunk."""
    jcfg, tcfg, jp, tp = _both(arch)
    jc, tc = _pools(jcfg, tcfg, 1, (jnp.float32, F32), seed=2)
    table = np.array([[5, 2, 8]], np.int32)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (1, 10)).astype(
        np.int32)
    chunk = jax.jit(lambda p, t, c, q, bt: jserve.prefill_chunk_fn(
        jcfg, p, t, c, q, block_tables=bt))
    for off, n in [(0, 4), (4, 4), (8, 2)]:
        jl, jc = chunk(jp, jnp.asarray(toks[:, off:off + n]), jc,
                       jnp.asarray(off, jnp.int32), jnp.asarray(table))
        tl, tc = tserve.prefill_chunk_fn(
            tcfg, tp, torch.from_numpy(toks[:, off:off + n]), tc, off,
            block_tables=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} chunk at {off}")
        _assert_tree(tc, jc, what=f"{arch} chunk at {off}")


# ------------------------------------- parity 4: the allocator's decisions

def _record_events(sched):
    """Wrap the slot manager so every admission (slot, block ids),
    preemption and decode's block tables lands in one event list."""
    slots, events = sched.slots, []
    insert, prefilled = slots.insert, slots.insert_prefilled
    preempt, prepare = slots.preempt, slots.prepare_decode

    def blocks(i):
        t = slots.tables[i]
        return None if t is None else [int(b) for b in t.blocks]

    def on_insert(req, *a, **kw):
        i = insert(req, *a, **kw)
        events.append(("insert", req.rid, i, blocks(i),
                       kw.get("resume") is not None))
        return i

    def on_prefilled(req, *a, **kw):
        i = prefilled(req, *a, **kw)
        events.append(("insert_prefilled", req.rid, i, blocks(i),
                       kw.get("resume") is not None))
        return i

    def on_preempt(i):
        events.append(("preempt", slots.slots[i].request.rid, i))
        return preempt(i)

    def on_prepare():
        out = prepare()
        events.append(("tables", np.asarray(slots.block_tables()).tolist()))
        return out

    slots.insert, slots.insert_prefilled = on_insert, on_prefilled
    slots.preempt, slots.prepare_decode = on_preempt, on_prepare
    return events


@pytest.mark.parametrize("arch,kw", [
    ("smollm-360m", dict(num_slots=4, pool_blocks=6)),
    ("smollm-360m", dict(num_slots=3, preempt_every=3)),
    ("hymba-1.5b", dict(num_slots=4, pool_blocks=7))],
    ids=["pressure", "drill", "hybrid"])
def test_allocator_decisions_equal_reference(arch, kw):
    """The same queue (prompts 4 / 8 / 12, chunks of 8) through the
    reference's paged Scheduler and the port's: the same admissions into
    the same slots and block ids, the same preemptions and table growth,
    the same admission order, per-request preemptions and decode steps
    (none of which depends on the sampled token values)."""
    from repro.serve import RequestQueue as JQueue
    from repro.serve import Scheduler as JScheduler
    from repro.serve import ServeConfig as JServeConfig
    jcfg, tcfg, jp, tp = _both(arch)
    geometry = dict(max_len=32, prefill_pack=2, chunk_len=8, block_size=8,
                    kv="paged", **kw)
    qkw = dict(prompt_lens=(4, 8, 12), new_tokens=(6, 16), seed=5)
    jsched = JScheduler(jcfg, jp, JServeConfig(cache_dtype=jnp.float32,
                                               **geometry))
    tsched = Scheduler(tcfg, tp, ServeConfig(cache_dtype=F32, **geometry))
    jev, tev = _record_events(jsched), _record_events(tsched)
    jm = jsched.run(JQueue.synthetic(9, jcfg.vocab, **qkw))
    tm = tsched.run(RequestQueue.synthetic(9, tcfg.vocab, **qkw))
    assert tm.preemptions >= 1 and tm.preemptions == jm.preemptions
    assert len(tev) == len(jev)
    for i, (a, b) in enumerate(zip(tev, jev)):
        assert a == b, f"event {i}: port {a} != reference {b}"
    assert list(tm.requests) == list(jm.requests)
    assert {r: v.preemptions for r, v in tm.requests.items()} == \
        {r: v.preemptions for r, v in jm.requests.items()}
    assert tm.active_per_step == jm.active_per_step
    assert tm.pool_samples == jm.pool_samples
    for key in ("requests", "tokens", "decode_steps", "preemptions",
                "rejected"):
        assert tm.summary()[key] == jm.summary()[key], key
