"""Slot parity of the port's serving tier, on the CPU at reduced widths
with fp32 caches.

A request served through the continuous-batching scheduler — prefilled
packed with strangers, written into a recycled slot row, decoded in a
batch whose other rows sit at other depths — gives logits equal, bit for
bit, to a replay of that request alone at the shapes the scheduler served
it at: its prefill group size and row (the other rows zero), or batch 1
and the same chunks for a chunked prompt; then decode at ``num_slots`` in
the same slot row, every other row idle.  That checks the row copies on
insert and evict, slot recycling, per-row positions and masks that never
read past a slot's position.  The shapes are recorded by wrapping the
scheduler's prefill, chunk and insert calls.

A batch-1 solo run (batch-1 prefill, scalar-pos decode) is another shape:
a library may reduce differently at another batch size, so it is held
within 1e-5 of the largest logit, with equal greedy tokens, and the
largest distance is reported.  MoE rows share expert capacity, so a
replay with idle rows is another computation: DeepSeek-V3 is held to two
runs of one schedule being bitwise equal.  Chunked prefill equals one-shot
prefill within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import tree
from repro_torch.models import model_fns
from repro_torch.serve import RequestQueue, Scheduler, ServeConfig
from repro_torch.serve.scheduler import _frontend_key as _key
from repro_torch.serve.scheduler import _prefix_len as _prefix
from repro_torch.train import serve as tserve

PARITY_ARCHS = ["smollm-360m", "xlstm-350m", "seamless-m4t-large-v2",
                "hymba-1.5b", "llava-next-mistral-7b"]
SOLO_TOL = 1e-5
F32 = torch.float32


def _build(arch):
    cfg = tconfigs.get(arch, reduced=True)
    return cfg, model_fns(cfg).init(cfg, seed=0, device="cpu")


def _workload(cfg, seed=3, cache_dtype=F32):
    """7 requests through 3 slots (packed prefill, mixed budgets, recycled
    rows); token-only decoders also get 12-token prompts that stream in
    chunks of 8; frontend archs get their frames or patches."""
    if cfg.encdec:
        kw = dict(frontend_dim=cfg.frontend_dim, prompt_lens=(8,))
    elif cfg.frontend is not None:
        kw = dict(prompt_lens=(4, 8))
    else:
        kw = dict(prompt_lens=(4, 8, 12))
    queue = RequestQueue.synthetic(7, cfg.vocab, new_tokens=(2, 6),
                                   seed=seed, **kw)
    if cfg.frontend == "patch":         # one image prefix a request
        rng = np.random.default_rng(seed)
        for r in queue._pending:
            r.frames = (rng.standard_normal(
                (cfg.frontend_len, cfg.frontend_dim)) * 0.1).astype(
                    np.float32)
    chunk = 8 if cfg.frontend is None and not cfg.encdec else None
    scfg = ServeConfig(num_slots=3, max_len=32, prefill_pack=2,
                       chunk_len=chunk, cache_dtype=cache_dtype,
                       record_logits=True,
                       enc_len=8 if cfg.encdec else None)
    return queue, scfg


def serve_recorded(cfg, params, queue, scfg):
    """Run the scheduler, recording each request's served shapes:
    {rid: (kind, batch, row, slot)}."""
    sched = Scheduler(cfg, params, scfg)
    shapes = {}
    group_fn, chunk_fn = sched._prefill_group, sched._prefill_chunked
    insert_fn = sched.slots.insert

    def prefill_group(group):
        for row, r in enumerate(group):
            shapes[r.rid] = ["group", len(group), row]
        return group_fn(group)

    def prefill_chunked(req):
        shapes[req.rid] = ["chunk", 1, 0]
        return chunk_fn(req)

    def insert(req, row_cache, row, first_token, pos):
        i = insert_fn(req, row_cache, row, first_token, pos)
        shapes[req.rid].append(i)
        return i

    sched._prefill_group = prefill_group
    sched._prefill_chunked = prefill_chunked
    sched.slots.insert = insert
    return sched.run(queue), {k: tuple(v) for k, v in shapes.items()}


def _device(params):
    return tree.flatten(params)[0][1].device


@torch.inference_mode()
def replay(cfg, params, scfg, req, shape, n_tokens):
    """The request alone at its served shape, on the parameters' device:
    logits of each token, on the host."""
    kind, batch, row, slot = shape
    key, dev = _key(cfg), _device(params)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if kind == "chunk":
        cache = model_fns(cfg).init_cache(cfg, 1, scfg.max_len,
                                          scfg.cache_dtype, device=dev)
        for off in range(0, req.prompt_len, scfg.chunk_len):
            logits, cache = tserve.prefill_chunk_fn(
                cfg, params, t(req.tokens[None, off:off + scfg.chunk_len]),
                cache, off)
    else:
        toks = np.zeros((batch, req.prompt_len), np.int32)
        toks[row] = req.tokens
        kw = {}
        if key is not None:
            fr = np.zeros((batch,) + req.frames.shape, np.float32)
            fr[row] = req.frames
            kw[key] = t(fr)
        logits, cache = tserve.prefill_fn(cfg, params, t(toks), scfg.max_len,
                                          cache_dtype=scfg.cache_dtype, **kw)
    out = [logits[row].cpu().numpy()]
    m = model_fns(cfg)
    lens = (scfg.max_len, scfg.enc_len) if cfg.encdec else (scfg.max_len,)
    dcache = m.init_cache(cfg, scfg.num_slots, *lens, scfg.cache_dtype,
                          device=dev)
    rows = dict(tree.flatten(cache))
    for path, leaf in tree.flatten(dcache):
        leaf[:, slot] = rows[path][:, row]
    tok = np.zeros(scfg.num_slots, np.int32)
    pos = np.zeros(scfg.num_slots, np.int32)
    tok[slot] = int(np.argmax(out[0]))
    pos[slot] = req.prompt_len + _prefix(cfg)
    for _ in range(1, n_tokens):
        logits, _ = tserve.decode_fn(cfg, params, t(tok), dcache, t(pos))
        out.append(logits[slot].cpu().numpy())
        tok[slot] = int(np.argmax(out[-1]))
        pos[slot] += 1
    return out


@torch.inference_mode()
def solo(cfg, params, scfg, req, n_tokens):
    """Batch-1 prefill of the whole prompt, then scalar-pos decode."""
    key, dev = _key(cfg), _device(params)
    kw = {} if key is None else {
        key: torch.from_numpy(req.frames[None]).to(dev)}
    logits, cache = tserve.prefill_fn(
        cfg, params, torch.from_numpy(req.tokens[None]).to(dev),
        scfg.max_len, cache_dtype=scfg.cache_dtype, **kw)
    out = [logits[0].cpu().numpy()]
    for i in range(1, n_tokens):
        tok = torch.tensor([int(np.argmax(out[-1]))], dtype=torch.int32,
                           device=dev)
        logits, cache = tserve.decode_fn(
            cfg, params, tok, cache, req.prompt_len + _prefix(cfg) + i - 1)
        out.append(logits[0].cpu().numpy())
    return out


@pytest.fixture(scope="module", params=PARITY_ARCHS)
def served(request):
    cfg, params = _build(request.param)
    queue, scfg = _workload(cfg)
    reqs = {r.rid: r for r in queue._pending}
    metrics, shapes = serve_recorded(cfg, params, queue, scfg)
    return cfg, params, scfg, metrics, reqs, shapes


def test_served_requests_complete(served):
    cfg, params, scfg, metrics, reqs, shapes = served
    assert len(metrics.requests) == 7
    for rec in metrics.requests.values():
        assert rec.generated == rec.requested
        assert rec.t_first is not None and rec.t_done is not None
        assert rec.t_done >= rec.t_first >= rec.arrival
        assert len(rec.logits) == rec.generated
    kinds = {s[0] for s in shapes.values()}
    assert "group" in kinds
    if scfg.chunk_len is not None:
        assert "chunk" in kinds
    assert any(s[1] == 2 for s in shapes.values())      # a packed prefill
    assert len({s[3] for s in shapes.values()}) == 3    # every slot used


def test_metrics_summary_sane(served):
    cfg, params, scfg, metrics, reqs, shapes = served
    s = metrics.summary()
    assert s["requests"] == 7
    assert s["tokens"] == sum(r.generated for r in metrics.requests.values())
    assert 0.0 < s["slot_occupancy"] <= 1.0
    assert s["tokens_per_sec"] > 0
    assert s["tokens_per_sec_per_chip"] == s["tokens_per_sec"]
    assert s["ttft_ms_p90"] >= s["ttft_ms_median"] >= 0
    assert s["decode_steps"] == len(metrics.decode_step_s)


def test_slot_equals_replay_at_served_shape_bitwise(served):
    """Every served logit stream equals its replay at the served shape,
    bit for bit, with the same greedy tokens."""
    cfg, params, scfg, metrics, reqs, shapes = served
    for rid, rec in metrics.requests.items():
        ref = replay(cfg, params, scfg, reqs[rid], shapes[rid],
                     rec.generated)
        assert [int(np.argmax(r)) for r in ref] == rec.tokens, rid
        for i, (a, b) in enumerate(zip(ref, rec.logits)):
            assert np.array_equal(a, b), \
                f"rid {rid} token {i} ({shapes[rid]}): served != replay"


def test_served_within_batch1_solo(served):
    """Against a batch-1 solo run: the same greedy tokens, logits within
    1e-5 of the largest (the largest distance is in the message)."""
    cfg, params, scfg, metrics, reqs, shapes = served
    worst = 0.0
    for rid, rec in metrics.requests.items():
        ref = solo(cfg, params, scfg, reqs[rid], rec.generated)
        assert [int(np.argmax(r)) for r in ref] == rec.tokens, rid
        for a, b in zip(ref, rec.logits):
            worst = max(worst, float(np.abs(a - b).max()
                                     / np.abs(a).max()))
    assert worst <= SOLO_TOL, f"largest relative distance {worst:.3e}"


def test_moe_two_runs_of_one_schedule_bitwise():
    """DeepSeek-V3 (MoE rows share expert capacity): the same schedule
    twice gives the same tokens and logits bit for bit."""
    cfg, params = _build("deepseek-v3-671b")
    runs = []
    for _ in range(2):
        queue, scfg = _workload(cfg, seed=4)
        runs.append(serve_recorded(cfg, params, queue, scfg))
    (m1, s1), (m2, s2) = runs
    assert s1 == s2 and list(m1.requests) == list(m2.requests)
    for rid, rec in m1.requests.items():
        other = m2.requests[rid]
        assert rec.tokens == other.tokens and rec.generated == rec.requested
        for a, b in zip(rec.logits, other.logits):
            assert np.array_equal(a, b), rid


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-350m",
                                  "hymba-1.5b", "deepseek-v3-671b"])
def test_chunked_prefill_matches_one_shot(arch):
    """prefill_chunk over an existing cache (3 chunks of 4) == one-shot
    prefill within 1e-5: logits and every cache leaf (the reference's
    bitwise claim rests on the batch premise; the recurrent families
    re-associate their scans)."""
    cfg, params = _build(arch)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, 12)).astype(np.int32))
    full, fcache = tserve.prefill_fn(cfg, params, toks, 24, cache_dtype=F32)
    cache = model_fns(cfg).init_cache(cfg, 1, 24, F32, device="cpu")
    for off in range(0, 12, 4):
        logits, cache = tserve.prefill_chunk_fn(cfg, params,
                                                toks[:, off:off + 4], cache,
                                                off)
    scale = float(full.abs().max())
    assert float((logits - full).abs().max()) <= 1e-5 * scale, arch
    want = dict(tree.flatten(fcache))
    for p, v in tree.flatten(cache):
        w = want[p]
        assert float((v - w).abs().max()) <= 1e-5 * max(
            1.0, float(w.abs().max())), (arch, p)
