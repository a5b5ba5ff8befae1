"""The port's contiguous serving tier (``repro_torch.serve``): twins of
``tests/test_serve.py``'s queue, slot and scheduler units, plus the
structure of a scheduler run against the reference's on the same
synthetic queue (decode steps, tokens, each request's count and the
admission order do not depend on the token values), the synthetic workload
request for request, and what serving under a mesh still refuses: the
families without a tensor-parallel forward (ROADMAP item 6) and the paged
pool (as the reference).  Slot parity is
``tests/test_torch_serve_parity.py``; the paged tier is
``tests/test_torch_serve_paged.py``; serving under a mesh of several ranks
is ``tests/test_torch_serve_mesh.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import (Request, RequestQueue, Scheduler, ServeConfig,
                               SlotManager, run_oneshot)

F32 = torch.float32


def _build(arch):
    cfg = tconfigs.get(arch, reduced=True)
    from repro_torch.models import model_fns
    return cfg, model_fns(cfg).init(cfg, seed=0, device="cpu")


def _req(rid, n, budget=4, arrival=0.0):
    return Request(rid=rid, tokens=np.arange(n, dtype=np.int32),
                   max_new_tokens=budget, arrival=arrival)


# ------------------------------------------------------------ queue units

def test_queue_packs_equal_lengths_only():
    q = RequestQueue([_req(0, 4), _req(1, 4), _req(2, 8), _req(3, 4)])
    q.poll(0.0)
    g = q.pop_group(3)
    assert [r.rid for r in g] == [0, 1, 3]       # len-8 skipped, kept
    assert [r.rid for r in q.pop_group(3)] == [2]
    assert q.drained


def test_queue_chunked_prompts_go_alone():
    q = RequestQueue([_req(0, 32), _req(1, 32)])
    q.poll(0.0)
    assert [r.rid for r in q.pop_group(4, chunk_len=16)] == [0]
    assert [r.rid for r in q.pop_group(4, chunk_len=16)] == [1]


def test_queue_arrivals_gate_readiness():
    q = RequestQueue([_req(0, 4, arrival=0.5), _req(1, 4, arrival=0.1)])
    assert q.num_ready == 0 and not q.drained
    assert q.next_arrival() == pytest.approx(0.1)
    assert q.poll(0.2) == 1
    assert [r.rid for r in q.pop_group(4)] == [1]
    assert q.poll(1.0) == 1
    assert [r.rid for r in q.pop_group(4)] == [0]


def test_synthetic_deterministic():
    a = RequestQueue.synthetic(5, 100, rate=10.0, seed=9)
    b = RequestQueue.synthetic(5, 100, rate=10.0, seed=9)
    for x, y in zip(a._pending, b._pending):
        assert np.array_equal(x.tokens, y.tokens)
        assert x.arrival == y.arrival and x.max_new_tokens == y.max_new_tokens


@pytest.mark.parametrize("kw", [
    dict(rate=10.0, seed=9),
    dict(prompt_lens=(4, 8, 16), mix=(0.5, 0.3, 0.2), budgets=(2, 12),
         seed=3),
    dict(prompt_lens=(8,), frontend_dim=32, new_tokens=(2, 6), seed=3)])
def test_synthetic_equals_reference_request_for_request(kw):
    """The same numpy draws in the same order: both packages build the
    same workload from a seed (tokens, budgets, arrivals, frames)."""
    pytest.importorskip("jax")
    from repro.serve import RequestQueue as JQueue
    want = JQueue.synthetic(9, 257, **kw)._pending
    got = RequestQueue.synthetic(9, 257, **kw)._pending
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.rid == w.rid and g.max_new_tokens == w.max_new_tokens
        assert g.arrival == w.arrival
        assert np.array_equal(g.tokens, w.tokens)
        assert g.tokens.dtype == w.tokens.dtype
        if w.frames is None:
            assert g.frames is None
        else:
            assert np.array_equal(g.frames, w.frames)


# ------------------------------------------------------------- slot units

def test_slot_lifecycle_and_errors():
    cfg, params = _build("smollm-360m")
    sm = SlotManager(cfg, 2, max_len=16, cache_dtype=F32, device="cpu")
    assert sm.num_free == 2 and sm.num_active == 0
    _, rcache = ttransformer.prefill(cfg, params,
                                     torch.zeros(1, 4, dtype=torch.int32),
                                     16, cache_dtype=F32)
    i = sm.insert(_req(0, 4), rcache, 0, first_token=1, pos=4)
    assert sm.num_active == 1 and int(sm.pos[i]) == 4 and int(sm.tok[i]) == 1
    assert torch.equal(sm.cache["k"][:, i], rcache["k"][:, 0])
    sm.advance(i, 7)
    assert int(sm.pos[i]) == 5 and sm.slots[i].generated == 2
    j = sm.insert(_req(1, 4), rcache, 0, first_token=2, pos=15)
    assert sm.num_free == 0
    assert sm.out_of_cache(j) is False
    sm.advance(j, 3)
    assert sm.out_of_cache(j) is True
    with pytest.raises(RuntimeError):
        sm.insert(_req(2, 4), rcache, 0, first_token=0, pos=4)
    s = sm.evict(i)
    assert s.request.rid == 0 and sm.num_free == 1
    with pytest.raises(ValueError):
        sm.evict(i)
    with pytest.raises(ValueError):
        sm.insert(_req(3, 4), rcache, 0, first_token=0, pos=16)
    # recycled row is claimed again without zeroing
    k = sm.insert(_req(4, 4), rcache, 0, first_token=5, pos=4)
    assert k == i
    assert sm.pool_stats() == (32, 4 + 16, 0, 0)


def test_encdec_slots_require_enc_len():
    cfg, _ = _build("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="enc_len"):
        SlotManager(cfg, 2, max_len=16, device="cpu")


def test_slot_cache_sits_on_the_parameters_device():
    """The scheduler's cache is on its parameters' device; an explicit
    device that differs raises (nothing moves to the CPU in silence)."""
    cfg, params = _build("smollm-360m")
    sched = Scheduler(cfg, params, ServeConfig(num_slots=2, max_len=16,
                                               cache_dtype=F32))
    assert sched.slots.cache["k"].device.type == "cpu"
    assert sched.slots.cache["k"].dtype == F32
    with pytest.raises(ValueError, match="parameters are on cpu"):
        Scheduler(cfg, params, ServeConfig(num_slots=2, max_len=16),
                  device="meta")
    mixed = {**params, "final_norm": {
        "norm_scale": params["final_norm"]["norm_scale"].to("meta")}}
    with pytest.raises(ValueError, match="span devices"):
        Scheduler(cfg, mixed, ServeConfig(num_slots=2, max_len=16))


# --------------------------------------------------------------- scheduler

def test_continuous_beats_oneshot_decode_steps():
    """Structural (count-based, deterministic): on a bimodal-budget
    workload the slot scheduler needs strictly fewer decode steps than
    lockstep rounds at the same batch size."""
    cfg, params = _build("smollm-360m")

    def wl():
        return RequestQueue.synthetic(8, cfg.vocab, prompt_lens=(4,),
                                      budgets=(2, 2, 2, 12), seed=5)
    sched = Scheduler(cfg, params, ServeConfig(num_slots=4, max_len=24,
                                               cache_dtype=F32))
    cont = sched.run(wl()).summary()
    q = wl()
    q.poll(0.0)
    reqs = [q.pop_group(1)[0] for _ in range(len(q))]
    base = run_oneshot(cfg, params, reqs, batch=4, max_len=24,
                       cache_dtype=F32).summary()
    assert cont["tokens"] == base["tokens"]
    assert cont["decode_steps"] < base["decode_steps"], \
        (cont["decode_steps"], base["decode_steps"])
    with pytest.raises(ValueError, match="uniform prompts"):
        run_oneshot(cfg, params, [_req(0, 4), _req(1, 5)], batch=2,
                    max_len=24)


def test_overlength_rejected_gracefully():
    """A prompt that alone fills the cache is rejected at admission —
    recorded done with the ``rejected`` marker — instead of raising out
    of SlotManager.insert; later fitting requests are unaffected."""
    cfg, params = _build("smollm-360m")
    q = RequestQueue()
    q.push(_req(0, 40, budget=4))       # 40 >= max_len 32: over-length
    q.push(_req(1, 8, budget=4))
    metrics = Scheduler(cfg, params, ServeConfig(
        num_slots=2, max_len=32, cache_dtype=F32)).run(q)
    r0, r1 = metrics.requests[0], metrics.requests[1]
    assert r0.rejected and r0.generated == 0
    assert r0.t_first is None and r0.t_done is not None
    assert not r1.rejected and r1.generated == 4
    assert metrics.summary()["rejected"] == 1


def test_metrics_per_chip_divides_by_the_one_card_served_on():
    from repro_torch.serve import ServeMetrics
    m = ServeMetrics(4)
    m.on_admit(_req(0, 4), 0.1, 5)
    m.on_token(0, 6)
    m.wall_s = 1.0
    s = m.summary()
    assert m.chips == 1
    assert s["tokens_per_sec_per_chip"] == s["tokens_per_sec"] == 2.0


def test_structure_equals_reference_scheduler():
    """One synthetic queue (packed prefills, a chunked prompt, recycled
    slots, mixed budgets) through both packages' schedulers: the same
    decode steps, tokens, per-request counts and admission order."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import model_fns as jmodel_fns
    from repro.serve import RequestQueue as JQueue
    from repro.serve import Scheduler as JScheduler
    from repro.serve import ServeConfig as JServeConfig
    arch = "smollm-360m"
    jcfg = jconfigs.get(arch, reduced=True)
    jp = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.get(arch, reduced=True)
    tp = ttransformer.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    kw = dict(prompt_lens=(4, 8, 12), new_tokens=(2, 7), seed=21)
    geometry = dict(num_slots=3, max_len=32, prefill_pack=2, chunk_len=8)
    jm = JScheduler(jcfg, jp, JServeConfig(
        cache_dtype=jnp.float32, **geometry)).run(JQueue.synthetic(
            10, jcfg.vocab, **kw))
    tm = Scheduler(tcfg, tp, ServeConfig(cache_dtype=F32, **geometry)).run(
        RequestQueue.synthetic(10, tcfg.vocab, **kw))
    assert list(tm.requests) == list(jm.requests)          # admission order
    assert {r: v.generated for r, v in tm.requests.items()} == \
        {r: v.generated for r, v in jm.requests.items()}
    js, ts = jm.summary(), tm.summary()
    for key in ("requests", "tokens", "decode_steps", "concurrent_peak",
                "rejected"):
        assert ts[key] == js[key], key
    assert tm.active_per_step == jm.active_per_step
    assert any(r.prompt_len == 12 for r in tm.requests.values())


# ------------------------------------------------ what is not in the slice

class _OneRankMesh:
    """A ("data", "model") mesh of one rank: what the serving rules and
    the scheduler read of a ``DeviceMesh`` (no process group is needed
    where every axis holds one rank)."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)

    def size(self, i=None):
        return 1

    def get_local_rank(self, i):
        return 0

    def get_group(self, i):
        return None


def test_mesh_and_unknown_kv_serving_raise():
    """A dense model serves on a mesh (here of one rank: bitwise the
    one-card run); a family without the tensor-parallel forward still
    raises naming ROADMAP item 6, and the paged pool under a mesh raises
    the reference's refusal; an unknown cache layout and a preemption
    drill without the paged cache are refused, as the reference's (the
    paged tier is tests/test_torch_serve_paged.py)."""
    cfg, params = _build("smollm-360m")
    scfg = ServeConfig(num_slots=2, max_len=24, cache_dtype=F32,
                       record_logits=True)
    runs = [Scheduler(cfg, params, scfg, **kw).run(RequestQueue.synthetic(
        3, cfg.vocab, prompt_lens=(4, 8), new_tokens=(2, 4), seed=1))
        for kw in ({}, {"mesh": _OneRankMesh()})]
    for a, b in zip(*(m.requests.values() for m in runs)):
        assert a.tokens == b.tokens
        assert all(torch.equal(torch.from_numpy(x), torch.from_numpy(y))
                   for x, y in zip(a.logits, b.logits))
    hcfg, hparams = _build("hymba-1.5b")
    with pytest.raises(NotImplementedError, match="item 6"):
        Scheduler(hcfg, hparams, ServeConfig(), mesh=_OneRankMesh())
    with pytest.raises(NotImplementedError, match="paged pool sharding"):
        Scheduler(cfg, params, ServeConfig(kv="paged"), mesh=_OneRankMesh())
    with pytest.raises(ValueError, match="kv must be"):
        Scheduler(cfg, params, ServeConfig(kv="ring"))
    with pytest.raises(ValueError, match="preempt_every"):
        Scheduler(cfg, params, ServeConfig(preempt_every=4))
