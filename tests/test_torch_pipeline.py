"""The port's bucketed optimizer pipeline (``repro_torch.core.pipeline``):
the twin of ``tests/test_pipeline.py``, item for item with the same
parametrisation, plus the port's bucketed update against the reference's.

Bit-exactness is the contract, asserted with ``torch.equal``: the bucketed
schedule is the fused owner update reordered, so in one process every
variant gives bitwise identical updates and state, the accumulation-
overlapped entry (per-microbatch staging + ``update_staged``) included,
which rides on packing being a permutation + zero pad.  Plus the elasticity
of in-flight staged state.  The parity test against the reference uses
``tests/test_torch_variants.py``'s tolerance for the same variants, rtol
5e-4 / atol 5e-5 (the two frameworks' NS iterations round differently).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core.gram_ns import GramNSConfig as JGramNSConfig  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import api, tree  # noqa: E402
from repro_torch.core.gram_ns import GramNSConfig  # noqa: E402
from repro_torch.core.muon import (MuonConfig, _matrix_and_rest,  # noqa: E402
                                   _resolve, muon_update_staged)
from repro_torch.core.owner_comms import group_key_str  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    BucketPipeline, reshard_staged, wait_all)
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

VARIANTS = ["muon", "normuon", "muonbp", "dion2", "adamuon", "adamw"]
RTOL, ATOL = 5e-4, 5e-5      # tests/test_torch_variants.py's tolerance


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)

    def n(*s):
        return (rng.standard_normal(s) * 0.02).astype(np.float32)
    return {"blocks": {"wq": n(3, 32, 32), "wk": n(3, 32, 16),
                       "up": n(3, 32, 128), "down": n(3, 128, 32),
                       "norm_scale": np.ones((3, 32), np.float32)},
            "embed_table": n(100, 32)}


def _np_grads(seed=1):
    rng = np.random.default_rng(100 + seed)
    return tree.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        _np_tree())


def _tree(seed=0):
    return tree.tree_map(torch.from_numpy, _np_tree(seed))


def _grads(seed=1):
    return tree.tree_map(torch.from_numpy, _np_grads(seed))


def _mk(variant, pipeline, **kw):
    params = _tree()
    plan = api.dedicate_params(params, num_owners=4, strategy="greedy")
    kw.setdefault("ns", GramNSConfig(num_steps=5))
    cfg = MuonConfig(variant=variant, pipeline=pipeline, learning_rate=0.1,
                     momentum=0.9, **kw)
    return params, plan, api.Muon(plan, config=cfg, device="cpu")


def _run(opt, params, n=3):
    state = opt.init(params)
    for t in range(n):
        u, state = opt.update(_grads(seed=t), state, params)
        params = tree.tree_map(lambda p, d: p + d, params, u)
    return params, state


def _assert_trees_equal(a, b, msg=""):
    fa, fb = tree.flatten(a), tree.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb], msg
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), \
            f"{msg}:{p}"


def _reduced_cfg():
    return configs.get("smollm-360m", reduced=True, n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=176, vocab=256,
                       remat=False)


# ----------------------------------------------------- schedule structure

def test_plan_is_multi_bucket():
    # the fixture must actually exercise the pipeline: >= 2 Gram buckets
    _, plan, _ = _mk("muon", "bucketed")
    assert len(plan.buckets) >= 2, plan.buckets


def test_schedule_orders_buckets_largest_first():
    _, plan, opt = _mk("muon", "bucketed")
    pipe = BucketPipeline(plan, opt.config, spec=opt.variant)
    ms = [m for m, _ in pipe.schedule]
    assert ms == sorted(ms, reverse=True)
    assert sum(len(keys) for _, keys in pipe.schedule) == len(plan.groups)


def test_bucketed_rejects_gather_mode():
    params = _tree()
    plan = api.dedicate_params(params, num_owners=4, strategy="greedy")
    with pytest.raises(ValueError, match="pipeline"):
        opt = api.Muon(plan, config=MuonConfig(mode="gather",
                                               pipeline="bucketed"),
                       device="cpu")
        opt.update(_grads(), opt.init(params), params)


def test_unknown_pipeline_rejected():
    params = _tree()
    plan = api.dedicate_params(params, num_owners=4, strategy="greedy")
    with pytest.raises(ValueError, match="pipeline"):
        opt = api.Muon(plan, config=MuonConfig(pipeline="wavefront"),
                       device="cpu")
        opt.update(_grads(), opt.init(params), params)


# ------------------------------------------------- bit-exactness (fused ==)

@pytest.mark.parametrize("variant", VARIANTS)
def test_bucketed_bit_exact_with_fused(variant):
    params_f, state_f = _run(_mk(variant, "fused")[2], _tree())
    params_b, state_b = _run(_mk(variant, "bucketed")[2], _tree())
    _assert_trees_equal(params_f, params_b, f"{variant}:params")
    _assert_trees_equal(state_f.momentum, state_b.momentum,
                        f"{variant}:momentum")
    _assert_trees_equal(state_f.variant_state, state_b.variant_state,
                        f"{variant}:variant_state")
    _assert_trees_equal(state_f.adamw._asdict(), state_b.adamw._asdict(),
                        f"{variant}:adamw")


@pytest.mark.parametrize("variant", VARIANTS)
def test_bucketed_bit_exact_with_bucket_fusion(variant):
    # ns.bucket_fusion fuses the iterate phase within a bucket — in both
    # schedules the fusion unit IS the bucket, so still bit-exact
    kw = {"ns": GramNSConfig(num_steps=5, bucket_fusion=True)}
    params_f, _ = _run(_mk(variant, "fused", **kw)[2], _tree())
    params_b, _ = _run(_mk(variant, "bucketed", **kw)[2], _tree())
    _assert_trees_equal(params_f, params_b, variant)


def test_bucketed_bit_exact_with_compress_grads():
    # compression's error feedback lives in the training layout and is
    # applied before stage_in — identical in both schedules
    kw = {"compress_grads": True}
    params_f, state_f = _run(_mk("muon", "fused", **kw)[2], _tree())
    params_b, state_b = _run(_mk("muon", "bucketed", **kw)[2], _tree())
    _assert_trees_equal(params_f, params_b, "params")
    _assert_trees_equal(state_f.error_feedback, state_b.error_feedback, "ef")


# ---------------------------------------- accumulation-overlapped schedule

@pytest.mark.parametrize("variant", VARIANTS)
def test_prestaged_accum_bit_exact(variant):
    """stage_in per microbatch + update_staged == accumulate + update.

    Packing is a permutation + zero pad, so summing packed per-microbatch
    gradients, scaling by 1/accum and casting to pack_dtype commutes with
    packing the averaged gradient — for every registry variant."""
    cfg = _reduced_cfg()
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=2, strategy="greedy")
    assert len(plan.buckets) >= 2     # GQA kv heads give a second bucket
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    batch = batch_for_step(dcfg, 0, device="cpu")

    outs = {}
    for prestage in (False, True):
        opt = api.Muon(plan, config=MuonConfig(
            mode="owner", variant=variant, pipeline="bucketed",
            ns=GramNSConfig(num_steps=3)), device="cpu")
        state = init_state(cfg, opt, seed=0, device="cpu")
        step = make_train_step(cfg, opt, accum_steps=2, prestage=prestage,
                               device="cpu")
        for _ in range(2):
            state = step(state, batch)
        outs[prestage] = state
    _assert_trees_equal(outs[False].params, outs[True].params,
                        f"{variant}:params")
    assert torch.equal(outs[False].loss_ema, outs[True].loss_ema)
    _assert_trees_equal(outs[False].opt_state.momentum,
                        outs[True].opt_state.momentum, f"{variant}:momentum")
    _assert_trees_equal(outs[False].opt_state.variant_state,
                        outs[True].opt_state.variant_state,
                        f"{variant}:vstate")


def test_prestage_refused_with_compress_grads():
    params = _tree()
    plan = api.dedicate_params(params, num_owners=2, strategy="greedy")
    cfg = MuonConfig(mode="owner", pipeline="bucketed", compress_grads=True)
    with pytest.raises(ValueError, match="compress_grads"):
        muon_update_staged(plan, {}, {}, None, params, cfg)


# ------------------------------------------------- elastic in-flight state

def test_staged_state_elastic_reshard():
    """A preemption mid-accumulation: owner-major staged gradient sums are
    repacked to a new owner count, the interrupted step finishes there, and
    the result matches the uninterrupted run bit for bit."""
    params = _tree()
    g1, g2 = _grads(seed=11), _grads(seed=12)

    def staged_sum(plan, opt):
        pipe = BucketPipeline(plan, opt.config, spec=opt.variant)
        out = None
        for g in (g1, g2):
            gm, _ = _matrix_and_rest(plan, g)
            st = wait_all(pipe.stage_in_all(gm, dtype=torch.float32))
            out = st if out is None else {k: out[k] + st[k] for k in out}
        return {k: v * 0.5 for k, v in out.items()}

    def finish(plan, opt, staged):
        _, gr1 = _matrix_and_rest(plan, g1)
        _, gr2 = _matrix_and_rest(plan, g2)
        rest = {p: (gr1[p] + gr2[p]) * 0.5 for p in gr1}
        return opt.update_staged(staged, rest, opt.init(params), params)

    def mk(n):
        plan = api.dedicate_params(params, num_owners=n, strategy="greedy")
        return plan, api.Muon(plan, config=MuonConfig(
            mode="owner", pipeline="bucketed", learning_rate=0.1,
            momentum=0.9, ns=GramNSConfig(num_steps=5)), device="cpu")

    plan4, opt4 = mk(4)
    plan2, opt2 = mk(2)

    # uninterrupted at 2 owners
    u_ref, _ = finish(plan2, opt2, staged_sum(plan2, opt2))
    # interrupted at 4 owners mid-accumulation, resumed at 2
    staged4 = staged_sum(plan4, opt4)
    staged2 = reshard_staged(staged4, plan4, plan2)
    u_el, _ = finish(plan2, opt2, staged2)
    _assert_trees_equal(u_ref, u_el, "elastic")


def test_reshard_staged_roundtrip():
    params = _tree()
    plan4 = api.dedicate_params(params, num_owners=4, strategy="greedy")
    plan2 = api.dedicate_params(params, num_owners=2, strategy="greedy")
    opt = api.Muon(plan4, config=MuonConfig(mode="owner",
                                            pipeline="bucketed"),
                   device="cpu")
    pipe = BucketPipeline(plan4, opt.config, spec=opt.variant)
    gm, _ = _matrix_and_rest(plan4, _grads())
    staged = wait_all(pipe.stage_in_all(gm, dtype=torch.float32))
    back = reshard_staged(reshard_staged(staged, plan4, plan2),
                          plan2, plan4)
    for key, grp in plan4.groups.items():
        skey = group_key_str(key)
        assert torch.equal(staged[skey], back[skey]), \
            f"{skey} rows={grp.pack_index.shape[0]}"


# ------------------------------------------------------- config surface

def test_replace_returns_new_opt():
    _, _, opt = _mk("muon", "fused")
    opt_b = opt.replace(pipeline="bucketed")
    assert opt.config.pipeline == "fused"
    assert opt_b.config.pipeline == "bucketed"
    assert opt_b.plan is opt.plan


def test_train_step_pipeline_override():
    cfg = _reduced_cfg()
    plan = api.dedicate_params(transformer.init(cfg, device="meta"),
                               num_owners=1, strategy="greedy")
    opt = api.Muon(plan, config=MuonConfig(mode="owner"), device="cpu")
    make_train_step(cfg, opt, pipeline="bucketed", device="cpu")
    assert opt.config.pipeline == "fused"   # caller's opt untouched


def test_pipeline_validation_in_resolve():
    with pytest.raises(ValueError, match="pipeline"):
        _resolve(dataclasses.replace(MuonConfig(), pipeline="nope"))


# ------------------------------------------------ the port's own invariants

def test_schedule_order_without_overlap():
    """The hook reports the double-buffered order in one process too (no
    overlap there: each move is waited as it is issued, the order is the
    same): stage_in(b+1) issued before compute(b), publish(b) waited after
    compute(b+1), never two stagings ahead."""
    _, plan, opt = _mk("muon", "bucketed")
    pipe = BucketPipeline(plan, opt.config, spec=opt.variant)
    assert not pipe.overlap
    events = []
    pipe.on_event = lambda what, b: events.append((what, b))
    params = _tree()
    gm, _ = _matrix_and_rest(plan, _grads())
    pm, _ = _matrix_and_rest(plan, params)
    pipe.run_from_grads(gm, {p: None for p in gm}, pm, opt.init(params))
    assert events == [("issue_stage_in", 0), ("wait_stage_in", 0),
                      ("issue_stage_in", 1), ("compute", 0),
                      ("issue_publish", 0), ("wait_stage_in", 1),
                      ("compute", 1), ("wait_publish", 0),
                      ("issue_publish", 1), ("wait_publish", 1)]


# ---------------------------------------------------- against the reference

@pytest.mark.parametrize("variant", ["muon", "normuon"])
def test_bucketed_matches_reference(variant):
    """3 steps of the port's bucketed update against the reference's
    bucketed update on the same numpy parameters and gradients: updates
    each step, then momentum and parameters, at rtol 5e-4 / atol 5e-5."""
    params = _np_tree()
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    kw = dict(variant=variant, pipeline="bucketed", learning_rate=0.1,
              momentum=0.9)
    jplan = japi.dedicate_params(jp, num_owners=4, strategy="greedy")
    tplan = api.dedicate_params(tp, num_owners=4, strategy="greedy")
    jopt = japi.Muon(jplan, config=JMuonConfig(
        ns=JGramNSConfig(num_steps=5), **kw))
    topt = api.Muon(tplan, config=MuonConfig(ns=GramNSConfig(num_steps=5),
                                             **kw), device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for t in range(3):
        g = _np_grads(t)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree.tree_map(torch.from_numpy, g), ts, tp)
        want = {p: np.asarray(v) for p, v in tree.flatten(
            jax.tree.map(np.asarray, ju))}
        for p, v in tree.flatten(tu):
            np.testing.assert_allclose(v.numpy(), want[p], rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {t}: {p}")
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = tree.tree_map(lambda a, b: a + b, tp, tu)
    for k, v in ts.momentum.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(js.momentum[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    want = dict(tree.flatten(jax.tree.map(np.asarray, jp)))
    for p, v in tree.flatten(tp):
        np.testing.assert_allclose(v.numpy(), want[p], rtol=RTOL, atol=ATOL,
                                   err_msg=p)


def test_torch_quickstart_bucketed():
    """``examples/torch_quickstart.py --pipeline bucketed`` on the CPU
    prints the reference quickstart's loss_ema lines."""
    import subprocess
    import sys
    from pathlib import Path
    script = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    out = subprocess.run([sys.executable, str(script), "--pipeline",
                          "bucketed", "--steps", "5", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "done."
    loss = [ln for ln in lines if ln.startswith("step ")]
    assert len(loss) == 1 and "loss_ema" in loss[0]
    assert np.isfinite(float(loss[0].split()[-1]))
