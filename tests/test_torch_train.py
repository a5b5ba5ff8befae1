"""Port model, data and train step vs the reference on the reduced
smollm-360m, plus the port's import hygiene.

Parameters cross from the reference's ``init`` as numpy
(``params_from_numpy``), batches from the shared pure-numpy ``_batch_at``.
Tolerances: logits and loss 1e-4; over 5 train steps each step's loss 1e-4,
the loss_ema atol 1e-3 and the parameters after step 5 rtol 5e-4 / atol 5e-5
(as the optimizer's own parity tests: two frameworks' fp32 CPU kernels sum
in different orders and the Gram NS amplifies it); accumulation 2 vs 1
microbatch 1e-5.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as tapi, tree  # noqa: E402
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.train_state import TrainState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _init(**overrides):
    jcfg = jconfigs.get("smollm-360m", reduced=True, **overrides)
    tcfg = tconfigs.get("smollm-360m", reduced=True, **overrides)
    jparams = jtransformer.init(jcfg, jax.random.PRNGKey(0))
    tparams = ttransformer.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu", requires_grad=True)
    return jcfg, tcfg, jparams, tparams


def _dcfg(cfg, batch=4, seq=32):
    return tpipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch)


def test_params_roundtrip_numpy():
    _, _, jparams, tparams = _init()
    back = ttransformer.params_to_numpy(tparams)
    for (p, a), (_, b) in zip(tree.flatten(back), tree.flatten(
            jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_logits_and_loss_match_reference():
    jcfg, tcfg, jparams, tparams = _init()
    batch = tpipeline._batch_at(_dcfg(tcfg), 0)
    jlogits = jtransformer.forward(jcfg, jparams, jnp.asarray(batch["tokens"]))
    tlogits = ttransformer.forward(tcfg, tparams,
                                   torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jloss = jstep.make_loss_fn(jcfg)(jparams, jax.tree.map(jnp.asarray, batch))
    tloss = tstep.make_loss_fn(tcfg)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-4)


def test_batches_byte_identical():
    for cfg in [tpipeline.DataConfig(vocab=257, seq_len=32, global_batch=4),
                tpipeline.DataConfig(vocab=49152, seq_len=16, global_batch=2,
                                     seed=3)]:
        jcfg = jpipeline.DataConfig(vocab=cfg.vocab, seq_len=cfg.seq_len,
                                    global_batch=cfg.global_batch,
                                    seed=cfg.seed)
        for step in (0, 7):
            a, b = tpipeline._batch_at(cfg, step), jpipeline._batch_at(jcfg,
                                                                       step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
        got = tpipeline.batch_for_step(cfg, 1, device="cpu")
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      jpipeline._batch_at(jcfg, 1)["tokens"])


def test_loss_ema_trajectory_matches_reference():
    jcfg, tcfg, jparams, tparams = _init()
    mcfg = dict(learning_rate=0.02, momentum=0.95)
    jopt = japi.Muon(japi.dedicate_params(jparams),
                     config=JMuonConfig(**mcfg))
    topt = tapi.Muon(tapi.dedicate_params(tparams),
                     config=MuonConfig(**mcfg), device="cpu")
    jstate = JTrainState(jnp.zeros((), jnp.int32), jparams,
                         jopt.init(jparams), jnp.zeros((), jnp.float32))
    tstate = TrainState(0, tparams, topt.init(tparams),
                        torch.zeros((), dtype=torch.float32))
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    tfn = tstep.make_train_step(tcfg, topt, device="cpu")
    jloss_fn, tloss_fn = jstep.make_loss_fn(jcfg), tstep.make_loss_fn(tcfg)
    dcfg = _dcfg(tcfg)
    for i in range(5):
        jbatch = jpipeline.batch_for_step(dcfg, i)
        tbatch = tpipeline.batch_for_step(dcfg, i, device="cpu")
        # the loss this step trains on: the current parameters on its batch
        with torch.no_grad():
            tloss = float(tloss_fn(tstate.params, tbatch))
        np.testing.assert_allclose(tloss, float(jloss_fn(jstate.params,
                                                         jbatch)),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        jstate = jfn(jstate, jbatch)
        tstate = tfn(tstate, tbatch)
        np.testing.assert_allclose(float(tstate.loss_ema),
                                   float(jstate.loss_ema), rtol=0, atol=1e-3)
    assert tstate.step == int(jstate.step) == 5
    for (p, a), (q, b) in zip(tree.flatten(tstate.params), tree.flatten(
            jax.tree.map(np.asarray, jstate.params)), strict=True):
        assert p == q
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-5, err_msg=p)


def test_accumulation_matches_single_batch():
    _, tcfg, _, tparams = _init()
    plan = tapi.dedicate_params(tparams)
    batch = tpipeline.batch_for_step(_dcfg(tcfg), 0, device="cpu")
    out = []
    for accum in (1, 2):
        params = tree.tree_map(
            lambda v: v.detach().clone().requires_grad_(True), tparams)
        opt = tapi.Muon(plan, device="cpu")
        state = TrainState(0, params, opt.init(params), torch.zeros(()))
        fn = tstep.make_train_step(tcfg, opt, accum_steps=accum,
                                   device="cpu")
        out.append(fn(state, batch))
    np.testing.assert_allclose(float(out[1].loss_ema),
                               float(out[0].loss_ema), rtol=1e-5, atol=1e-5)
    for (p, a), (_, b) in zip(tree.flatten(out[0].params),
                              tree.flatten(out[1].params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=p)


def test_remat_gradients_match_plain_backward():
    _, tcfg, _, tparams = _init()
    remat_cfg = tconfigs.get("smollm-360m", reduced=True, remat=True)
    batch = tpipeline.batch_for_step(_dcfg(tcfg), 0, device="cpu")
    leaves = [v for _, v in tree.flatten(tparams)]
    grads = [torch.autograd.grad(tstep.make_loss_fn(c)(tparams, batch),
                                 leaves) for c in (tcfg, remat_cfg)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _forward_sliced_per_layer(cfg, params, tokens):
    """The forward as it was before the stacked leaves were unbound once:
    every layer indexes each stacked leaf with ``w[l]``."""
    import functools
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import layers as tlayers
    x = tlayers.embed(params["embed"], tokens)
    rope_cs = ttransformer._rope_for(cfg, torch.arange(x.shape[1]))
    for l in range(cfg.n_layers):
        bp = tree.tree_map(lambda w: w[l], params["blocks"])
        body = functools.partial(ttransformer._block_apply, cfg, bp,
                                 rope_cs=rope_cs)
        x = checkpoint(body, x, use_reentrant=False) if cfg.remat else \
            body(x)
    x = tlayers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return tlayers.unembed(params.get("lm_head", params["embed"]), x)


@pytest.mark.parametrize("remat", [False, True])
def test_unbound_layers_give_bitwise_gradients_of_per_layer_slicing(remat):
    """Unbinding each stacked block leaf once per forward changes no bit of
    any parameter gradient against slicing ``w[l]`` on every layer."""
    _, tcfg, _, tparams = _init(remat=remat)
    batch = tpipeline.batch_for_step(_dcfg(tcfg), 0, device="cpu")
    leaves = [v for _, v in tree.flatten(tparams)]
    got = torch.autograd.grad(tstep.make_loss_fn(tcfg)(tparams, batch),
                              leaves)
    logits = _forward_sliced_per_layer(tcfg, tparams, batch["tokens"])
    want = torch.autograd.grad(tstep.softmax_xent(logits, batch["labels"]),
                               leaves)
    for (p, _), a, b in zip(tree.flatten(tparams), got, want, strict=True):
        assert torch.equal(a, b), p


def test_no_select_backward_on_stacked_block_leaves():
    """The backward graph reaches each stacked (L, ...) block leaf through
    one UnbindBackward0, never through a per-layer SelectBackward0."""
    _, tcfg, _, tparams = _init()
    batch = tpipeline.batch_for_step(_dcfg(tcfg), 0, device="cpu")
    loss = tstep.make_loss_fn(tcfg)(tparams, batch)
    stacked = {id(v): p for p, v in tree.flatten(tparams["blocks"])}
    feeders: dict = {}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            var = getattr(child, "variable", None)
            if var is not None and id(var) in stacked:
                feeders.setdefault(stacked[id(var)], set()).add(node.name())
            todo.append(child)
    assert set(feeders) == set(stacked.values())
    for path, names in feeders.items():
        assert names == {"UnbindBackward0"}, (path, names)


def test_rope_and_chunked_attention_match_reference():
    """rope_freqs and the online-softmax attention path (taken when both
    sequence lengths exceed 1024) against the reference, 1e-4."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    jc, js = jlayers.rope_freqs(16, 40)
    tc, ts = tlayers.rope_freqs(16, 40)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    rng = np.random.default_rng(0)
    S = 1056                                  # chunks of 528 > one block
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(1, S, 4, 8), (1, S, 2, 8), (1, S, 2, 8)])
    pos = np.arange(S)
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.35, qpos=jnp.asarray(pos),
                         kpos=jnp.asarray(pos), causal=True)
    got = tlayers._sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.35,
                        qpos=torch.from_numpy(pos), kpos=torch.from_numpy(pos),
                        causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("pipeline,accum,prestage", [
    ("fused", 1, False), ("bucketed", 2, True)])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(pipeline, accum,
                                                          prestage):
    """Every tensor a train step makes is freed by reference counting:
    with Python's cyclic collector off for two steps, a collection
    afterwards finds no tensor in a cycle (one left there would hold its
    device memory until a full collection)."""
    import gc
    _, tcfg, _, _ = _init()
    plan = tapi.dedicate_params(ttransformer.init(tcfg, device="meta"))
    opt = tapi.Muon(plan, config=MuonConfig(pipeline=pipeline),
                    device="cpu")
    dcfg = tpipeline.DataConfig(vocab=tcfg.vocab, seq_len=16,
                                global_batch=4)
    gc.collect()
    gc.disable()
    try:
        state = tstep.init_state(tcfg, opt, device="cpu")
        step = tstep.make_train_step(tcfg, opt, accum_steps=accum,
                                     prestage=prestage, device="cpu")
        for i in range(2):
            state = step(state, tpipeline.batch_for_step(dcfg, i,
                                                         device="cpu"))
        assert np.isfinite(float(state.loss_ema))
        del state, step
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, [tuple(t.shape) for t in cyclic]


def test_init_shapes_match_reference_and_seed_is_deterministic():
    jcfg, tcfg, jparams, _ = _init()
    a = ttransformer.init(tcfg, seed=1, device="cpu")
    b = ttransformer.init(tcfg, seed=1, device="cpu")
    jflat = {"/".join(str(k.key) for k in kp): v.shape for kp, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {p: tuple(v.shape) for p, v in tree.flatten(a)} == jflat
    for (_, x), (_, y) in zip(tree.flatten(a), tree.flatten(b)):
        assert torch.equal(x, y)
    full = tconfigs.get("smollm-360m")
    assert full.param_count() == 361_821_120


def test_init_state_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, tcfg, _, tparams = _init()
    opt = tapi.Muon(tapi.dedicate_params(tparams), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_state(tcfg, opt, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.make_train_step(tcfg, opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttransformer.init(tcfg)
    state = tstep.init_state(tcfg, opt, seed=0, device="cpu")
    assert all(v.requires_grad for _, v in tree.flatten(state.params))


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch
from repro_torch import configs, device
from repro_torch.checkpoint import manager
from repro_torch.core import (api, coefficients, dedication, gram_ns, layout,
                              load_balance, muon, newton_schulz, orthogonalize,
                              owner_comms, pipeline as bucket_pipeline, tree,
                              update_rules)
from repro_torch.data import pipeline
from repro_torch.kernels import autotune, build, gram_syrk, ops, ref, symmul
from repro_torch.launch import mesh, train
from repro_torch.models import layers, moe, sharding, transformer
from repro_torch.configs import (deepseek_v3_671b, kimi_k2_1t, nemotron4_340b,
                                 qwen2p5_14b, stablelm_1p6b)
from repro_torch.runtime import elastic, faults, resilient
from repro_torch.train import step, train_state
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules), "reference module imported"
print("ok")
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    assert ROOT / "examples" / "torch_quickstart.py" in files
    for sub in ("checkpoint/manager.py", "runtime/faults.py",
                "runtime/elastic.py", "runtime/resilient.py",
                "launch/train.py", "models/moe.py",
                "configs/deepseek_v3_671b.py", "configs/kimi_k2_1t.py"):
        assert ROOT / "src" / "repro_torch" / sub in files, sub
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


@pytest.mark.parametrize("pipeline", ["fused", "bucketed"])
def test_donated_state_gives_the_same_steps(pipeline):
    """``donate=True`` releases the incoming state's momentum and AdamW
    moments as their successors are made: two steps give the same loss,
    parameters and state bit for bit, and the spent state is empty."""
    _, tcfg, _, tparams = _init()
    plan = tapi.dedicate_params(tparams)
    dcfg = _dcfg(tcfg)
    runs = []
    for donate in (False, True):
        params = tree.tree_map(
            lambda v: v.detach().clone().requires_grad_(True), tparams)
        opt = tapi.Muon(plan, config=MuonConfig(pipeline=pipeline),
                        device="cpu")
        state = TrainState(0, params, opt.init(params), torch.zeros(()))
        fn = tstep.make_train_step(tcfg, opt, donate=donate, device="cpu")
        spent = []
        for i in range(2):
            spent.append(state.opt_state)
            state = fn(state, tpipeline.batch_for_step(dcfg, i,
                                                       device="cpu"))
        runs.append(state)
        if donate:
            for old in spent:
                assert not old.momentum and not old.adamw.mu \
                    and not old.adamw.nu
    a, b = runs
    assert torch.equal(a.loss_ema, b.loss_ema)
    for (p, x), (_, y) in zip(tree.flatten(a.params), tree.flatten(b.params)):
        assert torch.equal(x, y), p
    for part in ("momentum",):
        for k, v in getattr(a.opt_state, part).items():
            assert torch.equal(v, getattr(b.opt_state, part)[k]), k
    for k, v in a.opt_state.adamw.nu.items():
        assert torch.equal(v, b.opt_state.adamw.nu[k]), k
