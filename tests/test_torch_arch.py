"""Twin of ``tests/test_arch_smoke.py`` over the port's architectures (the
dense and MoE families): every reduced config's init shapes, logits and
one train step's gradients against the reference on the same numpy
parameters (``params_from_numpy``) and batch, the full configs against the
assignment table, a 5-step loss_ema parity of reduced DeepSeek-V3 trained
by Muon, and reduced DeepSeek-V3 in bf16 against the reference in bf16.

Tolerances: fp32 logits 1e-4 and gradients rtol 1e-4 / atol 1e-5 (the
port's logits parity, ``tests/test_torch_train.py``; gradients are O(1e-2)
and below); the 5-step parity as ``test_torch_train.py``'s (each loss 1e-4,
loss_ema atol 1e-3, parameters rtol 5e-4 / atol 5e-5); bf16 2e-2 (the
reference's bf16 kernel tolerance) on logits, loss and one Muon step's
parameters.
"""

import dataclasses

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

ARCHS = list(tconfigs.ARCH_IDS)
B, S = 2, 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                        str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _init(arch, **overrides):
    jcfg = jconfigs.get(arch, reduced=True, **overrides)
    tcfg = tconfigs.get(arch, reduced=True, **overrides)
    jparams = jtransformer.init(jcfg, jax.random.PRNGKey(0))
    tparams = ttransformer.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu", requires_grad=True)
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, step=0, batch=B, seq=S):
    return tpipeline._batch_at(tpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), step)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + _init(request.param)


def test_registry_is_the_reference_dense_and_moe():
    want = {a for a in jconfigs.ARCH_IDS
            if jconfigs.get(a).family in ("dense", "moe")}
    assert set(ARCHS) == want == {
        "qwen2.5-14b", "nemotron-4-340b", "smollm-360m", "stablelm-1.6b",
        "deepseek-v3-671b", "kimi-k2-1t-a32b"}


def test_init_shapes_match_reference(arch):
    _, jcfg, tcfg, _, _ = arch
    for reduced in (True, False):
        jc = jconfigs.get(jcfg.name.removesuffix("-reduced"), reduced=reduced)
        tc = tconfigs.get(jcfg.name.removesuffix("-reduced"), reduced=reduced)
        want = jax.eval_shape(lambda k: jtransformer.init(jc, k),
                              jax.random.PRNGKey(0))
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in
                tree.flatten(jax.tree.map(lambda s: s, want))}
        got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for p, v in tree.flatten(ttransformer.init(tc,
                                                          device="meta"))}
        assert got == want, (jc.name, reduced)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_forward_matches_reference(arch):
    _, jcfg, tcfg, jparams, tparams = arch
    tokens = _batch(tcfg)["tokens"]
    want = np.asarray(jtransformer.forward(jcfg, jparams,
                                           jnp.asarray(tokens)))
    with torch.no_grad():
        got = ttransformer.forward(tcfg, tparams, torch.from_numpy(tokens))
    assert got.shape == (B, S, tcfg.vocab) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_step_grads_match_reference(arch):
    _, jcfg, tcfg, jparams, tparams = arch
    batch = _batch(tcfg, step=1)
    jloss, jgrads = jax.value_and_grad(jstep.make_loss_fn(jcfg))(
        jparams, jax.tree.map(jnp.asarray, batch))
    paths, leaves = zip(*tree.flatten(tparams))
    loss = tstep.make_loss_fn(tcfg)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-4)
    want = dict(tree.flatten(jax.tree.map(np.asarray, jgrads)))
    assert set(paths) == set(want)
    for p, g in zip(paths, grads):
        assert bool(torch.isfinite(g).all()), p
        np.testing.assert_allclose(g.numpy(), want[p], err_msg=p, **GRAD_TOL)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_full_configs_match_assignment_table():
    """``test_arch_smoke.py``'s table, for the ported architectures."""
    rows = {
        "qwen2.5-14b": (48, 5120, 40, 8, 13824, 152064),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "stablelm-1.6b": (24, 2048, 32, 32, 5632, 100352),
        "deepseek-v3-671b": (61, 7168, 128, 128, 2048, 129280),
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
    }
    assert set(rows) == set(ARCHS)
    for a, (L, d, H, KV, ff, V) in rows.items():
        cfg = tconfigs.get(a)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab) == (L, d, H, KV, ff, V), a
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(
            jconfigs.get(a))
        assert got == {k: want[k] for k in got}, a
    assert tconfigs.get("deepseek-v3-671b").moe.n_experts == 256
    assert tconfigs.get("deepseek-v3-671b").moe.top_k == 8
    assert tconfigs.get("deepseek-v3-671b").attn_kind == "mla"
    assert tconfigs.get("kimi-k2-1t-a32b").moe.n_experts == 384


def test_unported_family_raises():
    cfg = dataclasses.replace(tconfigs.get("smollm-360m", reduced=True),
                              family="ssm")
    with pytest.raises(ValueError, match="ROADMAP item 9"):
        ttransformer.init(cfg, device="meta")


def test_expert_leaves_unbound_once_per_forward():
    """The (L, E, m, n) expert leaves ride the per-forward ``unbind``: the
    gradients equal slicing ``w[l]`` on every layer, bit for bit."""
    _, _, _, tparams = _init("deepseek-v3-671b")
    cfg = tconfigs.get("deepseek-v3-671b", reduced=True)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    leaves = [v for _, v in tree.flatten(tparams)]

    def sliced(params):
        from repro_torch.models import layers as tlayers
        x = tlayers.embed(params["embed"], tokens)
        rope_cs = ttransformer._rope_for(cfg, torch.arange(x.shape[1]))
        for l in range(cfg.n_layers):
            bp = tree.tree_map(lambda w: w[l], params["blocks"])
            x = ttransformer._block_apply(cfg, bp, x, rope_cs=rope_cs)
        x = tlayers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return tlayers.unembed(params["lm_head"], x)

    a = torch.autograd.grad(ttransformer.forward(cfg, tparams, tokens)
                            .square().mean(), leaves)
    b = torch.autograd.grad(sliced(tparams).square().mean(), leaves)
    assert tparams["blocks"]["moe"]["experts"]["up_proj"]["w"].ndim == 4
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _train_both(arch, steps, dcfg, **overrides):
    jcfg, tcfg, jparams, tparams = _init(arch, **overrides)
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
    losses = []
    for i in range(steps):
        jbatch = jpipeline.batch_for_step(dcfg, i)
        tbatch = tpipeline.batch_for_step(dcfg, i, device="cpu")
        with torch.no_grad():
            tl = float(tstep.make_loss_fn(tcfg)(tstate.params, tbatch))
        losses.append((tl, float(jstep.make_loss_fn(jcfg)(jstate.params,
                                                          jbatch))))
        jstate = jfn(jstate, jbatch)
        tstate = tfn(tstate, tbatch)
        losses[-1] += (float(tstate.loss_ema), float(jstate.loss_ema))
    return jstate, tstate, losses


def test_deepseek_loss_ema_trajectory_matches_reference():
    dcfg = tpipeline.DataConfig(vocab=257, seq_len=32, global_batch=4)
    jstate, tstate, losses = _train_both("deepseek-v3-671b", 5, dcfg)
    for i, (tl, jl, tema, jema) in enumerate(losses):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tema, jema, rtol=0, atol=1e-3)
    assert tstate.step == int(jstate.step) == 5
    for (p, a), (q, b) in zip(tree.flatten(tstate.params), tree.flatten(
            jax.tree.map(np.asarray, jstate.params)), strict=True):
        assert p == q
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-5, err_msg=p)


def test_deepseek_bf16_matches_reference_bf16():
    """bf16 parameters and compute: logits and loss within 2e-2 of the
    reference in bf16; one Muon step keeps the reference's dtype policy
    (bf16 parameters, fp32 momentum, AdamW moments fp32) and lands within
    2e-2 of its parameters and momentum."""
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    dcfg = tpipeline.DataConfig(vocab=257, seq_len=16, global_batch=2)
    jcfg, tcfg, jparams, tparams = _init("deepseek-v3-671b", **bf)
    assert all(v.dtype == torch.bfloat16 for _, v in tree.flatten(tparams))
    tokens = tpipeline._batch_at(dcfg, 0)["tokens"]
    with torch.no_grad():
        got = ttransformer.forward(tcfg, tparams, torch.from_numpy(tokens))
    want = jtransformer.forward(jcfg, jparams, jnp.asarray(tokens))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)

    jstate, tstate, losses = _train_both("deepseek-v3-671b", 1, dcfg, **bf)
    np.testing.assert_allclose(losses[0][0], losses[0][1], **BF16_TOL)
    for (p, a), (_, b) in zip(tree.flatten(tstate.params), tree.flatten(
            jax.tree.map(np.asarray, jstate.params)), strict=True):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, p
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.astype(np.float32), err_msg=p,
                                   **BF16_TOL)
    jmom = jstate.opt_state.momentum
    for k, v in tstate.opt_state.momentum.items():
        assert v.dtype == torch.float32 and jmom[k].dtype == jnp.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(jmom[k]),
                                   err_msg=k, **BF16_TOL)
    for p, v in tstate.opt_state.adamw.mu.items():
        assert v.dtype == torch.float32, p


def test_strict_fp32_turns_off_reduced_precision_matmuls(monkeypatch):
    """``strict_fp32`` (every CUDA entry point calls it) turns TF32 off and
    makes bf16 matmuls reduce their partial sums in fp32, as the
    reference's ``dot`` accumulates (``preferred_element_type=float32``)."""
    from repro_torch.device import strict_fp32
    m = torch.backends.cuda.matmul
    for flag in ("allow_tf32", "allow_bf16_reduced_precision_reduction"):
        monkeypatch.setattr(m, flag, True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert m.allow_tf32 and m.allow_bf16_reduced_precision_reduction
    strict_fp32()
    assert m.allow_tf32 is False
    assert m.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cudnn.allow_tf32 is False
