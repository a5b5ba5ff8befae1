"""Twin of ``tests/test_arch_smoke.py`` over all 10 architectures (dense,
MoE, hybrid, xLSTM, encoder-decoder, VLM): every reduced config's init
shapes (reduced and full width), logits and one train step's gradients
against the reference on the same numpy parameters (``params_from_numpy``)
and batch (patches / frames from a seeded numpy generator), the full
configs against the assignment table, ``param_count`` against the leaves
of the reference's ``model_fns(cfg).init``, 5-step loss_ema parities of
reduced DeepSeek-V3 and reduced hymba trained by Muon, and reduced
DeepSeek-V3 in bf16 against the reference in bf16.

Tolerances: fp32 logits 1e-4 and gradients rtol 1e-4 / atol 1e-5 (the
port's logits parity, ``tests/test_torch_train.py``; gradients are O(1e-2)
and below); the 5-step parity as ``test_torch_train.py``'s (each loss 1e-4,
loss_ema atol 1e-3, parameters rtol 5e-4 / atol 5e-5); bf16 2e-2 (the
reference's bf16 kernel tolerance) on logits, loss and one Muon step's
parameters.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as tapi, tree  # noqa: E402
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.models import model_fns as tmodel_fns  # noqa: E402
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
    jparams = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tparams = ttransformer.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu", requires_grad=True)
    return jcfg, tcfg, jparams, tparams


def _frontend(cfg, step, batch):
    """Patches or frames (batch, frontend_len, frontend_dim), standard
    normal from a numpy generator seeded by the step; {} without one."""
    if cfg.frontend is None:
        return {}
    key = "patches" if cfg.frontend == "patch" else "frames"
    rng = np.random.default_rng([7, step])
    return {key: rng.standard_normal(
        (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}


def _batch(cfg, step=0, batch=B, seq=S):
    return {**tpipeline._batch_at(tpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), step),
        **_frontend(cfg, step, batch)}


def _inputs(batch):
    """The forward's keyword inputs of a numpy batch, for both packages."""
    return ({k: jnp.asarray(v) for k, v in batch.items() if k != "labels"},
            {k: torch.from_numpy(v) for k, v in batch.items()
             if k != "labels"})


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + _init(request.param)


def test_registry_is_the_reference_dense_and_moe():
    """The registry holds the reference's 10 architectures, all six
    families, in its order."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(ARCHS) == {
        "hymba-1.5b", "qwen2.5-14b", "nemotron-4-340b", "smollm-360m",
        "stablelm-1.6b", "deepseek-v3-671b", "kimi-k2-1t-a32b", "xlstm-350m",
        "seamless-m4t-large-v2", "llava-next-mistral-7b"}
    assert {tconfigs.get(a).family for a in ARCHS} == set(
        ttransformer.FAMILIES)


def _reference_leaves(jc):
    """{path: (shape, dtype)} of the reference's ``model_fns(jc).init``."""
    want = jax.eval_shape(lambda k: jmodel_fns(jc).init(jc, k),
                          jax.random.PRNGKey(0))
    return {p: (tuple(v.shape), str(v.dtype)) for p, v in tree.flatten(want)}


def test_init_shapes_match_reference(arch):
    """Paths, shapes and dtypes of ``model_fns(cfg).init`` at reduced and
    full width; ``param_count`` is the sum over those leaves.  It is held
    to the leaves, not to the reference's ``ArchConfig.param_count``, which
    always counts ``transformer.init``: for seamless-m4t-large-v2 that
    gives 1,231,500,288, while ``encdec.init`` holds 2,036,881,408 (the
    encoder and the cross-attention are left out)."""
    _, jcfg, tcfg, _, _ = arch
    for reduced in (True, False):
        jc = jconfigs.get(jcfg.name.removesuffix("-reduced"), reduced=reduced)
        tc = tconfigs.get(jcfg.name.removesuffix("-reduced"), reduced=reduced)
        want = _reference_leaves(jc)
        got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for p, v in tree.flatten(tmodel_fns(tc).init(tc,
                                                            device="meta"))}
        assert got == want, (jc.name, reduced)
        assert tc.param_count() == sum(math.prod(s) for s, _ in
                                       want.values())
    if not tcfg.encdec:
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.sub_quadratic() == jcfg.sub_quadratic()


def test_forward_matches_reference(arch):
    _, jcfg, tcfg, jparams, tparams = arch
    jin, tin = _inputs(_batch(tcfg))
    want = np.asarray(jmodel_fns(jcfg).forward(jcfg, jparams, **jin))
    with torch.no_grad():
        got = tmodel_fns(tcfg).forward(tcfg, tparams, **tin)
    assert got.shape == (B, S, tcfg.vocab) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_step_grads_match_reference(arch):
    _, jcfg, tcfg, jparams, tparams = arch
    batch = _batch(tcfg, step=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jcfg)))(
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
    """``test_arch_smoke.py``'s table, with each family's extras."""
    rows = {
        "hymba-1.5b": (32, 1600, 25, 5, 5504, 32001),
        "qwen2.5-14b": (48, 5120, 40, 8, 13824, 152064),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "stablelm-1.6b": (24, 2048, 32, 32, 5632, 100352),
        "deepseek-v3-671b": (61, 7168, 128, 128, 2048, 129280),
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
        "xlstm-350m": (24, 1024, 4, 4, 0, 50304),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
        "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000),
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
    hymba = tconfigs.get("hymba-1.5b")
    assert hymba.ssm.d_state == 16 and hymba.ssm.dtr == 100
    assert (hymba.sliding_window, hymba.global_layers) == (1024, (0, 15, 31))
    assert tconfigs.get("xlstm-350m").xlstm.slstm_every == 8
    seamless = tconfigs.get("seamless-m4t-large-v2")
    assert seamless.encdec and seamless.n_enc_layers == 24
    assert (seamless.frontend, seamless.frontend_len) == ("frame", 4096)
    llava = tconfigs.get("llava-next-mistral-7b")
    assert (llava.frontend, llava.frontend_len) == ("patch", 2880)
    assert seamless.param_count() == 2_036_881_408


def test_unported_family_raises():
    """A family name the reference does not know raises, at init and at
    forward; so does the decoder's entry point on an encoder-decoder."""
    cfg = dataclasses.replace(tconfigs.get("smollm-360m", reduced=True),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        ttransformer.init(cfg, device="meta")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        ttransformer.forward(cfg, {}, torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(ValueError, match="encoder-decoder"):
        ttransformer.init(tconfigs.get("seamless-m4t-large-v2",
                                       reduced=True), device="meta")


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


def _assert_trajectory(arch):
    """5 Muon steps of ``arch`` reduced, batch 4 x 32, in both packages."""
    dcfg = tpipeline.DataConfig(vocab=257, seq_len=32, global_batch=4)
    jstate, tstate, losses = _train_both(arch, 5, dcfg)
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


def test_deepseek_loss_ema_trajectory_matches_reference():
    _assert_trajectory("deepseek-v3-671b")


def test_hymba_loss_ema_trajectory_matches_reference():
    """Hymba's windowed attention ‖ SSM blocks (seq 32 > the reduced
    window of 8) through 5 Muon steps."""
    _assert_trajectory("hymba-1.5b")


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
