"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's (``repro.models.encdec``) on the same numpy parameters, frames
and tokens, at the reduced seamless-m4t-large-v2: ``encode``, ``forward``
and one loss's gradients; the encoder's rope and the cross-attention's
lack of rope and mask; the model dispatch and the parameter count.

Tolerances: outputs 1e-4 and gradients rtol 1e-4 / atol 1e-5 (the arch
twin's, ``tests/test_torch_arch.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH = "seamless-m4t-large-v2"
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S_DEC = 2, 12


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get(ARCH, reduced=True)
    tcfg = tconfigs.get(ARCH, reduced=True)
    jp = jencdec.init(jcfg, jax.random.PRNGKey(0))
    tp = tencdec.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu", requires_grad=True)
    return jcfg, tcfg, jp, tp


def _frames(cfg, seed=0, length=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, length or cfg.frontend_len,
                                cfg.frontend_dim)).astype(np.float32)


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S_DEC)).astype(np.int32)


def test_model_fns_dispatches_on_encdec():
    assert model_fns(tconfigs.get(ARCH, reduced=True)) is tencdec
    assert model_fns(tconfigs.get("smollm-360m", reduced=True)).__name__ \
        == "repro_torch.models.transformer"
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        tencdec.init(tconfigs.get("smollm-360m", reduced=True),
                     device="meta")


def test_param_count_is_the_encdec_tree():
    """2,036,881,408 at full width: ``encdec.init``'s leaves.  The
    reference's ``ArchConfig.param_count`` counts ``transformer.init`` for
    every config and gives 1,231,500,288 (no encoder, no cross-attention);
    the port does not copy that."""
    jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    shapes = jax.eval_shape(lambda k: jencdec.init(jcfg, k),
                            jax.random.PRNGKey(0))
    leaves = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
    assert tcfg.param_count() == leaves == 2_036_881_408
    assert jcfg.param_count() == 1_231_500_288


@pytest.mark.parametrize("length", [None, 5])
def test_encode_matches_reference(model, length):
    """Frames of the configured length and of another one (5)."""
    jcfg, tcfg, jp, tp = model
    frames = _frames(tcfg, length=length)
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames))
    with torch.no_grad():
        got = tencdec.encode(tcfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_forward_and_grads_match_reference(model):
    jcfg, tcfg, jp, tp = model
    batch = {"tokens": _tokens(tcfg), "labels": _tokens(tcfg, seed=2),
             "frames": _frames(tcfg)}
    want = jencdec.forward(jcfg, jp, jnp.asarray(batch["tokens"]),
                           frames=jnp.asarray(batch["frames"]))
    with torch.no_grad():
        got = tencdec.forward(tcfg, tp, torch.from_numpy(batch["tokens"]),
                              frames=torch.from_numpy(batch["frames"]))
    assert got.shape == (B, S_DEC, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    jloss, jgrads = jax.value_and_grad(jstep.make_loss_fn(jcfg))(
        jp, jax.tree.map(jnp.asarray, batch))
    paths, leaves = zip(*tree.flatten(tp))
    loss = tstep.make_loss_fn(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    want = dict(tree.flatten(jax.tree.map(np.asarray, jgrads)))
    assert set(paths) == set(want)
    for p, g in zip(paths, grads):
        assert float(g.abs().sum()) > 0, p
        np.testing.assert_allclose(g.numpy(), want[p], err_msg=p, **GRAD_TOL)


def test_cross_attention_has_no_mask_and_no_rope():
    """Queries (S = 5) over keys and values from another sequence (T = 9):
    equal to the reference's, and invariant under any permutation of the
    source rows (no mask and no rope reach the keys)."""
    jc = jencdec._enc_attn_cfg(jconfigs.get(ARCH, reduced=True))
    tc = tencdec._enc_attn_cfg(tconfigs.get(ARCH, reduced=True))
    jp = jlayers.attention_init(jax.random.PRNGKey(0), jc)
    tp = tencdec.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 5, tc.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 9, tc.d_model)).astype(np.float32)
    cos, sin = jtransformer._rope_angles(tc.head_dim, jnp.arange(5),
                                         tc.rope_theta)
    want, _ = jlayers.attention(jp, jc, jnp.asarray(x), xk=jnp.asarray(src),
                                rope_cs=(cos, sin, cos, sin))
    trope = tuple(torch.from_numpy(np.array(a)) for a in (cos, sin) * 2)
    got = tlayers.attention(tp, tc, torch.from_numpy(x),
                            xk=torch.from_numpy(src), rope_cs=trope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    perm = torch.from_numpy(rng.permutation(9))
    shuffled = tlayers.attention(tp, tc, torch.from_numpy(x),
                                 xk=torch.from_numpy(src)[:, perm],
                                 rope_cs=trope)
    torch.testing.assert_close(shuffled, got, rtol=1e-5, atol=1e-6)


def test_encoder_attention_is_noncausal_with_rope(model):
    """The encoder's self attention sees every frame (a later frame moves
    an earlier output) and applies rope (shuffling the frames does not
    just shuffle the outputs), as the reference's."""
    _, tcfg, _, tp = model
    bp = tree.tree_map(lambda w: w[0].detach(), tp["enc_blocks"])
    acfg = tencdec._enc_attn_cfg(tcfg)
    rope = tencdec._rope_for(tcfg, torch.arange(8))
    x = torch.randn(B, 8, tcfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    out = tlayers.attention(bp["attn"], acfg, x, rope_cs=rope)
    later = x.clone()
    later[:, -1] += 1.0
    moved = tlayers.attention(bp["attn"], acfg, later, rope_cs=rope)
    assert float((moved[:, 0] - out[:, 0]).abs().max()) > 1e-3
    perm = torch.arange(8).flip(0)
    shuffled = tlayers.attention(bp["attn"], acfg, x[:, perm], rope_cs=rope)
    assert float((shuffled - out[:, perm]).abs().max()) > 1e-3
    no_rope = tlayers.attention(bp["attn"], acfg, x[:, perm])
    torch.testing.assert_close(
        no_rope, tlayers.attention(bp["attn"], acfg, x)[:, perm],
        rtol=1e-5, atol=1e-6)
