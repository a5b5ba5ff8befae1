"""The port's Multi-head Latent Attention (``repro_torch.models.layers.
mla_attention``, the training path) against the reference's
``repro.models.layers.mla_attention`` with ``cache=None``, on the same numpy
parameters and inputs: the reduced DeepSeek-V3 ``MLAConfig`` and one whose
v head dim differs from its qk dim at a narrow width, with rotary on and
off.  Forward and gradients (``jax.grad`` against autograd) within rtol
1e-4 / atol 1e-4, as the port's logits parity (``tests/test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 20
# the reduced DeepSeek-V3 MLA, and v_head_dim (24) unlike qk (12 + 8)
SHAPES = {"reduced": {},
          "v_ne_qk": dict(n_heads=3, qk_nope_dim=12, qk_rope_dim=8,
                          v_head_dim=24)}


def _cfgs(kind):
    base = jconfigs.get("deepseek-v3-671b", reduced=True)
    jcfg = dataclasses.replace(base.mla, **SHAPES[kind])
    tcfg = dataclasses.replace(
        tconfigs.get("deepseek-v3-671b", reduced=True).mla, **SHAPES[kind])
    return base, jcfg, tcfg


def test_config_matches_reference():
    for reduced in (False, True):
        got = tconfigs.get("deepseek-v3-671b", reduced=reduced)
        want = jconfigs.get("deepseek-v3-671b", reduced=reduced)
        assert dataclasses.asdict(got.mla) == dataclasses.asdict(want.mla)
        assert got.attn_kind == want.attn_kind == "mla"


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_mla_attention_matches_reference(kind, rope):
    arch, jcfg, tcfg = _cfgs(kind)
    jp = jlayers.mla_init(jax.random.PRNGKey(0), jcfg)
    tp = tree.tree_map(lambda a: torch.from_numpy(np.array(a))
                       .requires_grad_(True), jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    mla_arch = dataclasses.replace(arch, mla=jcfg)
    jrope = jtransformer._rope_for(mla_arch, jnp.arange(S)) if rope else None
    trope = ttransformer._rope_for(
        dataclasses.replace(tconfigs.get("deepseek-v3-671b", reduced=True),
                            mla=tcfg), torch.arange(S)) if rope else None

    def jloss(p, xx):
        out, cache = jlayers.mla_attention(p, jcfg, xx, rope_cs=jrope)
        assert cache is None
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tlayers.mla_attention(tp, tcfg, tx, rope_cs=trope)
    assert tout.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    paths, leaves = zip(*tree.flatten(tp))
    grads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(),
                                list(leaves) + [tx])
    want = dict(tree.flatten(jax.tree.map(np.asarray, jgp)))
    for p, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[p], err_msg=p, **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)


def test_sdpa_reads_v_head_dim_off_v():
    """``_sdpa`` at MLA's published head dims (qk 192, v 128), one head:
    the output carries v's head dim and equals the causal softmax
    attention computed directly."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 6, 2, 192, generator=gen)
    k = torch.randn(1, 6, 2, 192, generator=gen)
    v = torch.randn(1, 6, 2, 128, generator=gen)
    pos = torch.arange(6)
    out = tlayers._sdpa(q, k, v, scale=192 ** -0.5, qpos=pos, kpos=pos,
                        causal=True)
    assert out.shape == (1, 6, 2, 128)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * 192 ** -0.5
    logits = logits.masked_fill(~torch.ones(6, 6, dtype=torch.bool).tril(),
                                -torch.inf)
    want = torch.einsum("bhst,bthd->bshd", logits.softmax(-1), v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
