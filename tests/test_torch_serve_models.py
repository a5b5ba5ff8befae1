"""The port's serving entry points (``train/serve.py`` over
``models/{transformer,encdec}.py``) against the reference's, for all 10
reduced architectures, on the same numpy parameters, tokens and frontend
inputs: ``prefill_fn`` then 3 ``decode_fn`` steps at a scalar ``pos``, a
vector-``pos`` decode over 3 rows at different depths, ``prefill_chunk_fn``
in 3 chunks (logits and every cache leaf after each), the cache's shapes
and dtypes (``init_cache``, ``make_cache_shapes``), ``cache_specs`` and
``input_shardings`` on a fake (2, 4) mesh, and one bf16 cache (smollm).

Tolerances: fp32 logits and cache leaves 1e-4 (the port's logits parity,
``tests/test_torch_train.py``), relative to each leaf's largest entry for
the xLSTM memories; bf16 caches 2e-2 (the reference's bf16 tolerance).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

ARCHS = list(tconfigs.ARCH_IDS)
B, S, MAX_LEN = 3, 6, 24
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _prefix(cfg):
    return cfg.frontend_len if cfg.frontend is not None and not cfg.encdec \
        else 0


def _frontend(cfg, batch):
    """{key: (numpy, jax, torch)} of the patches / frames, or {}."""
    if cfg.frontend is None:
        return {}
    key = "patches" if cfg.frontend == "patch" else "frames"
    length = cfg.frontend_len if not cfg.encdec else 5
    a = np.random.default_rng(11).standard_normal(
        (batch, length, cfg.frontend_dim)).astype(np.float32)
    return {key: a}


def _assert_cache(got, want, tol=TOL, what=""):
    """Every leaf of the port's cache against the reference's (same
    paths), 1e-4 relative to the leaf's largest entry and elementwise."""
    want = dict(tree.flatten(jax.tree.map(np.asarray, want)))
    got = dict(tree.flatten(got))
    assert set(got) == set(want), what
    for p, g in got.items():
        w = want[p].astype(np.float32)
        assert tuple(g.shape) == w.shape, (what, p)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"{what} {p}")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg = jconfigs.get(name, reduced=True)
    tcfg = tconfigs.get(name, reduced=True)
    jp = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = ttransformer.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    fns = types.SimpleNamespace(
        prefill=jax.jit(lambda p, t, dt, **kw: jserve.prefill_fn(
            jcfg, p, t, MAX_LEN, cache_dtype=dt, **kw),
            static_argnums=(2,)),
        decode=jax.jit(lambda p, t, c, pos: jserve.decode_fn(
            jcfg, p, t, c, pos)),
        chunk=jax.jit(lambda p, t, c, pos: jserve.prefill_chunk_fn(
            jcfg, p, t, c, pos)))
    return name, jcfg, tcfg, jp, tp, fns


def _prefilled(arch, dtype=(jnp.float32, torch.float32)):
    name, jcfg, tcfg, jp, tp, fns = arch
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    fe = _frontend(jcfg, B)
    jl, jc = fns.prefill(jp, jnp.asarray(toks), dtype[0],
                         **{k: jnp.asarray(v) for k, v in fe.items()})
    tl, tc = tserve.prefill_fn(tcfg, tp, torch.from_numpy(toks), MAX_LEN,
                               cache_dtype=dtype[1],
                               **{k: torch.from_numpy(v)
                                  for k, v in fe.items()})
    return jl, jc, tl, tc


def test_prefill_then_scalar_decode_match_reference(arch):
    """Prefill of 3 rows, then 3 lockstep decode steps at scalar ``pos``
    (the prompt length plus any prefix), both fed the reference's greedy
    tokens: logits and every cache leaf after each call."""
    name, jcfg, tcfg, jp, tp, fns = arch
    jl, jc, tl, tc = _prefilled(arch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(tc, jc, what=f"{name} prefill")
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = S + _prefix(jcfg) + i
        jl, jc = fns.decode(jp, jnp.asarray(tok), jc,
                            jnp.asarray(pos, jnp.int32))
        tl, tc = tserve.decode_fn(tcfg, tp, torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{name} decode {i}")
        _assert_cache(tc, jc, what=f"{name} decode {i}")


def test_vector_pos_decode_matches_reference(arch):
    """One decode over 3 rows at different depths (per-row positions
    written and attended, per-row rope)."""
    name, jcfg, tcfg, jp, tp, fns = arch
    jl, jc, tl, tc = _prefilled(arch)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    base = S + _prefix(jcfg)
    pos = np.array([base, base - 3, base + 2], np.int32)
    jl, jc = fns.decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
    tl, tc = tserve.decode_fn(tcfg, tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(tc, jc, what=f"{name} vector decode")


def test_prefill_chunk_matches_reference(arch):
    """A 12-token prompt in 3 chunks of 4 into a fresh batch-1 cache
    (decoder-only, token-only archs); the enc-dec and frontend archs
    refuse, as the reference's."""
    name, jcfg, tcfg, jp, tp, fns = arch
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (1, 12)).astype(
        np.int32)
    if jcfg.encdec or jcfg.frontend is not None:
        with pytest.raises((NotImplementedError, ValueError)):
            tserve.prefill_chunk_fn(tcfg, tp, torch.from_numpy(toks), None, 0)
        return
    jc = jmodel_fns(jcfg).init_cache(jcfg, 1, MAX_LEN, jnp.float32)
    tc = ttransformer.init_cache(tcfg, 1, MAX_LEN, torch.float32,
                                 device="cpu")
    for off in range(0, 12, 4):
        jl, jc = fns.chunk(jp, jnp.asarray(toks[:, off:off + 4]), jc,
                           jnp.asarray(off, jnp.int32))
        tl, tc = tserve.prefill_chunk_fn(
            tcfg, tp, torch.from_numpy(toks[:, off:off + 4]), tc, off)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{name} chunk {off}")
        _assert_cache(tc, jc, what=f"{name} chunk {off}")


def test_cache_shapes_and_dtypes_match_reference(arch):
    """``make_cache_shapes`` (meta tensors) and ``init_cache`` against the
    reference's ``make_cache_shapes``: paths, shapes, dtypes."""
    name, jcfg, tcfg, jp, tp, fns = arch
    for jdt, tdt in [(jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)]:
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in tree.flatten(
            jserve.make_cache_shapes(jcfg, 4, 32, jdt))}
        meta = tserve.make_cache_shapes(tcfg, 4, 32, tdt)
        got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for p, v in tree.flatten(meta)}
        assert got == want, name
        assert all(v.device.type == "meta" for _, v in tree.flatten(meta))
        real = (tencdec.init_cache(tcfg, 4, 32, 32, tdt, device="cpu")
                if tcfg.encdec else
                ttransformer.init_cache(tcfg, 4, 32, tdt, device="cpu"))
        assert {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for p, v in tree.flatten(real)} == want


def _norm(spec):
    """A spec entry by entry: None / an axis name / a tuple of names."""
    out = []
    for e in spec:
        if e is None or e == ():
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(e[0] if len(e) == 1 else tuple(e))
        else:
            out.append(e)
    return tuple(out)


def test_cache_specs_match_reference(arch):
    """``cache_specs`` of a (batch 4, 32) cache on a shape-only
    ("data", "model") = (2, 4) mesh and ``input_shardings`` of a batch's
    inputs on a (1, 1) mesh, entry for entry, against the reference's
    PartitionSpecs."""
    name, jcfg, tcfg, jp, tp, fns = arch
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 2, "model": 4})
    shapes = jserve.make_cache_shapes(jcfg, 4, 32)
    want = {p: _norm(s) for p, s in tree.flatten(
        jax.tree.map(lambda s: s, jsharding.cache_specs(jcfg, shapes, jmesh),
                     is_leaf=lambda s: isinstance(s, jax.sharding
                                                  .PartitionSpec)))}
    got = tsharding.cache_specs(tcfg, tserve.make_cache_shapes(tcfg, 4, 32),
                                types.SimpleNamespace(
                                    mesh_dim_names=("data", "model"),
                                    shape=(2, 4)))
    assert {p: _norm(s) for p, s in got.items()} == want, name
    inputs = {"tokens": (4, 16), "pos": (), "frames": (4, 5, 32),
              "odd": (3, 7)}
    jin = jsharding.input_shardings(
        jcfg, {k: jax.ShapeDtypeStruct(v, jnp.float32)
               for k, v in inputs.items()},
        jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                          ("data", "model")))
    tin = tsharding.input_shardings(
        tcfg, {k: torch.empty(v, device="meta") for k, v in inputs.items()},
        types.SimpleNamespace(mesh_dim_names=("data", "model"),
                              shape=(1, 1)))
    assert {k: _norm(v) for k, v in tin.items()} == \
        {k: _norm(s.spec) for k, s in jin.items()}
    # on the (2, 4) mesh, the reference's formula over its batch_spec
    tin = tsharding.input_shardings(
        tcfg, {k: torch.empty(v, device="meta") for k, v in inputs.items()},
        types.SimpleNamespace(mesh_dim_names=("data", "model"),
                              shape=(2, 4)))
    for k, v in inputs.items():
        want = () if not v else _norm(tuple(
            jsharding.batch_spec(jmesh, v[0])) + (None,) * (len(v) - 1))
        assert _norm(tin[k]) == want, k
    assert _norm(tin["odd"]) == (None, None)


def test_bf16_cache_matches_reference():
    """smollm with a bf16 cache (the serving default): prefill and one
    decode against the reference at 2e-2."""
    name = "smollm-360m"
    jcfg = jconfigs.get(name, reduced=True)
    tcfg = tconfigs.get(name, reduced=True)
    jp = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = ttransformer.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    toks = np.random.default_rng(14).integers(0, jcfg.vocab, (2, 9)).astype(
        np.int32)
    jl, jc = jserve.prefill_fn(jcfg, jp, jnp.asarray(toks), 16,
                               cache_dtype=jnp.bfloat16)
    tl, tc = tserve.prefill_fn(tcfg, tp, torch.from_numpy(toks), 16,
                               cache_dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for _, v in tree.flatten(tc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    _assert_cache(tc, jc, BF16_TOL, "bf16 prefill")
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, jc = jserve.decode_fn(jcfg, jp, jnp.asarray(tok), jc,
                              jnp.asarray(9, jnp.int32))
    tl, tc = tserve.decode_fn(tcfg, tp, torch.from_numpy(tok), tc, 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    _assert_cache(tc, jc, BF16_TOL, "bf16 decode")
