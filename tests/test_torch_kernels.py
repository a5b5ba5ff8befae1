"""Port kernels: plain versions vs the reference's oracles and Pallas ops.

The port's wrappers take their plain PyTorch version for CPU tensors, so on
this CPU the same inputs (numpy, seeded) go through ``repro_torch.kernels``
and through ``repro.kernels.ref`` / ``repro.kernels.ops`` (Pallas,
``interpret=True``).  Shapes, dtypes and tolerances are those of
tests/test_kernels.py: fp32 rtol 1e-4 / atol 1e-3, bf16 2e-2 (blocked
accumulation order differs), gram_poly 2e-4.  The CUDA kernels themselves are
held against the plain versions on a card by tests/test_torch_cuda.py and
by chip_smoke.py.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import autotune, ops, ref  # noqa: E402
from repro_torch.kernels.gram_syrk import syrk_lower  # noqa: E402
from repro_torch.kernels.symmul import (  # noqa: E402
    symmul_lower, symmul_plain, tri_index_tables)

SHAPES_SQUARE = [(1, 16), (2, 64), (3, 128), (2, 160), (1, 200), (4, 96)]
SHAPES_RECT = [(1, 16, 64), (2, 64, 256), (2, 96, 40), (1, 128, 384),
               (3, 32, 32), (1, 200, 72)]
DTYPES = ["float32", "bfloat16"]
BLOCKS = list(autotune.INSTANTIATED_BLOCKS)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-3)


def _sym(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (a + np.swapaxes(a, -1, -2)) / 2


def _both(x32: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(x32).to(getattr(torch, dtype))
    j = jnp.asarray(x32).astype(getattr(jnp, dtype))
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield str(tmp_path / "autotune.json")
    autotune.clear_memory_cache()


@pytest.mark.parametrize("batch,m", SHAPES_SQUARE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_symmul_matches_reference(batch, m, dtype):
    a32 = _sym((batch, m, m), 0)
    ta, ja = _both(a32, dtype)
    tb, jb = ref.symmul_ref(ta, ta), jref.symmul_ref(ja, ja)   # A², commutes with A
    got = ops.symmul(ta, tb, block_m=64, block_k=32)
    want_ref = jref.mirror_lower(jref.symmul_ref(ja.astype(jnp.float32),
                                                 jb.astype(jnp.float32)))
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(dtype))
    pallas = jops.symmul(ja, jb, block_m=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(jref.mirror_lower(
        jnp.asarray(pallas, jnp.float32))), **_tol(dtype))


@pytest.mark.parametrize("batch,m,n", SHAPES_RECT)
@pytest.mark.parametrize("dtype", DTYPES)
def test_syrk_matches_reference(batch, m, n, dtype):
    x32 = np.random.default_rng(2).standard_normal((batch, m, n)).astype(
        np.float32)
    tx, jx = _both(x32, dtype)
    got = ops.syrk(tx, block_m=64, block_k=32)
    np.testing.assert_allclose(
        _np(got), _np(jref.syrk_ref(jx.astype(jnp.float32))), **_tol(dtype))
    pallas = jops.syrk(jx, block_m=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("m", [32, 128, 160])
@pytest.mark.parametrize("coeffs", [(3.4445, -4.775, 2.0315),
                                    (8.287, -23.6, 17.3)])
def test_gram_poly_fused_epilogue(m, coeffs):
    g32 = _sym((2, m, m), 4)
    tg, jg = _both(g32, "float32")
    got = ops.gram_poly(tg, *coeffs, block_m=64, block_k=32)
    np.testing.assert_allclose(_np(got), _np(jref.gram_poly_ref(jg, *coeffs)),
                               rtol=2e-4, atol=2e-4)
    pallas = jops.gram_poly(jg, *coeffs, block_m=64, block_k=64,
                            interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-4, atol=2e-4)


def test_gram_poly_bf16_rounds_like_the_kernel():
    """The plain version combines aI + bG + cG² in fp32 before the cast, as
    the kernel does; ``ref.gram_poly_ref`` (like the reference) rounds G² to
    bf16 first, so the two differ by bf16 rounding (tolerance 2e-2 rel)."""
    g = torch.from_numpy(_sym((2, 64, 64), 4) / 8).to(torch.bfloat16)
    c = (3.4445, -4.775, 2.0315)
    plain = symmul_plain(g, g, epilogue="gram_poly", coeffs=c)
    np.testing.assert_allclose(_np(plain), _np(ref.gram_poly_ref(g, *c)),
                               rtol=2e-2, atol=2e-2)
    exact = symmul_plain(g.float(), g.float(), epilogue="gram_poly", coeffs=c)
    assert (plain.float() - exact).abs().max() <= \
        (ref.gram_poly_ref(g, *c).float() - exact).abs().max() + 1e-6


@pytest.mark.parametrize("bm,bk", BLOCKS)
def test_block_size_invariance(bm, bk):
    a32 = _sym((2, 256, 256), 5)
    ta, ja = _both(a32, "float32")
    got = ops.symmul(ta, ta, block_m=bm, block_k=bk)
    np.testing.assert_allclose(_np(got), _np(jref.symmul_ref(ja, ja)),
                               rtol=1e-4, atol=1e-4)


def test_unaligned_padding_roundtrip():
    x32 = np.random.default_rng(6).standard_normal((2, 100, 212)).astype(
        np.float32)
    tx, jx = _both(x32, "float32")
    got = ops.syrk(tx, block_m=128, block_k=32)
    np.testing.assert_allclose(_np(got), _np(jref.syrk_ref(jx)),
                               rtol=1e-5, atol=1e-5)


def test_leading_batch_dims_flatten():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, 16, 40)).astype(np.float32))
    got = ops.syrk(x)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(_np(got), _np(ref.syrk_ref(x)), rtol=1e-5,
                               atol=1e-5)


def test_tri_index_tables():
    ii, jj = tri_index_tables(4)
    assert len(ii) == 10
    assert all(j <= i for i, j in zip(ii, jj))
    assert sorted(zip(ii.tolist(), jj.tolist())) == \
        [(i, j) for i in range(4) for j in range(i + 1)]


def test_tile_closed_form_matches_table():
    """csrc/lower_tiles.cuh:tile_of enumerates tiles in the table's order:
    l = i(i+1)/2 + j.  Checked here against the table for the slice's grids
    (plus margin), with the same float closed form and integer correction."""
    ii, jj = tri_index_tables(64)
    for l, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        t = int((np.sqrt(np.float32(8.0) * np.float32(l) + np.float32(1.0))
                 - np.float32(1.0)) * np.float32(0.5))
        while (t + 1) * (t + 2) // 2 <= l:
            t += 1
        while t * (t + 1) // 2 > l:
            t -= 1
        assert (t, l - t * (t + 1) // 2) == (i, j)


def test_mirror_lower_discards_upper_half_elementwise():
    raw = torch.arange(16.0).reshape(1, 4, 4) + torch.triu(
        torch.full((4, 4), float("nan")), 1)
    out = ref.mirror_lower(raw).numpy()
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out, out.transpose(0, 2, 1))
    np.testing.assert_array_equal(
        out, np.asarray(jref.mirror_lower(jnp.asarray(raw.numpy()))))


def test_wrappers_validate_block_contract():
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="no kernel instantiated"):
        syrk_lower(x, block_m=128, block_k=128)
    with pytest.raises(ValueError, match="no kernel instantiated"):
        symmul_lower(x, x, block_m=32, block_k=32)
    with pytest.raises(ValueError, match="no kernel"):
        syrk_lower(x, block_m=64, block_k=32, out_dtype=torch.float16)


def test_instantiated_blocks_match_cuda_dispatch():
    """Every autotune candidate has a CUDA instantiation and vice versa."""
    for src in ("gram_syrk.cu", "symmul.cu"):
        text = (CSRC / src).read_text()
        pairs = {(int(a), int(b)) for a, b in re.findall(
            r"block_m == (\d+) && block_k == (\d+)", text)}
        assert pairs == set(autotune.INSTANTIATED_BLOCKS), src


def test_autotune_candidates_fit_hopper_smem():
    cands = autotune.candidate_blocks(960, 2560, 4)
    assert cands and set(cands) <= set(autotune.INSTANTIATED_BLOCKS)
    for bm, bk in cands:
        assert autotune.smem_bytes(bm, bk) <= autotune.SMEM_BYTES
        assert bm % 16 == 0 and (bm // 16) ** 2 * autotune.THREADS == bm * bm


def test_autotune_cache_roundtrip_keyed_by_arch(_isolated_cache):
    path = _isolated_cache
    win = autotune.tune("symmul", 512, 512, "float32", cache_path=path,
                        arch="sm90")
    assert win in autotune.INSTANTIATED_BLOCKS
    assert autotune.lookup("symmul", 512, 512, "float32", cache_path=path,
                           arch="sm90") == win
    autotune.clear_memory_cache()
    assert autotune.cached_entry("symmul", 512, 512, "float32",
                                 cache_path=path, arch="sm90") == win
    assert autotune.cached_entry("symmul", 512, 512, "float32",
                                 cache_path=path, arch="cpu") is None
    with open(path) as f:
        assert list(json.load(f)) == ["sm90:symmul:512x512:float32"]


def test_autotune_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.undo()                      # the module's own path
    path = Path(autotune.default_cache_path())
    assert path.parts[-3:] == ("build", "repro_torch", "autotune.json")
    assert ".cache" not in path.parts


# The slice's kernel shapes and the pair measured fastest at each on an H100
# (chip_smoke.py, blocks phase): the analytical rule must pick the same.
SLICE_WINNERS = [("syrk", 960, 2560, (128, 32)), ("syrk", 960, 960, (128, 32)),
                 ("syrk", 320, 960, (64, 32)), ("symmul", 960, 960, (128, 32)),
                 ("gram_poly", 960, 960, (128, 32)),
                 ("symmul", 320, 320, (64, 32)),
                 ("gram_poly", 320, 320, (64, 32))]


@pytest.mark.parametrize("mode,m,k,want", SLICE_WINNERS)
def test_analytical_rule_picks_measured_winner(_isolated_cache, mode, m, k,
                                               want):
    assert autotune.lookup(mode, m, k, "float32", arch="sm90") == want


def test_prewarm_plan_covers_plan_shapes(_isolated_cache):
    from repro_torch.core import api
    params = {"wq": torch.zeros(3, 64, 64), "up": torch.zeros(3, 64, 256),
              "down": torch.zeros(3, 256, 64), "norm": torch.ones(3, 64)}
    plan = api.dedicate_params(params, num_owners=2, strategy="greedy")
    n = autotune.prewarm_plan(plan, dtypes=("float32", "bfloat16"),
                              cache_path=_isolated_cache, arch="sm90")
    shapes = autotune.plan_shapes(plan)
    assert n == 2 * len(shapes)
    with open(_isolated_cache) as f:
        cached = json.load(f)
    for mode, m, k in shapes:
        winner = tuple(cached[f"sm90:{mode}:{m}x{k}:float32"])
        best = min(autotune.candidate_blocks(m, k, 4),
                   key=lambda b: (autotune.analytical_score(*b, m, k, 4),
                                  -b[0]))
        assert winner == best
