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
from repro_torch.kernels.gram_syrk import syrk_lower, syrk_plain  # noqa: E402
from repro_torch.kernels.symmul import (  # noqa: E402
    TMA_ALIGN, padded_call, symmul_lower, symmul_plain, tri_index_tables)

SHAPES_SQUARE = [(1, 16), (2, 64), (3, 128), (2, 160), (1, 200), (4, 96)]
SHAPES_RECT = [(1, 16, 64), (2, 64, 256), (2, 96, 40), (1, 128, 384),
               (3, 32, 32), (1, 200, 72)]
DTYPES = ["float32", "bfloat16"]
BLOCKS = list(autotune.INSTANTIATED_BLOCKS[4])
# a block pair of each input type (block_k: one 128-byte swizzle row)
PAIR = {"float32": dict(block_m=64, block_k=32),
        "bfloat16": dict(block_m=128, block_k=64)}
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
    got = ops.symmul(ta, tb, **PAIR[dtype])
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
    got = ops.syrk(tx, **PAIR[dtype])
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


@pytest.mark.parametrize("kernel", ["gram_syrk", "symmul_plain",
                                    "symmul_gram_poly"])
@pytest.mark.parametrize("m,n", [(101, 211), (198, 203), (60, 1003)])
def test_padded_call_bf16_equals_unpadded_bitwise(kernel, m, n):
    """bf16 pads m and n to multiples of 8 (TMA's 16-byte row strides):
    the zero-pad-and-crop of ``padded_call`` equals the unpadded plain
    result bit for bit, for the SYRK and both epilogues.  The operands are
    small integers, so every fp32 partial sum is exact and the comparison
    does not hang on the CPU BLAS summing a longer contraction in another
    order (MKL does, at (60, 1003))."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-8, 9, (2, m, n)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-4, 5, (2, m, m)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (2, m, m)).astype(np.float32))
    x, a, b = (t.to(torch.bfloat16) for t in (x, a, b))
    g = ref.mirror_lower(a)
    coeffs = (8.287, -23.6, 17.3)
    fn, operands = {
        "gram_syrk": (syrk_plain, (x,)),
        "symmul_plain": (symmul_plain, (a, b)),
        "symmul_gram_poly": (lambda p, q: symmul_plain(
            p, q, epilogue="gram_poly", coeffs=coeffs), (g, g)),
    }[kernel]
    assert TMA_ALIGN[torch.bfloat16] == 8 and m % 8
    got = padded_call(fn, *operands)
    assert got.shape == (2, m, m) and got.dtype == torch.bfloat16
    assert torch.equal(got, fn(*operands))


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


def _grouped_tile_of(l, nb, group, rows):
    """csrc/lower_tiles.cuh:grouped_tile_of, line for line (``rows``: the
    row-major row of every tile, tile_of's)."""
    t = int(rows[l])
    r0 = (t // group) * group
    h = min(group, nb - r0)
    q = l - r0 * (r0 + 1) // 2
    full = (r0 + 1) * h
    if q < full:
        return r0 + q % h, q // h
    q -= full
    for d in range(1, h):
        if q < h - d:
            return r0 + d + q, r0 + d
        q -= h - d
    raise AssertionError(f"tile {l} outside the {nb}-block grid")


@pytest.mark.parametrize("nb,group", [(1, 8), (7, 8), (8, 8), (12, 8),
                                      (24, 16), (29, 16), (144, 8),
                                      (145, 16)])
def test_grouped_tile_order_covers_each_lower_tile_once(nb, group):
    """The bf16 kernels' tile order (lower_tiles.cuh:grouped_tile_of) is a
    permutation of the lower tiles that keeps each group of ``group`` block
    rows in its row-major places, column by column inside the group: at
    nemotron-4-340b's m = 18432 (144 blocks of 128) the 132 blocks in flight
    read about 8 row panels and 17 column panels."""
    ii, _ = tri_index_tables(nb)
    tiles = [_grouped_tile_of(l, nb, group, ii) for l in range(len(ii))]
    assert sorted(tiles) == [(i, j) for i in range(nb) for j in range(i + 1)]
    assert [i // group for i, _ in tiles] == [int(i) // group for i in ii]
    for l in range(len(tiles) - 1):
        (i0, j0), (i1, j1) = tiles[l], tiles[l + 1]
        if i0 // group == i1 // group:
            assert (j0, i0) < (j1, i1)
    if nb == 144:
        window = tiles[5000:5132]
        assert len({i for i, _ in window}) <= 8
        assert len({j for _, j in window}) <= 18


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
    """Every autotune candidate has a CUDA instantiation and vice versa,
    per input type: each source's fp32 and bf16 dispatch (the blocks
    after its "fp32 BLOCKS" / "bf16 BLOCKS" note)."""
    for src in ("gram_syrk.cu", "symmul.cu"):
        text = (CSRC / src).read_text()
        for dtype, nbytes in (("fp32", 4), ("bf16", 2)):
            part = text.split(f"{dtype} BLOCKS", 1)[1]
            part = part.split("return lt::kUnsupported", 1)[0]
            pairs = {(int(a), int(b)) for a, b in re.findall(
                r"block_m == (\d+) && block_k == (\d+)", part)}
            assert pairs == set(autotune.INSTANTIATED_BLOCKS[nbytes]), \
                (src, dtype)
            assert all(bk * nbytes == 128 for _, bk in pairs)
        assert len(re.findall(r"block_m == \d+ && block_k", text)) == 4, src


# csrc/tf32_lower.cuh's Tf32Cfg<BM>::kSmem: raw ring (2 stages at BM = 64,
# 3 at 128) of two BM x 32 fp32 slices, one {big, small} split buffer, one
# mbarrier a stage and 1 KB of alignment slack
TF32_SMEM = {64: 2 * 2 * 8192 + 2 * 8192 + 2 * 8 + 1024,
             128: 3 * 2 * 16384 + 2 * 16384 + 3 * 8 + 1024}
# csrc/bf16_lower.cuh's Bf16Cfg<BM>::kSmem: ring (6 stages at BM = 128, 4 at
# 192) of two BM x 64 bf16 slices, a full and an empty mbarrier a stage and
# 1 KB of alignment slack
BF16_SMEM = {128: 6 * 2 * 16384 + 2 * 6 * 8 + 1024,
             192: 4 * 2 * 24576 + 2 * 4 * 8 + 1024}


@pytest.mark.parametrize("mode,m,k,dtype_bytes",
                         [("syrk", 960, 2560, 4), ("symmul", 960, 960, 4),
                          ("gram_poly", 320, 320, 4), ("symmul", 320, 320, 2),
                          ("syrk", 320, 960, 2)])
def test_autotune_candidates_fit_hopper_smem(mode, m, k, dtype_bytes):
    """Every product takes its tensor-core mainloop's footprint: 3xTF32 for
    fp32 inputs, the bf16 wgmma ring for bf16."""
    cands = autotune.candidate_blocks(mode, m, k, dtype_bytes)
    assert cands and set(cands) <= set(
        autotune.INSTANTIATED_BLOCKS[dtype_bytes])
    assert autotune.tensor_core_path(mode, dtype_bytes)
    for bm, bk in cands:
        smem = autotune.smem_bytes(mode, bm, bk, dtype_bytes)
        assert smem <= autotune.SMEM_BYTES
        # whole 64-row warpgroup slabs; bk = one 128-byte swizzle row
        assert bm % 64 == 0 and bk * dtype_bytes == 128
        assert bk == autotune.slice_k(dtype_bytes)
        want = TF32_SMEM if dtype_bytes == 4 else BF16_SMEM
        assert smem == want[bm]


def test_autotune_cache_roundtrip_keyed_by_arch(_isolated_cache):
    path = _isolated_cache
    win = autotune.tune("symmul", 512, 512, "float32", cache_path=path,
                        arch="sm90")
    assert win in autotune.INSTANTIATED_BLOCKS[4]
    assert autotune.lookup("symmul", 512, 512, "float32", cache_path=path,
                           arch="sm90") == win
    autotune.clear_memory_cache()
    assert autotune.cached_entry("symmul", 512, 512, "float32",
                                 cache_path=path, arch="sm90") == win
    assert autotune.cached_entry("symmul", 512, 512, "float32",
                                 cache_path=path, arch="cpu") is None
    with open(path) as f:
        assert list(json.load(f)) == [
            f"sm90:{autotune.rule_digest()}:symmul:512x512:float32"]


def test_autotune_cache_ignores_entries_of_other_kernels(_isolated_cache):
    """A winner cached for other kernel sources or another scoring rule (a
    different digest in its key) is never returned."""
    with open(_isolated_cache, "w") as f:
        json.dump({"sm90:0000000000000000:symmul:960x960:float32": [128, 32]},
                  f)
    assert autotune.cached_entry("symmul", 960, 960, "float32",
                                 cache_path=_isolated_cache,
                                 arch="sm90") is None
    assert autotune.lookup("symmul", 960, 960, "float32",
                           cache_path=_isolated_cache, arch="sm90") == (64, 32)


def test_rule_digest_follows_kernel_sources(monkeypatch):
    from repro_torch.kernels import build
    before = autotune.rule_digest()
    autotune.rule_digest.cache_clear()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    try:
        assert autotune.rule_digest() != before
    finally:
        autotune.rule_digest.cache_clear()


@pytest.mark.parametrize("mode,dtype,want",
                         [("syrk", "float32", (64, 32)),
                          ("symmul", "float32", (64, 32)),
                          ("gram_poly", "float32", (64, 32)),
                          ("symmul", "bfloat16", (128, 64)),
                          ("syrk", "bfloat16", (128, 64))])
def test_autotune_tie_break_per_mainloop(_isolated_cache, mode, dtype, want):
    """m = 512 pads neither fp32 grid, so the fp32 scores tie and the tie
    goes to the smaller tile.  In bf16 neither grid fills the card's 132
    SMs (10 tiles of 128 rows, 3 of 192): the 128-row tile leaves fewer
    idle, which outweighs its cost a product; on equal bf16 scores the
    larger tile would go first."""
    assert autotune.lookup(mode, 512, 512, dtype, arch="sm90") == want
    nbytes = 2 if dtype == "bfloat16" else 4
    pairs = sorted(autotune.INSTANTIATED_BLOCKS[nbytes],
                   key=lambda b: autotune.tie_break(mode, b, nbytes))
    assert pairs[0][0] == (192 if nbytes == 2 else 64)


# nemotron-4-340b's bf16 Gram shapes (the >= 340 B policy, one owner's rows
# on (2, 2)) and the pair measured fastest at each on an H100
# (chip_smoke.py, blocks phase): the analytical rule must pick the same.
BF16_WINNERS = [("syrk", 18432, 73728, (192, 64)),
                ("syrk", 18432, 18432, (192, 64)),
                ("symmul", 18432, 18432, (192, 64)),
                ("gram_poly", 18432, 18432, (192, 64)),
                ("syrk", 1536, 18432, (128, 64)),
                ("symmul", 1536, 1536, (128, 64))]


@pytest.mark.parametrize("mode,m,k,want", BF16_WINNERS)
def test_bf16_rule_picks_measured_winner(_isolated_cache, mode, m, k, want):
    assert autotune.lookup(mode, m, k, "bfloat16", arch="sm90") == want


def test_autotune_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.undo()                      # the module's own path
    path = Path(autotune.default_cache_path())
    assert path.parts[-3:] == ("build", "repro_torch", "autotune.json")
    assert ".cache" not in path.parts


# The slice's kernel shapes and the pair measured fastest at each on an H100
# (chip_smoke.py, blocks phase; every fp32 product on the tensor-core
# mainloop): the analytical rule must pick the same.
SLICE_WINNERS = [("syrk", 960, 2560, (64, 32)), ("syrk", 960, 960, (64, 32)),
                 ("syrk", 320, 960, (64, 32)), ("symmul", 960, 960, (64, 32)),
                 ("gram_poly", 960, 960, (64, 32)),
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
        winner = tuple(
            cached[f"sm90:{autotune.rule_digest()}:{mode}:{m}x{k}:float32"])
        best = min(autotune.candidate_blocks(mode, m, k, 4),
                   key=lambda b: (autotune.analytical_score(mode, *b, m, k,
                                                            4),
                                  autotune.tie_break(mode, b)))
        assert winner == best
