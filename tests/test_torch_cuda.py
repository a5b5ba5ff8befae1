"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs no JAX, so it runs where the port runs:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips.  Tolerances: fp32 rtol 1e-4 /
atol 1e-3, bf16 2e-2 (the reference's kernel tolerances); the fp32 SYRK on
the tensor cores (3xTF32) also max|err| <= 1e-5 · max|want| on
heavy-tailed rows, the gate of chip_smoke.py; the bf16 unaligned and
non-symmetric cases 2^-7 of the largest entry (chip_smoke.BF16_GATE,
the diagonal apart).
"""

import pytest
import torch

from repro_torch.kernels import LAUNCHES, autotune, ops, ref, reset_launches
from repro_torch.kernels.gram_syrk import (syrk_lower, syrk_plain,
                                           syrk_tf32_emulated)
from repro_torch.kernels.symmul import symmul_lower, symmul_plain

pytestmark = pytest.mark.cuda

BLOCKS = list(autotune.INSTANTIATED_BLOCKS[4])
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SCALED_GATE = 1e-5


def _heavy_rows(device, shape, seed=0):
    """Cubed Gaussians, each row at unit norm (chip_smoke.syrk_inputs)."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(*shape, generator=gen, device=device) ** 3
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _assert_scaled(got, want):
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all()
    assert err <= SCALED_GATE * float(want.abs().max()), err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,bm,bk", [
    (dtype, bm, bk) for dtype, nbytes in (("float32", 4), ("bfloat16", 2))
    for bm, bk in autotune.INSTANTIATED_BLOCKS[nbytes]])
def test_kernels_match_plain(cuda_device, bm, bk, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda_device).manual_seed(0)
    # entries of G = X Xᵀ near 1, so atol 1e-3 is small against every term
    x = torch.randn(2, 100, 212, generator=gen, device=cuda_device)
    x = (x / 212 ** 0.5).to(dt)
    g = syrk_lower(x, block_m=bm, block_k=bk)
    torch.testing.assert_close(g.float(), ref.mirror_lower(syrk_plain(x))
                               .float(), **TOL[dtype])
    c = (8.287, -23.6, 17.3)
    p = symmul_lower(g, g, epilogue="gram_poly", coeffs=c, block_m=bm,
                     block_k=bk)
    torch.testing.assert_close(p.float(), ref.mirror_lower(symmul_plain(
        g, g, epilogue="gram_poly", coeffs=c)).float(), **TOL[dtype])
    q = symmul_lower(p, g, block_m=bm, block_k=bk)
    torch.testing.assert_close(q.float(), ref.mirror_lower(
        symmul_plain(p, g)).float(), **TOL[dtype])


def test_output_is_exactly_symmetric(cuda_device):
    a = torch.randn(3, 200, 200, device=cuda_device)
    b = torch.randn(3, 200, 200, device=cuda_device)   # A·B not symmetric
    c = symmul_lower(a, b, block_m=64, block_k=32)
    assert torch.equal(c, c.mT)
    torch.testing.assert_close(c, ref.mirror_lower(symmul_plain(a, b)),
                               **TOL["float32"])


@pytest.mark.parametrize("bm,bk", autotune.INSTANTIATED_BLOCKS[2])
@pytest.mark.parametrize("m", [101, 198, 328])
def test_bf16_symmul_nonsymmetric_b(cuda_device, m, bm, bk):
    """bf16 symmul reads B as it lies (MN-major, the wgmma transpose bit):
    with B not symmetric the kernel matches the plain A·B within 2^-7 of
    its largest entry and is far from A·Bᵀ; m = 101 and 198 take the pad
    path (m % 8 != 0), one launch each."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    a = torch.randn(2, m, m, generator=gen, device=cuda_device)
    b = torch.randn(2, m, m, generator=gen, device=cuda_device) / m ** 0.5
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    reset_launches()
    got = symmul_lower(a, b, block_m=bm, block_k=bk)
    assert LAUNCHES["symmul"] == 1
    assert got.shape == (2, m, m) and torch.equal(got, got.mT)
    want = ref.mirror_lower(symmul_plain(a, b, out_dtype=torch.float32))
    wrong = ref.mirror_lower(symmul_plain(a, b.mT, out_dtype=torch.float32))
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2.0 ** -7 * scale
    assert float((got.float() - wrong).abs().max()) >= 0.1 * scale


@pytest.mark.parametrize("bm,bk", autotune.INSTANTIATED_BLOCKS[2])
@pytest.mark.parametrize("shape", [(2, 101, 211), (3, 198, 1003),
                                   (1, 60, 73728)])
def test_bf16_syrk_and_gram_poly_unaligned(cuda_device, shape, bm, bk):
    """bf16 shapes whose m or n is not a multiple of 8 go through the
    zero-pad-and-crop (one launch); the SYRK (bf16 and fp32 output) and
    gram_poly match the plain versions within 2^-7 of the largest entry,
    the diagonal apart."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = (torch.randn(*shape, generator=gen, device=cuda_device)
         / shape[-1] ** 0.5).to(torch.bfloat16)
    want = ref.mirror_lower(syrk_plain(x, out_dtype=torch.float32))

    def close(got, want):
        off = (got.float() - want).abs()
        diag = off.diagonal(dim1=-2, dim2=-1).clone()
        off.diagonal(dim1=-2, dim2=-1).zero_()
        w = want.abs()
        wdiag = w.diagonal(dim1=-2, dim2=-1).clone()
        w.diagonal(dim1=-2, dim2=-1).zero_()
        assert float(off.max()) <= 2.0 ** -7 * float(w.max())
        assert float(diag.max()) <= 2.0 ** -7 * float(wdiag.max())
    reset_launches()
    g = syrk_lower(x, block_m=bm, block_k=bk)
    close(g, want)
    close(syrk_lower(x, block_m=bm, block_k=bk, out_dtype=torch.float32),
          want)
    assert LAUNCHES["syrk"] == 2
    c = (8.287, -23.6, 17.3)
    p = symmul_lower(g, g, epilogue="gram_poly", coeffs=c, block_m=bm,
                     block_k=bk)
    close(p, ref.mirror_lower(symmul_plain(g, g, epilogue="gram_poly",
                                           coeffs=c, out_dtype=torch.float32)))


def test_wrappers_count_launches(cuda_device):
    reset_launches()
    x = torch.randn(2, 64, 96, device=cuda_device)
    g = ops.syrk(x)
    ops.gram_poly(g, 1.0, 2.0, 3.0)
    ops.symmul(g, g)
    assert LAUNCHES == {"syrk": 1, "symmul": 1, "gram_poly": 1}


def test_unsupported_dtype_raises_on_card(cuda_device):
    x = torch.randn(1, 32, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        syrk_lower(x, block_m=64, block_k=32)


@pytest.mark.parametrize("bm,bk", BLOCKS)
@pytest.mark.parametrize("shape", [(4, 320, 960), (2, 100, 212)])
def test_fp32_syrk_within_scaled_gate(cuda_device, shape, bm, bk):
    """3xTF32 SYRK within 1e-5 · max|want| for both block pairs, a gate one
    TF32 pass misses by >= 10x on the same rows."""
    x = _heavy_rows(cuda_device, shape)
    want = ref.mirror_lower(syrk_plain(x))
    _assert_scaled(syrk_lower(x, block_m=bm, block_k=bk), want)
    one = ref.mirror_lower(syrk_tf32_emulated(x, passes=1))
    assert float((one - want).abs().max()) >= \
        10 * SCALED_GATE * float(want.abs().max())


def test_fp32_syrk_is_exactly_symmetric(cuda_device):
    x = _heavy_rows(cuda_device, (3, 200, 328), seed=1)
    g = syrk_lower(x, block_m=64, block_k=32)
    assert torch.equal(g, g.mT)


@pytest.mark.parametrize("shape", [(2, 101, 211), (2, 102, 960),
                                   (2, 96, 213)])
def test_fp32_syrk_unaligned_pad_path(cuda_device, shape):
    """m or n not a multiple of 4 goes through the zero-pad-and-crop: one
    launch, output (B, m, m), within the gate."""
    x = _heavy_rows(cuda_device, shape, seed=2)
    reset_launches()
    g = syrk_lower(x, block_m=64, block_k=32)
    assert LAUNCHES["syrk"] == 1
    assert g.shape == (shape[0], shape[1], shape[1]) and g.is_contiguous()
    _assert_scaled(g, ref.mirror_lower(syrk_plain(x)))


def test_fp32_syrk_counts_one_launch(cuda_device):
    x = _heavy_rows(cuda_device, (2, 320, 960), seed=3)
    reset_launches()
    ops.syrk(x)
    assert LAUNCHES == {"syrk": 1, "symmul": 0, "gram_poly": 0}


@pytest.mark.parametrize("bm,bk", BLOCKS)
@pytest.mark.parametrize("shape", [(4, 240, 2560), (4, 240, 960),
                                   (4, 80, 960)])
def test_fp32_syrk_dion2_factor_shapes(cuda_device, shape, bm, bk):
    """Dion2's r×n factors (r = 240 and 80, not multiples of the 64-row
    block) within the scaled gate."""
    x = _heavy_rows(cuda_device, shape, seed=4)
    _assert_scaled(syrk_lower(x, block_m=bm, block_k=bk),
                   ref.mirror_lower(syrk_plain(x)))


@pytest.mark.parametrize("bm,bk", BLOCKS)
@pytest.mark.parametrize("m", [240, 80])
def test_fp32_symmul_dion2_factor_shapes(cuda_device, m, bm, bk):
    """symmul and gram_poly at Dion2's Gram dims within the scaled gate, on
    O(1) products (G = X Xᵀ near I)."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn(4, m, 2 * m, generator=gen, device=cuda_device)
    g = ref.mirror_lower(syrk_plain(x / (2 * m) ** 0.5))
    c = (8.287, -23.6, 17.3)
    p = ref.mirror_lower(symmul_plain(g, g, epilogue="gram_poly", coeffs=c))
    _assert_scaled(symmul_lower(p, g, block_m=bm, block_k=bk),
                   ref.mirror_lower(symmul_plain(p, g)))
    _assert_scaled(symmul_lower(g, g, epilogue="gram_poly", coeffs=c,
                                block_m=bm, block_k=bk), p)


# DeepSeek-V3's Gram groups at its published widths, at batch 2: SYRK
# (m, n) and the Gram dims of symmul / gram_poly (m up to 7168 = 112 tiles
# of 64; n up to 32768 k-slices of the kv_b_proj group).  Held against the
# exact (float64) product at 5e-6 · max|exact| (chip_smoke.EXACT_GATE):
# the plain fp32 version's own rounding exceeds 1e-5 past n ~ 16k.
MOE_SYRK = [(2048, 7168), (1536, 7168), (1536, 24576), (576, 7168),
            (512, 32768), (7168, 16384)]
MOE_GRAM = [2048, 1536, 576, 512, 7168]
EXACT_GATE = 5e-6


def _assert_exact(got, exact):
    err = float((got.double() - exact).abs().max())
    assert torch.isfinite(got).all()
    assert err <= EXACT_GATE * float(exact.abs().max()), err


@pytest.mark.parametrize("m,n", MOE_SYRK)
def test_fp32_syrk_moe_shapes(cuda_device, m, n):
    x = _heavy_rows(cuda_device, (2, m, n), seed=6)
    xd = x.double()
    _assert_exact(ops.syrk(x), xd @ xd.mT)


@pytest.mark.parametrize("m", MOE_GRAM)
def test_fp32_symmul_moe_shapes(cuda_device, m):
    """symmul and gram_poly at DeepSeek-V3's Gram dims against the exact
    products, on O(1) products (G = X Xᵀ near I)."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    x = torch.randn(2, m, 2 * m, generator=gen, device=cuda_device)
    g = ref.mirror_lower(syrk_plain(x / (2 * m) ** 0.5))
    c = (8.287, -23.6, 17.3)
    p = ref.mirror_lower(symmul_plain(g, g, epilogue="gram_poly", coeffs=c))
    gd, pd = g.double(), p.double()
    _assert_exact(ref.mirror_lower(ops.symmul(p, g)), pd @ gd)
    poly = c[2] * (gd @ gd) + c[1] * gd
    poly.diagonal(dim1=-2, dim2=-1).add_(c[0])
    _assert_exact(ref.mirror_lower(ops.gram_poly(g, *c)), poly)


# The hybrid and xLSTM families' new Gram dims (hymba's m = 100 / 132 at
# n = 3200; m = 1024 and 1600 of xlstm / seamless / hymba) against the exact
# products, and one training step of each family on the card.
FAMILY_SYRK = [(100, 3200), (132, 3200), (1024, 4096), (1600, 5504)]


@pytest.mark.parametrize("m,n", FAMILY_SYRK)
def test_fp32_syrk_family_shapes(cuda_device, m, n):
    x = _heavy_rows(cuda_device, (2, m, n), seed=8)
    xd = x.double()
    _assert_exact(ops.syrk(x), xd @ xd.mT)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_family_train_step_on_card(cuda_device, arch):
    """One Muon step of the reduced config on the card (kernels on): a
    finite loss and one SYRK, 5 gram_poly and 12 symmul per group."""
    import math

    from repro_torch import configs
    from repro_torch.core import api
    from repro_torch.core.gram_ns import GramNSConfig
    from repro_torch.core.muon import MuonConfig
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import model_fns
    from repro_torch.train.step import init_state, make_train_step
    cfg = configs.get(arch, reduced=True, remat=True)
    plan = api.dedicate_params(model_fns(cfg).init(cfg, device="meta"))
    opt = api.Muon(plan, config=MuonConfig(
        ns=GramNSConfig(use_kernels=True)), device="cuda")
    state = init_state(cfg, opt, seed=0, device="cuda")
    step = make_train_step(cfg, opt, device="cuda")
    batch = batch_for_step(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=2), 0, device="cuda")
    reset_launches()
    state = step(state, batch)
    g = len(plan.groups)
    assert LAUNCHES == {"syrk": g, "gram_poly": 5 * g, "symmul": 12 * g}
    assert math.isfinite(float(state.loss_ema))


def test_linear_scan_on_card_matches_float64_loop(cuda_device):
    from repro_torch.models.ssm import linear_scan
    gen = torch.Generator(cuda_device).manual_seed(9)
    a = torch.rand(2, 300, 8, 4, generator=gen, device=cuda_device) * 0.99
    b = torch.randn(2, 300, 8, 4, generator=gen, device=cuda_device)
    h, prev, want = linear_scan(a, b), torch.zeros_like(b[:, 0]).double(), []
    for t in range(a.shape[1]):
        prev = a[:, t].double() * prev + b[:, t].double()
        want.append(prev)
    torch.testing.assert_close(h.double(), torch.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b"])
def test_served_equals_replay_at_served_shape_on_card(cuda_device, arch):
    """The serving tier on the card, reduced width, bf16 cache: each
    request's served logits equal its replay at the served shape (prefill
    group size and row or the same chunks; decode at num_slots in its slot
    row) bit for bit; the twin of the CPU test in
    tests/test_torch_serve_parity.py and of chip_smoke's serve phase."""
    import numpy as np
    from test_torch_serve_parity import _workload, replay, serve_recorded

    from repro_torch import configs
    from repro_torch.models import model_fns
    cfg = configs.get(arch, reduced=True)
    params = model_fns(cfg).init(cfg, seed=0, device=cuda_device)
    queue, scfg = _workload(cfg, cache_dtype=torch.bfloat16)
    reqs = {r.rid: r for r in queue._pending}
    metrics, shapes = serve_recorded(cfg, params, queue, scfg)
    assert {s[0] for s in shapes.values()} == {"group", "chunk"}
    for rid, rec in metrics.requests.items():
        assert rec.generated == rec.requested
        got = replay(cfg, params, scfg, reqs[rid], shapes[rid],
                     rec.generated)
        assert [int(np.argmax(a)) for a in got] == rec.tokens, rid
        for i, (a, b) in enumerate(zip(got, rec.logits)):
            assert np.array_equal(a, b), (rid, i, shapes[rid])


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "llava-next-mistral-7b"])
def test_prefill_matches_forward_on_card(cuda_device, arch):
    """A prefill over a bf16 cache, S = 1200 (> 1024: the chunked
    attention), against the training forward's logits at the last
    position: within 2e-2 of the largest (chip_smoke's SERVE_GATE)."""
    from repro_torch import configs
    from repro_torch.models import model_fns
    from repro_torch.train import serve
    cfg = configs.get(arch, reduced=True)
    m = model_fns(cfg)
    params = m.init(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 1200), generator=gen,
                         device=cuda_device)
    kw = {}
    if cfg.frontend is not None:
        kw["patches"] = torch.randn(2, cfg.frontend_len, cfg.frontend_dim,
                                    generator=gen, device=cuda_device)
    with torch.inference_mode():
        got, cache = serve.prefill_fn(cfg, params, toks, 1280,
                                      cache_dtype=torch.bfloat16, **kw)
        want = m.forward(cfg, params, toks, **kw)[:, -1]
    assert cache["k"].dtype == torch.bfloat16
    err = float((got - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max()), err


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b"])
def test_paged_equals_contiguous_on_card(cuda_device, arch):
    """The paged tier on the card, reduced width, bf16 cache: the same
    queue through the contiguous and the paged tier (default pool,
    watermark 0, chunks of 8 through the block table for smollm, staged
    for hymba) gives the same admissions and every request's logits bit
    for bit; the twin of tests/test_torch_serve_paged.py's CPU test and of
    chip_smoke's serve_paged phase."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model_fns
    from repro_torch.serve import RequestQueue, Scheduler, ServeConfig
    cfg = configs.get(arch, reduced=True)
    params = model_fns(cfg).init(cfg, seed=0, device=cuda_device)
    runs = {}
    for kv in ("contiguous", "paged"):
        scfg = ServeConfig(num_slots=3, max_len=32, prefill_pack=2,
                           chunk_len=8, cache_dtype=torch.bfloat16,
                           record_logits=True, kv=kv, block_size=8,
                           watermark=0.0)
        sched = Scheduler(cfg, params, scfg)
        runs[kv] = sched.run(RequestQueue.synthetic(
            7, cfg.vocab, prompt_lens=(4, 8, 12), new_tokens=(2, 6),
            seed=3))
    assert sched._use_tables and sched.slots.cache["k"].shape[1] == 13
    cont, paged = runs["contiguous"], runs["paged"]
    assert list(paged.requests) == list(cont.requests)
    assert paged.active_per_step == cont.active_per_step
    for rid, rec in paged.requests.items():
        want = cont.requests[rid]
        assert rec.generated == rec.requested and rec.tokens == want.tokens
        for i, (a, b) in enumerate(zip(rec.logits, want.logits)):
            assert np.array_equal(a, b), (rid, i)
