"""The port's op walker and roofline (``repro_torch.launch.op_walker`` /
``roofline``): twins of ``tests/test_roofline.py`` (the count scales with
layers, the analytic forward band, one matmul's FLOPs and bytes exactly, a
loop's products each counted, collective bytes per kind), the walker's
FLOPs equal to the reference ``hlo_walker``'s on the same reduced smollm
forward, ``Roofline.finalize`` against hand arithmetic with the H100
constants, and the storage tracker's peak on a scripted sequence."""

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as troofline
from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS
from repro_torch.launch.op_walker import ALLOC_ROUND, OpWalker
from repro_torch.models import model_fns

REDUCED = dict(d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
               remat=False)
TOKENS = (2, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk_flops(nl, fake=False):
    """The walked forward of ``tests/test_roofline.py``'s reduced smollm."""
    cfg = tconfigs.get("smollm-360m", reduced=True, n_layers=nl, **REDUCED)
    m = model_fns(cfg)
    params = m.init(cfg, 0, device="cpu")
    tok = torch.zeros(TOKENS, dtype=torch.int32)
    with FakeTensorMode(allow_non_fake_inputs=True) if fake else \
            torch.no_grad():
        with OpWalker() as w:
            m.forward(cfg, params, tok)
    return w.costs, cfg


def test_walker_scales_with_layers():
    c2, _ = _walk_flops(2)
    c8, _ = _walk_flops(8)
    assert 3.0 < c8.flops / c2.flops < 4.5   # ~4x more layer flops + head


def test_walker_matches_analytic_forward_flops():
    costs, cfg = _walk_flops(8)
    analytic = 2.0 * cfg.param_count() * TOKENS[0] * TOKENS[1]
    assert 0.5 * analytic < costs.flops < 3.0 * analytic


def test_walker_finds_matmul_flops_and_bytes_exactly():
    a, b = torch.zeros((128, 256)), torch.zeros((256, 64))
    with OpWalker() as w:
        a @ b
    assert w.costs.flops == 2 * 128 * 256 * 64
    assert w.costs.flops_by_dtype == {"float32": 2 * 128 * 256 * 64}
    assert w.costs.bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_walker_counts_every_loop_trip():
    """No trip count to infer: a Python loop of 7 products is 7 products."""
    x = torch.zeros((64, 64))
    with OpWalker() as w:
        for _ in range(7):
            x = x @ x
    assert w.costs.flops == 7 * 2 * 64 ** 3


def test_collective_bytes_per_kind():
    """One all-gather and one all-reduce of an (8, 4) fp32 tensor on a
    "fake" world of two ranks, torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        def fn():
            p = torch.zeros((8, 4))
            out = p.new_empty((16, 4))
            dist.all_gather_into_tensor(out, p)
            dist.all_reduce(p)
        out = troofline.collective_bytes(fn)
    finally:
        dist.destroy_process_group()
    assert out["all-gather"] == 8 * 4 * 4
    assert out["all-reduce"] == 8 * 4 * 4
    assert out["total"] == 2 * 8 * 4 * 4


@pytest.mark.parametrize("nl", [2, 8])
def test_walker_flops_equal_hlo_walker(nl):
    """The port's forward, real and fake, against the reference's compiled
    forward walked by ``hlo_walker`` on the same config: equal exactly
    (285,212,672 at 8 layers)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro.launch import hlo_walker
    from repro.models import model_fns as rmodel_fns
    rcfg = rconfigs.get("smollm-360m", reduced=True, n_layers=nl, **REDUCED)
    rm = rmodel_fns(rcfg)
    params = rm.init(rcfg, jax.random.PRNGKey(0))
    tok = jnp.zeros(TOKENS, jnp.int32)
    c = jax.jit(lambda p, t: rm.forward(rcfg, p, t)).lower(params,
                                                            tok).compile()
    want = hlo_walker.analyze_text(c.as_text()).flops
    got, _ = _walk_flops(nl)
    fake, _ = _walk_flops(nl, fake=True)
    assert got.flops == fake.flops == want
    if nl == 8:
        assert want == 285_212_672


def test_roofline_finalize_hand_arithmetic():
    """compute = Σ_dtype flops / peak[dtype], memory = bytes / HBM_BW,
    collective = bytes / NET_BW, with the H100 constants."""
    by_dtype = {"float32": 6.7e12, "bfloat16": 9.89e12, "tf32": 4.95e12}
    r = troofline.Roofline(flops=sum(by_dtype.values()), hbm_bytes=6.7e12,
                           coll_bytes=1e9, model_flops=1e12,
                           detail={"flops_by_dtype": by_dtype}).finalize()
    assert PEAK_FLOPS["float32"] == 67e12 and PEAK_FLOPS["bfloat16"] == 989e12
    assert PEAK_FLOPS["tf32"] == 495e12 and HBM_BW == 3.35e12
    assert NET_BW == 50e9
    assert r.compute_s == pytest.approx(0.1 + 0.01 + 0.01)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.02)
    assert r.dominant == "memory"
    assert r.useful_ratio == pytest.approx(1e12 / r.flops)


def test_analyze_kernel_adjustment():
    """The kernel-adjusted term moves the NS products' excess out of the
    NS dtype's FLOPs (the reference's adjustment)."""
    from repro_torch.launch.op_walker import Costs
    costs = Costs(flops=3e12, bytes=1.0,
                  flops_by_dtype={"float32": 2e12, "bfloat16": 1e12})
    r = troofline.analyze(costs, num_devices=4, ns_flops_raw=1e12,
                          ns_flops_kernel=0.6e12, ns_dtype="bfloat16")
    assert r.compute_s == pytest.approx(2e12 / 67e12 + 1e12 / 989e12)
    assert r.kernel_adjusted_compute_s == pytest.approx(
        2e12 / 67e12 + 0.6e12 / 989e12)
    assert r.detail["num_devices"] == 4


@pytest.mark.parametrize("fake", [False, True])
def test_tracker_peak_scripted(fake):
    """Allocate / free in a known order: the peak and the live bytes
    exactly, each storage rounded up to the allocator's 512-byte blocks;
    views share their base's storage; arguments count from the start."""
    r = ALLOC_ROUND
    arg = torch.zeros(100)                               # 400 B -> 512
    with FakeTensorMode(allow_non_fake_inputs=True) if fake else \
            torch.no_grad():
        w = OpWalker()
        w.track_arguments({"a": arg, "b": [arg]})
        with w:
            x = torch.empty(1000)                        # 4000 -> 4096
            y = torch.empty(2000)                        # 8000 -> 8192
            v = y[:10].view(2, 5)                        # no new storage
            del x
            z = torch.empty(3, dtype=torch.float64)      # 24 -> 512
            del y
            u = torch.empty(1024)                        # 4096
        peak = w.peak
        mem = w.memory({"v": v, "z": z, "u": u, "arg": arg})
    # y's storage outlives ``del y`` through the view v
    want = max(r + 4096 + 8192, r + 8192 + r, r + 8192 + r + 4096)
    assert peak == want
    assert mem["total_bytes"] == want
    assert mem["argument_size_in_bytes"] == r
    assert mem["output_size_in_bytes"] == 8192 + r + 4096 + r
    assert mem["alias_size_in_bytes"] == r
    assert mem["argument_size_in_bytes"] + mem["output_size_in_bytes"] + \
        mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"] == want
    del v, z, u
    assert w.live == r


def test_tracker_sees_resize():
    with OpWalker() as w:
        t = torch.empty(10)
        t.resize_(1000)
    assert w.peak == w.live == 4096
