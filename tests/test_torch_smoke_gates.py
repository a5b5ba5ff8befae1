"""``chip_smoke.py``'s bf16 kernel gate (``check_parts``), the sampled
captures of its four-card nemotron gate (``sample_grid``,
``sampled_whole``) and its serving-under-a-mesh gate (``serve_gate``), on
the CPU.  Besides tile faults, the gate must catch
the two faults a bf16 wgmma kernel can make silently: B's MN-major slices
read transposed (A·Bᵀ for A·B) and a contraction's last slice left out.

The bf16 gate holds each kernel's output to the plain version's fp32
product of the same bf16 operands, the off-diagonal entries and the
diagonal each at its own scale.  A Gram matrix's off-diagonal entries are
O(1/sqrt(n)) against its O(1) diagonal, so a gate at the diagonal's scale
passes a kernel that computes only the diagonal tiles, or maps a tile to
the wrong place, once n is long; this one does not.  Here the "kernel" is
the plain version itself (a CPU tensor), rounded to bf16 as the kernel
rounds its output, and the faults are planted in its output.
"""

import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.core.coefficients import get_coefficients
from repro_torch.kernels import ref
from repro_torch.kernels.gram_syrk import syrk_plain
from repro_torch.kernels.symmul import symmul_plain

TILE = 128


@pytest.fixture(scope="module")
def cs():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(cs, n=4096):
    gen = torch.Generator().manual_seed(0)
    coeffs = get_coefficients("polar_express", 5)[0]
    return {case[0]: case for case in cs.bf16_gram_cases(
        torch, gen, [(1, 2 * TILE, n)], [(1, 3 * TILE)], coeffs)}


def _diagonal_tiles_only(out):
    keep = torch.zeros(out.shape[-2:], dtype=torch.bool)
    for i in range(0, out.shape[-1], TILE):
        keep[i:i + TILE, i:i + TILE] = True
    return out.masked_fill(~keep, 0)


def _tile_misplaced(out):
    bad = out.clone()
    bad[..., TILE:2 * TILE, 0:TILE] = out[..., TILE:2 * TILE, TILE:2 * TILE]
    return bad


@pytest.mark.parametrize("name", ["gram_syrk", "symmul_plain",
                                  "symmul_gram_poly"])
def test_bf16_gate_passes_the_kernel_and_catches_tile_faults(cs, name):
    _, _, _, tol, kern, _, _, term, _, exact = _cases(cs)[name]
    got, want = kern(), ref.mirror_lower(exact())
    row = cs.check_parts(name, got, want, term(), tol["parts"])
    assert row["max_err_offdiag"] <= row["allowance_offdiag"]
    for fault in (_diagonal_tiles_only, _tile_misplaced):
        with pytest.raises(AssertionError, match="off the diagonal"):
            cs.check_parts(name, fault(got), want, term(), tol["parts"])


def test_bf16_gate_sees_what_the_old_one_missed(cs):
    """At nemotron-4-340b's contraction, 73728, the Gram matrix's
    off-diagonal entries are below 2e-2: rtol = atol = 2e-2 passed a SYRK
    that left out every tile off the diagonal."""
    _, _, _, tol, kern, plain, _, term, _, exact = _cases(
        cs, 73728)["gram_syrk"]
    bad = _diagonal_tiles_only(kern())
    assert torch.allclose(bad.float(), ref.mirror_lower(plain()).float(),
                          rtol=2e-2, atol=2e-2)
    with pytest.raises(AssertionError, match="off the diagonal"):
        cs.check_parts("gram_syrk", bad, ref.mirror_lower(exact()), term(),
                       tol["parts"])


def test_bf16_gate_tells_a_b_from_a_b_transposed(cs):
    """On the kernels phase's non-symmetric case (``nonsymmetric_case``,
    B not symmetric) the gate passes the plain product and rejects A·Bᵀ:
    what a kernel that read B's MN-major slices transposed would return.
    The Gram products' symmetric P and G cannot tell the two apart."""
    gen = torch.Generator().manual_seed(0)
    name, _, _, tol, kern, plain, _, term, _, exact = cs.nonsymmetric_case(
        torch, gen, 2, 328)
    want = ref.mirror_lower(exact())
    row = cs.check_parts(name, kern(), want, term(), tol["parts"])
    assert row["max_err_offdiag"] <= row["allowance_offdiag"]
    a, b = (inspect.getclosurevars(plain).nonlocals[k] for k in ("a", "bb"))
    assert not torch.equal(b, b.mT)
    transposed = ref.mirror_lower(symmul_plain(a, b.mT))
    with pytest.raises(AssertionError, match="off the diagonal"):
        cs.check_parts(name, transposed, want, term(), tol["parts"])


def test_bf16_gate_sees_a_missing_k_tail(cs):
    """A SYRK that leaves out the last 64-wide slice of nemotron-4-340b's
    73728-long contraction (the K-tail a TMA box can miss) fails the gate
    off the diagonal, at a small m."""
    _, _, _, tol, kern, _, _, term, _, exact = _cases(cs, 73728)["gram_syrk"]
    x = kern.__defaults__[0]
    assert x.shape[-1] == 73728
    short = ref.mirror_lower(syrk_plain(x[..., :-64]))
    want = ref.mirror_lower(exact())
    cs.check_parts("gram_syrk", kern(), want, term(), tol["parts"])
    with pytest.raises(AssertionError, match="off the diagonal"):
        cs.check_parts("gram_syrk", short, want, term(), tol["parts"])


def test_sample_grid_takes_both_ends_and_a_spread(cs):
    assert cs.sample_grid(30, 10) == list(range(30))
    grid = cs.sample_grid(18432, 256)
    assert grid == sorted(set(grid))
    assert grid[:256] == list(range(256))
    assert grid[-256:] == list(range(18432 - 256, 18432))
    middle = [i for i in grid if 256 <= i < 18432 - 256]
    assert len(middle) >= 256 - 2 * 256 * 256 // 18432 - 2
    assert max(b - a for a, b in zip(grid, grid[1:])) <= 18432 // 255 + 1


class _FakeDist:
    """``all_gather_object`` over ranks whose objects are given at once."""

    def __init__(self, every):
        self.every = every

    def all_gather_object(self, out, obj):
        out[:] = self.every

    def get_rank(self):
        return 0


def _capture(cs, full, rows, cols, k):
    """What ``sampled_part`` returns for the part ``full[:, rows, cols]``."""
    indices = [cs.sample_grid(full.shape[0], k)]
    t = full[:, rows.start:rows.stop, cols.start:cols.stop]
    t = t.index_select(0, torch.tensor(indices[0]))
    for d, span in ((1, rows), (2, cols)):
        here = [i for i in cs.sample_grid(full.shape[d], k) if i in span]
        indices.append(here)
        t = t.index_select(d, torch.tensor([i - span.start for i in here]))
    return tuple(full.shape), indices, t


def test_sampled_whole_puts_every_rank_s_part_in_place(cs):
    k = 40
    full = torch.randn(2, 300, 500, generator=torch.Generator().manual_seed(1))
    parts = [(range(0, 150), range(0, 250)), (range(0, 150), range(250, 500)),
             (range(150, 300), range(0, 250)),
             (range(150, 300), range(250, 500))]
    every = [{"w": _capture(cs, full, r, c, k)} for r, c in parts]
    got = cs.sampled_whole(torch, _FakeDist(every), 4, every[0], k)["w"]
    grids = [torch.tensor(cs.sample_grid(n, k)) for n in full.shape]
    want = full[grids[0]][:, grids[1]][:, :, grids[2]]
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="held by no rank"):
        cs.sampled_whole(torch, _FakeDist(every[:3]), 3, every[0], k)


def _serve_recs(seed, n_tokens=6, vocab=50, scale=1.0):
    """{rid: (greedy tokens, logits)} of two requests, drawn from ``seed``:
    well separated top-2 margins (a top logit 5 above the rest)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for rid in range(2):
        logits = [rng.standard_normal(vocab).astype(np.float32) * scale
                  for _ in range(n_tokens)]
        for i, lg in enumerate(logits):
            lg[(rid + i) % vocab] += 5.0
        out[rid] = ([int(lg.argmax()) for lg in logits], logits)
    return out


def _moved(recs, eps, seed):
    """``recs`` with every logit moved by up to ``eps``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {r: (toks, [lg + eps * rng.uniform(-1, 1, lg.shape).astype(
        np.float32) for lg in logits]) for r, (toks, logits) in recs.items()}


@pytest.mark.parametrize("mesh_eps,passes", [(1e-5, True), (1e-2, False)])
def test_serve_gate_holds_logits_to_the_one_ulp_spread(cs, mesh_eps, passes):
    """``serve_gate``: a mesh run within 10x the spread run's distance
    from one card passes; one 1000x farther fails."""
    one = _serve_recs(0)
    gate = cs.serve_gate(_moved(one, mesh_eps, 1), one, _moved(one, 1e-5, 2))
    assert gate["steps"] == gate["tokens"] == 12
    assert (gate["factor"] <= 1.0) == passes
    assert not gate["failures"]


def test_serve_gate_tells_a_near_tie_from_a_wrong_token(cs):
    """A token that differs where one card's top-2 margin is wide fails;
    where the margin is under the bound it ends that request's
    comparison without failing."""
    import numpy as np
    one = _serve_recs(0)
    spread = _moved(one, 1e-5, 2)
    toks, logits = one[0]
    wrong = dict(one)
    wrong[0] = ([toks[0], (toks[1] + 1) % 50] + toks[2:], logits)
    gate = cs.serve_gate(wrong, one, spread)
    assert gate["failures"] and "step 1" in gate["failures"][0]
    tied = [lg.copy() for lg in logits]
    tied[1][(toks[1] + 1) % 50] = tied[1][toks[1]] - 1e-6
    one_tied = dict(one)
    one_tied[0] = (toks, tied)
    mesh = dict(one_tied)
    mesh[0] = ([toks[0], (toks[1] + 1) % 50] + toks[2:], tied)
    gate = cs.serve_gate(mesh, one_tied, _moved(one_tied, 1e-5, 2))
    assert not gate["failures"]
    assert [(t["rid"], t["step"]) for t in gate["near_ties"]] == [(0, 1)]
    assert gate["steps"] == 2 + 6
    assert np.isfinite(gate["factor"])
