"""``chip_smoke.py``'s four-card step gate (``step_gate``) on synthetic
gradients and updates, on the CPU.

Four ranks' gradients are averaged in two summation orders, as the ranks'
collective and the one-card run over four microbatches add them; the
updates come from stand-ins with the properties the gate relies on: a
scale-invariant map for the Muon leaves (Newton-Schulz normalizes its
input) and AdamW's first step, −lr · g / (|g| + eps), for the rest.  The
reordered sum, a rounding-size difference, passes; the two planted faults
of the card run, the sum where the mean belongs and one rank's gradient
dropped, miss the gate by at least 10×.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

WORLD = 4
LR = 0.02


@pytest.fixture(scope="module")
def cs():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rank_grads(seed=0):
    gen = torch.Generator().manual_seed(seed)
    shapes = {"w": (8, 64, 32), "embed": (100, 32), "norm": (64,)}
    return [{p: torch.randn(s, generator=gen) ** 3 * 1e-3
             for p, s in shapes.items()} for _ in range(WORLD)]


def _update(grads: dict) -> dict:
    out = {}
    for p, g in grads.items():
        if p == "w":
            norm = torch.linalg.vector_norm(g, dim=(-2, -1), keepdim=True)
            out[p] = -LR * g / (norm + 1e-7) * 8.0
        else:
            out[p] = -LR * g / (g.abs() + 1e-8)
    return out


def _sums(ranks):
    """(one-card mean: ((0 + g0) + g1 + ...) · 1/world, as the accumulating
    step adds its microbatches; the ranks' mean in another order, / world;
    Σ_r |g_r|)."""
    ref, mesh, abs_sum = {}, {}, {}
    for p in ranks[0]:
        acc = torch.zeros_like(ranks[0][p])
        for g in ranks:
            acc += g[p]
        ref[p] = acc * (1.0 / WORLD)
        mesh[p] = ((ranks[3][p] + ranks[2][p]) + (ranks[1][p] + ranks[0][p])
                   ) / WORLD
        abs_sum[p] = sum(g[p].abs() for g in ranks)
    return ref, mesh, abs_sum


def _gate(cs, mesh_g, ref_g, abs_sum):
    gen = torch.Generator().manual_seed(5)
    u_ref = _update(ref_g)
    u_ulp = _update({p: cs.one_ulp_up(torch, g, gen)
                     for p, g in ref_g.items()})
    spread = float((u_ulp["w"] - u_ref["w"]).abs().max())
    assert spread > 0
    return cs.step_gate(torch, mesh_g, ref_g, abs_sum, _update(mesh_g),
                        u_ref, spread, {"w"}, WORLD)


def test_reordered_sum_passes(cs):
    ref, mesh, abs_sum = _sums(_rank_grads())
    assert any(not torch.equal(ref[p], mesh[p]) for p in ref)
    out = _gate(cs, mesh, ref, abs_sum)
    assert out["factor"] <= 1, out["ratios"]
    assert set(out["per_leaf"]) == set(ref)


@pytest.mark.parametrize("fault", ["sum_for_mean", "rank0_dropped"])
def test_planted_faults_miss_by_ten(cs, fault):
    ranks = _rank_grads()
    ref, mesh, abs_sum = _sums(ranks)
    if fault == "sum_for_mean":
        bad = {p: g * WORLD for p, g in mesh.items()}
    else:
        bad = {p: (g * WORLD - ranks[0][p]) / WORLD for p, g in mesh.items()}
    out = _gate(cs, bad, ref, abs_sum)
    assert out["factor"] >= cs.STEP_FAULT, out["ratios"]


def test_adamw_entries_may_flip_only_where_the_gradient_explains(cs):
    """An AdamW update entry that flips sign with no gradient difference
    behind it is more than its rho explains."""
    ref, _, abs_sum = _sums(_rank_grads())
    u_ref = _update(ref)
    u_bad = dict(u_ref, embed=u_ref["embed"].clone())
    u_bad["embed"][0, 0] *= -1
    out = cs.step_gate(torch, ref, ref, abs_sum, u_bad, u_ref, 1e-9, {"w"},
                       WORLD)
    assert out["ratios"]["adamw"] > 1
    assert out["ratios"]["grad"] == out["ratios"]["muon"] == 0
