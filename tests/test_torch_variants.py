"""The port's optimizer variants (NorMuon, MuonBP, Dion2, AdaMuon, AdamW):
the twin of ``tests/test_variants.py`` (all but the checkpoint-manager
round trip, which waits for ROADMAP item 8), and each variant against the
reference ``repro.core.api.Muon`` on the same numpy parameters and
gradients over 5 steps.

Tolerance rtol 5e-4 / atol 5e-5 on updates, momentum and every variant-state
buffer, as ``tests/test_torch_muon.py``'s owner parity (the NS iterations of
the two frameworks round differently).  Dion2's bases are compared as
Q Qᵀ: the QR's column signs are free.  Two quantities are ill-conditioned,
so the tolerance cannot hold everywhere (the reference misses it against
itself when its gradients move by one ulp), and each miss is bounded by
what its cause explains:

* AdaMuon divides every entry o of the orthogonalized update by the RMS of
  its own history, which turns o's absolute agreement into relative
  agreement: at the first step each entry becomes about o / |o|, so an
  entry at rounding level flips sign, and later an entry whose o agrees
  within the tolerance but not relatively within rtol carries that relative
  difference into the output.  Such entries are counted; each must agree
  within twice its o history's relative difference, at most a sign flip.
* MuonBP's cached polar accumulator Q is a polynomial of G₀ = X₀X₀ᵀ near
  G₀^(-1/2), with entries in the hundreds along a square matrix's smallest
  singular directions (σ_min/σ_max ≈ 1e-3 here): one ulp on the gradients
  moves the reference's own Q by more than the tolerance.  Q is compared as
  the Gram NS output it caches, Q·X₀ (X₀ the normalized momentum of its
  refresh step, in float64; it has full row rank, so Q·X₀ determines Q), at
  ``tests/test_torch_gram_ns.py``'s port-vs-reference tolerance for Gram NS
  outputs, 1e-4.  A reuse step applies the stale Q to new momentum, whose
  components along those directions are not small, so its update inherits
  Q's conditioning; each reuse step therefore starts from the reference's
  cached Q (the port's was held just before), and its update is held at the
  tolerance above, as every refresh step's is.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import orthogonalize as jortho  # noqa: E402
from repro.core.gram_ns import GramNSConfig as JGramNSConfig  # noqa: E402
from repro.core.muon import MuonConfig as JMuonConfig  # noqa: E402
from repro_torch.core import api, tree  # noqa: E402
from repro_torch.core import orthogonalize as tortho  # noqa: E402
from repro_torch.core.gram_ns import GramNSConfig, gram_newton_schulz  # noqa: E402
from repro_torch.core.muon import MuonConfig  # noqa: E402
from repro_torch.core.owner_comms import OwnerLayout, group_key_str  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

RTOL, ATOL = 5e-4, 5e-5
TOL = dict(rtol=RTOL, atol=ATOL)
GRAM_NS_TOL = 1e-4           # a Gram NS output, port vs reference
LR, MOMENTUM = 0.1, 0.9
STATEFUL = ["normuon", "muonbp", "dion2", "adamuon"]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "CACHE_PATH",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    yield
    autotune.clear_memory_cache()


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def n(*s):
        return (rng.standard_normal(s) * 0.02).astype(np.float32)
    return {"blocks": {"wq": n(3, 32, 32), "up": n(3, 32, 128),
                       "down": n(3, 128, 32),
                       "norm_scale": np.ones((3, 32), np.float32)},
            "embed_table": n(100, 32)}


def _grads(seed=1):
    rng = np.random.default_rng(100 + seed)
    return tree.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        _tree())


def _torch(t):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _add(params, updates):
    return tree.tree_map(lambda p, u: p + u, params, updates)


def _mk(variant, **kw):
    params = _torch(_tree())
    plan = api.dedicate_params(params, num_owners=4, strategy="greedy")
    kw.setdefault("ns", GramNSConfig(num_steps=5))
    cfg = MuonConfig(variant=variant, learning_rate=LR, momentum=MOMENTUM,
                     **kw)
    return params, plan, api.Muon(plan, config=cfg, device="cpu")


def _run(opt, params, n=3):
    state = opt.init(params)
    for t in range(n):
        u, state = opt.update(_torch(_grads(seed=t)), state, params)
        params = _add(params, u)
    return params, state


def _leaves(t):
    return [v for _, v in tree.flatten(t)]


def _finite(t):
    return all(bool(torch.isfinite(v).all()) for v in _leaves(t))


# ------------------------------------------------------------------ registry

def test_registry_contents_and_errors():
    assert set(api.VARIANTS) >= {"muon", "normuon", "muonbp", "dion2",
                                 "adamuon", "adamw"}
    assert sorted(api.VARIANTS) == sorted(japi.VARIANTS)
    for name, spec in japi.VARIANTS.items():
        got = api.VARIANTS[name]
        assert (got.orthogonalizer, got.elementwise, got.stateful) == \
            (spec.orthogonalizer, spec.elementwise, spec.stateful), name
    with pytest.raises(ValueError, match="unknown variant"):
        api.get_variant("dion3")
    with pytest.raises(ValueError, match="already registered"):
        api.register_variant(api.VARIANTS["muon"])
    _, plan, _ = _mk("muon")
    with pytest.raises(ValueError, match="unknown variant"):
        api.Muon(plan, config=MuonConfig(variant="nope"), device="cpu")


def test_known_orthogonalizers_single_source_of_truth():
    """The port accepts exactly the reference's backend names; each
    constructs, and the unknown-name error lists them all."""
    cfg = MuonConfig()
    names = tortho.known_orthogonalizers()
    assert names == jortho.known_orthogonalizers()
    for name in names:
        assert isinstance(tortho.make_orthogonalizer(name, cfg),
                          tortho.Orthogonalizer)
    with pytest.raises(ValueError) as ei:
        tortho.make_orthogonalizer("definitely_not_a_backend", cfg)
    for name in names:
        assert name in str(ei.value)


@pytest.mark.parametrize("bucket_fusion", [False, True])
def test_composition_rules_match_reference(bucket_fusion):
    """Each name resolves to the reference's backend class (composed names
    wrap the plain or bucket-fused Gram path as configured)."""
    tcfg = MuonConfig(ns=GramNSConfig(bucket_fusion=bucket_fusion))
    jcfg = JMuonConfig(ns=JGramNSConfig(bucket_fusion=bucket_fusion))
    for name in tortho.known_orthogonalizers():
        t = tortho.make_orthogonalizer(name, tcfg)
        j = jortho.make_orthogonalizer(name, jcfg)
        assert type(t).__name__ == type(j).__name__, name
        assert t.name == j.name
        if hasattr(j, "inner"):
            assert type(t.inner).__name__ == type(j.inner).__name__


def test_gather_mode_rejects_variant_backends():
    """Refused as in the reference (the port refuses at construction
    already, where it validates the whole config)."""
    params, plan, _ = _mk("muon")
    with pytest.raises(ValueError, match="owner pipeline"):
        opt = api.Muon(plan, config=MuonConfig(variant="normuon",
                                               mode="gather"), device="cpu")
        opt.init(params)


def test_adamw_variant_equals_adamw_mode():
    params, _, opt_v = _mk("adamw")
    _, _, opt_m = _mk("muon", mode="adamw")
    g = _torch(_grads())
    uv, _ = opt_v.update(g, opt_v.init(params), params)
    um, _ = opt_m.update(g, opt_m.init(params), params)
    for a, b in zip(_leaves(uv), _leaves(um), strict=True):
        assert torch.equal(a, b)


def test_unported_schedule_still_raises_for_variants():
    """The bucketed schedule is ported for every stateful variant
    (tests/test_torch_pipeline.py holds it bitwise to fused); only the
    gather baseline refuses it."""
    _, plan, _ = _mk("muon")
    for variant in STATEFUL:
        opt = api.Muon(plan, device="cpu", variant=variant,
                       pipeline="bucketed")
        assert opt.effective_mode == "owner"
    with pytest.raises(ValueError, match="gather baseline"):
        api.Muon(plan, device="cpu", mode="gather", pipeline="bucketed")


# ------------------------------------------------------------------- muonbp

def test_muonbp_period_one_matches_muon_exactly():
    """Every step refreshes -> bit-identical to the plain Gram path."""
    params_m, _, opt_m = _mk("muon")
    params_b, _, opt_b = _mk("muonbp", muonbp_period=1)
    sm, sb = opt_m.init(params_m), opt_b.init(params_b)
    for t in range(3):
        g = _torch(_grads(seed=t))
        um, sm = opt_m.update(g, sm, params_m)
        ub, sb = opt_b.update(g, sb, params_b)
        for a, b in zip(_leaves(um), _leaves(ub), strict=True):
            assert torch.equal(a, b)
        params_m, params_b = _add(params_m, um), _add(params_b, ub)


def test_muonbp_caches_and_reuses_polar_map():
    params, _, opt = _mk("muonbp", muonbp_period=3)
    state = opt.init(params)
    g = _torch(_grads())
    _, s1 = opt.update(g, state, params)          # refresh: Q cached
    q1 = {k: v.clone() for k, v in s1.variant_state["q"].items()}
    assert all(float(q.abs().max()) > 0 for q in q1.values())
    _, s2 = opt.update(g, s1, params)             # reuse: Q carried
    _, s3 = opt.update(g, s2, params)
    for k in q1:
        assert torch.equal(q1[k], s3.variant_state["q"][k])
    _, s4 = opt.update(g, s3, params)             # refresh: Q moves
    assert any(float((q1[k] - s4.variant_state["q"][k]).abs().max()) > 1e-7
               for k in q1)


def test_muonbp_reuse_step_is_finite_and_reasonable():
    params, _, opt = _mk("muonbp", muonbp_period=2)
    params_m, _, opt_m = _mk("muon")
    sb, sm = opt.init(params), opt_m.init(params_m)
    g = _torch(_grads())
    _, sb = opt.update(g, sb, params)            # refresh
    ub, _ = opt.update(g, sb, params)            # reuse (stale Q)
    _, sm = opt_m.update(g, sm, params_m)
    um, _ = opt_m.update(g, sm, params_m)        # exact
    for a, b in zip(_leaves(ub), _leaves(um), strict=True):
        assert bool(torch.isfinite(a).all())
        assert float(torch.linalg.norm(a)) < \
            10 * float(torch.linalg.norm(b)) + 1e-6


# ------------------------------------------------------------------ normuon

def test_normuon_state_shapes_and_finiteness():
    params, plan, opt = _mk("normuon")
    new_params, state = _run(opt, params)
    v = state.variant_state["v"]
    for key, grp in plan.groups.items():
        skey = group_key_str(key)
        assert v[skey].shape == (grp.packed_size, grp.key[0])
        assert bool(torch.isfinite(v[skey]).all())
        if grp.packed_size > grp.count:           # pad rows stay zero
            assert not v[skey][grp.count:].any()
    assert _finite(new_params)


@pytest.mark.parametrize("variant", ["normuon", "adamuon"])
def test_adaptive_variants_differ_from_muon_but_preserve_update_norm(
        variant):
    params_n, _, opt_n = _mk(variant)
    params_m, _, opt_m = _mk("muon")
    g = _torch(_grads())
    un, _ = opt_n.update(g, opt_n.init(params_n), params_n)
    um, _ = opt_m.update(g, opt_m.init(params_m), params_m)
    wq_n, wq_m = un["blocks"]["wq"], um["blocks"]["wq"]
    assert float((wq_n - wq_m).abs().max()) > 1e-6    # it does something
    np.testing.assert_allclose(float(torch.linalg.norm(wq_n)),
                               float(torch.linalg.norm(wq_m)), rtol=0.05)


@pytest.mark.parametrize("variant", STATEFUL)
def test_variants_compose_with_bucket_fusion(variant):
    params, _, opt = _mk(variant, ns=GramNSConfig(num_steps=5,
                                                  bucket_fusion=True))
    new_params, _ = _run(opt, params, n=2)
    assert _finite(new_params)


# -------------------------------------------------------------------- dion2

def test_dion2_state_shapes_and_rank():
    params, plan, opt = _mk("dion2", dion2_rank_frac=0.25)
    new_params, state = _run(opt, params, n=2)
    q = state.variant_state["q"]
    for key, grp in plan.groups.items():
        m = grp.key[0]
        r = tortho.dion2_rank(m, opt.config)
        assert 1 <= r <= m
        assert q[group_key_str(key)].shape == (grp.packed_size, m, r)
        assert bool(torch.isfinite(q[group_key_str(key)]).all())
    assert _finite(new_params)


def test_dion2_cold_start_is_leading_row_submatrix():
    """A cold basis is the leading-r row selector: the first update is
    √(m/r)·NS(M[:r]) in rows 0..r; from the next step the basis is warm."""
    m, n, r = 16, 48, 4
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4, m, n)) * 0.02).astype(np.float32))
    plan = api.dedicate_params({"w": x}, num_owners=1, strategy="greedy")
    cfg = MuonConfig(variant="dion2", dion2_rank_frac=r / m,
                     ns=GramNSConfig(num_steps=5))
    layout = OwnerLayout(plan)
    ortho = tortho.Dion2GramNS()
    state = ortho.init_state(layout, cfg)
    skey = group_key_str("w")
    assert not state["q"][skey].any()
    out, state1 = ortho({skey: x}, step=0, state=state, layout=layout,
                        cfg=cfg)
    u = out[skey]
    assert float(u[:, r:, :].abs().max()) <= 1e-6
    want = gram_newton_schulz(x[:, :r, :], cfg=cfg.ns, assume_short_fat=True)
    torch.testing.assert_close(u[:, :r, :], want * np.sqrt(m / r),
                               rtol=1e-4, atol=1e-5)
    out2, state2 = ortho({skey: x}, step=1, state=state1, layout=layout,
                         cfg=cfg)
    assert float(out2[skey][:, r:, :].abs().max()) > 1e-5
    assert float((state2["q"][skey] - state1["q"][skey]).abs().max()) > 1e-6


def test_dion2_full_rank_approximates_muon():
    params_d, _, opt_d = _mk("dion2", dion2_rank_frac=1.0)
    params_m, _, opt_m = _mk("muon")
    g = _torch(_grads())
    ud, _ = opt_d.update(g, opt_d.init(params_d), params_d)
    um, _ = opt_m.update(g, opt_m.init(params_m), params_m)
    for a, b in zip(_leaves(ud), _leaves(um), strict=True):
        assert float(torch.linalg.norm(a - b)) < \
            1e-2 * float(torch.linalg.norm(b)) + 1e-8


def test_dion2_rank_frac_validation():
    """An invalid rank fraction is refused as in the reference (the port
    refuses at construction already: it pre-warms the factor's kernel
    shapes there)."""
    with pytest.raises(ValueError, match="dion2_rank_frac"):
        params, _, opt = _mk("dion2", dion2_rank_frac=0.0)
        opt.init(params)
    cfg = MuonConfig(dion2_rank_frac=0.25)
    assert tortho.dion2_rank(32, cfg) == 8
    assert tortho.dion2_rank(1, cfg) == 1
    assert tortho.dion2_rank(32, MuonConfig(dion2_rank_frac=1.0)) == 32


def test_dion2_prewarms_the_factor_shapes():
    """Muon(variant='dion2') scores the kernels at the r×n factor's shapes
    (m = 8 for the 32-row groups here), which the cache then holds."""
    _mk("dion2")
    assert autotune.cached_entry("syrk", 8, 128, "float32") is not None
    assert autotune.cached_entry("symmul", 8, 8, "float32") is not None
    assert autotune.cached_entry("gram_poly", 8, 8, "float32") is not None


# ------------------------------------------------------------------ adamuon

def test_adamuon_state_shapes_and_pad_rows():
    params, plan, opt = _mk("adamuon")
    new_params, state = _run(opt, params)
    v = state.variant_state["v"]
    assert state.variant_state["inner"] is None   # base Gram is stateless
    for key, grp in plan.groups.items():
        skey = group_key_str(key)
        assert v[skey].shape == (grp.packed_size,) + grp.key
        assert bool(torch.isfinite(v[skey]).all())
        if grp.packed_size > grp.count:
            assert not v[skey][grp.count:].any()
    assert _finite(new_params)


# ------------------------------------------------------- state round-trips

@pytest.mark.parametrize("variant", STATEFUL)
def test_state_dict_roundtrip_with_variant_state(variant):
    params, _, opt = _mk(variant)
    _, state = _run(opt, params, n=2)
    d = opt.state_dict(state)
    assert d["variant_state"] is not None
    state2 = opt.load_state_dict(d)
    a, b = tree.flatten(state._asdict()), tree.flatten(state2._asdict())
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# ---------------------------------------------------- parity with reference

CASES = [("normuon", False), ("normuon", True), ("adamuon", False),
         ("adamuon", True), ("muonbp", False), ("dion2", False)]


def _pair(variant, bucket_fusion=False, muonbp_period=2):
    params = _tree()
    jplan = japi.dedicate_params(_jax(params), num_owners=4,
                                 strategy="greedy")
    tplan = api.dedicate_params(_torch(params), num_owners=4,
                                strategy="greedy")
    common = dict(variant=variant, learning_rate=LR, momentum=MOMENTUM,
                  muonbp_period=muonbp_period)
    jopt = japi.Muon(jplan, config=JMuonConfig(**common, ns=JGramNSConfig(
        num_steps=5, bucket_fusion=bucket_fusion)))
    topt = api.Muon(tplan, config=MuonConfig(**common, ns=GramNSConfig(
        num_steps=5, bucket_fusion=bucket_fusion)), device="cpu")
    return params, jplan, jopt, topt


def _flat_jax(t) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _flat_torch(t) -> dict:
    return {p: v.detach().float().numpy() for p, v in tree.flatten(t)}


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for p in want:
        np.testing.assert_allclose(got[p], np.asarray(want[p], np.float32),
                                   err_msg=f"{what}: {p}", **TOL)


def _state_close(variant, ts, js, what, x0=None) -> None:
    got, want = _flat_torch(ts), _flat_jax(js)
    if variant == "dion2":                      # bases up to column signs
        def proj(q):
            return q @ np.swapaxes(q, -1, -2)
        got = {p: proj(v) for p, v in got.items()}
        want = {p: proj(v) for p, v in want.items()}
    if x0 is not None:                          # MuonBP: Q as Q·X₀
        assert set(got) == set(want), what
        for p in want:
            np.testing.assert_allclose(
                got[p] @ x0[p], np.asarray(want[p], np.float64) @ x0[p],
                rtol=GRAM_NS_TOL, atol=GRAM_NS_TOL, err_msg=f"{what}: {p}")
        return
    _close(got, want, what)


def _muonbp_x0(tplan, grads: list) -> dict:
    """X₀ of MuonBP's last refresh (the last even step of ``grads``): the
    packed Nesterov momentum normalized per matrix, in float64, keyed like
    the state ('q/<group>')."""
    from repro_torch.core.owner_comms import pack_group
    out = {}
    for key, g in tplan.groups.items():
        mom, effs = 0.0, []
        for gr in grads:
            flat = dict(tree.flatten(_torch(tree.tree_map(
                lambda a: a.astype(np.float64), gr))))
            gp = pack_group(tplan, key, {p: flat[p] for p in g.leaf_paths})
            mom = MOMENTUM * mom + gp.numpy()
            effs.append(gp.numpy() + MOMENTUM * mom)
        x = effs[(len(grads) - 1) // 2 * 2]
        out["q/" + group_key_str(key)] = x / (np.sqrt(np.sum(
            x * x, axis=(-2, -1), keepdims=True)) + 1e-7)
    return out


def _rel_diff(o_port, o_ref):
    """|o_port − o_ref| / |o_ref| entrywise (inf where o_ref is 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(o_ref == 0, np.inf,
                        np.abs(o_port - o_ref) / np.abs(o_ref))


def _close_within_o(got, want, rho, what: str) -> int:
    """AdaMuon outputs against the reference: within the tolerance where
    the o history agrees relatively within rtol (``rho`` <= RTOL, rho the
    largest relative difference of an entry's o so far); every other entry
    (counted) within 2·rho of the larger of the two values: at most a sign
    flip, or, where |o| is near eps, the step from o/eps to ±1."""
    want = np.asarray(want, np.float32)
    held = rho <= RTOL
    np.testing.assert_allclose(got[held], want[held], err_msg=what, **TOL)
    g, w = got[~held], want[~held]
    allow = ATOL + RTOL * np.abs(w) + np.minimum(2 * rho[~held], 2) \
        * np.maximum(np.abs(g), np.abs(w))
    assert (np.abs(g - w) <= allow).all(), \
        f"{what}: more than its o explains"
    return int((~held).sum())


@pytest.mark.parametrize("variant,bucket_fusion", CASES,
                         ids=[f"{v}-{'fused' if f else 'plain'}"
                              for v, f in CASES])
def test_variant_matches_reference(variant, bucket_fusion):
    """5 steps (MuonBP period 2: refresh, reuse, refresh, reuse, refresh;
    Dion2: cold start, then warm) from the same parameters and gradients:
    updates every step, then parameters, momentum and variant state."""
    params, jplan, jopt, topt = _pair(variant, bucket_fusion)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    _state_close(variant, ts.variant_state, js.variant_state, "init state")
    if variant == "adamuon":
        # plain Muon on the same gradients: u = -lr·s·o (no weight decay),
        # the inner update o in the units of the update
        twins = [japi.Muon(jplan, config=dataclasses.replace(
                     jopt.config, variant="muon")),
                 api.Muon(topt.plan, config=dataclasses.replace(
                     topt.config, variant="muon"), device="cpu")]
        twin_states = [twins[0].init(jp), twins[1].init(tp)]
        rho = {}
    excepted = n_entries = 0
    for t in range(5):
        g = _grads(t)
        if variant == "muonbp" and t % 2:       # reuse: the same cached Q
            ts = ts._replace(variant_state={"q": {
                k: torch.from_numpy(np.array(v))
                for k, v in js.variant_state["q"].items()}})
        ju, js = jopt.update(_jax(g), js, jp)
        tu, ts = topt.update(_torch(g), ts, tp)
        got, want = _flat_torch(tu), _flat_jax(ju)
        if variant == "adamuon":
            mu, twin_states[0] = twins[0].update(_jax(g), twin_states[0], jp)
            tmu, twin_states[1] = twins[1].update(_torch(g), twin_states[1],
                                                  tp)
            o_ref, o_port = _flat_jax(mu), _flat_torch(tmu)
            _close(o_port, o_ref, f"inner update step {t}")
            for p in jplan.leaves:
                rho[p] = np.maximum(rho.get(p, 0.0),
                                    _rel_diff(o_port[p], o_ref[p]))
                excepted += _close_within_o(got.pop(p), want.pop(p),
                                            rho[p], f"updates step {t}: {p}")
                n_entries += rho[p].size
        _close(got, want, f"updates step {t}")    # (AdamW leaves of adamuon)
        x0 = _muonbp_x0(topt.plan, [_grads(s) for s in range(t + 1)]) \
            if variant == "muonbp" else None
        _state_close(variant, ts.variant_state, js.variant_state,
                     f"variant state step {t}", x0)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = _add(tp, tu)
    assert ts.step == int(js.step) == 5
    _close(_flat_torch(ts.momentum), _flat_jax(js.momentum), "momentum")
    if variant == "adamuon":
        # a guard that the exception stays one: entries whose o agrees
        # only to the absolute tolerance are a few percent of a Gaussian
        assert excepted <= 0.05 * n_entries, (excepted, n_entries)
    else:
        _close(_flat_torch(tp), _flat_jax(jp), "params")



# ------------------------------------------- chip_smoke.py's variant checks

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_expected_launches_per_variant():
    cs = _chip_smoke()
    full, none = cs.LAUNCHES_PER_STEP, dict.fromkeys(cs.LAUNCHES_PER_STEP, 0)
    bp = {"muonbp_period": 2}
    assert [cs.expected_launches("muonbp", "owner", i, bp)
            for i in range(3)] == [full, none, full]
    for variant in ("muon", "normuon", "dion2", "adamuon"):
        assert cs.expected_launches(variant, "owner", 1, {}) == full
    assert cs.expected_launches("adamw", "owner", 0, {}) == none
    assert cs.expected_launches("muon", "gather", 0, {}) == none


def test_chip_smoke_one_ulp_up_moves_half_the_entries_one_ulp():
    cs = _chip_smoke()
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    y = cs.one_ulp_up(torch, x, torch.Generator().manual_seed(1))
    moved = y != x
    assert 0.4 < float(moved.float().mean()) < 0.6
    assert torch.equal(y[moved], torch.nextafter(x[moved],
                                                 torch.tensor(np.inf)))


def test_chip_smoke_adamuon_check_counts_flips_and_rejects_faults():
    """An entry whose o flips sign may flip the update; an entry whose o
    agrees must agree within the gate, and a flip it does not explain
    fails."""
    cs = _chip_smoke()
    o = torch.tensor([[0.3, -0.2, 1e-9, 0.5]])
    o_got = o.clone()
    o_got[0, 2] = -1e-9                       # rounding-level entry flips
    want = {"w": torch.sign(o) * 0.01}
    got = {"w": torch.sign(o_got) * 0.01}
    res = cs.adamuon_vs_o(got, want, {"w": o_got}, {"w": o}, 1e-4)
    assert not res["outside"] and res["excepted"] == 1
    bad = {"w": got["w"].clone()}
    bad["w"][0, 0] = -0.01                    # o agrees, the update flips
    res = cs.adamuon_vs_o(bad, want, {"w": o_got}, {"w": o}, 1e-4)
    assert res["outside"] == ["w"]
