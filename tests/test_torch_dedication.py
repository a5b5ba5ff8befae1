"""Port dedication plans are identical to the reference's, key for key.

Both packages plan the same parameter shapes: the reduced smollm-360m from
its JAX init (carried over as numpy) and the full smollm-360m shape census
(JAX ``eval_shape`` vs the port's ``device="meta"`` init), for several owner
counts and every strategy ``load_balance.assign`` accepts.

Both packages' MILP solves run without their 10 s time limit here
(``_solve_to_gap``): on the full census at 8 owners the solve needs about
12 s alone and more beside other tests, so a clock could stop the two
solves at different incumbents.  Each then ends at HiGHS's 2% relative gap,
which it reaches by the same deterministic search in both.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.owner_comms import pack_group, unpack_group  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

# far above any solve's time: the relative gap ends every solve
MILP_TIME_LIMIT_S = 3600.0


@pytest.fixture(autouse=True)
def _solve_to_gap(monkeypatch):
    from repro.core import load_balance as jlb
    from repro_torch.core import load_balance as tlb
    for mod in (jlb, tlb):
        monkeypatch.setattr(mod, "solve_milp", functools.partial(
            mod.solve_milp, time_limit=MILP_TIME_LIMIT_S))


STRATEGIES = ["load_balance", "greedy", "lpt", "round_robin", "rank0", "xor"]
OWNERS = [1, 4, 8]


def _shapes(reduced: bool):
    jcfg = jconfigs.get("smollm-360m", reduced=reduced)
    tcfg = tconfigs.get("smollm-360m", reduced=reduced)
    if reduced:
        jparams = jtransformer.init(jcfg, jax.random.PRNGKey(0))
        tparams = ttransformer.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
    else:
        jparams = jax.eval_shape(lambda k: jtransformer.init(jcfg, k),
                                 jax.random.PRNGKey(0))
        tparams = ttransformer.init(tcfg, device="meta")
    return jparams, tparams


@pytest.fixture(scope="module", params=[True, False], ids=["reduced", "full"])
def shapes(request):
    return _shapes(request.param)


def _assert_same_plan(jp, tp):
    assert list(tp.leaves) == list(jp.leaves)
    for path, jl in jp.leaves.items():
        tl = tp.leaves[path]
        assert (tl.shape, tl.count, tl.transpose, tl.group, tl.offset) == \
            (tuple(jl.shape), jl.count, jl.transpose, jl.group, jl.offset)
    assert tp.adamw_paths == jp.adamw_paths
    assert list(tp.groups) == list(jp.groups)
    for key, jg in jp.groups.items():
        tg = tp.groups[key]
        assert (tg.key, tg.leaf_paths, tg.count, tg.capacity) == \
            (jg.key, jg.leaf_paths, jg.count, jg.capacity)
        np.testing.assert_array_equal(tg.owner_of, jg.owner_of)
        np.testing.assert_array_equal(tg.pack_index, jg.pack_index)
        np.testing.assert_array_equal(tg.unpack_index, jg.unpack_index)
    assert tp.buckets == jp.buckets
    assert tp.stats == jp.stats
    assert tp.strategy == jp.strategy
    assert set(tp.assignment.owner_of) == set(jp.assignment.owner_of)
    for k, v in jp.assignment.owner_of.items():
        np.testing.assert_array_equal(tp.assignment.owner_of[k], v)


@pytest.mark.parametrize("num_owners", OWNERS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plan_identical_to_reference(shapes, num_owners, strategy):
    jparams, tparams = shapes
    kw = dict(num_owners=num_owners, strategy=strategy)
    _assert_same_plan(japi.dedicate_params(jparams, **kw),
                      tapi.dedicate_params(tparams, **kw))


@pytest.mark.parametrize("physical_layout", ["contiguous", "assignment"])
def test_assignment_layout_identical(physical_layout):
    jparams, tparams = _shapes(reduced=True)
    kw = dict(num_owners=4, strategy="greedy", physical_layout=physical_layout)
    _assert_same_plan(japi.dedicate_params(jparams, **kw),
                      tapi.dedicate_params(tparams, **kw))


def test_named_parameters_plan_like_the_dict():
    """An nn.Module's names ('.'-joined) plan exactly as the nested dict."""
    _, tparams = _shapes(reduced=True)
    module = torch.nn.Module()
    for name, sub in tparams.items():
        child = torch.nn.Module()
        module.add_module(name, child)

        def add(mod, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    c = torch.nn.Module()
                    mod.add_module(k, c)
                    add(c, v)
                else:
                    mod.register_parameter(k, torch.nn.Parameter(v.detach()))
        add(child, sub)
    assert "blocks.attn.q_proj.w" in dict(module.named_parameters())
    _assert_same_plan(tapi.dedicate_params(tparams, num_owners=4),
                      tapi.dedicate_params(module, num_owners=4))


@pytest.mark.parametrize("physical_layout", ["contiguous", "assignment"])
def test_pack_unpack_matches_reference(physical_layout):
    from repro.core.muon import pack_group as jpack
    jparams, tparams = _shapes(reduced=True)
    kw = dict(num_owners=4, strategy="lpt", physical_layout=physical_layout)
    jplan = japi.dedicate_params(jparams, **kw)
    tplan = tapi.dedicate_params(tparams, **kw)
    flat_j = dict((("/".join(str(k.key) for k in kp), v) for kp, v in
                   jax.tree_util.tree_flatten_with_path(jparams)[0]))
    flat_t = {p: tparams_at(tparams, p) for p in flat_j}
    for key, g in tplan.groups.items():
        packed = pack_group(tplan, key, {p: flat_t[p] for p in g.leaf_paths})
        want = jpack(jplan, key, {p: flat_j[p] for p in g.leaf_paths})
        np.testing.assert_array_equal(packed.detach().numpy(),
                                      np.asarray(want))
        out = unpack_group(tplan, key, packed)
        for p in g.leaf_paths:
            torch.testing.assert_close(out[p], flat_t[p], rtol=0, atol=0)


def tparams_at(tree, path):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


@pytest.mark.parametrize("physical_layout", ["contiguous", "assignment"])
def test_repack_rows_matches_reference(physical_layout):
    """Owner-major buffers re-laid out from 4 owners to 3 (elastic restart)
    equal the reference's repack, row for row."""
    from repro.core.owner_comms import repack_rows as jrepack
    from repro_torch.core.owner_comms import repack_rows
    jparams, tparams = _shapes(reduced=True)
    plans = []
    for owners in (4, 3):
        kw = dict(num_owners=owners, strategy="lpt",
                  physical_layout=physical_layout)
        plans.append((japi.dedicate_params(jparams, **kw),
                      tapi.dedicate_params(tparams, **kw)))
    (jold, told), (jnew, tnew) = plans
    rng = np.random.default_rng(0)
    for key, g in told.groups.items():
        buf = rng.standard_normal((g.packed_size,) + g.key).astype(np.float32)
        got = repack_rows(g, tnew.groups[key], torch.from_numpy(buf))
        want = jrepack(jold.groups[key], jnew.groups[key], jax.numpy.asarray(buf))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_measured_cost_model_times_the_port():
    from repro_torch.core import load_balance
    cm = load_balance.measured_cost_model({(8, 16): 4, (16, 32): 2},
                                          batch_sizes=(1, 2), repeats=1,
                                          device="cpu")
    assert set(cm.costs) == {(8, 16), (16, 32)}
    for by_b in cm.costs.values():
        assert set(by_b) == {1, 2} and all(t > 0 for t in by_b.values())
    asn = load_balance.assign({(8, 16): 4, (16, 32): 2}, 2, strategy="greedy",
                              cost_model=cm)
    assert {k: len(v) for k, v in asn.owner_of.items()} == \
        {(8, 16): 4, (16, 32): 2}
    assert set(np.concatenate(list(asn.owner_of.values())).tolist()) <= {0, 1}


# ---------------------------------------------------------------- MoE census
# Expert leaves (L, E, m, n) carry L·E matrices each, one group per leaf;
# the census handed to the load balancer aggregates by (m, n) across leaves.

MOE_ARCHS = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]


def _arch_shapes(arch: str, reduced: bool, **overrides):
    """Both packages' ``model_fns(cfg).init`` trees: the reference's values
    carried over (reduced), or shapes (full width)."""
    from repro.models import model_fns as jmodel_fns
    from repro_torch.models import model_fns as tmodel_fns
    jcfg = jconfigs.get(arch, reduced=reduced, **overrides)
    tcfg = tconfigs.get(arch, reduced=reduced, **overrides)
    if reduced:
        jparams = jmodel_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
        tparams = ttransformer.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
    else:
        jparams = jax.eval_shape(lambda k: jmodel_fns(jcfg).init(jcfg, k),
                                 jax.random.PRNGKey(0))
        tparams = tmodel_fns(tcfg).init(tcfg, device="meta")
    return jparams, tparams


@pytest.mark.parametrize("num_owners", OWNERS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_plan_identical_to_reference(arch, num_owners):
    """Reduced DeepSeek-V3 / Kimi-K2 (the MILP's default strategy)."""
    jparams, tparams = _arch_shapes(arch, reduced=True)
    tplan = tapi.dedicate_params(tparams, num_owners=num_owners)
    _assert_same_plan(japi.dedicate_params(jparams, num_owners=num_owners),
                      tplan)
    L, E = 2, tconfigs.get(arch, reduced=True).moe.n_experts
    for part in ("gate_proj", "up_proj", "down_proj"):
        g = tplan.groups[f"blocks/moe/experts/{part}/w"]
        assert g.count == L * E
        assert tplan.leaves[f"blocks/moe/experts/{part}/w"].shape[:2] == (L, E)


# the chip phase's cut: two layers, 16 experts (the router has 16 outputs)
FULL_WIDTH = {"published": {},
              "cut": dict(n_layers=2, moe_experts=16)}


def _full_overrides(cut: dict):
    if not cut:
        return {}, {}
    import dataclasses
    jm = dataclasses.replace(jconfigs.get("deepseek-v3-671b").moe,
                             n_experts=cut["moe_experts"])
    tm = dataclasses.replace(tconfigs.get("deepseek-v3-671b").moe,
                             n_experts=cut["moe_experts"])
    return (dict(n_layers=cut["n_layers"], moe=jm),
            dict(n_layers=cut["n_layers"], moe=tm))


@pytest.mark.parametrize("num_owners", OWNERS)
@pytest.mark.parametrize("size", sorted(FULL_WIDTH))
def test_full_width_deepseek_census_identical(size, num_owners):
    """DeepSeek-V3 at its published widths, planned from meta tensors
    against ``jax.eval_shape``, greedy: 11 groups in 5 Gram buckets, the
    expert groups of L·E matrices, the census aggregated by (m, n)."""
    jo, to = _full_overrides(FULL_WIDTH[size])
    jcfg = jconfigs.get("deepseek-v3-671b", **jo)
    tcfg = tconfigs.get("deepseek-v3-671b", **to)
    jparams = jax.eval_shape(lambda k: jtransformer.init(jcfg, k),
                             jax.random.PRNGKey(0))
    tparams = ttransformer.init(tcfg, device="meta")
    kw = dict(num_owners=num_owners, strategy="greedy")
    tplan = tapi.dedicate_params(tparams, **kw)
    _assert_same_plan(japi.dedicate_params(jparams, **kw), tplan)
    L, E = tcfg.n_layers, tcfg.moe.n_experts
    assert len(tplan.groups) == 11
    assert sorted(tplan.buckets) == [512, 576, 1536, 2048, 7168]
    assert {k: g.key for k, g in tplan.groups.items()
            if "experts" in k} == dict.fromkeys(
        [f"blocks/moe/experts/{p}/w" for p in ("down_proj", "gate_proj",
                                               "up_proj")], (2048, 7168))
    census = {k: len(v) for k, v in tplan.assignment.owner_of.items()}
    assert census == {(2048, 7168): 3 * L * E + 3 * L, (1536, 7168): L,
                      (1536, 24576): L, (576, 7168): L, (512, 32768): L,
                      (7168, 16384): L}


# ------------------------------------------------- hybrid, xLSTM, enc-dec, VLM
# Their groups bring Gram shapes no earlier family has: hymba's m = 100
# (dt_proj) and 132 (x_proj), xLSTM's stacked mLSTM / sLSTM leaves, the
# encoder-decoder's cross-attention and llava's unstacked connector (count 1).

FAMILY_ARCHS = ["hymba-1.5b", "xlstm-350m", "seamless-m4t-large-v2",
                "llava-next-mistral-7b"]
# (groups, Gram buckets) of each published config's plan
FAMILY_CENSUS = {
    "hymba-1.5b": (11, [100, 132, 320, 1600]),
    "xlstm-350m": (11, [1024]),
    "seamless-m4t-large-v2": (20, [1024]),
    "llava-next-mistral-7b": (9, [1024, 4096]),
}


@pytest.mark.parametrize("num_owners", OWNERS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_plan_identical_to_reference(arch, num_owners):
    """The reduced configs, the MILP's default strategy."""
    jparams, tparams = _arch_shapes(arch, reduced=True)
    _assert_same_plan(japi.dedicate_params(jparams, num_owners=num_owners),
                      tapi.dedicate_params(tparams, num_owners=num_owners))


@pytest.mark.parametrize("num_owners", OWNERS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_full_width_family_census_identical(arch, num_owners):
    """Each published config planned from meta tensors against
    ``jax.eval_shape``, greedy: the same groups, buckets and census."""
    jparams, tparams = _arch_shapes(arch, reduced=False)
    kw = dict(num_owners=num_owners, strategy="greedy")
    tplan = tapi.dedicate_params(tparams, **kw)
    _assert_same_plan(japi.dedicate_params(jparams, **kw), tplan)
    groups, buckets = FAMILY_CENSUS[arch]
    assert (len(tplan.groups), sorted(tplan.buckets)) == (groups, buckets)

