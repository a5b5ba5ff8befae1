"""Port dedication plans are identical to the reference's, key for key.

Both packages plan the same parameter shapes: the reduced smollm-360m from
its JAX init (carried over as numpy) and the full smollm-360m shape census
(JAX ``eval_shape`` vs the port's ``device="meta"`` init), for several owner
counts and every strategy ``load_balance.assign`` accepts.
"""

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
