"""Serving under a mesh (``serve.Scheduler(..., mesh=mesh)``): the
contiguous tier on gloo worlds (1, 2), (1, 4) and (2, 2), one process a
rank (``tests/torch_dist_check.py serve``, ``torch_serve_check.py``),
against the reference's ``Scheduler(..., mesh=mesh)`` on an Auto-axis
mesh of host devices of the same shape (``jax_serve``), request for
request: logits within rtol 1e-4 / atol 1e-3 and the same tokens.

The cases cover every cache layout of ``cache_specs``: KV heads split
(reduced qwen2.5-14b, 2 KV heads, on model 2), sequence split (the same
on model 4; reduced smollm-360m with 3 heads and 1 KV head on model 2),
whole (qwen at 30 positions on model 4) and MLA's latent by sequence
(reduced DeepSeek-V3, experts split over 'model'; ``dsv3g``'s 3 heads,
whose MLA is not head-parallel, on model 4); on (2, 2) the slots split
over 'data' too, and the MoE dispatch ranks the decode batch over it.
Each case serves 7 requests through 4 slots in fp32 (packed prefills,
chunks of 8, a decode that writes rows 4 .. 29); ``REFERENCE`` names the
pairs held to the reference (each layout once), the others are held to
one another and to the one-card scheduler by the checks below.

Also: on a (1, 1) world the mesh run is bitwise the one-card scheduler;
each rank allocates only its part of the cache (the leaves' shapes);
every rank ends with the same tokens and logits; each dense request
replayed alone at its served shapes under the mesh is bitwise its served
logits; a sequence-split decode whose writes land on each rank in turn
writes exactly its own rows; a data rank that holds none of a prefill's
slots still runs it (the world ends); and a merge that drops one rank's
attention partial fails the gate.
"""

import concurrent.futures
import math

import numpy as np
import pytest
import torch

import torch_dist_check as dc
import torch_serve_check as sc
from repro_torch.models import transformer
from repro_torch.models.sharding import cache_specs, local_shape
from repro_torch.models.tp import ModelParallel
from repro_torch.train.serve import make_cache_shapes

WORLDS = {(1, 1): ("qwen256", "dsv3"),
          (1, 2): ("qwen256", "smollm3h", "dsv3"),
          (1, 4): ("qwen256", "qwen257w", "dsv3g", "dsv3"),
          (2, 2): ("qwen256", "smollm3h", "dsv3")}
# the pairs held to the reference, one process a mesh shape: each layout
# once (heads; sequence with and without 'data'; whole; MLA by sequence,
# head-parallel with the experts split over 'model' and the decode over
# 'data', and not head-parallel), few enough that each process ends well
# inside its deadline in the loaded suite (a case compiles the reference's
# scheduler for 8-17 s of one core)
REFERENCE = {(1, 2): ("qwen256",), (1, 4): ("qwen256", "qwen257w", "dsv3g"),
             (2, 2): ("smollm3h", "dsv3")}
RUNS = [(m, c) for m, cs in WORLDS.items() for c in cs]
REF_RUNS = [(m, c) for m, cs in REFERENCE.items() for c in cs]
DEADLINE_S = 600.0
RTOL, ATOL = 1e-4, 1e-3
# the cache layout each case takes on each mesh ("heads", "rows" (the
# sequence split), "whole"; MLA's latent "rows" or "whole")
LAYOUT = {((1, 2), "qwen256"): "heads", ((1, 2), "smollm3h"): "rows",
          ((1, 2), "dsv3"): "rows", ((1, 4), "qwen256"): "rows",
          ((1, 4), "qwen257w"): "whole", ((1, 4), "dsv3g"): "rows",
          ((1, 4), "dsv3"): "rows", ((2, 2), "qwen256"): "heads",
          ((2, 2), "smollm3h"): "rows", ((2, 2), "dsv3"): "rows",
          ((1, 1), "qwen256"): "whole", ((1, 1), "dsv3"): "whole"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The four worlds and the three reference processes side by side."""
    pytest.importorskip("jax")
    out = {m: tmp_path_factory.mktemp(f"serve_{m[0]}x{m[1]}")
           for m in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(
            len(WORLDS) + len(REFERENCE)) as pool:
        jobs = [pool.submit(dc.launch, "serve", math.prod(m), m, out[m],
                            DEADLINE_S, ("--configs", ",".join(cs)))
                for m, cs in WORLDS.items()]
        jobs += [pool.submit(dc.run_jax, m, out[m], DEADLINE_S, "jax_serve",
                             ("--configs", ",".join(cs)))
                 for m, cs in REFERENCE.items()]
        for j in jobs:
            j.result()
    res = {m: dc.load(out[m], math.prod(m)) for m in WORLDS}
    for m in REFERENCE:
        res[m]["jax"] = dict(np.load(out[m] / "jax.npz"))
    return res


def _ids(runs):
    return [f"{m[0]}x{m[1]}-{c}" for m, c in runs]


def _logits(z: dict, case: str, kind: str = "logits") -> dict:
    prefix = f"{case}/{kind}/"
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def gate_violation(got: dict, want: dict) -> float:
    """The largest max(|got − want| − (ATOL + RTOL·|want|)) over every
    request's logits (<= 0 passes), inf where a request's token count
    differs."""
    worst = -math.inf
    for rid, w in want.items():
        g = got.get(rid)
        if g is None or g.shape != w.shape:
            return math.inf
        worst = max(worst, float((np.abs(g - w)
                                  - (ATOL + RTOL * np.abs(w))).max()))
    return worst


@pytest.mark.parametrize("mesh,case", REF_RUNS, ids=_ids(REF_RUNS))
def test_matches_reference_mesh_scheduler(worlds, mesh, case):
    res = worlds[mesh]
    want = _logits(res["jax"], case)
    got = _logits(res["npz"][0], case)
    assert sorted(got) == sorted(want)
    assert gate_violation(got, want) <= 0
    tokens = res["json"][0]["cases"][case]["tokens"]
    for rid in want:
        assert tokens[rid] == res["jax"][f"{case}/tokens/{rid}"].tolist(), rid


@pytest.mark.parametrize("mesh,case", RUNS, ids=_ids(RUNS))
def test_every_rank_serves_the_same(worlds, mesh, case):
    res = worlds[mesh]
    first = res["json"][0]["cases"][case]
    ref = _logits(res["npz"][0], case)
    for info, z in zip(res["json"][1:], res["npz"][1:]):
        assert info["cases"][case]["tokens"] == first["tokens"]
        assert info["cases"][case]["stints"] == first["stints"]
        got = _logits(z, case)
        assert all(np.array_equal(got[r], v) for r, v in ref.items())
    # every request served in full
    reqs = {r.rid: r for r in sc.serve_queue(dc.tp_config(
        sc.CASES[case][0]).vocab)}
    for rid, toks in first["tokens"].items():
        r = reqs[int(rid)]
        assert len(toks) == min(r.max_new_tokens,
                                sc.CASES[case][1] - r.prompt_len + 1)


class _Mesh:
    """A stand-in mesh for the spec rules (they read names and sizes)."""

    def __init__(self, shape, rank):
        self.mesh_dim_names = dc.AXES
        self.shape = tuple(shape)
        self._coords = np.unravel_index(rank, shape)

    def size(self, i=None):
        return math.prod(self.shape) if i is None else self.shape[i]

    def get_local_rank(self, i):
        return int(self._coords[i])


@pytest.mark.parametrize("mesh,case", RUNS, ids=_ids(RUNS))
def test_each_rank_allocates_its_part(worlds, mesh, case):
    """The cache leaves are ``local_shape`` of ``cache_specs``: 1 / model
    of the whole (1 / data more where the slots split), in the layout
    the case is meant to take."""
    name, max_len = sc.CASES[case]
    cfg = dc.tp_config(name)
    shapes = make_cache_shapes(cfg, sc.SLOTS, max_len, torch.float32)
    for rank, info in enumerate(worlds[mesh]["json"]):
        row = info["cases"][case]
        fake = _Mesh(mesh, rank)
        specs = cache_specs(cfg, shapes, fake)
        whole_bytes = part_bytes = 0
        for k, v in shapes.items():
            want = local_shape(v.shape, specs[k], fake)
            assert tuple(row["cache_shapes"][k]) == want, (k, rank)
            whole_bytes += math.prod(v.shape)
            part_bytes += math.prod(want)
        split = (mesh[1] if LAYOUT[(mesh, case)] != "whole" else 1) * \
            (mesh[0] if sc.SLOTS % mesh[0] == 0 else 1)
        assert part_bytes * split == whole_bytes
        # the prefill's cache part (init_cache(tp=...)) has the same
        # layout over 'model'
        tp = None if mesh[1] == 1 else \
            ModelParallel(None, mesh[1], rank % mesh[1])
        part = transformer.init_cache(cfg, 1, max_len, torch.float32,
                                      device="meta", tp=tp)
        for k, v in part.items():
            assert v.shape[2:] == tuple(row["cache_shapes"][k][2:]), k
    layout = LAYOUT[(mesh, case)]
    rows = worlds[mesh]["json"][0]["cases"][case]["cache_rows"]
    assert (rows is not None) == (layout == "rows")
    heads = cfg.attn_kind != "mla" and layout == "heads"
    assert heads == (worlds[mesh]["json"][0]["cases"][case]["cache_shapes"]
                     [next(iter(shapes))][3] < cfg.n_kv_heads)


@pytest.mark.parametrize("case", WORLDS[(1, 1)])
def test_one_by_one_mesh_bitwise_one_card(worlds, case):
    assert worlds[(1, 1)]["json"][0]["cases"][case]["one_card_bitwise"]


REPLAYS = [(m, c) for m, c in RUNS if c in sc.REPLAY]


@pytest.mark.parametrize("mesh,case", REPLAYS, ids=_ids(REPLAYS))
def test_slot_equals_replay_under_mesh_bitwise(worlds, mesh, case):
    for info in worlds[mesh]["json"]:
        flags = info["cases"][case]["replay_bitwise"]
        assert len(flags) == 7 and all(flags.values()), flags


def test_sequence_split_decode_writes_each_rank_in_turn(worlds):
    """qwen's 2 KV heads on 4 ranks: 8 rows a rank.  One decode step with
    slot r at row 3 of rank r's rows changes exactly that (slot, row) on
    rank r, and matches the step without the mesh; the served queue's
    long request decodes through every rank's rows."""
    for rank, info in enumerate(worlds[(1, 4)]["json"]):
        w = info["cases"][sc.SEQ_WRITE]["seq_write"]
        assert w["changed"] == w["expected"] == [[rank, 8 * rank + 3]]
        assert w["part_max_diff"] <= 1e-5 and w["logits_max_diff"] <= 1e-4
    toks = worlds[(1, 4)]["json"][0]["cases"][sc.SEQ_WRITE]["tokens"]["6"]
    assert len(toks) == 27      # decode wrote rows 4 .. 29


def test_no_hang_when_a_data_rank_holds_no_slot_of_a_prefill(worlds):
    """On (2, 2) the slots split 2 a data rank.  A prefill of one request
    (a chunked prompt, or a group of one) writes one slot, so one data
    rank holds none of its slots: it ran there all the same, and the
    world ended with every rank's record."""
    for case in WORLDS[(2, 2)]:
        infos = worlds[(2, 2)]["json"]
        assert sorted(tuple(i["cases"][case]["slot_rows"]) for i in infos) \
            == [(0, 2), (0, 2), (2, 4), (2, 4)]
        stints = infos[0]["cases"][case]["stints"]
        assert any(batch == 1 for _, batch, _, _ in stints.values())


def test_dropped_partial_fails_the_gate(worlds):
    """The merge of the sequence split's attention partials with the last
    rank's dropped (its row max set to -1e30) misses the reference by far
    more than the gate, where the true merge passes it."""
    res = worlds[(1, 4)]
    case = WORLDS[(1, 4)][0]
    want = _logits(res["jax"], case)
    mutant = {r: v for r, v in _logits(res["npz"][0], case,
                                       "mutant").items()}
    assert gate_violation(_logits(res["npz"][0], case), want) <= 0
    assert gate_violation(mutant, want) > 100 * ATOL
