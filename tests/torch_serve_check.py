"""Serving under a mesh, one gloo process per rank (``serve``) and the
reference's ``Scheduler(..., mesh=mesh)`` on an Auto-axis mesh of host
devices (``jax_serve``), run by ``tests/test_torch_serve_mesh.py``
through ``torch_dist_check.py``:

    python tests/torch_dist_check.py serve --rank R --world W --port P \\
        --mesh 1,4 --out DIR [--configs qwen256,dsv3]
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dist_check.py jax_serve --mesh 1,4 --out DIR \\
        [--configs qwen256,dsv3]

Each case (``CASES``) is a reduced config of ``torch_dist_check.TP_CONFIGS``
in fp32 (parameters drawn with numpy, ``tp_params``), a cache length and
the same synthetic queue (``serve_queue``).  ``serve`` writes, for every
rank, each request's tokens, the stints it was served in, the cache leaves'
shapes and the slot replays (rank<R>.json), and its logits token by token
(rank<R>.npz); ``jax_serve`` writes the reference's logits (jax.npz).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

import torch_dist_check as dc

# (TP_CONFIGS name, max_len): ``qwen257w``'s 30 positions divide no model
# axis of more than one rank, so its cache is whole on every rank there
CASES = {"qwen256": ("qwen256", 32), "qwen257w": ("qwen257", 30),
         "smollm3h": ("smollm3h", 32), "dsv3": ("dsv3", 32),
         "dsv3g": ("dsv3g", 32)}
SLOTS, PACK, CHUNK = 4, 2, 8
# the dense cases, whose rows are independent (MoE rows share capacity):
# each request replayed alone at its served shapes, bitwise
REPLAY = ("qwen256", "qwen257w", "smollm3h")
# the sequence-split decode whose writes land on each rank in turn
SEQ_WRITE = "qwen256"


def serve_queue(vocab: int):
    """6 synthetic requests (prompts of 4 and 12 tokens: packed pairs and
    chunks of 8) and one of 4 tokens with 27 to generate, whose decode
    writes rows 4 .. 29: on a sequence split over 4 ranks each rank's rows
    in turn.  Few prompt lengths, so the reference compiles few shapes."""
    from repro_torch.serve import Request, RequestQueue
    q = RequestQueue.synthetic(6, vocab, prompt_lens=(4, 12),
                               new_tokens=(3, 8), seed=0)
    long = Request(rid=6, tokens=np.random.default_rng(7).integers(
        0, vocab, 4).astype(np.int32), max_new_tokens=27)
    return list(q._pending) + [long]


def serve_config(torch, max_len: int):
    from repro_torch.serve import ServeConfig
    return ServeConfig(num_slots=SLOTS, max_len=max_len, prefill_pack=PACK,
                       chunk_len=CHUNK, cache_dtype=torch.float32,
                       record_logits=True)


def port_params(torch, name: str):
    from repro_torch.core import tree
    flat = dict(tree.flatten(dc.tp_params(name)))
    return tree.tree_map(torch.from_numpy, dc._nest(flat))


def recorded_run(sched, queue):
    """``sched.run(queue)`` with each request's stint recorded: (kind,
    group size, row, slot) of its admission."""
    stints, pending = {}, {}
    group_fn, chunk_fn = sched._prefill_group, sched._prefill_chunked
    insert_fn = sched.slots.insert

    def prefill_group(group):
        for row, r in enumerate(group):
            pending[r.rid] = ("group", len(group), row)
        return group_fn(group)

    def prefill_chunked(req):
        pending[req.rid] = ("chunk", 1, 0)
        return chunk_fn(req)

    def insert(req, row_cache, row, first_token, pos, **kw):
        i = insert_fn(req, row_cache, row, first_token, pos, **kw)
        stints[req.rid] = pending.pop(req.rid) + (i,)
        return i

    sched._prefill_group = prefill_group
    sched._prefill_chunked = prefill_chunked
    sched.slots.insert = insert
    return sched.run(queue), stints


def replay(torch, cfg, params, scfg, ctx, req, stint, tokens) -> list:
    """``req`` alone at its served shapes under the mesh, fed the served
    ``tokens``: its prefill at its group size and row (the other rows
    zero) or batch 1 and the same chunks, its row written into slot
    ``slot`` of a fresh cache part, then decode at ``num_slots`` in that
    slot with every other row idle.  Logits of each token."""
    from repro_torch.core import tree
    from repro_torch.models import model_fns
    from repro_torch.models import tp as tp_lib
    from repro_torch.train import serve as serve_fns
    kind, batch, row, slot = stint
    whole = ctx.whole_batch()
    with torch.inference_mode():
        if kind == "chunk":
            cache = model_fns(cfg).init_cache(cfg, 1, scfg.max_len,
                                              scfg.cache_dtype, device="cpu",
                                              tp=ctx.tp)
            for off in range(0, req.prompt_len, scfg.chunk_len):
                logits, cache = serve_fns.prefill_chunk_fn(
                    cfg, params, torch.from_numpy(
                        req.tokens[None, off:off + scfg.chunk_len]),
                    cache, off, ctx=whole, max_len=scfg.max_len)
        else:
            toks = np.zeros((batch, req.prompt_len), np.int32)
            toks[row] = req.tokens
            logits, cache = serve_fns.prefill_fn(
                cfg, params, torch.from_numpy(toks), scfg.max_len,
                cache_dtype=scfg.cache_dtype, ctx=whole)
        out = [logits[row].numpy().copy()]
        dcache, (first, end) = serve_fns.init_cache_part(
            cfg, scfg.num_slots, scfg.max_len, ctx.mesh, scfg.cache_dtype,
            "cpu")
        if first <= slot < end:
            rows = dict(tree.flatten(cache))
            for path, leaf in tree.flatten(dcache):
                leaf[:, slot - first] = rows[path][:, row]
        dctx = ctx if end - first < scfg.num_slots else whole
        tok = np.zeros(scfg.num_slots, np.int32)
        pos = np.zeros(scfg.num_slots, np.int32)
        pos[slot] = req.prompt_len
        for t in tokens[:-1]:
            tok[slot] = t
            logits, dcache = serve_fns.decode_fn(
                cfg, params, torch.from_numpy(tok[first:end]), dcache,
                torch.from_numpy(pos[first:end]), ctx=dctx,
                max_len=scfg.max_len)
            if dctx.dp is not None:
                logits = tp_lib.gather_over_data(logits, dctx.dp).reshape(
                    scfg.num_slots, -1)
            out.append(logits[slot].numpy().copy())
            pos[slot] += 1
    return out


def seq_write_check(torch, cfg, whole_params, params, ctx,
                    max_len: int) -> dict:
    """One decode step with the slots at positions that fall on every
    rank of a sequence split (slot r at row 3 of rank r's rows), from a
    random cache: this rank's part against the same step without the mesh
    on the whole cache.  Returns the (slot, row) pairs where this rank's
    part changed, those expected, and the largest distance of the part
    and of the logits from the whole run."""
    from repro_torch.models import layers
    from repro_torch.train import serve as serve_fns
    n = ctx.tp.size
    lo, hi = layers.cache_row_range(cfg.n_kv_heads, max_len, ctx.tp)
    per = max_len // n
    rng = np.random.default_rng(11)
    whole = {k: torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, n, max_len, cfg.n_kv_heads, cfg.hd)).astype(
            np.float32)) for k in ("k", "v")}
    part = {k: v[:, :, lo:hi].clone() for k, v in whole.items()}
    before = {k: v.clone() for k, v in part.items()}
    pos = torch.tensor([r * per + 3 for r in range(n)], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, n).astype(np.int32))
    with torch.inference_mode():
        want, whole = serve_fns.decode_fn(cfg, whole_params, tok, whole, pos)
        got, part = serve_fns.decode_fn(cfg, params, tok, part, pos,
                                        ctx=ctx.whole_batch(),
                                        max_len=max_len)
    changed = sorted({(b, s + lo) for k in part for _, b, s, *_ in
                      (part[k] != before[k]).nonzero().tolist()})
    r = ctx.tp.rank
    return {"changed": changed, "expected": [[r, r * per + 3]],
            "part_max_diff": max(float((part[k] - whole[k][:, :, lo:hi])
                                       .abs().max()) for k in part),
            "logits_max_diff": float((got - want).abs().max())}


def serve_rank(args) -> None:
    """Every case of ``--configs`` served on this rank's part of the mesh
    (``Scheduler(..., mesh=mesh)``), its logits and tokens recorded; the
    dense cases' requests replayed alone at their served shapes; on a
    sequence split the decode of ``seq_write_check``; on the first case of
    a mesh with a model axis of 4 the merge of the attention partials
    mutated to drop the last rank's (the gate must then fail); on a mesh
    of one rank the run against the one-card scheduler, bitwise."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import tp as tp_lib
    from repro_torch.serve import RequestQueue, Scheduler
    mesh = dc._setup(args)
    names = args.configs.split(",")
    info, arrays = {"cases": {}}, {}
    for name in names:
        tp_name, max_len = CASES[name]
        cfg = dc.tp_config(tp_name)
        params = port_params(torch, tp_name)
        scfg = serve_config(torch, max_len)
        sched = Scheduler(cfg, params, scfg, mesh=mesh)
        metrics, stints = recorded_run(sched, RequestQueue(
            serve_queue(cfg.vocab)))
        row = {"tokens": {str(r): v.tokens
                          for r, v in metrics.requests.items()},
               "stints": {str(r): list(s) for r, s in stints.items()},
               "cache_shapes": {k: list(v.shape)
                                for k, v in sched.slots.cache.items()},
               "slot_rows": list(sched.slots.rows),
               "cache_rows": layers.cache_row_range(
                   1 if cfg.attn_kind == "mla" else cfg.n_kv_heads,
                   max_len, sched.ctx.tp),
               "model_split": sched.ctx.tp is not None}
        for r, v in metrics.requests.items():
            arrays[f"{name}/logits/{r}"] = np.stack(v.logits)
        reqs = {r.rid: r for r in serve_queue(cfg.vocab)}
        if name in REPLAY:
            row["replay_bitwise"] = {}
            for rid, s in stints.items():
                got = replay(torch, cfg, sched.params, scfg, sched.ctx,
                             reqs[rid], s, metrics.requests[rid].tokens)
                want = metrics.requests[rid].logits
                row["replay_bitwise"][str(rid)] = len(got) == len(want) and \
                    all(np.array_equal(a, b) for a, b in zip(got, want))
        if math.prod(args.mesh) == 1:
            plain = Scheduler(cfg, params, scfg).run(RequestQueue(
                serve_queue(cfg.vocab)))
            row["one_card_bitwise"] = all(
                plain.requests[r].tokens == v.tokens and all(
                    np.array_equal(a, b) for a, b in
                    zip(plain.requests[r].logits, v.logits))
                for r, v in metrics.requests.items())
        if name == SEQ_WRITE and row["cache_rows"] is not None:
            row["seq_write"] = seq_write_check(torch, cfg, params,
                                               sched.params, sched.ctx,
                                               max_len)
        if name == names[0] and sched.ctx.tp is not None and \
                sched.ctx.tp.size == 4 and row["cache_rows"] is not None:
            stack = tp_lib.gather_stack

            def dropped(x, mp):
                out = stack(x, mp)
                out[-1, ..., 0] = -1e30     # the last rank's row max
                return out
            tp_lib.gather_stack = dropped
            try:
                mut = Scheduler(cfg, params, scfg, mesh=mesh).run(
                    RequestQueue(serve_queue(cfg.vocab)))
            finally:
                tp_lib.gather_stack = stack
            for r, v in mut.requests.items():
                arrays[f"{name}/mutant/{r}"] = np.stack(v.logits)
        info["cases"][name] = row
    Path(args.out).mkdir(parents=True, exist_ok=True)
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(info))


def jax_serve_reference(args) -> None:
    """The reference's ``Scheduler(cfg, params, scfg, mesh=mesh)`` of each
    case on an Auto-axis mesh of ``args.mesh`` host devices, its
    parameters placed by ``param_specs`` (the issue's own run of it):
    each request's logits and tokens into jax.npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as Pspec

    from repro.models.sharding import param_specs
    from repro.serve import Request, RequestQueue, Scheduler, ServeConfig

    n = math.prod(args.mesh)
    mesh = jax.make_mesh(tuple(args.mesh), dc.AXES,
                         axis_types=(AxisType.Auto,) * len(dc.AXES),
                         devices=jax.devices()[:n])
    arrays = {}
    for name in args.configs.split(","):
        tp_name, max_len = CASES[name]
        cfg = dc.tp_config(tp_name, jax=True)
        params = jax.tree.map(jnp.asarray, dc.tp_params(tp_name))
        specs = param_specs(cfg, params, mesh)
        params = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, Pspec)))
        scfg = ServeConfig(num_slots=SLOTS, max_len=max_len,
                           prefill_pack=PACK, chunk_len=CHUNK,
                           cache_dtype=jnp.float32, record_logits=True)
        reqs = [Request(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens, arrival=r.arrival)
                for r in serve_queue(cfg.vocab)]
        m = Scheduler(cfg, params, scfg, mesh=mesh).run(RequestQueue(reqs))
        for r, v in m.requests.items():
            arrays[f"{name}/logits/{r}"] = np.stack(
                [np.asarray(x) for x in v.logits])
            arrays[f"{name}/tokens/{r}"] = np.asarray(v.tokens)
    np.savez(Path(args.out) / "jax.npz", **arrays)
