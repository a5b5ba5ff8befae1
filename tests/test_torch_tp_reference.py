"""The port's tensor-parallel train step against the reference's sharded
step (``src/repro/train/step.py``: parameters placed by ``param_specs``,
``make_train_step(..., grad_specs=...)``) on an Auto-axis mesh of the same
shape, from the same numpy parameters on the same batches
(``tests/torch_dist_check.py tp --train-only`` and ``jax_tp``), after 3
Muon steps: loss_ema at every step and every parameter within 1e-4.

Six (mesh, config) pairs, across the head-parallel, KV-gathered and
sequence-sharded layouts, with and without a vocab split: (1, 2) with each
of the three configs, (2, 2) with the vocab-256 qwen, (1, 4) with the
vocab-256 qwen (its 2 KV heads gathered) and the 3-head smollm.  One
reference process per mesh shape (a reference step compiles in 7-10 s on
the CPU); the three run beside the port's worlds.
"""

import concurrent.futures
import math

import numpy as np
import pytest
import torch

import torch_dist_check as dc

PAIRS = {(1, 2): ("qwen256", "smollm3h", "qwen257"),
         (2, 2): ("qwen256",),
         (1, 4): ("qwen256", "smollm3h")}
CASES = [(m, c) for m, cs in PAIRS.items() for c in cs]
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    out = {m: (tmp_path_factory.mktemp(f"port_{m[0]}x{m[1]}"),
               tmp_path_factory.mktemp(f"jax_{m[0]}x{m[1]}")) for m in PAIRS}
    with concurrent.futures.ThreadPoolExecutor(2 * len(PAIRS)) as pool:
        jobs = [pool.submit(dc.run_jax, m, out[m][1], 240.0, "jax_tp",
                            ("--configs", ",".join(cs)))
                for m, cs in PAIRS.items()]
        jobs += [pool.submit(dc.launch, "tp", math.prod(m), m, out[m][0],
                             240.0, ("--configs", ",".join(cs),
                                     "--train-only"))
                 for m, cs in PAIRS.items()]
        for j in jobs:
            j.result()
    return {m: (dc.load(out[m][0], math.prod(m)),
                dict(np.load(out[m][1] / "jax.npz"))) for m in PAIRS}


@pytest.mark.parametrize("mesh,name", CASES,
                         ids=[f"{m[0]}x{m[1]}-{c}" for m, c in CASES])
def test_matches_reference_sharded_step(runs, mesh, name):
    port, ref = runs[mesh]
    ema = port["json"][0]["configs"][name]["ema"]
    np.testing.assert_allclose(ema, ref[f"{name}/ema"], rtol=0, atol=ATOL,
                               err_msg="loss_ema")
    z = port["npz"][0]
    prefix = f"{name}/params/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(k for k in z
                                           if k.startswith(prefix))
    for k in keys:
        np.testing.assert_allclose(z[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)
