"""The port's prefetching data pipeline (twin of
``tests/test_data_pipeline.py``): determinism and the checkpointable
cursor.

* restart contract — restoring the ``state()`` cursor replays batches
  k, k+1, ... byte-identically to an uninterrupted stream;
* ``Pipeline.state()`` rides the checkpoint tree through the port's
  CheckpointManager and repositions a fresh pipeline;
* the prefetch worker shuts down cleanly (``close()`` while the thread is
  blocked mid-``put`` must not hang or leak the thread);
* ``_batch_at`` is a pure function of (config, step) — identical bytes in a
  separate interpreter process — and each batch equals the reference's.
"""

import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import (DataConfig, Pipeline, _batch_at,
                                       batch_for_step)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several pytest-xdist
    workers on the machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = DataConfig(vocab=64, seq_len=16, global_batch=4, seed=7)


def _digest(batch: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        v = batch[k]
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _pipe(**kw) -> Pipeline:
    return Pipeline(CFG, device="cpu", **kw)


def test_restart_replays_stream_exactly():
    """Consume k batches, snapshot the cursor, keep going; a fresh pipeline
    restored from the snapshot yields byte-identical batches k, k+1, ..."""
    pipe = _pipe()
    try:
        for _ in range(3):
            next(pipe)
        snap = pipe.state()
        want = [_digest(next(pipe)) for _ in range(5)]
    finally:
        pipe.close()

    fresh = _pipe()
    try:
        next(fresh)                      # arbitrary position before restore
        fresh.restore(snap)
        got = [_digest(next(fresh)) for _ in range(5)]
    finally:
        fresh.close()
    assert got == want


def test_state_is_cursor_of_next_batch():
    pipe = _pipe()
    try:
        assert int(pipe.state()["data_step"]) == 0
        assert pipe.state()["data_step"].dtype == np.int64
        for i in range(4):
            batch = next(pipe)
            assert batch["tokens"].dtype == torch.int32
            assert torch.equal(batch["tokens"],
                               batch_for_step(CFG, i, device="cpu")["tokens"])
        assert int(pipe.state()["data_step"]) == 4
    finally:
        pipe.close()


def test_state_roundtrips_through_checkpoint_manager(tmp_path):
    """The cursor rides the checkpoint tree: save state(), restore into a
    fresh pipeline, stream continues from the saved position."""
    pipe = _pipe()
    try:
        for _ in range(5):
            next(pipe)
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(5, {"data": pipe.state()})
    finally:
        pipe.close()

    fresh = _pipe()
    try:
        fresh.restore(mgr.restore(device="cpu")["data"])
        assert torch.equal(next(fresh)["tokens"],
                           batch_for_step(CFG, 5, device="cpu")["tokens"])
    finally:
        fresh.close()


def test_close_mid_put_shuts_worker_down():
    """With nothing consuming, the worker blocks on a full queue; close()
    must unblock it and join within the timeout (no leaked thread)."""
    pipe = _pipe(prefetch=1)
    deadline = time.monotonic() + 5.0
    while not pipe._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)                 # let the worker fill the queue
    assert pipe._q.full()
    pipe.close()
    assert not pipe._thread.is_alive()


def test_seek_discards_prefetched_batches():
    pipe = _pipe(prefetch=2)
    try:
        next(pipe)                       # worker now prefetching steps 1, 2
        pipe.seek(10)
        assert torch.equal(next(pipe)["tokens"],
                           batch_for_step(CFG, 10, device="cpu")["tokens"])
        assert int(pipe.state()["data_step"]) == 11
    finally:
        pipe.close()


def test_batch_at_pure_across_processes():
    """_batch_at must not depend on interpreter state (hash seeds, import
    order): a fresh process produces identical bytes for the same cursor."""
    steps = [0, 3, 11]
    want = {s: _digest(_batch_at(CFG, s)) for s in steps}
    prog = (
        "import hashlib, json\n"
        "import numpy as np\n"
        "from repro_torch.data.pipeline import DataConfig, _batch_at\n"
        f"cfg = DataConfig(vocab={CFG.vocab}, seq_len={CFG.seq_len}, "
        f"global_batch={CFG.global_batch}, seed={CFG.seed})\n"
        "def digest(b):\n"
        "    h = hashlib.sha256()\n"
        "    for k in sorted(b):\n"
        "        h.update(k.encode())\n"
        "        h.update(np.ascontiguousarray(np.asarray(b[k])).tobytes())\n"
        "    return h.hexdigest()\n"
        f"print(json.dumps({{s: digest(_batch_at(cfg, s)) for s in {steps}}}))\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": "src",
                                                      "PATH": "/usr/bin:/bin",
                                                      "HOME": "/tmp"},
                         cwd=str(pathlib.Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    got = {int(k): v for k, v in json.loads(out.stdout).items()}
    assert got == want


def test_stream_equals_reference_stream():
    """The port's stream yields the reference's batches byte for byte."""
    pytest.importorskip("jax")
    from repro.data.pipeline import Pipeline as JPipeline
    ref = JPipeline(CFG, start_step=2)
    pipe = Pipeline(CFG, start_step=2, device="cpu")
    try:
        for _ in range(4):
            assert _digest(next(pipe)) == _digest(
                {k: np.asarray(v) for k, v in next(ref).items()})
        assert int(pipe.state()["data_step"]) == \
            int(np.asarray(ref.state()["data_step"])) == 6
    finally:
        pipe.close()
        ref.close()
