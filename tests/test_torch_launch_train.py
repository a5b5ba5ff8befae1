"""The port's training launcher (``python -m repro_torch.launch.train``,
twin of ``repro.launch.train``) on the CPU, in subprocesses: 2 steps with a
checkpoint, then ``--resume`` to 4, against 4 steps straight — the final
loss_ema and every parameter's float64 sum bitwise equal.  ``--mesh`` on
two gloo ranks (the environment a ``torch.distributed`` launch sets):
the ranks agree, and their checkpoint resumes in one process at another
owner count.  And ``--mesh`` outside such a launch refuses to start."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--reduced", "--device", "cpu", "--strategy", "greedy", "--batch",
        "4", "--seq", "16", "--owners", "2"]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **extra)


def _launch(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE, *args],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)


def _result(out) -> dict:
    assert out.returncode == 0, out.stderr[-4000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[result] "), out.stdout[-2000:]
    return json.loads(line[len("[result] "):])


def test_resume_continues_bitwise(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _result(_launch(tmp_path, "--steps", "2", "--ckpt-dir", ckpt,
                            "--ckpt-every", "2"))
    assert first["steps"] == 2 and first["executed_steps"] == 2
    resumed = _launch(tmp_path, "--steps", "4", "--ckpt-dir", ckpt,
                      "--ckpt-every", "2", "--resume")
    assert "[resume] step 2" in resumed.stdout
    second = _result(resumed)
    assert second["executed_steps"] == 2
    straight = _result(_launch(tmp_path, "--steps", "4"))
    assert straight["executed_steps"] == 4
    assert second["loss_ema"] == straight["loss_ema"]
    assert second["param_sums"] == straight["param_sums"]
    assert second["param_sums"] != first["param_sums"]


def test_mesh_needs_a_distributed_launch(tmp_path):
    out = _launch(tmp_path, "--steps", "1", "--mesh")
    assert out.returncode != 0
    assert "torch.distributed launch" in out.stderr


def test_mesh_ranks_agree_and_resume_elsewhere(tmp_path):
    from repro_torch.launch.mesh import free_port
    ckpt = str(tmp_path / "ckpt")
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE, "--mesh",
         "--steps", "2", "--ckpt-dir", ckpt, "--ckpt-every", "2"],
        env=_env(RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="localhost",
                 MASTER_PORT=port),
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                    out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    ranks = [_result(o) for o in outs]
    assert ranks[0] == ranks[1] and ranks[0]["executed_steps"] == 2
    resumed = _launch(tmp_path, "--steps", "3", "--ckpt-dir", ckpt,
                      "--ckpt-every", "2", "--resume")
    assert "[resume] step 2" in resumed.stdout
    assert _result(resumed)["executed_steps"] == 1
