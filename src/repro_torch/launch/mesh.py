"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, e.g. ``("data", "model")``.  The backend follows the device
type the caller names: NCCL for ``"cuda"``, gloo for ``"cpu"``; nothing is
chosen by what the machine happens to have.  Nothing here tells a program
of a cluster: the caller gives the rendezvous address, the world size and
its rank.

``make_production_mesh`` keeps the reference's production meshes (256 or
512 cards), so that a dry-run cell means the same in both packages; the
roofline constants below are the H100's, in place of the reference's v5e
ones (``src/repro/launch/mesh.py:19-23``).
"""

from __future__ import annotations

import datetime
import math
import socket
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# NVIDIA H100 SXM5 80GB hardware constants (roofline denominators), from
# NVIDIA's H100 Tensor Core GPU datasheet: dense rates, no sparsity, at the
# full 700 W power limit.  The fp32 model path runs with TF32 off
# (``device.strict_fp32``), so its matmuls run at the FFMA rate.
PEAK_FLOPS = {"bfloat16": 989e12,      # bf16 tensor cores
              "tf32": 495e12,          # TF32 tensor cores
              "float32": 67e12,        # fp32 FFMA outside the tensor cores
              "float64": 34e12}        # fp64 outside the tensor cores
HBM_BW = 3.35e12                       # bytes/s per card (HBM3)
HBM_BYTES = 80 * 10**9                 # per-card HBM capacity (80 GB)
# One 400 Gb/s ConnectX-7 NDR NIC per card, as in DGX H100 (8 cards a node
# on NVLink, 8 NICs a node).  On the (16, 16) and (2, 16, 16) meshes every
# axis spans more than one node of 8, so every collective crosses the NICs:
# 50 GB/s a card, not NVLink's 450.
NET_BW = 50e9                          # bytes/s per card


def free_port() -> int:
    """A free TCP port on localhost, for ``tcp://localhost:<port>``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device_type: str, *, rank: int, world_size: int,
                       init_method: str,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the default process group with the backend of ``device_type``.

    On ``"cuda"`` rank ``r`` takes card ``r`` of this host (one process per
    card: NCCL refuses two ranks on one card).  ``timeout`` bounds every
    collective, so a rank that hangs fails instead of blocking forever."""
    backend = BACKENDS[device_type]
    if device_type == "cuda":
        if rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} has no card of its own "
                             f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    default process group, which must already run the backend of
    ``device_type`` (``init_process_group``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group first")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"a {device_type!r} mesh needs the "
                         f"{BACKENDS[device_type]!r} backend, the process "
                         f"group runs {backend!r}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False) -> DeviceMesh:
    """16 × 16 = 256 cards as ("data", "model"); 2 × 16 × 16 = 512 as
    ("pod", "data", "model") (the reference's
    ``src/repro/launch/mesh.py:12``), over the default process group,
    which the caller has started with that many ranks (the dry run: the
    "fake" backend).  The device type follows the backend: NCCL meshes
    are CUDA meshes, any other a CPU one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one of "
                           f"{math.prod(shape)} ranks first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
