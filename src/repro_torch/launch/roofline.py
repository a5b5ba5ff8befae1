"""Roofline analysis of a dry-run cell (port of ``repro.launch.roofline``,
``src/repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds per card:

    compute    = Σ_dtype FLOPs[dtype] / PEAK_FLOPS[dtype]
    memory     = bytes accessed       / HBM_BW
    collective = collective bytes     / NET_BW

from the H100 constants of ``launch/mesh.py``.  The costs come from
``launch/op_walker.py``, which sees every op of one eager step; the fp32
model path divides by the FFMA peak, since ``device.strict_fp32`` turns
TF32 off.

Kernel adjustment: the dry run traces the plain Gram NS path (its tensors
are fake CPU tensors, so every kernel wrapper takes its plain version), and
the compute term counts full GEMMs for the symmetric products.  The Hopper
kernels compute the lower tiles only, ~half of that; the kernel-adjusted
term uses the analytic model of ``core/gram_ns.py``, as the reference's.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS
from repro_torch.launch.op_walker import Costs, OpWalker


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """Per-kind collective operand bytes of one call of ``fn``, and their
    ``total`` (the reference's reads them from HLO text;
    ``src/repro/launch/roofline.py:52``)."""
    with OpWalker() as w:
        fn(*args, **kwargs)
    out: Dict[str, int] = {k: int(v) for k, v in w.costs.coll.items()}
    out["total"] = int(w.costs.coll_total)
    return out


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Σ over dtypes of FLOPs / that dtype's peak (the fp32 peak for a
    dtype without its own)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, f in flops_by_dtype.items())


@dataclass
class Roofline:
    """``src/repro/launch/roofline.py:61``, per card."""
    flops: float                   # per-device FLOPs
    hbm_bytes: float               # per-device bytes accessed
    coll_bytes: float              # per-device collective operand bytes
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0       # 6·N·D (dense) or 6·N_active·D
    useful_ratio: float = 0.0      # MODEL_FLOPS / FLOPs
    kernel_adjusted_compute_s: Optional[float] = None
    detail: dict = field(default_factory=dict)

    def finalize(self):
        by_dtype = self.detail.get("flops_by_dtype") or {
            "float32": self.flops}
        self.compute_s = compute_seconds(by_dtype)
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = self.coll_bytes / NET_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        if self.flops:
            self.useful_ratio = self.model_flops / self.flops
        return self

    def to_dict(self):
        return asdict(self)


def analyze(costs: Costs, *, num_devices: int, model_flops: float = 0.0,
            ns_flops_raw: float = 0.0, ns_flops_kernel: float = 0.0,
            ns_dtype: str = "float32") -> Roofline:
    """The three-term roofline of one step's walked ``costs`` (per card).
    ``ns_flops_raw`` / ``ns_flops_kernel``: per-card NS GEMM FLOPs as
    traced (full) vs as the symmetric kernels execute them, in
    ``ns_dtype``; the compute term is reported both ways
    (``src/repro/launch/roofline.py:94``)."""
    coll = dict(costs.coll)
    coll["total"] = costs.coll_total
    r = Roofline(flops=costs.flops, hbm_bytes=costs.bytes,
                 coll_bytes=float(coll["total"]), model_flops=model_flops,
                 detail={"collectives": coll, "num_devices": num_devices,
                         "flops_by_dtype": dict(costs.flops_by_dtype)})
    r.finalize()
    if ns_flops_raw and ns_flops_kernel and costs.flops > ns_flops_raw:
        adj = dict(costs.flops_by_dtype)
        adj[ns_dtype] = adj.get(ns_dtype, 0.0) - (ns_flops_raw
                                                  - ns_flops_kernel)
        r.kernel_adjusted_compute_s = compute_seconds(adj)
    return r


def memory_analysis_dict(walker: OpWalker, outputs=None) -> dict:
    """The reference's memory keys (``src/repro/launch/roofline.py:128``)
    from a walker's storage tracking; ``total_bytes`` is the peak."""
    return walker.memory(outputs)
