"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (pointers and the stream pass as ``c_void_p``) and
loaded with ``ctypes``.  Libraries land in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing is compiled at import time: the first kernel launch builds what it
needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gram_syrk", "symmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default prefix ``/usr/local/cuda``; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: Optional[str] = None) -> str:
    """Hash of the headers, ``<name>.cu`` (every source when ``name`` is
    None) and the flags."""
    sources = sorted(CSRC.glob("*.cu")) if name is None else [CSRC / f"{name}.cu"]
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def sources_digest() -> str:
    """Hash of every kernel source and the flags: changes whenever any
    library would rebuild."""
    return _digest()


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest(name)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    built (0.0 for one already up to date).  ``nvcc``'s ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside each library as
    ``<name>-<hash>.log``."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    nvcc = find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        lib = library_path(n)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib)
    failed = []
    for n, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
