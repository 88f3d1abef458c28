"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is one shared library with a plain C interface.
The first :func:`load` of a process compiles every source that has no
up-to-date library yet — one ``nvcc`` per source, all started together —
into ``_build/`` beside this module (listed in ``.gitignore``).  A library's
file name carries a hash of its source, the shared headers (``csrc/*.cuh``)
and the compiler flags, so an edited source or header is rebuilt and an
unchanged one is reused.  Nothing is built when the
module is imported: the CPU test suite imports it on machines without
``nvcc``.

:data:`events` counts what the process spent making kernels ready — the
port's counterpart of JAX's compiles: ``builds`` (``nvcc`` runs), ``loads``
(libraries opened by :func:`load`) and ``seconds`` (wall time of the
:func:`load` and :func:`build_all` calls that built or opened a library,
builds included, each counted once).  Every such call also calls each
function in :data:`listeners` with ``(builds, loads, seconds)``:
``repro_torch.obs.kernelhooks`` listens there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "BuildResult", "events",
           "listeners", "find_nvcc", "build_all", "load"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
# sm_90a (not sm_90): the arch-specific Hopper target; -Xptxas -v records
# each kernel's registers, shared memory and spills in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
events = {"builds": 0, "loads": 0, "seconds": 0.0}
listeners: list = []
_local = threading.local()      # .in_load: build_all runs inside load


def _record(builds: int, loads: int, seconds: float) -> None:
    """Count the seconds of one call that built ``builds`` and opened
    ``loads`` libraries, and tell the listeners."""
    events["seconds"] += seconds
    for fn in listeners:
        fn(builds, loads, seconds)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """One source's library: where it is, how long ``nvcc`` took (0.0 when
    an up-to-date library was reused) and the compiler's log."""

    name: str
    path: Path
    seconds: float
    log: str


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit
    PyTorch located; None when there is none (a CPU-only machine)."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").is_file():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").is_file():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    return None


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> list[BuildResult]:
    """Compile every source whose library is missing, all in parallel.
    Raises RuntimeError with the compiler's output if one fails."""
    t0 = time.perf_counter()
    results, built = _build_all()
    if built and not getattr(_local, "in_load", False):
        _record(built, 0, time.perf_counter() - t0)
    return results


def _build_all() -> tuple[list[BuildResult], int]:
    """:func:`build_all`'s work → (results, libraries built)."""
    srcs = sorted(CSRC.glob("*.cu"))
    todo = [(s, _lib_path(s)) for s in srcs]
    results = [BuildResult(s.stem, p, 0.0, p.with_suffix(".log").read_text())
               for s, p in todo if p.is_file()]
    todo = [(s, p) for s, p in todo if not p.is_file()]
    if not todo:
        return results, 0
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, path in todo:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        procs.append((src, path, tmp, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, path, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)   # atomic: a reader never sees half a library
        events["builds"] += 1
        results.append(BuildResult(src.stem, path, seconds, log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results, len(todo)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use, with every other source that needs it)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            before = events["builds"]
            _local.in_load = True
            try:
                paths = {r.name: r.path for r in build_all()}
            finally:
                _local.in_load = False
            if name not in paths:
                raise ValueError(f"no kernel source csrc/{name}.cu")
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
            events["loads"] += 1
            _record(events["builds"] - before, 1, time.perf_counter() - t0)
        return lib
