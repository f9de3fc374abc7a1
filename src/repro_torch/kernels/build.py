"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles into its
own shared library for ``sm_90a`` (Hopper).  Libraries go to ``build/``
at the repository root, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so the first call in a fresh
checkout builds and every later call (and every later process) reuses
the file; an edited header rebuilds every library.  Nothing here runs at import time:
the build starts on first use, which is the first launch on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """One built library: its path, the compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills), and the build's wall time
    (0 when the library was already on disk)."""
    name: str
    path: Path
    log: str
    seconds: float


def nvcc() -> str:
    """Path of ``nvcc``: on the PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` unless its library is on disk already."""
    lib = _target(name)
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return Built(name, lib, log.read_text(), 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, lib)              # atomic: a reader sees all or nothing
    return Built(name, lib, proc.stdout, seconds)


def build_all(names) -> list:
    """Build several sources at once, one ``nvcc`` each, all started
    together; returns their `Built` records in order."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))
