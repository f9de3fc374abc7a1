"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles into
shared libraries for ``sm_90a`` (Hopper), one per variant: the default
(int32 models, one pool queue), ``i64`` (int64 models: the same code at
``-DFIXLANE_VAL=int64_t``), and, for ``search.cu``, ``tiles`` and
``tiles_i64`` (the lane-tiled resident search, ``-DSEARCH_LANE_TILES=1``).
A variant is built at its first launch, so a run that never meets an
int64 model or a lane tile never builds those.  Libraries go to
``build/`` at the repository root, named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so the first call in a
fresh checkout builds and every later call (and every later process)
reuses the file; an edited header rebuilds every library.  Nothing here
runs at import time: the build starts on first use, which is the first
launch on a CUDA tensor.
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
# the defines of each library variant
VARIANTS = {"": (), "i64": ("-DFIXLANE_VAL=int64_t",),
            "tiles": ("-DSEARCH_LANE_TILES=1",),
            "tiles_i64": ("-DSEARCH_LANE_TILES=1", "-DFIXLANE_VAL=int64_t")}


def variant(dtype: str, tiles: bool = False) -> str:
    """The library variant for a model of `dtype` ("int32" or "int64"),
    lane-tiled or not."""
    parts = (["tiles"] if tiles else []) + (["i64"] if dtype == "int64"
                                            else [])
    return "_".join(parts)


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


def _flags(variant: str) -> tuple:
    return NVCC_FLAGS + VARIANTS[variant]


def _target(name: str, variant: str = "") -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(variant)).encode())
    stem = f"{name}_{variant}" if variant else name
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(name: str, variant: str = "") -> Built:
    """Build one variant of ``csrc/<name>.cu`` unless its library is on
    disk already."""
    lib = _target(name, variant)
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return Built(name, lib, log.read_text(), 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *_flags(variant), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, lib)              # atomic: a reader sees all or nothing
    return Built(name, lib, proc.stdout, seconds)


def build_all(specs) -> list:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; `specs` are names or (name, variant) pairs.  Returns their
    `Built` records in order."""
    specs = [(s, "") if isinstance(s, str) else tuple(s) for s in specs]
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        return list(pool.map(lambda s: build(*s), specs))


@functools.lru_cache(maxsize=None)
def load(name: str, variant: str = "") -> ctypes.CDLL:
    """The loaded library for a variant of ``csrc/<name>.cu``, built on
    first use."""
    return ctypes.CDLL(str(build(name, variant).path))
