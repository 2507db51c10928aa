"""Build the CUDA sources of ``repro_torch/csrc`` with ``nvcc`` and load
them with ``ctypes``.

Each source is a plain C interface (no PyTorch headers), compiled at first
use for ``sm_90a`` into ``build/repro_torch/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as is.  :func:`build_all` runs one
``nvcc`` per source, all at once; the first :func:`load` of a process runs
it over every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "REPRO_TORCH_BUILD_DIR",
        Path(__file__).resolve().parents[3] / "build" / "repro_torch",
    )
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: seconds the nvcc run took (0.0 when loaded from an earlier
# build) and the compiler's report (-Xptxas -v: registers, shared memory)
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def _target(name: str) -> Path:
    """Path of the library of ``csrc/<name>.cu`` for the current sources."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _nvcc(name: str, out: Path) -> str:
    """One nvcc run for ``csrc/<name>.cu``; returns its report, raises on
    failure."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr
    return proc.stderr


def build_all(names) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for every name without a build of the same
    sources and flags, one ``nvcc`` process per source, all started
    together; returns each library's path."""
    paths = {name: _target(name) for name in names}
    todo = [name for name, out in paths.items() if not out.exists()]
    for name in set(paths) - set(todo):
        BUILD_SECONDS.setdefault(name, 0.0)
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for job in [pool.submit(_nvcc, name, paths[name]) for name in todo]:
                job.result()
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless a build of
    the same sources and flags exists; returns the library's path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``.  A process's first load
    builds every source of ``csrc/`` without a build, in one :func:`build_all`
    pass, so no later kernel's first launch waits on ``nvcc``."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _LIBS:
            build_all(sorted(path.stem for path in CSRC.glob("*.cu")))
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def device_index(device: torch.device) -> int:
    """The CUDA ordinal a kernel launch takes for a ``torch.device``."""
    return device.index if device.index is not None else torch.cuda.current_device()
