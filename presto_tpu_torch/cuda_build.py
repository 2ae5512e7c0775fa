"""Build the package's hand-written CUDA kernels and load them with ctypes.

Every source under csrc/ has a plain C interface. `nvcc` compiles each one
for sm_90a into a shared library under `_build/` (listed in .gitignore),
named by a hash of the source so an edited kernel is rebuilt; the build
happens at first use, or ahead of time through `build_all()`, which starts
one `nvcc` per source at once. Nothing here runs at import: the CPU tests
import every module on machines without `nvcc`.
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
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# kernel library name -> source file under csrc/
KERNEL_SOURCES = {
    "groupby_partials": "groupby_partials.cu",
    "join_insert": "join_insert.cu",
    "join_probe": "join_probe.cu",
    "q1_partials": "q1_partials.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def _library_path(name: str) -> Path:
    src = CSRC / KERNEL_SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _nvcc_command(name: str, out: Path):
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
        str(CSRC / KERNEL_SOURCES[name]),
    ]


def _start_build(name: str):
    """Start nvcc for one library; returns (process, tmp path, final path)
    or None when the library is already built."""
    path = _library_path(name)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        _nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, path, time.perf_counter()


def _finish_build(name: str, started) -> str:
    """Wait for one nvcc; the build's wall from its start goes into the
    kernel profile as one compile of the library."""
    from .obs.kernelprof import KERNEL_PROFILE

    proc, tmp, path, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, path)
    KERNEL_PROFILE.record_compile(name, time.perf_counter() - t0)
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started
    together. Returns {name: compiler output} ('' when already built)."""
    started = {name: _start_build(name) for name in KERNEL_SOURCES}
    logs = {}
    for name, st in started.items():
        logs[name] = "" if st is None else _finish_build(name, st)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed. The load (and
    the build, when there is one) each count as a compile in the kernel
    profile."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            st = _start_build(name)
            if st is not None:
                _finish_build(name, st)
            from .obs.kernelprof import KERNEL_PROFILE

            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_library_path(name)))
            KERNEL_PROFILE.record_compile(name, time.perf_counter() - t0)
            _LIBS[name] = lib
    return lib
