"""Host-side native code of the port: the LZ4 block codec of the page wire
(torch counterpart of presto_tpu/native/).

`lz4.cpp` is this package's own copy of the JAX package's codec (the role
of airlift's aircompressor LZ4 in the reference's PagesSerde). At first
use `g++` builds it into `_build/` (listed in .gitignore), named by a hash
of the source and the flags as cuda_build.py names the CUDA kernels, so an
edited source is rebuilt and nothing is ever written next to the source.
A failed build or load raises at the LZ4 call that needed it: a process
without a toolchain advertises no lz4 (`available()` is False, and
negotiation then routes its peers around the codec), but a frame that
asks for lz4 is never decoded some other way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "lz4.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeCodecError(RuntimeError):
    """The LZ4 library could not be built or loaded."""


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libptpu_lz4-{digest[:12]}.so"


def _build(path: Path) -> None:
    # compile to a per-process temp file and rename atomically: concurrent
    # processes never load a half-written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for fn in (lib.ptpu_lz4_compress, lib.ptpu_lz4_decompress):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.CalledProcessError, AttributeError) as e:
            detail = getattr(e, "stderr", "") or ""
            _build_error = f"{type(e).__name__}: {e} {detail}".strip()
    return _lib


def available() -> bool:
    """Can this process run the codec (built and loaded)?"""
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeCodecError(f"the LZ4 codec could not be built or loaded: {_build_error}")
    return lib


def lz4_compress(data: bytes) -> bytes:
    """LZ4 block-format compress."""
    lib = _require()
    n = len(data)
    cap = n + n // 128 + 64  # worst case: tokens and length extensions
    dst = (ctypes.c_uint8 * cap)()
    out = lib.ptpu_lz4_compress(data, n, dst, cap)
    if out < 0:
        raise NativeCodecError("lz4 compress overflow")
    return ctypes.string_at(dst, out)


def lz4_decompress(data: bytes, original_size: int) -> bytes:
    """Decode one LZ4 block of `original_size` bytes; a block that does not
    inflate to exactly that size raises ValueError."""
    lib = _require()
    dst = (ctypes.c_uint8 * max(original_size, 1))()
    out = lib.ptpu_lz4_decompress(data, len(data), dst, original_size)
    if out != original_size:
        raise ValueError(f"lz4 decompress: got {out}, expected {original_size}")
    return ctypes.string_at(dst, original_size)
