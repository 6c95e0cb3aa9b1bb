"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles every source in `csrc/` into one shared library with a plain C
interface for sm_90a (Hopper), at first use, into `_build/` beside this file.
The file name carries a hash of the sources and flags, so an edited kernel
builds anew and a stale library is never loaded. The library is bound with
ctypes: every pointer and the stream pass as c_void_p, counts as c_int64, and
each entry point returns cudaGetLastError() as an int, which `check` turns
into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_HERE = pathlib.Path(__file__).parent
_SRC_DIR = _HERE / "csrc"
_BUILD_DIR = _HERE / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

# (name, argtypes): every entry point returns int (a cudaError_t)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "yt_gear_hash": (_P, _P, _I64, _P),
    "yt_sha256_rows": (_P, _P, _P, _P, _I64, _P),
    "yt_exact_topk": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
    "yt_pq4_adc": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libyams_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
