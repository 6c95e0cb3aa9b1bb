"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles every source in `csrc/` for sm_90a (Hopper), one process per
source, all started together, and links the objects into one shared library
with a plain C interface, at first use, into `_build/` beside this file.
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
          "-Xcompiler", "-fPIC")

# (name, argtypes): every entry point returns int (a cudaError_t)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "yt_gear_hash": (_P, _P, _I64, _P),
    "yt_sha256_rows": (_P, _P, _P, _P, _I64, _P),
    "yt_exact_topk": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
    "yt_pq4_adc": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "yt_grouped_max": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "yt_windowed_scan": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources(src_dir: pathlib.Path) -> list[pathlib.Path]:
    return sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(src_dir: pathlib.Path = _SRC_DIR) -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libyams_tpu_torch_{h.hexdigest()[:16]}.so"


def build(src_dir: pathlib.Path = _SRC_DIR) -> pathlib.Path:
    """Compile src_dir/*.cu (by default csrc/) unless the hashed library
    already exists: one nvcc per source, in parallel, then one link."""
    out = library_path(src_dir)
    if out.exists():
        return out
    tmp_dir = _BUILD_DIR / f"obj.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    procs: list[subprocess.Popen] = []
    try:
        nvcc = _nvcc()
        sources = [src for src in _sources(src_dir) if src.suffix == ".cu"]
        objs = [str(tmp_dir / f"{src.stem}.o") for src in sources]
        compiles = [[nvcc, *_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} -> {proc.returncode}\n{stdout}\n{stderr}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), *objs]
            proc = subprocess.run(link, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                failed.append(f"{' '.join(link)} -> {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)
    finally:
        for proc in procs:          # none is left running, whatever raised
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def load(path: pathlib.Path) -> ctypes.CDLL:
    """A built kernel library with its entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_aligned(what: str, **tensors) -> None:
    """Raise ValueError unless every tensor starts on a 16-byte boundary, as
    a TMA copy's global base must (csrc/bf16_scan.cuh)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} starts {t.data_ptr() % 16} bytes past a "
                             f"16-byte boundary; TMA needs 16-byte-aligned bases")
