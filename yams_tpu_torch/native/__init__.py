"""The port's native host libraries (C++, built with g++ on first use).

Copied from yams_tpu/native/__init__.py, with the sources copied under
`native/src/`, and split in two so that each builds where it can:

  - the sketch library, from `yams_native.cpp` alone: the gear table,
    FastCDC boundaries and the batched n-gram sketch
    (`ytn_sketch_batch`). It needs only a C++ compiler.
  - the ingest library, from `yams_native.cpp` + `ingest_pipeline.cpp`: one
    pass of FastCDC, SHA-256 and zstd over a payload. It links the system
    zstd and needs `<zstd.h>`.

Both build into `yams_tpu_torch/_build/` under a name that carries a hash of
their sources, their flags and the host CPU's model (the build targets
`-march=native`), so an edited source, or a tree copied to another
machine, builds anew. A library that
does not build (no compiler, no zstd) is None, and its callers take their
Python route, as the reference's host tiers do. YAMS_TPU_NO_NATIVE=1 turns
both off. This is host code: no device kernel lives here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "src"
_BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-funroll-loops")

_P = ctypes.POINTER
_u64, _u32, _u8 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint8
_size = ctypes.c_size_t

# name -> (sources, link flags, {symbol: (restype, argtypes)})
_LIBS = {
    "sketch": (("yams_native.cpp",), (), {
        "ytn_abi_version": (ctypes.c_int, []),
        "ytn_fastcdc": (_size, [ctypes.c_char_p, _size, _size, _size, _size,
                                _P(_u64), _size]),
        "ytn_gear_table": (None, [_P(_u32)]),
        "ytn_sketch_batch": (_size, [ctypes.c_char_p, _P(_u64), _size, _u32, _u32,
                                     _P(_u32), _size, _P(_u32), _size,
                                     _P(ctypes.c_float), _P(_u8)]),
    }),
    "ingest": (("yams_native.cpp", "ingest_pipeline.cpp"), ("-lzstd", "-lpthread"), {
        "ytn_abi_version": (ctypes.c_int, []),
        "ytn_sha256": (None, [ctypes.c_char_p, _size, _P(_u8)]),
        "ytn_ingest_pipeline": (_size, [ctypes.c_char_p, _size, _size, _size, _size,
                                        ctypes.c_int, ctypes.c_int, _P(_u64), _P(_u8),
                                        _P(_u8), _size, _P(_u64), _P(_u64), _size]),
    }),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL | None] = {}


def _cpu_model() -> str:
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("model name", "flags")):
                return line
    except OSError:
        pass
    return platform.processor()


def library_path(name: str) -> pathlib.Path:
    sources, link, _ = _LIBS[name]
    h = hashlib.sha256(" ".join((*_FLAGS, *link, platform.machine(), _cpu_model())).encode())
    for src in sources:
        h.update((_SRC / src).read_bytes())
    return _BUILD_DIR / f"libyams_torch_{name}_{h.hexdigest()[:16]}.so"


def _build(name: str) -> pathlib.Path | None:
    out = library_path(name)
    if out.exists():
        return out
    sources, link, _ = _LIBS[name]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, *[str(_SRC / s) for s in sources], *link, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None


def _load(name: str) -> ctypes.CDLL | None:
    with _lock:
        if name in _loaded:
            return _loaded[name]
        lib = None
        path = None if os.environ.get("YAMS_TPU_NO_NATIVE") else _build(name)
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            for sym, (restype, argtypes) in _LIBS[name][2].items():
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = argtypes
            if lib.ytn_abi_version() != 1:
                lib = None
        _loaded[name] = lib
        return lib


def sketch_library() -> ctypes.CDLL | None:
    """The sketch/FastCDC library, built on first call; None if it cannot be."""
    return _load("sketch")


def ingest_library() -> ctypes.CDLL | None:
    """The zstd ingest-pipeline library, built on first call; None if it cannot be."""
    return _load("ingest")


def fastcdc_boundaries(
    data: bytes, min_size: int, avg_size: int, max_size: int
) -> list[int] | None:
    """Chunk end-offsets via the native FastCDC, or None if unavailable."""
    lib = sketch_library()
    if lib is None:
        return None
    cap = max(2, len(data) // max(1, min_size) + 2)
    out = (ctypes.c_uint64 * cap)()
    n = lib.ytn_fastcdc(data, len(data), min_size, avg_size, max_size, out, cap)
    if n > cap:  # shouldn't happen given cap bound, but be safe
        out = (ctypes.c_uint64 * n)()
        n = lib.ytn_fastcdc(data, len(data), min_size, avg_size, max_size, out, n)
    return [int(out[i]) for i in range(n)]


def sketch_batch(
    texts: list[str], sketch_dim: int, max_tokens: int,
    word_ngrams: tuple[int, ...], char_ngrams: tuple[int, ...],
):
    """Raw signed bucket counts for a batch of docs via the C++ sketch.

    Returns (counts (B, S) float32, ok (B,) uint8) or None when the sketch
    library is missing. ok[i]==0 marks a non-ASCII doc the caller must
    sketch through the Python path; its counts row is zeroed.
    """
    lib = sketch_library()
    if lib is None or not texts:
        return None
    import numpy as np

    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum([len(b) for b in blobs], dtype=np.uint64)
    data = b"".join(blobs)
    counts = np.empty((len(blobs), sketch_dim), dtype=np.float32)
    ok = np.empty(len(blobs), dtype=np.uint8)
    wn = (ctypes.c_uint32 * len(word_ngrams))(*word_ngrams)
    cn = (ctypes.c_uint32 * len(char_ngrams))(*char_ngrams)
    lib.ytn_sketch_batch(
        data, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(blobs), sketch_dim, max_tokens, wn, len(word_ngrams),
        cn, len(char_ngrams),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return counts, ok


def ingest_pipeline(
    data: bytes, min_size: int, avg_size: int, max_size: int,
    level: int = 3, threads: int = 0,
) -> list[tuple[str, int, int, bytes]] | None:
    """Full native ingest pass: [(sha256_hex, start, end, zstd_bytes)].

    level=0 skips compression (empty bytes); negative levels select zstd
    fast mode (the hot ingest tier). None when the ingest library is missing.
    """
    lib = ingest_library()
    if lib is None:
        return None
    n = len(data)
    max_chunks = max(2, n // max(1, min_size) + 2)
    boundaries = (ctypes.c_uint64 * max_chunks)()
    hashes = (ctypes.c_uint8 * (32 * max_chunks))()
    comp_cap = int(n * 1.05) + max_chunks * 1024 if level != 0 else 1
    comp_out = (ctypes.c_uint8 * comp_cap)()
    comp_offsets = (ctypes.c_uint64 * max_chunks)()
    comp_sizes = (ctypes.c_uint64 * max_chunks)()
    count = lib.ytn_ingest_pipeline(
        data, n, min_size, avg_size, max_size, level, threads,
        boundaries, hashes, comp_out, comp_cap, comp_offsets, comp_sizes,
        max_chunks,
    )
    if count == 0 and n > 0:
        return None
    out = []
    start = 0
    raw = bytes(hashes[: 32 * count])
    # per-chunk string_at copies exactly comp_sizes[i] bytes
    base = ctypes.addressof(comp_out)
    for i in range(count):
        end = int(boundaries[i])
        digest = raw[32 * i : 32 * i + 32].hex()
        blob = (ctypes.string_at(base + int(comp_offsets[i]),
                                 int(comp_sizes[i]))
                if level != 0 else b"")
        out.append((digest, start, end, blob))
        start = end
    return out
