"""The port's native host libraries (C++, built with g++ on first use).

Copied from yams_tpu/native/__init__.py, with the sources copied under
`native/src/` and `native/include/`, and split in three so that each builds
where it can:

  - the sketch library, from `yams_native.cpp` alone: the gear table,
    FastCDC boundaries, the batched n-gram sketch (`ytn_sketch_batch`) and
    the literal substring scan of `grep` (`ytn_find_all`). It needs only a C++ compiler.
  - the ingest library, from `yams_native.cpp` + `ingest_pipeline.cpp`: one
    pass of FastCDC, SHA-256 and zstd over a payload. It links the system
    zstd and needs `<zstd.h>`.
  - the mobile library, from `yams_native.cpp` (its `ytn_crc32`) +
    `yams_mobile.cpp`: the `yams_mobile_*` C ABI of
    `native/include/yams_mobile.h`, which speaks the daemon's framed protocol
    in JSON mode. It needs only a C++ compiler. `mobile_library()` binds the
    signatures of `native/mobile_abi.py`.

All three build into `yams_tpu_torch/_build/` under a name that carries a hash of
their sources, their flags and the host CPU's model (the build targets
`-march=native`), so an edited source, or a tree copied to another
machine, builds anew. A sketch or ingest library that
does not build (no compiler, no zstd) is None, and its callers take their
Python route, as the reference's host tiers do; the mobile library has no
Python route, so a failed build raises with the compiler's message.
YAMS_TPU_NO_NATIVE=1 turns all three off (the mobile one then raises).

An explicit library replaces a build, as YAMS_TPU_NATIVE_LIB does for the
reference's one library: YAMS_TPU_TORCH_SKETCH_LIB, YAMS_TPU_TORCH_INGEST_LIB
and YAMS_TPU_TORCH_MOBILE_LIB name a file to load instead (a sanitizer build
of `native/build_sanitized.sh`, say); one that does not load raises. This is
host code: no device kernel lives here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

from .mobile_abi import SIGNATURES as _MOBILE_SIGNATURES

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
        "ytn_find_all": (_size, [ctypes.c_char_p, _size, ctypes.c_char_p, _size,
                                 _P(_u64), _size]),
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
    "mobile": (("yams_native.cpp", "yams_mobile.cpp"), (), _MOBILE_SIGNATURES),
}
_REQUIRED = ("mobile",)    # no Python route: a failed build raises

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
    if name == "mobile":
        h.update((_HERE / "include" / "yams_mobile.h").read_bytes())
    return _BUILD_DIR / f"libyams_torch_{name}_{h.hexdigest()[:16]}.so"


def override_var(name: str) -> str:
    """The environment variable that names an explicit `name` library."""
    return f"YAMS_TPU_TORCH_{name.upper()}_LIB"


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
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        if name in _REQUIRED:
            detail = getattr(e, "stderr", b"") or str(e).encode()
            raise RuntimeError(f"the {name} library did not build: "
                               f"{detail.decode(errors='replace')[-2000:]}") from e
        return None


def _load(name: str) -> ctypes.CDLL | None:
    with _lock:
        if name in _loaded:
            return _loaded[name]
        explicit = os.environ.get(override_var(name))
        if explicit:
            lib = ctypes.CDLL(explicit)      # an explicit library that does not load raises
        elif os.environ.get("YAMS_TPU_NO_NATIVE"):
            if name in _REQUIRED:
                raise RuntimeError(f"YAMS_TPU_NO_NATIVE is set: no {name} library")
            lib = None
        else:
            path = _build(name)
            try:
                lib = None if path is None else ctypes.CDLL(str(path))
            except OSError:
                if name in _REQUIRED:
                    raise
                lib = None
        if lib is not None:
            for sym, (restype, argtypes) in _LIBS[name][2].items():
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = argtypes
            if lib.ytn_abi_version() != 1:
                if explicit or name in _REQUIRED:
                    raise RuntimeError(f"{name} library: ABI {lib.ytn_abi_version()}, not 1")
                lib = None
        _loaded[name] = lib
        return lib


def sketch_library() -> ctypes.CDLL | None:
    """The sketch/FastCDC library, built on first call; None if it cannot be."""
    return _load("sketch")


def ingest_library() -> ctypes.CDLL | None:
    """The zstd ingest-pipeline library, built on first call; None if it cannot be."""
    return _load("ingest")


def mobile_library() -> ctypes.CDLL:
    """The mobile C ABI library with every signature bound, built on first
    call; raises where it cannot be built or loaded."""
    return _load("mobile")


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


def find_all(haystack: bytes, needle: bytes, max_hits: int = 1 << 20) -> list[int] | None:
    """Byte offsets of every (overlapping) occurrence of `needle`, at most
    `max_hits`, or None when the library is unavailable."""
    lib = sketch_library()
    if lib is None:
        return None
    out = (ctypes.c_uint64 * max_hits)()
    n = lib.ytn_find_all(haystack, len(haystack), needle, len(needle), out, max_hits)
    return [int(out[i]) for i in range(min(n, max_hits))]


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
