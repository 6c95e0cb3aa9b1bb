"""Native (dlopen) plugin host: load C/C++ plugins over the yams_plugin_* ABI.

Parity: src/daemon/resource/plugin_host.cpp + include/yams/plugins/abi.h —
the reference dlopens shared libraries exporting the yams_plugin_* lifecycle
symbols, checks the ABI version, calls init(config_json), and negotiates
typed vtables via yams_plugin_get_interface(id, version). This host does the
same through ctypes and adapts each vtable to the Python plugin protocols in
spec.py, so native plugins wire into the embedding / extraction / graph
registries identically to Python ones. The C header plugins compile against
is include/yams_plugin_abi.h.

Copied from yams_tpu/plugins/native_host.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import ctypes
import json
import pathlib

from .spec import (
    ABI_VERSION,
    IFACE_CONTENT_EXTRACTOR,
    IFACE_ENTITY_EXTRACTOR,
    IFACE_MODEL_PROVIDER,
    PluginManifest,
)

_SUPPORTS = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_char_p, ctypes.c_char_p)


class _ExtractionResult(ctypes.Structure):
    _fields_ = [
        ("text", ctypes.c_void_p),   # c_void_p (not c_char_p) so the pointer
        ("title", ctypes.c_void_p),  # survives for free_result
        ("error", ctypes.c_void_p),
    ]


_EXTRACT = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(_ExtractionResult)),
)
_FREE_RESULT = ctypes.CFUNCTYPE(None, ctypes.POINTER(_ExtractionResult))


class _ContentExtractorVtable(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("supports", _SUPPORTS),
        ("extract", _EXTRACT),
        ("free_result", _FREE_RESULT),
    ]


_MODEL_ID = ctypes.CFUNCTYPE(ctypes.c_char_p, ctypes.c_void_p)
_DIM = ctypes.CFUNCTYPE(ctypes.c_uint32, ctypes.c_void_p)
_EMBED = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
    ctypes.c_size_t, ctypes.POINTER(ctypes.c_float),
)


class _ModelProviderVtable(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("self", ctypes.c_void_p),
        ("model_id", _MODEL_ID),
        ("dim", _DIM),
        ("embed", _EMBED),
    ]


_EXTRACT_ENTITIES = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_char_p)
_FREE_JSON = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)


class _EntityExtractorVtable(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("self", ctypes.c_void_p),
        ("extract_entities_json", _EXTRACT_ENTITIES),
        ("free_json", _FREE_JSON),
    ]


def _cstr(ptr: int | None) -> str:
    return ctypes.string_at(ptr).decode("utf-8", "replace") if ptr else ""


class _NativeContentExtractor:
    """ContentExtractorPlugin protocol over a yams_content_extractor_v1."""

    def __init__(self, vt: _ContentExtractorVtable, mimes: list[str]):
        self._vt = vt
        self._mimes = mimes

    def supported_mimes(self) -> list[str]:
        return list(self._mimes)

    def extract(self, data: bytes, mime: str) -> tuple[str, str] | None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data \
            else (ctypes.c_uint8 * 1)()
        out = ctypes.POINTER(_ExtractionResult)()
        rc = self._vt.extract(buf, len(data), mime.encode(), ctypes.byref(out))
        if rc != 0 or not out:
            return None
        try:
            res = out.contents
            if res.error or not res.text:
                return None
            return _cstr(res.text), _cstr(res.title)
        finally:
            self._vt.free_result(out)


class _NativeModelProvider:
    """ModelProviderPlugin protocol over a yams_model_provider_v1."""

    def __init__(self, vt: _ModelProviderVtable):
        self._vt = vt

    def model_id(self) -> str:
        return (self._vt.model_id(self._vt.self) or b"").decode()

    def dim(self) -> int:
        return int(self._vt.dim(self._vt.self))

    def embed(self, texts: list[str]) -> list[list[float]]:
        n, d = len(texts), self.dim()
        arr = (ctypes.c_char_p * n)(*[t.encode() for t in texts])
        out = (ctypes.c_float * (n * d))()
        rc = self._vt.embed(self._vt.self, arr, n, out)
        if rc != 0:
            raise RuntimeError(f"plugin embed failed rc={rc}")
        return [list(out[i * d:(i + 1) * d]) for i in range(n)]


class _NativeEntityExtractor:
    """EntityExtractorPlugin protocol over a yams_entity_extractor_v1."""

    def __init__(self, vt: _EntityExtractorVtable):
        self._vt = vt

    def extract_entities(self, text: str) -> list[tuple[str, str, float]]:
        ptr = self._vt.extract_entities_json(self._vt.self, text.encode())
        if not ptr:
            return []
        try:
            rows = json.loads(_cstr(ptr))
        finally:
            self._vt.free_json(self._vt.self, ptr)
        return [(str(e), str(t), float(c)) for e, t, c in rows]


class NativePlugin:
    """One dlopen'd plugin: lifecycle + negotiated interfaces."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._lib = ctypes.CDLL(str(self.path))  # dlopen
        lib = self._lib
        lib.yams_plugin_get_abi_version.restype = ctypes.c_int
        abi = lib.yams_plugin_get_abi_version()
        if abi != ABI_VERSION:
            raise ValueError(
                f"ABI mismatch: plugin {abi} != host {ABI_VERSION}")
        lib.yams_plugin_get_name.restype = ctypes.c_char_p
        lib.yams_plugin_get_version.restype = ctypes.c_char_p
        lib.yams_plugin_get_manifest_json.restype = ctypes.c_char_p
        lib.yams_plugin_init.restype = ctypes.c_int
        lib.yams_plugin_init.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.yams_plugin_get_interface.restype = ctypes.c_int
        lib.yams_plugin_get_interface.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.yams_plugin_get_health_json.restype = ctypes.c_int
        lib.yams_plugin_get_health_json.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)]

    def _iface_ptr(self, iface_id: str, version: int) -> ctypes.c_void_p | None:
        out = ctypes.c_void_p()
        rc = self._lib.yams_plugin_get_interface(
            iface_id.encode(), version, ctypes.byref(out))
        return out if rc == 0 and out else None

    def manifest(self, config: dict | None = None) -> PluginManifest:
        lib = self._lib
        raw = lib.yams_plugin_get_manifest_json()
        meta = json.loads(raw.decode()) if raw else {}
        rc = lib.yams_plugin_init(
            json.dumps(config or {}).encode(), None)
        if rc != 0:
            raise RuntimeError(f"plugin init failed rc={rc}")

        interfaces: dict = {}
        p = self._iface_ptr(IFACE_CONTENT_EXTRACTOR, 1)
        if p:
            vt = ctypes.cast(p, ctypes.POINTER(_ContentExtractorVtable)).contents
            mimes = [i.get("mime") for i in meta.get("interfaces", [])
                     if i.get("id") == IFACE_CONTENT_EXTRACTOR and i.get("mime")]
            if not mimes:
                mimes = meta.get("mimes", [])
            interfaces[IFACE_CONTENT_EXTRACTOR] = _NativeContentExtractor(
                vt, mimes)
        p = self._iface_ptr(IFACE_MODEL_PROVIDER, 1)
        if p:
            vt = ctypes.cast(p, ctypes.POINTER(_ModelProviderVtable)).contents
            interfaces[IFACE_MODEL_PROVIDER] = _NativeModelProvider(vt)
        p = self._iface_ptr(IFACE_ENTITY_EXTRACTOR, 1)
        if p:
            vt = ctypes.cast(p, ctypes.POINTER(_EntityExtractorVtable)).contents
            interfaces[IFACE_ENTITY_EXTRACTOR] = _NativeEntityExtractor(vt)

        def health() -> dict:
            out = ctypes.c_void_p()
            rc = lib.yams_plugin_get_health_json(ctypes.byref(out))
            if rc != 0 or not out:
                return {"status": "error", "detail": f"rc={rc}"}
            try:
                return json.loads(_cstr(out.value))
            finally:
                _libc_free(out)

        return PluginManifest(
            name=(lib.yams_plugin_get_name() or b"").decode() or self.path.stem,
            version=(lib.yams_plugin_get_version() or b"").decode(),
            abi_version=ABI_VERSION,
            description=meta.get("description", ""),
            interfaces=interfaces,
            init=None,  # already initialized above
            shutdown=lib.yams_plugin_shutdown,
            health=health,
        )


_libc = ctypes.CDLL(None)
_libc.free.argtypes = [ctypes.c_void_p]


def _libc_free(ptr: ctypes.c_void_p) -> None:
    """Free plugin-malloc'd health JSON (documented contract in the header)."""
    if ptr:
        _libc.free(ptr)


def load_native_plugin(path: str | pathlib.Path,
                       config: dict | None = None) -> PluginManifest:
    return NativePlugin(path).manifest(config)
