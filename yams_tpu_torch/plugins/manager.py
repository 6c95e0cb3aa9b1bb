"""PluginManager: discovery, trust list, load/negotiate/health.

Parity: src/daemon/resource/PluginManager.cpp — trust-listed plugin dirs,
manifest negotiation, adapter wiring into the host services:
  model_provider_v1    -> embed.provider registry
  content_extractor_v1 -> services.extraction registry
  entity_extractor_v1  -> GraphService override
Plugins load in-process (Python module with `yams_plugin()`) or out-of-process
via host.SubprocessPlugin (JSON-RPC over stdio).

Port of yams_tpu/plugins/manager.py. It departs from the reference in
these ways only:

- `PluginManager(app, trust_file)` runs its plugins on the app's device
  (`app.device`; the card when there is no app): a Python plugin's init
  config gets "device" unless the caller set one, and the model-provider
  adapter builds its identity projection with `torch.eye` on the device
  the provider is created on (the reference: `jnp.eye`).
- `load_file` of a module of the port's own package (the bundled
  `plugins/neural_ner.py`) imports it as that module, so its relative
  imports resolve; the reference imports it as a top-level module, where
  they fail, so it cannot load its bundled plugins from the trust list.
- `unload` removes the model providers that `_wire` registered for that
  plugin, and only those (a name that a later registration took over stays
  registered); the reference leaves them in the provider registry, so a
  model of an unloaded plugin stays creatable.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
import traceback

import torch

from ..device import resolve_device
from .spec import (
    ABI_VERSION,
    IFACE_CONTENT_EXTRACTOR,
    IFACE_ENTITY_EXTRACTOR,
    IFACE_GRAPH_ADAPTER,
    IFACE_MODEL_PROVIDER,
    PluginManifest,
)


_PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def _own_module(path: pathlib.Path) -> str | None:
    """The dotted name of a .py file inside this package, else None."""
    try:
        rel = path.resolve().relative_to(_PACKAGE)
    except (OSError, ValueError):
        return None
    if path.suffix != ".py":
        return None
    return ".".join((_PACKAGE.name, *rel.with_suffix("").parts))


class PluginManager:
    def __init__(self, app=None, trust_file: str | pathlib.Path | None = None):
        self.app = app
        self.device = getattr(app, "device", None) or "cuda"
        self.trust_file = pathlib.Path(trust_file) if trust_file else None
        self.plugins: dict[str, PluginManifest] = {}
        self.errors: dict[str, str] = {}
        # plugin name -> the provider factory _wire registered under it
        self._providers: dict[str, object] = {}

    # -- trust list ----------------------------------------------------------
    def trusted_paths(self) -> list[pathlib.Path]:
        if not self.trust_file or not self.trust_file.exists():
            return []
        out = []
        for line in self.trust_file.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(pathlib.Path(line))
        return out

    def trust(self, path: str | pathlib.Path) -> None:
        if not self.trust_file:
            raise ValueError("no trust file configured")
        self.trust_file.parent.mkdir(parents=True, exist_ok=True)
        existing = set(str(p) for p in self.trusted_paths())
        if str(path) not in existing:
            with open(self.trust_file, "a") as f:
                f.write(f"{path}\n")

    def untrust(self, path: str | pathlib.Path) -> None:
        """Remove a path from the trust list (PluginTrustRemoveRequest,
        ipc_protocol_requests.h:2224)."""
        if not self.trust_file or not self.trust_file.exists():
            return
        keep = [str(p) for p in self.trusted_paths() if str(p) != str(path)]
        self.trust_file.write_text("".join(f"{p}\n" for p in keep))

    def scan(self, directory: str | pathlib.Path | None = None) -> list[str]:
        """Discover candidate plugin files WITHOUT loading them
        (PluginScanRequest, ipc_protocol_requests.h:2118): every trusted dir
        (or an explicit dir) is globbed for yams_plugin_*.py / *.yams-plugin
        manifests."""
        roots = ([pathlib.Path(directory)] if directory
                 else [p if p.is_dir() else p.parent
                       for p in self.trusted_paths()])
        found: list[str] = []
        for root in roots:
            if not root.is_dir():
                continue
            for pat in ("yams_plugin_*.py", "*.yams-plugin",
                        "yams_plugin_*.so", "libyams_plugin_*.so"):
                found.extend(str(p) for p in sorted(root.glob(pat)))
        return sorted(set(found))

    # -- loading ----------------------------------------------------------------
    def load_file(self, path: str | pathlib.Path, config: dict | None = None
                  ) -> PluginManifest | None:
        path = pathlib.Path(path)
        name = path.stem
        module = _own_module(path)
        if module is not None:
            return self.load_module(module, config)
        try:
            if path.suffix in (".so", ".dylib"):
                # C/C++ plugin over the dlopen ABI (include/yams_plugin_abi.h;
                # reference: include/yams/plugins/abi.h)
                from .native_host import load_native_plugin

                manifest = load_native_plugin(path, config)
                self.plugins[manifest.name] = manifest
                self._wire(manifest)
                return manifest
            spec = importlib.util.spec_from_file_location(f"yams_plugin_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            return self._register_module(mod, config)
        except Exception as e:
            self.errors[name] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            return None

    def load_module(self, module_name: str, config: dict | None = None
                    ) -> PluginManifest | None:
        try:
            mod = importlib.import_module(module_name)
            return self._register_module(mod, config)
        except Exception as e:
            self.errors[module_name] = f"{type(e).__name__}: {e}"
            return None

    def _register_module(self, mod, config: dict | None) -> PluginManifest:
        if not hasattr(mod, "yams_plugin"):
            raise ValueError("module lacks yams_plugin() entry point")
        manifest: PluginManifest = mod.yams_plugin()
        if manifest.abi_version != ABI_VERSION:
            raise ValueError(
                f"ABI mismatch: plugin {manifest.abi_version} != host {ABI_VERSION}"
            )
        if manifest.init:
            manifest.init({"device": str(self.device), **(config or {})})
        self.plugins[manifest.name] = manifest
        self._wire(manifest)
        return manifest

    def load_trusted(self) -> int:
        n = 0
        for p in self.trusted_paths():
            if p.is_file() and self.load_file(p):
                n += 1
        return n

    def unload(self, name: str) -> bool:
        m = self.plugins.pop(name, None)
        if m is None:
            return False
        if m.shutdown:
            try:
                m.shutdown()
            except Exception:
                pass
        if name in self._providers:
            from ..embed.provider import unregister_provider

            unregister_provider(name, self._providers.pop(name))
        return True

    # -- adapter wiring (abi_*.cpp analogs) -----------------------------------------
    def _wire(self, manifest: PluginManifest) -> None:
        mp = manifest.get_interface(IFACE_MODEL_PROVIDER)
        if mp is not None:
            from ..embed.provider import register_provider

            class _PluginProvider:
                name = manifest.name

                def __init__(self, device="cuda"):
                    self.device = resolve_device(device)

                @property
                def dim(self):
                    return mp.dim()

                @property
                def space_id(self):
                    return f"plugin/{manifest.name}/{mp.model_id()}"

                def encode(self, texts):
                    import numpy as np

                    v = np.asarray(mp.embed(texts), np.float32)
                    n = np.linalg.norm(v, axis=1, keepdims=True)
                    return v / np.maximum(n, 1e-9)

                def query_device_inputs(self, texts):
                    return self.encode(texts), torch.eye(
                        self.dim, dtype=torch.bfloat16, device=self.device)

            def factory(device="cuda", **kw):
                return _PluginProvider(device)

            register_provider(manifest.name, factory)
            self._providers[manifest.name] = factory

        ce = manifest.get_interface(IFACE_CONTENT_EXTRACTOR)
        if ce is not None:
            from ..services.extraction import register_extractor

            for mime in ce.supported_mimes():
                register_extractor(
                    mime, lambda data, _ce=ce, _m=mime: _ce.extract(data, _m)
                )

        ga = manifest.get_interface(IFACE_GRAPH_ADAPTER)
        if ga is not None and self.app is not None:
            # bind the bundled adapter to the app's KG store and publish it
            # (the reference exposes graph adapters to SDK consumers the
            # same way: one host-wired seam, not per-call plumbing)
            if getattr(ga, "kg", None) is None and hasattr(self.app, "kg"):
                ga.kg = self.app.kg
            self.app.graph_adapter = ga

        ee = manifest.get_interface(IFACE_ENTITY_EXTRACTOR)
        if ee is not None and self.app is not None:
            graph = self.app.graph

            def extract_entities(text, max_entities=32):
                return [
                    (ent, conf) for ent, _type, conf in
                    ee.extract_entities(text)[:max_entities]
                ]

            graph.extract_entities = extract_entities

    # -- introspection -----------------------------------------------------------------
    def health(self) -> dict:
        out = {}
        for name, m in self.plugins.items():
            try:
                out[name] = m.health() if m.health else {"status": "ok"}
            except Exception as e:
                out[name] = {"status": "error", "detail": str(e)}
        return out

    def list(self) -> list[dict]:
        return [
            {"name": m.name, "version": m.version,
             "interfaces": sorted(m.interfaces), "description": m.description}
            for m in self.plugins.values()
        ] + [{"name": n, "error": e} for n, e in self.errors.items()]
