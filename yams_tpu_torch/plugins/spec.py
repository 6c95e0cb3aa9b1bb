"""Plugin interface specs.

Parity: include/yams/plugins/abi.h (yams_plugin_{get_abi_version,get_name,
get_manifest_json,init,shutdown,get_interface,get_health_json}) and the typed
interfaces v1 (model_provider, content_extractor, entity_extractor,
object_storage). This build ships its own WIT contracts for the same interfaces at docs/spec/wit/*.wit. In this architecture a plugin is a Python
module exposing `yams_plugin()` -> PluginManifest; the C ABI is replaced by a
documented Python ABI with the same lifecycle + negotiation surface, and
out-of-process plugins speak JSON-RPC over stdio (host.py), mirroring the
reference's external plugin processes (src/extraction/plugin_process.cpp).

Copied from yams_tpu/plugins/spec.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

ABI_VERSION = 1

# interface ids (negotiated by name+version, like the reference's
# get_interface(name, version))
IFACE_MODEL_PROVIDER = "model_provider_v1"
IFACE_CONTENT_EXTRACTOR = "content_extractor_v1"
IFACE_ENTITY_EXTRACTOR = "entity_extractor_v1"
IFACE_OBJECT_STORAGE = "object_storage_v1"
IFACE_GRAPH_ADAPTER = "graph_adapter_v1"


class ModelProviderPlugin(Protocol):
    """model_provider_v1: embedding backends."""

    def model_id(self) -> str: ...
    def dim(self) -> int: ...
    def embed(self, texts: list[str]) -> list[list[float]]: ...


class ContentExtractorPlugin(Protocol):
    """content_extractor_v1: bytes -> (text, title) for extra mime types."""

    def supported_mimes(self) -> list[str]: ...
    def extract(self, data: bytes, mime: str) -> tuple[str, str] | None: ...


class EntityExtractorPlugin(Protocol):
    """entity_extractor_v1: text -> [(entity, type, confidence)]."""

    def extract_entities(self, text: str) -> list[tuple[str, str, float]]: ...


class GraphAdapterPlugin(Protocol):
    """graph_adapter_v1: cursor-paged property-graph access
    (docs/spec/wit/graph_adapter_v1.wit; bundled impl
    plugins/graph_adapter.py over the KG store)."""

    def get_capabilities(self) -> dict: ...
    def list_graphs(self) -> list[dict]: ...
    def get_graph_info(self, graph: str) -> dict: ...
    def nodes_begin(self, graph: str, filter_json: str | None = None) -> int: ...
    def nodes_next(self, cursor: int, limit: int = 256) -> dict: ...
    def nodes_end(self, cursor: int) -> None: ...
    def edges_begin(self, graph: str, filter_json: str | None = None) -> int: ...
    def edges_next(self, cursor: int, limit: int = 256) -> dict: ...
    def edges_end(self, cursor: int) -> None: ...
    def export_graph(self, graph: str, format: str) -> bytes: ...
    def import_graph(self, format: str, data: bytes) -> str: ...
    def apply_delta_json(self, graph: str, delta_jsonl: str) -> int: ...


@dataclasses.dataclass(slots=True)
class PluginManifest:
    name: str
    version: str
    abi_version: int = ABI_VERSION
    description: str = ""
    interfaces: dict[str, Any] = dataclasses.field(default_factory=dict)
    init: Callable[[dict], None] | None = None
    shutdown: Callable[[], None] | None = None
    health: Callable[[], dict] | None = None

    def get_interface(self, name: str):
        return self.interfaces.get(name)
