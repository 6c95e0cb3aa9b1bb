"""Out-of-process plugin host: JSON-RPC over the child's stdio.

Parity: src/extraction/plugin_process.cpp + jsonrpc_client.cpp — external
plugin executables speak line-delimited JSON-RPC:
  {"id": 1, "method": "manifest"}            -> {name, version, abi, interfaces}
  {"id": 2, "method": "embed", "params": {"texts": [...]}}
  {"id": 3, "method": "extract", "params": {"data_b64": ..., "mime": ...}}
  {"id": 4, "method": "extract_entities", "params": {"text": ...}}
  {"id": 5, "method": "shutdown"}
The host builds a PluginManifest whose interfaces proxy into the child.

Copied from yams_tpu/plugins/host.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import base64
import itertools
import json
import subprocess
import threading

from ..core.errors import YamsError
from .spec import (
    IFACE_CONTENT_EXTRACTOR,
    IFACE_ENTITY_EXTRACTOR,
    IFACE_MODEL_PROVIDER,
    PluginManifest,
)


class SubprocessPlugin:
    def __init__(self, argv: list[str], timeout: float = 60.0):
        self.argv = argv
        self.timeout = timeout
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1,
        )
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def call(self, method: str, **params):
        with self._lock:
            if self.proc.poll() is not None:
                raise YamsError(f"plugin process exited ({self.proc.returncode})")
            req = {"id": next(self._ids), "method": method, "params": params}
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
            if not line:
                raise YamsError("plugin process closed stdout")
            resp = json.loads(line)
            if "error" in resp:
                raise YamsError(f"plugin error: {resp['error']}")
            return resp.get("result")

    def close(self) -> None:
        try:
            self.call("shutdown")
        except Exception:
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=5)
        except Exception:
            self.proc.kill()

    def manifest(self) -> PluginManifest:
        info = self.call("manifest")
        interfaces = {}
        plugin = self
        if IFACE_MODEL_PROVIDER in info.get("interfaces", []):
            class _MP:
                def model_id(self):
                    return info.get("model_id", info["name"])

                def dim(self):
                    return info["dim"]

                def embed(self, texts):
                    return plugin.call("embed", texts=texts)["vectors"]

            interfaces[IFACE_MODEL_PROVIDER] = _MP()
        if IFACE_CONTENT_EXTRACTOR in info.get("interfaces", []):
            class _CE:
                def supported_mimes(self):
                    return info.get("mimes", [])

                def extract(self, data, mime):
                    out = plugin.call(
                        "extract",
                        data_b64=base64.b64encode(data).decode(), mime=mime,
                    )
                    if out is None:
                        return None
                    return out["text"], out.get("title", "")

            interfaces[IFACE_CONTENT_EXTRACTOR] = _CE()
        if IFACE_ENTITY_EXTRACTOR in info.get("interfaces", []):
            class _EE:
                def extract_entities(self, text):
                    out = plugin.call("extract_entities", text=text)
                    return [tuple(e) for e in out["entities"]]

            interfaces[IFACE_ENTITY_EXTRACTOR] = _EE()
        return PluginManifest(
            name=info["name"], version=info.get("version", "0"),
            abi_version=info.get("abi", 1),
            description=info.get("description", ""),
            interfaces=interfaces,
            shutdown=self.close,
            health=lambda: {"status": "ok" if self.proc.poll() is None else "dead"},
        )
