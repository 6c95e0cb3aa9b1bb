"""DaemonClient: synchronous socket client for the daemon protocol.

Parity: include/yams/daemon/client/daemon_client.h:56-90 (typed call<T>,
connection reuse, ping/auto-detect). Raises YamsError subclasses carrying the
server's ErrorCode.

Copied from yams_tpu/daemon/client.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import itertools
import pathlib
import socket
import threading

from ..core.errors import ErrorCode, YamsError
from .protocol import FrameError, read_frame, write_frame


class DaemonClient:
    def __init__(self, socket_path: str | pathlib.Path, timeout: float = 600.0):
        # generous default: a first search compiles the fused program on the
        # device, which can take minutes at large corpus shapes
        self.socket_path = pathlib.Path(socket_path)
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._ids = itertools.count(1)
        self._lock = threading.RLock()

    # -- connection ---------------------------------------------------------------
    def _connect(self, timeout: float | None = None) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(timeout or self.timeout)
            s.connect(str(self.socket_path))
            s.settimeout(self.timeout)
            self._sock = s
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def call(self, rtype: str, timeout: float | None = None, **fields) -> dict:
        with self._lock:
            req = {"id": next(self._ids), "type": rtype, **fields}
            try:
                sock = self._connect(timeout)
                if timeout:
                    sock.settimeout(timeout)
                write_frame(sock, req)
                resp = read_frame(sock)
                if timeout:
                    sock.settimeout(self.timeout)
            except (OSError, FrameError) as e:
                self.close()
                raise YamsError(f"daemon call failed: {e}", ErrorCode.NETWORK)
            if not resp.get("ok"):
                raise YamsError(
                    resp.get("error", "unknown daemon error"),
                    ErrorCode(resp.get("code", int(ErrorCode.UNKNOWN))),
                )
            return resp.get("result", {})

    # -- typed helpers ---------------------------------------------------------------
    def ping(self, timeout: float = 2.0) -> bool:
        try:
            return bool(self.call("ping", timeout=timeout).get("pong"))
        except YamsError:
            return False

    def status(self, detailed: bool = False) -> dict:
        return self.call("status", detailed=detailed)

    def shutdown(self) -> dict:
        return self.call("shutdown")

    def search(self, query: str, limit: int = 10, search_type: str = "hybrid",
               tags=None, path_glob=None, collection=None,
               filters: dict | None = None) -> dict:
        return self.call(
            "search", query=query, limit=limit, search_type=search_type,
            tags=tags, path_glob=path_glob, collection=collection,
            filters=filters,
        )

    def grep(self, pattern: str, **kw) -> dict:
        return self.call("grep", pattern=pattern, **kw)

    def add_bytes(self, data: bytes, name: str, **kw) -> dict:
        return self.call("add_bytes", data=data, name=name, **kw)

    def add_path(self, path: str, **kw) -> dict:
        return self.call("add_path", path=path, **kw)

    def get(self, selector: str) -> dict:
        return self.call("get", selector=selector)

    def cat(self, selector: str) -> bytes:
        return self.call("cat", selector=selector)["data"]

    def get_text(self, selector: str) -> str:
        return self.call("get_text", selector=selector)["text"]

    def list(self, **kw) -> list[dict]:
        return self.call("list", **kw)["documents"]

    def delete(self, selector: str) -> bool:
        return self.call("delete", selector=selector)["deleted"]

    def embed(self, texts: list[str]) -> dict:
        return self.call("embed", texts=texts)

    def repair(self, ops=None) -> dict:
        return self.call("repair", ops=ops)

    def doctor(self) -> dict:
        return self.call("doctor")
