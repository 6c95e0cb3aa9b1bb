"""PipelinedDaemonClient: many in-flight requests over ONE connection.

Parity seam: the reference's AsioTransportAdapter multiplexes typed requests
over a persistent connection (include/yams/daemon/client/daemon_client.h:56-90,
transport pooling); here the same one-connection/many-outstanding shape is the
serving-throughput lever — a synchronous client caps offered load at
1/latency per connection, while a pipelined one keeps `max_inflight`
requests in the daemon's batcher per connection, so a handful of client
processes can saturate the device batch.

Requires the daemon's pipelined connection handler (responses may return
out of submission order; matching is by request id).

Copied from yams_tpu/daemon/aclient.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import itertools
import pathlib
import socket
import threading
from concurrent.futures import Future

from ..core.errors import ErrorCode, YamsError
from .protocol import FrameError, encode_frames, read_frame


class PipelinedDaemonClient:
    """Thread-safe: submit() from any thread; one reader thread demuxes."""

    def __init__(self, socket_path: str | pathlib.Path,
                 timeout: float = 600.0, max_inflight: int = 256):
        self.socket_path = pathlib.Path(socket_path)
        self.timeout = timeout
        self._ids = itertools.count(1)
        self._pending: dict[int, Future] = {}
        self._lock = threading.Lock()
        self._inflight = threading.BoundedSemaphore(max_inflight)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(str(self.socket_path))
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- plumbing -----------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                resp = read_frame(self._sock)
                fut = None
                with self._lock:
                    fut = self._pending.pop(resp.get("id"), None)
                if fut is None:
                    continue  # cancelled/unknown id
                self._inflight.release()
                if not resp.get("ok"):
                    fut.set_exception(YamsError(
                        resp.get("error", "unknown daemon error"),
                        ErrorCode(resp.get("code", int(ErrorCode.UNKNOWN)))))
                else:
                    fut.set_result(resp.get("result", {}))
        except (OSError, FrameError, ValueError) as e:
            self._fail_all(e)

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(
                    YamsError(f"connection lost: {exc}", ErrorCode.NETWORK))

    def submit(self, rtype: str, **fields) -> Future:
        """Enqueue a request; resolve via the returned Future. Blocks only
        when max_inflight requests are already outstanding (backpressure)."""
        if self._closed:
            raise YamsError("client closed", ErrorCode.NETWORK)
        self._inflight.acquire()
        rid = next(self._ids)
        fut: Future = Future()
        with self._lock:
            self._pending[rid] = fut
        try:
            data = encode_frames({"id": rid, "type": rtype, **fields})
            with self._lock:
                self._sock.sendall(data)
        except (OSError, FrameError) as e:
            with self._lock:
                self._pending.pop(rid, None)
            self._inflight.release()
            raise YamsError(f"daemon send failed: {e}", ErrorCode.NETWORK)
        return fut

    def call(self, rtype: str, **fields) -> dict:
        return self.submit(rtype, **fields).result(timeout=self.timeout)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._fail_all(ConnectionError("client closed"))

    # -- typed helpers ------------------------------------------------------------
    def search(self, query: str, limit: int = 10, search_type: str = "hybrid",
               **kw) -> Future:
        return self.submit("search", query=query, limit=limit,
                           search_type=search_type, **kw)

    def ping(self) -> Future:
        return self.submit("ping")
