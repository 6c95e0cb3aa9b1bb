"""YamsDaemon: asyncio AF_UNIX socket server over one AppContext.

Parity: the reference's daemon stack (SURVEY §2.8) — SocketServer accept loop
(src/daemon/components/SocketServer.cpp), RequestDispatcher handler table
(RequestDispatcher.cpp DEFINE_REQUEST_HANDLER), lifecycle FSM
(Unstarted->Initializing->Ready->Stopping, DaemonLifecycleFsm.h:11-35),
periodic CheckpointManager ticks, and daemonized spawn. Request handlers run
on a single worker thread (the engine's effective WriteCoordinator); the
asyncio loop stays free for I/O.

Port of yams_tpu/daemon/server.py over the port's AppContext. It departs
from the reference in these ways only:

- `YamsDaemon(config, device="cuda")` opens its AppContext on `device`;
  `run_daemon` and `spawn_daemon` take the device too, and `spawn_daemon`
  starts `python -m yams_tpu_torch.daemon --device <device>`.
- `queue` with op "wait_idle" waits off the mutator worker and without
  `state_lock`: the post-ingest worker it waits for takes the write side of
  that lock for each stage, so a wait under it could never end. A batch
  envelope refuses it, and its answer adds "idle" (whether the queue
  drained before the timeout).
- `feedback` with neither `doc_id` nor `hash` answers InvalidArgumentError.
- `ping` and `status` add "backend": "torch" and the device.
- Plugins are not loaded (no PluginManager in the port): if
  plugins_trust.txt lists any, `degraded["plugins"]` says so.
  `degraded["native"]` follows the port's own native libraries, and
  `degraded["compression"]` says when zstandard is missing.
- `model_load` builds the provider on the daemon's device.
- A request for a service the port lacks answers UNSUPPORTED naming the
  ROADMAP item that ports it: any NotImplementedError a handler raises
  (AppContext's grep, session, download and watch services and the
  daemon's `plugins` raise it when used). `repair` and `doctor` run the port's
  RepairService on the mutator worker under the write side of
  `state_lock`, as every mutation does.
"""

from __future__ import annotations

import dataclasses as _dc


def _asdict(obj):
    """dataclass (incl. slots=True) -> plain dict for serialization.

    Flat slots dataclasses (the serving hot path: ~640 SearchHits per
    64-query batch) take the shallow getattr walk — dataclasses.asdict's
    recursive deepcopy costs ~20x more and the hit fields are all scalars.
    """
    if _dc.is_dataclass(obj):
        slots = getattr(type(obj), "__slots__", None)
        if slots is not None:
            return {f: getattr(obj, f) for f in slots}
        return _dc.asdict(obj)
    return dict(obj)

import asyncio
import concurrent.futures
import contextlib
import os
import pathlib
import signal
import subprocess
import sys
import time
import traceback

import functools

import torch

from ..core.config import Config
from ..core.errors import ErrorCode, InvalidArgumentError, YamsError
from ..device import resolve_device
from ..services.app import NotPorted
from .protocol import FrameError, async_read_frame, async_write_frame

CHECKPOINT_INTERVAL_S = 300.0  # reference: CheckpointManager.h:38-63


class DaemonState:
    UNSTARTED = "unstarted"
    INITIALIZING = "initializing"
    READY = "ready"
    DEGRADED = "degraded"   # serving, but a subsystem is impaired
    STOPPING = "stopping"


class SearchBatcher:
    """Pipelined micro-batching aggregator: concurrent searches coalesce
    into fused device programs (engine.search_batch via
    SearchService.search_many_requests), with up to `max_inflight` batches
    executing concurrently on the daemon's search pool.

    The reference serializes per-query fan-outs through thread pools; on TPU
    the win is different — a query batch costs barely more than one query,
    so serving throughput under concurrency scales with the batch. Requests
    wait at most `window_ms` for co-travellers (or flush early at
    `max_batch`). Pipelining matters because one batch's wall time is
    dominated by the host<->device round trip: while batch N waits on the
    device (GIL released), batch N+1 assembles and dispatches, so the RTT
    amortizes across `max_inflight` batches instead of gating each one.

    Filtered/qualified searches batch too — per-request candidate sets ride
    as rows of the fused program's (B, Nd) doc mask. Requests group by
    engine mode (hybrid | vector | keyword) since a batch shares one leg
    weighting.
    """

    # log2 latency buckets in ms: <1, <2, <4, ... <512, >=512
    HIST_BUCKETS = 11
    _MODE_GROUP = {"hybrid": "hybrid", "semantic": "vector",
                   "vector": "vector", "keyword": "keyword"}

    def __init__(self, daemon: "YamsDaemon", window_ms: float = 2.0,
                 max_batch: int = 64, max_queue: int = 1024,
                 max_inflight: int = 4):
        self.daemon = daemon
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.max_inflight = max_inflight
        self._pending: dict[str, list[tuple[dict, asyncio.Future, float]]] = {}
        self._n_pending = 0
        self._inflight = 0
        self._timer: asyncio.TimerHandle | None = None
        self.batches = 0
        self.batched_requests = 0
        self.shed = 0
        self.isolated_failures = 0
        self.latency_hist = [0] * self.HIST_BUCKETS

    def _observe_latency(self, seconds: float) -> None:
        ms = seconds * 1e3
        b = 0
        while b < self.HIST_BUCKETS - 1 and ms >= (1 << b):
            b += 1
        self.latency_hist[b] += 1

    def _group_of(self, req: dict) -> str:
        return self._MODE_GROUP.get(
            req.get("search_type", "hybrid"), "other")

    async def submit(self, req: dict) -> dict:
        loop = asyncio.get_running_loop()
        # shed under pressure: bounded queue + ResourceGovernor admission
        # (reference: ResourceGovernor admission/throttle decisions) — fail
        # fast instead of queueing into a death spiral
        governor = getattr(self.daemon, "governor", None)
        admit = getattr(governor, "admit_search", None) or getattr(
            governor, "admit", None)
        if self._n_pending >= self.max_queue or (
            admit is not None and not admit()
        ):
            self.shed += 1
            raise YamsError(
                "search queue overloaded, request shed",
                code=ErrorCode.RESOURCE_EXHAUSTED,
            )
        fut: asyncio.Future = loop.create_future()
        key = self._group_of(req)
        self._pending.setdefault(key, []).append(
            (req, fut, time.monotonic()))
        self._n_pending += 1
        if (len(self._pending[key]) >= self.max_batch
                and self._inflight < self.max_inflight):
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.window_s, self._flush)
        return await fut

    @staticmethod
    def _request_fields(req: dict) -> dict:
        return {
            "query": req.get("query", ""),
            "limit": int(req.get("limit", 10) or 10),
            "search_type": req.get("search_type", "hybrid"),
            "tags": req.get("tags"), "path_glob": req.get("path_glob"),
            "collection": req.get("collection"),
            "filters": req.get("filters"),
        }

    def _run_one(self, req: dict) -> dict:
        resp = self.daemon.app.search.search_many_requests(
            [self._request_fields(req)])[0]
        return {
            "hits": [_asdict(h) for h in resp.hits],
            "total": resp.total,
            "duration_ms": resp.duration_ms,
        }

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        # drain the deepest group first; keep dispatching while capacity
        while self._n_pending and self._inflight < self.max_inflight:
            key = max(self._pending, key=lambda g: len(self._pending[g]))
            q = self._pending[key]
            batch, rest = q[: self.max_batch], q[self.max_batch:]
            if rest:
                self._pending[key] = rest
            else:
                del self._pending[key]
            self._n_pending -= len(batch)
            self._dispatch_batch(batch)
        if self._n_pending and self._timer is None:
            loop = asyncio.get_running_loop()
            self._timer = loop.call_later(self.window_s, self._flush)

    def _dispatch_batch(
        self, batch: list[tuple[dict, asyncio.Future, float]]
    ) -> None:
        self.batches += 1
        self.batched_requests += len(batch)
        self._inflight += 1
        loop = asyncio.get_running_loop()
        lock = getattr(self.daemon, "state_lock", None)

        def run():
            reqs = [self._request_fields(r) for r, _, _ in batch]
            guard = lock.read() if lock is not None else contextlib.nullcontext()
            with guard:
                try:
                    resps = self.daemon.app.search.search_many_requests(reqs)
                    return [
                        {"hits": [_asdict(h) for h in resp.hits],
                         "total": resp.total,
                         "duration_ms": resp.duration_ms}
                        for resp in resps
                    ]
                except BaseException:
                    # per-request error isolation: the batch failed as a
                    # unit, so retry each co-traveller alone — only the
                    # poisoned request(s) surface an error (reference:
                    # per-request failure isolation in RequestDispatcher)
                    outs = []
                    for r, _, _ in batch:
                        try:
                            outs.append(self._run_one(r))
                        except BaseException as e:
                            self.isolated_failures += 1
                            outs.append(e)
                    return outs

        def done(f):
            self._inflight -= 1
            try:
                outs = f.result()
            except BaseException as e:  # executor itself failed
                outs = [e] * len(batch)
            now = time.monotonic()
            for (_, fut, t0), out in zip(batch, outs):
                self._observe_latency(now - t0)
                if fut.cancelled():
                    continue
                if isinstance(out, BaseException):
                    fut.set_exception(out)
                else:
                    fut.set_result(out)
            if self._n_pending:
                self._flush()

        pool = getattr(self.daemon, "_search_pool", None) or self.daemon._pool
        task = loop.run_in_executor(pool, run)
        task.add_done_callback(
            lambda f: loop.call_soon_threadsafe(done, f)
        )

    def snapshot(self) -> dict:
        labels = [
            f"<{1 << b}ms" for b in range(self.HIST_BUCKETS - 1)
        ] + [f">={1 << (self.HIST_BUCKETS - 2)}ms"]
        return {"batches": self.batches,
                "batched_requests": self.batched_requests,
                "avg_batch": round(
                    self.batched_requests / max(self.batches, 1), 2),
                "shed": self.shed,
                "isolated_failures": self.isolated_failures,
                "queue_depth": self._n_pending,
                "inflight": self._inflight,
                "latency_hist": dict(zip(labels, self.latency_hist))}


class YamsDaemon:
    def __init__(self, config: Config, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.state = DaemonState.UNSTARTED
        self.app = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._stop = asyncio.Event()
        self._started_at = time.time()
        # single worker: serializes engine mutations (WriteCoordinator analog)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # read-only search batches run concurrently here, overlapping the
        # host<->device round trip; state_lock keeps them exclusive with the
        # mutator worker (reference: WorkCoordinator read fan-out vs
        # WriteCoordinator serialization)
        from .components import RWLock

        self._search_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, config.daemon.search_workers))
        self.state_lock = RWLock()
        self._requests_handled = 0
        self._metrics: dict[str, dict] = {}
        self.search_batcher: SearchBatcher | None = None
        # chunked-get sessions (GetInit/GetChunk/GetEnd), loaded model
        # providers (LoadModel/ModelStatus), in-flight cancel flags
        self._get_sessions: dict[str, dict] = {}
        self._models: dict[str, object] = {}
        self._cancel_flags: dict[str, bool] = {}

    # -- lifecycle ----------------------------------------------------------------
    async def start(self) -> None:
        self.state = DaemonState.INITIALIZING
        from ..services.app import AppContext
        from .components import (GradientLimiter, InternalEventBus,
                                 PostIngestQueue, ResourceGovernor,
                                 TuneAdvisor)

        loop = asyncio.get_running_loop()
        self.events = InternalEventBus()
        self.events.publish("lifecycle", {"state": "initializing",
                                          "ts": time.time()})
        # RTT-gradient admission for the (single-worker) executor path:
        # when request latency trends up the in-flight+queued allowance
        # shrinks and excess requests shed with RESOURCE_EXHAUSTED instead
        # of stacking unboundedly behind the worker
        self.limiter = GradientLimiter(initial=32, min_limit=2, max_limit=64)
        self.app = await loop.run_in_executor(
            self._pool, functools.partial(AppContext, self.config, device=self.device))
        self.governor = ResourceGovernor()
        self.governor.start()
        self.advisor = TuneAdvisor()
        self.post_ingest = PostIngestQueue(self.app, self.governor, self.advisor,
                                           bus=self.events,
                                           state_lock=self.state_lock)
        self.governor.add_queue_source(self.post_ingest.depth_fraction)
        self.post_ingest.start()
        self.plugins = NotPorted("plugins", 3)
        sock = self.config.socket_path
        sock.parent.mkdir(parents=True, exist_ok=True)
        if sock.exists():
            sock.unlink()
        self._server = await asyncio.start_unix_server(self._handle_conn, path=str(sock))
        # Any client reaching the socket can drive repair/plugin ops; restrict
        # to the owning user (the reference daemon's socket is similarly
        # owner-only).
        os.chmod(sock, 0o600)
        # per-subsystem degraded flags (reference: DaemonLifecycleFsm Degraded
        # state + ServiceManager degraded tracking): still serving, but status
        # reports what's impaired and why
        self.degraded: dict[str, str] = {}
        if getattr(self.app, "salvage_report", None):
            self.degraded["metadata"] = "database salvaged on open"
        if self.app.lock_contended:
            self.degraded["data_dir"] = "another writer holds the data dir"
        from .. import native as _native

        missing = [name for name, lib in (("sketch", _native.sketch_library()),
                                          ("ingest", _native.ingest_library()))
                   if lib is None]
        if missing:
            self.degraded["native"] = (
                f"native {' and '.join(missing)} library unavailable "
                "(pure-python tier)")
        from ..ingest.compression import zstd_available

        if not zstd_available():
            self.degraded["compression"] = (
                "zstandard not installed: blocks are stored uncompressed")
        trust = self.config.data_dir / "plugins_trust.txt"
        if trust.exists() and trust.read_text().split():
            self.degraded["plugins"] = (
                "trusted plugins not loaded: plugins are not ported "
                "(ROADMAP queue 1 item 3)")
        self.state = DaemonState.DEGRADED if self.degraded else DaemonState.READY
        self.events.publish("lifecycle", {"state": str(self.state),
                                          "degraded": dict(self.degraded),
                                          "ts": time.time()})
        if self.config.daemon.search_batch_window_ms > 0:
            self.search_batcher = SearchBatcher(
                self,
                window_ms=self.config.daemon.search_batch_window_ms,
                max_batch=self.config.daemon.search_batch_max,
                max_inflight=self.config.daemon.search_batch_inflight,
            )

    async def run(self) -> None:
        await self.start()
        loop = asyncio.get_running_loop()
        self._loop = loop
        for sig in (signal.SIGTERM, signal.SIGINT):
            # RuntimeError/ValueError: not on the main thread (tests run the
            # daemon loop on a background thread)
            with contextlib.suppress(NotImplementedError, RuntimeError, ValueError):
                loop.add_signal_handler(sig, self._stop.set)
        checkpoint_task = asyncio.create_task(self._checkpoint_loop())
        await self._stop.wait()
        self.state = DaemonState.STOPPING
        self.events.publish("lifecycle", {"state": "stopping",
                                          "ts": time.time()})
        checkpoint_task.cancel()
        self.post_ingest.stop()
        self.governor.stop()
        self._server.close()
        # wait_closed() (3.12+) waits for every active connection handler;
        # persistent clients would pin the daemon open forever, so close
        # their transports first and bound the drain (reference:
        # daemon_sigterm_test expects prompt exit with clients attached)
        for w in list(self._conns):
            with contextlib.suppress(Exception):
                w.close()
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._server.wait_closed(), timeout=10.0)
        await loop.run_in_executor(
            self._pool, self._run_locked, lambda _req: self.app.close(), {})
        with contextlib.suppress(FileNotFoundError):
            self.config.socket_path.unlink()
        self._pool.shutdown(wait=False)
        self._search_pool.shutdown(wait=False)

    async def _checkpoint_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(CHECKPOINT_INTERVAL_S)
            with contextlib.suppress(Exception):
                await loop.run_in_executor(
                    self._pool, self._run_locked,
                    lambda _req: self.app.checkpoint(), {})

    # -- connection handling ---------------------------------------------------------
    # per-connection pipelining depth: how many requests one connection may
    # have in flight before reads pause (backpressure). Serving throughput
    # depends on it — a strictly request/response connection caps offered
    # load at 1/latency per client, while a pipelined one keeps the search
    # batcher fed from a handful of connections (reference: the Asio
    # transport multiplexes typed requests over persistent connections).
    MAX_CONN_INFLIGHT = 256

    async def _handle_conn(self, reader, writer) -> None:
        from .protocol import async_read_frame_ex

        self._conns.add(writer)
        wlock = asyncio.Lock()
        sem = asyncio.Semaphore(self.MAX_CONN_INFLIGHT)
        tasks: set[asyncio.Task] = set()

        async def serve_one(req: dict, json_mode: bool) -> None:
            try:
                resp = await self._dispatch(req)
                resp["id"] = req.get("id")
                # one writer at a time: encode_frames emits a whole framed
                # message per write, so the lock keeps frames contiguous
                async with wlock:
                    await async_write_frame(writer, resp, json_mode=json_mode)
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                sem.release()

        try:
            while True:
                try:
                    req, json_mode = await async_read_frame_ex(reader)
                except (asyncio.IncompleteReadError, FrameError, ConnectionError):
                    break
                await sem.acquire()
                t = asyncio.create_task(serve_one(req, json_mode))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            # client gone (or shutdown): responses are undeliverable —
            # cancel what hasn't completed rather than keep computing
            for t in list(tasks):
                t.cancel()
            self._conns.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    # trivial handlers run inline on the event loop so liveness checks are
    # never queued behind long worker operations (e.g. first-search compile)
    FAST_HANDLERS = frozenset({"ping", "shutdown"})

    @staticmethod
    def _waits_on_post_ingest(req: dict) -> bool:
        """A wait for the post-ingest worker, which takes the write side of
        state_lock itself: it must run off the mutator worker, unlocked."""
        return req.get("type") == "queue" and req.get("op") == "wait_idle"

    @staticmethod
    def _batchable_search(req: dict) -> bool:
        """Every search coalesces through the batcher: plain and filtered
        requests share the fused program (per-request doc-mask rows);
        fts/auto requests fall back to the single-query path inside the
        batch worker, still off the mutator thread."""
        return req.get("type") == "search"

    async def _dispatch(self, req: dict) -> dict:
        rtype = req.get("type", "")
        handler = getattr(self, f"handle_{rtype}", None)
        if handler is None:
            return {"ok": False, "error": f"unknown request type: {rtype}",
                    "code": int(ErrorCode.INVALID_ARGUMENT)}
        rid = str(req.get("id", ""))
        if rid and self._cancel_flags.pop(rid, None):
            # cancelled while queued: skip execution entirely (in-flight
            # device programs are not preemptible — cancel is only
            # effective before the executor picks the request up)
            return {"ok": False, "error": "cancelled",
                    "code": int(ErrorCode.CANCELLED)}
        self._requests_handled += 1
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        try:
            if rtype in self.FAST_HANDLERS:
                result = handler(req)
            elif self._waits_on_post_ingest(req):
                result = await loop.run_in_executor(None, handler, req)
            elif self.search_batcher is not None and self._batchable_search(req):
                result = await self.search_batcher.submit(req)
            else:
                limiter = getattr(self, "limiter", None)
                if limiter is not None and not limiter.try_acquire():
                    self._record_metric(rtype, t0, ok=False)
                    return {"ok": False,
                            "error": "overloaded (rtt-gradient admission)",
                            "code": int(ErrorCode.RESOURCE_EXHAUSTED)}
                try:
                    result = await loop.run_in_executor(
                        self._pool, self._run_locked, handler, req)
                finally:
                    if limiter is not None:
                        limiter.release()
                        limiter.record(time.monotonic() - t0)
            self._record_metric(rtype, t0, ok=True)
            return {"ok": True, "result": result}
        except YamsError as e:
            self._record_metric(rtype, t0, ok=False)
            return {"ok": False, "error": str(e), "code": int(e.code)}
        except NotImplementedError as e:
            self._record_metric(rtype, t0, ok=False)
            return {"ok": False, "error": str(e),
                    "code": int(ErrorCode.UNSUPPORTED)}
        except Exception as e:
            traceback.print_exc()
            self._record_metric(rtype, t0, ok=False)
            return {"ok": False, "error": f"{type(e).__name__}: {e}",
                    "code": int(ErrorCode.INTERNAL)}

    def _run_locked(self, handler, req: dict):
        """Mutator-worker handlers run under the write side of state_lock:
        exclusive with in-flight search batches (which hold the read side),
        so reads never observe a half-applied engine mutation."""
        with self.state_lock.write():
            return handler(req)

    def _record_metric(self, rtype: str, t0: float, ok: bool) -> None:
        """Per-request-type counters + latency (reference: DaemonMetrics
        fsm/stream registries aggregated into status snapshots)."""
        m = self._metrics.setdefault(
            rtype, {"count": 0, "errors": 0, "total_ms": 0.0, "max_ms": 0.0}
        )
        dt = (time.monotonic() - t0) * 1e3
        m["count"] += 1
        if not ok:
            m["errors"] += 1
        m["total_ms"] += dt
        m["max_ms"] = max(m["max_ms"], dt)

    # -- handlers (run on the worker thread) -------------------------------------------
    def handle_ping(self, req):
        return {"pong": True, "state": self.state, "backend": "torch",
                "device": str(self.device)}

    def handle_status(self, req):
        snap = self.app.stats.snapshot(detailed=req.get("detailed", False))
        snap["state"] = self.state
        snap["degraded"] = getattr(self, "degraded", {})
        snap["requests_handled"] = self._requests_handled
        snap["backend"] = "torch"
        snap["device"] = str(self.device)
        if req.get("detailed"):
            snap["requests_by_type"] = {
                t: {"count": m["count"], "errors": m["errors"],
                    "avg_ms": round(m["total_ms"] / max(m["count"], 1), 2),
                    "max_ms": round(m["max_ms"], 2)}
                for t, m in sorted(self._metrics.items())
            }
        snap["daemon_uptime_s"] = round(time.time() - self._started_at, 1)
        snap["post_ingest"] = self.post_ingest.snapshot()
        p = self.governor.pressure
        snap["pressure"] = {"cpu": round(p.cpu, 3), "memory": round(p.memory, 3),
                            "queues": round(p.queues, 3), "level": p.level}
        snap["tuning_profile"] = self.advisor.profile
        if self.search_batcher is not None:
            snap["search_batching"] = self.search_batcher.snapshot()
        limiter = getattr(self, "limiter", None)
        if limiter is not None:
            snap["admission"] = {"limit": limiter.limit,
                                 "inflight": limiter._inflight}
        return snap

    def handle_events(self, req):
        """Drain recent internal-bus events from a named channel
        (lifecycle | post_ingest); non-blocking."""
        bus = getattr(self, "events", None)
        if bus is None:
            return {"events": [], "depth": 0}
        name = req.get("channel", "post_ingest")
        out = []
        for _ in range(min(int(req.get("limit", 100)), 1000)):
            ev = bus.poll(name)
            if ev is None:
                break
            out.append(ev)
        return {"events": out, "depth": bus.depth(name)}

    def handle_shutdown(self, req):
        # runs on the worker thread; hop to the loop thread to set the event
        self._loop.call_soon_threadsafe(self._stop.set)
        return {"stopping": True}

    def handle_search(self, req):
        r = self.app.search.search(
            req["query"],
            limit=req.get("limit", 10),
            search_type=req.get("search_type", "hybrid"),
            tags=req.get("tags"),
            path_glob=req.get("path_glob"),
            collection=req.get("collection"),
            filters=req.get("filters"),
        )
        return {
            "hits": [_asdict(h) for h in r.hits],
            "total": r.total,
            "duration_ms": r.duration_ms,
        }

    def handle_grep(self, req):
        r = self.app.grep.grep(
            req["pattern"],
            ignore_case=req.get("ignore_case", False),
            literal=req.get("literal"),
            tags=req.get("tags"),
            path_glob=req.get("path_glob"),
            max_matches=req.get("max_matches", 1000),
            context=req.get("context", 0),
            word_boundary=req.get("word_boundary", False),
            filters=req.get("filters"),
            semantic_limit=req.get("semantic_limit", 0),
        )
        return {
            "matches": [_asdict(m) for m in r.matches],
            "files_searched": r.files_searched,
            "files_matched": r.files_matched,
            "truncated": r.truncated,
        }

    def handle_add_bytes(self, req):
        async_ingest = req.get("async_ingest", False)
        res = self.app.documents.add_bytes(
            req["data"], req["name"],
            tags=req.get("tags"), metadata=req.get("metadata"),
            mime_type=req.get("mime_type", ""),
            collection=req.get("collection", ""),
            auto_index=req.get("auto_index", True) and not async_ingest,
        )
        if async_ingest:
            # post-ingest stages (extraction/KG/embedding) run off the request
            # path, like the reference's PostIngestQueue
            self.post_ingest.enqueue(res.document_id)
        return _asdict(res)

    def handle_queue(self, req):
        op = req.get("op", "status")
        if op == "pause":
            self.post_ingest.pause()
        elif op == "resume":
            self.post_ingest.resume()
        elif op == "wait_idle":
            idle = self.post_ingest.wait_idle(req.get("timeout", 60.0))
            return {**self.post_ingest.snapshot(), "idle": idle}
        return self.post_ingest.snapshot()

    def handle_add_path(self, req):
        p = pathlib.Path(req["path"])
        if p.is_dir():
            rep = self.app.indexing.add_directory(
                p, recursive=req.get("recursive", True),
                include=req.get("include"), exclude=req.get("exclude"),
                tags=req.get("tags"), collection=req.get("collection", ""),
                snapshot=req.get("snapshot", False),
                snapshot_label=req.get("snapshot_label", ""),
            )
            return _asdict(rep)
        res = self.app.documents.add_file(
            p, tags=req.get("tags"), metadata=req.get("metadata"),
            collection=req.get("collection", ""),
            mime_type=req.get("mime_type", ""),
            auto_index=req.get("auto_index", True),
        )
        return _asdict(res)

    def handle_get(self, req):
        doc = self.app.documents.get(req["selector"])
        return _asdict(doc)

    def handle_cat(self, req):
        return {"data": self.app.documents.cat(req["selector"])}

    def handle_get_text(self, req):
        return {"text": self.app.documents.get_text(req["selector"])}

    def handle_list(self, req):
        docs = self.app.documents.list(
            limit=req.get("limit", 100), offset=req.get("offset", 0),
            pattern=req.get("pattern"), tags=req.get("tags"),
            collection=req.get("collection"), filters=req.get("filters"),
            sort=req.get("sort"), reverse=req.get("reverse", False),
            with_tags=req.get("with_tags", False),
        )
        return {"documents": [_asdict(d) for d in docs]}

    def handle_delete(self, req):
        return {"deleted": self.app.documents.delete(req["selector"])}

    def handle_update(self, req):
        doc = self.app.documents.update_metadata(
            req["selector"], metadata=req.get("metadata"),
            add_tags=req.get("add_tags"), remove_tags=req.get("remove_tags"),
        )
        return _asdict(doc)

    def handle_graph_explore(self, req):
        return self.app.graph.explore(req["query"], limit=req.get("limit", 25))

    def handle_graph_impact(self, req):
        return {"impact": self.app.graph.impact(
            req["selector"], hops=req.get("hops", 2),
            limit=req.get("limit", 25))}

    def handle_graph_trace(self, req):
        return {"path": self.app.graph.trace(req["from"], req["to"])}

    def handle_graph_related(self, req):
        return {"related": self.app.graph.related(req["selector"],
                                                  limit=req.get("limit", 20))}

    def handle_embed(self, req):
        vecs = self.app.search_engine.provider.encode(req["texts"])
        return {"vectors": [v.tolist() for v in vecs],
                "dim": int(vecs.shape[1]) if len(vecs) else 0,
                "model": self.app.config.embedding.profile}

    def handle_feedback(self, req):
        """Relevance feedback (reference: SearchTuner reward pipeline,
        search_tuner.cpp — rewards come from clicks/explicit relevance).
        Accepts a doc id or content hash; rewards the bandit's last-pulled
        arm for the corpus profile and bumps/decays the hotzone."""
        doc_id = req.get("doc_id")
        if doc_id is None and not req.get("hash"):
            raise InvalidArgumentError("feedback needs a doc_id or a hash")
        if doc_id is None:
            row = self.app.db.execute(
                "SELECT id FROM documents WHERE sha256_hash=?",
                (req["hash"],)).fetchone()
            if row is None:
                from ..core.errors import NotFoundError

                raise NotFoundError(f"no document {req['hash']}")
            doc_id = int(row[0])
        self.app.search_engine.record_feedback(
            int(doc_id), relevant=bool(req.get("relevant", True)))
        return {"ok": True, "doc_id": int(doc_id)}

    def handle_session(self, req):
        s = self.app.sessions
        op = req["op"]
        if op == "list":
            return {"sessions": s.list()}
        if op == "pin":
            s.pin(req["pattern"], req.get("name"))
        elif op == "unpin":
            s.unpin(req["pattern"], req.get("name"))
        elif op == "warm":
            return {"warmed": s.warm(req.get("name"))}
        elif op == "create":
            s.create(req["name"])
        elif op == "delete":
            s.delete(req["name"])
        return {"ok": True}

    def handle_repair(self, req):
        from ..services.repair_service import RepairService

        svc = RepairService(self.app)
        if req.get("dry_run"):
            # read-only: report the planned ops + current health probes
            # instead of executing (doctor checks the same invariants the
            # repair ops fix)
            ops = req.get("ops") or list(svc.OPS)
            plan = {op: ("planned" if hasattr(svc, f"repair_{op}")
                         else "unknown op") for op in ops}
            checks = {k: {"ok": bool(v[0]), "detail": v[1]}
                      for k, v in svc.doctor().items()}
            return {"dry_run": True, "plan": plan, "doctor": checks}
        return svc.run(req.get("ops"))

    def handle_doctor(self, req):
        from ..services.repair_service import RepairService

        return {k: list(v) for k, v in RepairService(self.app).doctor().items()}

    def handle_suggest_context(self, req):
        return {"context": self.app.search.suggest_context(
            req["query"], limit=req.get("limit", 5),
            max_chars=req.get("max_chars", 4000))}

    def handle_download(self, req):
        res = self.app.downloads.download(
            req["url"], expected_sha256=req.get("expected_sha256", ""),
            store=req.get("store", True), tags=req.get("tags"),
        )
        return _asdict(res)

    def handle_plugins(self, req):
        op = req.get("op", "list")
        if op == "trust":
            self.plugins.trust(req["path"])
        elif op == "load":
            # Trust gate: load executes plugin code in the daemon process, so
            # refuse paths not on the trust list (reference PluginManager
            # refuses non-trusted loads; trust must be granted explicitly
            # first).
            import pathlib as _pl

            p = _pl.Path(req["path"]).resolve()
            trusted = [t.resolve() for t in self.plugins.trusted_paths()]
            if not any(p == t or t in p.parents for t in trusted):
                raise YamsError(
                    f"plugin path not trusted: {p} (run plugins op=trust first)"
                )
            m = self.plugins.load_file(req["path"])
            if m is None:
                raise YamsError(f"plugin load failed: {self.plugins.errors}")
        return {"plugins": self.plugins.list(), "health": self.plugins.health()}

    def handle_checkpoint(self, req):
        self.app.checkpoint()
        return {"checkpointed": True}

    # -- chunked content streaming (GetInit/GetChunk/GetEnd,
    #    ipc_protocol_requests.h:522-621) ----------------------------------------------
    def handle_get_init(self, req):
        import uuid as _uuid

        data = self.app.documents.cat(req["selector"])
        handle = _uuid.uuid4().hex[:16]
        # bound concurrent sessions; evict oldest (reference bounds its
        # RetrievalSessions similarly)
        while len(self._get_sessions) >= 64:
            self._get_sessions.pop(next(iter(self._get_sessions)))
        self._get_sessions[handle] = {"data": data, "created": time.time()}
        return {"handle": handle, "size": len(data),
                "chunk_size": req.get("chunk_size", 1 << 20)}

    def handle_get_chunk(self, req):
        sess = self._get_sessions.get(req["handle"])
        if sess is None:
            raise YamsError(f"unknown get handle: {req['handle']}")
        off = int(req.get("offset", 0))
        n = int(req.get("size", 1 << 20))
        data = sess["data"]
        return {"data": data[off:off + n], "offset": off,
                "eof": off + n >= len(data)}

    def handle_get_end(self, req):
        return {"closed": self._get_sessions.pop(req["handle"], None) is not None}

    def handle_cancel(self, req):
        """Best-effort cancellation (CancelRequest, ipc_protocol_requests.h:1046):
        download jobs cancel hard; other request ids are cancelled if they
        are still queued (the dispatcher checks the flag before execution;
        in-flight device programs are not preemptible)."""
        if "job_id" in req:
            return self.app.downloads.cancel_job(req["job_id"])
        rid = str(req.get("request_id", ""))
        self._cancel_flags[rid] = True
        # bound the flag set: ids that never arrive would otherwise
        # accumulate forever in a long-lived daemon
        while len(self._cancel_flags) > 1024:
            self._cancel_flags.pop(next(iter(self._cancel_flags)))
        return {"cancel_requested": rid}

    # -- model lifecycle (LoadModel/UnloadModel/ModelStatus,
    #    ipc_protocol_requests.h:1195-1291) --------------------------------------------
    def handle_model_load(self, req):
        from ..embed.provider import create_provider

        name = req["model"]
        opts = req.get("options", {})
        if name not in self._models:
            self._models[name] = create_provider(name, device=self.app.device, **opts)
        p = self._models[name]
        return {"model": name, "dim": p.dim, "space_id": p.space_id}

    def handle_model_unload(self, req):
        return {"unloaded": self._models.pop(req["model"], None) is not None}

    def handle_model_status(self, req):
        from ..embed.provider import list_providers

        eng = self.app.search_engine.provider
        return {
            "default": {"name": self.app.config.embedding.profile,
                        "dim": eng.dim, "space_id": eng.space_id},
            "loaded": [{"name": n, "dim": p.dim, "space_id": p.space_id}
                       for n, p in self._models.items()],
            "registry": list_providers(),
        }

    # -- embedding services (BatchEmbedding/EmbedDocuments,
    #    ipc_protocol_requests.h:1107-1194) --------------------------------------------
    def handle_embed_batch(self, req):
        import numpy as np

        from ..embed.batcher import DynamicBatcher

        provider = self._models.get(req.get("model", "")) \
            or self.app.search_engine.provider
        batcher = DynamicBatcher(max_tokens=req.get("max_batch_tokens", 8192))
        chunks, n_batches = [], 0
        for batch in batcher.batches(req["texts"]):
            chunks.append(provider.encode(batch))
            n_batches += 1
        vecs = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 0))
        return {"vectors": [v.tolist() for v in vecs],
                "dim": int(vecs.shape[1]) if len(vecs) else 0,
                "batches": n_batches}

    def handle_embed_documents(self, req):
        """Queue stored documents for (re-)embedding via the post-ingest
        pipeline — the daemon-side EmbedDocumentsRequest."""
        queued = []
        for sel in req["selectors"]:
            doc = self.app.documents.get(sel)
            self.app.metadata.set_embedding_status(doc.id, "pending")
            self.post_ingest.enqueue(doc.id)
            queued.append(doc.id)
        return {"queued": queued}

    # -- download jobs (DownloadStatus/CancelDownloadJob/ListDownloadJobs) ---------
    def handle_download_start(self, req):
        job_id = self.app.downloads.start_job(
            req["url"], expected_sha256=req.get("expected_sha256", ""),
            store=req.get("store", True), tags=req.get("tags"),
        )
        return {"job_id": job_id}

    def handle_download_status(self, req):
        return self.app.downloads.job_status(req["job_id"])

    def handle_download_cancel(self, req):
        return self.app.downloads.cancel_job(req["job_id"])

    def handle_download_list(self, req):
        return {"jobs": self.app.downloads.list_jobs()}

    # -- history / snapshots / prune (FileHistory/Prune/ListSnapshots/Restore*,
    #    ipc_protocol_requests.h:1882-2117) --------------------------------------------
    def handle_file_history(self, req):
        return self.app.documents.file_history(
            req["path"], req.get("limit", 50))

    def handle_prune(self, req):
        return self.app.documents.prune(
            older_than_s=req.get("older_than_s"),
            pattern=req.get("pattern"),
            tags=req.get("tags"),
            dry_run=req.get("dry_run", True),
        )

    def handle_snapshots_list(self, req):
        return {"snapshots": self.app.trees.list_snapshots()}

    def handle_restore_snapshot(self, req):
        return self.app.indexing.restore_snapshot(
            req["snapshot_id"], req["target_dir"],
            overwrite=req.get("overwrite", False),
            dry_run=req.get("dry_run", False))

    def handle_restore_collection(self, req):
        return self.app.indexing.restore_collection(
            req["collection"], req["target_dir"],
            overwrite=req.get("overwrite", False),
            dry_run=req.get("dry_run", False))

    def handle_tree_diff(self, req):
        """Diff two snapshots (ListTreeDiffRequest, ipc_protocol_requests.h:3279)."""
        from ..metadata.tree import TreeDiffer

        old = self.app.trees.get_snapshot(req["from_snapshot"])
        new = self.app.trees.get_snapshot(req["to_snapshot"])
        changes = TreeDiffer.diff(old, new)
        return {"changes": [_asdict(c) for c in changes]}

    # -- typed plugin ops (PluginScan/Load/Unload/Trust*,
    #    ipc_protocol_requests.h:2118-2243) --------------------------------------------
    def handle_plugin_scan(self, req):
        found = self.plugins.scan(req.get("dir"))
        return {"found": found, "plugins": self.plugins.list()}

    def handle_plugin_load(self, req):
        return self.handle_plugins({"op": "load", "path": req["path"]})

    def handle_plugin_unload(self, req):
        ok = self.plugins.unload(req["name"])
        return {"unloaded": ok, "plugins": self.plugins.list()}

    def handle_plugin_trust_list(self, req):
        return {"trusted": [str(p) for p in self.plugins.trusted_paths()]}

    def handle_plugin_trust_add(self, req):
        self.plugins.trust(req["path"])
        return self.handle_plugin_trust_list(req)

    def handle_plugin_trust_remove(self, req):
        self.plugins.untrust(req["path"])
        return self.handle_plugin_trust_list(req)

    # -- graph long tail (GraphSymbolLookup/AffectedTests/PathHistory/
    #    Validate/Repair, ipc_protocol_requests.h:2506-2913) ---------------------------
    def handle_graph_symbol_lookup(self, req):
        return {"symbols": self.app.symbols.lookup(
            req["name"], limit=req.get("limit", 50))}

    def handle_graph_affected_tests(self, req):
        """Impact set filtered to test files (GraphAffectedTestsRequest)."""
        import fnmatch

        impact = self.app.graph.impact(
            req["selector"], hops=req.get("hops", 2),
            limit=req.get("limit", 200))
        pats = req.get("test_patterns",
                       ["*test*", "*spec*", "tests/*", "*_test.*"])
        tests = [e for e in impact
                 if any(fnmatch.fnmatch(e.get("path", ""), p) for p in pats)]
        return {"affected_tests": tests}

    def handle_graph_path_history(self, req):
        hist = self.handle_file_history({"path": req["path"],
                                         "limit": req.get("limit", 50)})
        ents = []
        try:
            doc = self.app.documents.get(req["path"])
            ents = [{"node_id": nid, "name": name, "weight": w}
                    for nid, name, w in self.app.kg.entities_for_document(doc.id)]
        except Exception:
            pass
        return {"versions": hist["versions"], "entities": ents}

    def handle_graph_validate(self, req):
        """KG referential integrity (GraphValidateRequest): dangling edges,
        aliases, and doc links."""
        db = self.app.db
        dangling_edges = db.execute(
            """SELECT COUNT(*) FROM kg_edges e
               WHERE NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=e.src_node_id)
                  OR NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=e.dst_node_id)"""
        ).fetchone()[0]
        dangling_aliases = db.execute(
            """SELECT COUNT(*) FROM kg_aliases a
               WHERE NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=a.node_id)"""
        ).fetchone()[0]
        dangling_doc_links = db.execute(
            """SELECT COUNT(*) FROM doc_entities d
               WHERE NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=d.node_id)
                  OR NOT EXISTS (SELECT 1 FROM documents x WHERE x.id=d.document_id)"""
        ).fetchone()[0]
        return {"nodes": self.app.kg.node_count(),
                "edges": self.app.kg.edge_count(),
                "dangling_edges": dangling_edges,
                "dangling_aliases": dangling_aliases,
                "dangling_doc_links": dangling_doc_links,
                "valid": not (dangling_edges or dangling_aliases
                              or dangling_doc_links)}

    def handle_graph_repair(self, req):
        """Drop dangling KG rows, then rebuild pending entity links
        (GraphRepairRequest)."""
        db = self.app.db
        with db.lock, db.conn:
            e = db.conn.execute(
                """DELETE FROM kg_edges WHERE
                   NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=kg_edges.src_node_id)
                   OR NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=kg_edges.dst_node_id)"""
            ).rowcount
            a = db.conn.execute(
                """DELETE FROM kg_aliases WHERE
                   NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=kg_aliases.node_id)"""
            ).rowcount
            d = db.conn.execute(
                """DELETE FROM doc_entities WHERE
                   NOT EXISTS (SELECT 1 FROM kg_nodes n WHERE n.id=doc_entities.node_id)
                   OR NOT EXISTS (SELECT 1 FROM documents x
                                  WHERE x.id=doc_entities.document_id)"""
            ).rowcount
        self.app.kg._bump()  # raw-SQL KG mutation: invalidate serving caches
        linked = self.app.graph.index_pending(limit=req.get("limit", 500))
        return {"removed_edges": e, "removed_aliases": a,
                "removed_doc_links": d, "relinked_docs": linked}

    def handle_kg_ingest(self, req):
        """Direct KG node/edge ingestion (KgIngestRequest,
        ipc_protocol_requests.h:2914)."""
        kg = self.app.kg
        node_ids = {}
        for n in req.get("nodes", []):
            nid = kg.upsert_node(
                n["key"], n.get("label", n["key"]),
                type_=n.get("type", "entity"),
                properties=n.get("properties"))
            node_ids[n["key"]] = nid
            for alias in n.get("aliases", []):
                kg.add_alias(nid, alias, source="kg_ingest")
        edges = 0
        for e in req.get("edges", []):
            src = node_ids.get(e["src"]) or kg.find_node(e["src"])
            dst = node_ids.get(e["dst"]) or kg.find_node(e["dst"])
            if src is not None and dst is not None:
                kg.add_edge(src, dst, e.get("relation", "related"),
                            weight=e.get("weight", 1.0))
                edges += 1
        return {"nodes": node_ids, "edges_added": edges}

    def handle_metadata_value_counts(self, req):
        """Distinct values + counts for a metadata key
        (MetadataValueCountsRequest, ipc_protocol_requests.h:3020)."""
        rows = self.app.db.execute(
            "SELECT value, COUNT(*) FROM metadata WHERE key=? "
            "GROUP BY value ORDER BY COUNT(*) DESC LIMIT ?",
            (req["key"], req.get("limit", 100)),
        ).fetchall()
        return {"key": req["key"],
                "values": [{"value": r[0], "count": r[1]} for r in rows]}

    def handle_stats(self, req):
        """GetStatsRequest — stats snapshot without daemon lifecycle fields."""
        return self.app.stats.snapshot(detailed=req.get("detailed", False))

    def handle_batch(self, req):
        """Batch envelope with per-item error isolation (BatchRequest,
        ipc_protocol_requests.h:3332)."""
        out = []
        for sub in req.get("requests", [])[:256]:
            rtype = sub.get("type", "")
            handler = getattr(self, f"handle_{rtype}", None)
            if (handler is None or rtype in ("batch", "shutdown")
                    or self._waits_on_post_ingest(sub)):
                out.append({"ok": False,
                            "error": f"unknown or disallowed type: {rtype}"})
                continue
            try:
                out.append({"ok": True, "result": handler(sub)})
            except YamsError as e:
                out.append({"ok": False, "error": str(e), "code": int(e.code)})
            except Exception as e:
                out.append({"ok": False, "error": f"{type(e).__name__}: {e}"})
        return {"responses": out}


def run_daemon(config: Config, device: str | torch.device = "cuda") -> None:
    """Run the daemon in the foreground (blocking)."""
    daemon = YamsDaemon(config, device=device)
    asyncio.run(daemon.run())


def spawn_daemon(config: Config, device: str = "cuda") -> int:
    """Start a detached daemon process; returns its pid.

    Parity: DaemonClient auto-spawn (daemon_client.h) + daemonize
    (daemon_main.cpp) — we use a detached subprocess instead of fork/setsid
    so the device runtime initializes fresh in the child.
    """
    env = dict(os.environ)
    env["YAMS_TPU_STORAGE"] = str(config.data_dir)
    log = config.data_dir / "daemon.log"
    config.data_dir.mkdir(parents=True, exist_ok=True)
    with open(log, "ab") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "yams_tpu_torch.daemon", "--device", str(device)],
            stdout=logf, stderr=logf, stdin=subprocess.DEVNULL,
            start_new_session=True, env=env,
            cwd=str(pathlib.Path(__file__).resolve().parents[2]),
        )
    (config.data_dir / "daemon.pid").write_text(str(proc.pid))
    # wait for the socket to come up
    for _ in range(100):
        if config.socket_path.exists():
            break
        time.sleep(0.1)
    return proc.pid
