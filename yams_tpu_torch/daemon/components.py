"""Daemon runtime components.

Parity (SURVEY §2.8):
  - InternalEventBus   — named typed channels, MPMC (InternalEventBus.h)
  - ResourceGovernor   — periodic pressure sampling -> admission/throttle
                         decisions (ResourceGovernor.h:134-154, 250ms tick)
  - GradientLimiter    — TCP-Vegas-style RTT-gradient concurrency limiter
                         (GradientLimiter.h:32-38)
  - TuneAdvisor        — env-var knob registry with Efficient/Balanced/
                         Aggressive profiles (TuneAdvisor.h:43-66)
  - PostIngestQueue    — staged post-add pipeline: Extraction -> KnowledgeGraph
                         -> Embedding, with per-stage counters and batched
                         device launches (PostIngestQueue.h:361-371)

Copied from yams_tpu/daemon/components.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Callable


# ---------------------------------------------------------------------------
class InternalEventBus:
    """Named channels with bounded thread-safe queues."""

    def __init__(self):
        self._channels: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()

    def channel(self, name: str, capacity: int = 1024) -> queue.Queue:
        with self._lock:
            if name not in self._channels:
                self._channels[name] = queue.Queue(maxsize=capacity)
            return self._channels[name]

    def publish(self, name: str, event: Any, block: bool = False) -> bool:
        try:
            self.channel(name).put(event, block=block)
            return True
        except queue.Full:
            return False

    def poll(self, name: str, timeout: float | None = None) -> Any | None:
        try:
            return self.channel(name).get(
                block=timeout is not None, timeout=timeout
            )
        except queue.Empty:
            return None

    def depth(self, name: str) -> int:
        return self.channel(name).qsize()


# ---------------------------------------------------------------------------
@dataclasses.dataclass(slots=True)
class Pressure:
    cpu: float = 0.0       # load average / cores, 0..inf
    memory: float = 0.0    # used fraction 0..1
    queues: float = 0.0    # max queue fill fraction 0..1

    @property
    def level(self) -> str:
        worst = max(self.cpu / 2.0, self.memory, self.queues)
        if worst > 0.9:
            return "critical"
        if worst > 0.7:
            return "high"
        if worst > 0.4:
            return "moderate"
        return "low"


class ResourceGovernor:
    """Samples system pressure; callers consult admit()/throttle_factor()."""

    def __init__(self, tick_s: float = 0.25):
        self.tick_s = tick_s
        self._pressure = Pressure()
        self._queue_sources: list[Callable[[], float]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_queue_source(self, fn: Callable[[], float]) -> None:
        self._queue_sources.append(fn)

    def sample(self) -> Pressure:
        try:
            cores = os.cpu_count() or 1
            cpu = os.getloadavg()[0] / cores
        except OSError:
            cpu = 0.0
        memory = 0.0
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1])
            total = info.get("MemTotal", 1)
            avail = info.get("MemAvailable", total)
            memory = 1.0 - avail / total
        except (OSError, KeyError):
            pass
        queues = max((fn() for fn in self._queue_sources), default=0.0)
        self._pressure = Pressure(cpu=cpu, memory=memory, queues=queues)
        return self._pressure

    @property
    def pressure(self) -> Pressure:
        return self._pressure

    def admit(self) -> bool:
        return self._pressure.level != "critical"

    def admit_search(self) -> bool:
        """Admission for batchable searches: memory + queue pressure only.

        Deliberately ignores loadavg — a saturated serving host runs at
        load >= cores by design, and the batcher's bounded queue is already
        the latency guard; shedding reads on CPU load turns every
        saturation benchmark (and every busy production box) into a 100%
        error storm. Memory stays a hard gate: an OOM-killed daemon serves
        nobody."""
        p = self._pressure
        return max(p.memory, p.queues) <= 0.9

    def throttle_factor(self) -> float:
        """1.0 = full speed; scales batch sizes / concurrency down."""
        return {"low": 1.0, "moderate": 1.0, "high": 0.5, "critical": 0.1}[
            self._pressure.level
        ]

    def start(self) -> None:
        if self._thread:
            return

        def loop():
            while not self._stop.wait(self.tick_s):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None


# ---------------------------------------------------------------------------
class RWLock:
    """Writer-preferring reader/writer lock.

    The daemon's serving split (reference: WriteCoordinator serializes all
    mutations while reads fan out across worker threads): search batches are
    read-only over the engine and run concurrently on the search pool under
    the read side; every mutating handler runs on the single mutator worker
    under the write side. Writer preference keeps a steady search load from
    starving ingest.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _Guard:
        __slots__ = ("_acquire", "_release")

        def __init__(self, acquire, release):
            self._acquire, self._release = acquire, release

        def __enter__(self):
            self._acquire()

        def __exit__(self, *exc):
            self._release()
            return False

    def read(self) -> "RWLock._Guard":
        return self._Guard(self.acquire_read, self.release_read)

    def write(self) -> "RWLock._Guard":
        return self._Guard(self.acquire_write, self.release_write)


# ---------------------------------------------------------------------------
class GradientLimiter:
    """RTT-gradient concurrency limit: shrink when latency trends up."""

    def __init__(self, initial: int = 4, min_limit: int = 1, max_limit: int = 64,
                 smoothing: float = 0.2):
        self.limit = initial
        self.min_limit = min_limit
        self.max_limit = max_limit
        self.smoothing = smoothing
        self._short = 0.0
        self._long = 0.0
        self._lock = threading.Lock()
        self._inflight = 0

    def record(self, rtt_s: float) -> None:
        with self._lock:
            if self._long == 0.0:
                self._short = self._long = rtt_s
            self._short += self.smoothing * (rtt_s - self._short)
            self._long += (self.smoothing / 10) * (rtt_s - self._long)
            gradient = self._long / max(self._short, 1e-9)
            new = self.limit * gradient + 0.5  # +queue allowance
            self.limit = int(max(self.min_limit, min(self.max_limit, new)))

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight >= self.limit:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)


# ---------------------------------------------------------------------------
class TuneAdvisor:
    """Env-var knob registry with profiles (YAMS_TPU_TUNING=efficient|balanced|aggressive)."""

    PROFILES = {
        "efficient": {"embed_batch_tokens": 4096, "ingest_workers": 1,
                      "scan_block_rows": 1024, "checkpoint_interval_s": 600},
        "balanced": {"embed_batch_tokens": 16384, "ingest_workers": 2,
                     "scan_block_rows": 2048, "checkpoint_interval_s": 300},
        "aggressive": {"embed_batch_tokens": 65536, "ingest_workers": 4,
                       "scan_block_rows": 4096, "checkpoint_interval_s": 120},
    }

    def __init__(self, env: dict | None = None):
        self.env = env if env is not None else os.environ

    @property
    def profile(self) -> str:
        p = self.env.get("YAMS_TPU_TUNING", "balanced").lower()
        return p if p in self.PROFILES else "balanced"

    def get(self, knob: str) -> int:
        override = self.env.get(f"YAMS_TPU_{knob.upper()}")
        if override is not None:
            try:
                return int(override)
            except ValueError:
                pass
        return self.PROFILES[self.profile][knob]


# ---------------------------------------------------------------------------
@dataclasses.dataclass(slots=True)
class StageStats:
    processed: int = 0
    failed: int = 0
    inflight: int = 0


class PostIngestQueue:
    """Staged post-add pipeline over the app services.

    Stages (PostIngestQueue.h:361-371, minus plugin-only stages):
      extraction — text extraction for docs whose content wasn't inline-extractable
      kg         — entity mining + graph linking (GraphService)
      embedding  — chunk + encode + device index insert, batched (DynamicBatcher)

    Single worker by default (the engine is effectively single-writer); the
    ResourceGovernor's throttle factor scales embedding batch budgets.
    """

    def __init__(self, app, governor: ResourceGovernor | None = None,
                 advisor: TuneAdvisor | None = None, capacity: int = 4096,
                 bus: "InternalEventBus | None" = None,
                 state_lock: "RWLock | None" = None):
        self.app = app
        self.governor = governor
        self.advisor = advisor or TuneAdvisor()
        self.bus = bus
        # the daemon's reader/writer lock: each mutating stage runs under
        # the write side so concurrent search batches (read side) never see
        # a half-applied engine/KG/metadata mutation. Per-STAGE sections,
        # not per-batch: the embedding encode is the long pole and holding
        # write across the whole batch would starve reads.
        self.state_lock = state_lock
        self._q: queue.Queue[int | None] = queue.Queue(maxsize=capacity)
        self.stats = {
            "extraction": StageStats(), "kg": StageStats(),
            "embedding": StageStats(),
        }
        self._paused = threading.Event()
        self._stop = threading.Event()
        # idleness = "no enqueued item is unprocessed", tracked as a counter
        # under a condition: an Event set from the worker races enqueue()
        # (worker sees the queue empty, enqueue clears+puts, worker sets —
        # wait_idle then returns while the new item is still pending)
        self._pending = 0
        self._idle_cv = threading.Condition()
        self._thread: threading.Thread | None = None

    def _write_guard(self):
        return (self.state_lock.write() if self.state_lock is not None
                else contextlib.nullcontext())

    def depth_fraction(self) -> float:
        return self._q.qsize() / max(self._q.maxsize, 1)

    def enqueue(self, doc_id: int) -> None:
        with self._idle_cv:
            self._pending += 1
        self._q.put(doc_id)

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def start(self) -> None:
        if self._thread:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None

    def wait_idle(self, timeout: float = 60.0) -> bool:
        with self._idle_cv:
            return self._idle_cv.wait_for(
                lambda: self._pending <= 0, timeout)

    def _mark_done(self, n: int) -> None:
        with self._idle_cv:
            self._pending -= n
            if self._pending <= 0:
                self._idle_cv.notify_all()

    # -- pipeline -----------------------------------------------------------------
    def _run(self) -> None:
        from ..embed.batcher import DynamicBatcher

        while not self._stop.is_set():
            batch: list[int] = []
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                break
            batch.append(item)
            # drain opportunistically into one embedding launch
            budget = self.advisor.get("embed_batch_tokens")
            if self.governor:
                budget = max(1024, int(budget * self.governor.throttle_factor()))
            while len(batch) < 64:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            while self._paused.is_set() and not self._stop.is_set():
                time.sleep(0.05)
            try:
                self._process_batch(batch, budget)
            finally:
                self._mark_done(len(batch))
                if self.bus is not None:
                    self.bus.publish("post_ingest", {
                        "docs": len(batch),
                        "pending": self._pending,
                        "ts": time.time(),
                    })

    def _process_batch(self, doc_ids: list[int], token_budget: int) -> None:
        texts: dict[int, str] = {}
        for doc_id in doc_ids:
            st = self.stats["extraction"]
            st.inflight += 1
            try:
                text = self.app.metadata.get_content(doc_id)
                if text is None:
                    # extraction stage: pull bytes from CAS and extract
                    from ..ingest.detection import detect_mime
                    from ..services.extraction import extract_text

                    doc = self.app.metadata.get_document(doc_id)
                    data = self.app.content_store.retrieve_bytes(doc.sha256_hash)
                    got = extract_text(data, doc.mime_type or
                                       detect_mime(data[:512], doc.file_path))
                    if got:
                        with self._write_guard():
                            self.app.metadata.set_content(
                                doc_id, got[0], got[1] or doc.file_name)
                        text = got[0]
                if text is not None:
                    texts[doc_id] = text
                st.processed += 1
            except Exception:
                st.failed += 1
            finally:
                st.inflight -= 1

        for doc_id, text in texts.items():
            st = self.stats["kg"]
            st.inflight += 1
            try:
                with self._write_guard():
                    self.app.graph.index_document(doc_id, text)
                    doc = self.app.metadata.get_document(doc_id)
                    self.app.symbols.index_document(doc_id, text,
                                                    doc.mime_type)
                st.processed += 1
            except Exception:
                st.failed += 1
            finally:
                st.inflight -= 1

        from ..embed.batcher import DynamicBatcher

        batcher = DynamicBatcher(max_tokens=token_budget)
        items = list(texts.items())
        for sub in batcher.batches(items, text_of=lambda kv: kv[1]):
            st = self.stats["embedding"]
            st.inflight += len(sub)
            try:
                # one device encode for the whole token-budget batch
                # (engine.add_documents), not one tiny matmul per doc
                batch = [
                    (doc_id, text,
                     self.app.metadata.get_document(doc_id).file_name)
                    for doc_id, text in sub
                ]
                with self._write_guard():
                    self.app.search_engine.add_documents(batch)
                    for doc_id, _text, _title in batch:
                        slot = self.app.search_engine._slot_by_doc[doc_id]
                        self.app.metadata.set_metadata(
                            doc_id, "__slot__", str(slot))
                        self.app.metadata.set_embedding_status(
                            doc_id, "done", self.app.config.embedding.profile
                        )
                        st.processed += 1
            except Exception:
                st.failed += len(sub)
            finally:
                st.inflight -= len(sub)

    def snapshot(self) -> dict:
        return {
            "depth": self._q.qsize(),
            "paused": self._paused.is_set(),
            "stages": {k: dataclasses.asdict(v) for k, v in self.stats.items()},
        }
