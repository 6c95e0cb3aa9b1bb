"""DownloadService: resumable downloads with integrity verify + CAS handoff.

Parity: src/downloader/ (curl adapter, rate limiter, resume store, disk
writer, integrity verify). urllib replaces curl; Range requests resume
partial transfers; a JSON resume store survives restarts; completed payloads
flow into DocumentService.add_bytes.

Copied from yams_tpu/services/download_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

from ..core.errors import CorruptionError, NotFoundError, YamsError
from ..ingest.hasher import sha256_file


class _Cancelled(Exception):
    """Internal: job cancellation signal (partial file kept for resume)."""


@dataclasses.dataclass(slots=True)
class DownloadResult:
    url: str
    path: str
    bytes_downloaded: int
    resumed_from: int
    sha256: str
    document_id: int = -1
    duration_ms: float = 0.0


class RateLimiter:
    def __init__(self, bytes_per_s: float = 0.0):
        self.bytes_per_s = bytes_per_s
        self._window_start = time.monotonic()
        self._window_bytes = 0

    def throttle(self, n: int) -> None:
        if self.bytes_per_s <= 0:
            return
        self._window_bytes += n
        elapsed = time.monotonic() - self._window_start
        expected = self._window_bytes / self.bytes_per_s
        if expected > elapsed:
            time.sleep(expected - elapsed)


@dataclasses.dataclass(slots=True)
class DownloadJob:
    """Async download job (reference: DownloadStatusRequest /
    CancelDownloadJobRequest / ListDownloadJobsRequest,
    ipc_protocol_requests.h:1707-1763)."""

    job_id: str
    url: str
    state: str = "queued"      # queued|running|completed|failed|cancelled
    bytes_downloaded: int = 0
    error: str = ""
    result: DownloadResult | None = None
    started_at: float = 0.0
    finished_at: float = 0.0
    cancel_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    thread: threading.Thread | None = None

    def snapshot(self) -> dict:
        return {
            "job_id": self.job_id, "url": self.url, "state": self.state,
            "bytes_downloaded": self.bytes_downloaded, "error": self.error,
            "started_at": self.started_at, "finished_at": self.finished_at,
            "result": dataclasses.asdict(self.result) if self.result else None,
        }


class DownloadService:
    def __init__(self, app, rate_limit_bps: float = 0.0):
        self.app = app
        self.dir = app.config.data_dir / "downloads"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.resume_store = self.dir / "resume.json"
        self.limiter = RateLimiter(rate_limit_bps)
        self._jobs: dict[str, DownloadJob] = {}
        self._jobs_lock = threading.Lock()
        # concurrent job threads share one resume file: every mutation is a
        # locked read-modify-write of the url's own entry (a thread-private
        # whole-state copy would erase co-running jobs' entries)
        self._resume_lock = threading.Lock()

    # -- async jobs ------------------------------------------------------------
    def start_job(self, url: str, **kw) -> str:
        """Start a background download; returns a job id immediately."""
        job = DownloadJob(job_id=uuid.uuid4().hex[:16], url=url)

        def run():
            job.state = "running"
            job.started_at = time.time()
            try:
                job.result = self.download(
                    url, _cancel=job.cancel_event, _progress=job, **kw)
                job.state = "completed"
                job.bytes_downloaded = job.result.bytes_downloaded
            except _Cancelled:
                job.state = "cancelled"
            except Exception as e:
                job.state = "failed"
                job.error = str(e)
            job.finished_at = time.time()

        with self._jobs_lock:
            self._jobs[job.job_id] = job
        job.thread = threading.Thread(target=run, daemon=True)
        job.thread.start()
        return job.job_id

    def job_status(self, job_id: str) -> dict:
        with self._jobs_lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise NotFoundError(f"download job not found: {job_id}")
        return job.snapshot()

    def cancel_job(self, job_id: str) -> dict:
        with self._jobs_lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise NotFoundError(f"download job not found: {job_id}")
        job.cancel_event.set()
        if job.state == "queued":
            job.state = "cancelled"
        return job.snapshot()

    def list_jobs(self) -> list[dict]:
        with self._jobs_lock:
            return [j.snapshot() for j in self._jobs.values()]

    # -- resume store ----------------------------------------------------------
    def _load_resume(self) -> dict:
        try:
            return json.loads(self.resume_store.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_resume(self, state: dict) -> None:
        tmp = self.resume_store.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(state))
        tmp.replace(self.resume_store)  # readers never see a torn file

    def _resume_get(self, url: str) -> dict | None:
        with self._resume_lock:
            return self._load_resume().get(url)

    def _resume_set(self, url: str, entry: dict) -> None:
        with self._resume_lock:
            state = self._load_resume()
            state[url] = entry
            self._save_resume(state)

    def _resume_pop(self, url: str) -> None:
        with self._resume_lock:
            state = self._load_resume()
            if state.pop(url, None) is not None:
                self._save_resume(state)

    def _part_path(self, url: str) -> pathlib.Path:
        return self.dir / (hashlib.sha256(url.encode()).hexdigest()[:24] + ".part")

    # -- download ---------------------------------------------------------------
    def download(
        self,
        url: str,
        expected_sha256: str = "",
        store: bool = True,
        tags: list[str] | None = None,
        chunk_size: int = 1 << 20,
        timeout: float = 60.0,
        _cancel: threading.Event | None = None,
        _progress: "DownloadJob | None" = None,
    ) -> DownloadResult:
        t0 = time.monotonic()
        part = self._part_path(url)
        entry = self._resume_get(url)
        resumed_from = part.stat().st_size if part.exists() else 0
        if entry is not None and entry.get("part") != str(part):
            resumed_from = 0

        headers = {}
        mode = "ab" if resumed_from else "wb"
        if resumed_from:
            headers["Range"] = f"bytes={resumed_from}-"
        req = urllib.request.Request(url, headers=headers)
        downloaded = 0
        # register before the .part is opened so a concurrent
        # repair_downloads never sees a live partial as orphaned
        self._resume_set(url, {"part": str(part), "bytes": resumed_from})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if resumed_from and resp.status != 206:
                    # server ignored Range: restart
                    resumed_from = 0
                    mode = "wb"
                with open(part, mode) as f:
                    while True:
                        if _cancel is not None and _cancel.is_set():
                            # keep the .part for resume
                            raise _Cancelled()
                        chunk = resp.read(chunk_size)
                        if not chunk:
                            break
                        f.write(chunk)
                        downloaded += len(chunk)
                        if _progress is not None:
                            _progress.bytes_downloaded = resumed_from + downloaded
                        self.limiter.throttle(len(chunk))
                        self._resume_set(url, {
                            "part": str(part),
                            "bytes": resumed_from + downloaded})
        except urllib.error.URLError as e:
            # keep the .part for resume
            raise YamsError(f"download failed ({e}); partial kept for resume")

        digest = sha256_file(part)
        if expected_sha256 and digest != expected_sha256:
            part.unlink(missing_ok=True)
            self._resume_pop(url)
            raise CorruptionError(
                f"integrity mismatch: got {digest[:12]}, want {expected_sha256[:12]}"
            )

        doc_id = -1
        name = urllib.parse.urlparse(url).path.rsplit("/", 1)[-1] or "download.bin"
        # Namespace the final file by URL hash: the URL basename alone can
        # clobber the resume store itself (.../resume.json) or a different
        # URL's completed download with the same basename.
        url_tag = hashlib.sha256(url.encode()).hexdigest()[:12]
        final_path = self.dir / f"{url_tag}-{name}"
        part.replace(final_path)
        self._resume_pop(url)
        if store:
            res = self.app.documents.add_bytes(
                final_path.read_bytes(), f"downloads/{name}", tags=tags,
                metadata={"source_url": url},
            )
            doc_id = res.document_id
        return DownloadResult(
            url=url,
            path=str(final_path),
            bytes_downloaded=downloaded,
            resumed_from=resumed_from,
            sha256=digest,
            document_id=doc_id,
            duration_ms=(time.monotonic() - t0) * 1e3,
        )
