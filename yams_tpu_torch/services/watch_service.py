"""WatchService: polling directory watcher feeding the ingest pipeline.

Parity: src/cli/commands/watch_command — watch a directory, (re)index files
as they appear or change. Poll-based (mtime+size fingerprints) so it works
on every filesystem; run_once() is the testable unit, watch() loops.

Copied from yams_tpu/services/watch_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import pathlib
import time

from .indexing_service import DEFAULT_EXCLUDES


@dataclasses.dataclass(slots=True)
class WatchEvent:
    path: str
    kind: str  # added | modified | removed


class WatchService:
    def __init__(self, app):
        self.app = app
        self._fingerprints: dict[str, tuple[float, int]] = {}

    def _scan(self, root: pathlib.Path, include, exclude) -> dict[str, tuple[float, int]]:
        out = {}
        excludes = list(exclude or []) + list(DEFAULT_EXCLUDES)
        for p in root.rglob("*"):
            if not p.is_file():
                continue
            s = str(p)
            if include and not any(
                fnmatch.fnmatch(s, g) or fnmatch.fnmatch(p.name, g) for g in include
            ):
                continue
            if any(fnmatch.fnmatch(s, g) or fnmatch.fnmatch(p.name, g)
                   for g in excludes):
                continue
            try:
                st = p.stat()
                out[s] = (st.st_mtime, st.st_size)
            except OSError:
                pass
        return out

    def run_once(
        self,
        directory: str | pathlib.Path,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
        tags: list[str] | None = None,
        delete_missing: bool = False,
    ) -> list[WatchEvent]:
        """One poll cycle: index added/changed files, optionally drop removed."""
        root = pathlib.Path(directory)
        current = self._scan(root, include, exclude)
        events: list[WatchEvent] = []
        for path, fp in current.items():
            prev = self._fingerprints.get(path)
            if prev is None or prev != fp:
                try:
                    self.app.documents.add_file(path, tags=tags)
                    events.append(
                        WatchEvent(path, "added" if prev is None else "modified")
                    )
                except Exception:
                    continue
        for path in set(self._fingerprints) - set(current):
            events.append(WatchEvent(path, "removed"))
            if delete_missing:
                self.app.documents.delete(path, keep_content=True)
        self._fingerprints = current
        return events

    def watch(self, directory, interval_s: float = 2.0, on_event=None, **kw):
        """Blocking poll loop (the CLI `yams watch` body)."""
        while True:
            for ev in self.run_once(directory, **kw):
                if on_event:
                    on_event(ev)
            time.sleep(interval_s)
