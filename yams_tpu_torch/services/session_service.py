"""SessionService: pinned working sets + session warming.

Parity: src/app/services/session_service.cpp (pin path patterns per named
session; warming = hotzone boosts for pinned docs).

Copied from yams_tpu/services/session_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations


class SessionService:
    def __init__(self, app):
        self.app = app
        self._current: str | None = None

    def create(self, name: str, metadata: dict | None = None) -> None:
        self.app.metadata.upsert_session(name, [], metadata)

    def use(self, name: str) -> None:
        if self.app.metadata.get_session(name) is None:
            self.create(name)
        self._current = name

    @property
    def current(self) -> str | None:
        return self._current

    def pin(self, pattern: str, session: str | None = None) -> None:
        name = session or self._current or "default"
        state = self.app.metadata.get_session(name) or ([], {})
        pinned, meta = state
        if pattern not in pinned:
            pinned.append(pattern)
        self.app.metadata.upsert_session(name, pinned, meta)
        # implicit relevance signal (reference: the tuner's reward pipeline):
        # pinning docs into a working session is the strongest click analog.
        # Bounded: at most 16 matched docs feed the bandit/hotzone per pin.
        try:
            for doc_id in list(self.pinned_doc_ids(name))[:16]:
                self.app.search_engine.record_feedback(doc_id, relevant=True)
        except Exception:
            pass  # feedback is advisory; pinning must never fail on it

    def unpin(self, pattern: str, session: str | None = None) -> None:
        name = session or self._current or "default"
        state = self.app.metadata.get_session(name)
        if state is None:
            return
        pinned, meta = state
        pinned = [p for p in pinned if p != pattern]
        self.app.metadata.upsert_session(name, pinned, meta)

    def pinned_doc_ids(self, session: str | None = None) -> set[int]:
        name = session or self._current or "default"
        state = self.app.metadata.get_session(name)
        if state is None:
            return set()
        pinned, _ = state
        # pattern matching pushed into SQLite GLOB: prefix-literal patterns
        # ("src/*") ride idx_documents_path as an index range scan, so warm()
        # is O(matches) — the Python fnmatch loop it replaces walked every
        # documents row per pattern (minutes at 10M docs). GLOB and fnmatch
        # share *?[] syntax; only negated classes spell differently.
        from .filters import fnmatch_to_glob

        out: set[int] = set()
        for p in pinned:
            rows = self.app.db.execute(
                "SELECT id FROM documents WHERE file_path GLOB ?",
                (fnmatch_to_glob(p),),
            ).fetchall()
            out.update(r["id"] for r in rows)
        return out

    def warm(self, session: str | None = None, boost: float = 1.0) -> int:
        """Hotzone-boost pinned docs (session warming)."""
        ids = self.pinned_doc_ids(session)
        for doc_id in ids:
            self.app.metadata.touch_hotzone(doc_id, boost)
            self.app.search_engine.touch_hot(doc_id, boost)
        return len(ids)

    def list(self) -> list[str]:
        return self.app.metadata.list_sessions()

    def delete(self, name: str) -> None:
        self.app.metadata.delete_session(name)
        if self._current == name:
            self._current = None
