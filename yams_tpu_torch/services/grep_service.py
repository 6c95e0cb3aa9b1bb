"""GrepService: regex/literal scan over extracted text.

Parity: src/app/services/grep_service.cpp:393-568 — candidate narrowing via
tags -> FTS prefilter -> path windows, then literal fast path (native
find_all, the simd_memmem analog) or Python regex.

Copied from yams_tpu/services/grep_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re

from .. import native


@dataclasses.dataclass(slots=True)
class GrepMatch:
    document_id: int
    path: str
    line_number: int
    line: str
    match_start: int = 0
    match_end: int = 0
    before: list[str] = dataclasses.field(default_factory=list)
    after: list[str] = dataclasses.field(default_factory=list)
    semantic: bool = False   # appended by the semantic-assist tier


@dataclasses.dataclass(slots=True)
class GrepResult:
    matches: list[GrepMatch]
    files_searched: int
    files_matched: int
    truncated: bool = False


_LITERAL_SAFE = re.compile(r"^[\w \t\-]+$")


class GrepService:
    def __init__(self, app):
        self.app = app

    def _candidates(
        self, pattern: str, tags, path_glob, max_docs: int,
        filters: dict | None = None,
    ) -> list[int]:
        md = self.app.metadata
        ids: list[int] | None = None
        if tags:
            ids = md.find_by_tags(
                tags, match_all=bool((filters or {}).get("match_all_tags")))
        if filters:
            from .filters import resolve_filter_ids

            fids = resolve_filter_ids(self.app, None, None, None, filters)
            if fids is not None:
                ids = list(fids) if ids is None else [i for i in ids if i in fids]
        # FTS prefilter with PREFIX queries over the pattern's literal words
        # ("cat" must keep a doc whose only occurrence is inside "catalogue",
        # so each word prefilters as word* — substring-of-longer-word recall)
        words = re.findall(r"[a-zA-Z_][\w\-]{2,}", pattern)
        if words:
            match = " ".join(f'"{w}" *'.replace('" *', '"*') for w in words)
            fts_ids = [r.document_id
                       for r in md.search_fts(match, limit=max_docs,
                                              raw_match=True)]
            if fts_ids:
                ids = fts_ids if ids is None else [i for i in ids if i in set(fts_ids)]
        if ids is None:
            ids = md.all_document_ids()
        if path_glob:
            globs = ([path_glob] if isinstance(path_glob, str)
                     else list(path_glob))
            keep = []
            for i in ids:
                try:
                    doc = md.get_document(i)
                except Exception:
                    continue
                if any(fnmatch.fnmatch(doc.file_path, g) for g in globs):
                    keep.append(i)
            ids = keep
        return ids[:max_docs]

    def grep_multi(
        self,
        patterns: list[str],
        ignore_case: bool = False,
        tags: list[str] | None = None,
        path_glob: str | None = None,
        max_matches: int = 1000,
        max_docs: int = 5000,
    ) -> GrepResult:
        """Multi-literal scan in one pass (Aho-Corasick; Simeon util parity)."""
        from ..utils.ahocorasick import AhoCorasick

        ac = AhoCorasick(patterns, case_insensitive=ignore_case)
        matches: list[GrepMatch] = []
        files_searched = files_matched = 0
        truncated = False
        for doc_id in self._candidates(" ".join(patterns), tags, path_glob,
                                       max_docs):
            text = self.app.metadata.get_content(doc_id)
            if not text:
                continue
            files_searched += 1
            hits = ac.find_all(text)
            if not hits:
                continue
            files_matched += 1
            try:
                path = self.app.metadata.get_document(doc_id).file_path
            except Exception:
                path = ""
            for start, end, _idx in hits:
                prefix = text[:start]
                line_no = prefix.count("\n") + 1
                ls = prefix.rfind("\n") + 1
                le = text.find("\n", end)
                le = len(text) if le < 0 else le
                matches.append(GrepMatch(
                    doc_id, path, line_no, text[ls:le], start - ls, end - ls
                ))
                if len(matches) >= max_matches:
                    truncated = True
                    break
            if truncated:
                break
        return GrepResult(matches, files_searched, files_matched, truncated)

    def grep(
        self,
        pattern: str,
        ignore_case: bool = False,
        literal: bool | None = None,
        tags: list[str] | None = None,
        path_glob: str | None = None,
        max_matches: int = 1000,
        max_docs: int = 5000,
        context: int = 0,
        word_boundary: bool = False,
        filters: dict | None = None,
        semantic_limit: int = 0,
    ) -> GrepResult:
        if word_boundary:
            # word boundaries force the regex path; escape a literal pattern
            pattern = r"\b(" + (re.escape(pattern)
                                 if (literal or (literal is None
                                     and _LITERAL_SAFE.match(pattern)))
                                 else pattern) + r")\b"
            literal = False
        if literal is None:
            literal = bool(_LITERAL_SAFE.match(pattern))
        rx = None
        if not literal:
            rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
        needle = pattern.lower() if ignore_case else pattern

        matches: list[GrepMatch] = []
        files_searched = files_matched = 0
        truncated = False
        for doc_id in self._candidates(pattern, tags, path_glob, max_docs,
                                       filters):
            text = self.app.metadata.get_content(doc_id)
            if not text:
                continue
            files_searched += 1
            hay = text.lower() if (literal and ignore_case) else text
            doc_hits: list[tuple[int, int]] = []
            if literal:
                offs = native.find_all(hay.encode(), needle.encode())
                if offs is None:  # no native lib: python fallback
                    offs, start = [], 0
                    while (i := hay.find(needle, start)) >= 0:
                        offs.append(i)
                        start = i + 1
                # byte offsets -> char offsets only safe for ascii; re-verify
                for off in offs:
                    doc_hits.append((off, off + len(needle)))
            else:
                for m in rx.finditer(hay):
                    doc_hits.append((m.start(), m.end()))
            if not doc_hits:
                continue
            files_matched += 1
            try:
                doc = self.app.metadata.get_document(doc_id)
                path = doc.file_path
            except Exception:
                path = ""
            # byte->line mapping (literal path used byte offsets on utf-8)
            blob = hay.encode() if literal else None
            for start, end in doc_hits:
                if literal:
                    prefix = blob[:start]
                    line_no = prefix.count(b"\n") + 1
                    ls = prefix.rfind(b"\n") + 1
                    le = blob.find(b"\n", end)
                    le = len(blob) if le < 0 else le
                    line = blob[ls:le].decode("utf-8", errors="replace")
                    ms, me = start - ls, end - ls
                else:
                    prefix = hay[:start]
                    line_no = prefix.count("\n") + 1
                    ls = prefix.rfind("\n") + 1
                    le = hay.find("\n", end)
                    le = len(hay) if le < 0 else le
                    line = text[ls:le]
                    ms, me = start - ls, end - ls
                m = GrepMatch(doc_id, path, line_no, line, ms, me)
                if context > 0:
                    all_lines = text.splitlines()
                    lo = max(0, line_no - 1 - context)
                    m.before = all_lines[lo : line_no - 1]
                    m.after = all_lines[line_no : line_no + context]
                matches.append(m)
                if len(matches) >= max_matches:
                    truncated = True
                    break
            if truncated:
                break
        if semantic_limit > 0:
            # semantic assist (reference grep --semantic-limit): append
            # vector-search hits for the pattern text as path-level pseudo
            # matches, skipping files that already matched literally
            seen = {m.document_id for m in matches}
            resp = self.app.search.search(
                re.sub(r"[^\w \-]", " ", pattern), limit=semantic_limit,
                search_type="vector", with_snippets=True, tags=tags,
            )
            for h in resp.hits:
                if h.document_id in seen:
                    continue
                matches.append(GrepMatch(
                    h.document_id, h.path, 0, h.snippet or h.title,
                    semantic=True,
                ))
        return GrepResult(matches, files_searched, files_matched, truncated)
