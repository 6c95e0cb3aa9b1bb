"""Shared document-filter resolution for search/list/grep.

Parity: the reference repeats this predicate surface across search_command,
list_command, and grep_command (tags, collections, mime/extension classes,
created/modified/indexed time bounds, session working sets); here one
resolver turns it into a candidate doc-id set that SearchService pushes down
into the device program and DocumentService.list applies relationally.

Copied from yams_tpu/services/filters.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

def fnmatch_to_glob(pattern: str) -> str:
    """fnmatch pattern -> SQLite GLOB pattern.

    The two agree on *, ?, and [seq]; the one spelling difference is the
    negated class: fnmatch uses [!seq], GLOB uses [^seq]. Every GLOB
    pushdown must translate through here so filtered search, list/grep, and
    session pins all keep the fnmatch semantics they replaced."""
    return pattern.replace("[!", "[^")


# mimes treated as text beyond text/* (reference --text-only semantics)
TEXTY_MIMES = frozenset({
    "application/json", "application/xml", "application/javascript",
    "application/x-sh", "application/x-python", "application/toml",
    "application/yaml", "application/x-yaml", "application/csv",
})


def resolve_filter_ids(
    app,
    tags: list[str] | None = None,
    path_glob: str | None = None,
    collection: str | None = None,
    filters: dict | None = None,
) -> set[int] | None:
    """Resolve filters to a candidate doc-id set (None = no filter).

    `filters` carries the long-tail predicates: match_all_tags, file_types
    (extensions or mime prefixes), text_only/binary_only, the six
    created/modified/indexed time bounds (unix seconds), and session
    (restrict to the named session's pinned working set)."""
    f = filters or {}
    md = app.metadata
    sets: list[set[int]] = []
    if tags:
        sets.append(set(md.find_by_tags(
            tags, match_all=bool(f.get("match_all_tags")))))
    if collection:
        sets.append(set(md.find_by_metadata("collection", collection)))
    if path_glob:
        # SQL GLOB pushdown: sqlite evaluates the pattern inside the row scan
        # (and can use the file_path index for literal prefixes) instead of
        # materializing every path into Python for fnmatch — O(matches)
        # transferred, not O(N). GLOB and fnmatch agree on *, ?, [seq] with
        # case-sensitive matching across '/' boundaries.
        rows = app.db.execute(
            "SELECT id FROM documents WHERE file_path GLOB ?",
            (fnmatch_to_glob(path_glob),)
        ).fetchall()
        sets.append({r[0] for r in rows})
    if f.get("session"):
        sets.append(app.sessions.pinned_doc_ids(f["session"]))
    conds, params = [], []
    for col, key in (("created_time", "created"),
                     ("modified_time", "modified"),
                     ("indexed_time", "indexed")):
        lo, hi = f.get(f"{key}_after"), f.get(f"{key}_before")
        if lo is not None:
            conds.append(f"{col} >= ?")
            params.append(float(lo))
        if hi is not None:
            conds.append(f"{col} <= ?")
            params.append(float(hi))
    file_types = f.get("file_types")
    if file_types:
        ors = []
        for ft in file_types:
            ft = ft.lower()
            if "/" in ft:                       # mime, possibly prefixed
                ors.append("mime_type LIKE ?")
                params.append(ft + "%")
            else:                               # extension (dot optional)
                ors.append("LOWER(file_extension) = ?")
                params.append("." + ft.lstrip("."))
        conds.append("(" + " OR ".join(ors) + ")")
    if f.get("text_only") or f.get("binary_only"):
        texty = ("mime_type LIKE 'text/%' OR mime_type IN (" +
                 ",".join("?" * len(TEXTY_MIMES)) + ")")
        conds.append(f"({texty})" if f.get("text_only") else f"NOT ({texty})")
        params.extend(sorted(TEXTY_MIMES))
    if conds:
        rows = app.db.execute(
            "SELECT id FROM documents WHERE " + " AND ".join(conds), params
        ).fetchall()
        sets.append({r[0] for r in rows})
    if not sets:
        return None
    out = sets[0]
    for s in sets[1:]:
        out &= s
    return out
