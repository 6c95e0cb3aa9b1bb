"""Real-text retrieval eval corpus, and a stand-in root built from trees on disk.

Port of tests/benchmarks/realtext.py (`camel_split`, `available`, `build`,
`realtext_beir`): a real-text root holds `docs/**/*.md`, `src/**/*.{cpp,h}`
or `include/**/*.h`, and its queries carry qrels pinned by construction
(known-item retrieval): a markdown heading (>= 3 words) must retrieve its
file (chunk), and a camel-split class/struct name must retrieve a file
(chunk) that defines it. The code is the original's, with these departures
only:

- every entry point takes the root as `root=`; without one it reads
  `YAMS_REALTEXT_DIR`, as the original does, and there is no other default
  (the original's default is a fixed path of its own host), so
  `available()` is False and `build` raises when neither is given;
- `realtext_beir` builds the port's `utils.beir.BeirDataset`.

`assemble_root(dst, n_headers)` is tooling for the tests and the card smoke,
not a feature of the system: it builds a root from trees already on disk,
so that no corpus is ever fetched. `docs/` links this repository's
markdown (the root `*.md` and `docs/**/*.md`, under their repository
paths), and `include/` a seeded selection of the installed torch package's
C++ headers (`torch/include`, whose CamelCase classes give the symbol
queries). `n_headers` defaults to `MAX_DOCS` less the markdown count, so
every markdown file stays inside `realtext_beir`'s shuffled cut of 900
files. Its queries are known-item queries on another corpus than the
reference's, so its metrics are not comparable with the reference's
published table.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import random
import re

REALTEXT_ROOT = (pathlib.Path(os.environ["YAMS_REALTEXT_DIR"])
                 if "YAMS_REALTEXT_DIR" in os.environ else None)
REPO = pathlib.Path(__file__).resolve().parents[2]

MAX_DOC_CHARS = 4000
MAX_DOCS = 900

_HEADING_RE = re.compile(r"^#{1,3}\s+(.+)$", re.MULTILINE)
_SYMBOL_RE = re.compile(
    r"^\s*(?:class|struct)\s+([A-Z][A-Za-z0-9_]{7,})\b(?!.*;\s*$)",
    re.MULTILINE)
_CAMEL_RE = re.compile(
    r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|[0-9]+")


@dataclasses.dataclass(slots=True)
class RealTextEval:
    docs: list[tuple[str, str]]              # (relpath, text)
    queries: list[tuple[str, set[str]]]      # (query, relevant relpaths)
    kinds: list[str]                         # per-query: heading | symbol


def camel_split(name: str) -> str:
    return " ".join(m.group(0).lower() for m in _CAMEL_RE.finditer(name))


def available(root: str | pathlib.Path | None = None) -> bool:
    if root is None and REALTEXT_ROOT is None:
        return False
    base = resolve_root(root)
    return (base / "docs").is_dir() or (base / "src").is_dir()


def build(max_docs: int = MAX_DOCS, max_queries_per_kind: int = 120,
          seed: int = 7, *, root: str | pathlib.Path | None = None) -> RealTextEval:
    base = resolve_root(root)
    rng = random.Random(seed)
    files: list[pathlib.Path] = []
    for sub, pats in (("docs", ("*.md",)),
                      ("src", ("*.cpp", "*.h")),
                      ("include", ("*.h",))):
        root = base / sub
        if not root.is_dir():
            continue
        for pat in pats:
            files.extend(sorted(root.rglob(pat)))
    rng.shuffle(files)
    files = files[:max_docs]

    docs: list[tuple[str, str]] = []
    text_by_rel: dict[str, str] = {}
    for f in files:
        try:
            text = f.read_text(errors="replace")[:MAX_DOC_CHARS]
        except OSError:
            continue
        rel = str(f.relative_to(base))
        docs.append((rel, text))
        text_by_rel[rel] = text

    queries: list[tuple[str, set[str]]] = []
    kinds: list[str] = []

    # heading queries: each (truncated) markdown doc's headings point home
    heads: list[tuple[str, set[str]]] = []
    seen_q: set[str] = set()
    for rel, text in docs:
        if not rel.endswith(".md"):
            continue
        for m in _HEADING_RE.finditer(text):
            q = re.sub(r"[`*_#\[\]()]", " ", m.group(1)).strip().lower()
            if len(q.split()) < 3 or q in seen_q:
                continue
            seen_q.add(q)
            heads.append((q, {rel}))
    rng.shuffle(heads)
    for q, rel in heads[:max_queries_per_kind]:
        queries.append((q, rel))
        kinds.append("heading")

    # symbol queries: class/struct definitions, relevant = defining files
    defs: dict[str, set[str]] = {}
    for rel, text in docs:
        if rel.endswith(".md"):
            continue
        for m in _SYMBOL_RE.finditer(text):
            defs.setdefault(m.group(1), set()).add(rel)
    syms = [(s, rels) for s, rels in defs.items()
            if len(camel_split(s).split()) >= 2 and len(rels) <= 4]
    rng.shuffle(syms)
    for s, rels in syms[:max_queries_per_kind]:
        queries.append((camel_split(s), rels))
        kinds.append("symbol")

    return RealTextEval(docs=docs, queries=queries, kinds=kinds)


def _chunk_text(text: str, chunk_chars: int) -> list[tuple[int, str]]:
    """Split at line boundaries into ~chunk_chars passages; returns
    (char_offset, chunk_text)."""
    out: list[tuple[int, str]] = []
    pos, buf, buf_start = 0, [], 0
    n = 0
    for line in text.splitlines(keepends=True):
        if n + len(line) > chunk_chars and buf:
            out.append((buf_start, "".join(buf)))
            buf, buf_start, n = [], pos, 0
        buf.append(line)
        n += len(line)
        pos += len(line)
    if buf:
        out.append((buf_start, "".join(buf)))
    return out


def realtext_beir(max_files: int = 900, max_file_chars: int = 24_000,
                  chunk_chars: int = 2_000, max_queries_per_kind: int = 120,
                  seed: int = 7, *, root: str | pathlib.Path | None = None):
    """BEIR-format dataset from the real-text root at REFERENCE SCALE:
    passage-chunked docs (>=2k) + known-item queries with chunk-level qrels.

    This is the zero-egress stand-in for BEIR scifact (2k docs / 50 queries,
    reference docs/benchmarks/index.md:57-71): same format (BeirDataset),
    same metric protocol (MRR / nDCG@10 / recall@10), real prose+code text.
    Heading queries resolve to the chunk CONTAINING the heading; symbol
    queries to every chunk defining the symbol (<=4 files)."""
    from ..utils.beir import BeirDataset

    base = resolve_root(root)
    rng = random.Random(seed)
    files: list[pathlib.Path] = []
    for sub, pats in (("docs", ("*.md",)),
                      ("src", ("*.cpp", "*.h")),
                      ("include", ("*.h",))):
        root = base / sub
        if not root.is_dir():
            continue
        for pat in pats:
            files.extend(sorted(root.rglob(pat)))
    rng.shuffle(files)
    files = files[:max_files]

    corpus: dict[str, dict] = {}
    chunks_by_rel: dict[str, list[tuple[int, str, str]]] = {}
    for f in files:
        try:
            text = f.read_text(errors="replace")[:max_file_chars]
        except OSError:
            continue
        rel = str(f.relative_to(base))
        lst = []
        for i, (off, chunk) in enumerate(_chunk_text(text, chunk_chars)):
            did = f"{rel}#{i}"
            corpus[did] = {"title": rel if i == 0 else "", "text": chunk}
            lst.append((off, did, chunk))
        chunks_by_rel[rel] = lst

    def _chunk_of(rel: str, char_off: int) -> str | None:
        best = None
        for off, did, _c in chunks_by_rel.get(rel, ()):
            if off <= char_off:
                best = did
            else:
                break
        return best

    queries: dict[str, str] = {}
    qrels: dict[str, dict[str, int]] = {}
    kinds: dict[str, str] = {}
    qn = 0

    heads: list[tuple[str, str]] = []
    seen_q: set[str] = set()
    for rel, lst in chunks_by_rel.items():
        if not rel.endswith(".md"):
            continue
        full = "".join(c for _o, _d, c in lst)
        for m in _HEADING_RE.finditer(full):
            q = re.sub(r"[`*_#\[\]()]", " ", m.group(1)).strip().lower()
            if len(q.split()) < 3 or q in seen_q:
                continue
            seen_q.add(q)
            did = _chunk_of(rel, m.start())
            if did:
                heads.append((q, did))
    rng.shuffle(heads)
    for q, did in heads[:max_queries_per_kind]:
        qid = f"q{qn}"
        queries[qid], qrels[qid], kinds[qid] = q, {did: 1}, "heading"
        qn += 1

    defs: dict[str, dict[str, int]] = {}
    def_files: dict[str, set[str]] = {}
    for rel, lst in chunks_by_rel.items():
        if rel.endswith(".md"):
            continue
        full = "".join(c for _o, _d, c in lst)
        for m in _SYMBOL_RE.finditer(full):
            did = _chunk_of(rel, m.start())
            if did:
                defs.setdefault(m.group(1), {})[did] = 1
                def_files.setdefault(m.group(1), set()).add(rel)
    syms = [(s, rels) for s, rels in defs.items()
            if len(camel_split(s).split()) >= 2 and len(def_files[s]) <= 4]
    rng.shuffle(syms)
    for s, rels in syms[:max_queries_per_kind]:
        qid = f"q{qn}"
        queries[qid], qrels[qid], kinds[qid] = camel_split(s), rels, "symbol"
        qn += 1

    ds = BeirDataset(name="realtext-beir", corpus=corpus, queries=queries,
                     qrels=qrels)
    ds.kinds = kinds  # per-query family, for per-family reporting
    return ds


def resolve_root(root: str | pathlib.Path | None = None) -> pathlib.Path:
    """The root given, else YAMS_REALTEXT_DIR's; FileNotFoundError if neither."""
    if root is not None:
        return pathlib.Path(root)
    if REALTEXT_ROOT is None:
        raise FileNotFoundError("no real-text root: pass root= or set YAMS_REALTEXT_DIR")
    return REALTEXT_ROOT


def repo_markdown() -> list[pathlib.Path]:
    """The repository's markdown: the root `*.md` and `docs/**/*.md`."""
    return sorted(REPO.glob("*.md")) + sorted((REPO / "docs").rglob("*.md"))


def assemble_root(dst: str | pathlib.Path, n_headers: int | None = None, *,
                  seed: int = 0) -> dict:
    """Link a stand-in real-text root under `dst` (see the module docstring):
    -> {"root", "markdown", "headers", "headers_available"}."""
    import torch

    dst = pathlib.Path(dst)
    include = pathlib.Path(torch.__file__).resolve().parent / "include"
    md = repo_markdown()
    headers = sorted(p.relative_to(include) for p in include.rglob("*.h"))
    if n_headers is None:
        n_headers = max(0, MAX_DOCS - len(md))
    picked = random.Random(seed).sample(headers, min(n_headers, len(headers)))
    links = [(dst / "docs" / p.relative_to(REPO), p) for p in md]
    links += [(dst / "include" / rel, include / rel) for rel in picked]
    for link, target in links:
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(target)
    return {"root": dst, "markdown": len(md), "headers": len(picked),
            "headers_available": len(headers)}
