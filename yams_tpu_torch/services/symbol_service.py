"""Symbol extraction for code documents.

Parity: the reference's symbol stage (PostIngestQueue Symbol stage +
symbol_metadata table + tree-sitter plugin, SURVEY §2.8/§2.10). Python gets
a full AST tier (stdlib ast: exact def lines, nesting-qualified names,
methods, constants — tree-sitter-grade for this language); other languages
use the regex tier. A tree-sitter-class plugin can replace either via the
entity_extractor interface; the storage/query surface stays the same:
symbols land in the KG (type='symbol') and as per-doc `sym:` metadata rows
carrying kind+line for definition lookup.

Copied from yams_tpu/services/symbol_service.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import ast as _pyast
import dataclasses
import json
import re

_EXTRACTORS: dict[str, list[tuple[str, re.Pattern]]] = {
    "python": [
        ("function", re.compile(r"^\s*def\s+([A-Za-z_]\w*)\s*\(", re.M)),
        ("class", re.compile(r"^\s*class\s+([A-Za-z_]\w*)\s*[(:]", re.M)),
    ],
    "c": [
        ("function", re.compile(
            r"^[A-Za-z_][\w:<>,\s\*&]*?\b([A-Za-z_]\w*)\s*\([^;]*\)\s*\{", re.M)),
        ("method", re.compile(  # C++ out-of-line definitions: Foo::bar(...)
            r"\b([A-Za-z_]\w*::[A-Za-z_~]\w*)\s*\(", re.M)),
        ("struct", re.compile(r"\b(?:struct|class|enum)\s+([A-Za-z_]\w*)\s*[{:]")),
        ("typedef", re.compile(r"\btypedef\s+[^;{]*?\b([A-Za-z_]\w*)\s*;")),
        ("using", re.compile(r"^\s*using\s+([A-Za-z_]\w*)\s*=", re.M)),
        ("define", re.compile(r"^#define\s+([A-Za-z_]\w*)", re.M)),
    ],
    "javascript": [
        ("function", re.compile(r"\bfunction\s+([A-Za-z_$][\w$]*)\s*\(")),
        ("class", re.compile(r"\bclass\s+([A-Za-z_$][\w$]*)")),
        ("const_fn", re.compile(
            r"\b(?:const|let|var)\s+([A-Za-z_$][\w$]*)\s*=\s*(?:async\s*)?"
            r"(?:\(|function|[A-Za-z_$][\w$]*\s*=>)")),
        ("method", re.compile(  # class body: name(args) { — skip keywords
            r"^\s{2,}(?:async\s+)?(?:static\s+)?(?:get\s+|set\s+)?"
            r"([A-Za-z_$][\w$]*)\s*\([^)]*\)\s*\{", re.M)),
        ("export_fn", re.compile(
            r"\bexport\s+default\s+(?:async\s+)?function\s*([A-Za-z_$][\w$]*)?")),
    ],
    "go": [
        ("function", re.compile(r"^func\s+([A-Za-z_]\w*)\s*\(", re.M)),
        ("method", re.compile(  # receiver methods: func (r *T) Name(
            r"^func\s+\(\s*\w+\s+\*?([A-Za-z_]\w*)\s*\)\s*([A-Za-z_]\w*)\s*\(",
            re.M)),
        ("interface", re.compile(r"^type\s+([A-Za-z_]\w*)\s+interface\b", re.M)),
        ("type", re.compile(r"^type\s+([A-Za-z_]\w*)\s", re.M)),
        ("const", re.compile(r"^const\s+([A-Za-z_]\w*)\s*=", re.M)),
    ],
    "rust": [
        ("function", re.compile(r"\bfn\s+([A-Za-z_]\w*)")),
        ("struct", re.compile(r"\b(?:struct|enum|trait|union)\s+([A-Za-z_]\w*)")),
        ("impl", re.compile(r"^impl(?:<[^>]*>)?\s+([A-Za-z_]\w*)", re.M)),
        ("macro", re.compile(r"\bmacro_rules!\s+([A-Za-z_]\w*)")),
        ("const", re.compile(r"\b(?:const|static)\s+([A-Z_][A-Z0-9_]*)\s*:")),
    ],
}

_MIME_LANG = {
    "text/x-python": "python",
    "text/x-c": "c", "text/x-c++": "c",
    "text/javascript": "javascript", "text/typescript": "javascript",
    "text/x-go": "go", "text/x-rust": "rust",
    "text/x-java": "java", "text/x-csharp": "csharp",
    "text/x-kotlin": "kotlin", "text/x-swift": "swift",
    "text/x-php": "php", "text/x-dart": "dart",
    "text/x-perl": "perl", "text/x-r": "r",
    "application/sql": "sql", "text/x-solidity": "solidity",
    "text/x-zig": "zig",
}

_IDENT_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]{2,}\b")

_KEYWORDS = frozenset(
    "if else for while return switch main init new catch function do".split()
)


@dataclasses.dataclass(slots=True)
class Symbol:
    name: str
    kind: str
    line: int


def language_for_mime(mime: str) -> str | None:
    return _MIME_LANG.get(mime)


def _extract_python_ast(text: str, max_symbols: int) -> list[Symbol] | None:
    """AST tier for Python: exact `def`/`class` lines (decorators excluded),
    dotted names for nested defs/methods, module-level UPPER_CASE constants.
    Returns None on a syntax error so the regex tier can take over (partial
    files, other-version syntax)."""
    try:
        tree = _pyast.parse(text)
    except (SyntaxError, ValueError, MemoryError, RecursionError):
        return None
    out: list[Symbol] = []

    def walk(node, prefix: str, in_class: bool) -> None:
        for child in _pyast.iter_child_nodes(node):
            if len(out) >= max_symbols:
                return
            if isinstance(child, (_pyast.FunctionDef, _pyast.AsyncFunctionDef)):
                kind = "method" if in_class else "function"
                out.append(Symbol(prefix + child.name, kind, child.lineno))
                walk(child, prefix + child.name + ".", False)
            elif isinstance(child, _pyast.ClassDef):
                out.append(Symbol(prefix + child.name, "class", child.lineno))
                walk(child, prefix + child.name + ".", True)
            elif not prefix and isinstance(child, _pyast.Assign):
                for t in child.targets:
                    if isinstance(t, _pyast.Name) and t.id.isupper():
                        out.append(Symbol(t.id, "constant", child.lineno))
            elif (not prefix and isinstance(child, _pyast.AnnAssign)
                  and isinstance(child.target, _pyast.Name)
                  and child.target.id.isupper()):
                out.append(Symbol(child.target.id, "constant", child.lineno))

    walk(tree, "", False)
    return out


def extract_symbols(text: str, language: str, max_symbols: int = 256) -> list[Symbol]:
    if language == "python":
        syms = _extract_python_ast(text[:500_000], max_symbols)
        if syms is not None:
            return syms
    if language in ("c", "javascript", "go", "rust", "java", "csharp",
                    "kotlin", "swift", "php", "dart", "perl", "r", "sql",
                    "solidity", "zig"):
        # parser tier: lexer + depth-tracked scanners (code_parser.py) —
        # comment/string-immune, nesting-qualified names, exact lines
        # (reference: tree-sitter plugin). Regex tier remains the fallback.
        from .code_parser import extract as _parser_extract

        try:
            syms = _parser_extract(text, language, max_symbols)
            return [Symbol(s.name, s.kind, s.line) for s in syms]
        except Exception:
            pass  # fall through to the regex tier
    extractors = _EXTRACTORS.get(language)
    if not extractors:
        return []
    out: list[Symbol] = []
    seen: set[tuple[str, int]] = set()
    for kind, rx in extractors:
        for m in rx.finditer(text[:500_000]):
            if rx.groups >= 2 and m.group(2):
                name = f"{m.group(1)}.{m.group(2)}"  # receiver.method
            else:
                name = m.group(1)
            if name is None:
                continue
            if name.lower() in _KEYWORDS or len(name) < 2:
                continue
            line = text.count("\n", 0, m.start(1)) + 1
            key = (name, line)
            if key not in seen:
                seen.add(key)
                out.append(Symbol(name, kind, line))
            if len(out) >= max_symbols:
                return out
    return out


class SymbolService:
    def __init__(self, app):
        self.app = app

    def index_document(self, doc_id: int, text: str, mime: str) -> int:
        lang = language_for_mime(mime)
        if lang is None:
            return 0
        symbols = extract_symbols(text, lang)
        kg = self.app.kg
        for s in symbols:
            self.app.metadata.set_metadata(
                doc_id, f"sym:{s.name}", json.dumps({"kind": s.kind, "line": s.line})
            )
            nid = kg.upsert_node(f"symbol:{s.name}", label=s.name, type_="symbol")
            kg.add_alias(nid, s.name, source="symbols")
            kg.add_alias(nid, s.name.lower(), source="symbols")
            if "." in s.name:  # dotted AST name: alias the bare member too
                leaf = s.name.rsplit(".", 1)[1]
                kg.add_alias(nid, leaf, source="symbols")
                kg.add_alias(nid, leaf.lower(), source="symbols")
            kg.link_document(doc_id, nid, s.name, 1.0)
        # reference edges: identifiers USED here that are defined elsewhere
        # link at lower confidence — this is what lets impact queries reach
        # callers/tests of a changed symbol (reference: GraphAffectedTests
        # walks symbol-reference links). Definition docs indexed after their
        # referencers are re-linked by graph repair / index_pending.
        defined = {s.name for s in symbols} | {
            s.name.rsplit(".", 1)[-1] for s in symbols
        }
        used = set()
        for m in _IDENT_RE.finditer(text[:200_000]):
            w = m.group(0)
            if w not in defined and w.lower() not in _KEYWORDS and len(w) > 2:
                used.add(w)
            if len(used) >= 512:
                break
        for name in used:
            nid = kg.find_node(f"symbol:{name}")
            if nid is not None:
                kg.link_document(doc_id, nid, name, 0.4)
        return len(symbols)

    def lookup(self, name: str, limit: int = 50) -> list[dict]:
        """Definition sites of a symbol: [{path, line, kind}].

        Exact key match first; a bare member name also matches dotted AST
        names by suffix (`bar` finds `Foo.bar`)."""
        rows = self.app.db.execute(
            "SELECT document_id, key, value FROM metadata "
            "WHERE key=? OR (key LIKE 'sym:%' AND key LIKE ?) LIMIT ?",
            (f"sym:{name}", f"%.{name}", limit),
        ).fetchall()
        out = []
        for doc_id, key, value in rows:
            try:
                doc = self.app.metadata.get_document(doc_id)
                info = json.loads(value)
                out.append({"path": doc.file_path, "line": info["line"],
                            "kind": info["kind"], "name": key[4:]})
            except Exception:
                pass
        return out

    def list_symbols(self, doc_selector: str) -> list[dict]:
        doc = self.app.documents.get(doc_selector)
        out = []
        for k, v in doc.metadata.items():
            if k.startswith("sym:"):
                info = json.loads(v)
                out.append({"name": k[4:], **info})
        return sorted(out, key=lambda s: s["line"])
