"""Structural PDF text extraction plugin (reference: the zyp PDF plugin).

Pure-Python, no third-party deps. Two tiers:

1. STRUCTURAL (primary): parse the cross-reference machinery and walk the
   document the way a conforming reader does —
     - classic `xref` tables AND PDF 1.5 cross-reference STREAMS
       (/Type/XRef, /W field widths, /Index subsections, FlateDecode with
       PNG predictors), following /Prev chains across updates;
     - compressed object streams (/Type/ObjStm — where modern
       digitally-born PDFs keep the page tree and fonts);
     - the page tree (Root -> Pages -> Kids) with inheritable /Resources;
     - content-stream interpretation: literal AND hex strings for
       Tj / ' / " / TJ, with the active font tracked through Tf so bytes
       decode through the font's /ToUnicode CMap (bfchar + bfrange,
       1- and 2-byte codes) when present.
2. FLAT SCAN (fallback): the legacy object-walking regex pass, used when
   the structure is damaged — never worse than the old extractor.

Scanned/encrypted PDFs yield nothing (an OCR-class plugin could layer on
top). Registered as a standard yams plugin exposing content_extractor_v1.

Copied from yams_tpu/plugins/pdf_extract.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import re
import zlib

from .spec import IFACE_CONTENT_EXTRACTOR, PluginManifest

# ---------------------------------------------------------------------------
# object model + lexer


class Name(str):
    """PDF name object (/Foo)."""


class Ref:
    __slots__ = ("num", "gen")

    def __init__(self, num: int, gen: int):
        self.num, self.gen = num, gen

    def __repr__(self):
        return f"{self.num} {self.gen} R"


class Stream:
    __slots__ = ("d", "raw")

    def __init__(self, d: dict, raw: bytes):
        self.d, self.raw = d, raw


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _skip_ws(data: bytes, i: int) -> int:
    n = len(data)
    while i < n:
        c = data[i]
        if c in _WS:
            i += 1
        elif c == 0x25:  # % comment to EOL
            while i < n and data[i] not in b"\r\n":
                i += 1
        else:
            break
    return i


_NUM_RE = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)")
_REF_RE = re.compile(rb"(\d+)\s+(\d+)\s+R\b")
_KEY_RE = re.compile(rb"[^\s()<>\[\]{}/%]*")


def parse_object(data: bytes, i: int):
    """Parse ONE object at i -> (obj, next_i). Raises ValueError on junk."""
    i = _skip_ws(data, i)
    if i >= len(data):
        raise ValueError("eof")
    c = data[i]
    if c == 0x2F:  # /Name
        m = _KEY_RE.match(data, i + 1)
        return Name(m.group(0).decode("latin-1")), m.end()
    if c == 0x28:  # (literal string)
        return _parse_literal(data, i)
    if c == 0x3C:  # << dict or <hex>
        if data[i:i + 2] == b"<<":
            return _parse_dict_or_stream(data, i)
        return _parse_hex(data, i)
    if c == 0x5B:  # [ array ]
        out = []
        i += 1
        while True:
            i = _skip_ws(data, i)
            if i < len(data) and data[i] == 0x5D:
                return out, i + 1
            obj, i = parse_object(data, i)
            out.append(obj)
    if data.startswith(b"true", i):
        return True, i + 4
    if data.startswith(b"false", i):
        return False, i + 5
    if data.startswith(b"null", i):
        return None, i + 4
    m = _REF_RE.match(data, i)
    if m:
        return Ref(int(m.group(1)), int(m.group(2))), m.end()
    m = _NUM_RE.match(data, i)
    if m:
        t = m.group(0)
        return (float(t) if b"." in t else int(t)), m.end()
    raise ValueError(f"unparsable object at {i}: {data[i:i+16]!r}")


def _parse_literal(data: bytes, i: int):
    assert data[i] == 0x28
    depth, j, out = 1, i + 1, bytearray()
    n = len(data)
    while j < n and depth:
        c = data[j]
        if c == 0x5C and j + 1 < n:
            out += data[j:j + 2]
            j += 2
            continue
        if c == 0x28:
            depth += 1
        elif c == 0x29:
            depth -= 1
            if not depth:
                j += 1
                break
        out.append(c)
        j += 1
    return _unescape_bytes(bytes(out)), j


def _parse_hex(data: bytes, i: int):
    end = data.index(b">", i + 1)
    hx = re.sub(rb"\s", b"", data[i + 1:end])
    if len(hx) % 2:
        hx += b"0"
    return bytes.fromhex(hx.decode("ascii")), end + 1


def _parse_dict_or_stream(data: bytes, i: int):
    assert data[i:i + 2] == b"<<"
    i += 2
    d: dict = {}
    while True:
        i = _skip_ws(data, i)
        if data[i:i + 2] == b">>":
            i += 2
            break
        key, i = parse_object(data, i)
        val, i = parse_object(data, i)
        d[str(key)] = val
    j = _skip_ws(data, i)
    if data.startswith(b"stream", j):
        j += 6
        if data[j:j + 2] == b"\r\n":
            j += 2
        elif data[j:j + 1] in (b"\n", b"\r"):
            j += 1
        ln = d.get("Length")
        if isinstance(ln, int):
            raw = data[j:j + ln]
            end = j + ln
        else:  # Length is a ref (resolved by Document) or missing: scan
            e = data.find(b"endstream", j)
            raw = data[j:e if e >= 0 else len(data)]
            end = e if e >= 0 else len(data)
        e2 = data.find(b"endstream", end)
        return Stream(d, raw), (e2 + 9 if e2 >= 0 else end)
    return d, i


def _unescape_bytes(raw: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    mapped = {0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09, 0x62: 0x08,
              0x66: 0x0C, 0x28: 0x28, 0x29: 0x29, 0x5C: 0x5C}
    while i < n:
        c = raw[i]
        if c == 0x5C and i + 1 < n:
            nx = raw[i + 1]
            if nx in mapped:
                out.append(mapped[nx])
                i += 2
                continue
            if 0x30 <= nx <= 0x37:
                j, digs = i + 1, b""
                while j < n and len(digs) < 3 and 0x30 <= raw[j] <= 0x37:
                    digs += bytes([raw[j]])
                    j += 1
                out.append(int(digs, 8) & 0xFF)
                i = j
                continue
            if nx in b"\r\n":  # line continuation
                i += 2
                if nx == 0x0D and i < n and raw[i] == 0x0A:
                    i += 1
                continue
            i += 1
            continue
        out.append(c)
        i += 1
    return bytes(out)


def _to_text(b: bytes) -> str:
    if b[:2] == b"\xfe\xff":
        try:
            return b[2:].decode("utf-16-be", errors="replace")
        except Exception:
            pass
    return b.decode("latin-1", errors="replace")


# ---------------------------------------------------------------------------
# filters


def _png_unpredict(data: bytes, colors: int, columns: int) -> bytes:
    row = columns * colors
    out = bytearray()
    prev = bytearray(row)
    for r in range(0, len(data), row + 1):
        ft = data[r]
        line = bytearray(data[r + 1:r + 1 + row])
        if ft == 1:      # Sub
            for k in range(colors, row):
                line[k] = (line[k] + line[k - colors]) & 0xFF
        elif ft == 2:    # Up
            for k in range(row):
                line[k] = (line[k] + prev[k]) & 0xFF
        elif ft == 3:    # Average
            for k in range(row):
                left = line[k - colors] if k >= colors else 0
                line[k] = (line[k] + (left + prev[k]) // 2) & 0xFF
        elif ft == 4:    # Paeth
            for k in range(row):
                a = line[k - colors] if k >= colors else 0
                b = prev[k]
                cc = prev[k - colors] if k >= colors else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[k] = (line[k] + pr) & 0xFF
        out += line
        prev = line
    return bytes(out)


def decode_stream(st: Stream, resolve) -> bytes:
    """Apply /Filter (+ /DecodeParms predictors) to a stream's raw bytes."""
    data = st.raw
    filters = resolve(st.d.get("Filter"))
    if filters is None:
        filters = []
    if not isinstance(filters, list):
        filters = [filters]
    parms = resolve(st.d.get("DecodeParms")) or resolve(st.d.get("DP"))
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    for f, p in zip(filters, parms):
        fname = str(f)
        if fname in ("FlateDecode", "Fl"):
            data = zlib.decompress(data)
        elif fname in ("ASCIIHexDecode", "AHx"):
            hx = re.sub(rb"[\s>]", b"", data)
            if len(hx) % 2:
                hx += b"0"
            data = bytes.fromhex(hx.decode("ascii"))
        else:
            raise ValueError(f"unsupported filter {fname}")
        p = resolve(p)
        if isinstance(p, dict):
            pred = resolve(p.get("Predictor", 1)) or 1
            if pred >= 10:
                data = _png_unpredict(
                    data, int(resolve(p.get("Colors", 1)) or 1),
                    int(resolve(p.get("Columns", 1)) or 1))
            elif pred != 1:
                raise ValueError(f"unsupported predictor {pred}")
    return data


# ---------------------------------------------------------------------------
# document: xref chain + object loading


class Document:
    def __init__(self, data: bytes):
        self.data = data
        # obj num -> ("at", offset) | ("in", objstm_num, idx)
        self.offsets: dict[int, tuple] = {}
        self.trailer: dict = {}
        self._cache: dict[int, object] = {}
        self._objstm_cache: dict[int, dict[int, object]] = {}
        self._load_xref_chain()

    # -- xref ----------------------------------------------------------------
    def _load_xref_chain(self) -> None:
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            raise ValueError("no startxref")
        pos = int(m.group(1))
        seen = set()
        while pos not in seen and 0 <= pos < len(self.data):
            seen.add(pos)
            i = _skip_ws(self.data, pos)
            if self.data.startswith(b"xref", i):
                trailer = self._parse_xref_table(i + 4)
            else:
                trailer = self._parse_xref_stream(i)
            for k, v in trailer.items():
                self.trailer.setdefault(k, v)
            prev = trailer.get("Prev")
            if prev is None:
                break
            pos = int(prev)

    def _parse_xref_table(self, i: int) -> dict:
        data = self.data
        while True:
            i = _skip_ws(data, i)
            if data.startswith(b"trailer", i):
                tr, _ = parse_object(data, i + 7)
                return tr if isinstance(tr, dict) else {}
            m = re.match(rb"(\d+)\s+(\d+)", data[i:i + 40])
            if not m:
                return {}
            start, count = int(m.group(1)), int(m.group(2))
            i += m.end()
            i = _skip_ws(data, i)
            for n in range(count):
                row = data[i:i + 20]
                off, gen, kind = row[:10], row[11:16], row[17:18]
                if kind == b"n":
                    self.offsets.setdefault(start + n, ("at", int(off)))
                i += 20

    def _parse_xref_stream(self, i: int) -> dict:
        m = re.match(rb"(\d+)\s+(\d+)\s+obj", self.data[i:i + 40])
        if not m:
            raise ValueError("bad xref stream header")
        obj, _ = parse_object(self.data, i + m.end())
        if not isinstance(obj, Stream):
            raise ValueError("xref object is not a stream")
        body = decode_stream(obj, self._resolve_shallow)
        w = [int(x) for x in obj.d["W"]]
        size = int(self._resolve_shallow(obj.d["Size"]))
        index = obj.d.get("Index", [0, size])
        index = [int(self._resolve_shallow(x)) for x in index]
        rw = sum(w)
        pos = 0

        def field(row, a, b):
            seg = row[a:b]
            return int.from_bytes(seg, "big") if seg else 0

        for s in range(0, len(index), 2):
            start, count = index[s], index[s + 1]
            for n in range(count):
                row = body[pos:pos + rw]
                pos += rw
                if len(row) < rw:
                    break
                t = field(row, 0, w[0]) if w[0] else 1
                f2 = field(row, w[0], w[0] + w[1])
                f3 = field(row, w[0] + w[1], rw)
                num = start + n
                if t == 1:
                    self.offsets.setdefault(num, ("at", f2))
                elif t == 2:
                    self.offsets.setdefault(num, ("in", f2, f3))
        return dict(obj.d)

    # -- objects --------------------------------------------------------------
    def _resolve_shallow(self, obj):
        return self.get(obj.num) if isinstance(obj, Ref) else obj

    def get(self, num: int):
        if num in self._cache:
            return self._cache[num]
        loc = self.offsets.get(num)
        out = None
        if loc is None:
            pass
        elif loc[0] == "at":
            m = re.match(rb"(\d+)\s+(\d+)\s+obj",
                         self.data[loc[1]:loc[1] + 40])
            if m:
                out, _ = parse_object(self.data, loc[1] + m.end())
                if isinstance(out, Stream) and isinstance(
                        out.d.get("Length"), Ref):
                    ln = self._resolve_shallow(out.d["Length"])
                    if isinstance(ln, int):
                        out = Stream(out.d, out.raw[:ln])
        else:  # inside an ObjStm
            out = self._objstm(loc[1]).get(loc[2])
        self._cache[num] = out
        return out

    def _objstm(self, num: int) -> dict[int, object]:
        got = self._objstm_cache.get(num)
        if got is not None:
            return got
        table: dict[int, object] = {}
        st = self.get(num)
        if isinstance(st, Stream):
            body = decode_stream(st, self._resolve_shallow)
            n = int(self._resolve_shallow(st.d.get("N", 0)) or 0)
            first = int(self._resolve_shallow(st.d.get("First", 0)) or 0)
            i = 0
            heads = []
            for _ in range(n):
                a, i = parse_object(body, i)
                b, i = parse_object(body, i)
                heads.append((int(a), int(b)))
            for idx, (_onum, off) in enumerate(heads):
                try:
                    obj, _ = parse_object(body, first + off)
                    table[idx] = obj
                except ValueError:
                    pass
        self._objstm_cache[num] = table
        return table

    def resolve(self, obj, depth: int = 0):
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get(obj.num)
            depth += 1
        return obj


# ---------------------------------------------------------------------------
# ToUnicode CMaps

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.DOTALL)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.DOTALL)
_HEXTOK_RE = re.compile(rb"<([0-9A-Fa-f\s]*)>")
_ARR_RE = re.compile(rb"\[(.*?)\]", re.DOTALL)


class CMap:
    """code (1- or 2-byte) -> unicode string."""

    def __init__(self):
        self.map: dict[int, str] = {}
        self.code_bytes = 1

    @staticmethod
    def _hx(tok: bytes) -> bytes:
        hx = re.sub(rb"\s", b"", tok)
        if len(hx) % 2:
            hx += b"0"
        return bytes.fromhex(hx.decode("ascii"))

    @classmethod
    def parse(cls, body: bytes) -> "CMap":
        cm = cls()

        def dst_text(b: bytes) -> str:
            try:
                return b.decode("utf-16-be", errors="replace")
            except Exception:
                return b.decode("latin-1", errors="replace")

        for m in _BFCHAR_RE.finditer(body):
            toks = _HEXTOK_RE.findall(m.group(1))
            for s in range(0, len(toks) - 1, 2):
                src = cls._hx(toks[s])
                cm.code_bytes = max(cm.code_bytes, len(src))
                cm.map[int.from_bytes(src, "big")] = dst_text(
                    cls._hx(toks[s + 1]))
        for m in _BFRANGE_RE.finditer(body):
            seg = m.group(1)
            pos = 0
            while True:
                h1 = _HEXTOK_RE.search(seg, pos)
                if not h1:
                    break
                h2 = _HEXTOK_RE.search(seg, h1.end())
                if not h2:
                    break
                lo = cls._hx(h1.group(1))
                hi = cls._hx(h2.group(1))
                cm.code_bytes = max(cm.code_bytes, len(lo))
                lo_i, hi_i = (int.from_bytes(lo, "big"),
                              int.from_bytes(hi, "big"))
                nxt = _skip_ws(seg, h2.end())
                if nxt < len(seg) and seg[nxt] == 0x5B:  # [ <d> <d> ... ]
                    am = _ARR_RE.match(seg, nxt)
                    dsts = _HEXTOK_RE.findall(am.group(1)) if am else []
                    for k, dtok in enumerate(dsts):
                        if lo_i + k <= hi_i:
                            cm.map[lo_i + k] = dst_text(cls._hx(dtok))
                    pos = am.end() if am else h2.end()
                else:
                    h3 = _HEXTOK_RE.search(seg, h2.end())
                    if not h3:
                        break
                    base = int.from_bytes(cls._hx(h3.group(1)), "big")
                    for k in range(hi_i - lo_i + 1):
                        cm.map[lo_i + k] = chr(base + k)
                    pos = h3.end()
        return cm

    def decode(self, b: bytes) -> str:
        if not self.map:
            return _to_text(b)
        step = self.code_bytes
        out = []
        for i in range(0, len(b) - step + 1, step):
            code = int.from_bytes(b[i:i + step], "big")
            out.append(self.map.get(code, ""))
        return "".join(out)


# ---------------------------------------------------------------------------
# content-stream interpretation

_CONTENT_TOK = re.compile(
    rb"\((?:\\.|[^\\()])*\)"      # literal string
    rb"|<[0-9A-Fa-f\s]*>"          # hex string
    rb"|\[|\]"
    rb"|/[^\s()<>\[\]{}/%]*"
    rb"|[^\s()<>\[\]{}/%]+"        # operator / number
)


def _content_text(content: bytes, fonts: dict[str, CMap]) -> list[str]:
    parts: list[str] = []
    cur: CMap | None = None
    stack: list = []

    def show(tok: bytes):
        if tok.startswith(b"("):
            raw = _unescape_bytes(tok[1:-1])
            parts.append(cur.decode(raw) if cur else _to_text(raw))
        elif tok.startswith(b"<"):
            raw = CMap._hx(tok[1:-1])
            parts.append(cur.decode(raw) if cur else _to_text(raw))

    for m in _CONTENT_TOK.finditer(content):
        tok = m.group(0)
        # operands push; operators consume + clear
        if tok.startswith((b"(", b"<", b"/")) or _NUM_RE.fullmatch(tok):
            stack.append(tok)
            continue
        if tok in (b"[", b"]"):
            continue
        if tok in (b"Tj", b"'", b'"'):
            for s in reversed(stack):
                if s.startswith((b"(", b"<")):
                    show(s)
                    break
        elif tok == b"TJ":
            for s in stack:
                if s.startswith((b"(", b"<")):
                    show(s)
        elif tok == b"Tf":
            for s in stack:
                if s.startswith(b"/"):
                    cur = fonts.get(s[1:].decode("latin-1"))
        elif tok in (b"Td", b"TD", b"T*", b"BT", b"ET"):
            if parts and parts[-1] != "\n":
                parts.append("\n")
        stack.clear()
    return parts


# ---------------------------------------------------------------------------
# page walk


def _extract_structural(data: bytes) -> tuple[str, str] | None:
    doc = Document(data)
    root = doc.resolve(doc.trailer.get("Root"))
    if not isinstance(root, dict):
        raise ValueError("no document catalog")
    title = ""
    info = doc.resolve(doc.trailer.get("Info"))
    if isinstance(info, dict):
        t = doc.resolve(info.get("Title"))
        if isinstance(t, bytes):
            title = _to_text(t).strip()

    pages: list[tuple[dict, dict]] = []   # (page dict, inherited resources)

    def walk(node, inherited_res, depth=0):
        node = doc.resolve(node)
        if not isinstance(node, dict) or depth > 64:
            return
        res = doc.resolve(node.get("Resources")) or inherited_res
        if str(node.get("Type")) == "Page":
            pages.append((node, res if isinstance(res, dict) else {}))
            return
        for kid in doc.resolve(node.get("Kids")) or []:
            walk(kid, res, depth + 1)

    walk(root.get("Pages"), {})
    parts: list[str] = []
    for page, res in pages:
        fonts: dict[str, CMap] = {}
        fdict = doc.resolve(res.get("Font")) if res else None
        if isinstance(fdict, dict):
            for fname, fref in fdict.items():
                fobj = doc.resolve(fref)
                if isinstance(fobj, dict):
                    tu = doc.resolve(fobj.get("ToUnicode"))
                    if isinstance(tu, Stream):
                        try:
                            fonts[fname] = CMap.parse(
                                decode_stream(tu, doc._resolve_shallow))
                        except Exception:
                            pass
        contents = doc.resolve(page.get("Contents"))
        streams = contents if isinstance(contents, list) else [contents]
        for st in streams:
            st = doc.resolve(st)
            if not isinstance(st, Stream):
                continue
            try:
                body = decode_stream(st, doc._resolve_shallow)
            except Exception:
                continue
            parts.extend(_content_text(body, fonts))
    text = "\n".join(
        p.strip() for p in "".join(parts).split("\n") if p.strip())
    if not text:
        return None
    return text, title


# ---------------------------------------------------------------------------
# flat fallback (the legacy extractor, kept verbatim in behavior)

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_FLATE_RE = re.compile(rb"/Filter\s*(?:\[[^\]]*/FlateDecode[^\]]*\]|/FlateDecode)")
_OBJ_RE = re.compile(rb"\d+\s+\d+\s+obj(.*?)endobj", re.DOTALL)
_TITLE_RE = re.compile(rb"/Title\s*\((?P<t>(?:\\.|[^\\()])*)\)")


def _extract_flat(data: bytes) -> tuple[str, str] | None:
    title = ""
    tm = _TITLE_RE.search(data)
    if tm:
        title = _to_text(_unescape_bytes(tm.group("t"))).strip()
    parts: list[str] = []
    for om in _OBJ_RE.finditer(data):
        obj = om.group(1)
        sm = _STREAM_RE.search(obj)
        if not sm:
            continue
        stream = sm.group(1)
        if _FLATE_RE.search(obj):
            try:
                stream = zlib.decompress(stream)
            except zlib.error:
                continue
        if b"Tj" in stream or b"TJ" in stream or b"'" in stream:
            parts.extend(_content_text(stream, {}))
    text = "\n".join(
        p.strip() for p in "".join(parts).split("\n") if p.strip())
    if not text.strip():
        return None
    return text, title


def extract_pdf(data: bytes, mime: str = "application/pdf") -> tuple[str, str] | None:
    if not data.startswith(b"%PDF"):
        return None
    try:
        out = _extract_structural(data)
        if out is not None:
            return out
    except Exception:
        pass
    return _extract_flat(data)


def yams_plugin() -> PluginManifest:
    class _Extractor:
        def supported_mimes(self):
            return ["application/pdf"]

        def extract(self, data, mime):
            return extract_pdf(data, mime)

    return PluginManifest(
        name="pdf_extract",
        version="2.0",
        description=(
            "built-in PDF text extraction (xref tables + xref streams, "
            "ObjStm, page tree, hex strings, ToUnicode CMaps)"
        ),
        interfaces={IFACE_CONTENT_EXTRACTOR: _Extractor()},
    )
