"""Text extraction: mime-routed extractor registry.

Parity: src/extraction/ (text extractor factory, plain/HTML extractors) +
src/content/ handler registry. Plugins can register more extractors
(PDF etc. — the reference ships those as plugins too).

Copied from yams_tpu/services/extraction.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import html.parser
import re
from typing import Callable

from ..ingest.detection import is_text_mime


class _HtmlTextParser(html.parser.HTMLParser):
    _SKIP = {"script", "style", "noscript", "template"}

    def __init__(self):
        super().__init__()
        self.parts: list[str] = []
        self._skip_depth = 0
        self.title = ""
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skip_depth += 1
        if tag == "title":
            self._in_title = True

    def handle_endtag(self, tag):
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1
        if tag == "title":
            self._in_title = False

    def handle_data(self, data):
        if self._in_title:
            self.title += data
        elif not self._skip_depth and data.strip():
            self.parts.append(data.strip())


def extract_html(data: bytes) -> tuple[str, str]:
    p = _HtmlTextParser()
    try:
        p.feed(data.decode("utf-8", errors="replace"))
    except Exception:
        pass
    return "\n".join(p.parts), p.title.strip()


def extract_plain(data: bytes) -> tuple[str, str]:
    text = data.decode("utf-8", errors="replace")
    return text, ""


_MD_TITLE_RE = re.compile(r"^#\s+(.+)$", re.MULTILINE)


def extract_markdown(data: bytes) -> tuple[str, str]:
    text = data.decode("utf-8", errors="replace")
    m = _MD_TITLE_RE.search(text)
    return text, (m.group(1).strip() if m else "")


Extractor = Callable[[bytes], tuple[str, str]]  # data -> (text, title)

_REGISTRY: dict[str, Extractor] = {
    "text/html": extract_html,
    "text/markdown": extract_markdown,
}


def register_extractor(mime: str, fn: Extractor) -> None:
    _REGISTRY[mime] = fn


def extract_text(data: bytes, mime: str) -> tuple[str, str] | None:
    """(text, title) for text-bearing content, None for binary."""
    fn = _REGISTRY.get(mime)
    if fn is not None:
        return fn(data)
    if is_text_mime(mime):
        return extract_plain(data)
    return None
