"""Embedding-time text chunking strategies.

Parity: include/yams/vector/document_chunker.h:19-27 (FIXED_SIZE / SENTENCE /
PARAGRAPH / SLIDING_WINDOW / RECURSIVE / MARKDOWN_AWARE) — the device index
stores one vector per text chunk and aggregates chunk->doc scores on device.

Copied from yams_tpu/embed/chunker.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(slots=True)
class TextChunk:
    text: str
    start: int
    end: int
    index: int


_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_PARA_RE = re.compile(r"\n\s*\n")
_MD_HEADER_RE = re.compile(r"^#{1,6}\s", re.MULTILINE)


def _pack(pieces: list[tuple[str, int]], target: int, overlap: int) -> list[TextChunk]:
    """Greedy-pack (text, offset) pieces into ~target-char chunks w/ overlap."""
    chunks: list[TextChunk] = []
    buf: list[tuple[str, int]] = []
    size = 0
    for piece, off in pieces:
        if size + len(piece) > target and buf:
            text = " ".join(p for p, _ in buf)
            chunks.append(TextChunk(text, buf[0][1], off, len(chunks)))
            # carry overlap tail
            keep: list[tuple[str, int]] = []
            acc = 0
            for p, o in reversed(buf):
                keep.insert(0, (p, o))
                acc += len(p)
                if acc >= overlap:
                    break
            buf, size = keep, acc
        buf.append((piece, off))
        size += len(piece)
    if buf:
        text = " ".join(p for p, _ in buf)
        chunks.append(TextChunk(text, buf[0][1], buf[-1][1] + len(buf[-1][0]), len(chunks)))
    return chunks


def _chunk_semantic(text: str, target_chars: int, embedder) -> list[TextChunk]:
    """Embedding-driven boundaries: split into sentences, embed each, place
    chunk boundaries at adjacent-similarity local minima (semantic topic
    shifts), then pack runs to the size budget.

    NOTE: this is a REAL semantic chunker — the reference's SemanticChunker
    is a fixed-size placeholder with computeSimilarity() hardcoded to 0.5
    (document_chunker.cpp:1086-1138); we implement what its interface
    promises.
    """
    import numpy as np

    pieces, off = [], 0
    for sent in _SENT_RE.split(text):
        s = sent.strip()
        if s:
            idx = text.find(sent, off)
            pieces.append((s, idx if idx >= 0 else off))
            off = (idx if idx >= 0 else off) + len(sent)
    if len(pieces) < 3:
        return _pack(pieces, target_chars, 0) if pieces else []

    vecs = np.asarray(embedder([p for p, _ in pieces]), np.float32)
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    sims = np.sum(vecs[:-1] * vecs[1:], axis=1)       # adjacent cosine
    # boundaries: local minima below (mean - 0.5*std) — topic shifts
    thresh = float(np.mean(sims) - 0.5 * np.std(sims))
    bounds = {
        i + 1
        for i in range(len(sims))
        if sims[i] < thresh
        and (i == 0 or sims[i] <= sims[i - 1])
        and (i == len(sims) - 1 or sims[i] <= sims[i + 1])
    }

    chunks: list[TextChunk] = []
    buf: list[tuple[str, int]] = []
    size = 0

    def flush():
        nonlocal buf, size
        if buf:
            t = " ".join(p for p, _ in buf)
            chunks.append(TextChunk(
                t, buf[0][1], buf[-1][1] + len(buf[-1][0]), len(chunks)))
        buf, size = [], 0

    for i, (p, o) in enumerate(pieces):
        if buf and (i in bounds or size + len(p) > target_chars):
            flush()
        buf.append((p, o))
        size += len(p)
    flush()
    return chunks


def chunk_document(
    text: str,
    strategy: str = "sentence",
    target_chars: int = 1024,
    overlap_chars: int = 128,
    embedder=None,
) -> list[TextChunk]:
    """embedder: optional callable texts -> (N, D) vectors; used by
    strategy='semantic' (without one, semantic falls back to sentence —
    the reference factory does the same, document_chunker.cpp:778-783)."""
    if not text.strip():
        return []
    if len(text) <= target_chars and strategy != "sliding_window":
        return [TextChunk(text, 0, len(text), 0)]

    if strategy == "semantic" and embedder is not None:
        return _chunk_semantic(text, target_chars, embedder)

    if strategy == "fixed_size":
        out = []
        step = max(target_chars - overlap_chars, 1)
        for i, start in enumerate(range(0, len(text), step)):
            piece = text[start : start + target_chars]
            if piece.strip():
                out.append(TextChunk(piece, start, start + len(piece), len(out)))
            if start + target_chars >= len(text):
                break
        return out

    if strategy == "sliding_window":
        return chunk_document(text, "fixed_size", target_chars, overlap_chars)

    if strategy == "paragraph":
        pieces, off = [], 0
        for para in _PARA_RE.split(text):
            p = para.strip()
            if p:
                pieces.append((p, text.find(para, off)))
            off += len(para)
        return _pack(pieces, target_chars, overlap_chars)

    if strategy == "markdown":
        # split at headers first, then pack sections
        bounds = [m.start() for m in _MD_HEADER_RE.finditer(text)] + [len(text)]
        if bounds[0] != 0:
            bounds.insert(0, 0)
        pieces = []
        for a, b in zip(bounds, bounds[1:]):
            sec = text[a:b].strip()
            if sec:
                pieces.append((sec, a))
        return _pack(pieces, target_chars, overlap_chars)

    if strategy == "recursive":
        # try paragraph, then sentence, then fixed for oversized chunks
        out: list[TextChunk] = []
        for c in chunk_document(text, "paragraph", target_chars, overlap_chars):
            if len(c.text) <= target_chars * 2:
                out.append(TextChunk(c.text, c.start, c.end, len(out)))
            else:
                for sub in chunk_document(c.text, "sentence", target_chars, overlap_chars):
                    out.append(
                        TextChunk(sub.text, c.start + sub.start, c.start + sub.end, len(out))
                    )
        return out

    # default: sentence
    pieces, off = [], 0
    for sent in _SENT_RE.split(text):
        s = sent.strip()
        if s:
            idx = text.find(sent, off)
            pieces.append((s, idx if idx >= 0 else off))
            off = (idx if idx >= 0 else off) + len(sent)
    if not pieces:
        return chunk_document(text, "fixed_size", target_chars, overlap_chars)
    return _pack(pieces, target_chars, overlap_chars)
