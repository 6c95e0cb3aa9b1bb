"""File type detection: magic-number tables + extension hints + text heuristic.

Parity: src/detection/file_type_detector.cpp (libmagic + builtin tables). We
carry our own signature table instead of libmagic — the detector only needs to
route compression policy, extraction, and the content handler registry.

Copied from yams_tpu/ingest/detection.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import pathlib

_MAGIC: list[tuple[bytes, str]] = [
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"BM", "image/bmp"),
    (b"%PDF-", "application/pdf"),
    (b"PK\x03\x04", "application/zip"),
    (b"PK\x05\x06", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"\x28\xb5\x2f\xfd", "application/zstd"),
    (b"\xfd7zXZ\x00", "application/x-xz"),
    (b"7z\xbc\xaf\x27\x1c", "application/x-7z-compressed"),
    (b"BZh", "application/x-bzip2"),
    (b"\x7fELF", "application/x-elf"),
    (b"MZ", "application/x-msdownload"),
    (b"OggS", "audio/ogg"),
    (b"fLaC", "audio/flac"),
    (b"ID3", "audio/mpeg"),
    # RIFF containers disambiguate on bytes 8-12 (see detect_mime)
    (b"RIFF", "audio/wav"),
    (b"\x00\x00\x00\x18ftyp", "video/mp4"),
    (b"\x00\x00\x00\x20ftyp", "video/mp4"),
    (b"ustar", "application/x-tar"),  # at offset 257; see detect_mime
    (b"SQLite format 3\x00", "application/x-sqlite3"),
    (b"{\\rtf", "application/rtf"),
]

_EXT: dict[str, str] = {
    ".txt": "text/plain", ".md": "text/markdown", ".rst": "text/x-rst",
    ".html": "text/html", ".htm": "text/html", ".xml": "application/xml",
    ".json": "application/json", ".jsonl": "application/x-ndjson",
    ".yaml": "application/yaml", ".yml": "application/yaml",
    ".toml": "application/toml", ".ini": "text/plain", ".cfg": "text/plain",
    ".csv": "text/csv", ".tsv": "text/tab-separated-values",
    ".py": "text/x-python", ".c": "text/x-c", ".h": "text/x-c",
    ".cc": "text/x-c++", ".cpp": "text/x-c++", ".hpp": "text/x-c++",
    ".cxx": "text/x-c++", ".rs": "text/x-rust", ".go": "text/x-go",
    ".java": "text/x-java", ".js": "text/javascript", ".ts": "text/typescript",
    ".tsx": "text/typescript", ".jsx": "text/javascript",
    ".sh": "text/x-shellscript", ".bash": "text/x-shellscript",
    ".rb": "text/x-ruby", ".php": "text/x-php", ".swift": "text/x-swift",
    ".kt": "text/x-kotlin", ".kts": "text/x-kotlin",
    ".cs": "text/x-csharp", ".dart": "text/x-dart",
    ".pl": "text/x-perl", ".pm": "text/x-perl",
    ".r": "text/x-r", ".sol": "text/x-solidity", ".zig": "text/x-zig",
    ".scala": "text/x-scala", ".lua": "text/x-lua",
    ".sql": "application/sql", ".proto": "text/x-protobuf",
    ".css": "text/css", ".tex": "text/x-tex", ".lean": "text/x-lean",
    ".pdf": "application/pdf", ".zip": "application/zip",
    ".gz": "application/gzip", ".zst": "application/zstd",
    ".png": "image/png", ".jpg": "image/jpeg", ".jpeg": "image/jpeg",
    ".gif": "image/gif", ".mp3": "audio/mpeg", ".wav": "audio/wav",
    ".mp4": "video/mp4", ".sqlite": "application/x-sqlite3",
    ".db": "application/x-sqlite3",
    ".tar": "application/x-tar", ".tgz": "application/gzip",
    ".webp": "image/webp", ".bmp": "image/bmp", ".flac": "audio/flac",
}

TEXT_MIMES_PREFIX = ("text/",)
TEXT_MIMES_EXACT = {
    "application/json", "application/x-ndjson", "application/yaml",
    "application/toml", "application/xml", "application/sql",
}


def is_text_mime(mime: str) -> bool:
    return mime.startswith(TEXT_MIMES_PREFIX) or mime in TEXT_MIMES_EXACT


def looks_like_text(head: bytes) -> bool:
    if not head:
        return True
    if b"\x00" in head:
        return False
    try:
        head.decode("utf-8")
        return True
    except UnicodeDecodeError:
        # allow a truncated multi-byte sequence at the tail
        try:
            head[:-4].decode("utf-8")
            return True
        except UnicodeDecodeError:
            return False


def detect_mime(head: bytes, path: str | pathlib.Path | None = None) -> str:
    """Detect MIME from leading bytes, falling back to extension then heuristic."""
    if head.startswith(b"RIFF") and len(head) >= 12:
        kind = head[8:12]
        if kind == b"WEBP":
            return "image/webp"
        if kind == b"AVI ":
            return "video/x-msvideo"
        return "audio/wav"  # RIFF....WAVE and unknown RIFF default
    if len(head) > 262 and head[257:262] == b"ustar":
        return "application/x-tar"
    for sig, mime in _MAGIC:
        if sig == b"ustar":
            continue  # handled at offset 257 above
        if head.startswith(sig):
            return mime
    if path is not None:
        ext = pathlib.Path(path).suffix.lower()
        if ext in _EXT:
            return _EXT[ext]
    if looks_like_text(head[:8192]):
        return "text/plain"
    return "application/octet-stream"
