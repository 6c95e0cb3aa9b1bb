"""SHA-256 content addressing.

Parity: include/yams/crypto/hasher.h:14-77 (IContentHasher / SHA256Hasher).
Python's hashlib is OpenSSL-backed (SHA-NI / NEON accelerated), matching the
reference's OpenSSL dependency; the streaming interface below mirrors
init/update/finalize so the storage layer can hash without buffering files.

Copied from yams_tpu/ingest/hasher.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import hashlib
import pathlib

_READ_SIZE = 4 * 1024 * 1024


def sha256_bytes(data: bytes | memoryview) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str | pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(_READ_SIZE)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class Sha256Hasher:
    """Streaming hasher with init/update/finalize (hasher.h:50-77)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def init(self) -> None:
        self._h = hashlib.sha256()

    def update(self, data: bytes | memoryview) -> None:
        self._h.update(data)

    def finalize(self) -> str:
        return self._h.hexdigest()

    @staticmethod
    def hash(data: bytes) -> str:
        return sha256_bytes(data)
