"""Core value types shared across layers.

Parity notes: ContentHash ~ reference Hash (SHA-256 hex, include/yams/core/types.h);
Chunk/ChunkRef ~ include/yams/chunking/chunker.h; Manifest ~ the ordered chunk
list the reference's ManifestManager persists (src/manifest/manifest_manager.cpp).

Copied from yams_tpu/core/types.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

ContentHash = str  # lowercase sha256 hex digest (64 chars)

HASH_HEX_LEN = 64


def is_valid_hash(h: str) -> bool:
    if len(h) != HASH_HEX_LEN:
        return False
    try:
        int(h, 16)
        return True
    except ValueError:
        return False


@dataclasses.dataclass(frozen=True, slots=True)
class ChunkRef:
    """A chunk's identity + placement inside its parent file."""

    hash: ContentHash
    offset: int
    size: int


@dataclasses.dataclass(frozen=True, slots=True)
class Chunk:
    """A materialized chunk (ref + bytes)."""

    ref: ChunkRef
    data: bytes


@dataclasses.dataclass(slots=True)
class Manifest:
    """Ordered chunk list reconstructing one content hash."""

    content_hash: ContentHash
    total_size: int
    chunks: list[ChunkRef]
    version: int = 1

    def to_dict(self) -> dict[str, Any]:
        return {
            "v": self.version,
            "hash": self.content_hash,
            "size": self.total_size,
            "chunks": [(c.hash, c.offset, c.size) for c in self.chunks],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Manifest":
        return cls(
            content_hash=d["hash"],
            total_size=d["size"],
            chunks=[ChunkRef(h, o, s) for (h, o, s) in d["chunks"]],
            version=d.get("v", 1),
        )


@dataclasses.dataclass(slots=True)
class DocumentInfo:
    """Metadata row for one ingested document (reference: metadata/document_metadata.h)."""

    id: int = -1
    file_path: str = ""
    file_name: str = ""
    file_extension: str = ""
    file_size: int = 0
    sha256_hash: ContentHash = ""
    mime_type: str = "application/octet-stream"
    created_time: float = dataclasses.field(default_factory=time.time)
    modified_time: float = dataclasses.field(default_factory=time.time)
    indexed_time: float = dataclasses.field(default_factory=time.time)
    content_extracted: bool = False
    extraction_status: str = "pending"  # pending|success|failed|skipped
    tags: list[str] = dataclasses.field(default_factory=list)
    metadata: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(slots=True)
class StoreResult:
    """Outcome of ContentStore.store (reference: api/content_store.h:21-40)."""

    content_hash: ContentHash
    bytes_stored: int
    bytes_deduped: int
    total_bytes: int
    chunk_count: int
    dedup_ratio: float
    duration_ms: float
    phase_timings_ms: dict[str, float] = dataclasses.field(default_factory=dict)
