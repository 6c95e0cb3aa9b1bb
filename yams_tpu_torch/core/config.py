"""Configuration.

Mirrors the reference's TOML config + ConfigResolver (src/config/config_helpers.cpp,
src/daemon/components/ConfigResolver.cpp): a single typed config merged from
defaults <- TOML file <- environment (YAMS_TPU_* vars).

Copied from yams_tpu/core/config.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Any

try:
    import tomllib
except ImportError:  # pragma: no cover
    tomllib = None


def default_data_dir() -> pathlib.Path:
    env = os.environ.get("YAMS_TPU_STORAGE") or os.environ.get("YAMS_STORAGE")
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_DATA_HOME")
    base = pathlib.Path(xdg) if xdg else pathlib.Path.home() / ".local" / "share"
    return base / "yams_tpu"


def default_config_path() -> pathlib.Path:
    xdg = os.environ.get("XDG_CONFIG_HOME")
    base = pathlib.Path(xdg) if xdg else pathlib.Path.home() / ".config"
    return base / "yams_tpu" / "config.toml"


@dataclasses.dataclass(slots=True)
class ChunkingConfig:
    # FastCDC-style gear CDC. The reference uses Rabin w/ 64 KB expected chunks
    # (include/yams/chunking/chunker.h:44-51); boundary-parity, not byte-parity.
    min_size: int = 16 * 1024
    avg_size: int = 64 * 1024
    max_size: int = 256 * 1024


@dataclasses.dataclass(slots=True)
class CompressionConfig:
    enabled: bool = True
    algorithm: str = "zstd"  # zstd | lzma | none
    zstd_level: int = 3
    zstd_hot_level: int = 1   # ingest-path tier (negative = zstd fast mode)
    lzma_level: int = 6
    min_size: int = 1024          # below this, store raw
    archive_after_days: int = 30  # policy: old blocks -> lzma
    incompressible_types: tuple[str, ...] = (
        "image/", "video/", "audio/", "application/zip", "application/gzip",
        "application/zstd", "application/x-xz",
    )


@dataclasses.dataclass(slots=True)
class EmbeddingConfig:
    # Simeon fixed_hash_384 profile parity
    # (reference src/embedding_simeon/simeon_embedding_backend.cpp:84-117).
    profile: str = "fixed_hash_384"
    provider: str = "simeon"   # simeon | hf | neural | mock | plugin name
    checkpoint: str = ""       # .npz for provider="hf" (converted/trained)
    dim: int = 384
    sketch_dim: int = 4096
    seed: int = 0x59414D53  # 'YAMS'
    char_ngrams: tuple[int, ...] = (3, 4, 5)
    word_ngrams: tuple[int, ...] = (1, 2)
    max_doc_tokens: int = 8192

    @property
    def space_id(self) -> str:
        return (
            f"{self.profile}/d{self.dim}/s{self.sketch_dim}/seed{self.seed:x}/v2"
        )


@dataclasses.dataclass(slots=True)
class VectorIndexConfig:
    dim: int = 384
    dtype: str = "bfloat16"     # device dtype for the embedding matrix
    capacity: int = 1 << 14      # initial capacity (grows by doubling)
    block_rows: int = 2048       # scan tile rows
    # vector engine (reference vector_types.h:31-35 engine select):
    #   dense — bf16/int8 matrix in HBM (ExactScan/streaming/int8 tiers)
    #   pq    — PQ-ADC codes (reference SimeonPqAdc default profile m x 256)
    #   pq4   — packed 4-bit capacity tier (D/16 bytes/row; ~100M x 768-d
    #           per 16 GB chip; dense matrix stays on host for rerank)
    # pq engines auto-build codebooks once active rows reach pq_min_rows
    # (AppContext checkpoint cadence — reference CheckpointManager persists
    # PQ with staleness stamps) and rebuild when the corpus doubles.
    engine: str = "dense"
    # multi-chip serving (SURVEY §2.11): "auto" row-shards the corpus over
    # every visible device when more than one is present, "on" forces it
    # (and raises if the mesh can't be built), "off" stays single-device.
    # The engine still falls back per-batch for features the sharded
    # program can't express (PQ tier, non-max chunk agg, ColBERT rerank).
    sharded: str = "auto"
    pq_min_rows: int = 4096
    pq_m: int = 32               # PQ subquantizers (reference sqlite_vec_backend.h:52)
    pq_ksub: int = 256
    pq_train_limit: int = 4096
    pq_rerank_factor: int = 2
    # ADC scan window: 0 = auto (1 below 1M active rows, else 64 — one
    # candidate per window, recovered by the exact rerank; measured 6x scan
    # speedup at 16.7M x 768, docs/RESULTS.md). Must divide block_rows.
    pq_group: int = 0


@dataclasses.dataclass(slots=True)
class LexicalIndexConfig:
    k1: float = 1.2
    b: float = 0.75
    # FTS5 bm25(documents_fts, 1.0, 10.0): title column weighted 1.0, content 10.0
    # (reference src/metadata/repository/search_ops.cpp:471).
    title_weight: float = 1.0
    content_weight: float = 10.0
    max_query_terms: int = 16
    # per-term postings scanned on device; impact-ordered so truncation is an
    # early-termination. Keep max_query_terms*postings_window <= ~16k: the
    # lexical leg sorts that many (doc, impact) pairs per query.
    postings_window: int = 1024
    # packed 2-D postings budget (i32 entries = vocab * window). Below it the
    # device index also carries a (V, window) packed matrix enabling the
    # row-gather fast path (~3x lexical-leg speedup); above it (huge vocabs)
    # only CSR ships. 128M entries = 512 MB HBM.
    packed_max_entries: int = 128 * 1024 * 1024
    # query-side morphological expansion: query terms additionally match
    # same-stem vocab variants at a discounted weight (fills otherwise-unused
    # max_query_terms slots; the BM25 kernels scale contributions by the
    # fractional term mask). The reference reaches morphological recall via
    # Simeon subword lexical recipes (simeon_lexical_backend.cpp).
    stem_expansion: bool = True
    stem_expansion_weight: float = 0.6
    # -- multi-field lexical strategies (SimeonLexicalBackend analog) --------
    # The reference's in-memory Simeon lexical stack rescopes the lexical leg
    # with SAB-smooth (SubwordAwareBackoff γ=5), keyphrase and lead-field
    # strategies, bandit/entropy-routed per query
    # (src/search/simeon_lexical_backend.cpp:1, search_engine.cpp:1460-1480).
    # TPU-first analog: the strategies are NAMESPACED TOKEN FIELDS folded
    # into the one postings tensor at build time — bigrams (keyphrase),
    # lead-window tokens (lead-field), char-trigrams (SAB subword backoff) —
    # so every arm is purely a different query-side (ids, weights) vector
    # into the SAME compiled device program: no new kernels, no recompiles.
    field_bigrams: bool = True
    field_lead: bool = True
    field_subword: bool = True
    lead_tokens: int = 64          # doc-lead window, reference lead=64
    bigram_weight: float = 0.25    # keyphrase arm boost (reference 0.25/0.30)
    lead_weight: float = 0.45      # lead-field arm boost
    subword_gamma: float = 5.0     # SAB γ: per-trigram weight = 1/γ
    subword_min_len: int = 4       # only backoff tokens >= this length
    subword_max_doc_tokens: int = 512  # distinct tokens emitting trigrams/doc
    subword_tris_per_token: int = 8
    max_bigrams_per_doc: int = 256


@dataclasses.dataclass(slots=True)
class DaemonConfig:
    socket_path: str = ""   # default: <data_dir>/daemon.sock
    max_message_bytes: int = 256 * 1024 * 1024
    worker_threads: int = 4
    auto_embed: bool = True
    # micro-batching serving aggregator: concurrent searches (plain AND
    # filtered) wait up to this long for co-travellers, then run as fused
    # device batches. 0 = off.
    search_batch_window_ms: float = 2.0
    search_batch_max: int = 64
    # batches pipelined concurrently (overlaps host<->device round trips)
    search_batch_inflight: int = 4
    # threads in the read-only search pool
    search_workers: int = 4


def _search_config_factory():
    # lazy: search config is a leaf dataclass but lives in the search layer
    from ..search.config import SearchEngineConfig

    return SearchEngineConfig()


@dataclasses.dataclass(slots=True)
class Config:
    data_dir: pathlib.Path = dataclasses.field(default_factory=default_data_dir)
    chunking: ChunkingConfig = dataclasses.field(default_factory=ChunkingConfig)
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    embedding: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    vector: VectorIndexConfig = dataclasses.field(default_factory=VectorIndexConfig)
    lexical: LexicalIndexConfig = dataclasses.field(default_factory=LexicalIndexConfig)
    daemon: DaemonConfig = dataclasses.field(default_factory=DaemonConfig)
    search: Any = dataclasses.field(default_factory=_search_config_factory)

    @property
    def storage_dir(self) -> pathlib.Path:
        return self.data_dir / "storage"

    @property
    def metadata_db(self) -> pathlib.Path:
        return self.data_dir / "yams.db"

    @property
    def vectors_dir(self) -> pathlib.Path:
        return self.data_dir / "vectors"

    @property
    def wal_dir(self) -> pathlib.Path:
        return self.data_dir / "wal"

    @property
    def socket_path(self) -> pathlib.Path:
        if self.daemon.socket_path:
            return pathlib.Path(self.daemon.socket_path)
        return self.data_dir / "daemon.sock"


def _apply_section(obj: Any, section: dict[str, Any]) -> None:
    for key, value in section.items():
        if hasattr(obj, key):
            cur = getattr(obj, key)
            if dataclasses.is_dataclass(cur) and isinstance(value, dict):
                _apply_section(cur, value)
            elif isinstance(cur, pathlib.Path):
                setattr(obj, key, pathlib.Path(value))
            elif isinstance(cur, tuple) and isinstance(value, list):
                setattr(obj, key, tuple(value))
            else:
                setattr(obj, key, type(cur)(value) if cur is not None else value)


def load_config(
    path: pathlib.Path | None = None, data_dir: pathlib.Path | str | None = None
) -> Config:
    """defaults <- TOML <- env, as the reference's ConfigResolver does."""
    cfg = Config()
    path = path or default_config_path()
    if tomllib is not None and path.is_file():
        with open(path, "rb") as f:
            _apply_section(cfg, tomllib.load(f))
    if data_dir is not None:
        cfg.data_dir = pathlib.Path(data_dir)
    elif os.environ.get("YAMS_TPU_STORAGE"):
        cfg.data_dir = pathlib.Path(os.environ["YAMS_TPU_STORAGE"])
    if os.environ.get("YAMS_TPU_SOCKET"):
        cfg.daemon.socket_path = os.environ["YAMS_TPU_SOCKET"]
    if os.environ.get("YAMS_TPU_EMBEDDING_PROVIDER"):
        cfg.embedding.provider = os.environ["YAMS_TPU_EMBEDDING_PROVIDER"]
    if os.environ.get("YAMS_TPU_EMBEDDING_CHECKPOINT"):
        cfg.embedding.checkpoint = os.environ["YAMS_TPU_EMBEDDING_CHECKPOINT"]
    # env-layered search knobs (reference: search_config_environment.cpp):
    # YAMS_SEARCH_<FIELD> overrides any SearchEngineConfig field
    for f in dataclasses.fields(cfg.search):
        raw = os.environ.get(f"YAMS_SEARCH_{f.name.upper()}")
        if raw is None:
            continue
        cur = getattr(cfg.search, f.name)
        try:
            if isinstance(cur, bool):
                setattr(cfg.search, f.name,
                        raw.lower() in ("1", "true", "yes", "on"))
            elif isinstance(cur, (int, float, str)):
                setattr(cfg.search, f.name, type(cur)(raw))
        except ValueError:
            pass  # malformed override: keep the configured value
    return cfg
