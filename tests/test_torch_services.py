"""The port's service layer held against the reference's, on the CPU.

One seeded tree (~300 files: zipf-word notes in a few directories, Python
sources for the symbol stage, a duplicate, a small binary) is added through
`yams_tpu.services.app.AppContext` (JAX on the CPU) and through
`yams_tpu_torch.services.app.AppContext(device="cpu")`, each on its own data
dir, at small widths (dim 64):

- the same documents: ids, paths, hashes, sizes, mime types, extracted
  text, metadata rows, embedding status, the add reports;
- the same searches (hybrid, keyword, semantic; path, tag and collection
  filters; the batched `search_many_requests`): on the CSR lexical leg
  (`packed_max_entries=0`) the same ids with scores within 1e-4; on the
  default packed leg the same ids with scores within 5e-3 (its BM25 sums
  drift a few ulps from the reference's, and the rank-based RRF term turns
  a swapped near-tie into up to ~4e-3, ROADMAP §3);
- each package's AppContext opens the other's data dir and answers as the
  writer did;
- the port's departures: int8 reopens as int8; a checkpoint that fails to
  parse is quarantined, while a RuntimeError from `VectorIndex.load`
  propagates and leaves the files in place; the entity side index is saved
  and reopened; sharding "on" and the unported services raise
  NotImplementedError, and an unknown provider the reference's ValueError;
  `YAMS_TPU_DEBUG_NANS` prints that it is not ported; stats list the CPU
  device.
"""

import dataclasses
import pathlib
import shutil

import numpy as np
import pytest

from yams_tpu.core import config as ref_config
from yams_tpu.search.config import SearchEngineConfig as RefSearchConfig
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.core import config as port_config
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.services import app as port_app_module
from yams_tpu_torch.services.app import AppContext

WORDS = [f"w{i}" for i in range(600)] + [
    "scheduler", "thread", "preempt", "memory", "chunking", "hashes", "routing",
    "raft", "consensus", "snapshot", "compaction", "index", "vector", "lexical"]

PY_SOURCE = '''"""Module {i}."""


class Handler{i}:
    def handle_{i}(self, request):
        return route_{i}(request)


def route_{i}(request):
    return request.scheduler_{i}
'''


def make_tree(root: pathlib.Path, n_notes: int = 280, seed: int = 0) -> pathlib.Path:
    """A seeded tree: zipf-word notes in 6 directories, 10 Python files, a
    duplicate note and a small binary."""
    rng = np.random.default_rng(seed)
    for i in range(n_notes):
        d = root / f"d{i % 6}"
        d.mkdir(parents=True, exist_ok=True)
        n = int(rng.integers(20, 200))
        body = " ".join(WORDS[z % len(WORDS)] for z in rng.zipf(1.2, n))
        (d / f"note{i:03d}.{'md' if i % 5 == 0 else 'txt'}").write_text(
            f"Note {i}\n\n{body}.\n")
    (root / "src").mkdir()
    for i in range(10):
        (root / "src" / f"mod{i}.py").write_text(PY_SOURCE.format(i=i))
    shutil.copy(root / "d1" / "note001.txt", root / "d2" / "copy_of_note001.txt")
    (root / "blob.bin").write_bytes(rng.bytes(5000))
    return root


def small_config(cfg_module, search_cls, data_dir, packed: bool = False, **vector):
    cfg = cfg_module.Config(data_dir=pathlib.Path(data_dir))
    cfg.chunking = cfg_module.ChunkingConfig(min_size=1024, avg_size=4096, max_size=16384)
    cfg.embedding = cfg_module.EmbeddingConfig(dim=64, sketch_dim=512)
    cfg.vector = cfg_module.VectorIndexConfig(dim=64, capacity=256, block_rows=128, **vector)
    cfg.lexical = cfg_module.LexicalIndexConfig(
        postings_window=64, **({} if packed else {"packed_max_entries": 0}))
    cfg.search = search_cls()
    return cfg


def port_config_for(data_dir, packed: bool = False, **vector):
    return small_config(port_config, SearchEngineConfig, data_dir, packed, **vector)


def ref_config_for(data_dir, packed: bool = False, **vector):
    return small_config(ref_config, RefSearchConfig, data_dir, packed, **vector)


TAGGED = [(f"tagged/t{i}.txt", f"raft consensus snapshot {WORDS[i]} compaction {i}",
           ["ops"] if i % 2 else ["ops", "raft"], "logs" if i < 4 else "")
          for i in range(8)]


def populate(app, tree: pathlib.Path):
    """The tree, then a few tagged documents in a collection."""
    rep = app.indexing.add_directory(tree)
    for name, text, tags, coll in TAGGED:
        app.documents.add_bytes(text.encode(), name, tags=tags, collection=coll)
    return rep


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def _pair(tmp_path_factory, tree, packed):
    root = tmp_path_factory.mktemp("packed" if packed else "csr")
    ref = RefApp(ref_config_for(root / "ref", packed))
    port = AppContext(port_config_for(root / "port", packed), device="cpu")
    reports = (populate(ref, tree), populate(port, tree))
    return ref, port, reports


@pytest.fixture(scope="module")
def csr_apps(tmp_path_factory, tree):
    ref, port, reports = _pair(tmp_path_factory, tree, packed=False)
    yield ref, port, reports
    ref.close()
    port.close()


@pytest.fixture(scope="module")
def packed_apps(tmp_path_factory, tree):
    ref, port, reports = _pair(tmp_path_factory, tree, packed=True)
    yield ref, port, reports
    ref.close()
    port.close()


_TIME_COLUMNS = {"created_time", "modified_time", "indexed_time", "updated_time",
                 "applied_at", "last_touch"}
_TABLES = ("documents", "document_content", "metadata", "embedding_status",
           "path_tree_nodes", "kg_nodes", "kg_aliases", "kg_edges", "doc_entities",
           "vector_models")


def table_rows(db, table: str) -> list[tuple]:
    cols = [r[1] for r in db.execute(f"PRAGMA table_info({table})").fetchall()
            if r[1] not in _TIME_COLUMNS]
    return [tuple(r) for r in db.execute(
        f"SELECT {', '.join(cols)} FROM {table} ORDER BY {', '.join(cols)}").fetchall()]


def test_add_tree_gives_the_same_documents(csr_apps):
    ref, port, (ref_rep, port_rep) = csr_apps
    assert dataclasses.asdict(port_rep) == dataclasses.asdict(ref_rep)
    assert port_rep.files_added == 292 and port_rep.files_failed == 0
    assert port_rep.bytes_deduped > 0                      # the duplicate note
    for table in _TABLES:
        assert table_rows(port.db, table) == table_rows(ref.db, table), table
    ids = ref.metadata.all_document_ids()
    assert port.metadata.all_document_ids() == ids and len(ids) == 300
    for doc_id in ids:
        r, p = ref.metadata.get_document(doc_id), port.metadata.get_document(doc_id)
        assert (p.file_path, p.sha256_hash, p.mime_type, p.tags, p.metadata) == \
            (r.file_path, r.sha256_hash, r.mime_type, r.tags, r.metadata)
        assert port.documents.cat(r.sha256_hash) == ref.documents.cat(r.sha256_hash)
    assert port.metadata.stats() == ref.metadata.stats()
    assert port.symbols.lookup("route_3") == ref.symbols.lookup("route_3")


SEARCHES = [
    ("hybrid", dict(query="raft consensus snapshot")),
    ("hybrid-zipf", dict(query="w1 w2 w7")),
    ("hybrid-rare", dict(query="w311 scheduler memory")),
    ("keyword", dict(query="chunking hashes routing", search_type="keyword")),
    ("semantic", dict(query="thread preempt memory", search_type="semantic")),
    ("path_glob", dict(query="w3 w5", path_glob="*/d2/*")),
    ("tags", dict(query="raft compaction", tags=["raft"])),
    ("collection", dict(query="snapshot", collection="logs")),
    ("qualifier", dict(query="tag:ops consensus w4")),
    ("symbol", dict(query="Handler4 route_4")),
]


def _search(app, kw, batched: bool):
    if batched:
        return app.search.search_many_requests([{"limit": 10, **kw}])[0]
    kw = dict(kw)
    return app.search.search(kw.pop("query"), limit=10, **kw)


def _same_hits(port_resp, ref_resp, atol):
    p = [(h.document_id, h.path) for h in port_resp.hits]
    r = [(h.document_id, h.path) for h in ref_resp.hits]
    assert p == r and p
    np.testing.assert_allclose([h.score for h in port_resp.hits],
                               [h.score for h in ref_resp.hits], atol=atol, rtol=0)
    assert port_resp.total == ref_resp.total


@pytest.mark.parametrize("batched", [False, True], ids=["search", "batched"])
@pytest.mark.parametrize("name,kw", SEARCHES, ids=[s[0] for s in SEARCHES])
def test_searches_match_reference_on_the_csr_leg(csr_apps, name, kw, batched):
    ref, port, _ = csr_apps
    _same_hits(_search(port, kw, batched), _search(ref, kw, batched), atol=1e-4)


@pytest.mark.parametrize("name,kw", SEARCHES[:6], ids=[s[0] for s in SEARCHES[:6]])
def test_searches_match_reference_on_the_default_leg(packed_apps, name, kw):
    ref, port, _ = packed_apps
    _same_hits(_search(port, kw, True), _search(ref, kw, True), atol=5e-3)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_opens_the_others_data_dir(csr_apps, tmp_path, writer):
    """The writer's data dir, checkpointed and copied twice: the other
    package opens one copy, the writer's package the other, and both hold
    the same documents and give the same answers. (A reopen, not the live
    app: single searches warm the engine's in-memory hotzone, which neither
    package restores on open.)"""
    ref, port, _ = csr_apps
    src = port if writer == "port" else ref
    src.checkpoint()
    for name in ("mine", "theirs"):
        shutil.copytree(src.config.data_dir, tmp_path / name,
                        ignore=shutil.ignore_patterns(".lock"))
    ports = AppContext(port_config_for(tmp_path / ("mine" if writer == "port" else "theirs")),
                       device="cpu")
    refs = RefApp(ref_config_for(tmp_path / ("theirs" if writer == "port" else "mine")))
    try:
        assert ports.index_load_event is None and refs.index_load_event is None
        assert ports.metadata.all_document_ids() == src.metadata.all_document_ids()
        assert refs.metadata.all_document_ids() == src.metadata.all_document_ids()
        for _, kw in SEARCHES:
            _same_hits(_search(ports, kw, True), _search(refs, kw, True), atol=1e-4)
    finally:
        ports.close()
        refs.close()


def test_int8_reopens_as_int8(tree, tmp_path):
    cfg = port_config_for(tmp_path / "d", dtype="int8")
    app = AppContext(cfg, device="cpu")
    populate(app, tree)
    want = [_search(app, kw, True) for _, kw in SEARCHES]
    app.close()
    app = AppContext(port_config_for(tmp_path / "d", dtype="int8"), device="cpu")
    try:
        assert app.search_engine.vector_index.device_dtype == "int8"
        assert app.stats.snapshot(detailed=True)["vector_index"]["device_dtype"] == "int8"
        for w, (_, kw) in zip(want, SEARCHES):
            _same_hits(_search(app, kw, True), w, atol=0)
    finally:
        app.close()


def _small_app(data_dir):
    app = AppContext(port_config_for(data_dir), device="cpu")
    for name, text, tags, coll in TAGGED:
        app.documents.add_bytes(text.encode(), name, tags=tags, collection=coll)
    return app


def test_a_truncated_checkpoint_is_quarantined(tmp_path):
    _small_app(tmp_path / "d").close()
    vdir = tmp_path / "d" / "vectors"
    raw = (vdir / "vectors.npz").read_bytes()
    (vdir / "vectors.npz").write_bytes(raw[: len(raw) // 2])
    app = AppContext(port_config_for(tmp_path / "d"), device="cpu")
    try:
        ev = app.index_load_event
        assert ev["event"] == "index_rebuild_required"
        assert "vectors.npz.corrupt-0" in ev["quarantined"]
        assert (vdir / "vectors.npz.corrupt-0").exists() and not (vdir / "vectors.npz").exists()
        assert app.search_engine.vector_index.active_rows == 0
        assert app.search_engine._doc_by_slot == []
        assert app.metadata.document_count() == len(TAGGED)
    finally:
        app.close()


def test_a_device_error_while_loading_propagates_and_keeps_the_files(tmp_path, monkeypatch):
    _small_app(tmp_path / "d").close()
    vdir = tmp_path / "d" / "vectors"
    before = sorted(p.name for p in vdir.iterdir())
    from yams_tpu_torch.index.vector_index import VectorIndex

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(VectorIndex, "load", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        AppContext(port_config_for(tmp_path / "d"), device="cpu")
    assert sorted(p.name for p in vdir.iterdir()) == before
    assert not any("corrupt" in name for name in before)


def test_the_entity_side_index_is_saved_and_reopened(tmp_path):
    app = _small_app(tmp_path / "d")
    for doc_id in app.metadata.all_document_ids():
        app.graph.index_document(doc_id, app.metadata.get_content(doc_id))
    ent = app.search_engine.entity_index
    assert ent.active_rows > 0
    rows, want = ent.active_rows, [_search(app, kw, True) for _, kw in SEARCHES[6:8]]
    app.close()
    app = AppContext(port_config_for(tmp_path / "d"), device="cpu")
    try:
        assert app.search_engine.entity_index.active_rows == rows
        for w, (_, kw) in zip(want, SEARCHES[6:8]):
            _same_hits(_search(app, kw, True), w, atol=0)
    finally:
        app.close()


def test_sharding_on_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", "on")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        AppContext(port_config_for(tmp_path / "d"), device="cpu")
    monkeypatch.setenv("YAMS_VECTOR_SHARDED", "auto")
    app = AppContext(port_config_for(tmp_path / "d"), device="cpu")
    try:
        snap = app.stats.snapshot(detailed=True)
        assert app.sharded is False and snap["sharded"] is False
        assert snap["devices"] == ["cpu"]
    finally:
        app.close()


def test_an_unported_provider_raises(tmp_path):
    """Every provider of the reference's registry is ported (mock, neural
    and hf build in tests/test_torch_providers.py); a name outside the
    registry raises the reference's ValueError."""
    cfg = port_config_for(tmp_path / "d")
    cfg.embedding.provider = "nope"
    with pytest.raises(ValueError, match="unknown embedding provider: 'nope'"):
        AppContext(cfg, device="cpu")


@pytest.mark.parametrize("service,call", [
    ("grep", lambda s: s.grep("x")), ("sessions", lambda s: s.list()),
    ("downloads", lambda s: s.download("file:///x")), ("watch", lambda s: s.run_once("."))])
def test_unported_services_raise_when_used(tmp_path, service, call):
    app = AppContext(port_config_for(tmp_path / "d"), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="not ported: ROADMAP queue 1 item 3"):
            call(getattr(app, service))
    finally:
        app.close()


def test_a_session_filter_raises_rather_than_answering_empty(tmp_path):
    app = _small_app(tmp_path / "d")
    try:
        with pytest.raises(NotImplementedError, match="session service"):
            app.search.search("raft", filters={"session": "s1"})
    finally:
        app.close()


def test_debug_nans_prints_that_it_is_not_ported(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("YAMS_TPU_DEBUG_NANS", "1")
    AppContext(port_config_for(tmp_path / "d"), device="cpu").close()
    err = [ln for ln in capsys.readouterr().err.splitlines() if "DEBUG_NANS" in ln]
    assert len(err) == 1 and "not ported" in err[0]


def test_open_app_takes_the_device(tmp_path):
    app = port_app_module.open_app(tmp_path / "d", device="cpu")
    try:
        assert app.device.type == "cpu" and app.search_engine.device.type == "cpu"
        assert app.content_store.device.type == "cpu"
    finally:
        app.close()


def test_without_zstandard_blocks_are_stored_uncompressed(tmp_path, monkeypatch):
    """Where the zstandard package is missing (as on the card's machine), the
    policy stores what it would have compressed with zstd uncompressed, and
    the reference's store reads those blocks back."""
    from yams_tpu.storage.content_store import ContentStore as RefStore
    from yams_tpu_torch.ingest import compression
    from yams_tpu_torch.storage.content_store import ContentStore

    text = " ".join(WORDS[i % len(WORDS)] for i in range(20_000)).encode()
    monkeypatch.setattr(compression, "zstd_available", lambda: False)
    assert not compression.CompressionPolicy().decide(len(text), "text/plain").compress
    assert compression.CompressionPolicy().decide(
        len(text), "text/plain", age_days=99).algorithm == "lzma"
    chunking = dict(min_size=1024, avg_size=4096, max_size=16384)
    store = ContentStore(tmp_path, port_config.ChunkingConfig(**chunking), device="cpu")
    res = store.store_bytes(text, "text/plain")
    assert res.bytes_stored == len(text) and store.retrieve_bytes(res.content_hash) == text
    blocks = [store.engine.inner.retrieve(c.hash)
              for c in store.refcounter.get_manifest(res.content_hash).chunks]
    assert len(blocks) > 1 and not any(map(compression.is_compressed_block, blocks))
    store.close()
    ref = RefStore(tmp_path, ref_config.ChunkingConfig(**chunking))
    assert ref.retrieve_bytes(res.content_hash) == text
    ref.close()
