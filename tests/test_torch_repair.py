"""The port's RepairService against the reference's, on the CPU.

One seeded data dir (written by the port's AppContext: notes, code, a
binary, a URL-named download, an exact duplicate and a bigram concept in
four documents) is copied once for each package. The reference's fault
battery (tests/test_repair_ability.py) is injected into both copies, and
both packages' RepairService run the same ops: the report strings are equal
op by op, except the departures the port's repair service names, each
pinned here by a test of its own:

- `embeddings` does not re-queue the binary ('skipped') document, which the
  reference re-queues and reports on every run;
- `topology` resets the engine's route-risk calibration and its
  persistence stat for the new construction (the reference keeps the old
  construction's shadow evidence);
- `downloads` normalizes URL-named documents and says its .part/resume
  cleanup waits for ROADMAP queue 1 item 3;
- `orphans` keeps the blocks a live manifest lists (the reference's full
  repair deletes every block once the refcount table is lost);
- `doctor`'s device line reads torch on the app's device.

After a full repair the port's doctor is green.
"""

import pathlib
import shutil

import pytest

from test_torch_services import port_config_for, ref_config_for
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu.services.repair_service import RepairService as RefRepair
from yams_tpu_torch.services.app import AppContext
from yams_tpu_torch.services.repair_service import RepairService, device_check

DOCS = {
    "notes/alpha.txt": "alpha document about storage engines and compaction",
    "notes/beta.txt": "beta document compares lexical and vector retrieval",
    "notes/gamma.md": "# gamma\nknowledge graphs connect entities and docs",
    "src/delta.py": "def delta():\n    return 'refcount semantics'\n",
    "src/epsilon.txt": "epsilon covers checkpoint and recovery paths",
    "logs/zeta.txt": "zeta log line mentions quarantine and integrity",
    "notes/eta.txt": "eta: storage engines keep write amplification low",
    "notes/theta.txt": "theta benchmarks storage engines under load",
    "notes/iota.txt": "iota: storage engines and the page cache",
    "notes/alpha_copy.txt": "alpha document about storage engines and compaction",
    "https://example.com/files/report.txt": "a downloaded report on raft logs",
}
BLOB = bytes(range(256)) * 20
DOWNLOADS_WAIT = "the download service waits for ROADMAP queue 1 item 3"


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("seed")
    app = AppContext(port_config_for(root / "data"), device="cpu")
    for path, text in DOCS.items():
        app.documents.add_bytes(text.encode(), path)
    app.documents.add_bytes(BLOB, "bin/blob.bin")
    app.close()
    return root / "data"


@pytest.fixture()
def apps(seeded, tmp_path):
    """(port app, reference app), each on its own copy of the seeded dir."""
    shutil.copytree(seeded, tmp_path / "port")
    shutil.copytree(seeded, tmp_path / "ref")
    for lock in (tmp_path / "port" / ".lock", tmp_path / "ref" / ".lock"):
        lock.unlink(missing_ok=True)
    port = AppContext(port_config_for(tmp_path / "port"), device="cpu")
    ref = RefApp(ref_config_for(tmp_path / "ref"))
    yield port, ref
    port.close()
    ref.close()


def _block_files(app) -> list[pathlib.Path]:
    root = pathlib.Path(app.config.storage_dir)
    hexd = set("0123456789abcdef")
    return sorted(p for p in root.rglob("*")
                  if p.is_file() and len(p.name) >= 32 and set(p.name) <= hexd)


def _metadata_faults(app):
    db = app.db
    with db.lock, db.conn:
        db.conn.execute("DELETE FROM documents_fts")
        db.conn.execute("UPDATE documents SET mime_type='application/x-bogus'"
                        " WHERE file_path LIKE '%alpha%' OR file_path LIKE '%delta%'")
        db.conn.execute("UPDATE documents SET extraction_status='pending'"
                        " WHERE file_path LIKE '%beta%'")
        db.conn.execute("DELETE FROM path_tree_nodes")
    rc = app.content_store.refcounter
    with rc._lock, rc._conn:
        rc._conn.execute("DELETE FROM block_references")


def _storage_faults(app):
    blocks = _block_files(app)
    raw = bytearray(blocks[0].read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    blocks[0].write_bytes(bytes(raw))
    blocks[-1].unlink()


def _orphan(app):
    import hashlib

    payload = b"orphaned payload never referenced"
    app.content_store.engine.store(hashlib.sha256(payload).hexdigest(), payload)


def _embedding_backlog(app):
    with app.db.lock, app.db.conn:
        app.db.conn.execute("UPDATE embedding_status SET status='pending'"
                            " WHERE status='done'")


def _nothing(app):
    pass


FAULTS = {
    "metadata": (_metadata_faults,
                 ["fts5", "mime", "stuck_documents", "path_tree", "block_references"]),
    "storage": (_storage_faults, ["chunks", "compression"]),
    "orphans": (_orphan, ["orphans"]),
    "embeddings": (_embedding_backlog, ["embeddings", "graph"]),
    "concepts": (_nothing, ["concepts", "dedupe", "topology"]),
    "full": (_metadata_faults, None),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_battery_reports_match_the_reference(apps, fault):
    port, ref = apps
    inject, ops = FAULTS[fault]
    inject(port)
    inject(ref)
    got = RepairService(port).run(ops)
    want = RefRepair(ref).run(ops)
    assert list(got) == list(want) == (ops or list(RepairService.OPS))
    assert not any(v.startswith("failed") for v in got.values()), got
    # the named departures
    if "downloads" in got:
        assert got.pop("downloads") == \
            f"1 url-docs normalized, .part/resume cleanup skipped: {DOWNLOADS_WAIT}"
        assert want.pop("downloads").startswith("1 url-docs normalized, 0 orphan")
    if fault == "full":       # the refcount table was lost: see test_orphans_*
        assert got.pop("orphans") == "0 orphan blocks removed, 0 GC'd"
        assert want.pop("orphans") == "11 orphan blocks removed, 0 GC'd"
        for key in ("mime", "chunks", "compression"):  # they read the lost blocks
            got.pop(key), want.pop(key)
    if "embeddings" in got:   # the reference re-queues the skipped binary
        embedded = "11" if fault == "embeddings" else "0"
        assert got.pop("embeddings") == f"{embedded} documents embedded"
        assert want.pop("embeddings") == \
            f"{embedded} documents embedded (1 re-queued from lost index)"
    assert got == want
    if fault == "metadata":   # the user-visible invariants are back
        hits = port.search.search("compaction", search_type="keyword").hits
        assert any("alpha" in h.path for h in hits)
        for path, text in DOCS.items():
            if "://" not in path:
                assert port.documents.cat(path) == text.encode()
    if fault == "storage":
        assert not port.content_store.verifier.verify_all().corrupted
    if fault == "concepts":
        assert got["concepts"].startswith("1 concepts") and "clusters over" in got["topology"]
        assert port.kg.resolve_alias("storage engines", limit=2)


def test_doctor_green_after_full_repair(apps):
    port, _ = apps
    _metadata_faults(port)
    _embedding_backlog(port)
    checks = RepairService(port).doctor()
    assert not checks["embeddings"][0]
    RepairService(port).run()
    checks = RepairService(port).doctor()
    assert all(ok for ok, _ in checks.values()), checks
    assert checks["device"] == (True, "cpu") == device_check(port.device)


def test_orphans_keep_blocks_a_manifest_lists(apps):
    """With the refcount table lost, the reference's full repair removes
    every block as an orphan before `block_references` rebuilds the table,
    and no document reads back; the port keeps the blocks its manifests
    list."""
    port, ref = apps
    for app in (port, ref):
        rc = app.content_store.refcounter
        with rc._lock, rc._conn:
            rc._conn.execute("DELETE FROM block_references")
    RepairService(port).run()
    RefRepair(ref).run()
    assert RepairService(port).doctor()["block_integrity"] == (True, "11/11 ok")
    assert RefRepair(ref).doctor()["block_integrity"] == (False, "0/11 ok")
    assert port.documents.cat("notes/alpha.txt") == DOCS["notes/alpha.txt"].encode()


def test_skipped_docs_are_not_requeued(apps):
    """The reference re-queues the binary document on every run (its
    `status != 'pending'` query); the port re-queues only embedded docs
    that lost their vector rows."""
    port, ref = apps
    for _ in range(2):
        assert RepairService(port).repair_embeddings() == "0 documents embedded"
        assert RefRepair(ref).repair_embeddings() == \
            "0 documents embedded (1 re-queued from lost index)"
    # a doc that lost its rows is still re-queued and re-embedded
    eng = port.search_engine
    slot = next(iter(eng.vector_index._rows_by_slot))
    doc_id = eng._doc_by_slot[slot]
    eng.vector_index.remove_doc(slot)
    assert RepairService(port).repair_embeddings() == \
        "1 documents embedded (1 re-queued from lost index)"
    assert eng.vector_index._rows_by_slot.get(eng._slot_by_doc[doc_id])


def test_calibration_resets_on_repair(apps):
    """Shadow evidence of one construction does not survive `repair
    topology` in the port; in the reference it does."""
    port, ref = apps
    for app in (port, ref):
        app.search_engine.rebuild_topology()
        app.search_engine.search_batch(["storage engines", "raft logs", "vector retrieval"])
        assert app.search_engine._route_calib["queries"] == 3
    RepairService(port).run(["topology"])
    RefRepair(ref).run(["topology"])
    arts = port.search_engine.topology.artifacts
    assert port.search_engine._route_calib == {
        "fingerprint": f"0/{len(arts.centroids)}", "queries": 0, "protected": 0,
        "missed": 0}
    assert port.search_engine.stats()["topology_persistence"] == arts.centroid_persistence
    assert ref.search_engine._route_calib["queries"] == 3     # stale evidence kept


def test_downloads_wait_for_item_3(apps):
    port, ref = apps
    got = RepairService(port).repair_downloads()
    want = RefRepair(ref).repair_downloads()
    assert got == f"1 url-docs normalized, .part/resume cleanup skipped: {DOWNLOADS_WAIT}"
    assert want.startswith("1 url-docs normalized, 0 orphan")
    for app in (port, ref):
        row = app.db.execute("SELECT id, file_path FROM documents"
                             " WHERE file_name='report.txt'").fetchone()
        assert row["file_path"] == "report.txt"
        assert {"downloaded", "host:example.com", "scheme:https"} <= \
            set(app.metadata.get_tags(row["id"]))


def test_doctor_device_line(apps):
    port, ref = apps
    got = RepairService(port).doctor()
    want = RefRepair(ref).doctor()
    assert got["device"] == (True, "cpu")
    assert want["device"][0]
    assert set(got) == set(want)
