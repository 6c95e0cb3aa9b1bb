"""The port's session and watch services against the reference's, on the CPU.

One seeded tree is added to both packages' AppContext:

- sessions: create, use, pin (which feeds the tuner's feedback), unpin,
  the pinned documents, warm (the engine's hotzone and the metadata's
  boosts), list and delete leave the same state in both, and a search with
  the `session` filter returns the reference's hits;
- watch: `run_once` over a directory reports the same events as the
  reference's for a first pass, a pass with a file added, one modified and
  one deleted (with and without delete_missing), and searches see all
  three changes.
"""

import dataclasses
import os

import pytest

from test_torch_services import make_tree, populate, port_config_for, ref_config_for
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.services.app import AppContext


@pytest.fixture()
def apps(tmp_path):
    tree = make_tree(tmp_path / "tree", n_notes=40)
    port = AppContext(port_config_for(tmp_path / "port"), device="cpu")
    ref = RefApp(ref_config_for(tmp_path / "ref"))
    for app in (port, ref):
        populate(app, tree)
    yield port, ref
    port.close()
    ref.close()


def _hits(resp):
    return [(h.document_id, h.path, round(h.score, 4)) for h in resp.hits]


def _session_state(app, name):
    return (app.sessions.list(), app.metadata.get_session(name),
            sorted(app.sessions.pinned_doc_ids(name)))


def test_sessions_match_the_reference(apps):
    port, ref = apps
    for app in (port, ref):
        s = app.sessions
        s.create("work", {"owner": "t"})
        s.use("work")
        s.pin("*/d1/*")
        s.pin("*/src/mod[12].py", "work")
        s.pin("*/d2/*", "other")
        s.unpin("*/d2/*", "other")
        s.use("fresh")
    assert port.sessions.current == ref.sessions.current == "fresh"
    for name in ("work", "other", "fresh"):
        assert _session_state(port, name) == _session_state(ref, name)
    assert len(port.sessions.pinned_doc_ids("work")) == 9
    assert port.sessions.warm("work", boost=2.0) == ref.sessions.warm("work", boost=2.0) == 9
    assert port.search_engine._hot == ref.search_engine._hot
    assert port.search_engine._hot
    hot = "SELECT document_id, score FROM hotzones ORDER BY document_id"
    assert [tuple(r) for r in port.db.execute(hot)] == [tuple(r) for r in ref.db.execute(hot)]
    assert len(port.db.execute(hot).fetchall()) == 9
    for app in (port, ref):
        app.sessions.delete("other")
    assert port.sessions.list() == ref.sessions.list() == ["fresh", "work"]


@pytest.mark.parametrize("search_type", ["hybrid", "keyword"])
def test_a_session_filtered_search_matches_the_reference(apps, search_type):
    port, ref = apps
    for app in (port, ref):
        app.sessions.pin("*/d3/*", "s1")
        app.sessions.warm("s1")
    kw = dict(limit=10, search_type=search_type, filters={"session": "s1"})
    got = port.search.search("w3 w5 note", **kw)
    want = ref.search.search("w3 w5 note", **kw)
    assert _hits(got) == _hits(want) and got.hits
    assert all("/d3/" in h.path for h in got.hits)


def _events(evs):
    return sorted(dataclasses.astuple(e) for e in evs)


@pytest.mark.parametrize("delete_missing", [False, True])
def test_watch_run_once_matches_the_reference(apps, tmp_path, delete_missing):
    port, ref = apps
    dirs = {}
    for label in ("port", "ref"):
        d = tmp_path / f"watched_{label}" / "w"
        d.mkdir(parents=True)
        (d / "keep.txt").write_text("alpha watched keepword\n")
        (d / "change.txt").write_text("beta watched before\n")
        (d / "gone.txt").write_text("gamma watched goneword\n")
        (d / "skip.log").write_text("delta not included\n")
        dirs[label] = d
    kw = dict(include=["*.txt"], tags=["watched"], delete_missing=delete_missing)

    def norm(evs, label):
        return [(p.replace(str(dirs[label]), "<w>"), k) for p, k in _events(evs)]

    first = {lab: app.watch.run_once(dirs[lab], **kw)
             for lab, app in (("port", port), ("ref", ref))}
    assert norm(first["port"], "port") == norm(first["ref"], "ref")
    assert [k for _, k in norm(first["port"], "port")] == ["added"] * 3
    for d in dirs.values():
        (d / "new.txt").write_text("epsilon watched newword\n")
        (d / "change.txt").write_text("beta watched after changedword\n")
        os.utime(d / "change.txt", (1, 1))       # a fingerprint change for certain
        (d / "gone.txt").unlink()
    second = {lab: app.watch.run_once(dirs[lab], **kw)
              for lab, app in (("port", port), ("ref", ref))}
    assert norm(second["port"], "port") == norm(second["ref"], "ref") == \
        [("<w>/change.txt", "modified"), ("<w>/gone.txt", "removed"), ("<w>/new.txt", "added")]
    assert port.watch.run_once(dirs["port"], **kw) == []
    for word, present in (("newword", True), ("changedword", True),
                          ("goneword", not delete_missing)):
        got = port.search.search(word, limit=5, search_type="keyword")
        want = ref.search.search(word, limit=5, search_type="keyword")
        assert bool(got.hits) == present and len(got.hits) == len(want.hits), word
    got = port.search.search("watched", limit=10, search_type="keyword",
                             filters={"tags": ["watched"]})
    assert len(got.hits) == len(ref.search.search(
        "watched", limit=10, search_type="keyword", filters={"tags": ["watched"]}).hits)
