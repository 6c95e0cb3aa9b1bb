"""The port's CLI (`python -m yams_tpu_torch.cli`) on the CPU.

- In-process with `--device cpu --no-daemon`, `add` of a seeded tree and
  `search`, `get`, `cat`, `list` and `delete` print what the reference's
  CLI prints for the same tree (the CSR lexical leg, set in the config
  file both read: same ids, scores within 1e-4).
- grep, session, watch, download, plugin, auth and serve (which exited 3
  until their services were ported) print, beside the port's daemon, what
  the daemon answers; repair, doctor, restore, dedupe and tune print what
  the reference's CLI prints for the same tree, apart from the repair
  service's named departures.
- A daemon on the socket whose ping lacks "backend": "torch" (a daemon of
  the JAX package) is refused: exit 2 with a message, never served by.
- Against the port's daemon the CLI routes through the socket and prints
  the daemon's hits; `daemon start` spawns the port's daemon on the
  CLI's device.
"""

import hashlib
import json
import pathlib
import shutil
import socket
import tempfile
import threading

import pytest
import torch

from chip_smoke import ThreadDaemon
from test_torch_services import make_tree, reference_native, reference_native_build  # noqa: F401
from yams_tpu.cli.main import main as ref_main
from yams_tpu_torch.cli.main import main as port_main
from yams_tpu_torch.core.config import load_config
from yams_tpu_torch.daemon.protocol import read_frame, write_frame

_TIMES = ("created_time", "modified_time", "indexed_time", "duration_ms")


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """Both CLIs read one config file that selects the CSR lexical leg."""
    (tmp_path / "xdg" / "yams_tpu").mkdir(parents=True)
    (tmp_path / "xdg" / "yams_tpu" / "config.toml").write_text(
        "[lexical]\npacked_max_entries = 0\n")
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    monkeypatch.delenv("YAMS_TPU_STORAGE", raising=False)
    monkeypatch.delenv("YAMS_TPU_SOCKET", raising=False)
    return tmp_path


@pytest.fixture()
def short_dir():
    d = pathlib.Path(tempfile.mkdtemp(prefix="yc"))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def run(main, capsys, *argv):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def port(storage, *argv):
    return ("--storage", str(storage), "--device", "cpu", "--no-daemon", *argv)


def ref(storage, *argv):
    return ("--storage", str(storage), "--no-daemon", *argv)


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_strip(x) for x in obj]
    return obj


def test_in_process_commands_match_the_reference(env, capsys):
    tree = make_tree(env / "tree", n_notes=60)
    out = {}
    for name, main, argv in (("port", port_main, port), ("ref", ref_main, ref)):
        s = env / name
        rc, add, _ = run(main, capsys, "--json", *argv(s, "add", str(tree)))
        assert rc == 0
        rc, srch, _ = run(main, capsys, "--json", *argv(s, "search", "w3 w5 w11", "-n", "8"))
        assert rc == 0
        rc, kw, _ = run(main, capsys, "--json", *argv(s, "search", "note", "--type", "keyword",
                                                     "--path", "*/d2/*"))
        rc2, get, _ = run(main, capsys, "--json", *argv(s, "get", str(tree / "d1" / "note001.txt")))
        rc3, cat, _ = run(main, capsys, *argv(s, "cat", str(tree / "d1" / "note001.txt")))
        rc4, lst, _ = run(main, capsys, "--json", *argv(s, "list", "--limit", "500", "--sort", "name"))
        rc5, _, _ = run(main, capsys, *argv(s, "delete", str(tree / "d1" / "note001.txt")))
        rc6, after, _ = run(main, capsys, "--json", *argv(s, "list", "--limit", "500"))
        rc7, gone, err = run(main, capsys, *argv(s, "get", str(tree / "d1" / "note001.txt")))
        assert (rc, rc2, rc3, rc4, rc5, rc6) == (0,) * 6 and rc7 != 0 and err
        out[name] = dict(add=json.loads(add), search=json.loads(srch), kw=json.loads(kw),
                         get=json.loads(get), cat=cat, list=json.loads(lst),
                         after=json.loads(after))
    p, r = out["port"], out["ref"]
    assert p["add"] == r["add"] and p["add"]["files_added"] == 72
    for key in ("search", "kw"):
        assert [(h["document_id"], h["path"]) for h in p[key]] == \
            [(h["document_id"], h["path"]) for h in r[key]] and p[key]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(p[key], r[key])) <= 1e-4
    assert _strip(p["get"]) == _strip(r["get"])
    assert p["cat"] == r["cat"] and p["cat"] == (tree / "d1" / "note001.txt").read_text()
    assert _strip(p["list"]) == _strip(r["list"]) and len(p["list"]) == 72
    assert _strip(p["after"]) == _strip(r["after"]) and len(p["after"]) == 71


# the commands that exited 3 ("not ported: ROADMAP queue 1 item 3") until
# their services were ported
NOT_PORTED = [("grep", ["grep", "x"], 3), ("session", ["session", "list"], 3),
              ("watch", ["watch", "."], 3), ("download", ["download", "file:///x"], 3),
              ("plugin", ["plugin", "list"], 3), ("auth", ["auth", "list-keys"], 3),
              ("serve", ["serve"], 3)]


def _ported_argv(name, snapshot, target):
    return {"repair": ["repair"], "doctor": ["doctor"], "tune": ["tune"],
            "restore": ["restore", snapshot, str(target)],
            "dedupe": ["dedupe", "--threshold", "0.9"]}[name]


@pytest.mark.parametrize("name", ["repair", "doctor", "restore", "dedupe", "tune"])
def test_ported_commands_match_the_reference(env, capsys, name, reference_native):
    """The commands that exited 3 until the repair service was ported print
    what the reference's CLI prints for the same tree, apart from the
    departures the repair service names: the embeddings op does not re-queue the binary
    ('skipped') document, and doctor's device and native lines name the
    port's own. The reference's native library is built into a file of the
    test's own (`reference_native`), so its doctor line does not depend on
    which xdist worker won its loader's shared build."""
    tree = make_tree(env / "tree", n_notes=30)
    got = {}
    for label, main, argv in (("port", port_main, port), ("ref", ref_main, ref)):
        s = env / label
        rc, add, _ = run(main, capsys, "--json", *argv(s, "add", str(tree), "--snapshot"))
        assert rc == 0
        snap = json.loads(add)["snapshot_id"]
        rc, out, err = run(main, capsys, "--json",
                           *argv(s, *_ported_argv(name, snap, env / f"{label}_out")))
        got[label] = (rc, json.loads(out.replace(str(s), "<storage>")))
    (prc, p), (rrc, r) = got["port"], got["ref"]
    assert prc == rrc == 0
    if name == "repair":
        assert set(p) == set(r) and not any(v.startswith("failed") for v in p.values())
        assert p["downloads"].startswith("0 url-docs normalized, 0 orphan")
        assert p.pop("embeddings") == "0 documents embedded"
        assert r.pop("embeddings") == "0 documents embedded (1 re-queued from lost index)"
        assert p == r and "clusters over" in p["topology"]
    elif name == "doctor":
        assert p.pop("device") == [True, "cpu"] and r.pop("device")[0]
        assert p.pop("native_lib")[0] == r.pop("native_lib")[0]
        assert p == r
    elif name == "restore":
        assert {k: v for k, v in p.items() if k != "target"} == \
            {k: v for k, v in r.items() if k != "target"} and p["restored"] > 30
        for f in (env / "ref_out").rglob("*"):
            if f.is_file():
                twin = env / "port_out" / f.relative_to(env / "ref_out")
                assert twin.read_bytes() == f.read_bytes()
    elif name == "dedupe":
        assert [(x["a"], x["b"]) for x in p] == [(x["a"], x["b"]) for x in r] and p
        assert max(abs(x["similarity"] - y["similarity"]) for x, y in zip(p, r)) <= 1e-4
    else:
        assert p == r and p["engine_stats"] == {"searches": 0}


@pytest.mark.parametrize("name,argv,item", NOT_PORTED, ids=[n[0] for n in NOT_PORTED])
def test_unported_commands_exit_with_their_roadmap_item(env, capsys, short_dir, monkeypatch,
                                                        name, argv, item):
    """Each command that exited 3 naming ROADMAP queue 1 item 3 now runs
    beside the port's daemon and prints what the daemon answers for the
    same request: grep's matches; a session's pin, warm and list; a watch
    pass (indexed through the daemon); a download (stored through it); the
    daemon's plugins; auth's keys (a file store beside the data dir: the
    keys the CLI wrote are the ones listed, and a traversal name is
    refused); and `serve`, whose MCP search equals the daemon's search."""
    import io

    import numpy as np

    del argv, item
    cfg = load_config(data_dir=short_dir)
    d = ThreadDaemon(cfg, torch.device("cpu"), timeout=120)
    tree = make_tree(env / "tree", n_notes=20)

    def cli(*args):
        return run(port_main, capsys, "--storage", str(short_dir), "--device", "cpu", *args)

    try:
        d.client.add_path(str(tree))
        c = d.client
        if name == "grep":
            rc, out, _ = cli("--json", "grep", "w3", "-C", "1")
            want = c.grep("w3", ignore_case=False, literal=None, path_glob=None, tags=None,
                          max_matches=1000, context=1, word_boundary=False, filters=None,
                          semantic_limit=0)
            assert rc == 0 and json.loads(out)["matches"] == want["matches"] and want["matches"]
        elif name == "session":
            assert cli("session", "create", "s1")[:2] == (0, "created session s1\n")
            assert cli("session", "pin", "*/d1/*", "--name", "s1")[0] == 0
            rc, out, _ = cli("session", "warm", "--name", "s1")
            n = len(d.app.sessions.pinned_doc_ids("s1"))
            assert rc == 0 and out == f"warmed {n} documents\n" and n
            rc, out, _ = cli("--json", "session", "list")
            assert rc == 0 and json.loads(out) == c.call("session", op="list")["sessions"] == \
                ["s1"]
        elif name == "watch":
            w = env / "watched"
            w.mkdir()
            (w / "a.txt").write_text("watched zeta note")
            (w / "b.txt").write_text("watched eta note")
            before = d.app.metadata.document_count()
            rc, out, _ = cli("watch", str(w), "--once")
            assert rc == 0 and sorted(out.splitlines()[1:]) == \
                [f"added: {w.resolve() / 'a.txt'}", f"added: {w.resolve() / 'b.txt'}"]
            assert d.app.metadata.document_count() == before + 2
            assert c.call("watch", directory=str(w.resolve()))["events"] == []
        elif name == "download":
            blob = np.random.default_rng(2).bytes(50_000)
            (env / "blob.bin").write_bytes(blob)
            rc, out, _ = cli("--json", "download", (env / "blob.bin").as_uri())
            res = json.loads(out)
            assert rc == 0 and res["sha256"] == hashlib.sha256(blob).hexdigest()
            assert c.get(res["sha256"])["id"] == res["document_id"] > 0
            assert c.cat(res["sha256"]) == blob
        elif name == "plugin":
            ner = pathlib.Path(__file__).resolve().parents[1] / "yams_tpu_torch/plugins/neural_ner.py"
            assert cli("plugin", "trust", str(ner))[:2] == (0, f"trusted {ner}\n")
            assert cli("plugin", "load", str(ner))[:2] == (0, "loaded neural_ner v1.0\n")
            rc, out, _ = cli("--json", "plugin", "list")
            assert rc == 0 and json.loads(out) == c.call("plugins", op="list")["plugins"]
            assert [p["name"] for p in json.loads(out)] == ["neural_ner"]
        elif name == "auth":
            assert cli("auth", "keygen", "--type", "hmac", "--name", "k1")[0] == 0
            assert cli("auth", "keygen", "--type", "hmac", "--name", "../k2")[0] == 1
            rc, out, _ = cli("--json", "auth", "list-keys")
            assert rc == 0 and [k["key_id"] for k in json.loads(out)["keys"]] == ["k1"]
            assert sorted(p.name for p in (short_dir / "keys").iterdir()) == \
                ["k1.secret", "keys.json"]
        else:
            msgs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                    {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                     "params": {"name": "search", "arguments": {"query": "w3 w5", "limit": 5}}}]
            c.call("checkpoint")          # serve opens its own app on the data dir
            monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(map(json.dumps, msgs))))
            rc, out, _ = cli("serve")
            replies = [json.loads(x) for x in out.splitlines()]
            hits = json.loads(replies[1]["result"]["content"][0]["text"])["hits"]
            want = c.search("w3 w5", limit=5)["hits"]
            assert rc == 0 and [(h["document_id"], h["score"]) for h in hits] == \
                [(h["document_id"], h["score"]) for h in want] and want
    finally:
        d.stop()


def _fake_daemon(sock_path: pathlib.Path, stop: threading.Event):
    """A daemon of another backend: it answers every request with a pong
    that has no "backend"."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(str(sock_path))
    srv.listen(4)
    srv.settimeout(0.2)
    served = []

    def loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                continue
            conn.settimeout(5.0)
            try:
                while True:
                    req = read_frame(conn)
                    served.append(req["type"])
                    write_frame(conn, {"id": req.get("id"), "ok": True,
                                       "result": {"pong": True, "state": "ready"}})
            except Exception:       # noqa: BLE001  (the client hung up)
                conn.close()
        srv.close()

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return th, served


@pytest.mark.parametrize("argv", [["search", "raft"], ["status"], ["daemon", "status"]])
def test_a_daemon_of_another_backend_is_refused(env, capsys, short_dir, argv):
    stop = threading.Event()
    th, served = _fake_daemon(load_config(data_dir=short_dir).socket_path, stop)
    try:
        rc, out, err = run(port_main, capsys, "--storage", str(short_dir),
                           "--device", "cpu", *argv)
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert rc == 2 and "not the torch port's" in err and not out
    assert served == ["ping"]                   # asked who it is, nothing more


def test_the_cli_routes_through_the_ports_daemon(env, capsys, short_dir, monkeypatch):
    cfg = load_config(data_dir=short_dir)
    d = ThreadDaemon(cfg, torch.device("cpu"), timeout=120)
    try:
        tree = make_tree(env / "tree", n_notes=30)
        rc, out, _ = run(port_main, capsys, "--storage", str(short_dir), "--json",
                         "add", str(tree))
        assert rc == 0 and json.loads(out)["files_added"] == 42
        rc, out, _ = run(port_main, capsys, "--storage", str(short_dir), "--json",
                         "search", "w3 w5")
        want = d.client.search("w3 w5")["hits"]
        assert rc == 0 and [(h["document_id"], h["score"]) for h in json.loads(out)] == \
            [(h["document_id"], h["score"]) for h in want] and want
        rc, out, _ = run(port_main, capsys, "--storage", str(short_dir), "--json", "status")
        st = json.loads(out)
        assert rc == 0 and st["daemon"] == "running" and st["backend"] == "torch"
        assert d.app.metadata.document_count() == 42   # added through the daemon
        spawned = []
        from yams_tpu_torch.daemon import server
        monkeypatch.setattr(server, "spawn_daemon",
                            lambda c, device="cuda": spawned.append(device) or 1)
        rc, out, _ = run(port_main, capsys, "--storage", str(short_dir), "daemon", "start")
        assert rc == 0 and "already running" in out and not spawned
    finally:
        d.stop()
    rc, out, _ = run(port_main, capsys, "--storage", str(short_dir), "--device", "cpu",
                     "daemon", "start")
    assert rc == 0 and spawned == ["cpu"]
