"""The port's CLI (`python -m yams_tpu_torch.cli`) on the CPU.

- In-process with `--device cpu --no-daemon`, `add` of a seeded tree and
  `search`, `get`, `cat`, `list` and `delete` print what the reference's
  CLI prints for the same tree (the CSR lexical leg, set in the config
  file both read: same ids, scores within 1e-4).
- Every command whose service the port lacks exits 3 with "not ported:
  ROADMAP queue 1 item N".
- A daemon on the socket whose ping lacks "backend": "torch" (a daemon of
  the JAX package) is refused: exit 2 with a message, never served by.
- Against the port's daemon the CLI routes through the socket and prints
  the daemon's hits; `daemon start` spawns the port's daemon on the
  CLI's device.
"""

import json
import pathlib
import shutil
import socket
import tempfile
import threading

import pytest
import torch

from chip_smoke import ThreadDaemon
from test_torch_services import make_tree
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


NOT_PORTED = [("grep", ["grep", "x"], 3), ("session", ["session", "list"], 3),
              ("watch", ["watch", "."], 3), ("download", ["download", "file:///x"], 3),
              ("repair", ["repair"], 3), ("doctor", ["doctor"], 3),
              ("plugin", ["plugin", "list"], 3), ("restore", ["restore", "s", "t"], 3),
              ("dedupe", ["dedupe"], 3), ("auth", ["auth", "list-keys"], 3),
              ("serve", ["serve"], 3), ("model", ["model"], 5), ("tune", ["tune"], 3)]


@pytest.mark.parametrize("name,argv,item", NOT_PORTED, ids=[n[0] for n in NOT_PORTED])
def test_unported_commands_exit_with_their_roadmap_item(env, capsys, name, argv, item):
    rc, out, err = run(port_main, capsys, *port(env / "s", *argv))
    assert rc == 3 and not out
    assert f"yams {name}: not ported: ROADMAP queue 1 item {item}" in err
    assert not (env / "s").exists()              # nothing was opened


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
