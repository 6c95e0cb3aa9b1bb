"""The port's MCP server against the reference's, on the CPU.

One seeded tree is added to both packages' AppContext (the CSR lexical
leg), and the same JSON-RPC messages go to each package's `MCPServer`:
`initialize` (the port names its own version), `tools/list`,
`resources/list` and `prompts/list` answer alike, and `tools/call` of
search, grep, list, get, cat, status, graph, the session tools,
list_collections and an unknown tool give the reference's answers (search
scores within 1e-4). Over stdio, `run_stdio_server` answers line-delimited
and Content-Length framed requests in order and survives garbage, and
`python -m yams_tpu_torch.mcp <dir> --device cpu` serves the same search
as the in-process app.
"""

import io
import json
import subprocess
import sys

import pytest

from test_torch_services import make_tree, populate, port_config_for, ref_config_for
from yams_tpu.mcp.server import MCPServer as RefServer
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.mcp.server import MCPServer, run_stdio_server
from yams_tpu_torch.services.app import AppContext


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tree = make_tree(tmp_path_factory.mktemp("tree"), n_notes=40)
    root = tmp_path_factory.mktemp("apps")
    port = AppContext(port_config_for(root / "port"), device="cpu")
    ref = RefApp(ref_config_for(root / "ref"))
    for app in (port, ref):
        populate(app, tree)
    yield MCPServer(port), RefServer(ref), port
    port.close()
    ref.close()


def _msg(method, params=None, i=1):
    return {"jsonrpc": "2.0", "id": i, "method": method, "params": params or {}}


def _strip(obj, key_drop=("duration_ms", "elapsed_ms", "latency_ms", "indexed_time",
                          "created_time", "modified_time", "uptime_s")):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in key_drop}
    if isinstance(obj, list):
        return [_strip(x) for x in obj]
    return obj


def _close(a, b, tol=1e-4):
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)):
        return abs(a - b) <= tol
    return a == b


@pytest.mark.parametrize("method", ["tools/list", "resources/list", "prompts/list", "ping"])
def test_listings_match_the_reference(servers, method):
    port, ref, _ = servers
    assert port.handle_message(_msg(method)) == ref.handle_message(_msg(method))


def test_initialize_names_the_ports_version(servers):
    port, ref, _ = servers
    got, want = port.handle_message(_msg("initialize")), ref.handle_message(_msg("initialize"))
    assert got["result"]["serverInfo"] == {"name": "yams-tpu", "version": "0.1.0"}
    got["result"].pop("serverInfo")
    want["result"].pop("serverInfo")
    assert got == want


CALLS = [
    ("search", {"query": "w3 w5 note", "limit": 8}),
    ("search", {"query": "raft consensus", "type": "keyword", "tags": ["ops"]}),
    ("grep", {"pattern": "w1[0-9] w2"}),
    ("grep", {"pattern": "raft", "ignore_case": True}),
    ("list", {"limit": 20}),
    ("get", {"name": "t1.txt"}),
    ("cat", {"name": "t2.txt"}),
    ("graph", {"action": "stats"}),
    ("session_pin", {"pattern": "*/d1/*", "session": "mcp"}),
    ("session_warm", {"session": "mcp"}),
    ("list_collections", {}),
    ("no_such_tool", {}),
]


def _text(resp):
    res = resp.get("result") or {}
    body = (res.get("content") or [{}])[0].get("text")
    try:
        return _strip(json.loads(body)), res.get("isError")
    except (TypeError, json.JSONDecodeError):
        return body, res.get("isError") if res else resp.get("error")


@pytest.mark.parametrize("tool,args", CALLS, ids=[f"{c[0]}{i}" for i, c in enumerate(CALLS)])
def test_tool_calls_match_the_reference(servers, tool, args):
    port, ref, _ = servers
    msg = _msg("tools/call", {"name": tool, "arguments": args})
    got, want = _text(port.handle_message(msg)), _text(ref.handle_message(msg))
    got = json.loads(json.dumps(got).replace('"/port/', '"/x/'))
    want = json.loads(json.dumps(want).replace('"/ref/', '"/x/'))
    assert _close(got, want), (got, want)
    if tool in ("search", "grep", "list"):
        assert got[0] and not got[1]


def test_stdio_framing_and_garbage(servers):
    _, _, app = servers
    lines = [json.dumps(_msg("initialize", i=1)), "not json at all",
             json.dumps(_msg("tools/call", {"name": "search",
                                            "arguments": {"query": "w3"}}, i=2))]
    body = json.dumps(_msg("tools/list", i=3))
    framed = f"Content-Length: {len(body)}\r\n\r\n{body}"
    out = io.StringIO()
    run_stdio_server(app, stdin=io.StringIO("\n".join(lines) + "\n" + framed + "\n"),
                     stdout=out)
    replies = [json.loads(x) for x in out.getvalue().splitlines() if x.strip()]
    ids = [r.get("id") for r in replies]
    assert [i for i in ids if i is not None] == [1, 2, 3]
    assert any(r.get("error", {}).get("code") == -32700 for r in replies)
    hits = json.loads(replies[ids.index(2)]["result"]["content"][0]["text"])["hits"]
    assert hits


def test_the_module_serves_over_stdio(tmp_path):
    tree = make_tree(tmp_path / "tree", n_notes=12)
    app = AppContext(port_config_for(tmp_path / "data"), device="cpu")
    try:
        populate(app, tree)
        want = [(h.document_id, round(h.score, 4))
                for h in app.search.search("w3 w5", limit=5).hits]
        app.checkpoint()
    finally:
        app.close()
    msgs = [_msg("initialize", i=1),
            _msg("tools/call", {"name": "search", "arguments": {"query": "w3 w5", "limit": 5}},
                 i=2)]
    proc = subprocess.run(
        [sys.executable, "-m", "yams_tpu_torch.mcp", str(tmp_path / "data"), "--device", "cpu"],
        input="\n".join(json.dumps(m) for m in msgs) + "\n", capture_output=True, text=True,
        timeout=240, env={**__import__("os").environ,
                          "XDG_CONFIG_HOME": str(_csr_config(tmp_path))})
    assert proc.returncode == 0, proc.stderr
    replies = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    hits = json.loads(replies[1]["result"]["content"][0]["text"])["hits"]
    assert [(h["document_id"], round(h["score"], 4)) for h in hits] == want and want


def _csr_config(tmp_path):
    """A config file with the test apps' widths (load_config reads it)."""
    d = tmp_path / "xdg"
    (d / "yams_tpu").mkdir(parents=True)
    (d / "yams_tpu" / "config.toml").write_text(
        "[embedding]\ndim = 64\nsketch_dim = 512\n[vector]\ndim = 64\ncapacity = 256\n"
        "block_rows = 128\n[lexical]\npostings_window = 64\npacked_max_entries = 0\n"
        "[chunking]\nmin_size = 1024\navg_size = 4096\nmax_size = 16384\n")
    return d
