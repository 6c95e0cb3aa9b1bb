"""MCP server over stdio (JSON-RPC 2.0).

Parity: src/mcp/ — MCPServer + StdioTransport + the tool registry
(mcp_server_tool_registry.cpp:148-810): search, grep, list, add, get, update,
delete_by_name, status, doctor, graph, session_pin/unpin/warm,
suggest_context, list_collections, list_snapshots, cat, stats, repair,
mcp.echo. JSON-RPC over line-delimited stdio (Content-Length framing also
accepted on input).

Copied from yams_tpu/mcp/server.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py), except that the `model_status` tool
lists the port's provider registry (the reference names its own package
there); its relative imports resolve to the port's own modules.
"""

from __future__ import annotations

import dataclasses as _dc


def _asdict(obj):
    """dataclass (incl. slots=True) -> plain dict for serialization."""
    if _dc.is_dataclass(obj):
        return _dc.asdict(obj)
    return dict(obj)

import json
import sys
from typing import Any, Callable

from .. import __version__

PROTOCOL_VERSION = "2024-11-05"


def _tool(name: str, description: str, properties: dict, required: list[str] | None = None):
    return {
        "name": name,
        "description": description,
        "inputSchema": {
            "type": "object",
            "properties": properties,
            "required": required or [],
        },
    }


class MCPServer:
    def __init__(self, app):
        self.app = app
        self._tools: dict[str, tuple[dict, Callable[[dict], Any]]] = {}
        self._register_tools()
        self.initialized = False

    # -- tool registry -----------------------------------------------------------
    def _register(self, spec: dict, fn: Callable[[dict], Any]) -> None:
        self._tools[spec["name"]] = (spec, fn)

    def _register_tools(self) -> None:
        S = {"type": "string"}
        I = {"type": "integer"}
        B = {"type": "boolean"}
        A = {"type": "array", "items": {"type": "string"}}

        self._register(
            _tool("search", "Hybrid (BM25 + vector + KG) search over indexed documents",
                  {"query": S, "limit": I, "type": S, "tags": A, "path": S}, ["query"]),
            self.t_search,
        )
        self._register(
            _tool("batch",
                  "Run several tool calls in one round trip (code-mode tier: "
                  "steps run in order; a step failure records an error and "
                  "continues). steps: [{tool, arguments}]",
                  {"steps": {"type": "array", "items": {"type": "object"}}},
                  ["steps"]),
            self.t_batch,
        )
        self._register(
            _tool("grep", "Regex/literal search over document contents",
                  {"pattern": S, "ignore_case": B, "path": S, "max_matches": I},
                  ["pattern"]),
            self.t_grep,
        )
        self._register(
            _tool("list", "List indexed documents",
                  {"limit": I, "offset": I, "pattern": S}),
            self.t_list,
        )
        self._register(
            _tool("add", "Add content (inline text or a local path) to the store",
                  {"path": S, "content": S, "name": S, "tags": A, "collection": S}),
            self.t_add,
        )
        self._register(
            _tool("get", "Get document info and content by hash/path/name",
                  {"selector": S, "include_content": B}, ["selector"]),
            self.t_get,
        )
        self._register(
            _tool("cat", "Return raw document text", {"selector": S}, ["selector"]),
            self.t_cat,
        )
        self._register(
            _tool("update", "Update tags/metadata on a document",
                  {"selector": S, "metadata": {"type": "object"},
                   "add_tags": A, "remove_tags": A}, ["selector"]),
            self.t_update,
        )
        self._register(
            _tool("delete_by_name", "Delete documents by name/path/hash",
                  {"selector": S}, ["selector"]),
            self.t_delete,
        )
        self._register(
            _tool("status", "System status snapshot", {"detailed": B}), self.t_status
        )
        self._register(
            _tool("doctor", "Run health checks", {}), self.t_doctor
        )
        self._register(
            _tool("repair", "Run repair operations", {"ops": A}), self.t_repair
        )
        self._register(
            _tool("graph", "Explore the knowledge graph around a term",
                  {"query": S, "limit": I}, ["query"]),
            self.t_graph,
        )
        self._register(
            _tool("graph_related", "Documents related via shared entities",
                  {"selector": S, "limit": I}, ["selector"]),
            self.t_graph_related,
        )
        self._register(
            _tool("graph_impact",
                  "Documents transitively affected by changes to a document",
                  {"selector": S, "hops": I, "limit": I}, ["selector"]),
            self.t_graph_impact,
        )
        self._register(
            _tool("graph_trace",
                  "Shortest entity path connecting two documents",
                  {"from": S, "to": S}, ["from", "to"]),
            self.t_graph_trace,
        )
        self._register(
            _tool("session_pin", "Pin a path pattern into the active session",
                  {"pattern": S, "session": S}, ["pattern"]),
            self.t_session_pin,
        )
        self._register(
            _tool("session_unpin", "Unpin a path pattern",
                  {"pattern": S, "session": S}, ["pattern"]),
            self.t_session_unpin,
        )
        self._register(
            _tool("session_warm", "Warm (hotzone-boost) the session's pinned docs",
                  {"session": S}),
            self.t_session_warm,
        )
        self._register(
            _tool("session_start", "Create and switch to a named session",
                  {"name": S}, ["name"]),
            self.t_session_start,
        )
        self._register(
            _tool("session_stop", "Deactivate the current session", {}),
            self.t_session_stop,
        )
        self._register(
            _tool("session_watch",
                  "One watch pass over a directory: ingest new/changed files",
                  {"directory": S, "include": S}, ["directory"]),
            self.t_session_watch,
        )
        self._register(
            _tool("suggest_context", "Assemble retrieval context for an LLM prompt",
                  {"query": S, "limit": I, "max_chars": I}, ["query"]),
            self.t_suggest_context,
        )
        self._register(
            _tool("feedback",
                  "Record relevance feedback for a document (rewards the "
                  "search tuner's bandit and the hotzone)",
                  {"hash": S, "doc_id": I, "relevant": B}, []),
            self.t_feedback,
        )
        self._register(
            _tool("list_collections", "List known collections", {}),
            self.t_list_collections,
        )
        self._register(
            _tool("list_snapshots", "List tree snapshots", {}), self.t_list_snapshots
        )
        self._register(
            _tool("download", "Download a URL (resumable) and store it",
                  {"url": S, "expected_sha256": S, "tags": A}, ["url"]),
            self.t_download,
        )
        self._register(
            _tool("symbol_lookup", "Find definition sites of a code symbol",
                  {"name": S, "limit": I}, ["name"]),
            lambda a: {"definitions": self.app.symbols.lookup(
                a["name"], limit=a.get("limit", 50))},
        )
        self._register(
            _tool("semantic_dedupe", "Find near-duplicate documents (MinHash)",
                  {"threshold": {"type": "number"}}),
            self.t_semantic_dedupe,
        )
        self._register(
            _tool("restore", "Restore a tree snapshot's files from the CAS",
                  {"snapshot_id": S, "target_dir": S, "overwrite": B},
                  ["snapshot_id", "target_dir"]),
            self.t_restore,
        )
        self._register(
            _tool("download_start",
                  "Start a background download job; returns a job id",
                  {"url": S, "expected_sha256": S}, ["url"]),
            lambda a: {"job_id": self.app.downloads.start_job(
                a["url"], expected_sha256=a.get("expected_sha256", ""))},
        )
        self._register(
            _tool("download_status", "Status of a download job",
                  {"job_id": S}, ["job_id"]),
            lambda a: self.app.downloads.job_status(a["job_id"]),
        )
        self._register(
            _tool("download_cancel", "Cancel a download job",
                  {"job_id": S}, ["job_id"]),
            lambda a: self.app.downloads.cancel_job(a["job_id"]),
        )
        self._register(
            _tool("download_list", "List download jobs", {}),
            lambda a: {"jobs": self.app.downloads.list_jobs()},
        )
        self._register(
            _tool("file_history",
                  "Appearances of a path across tree snapshots, newest first",
                  {"path": S, "limit": I}, ["path"]),
            self.t_file_history,
        )
        self._register(
            _tool("prune",
                  "Delete documents matching age/pattern/tag filters "
                  "(dry-run unless dry_run=false)",
                  {"older_than_s": I, "pattern": S, "tags": A, "dry_run": B}),
            self.t_prune,
        )
        self._register(
            _tool("tree_diff", "Diff two tree snapshots",
                  {"from_snapshot": S, "to_snapshot": S},
                  ["from_snapshot", "to_snapshot"]),
            self.t_tree_diff,
        )
        self._register(
            _tool("model_status", "Embedding models: default + registry", {}),
            lambda a: {
                "default": {"name": self.app.config.embedding.profile
                            if self.app.config.embedding.provider in ("", "simeon")
                            else self.app.config.embedding.provider,
                            "dim": self.app.search_engine.provider.dim,
                            "space_id": self.app.search_engine.provider.space_id},
                "registry": __import__(
                    "yams_tpu_torch.embed.provider", fromlist=["list_providers"]
                ).list_providers(),
            },
        )
        self._register(_tool("mcp.echo", "Echo (connectivity test)", {"text": S}),
                       lambda a: {"echo": a.get("text", "")})

    # -- tool impls --------------------------------------------------------------------
    def t_search(self, a):
        r = self.app.search.search(
            a["query"], limit=a.get("limit", 10),
            search_type=a.get("type", "hybrid"), tags=a.get("tags"),
            path_glob=a.get("path"),
        )
        return {
            "hits": [_asdict(h) for h in r.hits],
            "total": r.total, "duration_ms": round(r.duration_ms, 2),
        }

    def t_grep(self, a):
        r = self.app.grep.grep(
            a["pattern"], ignore_case=a.get("ignore_case", False),
            path_glob=a.get("path"), max_matches=a.get("max_matches", 200),
        )
        return {
            "matches": [
                {"path": m.path, "line": m.line_number, "text": m.line}
                for m in r.matches
            ],
            "files_matched": r.files_matched,
        }

    def t_list(self, a):
        docs = self.app.documents.list(
            limit=a.get("limit", 50), offset=a.get("offset", 0),
            pattern=a.get("pattern"),
        )
        return {"documents": [
            {"path": d.file_path, "hash": d.sha256_hash, "size": d.file_size,
             "mime": d.mime_type} for d in docs
        ]}

    def t_add(self, a):
        if a.get("content") is not None:
            res = self.app.documents.add_bytes(
                a["content"].encode(), a.get("name", "inline.txt"),
                tags=a.get("tags"), collection=a.get("collection", ""),
            )
            return _asdict(res)
        if a.get("path"):
            import pathlib

            p = pathlib.Path(a["path"])
            if p.is_dir():
                return _asdict(self.app.indexing.add_directory(
                    p, tags=a.get("tags"), collection=a.get("collection", "")
                ))
            return _asdict(self.app.documents.add_file(
                p, tags=a.get("tags"), collection=a.get("collection", "")
            ))
        raise ValueError("add requires 'content' or 'path'")

    def t_get(self, a):
        doc = self.app.documents.get(a["selector"])
        out = _asdict(doc)
        if a.get("include_content"):
            try:
                out["content"] = self.app.documents.get_text(a["selector"])
            except Exception:
                out["content"] = None
        return out

    def t_cat(self, a):
        return {"text": self.app.documents.get_text(a["selector"])}

    def t_update(self, a):
        doc = self.app.documents.update_metadata(
            a["selector"], metadata=a.get("metadata"),
            add_tags=a.get("add_tags"), remove_tags=a.get("remove_tags"),
        )
        return _asdict(doc)

    def t_delete(self, a):
        return {"deleted": self.app.documents.delete(a["selector"])}

    def t_status(self, a):
        return self.app.stats.snapshot(detailed=a.get("detailed", False))

    def t_doctor(self, a):
        from ..services.repair_service import RepairService

        return {k: {"ok": ok, "detail": d}
                for k, (ok, d) in RepairService(self.app).doctor().items()}

    def t_repair(self, a):
        from ..services.repair_service import RepairService

        return RepairService(self.app).run(a.get("ops"))

    def t_graph(self, a):
        return self.app.graph.explore(a["query"], limit=a.get("limit", 25))

    def t_batch(self, a):
        """MCP code-mode tier (reference: mcp_code_mode.cpp): N tool calls,
        one round trip. No control flow — sequencing only; errors are
        recorded per-step rather than aborting the batch."""
        out = []
        for step in a["steps"][:32]:
            name = step.get("tool", "")
            if name == "batch":
                out.append({"tool": name, "error": "nested batch not allowed"})
                continue
            entry = self._tools.get(name)
            if entry is None:
                out.append({"tool": name, "error": "unknown tool"})
                continue
            try:
                out.append({"tool": name,
                            "result": entry[1](step.get("arguments", {}))})
            except Exception as e:
                out.append({"tool": name, "error": str(e)})
        return {"steps": out}

    def t_graph_impact(self, a):
        return {"impact": self.app.graph.impact(
            a["selector"], hops=a.get("hops", 2), limit=a.get("limit", 25))}

    def t_graph_trace(self, a):
        return {"path": self.app.graph.trace(a["from"], a["to"])}

    def t_graph_related(self, a):
        return {"related": self.app.graph.related(a["selector"],
                                                  limit=a.get("limit", 20))}

    def t_session_start(self, a):
        self.app.sessions.use(a["name"])
        return {"session": a["name"], "active": True}

    def t_session_stop(self, a):
        prev = self.app.sessions.current
        self.app.sessions._current = None
        return {"stopped": prev}

    def t_session_watch(self, a):
        include = a["include"].split(",") if a.get("include") else None
        events = self.app.watch.run_once(a["directory"], include=include)
        return {"events": [_asdict(e) for e in events]}

    def t_session_pin(self, a):
        self.app.sessions.pin(a["pattern"], a.get("session"))
        return {"pinned": a["pattern"]}

    def t_session_unpin(self, a):
        self.app.sessions.unpin(a["pattern"], a.get("session"))
        return {"unpinned": a["pattern"]}

    def t_session_warm(self, a):
        return {"warmed": self.app.sessions.warm(a.get("session"))}

    def t_suggest_context(self, a):
        return {"context": self.app.search.suggest_context(
            a["query"], limit=a.get("limit", 5), max_chars=a.get("max_chars", 4000))}

    def t_feedback(self, a):
        doc_id = a.get("doc_id")
        if doc_id is None and a.get("hash"):
            row = self.app.db.execute(
                "SELECT id FROM documents WHERE sha256_hash=?",
                (a["hash"],)).fetchone()
            if row is None:
                raise ValueError(f"no document {a['hash']}")
            doc_id = int(row[0])
        if doc_id is None:
            raise ValueError("feedback needs doc_id or hash")
        self.app.search_engine.record_feedback(
            int(doc_id), relevant=bool(a.get("relevant", True)))
        return {"ok": True, "doc_id": int(doc_id)}

    def t_download(self, a):
        return _asdict(self.app.downloads.download(
            a["url"], expected_sha256=a.get("expected_sha256", ""),
            tags=a.get("tags"),
        ))

    def t_semantic_dedupe(self, a):
        return {"pairs": self.app.search.semantic_dedupe(a.get("threshold", 0.8))}

    def t_restore(self, a):
        return self.app.indexing.restore_snapshot(
            a["snapshot_id"], a["target_dir"], overwrite=a.get("overwrite", False)
        )

    def t_file_history(self, a):
        return self.app.documents.file_history(a["path"], a.get("limit", 50))

    def t_prune(self, a):
        return self.app.documents.prune(
            older_than_s=a.get("older_than_s"),
            pattern=a.get("pattern"),
            tags=a.get("tags"),
            dry_run=a.get("dry_run", True),
            report_limit=100,
        )

    def t_tree_diff(self, a):
        import dataclasses as _dc

        from ..metadata.tree import TreeDiffer

        old = self.app.trees.get_snapshot(a["from_snapshot"])
        new = self.app.trees.get_snapshot(a["to_snapshot"])
        return {"changes": [_dc.asdict(c)
                            for c in TreeDiffer.diff(old, new)]}

    def t_list_collections(self, a):
        rows = self.app.db.execute(
            "SELECT DISTINCT value FROM metadata WHERE key='collection'"
        ).fetchall()
        return {"collections": [r[0] for r in rows if r[0]]}

    def t_list_snapshots(self, a):
        return {"snapshots": self.app.trees.list_snapshots()}

    # -- JSON-RPC ------------------------------------------------------------------------
    def handle_message(self, msg: dict) -> dict | None:
        method = msg.get("method", "")
        msg_id = msg.get("id")
        params = msg.get("params") or {}

        def reply(result):
            return {"jsonrpc": "2.0", "id": msg_id, "result": result}

        def error(code, text):
            return {"jsonrpc": "2.0", "id": msg_id,
                    "error": {"code": code, "message": text}}

        if method == "initialize":
            self.initialized = True
            return reply({
                "protocolVersion": params.get("protocolVersion", PROTOCOL_VERSION),
                "capabilities": {
                    "tools": {"listChanged": False},
                    "resources": {"listChanged": False},
                    "prompts": {"listChanged": False},
                },
                "serverInfo": {"name": "yams-tpu", "version": __version__},
            })
        if method == "resources/list":
            # documents as yams:// resources (reference: MCP resources surface)
            docs = self.app.documents.list(limit=params.get("limit", 100))
            return reply({"resources": [
                {"uri": f"yams://{d.sha256_hash}", "name": d.file_path,
                 "mimeType": d.mime_type} for d in docs
            ]})
        if method == "resources/read":
            uri = (params.get("uri") or "").removeprefix("yams://")
            try:
                text = self.app.documents.get_text(uri)
                return reply({"contents": [
                    {"uri": params.get("uri"), "mimeType": "text/plain",
                     "text": text}
                ]})
            except Exception as e:
                return error(-32002, f"resource not readable: {e}")
        if method == "prompts/list":
            return reply({"prompts": [
                {"name": "summarize_results",
                 "description": "Summarize search results for a query",
                 "arguments": [{"name": "query", "required": True}]},
                {"name": "answer_from_memory",
                 "description": "Answer a question using retrieved context",
                 "arguments": [{"name": "question", "required": True}]},
            ]})
        if method == "prompts/get":
            name = params.get("name", "")
            args = params.get("arguments") or {}
            q = args.get("query") or args.get("question") or ""
            ctx = self.app.search.suggest_context(q, limit=5) if q else ""
            text = {
                "summarize_results":
                    f"Summarize what the memory store knows about: {q}\n\n{ctx}",
                "answer_from_memory":
                    f"Answer using ONLY this context.\n\n{ctx}\n\nQuestion: {q}",
            }.get(name)
            if text is None:
                return error(-32601, f"unknown prompt: {name}")
            return reply({"messages": [
                {"role": "user", "content": {"type": "text", "text": text}}
            ]})
        if method in ("notifications/initialized", "initialized"):
            return None
        if method == "ping":
            return reply({})
        if method == "tools/list":
            return reply({"tools": [spec for spec, _ in self._tools.values()]})
        if method == "tools/call":
            name = params.get("name", "")
            args = params.get("arguments") or {}
            entry = self._tools.get(name)
            if entry is None:
                return error(-32601, f"unknown tool: {name}")
            try:
                result = entry[1](args)
                return reply({
                    "content": [
                        {"type": "text",
                         "text": json.dumps(result, default=str, indent=1)}
                    ],
                    "isError": False,
                })
            except Exception as e:
                return reply({
                    "content": [{"type": "text", "text": f"{type(e).__name__}: {e}"}],
                    "isError": True,
                })
        if msg_id is None:
            return None  # unknown notification: ignore
        return error(-32601, f"unknown method: {method}")


def run_stdio_server(app, stdin=None, stdout=None) -> None:
    """Blocking stdio loop: newline-delimited JSON, Content-Length framed input
    also accepted (both appear in the wild for MCP stdio transports)."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    server = MCPServer(app)
    while True:
        line = stdin.readline()
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        if line.lower().startswith("content-length:"):
            try:
                length = int(line.split(":", 1)[1])
            except ValueError:
                continue  # garbled header: skip, stay alive
            if length < 0 or length > (64 << 20):
                continue
            while True:  # consume the rest of the headers
                h = stdin.readline()
                if not h.strip():
                    break
            body = stdin.read(length)
        else:
            body = line
        try:
            msg = json.loads(body)
        except json.JSONDecodeError:
            # JSON-RPC parse error; id unknowable for a garbled frame
            resp = {"jsonrpc": "2.0", "id": None,
                    "error": {"code": -32700, "message": "parse error"}}
            stdout.write(json.dumps(resp) + "\n")
            stdout.flush()
            continue
        try:
            resp = server.handle_message(msg)
        except Exception as e:  # a handler bug must not kill the transport
            resp = {"jsonrpc": "2.0",
                    "id": msg.get("id") if isinstance(msg, dict) else None,
                    "error": {"code": -32603,
                              "message": f"internal error: {e}"}}
        if resp is not None:
            stdout.write(json.dumps(resp, default=str) + "\n")
            stdout.flush()
