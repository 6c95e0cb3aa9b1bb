"""yams CLI: the reference's command surface (src/cli/commands/, 29 commands)
rebuilt on the service layer.

Commands hit the daemon over its socket when one is running (DaemonClient,
like the reference's auto-connect), else run in-process against the data dir.

Port of yams_tpu/cli/main.py over the port's services and daemon
(`python -m yams_tpu_torch.cli`, or the `yams-torch` script). It departs
from the reference in these ways only:

- a global `--device` (default `$YAMS_TPU_DEVICE`, else `cuda`; `cpu` runs
  the port on the host): the in-process AppContext opens on it, and
  `daemon start` spawns the port's daemon with it. The variable is how a
  host that cannot pass flags picks the device: the mobile C ABI's embedded
  mode runs `daemon start` with none. There is no fallback: a daemon asked
  for `cuda` where torch sees no card raises;
- the CLI uses a daemon only when its ping says "backend": "torch". A
  daemon of the JAX package on the socket is an error (exit 2), never a
  silent server;
- `repair` and `doctor` go to a running daemon (as every mutation does),
  else run in-process; the reference's run in-process always, beside a
  daemon that holds the same data dir;
- `model list` beside a running daemon reads the `vector_models` table
  from the metadata database alone (read-only) instead of opening a
  second AppContext on the daemon's data dir; `model download` converts
  with the port's `yams_tpu_torch/scripts/convert_hf_encoder.py`;
- `session`, `watch`, `download` and `plugin` go to a running daemon (as
  every mutation does), else run in-process; the reference's run in-process
  always. A watch pass through the daemon is its `watch` request (the
  port's daemon adds it); `plugin` sends the daemon's `plugins` ops;
- `auth keygen` refuses a key name that is not a file name (cli/auth.py).
"""

from __future__ import annotations

import dataclasses as _dc


def _asdict(obj):
    """dataclass (incl. slots=True) -> plain dict for serialization."""
    if _dc.is_dataclass(obj):
        return _dc.asdict(obj)
    return dict(obj)

import argparse
import json
import os
import pathlib
import sys

from ..core.config import load_config
from ..core.errors import ErrorCode, YamsError



def _fmt_size(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


class Cli:
    """Lazily opens either a daemon client or an in-process AppContext."""

    def __init__(self, args):
        self.args = args
        self.config = load_config(data_dir=args.storage)
        self._app = None
        self._client = None

    @property
    def app(self):
        if self._app is None:
            from ..services.app import AppContext

            self._app = AppContext(self.config, device=self.args.device)
        return self._app

    def client_or_none(self):
        """Daemon client when a live daemon is reachable, else None."""
        if self.args.no_daemon:
            return None
        if self._client is None:
            from ..daemon.client import DaemonClient

            c = DaemonClient(self.config.socket_path)
            if torch_daemon(c, timeout=1.0):
                self._client = c
        return self._client

    def close(self):
        if self._app is not None:
            self._app.close()

    def out(self, obj, text_fn=None):
        if self.args.json:
            print(json.dumps(obj, indent=2, default=str))
        elif text_fn:
            text_fn(obj)
        else:
            print(obj)


def torch_daemon(client, timeout: float) -> bool:
    """Whether a daemon answers on the client's socket. One that is not the
    port's (its ping lacks "backend": "torch") is an error."""
    try:
        pong = client.call("ping", timeout=timeout)
    except YamsError:
        return False
    if pong.get("backend") != "torch":
        raise YamsError(
            f"the daemon on {client.socket_path} is not the torch port's "
            "(a yams_tpu daemon?): stop it, or pass --no-daemon",
            code=ErrorCode.UNAVAILABLE)
    return bool(pong.get("pong"))


# --- command implementations -------------------------------------------------

def cmd_init(cli: Cli):
    cli.config.data_dir.mkdir(parents=True, exist_ok=True)
    app = cli.app  # constructing runs migrations + creates layout
    cli.out(
        {"initialized": str(cli.config.data_dir)},
        lambda o: print(f"Initialized yams-tpu storage at {o['initialized']}"),
    )
    return 0


def cmd_add(cli: Cli):
    a = cli.args
    tags = a.tags.split(",") if a.tags else []
    meta = dict(kv.split("=", 1) for kv in (a.metadata or []))
    common = {}
    if a.mime_type:
        common["mime_type"] = a.mime_type
    if a.no_embeddings:
        common["auto_index"] = False
    # Mutations route through a running daemon (reference: every CLI command
    # is an IPC request) — a direct write would race the daemon's
    # single-writer engine and leave its in-memory indexes stale.
    client = cli.client_or_none()
    results = []
    for target in a.paths:
        p = pathlib.Path(target)
        if target == "-":
            data = sys.stdin.buffer.read()
            if client:
                res = client.add_bytes(
                    data, a.name or "stdin", tags=tags, metadata=meta,
                    collection=a.collection or "", **common,
                )
            else:
                res = cli.app.documents.add_bytes(
                    data, a.name or "stdin", tags=tags, metadata=meta,
                    collection=a.collection or "", **common,
                )
            results.append(res)
        elif p.is_dir():
            include = a.include.split(",") if a.include else None
            exclude = a.exclude.split(",") if a.exclude else None
            if client:
                rep = client.add_path(
                    str(p.resolve()), recursive=a.recursive, include=include,
                    exclude=exclude, tags=tags, collection=a.collection or "",
                    snapshot=a.snapshot or bool(a.snapshot_label),
                    snapshot_label=a.snapshot_label or "",
                )
            else:
                rep = cli.app.indexing.add_directory(
                    p, recursive=a.recursive, include=include, exclude=exclude,
                    tags=tags, collection=a.collection or "",
                    snapshot=a.snapshot or bool(a.snapshot_label),
                    snapshot_label=a.snapshot_label or "",
                )
            cli.out(
                _asdict(rep),
                lambda o: print(
                    f"added {o['files_added']} files "
                    f"({_fmt_size(o['bytes_stored'])} stored, "
                    f"{_fmt_size(o['bytes_deduped'])} deduped, "
                    f"{o['files_skipped']} skipped, {o['files_failed']} failed)"
                ),
            )
            continue
        elif p.is_file():
            if client:
                res = client.add_path(
                    str(p.resolve()), tags=tags, metadata=meta,
                    collection=a.collection or "", **common,
                )
            else:
                res = cli.app.documents.add_file(
                    p, tags=tags, metadata=meta,
                    collection=a.collection or "", **common,
                )
            results.append(res)
        else:
            print(f"error: no such file: {target}", file=sys.stderr)
            return 1
    for res in results:
        o = _asdict(res)
        if a.verify:
            # read back the stored bytes and re-hash (reference add --verify)
            import hashlib

            data = (client.cat(o["content_hash"]) if client
                    else cli.app.documents.cat(o["content_hash"]))
            ok = hashlib.sha256(data).hexdigest() == o["content_hash"]
            o["verified"] = ok
            if not ok:
                print(f"VERIFY FAILED: {o['content_hash']}", file=sys.stderr)
                return 1
        cli.out(
            o,
            lambda o: print(f"{o['content_hash'][:16]}  {_fmt_size(o['bytes_stored'])} stored"
                            f"  doc={o['document_id']}"
                            + ("  verified" if a.verify else "")),
        )
    return 0


def cmd_get(cli: Cli):
    a = cli.args
    client = cli.client_or_none()
    selector = a.selector
    if a.name or a.latest or a.oldest:
        # strict name resolution with version ordering (reference get
        # --name/--latest/--oldest; names may repeat across directories)
        if client:
            docs = client.list(limit=1 << 20, pattern="*" + selector)
            docs = [d for d in docs
                    if d["file_path"].rsplit("/", 1)[-1] == selector]
            docs.sort(key=lambda d: d["indexed_time"])
        else:
            found = cli.app.metadata.find_by_name(selector)
            docs = sorted((_asdict(d) for d in found),
                          key=lambda d: d["indexed_time"])
        if not docs:
            print(f"error: no document named {selector}", file=sys.stderr)
            return 1
        doc = docs[0] if a.oldest else docs[-1]
        selector = doc["file_path"]
    doc = (client.get(selector) if client
           else _asdict(cli.app.documents.get(selector)))
    if a.graph:
        related = (client.call("graph_related", selector=selector,
                               limit=10 * max(a.depth, 1))["related"]
                   if client else
                   cli.app.graph.related(selector,
                                         limit=10 * max(a.depth, 1)))
        doc = dict(doc)
        doc["related"] = related

    def text(o):
        print(
            f"path: {o['file_path']}\nhash: {o['sha256_hash']}\n"
            f"size: {_fmt_size(o['file_size'])}\nmime: {o['mime_type']}\n"
            f"tags: {', '.join(o['tags'])}"
        )
        for r in o.get("related", []):
            print(f"related: {r.get('path', r)}")
    cli.out(doc, text)
    return 0


def cmd_cat(cli: Cli):
    client = cli.client_or_none()
    data = (client.cat(cli.args.selector) if client
            else cli.app.documents.cat(cli.args.selector))
    if hasattr(sys.stdout, "buffer"):
        sys.stdout.buffer.write(data)
    else:  # redirected stdout (tests)
        sys.stdout.write(data.decode("utf-8", errors="replace"))
    return 0


def cmd_list(cli: Cli):
    a = cli.args
    f: dict = {}
    if a.match_all_tags:
        f["match_all_tags"] = True
    if a.file_type:
        f["file_types"] = a.file_type
    if a.text_only:
        f["text_only"] = True
    if a.binary_only:
        f["binary_only"] = True
    for when in ("created", "modified", "indexed"):
        for side in ("after", "before"):
            v = getattr(a, f"{when}_{side}")
            if v is not None:
                f[f"{when}_{side}"] = _parse_time_spec(v)
    kw = dict(
        limit=a.limit, offset=a.offset, pattern=a.pattern,
        tags=a.tags.split(",") if a.tags else None,
        collection=a.collection, filters=f or None,
        sort=a.sort, reverse=a.reverse, with_tags=a.show_tags,
    )
    if a.recent:
        kw.update(limit=a.recent, sort="indexed", reverse=True)
    client = cli.client_or_none()
    if client:
        docs = client.list(**kw)
    else:
        docs = [_asdict(d) for d in cli.app.documents.list(**kw)]

    def text(rows):
        for d in rows:
            tagcol = ""
            if a.show_tags and d.get("tags"):
                tagcol = "  [" + ",".join(d["tags"]) + "]"
            print(f"{d['sha256_hash'][:12]}  {_fmt_size(d['file_size']):>9}  "
                  f"{d['file_path']}{tagcol}")
    if a.paths_only and not cli.args.json:
        for d in docs:
            print(d["file_path"])
    else:
        cli.out([_asdict(d) for d in docs], text)
    return 0


def cmd_delete(cli: Cli):
    a = cli.args
    client = cli.client_or_none()
    targets = list(a.selectors)
    if a.pattern or a.directory:
        pattern = a.pattern or (a.directory.rstrip("/") + "/*")
        if client:
            docs = client.list(limit=1 << 20, pattern=pattern)
        else:
            docs = [_asdict(d) for d in
                    cli.app.documents.list(limit=1 << 20, pattern=pattern)]
        targets += [d["file_path"] for d in docs]
    if not targets:
        print("nothing to delete", file=sys.stderr)
        return 1
    if a.dry_run:
        for t in targets:
            print(f"would delete: {t}")
        return 0
    if client:
        ok = all(client.delete(s) for s in targets)
    elif a.keep_content:
        ok = all(cli.app.documents.delete(s, keep_content=True)
                 for s in targets)
    else:
        ok = all(cli.app.documents.delete(s) for s in targets)
    if not ok:
        print("some documents not found", file=sys.stderr)
    return 0 if ok else 1


def cmd_update(cli: Cli):
    a = cli.args
    meta = dict(kv.split("=", 1) for kv in (a.metadata or []))
    add_tags = a.add_tags.split(",") if a.add_tags else None
    remove_tags = a.remove_tags.split(",") if a.remove_tags else None
    client = cli.client_or_none()
    if client:
        doc = client.call("update", selector=a.selector, metadata=meta,
                          add_tags=add_tags, remove_tags=remove_tags)
    else:
        doc = cli.app.documents.update_metadata(
            a.selector, metadata=meta, add_tags=add_tags,
            remove_tags=remove_tags,
        )
    cli.out(_asdict(doc), lambda o: print(f"updated {o['file_path']}"))
    return 0


def _parse_time_spec(spec: str) -> float:
    """ISO date/datetime, unix seconds, or relative age ("7d", "12h", "30m")."""
    import datetime
    import re
    import time as _t

    spec = spec.strip()
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smhdw])", spec)
    if m:
        mult = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}[m.group(2)]
        return _t.time() - float(m.group(1)) * mult
    try:
        return float(spec)
    except ValueError:
        pass
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime.datetime.strptime(spec, fmt).timestamp()
        except ValueError:
            continue
    raise SystemExit(f"error: cannot parse time spec: {spec!r}")


def _search_filters(a) -> dict | None:
    f: dict = {}
    if a.match_all_tags:
        f["match_all_tags"] = True
    if a.file_type:
        f["file_types"] = a.file_type
    if a.text_only:
        f["text_only"] = True
    if a.binary_only:
        f["binary_only"] = True
    if a.session:
        f["session"] = a.session
    if a.similarity is not None:
        f["min_score"] = a.similarity
    for when in ("created", "modified", "indexed"):
        for side in ("after", "before"):
            v = getattr(a, f"{when}_{side}")
            if v is not None:
                f[f"{when}_{side}"] = _parse_time_spec(v)
    return f or None


def cmd_search(cli: Cli):
    a = cli.args
    if a.hash_prefix:
        # --hash: direct content-address lookup, no ranking
        return cmd_get_by_hash(cli, a.hash_prefix)
    query = a.query
    if a.stdin:
        query = sys.stdin.read().strip()
    elif a.query_file:
        query = pathlib.Path(a.query_file).read_text().strip()
    if not query:
        print("error: no query (pass QUERY, --stdin, --query-file, or --hash)",
              file=sys.stderr)
        return 1
    filters = _search_filters(a)
    client = cli.client_or_none()
    if client:
        resp = client.search(
            query, limit=a.limit, search_type=a.type,
            tags=a.tags.split(",") if a.tags else None, path_glob=a.path,
            collection=a.collection, filters=filters,
        )
        hits = resp["hits"]
    else:
        r = cli.app.search.search(
            query, limit=a.limit, search_type=a.type,
            tags=a.tags.split(",") if a.tags else None, path_glob=a.path,
            collection=a.collection, filters=filters,
        )
        hits = [_asdict(h) for h in r.hits]

    def text(rows):
        if not rows:
            print("no results")
            return
        for i, h in enumerate(rows, 1):
            tag = f"{h['hash'][:12]}  " if a.show_hash and h.get("hash") else ""
            print(f"{i:2}. [{h['score']:.3f}] {tag}{h['path']}")
            if h.get("snippet") and not a.paths_only:
                print(f"      {h['snippet']}")
    if a.paths_only and not cli.args.json:
        for h in hits:
            print(h["path"])
    else:
        cli.out(hits, text)
    return 0


def cmd_grep(cli: Cli):
    a = cli.args
    f: dict = {}
    if a.match_all_tags:
        f["match_all_tags"] = True
    if a.session:
        f["session"] = a.session
    globs = list(a.include or [])
    if a.path:
        globs.append(a.path)
    kw = dict(
        ignore_case=a.ignore_case,
        literal=True if a.fixed_strings else None,
        path_glob=(globs[0] if len(globs) == 1 else globs) or None,
        tags=a.tags.split(",") if a.tags else None,
        max_matches=a.max_count, context=a.context,
        word_boundary=a.word_regexp, filters=f or None,
        semantic_limit=a.semantic_limit,
    )
    client = cli.client_or_none()
    if client:
        resp = client.grep(a.pattern, **kw)
    else:
        r = cli.app.grep.grep(a.pattern, **kw)
        resp = {"matches": [_asdict(m) for m in r.matches],
                "files_searched": r.files_searched,
                "files_matched": r.files_matched, "truncated": r.truncated}
    matches = resp["matches"]
    if a.files_with_matches and not cli.args.json:
        for p in dict.fromkeys(m["path"] for m in matches):
            print(p)
        return 0 if matches else 1
    if a.count and not cli.args.json:
        counts: dict[str, int] = {}
        for m in matches:
            if not m.get("semantic"):
                counts[m["path"]] = counts.get(m["path"], 0) + 1
        for p, n in counts.items():
            print(f"{p}:{n}")
        return 0 if matches else 1

    def text(o):
        for m in matches:
            prefix = "" if a.no_filename else f"{m['path']}:"
            if m.get("semantic"):
                print(f"{prefix}(semantic) {m['line']}")
                continue
            before, after = m.get("before", []), m.get("after", [])
            for i, b in enumerate(before):
                print(f"{prefix}{m['line_number'] - len(before) + i}-{b}")
            print(f"{prefix}{m['line_number']}:{m['line']}")
            for i, aft in enumerate(after):
                print(f"{prefix}{m['line_number'] + 1 + i}-{aft}")
        if resp.get("truncated"):
            print("... (truncated)", file=sys.stderr)
    cli.out(
        {"matches": matches, "files_searched": resp["files_searched"],
         "files_matched": resp["files_matched"]},
        text,
    )
    return 0 if matches else 1


def cmd_get_by_hash(cli: Cli, prefix: str):
    client = cli.client_or_none()
    doc = (client.get(prefix) if client
           else cli.app.documents.get(prefix))
    doc = _asdict(doc)
    cli.out(doc, lambda o: print(
        f"{o['sha256_hash'][:12]}  {_fmt_size(o['file_size'])}  "
        f"{o['file_path']}"))
    return 0


def cmd_status(cli: Cli):
    client = cli.client_or_none()
    if client:
        snap = client.status(detailed=cli.args.detailed)
        snap["daemon"] = "running"
    else:
        snap = cli.app.stats.snapshot(detailed=cli.args.detailed)
        snap["daemon"] = "not running (in-process)"
    def text(o):
        print(f"yams-tpu {o['version']}  [{o['daemon']}]")
        print(f"data dir:   {o['data_dir']}")
        d = o["documents"]
        print(f"documents:  {d['documents']} ({d['extracted']} extracted, "
              f"{d['pending_embeddings']} pending embed)")
        s = o["storage"]
        print(f"storage:    {s.get('unique_blocks', 0)} blocks, "
              f"{_fmt_size(s.get('unique_bytes', 0))} unique")
        g = o["graph"]
        print(f"graph:      {g['nodes']} nodes, {g['edges']} edges")
        if "devices" in o:
            print(f"devices:    {', '.join(o['devices'])}")
    cli.out(snap, text)
    return 0


def cmd_stats(cli: Cli):
    cli.args.detailed = True
    return cmd_status(cli)


def cmd_graph(cli: Cli):
    a = cli.args
    if a.graph_cmd == "explore":
        out = cli.app.graph.explore(a.query, limit=a.limit)
        def text(o):
            for n in o["nodes"]:
                print(f"node: {n['label']} ({n['type']})")
                for nb in n["neighbors"][:10]:
                    print(f"  -[{nb['relation']} {nb['weight']:.2f}]-> {nb['label']}")
                for d in n["documents"][:5]:
                    print(f"  doc: {d['path']} ({d['confidence']:.2f})")
        cli.out(out, text)
    elif a.graph_cmd == "related":
        out = cli.app.graph.related(a.query, limit=a.limit)
        cli.out(out, lambda o: [print(f"{r['support']:.2f}  {r['path']}") for r in o])
    elif a.graph_cmd == "symbol":
        out = cli.app.symbols.lookup(a.query, limit=a.limit)
        cli.out(out, lambda o: [
            print(f"{r['path']}:{r['line']}  {r['kind']} {r['name']}") for r in o
        ])
    elif a.graph_cmd == "impact":
        out = cli.app.graph.impact(a.query, hops=a.hops, limit=a.limit)
        cli.out(out, lambda o: [print(f"{r['impact']:.3f}  {r['path']}") for r in o])
    elif a.graph_cmd == "trace":
        out = cli.app.graph.trace(a.query, a.to)
        cli.out({"path": out}, lambda o: print(
            " -> ".join(o["path"]) if o["path"] else "no connection"))
    elif a.graph_cmd == "build":
        n = cli.app.graph.index_pending()
        cli.out({"indexed": n}, lambda o: print(f"indexed {o['indexed']} documents"))
    else:
        cli.out(cli.app.graph.stats())
    return 0


def cmd_tree(cli: Cli):
    prefix = cli.args.prefix or ""
    rows = cli.app.metadata.path_tree_children(prefix)
    def text(o):
        for path, count in o:
            print(f"{count:>6}  {path}")
    cli.out(rows, text)
    return 0


def cmd_diff(cli: Cli):
    from ..metadata.tree import TreeDiffer

    a = cli.args
    old = cli.app.trees.get_snapshot(a.snapshot_a)
    new = cli.app.trees.get_snapshot(a.snapshot_b)
    changes = TreeDiffer.diff(old, new)
    def text(o):
        sym = {"added": "+", "deleted": "-", "modified": "~", "renamed": ">"}
        for c in changes:
            if c.type == "renamed":
                print(f"> {c.old_path} -> {c.path}")
            else:
                print(f"{sym[c.type]} {c.path}")
    cli.out([_asdict(c) for c in changes], text)
    return 0


def cmd_snapshots(cli: Cli):
    rows = cli.app.trees.list_snapshots()
    cli.out(rows, lambda o: [print(f"{r['id']}  {r['label']}") for r in o])
    return 0


def cmd_session(cli: Cli):
    a = cli.args
    client = cli.client_or_none()

    def call(op, **kw):
        if client:
            return client.call("session", op=op, **kw)
        s = cli.app.sessions
        if op == "list":
            return {"sessions": s.list()}
        if op == "warm":
            return {"warmed": s.warm(kw.get("name"))}
        fn = {"create": s.create, "delete": s.delete}.get(op)
        if fn:
            fn(kw["name"])
        else:
            getattr(s, op)(kw["pattern"], kw.get("name"))
        return {"ok": True}

    if a.session_cmd == "list":
        cli.out(call("list")["sessions"], lambda o: [print(x) for x in o])
    elif a.session_cmd == "create":
        call("create", name=a.name)
        print(f"created session {a.name}")
    elif a.session_cmd == "pin":
        call("pin", pattern=a.pattern, name=a.name)
        print(f"pinned {a.pattern}")
    elif a.session_cmd == "unpin":
        call("unpin", pattern=a.pattern, name=a.name)
    elif a.session_cmd == "warm":
        n = call("warm", name=a.name)["warmed"]
        print(f"warmed {n} documents")
    elif a.session_cmd == "delete":
        call("delete", name=a.name)
    return 0


def cmd_config(cli: Cli):
    import dataclasses

    def to_dict(o):
        if dataclasses.is_dataclass(o):
            return {f.name: to_dict(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, pathlib.Path):
            return str(o)
        if isinstance(o, tuple):
            return list(o)
        return o
    print(json.dumps(to_dict(cli.config), indent=2))
    return 0


def cmd_repair(cli: Cli):
    ops = cli.args.ops.split(",") if cli.args.ops else None
    client = cli.client_or_none()
    if client:
        report = client.repair(ops)
    else:
        from ..services.repair_service import RepairService

        report = RepairService(cli.app).run(ops)
    cli.out(report, lambda o: [print(f"{k}: {v}") for k, v in o.items()])
    return 0


def cmd_doctor(cli: Cli):
    client = cli.client_or_none()
    if client:
        report = client.doctor()
    else:
        from ..services.repair_service import RepairService

        report = {k: list(v) for k, v in RepairService(cli.app).doctor().items()}
    def text(o):
        for check, (ok, detail) in o.items():
            mark = "ok " if ok else "FAIL"
            print(f"[{mark}] {check}: {detail}")
    cli.out(report, text)
    return 0 if all(ok for ok, _ in report.values()) else 1


def cmd_restore(cli: Cli):
    out = cli.app.indexing.restore_snapshot(
        cli.args.snapshot_id, cli.args.target, overwrite=cli.args.overwrite
    )
    cli.out(out, lambda o: print(
        f"restored {o['restored']} files to {o['target']} "
        f"({o['skipped']} skipped, {o['failed']} failed)"))
    return 0


def cmd_dedupe(cli: Cli):
    pairs = cli.app.search.semantic_dedupe(threshold=cli.args.threshold)
    cli.out(pairs, lambda o: [
        print(f"{p['similarity']:.2f}  {p['a']}  <->  {p['b']}") for p in o
    ])
    return 0


def cmd_tune(cli: Cli):
    """Runtime tuning: show the active TuneAdvisor profile + search-tuner
    arm stats (reference: `yams tune` + TuningManager)."""
    from ..daemon.components import TuneAdvisor

    adv = TuneAdvisor()
    out = {"profile": adv.profile,
           "knobs": {k: adv.get(k) for k in adv.PROFILES[adv.profile]}}
    eng = cli.app.search_engine
    if eng.tuner is not None:
        out["search_tuner"] = eng.tuner.snapshot()
    out["engine_stats"] = {
        k: v for k, v in eng.stats().items()
        if k in ("searches", "avg_latency_ms", "topology_persistence")
    }

    def text(o):
        print(f"profile: {o['profile']}")
        for k, v in o["knobs"].items():
            print(f"  {k}: {v}")
        if "search_tuner" in o:
            print(f"tuner: {o['search_tuner']}")

    cli.out(out, text)
    return 0


def cmd_plugin(cli: Cli):
    a = cli.args
    client = cli.client_or_none()
    if client:       # the daemon loaded its trusted plugins at start
        listed = client.call("plugins", op=a.plugin_cmd,
                             path=getattr(a, "path", None))["plugins"]
        m = [x for x in listed if "error" not in x][-1] if a.plugin_cmd == "load" else None
    else:
        from ..plugins.manager import PluginManager

        pm = PluginManager(cli.app, trust_file=cli.config.data_dir / "plugins_trust.txt")
        if a.plugin_cmd == "list":
            pm.load_trusted()
        elif a.plugin_cmd == "trust":
            pm.trust(a.path)
        else:
            man = pm.load_file(a.path)
            if man is None:
                print(f"failed: {pm.errors}", file=sys.stderr)
                return 1
            m = {"name": man.name, "version": man.version}
        listed = pm.list()
    if a.plugin_cmd == "list":
        cli.out(listed, lambda o: [print(f"{x.get('name')}  {x.get('version','')}  "
                                         f"{','.join(x.get('interfaces', []))}"
                                         + (f"  ERROR: {x['error']}" if 'error' in x else ''))
                                   for x in o])
    elif a.plugin_cmd == "trust":
        print(f"trusted {a.path}")
    else:
        print(f"loaded {m['name']} v{m['version']}")
    return 0


def cmd_watch(cli: Cli):
    import time as _time

    client = cli.client_or_none()
    kw = dict(include=cli.args.include.split(",") if cli.args.include else None,
              tags=cli.args.tags.split(",") if cli.args.tags else None,
              delete_missing=cli.args.delete_missing)
    directory = str(pathlib.Path(cli.args.directory).resolve()) if client \
        else cli.args.directory
    print(f"watching {cli.args.directory} (interval {cli.args.interval}s, ^C to stop)")
    try:
        while True:
            if client:
                events = client.call("watch", directory=directory, **kw)["events"]
            else:
                events = [_asdict(ev) for ev in cli.app.watch.run_once(directory, **kw)]
            for ev in events:
                print(f"{ev['kind']}: {ev['path']}")
            if cli.args.once:
                break
            _time.sleep(cli.args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_download(cli: Cli):
    kw = dict(expected_sha256=cli.args.sha256 or "", store=not cli.args.no_store,
              tags=cli.args.tags.split(",") if cli.args.tags else None)
    client = cli.client_or_none()
    if client:
        res = client.call("download", url=cli.args.url, **kw)
    else:
        res = _asdict(cli.app.downloads.download(cli.args.url, **kw))
    cli.out(res, lambda o: print(
        f"downloaded {o['url']} -> {o['sha256'][:16]} "
        f"({o['bytes_downloaded']} bytes, doc={o['document_id']})"))
    return 0


def cmd_model(cli: Cli):
    op = getattr(cli.args, "model_cmd", "list")
    if op == "download":
        # HF hub id (needs egress) or local checkpoint dir -> converted npz
        from ..scripts import convert_hf_encoder

        out_dir = cli.config.data_dir / "models"
        out_dir.mkdir(parents=True, exist_ok=True)
        out = cli.args.out or str(
            out_dir / (cli.args.model_id.replace("/", "--") + ".npz"))
        try:
            convert_hf_encoder.convert(cli.args.model_id, out)
        except Exception as e:
            print(f"model download failed: {e}\n"
                  f"(hub ids need network egress; air-gapped hosts can pass "
                  f"a local checkpoint directory instead)", file=sys.stderr)
            return 1
        print(f"converted -> {out}\nUse it with:\n"
              f"  [embedding] provider = \"hf\" checkpoint = \"{out}\"  "
              f"(config.toml)\n  or YAMS_TPU_EMBEDDING_PROVIDER=hf "
              f"YAMS_TPU_EMBEDDING_CHECKPOINT={out}")
        return 0
    query = "SELECT * FROM vector_models"
    if cli.client_or_none() is not None:
        import sqlite3

        conn = sqlite3.connect(f"file:{cli.config.metadata_db}?mode=ro", uri=True)
        conn.row_factory = sqlite3.Row
        try:
            rows = conn.execute(query).fetchall()
        finally:
            conn.close()
    else:
        rows = cli.app.db.execute(query).fetchall()
    out = [
        {"model_id": r["model_id"], "dim": r["dim"], "space_id": r["space_id"]}
        for r in rows
    ]
    cli.out(out, lambda o: [print(f"{m['model_id']}  dim={m['dim']}  {m['space_id']}") for m in o])
    return 0


def cmd_daemon(cli: Cli):
    from ..daemon.client import DaemonClient
    from ..daemon.server import run_daemon, spawn_daemon

    a = cli.args
    if a.daemon_cmd == "start":
        if torch_daemon(DaemonClient(cli.config.socket_path), timeout=0.5):
            print("daemon already running")
            return 0
        if a.foreground:
            run_daemon(cli.config, device=cli.args.device)
        else:
            pid = spawn_daemon(cli.config, device=cli.args.device)
            print(f"daemon started (pid {pid})")
        return 0
    client = DaemonClient(cli.config.socket_path)
    if a.daemon_cmd == "stop":
        if torch_daemon(client, timeout=0.5):
            client.shutdown()
            print("daemon stopped")
        else:
            print("daemon not running")
        return 0
    if a.daemon_cmd == "status":
        if torch_daemon(client, timeout=0.5):
            print(json.dumps(client.status(), indent=2))
            return 0
        print("daemon not running")
        return 1
    if a.daemon_cmd == "restart":
        if torch_daemon(client, timeout=0.5):
            client.shutdown()
        pid = spawn_daemon(cli.config, device=cli.args.device)
        print(f"daemon started (pid {pid})")
        return 0
    return 1


def cmd_serve(cli: Cli):
    from ..mcp.server import run_stdio_server

    run_stdio_server(cli.app)
    return 0


def cmd_completion(cli: Cli):
    shell = cli.args.shell
    cmds = "add get cat list delete update search grep status stats graph session tree diff snapshots repair doctor auth config model daemon serve init completion"
    if shell == "bash":
        print(f'complete -W "{cmds}" yams')
    elif shell == "zsh":
        print(f'compdef _gnu_generic yams\n# commands: {cmds}')
    else:
        print(f"# supported: bash, zsh\n# commands: {cmds}")
    return 0


# --- parser ---------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yams-torch",
        description="yams-tpu on PyTorch/CUDA: content-addressed memory + hybrid search",
    )
    p.add_argument("--storage", help="data directory (default: $YAMS_TPU_STORAGE)")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--no-daemon", action="store_true",
                   help="never route through a running daemon")
    p.add_argument("--device", default=os.environ.get("YAMS_TPU_DEVICE", "cuda"),
                   help="torch device of the in-process app and of a spawned "
                        "daemon: cuda, cuda:N or cpu (default: $YAMS_TPU_DEVICE, "
                        "else cuda)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("init", help="initialize storage").set_defaults(fn=cmd_init)

    sp = sub.add_parser("add", help="add files or directories")
    sp.add_argument("paths", nargs="+", help="files, directories, or - for stdin")
    sp.add_argument("-r", "--recursive", action="store_true", default=True)
    sp.add_argument("--name", help="name for stdin content")
    sp.add_argument("--tags", help="comma-separated tags")
    sp.add_argument("--metadata", action="append", help="key=value (repeatable)")
    sp.add_argument("--collection", help="collection name")
    sp.add_argument("--include", help="comma-separated include globs")
    sp.add_argument("--exclude", help="comma-separated exclude globs")
    sp.add_argument("--mime-type", help="override mime detection")
    sp.add_argument("--no-embeddings", action="store_true",
                    help="store + metadata only; skip device indexing")
    sp.add_argument("--verify", action="store_true",
                    help="read back stored content and re-hash")
    sp.add_argument("--snapshot", action="store_true", help="record a tree snapshot")
    sp.add_argument("--snapshot-label", help="label for the snapshot")
    sp.set_defaults(fn=cmd_add)

    sp = sub.add_parser("get", help="show document info")
    sp.add_argument("selector", help="hash, hash prefix, path, or name")
    sp.add_argument("--name", action="store_true",
                    help="treat the selector strictly as a file name")
    sp.add_argument("--latest", action="store_true",
                    help="newest match when several share the name")
    sp.add_argument("--oldest", action="store_true")
    sp.add_argument("--metadata-only", action="store_true",
                    help="(default behavior; accepted for compatibility)")
    sp.add_argument("--graph", action="store_true",
                    help="include knowledge-graph related documents")
    sp.add_argument("--depth", type=int, default=1,
                    help="graph expansion limit scaling")
    sp.set_defaults(fn=cmd_get)

    sp = sub.add_parser("cat", help="print document content")
    sp.add_argument("selector")
    sp.set_defaults(fn=cmd_cat)

    sp = sub.add_parser("list", help="list documents")
    sp.add_argument("--limit", type=int, default=50)
    sp.add_argument("--offset", type=int, default=0)
    sp.add_argument("--pattern", help="path glob")
    sp.add_argument("--tags")
    sp.add_argument("--match-all-tags", action="store_true")
    sp.add_argument("--collection")
    sp.add_argument("--file-type", action="append",
                    help="extension or mime filter (repeatable)")
    sp.add_argument("--text", action="store_true", dest="text_only",
                    help="text documents only")
    sp.add_argument("--binary", action="store_true", dest="binary_only",
                    help="binary documents only")
    for when in ("created", "modified", "indexed"):
        sp.add_argument(f"--{when}-after", metavar="TIME")
        sp.add_argument(f"--{when}-before", metavar="TIME")
    sp.add_argument("--recent", type=int, metavar="N",
                    help="N most recently indexed")
    sp.add_argument("--sort", choices=["name", "size", "date", "indexed",
                                       "hash"])
    sp.add_argument("--reverse", action="store_true")
    sp.add_argument("--paths-only", action="store_true")
    sp.add_argument("--show-tags", action="store_true")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("delete", help="delete documents")
    sp.add_argument("selectors", nargs="*")
    sp.add_argument("--pattern", help="delete every document matching a path glob")
    sp.add_argument("--directory", help="delete every document under a path prefix")
    sp.add_argument("--dry-run", action="store_true",
                    help="print what would be deleted")
    sp.add_argument("--keep-content", action="store_true",
                    help="drop metadata/indexes but keep CAS blocks")
    sp.set_defaults(fn=cmd_delete)

    sp = sub.add_parser("update", help="update tags/metadata")
    sp.add_argument("selector")
    sp.add_argument("--metadata", action="append")
    sp.add_argument("--add-tags")
    sp.add_argument("--remove-tags")
    sp.set_defaults(fn=cmd_update)

    sp = sub.add_parser("search", help="hybrid search")
    sp.add_argument("query", nargs="?", default=None)
    sp.add_argument("-n", "--limit", type=int, default=10)
    sp.add_argument("--type", default="hybrid",
                    choices=["auto", "hybrid", "semantic", "vector",
                             "keyword", "fts"])
    sp.add_argument("--tags")
    sp.add_argument("--match-all-tags", action="store_true",
                    help="require every tag (default: any)")
    sp.add_argument("--path", help="path glob filter")
    sp.add_argument("--collection")
    sp.add_argument("--session", help="restrict to a session's pinned set")
    sp.add_argument("--paths-only", action="store_true")
    sp.add_argument("--show-hash", action="store_true")
    sp.add_argument("--hash", dest="hash_prefix",
                    help="look up a document by sha256 (prefix ok)")
    sp.add_argument("--file-type", action="append",
                    help="extension or mime filter (repeatable)")
    sp.add_argument("--text-only", action="store_true")
    sp.add_argument("--binary-only", action="store_true")
    for when in ("created", "modified", "indexed"):
        sp.add_argument(f"--{when}-after", metavar="TIME")
        sp.add_argument(f"--{when}-before", metavar="TIME")
    sp.add_argument("--similarity", type=float,
                    help="minimum fused score (0..1)")
    sp.add_argument("--stdin", action="store_true",
                    help="read the query from stdin")
    sp.add_argument("--query-file", help="read the query from a file")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("grep", help="regex search over content")
    sp.add_argument("pattern")
    sp.add_argument("-i", "--ignore-case", action="store_true")
    sp.add_argument("-F", "--fixed-strings", action="store_true")
    sp.add_argument("-w", "--word-regexp", action="store_true")
    sp.add_argument("--path", help="path glob filter")
    sp.add_argument("--include", action="append",
                    help="path glob (repeatable; any may match)")
    sp.add_argument("--tags")
    sp.add_argument("--match-all-tags", action="store_true")
    sp.add_argument("--session", help="restrict to a session's pinned set")
    sp.add_argument("-m", "--max-count", type=int, default=1000)
    sp.add_argument("-C", "--context", type=int, default=0)
    sp.add_argument("-l", "--files-with-matches", action="store_true")
    sp.add_argument("-c", "--count", action="store_true",
                    help="print per-file match counts")
    sp.add_argument("--no-filename", action="store_true")
    sp.add_argument("--semantic-limit", type=int, default=0, metavar="N",
                    help="append up to N semantic matches")
    sp.set_defaults(fn=cmd_grep)

    sp = sub.add_parser("status", help="system status")
    sp.add_argument("-d", "--detailed", action="store_true")
    sp.set_defaults(fn=cmd_status)
    sub.add_parser("stats", help="detailed stats").set_defaults(fn=cmd_stats)

    sp = sub.add_parser("graph", help="knowledge graph")
    gsub = sp.add_subparsers(dest="graph_cmd", required=True)
    g = gsub.add_parser("explore"); g.add_argument("query"); g.add_argument("--limit", type=int, default=25)
    g = gsub.add_parser("related"); g.add_argument("query"); g.add_argument("--limit", type=int, default=20)
    g = gsub.add_parser("symbol"); g.add_argument("query"); g.add_argument("--limit", type=int, default=50)
    g = gsub.add_parser("impact"); g.add_argument("query"); g.add_argument("--hops", type=int, default=2); g.add_argument("--limit", type=int, default=25)
    g = gsub.add_parser("trace"); g.add_argument("query"); g.add_argument("to")
    gsub.add_parser("build")
    gsub.add_parser("stats")
    sp.set_defaults(fn=cmd_graph)

    sp = sub.add_parser("session", help="working sets")
    ssub = sp.add_subparsers(dest="session_cmd", required=True)
    ssub.add_parser("list")
    s = ssub.add_parser("create"); s.add_argument("name")
    s = ssub.add_parser("pin"); s.add_argument("pattern"); s.add_argument("--name")
    s = ssub.add_parser("unpin"); s.add_argument("pattern"); s.add_argument("--name")
    s = ssub.add_parser("warm"); s.add_argument("--name")
    s = ssub.add_parser("delete"); s.add_argument("name")
    sp.set_defaults(fn=cmd_session)

    sp = sub.add_parser("tree", help="path tree browse")
    sp.add_argument("prefix", nargs="?")
    sp.set_defaults(fn=cmd_tree)

    sp = sub.add_parser("diff", help="diff two tree snapshots")
    sp.add_argument("snapshot_a")
    sp.add_argument("snapshot_b")
    sp.set_defaults(fn=cmd_diff)
    sub.add_parser("snapshots", help="list tree snapshots").set_defaults(fn=cmd_snapshots)

    sp = sub.add_parser("repair", help="run repair operations")
    sp.add_argument("--ops", help="comma-separated op names (default: all)")
    sp.set_defaults(fn=cmd_repair)
    sub.add_parser("doctor", help="health checks").set_defaults(fn=cmd_doctor)

    sp = sub.add_parser("plugin", help="plugin management")
    psub = sp.add_subparsers(dest="plugin_cmd", required=True)
    psub.add_parser("list")
    pp = psub.add_parser("trust"); pp.add_argument("path")
    pp = psub.add_parser("load"); pp.add_argument("path")
    sp.set_defaults(fn=cmd_plugin)

    sp = sub.add_parser("restore", help="restore a tree snapshot from the CAS")
    sp.add_argument("snapshot_id")
    sp.add_argument("target")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(fn=cmd_restore)

    sp = sub.add_parser("watch", help="watch a directory and index changes")
    sp.add_argument("directory")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--include")
    sp.add_argument("--tags")
    sp.add_argument("--delete-missing", action="store_true")
    sp.add_argument("--once", action="store_true")
    sp.set_defaults(fn=cmd_watch)

    sp = sub.add_parser("dedupe", help="find near-duplicate documents")
    sp.add_argument("--threshold", type=float, default=0.8)
    sp.set_defaults(fn=cmd_dedupe)

    sp = sub.add_parser("download", help="download a URL into the store")
    sp.add_argument("url")
    sp.add_argument("--sha256", help="expected content hash")
    sp.add_argument("--tags")
    sp.add_argument("--no-store", action="store_true")
    sp.set_defaults(fn=cmd_download)

    sub.add_parser(
        "tune", help="show runtime tuning profile + tuner stats"
    ).set_defaults(fn=cmd_tune)

    sub.add_parser("config", help="show effective config").set_defaults(fn=cmd_config)

    from .auth import cmd_auth

    sp = sub.add_parser(
        "auth", help="signing keys, API keys, JWT tokens "
        "(the reference registers this surface but stubs it)")
    asub = sp.add_subparsers(dest="auth_op", required=True)
    k = asub.add_parser("keygen", help="generate a signing key")
    k.add_argument("--type", default="ed25519", choices=["ed25519", "hmac"])
    k.add_argument("--name", default="", help="key id (default: generated)")
    asub.add_parser("list-keys", help="list keys + API keys")
    r = asub.add_parser("revoke", help="revoke a key or API key")
    r.add_argument("key_id")
    t = asub.add_parser("token", help="mint a JWT (EdDSA or HS256)")
    t.add_argument("key_id")
    t.add_argument("--claims", default="", help="extra claims as JSON")
    t.add_argument("--validity", type=int, default=3600, help="seconds")
    ak = asub.add_parser("api-key", help="generate an API key (shown once)")
    ak.add_argument("--name", required=True)
    ak.add_argument("--permissions", default="read,write")
    ak.add_argument("--expires", default="never", help="ISO 8601 or 'never'")
    v = asub.add_parser("verify", help="verify a JWT or API key")
    v.add_argument("token")
    sp.set_defaults(fn=cmd_auth)
    sp = sub.add_parser("model", help="embedding models")
    sp.add_argument("model_cmd", nargs="?", default="list",
                    choices=["list", "download"])
    sp.add_argument("model_id", nargs="?", default="",
                    help="HF hub id or local checkpoint dir (download)")
    sp.add_argument("--out", default="", help="output .npz path")
    sp.set_defaults(fn=cmd_model)

    sp = sub.add_parser("daemon", help="daemon control")
    sp.add_argument("daemon_cmd", choices=["start", "stop", "status", "restart"])
    sp.add_argument("--foreground", action="store_true")
    sp.set_defaults(fn=cmd_daemon)

    sub.add_parser("serve", help="MCP server over stdio").set_defaults(fn=cmd_serve)

    sp = sub.add_parser("completion", help="shell completion")
    sp.add_argument("shell", choices=["bash", "zsh"])
    sp.set_defaults(fn=cmd_completion)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cli = Cli(args)
    try:
        return args.fn(cli)
    except YamsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0
    finally:
        cli.close()


if __name__ == "__main__":
    sys.exit(main())
