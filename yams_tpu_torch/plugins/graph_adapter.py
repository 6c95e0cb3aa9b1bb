"""graph_adapter_v1: property-graph access over the KG store.

Parity: the reference exposes its knowledge graph to plugins/SDKs through a
read-focused, cursor-paged adapter contract with portable export/import and
JSONL delta apply (the upstream docs/spec/wit/graph_adapter_v1.wit:1).
This is the bundled in-process implementation over KnowledgeGraphStore
(metadata/kg.py); docs/spec/wit/graph_adapter_v1.wit is the contract.

Cursors page by rowid (`WHERE id > last ORDER BY id LIMIT n`), so iteration
is O(page) per call and never materializes the graph. Export formats:
  graphjson — JSONL: {"node": {...}} and {"edge": {...}} records
  edge-list — TSV: src_key <TAB> relation <TAB> dst_key <TAB> weight

Copied from yams_tpu/plugins/graph_adapter.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import json

from .spec import PluginManifest

FORMATS_EXPORT = ("graphjson", "edge-list")
FORMATS_IMPORT = ("graphjson",)
GRAPH_ID = "kg"


class GraphAdapter:
    def __init__(self, kg):
        self.kg = kg
        self._cursors: dict[int, dict] = {}
        self._next_cursor = 1

    # -- capabilities / info -------------------------------------------------

    def get_capabilities(self) -> dict:
        return {
            "read_only": False, "multigraph": True, "weighted": True,
            "delta": True,
            "export_formats": list(FORMATS_EXPORT),
            "import_formats": list(FORMATS_IMPORT),
        }

    def list_graphs(self) -> list[dict]:
        return [self.get_graph_info(GRAPH_ID)]

    def get_graph_info(self, graph: str = GRAPH_ID) -> dict:
        self._check(graph)
        return {
            "id": GRAPH_ID, "name": "knowledge-graph", "directed": True,
            "num_nodes": self.kg.node_count(),
            "num_edges": self.kg.edge_count(),
        }

    def _check(self, graph: str) -> None:
        if graph != GRAPH_ID:
            raise KeyError(f"unknown graph: {graph}")

    # -- cursor-paged iteration ------------------------------------------------

    def _begin(self, kind: str, filter_json: str | None) -> int:
        f = json.loads(filter_json) if filter_json else {}
        cur = self._next_cursor
        self._next_cursor += 1
        self._cursors[cur] = {"kind": kind, "last": 0, "filter": f}
        return cur

    def nodes_begin(self, graph: str = GRAPH_ID,
                    filter_json: str | None = None) -> int:
        self._check(graph)
        return self._begin("nodes", filter_json)

    def edges_begin(self, graph: str = GRAPH_ID,
                    filter_json: str | None = None) -> int:
        self._check(graph)
        return self._begin("edges", filter_json)

    def nodes_next(self, cursor: int, limit: int = 256) -> dict:
        st = self._cursors[cursor]
        q = "SELECT id, node_key, label, type, properties FROM kg_nodes WHERE id > ?"
        args: list = [st["last"]]
        if st["filter"].get("type"):
            q += " AND type = ?"
            args.append(st["filter"]["type"])
        q += " ORDER BY id LIMIT ?"
        args.append(limit + 1)
        rows = self.kg.db.execute(q, tuple(args)).fetchall()
        done = len(rows) <= limit
        rows = rows[:limit]
        if rows:
            st["last"] = rows[-1]["id"]
        items = [{
            "id": r["id"], "key": r["node_key"], "label": r["label"],
            "type": r["type"], "props": json.loads(r["properties"] or "{}"),
        } for r in rows]
        return {"items": items, "done": done}

    def edges_next(self, cursor: int, limit: int = 256) -> dict:
        st = self._cursors[cursor]
        q = ("SELECT id, src_node_id, dst_node_id, relation, weight "
             "FROM kg_edges WHERE id > ?")
        args: list = [st["last"]]
        if st["filter"].get("relation"):
            q += " AND relation = ?"
            args.append(st["filter"]["relation"])
        q += " ORDER BY id LIMIT ?"
        args.append(limit + 1)
        rows = self.kg.db.execute(q, tuple(args)).fetchall()
        done = len(rows) <= limit
        rows = rows[:limit]
        if rows:
            st["last"] = rows[-1]["id"]
        items = [{
            "src": r["src_node_id"], "dst": r["dst_node_id"],
            "relation": r["relation"], "weight": r["weight"],
        } for r in rows]
        return {"items": items, "done": done}

    def nodes_end(self, cursor: int) -> None:
        self._cursors.pop(cursor, None)

    edges_end = nodes_end

    # -- export / import -------------------------------------------------------

    def _iter_all(self, kind: str):
        cur = self._begin(kind, None)
        step = self.nodes_next if kind == "nodes" else self.edges_next
        try:
            while True:
                page = step(cur, 512)
                yield from page["items"]
                if page["done"]:
                    return
        finally:
            self.nodes_end(cur)

    def export_graph(self, graph: str = GRAPH_ID,
                     format: str = "graphjson") -> bytes:
        self._check(graph)
        keys = {}
        if format == "graphjson":
            lines = []
            for n in self._iter_all("nodes"):
                keys[n["id"]] = n["key"]
                lines.append(json.dumps({"node": n}))
            for e in self._iter_all("edges"):
                lines.append(json.dumps({"edge": {
                    "src": keys.get(e["src"], e["src"]),
                    "dst": keys.get(e["dst"], e["dst"]),
                    "relation": e["relation"], "weight": e["weight"],
                }}))
            return ("\n".join(lines) + "\n").encode()
        if format == "edge-list":
            for n in self._iter_all("nodes"):
                keys[n["id"]] = n["key"]
            rows = [
                f"{keys.get(e['src'], e['src'])}\t{e['relation']}\t"
                f"{keys.get(e['dst'], e['dst'])}\t{e['weight']}"
                for e in self._iter_all("edges")
            ]
            return ("\n".join(rows) + "\n").encode()
        raise ValueError(f"unknown export format: {format}")

    def import_graph(self, format: str, data: bytes) -> str:
        if format != "graphjson":
            raise ValueError(f"unknown import format: {format}")
        self.apply_delta_json(GRAPH_ID, data.decode())
        return GRAPH_ID

    # -- delta -----------------------------------------------------------------

    @staticmethod
    def _parse_delta(delta_jsonl: str) -> list[tuple]:
        """Validate EVERY line up front — parse, op kind, required fields,
        numeric coercions — before anything touches the store. A delta is a
        transaction of intent: a malformed line anywhere must reject the
        whole delta, not land the prefix durably and then raise."""
        ops: list[tuple] = []
        for i, ln in enumerate(delta_jsonl.splitlines(), 1):
            ln = ln.strip()
            if not ln:
                continue
            try:
                op = json.loads(ln)
            except json.JSONDecodeError as e:
                raise ValueError(f"delta line {i}: bad JSON: {e}") from e
            try:
                if "node" in op:
                    n = op["node"]
                    ops.append(("node", str(n["key"]),
                                str(n.get("label", "")),
                                str(n.get("type", "entity")), n.get("props")))
                elif "edge" in op:
                    e = op["edge"]
                    ops.append(("edge", str(e["src"]), str(e["dst"]),
                                str(e.get("relation", "related")),
                                float(e.get("weight", 1.0))))
                elif "alias" in op:
                    a = op["alias"]
                    ops.append(("alias", str(a["key"]), str(a["alias"])))
                elif "link" in op:
                    li = op["link"]
                    ops.append(("link", str(li["key"]), int(li["doc_id"]),
                                float(li.get("weight", 1.0))))
                else:
                    raise ValueError(f"unknown delta op: {sorted(op)}")
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"delta line {i}: {e}") from e
        return ops

    def apply_delta_json(self, graph: str, delta_jsonl: str) -> int:
        """JSONL ops: {"node": {key,label,type,props}} upserts,
        {"edge": {src,dst,relation,weight}} adds (src/dst are node KEYS,
        auto-upserted), {"alias": {key,alias}}, {"link": {key,doc_id,weight}}.
        Returns ops applied. The whole delta validates before any op lands
        (import_graph inherits this), so a bad line can never leave the
        graph half-imported."""
        self._check(graph)
        ops = self._parse_delta(delta_jsonl)
        for op in ops:
            kind = op[0]
            if kind == "node":
                _, key, label, type_, props = op
                self.kg.upsert_node(key, label, type_, props)
            elif kind == "edge":
                _, src, dst, relation, weight = op
                s = self.kg.upsert_node(src)
                t = self.kg.upsert_node(dst)
                self.kg.add_edge(s, t, relation, weight)
            elif kind == "alias":
                _, key, alias = op
                self.kg.add_alias(self.kg.upsert_node(key), alias)
            else:
                _, key, doc_id, weight = op
                self.kg.link_document(self.kg.upsert_node(key), doc_id,
                                      weight)
        return len(ops)


def yams_plugin(kg=None) -> PluginManifest:
    """Bundled-plugin entry: graph_adapter_v1 over the app's KG store."""
    adapter = GraphAdapter(kg)
    return PluginManifest(
        name="graph_adapter",
        version="1.0.0",
        description="Property-graph access over the knowledge-graph store",
        interfaces={"graph_adapter_v1": adapter},
    )
