"""The port's mobile C ABI (`yams_tpu_torch/native`, the `mobile` library)
on the CPU.

- Every flow of tests/test_mobile_abi.py (the JSON escape hatch, the
  reference-shaped typed structs, the field-level getters, the thread-local
  last error, a bad config) runs through the port's library against the
  port's daemon and against the reference's daemon, each on a thread with
  a real AF_UNIX socket over its own data dir, at the same small widths;
  the reference test's assertions hold on the port's side, and every
  answer is the reference's apart from the named departures: `ping` and
  `status` add "backend" and "device", doctor's `device` and `native_lib`
  lines are the port's own, and volatile fields (times, durations, the
  data dir) are normalized away. Scores agree within 1e-4 (the CSR leg).
- Embedded mode: a context with only a working directory spawns the
  port's daemon (`python3 -m yams_tpu_torch.cli.main ... daemon start`)
  on $YAMS_TPU_DEVICE, here `cpu`, and its status names that device; with
  the variable unset the CLI's default stays `cuda`.
- TestMobileResultParserFuzz: the hostile-daemon parser fuzz of
  tests/test_fuzz.py against the port's library, and one subprocess run of
  a ubsan build of `native/build_sanitized.sh` (the loader takes it from
  YAMS_TPU_TORCH_MOBILE_LIB) driving a live port daemon.
- The loader: an explicit library path that does not load raises, as does
  the mobile library under YAMS_TPU_NO_NATIVE.
"""

import asyncio
import ctypes
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import pytest
import torch

from chip_smoke import ThreadDaemon
from test_torch_services import (port_config_for, ref_config_for,  # noqa: F401
                                 reference_native, reference_native_build)
from yams_tpu_torch import native
from yams_tpu_torch.native import mobile_abi as abi

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lib():
    return native.mobile_library()


@pytest.fixture()
def short_dir():
    """A short directory for sockets (AF_UNIX paths are limited to ~107 bytes)."""
    d = pathlib.Path(tempfile.mkdtemp(prefix="ym"))
    yield d
    shutil.rmtree(d, ignore_errors=True)


class RefThreadDaemon:
    """The reference's YamsDaemon on a background thread (as
    tests/test_mobile_abi.py runs it)."""

    def __init__(self, cfg):
        from yams_tpu.daemon.server import YamsDaemon

        self.cfg, self.daemon = cfg, YamsDaemon(cfg)
        self.loop = asyncio.new_event_loop()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.daemon.run())

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        for _ in range(400):
            if cfg.socket_path.exists():
                break
            time.sleep(0.05)

    def stop(self):
        from yams_tpu.daemon.client import DaemonClient

        DaemonClient(self.cfg.socket_path).shutdown()
        self.thread.join(timeout=30)
        self.loop.close()


@pytest.fixture()
def daemons(tmp_path, short_dir, reference_native):
    """{"port": (socket, data dir), "ref": (socket, data dir)}: both daemons
    on their own data dirs; the reference's native library is the test's own
    build (`reference_native`), so its doctor line does not depend on which
    xdist worker won its loader's shared build."""
    pcfg = port_config_for(tmp_path / "port")
    pcfg.daemon.socket_path = str(short_dir / "p.sock")
    rcfg = ref_config_for(tmp_path / "ref")
    rcfg.daemon.socket_path = str(short_dir / "r.sock")
    port = ThreadDaemon(pcfg, CPU, timeout=120)
    ref = RefThreadDaemon(rcfg)
    yield {"port": (pcfg.socket_path, pcfg.data_dir), "ref": (rcfg.socket_path, rcfg.data_dir)}
    ref.stop()
    if port.thread.is_alive():
        port.stop()


def take(lib, ptr) -> dict:
    assert ptr, "C call returned NULL"
    s = ctypes.string_at(ptr).decode()
    lib.yams_mobile_free(ptr)
    return json.loads(s)


def ctx_for(lib, sock) -> int:
    cfg = lib.yams_mobile_context_config_default()
    assert cfg.struct_size == ctypes.sizeof(abi.ContextConfig)
    cfg.backend_mode = abi.BACKEND_DAEMON
    cfg.daemon_socket_path = str(sock).encode()
    out = ctypes.c_void_p()
    rc = lib.yams_mobile_context_create(ctypes.byref(cfg), ctypes.byref(out))
    assert rc == 0, lib.yams_mobile_last_error_message()
    return out.value


def hdr(lib):
    return lib.yams_mobile_request_header_default()


def family_json(lib, fam, handle) -> dict:
    return json.loads(getattr(lib, f"yams_mobile_{fam}_result_json")(handle).text())


def store(lib, ctx, path, tags=()) -> str:
    req = abi.DocumentStoreRequest()
    req.header = hdr(lib)
    req.path = str(path).encode()
    if tags:
        arr = (abi.cp * len(tags))(*[t.encode() for t in tags])
        req.tags, req.tag_count = arr, len(tags)
    hv = abi.StringView()
    assert lib.yams_mobile_store_document(ctx, ctypes.byref(req), ctypes.byref(hv)) == 0
    h = hv.text()
    lib.yams_mobile_string_view_destroy(ctypes.byref(hv))
    assert not hv.data
    return h


# -- the flows of tests/test_mobile_abi.py, each returning its answers --------

def flow_full(lib, sock, tmp):
    h = lib.yams_mobile_connect(str(sock).encode())
    assert h
    out = []
    try:
        resp = take(lib, lib.yams_mobile_ping(h))
        assert resp["ok"] and resp["result"]["pong"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_add_text(h, b"mobile/m.txt",
                                                  b"text added through the C ABI"))
        assert resp["ok"] and resp["result"]["indexed"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_search(h, b"C ABI text", 5, b"hybrid"))
        assert resp["ok"] and resp["result"]["hits"][0]["name"] == "m.txt"
        out.append(resp)
        resp = take(lib, lib.yams_mobile_get_text(h, b"m.txt"))
        assert "C ABI" in resp["result"]["text"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_status_json(h, 0))
        assert resp["result"]["documents"]["documents"] == 1
        out.append(resp)
        resp = take(lib, lib.yams_mobile_request(
            h, json.dumps({"type": "grep", "pattern": "ABI"}).encode()))
        assert resp["ok"] and resp["result"]["files_matched"] == 1
        out.append(resp)
    finally:
        lib.yams_mobile_disconnect(h)
    return out


def flow_extended(lib, sock, tmp):
    h = lib.yams_mobile_connect(str(sock).encode())
    assert h
    out = []
    try:
        out.append(take(lib, lib.yams_mobile_add_text(
            h, b"ext/AlphaWidget.md",
            b"AlphaWidget renders the MainPanel with AlphaWidget state")))
        resp = take(lib, lib.yams_mobile_update_metadata(h, b"AlphaWidget.md", b"team", b"ui"))
        assert resp["ok"] and resp["result"]["metadata"]["team"] == "ui"
        out.append(resp)
        resp = take(lib, lib.yams_mobile_embed(h, b"alpha widget"))
        assert resp["ok"] and resp["result"]["dim"] == 64
        out.append(resp)
        resp = take(lib, lib.yams_mobile_doctor_json(h))
        assert resp["ok"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_repair_json(h, b"fts5,orphans"))
        assert resp["ok"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_session(h, b"list", None))
        assert resp["ok"]
        out.append(resp)
        resp = take(lib, lib.yams_mobile_suggest_context(h, b"alpha widget", 2))
        assert resp["ok"] and "AlphaWidget" in resp["result"]["context"]
        out.append(resp)
        out.append(take(lib, lib.yams_mobile_request(
            h, json.dumps({"type": "queue", "op": "wait_idle"}).encode())))
        resp = take(lib, lib.yams_mobile_graph_explore(h, b"alphawidget", 5))
        assert resp["ok"]
        out.append(resp)
    finally:
        lib.yams_mobile_disconnect(h)
    return out


def flow_typed(lib, sock, tmp):
    """test_reference_struct_flow: the reference request structs drive every
    major flow."""
    ctx = ctx_for(lib, sock)
    rec = []
    out = ctypes.c_void_p()
    try:
        f = tmp / "typed.txt"
        f.write_text("typed surface text with reference structs")
        doc_hash = store(lib, ctx, f, ("t1", "t2"))
        assert len(doc_hash) == 64
        rec.append(doc_hash)

        q = abi.SearchRequest()
        q.header = hdr(lib)
        q.query = b"reference structs"
        q.limit = 5
        assert lib.yams_mobile_search_execute(ctx, ctypes.byref(q), ctypes.byref(out)) == 0
        body = family_json(lib, "search", out)
        assert body["result"]["hits"][0]["name"] == "typed.txt"
        stats = json.loads(lib.yams_mobile_search_result_stats_json(out).text())
        assert stats["ok"] is True
        rec += [body, stats]
        lib.yams_mobile_search_result_destroy(out)

        g = abi.GrepRequest()
        g.header = hdr(lib)
        g.pattern = b"typed"
        g.word_boundary = 1
        assert lib.yams_mobile_grep_execute(ctx, ctypes.byref(g), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "grep", out))
        assert rec[-1]["result"]["files_matched"] == 1
        lib.yams_mobile_grep_result_destroy(out)

        lreq = abi.ListRequest()
        lreq.header = hdr(lib)
        lreq.limit = 10
        assert lib.yams_mobile_list_documents(ctx, ctypes.byref(lreq), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "list", out))
        assert len(rec[-1]["result"]["documents"]) == 1
        lib.yams_mobile_list_result_destroy(out)

        dreq = abi.DocumentGetRequest()
        dreq.header = hdr(lib)
        dreq.document_hash = doc_hash.encode()
        assert lib.yams_mobile_get_document(ctx, ctypes.byref(dreq), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "document_get", out))
        assert rec[-1]["result"]["sha256_hash"] == doc_hash
        lib.yams_mobile_document_get_result_destroy(out)

        ureq = abi.UpdateRequest()
        ureq.header = hdr(lib)
        ureq.hash = doc_hash.encode()
        addt, mk, mv = (abi.cp * 1)(b"extra"), (abi.cp * 1)(b"team"), (abi.cp * 1)(b"mobile")
        ureq.add_tags, ureq.add_tag_count = addt, 1
        ureq.metadata_keys, ureq.metadata_values, ureq.metadata_count = mk, mv, 1
        assert lib.yams_mobile_update_document(ctx, ctypes.byref(ureq), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "update", out))
        assert rec[-1]["result"]["metadata"]["team"] == "mobile"
        assert "extra" in rec[-1]["result"]["tags"]
        lib.yams_mobile_update_result_destroy(out)

        mreq = abi.MetadataRequest()
        mreq.header = hdr(lib)
        mreq.document_hash = doc_hash.encode()
        assert lib.yams_mobile_get_metadata(ctx, ctypes.byref(mreq), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "metadata", out))
        lib.yams_mobile_metadata_result_destroy(out)

        creq = abi.CatRequest()
        creq.header = hdr(lib)
        creq.hash = doc_hash.encode()
        content = abi.StringView()
        assert lib.yams_mobile_cat(ctx, ctypes.byref(creq), ctypes.byref(content)) == 0
        assert "reference structs" in content.text()
        rec.append(content.text())
        lib.yams_mobile_cat_result_destroy(ctypes.byref(content))

        vreq = abi.VectorStatusRequest()
        vreq.header = hdr(lib)
        assert lib.yams_mobile_get_vector_status(ctx, ctypes.byref(vreq), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "vector_status", out))
        lib.yams_mobile_vector_status_result_destroy(out)

        rreq = abi.RepairRequest()
        rreq.header = hdr(lib)
        rreq.repair_fts5 = rreq.repair_orphans = 1
        rres = ctypes.POINTER(abi.RepairResult)()
        assert lib.yams_mobile_repair(ctx, ctypes.byref(rreq), ctypes.byref(rres)) == 0
        r = rres.contents
        assert r.operation_count == 2
        rec.append([r.embeddings_generated, r.embeddings_skipped, r.fts5_cleaned,
                    r.graph_repaired, r.orphans_removed, r.operation_count])
        lib.yams_mobile_repair_result_destroy(rres)

        report = abi.StringView()
        assert lib.yams_mobile_doctor(ctx, ctypes.byref(report)) == 0
        assert "ok" in report.text()
        rec.append(json.loads(report.text()))
        lib.yams_mobile_doctor_result_destroy(ctypes.byref(report))

        ml = ctypes.POINTER(abi.ModelListResult)()
        assert lib.yams_mobile_list_models(ctx, ctypes.byref(ml)) == 0
        m = ml.contents
        assert m.count >= 1 and m.models[0].is_loaded == 1 and m.models[0].dim == 64
        models = [(m.models[i].name.decode(), m.models[i].dim, m.models[i].is_loaded)
                  for i in range(m.count)]
        # the rest of the list is the process's provider registry, which keeps
        # the providers of plugins an earlier test loaded (the reference's
        # never drops one): only the loaded model and the built-ins are held
        assert {"hf", "mock", "neural", "simeon"} <= {name for name, _, _ in models}
        rec.append([x for x in models if x[2]])
        lib.yams_mobile_model_list_result_destroy(ml)
        einfo = abi.EmbeddingInfo()
        assert lib.yams_mobile_get_embedding_info(ctx, ctypes.byref(einfo)) == 0
        assert einfo.available == 1 and einfo.dim == 64

        delr = abi.DeleteRequest()
        delr.header = hdr(lib)
        delr.hash = doc_hash.encode()
        delr.dry_run = 1
        assert lib.yams_mobile_delete_by_name(ctx, ctypes.byref(delr), ctypes.byref(out)) == 0
        rec.append(family_json(lib, "delete", out))
        lib.yams_mobile_delete_result_destroy(out)
        assert lib.yams_mobile_remove_document(ctx, doc_hash.encode()) == 0
        assert lib.yams_mobile_remove_document(ctx, doc_hash.encode()) != 0
        rec.append(lib.yams_mobile_last_error_message().decode())
    finally:
        lib.yams_mobile_context_destroy(ctx)
    return rec


def flow_diff(lib, sock, tmp):
    ctx = ctx_for(lib, sock)
    try:
        hashes = []
        for name, text in (("a.txt", "alpha\nshared line\nomega"),
                           ("b.txt", "alpha\nCHANGED line\nomega")):
            (tmp / name).write_text(text)
            hashes.append(store(lib, ctx, tmp / name))
        dreq = abi.DiffRequest()
        dreq.header = hdr(lib)
        dreq.hash_a, dreq.hash_b = hashes[0].encode(), hashes[1].encode()
        dv = abi.StringView()
        assert lib.yams_mobile_diff(ctx, ctypes.byref(dreq), ctypes.byref(dv)) == 0
        diff = dv.text()
        assert "-shared line" in diff and "+CHANGED line" in diff
        lib.yams_mobile_string_view_destroy(ctypes.byref(dv))
    finally:
        lib.yams_mobile_context_destroy(ctx)
    return [hashes, diff]


def flow_last_error(lib, sock, tmp):
    ctx = ctx_for(lib, sock)
    try:
        out = ctypes.c_void_p()
        dreq = abi.DocumentGetRequest()
        dreq.header = hdr(lib)
        dreq.name = b"no-such-doc"
        assert lib.yams_mobile_get_document(ctx, ctypes.byref(dreq), ctypes.byref(out)) != 0
        msg = lib.yams_mobile_last_error_message().decode()
        assert "ok" in msg
        lib.yams_mobile_document_get_result_destroy(out)
        assert lib.yams_mobile_status_execute(ctx, 0, ctypes.byref(out)) == 0
        assert lib.yams_mobile_last_error_message() == b""
        status = family_json(lib, "status", out)
        lib.yams_mobile_status_result_destroy(out)
    finally:
        lib.yams_mobile_context_destroy(ctx)
    return [json.loads(msg), status]


def flow_getters(lib, sock, tmp):
    """test_typed_field_access_end_to_end: every result field read without
    parsing JSON."""
    ctx = ctx_for(lib, sock)
    rec = []
    try:
        f = tmp / "alpha.txt"
        f.write_text("unicode snowman ☃ in typed getter land")
        doc_hash = store(lib, ctx, f)
        out = ctypes.c_void_p()
        q = abi.SearchRequest()
        q.header = hdr(lib)
        q.query = b"typed getter"
        q.limit = 5
        assert lib.yams_mobile_search_execute(ctx, ctypes.byref(q), ctypes.byref(out)) == 0
        n = lib.yams_mobile_search_result_count(out)
        assert n >= 1
        rec.append([n, lib.yams_mobile_search_result_path(out, 0).text(),
                    lib.yams_mobile_search_result_title(out, 0).text(),
                    lib.yams_mobile_search_result_snippet(out, 0).text(),
                    lib.yams_mobile_search_result_score(out, 0),
                    lib.yams_mobile_search_result_document_id(out, 0),
                    lib.yams_mobile_search_result_total(out),
                    lib.yams_mobile_search_result_path(out, 99).text()])
        assert rec[-1][1].endswith("alpha.txt") and rec[-1][4] > 0.0 and rec[-1][5] >= 1
        assert rec[-1][6] >= 1 and rec[-1][7] == ""
        assert lib.yams_mobile_search_result_duration_ms(out) >= 0.0
        lib.yams_mobile_search_result_destroy(out)

        g = abi.GrepRequest()
        g.header = hdr(lib)
        g.pattern = b"snowman"
        g.max_matches = 10
        assert lib.yams_mobile_grep_execute(ctx, ctypes.byref(g), ctypes.byref(out)) == 0
        rec.append([lib.yams_mobile_grep_result_count(out),
                    lib.yams_mobile_grep_result_path(out, 0).text(),
                    lib.yams_mobile_grep_result_line(out, 0).text(),
                    lib.yams_mobile_grep_result_line_number(out, 0),
                    lib.yams_mobile_grep_result_files_searched(out),
                    lib.yams_mobile_grep_result_files_matched(out)])
        assert rec[-1][0] == 1 and rec[-1][1].endswith("alpha.txt") and "snowman" in rec[-1][2]
        assert rec[-1][3] == 1 and rec[-1][4] >= 1 and rec[-1][5] == 1
        lib.yams_mobile_grep_result_destroy(out)

        lreq = abi.ListRequest()
        lreq.header = hdr(lib)
        lreq.limit = 10
        assert lib.yams_mobile_list_documents(ctx, ctypes.byref(lreq), ctypes.byref(out)) == 0
        rec.append([lib.yams_mobile_list_result_count(out),
                    lib.yams_mobile_list_result_path(out, 0).text(),
                    lib.yams_mobile_list_result_hash(out, 0).text(),
                    lib.yams_mobile_list_result_mime_type(out, 0).text(),
                    lib.yams_mobile_list_result_size(out, 0)])
        assert rec[-1][0] == 1 and rec[-1][1].endswith("alpha.txt")
        assert len(rec[-1][2]) == 64 and rec[-1][4] > 0
        lib.yams_mobile_list_result_destroy(out)

        dreq = abi.DocumentGetRequest()
        dreq.header = hdr(lib)
        dreq.document_hash = doc_hash.encode()
        assert lib.yams_mobile_get_document(ctx, ctypes.byref(dreq), ctypes.byref(out)) == 0
        rec.append([lib.yams_mobile_document_get_result_path(out).text(),
                    lib.yams_mobile_document_get_result_hash(out).text(),
                    lib.yams_mobile_document_get_result_mime_type(out).text(),
                    lib.yams_mobile_document_get_result_size(out)])
        assert rec[-1][0].endswith("alpha.txt") and rec[-1][1] == doc_hash and rec[-1][3] > 0
        lib.yams_mobile_document_get_result_destroy(out)
        dreq.include_content = 1
        assert lib.yams_mobile_get_document(ctx, ctypes.byref(dreq), ctypes.byref(out)) == 0
        rec.append(lib.yams_mobile_document_get_result_content(out).text())
        assert "☃" in rec[-1]
        lib.yams_mobile_document_get_result_destroy(out)

        assert lib.yams_mobile_status_execute(ctx, 0, ctypes.byref(out)) == 0
        keys = (abi.StringView * 16)()
        nkeys = lib.yams_mobile_result_keys(out, b"documents", keys, 16)
        rec.append([lib.yams_mobile_status_result_document_count(out),
                    lib.yams_mobile_status_result_block_count(out),
                    lib.yams_mobile_status_result_state(out).text(),
                    lib.yams_mobile_result_int(out, b"documents.documents", -1),
                    sorted(keys[i].text() for i in range(min(nkeys, 16)))])
        assert rec[-1][0] == 1 and rec[-1][1] >= 1 and rec[-1][3] == 1
        assert "documents" in rec[-1][4]
        lib.yams_mobile_status_result_destroy(out)
    finally:
        lib.yams_mobile_context_destroy(ctx)
    return rec


def flow_getters_on_error(lib, sock, tmp):
    ctx = ctx_for(lib, sock)
    try:
        out = ctypes.c_void_p()
        dreq = abi.DocumentGetRequest()
        dreq.header = hdr(lib)
        dreq.name = b"nope"
        assert lib.yams_mobile_get_document(ctx, ctypes.byref(dreq), ctypes.byref(out)) != 0
        rec = [lib.yams_mobile_result_ok(out), lib.yams_mobile_search_result_count(out),
               lib.yams_mobile_document_get_result_path(out).text(),
               lib.yams_mobile_document_get_result_size(out),
               family_json(lib, "document_get", out)]
        assert rec[:4] == [0, 0, "", -1]
        lib.yams_mobile_document_get_result_destroy(out)
    finally:
        lib.yams_mobile_context_destroy(ctx)
    return rec


FLOWS = {"full": flow_full, "extended": flow_extended, "typed": flow_typed,
         "diff": flow_diff, "last_error": flow_last_error, "getters": flow_getters,
         "getters_on_error": flow_getters_on_error}

# answers that differ between runs of one daemon: times, durations, load
VOLATILE = {"duration_ms", "uptime_s", "daemon_uptime_s", "created_time", "modified_time",
            "indexed_time", "avg_latency_ms", "pressure", "latency_hist", "admission",
            "requests_handled", "bytes"}
# the named departures: the package version, the device names, the port's
# "backend" / "device" in ping and status, the vector index's device dtype
# and sharding in detailed status, and wait_idle's "idle" (the port's own)
DEPARTED = {"version", "device", "devices", "backend", "device_dtype", "sharded", "idle"}


def normalize(x, roots):
    if isinstance(x, dict):
        return {k: normalize(v, roots) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [normalize(v, roots) for v in x]
    if isinstance(x, str):
        for root, name in roots:
            x = x.replace(str(root), name)
    return x


def departures(port, ref):
    """Both sides without the named departures; doctor's native line keeps
    its verdict."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in DEPARTED}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    def natives(x, out):
        if isinstance(x, dict):
            if "native_lib" in x:
                out.append(x.pop("native_lib")[0])
            for v in x.values():
                natives(v, out)
        elif isinstance(x, list):
            for v in x:
                natives(v, out)
        return out

    assert natives(port, []) == natives(ref, [])
    return strip(port), strip(ref)


def assert_close(got, want, where="answer"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, abs=1e-4, rel=0), (where, got, want)
    else:
        assert got == want, (where, got, want)


def run_both(lib, daemons, tmp_path, flow):
    got = {}
    for side in ("port", "ref"):
        sock, data = daemons[side]
        work = tmp_path / f"{side}_work"
        work.mkdir()
        got[side] = normalize(flow(lib, sock, work), [(data, "<data>"), (work, "<work>")])
    return got["port"], got["ref"]


@pytest.mark.parametrize("name", list(FLOWS))
def test_flow_answers_as_the_reference(lib, daemons, tmp_path, name):
    """One flow of tests/test_mobile_abi.py through the port's library on
    both daemons: the reference test's assertions hold on each, and the
    answers are equal apart from the named departures."""
    port, ref = run_both(lib, daemons, tmp_path, FLOWS[name])
    assert_close(*departures(port, ref))


def test_ping_and_status_name_the_ports_backend_and_device(lib, daemons):
    """The departures the comparison strips, pinned: the port's ping and
    status say "backend": "torch" and the device; the reference's do not."""
    for side, want in (("port", ("torch", "cpu")), ("ref", (None, None))):
        h = lib.yams_mobile_connect(str(daemons[side][0]).encode())
        try:
            for resp in (take(lib, lib.yams_mobile_ping(h)),
                         take(lib, lib.yams_mobile_status_json(h, 0))):
                r = resp["result"]
                assert (r.get("backend"), r.get("device")) == want
        finally:
            lib.yams_mobile_disconnect(h)


def test_abi_version_and_version_struct(lib):
    assert lib.yams_mobile_abi_version() == 1
    v = lib.yams_mobile_get_version()
    assert (v.major, v.minor, v.patch) == (1, 0, 0)


def test_connect_failure_returns_null(lib):
    assert not lib.yams_mobile_connect(b"/nonexistent/sock")


def test_bad_config_rejected(lib):
    out = ctypes.c_void_p()
    cfg = abi.ContextConfig()
    assert lib.yams_mobile_context_create(ctypes.byref(cfg), ctypes.byref(out)) == 1
    cfg = lib.yams_mobile_context_config_default()
    assert cfg.backend_mode == abi.BACKEND_EMBEDDED
    assert lib.yams_mobile_context_create(ctypes.byref(cfg), ctypes.byref(out)) == 1
    assert b"working_directory" in lib.yams_mobile_last_error_message()


def stop_embedded(wd: pathlib.Path) -> None:
    """Shut the spawned daemon down and wait for its process to end."""
    from yams_tpu_torch.daemon.client import DaemonClient

    pid_file = wd / "daemon.pid"
    try:
        DaemonClient(wd / "daemon.sock").shutdown()
    except Exception:      # noqa: BLE001  (already gone: the pid check below decides)
        pass
    if not pid_file.exists():
        return
    pid = int(pid_file.read_text())
    for _ in range(200):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)
    os.kill(pid, 9)


def test_embedded_mode_spawns_the_ports_daemon_on_its_device(lib, short_dir, monkeypatch):
    """BACKEND_EMBEDDED with only a working directory spawns the port's
    daemon over it (the copy's departure: `python3 -m yams_tpu_torch.cli.main
    --storage <wd> daemon start`) and connects once the socket appears; the
    daemon opens on $YAMS_TPU_DEVICE (`cpu` here: no card) and says so."""
    monkeypatch.setenv("YAMS_TPU_DEVICE", "cpu")
    monkeypatch.delenv("YAMS_TPU_SOCKET", raising=False)
    monkeypatch.delenv("YAMS_TPU_STORAGE", raising=False)
    monkeypatch.chdir(REPO)
    wd = short_dir / "wd"
    wd.mkdir()
    cfg = lib.yams_mobile_context_config_default()
    assert cfg.backend_mode == abi.BACKEND_EMBEDDED
    cfg.working_directory = str(wd).encode()
    out = ctypes.c_void_p()
    try:
        rc = lib.yams_mobile_context_create(ctypes.byref(cfg), ctypes.byref(out))
        assert rc == 0, lib.yams_mobile_last_error_message()
        ctx = out.value
        try:
            res = ctypes.c_void_p()
            assert lib.yams_mobile_status_execute(ctx, 0, ctypes.byref(res)) == 0
            status = family_json(lib, "status", res)["result"]
            lib.yams_mobile_status_result_destroy(res)
            assert (status["backend"], status["device"]) == ("torch", "cpu")
            assert status["data_dir"] == str(wd)
            report = abi.StringView()
            assert lib.yams_mobile_doctor(ctx, ctypes.byref(report)) == 0
            assert json.loads(report.text())["result"]["device"] == [True, "cpu"]
            lib.yams_mobile_doctor_result_destroy(ctypes.byref(report))
        finally:
            lib.yams_mobile_context_destroy(ctx)
    finally:
        stop_embedded(wd)


def test_cli_device_defaults_to_the_environment_then_cuda(monkeypatch):
    """`--device` defaults to $YAMS_TPU_DEVICE, else `cuda`; the flag wins."""
    from yams_tpu_torch.cli.main import build_parser

    monkeypatch.delenv("YAMS_TPU_DEVICE", raising=False)
    assert build_parser().parse_args(["status"]).device == "cuda"
    monkeypatch.setenv("YAMS_TPU_DEVICE", "cpu")
    assert build_parser().parse_args(["status"]).device == "cpu"
    assert build_parser().parse_args(["--device", "cuda:1", "status"]).device == "cuda:1"


def test_a_daemon_asked_for_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No fallback: the CLI's foreground daemon on the default device raises
    where torch sees no card, instead of serving from the CPU."""
    from yams_tpu_torch.cli.main import main

    monkeypatch.delenv("YAMS_TPU_DEVICE", raising=False)
    monkeypatch.delenv("YAMS_TPU_SOCKET", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the daemon would serve")
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        main(["--storage", str(tmp_path / "d"), "--no-daemon", "daemon", "start",
              "--foreground"])


class TestMobileResultParserFuzz:
    """tests/test_fuzz.py's hostile-daemon fuzz against the port's library:
    the in-library JSON DOM (JParser) parses daemon responses for the typed
    getters, and a corrupted or hostile daemon must never crash a C host:
    getters degrade to defaults on any byte garbage, deep nesting,
    truncation or type confusion."""

    @staticmethod
    def serve_one(sock_path, payload: bytes, flags=0x02):
        """Accept one connection, read a frame, reply with `payload`."""
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(sock_path))
        srv.listen(1)

        def recv_exactly(conn, n):
            buf = b""
            while len(buf) < n:
                part = conn.recv(n - len(buf))
                if not part:
                    return None
                buf += part
            return buf

        def run():
            conn, _ = srv.accept()
            try:
                hdr = recv_exactly(conn, 16)
                if hdr is None:
                    return
                length = struct.unpack("<IBBHII", hdr)[4]
                if recv_exactly(conn, length) is None:
                    return
                conn.sendall(struct.pack("<IBBHII", 0x59545044, 1, flags, 0, len(payload),
                                         zlib.crc32(payload) & 0xFFFFFFFF) + payload)
            finally:
                conn.close()
                srv.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    @pytest.mark.parametrize("payload", [
        b"",                                     # empty
        b"not json at all",                      # garbage
        b'{"ok": true, "result": ',              # truncated
        b'{"ok": true, "result": {"hits": 3}}',  # type confusion: not array
        b'{"ok": true, "result": {"hits": [{"path": 42}]}}',  # wrong type
        b'[' * 4096 + b']' * 4096,               # deep nesting
        b'{"ok": true, "result": {"total": 1e999}}',  # inf overflow
        b'{"ok": true, "result": {"hits": [' + b'{},' * 999 + b'{}]}}',
        bytes(range(256)),                       # raw bytes
        b'{"ok": true, "result": {"text": "' + b'\\ud800' + b'"}}',
    ], ids=["empty", "garbage", "truncated", "not_array", "wrong_type", "deep", "inf",
            "wide", "raw", "lone_surrogate"])
    def test_hostile_daemon_payload_never_crashes_getters(self, lib, short_dir, payload):
        sock = short_dir / "hostile.sock"
        t = self.serve_one(sock, payload)
        h = lib.yams_mobile_connect(str(sock).encode())
        assert h
        try:
            ptr = lib.yams_mobile_request(h, b'{"type":"ping"}')
            if ptr:          # a transport-level rejection (NULL) is a fine outcome
                assert isinstance(ctypes.string_at(ptr), bytes)
                lib.yams_mobile_free(ptr)
        finally:
            lib.yams_mobile_disconnect(h)
            t.join(timeout=5)

    def test_typed_getters_on_hostile_payloads(self, lib, short_dir):
        """The full typed path (run_request -> JParser -> getters) against
        each hostile payload through a fresh one-shot server."""
        payloads = [b'{"ok": true, "result": {"hits": "nope"}}',
                    b'{"ok": true, "result": {"hits": [[[[[[]]]]]]}}',
                    b'{"ok": true', b'\x00\xff\xfe', b'{}', b'{"ok": true, "result": null}']
        for i, payload in enumerate(payloads):
            sock = short_dir / f"h{i}.sock"
            t = self.serve_one(sock, payload)
            ctx = ctx_for(lib, sock)
            out = ctypes.c_void_p()
            lib.yams_mobile_status_execute(ctx, 0, ctypes.byref(out))
            if out.value:
                assert lib.yams_mobile_result_int(out, b"total", -7) in (-7, 1)
                assert 0 <= lib.yams_mobile_result_array_len(out, b"hits") < 10
                assert 0 <= lib.yams_mobile_search_result_count(out) < 10
                lib.yams_mobile_status_result_destroy(out)
            lib.yams_mobile_context_destroy(ctx)
            t.join(timeout=5)


UBSAN_HOST = """
import ctypes, json, pathlib, sys
import numpy as np
import torch
from chip_smoke import ThreadDaemon
from yams_tpu_torch import native
from yams_tpu_torch.core import config as C
from yams_tpu_torch.search.config import SearchEngineConfig

lib = native.mobile_library()
assert native.library_path("mobile").name not in lib._name      # the explicit build
data = np.random.default_rng(0).bytes(1 << 20)
b = native.fastcdc_boundaries(data, 4096, 16384, 65536)
assert b[-1] == len(data)
counts, ok = native.sketch_batch(["alpha beta gamma", "delta"], 512, 256, (1, 2), (3,))
assert ok.all() and counts.shape == (2, 512)
root = pathlib.Path(sys.argv[1])
cfg = C.Config(data_dir=root / "data")
cfg.embedding = C.EmbeddingConfig(dim=64, sketch_dim=512)
cfg.vector = C.VectorIndexConfig(dim=64, capacity=256, block_rows=128)
cfg.lexical = C.LexicalIndexConfig(postings_window=64)
cfg.search = SearchEngineConfig()
cfg.daemon.socket_path = str(root / "s.sock")
d = ThreadDaemon(cfg, torch.device("cpu"), timeout=120)
h = lib.yams_mobile_connect(str(cfg.socket_path).encode())
def take(p):
    s = ctypes.string_at(p).decode()
    lib.yams_mobile_free(p)
    return json.loads(s)
assert take(lib.yams_mobile_add_text(h, b"san/a.txt", b"sanitized text \\xe2\\x98\\x83"))["ok"]
assert take(lib.yams_mobile_search(h, b"sanitized", 5, b"hybrid"))["result"]["hits"]
cfgc = lib.yams_mobile_context_config_default()
cfgc.backend_mode = 1
cfgc.daemon_socket_path = str(cfg.socket_path).encode()
ctx = ctypes.c_void_p()
assert lib.yams_mobile_context_create(ctypes.byref(cfgc), ctypes.byref(ctx)) == 0
out = ctypes.c_void_p()
assert lib.yams_mobile_status_execute(ctx, 0, ctypes.byref(out)) == 0
assert lib.yams_mobile_status_result_document_count(out) == 1
keys = (native.mobile_abi.StringView * 8)()
assert lib.yams_mobile_result_keys(out, b"documents", keys, 8) >= 1
lib.yams_mobile_status_result_destroy(out)
lib.yams_mobile_context_destroy(ctx)
lib.yams_mobile_disconnect(h)
d.stop()
print("SAN_OK")
"""


def test_ubsan_build_runs_clean(tmp_path, short_dir):
    """`native/build_sanitized.sh ubsan` builds the sketch and mobile
    libraries with -fsanitize=undefined; a subprocess loads them through
    the explicit paths (YAMS_TPU_TORCH_SKETCH_LIB / _MOBILE_LIB) and drives
    FastCDC, the batched sketch and the C ABI against a live port daemon
    (JSON tier, typed context, getters). UBSAN_OPTIONS halt_on_error=1
    turns any undefined behavior into a nonzero exit (tests/test_fuzz.py's
    ubsan build, on the port's libraries)."""
    script = REPO / "yams_tpu_torch" / "native" / "build_sanitized.sh"
    r = subprocess.run(["sh", str(script), "ubsan", str(tmp_path), "sketch mobile"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    env = dict(os.environ, UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1",
               YAMS_TPU_TORCH_SKETCH_LIB=str(tmp_path / "libyams_torch_sketch.ubsan.so"),
               YAMS_TPU_TORCH_MOBILE_LIB=str(tmp_path / "libyams_torch_mobile.ubsan.so"))
    r2 = subprocess.run([sys.executable, "-c", UBSAN_HOST, str(short_dir)], env=env,
                        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "SAN_OK" in r2.stdout and "runtime error" not in r2.stderr


def test_an_explicit_library_that_does_not_load_raises(tmp_path):
    """The explicit path replaces the build: one that does not load raises
    (no silent fallback), and so does the mobile library under
    YAMS_TPU_NO_NATIVE, which has no Python route."""
    code = ("from yams_tpu_torch import native\n"
            "for name in ('sketch', 'mobile'):\n"
            "    try:\n"
            "        native._load(name)\n"
            "    except OSError as e:\n"
            "        print(name, 'raised')\n")
    env = dict(os.environ, YAMS_TPU_TORCH_SKETCH_LIB=str(tmp_path / "missing.so"),
               YAMS_TPU_TORCH_MOBILE_LIB=str(tmp_path / "missing.so"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and r.stdout.split("\n")[:2] == ["sketch raised", "mobile raised"]
    code = ("from yams_tpu_torch import native\n"
            "assert native.sketch_library() is None\n"
            "try:\n"
            "    native.mobile_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n")
    env = dict(os.environ, YAMS_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and r.stdout.startswith("raised YAMS_TPU_NO_NATIVE"), r.stderr


def test_the_smoke_c_host_drives_a_cpu_daemon(lib, tmp_path, short_dir):
    """chip_smoke's phase-16 C host (ABI_HOST_C), compiled with gcc against
    the port's yams_mobile.h and linked to the mobile library, drives a
    port daemon on the CPU: its add_text, store_document, search, grep,
    get_document and doctor answer, and its search hits equal the same
    daemon's search from Python."""
    import hashlib

    from chip_smoke import ABI_HOST_C

    include = REPO / "yams_tpu_torch" / "native" / "include"
    lib_path = pathlib.Path(lib._name)
    (tmp_path / "host.c").write_text(ABI_HOST_C)
    subprocess.run(["gcc", "-O1", "-std=c11", f"-I{include}", str(tmp_path / "host.c"),
                    str(lib_path), f"-Wl,-rpath,{lib_path.parent}", "-o", str(tmp_path / "host")],
                   check=True, capture_output=True, timeout=120)
    blob = os.urandom(1 << 16)
    (tmp_path / "blob.bin").write_bytes(blob)
    cfg = port_config_for(tmp_path / "data")
    cfg.daemon.socket_path = str(short_dir / "h.sock")
    d = ThreadDaemon(cfg, CPU, timeout=120)
    try:
        proc = subprocess.run([str(tmp_path / "host"), str(cfg.socket_path),
                               str(tmp_path / "blob.bin"), "tensor kernels socket",
                               "socket frames"], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        got = dict(line.partition(" ")[::2] for line in proc.stdout.splitlines())
        assert got["store"] == hashlib.sha256(blob).hexdigest()
        hits = json.loads(got["search"])["result"]["hits"]
        want = d.client.search("tensor kernels socket", limit=10)["hits"]
        assert hits and hits[0]["name"] == "host_note.txt"
        assert [(h["document_id"], h["score"]) for h in hits] == \
            [(h["document_id"], h["score"]) for h in want]
        assert json.loads(got["grep"])["result"]["files_matched"] == 1
        assert json.loads(got["get_document"])["result"]["file_size"] == len(blob)
        assert json.loads(got["doctor"])["result"]["device"] == [True, "cpu"]
    finally:
        d.stop()
