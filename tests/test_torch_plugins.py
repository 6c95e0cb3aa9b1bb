"""The port's plugin host on the CPU, held against the reference's.

- `PluginManager` over the port's AppContext: the mock plugin's manifest,
  health and listing as the reference's manager gives them; its model
  provider (the identity projection a bf16 `torch.eye` on the provider's
  device), content extractor and entity extractor wired into the port's
  registries and graph service; the trust list, a bad plugin, unload, the
  daemon's trust gate; the bundled `neural_ner.py` loads from its path
  (the reference's manager cannot import it that way) on the app's device.
- `host.SubprocessPlugin`: the JSON-RPC fixture plugin's interfaces.
- `native_host`: a C plugin built here against the port's copy of the ABI
  header (into this process's own temporary directory), loaded, and each
  negotiated interface exercised, also through document ingestion.
- `pdf_extract`: the reference's PDF tests (flat streams, object streams,
  xref streams, ToUnicode maps, a classic xref table, damaged xrefs) rerun
  on the port's `extract_pdf`, which also gives the reference's output on
  each of their PDFs; a PDF added through the port's app is searchable.
- `graph_adapter`: the reference's cursor, export/import and delta tests
  rerun on the port's adapter over the port's KG store, and the manager
  binds it to the app's KG.
"""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_graph_adapter as ref_ga_tests
import test_native_plugin as ref_native_tests
import test_plugins as ref_plugin_tests
import yams_tpu.plugins.pdf_extract as ref_pdf
from test_torch_services import port_config_for, ref_config_for
from yams_tpu.plugins.manager import PluginManager as RefManager
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu_torch.core.errors import YamsError
from yams_tpu_torch.metadata.db import Database
from yams_tpu_torch.metadata.kg import KnowledgeGraphStore
from yams_tpu_torch.plugins import pdf_extract
from yams_tpu_torch.plugins.graph_adapter import GraphAdapter
from yams_tpu_torch.plugins.host import SubprocessPlugin
from yams_tpu_torch.plugins.manager import PluginManager
from yams_tpu_torch.plugins.spec import (
    IFACE_CONTENT_EXTRACTOR,
    IFACE_ENTITY_EXTRACTOR,
    IFACE_MODEL_PROVIDER,
)
from yams_tpu_torch.services.app import AppContext

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
MOCK = FIXTURES / "mock_plugin.py"
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "yams_tpu_torch"
NER_PLUGIN = PORT_ROOT / "plugins" / "neural_ner.py"


@pytest.fixture()
def app(tmp_path):
    a = AppContext(port_config_for(tmp_path / "data"), device="cpu")
    yield a
    a.close()


def test_mock_plugin_loads_as_in_the_reference(app, tmp_path):
    ref_app = RefApp(ref_config_for(tmp_path / "ref"))
    try:
        pm = PluginManager(app, trust_file=tmp_path / "trust")
        rm = RefManager(ref_app, trust_file=tmp_path / "ref_trust")
        m = pm.load_file(MOCK, config={"k": "v"})
        r = rm.load_file(MOCK, config={"k": "v"})
        assert m is not None and m.name == r.name == "mockplug"
        assert pm.health() == rm.health() and pm.health()["mockplug"]["initialized"]
        assert pm.list() == rm.list()
        assert "model_provider_v1" in pm.list()[0]["interfaces"]
    finally:
        ref_app.close()


def test_model_provider_adapter(app):
    from yams_tpu_torch.embed.provider import create_provider

    PluginManager(app).load_file(MOCK)
    p = create_provider("mockplug", device="cpu")
    v = p.encode(["abc", "defg"])
    assert v.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    vecs, proj = p.query_device_inputs(["abc"])
    assert np.array_equal(vecs, p.encode(["abc"]))
    assert proj.dtype == torch.bfloat16 and proj.device.type == "cpu"
    assert torch.equal(proj, torch.eye(16, dtype=torch.bfloat16))
    assert p.space_id.startswith("plugin/mockplug/")


def test_content_and_entity_extractor_adapters(app):
    from yams_tpu_torch.services.extraction import extract_text

    PluginManager(app).load_file(MOCK)
    assert extract_text(b"hello plug", "application/x-mocktype") == ("HELLO PLUG", "MOCK TITLE")
    ents = app.graph.extract_entities("alpha beta gamma delta")
    assert [e[0] for e in ents] == ["alpha", "beta", "gamma"]


def test_trust_list_bad_plugin_and_unload(app, tmp_path):
    pm = PluginManager(app, trust_file=tmp_path / "trust")
    assert pm.load_trusted() == 0
    pm.trust(MOCK)
    assert pm.load_trusted() == 1
    pm.trust(MOCK)                                   # deduplicated
    assert len(pm.trusted_paths()) == 1
    pm.untrust(MOCK)
    assert pm.trusted_paths() == []
    bad = tmp_path / "bad_plugin.py"
    bad.write_text("raise RuntimeError('boom')")
    assert pm.load_file(bad) is None and "bad_plugin" in pm.errors
    assert pm.unload("mockplug") and not pm.unload("mockplug")


def test_the_daemons_load_requires_trust(app, tmp_path):
    from yams_tpu_torch.daemon.server import YamsDaemon

    class _Daemon:
        handle_plugins = YamsDaemon.handle_plugins

    d = _Daemon()
    d.plugins = PluginManager(app, trust_file=tmp_path / "trust")
    with pytest.raises(YamsError, match="not trusted"):
        d.handle_plugins({"op": "load", "path": str(MOCK)})
    d.handle_plugins({"op": "trust", "path": str(MOCK)})
    assert d.handle_plugins({"op": "load", "path": str(MOCK)})["plugins"][0]["name"] == \
        "mockplug"


def test_the_bundled_ner_plugin_loads_from_its_path(app, tmp_path):
    """Trusted by path, the bundled plugin imports as the port's own module
    and runs on the app's device; the reference's manager fails on the
    relative imports of its own bundled file."""
    pm = PluginManager(app, trust_file=tmp_path / "trust")
    pm.trust(NER_PLUGIN)
    assert pm.load_trusted() == 1 and not pm.errors
    assert pm.health() == {"neural_ner": {"status": "ok", "labels": ["entity"]}}
    ents = app.graph.extract_entities("When the CacheManager runs the ingest_queue_worker")
    assert [e for e, _ in ents] == ["CacheManager", "ingest_queue_worker"]
    ref = RefManager(None)
    assert ref.load_file(pathlib.Path(ref_pdf.__file__).parent / "neural_ner.py") is None
    assert "relative import" in ref.errors["neural_ner"]


def test_subprocess_plugin_host():
    sp = SubprocessPlugin([sys.executable, str(FIXTURES / "subprocess_plugin.py")])
    try:
        m = sp.manifest()
        assert m.name == "subproc"
        mp = m.interfaces["model_provider_v1"]
        assert mp.dim() == 8 and mp.embed(["x", "y"]) == [[1.0] * 8, [1.0] * 8]
        assert m.interfaces["entity_extractor_v1"].extract_entities("one two three") == [
            ("one", "tok", 0.9), ("two", "tok", 0.9)]
        assert m.health()["status"] == "ok"
    finally:
        sp.close()
    assert sp.proc.poll() is not None


@pytest.fixture(scope="module")
def plugin_so(tmp_path_factory):
    """The reference tests' C plugin, built against the port's ABI header
    into this process's own temporary directory."""
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc, "a C compiler builds the native plugin"
    d = tmp_path_factory.mktemp("nplug")
    (d / "plugin.c").write_text(ref_native_tests.PLUGIN_SRC)
    so = d / "yams_plugin_rot13.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O2", f"-I{PORT_ROOT / 'plugins' / 'include'}",
                    str(d / "plugin.c"), "-o", str(so)], check=True, capture_output=True,
                   timeout=120)
    return so


def test_native_plugin_interfaces(plugin_so, tmp_path):
    mgr = PluginManager(trust_file=tmp_path / "trust.txt")
    assert str(plugin_so) in mgr.scan(plugin_so.parent)
    mgr.trust(plugin_so)
    assert mgr.load_trusted() == 1
    m = mgr.plugins["rot13_demo"]
    assert m.version == "1.2.3" and m.health() == {"status": "ok"}
    assert set(m.interfaces) == {IFACE_CONTENT_EXTRACTOR, IFACE_MODEL_PROVIDER,
                                 IFACE_ENTITY_EXTRACTOR}
    ce = m.get_interface(IFACE_CONTENT_EXTRACTOR)
    assert ce.supported_mimes() == ["application/x-rot13"]
    assert ce.extract(b"Uryyb Jbeyq", "application/x-rot13") == ("Hello World", "rot13 doc")
    assert ce.extract(b"n" * 100_000, "application/x-rot13")[0] == "a" * 100_000
    mp = m.get_interface(IFACE_MODEL_PROVIDER)
    rows = mp.embed(["ab", "abab"])
    assert mp.model_id() == "bytes-4d" and mp.dim() == 4 and sum(rows[1]) > sum(rows[0])
    ents = m.get_interface(IFACE_ENTITY_EXTRACTOR).extract_entities("the HTTP server uses TLS")
    assert ("HTTP", "TERM", 0.9) in ents and ("TLS", "TERM", 0.9) in ents
    assert mgr.unload("rot13_demo")


def test_native_plugin_wires_into_ingestion(plugin_so, app, tmp_path):
    assert PluginManager(app, trust_file=tmp_path / "t").load_file(plugin_so) is not None
    res = app.documents.add_bytes(b"frperg cnffjbeq vafvqr", "docs/x.rot13",
                                  mime_type="application/x-rot13")
    assert res.document_id > 0
    assert "secret password inside" in app.documents.get_text("docs/x.rot13")


def test_native_abi_mismatch_is_refused(tmp_path):
    (tmp_path / "bad.c").write_text("int yams_plugin_get_abi_version(void){return 999;}\n")
    so = tmp_path / "yams_plugin_bad.so"
    subprocess.run([shutil.which("gcc") or "cc", "-shared", "-fPIC", str(tmp_path / "bad.c"),
                    "-o", str(so)], check=True, capture_output=True, timeout=120)
    mgr = PluginManager(trust_file=tmp_path / "trust.txt")
    assert mgr.load_file(so) is None and "ABI mismatch" in mgr.errors["yams_plugin_bad"]


@pytest.fixture()
def port_pdf(monkeypatch):
    """The reference's PDF tests import extract_pdf at call time: point that
    name at the port's."""
    monkeypatch.setattr(ref_pdf, "extract_pdf", pdf_extract.extract_pdf)


class TestPortPdfPlugin(ref_plugin_tests.TestPdfPlugin):
    @pytest.fixture(autouse=True)
    def _port(self, port_pdf):
        pass

    def test_end_to_end_via_plugin(self, app):
        pm = PluginManager(app)
        assert pm.load_module("yams_tpu_torch.plugins.pdf_extract") is not None
        res = app.documents.add_bytes(self._make_pdf("searchable pdf body content"), "doc.pdf")
        assert res.indexed
        hits = app.search.search("searchable pdf body").hits
        assert hits and hits[0].name == "doc.pdf"


class TestPortPdfStructural(ref_plugin_tests.TestPdfStructural):
    @pytest.fixture(autouse=True)
    def _port(self, port_pdf):
        pass


@pytest.mark.parametrize("case", ["flat", "flat_raw", "objstm", "bfrange", "predictor"])
def test_pdf_extract_gives_the_references_output(case):
    mk = ref_plugin_tests.TestPdfPlugin._make_pdf
    modern = ref_plugin_tests.TestPdfStructural._modern_pdf
    pdf = {"flat": lambda: mk(None, "Hello PDF world", title="My Doc"),
           "flat_raw": lambda: mk(None, r"Parens \(q\) and \\s", compress=False),
           "objstm": lambda: modern()[0], "bfrange": lambda: modern(use_bfrange=True)[0],
           "predictor": lambda: modern(predictor=True)[0]}[case]()
    got = pdf_extract.extract_pdf(pdf)
    assert got == ref_pdf.extract_pdf(pdf) and got[0]


@pytest.fixture()
def kg(tmp_path):
    return KnowledgeGraphStore(Database(tmp_path / "m.db"))


@pytest.fixture()
def adapter(kg):
    a = GraphAdapter(kg)
    for i in range(10):
        kg.upsert_node(f"n{i}", label=f"Node {i}", type_="entity" if i % 2 else "concept")
    ids = [kg.find_node(f"n{i}") for i in range(10)]
    for i in range(9):
        kg.add_edge(ids[i], ids[i + 1], "next", 0.5 + i / 20)
    return a


@pytest.fixture()
def port_kg_names(monkeypatch):
    """The reference's round-trip test builds a second store with its
    module's names: point them at the port's."""
    monkeypatch.setattr(ref_ga_tests, "Database", Database)
    monkeypatch.setattr(ref_ga_tests, "KnowledgeGraphStore", KnowledgeGraphStore)
    monkeypatch.setattr(ref_ga_tests, "GraphAdapter", GraphAdapter)


class TestPortGraphInfo(ref_ga_tests.TestInfo):
    pass


class TestPortGraphCursors(ref_ga_tests.TestCursors):
    pass


class TestPortGraphExportImportDelta(ref_ga_tests.TestExportImportDelta):
    @pytest.fixture(autouse=True)
    def _port(self, port_kg_names):
        pass


def test_graph_export_matches_the_reference(adapter, tmp_path):
    from yams_tpu.metadata.db import Database as RefDb
    from yams_tpu.metadata.kg import KnowledgeGraphStore as RefKg
    from yams_tpu.plugins.graph_adapter import GraphAdapter as RefAdapter

    ref_kg = RefKg(RefDb(tmp_path / "ref.db"))
    ref = RefAdapter(ref_kg)
    for i in range(10):      # the `adapter` fixture's graph
        ref_kg.upsert_node(f"n{i}", label=f"Node {i}", type_="entity" if i % 2 else "concept")
    ids = [ref_kg.find_node(f"n{i}") for i in range(10)]
    for i in range(9):
        ref_kg.add_edge(ids[i], ids[i + 1], "next", 0.5 + i / 20)
    for fmt in ("graphjson", "edge-list"):
        assert adapter.export_graph("kg", fmt) == ref.export_graph("kg", fmt)
    assert adapter.get_graph_info("kg") == ref.get_graph_info("kg")
    assert adapter.get_capabilities() == ref.get_capabilities()


def test_the_manager_binds_the_graph_adapter_to_the_apps_kg(app, tmp_path):
    pm = PluginManager(app=app, trust_file=tmp_path / "trust")
    assert pm.load_module("yams_tpu_torch.plugins.graph_adapter") is not None, pm.errors
    ga = app.graph_adapter
    assert ga.kg is app.kg
    ga.apply_delta_json("kg", '{"node": {"key": "wired", "label": "W"}}')
    assert app.kg.find_node("wired") is not None
