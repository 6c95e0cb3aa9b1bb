"""The real-text evaluation path on a stand-in root, against the reference.

A stand-in real-text root is built in a temporary directory by
`scripts/realtext.py` `assemble_root` (this repository's markdown as
`docs/`, a seeded selection of the installed torch package's C++ headers
as `include/`); no corpus is fetched. On it:

- `assemble_root` links what it says, and at its default header count
  every markdown file stays inside `realtext_beir`'s 900 files;
- the port's `build`, `realtext_beir`, `camel_split` and `available` equal
  the reference helper's (tests/benchmarks/realtext.py, its
  `REALTEXT_ROOT` pointed at the same root), case by case;
- the port's `eval_beir_scale.run_eval` and the reference's `AppContext`
  (provider hf on the in-repo realtext_bert_d192 at f32 compute, the CSR
  lexical leg: `packed_max_entries=0`, whose BM25 sums are bit-equal across
  packages) give file-level MRR / nDCG@10 / recall@10 within 0.005 and
  the same top-10 on at least 98% of the queries, the rest named. This
  runs at a reduced file count (`realtext_beir`'s seeded cut of `EVAL_FILES`
  files from a root of `EVAL_HEADERS` headers and the markdown: ~90 chunks
  and ~55 queries), so that both packages' adds (the reference's ~13 s
  alone, over 8 minutes under the parallel tier-1 run at ~240 chunks) fit
  the tier-1 run's time; the card smoke runs the full root.
"""

import functools
import os

import numpy as np
import pytest

from tests.benchmarks import realtext as ref_realtext
from yams_tpu_torch.scripts import eval_beir_scale, realtext

EVAL_HEADERS, EVAL_FILES = 60, 40   # reduced file count of the cross-package eval (tier-1 time)


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    return realtext.assemble_root(tmp_path_factory.mktemp("rt") / "root")


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return realtext.assemble_root(tmp_path_factory.mktemp("rts") / "root", EVAL_HEADERS)


def test_assemble_root_links_the_markdown_and_headers(full_root):
    root = full_root["root"]
    md = realtext.repo_markdown()
    assert full_root["markdown"] == len(md) >= 10
    assert full_root["headers"] == realtext.MAX_DOCS - len(md)
    assert full_root["headers_available"] >= full_root["headers"]
    links = [p for p in root.rglob("*") if p.is_symlink()]
    assert len(links) == len(md) + full_root["headers"]
    assert all(p.resolve().is_file() for p in links)
    assert (root / "docs" / "README.md").resolve() == (realtext.REPO / "README.md").resolve()
    assert sorted(p.suffix for p in (root / "include").rglob("*") if p.is_symlink()) == \
        [".h"] * full_root["headers"]


def test_every_markdown_file_stays_in_the_cut(full_root):
    ds = realtext.realtext_beir(root=full_root["root"])
    files = {eval_beir_scale.file_of(d) for d in ds.corpus}
    assert len(files) == realtext.MAX_DOCS
    assert sum(f.endswith(".md") for f in files) == full_root["markdown"]
    kinds = list(ds.kinds.values())
    assert kinds.count("heading") >= 50 and kinds.count("symbol") >= 50


def test_assemble_root_is_seeded(tmp_path):
    a = realtext.assemble_root(tmp_path / "a", 30, seed=1)["root"]
    b = realtext.assemble_root(tmp_path / "b", 30, seed=1)["root"]
    c = realtext.assemble_root(tmp_path / "c", 30, seed=2)["root"]

    def names(r):
        return sorted(str(p.relative_to(r)) for p in (r / "include").rglob("*.h"))
    assert names(a) == names(b) != names(c)


def test_root_argument_and_environment(tmp_path, monkeypatch):
    assert not realtext.available(tmp_path)
    (tmp_path / "docs").mkdir()
    assert realtext.available(tmp_path)
    monkeypatch.setattr(realtext, "REALTEXT_ROOT", None)
    assert not realtext.available()
    with pytest.raises(FileNotFoundError, match="YAMS_REALTEXT_DIR"):
        realtext.build()
    monkeypatch.setattr(realtext, "REALTEXT_ROOT", tmp_path)
    assert realtext.available() and realtext.resolve_root() == tmp_path


@pytest.mark.parametrize("name", ["TopologyRoutingSession", "PQ4CodeBook", "HTTPServer",
                                  "ivalue_to_arg", "x", "ABCDefGHIj2k", "TensorImpl"])
def test_camel_split_is_the_references(name):
    assert realtext.camel_split(name) == ref_realtext.camel_split(name)


@pytest.mark.parametrize("kw", [{}, {"max_docs": 120, "seed": 3},
                                {"max_docs": 400, "max_queries_per_kind": 20}])
def test_build_equals_the_reference_helper(full_root, monkeypatch, kw):
    monkeypatch.setattr(ref_realtext, "REALTEXT_ROOT", full_root["root"])
    got, want = realtext.build(**kw, root=full_root["root"]), ref_realtext.build(**kw)
    assert (got.docs, got.queries, got.kinds) == (want.docs, want.queries, want.kinds)
    assert len(got.queries) > 0


@pytest.mark.parametrize("kw", [{}, {"max_files": 200, "seed": 1},
                                {"chunk_chars": 700, "max_file_chars": 5000},
                                {"max_queries_per_kind": 30, "seed": 11}])
def test_realtext_beir_equals_the_reference_helper(full_root, monkeypatch, kw):
    monkeypatch.setattr(ref_realtext, "REALTEXT_ROOT", full_root["root"])
    got, want = realtext.realtext_beir(**kw, root=full_root["root"]), \
        ref_realtext.realtext_beir(**kw)
    assert (got.name, got.corpus, got.queries, got.qrels, got.kinds) == \
        (want.name, want.corpus, want.queries, want.qrels, want.kinds)


def _reference_eval(ds, data_dir, monkeypatch):
    """scripts/eval_beir_scale.py's hybrid loop on the reference's AppContext,
    with the hf provider at f32 compute and the CSR lexical leg."""
    from yams_tpu.core.config import Config, VectorIndexConfig
    from yams_tpu.embed import provider as ref_provider
    from yams_tpu.services.app import AppContext
    from yams_tpu.utils.metrics import evaluate

    monkeypatch.setitem(ref_provider._REGISTRY, "hf-float32",
                        functools.partial(ref_provider.HFProvider, compute_dtype="float32"))
    cfg = Config(data_dir=data_dir)
    cfg.embedding.provider = "hf-float32"
    cfg.vector = VectorIndexConfig(dim=192, capacity=2 * len(ds.corpus), block_rows=512)
    cfg.lexical.packed_max_entries = 0
    app = AppContext(cfg)
    try:
        for did, doc in ds.corpus.items():
            app.documents.add_bytes(doc["text"].encode(), did)
        app.search_engine.clear_hot()
        runs, fruns, ranked_by_q = [], [], {}
        for qid, qtext in ds.queries.items():
            resp = app.search.search(qtext, limit=20, search_type="hybrid",
                                     with_snippets=False)
            ranked = [h.path.lstrip("/") for h in resp.hits]
            rels = ds.relevant(qid)
            runs.append((ranked[:10], rels))
            fruns.append((eval_beir_scale.fold_to_files(ranked)[:10],
                          {eval_beir_scale.file_of(d) for d in rels}))
            ranked_by_q[qid] = ranked[:10]
        return {"all": evaluate(runs, k=10), "file_level": evaluate(fruns, k=10),
                "ranked": ranked_by_q}
    finally:
        app.close()


def test_hybrid_eval_matches_the_reference(small_root, tmp_path, monkeypatch):
    assert os.environ.get("YAMS_VECTOR_SHARDED") == "off"     # tests/conftest.py
    ds = realtext.realtext_beir(max_files=EVAL_FILES, root=small_root["root"])
    assert len(ds.queries) >= 50
    got = eval_beir_scale.run_eval("hf", modes=("hybrid",), quiet=True, ds=ds, device="cpu",
                                   compute_dtype="float32", packed_max_entries=0,
                                   data_dir=tmp_path / "port")["hybrid"]
    want = _reference_eval(ds, tmp_path / "ref" / "data", monkeypatch)
    for level in ("file_level", "all"):
        for metric in ("mrr", "ndcg", "recall"):
            assert abs(got[level][metric] - want[level][metric]) <= 0.005, \
                (level, metric, got[level], want[level])
    differ = [q for q in ds.queries if got["ranked"][q] != want["ranked"][q]]
    assert len(differ) <= 0.02 * len(ds.queries), \
        [(q, ds.queries[q], got["ranked"][q], want["ranked"][q]) for q in differ]
    # the stand-in corpus is real text: the trained encoder retrieves on it
    assert got["file_level"]["mrr"] >= 0.5 and got["file_level"]["recall"] >= 0.7
    assert np.isfinite(list(got["all"].values())).all()
