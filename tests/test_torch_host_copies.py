"""The port's copies of the reference's host modules, held to the originals.

yams_tpu_torch keeps its own copy of every host module it runs (configs,
tokenizer and sketch, chunkers, native library, storage, the indexes' host
state). Here each copy and its original get the same seeded inputs:

- every copied config dataclass has the reference's fields and defaults
  (the daemon's and the top-level Config among them);
- tokenize, light_stem, the per-text sketch and the batched (native)
  sketch give bit-equal output; chunk_document gives the same chunks;
- FastCDCChunker (native and NumPy) cuts the same boundaries;
- LexicalIndex.build_arrays gives the same arrays, and the query-side term
  vectors the same ids and weights, after the same adds and removals;
- VectorIndex host state is the same after the same mutations;
- query understanding (search/query.py): intents, their leg-weight
  multipliers, qualifiers, fuzzy correction, expansions and routing plans
  are the same for the same queries, and the copy's code is the original's,
  as it is for the SQLite store, the knowledge graph, the search tuner, the
  configs and the service layer's host modules;
- a repository written by the port's ContentStore is read back by the
  reference's, and the other way round, with whole-content dedup across;
- the WordPiece tokenizer gives the reference's ids on both in-repo
  vocabularies, and the fragment arm's sentence picker the same sentences;
  both are the reference's code.
"""

import dataclasses

import numpy as np
import pytest

from yams_tpu.core import config as ref_config
from yams_tpu.embed import chunker as ref_text_chunker
from yams_tpu.embed import simeon as ref_simeon
from yams_tpu.index.lexical_index import LexicalIndex as RefLexical
from yams_tpu.index.vector_index import VectorIndex as RefVector
from yams_tpu.ingest import chunker as ref_chunker
from yams_tpu.search import query as ref_query
from yams_tpu.search.config import SearchEngineConfig as RefSearchConfig
from yams_tpu.storage.content_store import ContentStore as RefStore
from yams_tpu_torch import native
from yams_tpu_torch.core import config as port_config
from yams_tpu_torch.embed import chunker as port_text_chunker
from yams_tpu_torch.embed import simeon as port_simeon
from yams_tpu_torch.index.lexical_index import LexicalIndex
from yams_tpu_torch.index.vector_index import VectorIndex
from yams_tpu_torch.ingest import chunker as port_chunker
from yams_tpu_torch.search import query as port_query
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.storage.content_store import ContentStore

WORDS = ["scheduler", "thread", "preempt", "memory", "chunking", "hashes", "routing",
         "routed", "compression", "snapshots", "indexing", "quickly", "ab", "x-y_z"]


def _texts(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = [" ".join(WORDS[z % len(WORDS)] for z in rng.zipf(1.3, int(rng.integers(1, 60))))
           + ". Second sentence here! Third?" for _ in range(n)]
    return out + ["", "ünïcödé rôuting naïve", "UPPER lower MiXeD 123 4.5", "a\n\nb"]


@pytest.mark.parametrize("name", ["ChunkingConfig", "CompressionConfig", "EmbeddingConfig",
                                  "VectorIndexConfig", "LexicalIndexConfig",
                                  "SearchEngineConfig", "DaemonConfig", "Config"])
def test_config_dataclass_matches_reference(name):
    if name == "SearchEngineConfig":
        port, ref = SearchEngineConfig(), RefSearchConfig()
    else:
        port, ref = getattr(port_config, name)(), getattr(ref_config, name)()
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if name == "EmbeddingConfig":
        assert port.space_id == ref.space_id


def test_tokenize_and_light_stem_match_reference():
    for text in _texts():
        toks = port_simeon.tokenize(text)
        assert toks == ref_simeon.tokenize(text)
        assert port_simeon.tokenize(text, 3) == ref_simeon.tokenize(text, 3)
        assert [port_simeon.light_stem(t) for t in toks] == \
            [ref_simeon.light_stem(t) for t in toks]


@pytest.mark.parametrize("batched", [False, True])
def test_sketch_matches_reference(batched):
    cfg, ref_cfg = port_config.EmbeddingConfig(), ref_config.EmbeddingConfig()
    texts = _texts(seed=1)
    if batched:   # the native sketch where its library builds, with the per-text fallback
        got, want = port_simeon.sketch_texts(texts, cfg), ref_simeon.sketch_texts(texts, ref_cfg)
    else:         # the NumPy path alone
        got = np.stack([port_simeon.sketch_text(t, cfg) for t in texts])
        want = np.stack([ref_simeon.sketch_text(t, ref_cfg) for t in texts])
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_native_sketch_library_builds_alone_and_matches_python():
    """The sketch library needs no zstd; where it builds its counts equal the
    Python path's."""
    assert native.sketch_library() is not None
    cfg = port_config.EmbeddingConfig()
    texts = _texts(seed=2)[:-4]                  # ASCII: the native path serves them
    counts, ok = native.sketch_batch(texts, cfg.sketch_dim, cfg.max_doc_tokens,
                                     cfg.word_ngrams, cfg.char_ngrams)
    assert ok.all()
    want = np.stack([port_simeon.sketch_text(t, cfg) for t in texts])
    assert np.array_equal(np.sign(counts) * np.log1p(np.abs(counts)), want)


@pytest.mark.parametrize("strategy", ["sentence", "paragraph", "fixed_size", "sliding_window",
                                      "recursive", "markdown"])
def test_chunk_document_matches_reference(strategy):
    for text in _texts(10, seed=3):
        got = port_text_chunker.chunk_document(text * 20, strategy)
        want = ref_text_chunker.chunk_document(text * 20, strategy)
        assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]


@pytest.mark.parametrize("use_native", [True, False])
def test_fastcdc_chunker_matches_reference(use_native):
    cfg = port_config.ChunkingConfig(min_size=256, avg_size=1024, max_size=4096)
    ref_cfg = ref_config.ChunkingConfig(min_size=256, avg_size=1024, max_size=4096)
    data = np.random.default_rng(4).bytes(300_000)
    got = port_chunker.FastCDCChunker(cfg, use_native=use_native).chunk_bytes(data)
    want = ref_chunker.FastCDCChunker(ref_cfg, use_native=use_native).chunk_bytes(data)
    assert [(c.ref.hash, c.ref.offset, c.ref.size) for c in got] == \
        [(c.ref.hash, c.ref.offset, c.ref.size) for c in want]
    table = (native.ctypes.c_uint32 * 256)()
    native.sketch_library().ytn_gear_table(table)
    assert np.array_equal(np.asarray(table), port_chunker.gear_table())


def _lexical_ops(idx):
    texts = _texts(60, seed=5)
    for i, t in enumerate(texts):
        idx.add_document(i, t, title=WORDS[i % len(WORDS)])
    yield "add"
    for s in (3, 17, 40):
        idx.remove_document(s)
    yield "remove"
    for i, t in enumerate(texts[:10]):
        idx.add_document(100 + i, t + " routing", title="")   # new slots
        idx.add_document(i, "replaced " + t)                  # re-add an existing slot
    yield "re-add"


def _tail_ratio(arrs, prefilter):
    long_rows = arrs["term_lengths"] > prefilter
    o = arrs["term_offsets"][long_rows].astype(np.int64)
    pi = arrs["postings_impact"]
    return float(np.mean(pi[o + prefilter] / np.maximum(pi[o], 1e-9)))


def test_lexical_build_arrays_match_reference():
    ref, port = RefLexical(), LexicalIndex()
    queries = ["routing scheduler", "compressio snapshots", "x-y_z", "quickly thread preempt"]
    for step, _ in zip(_lexical_ops(ref), _lexical_ops(port)):
        for n in (None, 256):
            r, p = ref.build_arrays(n), port.build_arrays(n)
            assert r.keys() == p.keys(), step
            for key in r:
                assert np.array_equal(np.asarray(p[key]), np.asarray(r[key])), (step, key)
        # the statistic of the reference's CSR (its own cached value can be
        # stale: it keys the cache on id() of a dict a later build may reuse)
        assert port.prefilter_tail_ratio(4) == _tail_ratio(ref.build_arrays(), 4), step
        for q in queries:
            for arm in ("auto", "bm25", "sab_smooth", "keyphrase", "lead_field"):
                ri, rm, ra = ref.query_arm_terms(q, arm=arm)
                pi, pm, pa = port.query_arm_terms(q, arm=arm)
                assert (pa, pi.tolist(), pm.tolist()) == (ra, ri.tolist(), rm.tolist())
        assert port.stats() == ref.stats()


_VECTOR_STATE = ("_vecs", "_valid", "_slots", "_count", "_free", "_rows_by_slot",
                 "_dirty_full", "_dirty_blocks", "_pq_dirty_blocks", "mutation_gen",
                 "capacity", "active_rows")


def test_vector_index_host_state_matches_reference():
    ref = RefVector(dim=32, capacity=200, block_rows=64)
    port = VectorIndex(dim=32, capacity=200, block_rows=64, device="cpu")
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((700, 32)).astype(np.float32)

    def same(step):
        for name in _VECTOR_STATE:
            r, p = getattr(ref, name), getattr(port, name)
            if isinstance(r, np.ndarray):
                assert np.array_equal(p, r), (step, name)
            else:
                assert p == r, (step, name)
        assert port.identity_layout == ref.identity_layout, step
        assert port.stats() == ref.stats(), step
        rows = np.arange(port._count)
        assert np.array_equal(port.slots_of_rows(rows), ref.slots_of_rows(rows)), step

    for idx in (ref, port):
        idx.add(vecs[:150], list(range(150)))
    same("add, identity layout")
    for idx in (ref, port):
        for s in (4, 77, 149):
            idx.remove_doc(s)
        idx._dirty_blocks.clear()
    same("remove")
    for idx in (ref, port):
        idx.add(vecs[150:160], [4] * 5 + [500] * 5)        # reuses freed rows
        idx.add(vecs[160:700], list(range(1000, 1540)))    # grows twice
    same("re-add and grow")
    for idx in (ref, port):
        assert idx.rows_for_slot(500) and idx.remove_doc(500) == 5
    same("remove a multi-row doc")
    blocks = sorted(port._dirty_blocks)
    r_stack, r_starts = ref._gather_blocks(ref._vecs, blocks)
    p_stack, p_starts = port._gather_blocks(port._vecs, blocks)
    assert np.array_equal(p_stack, r_stack) and np.array_equal(p_starts, r_starts)


def _payloads(seed):
    rng = np.random.default_rng(seed)
    text = " ".join(WORDS[z % len(WORDS)] for z in rng.zipf(1.3, 40_000)).encode()
    return [text, rng.bytes(150_000), text[:5_000] + rng.bytes(600)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_content_store_repository_is_shared(tmp_path, monkeypatch, writer):
    """One store writes a repository (compressible text, random bytes, a
    small payload), closes it, and the other store opens the same root:
    every payload reads back, and storing one again is a whole-content
    dedup. Both run their host tiers."""
    monkeypatch.setenv("YAMS_DEVICE_INGEST", "0")
    chunking = dict(min_size=1024, avg_size=4096, max_size=16384)

    def port():
        return ContentStore(tmp_path, port_config.ChunkingConfig(**chunking), device="cpu")

    def ref():
        return RefStore(tmp_path, ref_config.ChunkingConfig(**chunking))

    first, second = (port, ref) if writer == "port" else (ref, port)
    data = _payloads(7)
    store = first()
    hashes = [store.store_bytes(d).content_hash for d in data]
    store.close()
    other = second()
    for h, d in zip(hashes, data):
        assert other.exists(h) and other.retrieve_bytes(h) == d
    again = other.store_bytes(data[0])
    assert again.content_hash == hashes[0] and again.bytes_stored == 0
    assert other.remove(hashes[2]) and not other.exists(hashes[2])
    other.close()


def test_python_routes_without_the_native_libraries(tmp_path):
    """With YAMS_TPU_NO_NATIVE=1 (as where g++ or <zstd.h> is missing) no
    native library loads, and the sketch, the chunker and a host-tier store
    take their Python routes with the same results."""
    import pathlib
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import numpy as np
        from yams_tpu_torch import native
        from yams_tpu_torch.core.config import ChunkingConfig, EmbeddingConfig
        from yams_tpu_torch.embed.simeon import sketch_texts
        from yams_tpu_torch.ingest.chunker import FastCDCChunker
        from yams_tpu_torch.storage.content_store import ContentStore
        assert native.sketch_library() is None and native.ingest_library() is None
        np.save({str(tmp_path / "sketch.npy")!r},
                sketch_texts(["thread scheduler", "routing and chunking"], EmbeddingConfig()))
        data = np.random.default_rng(8).bytes(200_000)
        cfg = ChunkingConfig(1024, 4096, 16384)
        print(FastCDCChunker(cfg).boundaries(data)[:3])
        cs = ContentStore({str(tmp_path / "store")!r}, cfg, device="cpu")
        h = cs.store_bytes(data).content_hash
        assert cs.retrieve_bytes(h) == data
        cs.close()
    """)
    env = dict(__import__("os").environ, YAMS_TPU_NO_NATIVE="1", YAMS_DEVICE_INGEST="0")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240, env=env, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    data = np.random.default_rng(8).bytes(200_000)
    cfg = port_config.ChunkingConfig(1024, 4096, 16384)
    assert proc.stdout.strip() == str(port_chunker.FastCDCChunker(cfg).boundaries(data)[:3])
    want = port_simeon.sketch_texts(["thread scheduler", "routing and chunking"],
                                    port_config.EmbeddingConfig())
    assert np.array_equal(np.load(tmp_path / "sketch.npy"), want)


QUERIES = ["how does the scheduler preempt threads", "yams_tpu/search/engine.py",
           "MyClass", "memory", "chunking hashes quickly", "what is routing",
           "tag:ops path:src/*.py collection:docs type:keyword scheduler memory",
           'tag:"two words" routed compression snapshots', "", "x-y_z ab",
           "schedulr memroy chunkng", "ünïcödé rôuting naïve query"]


def test_query_understanding_matches_reference():
    vocab = {w: i + 1 for i, w in enumerate(WORDS)}
    ref_fix, port_fix = ref_query.FuzzyCorrector(vocab), port_query.FuzzyCorrector(vocab)
    for q in QUERIES:
        intent = port_query.classify_intent(q)
        assert intent == ref_query.classify_intent(q), q
        assert port_query.route_mode(intent) == ref_query.route_mode(intent)
        assert port_query.intent_weight_multipliers(intent) == \
            ref_query.intent_weight_multipliers(intent)
        assert dataclasses.astuple(port_query.parse_qualifiers(q)) == \
            dataclasses.astuple(ref_query.parse_qualifiers(q)), q
        assert port_fix.correct_query(q) == ref_fix.correct_query(q), q
        assert port_query.subphrase_expansions(q) == ref_query.subphrase_expansions(q)
        assert dataclasses.astuple(port_query.build_routing_plan(q, vocab, port_fix)) == \
            dataclasses.astuple(ref_query.build_routing_plan(q, vocab, ref_fix)), q
    assert port_query.intent_weight_multipliers("other") == (1.0, 1.0)


@pytest.mark.parametrize("with_stats", [False, True])
def test_prf_expansion_matches_reference(with_stats):
    texts = _texts(12, seed=5)
    kw = {}
    if with_stats:
        kw = dict(global_df={w: 3 + i for i, w in enumerate(WORDS)}, n_docs=500)
    for q in QUERIES[:6]:
        assert port_query.prf_expansion(q, texts, **kw) == \
            ref_query.prf_expansion(q, texts, **kw), q


def test_query_module_is_the_reference_code():
    """Past the module docstring the copy is the original, line for line."""
    import ast
    import inspect

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]                 # the docstring
        return ast.dump(tree)

    assert body(port_query) == body(ref_query)


@pytest.mark.parametrize("name", [
    "metadata.db", "metadata.kg", "search.tuner",
    # the service layer's host modules
    "core.config", "metadata.repository", "metadata.tree", "metadata.recovery",
    "ingest.detection", "ingest.content_handlers", "services.extraction",
    "services.filters", "services.document_service", "services.symbol_service",
    "services.code_parser", "services.graph_service", "utils.textrank",
    "services.indexing_service", "services.search_service", "utils.minhash",
    "daemon.protocol", "daemon.client", "daemon.aclient", "embed.batcher",
    "daemon.components",
    # the repair service's host modules
    "utils.tda", "storage.compression_recovery",
    # grep, sessions, watch, downloads and their object backends, the plugin
    # host and MCP
    "utils.ahocorasick", "services.grep_service", "services.session_service",
    "services.watch_service", "services.download_service", "storage.backends",
    "storage.remote_checkpoint", "plugins.spec", "plugins.host", "plugins.graph_adapter",
    "plugins.pdf_extract", "plugins.native_host",
    # the retrieval metrics and the BEIR datasets of the trainers and evals
    "utils.metrics", "utils.beir"])
def test_copied_module_is_the_reference_code(name):
    """The SQLite store, the knowledge graph, the search tuner, the configs
    and the service layer's host modules (metadata, detection and
    extraction, the document, symbol, graph, indexing and search services,
    the daemon's protocol, clients and components, the grep, session,
    watch and download services, the object backends and remote
    checkpoints, the plugin host's spec, subprocess and native hosts, graph
    adapter and PDF extractor, the retrieval metrics and BEIR datasets):
    past the module docstring each copy is the original, line for line."""
    import ast
    import importlib
    import inspect

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]                 # the docstring
        return ast.dump(tree)

    assert body(importlib.import_module(f"yams_tpu_torch.{name}")) == \
        body(importlib.import_module(f"yams_tpu.{name}"))


def _defs(mod, names):
    """{name: AST dump} of top-level functions/classes and Class.method
    definitions of a module."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(mod))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        out[f"{node.name}.{sub.name}"] = ast.dump(sub)
    return {n: out[n] for n in names}


TOPOLOGY_HOST = ["auto_k", "TopologyArtifacts", "RouteSelection", "pick_representatives",
                 "TopologyTuner", "TopologyEngine._attach_reps", "TopologyEngine.build_auto",
                 "TopologyEngine.cluster_scores", "TopologyEngine.select_routes",
                 "TopologyEngine.route", "TopologyEngine.member_rows",
                 "TopologyEngine.routed_row_mask"]


@pytest.mark.parametrize("name", TOPOLOGY_HOST)
def test_topology_host_half_is_the_reference_code(name):
    """The host half of index/topology.py (auto-k, the artifacts, the
    representatives, routing and the topology tuner) is the reference's,
    definition for definition."""
    from yams_tpu.index import topology as ref_topology
    from yams_tpu_torch.index import topology as port_topology

    assert _defs(port_topology, [name]) == _defs(ref_topology, [name])


@pytest.mark.parametrize("name", ["LexicalIndex.mine_concepts",
                                  "LexicalIndex.docs_with_bigram"])
def test_concept_miner_is_the_reference_code(name):
    from yams_tpu.index import lexical_index as ref_lexical
    from yams_tpu_torch.index import lexical_index as port_lexical

    assert _defs(port_lexical, [name]) == _defs(ref_lexical, [name])


def test_concept_miner_matches_reference():
    """The same adds give the same mined concepts and bigram postings."""
    rng = np.random.default_rng(8)
    phrases = ["storage engines", "raft consensus", "page cache", "write ahead"]
    port, ref = LexicalIndex(), RefLexical()
    for slot in range(60):
        words = [WORDS[z % len(WORDS)] for z in rng.zipf(1.3, 12)]
        text = " ".join(words + [phrases[slot % 4]] * int(rng.integers(1, 3)))
        port.add_document(slot, text)
        ref.add_document(slot, text)
    got, want = port.mine_concepts(min_df=2), ref.mine_concepts(min_df=2)
    assert got == want and len(got) >= 4
    for a, b, _pmi, _df in got:
        assert port.docs_with_bigram(a, b) == ref.docs_with_bigram(a, b)


@pytest.mark.parametrize("name", ["hf_encoder:WordPieceTokenizer",
                                  "fragment_index:top_sentences"])
def test_embedding_host_code_is_the_reference_code(name):
    """The WordPiece tokenizer and the fragment arm's sentence picker are
    the reference's, definition for definition."""
    import importlib

    module, definition = name.split(":")
    package = "embed" if module == "hf_encoder" else "index"
    port_mod = importlib.import_module(f"yams_tpu_torch.{package}.{module}")
    ref_mod = importlib.import_module(f"yams_tpu.{package}.{module}")
    names = [definition] + ([f"{definition}.{m}" for m in
                             ("__init__", "_basic_split", "_wordpiece", "encode")]
                            if definition == "WordPieceTokenizer" else [])
    assert _defs(port_mod, names) == _defs(ref_mod, names)


@pytest.mark.parametrize("checkpoint", ["realtext_bert_d192.npz", "synthetic_bert_d128.npz"])
def test_wordpiece_ids_match_reference(checkpoint):
    """Both in-repo vocabularies: the same ids for the same seeded text, at
    several max lengths (words longer than 100 characters go to [UNK])."""
    from yams_tpu.embed.hf_encoder import WordPieceTokenizer as RefTokenizer
    from yams_tpu_torch.embed.hf_encoder import WordPieceTokenizer
    from yams_tpu_torch.embed.provider import DEFAULT_HF_CHECKPOINT

    z = np.load(DEFAULT_HF_CHECKPOINT.parent / checkpoint)
    vocab = [str(v) for v in z["vocab"]]
    port, ref = WordPieceTokenizer(vocab), RefTokenizer(vocab)
    texts = _texts(60, seed=3) + ["x" * 150 + " tail", "Punctuation, (brackets) & co!"]
    for text in texts:
        for max_len in (8, 32, 128):
            assert port.encode(text, max_len) == ref.encode(text, max_len), text


def test_top_sentences_match_reference():
    from yams_tpu.index.fragment_index import top_sentences as ref_top
    from yams_tpu_torch.index.fragment_index import top_sentences

    rng = np.random.default_rng(5)
    for text in _texts(30, seed=4):
        doc = "\n\n".join(text for _ in range(int(rng.integers(1, 4)))) + "\n# heading line here"
        for n in (1, 3, 6):
            assert top_sentences(doc, n=n) == ref_top(doc, n=n)


# the definitions each ported module keeps from the reference: all of them
# except the named departures (the module docstrings list them)
KEPT = {
    "embed.ner": ["_WORD_RE", "word_tokenize", "_ngram_ids", "_case_feats", "featurize",
                  "identifier_shape", "ambiguous_shape", "NerConfig", "NerModel.num_tags",
                  "NerModel.extract", "NeuralEntityExtractor"],
    "plugins.manager": ["PluginManager.trusted_paths", "PluginManager.trust",
                        "PluginManager.untrust", "PluginManager.scan",
                        "PluginManager.load_module", "PluginManager.load_trusted",
                        "PluginManager.health", "PluginManager.list"],
    "cli.auth": ["_b64url", "_b64url_dec", "AuthStore.__init__", "AuthStore._load",
                 "AuthStore._save", "AuthStore.list_keys", "AuthStore.revoke",
                 "AuthStore.token", "AuthStore.verify_token", "AuthStore.api_key",
                 "AuthStore.verify_api_key", "cmd_auth"],
    "plugins.neural_ner": [],
    "mcp.server": [],
}


def _defs_and_assigns(mod, names):
    """_defs, with module-level assignments (`_WORD_RE = ...`) too."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(mod))
    assigns = {t.id: ast.dump(node) for node in tree.body if isinstance(node, ast.Assign)
               for t in node.targets if isinstance(t, ast.Name)}
    defs = _defs(mod, [n for n in names if n not in assigns])
    return {n: assigns.get(n, defs.get(n)) for n in names}


@pytest.mark.parametrize("name", list(KEPT))
def test_ported_modules_keep_the_reference_code(name):
    """NER's host half and its output assembly, the plugin manager's trust
    list, discovery and introspection (its `unload` also removes the
    plugin's provider: a departure), and `yams auth` (all but keygen)
    are the reference's, definition for definition; the bundled NER
    plugin's body differs only in its device key and its description, and
    the MCP server only in the package whose provider registry it lists."""
    import importlib

    port = importlib.import_module(f"yams_tpu_torch.{name}")
    ref = importlib.import_module(f"yams_tpu.{name}")
    if KEPT[name]:
        assert _defs_and_assigns(port, KEPT[name]) == _defs_and_assigns(ref, KEPT[name])
    elif name == "mcp.server":
        import ast
        import inspect

        def body(src):
            tree = ast.parse(src)
            tree.body = tree.body[1:]                 # the docstring
            return ast.dump(tree)

        want = inspect.getsource(ref).replace('"yams_tpu.embed.provider"',
                                              '"yams_tpu_torch.embed.provider"')
        assert body(inspect.getsource(port)) == body(want)
    else:
        import inspect

        got = inspect.getsource(port.yams_plugin).replace(
            'NerModel.load(path, device=cfg.get("device", "cuda"))', "NerModel.load(path)")
        want = inspect.getsource(ref.yams_plugin).replace("(flax label", "(torch label")
        assert got == want


def _module_from(path):
    """A reference script or helper, imported from its file (once)."""
    import importlib.util
    import pathlib
    import sys

    path = pathlib.Path(__file__).resolve().parents[1] / path
    name = f"ref_{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


# the port's copies of the reference's real-text helper and training and
# evaluation scripts: the definitions each keeps unchanged (the module
# docstrings list the departures: the root, device and output arguments)
SCRIPT_KEPT = {
    ("scripts.realtext", "tests/benchmarks/realtext.py"): [
        "MAX_DOC_CHARS", "MAX_DOCS", "_HEADING_RE", "_SYMBOL_RE", "_CAMEL_RE",
        "RealTextEval", "camel_split", "_chunk_text"],
    ("scripts.train_ner_default", "scripts/train_ner_default.py"): [
        "CTX", "HARD_STARTS", "CAMEL_PARTS", "SNAKE_PARTS", "PROPER_PARTS", "_entity",
        "synth_example", "f1"],
    ("scripts.eval_ner_realtext", "scripts/eval_ner_realtext.py"): [
        "MAX_SENTENCES", "SEED", "_FENCE_RE", "_INLINE_CODE_RE", "_MD_NOISE_RE",
        "_SENT_SPLIT_RE", "_TOKEN_RE", "evaluate"],
    ("scripts.train_encoder", "scripts/train_encoder.py"): [
        "SUFFIX_PIECES", "build_vocab"],
    ("scripts.train_encoder_realtext", "scripts/train_encoder_realtext.py"): [
        "MAX_LEN", "SUFFIX_PIECES", "VOCAB_CAP", "build_vocab"],
}


@pytest.mark.parametrize("port_name,original", list(SCRIPT_KEPT), ids=lambda x: x)
def test_ported_scripts_keep_the_reference_code(port_name, original):
    """The real-text helper's dataset code, the default NER script's
    generator and token F1, the real-text NER eval's regexes and scoring,
    and the encoder scripts' vocabularies are the reference's, definition
    for definition."""
    import importlib

    port = importlib.import_module(f"yams_tpu_torch.{port_name}")
    names = SCRIPT_KEPT[(port_name, original)]
    assert _defs_and_assigns(port, names) == _defs_and_assigns(_module_from(original), names)


def test_ported_scripts_keep_the_reference_constants():
    """The encoder scripts' shapes and the trainers' hyperparameters."""
    from yams_tpu_torch.scripts import train_encoder, train_encoder_realtext, train_ner_default

    ref = _module_from("scripts/train_encoder.py")
    assert (train_encoder.DIM, train_encoder.LAYERS, train_encoder.HEADS,
            train_encoder.INTERMEDIATE, train_encoder.MAX_LEN) == \
        (ref.DIM, ref.LAYERS, ref.HEADS, ref.INTERMEDIATE, ref.MAX_LEN)
    rt = _module_from("scripts/train_encoder_realtext.py")
    assert (train_encoder_realtext.QT, train_encoder_realtext.DT) == (rt.QT, rt.DT)
    assert train_encoder_realtext.shape_from_env() == {
        "dim": rt.DIM, "layers": rt.LAYERS, "heads": rt.HEADS, "intermediate": rt.INTERMEDIATE}
    cfg = train_ner_default.CONFIG
    assert (cfg.dm, cfg.heads, cfg.layers, cfg.window, cfg.labels) == (64, 4, 2, 32, ("entity",))
    assert (train_ner_default.STEPS, train_ner_default.LR, train_ner_default.BATCH) == \
        (1200, 3e-3, 32)
