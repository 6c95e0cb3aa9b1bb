"""The late-interaction (ColBERT) tier and the fragment-geometry arm of the
port (index/token_index.py, index/fragment_index.py, the engine's stages)
against the reference's, JAX on the CPU.

- TokenIndex and FragmentIndex: after the same sets, growths and removals
  the host arrays are the reference's bit for bit (the fragment rows within
  1e-5: each package's f32 hf encoder embeds the sentences), and the
  device gather gives the reference's tokens and masks.
- The engine with the hf provider (f32 compute in both packages, the CSR
  lexical leg, `packed_max_entries=0`, as ROADMAP's hazards say) and the
  ColBERT tier, the fragment arm or both: the reference's top-k equals the
  port's, scores within 1e-4 (`chip_smoke.results_agree`, ties named), and
  the trace carries each stage's milliseconds.
- The reference's own scenario: a doc holding the query's exact tokens
  rises to the top under the ColBERT tier (simeon and hf providers), and
  removing it takes it out of every index.
- Semantic chunking: the same chunks and vectors as the reference's.
"""

import numpy as np
import pytest
import torch

from chip_smoke import results_agree
from yams_tpu.core.config import EmbeddingConfig as RefEmbedding
from yams_tpu.core.config import LexicalIndexConfig as RefLexical
from yams_tpu.core.config import VectorIndexConfig as RefVector
from yams_tpu.embed.provider import HFProvider as RefHF
from yams_tpu.index.fragment_index import FragmentIndex as RefFragments
from yams_tpu.index.token_index import TokenIndex as RefTokens
from yams_tpu.search.config import SearchEngineConfig as RefConfig
from yams_tpu.search.engine import SearchEngine as RefEngine
from yams_tpu_torch.core.config import EmbeddingConfig, LexicalIndexConfig, VectorIndexConfig
from yams_tpu_torch.embed.provider import HFProvider
from yams_tpu_torch.index.fragment_index import FragmentIndex
from yams_tpu_torch.index.token_index import TokenIndex
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.engine import SearchEngine

CPU = torch.device("cpu")
WORDS = ("storage engine block cache page write ahead log raft consensus leader "
         "election replica snapshot merkle tree diff rename file search query "
         "index vector token gradient descent optimizer converges learning rate "
         "network packet routing fabric frame switch address traffic").split()


def _unit(n, d, seed):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _corpus(n_docs=40, n_queries=8, seed=0):
    rng = np.random.default_rng(seed)

    def sentence():
        return " ".join(WORDS[z % len(WORDS)]
                        for z in rng.zipf(1.2, int(rng.integers(5, 12)))).capitalize() + "."

    docs = [(100 + i, " ".join(sentence() for _ in range(int(rng.integers(1, 5)))),
             " ".join(WORDS[z % len(WORDS)] for z in rng.zipf(1.5, 2))) for i in range(n_docs)]
    queries = [" ".join(WORDS[z % len(WORDS)] for z in rng.zipf(1.2, int(rng.integers(2, 5))))
               for _ in range(n_queries)]
    return docs, queries


@pytest.fixture(scope="module")
def hf():
    """The hf provider of each package, f32 compute."""
    return RefHF(compute_dtype="float32"), HFProvider(compute_dtype="float32", device="cpu")


def test_token_index_state_and_gather_match_reference():
    ref, port = RefTokens(dim=8, max_tokens=4, capacity=2), \
        TokenIndex(dim=8, max_tokens=4, capacity=2, device="cpu")
    for idx in (ref, port):
        idx.set_doc(0, _unit(3, 8, 0))
        idx.set_doc(5, _unit(6, 8, 1))          # grows, keeps the first 4
        idx.set_doc(2, np.zeros((0, 8), np.float32))
        idx.set_doc(0, _unit(2, 8, 2))          # replaced
        idx.remove_doc(5)
        idx.remove_doc(40)                      # beyond capacity: nothing
        idx.set_doc(9, _unit(1, 8, 3))
    assert (port.capacity, port.doc_count) == (ref.capacity, ref.doc_count) == (16, 10)
    np.testing.assert_array_equal(port._tok, ref._tok)
    np.testing.assert_array_equal(port._mask, ref._mask)
    slots = np.array([[0, 5, -1, 9], [2, 16, 9, 0]], np.int32)
    import jax.numpy as jnp
    rt, rm = ref.gather(jnp.asarray(slots))
    pt, pm = port.gather(torch.from_numpy(slots))
    assert pt.dtype == torch.bfloat16 and pm.dtype == torch.float32
    np.testing.assert_array_equal(pt.float().numpy(), np.asarray(rt, np.float32))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


def test_fragment_index_matches_reference(hf):
    ref_p, port_p = hf
    docs, _ = _corpus(12, seed=3)
    ref, port = RefFragments(dim=ref_p.dim, max_tokens=6, capacity=4), \
        FragmentIndex(dim=port_p.dim, max_tokens=6, capacity=4, device="cpu")
    for slot, (_, text, _) in enumerate(docs + [(0, "too short.", "")]):
        assert port.set_doc_text(slot, text, port_p, n_sentences=3) == \
            ref.set_doc_text(slot, text, ref_p, n_sentences=3)
    port.remove_doc(4)
    ref.remove_doc(4)
    assert (port.capacity, port.doc_count) == (ref.capacity, ref.doc_count)
    np.testing.assert_array_equal(port._mask, ref._mask)
    np.testing.assert_allclose(port._tok, ref._tok, atol=1e-5, rtol=0)


def _engines(hf, tiers):
    """A reference and a port engine with the hf provider and the given
    tiers, fed the same documents."""
    ref_p, port_p = hf
    docs, queries = _corpus()
    ref = RefEngine(config=RefConfig(batch_pad=4), lexical=RefLexical(packed_max_entries=0),
                    provider=ref_p)
    port = SearchEngine(config=SearchEngineConfig(batch_pad=4),
                        lexical=LexicalIndexConfig(packed_max_entries=0), provider=port_p,
                        device=CPU)
    for eng in (ref, port):
        if "late" in tiers:
            eng.enable_late_interaction()
        if "fragments" in tiers:
            eng.enable_fragment_geometry()
        eng.add_documents(docs)
    return ref, port, queries


@pytest.mark.parametrize("tiers", [("late",), ("fragments",), ("late", "fragments")],
                         ids=["late", "fragments", "both"])
def test_engine_tiers_match_reference(hf, tiers):
    ref, port, queries = _engines(hf, tiers)
    want = ref.search_batch(queries, k=10)
    got = port.search_batch(queries, k=10)
    results_agree(f"hf engine, {'+'.join(tiers)}", got, want, atol=1e-4)
    stages = port.last_trace["stages"]
    assert ("late_interaction_ms" in stages) == ("late" in tiers)
    assert ("fragment_geometry_ms" in stages) == ("fragments" in tiers)
    # keyword mode skips both stages, as in the reference
    port.search_batch(queries[:2], mode="keyword")
    assert not {"late_interaction_ms", "fragment_geometry_ms"} & set(port.last_trace["stages"])


def _small(provider=None):
    return SearchEngine(config=SearchEngineConfig(batch_pad=4),
                        embedding=EmbeddingConfig(dim=64, sketch_dim=512),
                        vector=VectorIndexConfig(dim=64, capacity=256, block_rows=128),
                        lexical=LexicalIndexConfig(postings_window=64), provider=provider,
                        device=CPU)


@pytest.mark.parametrize("provider", ["simeon", "hf"])
def test_rerank_promotes_exact_token_doc(hf, provider):
    eng = _small(None if provider == "simeon" else hf[1])
    eng.enable_late_interaction()
    for i in range(12):
        eng.add_document(i, f"filler doc {i} miscellaneous words here")
    eng.add_document(50, "gradient descent optimizer converges")
    res = eng.search("gradient descent", k=5)
    assert res[0].doc_id == 50
    assert "late_interaction_ms" in eng.last_trace["stages"]
    slot = eng._slot_by_doc[50]
    assert eng.remove_document(50)
    assert eng.token_index._mask[slot].sum() == 0
    assert 50 not in {r.doc_id for r in eng.search("gradient descent", k=5)}


def test_tiers_are_off_by_default():
    eng = _small()
    eng.add_document(0, "some document body. It has two sentences here.")
    eng.search("document", k=2)
    assert eng.token_index is None and eng.fragment_index is None
    assert not {"late_interaction_ms", "fragment_geometry_ms"} & set(eng.last_trace["stages"])


def test_semantic_chunking_matches_reference(hf):
    ref_p, port_p = hf
    docs, _ = _corpus(10, seed=5)
    docs = [(d, "\n\n".join([body] * 3), t) for d, body, t in docs]
    ref = RefEngine(config=RefConfig(batch_pad=4), provider=ref_p,
                    vector=RefVector(dim=ref_p.dim), embedding=RefEmbedding())
    port = SearchEngine(config=SearchEngineConfig(batch_pad=4), provider=port_p, device=CPU)
    assert port.add_documents(docs, chunk_strategy="semantic") == \
        ref.add_documents(docs, chunk_strategy="semantic")
    n = ref.vector_index._count
    np.testing.assert_array_equal(port.vector_index._slots[:n], ref.vector_index._slots[:n])
    np.testing.assert_allclose(port.vector_index._vecs[:n], ref.vector_index._vecs[:n],
                               atol=1e-5, rtol=0)
