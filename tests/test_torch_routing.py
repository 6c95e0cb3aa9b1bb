"""Topology routing in the port's SearchEngine, on the CPU.

- Cross-package: a yams_tpu engine and a port engine get the same adds (the
  CSR lexical leg, as in test_torch_engine.py) and the same topology (built
  on both after the same number of searches, so with the same k-means seed:
  the artifacts are equal here; the port then takes the reference's through
  `convert.load_topology`, so routing is compared on equal artifacts). For
  each policy (off, shadow, narrow, augment) and B in {1, 8, 16}, with the
  abstention gate at its default and at 0 (the narrow gather tier then
  engages at B <= 8): the same ids, scores within 1e-4 (an id swap is
  allowed only between scores within 1e-4, and is named), the same
  topology counters and trace keys, the same `route_calibration()`, and
  after the same shadow traffic the same auto-promotion.
- The reference's own routing contracts (tests/test_routing_contracts.py:
  narrow within the allowed set, augment keeps the global ranking, shadow
  is observationally identical, narrow preserves a covered protected set,
  an empty route is the global scan, routed clusters are known) and its
  topology routing, hardening and replay cases
  (tests/test_tuning_topology.py: the gather tier engages at small B and
  falls back above the cap or under filters; representatives, seed votes,
  the adaptive gap, abstention, the budget clamp, calibration, promotion,
  determinism replay) run against the port engine: the reference's test
  classes, with their module's SearchEngine set to the port's on the CPU,
  and port-side copies of the cases that import the reference's topology
  classes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_routing_contracts as contracts
import test_tuning_topology as tuning
from yams_tpu.core.config import LexicalIndexConfig as RefLexical
from yams_tpu.search.config import SearchEngineConfig as RefConfig
from yams_tpu.search.engine import SearchEngine as RefEngine
from yams_tpu_torch.convert import load_topology
from yams_tpu_torch.core.config import LexicalIndexConfig
from yams_tpu_torch.index.topology import (TopologyArtifacts, TopologyEngine,
                                           TopologyTuner)
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.engine import SearchEngine

CPU = torch.device("cpu")
TOPICS = contracts.TOPICS + [["raft", "quorum", "leader", "append", "commit"]]
COUNTERS = ("topology_routes", "topology_abstained", "topology_budget_clamped",
            "topology_promotions")


def _corpus(n=100, seed=5):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = rng.choice(TOPICS[i % len(TOPICS)], size=int(rng.integers(8, 24)))
        other = rng.choice(TOPICS[(i + 1) % len(TOPICS)], size=2)
        docs.append((100 + i, " ".join(words) + ". " + " ".join(other) + ".",
                     f"{TOPICS[i % len(TOPICS)][0]} note {i}"))
    queries = [" ".join(rng.choice(TOPICS[j % len(TOPICS)], size=int(rng.integers(1, 4))))
               for j in range(16)]
    return docs, queries


def _pair(policy, margin=None, **knobs):
    docs, queries = _corpus()
    kw = dict(batch_pad=4, topology_policy=policy, **knobs)
    if margin is not None:
        kw["topology_narrow_min_boundary_margin"] = margin
    ref = RefEngine(RefConfig(**kw), lexical=RefLexical(packed_max_entries=0))
    port = SearchEngine(SearchEngineConfig(**kw),
                        lexical=LexicalIndexConfig(packed_max_entries=0), device=CPU)
    ref.add_documents(docs)
    port.add_documents(docs)
    ref.rebuild_topology()
    port.rebuild_topology()
    # the builds agree (representatives aside: rows tied in similarity to
    # their centroid, such as duplicate chunks, may be picked in another
    # order when the centroids differ by an ulp); routing then runs on the
    # reference's artifacts
    for name in ("assignments", "cluster_sizes"):
        assert np.array_equal(getattr(port.topology.artifacts, name),
                              getattr(ref.topology.artifacts, name)), name
    for name in ("centroids", "cohesion"):
        assert np.allclose(getattr(port.topology.artifacts, name),
                           getattr(ref.topology.artifacts, name), atol=1e-5, rtol=0), name
    load_topology(port, ref)
    return ref, port, queries


def _same_results(want, got, atol=1e-4):
    for qi, (w, g) in enumerate(zip(want, got)):
        wi, gi = [r.doc_id for r in w], [r.doc_id for r in g]
        assert len(wi) == len(gi), qi
        for j, (a, b) in enumerate(zip(wi, gi)):
            if a != b:   # only a near-tie may swap: name it
                ws = {r.doc_id: r.score for r in w}
                assert b in ws and abs(ws[a] - ws[b]) <= atol, \
                    f"query {qi} rank {j}: {a} vs {b} is not a tie"
        np.testing.assert_allclose([r.score for r in g], [r.score for r in w],
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("policy,margin", [
    ("off", None), ("augment", None), ("shadow", None), ("shadow", 0.0),
    ("narrow", None), ("narrow", 0.0)],
    ids=["off", "augment", "shadow-gate", "shadow-no_gate", "narrow-gate",
         "narrow-no_gate"])
def test_search_matches_reference_under_each_policy(policy, margin, B):
    ref, port, queries = _pair(policy, margin)
    for lo in range(0, 16 if B > 1 else 4, B):
        batch = queries[lo:lo + B]
        _same_results(ref.search_batch(batch, k=10), port.search_batch(batch, k=10))
        for key in ("narrow_gather_rows", "shadow_agreement"):
            assert (key in port.last_trace) == (key in ref.last_trace), key
            if key in ref.last_trace:
                assert port.last_trace[key] == pytest.approx(ref.last_trace[key])
    for c in COUNTERS:
        assert port._stats[c] == ref._stats[c], c
    assert port._stats["topology_shadow_agree"] == \
        pytest.approx(ref._stats["topology_shadow_agree"], abs=1e-12)
    assert port.route_calibration() == ref.route_calibration()
    if policy == "narrow" and margin == 0.0 and B <= 8:
        assert "narrow_gather_rows" in port.last_trace
    if policy == "off":
        assert port._stats["topology_routes"] == 0


@pytest.mark.parametrize("max_mpt", [1000, 0])
def test_auto_promotion_matches_reference(max_mpt):
    ref, port, queries = _pair("shadow", topology_auto_promote=True,
                               topology_calibration_min_queries=5,
                               topology_calibration_max_mpt=max_mpt)
    for q in queries:
        _same_results(ref.search_batch([q], k=5), port.search_batch([q], k=5))
        assert port.config.topology_policy == ref.config.topology_policy
        assert port.route_calibration() == ref.route_calibration()
    assert port._stats["topology_promotions"] == ref._stats["topology_promotions"]
    if max_mpt == 1000:
        assert port.config.topology_policy == "narrow"


# -- the reference's own test classes, run against the port engine ----------

def _port_engine(config=None, embedding=None, vector=None, lexical=None, **_):
    cfg = SearchEngineConfig(**dataclasses.asdict(config)) if config else None
    return SearchEngine(cfg, embedding=embedding, vector=vector, lexical=lexical,
                        device=CPU)


@pytest.fixture(autouse=True)
def _port_engines(monkeypatch):
    monkeypatch.setattr(contracts, "SearchEngine", _port_engine)
    monkeypatch.setattr(tuning, "SearchEngine", _port_engine)


class TestPortRoutingContracts(contracts.TestRoutingContracts):
    pass


class TestPortEmptyRouteFallback(contracts.TestEmptyRouteFallback):
    pass


class TestPortRouterArtifacts(contracts.TestRouterArtifacts):
    def test_engine_is_the_port(self):
        assert isinstance(contracts.build_engine("off", seed=0), SearchEngine)


class TestPortTopologyRouting(tuning.TestTopologyRouting):
    def test_topology_tuner_selects_and_learns(self):
        eng = tuning.make_engine()
        eng.topology_tuner = TopologyTuner(reward_mode="hybrid")
        for _ in range(4):
            eng.rebuild_topology()
        snap = eng.topology_tuner.snapshot()
        assert sum(a["plays"] for a in snap["arms"].values()) == 4
        assert all(a["plays"] >= 1 for a in snap["arms"].values())
        assert all(0.0 <= r <= 1.5 for _, r in eng.topology_tuner.history)
        assert eng.search("kernel mutex", k=3)

    def test_topology_tuner_reward_modes(self):
        rng = np.random.default_rng(0)
        v = rng.standard_normal((64, 16)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        arts = TopologyEngine(iters=4, device=CPU).build(v, np.ones(64, np.float32))
        rewards = {m: TopologyTuner(reward_mode=m).reward_of(arts)
                   for m in ("geometric", "persistence", "hybrid")}
        assert rewards["hybrid"] == pytest.approx(
            0.5 * (rewards["geometric"] + rewards["persistence"]))


class TestPortRoutingHardening(tuning.TestRoutingHardening):
    def test_representatives_recover_elongated_cluster(self):
        D = 8
        edge = np.zeros(D, np.float32); edge[1] = 1.0
        c0 = np.zeros(D, np.float32); c0[0] = 1.0
        c1 = (c0 + edge) / np.sqrt(2)
        eng = TopologyEngine(representatives=2, device=CPU)
        eng.artifacts = TopologyArtifacts(
            centroids=np.stack([c0, c1]),
            assignments=np.array([0, 0, 1, 1], np.int32),
            cluster_sizes=np.array([2, 2]), epoch=0,
            cohesion=np.ones(2, np.float32),
            rep_vectors=np.stack([np.stack([c0, edge]), np.stack([c1, c1])]),
            rep_counts=np.array([2, 2], np.int32))
        q = 0.95 * edge + 0.05 * c0
        q /= np.linalg.norm(q)
        assert eng.select_routes(q, max_clusters=1).clusters[0] == 0
        eng.artifacts.rep_vectors = None
        assert eng.select_routes(q, max_clusters=1).clusters[0] == 1

    def test_seed_votes_steer_routing(self):
        eng = tuning.make_engine(policy="narrow")
        eng.rebuild_topology()
        eng.config.topology_sparse_dense_alpha = 1.0
        seeds = eng._lexical_seed_rows("tomato basil pasta")
        assert seeds is not None and len(seeds)
        a = eng.topology.artifacts
        seed_clusters = set(int(c) for c in a.assignments[seeds] if c >= 0)
        sel = eng.topology.select_routes(np.zeros(eng.provider.dim, np.float32),
                                         seeds, alpha=1.0, max_clusters=1)
        assert int(sel.clusters[0]) in seed_clusters


class TestPortWeakQueryFanout(tuning.TestWeakQueryFanout):
    pass
