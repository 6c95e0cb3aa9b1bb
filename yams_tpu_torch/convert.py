"""Carry an engine's index state across: the part that plays the weights.

`state_from_jax(engine)` reads the host state of a yams_tpu SearchEngine
(or of a port engine, which keeps the same host layout) into a flat dict of
NumPy arrays: vector rows, validity and row -> slot map, free rows, the
slot <-> doc maps, titles, the lexical vocabulary, per-doc term
frequencies, doc lengths and width, the rows of the entity side index
(KG node label vectors, slot == node id), the search tuner's per-profile
arm statistics when the engine has a tuner, and, when the index has PQ
codebooks, the PQ state (centroids, capacity-sized codes, packing, group,
rerank factor, selection width, rows at the last build).
`load_state(port_engine, state)` installs it into a port engine (tuner
statistics only into an engine given a SearchTuner, as the source engine
was), after which both engines compute the same searches with the same
codebook and choose the same tuner arms. Postings, impacts and device views
are derived state and are rebuilt on the next search. The KG itself lives
in its SQLite file, which both packages open.

`topology_from_jax(topology)` carries a TopologyEngine's artifacts, and
`load_topology(port_engine, engine)` an engine's whole topology surface
(the topology, its tuner, the route-risk calibration), so routing compares
on equal artifacts.

Model weights: `hf_state_from_npz(path)` reads a converted BERT checkpoint
(scripts/convert_hf_encoder.py's flat npz) into the state dict of the
port's `embed.hf_encoder.BertEncoder` (the same names with "." for "/"),
and `neural_state_from_flax(params)` turns the reference `NeuralEncoder`'s
flax parameter tree, as NumPy arrays, into the state dict of the port's
`embed.encoder.NeuralEncoderModule`; `ner_state_from_flax(params)` and
`ner_flax_from_state(state)` carry the reference NER tagger's flax tree to
the port's `embed.ner.Tagger` and back.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.pq import PQCodebook


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_state(vi, prefix: str) -> dict[str, np.ndarray]:
    n = vi._count
    return {f"{prefix}_rows": vi._vecs[:n].copy(),
            f"{prefix}_valid": vi._valid[:n].copy(),
            f"{prefix}_slots": vi._slots[:n].copy(),
            f"{prefix}_free": np.asarray(vi._free, np.int64)}


def _install_rows(vi, state: dict[str, np.ndarray], prefix: str) -> None:
    rows = state[f"{prefix}_rows"].astype(np.float32)
    valid, slots = state[f"{prefix}_valid"], state[f"{prefix}_slots"]
    n = len(rows)
    if n > vi.capacity:
        vi._grow(n)
    vi._vecs[:n] = rows
    vi._valid[:n] = valid
    vi._slots[:n] = slots
    vi._count = n
    vi._free = [int(r) for r in state[f"{prefix}_free"]]
    vi._rows_by_slot = {}
    for r in np.nonzero(valid > 0)[0]:
        vi._rows_by_slot.setdefault(int(slots[r]), []).append(int(r))
    vi._mark_dirty(np.arange(n, dtype=np.int64))
    vi._dirty_full = True


def state_from_jax(engine) -> dict[str, np.ndarray]:
    vi = engine.vector_index
    lex = engine.lexical_index
    slots_in_docs = sorted(lex._docs)
    doc_tids, doc_tfs, doc_ptr = [], [], [0]
    for s in slots_in_docs:
        tf = lex._docs[s]
        doc_tids.extend(tf.keys())
        doc_tfs.extend(tf.values())
        doc_ptr.append(len(doc_tids))
    vocab = sorted(lex._vocab.items(), key=lambda kv: kv[1])
    doc_ids = np.asarray(engine._doc_by_slot, np.int64)
    state = {
        **_rows_state(vi, "vec"),
        **_rows_state(engine.entity_index, "ent"),
        "doc_by_slot": doc_ids,
        "titles": np.asarray([engine._titles.get(int(d), "") for d in doc_ids],
                             dtype=object),
        "lex_terms": np.asarray([t for t, _ in vocab], dtype=object),
        "lex_doc_slots": np.asarray(slots_in_docs, np.int64),
        "lex_doc_len": np.asarray([lex._doc_len[s] for s in slots_in_docs],
                                  np.float64),
        "lex_doc_ptr": np.asarray(doc_ptr, np.int64),
        "lex_doc_tids": np.asarray(doc_tids, np.int64),
        "lex_doc_tfs": np.asarray(doc_tfs, np.float64),
        "lex_num_slots": np.asarray(lex._num_slots, np.int64),
    }
    if vi.has_pq:
        state.update(pq_state(vi))
    if engine.tuner is not None:
        state.update(tuner_state(engine.tuner))
    return state


def tuner_state(tuner) -> dict[str, np.ndarray]:
    """A SearchTuner's arm names, and per corpus profile its (pulls, total
    reward) per arm and the last arm it chose (-1: none yet)."""
    profiles = sorted(tuner._stats)
    n_arms = max([len(tuner.arms)] + [len(tuner._stats[p]) for p in profiles])
    stats = np.zeros((len(profiles), n_arms, 2), np.float64)
    for i, p in enumerate(profiles):
        stats[i, :len(tuner._stats[p])] = tuner._stats[p]
    return {
        "tuner_arms": np.asarray([a.name for a in tuner.arms], dtype=object),
        "tuner_profiles": np.asarray(profiles, dtype=object),
        "tuner_stats": stats,
        "tuner_last_arm": np.asarray([tuner._last_arm.get(p, -1) for p in profiles],
                                     np.int64),
    }


def load_tuner_state(tuner, state: dict[str, np.ndarray]) -> None:
    """Install `tuner_state` output into a port SearchTuner with the same arms."""
    names = [str(a) for a in state["tuner_arms"]]
    if [a.name for a in tuner.arms] != names:
        raise ValueError(f"tuner arms differ: {names}")
    tuner._stats = {str(p): [list(map(float, row)) for row in stats]
                    for p, stats in zip(state["tuner_profiles"], state["tuner_stats"])}
    tuner._last_arm = {str(p): int(a) for p, a in
                       zip(state["tuner_profiles"], state["tuner_last_arm"]) if a >= 0}


def pq_state(vi) -> dict[str, np.ndarray]:
    """The PQ state of a yams_tpu (or port) VectorIndex built with build_pq."""
    return {
        "pq_centroids": _host(vi._pq_codebook.centroids).astype(np.float32),
        "pq_codes": vi._pq_codes.copy(),
        "pq_packed4": np.asarray(bool(getattr(vi, "_pq_packed4", False))),
        "pq_group": np.asarray(getattr(vi, "_pq_group", 1), np.int64),
        "pq_rerank_factor": np.asarray(vi._pq_rerank_factor, np.int64),
        "pq_sel_width": np.asarray(getattr(vi, "_pq_sel_width", 0), np.int64),
        "pq_built_rows": np.asarray(getattr(vi, "_pq_built_rows", 0), np.int64),
    }


def load_state(engine, state: dict[str, np.ndarray]) -> None:
    """Install `state` into an EMPTY port engine."""
    if engine._doc_by_slot:
        raise ValueError("load_state needs an empty engine")
    if "tuner_stats" in state and engine.tuner is None:
        raise ValueError("the state carries tuner statistics: give the engine a "
                         "SearchTuner first (engine.tuner), as the source engine has")
    vi = engine.vector_index
    _install_rows(vi, state, "vec")
    if "pq_centroids" in state:
        load_pq_state(vi, state)
    if "ent_rows" in state:
        _install_rows(engine.entity_index, state, "ent")
    if "tuner_stats" in state:
        load_tuner_state(engine.tuner, state)

    engine._doc_by_slot = [int(d) for d in state["doc_by_slot"]]
    engine._slot_by_doc = {d: s for s, d in enumerate(engine._doc_by_slot)}
    engine._titles = {d: str(t) for d, t in
                      zip(engine._doc_by_slot, state["titles"])}

    lex = engine.lexical_index
    terms = [str(t) for t in state["lex_terms"]]
    for t in terms:
        lex._term_id(t)  # same ids in the same order, and the stem index
    ptr = state["lex_doc_ptr"]
    tids = state["lex_doc_tids"].tolist()
    tfs = state["lex_doc_tfs"].tolist()
    for i, slot in enumerate(state["lex_doc_slots"].tolist()):
        tf = dict(zip(tids[ptr[i]:ptr[i + 1]], tfs[ptr[i]:ptr[i + 1]]))
        lex._docs[slot] = tf
        lex._doc_len[slot] = float(state["lex_doc_len"][i])
        for tid, f in tf.items():
            lex._postings.setdefault(tid, {})[slot] = f
    lex._num_slots = int(state["lex_num_slots"])
    lex._dirty_terms.update(lex._postings.keys())
    lex._dirty = True


def load_pq_state(vi, state: dict[str, np.ndarray]) -> None:
    """Install `pq_state` output into a port VectorIndex holding the same
    rows; codes keep the source index's capacity."""
    codes = state["pq_codes"]
    if len(codes) > vi.capacity:
        vi._grow(len(codes))
    full = np.zeros((vi.capacity, codes.shape[1]), np.uint8)
    full[:len(codes)] = codes
    cent = state["pq_centroids"]
    m, ksub, dsub = cent.shape
    vi._pq_codebook = PQCodebook(
        centroids=torch.from_numpy(cent.copy()).to(vi.device), m=m, ksub=ksub,
        dsub=dsub)
    vi._pq_codes = full
    vi._pq_packed4 = bool(state["pq_packed4"])
    vi._pq_group = int(state["pq_group"])
    vi._pq_rerank_factor = int(state["pq_rerank_factor"])
    vi._pq_sel_width = int(state["pq_sel_width"])
    vi._pq_built_rows = int(state["pq_built_rows"])
    vi._pq_device = None


def topology_from_jax(topology, *, device: str | torch.device = "cuda"):
    """A port TopologyEngine holding the artifacts of `topology` (a yams_tpu
    TopologyEngine, or a port one) as NumPy arrays: centroids, assignments,
    sizes, cohesion, epoch, representatives and their counts, and the
    centroid persistence; the member CSR is rebuilt from the assignments.
    Routing then compares with equal artifacts, apart from the builds."""
    from .index.topology import TopologyArtifacts, TopologyEngine

    eng = TopologyEngine(iters=topology.iters, seed=topology.seed,
                         representatives=topology.representatives, device=device)
    a = topology.artifacts
    if a is not None:
        copy = lambda x: None if x is None else np.array(_host(x))  # noqa: E731
        eng.artifacts = TopologyArtifacts(
            centroids=copy(a.centroids).astype(np.float32),
            assignments=copy(a.assignments).astype(np.int32),
            cluster_sizes=copy(a.cluster_sizes),
            epoch=int(a.epoch),
            cohesion=copy(a.cohesion),
            centroid_persistence=float(a.centroid_persistence),
            rep_vectors=copy(a.rep_vectors),
            rep_counts=copy(a.rep_counts),
        )
        eng._member_csr = None
        eng.member_rows(np.empty(0, np.int64))   # rebuilds the CSR
    return eng


def topology_tuner_from_jax(tuner):
    """A port TopologyTuner with the plays, reward totals and history of
    `tuner` (a yams_tpu TopologyTuner, or a port one)."""
    from .index.topology import TopologyTuner

    out = TopologyTuner(reward_mode=tuner.reward_mode, exploration=tuner.exploration)
    out.counts = dict(tuner.counts)
    out.totals = dict(tuner.totals)
    out.history = list(tuner.history)
    return out


def load_topology(engine, source) -> None:
    """Carry the topology surface of search engine `source` (a yams_tpu
    SearchEngine, or a port one) into port `engine`: the topology, the
    topology tuner, the route-risk calibration and the persistence stat."""
    engine.topology = (None if source.topology is None else
                       topology_from_jax(source.topology, device=engine.device))
    engine.topology_tuner = (None if source.topology_tuner is None else
                             topology_tuner_from_jax(source.topology_tuner))
    engine._route_calib = dict(source._route_calib)
    if "topology_persistence" in source._stats:
        engine._stats["topology_persistence"] = source._stats["topology_persistence"]
    else:
        engine._stats.pop("topology_persistence", None)


def hf_state_from_npz(path: str) -> dict[str, torch.Tensor]:
    """A converted BERT checkpoint -> BertEncoder's state dict (f32): every
    array but the config scalars and the vocabulary, "/" turned into "."."""
    with np.load(path, allow_pickle=False) as z:
        return {k.replace("/", "."): torch.from_numpy(np.asarray(z[k], np.float32))
                for k in z.files if not k.startswith("cfg/") and k != "vocab"}


_FLAX_BLOCK = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2", "Dense_0": "fc1",
               "Dense_1": "fc2"}
_FLAX_ATTN = {"query": "q", "key": "k", "value": "v", "out": "o"}


def _flat(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def neural_state_from_flax(params) -> dict[str, torch.Tensor]:
    """The reference NeuralEncoder's flax tree (with or without its
    "params" level; NumPy leaves) -> NeuralEncoderModule's state dict.

    `Embed_0` / `Embed_1` become "tok" / "pos"; `Block_i`'s LayerNorm_0,
    LayerNorm_1, Dense_0 and Dense_1 become "blocks.i.ln1", "ln2", "fc1"
    and "fc2"; its attention's query, key and value kernels (D, H, hd) and
    biases (H, hd) become (D, H*hd) and (H*hd,), and `out`'s kernel
    (H, hd, D) becomes (H*hd, D); the final `LayerNorm_0` is "ln_f". A
    partial tree gives a partial state dict."""
    if "params" in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}
    for path, value in _flat(params):
        a = np.array(value, np.float32)
        head, leaf = path[0], path[-1]
        if head in ("Embed_0", "Embed_1"):
            key = "tok" if head == "Embed_0" else "pos"
        elif head == "LayerNorm_0" and len(path) == 2:
            key = f"ln_f.{leaf}"
        elif head.startswith("Block_"):
            pre = f"blocks.{int(head[len('Block_'):])}"
            sub = path[1]
            if sub == "MultiHeadDotProductAttention_0":
                key = f"{pre}.attn.{_FLAX_ATTN[path[2]]}.{leaf}"
                if path[2] == "out":
                    a = a.reshape(-1, a.shape[-1]) if leaf == "kernel" else a
                else:
                    a = a.reshape(a.shape[0], -1) if leaf == "kernel" else a.reshape(-1)
            else:
                key = f"{pre}.{_FLAX_BLOCK[sub]}.{leaf}"
        else:
            raise KeyError(f"unknown NeuralEncoder parameter {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def ner_state_from_flax(params) -> dict[str, torch.Tensor]:
    """The reference NER Tagger's flax tree (with or without its "params"
    level; NumPy leaves) -> the state dict of `embed.ner.Tagger`. The
    module keeps the flax names and shapes, so this only joins the path
    with "." (`encoder/attn0/query/kernel` (64, 4, 16) is
    `encoder.attn0.query.kernel`)."""
    if "params" in params:
        params = params["params"]
    return {".".join(path): torch.from_numpy(np.array(value, np.float32))
            for path, value in _flat(params)}


def ner_flax_from_state(state: dict[str, torch.Tensor]) -> dict:
    """`ner_state_from_flax` backwards: the Tagger's state dict -> the flax
    tree {"params": {...}} of NumPy f32 arrays that the reference's
    NerModel.save writes."""
    tree: dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()
    return {"params": tree}
