"""Port parity: the sharded hybrid query (yams_tpu_torch.parallel.sharded_hybrid).

The reference's `problem` (tests/test_sharded_hybrid.py) goes through
yams_tpu's sharded_hybrid_query on its 8-device virtual CPU mesh and
through the port's on a virtual mesh of 8 CPU shards. On the CSR lexical
leg the fused slots are equal and every output agrees to atol 1e-5 (the
vector scores are f32 sums of bf16 products in another order; the port's
query norm sums in f64). The packed lexical leg's BM25 sums sit a few ulps
of the impact mass from the reference's (tests/test_torch_bm25.py), which
the adaptive leg weights magnify: there the slots are equal and the values
agree to 1e-4. The port's sharded program is also held to its own
single-device hybrid_query at the reference's gate (fused values within
2e-3 at every rank, top-10 id overlap >= 0.9).
"""

import jax
import jax.numpy as jnp
import jax.sharding as jsh
import numpy as np
import pytest
import torch

from yams_tpu.ops.bm25 import pack_postings_2d
from yams_tpu.ops.scan import quantize_int8
from yams_tpu.parallel import corpus_mesh as ref_corpus_mesh
from yams_tpu.parallel.sharded_hybrid import sharded_hybrid_query
from yams_tpu_torch.parallel.mesh import virtual_mesh
from yams_tpu_torch.parallel import sharded_hybrid as port
from yams_tpu_torch.search.config import SearchEngineConfig
from yams_tpu_torch.search.fusion import hybrid_query, pack_weights

CPU = torch.device("cpu")
# jitted: the reference called eagerly dispatches its shard_map op by op
# (~13 s a call on the virtual mesh); under jit one compile runs it
ref_query = jax.jit(sharded_hybrid_query, static_argnums=(0,), static_argnames=(
    "k", "rrf_cand", "window", "num_slots", "int8_corpus", "axis", "packed_lexical",
    "bm25_prefilter"))
ORDER = ("sketch", "tid", "tm", "proj", "E", "rv", "r2s", "rs", "pd", "pi", "to",
         "tl", "dm", "hot", "w")


def _problem(seed=3, chunked=False):
    """tests/test_sharded_hybrid.py's problem; `chunked` gives each doc
    several rows spread over the shards (a doc's rows straddle shards)."""
    rng = np.random.default_rng(seed)
    rows, D, S, Nd, B, T, V, W = 8 * 128, 64, 256, 1024, 4, 8, 128, 32
    E = rng.standard_normal((rows, D)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    proj = ((rng.integers(0, 2, (S, D)) * 2 - 1) / np.sqrt(D)).astype(np.float32)
    sketch = rng.standard_normal((B, S)).astype(np.float32)
    tid = rng.integers(0, V, (B, T)).astype(np.int32)
    tm = np.ones((B, T), np.float32)
    per = W // 2
    pd = np.concatenate([rng.integers(0, Nd, V * per).astype(np.int32),
                         np.full(W, Nd, np.int32)])
    pi = np.concatenate([rng.random(V * per).astype(np.float32) + 0.5,
                         np.zeros(W, np.float32)])
    to = (np.arange(V) * per).astype(np.int32)
    tl = np.full(V, per, np.int32)
    rv = np.ones(rows, np.float32)
    if chunked:
        Nd = 256
        r2s = rng.integers(0, Nd, rows).astype(np.int32)   # ~4 rows a doc, any shard
        dead = rng.random(rows) < 0.05
        rv[dead], r2s[dead] = 0.0, -1
        pd = np.where(pd >= 1024, Nd, pd % Nd).astype(np.int32)
    else:
        r2s = np.arange(rows).astype(np.int32)
    w = pack_weights(SearchEngineConfig())
    return dict(sketch=sketch, tid=tid, tm=tm, proj=proj, E=E, rv=rv, r2s=r2s,
                rs=np.ones(rows, np.float32), pd=pd, pi=pi, to=to, tl=tl,
                dm=np.ones(Nd, np.float32), hot=np.zeros(Nd, np.float32), w=w,
                Nd=Nd, W=W)


def _variant(p, int8=False, packed=False, dm=None):
    x = dict(p)
    if int8:
        x["E"], x["rs"] = quantize_int8(p["E"])
    if packed:
        pk, sc = pack_postings_2d(p["pd"], p["pi"], p["to"], p["tl"], window=p["W"],
                                  num_docs=p["Nd"])
        x.update(pd=pk, pi=np.float32(sc))
    if dm is not None:
        x["dm"] = dm
    return x


def _ref(x, mesh, axis="d", idx=None, **kw):
    sh_r = jsh.NamedSharding(mesh, jsh.PartitionSpec(axis, None))
    sh_1 = jsh.NamedSharding(mesh, jsh.PartitionSpec(axis))
    a = [jnp.asarray(x[n]) for n in ORDER]
    a[3] = a[3].astype(jnp.bfloat16)
    if x["E"].dtype != np.int8:
        a[4] = a[4].astype(jnp.bfloat16)
    a[4] = jax.device_put(a[4], sh_r)
    for i in (5, 6, 7):
        a[i] = jax.device_put(a[i], sh_1)
    if idx is not None:
        a.append(jnp.asarray(idx))
    out = ref_query(mesh, *a, k=10, rrf_cand=32, window=x["W"], num_slots=x["Nd"],
                    axis=axis, int8_corpus=x["E"].dtype == np.int8, **kw)
    return [np.asarray(o) for o in out]


def _tensors(x, idx=None):
    t = [torch.as_tensor(np.asarray(x[n])) for n in ORDER]
    t[3] = t[3].bfloat16()
    if x["E"].dtype != np.int8:
        t[4] = t[4].bfloat16()
    if idx is not None:
        t.append(torch.from_numpy(idx))
    return t


def _port(x, mesh, axis="d", idx=None, **kw):
    out = port.sharded_hybrid_query(mesh, *_tensors(x, idx), k=10, rrf_cand=32, window=x["W"],
                               num_slots=x["Nd"], axis=axis,
                               int8_corpus=x["E"].dtype == np.int8, **kw)
    return [o.numpy() for o in out]


def _same(want, got, atol=1e-5):
    assert np.array_equal(got[1], want[1])
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8
    devs = np.array(jax.devices()[:8])
    return {"1d": (ref_corpus_mesh(8), virtual_mesh(8, "d", CPU), "d"),
            "2x4": (jax.sharding.Mesh(devs.reshape(2, 4), ("dcn", "ici")),
                    virtual_mesh((2, 4), ("dcn", "ici"), CPU), ("dcn", "ici"))}


@pytest.mark.parametrize("mesh_name", ["1d", "2x4"])
@pytest.mark.parametrize("int8", [False, True])
def test_matches_reference_csr(meshes, mesh_name, int8):
    ref_mesh, mesh, axis = meshes[mesh_name]
    x = _variant(_problem(), int8=int8)
    _same(_ref(x, ref_mesh, axis), _port(x, mesh, axis))


@pytest.mark.parametrize("mesh_name", ["1d", "2x4"])
def test_matches_reference_packed(meshes, mesh_name):
    """The packed lexical leg (the engine's default): slots equal, values
    within its known few-ulp gap."""
    ref_mesh, mesh, axis = meshes[mesh_name]
    x = _variant(_problem(), packed=True)
    _same(_ref(x, ref_mesh, axis, packed_lexical=True, bm25_prefilter=8),
          _port(x, mesh, axis, packed_lexical=True, bm25_prefilter=8), atol=1e-4)


def test_filter_pushdown_shared_and_per_query(meshes):
    """The reference's pushdown test (slots 100..200 only), then per-query
    uint8 rows with mask_idx, against the reference."""
    ref_mesh, mesh, _ = meshes["1d"]
    p = _problem()
    dm = np.zeros(p["Nd"], np.float32)
    dm[100:200] = 1.0
    x = _variant(p, dm=dm)
    want, got = _ref(x, ref_mesh), _port(x, mesh)
    _same(want, got)
    ok = got[1][got[0] > -1e29]
    assert ok.size and np.all((ok >= 100) & (ok < 200))
    rows = np.zeros((4, p["Nd"]), np.uint8)
    rows[0, 100:300] = 1
    rows[1, ::3] = 1
    rows[2, :] = 1
    idx = np.array([0, 1, 2, 0], np.int32)
    x = _variant(p, dm=rows)
    want, got = _ref(x, ref_mesh, idx=idx), _port(x, mesh, idx=idx)
    _same(want, got)
    for b, r in enumerate(idx):
        live = got[1][b][got[0][b] > -1e29]
        assert np.all(rows[r][live] == 1)


def test_chunked_rows_straddle_shards(meshes):
    """Docs whose chunk rows sit on several shards, tombstones among them:
    the slot dedup keeps each doc once, at its best chunk."""
    ref_mesh, mesh, _ = meshes["1d"]
    x = _problem(seed=5, chunked=True)
    want, got = _ref(x, ref_mesh), _port(x, mesh)
    _same(want, got)
    for row in got[1]:
        assert len(set(row.tolist())) == len(row)


def _single(x, **kw):
    out = hybrid_query(*_tensors(x), k=10, rrf_cand=32, window=x["W"], num_slots=x["Nd"],
                       int8_corpus=x["E"].dtype == np.int8, **kw)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("mesh_name", ["1d", "2x4"])
@pytest.mark.parametrize("int8", [False, True])
def test_matches_own_single_device(meshes, mesh_name, int8):
    """The reference's dryrun gate: fused values within 2e-3 at every rank,
    top-10 id overlap >= 0.9."""
    _, mesh, axis = meshes[mesh_name]
    x = _variant(_problem(), int8=int8, packed=True)
    kw = dict(packed_lexical=True, bm25_prefilter=8)
    sv, ss, _, _ = _single(x, rows_are_docs=True, **kw)
    hv, hs, _, _ = _port(x, mesh, axis, **kw)
    np.testing.assert_allclose(hv, sv, atol=2e-3)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ss, hs)])
    assert overlap >= 0.9, overlap


def test_dedup_keeps_each_slot_once_at_its_max():
    vv = torch.tensor([[0.9, 0.8, 0.95, 0.1, -1e30, -1e30]])
    vs = torch.tensor([[5, 7, 7, 5, 9, 9]])
    v, s = port.dedup_slots(vv, vs, C=4, sink=9)
    assert s.tolist() == [[7, 5, 9, 9]]
    assert v[0, :2].tolist() == pytest.approx([0.95, 0.9])


def test_shard_count_smaller_than_candidates():
    """A shard with fewer rows than C pads its list to C (the reference's
    c_loc), here 16 shards of 64 rows at C 128."""
    x = _problem()
    mesh = virtual_mesh(16, "d", CPU)
    out = port.sharded_hybrid_query(mesh, *_tensors(x), k=10, rrf_cand=128, window=x["W"],
                                    num_slots=x["Nd"])
    sv, ss, _, _ = hybrid_query(*_tensors(x), k=10, rrf_cand=128, window=x["W"],
                                num_slots=x["Nd"], rows_are_docs=True)
    np.testing.assert_allclose(out[0].numpy(), sv.numpy(), atol=2e-3)
    assert np.array_equal(out[1].numpy(), ss.numpy())
