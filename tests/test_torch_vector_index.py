"""Port parity: the vector store (yams_tpu_torch.index.vector_index).

One sequence of add / remove / add on a yams_tpu VectorIndex and on the
port's: after every step the host->device byte count is equal and the
device arrays (bf16 E, valid, slots) are bit-equal, so the port splices the
reference's dirty blocks, no more and no less. Searches go through both:
exact KNN with and without the block kernel K3, and the PQ tiers with the
same codebook (carried by convert.pq_state / load_pq_state), host and
device rerank, the K4 route forced (YAMS_PQ_PALLAS=1: the plain twin on the
CPU) and off, the small-capacity clamp, and the filtered route. The int8
tier runs the same sequence: its codes and scales bit-equal the
reference's, its scan gives the same ids and bit-equal values, and its
device rerank reads a bf16 mirror.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yams_tpu.index.vector_index import VectorIndex as RefIndex
from yams_tpu_torch.convert import load_pq_state, pq_state
from yams_tpu_torch.index.vector_index import VectorIndex

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
DIM = 64


def _unit(n, d=DIM, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(capacity=512, block_rows=128, dtype="bfloat16"):
    return (RefIndex(dim=DIM, capacity=capacity, block_rows=block_rows, device_dtype=dtype),
            VectorIndex(dim=DIM, capacity=capacity, block_rows=block_rows,
                        device_dtype=dtype, device=CPU))


def _mutations(ref, port):
    """add / remove / add / grow, yielding after each step."""
    vecs = _unit(900, seed=1)
    for idx in (ref, port):
        idx.add(vecs[:300], list(range(300)))
    yield "add"
    for idx in (ref, port):
        idx.remove_doc(7)
        idx.remove_doc(250)
    yield "remove"
    for idx in (ref, port):
        idx.add(vecs[300:310], [1000 + i for i in range(10)])   # reuses freed rows
    yield "add into freed rows"
    for idx in (ref, port):
        idx.add(vecs[310:900], list(range(2000, 2590)))         # grows capacity
    yield "grow"


def test_device_arrays_splice_matches_reference():
    ref, port = _pair()
    for step in _mutations(ref, port):
        r_arrays = [np.asarray(a) for a in ref.device_arrays()]
        p_arrays = port.device_arrays()
        assert port.upload_bytes_total == ref.upload_bytes_total, step
        assert np.array_equal(p_arrays[0].view(torch.int16).numpy(),
                              r_arrays[0].view(np.int16)), step
        for p, r in zip(p_arrays[1:], r_arrays[1:]):
            assert np.array_equal(p.numpy(), r), step
        assert not port._dirty_blocks and not port._dirty_full
    # a search with no mutation since uploads nothing
    before = port.upload_bytes_total
    port.device_arrays()
    assert port.upload_bytes_total == before


def test_splice_leaves_held_arrays_untouched():
    _, port = _pair()
    port.add(_unit(200, seed=2), list(range(200)))
    held = port.device_arrays()
    snapshot = [t.clone() for t in held]
    port.remove_doc(3)
    port.add(_unit(5, seed=3), [900 + i for i in range(5)])
    fresh = port.device_arrays()
    assert fresh[0] is not held[0]
    assert all(torch.equal(a, b) for a, b in zip(held, snapshot))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_matches_reference_after_mutations(use_pallas):
    ref, port = _pair()
    queries = _unit(6, seed=4)
    for step in _mutations(ref, port):
        rv, ri = ref.search(queries, k=10, use_pallas=use_pallas)
        pv, pi = port.search(queries, k=10, use_pallas=use_pallas)
        np.testing.assert_allclose(pv, rv, atol=1e-5, rtol=0, err_msg=step)
        np.testing.assert_array_equal(pi, ri, err_msg=step)
        assert port.upload_bytes_total == ref.upload_bytes_total, step


def test_search_one_dimensional_query_and_dead_rows():
    ref, port = _pair()
    for _ in _mutations(ref, port):
        pass
    for idx in (ref, port):
        idx.remove_doc(2000)
    q = port._vecs[port.rows_for_slot(2001)[0]]
    pv, pi = port.search(q, k=3, use_pallas=True)
    rv, ri = ref.search(q, k=3, use_pallas=True)
    np.testing.assert_array_equal(pi, ri)
    assert pi[0, 0] == port.rows_for_slot(2001)[0]


def _pq_pair(n=700, capacity=1024, block_rows=128, group=16, factor=8, seed=41):
    """A reference index with PQ4 built and a port index with its state."""
    ref, port = _pair(capacity, block_rows)
    vecs = _unit(n, seed=seed)
    for idx in (ref, port):
        idx.add(vecs, list(range(n)))
    ref.build_pq(m=16, ksub=16, pack4=True, rerank_factor=factor, group=group)
    load_pq_state(port, pq_state(ref))
    return ref, port, vecs


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("rerank", ["host", "device"])
def test_search_pq_matches_reference(monkeypatch, rerank, pallas):
    ref, port, vecs = _pq_pair()
    monkeypatch.setenv("YAMS_PQ_PALLAS", pallas)
    codes, cents, _, _ = port._pq_arrays()
    assert port._use_pallas_adc(True, 16, cents, None) == (pallas == "1")
    queries = vecs[[123, 5, 600]]
    rv, ri = ref.search_pq(queries, k=5, rerank=rerank)
    pv, pi = port.search_pq(queries, k=5, rerank=rerank)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, atol=1e-5, rtol=0)
    assert pi[0, 0] == 123


def test_pq_tier_uploads_no_dense_matrix():
    _, port, vecs = _pq_pair()
    port.upload_bytes_total = 0
    port.search_pq(vecs[:2], k=5)                 # auto: host rerank
    assert port._device is None
    assert port.upload_bytes_total < port.capacity * DIM * 2


def test_pq_state_splices_dirty_blocks_like_reference():
    ref, port, vecs = _pq_pair()
    for idx in (ref, port):
        idx._pq_arrays()
        idx.remove_doc(10)
    before = (ref.upload_bytes_total, port.upload_bytes_total)
    r_codes, _, r_valid, r_slots = ref._pq_arrays()
    p_codes, _, p_valid, p_slots = port._pq_arrays()
    assert port.upload_bytes_total - before[1] == ref.upload_bytes_total - before[0]
    assert np.array_equal(p_codes.numpy(), np.asarray(r_codes))
    assert np.array_equal(p_valid.numpy(), np.asarray(r_valid))
    assert np.array_equal(p_slots.numpy(), np.asarray(r_slots))


def test_pallas_candidate_clamp_small_capacity(monkeypatch):
    """capacity // group < k * rerank_factor: the K4 route clamps its
    candidate count to the window count (tests/test_pq.py:442-457)."""
    ref, port, vecs = _pq_pair(n=900, group=128, factor=8, seed=7)
    assert port._pallas_adc_candidates(40, 128) == 8
    monkeypatch.setenv("YAMS_PQ_PALLAS", "1")
    pv, pi = port.search_pq(vecs[7], k=5)
    rv, ri = ref.search_pq(vecs[7], k=5)
    assert pv.shape == (1, 5) and pi.shape == (1, 5)
    assert 7 in set(pi[0].tolist())
    np.testing.assert_array_equal(pi, ri)


def test_filtered_search_pq_stays_plain_and_honors_mask(monkeypatch):
    ref, port = _pair(capacity=512, block_rows=128)
    vecs = _unit(200, d=DIM, seed=5)
    for idx in (ref, port):
        idx.add(vecs, list(range(200)))
    ref.build_pq(m=8, ksub=16, pack4=True, group=8)
    load_pq_state(port, pq_state(ref))
    monkeypatch.setenv("YAMS_PQ_PALLAS", "1")
    _, cents, _, _ = port._pq_arrays()
    assert port._use_pallas_adc(True, 8, cents, None)
    assert not port._use_pallas_adc(True, 8, cents, torch.ones(1, 512))
    assert not port._use_pallas_adc(True, 1, cents, None)    # ungrouped
    assert not port._use_pallas_adc(False, 8, cents, None)   # unpacked
    mask = np.zeros(512, np.float32)
    mask[:50] = 1.0
    pv, pi = port.search_pq(vecs[10:13], k=5, doc_mask=mask)
    rv, ri = ref.search_pq(vecs[10:13], k=5, doc_mask=mask)
    assert all(port._slots[r] < 50 for r in pi.ravel() if r >= 0)
    np.testing.assert_array_equal(pi, ri)


@pytest.mark.parametrize("pack4,ksub", [(False, 256), (True, 16)])
def test_add_after_build_pq_encodes_like_reference(pack4, ksub):
    ref, port = _pair(capacity=256, block_rows=128)
    vecs = _unit(400, seed=6)
    for idx in (ref, port):
        idx.add(vecs[:200], list(range(200)))
    ref.build_pq(m=16, ksub=ksub, pack4=pack4, rerank_factor=4)
    load_pq_state(port, pq_state(ref))
    for idx in (ref, port):
        idx.add(vecs[200:], list(range(200, 400)))   # grows, encodes new rows
    assert port.capacity == ref.capacity
    assert np.array_equal(port._pq_codes, ref._pq_codes)
    rv, ri = ref.search_pq(vecs[[250, 399]], k=5)
    pv, pi = port.search_pq(vecs[[250, 399]], k=5)
    np.testing.assert_array_equal(pi, ri)


def test_build_pq_validates_before_mutating():
    _, port = _pair()
    port.add(_unit(50), list(range(50)))
    for kw in ({"pack4": True, "ksub": 256}, {"m": 5}, {"pack4": True, "m": 7, "ksub": 16},
               {"group": 3}):
        with pytest.raises(ValueError):
            port.build_pq(**kw)
    assert not port.has_pq
    with pytest.raises(RuntimeError):
        port.search_pq(_unit(1), k=3)


def test_port_build_pq_searches():
    _, port = _pair()
    vecs = _unit(400, seed=8)
    port.add(vecs, list(range(400)))
    port.build_pq(m=16, ksub=16, pack4=True, rerank_factor=8, group=8)
    assert port.has_pq and port._pq_codes.shape == (port.capacity, 8)
    _, rows = port.search_pq(vecs[[3, 77]], k=5)
    assert rows[0, 0] == 3 and rows[1, 0] == 77


@pytest.mark.parametrize("call", ["int8", "sharded", "load"])
def test_unported_tiers_refuse(call, tmp_path):
    """Sharded views refuse. The int8 tier and persistence refused until the
    port had them: the int8 tier uploads the reference's int8 codes (an
    unknown device dtype raises), and a reference index saved with PQ
    reloads in the port with equal rows and searches."""
    if call == "int8":
        ref, port = _pair(dtype="int8")
        for idx in (ref, port):
            idx.add(_unit(50), list(range(50)))
        assert np.array_equal(port.device_arrays()[0].numpy(),
                              np.asarray(ref.device_arrays()[0]))
        with pytest.raises(ValueError, match="device_dtype"):
            VectorIndex(dim=DIM, device_dtype="float16", device=CPU)
        return
    if call == "load":
        ref, _ = _pair()
        vecs = _unit(300, seed=4)
        ref.add(vecs, list(range(300)))
        ref.remove_doc(11)
        ref.build_pq(m=16, ksub=16, pack4=True, rerank_factor=4, group=8)
        ref.save(tmp_path)
        port = VectorIndex.load(tmp_path, device=CPU)
        assert np.array_equal(port._vecs[:300], ref._vecs[:300])
        assert port._free == ref._free and port._rows_by_slot == ref._rows_by_slot
        for got, want in ((port.search(vecs[:9], k=5), ref.search(vecs[:9], k=5)),
                          (port.search_pq(vecs[:9], k=5, rerank="host"),
                           ref.search_pq(vecs[:9], k=5, rerank="host"))):
            assert np.array_equal(got[1], np.asarray(want[1]))
            np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6, rtol=0)
        return
    with pytest.raises(NotImplementedError):
        _pair()[1].sharded_device_arrays(mesh=None)


# -- the int8 device tier ----------------------------------------------------------
def _assert_arrays_equal(ref, port, what):
    r_arrays = [np.asarray(a) for a in ref.device_arrays()]
    p_arrays = [a.numpy() for a in port.device_arrays()]
    assert port.upload_bytes_total == ref.upload_bytes_total, what
    assert p_arrays[0].dtype == np.int8, what
    for p, r in zip(p_arrays, r_arrays):
        assert p.dtype == r.dtype and np.array_equal(p.view(np.uint8), r.view(np.uint8)), what


def test_int8_device_arrays_splice_matches_reference():
    """After a full upload and after every block splice: the int8 codes,
    validity, slots and per-row scales bit-equal the reference's, and the
    upload byte counts (scales included) are equal."""
    ref, port = _pair(dtype="int8")
    for step in _mutations(ref, port):
        _assert_arrays_equal(ref, port, step)
        assert not port._dirty_blocks and not port._dirty_full


@pytest.mark.parametrize("use_pallas", [False, True])
def test_int8_search_matches_reference_after_mutations(use_pallas):
    """An int8 index takes the int8 scan whatever use_pallas says: ids
    equal, values bit-equal."""
    ref, port = _pair(dtype="int8")
    queries = _unit(6, seed=14)
    for step in _mutations(ref, port):
        rv, ri = ref.search(queries, k=10, use_pallas=use_pallas)
        pv, pi = port.search(queries, k=10, use_pallas=use_pallas)
        np.testing.assert_array_equal(pi, ri, err_msg=step)
        assert np.array_equal(pv.view(np.uint32), rv.view(np.uint32)), step


def test_int8_search_pq_device_rerank_keeps_a_bf16_mirror():
    """search_pq(rerank="device") on an int8 index reranks against a bf16
    mirror uploaded once (not the int8 codes) and spliced after mutations,
    as the reference's does: the same rows and values, the same bytes."""
    ref, port = _pair(capacity=1024, block_rows=128, dtype="int8")
    vecs = _unit(700, seed=15)
    for idx in (ref, port):
        idx.add(vecs, list(range(700)))
    ref.build_pq(m=16, ksub=16, pack4=True, rerank_factor=8)
    load_pq_state(port, pq_state(ref))
    queries = vecs[[12, 345, 699]]
    for step in ("first", "again", "after remove"):
        if step == "after remove":
            for idx in (ref, port):
                idx.remove_doc(345)
                idx.add(_unit(3, seed=16), [900, 901, 902])
        rv, ri = ref.search_pq(queries, k=5, rerank="device")
        pv, pi = port.search_pq(queries, k=5, rerank="device")
        np.testing.assert_array_equal(pi, ri, err_msg=step)
        np.testing.assert_allclose(pv, rv, atol=1e-5, rtol=0, err_msg=step)
        assert port.upload_bytes_total == ref.upload_bytes_total, step
        assert port._pq_rerank_device.dtype == torch.bfloat16
    assert pi[0, 0] == 12 and 345 not in pi[1]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_stats_match_reference(dtype):
    ref, port = _pair(dtype=dtype)
    for _ in _mutations(ref, port):
        assert port.stats() == ref.stats()


def test_pq_path_runs_without_jax():
    """build_pq, add on a PQ-built index, and both PQ routes in a fresh
    interpreter: jax is never imported."""
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import os, sys
        import numpy as np
        from yams_tpu_torch.index.vector_index import VectorIndex
        rng = np.random.default_rng(0)
        v = rng.standard_normal((600, 64)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        idx = VectorIndex(dim=64, capacity=256, block_rows=128, device="cpu")
        idx.add(v[:300], list(range(300)))
        idx.build_pq(m=16, ksub=16, pack4=True, group=8)
        idx.add(v[300:], list(range(300, 600)))
        os.environ["YAMS_PQ_PALLAS"] = "1"
        a = idx.search_pq(v[400], k=3)[1]
        b = idx.search_pq(v[400], k=3, doc_mask=np.ones(600, np.float32))[1]
        c = idx.search(v[400], k=3, use_pallas=True)[1]
        assert a[0, 0] == b[0, 0] == c[0, 0] == 400, (a, b, c)
        print("jax" in sys.modules)
    """)], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
