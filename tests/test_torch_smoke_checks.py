"""The card check's own comparison (chip_smoke.check_topk and its owners),
run on CPU tensors: it must pass the plain twin against itself and refuse
a result that only looks right, such as a row that ties the twin's exactly
but lies in another row block, window or group, a dead row in a live slot,
or one row twice in a list. The twins here are the port's plain versions of
K1-K4 (ops/scan.py, ops/flash_topk.py, ops/pq_pallas.py); values are the
twins' own, so the tolerance (1e-4, the smoke's) is not what is tested.
"""

import pytest
import torch

import chip_smoke as smoke
from yams_tpu_torch.ops import flash_topk, pq_pallas, scan

TOL = 1e-4
BR = 2048


def _k3(case: str = "duplicates", k: int = 10, B: int = 3):
    gen = torch.Generator()
    gen.manual_seed(5)
    q, E, valid = smoke.k3_inputs("cpu", gen, B, k, case, N=4 * BR, D=64, block_rows=BR)
    valid[[11, 700, 2048, 6000]] = 1.0          # query 0's four copies are live
    tv, ti = scan.exact_topk_reference(q, E, valid, k, BR)
    return q, E, valid, tv, ti


def _check_k3(q, E, valid, kv, ki, tv, ti):
    return smoke.check_topk("K3", kv, ki, tv, ti, smoke.k3_true_score(q, E, valid),
                            smoke.part_owns(valid, BR, 0), TOL)


def test_check_topk_passes_the_twin_against_itself():
    q, E, valid, tv, ti = _k3()
    assert _check_k3(q, E, valid, tv.clone(), ti.clone(), tv, ti) == (0.0, 0)


def test_check_topk_refuses_an_exact_tie_from_another_block():
    """Query 0's copies at rows 11 (block 0) and 2,048 (block 1) score the
    same: block 1's first slot naming row 11 is a near-tie by value, but not
    a row of block 1."""
    q, E, valid, tv, ti = _k3()
    assert ti[0, 0, 0] == 11 and ti[1, 0, 0] == 2048
    ki = ti.clone()
    ki[1, 0, 0] = 11
    with pytest.raises(RuntimeError, match="own part"):
        _check_k3(q, E, valid, tv.clone(), ki, tv, ti)


def test_check_topk_refuses_a_dead_row_in_a_live_slot():
    q, E, valid, tv, ti = _k3()
    dead = int(torch.nonzero(valid[:BR] == 0)[0])
    ki = ti.clone()
    ki[0, 1, 3] = dead
    with pytest.raises(RuntimeError, match="own part"):
        _check_k3(q, E, valid, tv.clone(), ki, tv, ti)


def test_check_topk_refuses_a_row_twice_in_a_list():
    """Copies at rows 11 and 700 tie exactly at query 0's top in block 0:
    naming row 11 in both slots passes the near-tie test, not the list's."""
    q, E, valid, tv, ti = _k3()
    assert ti[0, 0, :2].tolist() == [11, 700]
    ki = ti.clone()
    ki[0, 0, 1] = 11
    with pytest.raises(RuntimeError, match="twice|lower rows first"):
        _check_k3(q, E, valid, tv.clone(), ki, tv, ti)


def test_check_topk_accepts_a_near_tie_inside_the_block():
    """Two live rows of one block that tie may trade places (where the order
    of a tie is not checked)."""
    q, E, valid, tv, ti = _k3("random")
    g, b = 2, 1
    top = int(ti[g, b, 0])
    other = g * BR + (top % BR + 1000) % BR
    E[other] = E[top]
    valid[other] = 1.0
    tv, ti = scan.exact_topk_reference(q, E, valid, 10, BR)
    assert sorted(ti[g, b, :2].tolist()) == sorted([top, other])
    ki = ti.clone()
    ki[g, b, 0], ki[g, b, 1] = ti[g, b, 1], ti[g, b, 0]
    err, d = smoke.check_topk("K3", tv.clone(), ki, tv, ti, smoke.k3_true_score(q, E, valid),
                              smoke.part_owns(valid, BR, 0), TOL, ordered=False)
    assert (err, d) == (0.0, 2)
    with pytest.raises(RuntimeError, match="lower rows first"):
        _check_k3(q, E, valid, tv.clone(), ki, tv, ti)


@pytest.mark.parametrize("group", [8, 64, 256])
def test_check_k4_refuses_a_row_of_the_next_window(group):
    gen = torch.Generator()
    gen.manual_seed(9)
    lut, codes, valid = smoke.k4_inputs("cpu", gen, 2, 8, 16384)
    tv, ti = pq_pallas.pq4_adc_reference(lut, codes, valid, group, group)
    assert smoke.check_k4("K4", tv.clone(), ti.clone(), tv, ti, lut, codes, valid, group,
                          TOL) == (True, 0.0, 0)
    live = int(torch.nonzero(valid[group:2 * group] > 0)[0]) + group
    codes[live] = codes[ti[0, 0]]                # ties window 0's winner exactly
    tv, ti = pq_pallas.pq4_adc_reference(lut, codes, valid, group, group)
    ki = ti.clone()
    ki[0, 0] = live
    with pytest.raises(RuntimeError, match="own part"):
        smoke.check_k4("K4", tv.clone(), ki, tv, ti, lut, codes, valid, group, TOL)


@pytest.mark.parametrize("group", [64, 256])
def test_check_topk_refuses_a_row_of_another_k1_group(group):
    gen = torch.Generator()
    gen.manual_seed(3)
    q, E, valid = smoke.k1_inputs("cpu", gen, 2, "random", N=4096, D=64)
    valid[:] = 1.0
    E[group] = E[0] = q[0].to(E.dtype)           # rows 0 and group tie exactly for query 0
    tv, ti = scan.grouped_max_reference(q, E, valid, group)
    assert ti[0, 0] == 0 and ti[0, 1] == group
    ki = ti.clone()
    ki[0, 1] = 0
    with pytest.raises(RuntimeError, match="own part"):
        smoke.check_topk("K1", tv.clone(), ki, tv, ti,
                         smoke.partition_true_score(q, E, valid=valid),
                         smoke.part_owns(valid, group, 1), TOL, ordered=False)


@pytest.mark.parametrize("offset", [1, flash_topk.WINDOW])
def test_check_topk_refuses_a_row_of_another_k2_window(offset):
    """Window 0 owns rows 0, 128, 256, ... of its span: row 1 (window 1) and
    row 128 + 1 do not belong to it, row 128 does."""
    gen = torch.Generator()
    gen.manual_seed(4)
    q, E, bias = smoke.k2_inputs("cpu", gen, 2, "random", 1, D=64)
    bias[:] = 0.0
    E[0] = E[offset] = E[flash_topk.WINDOW] = q[0].to(E.dtype)
    tv, ti = flash_topk.windowed_scan_reference(q, E, bias)
    assert ti[0, 0] == 0
    owns = smoke.window_owns(bias)
    assert bool(owns(torch.tensor([[0, 0]]), torch.tensor([flash_topk.WINDOW])).all())
    ki = ti.clone()
    ki[0, 0] = offset + (1 if offset == flash_topk.WINDOW else 0)
    with pytest.raises(RuntimeError, match="own part"):
        smoke.check_topk("K2", tv.clone(), ki, tv, ti,
                         smoke.partition_true_score(q, E, bias=bias), owns, TOL, ordered=False)


@pytest.mark.parametrize("N", [8192, 7680])
def test_tile_dupe_rows_stay_in_one_tile_and_apart(N):
    seen = set()
    for b in range(5 * N // 128):
        rows = smoke.tile_dupe_rows(b, N)
        assert len(rows) == 24 > 20 and rows == sorted(rows)
        assert len({r // 128 for r in rows}) == 1 and rows[-1] < N
        assert seen.isdisjoint(rows)
        seen.update(rows)


# -- phase 8's comparison of two programs' fused top-k --------------------------
def _fused():
    vals = torch.tensor([[0.9, 0.8, 0.700005, 0.7, 0.5], [0.6, 0.5, 0.4, 0.3, 0.2]])
    ids = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    return vals, ids


def test_fused_agree_passes_equal_programs():
    vals, ids = _fused()
    assert smoke.fused_agree("same", vals, ids, vals.clone(), ids.clone()) == (0.0, 0)


def test_fused_agree_names_a_near_tie_swap():
    """Docs 3 and 4, 5e-6 apart, change places in the other program: each
    rank's value agrees within 1e-5 and each doc's score within 1e-4, so
    both differing ids are counted as near-ties."""
    vals, ids = _fused()
    other_ids = ids.clone()
    other_ids[0, [2, 3]] = torch.tensor([4, 3], dtype=torch.int32)
    other_vals = vals.clone()
    other_vals[0, [2, 3]] = torch.tensor([0.700004, 0.700001])
    err, differ = smoke.fused_agree("swap", vals, ids, other_vals, other_ids)
    assert differ == 2 and err <= 1e-5


def test_fused_agree_refuses_a_far_doc():
    """A top doc replaced by one the first list lacks (0.9 against the other
    list's last score 0.5) is refused, as are values 1e-3 apart."""
    vals, ids = _fused()
    other = ids.clone()
    other[0, 0] = 42                         # the top doc replaced outright
    with pytest.raises(RuntimeError, match="no near-tie"):
        smoke.fused_agree("far", vals, ids, vals, other)
    with pytest.raises(RuntimeError, match="fused values"):
        smoke.fused_agree("values", vals, ids, vals + 1e-3, ids)


def _results(pairs):
    from yams_tpu_torch.search.engine import SearchResult
    return [SearchResult(doc_id=d, score=s) for d, s in pairs]


def test_results_agree_passes_equal_lists_and_names_a_tie():
    """Phase 9's comparison of two engines' results: equal lists pass; two
    docs 5e-6 apart in other places are a tie, counted and accepted."""
    want = [_results([(1, 0.9), (2, 0.7), (3, 0.700005), (4, 0.5)])]
    assert smoke.results_agree("same", want, want) == {"equal": 1, "ties": 0, "max_err": 0.0}
    swapped = [_results([(1, 0.9), (3, 0.700004), (2, 0.700001), (4, 0.5)])]
    got = smoke.results_agree("swap", swapped, want)
    assert got["equal"] == 0 and got["ties"] == 2 and got["max_err"] <= 1e-5


def test_results_agree_refuses_a_far_doc_and_a_far_score():
    want = [_results([(1, 0.9), (2, 0.7), (4, 0.5)])]
    with pytest.raises(RuntimeError, match="no tie"):
        smoke.results_agree("far", [_results([(9, 0.9), (2, 0.7), (4, 0.5)])], want)
    with pytest.raises(RuntimeError, match="scores within"):
        smoke.results_agree("score", [_results([(1, 0.9), (2, 0.7002), (4, 0.5)])], want)
    with pytest.raises(RuntimeError, match="results against"):
        smoke.results_agree("short", [_results([(1, 0.9)])], want)


def test_kg_graph_links_documents_to_labels_in_their_text():
    docs, _ = smoke.make_docs(300, 3)
    from yams_tpu_torch.scripts.kg_fixture import kg_graph
    labels, links = kg_graph(docs, n_nodes=500, seed=1)
    assert len(labels) == len(set(labels)) == 500
    assert all(1 <= len(label.split()) <= 3 for label in labels)
    text = {d: f" {title} {body.rstrip('.')} " for d, body, title in docs}
    assert [d for d, _ in links] == [d for d, _, _ in docs]
    for d, ents in links:
        assert len(ents) <= 5
        for e, conf in ents:
            assert f" {labels[e]} " in text[d] and 0.4 <= conf <= 1.0
    assert sum(len(ents) for _, ents in links) >= len(docs)


def test_restore_slot_map_fills_gaps(tmp_path):
    import types

    from yams_tpu_torch.metadata import Database
    from yams_tpu_torch.services.app import AppContext
    db = Database(tmp_path / "m.db")
    db.execute("INSERT INTO documents (id, file_path, file_name, sha256_hash, created_time,"
               " modified_time, indexed_time) VALUES (7, '/a', 'a', 'x', 0, 0, 0),"
               " (9, '/b', 'b', 'y', 0, 0, 0)")
    db.execute("INSERT INTO metadata (document_id, key, value) VALUES (7, '__slot__', '2'),"
               " (9, '__slot__', '0')")

    class Engine:
        pass

    eng = Engine()
    AppContext._restore_slot_map(types.SimpleNamespace(db=db, search_engine=eng))
    assert eng._doc_by_slot == [9, -1, 7] and eng._slot_by_doc == {9: 0, 7: 2}
