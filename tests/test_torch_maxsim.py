"""The port's MaxSim and matryoshka ops (yams_tpu_torch/ops/maxsim.py,
ops/matryoshka.py) against the reference's (yams_tpu/ops/), JAX on the CPU.

- `maxsim_scores`: seeded query and candidate tokens with masks (masked
  query tokens, masked doc tokens, a candidate with no live token, a query
  with none): within 1e-5 of the reference (both take bf16 products with
  f32 sums; only the order of the sums differs).
- `maxsim_rerank`: the same ids as the reference, tie order included
  (candidates with equal scores, invalid ids sunk).
- `matryoshka_topk`: lax.approx_max_k is exact off the TPU, so the op is
  judged by recall@10 against the exact scan (>= 0.85, the reference
  test's bar, at d0 64 and 96; >= 0.5 at d0 32; and within 0.05 of the
  reference's recall at each), by its scores being the full-dim products
  of the rows it returns (1e-5), and by masked rows never returned. `prefix_corpus` is
  the reference's prefix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yams_tpu.ops import matryoshka as ref_mat
from yams_tpu.ops import maxsim as ref_maxsim
from yams_tpu_torch.ops import matryoshka, maxsim
from yams_tpu_torch.ops.scan import exact_topk_scan

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _maxsim_inputs(seed, B=3, Tq=6, C=5, Td=7, D=32):
    rng = np.random.default_rng(seed)
    qt = rng.standard_normal((B, Tq, D)).astype(np.float32)
    qm = (rng.random((B, Tq)) > 0.3).astype(np.float32)
    qm[:, 0] = 1.0
    ct = rng.standard_normal((B, C, Td, D)).astype(np.float32)
    cm = (rng.random((B, C, Td)) > 0.3).astype(np.float32)
    cm[:, :, 0] = 1.0
    cm[0, 1] = 0.0          # a candidate with no live token
    qm[-1] = 0.0            # a query with no live token
    return qt, qm, ct, cm


@pytest.mark.parametrize("seed,shape", [(0, {}), (1, dict(B=2, Tq=32, C=16, Td=32, D=64)),
                                        (2, dict(B=4, Tq=1, C=3, Td=6, D=48))])
def test_maxsim_scores_match_reference(seed, shape):
    qt, qm, ct, cm = _maxsim_inputs(seed, **shape)
    want = np.asarray(ref_maxsim.maxsim_scores(*(jnp.asarray(a) for a in (qt, qm, ct, cm))))
    got = maxsim.maxsim_scores(_t(qt), _t(qm), _t(ct), _t(cm)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_maxsim_rerank_keeps_the_reference_tie_order():
    qt, qm, ct, cm = _maxsim_inputs(3, B=3, C=8)
    ct[:, 4] = ct[:, 1]     # candidates 1 and 4, 2 and 6 score alike
    cm[:, 4] = cm[:, 1]
    ct[:, 6] = ct[:, 2]
    cm[:, 6] = cm[:, 2]
    ids = np.arange(10, 18, dtype=np.int32)[None].repeat(3, 0)
    ids[1, 3] = -1          # an invalid candidate sinks
    for k in (3, 8):
        wv, wi = ref_maxsim.maxsim_rerank(*(jnp.asarray(a) for a in (qt, qm, ct, cm, ids)), k=k)
        gv, gi = maxsim.maxsim_rerank(_t(qt), _t(qm), _t(ct), _t(cm), _t(ids).long(), k=k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)


def _clustered(n, d, n_clusters, seed=0, spread=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    v = centers[assign] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_prefix_corpus_is_the_reference_prefix():
    E = _clustered(300, 64, 8, seed=4)
    got = matryoshka.prefix_corpus(_t(E), 24)
    want = ref_mat.prefix_corpus(jnp.asarray(E, jnp.bfloat16), 24)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("d0,factor,floor", [(64, 24, 0.85), (96, 8, 0.85), (32, 24, 0.5)])
def test_matryoshka_recall_against_the_exact_scan(d0, factor, floor):
    """Recall@10 against the exact scan at or above the floor, and within
    0.05 of the reference's own recall there (a 32-dim prefix of this
    corpus carries less signal, in both packages)."""
    N, D, B, k = 2048, 128, 8, 10
    E = torch.from_numpy(_clustered(N, D, 16, seed=1)).bfloat16()
    q = torch.from_numpy(_clustered(B, D, 16, seed=2))
    valid = torch.ones(N)
    mv, mi = matryoshka.matryoshka_topk(q, E, matryoshka.prefix_corpus(E, d0), valid, k=k,
                                        rerank_factor=factor)
    ev, ei = exact_topk_scan(q, E, valid, k=k, block_rows=512)
    Ej = jnp.asarray(E.float().numpy(), jnp.bfloat16)
    _, ri = ref_mat.matryoshka_topk(jnp.asarray(q.numpy()), Ej, ref_mat.prefix_corpus(Ej, d0),
                                    jnp.asarray(valid.numpy()), k=k, rerank_factor=factor)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, ei.tolist())])

    got, want = recall(mi.tolist()), recall(np.asarray(ri).tolist())
    assert got >= floor and abs(got - want) <= 0.05, (got, want)
    full = q.bfloat16().float() @ E.float().T
    np.testing.assert_allclose(mv.numpy(), full.gather(1, mi.long()).numpy(), atol=ATOL)
    assert torch.all(mv[:, 0] <= ev[:, 0] + 1e-5)


def test_matryoshka_masked_rows_excluded():
    N, D, D0 = 512, 64, 16
    E = torch.from_numpy(_clustered(N, D, 8, seed=3)).bfloat16()
    valid = torch.ones(N)
    valid[:256] = 0.0
    _, mi = matryoshka.matryoshka_topk(E[:4].float(), E, matryoshka.prefix_corpus(E, D0),
                                       valid, k=5)
    assert mi.dtype == torch.int32 and torch.all(mi >= 256)
