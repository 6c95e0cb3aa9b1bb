"""Tiled distance scan + exact top-k: the vector store's KNN core.

Port of yams_tpu/ops/scan.py (`dense_scores`, `exact_topk_scan`,
`exact_topk_pallas`, `grouped_topk_pallas`, `routed_gather_topk`):

  - dot_f32 / dense_scores: (B, D) x (N, D) -> (B, N) f32 scores from bf16
    operands, invalid rows -> -1e30;
  - exact_topk_scan: the plain exact path, a running top-k merged over row
    chunks (a chunk is a whole number of blocks, so the merge order is the
    reference's block scan and ties keep lax.top_k's order);
  - exact_topk_pallas: the block kernel (K3) emits each 2,048-row block's
    top-k per query, and a top-k over the G*k candidates merges them. On a
    CUDA tensor the block step is the CUDA kernel `exact_topk_cuda`
    (csrc/exact_topk.cu); on a CPU tensor its plain twin
    `exact_topk_reference`;
  - grouped_topk_pallas: the grouped-max kernel (K1) emits one (max, last
    argmax) per `group` consecutive rows per query, (B, N/group), and a
    top-k over them merges the groups (lax.approx_max_k's one-hit-per-window
    contract, fused with the product). On a CUDA tensor the group step is
    `grouped_max_cuda` (csrc/fused_scan.cu); on a CPU tensor its plain twin
    `grouped_max_reference`. Its only callers are the experiments
    yams_tpu_torch/scripts/profile_grouped.py and exp_recall_target.py
    and the tests;
  - the int8 tier: `quantize_int8` (host NumPy, the corpus side),
    `quantize_rows` (the query side, on the device), `int8_mm` (int8 x int8
    with int32 sums: torch._int_mm, the reference's lax.dot_general with
    i32 accumulation), `int8_scores` and `int8_topk_scan`; `merge_topk`.
    The int32 sums are exact in any order, so the f32 scores equal the
    reference's bit for bit given the same queries;
  - routed_gather_topk: the topology narrow tier's scan of each query's
    routed rows alone (a gather, a batched bf16 product, the top-k).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .select import top_k

NEG = -1e30
_SCORE_BUDGET = 1 << 26   # f32 scores per chunk of the plain paths (256 MB)
_TOPK_SMALL_K = 16        # K3: k above this takes the score dump (csrc/exact_topk.cu)
_DUMP_BYTES = 1 << 30     # K3's score dump: bytes a launch may hold


def dump_query_slice(N: int) -> int:
    """Queries one K3 dump launch takes: its (G, b, block_rows) f32 scores,
    N * b * 4 bytes, stay within _DUMP_BYTES (at least one query). At 1M
    rows that is 256, one whole query tile of the kernel's mainloop."""
    return max(1, _DUMP_BYTES // (4 * N))


def dot_f32(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a @ b_t.T with bf16-rounded operands and f32 scores.

    A bf16 matmul that returns bf16 would round the scores and reorder
    near-ties on a clustered corpus. On CUDA this is cuBLAS with an f32
    output (torch.mm(..., out_dtype=float32)); on the CPU, which has no
    such mm, it is an f32 matmul over the bf16-rounded values (bf16
    products are exact in f32, so only the summation order differs)."""
    a16 = a.to(torch.bfloat16)
    b16 = b_t.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a16, b16.t(), out_dtype=torch.float32)
    return torch.mm(a16.float(), b16.float().t())


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Cosine/IP scores: (B, D) x (N, D) -> (B, N) f32, invalid rows -> -1e30."""
    return dot_f32(queries, corpus) + ((valid - 1.0) * 1e30)[None, :]


def _chunk_rows(B: int, block_rows: int) -> int:
    return block_rows * max(1, _SCORE_BUDGET // (B * block_rows))


def _running_topk(scores, B: int, N: int, k: int, block_rows: int, dev):
    """The reference's blocked scan with a running top-k: the carry starts
    at k (-1e30, -1) entries and comes first in each merge, so a tie keeps
    the earlier row and a corpus with fewer than k live rows fills the tail
    with (-1e30, -1). `scores(lo, hi)` gives the (B, hi - lo) biased scores
    of rows lo..hi; a chunk is a whole number of blocks, which merges as
    the reference's block-by-block scan does."""
    if N % block_rows:
        raise ValueError(f"pad the corpus to a block multiple ({N} % {block_rows})")
    vals = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    idx = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    step = _chunk_rows(B, block_rows)
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        cols = torch.arange(lo, hi, device=dev).expand(B, -1)
        vals, pos = top_k(torch.cat([vals, scores(lo, hi)], dim=1), k)
        idx = torch.cat([idx, cols], dim=1).gather(1, pos)
    return vals, idx.to(torch.int32)


def exact_topk_scan(queries: torch.Tensor, corpus: torch.Tensor,
                    valid: torch.Tensor, k: int, block_rows: int = 4096):
    """Streaming exact top-k -> (values (B, k) f32 desc, indices (B, k) i32)."""
    return _running_topk(
        lambda lo, hi: dense_scores(queries, corpus[lo:hi], valid[lo:hi]),
        queries.shape[0], corpus.shape[0], k, block_rows, queries.device)


def merge_topk(vals_list: list[torch.Tensor], idx_list: list[torch.Tensor], k: int):
    """Merge per-shard (B, k) top-k candidate sets into a global top-k (ties
    to the earlier list)."""
    out_v, pos = top_k(torch.cat(vals_list, dim=1), k)
    return out_v, torch.cat(idx_list, dim=1).gather(1, pos)


# ---------------------------------------------------------------------------
# int8 tier: symmetric per-row quantization, int8 x int8 -> int32 products
# ---------------------------------------------------------------------------

def quantize_int8(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization on the host: (N, D) ->
    (int8 (N, D), scale f32 (N,)), the reference's own arithmetic."""
    absmax = np.maximum(np.abs(mat).max(axis=1), 1e-12)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(mat / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The query side of the int8 product, on x's device: (B, D) f32 ->
    (int8 (B, D), scale f32 (B,)). torch.round rounds half to even, as
    jnp.round does. The divisor 127 is a tensor on the device: on a card
    torch turns division by a Python number into a multiply by its
    reciprocal, which rounds otherwise than the reference's division.

    `syncs` (a plain int, never reset) counts the host's waits for the
    device: one a call, the divisor's copy to the device, which on a card
    waits for the work queued before it (a stream sync)."""
    amax = x.abs().amax(dim=1).clamp_min(1e-12)
    qscale = amax / amax.new_tensor(127.0)             # the host waits here
    quantize_rows.syncs += 1
    q8 = torch.round(x / qscale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q8, qscale


quantize_rows.syncs = 0


_INT_MM_MIN_ROWS = 32   # torch._int_mm on CUDA wants more than 16 rows in A


def int8_mm(q8: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D) int8 -> (B, N) int32 exact sums, torch._int_mm.

    On a card, cuBLASLt's int8 product takes D and N in multiples of 8 and
    more than 16 rows of A: the query side is padded with zero rows to a
    multiple of 8, at least 32, and the padding sliced off."""
    B, D = q8.shape
    if q8.device.type != "cuda":
        return torch._int_mm(q8, e8.t())
    if D % 8 or e8.shape[0] % 8:
        raise ValueError(f"int8_mm on a card takes D and N in multiples of 8, "
                         f"got D={D}, N={e8.shape[0]}")
    rows = max(_INT_MM_MIN_ROWS, -(-B // 8) * 8)
    if rows != B:
        q8 = torch.nn.functional.pad(q8, (0, 0, 0, rows - B))
    return torch._int_mm(q8, e8.t())[:B]


def int8_product(q8: torch.Tensor, qscale: torch.Tensor, e8: torch.Tensor,
                 row_scale: torch.Tensor) -> torch.Tensor:
    """Dequantized (B, N) f32 scores: (f32(s_i32) * qscale) * row_scale, in
    the reference's order; the int32 -> f32 cast rides the first multiply,
    the second runs in place."""
    s = torch.mul(int8_mm(q8, e8), qscale[:, None])
    s *= row_scale[None, :]
    return s


def int8_scores(queries: torch.Tensor, corpus_q: torch.Tensor,
                corpus_scale: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Dense int8 scores (B, N) f32, invalid rows -> -1e30."""
    q8, qscale = quantize_rows(queries)
    s = int8_product(q8, qscale, corpus_q, corpus_scale)
    s += ((valid - 1.0) * 1e30)[None, :]
    return s


def int8_topk_scan(queries: torch.Tensor, corpus_q: torch.Tensor,
                   corpus_scale: torch.Tensor, valid: torch.Tensor, k: int,
                   block_rows: int = 4096):
    """Blocked int8 scan -> (values (B, k) f32 desc, indices (B, k) i32),
    the reference's running top-k over int8 scores."""
    q8, qscale = quantize_rows(queries)

    def scores(lo, hi):
        s = int8_product(q8, qscale, corpus_q[lo:hi], corpus_scale[lo:hi])
        s += ((valid[lo:hi] - 1.0) * 1e30)[None, :]
        return s

    return _running_topk(scores, queries.shape[0], corpus_q.shape[0], k,
                         block_rows, queries.device)


# ---------------------------------------------------------------------------
# K3: per-block top-k (kernel + twin), then the merge
# ---------------------------------------------------------------------------

def exact_topk_reference(q: torch.Tensor, E: torch.Tensor, valid: torch.Tensor,
                         k: int, block_rows: int = 2048):
    """Plain twin of `exact_topk_cuda`: (G, B, k) f32 values, i32 rows.

    The TPU kernel runs k rounds of (max, first argmax, knock the winner out
    to -1e30) over each block's scores. While a live row remains that is the
    block's top-k ordered by value, then lower row; once only -1e30 is left
    every round picks the block's first row again (the knock-out value equals
    the masked score), so those slots hold (-1e30, block start)."""
    B = q.shape[0]
    N = E.shape[0]
    G = N // block_rows
    out_v = torch.empty((G, B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((G, B, k), dtype=torch.int32, device=q.device)
    per = max(1, _SCORE_BUDGET // (B * block_rows))
    for g0 in range(0, G, per):
        g1 = min(G, g0 + per)
        lo, hi = g0 * block_rows, g1 * block_rows
        s = dense_scores(q, E[lo:hi], valid[lo:hi])
        s = s.reshape(B, g1 - g0, block_rows).transpose(0, 1).reshape(-1, block_rows)
        v, pos = top_k(s, k)
        pos = torch.where(v > NEG, pos, 0)
        base = torch.arange(g0, g1, device=q.device) * block_rows
        out_v[g0:g1] = v.reshape(g1 - g0, B, k)
        out_i[g0:g1] = (pos.reshape(g1 - g0, B, k) + base[:, None, None]).to(torch.int32)
    return out_v, out_i


def exact_topk_cuda(q: torch.Tensor, E: torch.Tensor, valid: torch.Tensor,
                    k: int, block_rows: int = 2048):
    """Launch the CUDA block top-k kernel (csrc/exact_topk.cu): (G, B, k).

    k <= 16 keeps each query's top-k in shared memory behind a threshold;
    a larger k dumps the biased scores to a (G, b, block_rows) f32 buffer
    and selects each row's k best, b queries a launch (`dump_query_slice`)."""
    B, D = q.shape
    N = E.shape[0]
    _build.require_aligned("exact_topk_cuda", q=q, E=E)
    if q.device.type != "cuda" or E.device != q.device or valid.device != q.device:
        raise ValueError(f"exact_topk_cuda needs CUDA tensors on one card, got {q.device}")
    if q.dtype != torch.bfloat16 or E.dtype != torch.bfloat16 or valid.dtype != torch.float32:
        raise ValueError("exact_topk_cuda takes bf16 q and E and f32 valid")
    if not (q.is_contiguous() and E.is_contiguous() and valid.is_contiguous()):
        raise ValueError("exact_topk_cuda takes contiguous tensors")
    if E.shape[1] != D or valid.shape != (N,) or D % 16:
        raise ValueError(f"shapes q {tuple(q.shape)}, E {tuple(E.shape)}: D % 16 != 0 or mismatch")
    if block_rows % 64 or block_rows > 2048 or N % block_rows or not 1 <= k <= block_rows:
        raise ValueError(f"block_rows {block_rows} (a multiple of 64, <= 2048, "
                         f"dividing N={N}) and 1 <= k={k} <= block_rows")
    if N >= 1 << 31:
        raise ValueError(f"N={N}: rows are int32")
    G = N // block_rows
    out_v = torch.empty((G, B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((G, B, k), dtype=torch.int32, device=q.device)
    if B == 0 or G == 0:
        return out_v, out_i
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if k <= _TOPK_SMALL_K:
        err = lib.yt_exact_topk(q.data_ptr(), E.data_ptr(), valid.data_ptr(),
                                out_v.data_ptr(), out_i.data_ptr(), None,
                                B, N, D, k, block_rows, stream)
        exact_topk_cuda.launches += 1
        _build.check(err, "exact_topk_cuda")
        return out_v, out_i
    step = dump_query_slice(N)
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        dump = torch.empty((G, b1 - b0, block_rows), dtype=torch.float32, device=q.device)
        sv = torch.empty((G, b1 - b0, k), dtype=torch.float32, device=q.device)
        si = torch.empty((G, b1 - b0, k), dtype=torch.int32, device=q.device)
        err = lib.yt_exact_topk(q[b0:b1].data_ptr(), E.data_ptr(), valid.data_ptr(),
                                sv.data_ptr(), si.data_ptr(), dump.data_ptr(),
                                b1 - b0, N, D, k, block_rows, stream)
        exact_topk_cuda.launches += 1
        _build.check(err, "exact_topk_cuda")
        out_v[:, b0:b1] = sv
        out_i[:, b0:b1] = si
    return out_v, out_i


exact_topk_cuda.launches = 0


def exact_topk_pallas(queries: torch.Tensor, corpus: torch.Tensor,
                      valid: torch.Tensor, k: int, block_rows: int = 2048):
    """Fused scan: only (G, B, k) candidates leave the block step; a top-k
    over them merges the blocks. Same results as exact_topk_scan."""
    B = queries.shape[0]
    N = corpus.shape[0]
    if N % block_rows:
        raise ValueError(f"N={N} % block_rows={block_rows} != 0")
    q = queries.to(torch.bfloat16).contiguous()
    E = corpus.to(torch.bfloat16)
    if queries.device.type == "cuda":
        vals, idx = exact_topk_cuda(q, E, valid, k, block_rows)
    elif queries.device.type == "cpu":
        vals, idx = exact_topk_reference(q, E, valid, k, block_rows)
    else:
        raise ValueError(f"exact_topk_pallas: unsupported device {queries.device}")
    G = N // block_rows
    cat_v = vals.transpose(0, 1).reshape(B, G * k)
    cat_i = idx.transpose(0, 1).reshape(B, G * k)
    out_v, pos = top_k(cat_v, k)
    return out_v, cat_i.gather(1, pos)


# ---------------------------------------------------------------------------
# K1: per-group max/argmax (kernel + twin), then the merge
# ---------------------------------------------------------------------------

def grouped_max_reference(q: torch.Tensor, E: torch.Tensor, valid: torch.Tensor,
                          group: int):
    """Plain twin of `grouped_max_cuda`: (B, N/group) f32 values, i32 rows.

    For each query and each run of `group` consecutive rows, the max of
    q.E + (valid - 1) * 1e30 and the LAST row that reaches it, as the TPU
    kernel's max(where(s >= m, lane, -1)) picks. A group with no live row
    scores -1e30 throughout and so emits (-1e30, its last row)."""
    B = q.shape[0]
    N = E.shape[0]
    out_v = torch.empty((B, N // group), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, N // group), dtype=torch.int32, device=q.device)
    lane = torch.arange(group, device=q.device, dtype=torch.int32)
    step = group * max(1, _SCORE_BUDGET // (B * group))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        s3 = dense_scores(q, E[lo:hi], valid[lo:hi]).reshape(B, -1, group)
        m = s3.amax(dim=2)
        am = torch.where(s3 >= m[:, :, None], lane, -1).amax(dim=2)
        base = torch.arange(lo, hi, group, device=q.device, dtype=torch.int32)
        out_v[:, lo // group:hi // group] = m
        out_i[:, lo // group:hi // group] = am + base
    return out_v, out_i


def grouped_max_cuda(q: torch.Tensor, E: torch.Tensor, valid: torch.Tensor, group: int):
    """Launch the CUDA grouped-max kernel (csrc/fused_scan.cu): (B, N/group)."""
    B, D = q.shape
    N = E.shape[0]
    _build.require_aligned("grouped_max_cuda", q=q, E=E, valid=valid)
    if q.device.type != "cuda" or E.device != q.device or valid.device != q.device:
        raise ValueError(f"grouped_max_cuda needs CUDA tensors on one card, got {q.device}")
    if q.dtype != torch.bfloat16 or E.dtype != torch.bfloat16 or valid.dtype != torch.float32:
        raise ValueError("grouped_max_cuda takes bf16 q and E and f32 valid")
    if not (q.is_contiguous() and E.is_contiguous() and valid.is_contiguous()):
        raise ValueError("grouped_max_cuda takes contiguous tensors")
    if E.shape[1] != D or valid.shape != (N,) or D % 16:
        raise ValueError(f"shapes q {tuple(q.shape)}, E {tuple(E.shape)}: D % 16 != 0 or mismatch")
    if group < 1 or 2048 % group or N % group:
        raise ValueError(f"group {group}: a power of two <= 2048 that divides N={N}")
    if N >= 1 << 31:
        raise ValueError(f"N={N}: rows are int32")
    out_v = torch.empty((B, N // group), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, N // group), dtype=torch.int32, device=q.device)
    if B == 0 or N == 0:
        return out_v, out_i
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.yt_grouped_max(q.data_ptr(), E.data_ptr(), valid.data_ptr(),
                             out_v.data_ptr(), out_i.data_ptr(), B, N, D, group, stream)
    grouped_max_cuda.launches += 1
    _build.check(err, "grouped_max_cuda")
    return out_v, out_i


grouped_max_cuda.launches = 0


def grouped_topk_pallas(queries: torch.Tensor, corpus: torch.Tensor,
                        valid: torch.Tensor, k: int, block_rows: int = 2048,
                        group: int = 256):
    """Fused scan returning the approx top-k under grouped-winner semantics:
    at most one hit per `group` consecutive rows, like lax.approx_max_k.
    `block_rows` is the reference's layout contract (N % block_rows == 0,
    block_rows % group == 0); the result does not depend on it."""
    N = corpus.shape[0]
    if N % block_rows or block_rows % group:
        raise ValueError(f"N={N} % block_rows={block_rows} or block_rows % group={group} != 0")
    q = queries.to(torch.bfloat16).contiguous()
    E = corpus.to(torch.bfloat16)
    if queries.device.type == "cuda":
        vals, idx = grouped_max_cuda(q, E, valid, group)
    elif queries.device.type == "cpu":
        vals, idx = grouped_max_reference(q, E, valid, group)
    else:
        raise ValueError(f"grouped_topk_pallas: unsupported device {queries.device}")
    out_v, pos = top_k(vals, k)
    return out_v, idx.gather(1, pos)


# ---------------------------------------------------------------------------
# topology narrow tier: a per-query scan of the routed rows only
# ---------------------------------------------------------------------------

def routed_gather_topk(queries: torch.Tensor, corpus: torch.Tensor,
                       row_idx: torch.Tensor, row_ok: torch.Tensor, k: int):
    """Score only each query's routed rows: (B, D) queries, (N, D) bf16
    corpus, (B, R) row indices (padding 0) and (B, R) f32 liveness ->
    (values (B, k) f32 desc, ROW indices (B, k) i32); padding scores -1e30.

    The rows are gathered into a (B, R, D) bf16 buffer and scored by a
    batched bf16 product with f32 sums (cuBLAS with an f32 output on the
    card; an f32 product of the bf16-rounded values on the CPU); the top-k
    keeps lax.top_k's tie order (`select.top_k`). Work is B*R*D, against
    B*N*D plus one shared corpus read for the full scan."""
    B, R = row_idx.shape
    rows = corpus.index_select(0, row_idx.reshape(-1).long()).reshape(B, R, -1)
    q = queries.to(torch.bfloat16)[:, :, None]
    if rows.device.type == "cuda":
        s = torch.bmm(rows.to(torch.bfloat16), q, out_dtype=torch.float32)
    else:
        s = torch.bmm(rows.to(torch.bfloat16).float(), q.float())
    s = s[:, :, 0] + (row_ok - 1.0) * 1e30
    vals, pos = top_k(s, k)
    return vals, row_idx.gather(1, pos).to(torch.int32)
