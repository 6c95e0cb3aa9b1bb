"""Product quantization: train / encode / ADC scan / exact rerank.

Port of yams_tpu/ops/pq.py. Everything here is plain PyTorch on the device
of its inputs (the reference's versions are XLA, not Pallas):

  - pq_train: per-subspace k-means, all m subspaces in one batched einsum
    per Lloyd step. The initial centroids are drawn with a torch.Generator
    seeded like the reference's PRNGKey, which gives other rows than
    jax.random.choice; `_lloyd` takes the initial centroids, so a test can
    hand it the reference's and compare the steps.
  - pq_encode: nearest centroid per subspace (argmax of ip - |c|^2 / 2).
  - pq_adc_topk: ADC scan -> top-k over row chunks; score = sum over
    subspaces of the bf16-rounded LUT entry of each code, summed in f32 in
    subspace order (the reference's one-hot bf16 einsum with f32
    accumulation, written as the gather it stands for); optional grouped
    windows and doc-filter pushdown, as in the reference.
  - exact_rerank: gather the ADC candidates' bf16 rows, rescore in f32,
    top-k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scan import NEG, _chunk_rows
from .select import top_k

_ENCODE_BUDGET = 1 << 25   # f32 entries of the (m, rows, ksub) encode product


@dataclasses.dataclass
class PQCodebook:
    centroids: torch.Tensor  # (m, ksub, dsub) f32
    m: int
    ksub: int
    dsub: int

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, D) -> (m, n, dsub)"""
    n, D = x.shape
    return x.reshape(n, m, D // m).transpose(0, 1)


def _assign(sub: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(m, n, dsub) x (m, ksub, dsub) -> (m, n) nearest centroid: L2 ==
    argmax(ip - 0.5 * |c|^2), first index on ties."""
    cnorm = 0.5 * (cent * cent).sum(dim=-1)                 # (m, ksub)
    ip = torch.einsum("mnd,mkd->mnk", sub, cent)
    return torch.argmax(ip - cnorm[:, None, :], dim=-1)


def _lloyd(sub: torch.Tensor, cent: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` Lloyd steps of every subspace from initial centroids `cent`;
    an empty cluster keeps its centroid."""
    ksub = cent.shape[1]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(_assign(sub, cent), ksub).float()
        sums = torch.einsum("mnk,mnd->mkd", onehot, sub)
        counts = onehot.sum(dim=1)[..., None]                # (m, ksub, 1)
        cent = torch.where(counts > 0, sums / counts.clamp_min(1.0), cent)
    return cent


def pq_train(vectors: np.ndarray, m: int = 32, ksub: int = 256,
             train_limit: int = 4096, iters: int = 10, seed: int = 0, *,
             device: torch.device) -> PQCodebook:
    """ksub=256 is the reference profile; ksub=16 the capacity tier whose
    codes pack two per byte (pq4_pack). Trains on `device`."""
    n, D = vectors.shape
    if D % m:
        raise ValueError(f"dim {D} not divisible by m={m}")
    if n > train_limit:
        rng = np.random.default_rng(seed)
        vectors = vectors[rng.choice(n, train_limit, replace=False)]
    n = len(vectors)
    ksub = min(ksub, max(n, 2))
    sub = _split(torch.as_tensor(np.asarray(vectors, np.float32)).to(device), m)
    gen = torch.Generator().manual_seed(seed)
    init = torch.randint(0, n, (m, ksub), generator=gen).to(device)
    cent = torch.gather(sub, 1, init[:, :, None].expand(-1, -1, D // m))
    return PQCodebook(centroids=_lloyd(sub, cent, iters), m=m, ksub=ksub, dsub=D // m)


def pq_encode(codebook: PQCodebook, vectors: np.ndarray | torch.Tensor) -> torch.Tensor:
    """(n, D) -> (n, m) uint8 codes on the codebook's device. Host rows are
    uploaded in chunks, so a large host matrix never sits on the device whole."""
    cent = codebook.centroids
    rows = max(1, _ENCODE_BUDGET // (codebook.m * codebook.ksub))
    out = []
    for lo in range(0, len(vectors), rows):
        x = torch.as_tensor(vectors[lo:lo + rows]).to(cent.device, torch.float32)
        out.append(_assign(_split(x, codebook.m), cent).t().to(torch.uint8))
    if not out:
        return torch.empty((0, codebook.m), dtype=torch.uint8, device=cent.device)
    return torch.cat(out)


def pq4_pack(codes: np.ndarray | torch.Tensor) -> np.ndarray:
    """(n, m) uint8 codes with values < 16 -> (n, m//2) packed nibbles.

    Even subspaces go to the low nibble, odd to the high nibble."""
    c = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    if c.shape[1] % 2:
        raise ValueError(f"pack4 needs an even code count, got {c.shape[1]}")
    if c.max(initial=0) >= 16:
        raise ValueError("pack4 codes must be < 16 (train with ksub <= 16)")
    return (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8)


def pq4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """(n, m//2) packed nibbles -> (n, m) codes, subspace s = 2p + parity."""
    return torch.stack([packed & 0x0F, packed >> 4], dim=2).reshape(packed.shape[0], -1)


def pq_lut(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, D) queries x (m, ksub, dsub) codebook -> (B, m, ksub) f32 LUT."""
    m, _, dsub = centroids.shape
    qsub = queries.float().reshape(queries.shape[0], m, dsub)
    return torch.einsum("bmd,mkd->bmk", qsub, centroids.float())


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, m, ksub) bf16 LUT x (R, m) codes -> (B, R) f32: the m entries
    summed in f32 in subspace order."""
    codes = codes.long()
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for s in range(lut.shape[1]):
        acc += lut[:, s].float()[:, codes[:, s]]
    return acc


def grouped_max(s: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, R) -> per `group` consecutive columns (max, first argmax column)."""
    sg = s.reshape(s.shape[0], -1, group)
    arg = torch.argmax(sg, dim=2)
    base = torch.arange(sg.shape[1], device=s.device) * group
    return sg.gather(2, arg[:, :, None])[:, :, 0], base[None, :] + arg


def pq_adc_topk(queries: torch.Tensor, codes: torch.Tensor, centroids: torch.Tensor,
                valid: torch.Tensor, k: int, block_rows: int = 8192,
                packed4: bool = False, group: int = 1,
                slots: torch.Tensor | None = None,
                doc_mask: torch.Tensor | None = None):
    """ADC scan -> (values (B, k) f32, rows (B, k) i32), the reference's
    block scan with a running top-k: group=1 keeps the exact ADC top-k;
    group>1 keeps one candidate per `group`-row window. slots + doc_mask
    ((1 | B, num_slots) 0/1) push a doc filter into the scan before
    selection."""
    if block_rows % group:
        raise ValueError(f"block_rows {block_rows} % group {group} != 0")
    B = queries.shape[0]
    N = codes.shape[0]
    dev = queries.device
    lut = pq_lut(queries, centroids).to(torch.bfloat16)
    filtered = doc_mask is not None and slots is not None
    vals = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    idx = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    step = _chunk_rows(B, block_rows)
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        c = codes[lo:hi]
        s = adc_scores(lut, pq4_unpack(c) if packed4 else c)
        s += ((valid[lo:hi] - 1.0) * 1e30)[None, :]
        if filtered:
            sl = slots[lo:hi].long()
            dm = doc_mask[:, sl.clamp_min(0)]                 # (1 | B, R)
            dm = torch.where(sl[None, :] >= 0, dm, 0.0)
            s = s + (dm - 1.0) * 1e30
        if group > 1:
            s, local = grouped_max(s, group)
        else:
            local = torch.arange(hi - lo, device=dev).expand(B, -1)
        vals, pos = top_k(torch.cat([vals, s], dim=1), k)
        idx = torch.cat([idx, local + lo], dim=1).gather(1, pos)
    return vals, idx.to(torch.int32)


def exact_rerank(queries: torch.Tensor, E: torch.Tensor, cand_idx: torch.Tensor,
                 cand_vals: torch.Tensor, cand_valid_floor: float, k: int):
    """Gather candidates, rescore exactly (bf16 operands, f32 sums), top-k.

    Candidates whose ADC score is at or below cand_valid_floor were emitted
    only because the scan ran out of valid rows; they stay masked, so deleted
    rows are never resurrected."""
    vecs = E[cand_idx.long().clamp_min(0)].float()             # (B, C, D)
    q = queries.to(torch.bfloat16).float()
    s = torch.einsum("bcd,bd->bc", vecs, q)
    s = torch.where((cand_idx >= 0) & (cand_vals > cand_valid_floor), s, NEG)
    v, pos = top_k(s, k)
    return v, cand_idx.gather(1, pos)
