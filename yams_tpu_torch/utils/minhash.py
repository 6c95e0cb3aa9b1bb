"""MinHash near-duplicate detection (semantic_dedupe).

Parity: Simeon's minhash retrieval util + the MCP semantic_dedupe tool
(mcp_server_tool_registry.cpp). Signatures over word 3-shingles; LSH banding
finds candidate pairs without O(n^2) comparisons.

Copied from yams_tpu/utils/minhash.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import numpy as np

from ..embed.simeon import _hash_token_cached, tokenize

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def shingle_hashes(text: str, k: int = 3) -> np.ndarray:
    toks = tokenize(text, 4096)
    if len(toks) < k:
        toks = toks + ["" for _ in range(k - len(toks))]
    hs = np.array([_hash_token_cached(t) for t in toks], dtype=np.uint64)
    out = hs[: len(hs) - k + 1].copy()
    with np.errstate(over="ignore"):
        for j in range(1, k):
            out = out * np.uint64(0x100000001B3) ^ hs[j : len(hs) - k + 1 + j]
    return out


def minhash_signature(text: str, num_perm: int = 64, seed: int = 7) -> np.ndarray:
    """(num_perm,) uint64 signature via xor-permutations of shingle hashes."""
    sh = shingle_hashes(text)
    if len(sh) == 0:
        return np.zeros(num_perm, np.uint64)
    rng = np.random.default_rng(seed)
    salts = rng.integers(0, 2**63, num_perm, dtype=np.uint64)
    with np.errstate(over="ignore"):
        # h_p(x) = splitmix-ish mix of (x ^ salt_p); min over shingles
        m = sh[None, :] ^ salts[:, None]
        m = (m * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        m ^= m >> np.uint64(31)
    return m.min(axis=1)


def jaccard_estimate(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    return float(np.mean(sig_a == sig_b))


def find_near_duplicates(
    texts: dict[int, str],
    threshold: float = 0.8,
    num_perm: int = 64,
    bands: int = 16,
) -> list[tuple[int, int, float]]:
    """[(id_a, id_b, estimated_jaccard)] for pairs above threshold (LSH-banded)."""
    sigs = {i: minhash_signature(t, num_perm) for i, t in texts.items()}
    rows = num_perm // bands
    buckets: dict[tuple, list[int]] = {}
    for i, sig in sigs.items():
        for b in range(bands):
            key = (b, tuple(sig[b * rows : (b + 1) * rows].tolist()))
            buckets.setdefault(key, []).append(i)
    seen: set[tuple[int, int]] = set()
    out = []
    for members in buckets.values():
        for x in range(len(members)):
            for y in range(x + 1, len(members)):
                a, b = sorted((members[x], members[y]))
                if (a, b) in seen:
                    continue
                seen.add((a, b))
                j = jaccard_estimate(sigs[a], sigs[b])
                if j >= threshold:
                    out.append((a, b, j))
    return sorted(out, key=lambda t: -t[2])
