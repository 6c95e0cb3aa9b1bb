"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero; each prints its
seconds):

  0. card identity (nvidia-smi name and power limit);
  1. each CUDA kernel built from yams_tpu_torch/csrc (one nvcc per source,
     in parallel) and held against its plain PyTorch twin on the card, with
     both timed: gear hash and SHA-256 bit-exact; K3 (exact_topk_cuda) at
     edge shapes (B 1/3/64 and 255/256/257; k 1/10/16 on its threshold
     epilogue and 17/100/128/129/2,048 on its score dump; duplicate rows,
     ties across 128-row tile and block edges, 24 exact ties inside one
     128-row tile (more than a query's 20 slots: its lowest rows must
     win), scores rising with the row, an all-dead block, a block with
     k-1 live rows; block_rows 64, 192 and 2,048) and at the bench shape
     (1,048,576 x 768, B 1,024, k 10, beside dot_f32 on the same operands;
     k 17/100/128 on the score dump; and k 10 with rising scores), values
     within 1e-4, every id a live row of its slot's own block and every
     differing id a near-tie; K4 (pq4_adc_cuda) at edge
     shapes (m 8/32/48/50/96/200, groups 1-256, B 1/3/127/128/129/256, dead
     tiles, ragged last tiles) and at the capacity shape (16,777,216 rows,
     m 48, group 128, B 256), with the QPS of the whole top-64 selection,
     each case bit-equal to the twin or (the tensor cores' f32 sum rounds
     otherwise) within 1e-4 with every row a live row of its own window
     and every differing row a near-tie; K1
     (grouped_max_cuda) and K2 (windowed_scan_cuda) at edge shapes (B
     1/3/64; group 64/256; a dead group; an all-masked window, which must
     give (-1e30, 0); duplicate rows for ties; a ragged last tile; N of 1
     and 3 spans), at the edges of their 128-row x 256-query tiling (B
     127/129/255/257; groups of 1, 8, 16, 32, 64 and 2,048 rows; a ragged
     last 128-row tile whose live rows all score below 0; D 80), with a
     misaligned E refused before any launch, and at the experiments'
     shapes, values within 1e-4, every id a live row of its own group or
     window and every differing id a near-tie, each
     kernel timed beside dot_f32 (cuBLAS) on the same operands;
  2. add: a 128 MiB seeded zipf-word payload through device_chunk_hash
     (gear-hash CDC + SHA-256 on the card), checked against the host chunker
     and hashlib;
  3. search: a SearchEngine with the default configs fed 70,000 seeded
     documents, a 64-query search_batch on the card, 16 of its queries
     checked against the same state searched on the CPU plain path (with the
     engine's prefilter guard as configured, and with it off so the BM25
     prefilter tier runs too); it reports whether the port's own native
     sketch library built, and the add_documents time that followed;
  4. the hybrid query at the bench shape (1,048,576 x 768 clustered bf16
     corpus, 65,536 packed postings rows of 1,024), QPS and recall@10;
  5. the vector store: a 1,048,576 x 768 clustered VectorIndex in which
     each of 1,024 query rows has 9 planted near-copies; search with K3
     against the plain scan; build_pq(m=48, ksub=16, pack4, group=64) and
     an unfiltered search_pq on K4, whose recall@10 against the exact oracle
     must be within 0.01 of the plain ADC route's; a filtered search_pq that
     must honor its mask;
  6. the engine's PQ tier: phase 3's state carried by convert.py into an
     engine="pq4" engine with pq_tier_enabled and ensure_pq(), a 64-query
     search_batch, 16 queries checked against the CPU plain path;
  7. the two top-C experiments at the reference scripts' shapes:
     profile_grouped (K1: 1,003,520 x 768 unit-normal, B 256, 8 batches,
     block 4,096, group 256, C 32) and exp_flash_topk (K2: 1,015,808 x 768
     clustered, B 1,024, 8 batches, C 32), each against the matmul + top-C
     path: QPS and recall@10 of both paths against the exact top-10;
  8. the streaming blocked scan and the int8 corpus tier: hybrid_query at
     4,194,304 x 768 (phase 4's generator and postings, B 1,024, C 32,
     blocks of 262,144 rows), bf16 and int8 (the same corpus quantized on
     the card, held to quantize_int8 on a slice), each against its
     materialized program at the largest B whose (B, rows) scores fit (ids
     equal except near-ties within 1e-4, values within 1e-5), with QPS
     (median of 5 windows), peak memory (the streaming peak must stay below
     the (B, rows) f32 bytes at B 1,024), int8 recall@10 against bf16
     (>= 0.85), the split between the products and the per-block top-C,
     and torch._int_mm against dot_f32 at one block's shape with their
     bounds; then a 65,536-doc flat engine, bf16 and int8, with lowered
     streaming thresholds: search_batch must pick the streaming tier itself
     (unfiltered, a shared filter, per-query filters), then
     remove_document, touch_hot and record_feedback, each intent and
     search_expanded, every search with top-10 overlap 1.0 against the same
     engine on the CPU (16 queries), no removed doc returned, and stats()
     counting the searches;
  9. the engine as the service layer opens and serves it: a KG over phase
     3's documents in a temporary SQLite file, built with the graph
     service's ingest calls (16,384 entity nodes labelled with 1-3 words of
     the documents' text, each document linked to 1-5 of the labels it
     contains, drawn by zipf, aliases, co-occurrence edges) and every node
     label embedded into the entity side index; phase 3's card engine and
     its CPU twin each open their own store over the file. 64 queries (half
     naming an entity label) timed with and without the KG leg, the entity
     leg's device search apart from the host KG work; on 16 queries the
     card's top-10 ids equal the CPU's with scores within 1e-4 (ties
     named) with the KG leg and graph rerank, with semantic_rescue_slots=2
     and with the tuner through 32 record_feedback calls (the same arm
     each time); at least half the entity-naming queries reach a result
     with kg_score > 0. Then both indexes saved and reopened in a fresh
     card engine (slot map restored from the metadata table) giving the
     same 64 results; phase 6's PQ4 index (m 32, windows of 64) through K3
     (search, use_pallas) and K4 (unfiltered search_pq) before the save
     and after the reload, equal; an int8 index reloaded as int8 with
     equal codes;
 10. the service layer through the port's own daemon on the card (a
     YamsDaemon on a background thread with a real AF_UNIX socket): a
     seeded tree of 2,048 zipf-word notes (96-1,536 words) in 64
     directories, a 48 MiB seeded blob and a copy of it, added with one
     add_path (every file added, none failed, the copy deduped whole,
     gear_hash_cuda and sha256_cuda launched, the blob read back
     bit-exact; files/s and MB/s); 256 async adds and `queue wait_idle`
     (every job processed, none failed; KG nodes > 0); 64 queries (half
     naming words of the tree), sequential (p50, p99) and from 8 client
     threads through the SearchBatcher (QPS median of 5 windows, p50, p99,
     requests a batch), and the split of one steady request; 16 queries
     (hybrid, keyword, semantic, path_glob, tags) held against a CPU
     AppContext on a copy of the checkpointed data dir; the CLI
     (`python -m yams_tpu_torch.cli --json search`) through the socket
     printing the daemon's hits; a restart giving the same document counts
     and the same 64 answers, and a restart as int8 serving the int8 tier
     with top-10 overlap >= 0.85 against bf16;
 11. topology routing and the repair service: (a) on phase 3's card engine
     (140,000 rows, D 384, auto_k 300) rebuild_topology with the connected
     and k-means engines and the Louvain build over the index's first 32,768
     rows (its host passes take ~23 s at 140,000), each build's wall time
     and stages (the
     kNN self-join, label propagation or Louvain passes, Lloyd steps, host
     packaging), one kmeans_step's device time against its bound, two card
     k-means builds bit-identical, the card build against the CPU twin's
     build of the same host vectors (>= 0.99 of rows in the same cluster,
     each differing row named with its top-2 margin), and the connected
     labels of the first 16,384 rows equal to the CPU's; (b) a k-means
     build at 1,048,576 x 768 (phase 4's generator, K 300): seconds,
     kmeans_step against its bound, peak memory; (c) search_batch(64) and
     (8) under the off, shadow, narrow (abstention gate at 0, so routes
     commit) and augment policies on (a)'s k-means topology: steady ms and
     the route's host ms; shadow's top-10 equal to off's on all 64; every
     narrow hit inside its query's routed slots; the narrow gather tier at
     B 8 and not at B 64; card == CPU twin (the topology carried by
     convert.load_topology) on 16 queries per policy and at B 8 for the
     gather tier; then the route-risk calibration available after the
     shadow traffic and auto-promotion acting as configured; (d)
     scripts/bench_narrow.py at its reference shape (1,000,448 x 768, 4,096
     clusters, top-4 routing, k 10, C 32) at B 1/8/32/128: QPS and device
     ms of the full scan, the routed gather and the contiguous slices,
     narrow recall@10 >= 0.9, routed_gather_topk against its bytes bound;
     (e) a daemon on phase 10's data dir: `repair --ops topology` reporting
     auto_k clusters over the live rows, the default shadow policy's 64
     answers unchanged with its counters moving, a full repair with no op
     "failed", a dry run, doctor green naming the card, and the CLI's
     repair and doctor through the socket equal to the daemon's;
 12. the neural embedding path and the late-interaction tier, at the
     in-repo realtext_bert_d192 checkpoint's full width (3 layers, D 192, 6
     heads, T up to 128): (a) HFBertEncoder.encode (bf16) on 4,096 of
     phase 3's texts (texts/s, tokens/s, tokenizer and forward seconds),
     the batch's forward at each bucket T 16-128 and one layer at 1,024 x
     128 against their bounds, the layer's attention against
     F.scaled_dot_product_attention on the same q, k, v; the card against
     the port's CPU forward on 64 texts: f32 within 1e-4, bf16 cosine >=
     0.99, the same for encode_tokens and for NeuralEncoder at its
     defaults on the port's seeded weights; (b) a SearchEngine with
     create_provider("hf") over phase 3's documents (the tokenizer timed
     on 1,024 first; the count cut if the add's tokenizer would pass ~60
     s): add_documents split into tokenizer, forward and index,
     search_batch(64) first and steady, and card == CPU (results_agree,
     ties named) on 2,048-document engines at f32 compute, 16 queries;
     (c) the ColBERT tier and the fragment arm on 16,384 documents (one
     forward a document for its tokens and one for its sentences, as in
     the reference): search_batch(64) steady with late_interaction_ms,
     then with fragment_geometry_ms; a doc holding the query's exact
     tokens first and its score risen by the tiers; card == CPU with the
     tiers on; maxsim_scores and the token-index gather at search_batch's
     shape against their bounds, one torch.matmul + max and index_select;
     (d) matryoshka_topk at 1,048,576 x 768 (phase 4's generator with
     phase 5's planted copies), B 1,024, k 10, d0 192 and 384: recall@10
     against the exact scan (>= 0.9), QPS, ms against the bound and the
     exact scan; (e) an AppContext with embedding.provider="hf" through
     the daemon on a fresh data dir: add_path of 256 notes and a 48 MiB
     blob with its copy, searches, model_load hf, model_status,
     embed_batch, the CLI's search and model list equal to the daemon's,
     16 searches equal across a restart.

The kernel launch counters are zeroed just before each path and read just
after: the add path (phases 2-3) must launch gear_hash_cuda and
sha256_cuda, the vector store (phase 5) exact_topk_cuda and pq4_adc_cuda,
the engine's PQ tier (phase 6) must launch pq4_adc_cuda zero times (it
always pushes a doc mask into the scan, and K4 serves the unfiltered scan
only), and the experiments (phase 7) grouped_max_cuda and
windowed_scan_cuda; phase 8's path runs torch operations only, and its
counts are printed; phase 9 must launch exact_topk_cuda and pq4_adc_cuda
(on the PQ4 index before the save and after the reload), and phase 10's
add gear_hash_cuda and sha256_cuda (on the blob); phase 11's path runs
torch operations only, and its counts are printed with its device
operations' times and bounds; phase 12's daemon add must launch
gear_hash_cuda and sha256_cuda (on the blob), and its device operations
(the BERT forward and layer, MaxSim, the token-index gather, matryoshka)
are printed with their calls on the path, times, bounds and yardsticks. At
the end no module of
yams_tpu, jax, jaxlib or flax
may be loaded. The second-last line is the kernels' JSON record (each with
its launches, error, time, twin's time and bound), the last line the device
record.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import subprocess
import sys
import time
import traceback
import types

import numpy as np
import torch

from yams_tpu_torch.scripts._common import cuda_ms

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# H100 SXM peaks at 700 W. The bf16 and memory rates are NVIDIA's data
# sheet's (dense). The data sheet's 67 TFLOP/s of f32 counts an FMA as two
# operations (132 SMs x 128 f32 lanes x 2 x 1.98 GHz); a plain f32 add or
# compare is one operation a lane a clock, half that, and 32-bit integer
# work runs on 64 lanes a clock per SM, half that again.
PEAK_BF16 = 989e12                 # FLOP/s, dense bf16 tensor cores
PEAK_CORE = 132 * 128 * 1.98e9     # f32 adds or compares /s (~33.5e12)
PEAK_INT = 132 * 64 * 1.98e9       # 32-bit integer ops /s (~16.7e12)
PEAK_BYTES = 3.35e12               # B/s, HBM3


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes that must
    move (each input read once, each output written once) over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def zipf_text(n_bytes: int, seed: int) -> bytes:
    """bench.py's ingest payload generator, scaled: zipf(1.3) over 4,096 words."""
    rng = np.random.default_rng(seed)
    words = [f"word{i}" for i in range(4096)]
    zipf = rng.zipf(1.3, size=n_bytes // 6 + 1)   # every word + space >= 6 B
    data = " ".join(np.asarray(words, dtype=object)[zipf % 4096].tolist()).encode()
    if len(data) < n_bytes:
        raise RuntimeError("zipf text generator came up short")
    return data[:n_bytes]


# -- phase 0 ------------------------------------------------------------------
def phase0_identity() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(line.splitlines()[0] if line else "nvidia-smi printed nothing")
    return line


# -- phase 1 ------------------------------------------------------------------
def phase1_kernels(dev) -> dict:
    from yams_tpu_torch import _build
    from yams_tpu_torch.ingest.device_pipeline import payload_tensor
    from yams_tpu_torch.ops import cdc, sha256

    t = time.perf_counter()
    lib = _build.build()
    log(f"[phase1] kernels built in {time.perf_counter() - t:.2f} s -> {lib.name}")
    rng = np.random.default_rng(SEED)

    # gear hash: edge lengths, tile edges, then 64 MiB of seeded bytes
    tile = 2048
    for n in (1, 31, 32, 33, tile - 1, tile, tile + 1, tile + 31, 2 * tile + 5):
        g = cdc.gear_values(payload_tensor(rng.bytes(n), dev))
        check(torch.equal(cdc.gear_hash_cuda(g), cdc.gear_hash_reference(g)),
              f"gear_hash_cuda == twin at n={n}")
    g = cdc.gear_values(payload_tensor(rng.bytes(64 << 20), dev))
    got, want = cdc.gear_hash_cuda(g), cdc.gear_hash_reference(g)
    torch.cuda.synchronize()
    gear_err = int((got.long() - want.long()).abs().max())
    check(gear_err == 0, "gear_hash_cuda == twin on 64 MiB")
    gear_ms = cuda_ms(lambda: cdc.gear_hash_cuda(g), 20)
    gear_plain_ms = cuda_ms(lambda: cdc.gear_hash_reference(g), 3)
    log(f"[phase1] gear_hash 64 MiB: cuda {gear_ms:.4f} ms, plain {gear_plain_ms:.4f} ms")
    del g, got, want

    # sha256 vs hashlib: 4,096 chunks, edge lengths + random up to 256 KiB
    lengths = [0, 55, 56, 63, 64, 119, 120]
    lengths += [int(x) for x in rng.integers(0, 256 * 1024 + 1, 4096 - len(lengths))]
    blob = rng.bytes(sum(lengths))
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    buf = payload_tensor(blob, dev)
    st = torch.from_numpy(starts).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dig = sha256.sha256_cuda(buf, st, ln).cpu().numpy()
    for i, (s, n) in enumerate(zip(starts, lengths)):
        check(dig[i].tobytes() == hashlib.sha256(blob[s:s + n]).digest(),
              f"sha256_cuda == hashlib on chunk {i} (len {n})")
    sha_big_ms = cuda_ms(lambda: sha256.sha256_cuda(buf, st, ln), 3)
    log(f"[phase1] sha256 4096 chunks ({len(blob) / 2**20:.1f} MiB): "
        f"cuda {sha_big_ms:.3f} ms; all digests == hashlib")
    del buf

    # sha256 vs its plain twin: 2,048 rows of 4 KiB (the twin is a Python
    # loop of ~45 torch launches per round, so it is timed on short rows)
    rows, width = 2048, 4096
    tb = payload_tensor(rng.bytes(rows * width), dev)
    tst = torch.arange(rows, dtype=torch.int64, device=dev) * width
    tln = torch.tensor(rng.integers(width - 64, width + 1, rows), dtype=torch.int32,
                       device=dev)
    a = sha256.sha256_cuda(tb, tst, tln)
    b = sha256.sha256_reference(tb, tst, tln)
    sha_err = int((a.int() - b.int()).abs().max())
    check(sha_err == 0, "sha256_cuda == sha256_reference")
    sha_ms = cuda_ms(lambda: sha256.sha256_cuda(tb, tst, tln), 10)
    sha_plain_ms = cuda_ms(lambda: sha256.sha256_reference(tb, tst, tln), 1)
    log(f"[phase1] sha256 {rows}x{width} B: cuda {sha_ms:.3f} ms, plain {sha_plain_ms:.1f} ms")
    n = 64 << 20
    lens = tln.long()
    blocks = int(((lens + 9 + 63) // 64).sum())
    return {
        # int32 gear values in, int32 hashes out; h = (h << 1) + g: 2 ops a byte
        "gear_hash_cuda": dict(max_abs_err=gear_err, ms=gear_ms, plain_ms=gear_plain_ms,
                               shape="64 MiB (67,108,864 positions)",
                               **bound(8.0 * n, 2.0 * n, PEAK_INT)),
        # message bytes, starts and lengths in, 32-byte digests out; ~2,200
        # 32-bit integer ops per 64-byte block (64 rounds + the schedule)
        "sha256_cuda": dict(max_abs_err=sha_err, ms=sha_ms, plain_ms=sha_plain_ms,
                            shape=f"{rows} rows x ~{width} B",
                            ms_4096_chunks_to_256KiB=sha_big_ms,
                            **bound(float(lens.sum()) + 44.0 * rows, 2200.0 * blocks,
                                    PEAK_INT)),
    }


def check_topk(what: str, kv, ki, tv, ti, true_score, owns, tol: float,
               ordered: bool = True) -> tuple[float, int]:
    """A kernel's top-k (kv, ki) against its twin's (tv, ti), ranks on the
    last axis. Values agree within tol; the -1e30 slots are identical; the id
    in every live slot is a live row of the slot's own part of the partition
    (owns(positions, ids): its row block, window or group); an id that
    differs from the twin's must truly score within tol of the twin's value
    at its rank (a near-tie), by true_score(positions, ids); when `ordered`
    (a ranked list, not one winner per part of a partition), no id comes
    twice in a list and equal kernel values list the lower row first.
    -> (max value error, #ids that differ)."""
    live = tv > -1e29
    err = float((kv - tv).abs()[live].max()) if bool(live.any()) else 0.0
    check(err <= tol, f"{what}: values within {tol} of the twin (max err {err})")
    check(torch.equal(kv[~live], tv[~live]) and torch.equal(ki[~live], ti[~live]),
          f"{what}: -1e30 slots equal the twin's")
    check(bool(owns(live.nonzero(), ki[live]).all()),
          f"{what}: every id is a live row of its slot's own part")
    diff = (ki != ti) & live
    if bool(diff.any()):
        true = true_score(diff.nonzero(), ki[diff])
        check(bool(((true - tv[diff].double()).abs() <= tol).all()),
              f"{what}: every differing id is a near-tie")
    if ordered:
        rank = torch.arange(ki.shape[-1], device=ki.device)
        ids = torch.where(live, ki.long(), -1 - rank).sort(dim=-1).values   # dead slots unique
        check(bool((ids[..., 1:] != ids[..., :-1]).all()), f"{what}: no id twice in a list")
        tied = (kv[..., 1:] == kv[..., :-1]) & live[..., 1:]
        check(bool((ki[..., 1:] > ki[..., :-1])[tied].all()),
              f"{what}: ties list lower rows first")
    return err, int(diff.sum())


def part_owns(valid, size: int, axis: int):
    """A slot owns the live rows of part pos[axis], each part `size`
    consecutive rows: K3's row block (axis 0 of (block, query, rank)), K1's
    group and K4's window (axis 1 of (query, column))."""
    def owns(pos, ids):
        ids = ids.long()
        return (ids // size == pos[:, axis]) & (valid[ids] > 0)
    return owns


def window_owns(bias):
    """K2: column c owns the rows of span c // 128 at offset c % 128 (mod
    128) whose bias is not the mask's."""
    from yams_tpu_torch.ops.flash_topk import SPAN, WINDOW

    def owns(pos, ids):
        ids = ids.long()
        return ((ids // SPAN == pos[:, 1] // WINDOW) & (ids % WINDOW == pos[:, 1] % WINDOW)
                & (bias[ids] > -1e29))
    return owns


def k3_inputs(dev, gen, B: int, k: int, case: str, N: int = 4 * 2048, D: int = 768,
              block_rows: int = 2048):
    """Edge inputs of the K3 block step: (q bf16, E bf16, valid f32)."""
    E = torch.randn(N, D, generator=gen, device=dev)
    q = torch.randn(B, D, generator=gen, device=dev)
    E = (E / E.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    if case == "rising":           # every query scores row r of a block exactly r / 2,048
        r = torch.arange(N, device=dev) % block_rows   # (every tile inserts)
        E.zero_()
        E[:, 0] = (r // 16).float() / 128       # both exact in bf16
        E[:, 1] = (r % 16).float() / 16
        q.zero_()
        q[:, 0] = 1.0
        q[:, 1] = 1.0 / 128
    valid = (torch.rand(N, generator=gen, device=dev) > 0.05).float()
    if case == "duplicates":       # exact ties at the top, inside and across blocks
        for b in range(B):
            E[[(11 + 7 * b) % N, (700 + 7 * b) % N, (2048 + 5 * b) % N, (6000 + b) % N]] = q[b]
    elif case == "tile_ties":      # query b's copies on both sides of a 128-row tile edge
        edges = N // 128 - 1       # j = 16 straddles rows 2,047 / 2,048, a block edge
        for b in range(B):
            j = 1 + (b * 15) % edges
            E[[128 * j - 1, 128 * j]] = q[b]
            valid[[128 * j - 1, 128 * j]] = 1.0
    elif case == "tile_dupes":     # query b's 24 copies in one 128-row tile: more than its 20 slots
        for b in range(B):
            rows = tile_dupe_rows(b, N)
            E[rows] = q[b]
            valid[rows] = 1.0
    elif case == "dead_block":
        valid[block_rows:2 * block_rows] = 0.0
    elif case == "k_minus_1_live":
        valid[block_rows:2 * block_rows] = 0.0
        valid[block_rows + torch.randperm(block_rows, generator=gen, device=dev)[:k - 1]] = 1.0
    elif case == "rising":
        valid[:] = 1.0
    return q, E.contiguous(), valid


def tile_dupe_rows(b: int, N: int) -> list[int]:
    """The 24 rows, ascending, of query b's copies in the tile_dupes case:
    every 5th row of 128-row tile b % (N / 128), from offset (b // (N / 128))
    % 5, so that no two of up to 5 N / 128 queries share a row."""
    tiles = N // 128
    return [128 * (b % tiles) + (b // tiles) % 5 + 5 * i for i in range(24)]


def k3_true_score(q, E, valid):
    """f64 score of (pos (.., 3) = (block, query, rank), row ids)."""
    def true(pos, ids):
        s = (q[pos[:, 1]].double() * E[ids.long()].double()).sum(dim=1)
        return torch.where(valid[ids.long()] > 0, s, -1e30)
    return true


def k4_true_score(lut, codes, valid):
    """f64 ADC score of (pos (.., 2) = (query, window), row ids)."""
    def true(pos, ids):
        r = ids.long()
        c = torch.stack([codes[r] & 15, codes[r] >> 4], dim=2).reshape(r.numel(), -1).long()
        s = lut[pos[:, 0]].double().gather(2, c[:, :, None])[:, :, 0].sum(dim=1)
        return torch.where(valid[r] > 0, s, -1e30)
    return true


def check_k4(what: str, kv, ki, tv, ti, lut, codes, valid, group: int,
             tol: float) -> tuple[bool, float, int]:
    """K4 against its twin: bit-equal, or (if the tensor-core sum rounds
    otherwise) values within tol and every differing row a near-tie in the
    twin's own window. -> (bit-equal, max value error, #rows that differ)."""
    if torch.equal(kv, tv) and torch.equal(ki, ti):
        return True, 0.0, 0
    err, d = check_topk(what, kv, ki, tv, ti, k4_true_score(lut, codes, valid),
                        part_owns(valid, group, 1), tol, ordered=False)
    return False, err, d


def phase1_k3(dev) -> dict:
    """K3 held against its twin on the card: edge shapes, then the bench
    shape, timed beside dot_f32 (cuBLAS) on the same operands."""
    from yams_tpu_torch.ops import scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    tol = 1e-4   # 768 bf16 products summed in f32 by wgmma vs cuBLAS
    # (B, k, case, N, block_rows): the first port's cases; then the edges of
    # the 128-row x 256-query tile and of the threshold epilogue (k <= 16)
    # against the score dump (k > 16), block_rows 64 and 192 (TMA's zeros
    # past a block's end), ties across tile and block edges, scores rising
    # with the row (every tile inserts), a dead block, k - 1 live rows
    cases = [(B, k, case, 8192, 2048) for B in (1, 3, 64) for k in (1, 10, 100)
             for case in ("random", "duplicates", "dead_block", "k_minus_1_live")]
    cases += [(B, k, "random", 8192, 2048) for B in (255, 256, 257)
              for k in (1, 10, 16, 17, 128, 129, 2048)]
    cases += [(B, k, "tile_ties", 8192, 2048) for B in (3, 257) for k in (1, 10, 129)]
    cases += [(B, k, "tile_dupes", 8192, 2048) for B in (3, 257) for k in (10, 16, 17, 129)]
    cases += [(B, k, "rising", 8192, 2048) for B in (3, 257) for k in (1, 10, 16, 129)]
    cases += [(257, k, case, 8192, 2048) for k in (10, 129)
              for case in ("duplicates", "dead_block", "k_minus_1_live")]
    cases += [(B, k, case, N, br) for B in (3, 257) for N, br, ks in
              ((8192, 64, (1, 10, 64)), (7680, 192, (10, 16, 129, 192)))
              for k in ks for case in ("random", "dead_block", "k_minus_1_live")]
    n_diff = 0
    for B, k, case, N, br in cases:
        q, E, valid = k3_inputs(dev, gen, B, k, case, N=N, block_rows=br)
        kv, ki = scan.exact_topk_cuda(q, E, valid, k, br)
        tv, ti = scan.exact_topk_reference(q, E, valid, k, br)
        torch.cuda.synchronize()
        what = f"K3 {case} B={B} k={k} N={N} block_rows={br}"
        _, d = check_topk(what, kv, ki, tv, ti, k3_true_score(q, E, valid),
                          part_owns(valid, br, 0), tol)
        if case in ("dead_block", "k_minus_1_live"):
            check(bool((kv <= -1e29).any()), f"{what}: -1e30 slots present")
        if case == "tile_dupes":   # the exact ties rank their lowest rows first, in row order
            got = ki.cpu()
            for b in range(B):
                rows = tile_dupe_rows(b, N)
                check(got[rows[0] // br, b, :min(k, 24)].tolist() == rows[:k],
                      f"{what}: query {b}'s copies give its lowest {min(k, 24)} rows")
        n_diff += d
    log(f"[phase1] exact_topk_cuda: {len(cases)} edge cases == twin "
        f"({n_diff} ids differ, all near-ties)")

    # the bench shape: 1,048,576 x 768 clustered, B = 1,024, k = 10
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(SEED)
    E = clustered_corpus(dev, cgen)
    N, D = E.shape
    qf = torch.randn(1024, D, generator=gen, device=dev)
    q = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    valid = torch.ones(N, device=dev)
    kv, ki = scan.exact_topk_cuda(q, E, valid, 10)
    tv, ti = scan.exact_topk_reference(q, E, valid, 10)
    torch.cuda.synchronize()
    k3_err, d = check_topk("K3 bench shape", kv, ki, tv, ti, k3_true_score(q, E, valid),
                           part_owns(valid, 2048, 0), tol)
    k3_ms = cuda_ms(lambda: scan.exact_topk_cuda(q, E, valid, 10), 5)
    k3_plain_ms = cuda_ms(lambda: scan.exact_topk_reference(q, E, valid, 10), 3)
    dot_ms = cuda_ms(lambda: scan.dot_f32(q, E), 5)
    flops = 2.0 * 1024 * N * D
    log(f"[phase1] exact_topk_cuda {N}x{D}, B=1024, k=10: cuda {k3_ms:.3f} ms "
        f"({flops / k3_ms / 1e9:.1f} TFLOP/s), plain {k3_plain_ms:.3f} ms; dot_f32 on the "
        f"same operands {dot_ms:.3f} ms ({flops / dot_ms / 1e9:.1f} TFLOP/s); "
        f"max err {k3_err:.3g}, {d} of {ki.numel()} ids differ (near-ties)")
    out = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, dot_f32_ms=dot_ms,
               tflops=flops / k3_ms / 1e9, dot_f32_tflops=flops / dot_ms / 1e9,
               shape=f"{N}x{D} bf16, B=1024, k=10 (G x B x k blocks)",
               **bound(2.0 * N * D + 2.0 * 1024 * D + 4.0 * N + 8.0 * kv.numel(), flops,
                       PEAK_BF16))
    del kv, ki, tv, ti
    # k > 16 takes the score dump and the sort (VectorIndex.search passes the
    # caller's k through): the same shape at k 17, 100 and 128
    out["large_k"] = {}
    for k in (17, 100, 128):
        kv, ki = scan.exact_topk_cuda(q, E, valid, k)
        tv, ti = scan.exact_topk_reference(q, E, valid, k)
        torch.cuda.synchronize()
        _, d = check_topk(f"K3 bench shape k={k}", kv, ki, tv, ti, k3_true_score(q, E, valid),
                          part_owns(valid, 2048, 0), tol)
        del kv, ki, tv, ti
        ms = cuda_ms(lambda: scan.exact_topk_cuda(q, E, valid, k), 3)
        plain_ms = cuda_ms(lambda: scan.exact_topk_reference(q, E, valid, k), 2)
        out["large_k"][k] = dict(ms=ms, plain_ms=plain_ms, ids_differ=d,
                                 launches_a_call=-(-1024 // scan.dump_query_slice(N)))
        log(f"[phase1] exact_topk_cuda {N}x{D}, B=1024, k={k} (score dump + sort): cuda "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms; {d} ids differ (near-ties)")
    del E
    # the threshold's worst case at the same size: scores rising with the row
    q, E, valid = k3_inputs(dev, gen, 1024, 10, "rising", N=N)
    kv, ki = scan.exact_topk_cuda(q, E, valid, 10)
    tv, ti = scan.exact_topk_reference(q, E, valid, 10)
    torch.cuda.synchronize()
    _, d = check_topk("K3 rising scores, bench size", kv, ki, tv, ti,
                      k3_true_score(q, E, valid), part_owns(valid, 2048, 0), tol)
    out["rising_ms"] = cuda_ms(lambda: scan.exact_topk_cuda(q, E, valid, 10), 3)
    log(f"[phase1] exact_topk_cuda, scores rising with the row ({N}x{D}, B=1024, k=10): "
        f"{out['rising_ms']:.3f} ms; {d} ids differ (near-ties)")
    return {"exact_topk_cuda": out}


def k4_inputs(dev, gen, B: int, m: int, N: int, dsub: int = 16):
    """K4 inputs: (bf16 LUT (B, m, 16), packed codes (N, m/2), valid) with
    ~10% dead rows and a dead 4,096-row span (whole 128-row tiles)."""
    from yams_tpu_torch.ops.pq import pq_lut

    codes = torch.randint(0, 256, (N, m // 2), generator=gen, device=dev, dtype=torch.uint8)
    valid = (torch.rand(N, generator=gen, device=dev) > 0.1).float()
    valid[4096:8192] = 0.0
    cent = torch.randn(m, 16, dsub, generator=gen, device=dev)
    lut = pq_lut(torch.randn(B, m * dsub, generator=gen, device=dev),
                 cent).to(torch.bfloat16).contiguous()
    return lut, codes, valid


def phase1_k4(dev) -> dict:
    """K4 held against its twin on the card: edge shapes, then the capacity
    shape with the top-64 selection."""
    from yams_tpu_torch.ops import pq_pallas
    from yams_tpu_torch.ops.pq import pq_lut

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    tol = 1e-4
    # (m, group, B, N): the first port's cases (m 48, groups 8/64/128, B
    # 1/3/256); every m tile width (n 128 to m 48, 64 to 104, 32 to 192, 16
    # beyond) and the largest m; groups 1-256 (inside a warp, across warps,
    # across the two warpgroups, across two tiles); query tiles at B 127-129
    # and 256; a ragged last 128-row tile (N = 65,536 + 64, and + 8)
    cases = [(48, g, B, 65536) for g in (8, 64, 128) for B in (1, 3, 256)]
    cases += [(m, g, B, 65536) for m in (8, 32, 48, 96, 200) for g in (8, 64, 128, 256)
              for B in (1, 127, 128, 129, 256)]
    cases += [(48, g, B, 65536) for g in (1, 2, 4, 16, 32) for B in (3, 129)]
    cases += [(m, g, 129, 65536 + 64) for m in (8, 50) for g in (1, 8, 16, 64)]
    cases += [(50, g, 3, 65536 + 8) for g in (1, 8)]   # its last copy is 8 bytes
    n_equal = n_diff = 0
    k4_case_err = 0.0
    for m, group, B, N in cases:
        lut, codes, valid = k4_inputs(dev, gen, B, m, N)
        kv, ki = pq_pallas.pq4_adc_cuda(lut, codes, valid, group, group)
        tv, ti = pq_pallas.pq4_adc_reference(lut, codes, valid, group, group)
        torch.cuda.synchronize()
        eq, err, d = check_k4(f"K4 m={m} group={group} B={B} N={N}", kv, ki, tv, ti,
                              lut, codes, valid, group, tol)
        n_equal += eq
        n_diff += d
        k4_case_err = max(k4_case_err, err)
    log(f"[phase1] pq4_adc_cuda: {len(cases)} edge cases against the twin: {n_equal} bit-equal; "
        f"the rest within {tol} (max err {k4_case_err:.3g}), {n_diff} rows differ, all near-ties")

    # the capacity shape (scripts/bench_pq.py): 16,777,216 rows, D 768, m 48,
    # ksub 16, group 128, block 2,048, 256 queries, top-64 candidates
    m, dsub = 48, 16
    N, B, group = 16_777_216, 256, 128
    t = time.perf_counter()
    codes = torch.randint(0, 256, (N, m // 2), generator=gen, device=dev, dtype=torch.uint8)
    valid = (torch.rand(N, generator=gen, device=dev) > 0.01).float()
    cent = torch.randn(m, 16, dsub, generator=gen, device=dev)
    cent /= cent.norm(dim=2, keepdim=True)
    qf = torch.randn(B, m * dsub, generator=gen, device=dev)
    qf /= qf.norm(dim=1, keepdim=True)
    torch.cuda.synchronize()
    log(f"[phase1] capacity shape: {codes.numel() / 1e6:.1f} MB of codes, "
        f"{valid.numel() * 4 / 1e6:.1f} MB of validity made in {time.perf_counter() - t:.2f} s")
    lut = pq_lut(qf, cent).to(torch.bfloat16).contiguous()
    kv, ki = pq_pallas.pq4_adc_cuda(lut, codes, valid, group)
    tv, ti = pq_pallas.pq4_adc_reference(lut, codes, valid, group)
    torch.cuda.synchronize()
    eq, k4_err, d = check_k4("K4 capacity shape", kv, ki, tv, ti, lut, codes, valid, group, tol)
    del kv, ki, tv, ti
    k4_ms = cuda_ms(lambda: pq_pallas.pq4_adc_cuda(lut, codes, valid, group), 10)
    k4_plain_ms = cuda_ms(lambda: pq_pallas.pq4_adc_reference(lut, codes, valid, group), 1)
    topk_ms = cuda_ms(lambda: pq_pallas.pq4_adc_topk_pallas(
        qf, codes, cent, valid, 64, group=group, block_rows=2048), 5)
    lookups = float(N) * B * m
    onehot_flops = 2.0 * N * 16 * m * B
    log(f"[phase1] pq4_adc_cuda {N} rows, m={m}, group={group}, B={B}: cuda {k4_ms:.3f} ms "
        f"({lookups / k4_ms / 1e9:.2f}e12 lookups/s; the one-hot product at "
        f"{onehot_flops / k4_ms / 1e9:.1f} TFLOP/s), plain {k4_plain_ms:.1f} ms; "
        + ("bit-equal" if eq else f"max err {k4_err:.3g}, {d} rows differ (near-ties)")
        + f"; pq4_adc_topk_pallas (top-64) {topk_ms:.3f} ms = {B / topk_ms * 1e3:.1f} QPS")
    # codes, validity and the bf16 LUT in, one (value, row) per group out;
    # one f32 add per (row, query, subspace) and one compare per (row, query)
    return {"pq4_adc_cuda": dict(
        max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain_ms, bit_equal=eq,
        edge_cases_bit_equal=f"{n_equal} of {len(cases)}",
        shape=f"{N} rows, m=48 packed, group 128, B=256",
        onehot_tflops=onehot_flops / k4_ms / 1e9,
        topk_pallas_ms=topk_ms, topk_pallas_qps=B / topk_ms * 1e3,
        **bound(codes.numel() + 4.0 * N + 2.0 * lut.numel() + 8.0 * B * (N // group),
                float(N) * B * (m + 1), PEAK_CORE))}


def partition_true_score(q, E, valid=None, bias=None):
    """f64 score of (pos (.., 2) = (query, column), row ids) for K1 (valid:
    dead rows score -1e30) or K2 (bias added)."""
    def true(pos, ids):
        ids = ids.long()
        s = (q[pos[:, 0]].double() * E[ids].double()).sum(dim=1)
        if bias is not None:
            return s + bias[ids].double()
        return torch.where(valid[ids] > 0, s, -1e30)
    return true


def k1_inputs(dev, gen, B: int, case: str, N: int = 4 * 2048 + 512, D: int = 768):
    """Edge inputs of the K1 group step: (q bf16, E bf16, valid f32). The
    default N leaves a ragged 512-row last 2,048-row block."""
    E = torch.randn(N, D, generator=gen, device=dev)
    q = torch.randn(B, D, generator=gen, device=dev)
    if case == "negative_tail":    # the last 64 rows, all live, score below 0 for every query
        q[:, 0] = q[:, 0].abs() + 4.0
        E[N - 64:] = 0.02 * E[N - 64:]
        E[N - 64:, 0] = -1.0
    E = (E / E.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    valid = (torch.rand(N, generator=gen, device=dev) > 0.05).float()
    if case == "duplicates":       # exact ties inside a group: the last row wins
        for b in range(B):
            E[[(11 + 7 * b) % N, (40 + 7 * b) % N, (2048 + 5 * b) % N, N - 1 - b]] = q[b]
    elif case == "dead_group":
        valid[1024:1280] = 0.0
    elif case == "dead_2048":      # the second 2,048-row group has no live row
        valid[2048:4096] = 0.0
    elif case == "negative_tail":
        valid[N - 64:] = 1.0
    return q, E.contiguous(), valid


def k2_inputs(dev, gen, B: int, case: str, spans: int, D: int = 768):
    """Edge inputs of the K2 window step: (q bf16, E bf16, bias f32). The
    duplicates case plants copies for the first 128 queries (one window
    each)."""
    from yams_tpu_torch.ops.flash_topk import SPAN

    N = spans * SPAN
    E = torch.randn(N, D, generator=gen, device=dev)
    E = (E / E.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn(B, D, generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    bias = torch.zeros(N, device=dev)
    bias[::7] = -1e30
    if case == "masked_window":    # every row of window (0, 5) and (last, 127)
        bias[5:SPAN:128] = -1e30
        bias[N - SPAN + 127::128] = -1e30
    elif case == "duplicates":     # exact ties inside a window: the first row wins
        for b in range(min(B, 128)):
            w = (3 + b) % 128
            E[[w + 128 * 9, w + 128 * 40, w + 128 * 41, N - SPAN + w]] = q[b]
            bias[[w + 128 * 9, w + 128 * 40, w + 128 * 41, N - SPAN + w]] = 0.0
    return q, E.contiguous(), bias


def phase1_fused_scan_kernels(dev) -> dict:
    """K1 and K2 held against their twins on the card: edge shapes, then the
    shapes the two experiments run them at."""
    from yams_tpu_torch.ops import flash_topk, scan
    from yams_tpu_torch.ops.flash_topk import SPAN
    from yams_tpu_torch.scripts.exp_flash_topk import clustered_corpus
    from yams_tpu_torch.scripts.profile_grouped import unit_corpus

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    tol = 1e-4   # 768 bf16 products summed in f32 by wgmma vs cuBLAS
    out = {}
    n_cases = n_diff = 0
    for B in (1, 3, 64):
        for group in (64, 256):
            for case in ("random", "duplicates", "dead_group"):
                q, E, valid = k1_inputs(dev, gen, B, case)
                kv, ki = scan.grouped_max_cuda(q, E, valid, group)
                tv, ti = scan.grouped_max_reference(q, E, valid, group)
                torch.cuda.synchronize()
                _, d = check_topk(f"K1 {case} B={B} group={group}", kv, ki, tv, ti,
                                  partition_true_score(q, E, valid=valid),
                                  part_owns(valid, group, 1), tol, ordered=False)
                if case == "dead_group":
                    g = 1024 // group
                    check(bool((kv[:, g] == -1e30).all() and (ki[:, g] == 1024 + group - 1).all()),
                          "K1 dead group emits (-1e30, its last row)")
                if case == "duplicates":    # two copies of q[b] in one live group
                    for b in range(B):
                        a, r = 11 + 7 * b, 40 + 7 * b
                        if a // group == r // group and valid[a] > 0 and valid[r] > 0:
                            check(int(ki[b, r // group]) == r, "K1 ties go to the last row")
                n_cases += 1
                n_diff += d
    log(f"[phase1] grouped_max_cuda: {n_cases} edge cases == twin "
        f"({n_diff} ids differ, all near-ties)")
    n_cases = n_diff = 0
    for B in (1, 3, 64):
        for spans in (1, 3):
            for case in ("random", "masked_window", "duplicates"):
                q, E, bias = k2_inputs(dev, gen, B, case, spans)
                kv, ki = flash_topk.windowed_scan_cuda(q, E, bias)
                tv, ti = flash_topk.windowed_scan_reference(q, E, bias)
                torch.cuda.synchronize()
                _, d = check_topk(f"K2 {case} B={B} spans={spans}", kv, ki, tv, ti,
                                  partition_true_score(q, E, bias=bias), window_owns(bias),
                                  tol, ordered=False)
                if case == "masked_window":
                    check(bool((kv[:, 5] == -1e30).all() and (ki[:, 5] == 0).all()
                               and (kv[:, -1] == -1e30).all() and (ki[:, -1] == 0).all()),
                          "K2 all-masked windows emit (-1e30, 0)")
                if case == "duplicates":    # copies of q[b] in window (0, w)
                    for b in range(B):
                        w = (3 + b) % 128
                        first = w if spans == 1 else w + 128 * 9
                        check(int(ki[b, w]) == first, "K2 ties go to the first row")
                n_cases += 1
                n_diff += d
    log(f"[phase1] windowed_scan_cuda: {n_cases} edge cases == twin "
        f"({n_diff} ids differ, all near-ties)")

    # the 128-row x 256-query tiling's edges: partial query tiles; every
    # epilogue path of K1 (groups of 1-8 rows inside a warp, 16, 32-128
    # through the scratch, 2,048 folded over 16 tiles); a ragged last
    # 128-row tile whose 64 live rows all score below 0 (TMA fills the rest
    # with zeros); D = 80, not a multiple of the 64-wide D slice
    n_cases = n_diff = 0
    k1_edges = [(B, 256, 8704, 768, case) for B in (127, 129, 255, 257)
                for case in ("random", "duplicates")]
    k1_edges += [(64, g, 8768, 768, "negative_tail") for g in (1, 8, 16, 32, 64)]
    k1_edges += [(B, 2048, 8192, 768, case) for B in (3, 257)
                 for case in ("random", "duplicates", "dead_2048")]
    k1_edges += [(B, g, 8704, 80, "random") for B in (3, 257) for g in (16, 128)]
    for B, group, N, D, case in k1_edges:
        q, E, valid = k1_inputs(dev, gen, B, case, N=N, D=D)
        kv, ki = scan.grouped_max_cuda(q, E, valid, group)
        tv, ti = scan.grouped_max_reference(q, E, valid, group)
        torch.cuda.synchronize()
        what = f"K1 {case} B={B} group={group} N={N} D={D}"
        _, d = check_topk(what, kv, ki, tv, ti, partition_true_score(q, E, valid=valid),
                          part_owns(valid, group, 1), tol, ordered=False)
        if case == "negative_tail":
            check(bool((kv[:, -1] < 0).all() and (ki[:, -1] >= N - group).all()
                       and (ki[:, -1] < N).all()),
                  f"{what}: the ragged tile's live rows win their group, not the zero fill")
        if case == "dead_2048":
            check(bool((kv[:, 1] == -1e30).all() and (ki[:, 1] == 4095).all()),
                  f"{what}: the dead group emits (-1e30, its last row)")
        if case == "duplicates" and group == 2048:
            check(all(int(ki[b, 0]) == 40 + 7 * b for b in range(B)
                      if valid[11 + 7 * b] > 0 and valid[40 + 7 * b] > 0),
                  f"{what}: ties go to the last row")
        n_cases += 1
        n_diff += d
    k2_edges = [(B, 1, 768, case) for B in (127, 129, 255, 257)
                for case in ("random", "masked_window", "duplicates")]
    k2_edges += [(B, 2, 80, case) for B in (3, 257) for case in ("random", "masked_window")]
    for B, spans, D, case in k2_edges:
        q, E, bias = k2_inputs(dev, gen, B, case, spans, D=D)
        kv, ki = flash_topk.windowed_scan_cuda(q, E, bias)
        tv, ti = flash_topk.windowed_scan_reference(q, E, bias)
        torch.cuda.synchronize()
        what = f"K2 {case} B={B} spans={spans} D={D}"
        _, d = check_topk(what, kv, ki, tv, ti, partition_true_score(q, E, bias=bias),
                          window_owns(bias), tol, ordered=False)
        if case == "masked_window":
            check(bool((kv[:, 5] == -1e30).all() and (ki[:, 5] == 0).all()
                       and (kv[:, -1] == -1e30).all() and (ki[:, -1] == 0).all()),
                  f"{what}: all-masked windows emit (-1e30, 0)")
        if case == "duplicates":
            check(all(int(ki[b, (3 + b) % 128]) == (3 + b) % 128 for b in range(min(B, 128))),
                  f"{what}: ties go to the first row")
        n_cases += 1
        n_diff += d
    log(f"[phase1] K1/K2 tiling edges: {n_cases} cases == twin "
        f"({n_diff} ids differ, all near-ties)")

    # TMA needs 16-byte-aligned bases: E one element into its buffer raises
    # before any launch
    q, E, valid = k1_inputs(dev, gen, 3, "random", N=SPAN)
    shifted = torch.empty(E.numel() + 8, dtype=E.dtype, device=dev)[1:1 + E.numel()].view_as(E)
    shifted.copy_(E)
    for name, fn in (("grouped_max_cuda", lambda: scan.grouped_max_cuda(q, shifted, valid, 64)),
                     ("windowed_scan_cuda",
                      lambda: flash_topk.windowed_scan_cuda(q, shifted, valid))):
        before = (scan.grouped_max_cuda.launches, flash_topk.windowed_scan_cuda.launches)
        try:
            fn()
            raised = False
        except ValueError as e:
            raised = "16-byte" in str(e)
        check(raised and before == (scan.grouped_max_cuda.launches,
                                    flash_topk.windowed_scan_cuda.launches),
              f"{name} refuses a misaligned E before any launch")
    log("[phase1] a misaligned E raises ValueError in both wrappers before any launch")

    # K1 at profile_grouped's shape: 1,003,520 x 768 unit-normal, B 256, group 256
    N, D, B, group = 1_003_520, 768, 256, 256
    E = unit_corpus(N, D, gen, dev)
    qf = torch.randn(B, D, generator=gen, device=dev)
    q = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    valid = torch.ones(N, device=dev)
    kv, ki = scan.grouped_max_cuda(q, E, valid, group)
    tv, ti = scan.grouped_max_reference(q, E, valid, group)
    torch.cuda.synchronize()
    k1_err, d = check_topk("K1 experiment shape", kv, ki, tv, ti,
                           partition_true_score(q, E, valid=valid), part_owns(valid, group, 1),
                           tol, ordered=False)
    k1_ms = cuda_ms(lambda: scan.grouped_max_cuda(q, E, valid, group), 20)
    k1_plain_ms = cuda_ms(lambda: scan.grouped_max_reference(q, E, valid, group), 2)
    dot_ms = cuda_ms(lambda: scan.dot_f32(q, E), 20)   # the mainloop's yardstick (cuBLAS)
    flops = 2.0 * B * N * D
    log(f"[phase1] grouped_max_cuda {N}x{D}, B={B}, group={group}: cuda {k1_ms:.3f} ms "
        f"({flops / k1_ms / 1e9:.1f} TFLOP/s), plain {k1_plain_ms:.3f} ms; "
        f"dot_f32 on the same operands {dot_ms:.3f} ms ({flops / dot_ms / 1e9:.1f} TFLOP/s); "
        f"max err {k1_err:.3g}, {d} of {ki.numel()} ids differ (near-ties)")
    out["grouped_max_cuda"] = dict(
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, dot_f32_ms=dot_ms,
        tflops=flops / k1_ms / 1e9, dot_f32_tflops=flops / dot_ms / 1e9,
        shape=f"{N}x{D} bf16, B={B}, group={group} -> (B, N/group)",
        **bound(2.0 * N * D + 2.0 * B * D + 4.0 * N + 8.0 * kv.numel(), flops, PEAK_BF16))
    del E, kv, ki, tv, ti

    # K2 at exp_flash_topk's shape: 1,015,808 x 768 clustered, B 1,024
    N, B = 1_015_808, 1024
    E = clustered_corpus(N, D, 4096, 0.35, gen, dev)
    qf = torch.randn(B, D, generator=gen, device=dev)
    q = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    bias = torch.zeros(N, device=dev)
    kv, ki = flash_topk.windowed_scan_cuda(q, E, bias)
    tv, ti = flash_topk.windowed_scan_reference(q, E, bias)
    torch.cuda.synchronize()
    k2_err, d = check_topk("K2 experiment shape", kv, ki, tv, ti,
                           partition_true_score(q, E, bias=bias), window_owns(bias), tol,
                           ordered=False)
    k2_ms = cuda_ms(lambda: flash_topk.windowed_scan_cuda(q, E, bias), 10)
    k2_plain_ms = cuda_ms(lambda: flash_topk.windowed_scan_reference(q, E, bias), 2)
    dot_ms = cuda_ms(lambda: scan.dot_f32(q, E), 10)
    flops = 2.0 * B * N * D
    log(f"[phase1] windowed_scan_cuda {N}x{D}, B={B}: cuda {k2_ms:.3f} ms "
        f"({flops / k2_ms / 1e9:.1f} TFLOP/s), plain {k2_plain_ms:.3f} ms; "
        f"dot_f32 on the same operands {dot_ms:.3f} ms ({flops / dot_ms / 1e9:.1f} TFLOP/s); "
        f"max err {k2_err:.3g}, {d} of {ki.numel()} ids differ (near-ties)")
    out["windowed_scan_cuda"] = dict(
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, dot_f32_ms=dot_ms,
        tflops=flops / k2_ms / 1e9, dot_f32_tflops=flops / dot_ms / 1e9,
        shape=f"{N}x{D} bf16 clustered, B={B} -> (B, N/128)",
        **bound(2.0 * N * D + 2.0 * B * D + 4.0 * N + 8.0 * kv.numel(), flops, PEAK_BF16))
    return out


# -- phase 2 ------------------------------------------------------------------
def phase2_add(dev, data: bytes, warm_reps: int = 5) -> dict:
    from yams_tpu_torch.ingest.chunker import ChunkingConfig, _boundaries_numpy
    from yams_tpu_torch.ingest.device_pipeline import device_chunk_hash

    c = ChunkingConfig()

    def one():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_chunk_hash(data, c.min_size, c.avg_size, c.max_size, dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    triples, cold_s = one()
    warm_s = []
    for _ in range(warm_reps):
        again, dt = one()
        check(again == triples, "device_chunk_hash repeats identically")
        warm_s.append(dt)
    mbps = sorted(len(data) / 1e6 / s for s in warm_s)
    median = float(np.median(mbps))
    log(f"[phase2] device_chunk_hash {len(data) / 2**20:.0f} MiB: {len(triples)} chunks; "
        f"cold {cold_s:.4f} s = {len(data) / 1e6 / cold_s:.1f} MB/s; "
        f"warm x{warm_reps} median {median:.1f} MB/s (all: "
        + ", ".join(f"{x:.1f}" for x in mbps) + ")")
    check(triples[0][1] == 0 and triples[-1][2] == len(data), "chunks cover the payload")
    check(all(e == s2 for (_, _, e), (_, s2, _) in zip(triples, triples[1:])),
          "chunks tile the payload")
    t = time.perf_counter()
    oracle = _boundaries_numpy(data, c.min_size, c.avg_size, c.max_size)
    log(f"[phase2] host oracle boundaries in {time.perf_counter() - t:.2f} s")
    check([e for _, _, e in triples] == oracle, "boundaries == host chunker oracle")
    check(all(hashlib.sha256(data[s:e]).hexdigest() == h for h, s, e in triples),
          "digests == hashlib")
    return {"payload_bytes": len(data), "chunks": len(triples), "cold_s": cold_s,
            "warm_s": warm_s, "mb_s_median_warm": median, "mb_s_warm": mbps}


def phase2_breakdown(dev, data: bytes) -> dict:
    """Stage times of a second, synchronized pass (not on the counted path)."""
    from yams_tpu_torch.ingest.chunker import ChunkingConfig, _masks, select_cuts
    from yams_tpu_torch.ingest.device_pipeline import payload_tensor
    from yams_tpu_torch.ops import cdc, sha256

    c = ChunkingConfig()
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    buf = timed("h2d_ms", lambda: payload_tensor(data, dev))
    g = timed("gear_lookup_ms", lambda: cdc.gear_values(buf))
    h = timed("gear_hash_kernel_ms", lambda: cdc.gear_hash_cuda(g))
    mask_s, mask_l = _masks(c.avg_size)
    cs, cl = timed("candidates_ms", lambda: (
        torch.nonzero((h & mask_s) == 0).flatten().cpu().numpy(),
        torch.nonzero((h & mask_l) == 0).flatten().cpu().numpy()))
    bounds = timed("cut_selection_ms", lambda: select_cuts(
        len(data), cs, cl, c.min_size, c.avg_size, c.max_size))
    ends = np.asarray(bounds, np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    st = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy((ends - starts).astype(np.int32)).to(dev)
    timed("sha256_kernel_ms", lambda: sha256.sha256_cuda(buf, st, ln).cpu())
    log("[phase2] breakdown " + json.dumps({k: round(v, 3) for k, v in out.items()}))
    return out


# -- phase 3 ------------------------------------------------------------------
def make_docs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(1024)]
    lens = rng.integers(12, 24, n)
    z = rng.zipf(1.3, size=int(lens.sum())) % len(vocab)
    tz = rng.zipf(1.5, size=3 * n) % len(vocab)
    docs, p = [], 0
    for i, L in enumerate(lens):
        body = " ".join(vocab[j] for j in z[p:p + L]) + "."
        title = " ".join(vocab[j] for j in tz[3 * i:3 * i + 3])
        docs.append((100_000 + i, body, title))
        p += L
    queries = [" ".join(vocab[j] for j in rng.zipf(1.3, size=int(rng.integers(2, 6)))
                        % len(vocab)) for _ in range(64)]
    return docs, queries


def phase3_search(dev, n_docs: int = 70_000) -> dict:
    from yams_tpu_torch.convert import load_state, state_from_jax
    from yams_tpu_torch.embed.provider import native_sketch_available
    from yams_tpu_torch.search.engine import SearchEngine

    docs, queries = make_docs(n_docs, SEED + 1)
    t = time.perf_counter()
    native_sketch = native_sketch_available()   # g++ build on first use
    native_s = time.perf_counter() - t
    log(f"[phase3] native sketch library: {native_sketch} "
        f"(built or loaded in {native_s:.2f} s; else the Python sketch runs)")
    eng = SearchEngine(device=dev)
    t = time.perf_counter()
    eng.add_documents(docs)
    add_s = time.perf_counter() - t
    log(f"[phase3] add_documents {len(docs)} docs in {add_s:.2f} s; "
        f"rows {eng.vector_index.active_rows}, "
        f"vocab {eng.lexical_index.vocab_size}, slots {eng.num_slots_padded}")
    if n_docs > eng.config.approx_threshold:
        check(eng.num_slots_padded > eng.config.approx_threshold, "Nd above approx_threshold")
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.search_batch(queries)        # first call: uploads the index
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    res = eng.search_batch(queries)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t
    trace = eng.last_trace
    log(f"[phase3] search_batch(64): first {first_s:.3f} s, steady {steady_s * 1e3:.1f} ms; "
        f"trace {json.dumps({k: v for k, v in trace.items() if k != 'lexical_arms'})}")
    check(all(len(r) == 10 for r in res), "10 results per query")
    check(all(np.isfinite([x.score for r in res for x in r])), "finite scores")

    cpu = SearchEngine(device="cpu")
    load_state(cpu, state_from_jax(eng))

    def overlap_vs_cpu(card_res):
        ref = cpu.search_batch(queries[:16])
        return float(np.mean([len({x.doc_id for x in a} & {x.doc_id for x in b}) / 10
                              for a, b in zip(card_res[:16], ref)]))

    overlap = overlap_vs_cpu(res)
    log(f"[phase3] top-10 overlap with the CPU plain path on 16 queries: {overlap:.4f}")
    check(overlap >= 0.99, "top-10 overlap >= 0.99 vs CPU")
    # The engine's impact-skew guard turns the BM25 prefilter off on this
    # corpus (near-uniform impacts); run the prefilter tier through the engine
    # as well, with the guard off on both sides.
    eng.config.prefilter_max_tail_ratio = 0.0
    cpu.config.prefilter_max_tail_ratio = 0.0
    pf_s, pf_stages = [], []
    for _ in range(2):                  # first call, then steady
        torch.cuda.synchronize()
        t = time.perf_counter()
        res_pf = eng.search_batch(queries)
        torch.cuda.synchronize()
        pf_s.append(time.perf_counter() - t)
        pf_stages.append(eng.last_trace["stages"])
    check("prefilter_disabled_tail_ratio" not in eng.last_trace, "prefilter live")
    overlap_pf = overlap_vs_cpu(res_pf)
    log(f"[phase3] prefilter 256 forced: search_batch(64) first {pf_s[0] * 1e3:.1f} ms, "
        f"steady {pf_s[1] * 1e3:.1f} ms; top-10 overlap with the CPU plain path "
        f"{overlap_pf:.4f}; stages {json.dumps(pf_stages)}")
    check(overlap_pf >= 0.99, "prefilter top-10 overlap >= 0.99 vs CPU")
    return {"docs": len(docs), "add_s": add_s, "native_sketch": native_sketch,
            "native_build_s": native_s,
            "first_search_s": first_s, "steady_search_ms": steady_s * 1e3,
            "overlap_vs_cpu": overlap,
            "prefilter_disabled": "prefilter_disabled_tail_ratio" in trace,
            "prefilter_first_search_ms": pf_s[0] * 1e3,
            "prefilter_search_ms": pf_s[1] * 1e3,
            "prefilter_overlap_vs_cpu": overlap_pf}, eng, cpu, docs, queries


# -- phase 4 ------------------------------------------------------------------
def clustered_corpus(dev, gen, N: int = 1 << 20, D: int = 768) -> torch.Tensor:
    """bench.py's clustered corpus: 4,096 unit centers, sigma 0.35 bf16
    noise, rows L2-normalized -> (N, D) bf16 on the card."""
    centers = torch.randn(4096, D, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True).clamp_min(1e-9)
    ar = torch.arange(N, device=dev, dtype=torch.int64)
    assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % 4096
    noise = torch.randn(N, D, generator=gen, device=dev, dtype=torch.bfloat16)
    e = centers[assign].to(torch.bfloat16) + 0.35 * noise
    del noise
    ef = e.float()
    del e
    return (ef / ef.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)


def packed_postings(dev, N: int, V: int, WIN: int):
    """bench.py's packed postings: each of V terms -> WIN/2 multiplicative-
    hash docs of N, zipf impacts -> ((V, WIN) i32 packed, impact scale)."""
    from yams_tpu_torch.ops.bm25 import packed_qbits

    per_term = WIN // 2
    qbits = packed_qbits(N)
    qmax, vmax = (1 << qbits) - 1, 5.25
    tt = torch.arange(V, device=dev, dtype=torch.int64)[:, None]
    cc = torch.arange(WIN, device=dev, dtype=torch.int64)[None, :]
    arp = tt * per_term + cc
    docs = ((arp * 2654435761) & 0xFFFFFFFF) % N
    imp = 0.5 + 4.75 * (1.0 + cc.float()) ** -0.7
    q = torch.clamp(torch.round(imp * (qmax / vmax)), 0, qmax).long()
    packed = torch.where(cc < per_term, (docs << qbits) | q, N << qbits).to(torch.int32)
    return packed, torch.tensor(vmax, dtype=torch.float32, device=dev)


def phase4_bench(dev, N: int = 1 << 20, D: int = 768, B: int = 1024,
                 V: int = 65536) -> dict:
    from yams_tpu_torch.ops.bm25 import bm25_topk_candidates_packed
    from yams_tpu_torch.ops.select import top_k
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.ops.scan import dot_f32
    from yams_tpu_torch.search.fusion import hybrid_query, pack_weights

    S, T, K, WIN, ITERS, WINDOWS = 4096, 16, 10, 1024, 8, 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = time.perf_counter()
    E = clustered_corpus(dev, gen, N, D)
    proj = torch.where(torch.rand(S, D, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    proj = (proj / np.sqrt(D)).to(torch.bfloat16)
    packed, scale = packed_postings(dev, N, V, WIN)
    valid = torch.ones(N, device=dev)
    row2slot = torch.arange(N, device=dev, dtype=torch.int32)
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    doc_mask = torch.ones(N, device=dev)
    hot = torch.zeros(N, device=dev)
    w = torch.from_numpy(pack_weights(SearchEngineConfig())).to(dev)
    sketches = torch.randn(ITERS, B, S, generator=gen, device=dev)
    tids = torch.randint(0, V, (ITERS, B, T), generator=gen, device=dev, dtype=torch.int32)
    tmask = torch.ones(ITERS, B, T, device=dev)
    torch.cuda.synchronize()
    log(f"[phase4] corpus {N}x{D} bf16 + packed postings {V}x{WIN} built in "
        f"{time.perf_counter() - t:.2f} s")

    def run(i, approx=True, prefilter=256):
        return hybrid_query(
            sketches[i], tids[i], tmask[i], proj, E, valid, row2slot, valid,
            packed, scale, dummy, dummy, doc_mask, hot, w,
            k=K, rrf_cand=32, window=WIN, num_slots=N, chunk_agg="max",
            rows_are_docs=True, approx=approx, bm25_prefilter=prefilter,
            packed_lexical=True)

    run(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    windows = []                      # QPS of each window: all its batches / its time
    for _ in range(WINDOWS):
        t = time.perf_counter()
        slots = [run(i)[1] for i in range(ITERS)]
        torch.cuda.synchronize()
        windows.append(ITERS * B / (time.perf_counter() - t))
    qps = float(np.median(windows))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fused = torch.stack(slots).cpu().numpy()
    vals = run(0)[0]
    check(bool(torch.isfinite(vals).all()), "finite fused scores at the bench shape")

    def recall(oracle):
        return float(np.mean([len(np.intersect1d(a, o)) / K
                              for a, o in zip(fused.reshape(-1, K), oracle.reshape(-1, K))]))

    exact = torch.stack([run(i, approx=False)[1] for i in range(ITERS)]).cpu().numpy()
    full = torch.stack([run(i, approx=False, prefilter=0)[1] for i in range(ITERS)]).cpu().numpy()
    r10, r10_full = recall(exact), recall(full)

    # stage times for one batch (device time, CUDA events)
    qv = dot_f32(sketches[0], proj.t())
    qv = qv / qv.norm(dim=-1, keepdim=True)
    stages = {
        "embed_ms": cuda_ms(lambda: dot_f32(sketches[0], proj.t()), 5),
        "scores_ms": cuda_ms(lambda: dot_f32(qv, E), 5),
    }
    sc = dot_f32(qv, E)
    stages["top_c_ms"] = cuda_ms(lambda: top_k(sc, 32), 5)
    stages["torch_topk_ms"] = cuda_ms(lambda: torch.topk(sc, 32, dim=1), 5)
    del sc
    stages["bm25_ms"] = cuda_ms(lambda: bm25_topk_candidates_packed(
        tids[0], tmask[0], packed, scale, num_docs=N, num_candidates=32,
        prefilter=256), 5)
    stages["hybrid_query_ms"] = cuda_ms(lambda: run(0), 3)
    log(f"[phase4] QPS median {qps:.1f} over {WINDOWS} windows of {ITERS} batches of "
        f"B={B} (windows: " + ", ".join(f"{x:.1f}" for x in windows) + "); "
        f"recall10 {r10:.4f} (1 by construction: approx is exact on the port), "
        f"recall10_full {r10_full:.4f}; peak {peak_gb:.2f} GB; stages "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    check(r10_full >= 0.9, "recall10_full >= 0.9")
    return {"qps_median": qps, "qps_windows": windows, "recall10": r10,
            "recall10_full": r10_full, "peak_gb": peak_gb, "stages_ms": stages}


# -- phase 5 ------------------------------------------------------------------
def recall_at(rows: np.ndarray, oracle: np.ndarray) -> float:
    k = oracle.shape[1]
    return float(np.mean([len(np.intersect1d(a, o)) / k for a, o in zip(rows, oracle)]))


def phase5_vector_store(dev, N: int = 1 << 20, D: int = 768, B: int = 1024,
                        dups: int = 9) -> dict:
    """The vector store's own search tiers on a 1,048,576 x 768 clustered
    index: exact KNN through K3, PQ4 through K4, filtered PQ on the plain
    route. Each query is a corpus row with `dups` perturbed copies planted
    at other rows (cosine ~0.97, noise norm 0.25, as scripts/bench_pq.py
    plants them), so its exact top-10 is a clear set and PQ recall@10 means
    something; on the clustered corpus alone a row's other neighbours sit
    near cosine 0."""
    import os

    from yams_tpu_torch.index.vector_index import VectorIndex

    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = time.perf_counter()
    host = clustered_corpus(dev, gen, N, D).float().cpu().numpy()
    rng = np.random.default_rng(SEED + 11)
    base = rng.choice(N, B, replace=False)
    planted = rng.choice(np.setdiff1d(np.arange(N), base), B * dups, replace=False)
    copies = host[base][:, None, :] + (0.25 / np.sqrt(D)) * rng.standard_normal(
        (B, dups, D), dtype=np.float32)
    copies /= np.linalg.norm(copies, axis=2, keepdims=True)
    host[planted] = copies.reshape(-1, D)
    queries = host[base].copy()
    truth = np.concatenate([base[:, None], planted.reshape(B, dups)], axis=1)
    idx = VectorIndex(dim=D, capacity=N, block_rows=2048, device=dev)
    idx.add(host, np.arange(N))
    del host
    out["build_s"] = time.perf_counter() - t
    log(f"[phase5] VectorIndex {N}x{D} ({idx._vecs.nbytes / 1e9:.1f} GB host f32) "
        f"filled in {out['build_s']:.2f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # K3 route against the plain scan, both on the card
    _, upload_s = timed(idx.device_arrays)
    (pv, pi), plain_s = timed(lambda: idx.search(queries, k=10, use_pallas=False))
    (kv, ki), k3_s = timed(lambda: idx.search(queries, k=10, use_pallas=True))
    log(f"[phase5] upload {idx.upload_bytes_total / 1e9:.3f} GB in {upload_s:.2f} s; "
        f"search(use_pallas=True) B={B}: {k3_s:.3f} s; plain scan {plain_s:.3f} s")
    out["upload_s"] = upload_s
    E, valid, _, _ = idx.device_arrays()
    qd = torch.from_numpy(queries).to(dev).to(torch.bfloat16)

    def true(pos, ids):
        return (qd[pos[:, 0]].double() * E[ids.long()].double()).sum(dim=1)

    err, d = check_topk("search(use_pallas=True) vs plain", torch.from_numpy(kv).to(dev),
                        torch.from_numpy(ki).to(dev), torch.from_numpy(pv).to(dev),
                        torch.from_numpy(pi).to(dev), true,
                        lambda pos, ids: valid[ids.long()] > 0, 1e-4)
    planted_found = recall_at(pi, truth)
    log(f"[phase5] K3 route == plain route: max err {err:.3g}, {d} ids differ (near-ties); "
        f"the exact top-10 holds {planted_found:.4f} of each query's planted set")
    check(planted_found >= 0.99, "the exact scan finds the planted copies")
    out.update(k3_search_s=k3_s, plain_search_s=plain_s, k3_max_err=err, k3_ids_differ=d,
               exact_planted_recall10=planted_found)

    # K4 route: build PQ4 (the engine's group at >= 1M rows), unfiltered search
    _, out["build_pq_s"] = timed(lambda: idx.build_pq(m=48, ksub=16, pack4=True, group=64))
    log(f"[phase5] build_pq(m=48, ksub=16, pack4, group=64) in {out['build_pq_s']:.2f} s")
    _, cents, _, _ = idx._pq_arrays()
    os.environ["YAMS_PQ_PALLAS"] = "auto"
    check(idx._use_pallas_adc(True, 64, cents, None), "unfiltered PQ4 search routes to K4")
    idx.search_pq(queries[:8], k=10)               # warm-up
    (k4v, k4i), k4_s = timed(lambda: idx.search_pq(queries, k=10))
    os.environ["YAMS_PQ_PALLAS"] = "0"
    try:
        (p0v, p0i), p0_s = timed(lambda: idx.search_pq(queries, k=10))
    finally:
        os.environ["YAMS_PQ_PALLAS"] = "auto"
    r_k4, r_plain = recall_at(k4i, pi), recall_at(p0i, pi)
    log(f"[phase5] search_pq(k=10) B={B}: K4 route {k4_s:.3f} s, recall@10 {r_k4:.4f}; "
        f"plain route {p0_s:.3f} s, recall@10 {r_plain:.4f} (exact oracle: the plain scan)")
    check(abs(r_k4 - r_plain) <= 0.01, "K4 route recall@10 within 0.01 of the plain route")
    check(r_k4 >= 0.5, "K4 route recall@10 >= 0.5 on the planted sets")
    check(np.isfinite(k4v).all() and k4i.shape == (B, 10), "finite (B, 10) PQ results")
    out.update(pq_k4_s=k4_s, pq_plain_s=p0_s, pq_recall10_k4=r_k4, pq_recall10_plain=r_plain)

    # filtered search_pq: the mask rides into the plain ADC scan
    mask = np.zeros(N, np.float32)
    allowed = np.random.default_rng(SEED).choice(N, N // 100, replace=False)
    mask[allowed] = 1.0
    (fv, fi), f_s = timed(lambda: idx.search_pq(queries[:64], k=10, doc_mask=mask))
    live = fi[fv > -1e29]
    check(live.size > 0 and bool((mask[idx.slots_of_rows(live)] == 1).all()),
          "filtered search_pq honors the mask")
    log(f"[phase5] filtered search_pq (1% of docs) B=64: {f_s:.3f} s, all hits in the filter")
    out["pq_filtered_s"] = f_s
    return out


# -- phase 6 ------------------------------------------------------------------
def phase6_engine_pq(dev, eng, queries) -> dict:
    """The engine's PQ tier: phase 3's state carried into an engine='pq4'
    engine with the tier on; 64 queries on the card, 16 checked on the CPU."""
    from yams_tpu_torch.convert import load_state, state_from_jax
    from yams_tpu_torch.search.config import SearchEngineConfig, VectorIndexConfig
    from yams_tpu_torch.search.engine import SearchEngine

    def make(device):
        return SearchEngine(SearchEngineConfig(pq_tier_enabled=True),
                            vector=VectorIndexConfig(dim=eng.provider.dim, engine="pq4"),
                            device=device)

    t = time.perf_counter()
    pq = make(dev)
    load_state(pq, state_from_jax(eng))
    check(pq.ensure_pq(), "ensure_pq built the PQ4 tier")
    build_s = time.perf_counter() - t
    vi = pq.vector_index
    log(f"[phase6] engine pq4: state carried + ensure_pq in {build_s:.2f} s "
        f"(m={vi._pq_codebook.m}, ksub={vi._pq_codebook.ksub}, group={vi._pq_group}, "
        f"rows {vi.active_rows})")
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pq.search_batch(queries)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    res = pq.search_batch(queries)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t
    check(vi._device is None, "the PQ tier never uploaded the dense matrix")
    check(all(len(r) == 10 for r in res), "10 results per query")
    check(all(np.isfinite([x.score for r in res for x in r])), "finite scores")
    cpu = make("cpu")
    load_state(cpu, state_from_jax(pq))
    ref = cpu.search_batch(queries[:16])
    overlap = float(np.mean([len({x.doc_id for x in a} & {x.doc_id for x in b}) / 10
                             for a, b in zip(res[:16], ref)]))
    log(f"[phase6] search_batch(64) on the PQ tier: first {first_s:.3f} s, steady "
        f"{steady_s * 1e3:.1f} ms; top-10 overlap with the CPU plain path on 16 queries "
        f"{overlap:.4f}")
    check(overlap >= 0.98, "PQ tier top-10 overlap >= 0.98 vs CPU")
    return {"build_s": build_s, "first_search_s": first_s, "steady_search_ms": steady_s * 1e3,
            "overlap_vs_cpu": overlap}, vi


# -- phase 7 ------------------------------------------------------------------
def phase7_experiments(dev) -> dict:
    """The two top-C experiments at the reference scripts' shapes, each
    against the matmul + top-C path (dot_f32 + select.top_k)."""
    from yams_tpu_torch.scripts import exp_flash_topk, profile_grouped

    runs = (
        ("profile_grouped", profile_grouped.run,
         dict(N=1_000_000, D=768, B=256, iters=8, block=4096, group=256, C=32)),
        ("exp_flash_topk", exp_flash_topk.run,
         dict(N=1_015_808, D=768, B=1024, iters=8, C=32, n_clusters=4096, sigma=0.35)),
    )
    out = {}
    for name, run, kw in runs:
        r = run(**kw, device=dev, seed=SEED)
        log(f"[phase7] {name}: kernel path {r['kernel_qps']:.1f} QPS, recall@10 "
            f"{r['kernel_recall10']:.4f}; matmul + top-C {r['matmul_topc_qps']:.1f} QPS, "
            f"recall@10 {r['matmul_topc_recall10']:.4f}; {json.dumps(r)}")
        check(r["matmul_topc_recall10"] >= 0.999, f"{name}: the exact top-C path is exact")
        check(r["kernel_recall10"] >= 0.9, f"{name}: kernel path recall@10 >= 0.9")
        out[name] = r
        torch.cuda.empty_cache()
    return out


# -- phase 8 ------------------------------------------------------------------
PEAK_INT8 = 1979e12                # int8 operations /s, dense tensor cores


def fused_agree(what: str, av, ai, bv, bi, tol: float = 1e-5, tie: float = 1e-4):
    """Two programs' fused top-k on the same inputs: values rank by rank
    within `tol`, and every differing id a near-tie: the doc's score in the
    other list within `tie` of its own or, where the other list lacks it,
    within `tie` of that list's last score. -> (max value error, ids that
    differ)."""
    av, ai, bv, bi = (t.cpu().numpy() for t in (av, ai, bv, bi))
    err = float(np.abs(av - bv).max())
    check(err <= tol, f"{what}: fused values within {tol} (max error {err:.3g})")
    differ = 0
    for q, j in zip(*np.nonzero(ai != bi)):
        differ += 1
        hit = np.nonzero(bi[q] == ai[q, j])[0]
        other = bv[q, hit[0]] if hit.size else bv[q, -1]
        check(abs(float(av[q, j]) - float(other)) <= tie,
              f"{what}: query {q} rank {j}: id {ai[q, j]} differs and is no near-tie")
    return err, differ


def phase8_streaming(dev, N: int = 1 << 22, D: int = 768, B: int = 1024,
                     V: int = 65536, block: int = 262_144) -> dict:
    """The streaming blocked scan and the int8 corpus at 4,194,304 x 768:
    hybrid_query on phase 4's clustered generator and packed postings, bf16
    and int8, each against its materialized program at the largest B whose
    (B, rows) scores fit; QPS, peak memory, the product / top-C split, and
    torch._int_mm against dot_f32 at one block's shape."""
    from yams_tpu_torch.ops.scan import dot_f32, int8_mm, int8_product, quantize_int8, quantize_rows
    from yams_tpu_torch.ops.select import top_k
    from yams_tpu_torch.scripts._common import qps_windows, recall
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.search.fusion import hybrid_query, pack_weights

    S, T, K, C, WIN, ITERS, WINDOWS = 4096, 16, 10, 32, 1024, 4, 5
    out: dict = {"rows": N, "dim": D, "batch": B, "scan_block_rows": block}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    t = time.perf_counter()
    E = clustered_corpus(dev, gen, N, D)
    proj = torch.where(torch.rand(S, D, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    proj = (proj / np.sqrt(D)).to(torch.bfloat16)
    packed, scale = packed_postings(dev, N, V, WIN)
    # the int8 tier of the same corpus: per-row codes and scales, quantized
    # on the card in row chunks with the host tier's arithmetic
    E8 = torch.empty(N, D, dtype=torch.int8, device=dev)
    scale8 = torch.empty(N, dtype=torch.float32, device=dev)
    for lo in range(0, N, 1 << 18):
        E8[lo:lo + (1 << 18)], scale8[lo:lo + (1 << 18)] = quantize_rows(
            E[lo:lo + (1 << 18)].float())
    h8, hs = quantize_int8(E[:4096].float().cpu().numpy())
    check(np.array_equal(E8[:4096].cpu().numpy(), h8)
          and np.array_equal(scale8[:4096].cpu().numpy(), hs),
          "the card's int8 codes and scales equal quantize_int8's")
    ones = torch.ones(N, device=dev)
    row2slot = torch.arange(N, device=dev, dtype=torch.int32)
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    hot = torch.zeros(N, device=dev)
    w = torch.from_numpy(pack_weights(SearchEngineConfig())).to(dev)
    sketches = torch.randn(ITERS, B, S, generator=gen, device=dev)
    tids = torch.randint(0, V, (ITERS, B, T), generator=gen, device=dev, dtype=torch.int32)
    tmask = torch.ones(ITERS, B, T, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    log(f"[phase8] corpus {N}x{D} bf16 ({E.nbytes / 1e9:.2f} GB) and int8 "
        f"({(E8.nbytes + scale8.nbytes) / 1e9:.2f} GB), packed postings {V}x{WIN}, "
        f"built in {out['build_s']:.2f} s")

    def run(i, int8, b=B, scan=block):
        return hybrid_query(
            sketches[i, :b], tids[i, :b], tmask[i, :b], proj, E8 if int8 else E, ones,
            row2slot, scale8 if int8 else ones, packed, scale, dummy, dummy, ones, hot, w,
            k=K, rrf_cand=C, window=WIN, num_slots=N, rows_are_docs=True,
            bm25_prefilter=256, packed_lexical=True, int8_corpus=int8, scan_block_rows=scan)

    def peak_of(fn):
        """Bytes the call adds above what was allocated before it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        r = fn()
        torch.cuda.synchronize()
        return r, torch.cuda.max_memory_allocated(dev) - base

    matrix_bytes = B * N * 4
    slots = {}
    for name, int8 in (("bf16", False), ("int8", True)):
        (vals, _, _, _), peak = peak_of(lambda: run(0, int8))
        check(bool(torch.isfinite(vals).all()) and vals.shape == (B, K),
              f"{name}: finite (B, k) fused scores")
        qps, windows = qps_windows(lambda i: run(i, int8), ITERS, B, WINDOWS, dev)
        slots[name] = torch.stack([run(i, int8)[1] for i in range(ITERS)]).cpu().numpy()
        log(f"[phase8] streaming {name}: QPS median {qps:.1f} over {WINDOWS} windows of "
            f"{ITERS} batches of B={B} (windows: " + ", ".join(f"{x:.1f}" for x in windows)
            + f"); peak {peak / 1e9:.3f} GB above the resident corpus, against "
            f"{matrix_bytes / 1e9:.2f} GB of (B, rows) f32 scores")
        check(peak < matrix_bytes, f"{name}: streaming peak below the (B, rows) f32 bytes")
        out[name] = {"qps_median": qps, "qps_windows": windows, "peak_bytes": peak}
    r_int8 = recall(slots["int8"].reshape(-1, K), slots["bf16"].reshape(-1, K))
    log(f"[phase8] int8 recall@10 against the bf16 program's top-10: {r_int8:.4f}")
    check(r_int8 >= 0.85, "int8 recall@10 >= 0.85 against bf16")
    out["int8"]["recall10_vs_bf16"] = r_int8

    # the materialized programs at the largest B whose (B, rows) scores fit:
    # the int8 program holds its int32 product and the f32 scores at once,
    # and the top-C its own temporaries, so four matrices must fit
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    b_cmp = B
    while b_cmp > 8 and 4 * b_cmp * N * 4 > free:
        b_cmp //= 2
    out["materialized_batch"] = b_cmp
    for name, int8 in (("bf16", False), ("int8", True)):
        sv, si, _, _ = run(0, int8, b_cmp)
        (mv, mi, _, _), peak = peak_of(lambda: run(0, int8, b_cmp, scan=0))
        err, d = fused_agree(f"{name} streaming vs materialized", sv, si, mv, mi)
        t_m = cuda_ms(lambda: run(0, int8, b_cmp, scan=0), 2)
        t_s = cuda_ms(lambda: run(0, int8, b_cmp), 2)
        log(f"[phase8] {name} at B={b_cmp} (the largest whose (B, rows) scores fit "
            f"{free / 1e9:.1f} GB free four times): streaming == materialized, max value "
            f"error {err:.3g}, {d} of {si.numel()} ids differ (near-ties within 1e-4); "
            f"materialized peak {peak / 1e9:.3f} GB, {t_m:.2f} ms; streaming {t_s:.2f} ms")
        out[name].update(materialized_peak_bytes=peak, materialized_ms=t_m,
                         streaming_ms_at_cmp=t_s, max_err_vs_materialized=err,
                         ids_differ_vs_materialized=d)
        torch.cuda.empty_cache()

    # where a streaming batch's time goes: its totals, then each device
    # operation of one block (CUDA events) with its launches a batch and
    # its bound
    G = N // block
    qv = dot_f32(sketches[0], proj.t())
    qv = qv / qv.norm(dim=-1, keepdim=True)
    q8, qs = quantize_rows(qv)

    def products(int8):
        for g in range(G):
            sl = slice(g * block, (g + 1) * block)
            if int8:
                int8_product(q8, qs, E8[sl], scale8[sl])
            else:
                dot_f32(qv, E[sl])

    s_blk = dot_f32(qv, E[:block])
    i_blk = int8_mm(q8, E8[:block])
    zero_bias = ((ones[:block] - 1.0) * 1e30)[None, :]
    cand = torch.randn(B, C * (G + 1), generator=gen, device=dev)
    scores_bytes, mac = B * block * 4, 2.0 * B * block * D
    table = {}
    for name, fn, launches, nbytes, nops, rate in (
            ("dot_f32 (bf16 product)", lambda: dot_f32(qv, E[:block]), G,
             2 * B * D + 2 * block * D + scores_bytes, mac, PEAK_BF16),
            ("torch._int_mm (int8 product)", lambda: int8_mm(q8, E8[:block]), G,
             B * D + block * D + scores_bytes, mac, PEAK_INT8),
            ("int8 dequantization", lambda: torch.mul(i_blk, qs[:, None]).mul_(scale8[:block]),
             G, 2 * scores_bytes + 4 * (B + block), 2.0 * B * block, PEAK_CORE),
            ("validity and doc-mask biases", lambda: s_blk.add_(zero_bias).add_(zero_bias), G,
             2 * scores_bytes + 8 * block, 2.0 * B * block, PEAK_CORE),
            ("per-block top-C (select.top_k)", lambda: top_k(s_blk, C), G,
             scores_bytes + 12 * B * C, 1.0 * B * block, PEAK_CORE),
            ("merge top-C (select.top_k)", lambda: top_k(cand, C), 1,
             cand.nbytes + 12 * B * C, 1.0 * cand.numel(), PEAK_CORE)):
        table[name] = {"ms": cuda_ms(fn, 5), "launches_per_batch": launches,
                       **bound(nbytes, nops, rate)}
    split = {"top_c_ms": table["per-block top-C (select.top_k)"]["ms"] * G}
    for name, int8 in (("bf16", False), ("int8", True)):
        split[f"{name}_products_ms"] = cuda_ms(lambda: products(int8), 3)
        split[f"{name}_batch_ms"] = cuda_ms(lambda: run(0, int8), 3)
        split[f"{name}_rest_ms"] = (split[f"{name}_batch_ms"] - split[f"{name}_products_ms"]
                                    - split["top_c_ms"])
    del s_blk, i_blk
    log(f"[phase8] one streaming batch (B={B}, {G} blocks): " + json.dumps(
        {k: round(v, 3) for k, v in split.items()}))
    for name, r in table.items():
        log(f"[phase8] {name}: {r['ms']:.3f} ms a launch, {r['launches_per_batch']} a batch; "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}: {r['bound_bytes'] / 1e9:.3f} GB, "
            f"{r['bound_ops']:.3g} operations)")
    out.update(split_ms=split, block_ops=table)
    return out


def flat_docs(n: int, seed: int):
    """n one-sentence documents without titles (one chunk each, the flat
    layout the streaming tier needs) and 64 queries, phase 3's vocabulary."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(1024)]
    lens = rng.integers(8, 16, n)
    z = rng.zipf(1.3, size=int(lens.sum())) % len(vocab)
    docs, p = [], 0
    for i, L in enumerate(lens):
        docs.append((200_000 + i, " ".join(vocab[j] for j in z[p:p + L]) + ".", ""))
        p += L
    queries = [" ".join(vocab[j] for j in rng.zipf(1.3, size=int(rng.integers(2, 6)))
                        % len(vocab)) for _ in range(64)]
    return docs, queries


def phase8_engine(dev, n_docs: int = 65_536) -> dict:
    """The engine on a flat corpus above a lowered streaming threshold, bf16
    and int8: search_batch must pick the streaming tier itself, unfiltered,
    with a shared filter and with per-query filters; then remove_document,
    touch_hot and record_feedback, each intent and search_expanded. Every
    search is held against the same engine on the CPU (16 queries)."""
    from yams_tpu_torch.convert import load_state, state_from_jax
    from yams_tpu_torch.search.config import SearchEngineConfig, VectorIndexConfig
    from yams_tpu_torch.search.engine import SearchEngine

    docs, queries = flat_docs(n_docs, SEED + 9)

    def make(device, dtype):
        cfg = SearchEngineConfig(streaming_threshold=n_docs // 2,
                                 streaming_block_rows=n_docs // 4)
        return SearchEngine(cfg, vector=VectorIndexConfig(dtype=dtype), device=device)

    t = time.perf_counter()
    card = {"bfloat16": make(dev, "bfloat16")}
    card["bfloat16"].add_documents(docs)
    add_s = time.perf_counter() - t
    check(card["bfloat16"].vector_index.identity_layout, "one chunk a doc: the identity layout")
    state = state_from_jax(card["bfloat16"])
    card["int8"] = make(dev, "int8")
    load_state(card["int8"], state)
    cpu = {}
    for dtype in card:
        cpu[dtype] = make("cpu", dtype)
        load_state(cpu[dtype], state)
    log(f"[phase8] engine: {n_docs} flat docs added in {add_s:.2f} s; "
        f"rows {card['bfloat16'].vector_index.capacity}, slots "
        f"{card['bfloat16'].num_slots_padded}; streaming_threshold {n_docs // 2}, "
        f"streaming_block_rows {n_docs // 4}")
    shared = {d[0] for d in docs[::3]}
    few = {d[0] for d in docs[5:40:7]}
    per_query = [(shared, None, few)[i % 3] for i in range(len(queries))]
    overlaps: dict[str, float] = {}
    out: dict = {"docs": n_docs, "add_s": add_s}

    def held(name, got, want):
        """Top-10 overlap of the card's results with the CPU's."""
        overlaps[name] = float(np.mean([
            len({x.doc_id for x in a} & {x.doc_id for x in b}) / max(len(a), len(b), 1)
            for a, b in zip(got, want)]))

    for dtype in card:
        eng, ref = card[dtype], cpu[dtype]
        searches = 0
        for fname, kw, kw16 in (
                ("unfiltered", {}, {}),
                ("shared filter", {"filter_doc_ids": shared}, {"filter_doc_ids": shared}),
                ("per-query filters", {"per_query_filters": per_query},
                 {"per_query_filters": per_query[:16]})):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = eng.search_batch(queries, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            searches += len(queries)
            check(eng.last_trace.get("scan_block_rows") == n_docs // 4,
                  f"{dtype} {fname}: search_batch took the streaming tier")
            check(all(r for r in res[:16]), f"{dtype} {fname}: results")
            if fname == "shared filter":
                check(all(x.doc_id in shared for r in res for x in r), "shared filter honored")
            if fname == "per-query filters":
                check(all(x.doc_id in f for r, f in zip(res, per_query) if f is not None
                          for x in r), "per-query filters honored")
            held(f"{dtype} streaming {fname}", res[:16], ref.search_batch(queries[:16], **kw16))
            out[f"{dtype} streaming {fname} ms"] = ms
        base = eng.search_batch(queries)
        searches += len(queries)
        removed = {r[0].doc_id for r in base[:16]} | {d[0] for d in docs[::1024]}
        hot_docs = [r[0].doc_id for r in base[16:32] if r]
        liked = [r[1].doc_id for r in base[32:48] if len(r) > 1]
        for e in (eng, ref):
            for d in removed:
                check(e.remove_document(d), "remove_document found the doc")
            for d in hot_docs:
                e.touch_hot(d, 2.0)
            for d in liked:
                e.record_feedback(d)
        check(not eng.vector_index.identity_layout, "tombstones end the identity layout")
        res = eng.search_batch(queries)
        searches += len(queries)
        check("scan_block_rows" not in eng.last_trace, "after removals: the materialized tier")
        seen = {x.doc_id for r in res for x in r}
        held(f"{dtype} after removals and feedback", res[:16], ref.search_batch(queries[:16]))
        for intent in ("navigational", "lookup", "conceptual", "question"):
            res = eng.search_batch(queries[:16], intent=intent)
            searches += 16
            seen |= {x.doc_id for r in res for x in r}
            held(f"{dtype} intent {intent}", res, ref.search_batch(queries[:16], intent=intent))
        got, want = [], []
        for j in range(4):
            exp = queries[16 + 2 * j:18 + 2 * j]
            got.append(eng.search_expanded(queries[j], exp))
            want.append(ref.search_expanded(queries[j], exp))
            searches += 1 + len(exp)
        seen |= {x.doc_id for r in got for x in r}
        held(f"{dtype} search_expanded", got, want)
        check(not seen & removed, f"{dtype}: no removed doc returned")
        stats = eng.stats()
        check(stats["searches"] == searches,
              f"{dtype}: stats() counts {stats['searches']} searches, {searches} run")
        out[f"{dtype} searches"] = searches
    log("[phase8] engine top-10 overlap with the CPU on 16 queries: " + json.dumps(overlaps))
    for name, v in overlaps.items():
        check(v == 1.0, f"{name}: top-10 overlap 1.0 with the CPU")
    out["overlap_vs_cpu"] = overlaps
    return out


# -- phase 9 ------------------------------------------------------------------
KG_STAGES = ("_entity_vector_batch", "_kg_scores", "_graph_rerank", "_community_support")


def staged(eng, fn):
    """fn() with the engine's KG stages timed where search_batch calls them
    (_community_support runs inside _graph_rerank). -> (fn's result,
    {stage: seconds}, the window length of each _community_support call)."""
    spent, windows = dict.fromkeys(KG_STAGES, 0.0), []

    def timed(name):
        orig = getattr(eng, name)

        def call(*args, **kwargs):
            if name == "_community_support":
                windows.append(len(args[0]))
            t = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    for name in KG_STAGES:
        setattr(eng, name, timed(name))
    try:
        return fn(), spent, windows
    finally:
        for name in KG_STAGES:
            delattr(eng, name)


def results_agree(what: str, got, want, atol: float = 1e-4) -> dict:
    """Two engines' result lists, query by query: the same ids in the same
    order with scores (and KG scores) within `atol`, except where two
    results tie: an id in another place must have its score, in the other
    list, within `atol` of the score it has here (or, where the other list
    lacks it, of that list's last score). Every tie is printed.
    -> {"equal": queries with equal ids, "ties": [...], "max_err"}."""
    equal, ties, err = 0, [], 0.0
    for q, (g, w) in enumerate(zip(got, want, strict=True)):
        check(len(g) == len(w), f"{what}: query {q}: {len(g)} results against {len(w)}")
        w_score = {r.doc_id: r.score for r in w}
        for j, (a, b) in enumerate(zip(g, w)):
            if a.doc_id == b.doc_id:
                err = max(err, abs(a.score - b.score), abs(a.kg_score - b.kg_score))
                continue
            other = w_score.get(a.doc_id, w[-1].score)
            check(abs(a.score - other) <= atol,
                  f"{what}: query {q} rank {j}: doc {a.doc_id} ({a.score:.7f}) against "
                  f"{b.doc_id} ({b.score:.7f}) is no tie")
            ties.append((q, j, a.doc_id, b.doc_id, round(a.score, 7), round(b.score, 7)))
        equal += [r.doc_id for r in g] == [r.doc_id for r in w]
    check(err <= atol, f"{what}: scores within {atol} (max error {err:.3g})")
    if ties:
        log(f"[ties] {what} (query, rank, doc here, doc there, scores): {ties}")
    return {"equal": equal, "ties": len(ties), "max_err": err}


def timed_search(dev, eng, queries, reps: int = 3):
    """(first seconds, median steady seconds, results) of search_batch."""
    times, res = [], None
    for _ in range(reps + 1):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = eng.search_batch(queries)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t)
    return times[0], float(np.median(times[1:])), res


def phase9_kg(dev, card: str, eng, cpu, docs, queries, phase3_steady_ms: float,
              pq_vi) -> dict:
    """The engine as the service layer opens and serves it: a KG over phase
    3's documents in SQLite, the KG leg, graph rerank, semantic rescue and the
    tuner held against the CPU twin, then both indexes saved and reopened in
    a fresh engine, phase 6's PQ4 index through K3 and K4 before the save
    and after the reload, each held against its plain route, and an int8
    index reloaded as int8."""
    import os
    import tempfile

    from yams_tpu_torch.convert import load_pq_state, pq_state
    from yams_tpu_torch.index.lexical_index import LexicalIndex
    from yams_tpu_torch.index.vector_index import VectorIndex
    from yams_tpu_torch.metadata import Database, KnowledgeGraphStore
    from yams_tpu_torch.ops import pq_pallas
    from yams_tpu_torch.ops.pq import pq_lut
    from yams_tpu_torch.scripts.kg_fixture import build_kg, kg_graph, one_transaction
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.search.engine import SearchEngine
    from yams_tpu_torch.search.tuner import SearchTuner
    from yams_tpu_torch.services.app import AppContext

    def insert_docs(db, doc_ids):
        with db.lock, db.conn:
            db.conn.executemany(
                "INSERT INTO documents (id, file_path, file_name, sha256_hash, created_time,"
                " modified_time, indexed_time, content_extracted) VALUES (?,?,?,?,0,0,0,1)",
                [(d, f"/corpus/{d}.txt", f"{d}.txt", f"{d:064x}") for d in doc_ids])

    out: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_kg_")
    root = pathlib.Path(tmp.name)
    try:
        # -- the KG, built with the graph service's calls on one SQLite file
        labels, links = kg_graph(docs, seed=SEED + 9)
        db = Database(root / "metadata.db")
        insert_docs(db, [d for d, _, _ in docs])
        with db.lock, db.conn:
            db.conn.executemany(
                "INSERT INTO metadata (document_id, key, value) VALUES (?, '__slot__', ?)",
                [(d, str(s)) for d, s in eng._slot_by_doc.items()])
        # the service commits each call: that cost, with db.py's options, on
        # the first 1,024 documents' links in a file of their own
        sample = links[:1024]
        used = sorted({e for _, ents in sample for e, _ in ents})
        at = {e: i for i, e in enumerate(used)}
        sdb = Database(root / "sample.db")
        insert_docs(sdb, [d for d, _ in sample])
        t = time.perf_counter()
        _, sample_calls = build_kg(KnowledgeGraphStore(sdb), [labels[e] for e in used],
                                   [(d, [(at[e], c) for e, c in ents]) for d, ents in sample])
        sample_s = time.perf_counter() - t
        sdb.close()
        # the whole graph with the same calls, joined into one transaction
        t = time.perf_counter()
        with one_transaction(db) as bulk:
            nodes, calls = build_kg(bulk, labels, links)
        kg_s = time.perf_counter() - t
        kg = KnowledgeGraphStore(db)
        t = time.perf_counter()
        for e in (eng, cpu):
            e.config = SearchEngineConfig()
            e.add_entity_vectors(nodes, labels)
        ent_s = time.perf_counter() - t
        n_links = sum(len(x) for _, x in links)
        call_us = sample_s / sample_calls * 1e6
        log(f"[phase9] KG: {kg.node_count()} nodes, {n_links} doc links, {kg.edge_count()} edges: "
            f"{calls} graph service calls joined in one transaction in {kg_s:.2f} s; a "
            f"transaction a call, as the service commits them: {sample_calls} calls for the "
            f"first 1,024 documents in {sample_s:.2f} s ({call_us:.1f} us a call); entity side "
            f"index {eng.entity_index.active_rows} rows (capacity {eng.entity_index.capacity}) "
            f"on both engines in {ent_s:.2f} s")
        check(eng.entity_index.active_rows == len(labels) >= 16_384, "entity rows")
        check(np.array_equal(eng.entity_index._vecs, cpu.entity_index._vecs),
              "card and CPU entity rows equal")
        out.update(nodes=len(nodes), doc_links=n_links, edges=kg.edge_count(), kg_calls=calls,
                   kg_build_s=kg_s, sample_calls=sample_calls, sample_s=sample_s,
                   service_call_us=call_us, entity_add_s=ent_s)

        # 64 queries, half naming an entity label
        rng = np.random.default_rng(SEED + 10)
        linked = sorted({e for _, ents in links for e, _ in ents})
        named = [labels[linked[i]] for i in rng.choice(len(linked), 32, replace=False)]
        qs = [named[i // 2] if i % 2 else queries[i] for i in range(64)]

        # -- timing: without the KG, then with it (each engine opens its own store)
        _, nokg_s, _ = timed_search(dev, eng, qs)
        eng.kg = KnowledgeGraphStore(Database(root / "metadata.db"))
        cpu.kg = KnowledgeGraphStore(Database(root / "metadata.db"))
        first_s, steady_s, res = timed_search(dev, eng, qs)
        kg_named = sum(any(r.kg_score > 0 for r in res[i]) for i in range(1, 64, 2))
        log(f"[phase9] {card}: search_batch(64) with the KG leg: first {first_s * 1e3:.1f} ms, steady "
            f"{steady_s * 1e3:.1f} ms; without it {nokg_s * 1e3:.1f} ms here, "
            f"{phase3_steady_ms:.1f} ms in phase 3; {kg_named} of 32 entity-naming queries "
            f"have a result with kg_score > 0")
        check(kg_named >= 16, "half the entity-naming queries reach the KG leg")
        check(all(len(r) == 10 for r in res), "10 results per query")
        out.update(first_search_ms=first_s * 1e3, steady_search_ms=steady_s * 1e3,
                   steady_no_kg_ms=nokg_s * 1e3, phase3_steady_ms=phase3_steady_ms,
                   kg_named_hits=kg_named)

        # where a steady batch's KG time goes: each stage timed inside the
        # batch, on the windows the batch itself reranks (3 batches, mean)
        def batch():
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            eng.search_batch(qs)
            torch.cuda.synchronize(dev)
            return time.perf_counter() - t

        runs = [staged(eng, batch) for _ in range(3)]
        batch_ms = float(np.mean([r[0] for r in runs])) * 1e3
        stage_ms = {n: float(np.mean([r[1][n] for r in runs])) * 1e3 for n in KG_STAGES}
        windows = runs[-1][2]
        rest_ms = batch_ms - sum(stage_ms[n] for n in KG_STAGES[:3])
        qv = eng.provider.encode(qs)
        ent_ms = cuda_ms(lambda: eng.entity_index.search(qv, k=4), 10)
        log(f"[phase9] {card}: a steady search_batch(64) with its KG stages timed inside it: "
            f"{batch_ms:.1f} ms = _entity_vector_batch {stage_ms['_entity_vector_batch']:.1f} "
            f"(its device search alone, 64 x {eng.entity_index.capacity} rows, k 4: "
            f"{ent_ms:.3f} ms) + _kg_scores {stage_ms['_kg_scores']:.1f} + _graph_rerank "
            f"{stage_ms['_graph_rerank']:.1f} (of it _community_support "
            f"{stage_ms['_community_support']:.1f}, {len(windows)} windows of "
            f"{np.mean(windows) if windows else 0:.1f} results) + the rest {rest_ms:.1f} ms "
            f"(the batch without the KG: {nokg_s * 1e3:.1f} ms)")
        check(len(windows) == 64, "the batch reranks 64 windows")
        out.update(staged_batch_ms=batch_ms, stage_ms=stage_ms, rest_ms=rest_ms,
                   rerank_windows=len(windows), mean_window=float(np.mean(windows)),
                   entity_search_ms=ent_ms)

        # the entity leg's hits against the CPU's, and how near 0.4 they come
        ev = eng._entity_vector_batch(qs, qvecs=qv)
        cpu_ev = cpu._entity_vector_batch(qs, qvecs=qv)
        near = [(q, n, s) for q, h in enumerate(ev) for n, s in h if abs(s - 0.4) < 1e-4]
        vals, _ = eng.entity_index.search(qv, k=4)
        edge = float(np.abs(vals[vals > -1e29] - 0.4).min())
        log(f"[phase9] entity leg: {sum(map(len, ev))} hits >= 0.4 for 64 queries; near the "
            f"threshold (within 1e-4): {near}; closest similarity to 0.4: {edge:.3g} off")
        check([[n for n, _ in h] for h in ev] == [[n for n, _ in h] for h in cpu_ev],
              "entity hits equal the CPU's")
        out.update(entity_hits=sum(map(len, ev)), threshold_margin=edge)

        # -- gates: the card against the CPU twin on 16 queries
        q16 = qs[:16]
        out["default"] = results_agree("default (KG leg + graph rerank)",
                                       eng.search_batch(q16), cpu.search_batch(q16))
        for e in (eng, cpu):
            e.config = SearchEngineConfig(semantic_rescue_slots=2)
        out["rescue"] = results_agree("semantic_rescue_slots=2",
                                      eng.search_batch(q16), cpu.search_batch(q16))
        for e in (eng, cpu):
            e.config = SearchEngineConfig(tuner_enabled=True)
            e.tuner = SearchTuner()
        arms, tuner = [], {"equal": 0, "ties": 0, "max_err": 0.0}
        for step in range(8):
            got, want = eng.search_batch(q16), cpu.search_batch(q16)
            check(eng.last_trace["tuner_arm"] == cpu.last_trace["tuner_arm"], "same tuner arm")
            arms.append(eng.last_trace["tuner_arm"])
            r = results_agree(f"tuner arm {arms[-1]}", got, want)
            tuner = {"equal": tuner["equal"] + r["equal"], "ties": tuner["ties"] + r["ties"],
                     "max_err": max(tuner["max_err"], r["max_err"])}
            for i in range(4):       # 32 feedback calls in all, the same on both
                doc, relevant = got[i][step % len(got[i])].doc_id, (step + i) % 3 != 0
                eng.record_feedback(doc, relevant)
                cpu.record_feedback(doc, relevant)
        check(eng.tuner._stats == cpu.tuner._stats, "tuner statistics equal")
        out["tuner"] = {**tuner, "arms": arms}
        for e in (eng, cpu):
            e.tuner = None
            e.clear_hot()
            e.config = SearchEngineConfig()
        log(f"[phase9] card == CPU on 16 queries: {json.dumps({k: out[k] for k in ('default', 'rescue', 'tuner')})}")

        # -- persistence: save both indexes, reopen them in a fresh card engine
        before = eng.search_batch(qs)
        vdir = root / "vectors"
        t = time.perf_counter()
        eng.vector_index.save(vdir)
        eng.lexical_index.save(vdir)
        save_s = time.perf_counter() - t
        disk = {f.name: f.stat().st_size for f in sorted(vdir.iterdir())}
        t = time.perf_counter()
        fresh = SearchEngine(kg_store=KnowledgeGraphStore(Database(root / "metadata.db")),
                             device=dev)
        fresh.vector_index = VectorIndex.load(
            vdir, device_dtype=fresh.vector_index.device_dtype, device=dev)
        fresh.lexical_index = LexicalIndex.load(vdir, fresh.lexical_index.config)
        # the slot-map restore AppContext runs when it reopens the indexes
        AppContext._restore_slot_map(types.SimpleNamespace(db=db, search_engine=fresh))
        fresh.add_entity_vectors(nodes, labels)     # the side index is not persisted
        load_s = time.perf_counter() - t
        after = fresh.search_batch(qs)
        out["reopen"] = results_agree("reopened engine", after, before)
        log(f"[phase9] {card}: saved the vector and lexical indexes in {save_s:.2f} s ({disk}); "
            f"reopened in {load_s:.2f} s; 64 searches after == before: {out['reopen']}")
        out.update(save_s=save_s, load_s=load_s, disk_bytes=disk)
        del fresh, before, after

        # -- phase 6's PQ4 index with windows of 64, so the unfiltered scan takes K4
        pq_idx = VectorIndex(dim=pq_vi.dim, capacity=pq_vi.capacity,
                             block_rows=pq_vi.block_rows, space_id=pq_vi.space_id, device=dev)
        live = np.nonzero(pq_vi._valid[:pq_vi._count] > 0)[0]
        check(len(live) == pq_vi._count, "phase 6's rows all live (codes align by row)")
        pq_idx.add(pq_vi._vecs[live], pq_vi._slots[live])
        load_pq_state(pq_idx, {**pq_state(pq_vi), "pq_group": np.asarray(64)})
        check(pq_idx._pq_packed4 and pq_idx._pq_codebook.m == 32, "phase 6's PQ4 index, m 32")
        t = time.perf_counter()
        k3_before = pq_idx.search(qv, k=10, use_pallas=True)
        k4_before = pq_idx.search_pq(qv, k=10, rerank="host")
        pdir = root / "pq4"
        pq_idx.save(pdir)
        reloaded = VectorIndex.load(pdir, device=dev)
        check(reloaded.has_pq and reloaded._pq_group == 64, "pq.npz reloaded")
        k3_after = reloaded.search(qv, k=10, use_pallas=True)
        k4_after = reloaded.search_pq(qv, k=10, rerank="host")
        pq_s = time.perf_counter() - t
        for name, (bv, bi), (av, ai) in (("K3", k3_before, k3_after), ("K4", k4_before, k4_after)):
            check(np.array_equal(ai, bi) and np.array_equal(av, bv),
                  f"{name} on the reloaded index == before the save")
        del reloaded

        # each kernel's route against its plain route on these inputs (D 384,
        # a ragged 140,000-row index, m 32, group 64, B 64)
        qd = torch.from_numpy(qv).to(dev)
        E, valid, _, _ = pq_idx.device_arrays()
        qb = qd.to(torch.bfloat16)
        k3_plain = pq_idx.search(qv, k=10, use_pallas=False)
        k3_err, k3_diff = check_topk(
            "phase 9 K3 route vs the plain scan",
            *(torch.from_numpy(a).to(dev) for a in (*k3_before, *k3_plain)),
            lambda pos, ids: (qb[pos[:, 0]].double() * E[ids.long()].double()).sum(dim=1),
            lambda pos, ids: valid[ids.long()] > 0, 1e-4)
        # the ADC candidates that search_pq reranks: K4's (a comparison's
        # launch, taken off the path's count) against the plain ADC scan's
        c = min(10 * pq_idx._pq_rerank_factor, pq_idx.capacity)
        n0 = pq_pallas.pq4_adc_cuda.launches
        kv, ki = pq_idx._adc_candidates(qd, c)
        check(pq_pallas.pq4_adc_cuda.launches == n0 + 1, "the ADC candidates come from K4")
        pq_pallas.pq4_adc_cuda.launches = n0
        mode = os.environ.get("YAMS_PQ_PALLAS")
        os.environ["YAMS_PQ_PALLAS"] = "0"
        try:
            tv, ti = pq_idx._adc_candidates(qd, c)
            k4_plain = pq_idx.search_pq(qv, k=10, rerank="host")
        finally:
            if mode is None:
                os.environ.pop("YAMS_PQ_PALLAS")
            else:
                os.environ["YAMS_PQ_PALLAS"] = mode
        codes, cents, pvalid, _ = pq_idx._pq_arrays()
        lut = pq_lut(qd, cents).to(torch.bfloat16)
        adc_err, adc_diff = check_topk(
            "phase 9 K4 ADC candidates vs the plain ADC scan", kv, ki, tv, ti,
            k4_true_score(lut, codes, pvalid), lambda pos, ids: pvalid[ids.long()] > 0, 1e-4)
        # the reranked results, on the queries whose candidate sets are equal
        # (the others differ by the near-ties checked above); the host rerank
        # orders exact ties in no fixed way
        same = np.asarray([set(a) == set(b) for a, b in zip(ki.tolist(), ti.tolist())])
        qh = torch.from_numpy(qv[same]).double()
        hv = torch.from_numpy(pq_idx._vecs)
        hvalid = torch.from_numpy(pq_idx._valid)
        k4_err, k4_diff = check_topk(
            "phase 9 search_pq K4 route vs the plain route",
            *(torch.from_numpy(a[same]) for a in (*k4_before, *k4_plain)),
            lambda pos, ids: (qh[pos[:, 0]] * hv[ids.long()].double()).sum(dim=1),
            lambda pos, ids: hvalid[ids.long()] > 0, 1e-4, ordered=False)
        log(f"[phase9] PQ4 index ({len(live)} rows, m 32, group 64, capacity {pq_idx.capacity}): "
            f"K3 and K4 ids and values equal before the save and after the reload "
            f"({pq_s:.2f} s; pq.npz {(pdir / 'pq.npz').stat().st_size} B); K3 route vs the "
            f"plain scan: max err {k3_err:.3g}, {k3_diff} ids differ; K4's {c} ADC "
            f"candidates vs the plain ADC scan: max err {adc_err:.3g}, {adc_diff} ids differ; "
            f"search_pq K4 route vs the plain route on the {int(same.sum())} of 64 queries "
            f"with equal candidate sets: max err {k4_err:.3g}, {k4_diff} ids differ")
        out.update(pq4_roundtrip_s=pq_s, k3_vs_plain=dict(max_err=k3_err, ids_differ=k3_diff),
                   k4_adc_vs_plain=dict(max_err=adc_err, ids_differ=adc_diff),
                   k4_search_vs_plain=dict(max_err=k4_err, ids_differ=k4_diff,
                                           queries=int(same.sum())))
        del pq_idx, E, valid, codes, cents, pvalid, lut

        # -- an int8 index reloaded as int8
        n8 = 16_384
        idx8 = VectorIndex(dim=eng.vector_index.dim, capacity=n8, device_dtype="int8", device=dev)
        idx8.add(eng.vector_index._vecs[:n8], eng.vector_index._slots[:n8])
        want8 = [a.cpu() for a in idx8.device_arrays()]
        idx8.save(root / "int8")
        back8 = VectorIndex.load(root / "int8", device_dtype="int8", device=dev)
        got8 = [a.cpu() for a in back8.device_arrays()]
        check(back8.device_dtype == "int8" and got8[0].dtype == torch.int8, "int8 kept")
        check(all(torch.equal(a[:n8], b[:n8]) for a, b in zip(want8, got8)),
              "int8 codes and scales equal after the reload")
        log(f"[phase9] int8 index of {n8} rows saved and reloaded: device_dtype int8, codes and "
            "scales equal")
        eng.kg = cpu.kg = None
        return out
    finally:
        tmp.cleanup()


# -- phase 10 -----------------------------------------------------------------
def svc_tree(root: pathlib.Path, n_files: int, n_dirs: int, blob_bytes: int, seed: int):
    """Phase 10's seeded tree: n_files zipf-word text files of 96-1,536 words
    in n_dirs directories, a seeded binary blob and a copy of it under
    another name. -> (vocab, text of each file by path, blob bytes, blob
    path, copy path)"""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(8192)])
    lens = rng.integers(96, 1537, n_files)
    z = rng.zipf(1.2, size=int(lens.sum())) % len(vocab)
    texts, p = {}, 0
    for i, n in enumerate(lens):
        d = root / f"d{i % n_dirs:02d}"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"note{i:05d}.txt"
        text = " ".join(vocab[z[p:p + n]]) + "\n"
        path.write_text(text)
        texts[str(path.resolve())] = text
        p += n
    blob = rng.bytes(blob_bytes)
    (root / "blob.bin").write_bytes(blob)
    (root / "copy_of_blob.bin").write_bytes(blob)
    return vocab, texts, blob, (root / "blob.bin").resolve(), (root / "copy_of_blob.bin").resolve()


class ThreadDaemon:
    """The port's YamsDaemon on a background thread with a real AF_UNIX
    socket (as tests/test_interfaces.py runs the reference's), and a client."""

    def __init__(self, cfg, dev, timeout: float = 600.0):
        import asyncio
        import threading

        from yams_tpu_torch.daemon.client import DaemonClient
        from yams_tpu_torch.daemon.server import YamsDaemon

        self.daemon, self.error = YamsDaemon(cfg, device=dev), None
        self.loop = asyncio.new_event_loop()

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(self.daemon.run())
            except BaseException as e:     # noqa: BLE001  (reported by the caller)
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        self.client = DaemonClient(cfg.socket_path)
        deadline = time.monotonic() + timeout
        while not self.client.ping(timeout=5.0):
            check(self.thread.is_alive(), f"the daemon started ({self.error!r})")
            check(time.monotonic() < deadline, "the daemon answered a ping in time")
            time.sleep(0.1)

    @property
    def app(self):
        return self.daemon.app

    def stop(self) -> None:
        self.client.shutdown()
        self.client.close()
        self.thread.join(timeout=120)
        check(not self.thread.is_alive() and self.error is None,
              f"the daemon stopped cleanly ({self.error!r})")
        self.loop.close()


def hits_of(resp) -> list:
    """A daemon search answer (or a SearchResponse) as results_agree's rows."""
    hits = resp["hits"] if isinstance(resp, dict) else [dataclasses.asdict(h) for h in resp.hits]
    return [types.SimpleNamespace(doc_id=h["document_id"], score=h["score"],
                                  kg_score=h["kg_score"]) for h in hits]


def percentiles(lat_s: list[float]) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def phase10_service(dev, card: str, n_files: int = 2048, n_dirs: int = 64,
                    blob_bytes: int = 48 << 20, keep: dict | None = None) -> dict:
    """The service layer on the card through the port's own daemon: add a
    seeded tree, async ingest, sequential and concurrent (batched) search,
    the card's answers against a CPU AppContext on a copy of the data dir,
    the CLI against the socket, and two restarts (the second as int8).
    With `keep`, the data dir outlives the phase: `keep` gets "tmp" (the
    TemporaryDirectory to clean up), "data_dir" and "queries"."""
    import shutil
    import tempfile
    import threading

    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.ops import cdc, sha256
    from yams_tpu_torch.services.app import AppContext

    out: dict = {"card": card}
    d = None
    tmp = tempfile.TemporaryDirectory(prefix="ysvc")
    root = pathlib.Path(tmp.name)
    try:
        t = time.perf_counter()
        vocab, texts, blob, blob_path, copy_path = svc_tree(
            root / "tree", n_files, n_dirs, blob_bytes, SEED + 10)
        tree_bytes = sum(len(x) for x in texts.values()) + 2 * len(blob)
        log(f"[phase10] tree: {n_files} text files in {n_dirs} directories and a "
            f"{blob_bytes >> 20} MiB blob with its copy, {tree_bytes / 1e6:.1f} MB, "
            f"written in {time.perf_counter() - t:.2f} s")
        data_dir = root / "data"
        cfg = load_config(data_dir=data_dir)
        t = time.perf_counter()
        d = ThreadDaemon(cfg, dev)
        out["daemon_start_s"] = time.perf_counter() - t
        pong = d.client.call("ping")
        check(pong.get("backend") == "torch" and pong.get("device") == str(dev),
              f"the daemon is the port's, on {dev} ({pong})")
        check(d.app.search_engine.device == dev and d.app.content_store.device == dev,
              "the daemon's engine and store are on the card")

        # 1. add the tree through the daemon
        g0, s0 = cdc.gear_hash_cuda.launches, sha256.sha256_cuda.launches
        t = time.perf_counter()
        rep = d.client.add_path(str((root / "tree").resolve()))
        add_s = time.perf_counter() - t
        check(rep["files_added"] == n_files + 2 and rep["files_failed"] == 0,
              f"the add took every file ({ {k: rep[k] for k in rep if k != 'errors'} }, "
              f"{rep['errors'][:3]})")
        # every text file is unique, so what was deduped is the blob's copy
        check(rep["bytes_deduped"] == len(blob),
              f"the copy was deduped whole ({rep['bytes_deduped']} of {len(blob)} bytes)")
        gear, sha = (cdc.gear_hash_cuda.launches - g0, sha256.sha256_cuda.launches - s0)
        check(gear >= 1 and sha >= 1,
              f"the add launched gear_hash_cuda ({gear}) and sha256_cuda ({sha})")
        back = d.client.cat(str(blob_path))
        check(back == blob and hashlib.sha256(back).hexdigest() == hashlib.sha256(blob).hexdigest(),
              "cat of the blob gives back its bytes")
        out["add"] = {"s": add_s, "files": rep["files_added"], "bytes": tree_bytes,
                      "files_per_s": rep["files_added"] / add_s,
                      "mb_per_s": tree_bytes / 1e6 / add_s,
                      "bytes_deduped": rep["bytes_deduped"],
                      "gear_hash_launches": gear, "sha256_launches": sha}
        log(f"[phase10] add_path: {rep['files_added']} files in {add_s:.2f} s, "
            f"{out['add']['files_per_s']:.1f} files/s, {out['add']['mb_per_s']:.2f} MB/s; "
            f"copy deduped {rep['bytes_deduped']} bytes; gear_hash_cuda {gear}, "
            f"sha256_cuda {sha} launches; the blob read back bit-exact")

        # 2. async ingest, then wait_idle (off the state lock)
        rng = np.random.default_rng(SEED + 11)
        t = time.perf_counter()
        for i in range(256):
            words = vocab[rng.zipf(1.2, size=int(rng.integers(96, 400))) % len(vocab)]
            d.client.add_bytes((" ".join(words) + "\n").encode(), f"async/a{i:03d}.txt",
                               tags=["async"], async_ingest=True)
        enq_s = time.perf_counter() - t
        t = time.perf_counter()
        q = d.client.call("queue", op="wait_idle", timeout=120.0)
        wait_s = time.perf_counter() - t
        stages = q["stages"]
        check(q["idle"] and all(st["failed"] == 0 for st in stages.values())
              and stages["embedding"]["processed"] == 256,
              f"wait_idle returned with every async job processed ({q})")
        st = d.client.status()
        check(st["graph"]["nodes"] > 0, f"the KG has nodes ({st['graph']})")
        out["async"] = {"enqueue_s": enq_s, "wait_idle_s": wait_s, "stages": stages,
                        "kg_nodes": st["graph"]["nodes"], "kg_edges": st["graph"]["edges"]}
        log(f"[phase10] 256 async adds enqueued in {enq_s:.2f} s; wait_idle returned in "
            f"{wait_s:.2f} s, idle; stages {stages}; KG {st['graph']}")

        # 3. search: sequential, then 8 client threads through the batcher
        queries = [" ".join(vocab[rng.zipf(1.3, size=int(rng.integers(2, 5))) % len(vocab)])
                   for _ in range(32)]
        queries += [f"absent{i} topic{i * 7} unseen" for i in range(32)]
        t = time.perf_counter()
        d.client.search(queries[0])
        out["first_search_s"] = time.perf_counter() - t
        lat = []
        for qtext in queries:
            t = time.perf_counter()
            d.client.search(qtext)
            lat.append(time.perf_counter() - t)
        out["sequential"] = percentiles(lat)
        log(f"[phase10] first search {out['first_search_s']:.3f} s; 64 sequential searches: "
            f"p50 {out['sequential']['p50_ms']:.2f} ms, p99 {out['sequential']['p99_ms']:.2f} ms")

        from yams_tpu_torch.daemon.client import DaemonClient
        clients = [DaemonClient(cfg.socket_path) for _ in range(8)]
        windows, conc_lat = [], []

        def worker(c, off, sink):
            for j in range(32):
                t0 = time.perf_counter()
                c.search(queries[(off + j) % len(queries)])
                sink.append(time.perf_counter() - t0)

        b0 = d.client.status()["search_batching"]
        for w in range(6):
            sinks = [[] for _ in clients]
            threads = [threading.Thread(target=worker, args=(c, 8 * i + w, sinks[i]))
                       for i, c in enumerate(clients)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            wall = time.perf_counter() - t
            check(not any(th.is_alive() for th in threads), "the client threads finished")
            if w:                                   # window 0 warms the batch shapes
                windows.append(256 / wall)
                conc_lat += [x for s in sinks for x in s]
        for c in clients:
            c.close()
        b1 = d.client.status()["search_batching"]
        n_batches = b1["batches"] - b0["batches"]
        out["concurrent"] = {"qps": float(np.median(windows)), "qps_windows": windows,
                             "avg_batch": (b1["batched_requests"] - b0["batched_requests"])
                             / max(n_batches, 1), **percentiles(conc_lat)}
        log(f"[phase10] 8 client threads: QPS median {out['concurrent']['qps']:.1f} over 5 "
            f"windows of 256 ({', '.join(f'{x:.1f}' for x in windows)}); p50 "
            f"{out['concurrent']['p50_ms']:.2f} ms, p99 {out['concurrent']['p99_ms']:.2f} ms; "
            f"{out['concurrent']['avg_batch']:.2f} requests a batch")

        # the split of one steady request (a query not yet seen: no snippet cache)
        svc, eng = d.app.search, d.app.search_engine
        spent = {"_filter_doc_ids": 0.0, "_hydrate": 0.0, "_snippet": 0.0}

        def timed(name):
            orig = getattr(svc, name)

            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    spent[name] += time.perf_counter() - t0
            return call

        for name in spent:
            setattr(svc, name, timed(name))
        try:
            t = time.perf_counter()
            d.client.search(queries[1] + " " + queries[2])
            rtt = time.perf_counter() - t
        finally:
            for name in spent:
                delattr(svc, name)
        tr = eng.last_trace
        split = {"round_trip_ms": rtt * 1e3,
                 "engine_host_prep_ms": tr["stages"]["host_prep_ms"],
                 "engine_device_ms": tr["stages"]["device_ms"],
                 "engine_total_ms": tr["total_ms"],
                 "filters_ms": spent["_filter_doc_ids"] * 1e3,
                 "hydrate_ms": (spent["_hydrate"] - spent["_snippet"]) * 1e3,
                 "snippets_ms": spent["_snippet"] * 1e3}
        split["rest_ms"] = split["round_trip_ms"] - split["engine_total_ms"] - \
            split["filters_ms"] - split["hydrate_ms"] - split["snippets_ms"]
        out["split_ms"] = split
        log("[phase10] one steady request (ms): " + json.dumps(
            {k: round(v, 3) for k, v in split.items()}))

        # 4. the card's answers against a CPU AppContext on a copy of the data dir
        d.client.call("checkpoint")
        shutil.copytree(data_dir, root / "cpu_copy",
                        ignore=shutil.ignore_patterns("daemon.sock", ".lock", "daemon.*"))
        cases = ([{"query": q} for q in queries[2:8]]
                 + [{"query": q, "search_type": "keyword"} for q in queries[8:11]]
                 + [{"query": q, "search_type": "semantic"} for q in queries[11:13]]
                 + [{"query": queries[40], "search_type": "semantic"}]
                 + [{"query": q, "path_glob": "*/d07/*"} for q in queries[13:15]]
                 + [{"query": q, "tags": ["async"]} for q in queries[15:17]])
        fields = [{"limit": 10, "search_type": "hybrid", **c} for c in cases]
        card_res = [hits_of(d.client.call("search", **f)) for f in fields]
        check(all(card_res), "every card query found something")
        t = time.perf_counter()
        cpu_app = AppContext(load_config(data_dir=root / "cpu_copy"), device="cpu")
        try:
            cpu_res = [hits_of(cpu_app.search.search_many_requests([f])[0]) for f in fields]
        finally:
            cpu_app.close()
        out["card_vs_cpu"] = results_agree("daemon on the card against a CPU AppContext",
                                           card_res, cpu_res)
        log(f"[phase10] 16 queries (hybrid, keyword, semantic, path_glob, tags): card daemon "
            f"== CPU app {out['card_vs_cpu']} ({time.perf_counter() - t:.2f} s on the CPU)")

        # 5. the CLI against the socket
        cli = []
        for qtext in queries[3:5]:
            want = hits_of(d.client.search(qtext))
            proc = subprocess.run(
                [sys.executable, "-m", "yams_tpu_torch.cli", "--storage", str(data_dir),
                 "--json", "search", qtext], capture_output=True, text=True, timeout=300,
                cwd=pathlib.Path(__file__).resolve().parent)
            check(proc.returncode == 0, f"the CLI searched through the daemon ({proc.stderr[-500:]})")
            got = [types.SimpleNamespace(doc_id=h["document_id"], score=h["score"],
                                         kg_score=h["kg_score"]) for h in json.loads(proc.stdout)]
            check([(r.doc_id, r.score) for r in got] == [(r.doc_id, r.score) for r in want],
                  f"the CLI printed the daemon's hits for {qtext!r}")
            cli.append(len(got))
        out["cli_hits"] = cli
        log(f"[phase10] CLI --json search through the socket == the daemon's hits ({cli})")

        # 6. restart, then restart as int8
        docs_before = d.client.status()["documents"]
        before = [hits_of(d.client.search(qtext)) for qtext in queries]
        d.stop()
        t = time.perf_counter()
        d = ThreadDaemon(cfg, dev)
        out["restart_s"] = time.perf_counter() - t
        check(d.client.status()["documents"] == docs_before,
              f"the document counts survive the restart ({docs_before})")
        after = [hits_of(d.client.search(qtext)) for qtext in queries]
        out["restart"] = results_agree("restarted daemon", after, before)
        check(out["restart"]["equal"] == len(queries), "64 searches equal across the restart")
        d.stop()
        cfg8 = load_config(data_dir=data_dir)
        cfg8.vector.dtype = "int8"
        d = ThreadDaemon(cfg8, dev)
        vstats = d.client.call("stats", detailed=True)["vector_index"]
        check(vstats["device_dtype"] == "int8" and d.app.search_engine.vector_index.device_dtype == "int8",
              f"the int8 restart serves the int8 tier ({vstats})")
        got8 = [hits_of(d.client.search(qtext)) for qtext in queries]
        overlap = float(np.mean([len({r.doc_id for r in a[:10]} & {r.doc_id for r in b[:10]})
                                 / max(len(b[:10]), 1) for a, b in zip(got8, before)]))
        check(overlap >= 0.85, f"int8 top-10 overlap against bf16 {overlap:.4f} >= 0.85")
        d.stop()
        out["int8_overlap"] = overlap
        log(f"[phase10] restart in {out['restart_s']:.2f} s: documents {docs_before}, 64 "
            f"searches equal {out['restart']}; int8 restart: {vstats['device_dtype']}, top-10 "
            f"overlap with bf16 {overlap:.4f}")
        d = None
        if keep is not None:
            keep.update(tmp=tmp, data_dir=data_dir, queries=queries)
        return out
    finally:
        if d is not None and d.thread.is_alive():
            try:
                d.stop()
            except Exception:       # noqa: BLE001  (the phase already failed)
                pass
        if "tmp" not in (keep or {}):
            tmp.cleanup()


# -- phase 11 -----------------------------------------------------------------
def top2_margin(vectors: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Each row's gap between its best and second-best centroid score (f64)."""
    s = vectors.astype(np.float64) @ centroids.astype(np.float64).T
    top2 = np.sort(s, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assignments_agree(what: str, got: np.ndarray, want: np.ndarray,
                      vectors: np.ndarray, centroids: np.ndarray,
                      least: float = 0.99) -> dict:
    """Two k-means builds of the same rows: at least `least` of the live rows
    (want >= 0) get the same cluster; every row that differs is named with
    its top-2 margin against `centroids`."""
    live = want >= 0
    check(np.array_equal(got < 0, ~live), f"{what}: the same rows are invalid")
    differ = np.nonzero(got != want)[0]
    frac = 1.0 - len(differ) / max(int(live.sum()), 1)
    margins = top2_margin(vectors[differ], centroids) if len(differ) else np.zeros(0)
    if len(differ):
        named = [(int(r), round(float(mg), 7)) for r, mg in zip(differ[:32], margins[:32])]
        log(f"[assignments] {what}: {len(differ)} rows differ (row, top-2 margin; first "
            f"32): {named}")
    check(frac >= least, f"{what}: {frac:.5f} of the rows agree (>= {least})")
    return {"agree": frac, "differ": int(len(differ)),
            "max_margin": float(margins.max()) if len(differ) else 0.0,
            "median_margin": float(np.median(margins)) if len(differ) else 0.0}


def hits_outside(results, masks, slot_by_doc) -> list:
    """(query, rank, doc) of every hit whose slot its query's routed mask
    leaves out."""
    return [(q, j, r.doc_id) for q, (res, mask) in enumerate(zip(results, masks))
            for j, r in enumerate(res) if mask[slot_by_doc[r.doc_id]] <= 0]


def route_masks(eng, queries) -> list:
    """The engine's own routed slot mask of each query, from the query
    vectors search_batch computes (sketch @ projection, L2-normalized)."""
    sketches, proj = eng.provider.query_device_inputs(queries)
    v = np.asarray(sketches)[:len(queries)].astype(np.float32) @ proj.float().cpu().numpy()
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return [eng._routed_slot_mask(qv, eng.num_slots_padded, query=q)
            for qv, q in zip(v, queries)]


def promotes_as_configured(calib: dict, max_mpt: float, promoted: bool) -> bool:
    """Auto-promotion acts as the config says: it promotes exactly when the
    route-risk certificate is available and its misses per thousand clear
    the gate."""
    want = bool(calib["available"]) and calib["misses_per_thousand"] <= max_mpt
    return promoted == want


def top10_overlap(got, want) -> float:
    return float(np.mean([len({r.doc_id for r in a[:10]} & {r.doc_id for r in b[:10]})
                          / max(len(b[:10]), 1) for a, b in zip(got, want)]))


def phase11_builds(dev, eng, cpu, n_sub: int = 16_384, louvain_rows: int = 32_768) -> dict:
    """(a) The three builds on phase 3's card engine through
    rebuild_topology (k-means last, so the engine keeps it), their stage
    times, kmeans_step's device time against its bound, two card k-means
    builds bit-identical, the card build against the CPU twin's, and the
    connected labels of a 16,384-row subset against the CPU's. Louvain's
    host passes take ~23 s at 140,000 rows on the card's host, so it
    builds the index's first `louvain_rows` rows (the same build
    rebuild_topology runs, on a TopologyEngine of its own)."""
    from yams_tpu_torch.index import topology as topo

    vi = eng.vector_index
    n_live = vi.active_rows
    K = topo.auto_k(n_live)
    out: dict = {"rows": n_live, "capacity": vi.capacity, "dim": vi.dim, "auto_k": K,
                 "louvain_rows": louvain_rows, "builds": {}}
    for name in ("connected", "louvain", "kmeans"):
        t = time.perf_counter()
        if name == "louvain":
            built = topo.TopologyEngine(
                representatives=eng.config.topology_representatives, device=dev)
            built.build(vi._vecs[:louvain_rows], vi._valid[:louvain_rows],
                        epoch=eng._stats["searches"], engine="louvain")
        else:
            eng.rebuild_topology(engine=None if name == "kmeans" else name)
            built = eng.topology
        wall = time.perf_counter() - t
        a = built.artifacts
        b = {"s": wall, **built.last_timings, "clusters": len(a.centroids),
             "max_size": int(a.cluster_sizes.max()),
             "persistence": float(a.centroid_persistence)}
        out["builds"][name] = b
        rows = f"the first {louvain_rows} rows" if name == "louvain" else f"{n_live} rows"
        log(f"[phase11] {name} build over {rows}: {wall:.2f} s, stages "
            f"{json.dumps({k: round(v, 3) for k, v in built.last_timings.items()})}, "
            f"{b['clusters']} clusters (largest {b['max_size']} rows)")
    arts = eng.topology.artifacts
    check(len(arts.centroids) == K, f"k-means built auto_k({n_live}) = {K} clusters")
    v = torch.from_numpy(vi._vecs).to(dev)
    m = torch.from_numpy(vi._valid).to(dev)
    cen = torch.from_numpy(arts.centroids).to(dev)
    N, D = v.shape
    step_ms = cuda_ms(lambda: topo.kmeans_step(v, m, cen), 10)
    out["kmeans_step"] = {"ms": step_ms, "N": N, "D": D, "K": K, "live": n_live,
                          **kmeans_bound(n_live, N, D, K)}
    del v, m, cen
    log(f"[phase11] kmeans_step ({N} x {D} rows given, {n_live} live, K {K}): "
        f"{step_ms:.4f} ms against a bound of {out['kmeans_step']['bound_ms']:.4f} ms "
        f"({out['kmeans_step']['bound_by']})")

    epoch = arts.epoch
    t = time.perf_counter()
    one = topo.TopologyEngine(device=dev).build(vi._vecs, vi._valid, epoch=epoch)
    two = topo.TopologyEngine(device=dev).build(vi._vecs, vi._valid, epoch=epoch)
    check(np.array_equal(one.assignments, two.assignments)
          and np.array_equal(one.centroids.view(np.uint32), two.centroids.view(np.uint32))
          and np.array_equal(one.assignments, arts.assignments),
          "two card k-means builds of the same vectors are bit-identical")
    log(f"[phase11] two card k-means builds bit-identical ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    twin = topo.TopologyEngine(device="cpu").build(vi._vecs, vi._valid, epoch=epoch)
    out["cpu_kmeans_s"] = time.perf_counter() - t
    out["kmeans_vs_cpu"] = assignments_agree(
        "card k-means against the CPU twin", arts.assignments, twin.assignments,
        vi._vecs, twin.centroids)
    log(f"[phase11] card k-means against the CPU twin's build ({out['cpu_kmeans_s']:.2f} s "
        f"on the CPU): {json.dumps(out['kmeans_vs_cpu'])}")
    # how the gate's agreement grows with the Lloyd steps: after one step
    # (recorded, not gated) against the eight of the build above
    one = topo.TopologyEngine(iters=1, device=dev).build(vi._vecs, vi._valid, epoch=epoch)
    twin = topo.TopologyEngine(iters=1, device="cpu").build(vi._vecs, vi._valid, epoch=epoch)
    out["kmeans_vs_cpu_1step"] = assignments_agree(
        "card k-means after 1 Lloyd step against the CPU twin's (recorded)",
        one.assignments, twin.assignments, vi._vecs, twin.centroids, least=0.0)
    log(f"[phase11] after 1 Lloyd step, card against the CPU twin: "
        f"{json.dumps(out['kmeans_vs_cpu_1step'])}")

    sub = np.ascontiguousarray(vi._vecs[:n_sub])
    sub_valid = np.ascontiguousarray(vi._valid[:n_sub])
    card_labels = topo.connected_labels(
        torch.from_numpy(sub).to(dev), torch.from_numpy(sub_valid).to(dev), 0.25,
        knn=8, block_rows=256).cpu().numpy()
    t = time.perf_counter()
    cpu_labels = topo.connected_labels(torch.from_numpy(sub), torch.from_numpy(sub_valid),
                                       0.25, knn=8, block_rows=256).numpy()
    out["connected_subset"] = {"rows": n_sub, "cpu_s": time.perf_counter() - t,
                               "components": int(len(np.unique(card_labels)))}
    check(np.array_equal(card_labels, cpu_labels),
          f"connected labels of {n_sub} rows: card == CPU "
          f"({int((card_labels != cpu_labels).sum())} differ)")
    log(f"[phase11] connected labels of the first {n_sub} rows: card == CPU "
        f"({out['connected_subset']['components']} components)")
    out["self_join"] = phase11_self_join(dev, vi)
    return out


def once_ms(fn):
    """(fn(), its device milliseconds by CUDA events) of one call, no
    warm-up: for work too long to repeat whose path has already run."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end)


def kmeans_bound(n_live: int, N: int, D: int, K: int) -> dict:
    """kmeans_step's bound: the live rows' f32 vectors and the (N,) mask read
    once, the centroids read and written (a dead row's vector need not be
    read), against the bf16 product of the live rows with the centroids."""
    return bound(n_live * D * 4 + N * 4 + 2 * K * D * 4, 2 * n_live * K * D, PEAK_BF16)


def self_join_bound(n_live: int, D: int, k: int, block: int) -> dict:
    """The kNN self-join's bound: the live rows' f32 vectors read once and
    (n_live, k) f32 scores and 4-byte ids written, against the bf16 product
    of the live rows with the live rows padded to a block."""
    return bound(n_live * D * 4 + n_live * k * 8,
                 2.0 * n_live * (n_live + (-n_live) % block) * D, PEAK_BF16)


def propagate_bound(n_live: int, knn: int, rounds: int = 24) -> dict:
    """Label propagation's bound, bytes: each round reads a live row's knn
    neighbor ids, gathers their knn labels, scatters knn labels back, and
    reads and writes its own label to halve the path, in 4-byte ids and
    labels (the least width that holds a row id); the min operations are
    no bound beside them."""
    return bound(rounds * n_live * (3 * knn + 2) * 4, rounds * n_live * (2 * knn + 2),
                 PEAK_INT)


def phase11_self_join(dev, vi, knn: int = 8, block: int = 256, n_cmp: int = 40_000) -> dict:
    """The connected build's kNN self-join on phase 3's index: its device
    time in the query slices the build takes (_KNN_QUERIES) and label
    propagation's on its graph, against their bounds; then, on the first
    `n_cmp` live rows, the sliced join (the last slice shorter) against one
    slice of them all: values within 1e-5, a differing id only at a
    near-tie within 1e-5, equal labels. One slice of all 140,000 rows gave
    bit-equal lists but took 21.7 s on an H100 (PERF.md §6), too long to
    repeat in every run."""
    from yams_tpu_torch.index import topology as topo

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, (-len(x)) % block))

    v = padded(torch.from_numpy(vi._vecs).to(dev))
    m = padded(torch.from_numpy(vi._valid).to(dev))
    n_live = int(vi._valid.sum())
    (vals, nbrs), join_ms = once_ms(lambda: topo.knn_live(v, m, knn, block))
    graph = topo.knn_edges(vals, nbrs, m, 0.25)
    prop_ms = cuda_ms(lambda: topo.propagate_labels(graph), 5)
    rows = torch.nonzero(m > 0).flatten()[:n_cmp]
    n = len(rows)
    vs, ms = padded(v.index_select(0, rows)), padded(m.index_select(0, rows))
    del v, m, vals, nbrs, graph
    (vals, nbrs), sliced_ms = once_ms(lambda: topo.knn_live(vs, ms, knn, block))
    (vals1, nbrs1), one_ms = once_ms(lambda: topo.knn_live(vs, ms, knn, block, query_rows=n))
    err, differ = fused_agree(f"self-join of {n} rows in slices of {topo._KNN_QUERIES} "
                              "against one slice", vals, nbrs, vals1, nbrs1, tol=1e-5, tie=1e-5)
    same = torch.equal(topo.propagate_labels(topo.knn_edges(vals, nbrs, ms, 0.25)),
                       topo.propagate_labels(topo.knn_edges(vals1, nbrs1, ms, 0.25)))
    check(same, f"connected labels of {n} rows: the sliced self-join's == one slice's")
    out = {"rows": n_live, "knn": knn, "slices": -(-n_live // topo._KNN_QUERIES),
           "join": {"ms": join_ms, **self_join_bound(n_live, vi.dim, knn, block)},
           "propagate": {"ms": prop_ms, **propagate_bound(n_live, knn)},
           "one_slice": {"rows": n, "slices": -(-n // topo._KNN_QUERIES), "sliced_ms": sliced_ms,
                         "one_ms": one_ms, "max_err": err, "ids_differ": differ}}
    del vs, ms, vals, nbrs, vals1, nbrs1
    torch.cuda.empty_cache()
    log(f"[phase11] self-join of {n_live} live rows, k {knn}, {out['slices']} slices: "
        f"{join_ms:.1f} ms against {out['join']['bound_ms']:.3f} ms "
        f"({out['join']['bound_by']}); propagate_labels {prop_ms:.3f} ms against "
        f"{out['propagate']['bound_ms']:.4f} ms ({out['propagate']['bound_by']}); the first "
        f"{n} rows in {out['one_slice']['slices']} slices ({sliced_ms:.1f} ms) against one "
        f"({one_ms:.1f} ms): max error {err:.3g}, {differ} ids differ, labels equal")
    return out


def phase11_full_width(dev, N: int = 1 << 20, D: int = 768) -> dict:
    """(b) TopologyEngine(device=cuda).build on phase 4's clustered
    generator at 1,048,576 x 768 (K 300)."""
    from yams_tpu_torch.index import topology as topo

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    E = clustered_corpus(dev, gen, N, D)
    host = E.float().cpu().numpy()
    del E
    valid = np.ones(len(host), np.float32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    eng = topo.TopologyEngine(device=dev)
    t = time.perf_counter()
    arts = eng.build(host, valid)
    build_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) - base
    K = topo.auto_k(len(host))
    check(len(arts.centroids) == K and (arts.assignments >= 0).all()
          and np.isfinite(arts.centroids).all(),
          f"the full-width build gives {K} finite centroids and assigns every row")
    v = torch.from_numpy(host).to(dev)
    m = torch.from_numpy(valid).to(dev)
    cen = torch.from_numpy(arts.centroids).to(dev)
    N, D = v.shape
    step_ms = cuda_ms(lambda: topo.kmeans_step(v, m, cen), 5)
    out = {"N": N, "D": D, "K": K, "build_s": build_s, "stages": eng.last_timings,
           "peak_gb": peak / 1e9,
           "kmeans_step": {"ms": step_ms, "N": N, "D": D, "K": K, "live": N,
                           **kmeans_bound(N, N, D, K)}}
    del v, m, cen, host
    torch.cuda.empty_cache()
    log(f"[phase11] full width {N} x {D}, K {K}: build {build_s:.2f} s (stages "
        f"{json.dumps({k: round(x, 3) for k, x in eng.last_timings.items()})}), peak "
        f"{out['peak_gb']:.2f} GB above the start; kmeans_step {step_ms:.4f} ms against a "
        f"bound of {out['kmeans_step']['bound_ms']:.4f} ms ({out['kmeans_step']['bound_by']})")
    return out


def phase11_policies(dev, eng, cpu, queries) -> dict:
    """(c) search_batch under the four policies on the k-means topology:
    steady ms at B 64 and 8, the route's host ms, shadow == off, narrow hits
    within their routes, the gather tier at B 8 only, card == CPU (the CPU
    twin gets the card's topology through convert.load_topology), and the
    route-risk calibration and auto-promotion after the shadow traffic."""
    from yams_tpu_torch.convert import load_topology

    load_topology(cpu, eng)
    cfg, ccfg = eng.config, cpu.config
    saved = (cfg.topology_policy, cfg.topology_narrow_min_boundary_margin,
             cfg.topology_auto_promote)
    out: dict = {"policies": {}}
    results = {}
    try:
        for policy in ("off", "shadow", "narrow", "augment"):
            for c in (cfg, ccfg):
                c.topology_policy = policy
                # narrow commits its routes (no abstention) so the gather
                # tier and the within-route check see real narrowing
                c.topology_narrow_min_boundary_margin = 0.0 if policy == "narrow" else saved[1]
            _, steady64, res = timed_search(dev, eng, queries)
            tr64 = eng.last_trace
            _, steady8, res8 = timed_search(dev, eng, queries[:8])
            tr8 = eng.last_trace
            results[policy] = res
            row = {"steady64_ms": steady64 * 1e3, "steady8_ms": steady8 * 1e3,
                   "route64_ms": tr64["stages"].get("topology_route_ms"),
                   "route8_ms": tr8["stages"].get("topology_route_ms"),
                   "device64_ms": tr64["stages"]["device_ms"],
                   "gather_rows8": tr8.get("narrow_gather_rows"),
                   "gather_rows64": tr64.get("narrow_gather_rows")}
            row["card_vs_cpu16"] = results_agree(
                f"{policy}: card against the CPU twin, B 16",
                eng.search_batch(queries[:16]), cpu.search_batch(queries[:16]))
            if policy == "narrow":
                check(row["gather_rows8"] is not None and row["gather_rows64"] is None,
                      f"narrow: the gather tier runs at B 8 and not at B 64 ({row})")
                row["card_vs_cpu8"] = results_agree(
                    "narrow gather tier: card against the CPU twin, B 8",
                    eng.search_batch(queries[:8]), cpu.search_batch(queries[:8]))
                outside = hits_outside(res, route_masks(eng, queries), eng._slot_by_doc)
                outside += hits_outside(res8, route_masks(eng, queries[:8]), eng._slot_by_doc)
                check(not outside, f"every narrow hit lies in its query's routed slots "
                      f"({outside[:8]})")
                row["recall10_vs_off"] = top10_overlap(res, results["off"])
            out["policies"][policy] = row
            log(f"[phase11] {policy}: search_batch(64) steady {row['steady64_ms']:.2f} ms "
                f"(route {row['route64_ms']}), search_batch(8) {row['steady8_ms']:.2f} ms "
                f"(route {row['route8_ms']}, gather rows {row['gather_rows8']}); card == CPU "
                f"{row['card_vs_cpu16']}"
                + (f"; recall@10 against off {row['recall10_vs_off']:.4f}"
                   if policy == "narrow" else ""))
        same = [[(r.doc_id, r.score) for r in a] == [(r.doc_id, r.score) for r in b]
                for a, b in zip(results["shadow"], results["off"])]
        check(all(same), f"shadow's top-10 equals off's on all 64 ({sum(same)})")
        # calibration after the shadow traffic, then promotion as configured
        for c in (cfg, ccfg):
            c.topology_policy = "shadow"
            c.topology_narrow_min_boundary_margin = saved[1]
        eng.search_batch(queries)
        calib = eng.route_calibration()
        check(calib["available"], f"route calibration available after shadow traffic ({calib})")
        cfg.topology_auto_promote = True
        promotions = eng._stats["topology_promotions"]
        eng.search_batch(queries[:8])
        promoted = eng._stats["topology_promotions"] > promotions
        check(promoted == (cfg.topology_policy == "narrow")
              and promotes_as_configured(calib, cfg.topology_calibration_max_mpt, promoted),
              f"auto-promotion acts as configured (max_mpt "
              f"{cfg.topology_calibration_max_mpt}, {calib}, promoted {promoted})")
        out["calibration"] = {k: v.item() if isinstance(v, np.generic) else v
                              for k, v in calib.items()}
        out["promoted"] = promoted
        out["shadow_agree"] = eng._stats["topology_shadow_agree"]
        log(f"[phase11] after the shadow traffic: calibration {json.dumps(calib, default=float)}; "
            f"auto-promotion at max_mpt {cfg.topology_calibration_max_mpt}: {promoted}; "
            f"shadow agreement {out['shadow_agree']:.4f}")
        return out
    finally:
        for c in (cfg, ccfg):
            (c.topology_policy, c.topology_narrow_min_boundary_margin,
             c.topology_auto_promote) = saved


def phase11_narrow(dev, **shape) -> dict:
    """(d) The narrow mechanism at the reference script's shape
    (scripts/bench_narrow.py: 1,000,448 x 768, 4,096 clusters, sigma 0.35,
    top-4 routing, k 10, C 32)."""
    from yams_tpu_torch.scripts import bench_narrow

    rows = bench_narrow.run(batches=(1, 8, 32, 128), seed=SEED, device=dev, **shape,
                            log=lambda line: log(f"[phase11] bench_narrow {line}"))
    for r in rows:
        check(r["narrow_recall10"] >= 0.9,
              f"bench_narrow B {r['B']}: narrow recall@10 {r['narrow_recall10']:.4f} >= 0.9")
    torch.cuda.empty_cache()
    return {"rows": rows}


def phase11_service(dev, keep: dict) -> dict:
    """(e) Repair through a daemon on phase 10's data dir: `repair --ops
    topology`, the default shadow policy's answers unchanged and its
    counters moving, a full repair, a dry run, doctor, and the CLI through
    the socket against the daemon."""
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.index.topology import auto_k

    data_dir, queries = keep["data_dir"], keep["queries"]
    cfg = load_config(data_dir=data_dir)
    d = ThreadDaemon(cfg, dev)
    out: dict = {}
    try:
        eng = d.app.search_engine
        check(eng.config.topology_policy == "shadow", "the daemon's default policy is shadow")
        before = [hits_of(d.client.search(q)) for q in queries]
        routes0 = eng.stats()["topology_routes"]
        n = eng.vector_index.active_rows
        t = time.perf_counter()
        rep = d.client.repair(["topology"])
        out["repair_topology_s"] = time.perf_counter() - t
        want = f"{auto_k(n)} clusters over {n} rows"
        check(rep == {"topology": want}, f"repair --ops topology reports {want!r} ({rep})")
        after = [hits_of(d.client.search(q)) for q in queries]
        out["shadow_vs_before"] = results_agree("shadow after the repair against before",
                                                after, before)
        check(out["shadow_vs_before"]["equal"] == len(queries),
              "64 answers unchanged under shadow after the repair")
        st = eng.stats()
        check(st["topology_routes"] - routes0 >= len(queries)
              and eng.route_calibration()["queries"] > 0,
              f"the shadow counters moved ({st['topology_routes']}, {eng.route_calibration()})")
        out["shadow_routes"] = st["topology_routes"] - routes0
        out["shadow_agree"] = st["topology_shadow_agree"]
        t = time.perf_counter()
        full = d.client.repair()
        out["repair_all_s"] = time.perf_counter() - t
        failed = {op: r for op, r in full.items() if str(r).startswith("failed")}
        check(not failed and len(full) == 15, f"no repair op failed ({failed or full})")
        out["repair_all"] = full
        dry = d.client.call("repair", dry_run=True)
        check(dry["dry_run"] and set(dry["plan"].values()) == {"planned"},
              f"the dry run plans every op ({dry['plan']})")
        doc = d.client.doctor()
        name = torch.cuda.get_device_name(dev)
        check(all(ok for ok, _ in doc.values()) and name in doc["device"][1],
              f"doctor is green and names the card ({doc})")
        out["doctor"] = doc
        cli = {}
        for argv, answer in ((["repair", "--ops", "topology"], None), (["doctor"], doc)):
            if answer is None:
                answer = d.client.repair(["topology"])
            proc = subprocess.run(
                [sys.executable, "-m", "yams_tpu_torch.cli", "--storage", str(data_dir),
                 "--json", *argv], capture_output=True, text=True, timeout=300,
                cwd=pathlib.Path(__file__).resolve().parent)
            check(proc.returncode == 0 and json.loads(proc.stdout) == answer,
                  f"the CLI's {argv[0]} through the socket equals the daemon's "
                  f"({proc.returncode}, {proc.stdout[-300:]}, {proc.stderr[-300:]})")
            cli[argv[0]] = True
        out["cli"] = cli
        log(f"[phase11] daemon: repair --ops topology {rep['topology']!r} in "
            f"{out['repair_topology_s']:.2f} s; 64 shadow answers unchanged "
            f"{out['shadow_vs_before']}, {out['shadow_routes']} routes, agreement "
            f"{out['shadow_agree']:.4f}; full repair in {out['repair_all_s']:.2f} s "
            f"{json.dumps(full)}; dry run plans {len(dry['plan'])} ops; doctor green, "
            f"device {doc['device'][1]!r}; the CLI's repair and doctor == the daemon's")
        d.stop()
        d = None
        return out
    finally:
        if d is not None and d.thread.is_alive():
            try:
                d.stop()
            except Exception:       # noqa: BLE001  (the phase already failed)
                pass


def phase11_ops(topology: dict) -> list:
    """Phase 11's device operations (torch, no hand kernel yet), each with
    its time and bound: kmeans_step at phase 3's rows and at full width,
    the kNN self-join and label propagation (the connected build's, at the
    live rows), and routed_gather_topk at each bench_narrow B."""
    b = topology["builds"]
    rows = [{"op": "kmeans_step", "shape": f"{k['N']}x{k['D']} K {k['K']}", "live": k["live"],
             "ms": k["ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"]}
            for k in (b["kmeans_step"], topology["full_width"]["kmeans_step"])]
    j = b["self_join"]
    for op in ("join", "propagate"):
        rows.append({"op": "knn_self_join" if op == "join" else "propagate_labels",
                     "rows": j["rows"], "knn": j["knn"], **j[op]})
    rows += [{"op": "routed_gather_topk", "B": r["B"], "R": r["routed_rows"],
              "ms": r["narrow_dev_ms"], "bound_ms": r["narrow_bound_ms"], "bound_by": "bytes",
              "full_scan_ms": r["full_dev_ms"]} for r in topology["narrow"]["rows"]]
    return rows


def phase11_topology(dev, card: str, eng, cpu, queries, keep: dict) -> dict:
    """Topology routing and the repair service on the card: (a) the builds
    on phase 3's engine, (b) the full-width build, (c) search under the four
    policies, (d) the narrow mechanism, (e) repair and doctor through a
    daemon on phase 10's data dir."""
    out = {"card": card}
    try:
        for name, fn, args in (
                ("builds", phase11_builds, (dev, eng, cpu)),
                ("full_width", phase11_full_width, (dev,)),
                ("policies", phase11_policies, (dev, eng, cpu, queries)),
                ("narrow", phase11_narrow, (dev,)),
                ("service", phase11_service, (dev, keep))):
            t = time.perf_counter()
            out[name] = fn(*args)
            out[name + "_s"] = time.perf_counter() - t
            log(f"[phase11 {name}] {out[name + '_s']:.2f} s")
        return out
    finally:
        if "tmp" in keep:
            keep.pop("tmp").cleanup()


# -- phase 12 -----------------------------------------------------------------
HF_SHAPE = {"layers": 3, "dim": 192, "heads": 6, "intermediate": 768}


class CallCounts:
    """Calls of phase 12's device operations on the card while installed:
    each target (module or class, attribute) is wrapped to count the calls
    that get a CUDA tensor, except while `paused` (timing repetitions and
    yardsticks are not the path)."""

    def __init__(self, targets: dict):
        self.targets, self.counts, self.paused, self._orig = targets, {}, False, {}

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = self._orig[name] = getattr(owner, attr)
            self.counts[name] = 0

            def wrapped(*a, _fn=fn, _name=name, **kw):
                if not self.paused and any(isinstance(x, torch.Tensor) and x.is_cuda
                                           for x in (*a, *kw.values())):
                    self.counts[_name] += 1
                return _fn(*a, **kw)
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._orig[name])

    def timed(self, fn, reps: int) -> float:
        """cuda_ms(fn, reps) with the counts paused."""
        self.paused = True
        try:
            return cuda_ms(fn, reps)
        finally:
            self.paused = False


def bert_flops(tokens: int, T: int, layers: int = 3, D: int = 192, inter: int = 768) -> float:
    """Multiply-adds x 2 of the BERT layers: q, k, v, o (4 D^2), the MLP
    (2 D I) and the attention's two products (2 T D), a token a layer."""
    return 2.0 * tokens * layers * (4 * D * D + 2 * D * inter + 2 * T * D)


def bert_weight_bytes(layers: int = 3, D: int = 192, inter: int = 768) -> float:
    return 4.0 * layers * (4 * D * D + 2 * D * inter + 10 * D + inter)


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)


def phase12_encoder(dev, docs, counts: CallCounts) -> dict:
    """(a) HFBertEncoder.encode on 4,096 of phase 3's texts; each bucket's
    forward; a layer, its attention against SDPA; card against the CPU."""
    from yams_tpu_torch.embed import hf_encoder
    from yams_tpu_torch.embed.encoder import NeuralEncoder
    from yams_tpu_torch.embed.provider import DEFAULT_HF_CHECKPOINT

    ck = str(DEFAULT_HF_CHECKPOINT)
    out: dict = {}
    enc = hf_encoder.HFBertEncoder(ck, "bfloat16", device=dev)
    texts = [body for _, body, _ in docs[:4096]]
    enc.encode(texts[:64])                           # first launches, cuBLAS handles
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids = [enc.tokenizer.encode(x, enc.max_len) for x in texts]
    tok_s = time.perf_counter() - t
    t = time.perf_counter()
    vecs = enc.encode_ids(ids)                        # a host array: synchronized
    fwd_s = time.perf_counter() - t
    n_tok = sum(len(r) for r in ids)
    T = enc._bucket(max(len(r) for r in ids))
    check(vecs.shape == (len(texts), 192) and bool(np.isfinite(vecs).all()),
          f"{len(texts)} finite vectors")
    check(np.abs(np.linalg.norm(vecs, axis=1) - 1).max() < 1e-2, "unit vectors")
    out["encode"] = {"texts": len(texts), "tokens": n_tok, "bucket": T, "tokenize_s": tok_s,
                     "forward_s": fwd_s, "texts_per_s": len(texts) / (tok_s + fwd_s),
                     "tokens_per_s": n_tok / (tok_s + fwd_s)}
    log(f"[phase12 encoder] encode 4,096 texts ({n_tok} tokens, bucket T {T}): tokenizer "
        f"{tok_s:.3f} s, forward {fwd_s:.3f} s; {out['encode']['texts_per_s']:.1f} texts/s, "
        f"{out['encode']['tokens_per_s']:.1f} tokens/s")

    # each bucket's forward on the card, the 4,096 texts padded to T (cut at T)
    P = dict(enc.model.named_parameters())
    buckets = {}
    with torch.inference_mode():
        for Tb in (16, 32, 64, 128):
            ii, aa = hf_encoder.pad_batch([r[:Tb] for r in ids], Tb, enc.tokenizer.pad_id)
            i_t, a_t = torch.from_numpy(ii).to(dev), torch.from_numpy(aa).to(dev)
            ms = counts.timed(lambda: enc.model(i_t, a_t), 3)
            live = int(aa.sum())
            b = bound(ii.nbytes + aa.nbytes + bert_weight_bytes() + live * 192 * 4
                      + len(ids) * 192 * 4, bert_flops(len(ids) * Tb, Tb), PEAK_BF16)
            buckets[Tb] = {"ms": ms, **b}
        out["buckets"] = buckets
        log("[phase12 encoder] forward of the 4,096-text batch a bucket (bf16, device ms, "
            "bound): " + ", ".join(f"T {t_}: {v['ms']:.3f} / {v['bound_ms']:.4f}"
                                    for t_, v in buckets.items()))

        # one layer at full width: a 131,072-token slice (1,024 rows at T 128)
        ii, aa = hf_encoder.pad_batch([r[:128] for r in ids[:1024]], 128, enc.tokenizer.pad_id)
        i_t, a_t = torch.from_numpy(ii).to(dev), torch.from_numpy(aa).to(dev)
        x = hf_encoder.bert_embed(P, i_t)
        neg = (1.0 - a_t)[:, None, None, :] * -1e9
        layer_ms = counts.timed(lambda: hf_encoder.bert_layer(
            P, "layer0", x, neg, num_heads=6, compute_dtype="bfloat16"), 5)
        layer_b = bound(2 * x.numel() * 4 + a_t.numel() * 4 + bert_weight_bytes(1),
                        bert_flops(1024 * 128, 128, layers=1), PEAK_BF16)
        q, k, v = (torch.randn(1024, 128, 6, 32, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        attn_ms = counts.timed(lambda: hf_encoder.attention(q, k, v, neg), 5)
        keep = (a_t > 0)[:, None, None, :]
        sdpa_ms = counts.timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep), 5)
        attn_b = bound(4 * q.numel() * 2 + a_t.numel() * 4, 4.0 * 1024 * 128 * 128 * 192,
                       PEAK_BF16)
        out["layer"] = {"shape": [1024, 128, 192], "ms": layer_ms, **layer_b,
                        "attention_ms": attn_ms, "attention_bound_ms": attn_b["bound_ms"],
                        "sdpa_ms": sdpa_ms}
        log(f"[phase12 encoder] one layer (1,024 x 128 x 192, bf16): {layer_ms:.3f} ms against "
            f"{layer_b['bound_ms']:.4f} ({layer_b['bound_by']}); its attention {attn_ms:.3f} ms "
            f"against {attn_b['bound_ms']:.4f}, F.scaled_dot_product_attention on the same "
            f"q, k, v {sdpa_ms:.3f} ms")

    # the card against the port's CPU forward on 64 texts
    sample = texts[:48] + [t_ + " " + b_ for _, b_, t_ in docs[4096:4112]]
    cpu32 = hf_encoder.HFBertEncoder(ck, "float32", device="cpu")
    cpu16 = hf_encoder.HFBertEncoder(ck, "bfloat16", device="cpu")
    card32 = hf_encoder.HFBertEncoder(ck, "float32", device=dev)
    want32, want16 = cpu32.encode(sample), cpu16.encode(sample)
    err32 = float(np.abs(card32.encode(sample) - want32).max())
    got16 = enc.encode(sample)
    cos16 = float(min(cosines(got16, want32).min(), cosines(got16, want16).min()))
    tok_err, tok_cos = 0.0, 1.0
    for text in sample[:16]:
        w32 = cpu32.encode_tokens(text)
        tok_err = max(tok_err, float(np.abs(card32.encode_tokens(text) - w32).max()))
        tok_cos = min(tok_cos, float(cosines(enc.encode_tokens(text), w32).min()))
    neural_card = NeuralEncoder(device=dev)
    neural_cpu = NeuralEncoder(device="cpu")
    ng, nw = neural_card.encode(sample), neural_cpu.encode(sample)
    n_cos, n_err = float(cosines(ng, nw).min()), float(np.abs(ng - nw).max())
    out["card_vs_cpu"] = {"f32_max_abs": err32, "bf16_min_cos": cos16,
                          "tokens_f32_max_abs": tok_err, "tokens_bf16_min_cos": tok_cos,
                          "neural_bf16_min_cos": n_cos, "neural_max_abs": n_err}
    log(f"[phase12 encoder] card vs the port's CPU forward, 64 texts: f32 max abs {err32:.3g}, "
        f"bf16 min cosine {cos16:.6f}; encode_tokens (16 texts) f32 {tok_err:.3g}, bf16 "
        f"{tok_cos:.6f}; NeuralEncoder at its defaults (seeded weights, bf16) min cosine "
        f"{n_cos:.6f}, max abs {n_err:.3g}")
    check(err32 <= 1e-4 and tok_err <= 1e-4, "f32 card forward within 1e-4 of the CPU's")
    check(cos16 >= 0.99 and tok_cos >= 0.99 and n_cos >= 0.99, "bf16 cosines >= 0.99")
    return out


def timed_wraps(obj, names):
    """Wrap obj's methods to add their wall seconds into the returned dict."""
    spent = {n: 0.0 for n in names}
    for n in names:
        fn = getattr(obj, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spent[_n] += time.perf_counter() - t0
        setattr(obj, n, wrapped)
    return spent


def phase12_sub_engines(dev, docs, n: int = 2048):
    """Card and CPU engines over n documents, the hf provider at f32 compute
    on each, both tiers enabled (searched with or without them)."""
    from yams_tpu_torch.embed.provider import create_provider
    from yams_tpu_torch.search.engine import SearchEngine

    pair = []
    for device in (dev, torch.device("cpu")):
        eng = SearchEngine(provider=create_provider("hf", compute_dtype="float32",
                                                    device=device), device=device)
        eng.enable_late_interaction()
        eng.enable_fragment_geometry()
        t = time.perf_counter()
        eng.add_documents(docs[:n])
        log(f"[phase12] {n}-document sub-engine on {device} (hf at f32, both tiers) "
            f"built in {time.perf_counter() - t:.2f} s")
        pair.append(eng)
    return pair


def tiers(eng, on: bool):
    """Detach (or give back) an engine's ColBERT and fragment indexes."""
    if on:
        eng.token_index, eng.fragment_index = eng._tiers
    else:
        eng._tiers = (eng.token_index, eng.fragment_index)
        eng.token_index = eng.fragment_index = None


def phase12_engine(dev, docs, queries, subs, n_docs: int = 70_000) -> dict:
    """(b) an engine with create_provider("hf") over phase 3's documents."""
    from yams_tpu_torch.embed.chunker import chunk_document
    from yams_tpu_torch.embed.provider import create_provider
    from yams_tpu_torch.search.engine import SearchEngine

    out: dict = {}
    prov = create_provider("hf", device=dev)
    # the WordPiece tokenizer is host Python: time it on 1,024 documents first
    texts = [x for _, body, title in docs[:1024]
             for x in [title] + [c.text for c in chunk_document(body, "sentence")]]
    t = time.perf_counter()
    for x in texts:
        prov.encoder.tokenizer.encode(x, prov.encoder.max_len)
    per_doc = (time.perf_counter() - t) / 1024
    n = min(n_docs, int(60.0 / per_doc))      # keep the add's tokenizer under ~60 s
    out["tokenizer_per_doc_s"] = per_doc
    out["docs"] = n
    log(f"[phase12 engine] tokenizer {per_doc * 1e6:.1f} us a document on 1,024 documents "
        f"({len(texts)} texts): {n_docs} documents would take {per_doc * n_docs:.1f} s; "
        f"adding {n}")
    eng = SearchEngine(provider=prov, device=dev)
    spent = timed_wraps(prov.encoder, ["encode", "encode_ids"])
    t = time.perf_counter()
    eng.add_documents(docs[:n])
    add_s = time.perf_counter() - t
    out["add"] = {"s": add_s, "tokenize_s": spent["encode"] - spent["encode_ids"],
                  "forward_s": spent["encode_ids"], "index_s": add_s - spent["encode"],
                  "rows": eng.vector_index.active_rows}
    log(f"[phase12 engine] add_documents {n} documents in {add_s:.2f} s: tokenizer "
        f"{out['add']['tokenize_s']:.2f} s, forward {out['add']['forward_s']:.2f} s, index "
        f"{out['add']['index_s']:.2f} s; rows {out['add']['rows']}")
    first_s, steady_s, res = timed_search(dev, eng, queries)
    check(all(len(r) == 10 for r in res), "10 results per query")
    check(all(np.isfinite([x.score for r in res for x in r])), "finite scores")
    out["search"] = {"first_ms": first_s * 1e3, "steady_ms": steady_s * 1e3,
                     "stages": eng.last_trace["stages"]}
    log(f"[phase12 engine] search_batch(64): first {first_s * 1e3:.1f} ms, steady "
        f"{steady_s * 1e3:.1f} ms; stages {json.dumps(eng.last_trace['stages'])}")
    card, cpu = subs
    for e in (card, cpu):
        tiers(e, False)
    try:
        out["card_vs_cpu"] = results_agree("hf engine, 2,048 documents, card against CPU",
                                           card.search_batch(queries[:16]),
                                           cpu.search_batch(queries[:16]))
    finally:
        for e in (card, cpu):
            tiers(e, True)
    log(f"[phase12 engine] card == CPU on the 2,048-document sub-engines (f32), 16 queries: "
        f"{out['card_vs_cpu']}")
    return out


EXACT_DOC = (900_000, "gradient descent optimizer converges", "")


def phase12_tiers(dev, docs, queries, subs, counts: CallCounts, n_docs: int = 16_384) -> dict:
    """(c) the ColBERT tier and the fragment arm over 16,384 documents."""
    from yams_tpu_torch.embed.provider import create_provider
    from yams_tpu_torch.search.engine import SearchEngine

    out: dict = {}
    prov = create_provider("hf", device=dev)
    eng = SearchEngine(provider=prov, device=dev)
    eng.enable_late_interaction()
    eng.enable_fragment_geometry()
    spent = timed_wraps(prov, ["encode", "encode_tokens"])
    t = time.perf_counter()
    eng.add_documents(docs[:n_docs - 1] + [EXACT_DOC])
    add_s = time.perf_counter() - t
    out["add"] = {"s": add_s, "docs": n_docs, "encode_tokens_s": spent["encode_tokens"],
                  "encode_s": spent["encode"]}
    log(f"[phase12 tiers] add_documents {n_docs} documents with both tiers in {add_s:.2f} s "
        f"(encode_tokens, one forward a document: {spent['encode_tokens']:.2f} s; encode, "
        f"chunks and one forward a document's sentences: {spent['encode']:.2f} s)")
    frag = eng.fragment_index
    eng.fragment_index = None
    _, late_s, _ = timed_search(dev, eng, queries)
    late_stage = eng.last_trace["stages"]["late_interaction_ms"]
    eng.fragment_index = frag
    _, both_s, _ = timed_search(dev, eng, queries)
    stages = eng.last_trace["stages"]
    out["search"] = {"late_steady_ms": late_s * 1e3, "late_interaction_ms": late_stage,
                     "both_steady_ms": both_s * 1e3, "stages": stages}
    log(f"[phase12 tiers] search_batch(64) steady: ColBERT tier {late_s * 1e3:.1f} ms "
        f"(late_interaction_ms {late_stage:.1f}); with the fragment arm {both_s * 1e3:.1f} ms "
        f"(stages {json.dumps(stages)})")
    with_tiers = eng.search("gradient descent", k=10)
    tiers(eng, False)
    without = eng.search("gradient descent", k=10)
    tiers(eng, True)
    score = {r.doc_id: r.score for r in with_tiers}
    base = {r.doc_id: r.score for r in without}
    check(with_tiers[0].doc_id == EXACT_DOC[0], "the doc with the query's exact tokens on top")
    check(score[EXACT_DOC[0]] > base.get(EXACT_DOC[0], -1e30), "and its score rises")
    out["exact_doc"] = {"score_with": score[EXACT_DOC[0]],
                        "score_without": base.get(EXACT_DOC[0]),
                        "rank_without": [r.doc_id for r in without].index(EXACT_DOC[0])
                        if EXACT_DOC[0] in base else None}
    log(f"[phase12 tiers] 'gradient descent': the exact-token doc first, score "
        f"{out['exact_doc']['score_without']} -> {out['exact_doc']['score_with']}")
    card, cpu = subs
    out["card_vs_cpu"] = results_agree("hf engine with both tiers, card against CPU",
                                       card.search_batch(queries[:16]),
                                       cpu.search_batch(queries[:16]))
    log(f"[phase12 tiers] card == CPU with the tiers on (2,048 documents, f32, 16 queries): "
        f"{out['card_vs_cpu']}")
    out["ops"] = phase12_rerank_ops(dev, eng, queries, counts)
    return out


def phase12_rerank_ops(dev, eng, queries, counts: CallCounts) -> dict:
    """maxsim_scores and the token-index gather at search_batch(64)'s shape,
    each against its bound and its yardstick (timed, not on the path)."""
    from yams_tpu_torch.ops.maxsim import maxsim_scores

    cfg = eng.config
    B, Tq, D = len(queries), cfg.late_interaction_max_tokens, eng.provider.dim
    rrf_c = min(cfg.rrf_candidates, eng.num_slots_padded)
    C = min(max(2 * 10, cfg.rrf_candidates), 2 * rrf_c)      # search_batch's k_dev at k 10
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    slots = torch.randint(0, len(eng._doc_by_slot), (B, C), generator=gen, device=dev)
    qt = torch.randn(B, Tq, D, device=dev)
    qm = torch.ones(B, Tq, device=dev)
    ti = eng.token_index
    tok, mask = ti.device_arrays()
    gather_ms = counts.timed(lambda: ti.gather(slots), 10)
    counts.paused = True            # the operands of the timed operations
    ct, cm = ti.gather(slots)
    counts.paused = False
    gather_b = bound(2 * ct.numel() * 2 + 2 * cm.numel() * 4 + slots.numel() * 8, 0.0,
                     PEAK_CORE)
    select_ms = cuda_ms(lambda: tok.index_select(0, slots.reshape(-1)), 10)
    ms = cuda_ms(lambda: maxsim_scores(qt, qm, ct, cm), 10)
    ms_b = bound(ct.numel() * 2 + cm.numel() * 4 + qt.numel() * 4 + qm.numel() * 4 + B * C * 4,
                 2.0 * B * C * Tq * ct.shape[2] * D, PEAK_BF16)
    q16, c16 = qt.bfloat16(), ct.reshape(B, -1, D).bfloat16()
    mm_ms = cuda_ms(lambda: torch.matmul(q16, c16.transpose(1, 2)).reshape(
        B, Tq, C, -1).amax(-1), 10)
    out = {"shape": [B, C, Tq, int(ct.shape[2]), D],
           "maxsim": {"ms": ms, **ms_b, "matmul_max_ms": mm_ms},
           "gather": {"ms": gather_ms, **gather_b, "index_select_ms": select_ms}}
    log(f"[phase12 ops] maxsim_scores (B {B}, C {C}, Tq {Tq}, Td {ct.shape[2]}, D {D}): "
        f"{ms:.4f} ms against {ms_b['bound_ms']:.4f} ({ms_b['bound_by']}), one torch.matmul "
        f"+ max {mm_ms:.4f}; token-index gather {gather_ms:.4f} ms against "
        f"{gather_b['bound_ms']:.4f}, index_select {select_ms:.4f}")
    return out


def phase12_matryoshka(dev, counts: CallCounts, N: int = 1 << 20, D: int = 768,
                       B: int = 1024, k: int = 10, dups: int = 9) -> dict:
    """(d) matryoshka_topk on phase 4's corpus with phase 5's planted copies
    (on phase 4's rows alone a row's neighbours sit near cosine 0, so a
    prefix has nothing to find), recall@10 against the exact scan."""
    from yams_tpu_torch.ops import matryoshka
    from yams_tpu_torch.ops.scan import dot_f32
    from yams_tpu_torch.ops.select import top_k

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    E = clustered_corpus(dev, gen, N, D)
    perm = torch.randperm(N, generator=gen, device=dev)
    base, planted = perm[:B], perm[B:B * (dups + 1)]
    copies = E[base].float()[:, None, :] + (0.25 / np.sqrt(D)) * torch.randn(
        B, dups, D, generator=gen, device=dev)
    E[planted] = (copies / copies.norm(dim=2, keepdim=True)).reshape(-1, D).bfloat16()
    q = E[base].float()
    valid = torch.ones(N, device=dev)
    ei = top_k(dot_f32(q, E), k)[1].cpu().numpy()
    exact_ms = cuda_ms(lambda: top_k(dot_f32(q, E), k), 3)
    out = {"exact_ms": exact_ms, "queries": "phase 5's planted copies", "shape": [N, D, B]}
    for d0 in (192, 384):
        E0 = matryoshka.prefix_corpus(E, d0)
        _, mi = matryoshka.matryoshka_topk(q, E, E0, valid, k=k)
        rec = recall_at(mi.cpu().numpy(), ei)
        ms = counts.timed(lambda: matryoshka.matryoshka_topk(q, E, E0, valid, k=k), 5)
        C = k * 8
        b = bound(E0.numel() * 2 + valid.numel() * 4 + q.numel() * 4 + B * C * D * 2
                  + B * k * 8, 2.0 * B * N * d0 + 2.0 * B * C * D, PEAK_BF16)
        out[f"d0_{d0}"] = {"recall10": rec, "ms": ms, "qps": B / ms * 1e3, **b}
        check(rec >= 0.9, f"matryoshka recall@10 at d0 {d0} >= 0.9 ({rec:.4f})")
        del E0
    log(f"[phase12 matryoshka] {N} x {D}, B {B}, k {k}, rerank x8: " + "; ".join(
        f"d0 {d0}: recall@10 {out[f'd0_{d0}']['recall10']:.4f}, {out[f'd0_{d0}']['ms']:.3f} ms "
        f"({out[f'd0_{d0}']['qps']:.1f} QPS) against {out[f'd0_{d0}']['bound_ms']:.4f}"
        for d0 in (192, 384)) + f"; the exact scan (dot_f32 + top_k) {exact_ms:.3f} ms")
    return out


def phase12_service(dev, n_files: int = 256, blob_bytes: int = 48 << 20) -> dict:
    """(e) an AppContext with embedding.provider="hf" through the daemon."""
    import tempfile

    from yams_tpu_torch.core.config import load_config

    out: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="yhf")
    root = pathlib.Path(tmp.name)
    d = None
    try:
        vocab, texts, blob, _, _ = svc_tree(root / "tree", n_files, 16, blob_bytes, SEED + 20)
        cfg = load_config(data_dir=root / "data")
        cfg.embedding.provider = "hf"
        d = ThreadDaemon(cfg, dev)
        check(d.app.search_engine.provider.name == "hf", "the daemon serves the hf provider")
        t = time.perf_counter()
        rep = d.client.add_path(str((root / "tree").resolve()))
        out["add_s"] = time.perf_counter() - t
        check(rep["files_added"] == n_files + 2 and rep["files_failed"] == 0,
              f"the add took every file ({rep['files_added']}, {rep['errors'][:3]})")
        rng = np.random.default_rng(SEED + 21)
        queries = [" ".join(vocab[rng.zipf(1.3, size=int(rng.integers(1, 4))) % 512])
                   for _ in range(16)]
        before = [hits_of(d.client.search(qtext)) for qtext in queries]
        check(all(before), "every query found something")
        loaded = d.client.call("model_load", model="hf")
        status = d.client.call("model_status")
        engine_space = d.app.search_engine.provider.space_id
        check(loaded["space_id"] == engine_space and loaded["dim"] == 192,
              f"model_load hf gives the engine's space ({loaded})")
        check(status["default"]["space_id"] == engine_space
              and [m["name"] for m in status["loaded"]] == ["hf"], f"model_status ({status})")
        sample = list(texts.values())[:8]
        emb = d.client.call("embed_batch", texts=sample, model="hf")
        want = d.app.search_engine.provider.encode(sample)
        cos = float(cosines(np.asarray(emb["vectors"], np.float32), want).min())
        check(emb["dim"] == 192 and cos >= 0.99, f"embed_batch gives the model's vectors ({cos})")
        cli = {}
        for argv in (["search", queries[0]], ["search", queries[1]], ["model", "list"]):
            proc = subprocess.run(
                [sys.executable, "-m", "yams_tpu_torch.cli", "--storage", str(root / "data"),
                 "--json", *argv], capture_output=True, text=True, timeout=300,
                cwd=pathlib.Path(__file__).resolve().parent)
            check(proc.returncode == 0, f"the CLI ran {argv} ({proc.stderr[-500:]})")
            cli[" ".join(argv)] = json.loads(proc.stdout)
        for i in (0, 1):
            got = [(h["document_id"], h["score"]) for h in cli[f"search {queries[i]}"]]
            check(got == [(r.doc_id, r.score) for r in before[i]],
                  f"the CLI printed the daemon's hits for {queries[i]!r}")
        rows = cli["model list"]
        check([(r["model_id"], r["dim"], r["space_id"]) for r in rows]
              == [("hf", 192, engine_space)], f"the CLI's model list ({rows})")
        d.stop()
        d = ThreadDaemon(cfg, dev)
        after = [hits_of(d.client.search(qtext)) for qtext in queries]
        out["restart"] = results_agree("hf daemon restarted", after, before, atol=1e-5)
        check(out["restart"]["equal"] == len(queries), "16 searches equal across the restart")
        d.stop()
        d = None
        out.update(files=rep["files_added"], space_id=engine_space, embed_min_cos=cos)
        log(f"[phase12 service] hf AppContext through the daemon: {rep['files_added']} files "
            f"added in {out['add_s']:.2f} s; model_load / model_status / embed_batch (min "
            f"cosine {cos:.6f}); CLI search and model list == the daemon's; 16 searches equal "
            f"across a restart")
        return out
    finally:
        if d is not None and d.thread.is_alive():
            try:
                d.stop()
            except Exception:       # noqa: BLE001  (the phase already failed)
                pass
        tmp.cleanup()


def phase12_neural(dev, card: str, docs, queries) -> dict:
    """The neural embedding path and the late-interaction tier on the card:
    (a) the encoders, (b) the engine with the hf provider, (c) the ColBERT
    tier and the fragment arm, (d) matryoshka top-k, (e) the daemon."""
    from yams_tpu_torch.embed import encoder, hf_encoder
    from yams_tpu_torch.index.token_index import TokenIndex
    from yams_tpu_torch.ops import matryoshka
    from yams_tpu_torch.search import engine as engine_module

    out = {"card": card}
    counts = CallCounts({
        "bert_forward": (hf_encoder, "bert_forward"), "bert_layer": (hf_encoder, "bert_layer"),
        "neural_forward": (encoder, "neural_forward"),
        "maxsim_scores": (engine_module, "maxsim_scores"),
        "token_index_gather": (TokenIndex, "gather"),
        "matryoshka_topk": (matryoshka, "matryoshka_topk")})
    with counts:
        t = time.perf_counter()
        subs = phase12_sub_engines(dev, docs)
        out["sub_engines_s"] = time.perf_counter() - t
        for name, fn, args in (
                ("encoder", phase12_encoder, (dev, docs, counts)),
                ("engine", phase12_engine, (dev, docs, queries, subs)),
                ("tiers", phase12_tiers, (dev, docs, queries, subs, counts)),
                ("matryoshka", phase12_matryoshka, (dev, counts)),
                ("service", phase12_service, (dev,))):
            t = time.perf_counter()
            out[name] = fn(*args)
            out[name + "_s"] = time.perf_counter() - t
            log(f"[phase12 {name}] {out[name + '_s']:.2f} s")
            torch.cuda.empty_cache()
    out["op_calls"] = dict(counts.counts)
    return out


def phase12_ops(neural: dict) -> list:
    """Phase 12's device operations: calls on the path, card time, bound and
    yardstick."""
    c, enc, ti = neural["op_calls"], neural["encoder"], neural["tiers"]["ops"]
    batch = enc["buckets"][enc["encode"]["bucket"]]
    mat = neural["matryoshka"]
    rows = [
        {"op": "bert_layer", "calls": c["bert_layer"], "shape": enc["layer"]["shape"],
         "ms": enc["layer"]["ms"], "bound_ms": enc["layer"]["bound_ms"],
         "bound_by": enc["layer"]["bound_by"], "attention_ms": enc["layer"]["attention_ms"],
         "sdpa_ms": enc["layer"]["sdpa_ms"]},
        {"op": "bert_forward", "calls": c["bert_forward"], "shape": [4096, enc["encode"]["bucket"]],
         "ms": batch["ms"], "bound_ms": batch["bound_ms"], "bound_by": batch["bound_by"]},
        {"op": "maxsim_scores", "calls": c["maxsim_scores"], "shape": ti["shape"],
         "ms": ti["maxsim"]["ms"], "bound_ms": ti["maxsim"]["bound_ms"],
         "bound_by": ti["maxsim"]["bound_by"], "matmul_max_ms": ti["maxsim"]["matmul_max_ms"]},
        {"op": "token_index_gather", "calls": c["token_index_gather"], "shape": ti["shape"][:4],
         "ms": ti["gather"]["ms"], "bound_ms": ti["gather"]["bound_ms"],
         "bound_by": ti["gather"]["bound_by"], "index_select_ms": ti["gather"]["index_select_ms"]}]
    for d0 in (192, 384):
        m = mat[f"d0_{d0}"]
        rows.append({"op": f"matryoshka_topk d0 {d0}", "calls": c["matryoshka_topk"],
                     "shape": mat["shape"], "ms": m["ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "exact_scan_ms": mat["exact_ms"],
                     "recall10": m["recall10"]})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; nothing was run", file=sys.stderr)
        return 2
    import yams_tpu_torch  # noqa: F401  (fails fast outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds: dict[str, float] = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"[{name}] {seconds[name]:.2f} s")
        return r

    card = phase("phase0", phase0_identity)
    from yams_tpu_torch.ops import cdc, flash_topk, pq_pallas, scan, sha256

    counters = {"gear_hash_cuda": cdc.gear_hash_cuda, "sha256_cuda": sha256.sha256_cuda,
                "exact_topk_cuda": scan.exact_topk_cuda, "pq4_adc_cuda": pq_pallas.pq4_adc_cuda,
                "grouped_max_cuda": scan.grouped_max_cuda,
                "windowed_scan_cuda": flash_topk.windowed_scan_cuda}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    kernels = phase("phase1", phase1_kernels, dev)
    kernels.update(phase("phase1 K3", phase1_k3, dev))
    kernels.update(phase("phase1 K4", phase1_k4, dev))
    kernels.update(phase("phase1 fused scan kernels", phase1_fused_scan_kernels, dev))
    torch.cuda.empty_cache()   # phase 1's large blocks must not crowd the paths' allocations
    data = zipf_text(128 << 20, SEED)
    log(f"[phase2] payload {len(data)} bytes of zipf-word text")

    # each path runs with the counters zeroed just before it and read just after
    zero()
    add = phase("phase2", phase2_add, dev, data)
    search, eng, cpu, docs, queries = phase("phase3", phase3_search, dev)
    add_launches = read()
    log(f"[add path] kernel launches {add_launches}")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(add_launches[name] >= 1, f"{name} launched on the add path")

    breakdown = phase("phase2 breakdown", phase2_breakdown, dev, data)
    bench = phase("phase4", phase4_bench, dev)

    zero()
    store = phase("phase5", phase5_vector_store, dev)
    store_launches = read()
    log(f"[vector store path] kernel launches {store_launches}")
    for name in ("exact_topk_cuda", "pq4_adc_cuda"):
        check(store_launches[name] >= 1, f"{name} launched on the vector store's path")

    zero()
    engine_pq, pq_index = phase("phase6", phase6_engine_pq, dev, eng, queries)
    engine_launches = read()
    log(f"[engine PQ path] kernel launches {engine_launches}")
    check(engine_launches["pq4_adc_cuda"] == 0,
          "the engine's PQ tier never reaches K4 (its doc mask keeps the plain route)")

    zero()
    experiments = phase("phase7", phase7_experiments, dev)
    exp_launches = read()
    log(f"[experiments path] kernel launches {exp_launches}")
    for name in ("grouped_max_cuda", "windowed_scan_cuda"):
        check(exp_launches[name] >= 1, f"{name} launched on the experiments' path")

    zero()
    streaming = phase("phase8", phase8_streaming, dev)
    torch.cuda.empty_cache()
    engine8 = phase("phase8 engine", phase8_engine, dev)
    stream_launches = read()
    log(f"[streaming and int8 path] kernel launches {stream_launches} (its products, "
        "top-C and aggregations are torch operations: no hand kernel yet)")

    zero()
    kg = phase("phase9", phase9_kg, dev, card, eng, cpu, docs, queries,
               search["steady_search_ms"], pq_index)
    kg_launches = read()
    log(f"[KG and persistence path] kernel launches {kg_launches}")
    for name in ("exact_topk_cuda", "pq4_adc_cuda"):
        check(kg_launches[name] >= 1, f"{name} launched on a reloaded index")

    zero()
    keep: dict = {}
    service = phase("phase10", phase10_service, dev, card, 2048, 64, 48 << 20, keep)
    svc_launches = read()
    log(f"[service layer path] kernel launches {svc_launches}")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(svc_launches[name] >= 1, f"{name} launched on the service layer's add")

    zero()
    topology = phase("phase11", phase11_topology, dev, card, eng, cpu, queries, keep)
    topo_launches = read()
    log(f"[topology and repair path] kernel launches {topo_launches} (its builds, routing "
        "and gather scan are torch operations: no hand kernel yet)")
    log("[phase11] device operations " + json.dumps(phase11_ops(topology)))

    zero()
    neural = phase("phase12", phase12_neural, dev, card, docs, queries)
    neural_launches = read()
    log(f"[neural embedding path] kernel launches {neural_launches} (the encoders, MaxSim, "
        "the gather and matryoshka are torch operations: no hand kernel yet)")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(neural_launches[name] >= 1, f"{name} launched on the hf daemon's add")
    log("[phase12] device operations " + json.dumps(phase12_ops(neural)))

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("yams_tpu", "jax", "jaxlib", "flax"))
    check(not loaded, f"no module of yams_tpu, jax, jaxlib or flax loaded (found {loaded})")
    log(f"[summary] {json.dumps({'card': card, 'seconds': seconds, 'add': add, 'add_breakdown_ms': breakdown, 'search': search, 'bench': bench, 'vector_store': store, 'engine_pq': engine_pq, 'experiments': experiments, 'streaming': streaming, 'engine_streaming': engine8, 'kg': kg, 'service': service, 'topology': topology, 'neural': neural, 'torch': torch.__version__})}")

    sources = {
        "gear_hash_cuda": ("yams_tpu_torch/csrc/gear_hash.cu", "yams_tpu/ops/cdc.py:65",
                           add_launches),
        "sha256_cuda": ("yams_tpu_torch/csrc/sha256.cu", "yams_tpu/ops/sha256.py:55",
                        add_launches),
        "exact_topk_cuda": ("yams_tpu_torch/csrc/exact_topk.cu", "yams_tpu/ops/scan.py:94",
                            store_launches),
        "pq4_adc_cuda": ("yams_tpu_torch/csrc/pq4_adc.cu", "yams_tpu/ops/pq_pallas.py:44",
                         store_launches),
        "grouped_max_cuda": ("yams_tpu_torch/csrc/fused_scan.cu", "yams_tpu/ops/scan.py:166",
                             exp_launches),
        "windowed_scan_cuda": ("yams_tpu_torch/csrc/fused_scan.cu",
                               "yams_tpu/ops/flash_topk.py:53", exp_launches),
    }
    records = []
    for name, (src, replaces, launches) in sources.items():
        k = kernels[name]
        # no single PyTorch call computes any of these functions
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None, "shape": k["shape"],
                        "bound_bytes": k["bound_bytes"], "bound_ops": k["bound_ops"],
                        **{key: k[key] for key in ("dot_f32_ms", "tflops", "dot_f32_tflops",
                                                   "large_k", "rising_ms") if key in k}})
        if name in ("exact_topk_cuda", "pq4_adc_cuda"):
            records[-1]["launches_phase9"] = kg_launches[name]
        if name in ("gear_hash_cuda", "sha256_cuda"):
            records[-1]["launches_phase10"] = svc_launches[name]
        records[-1]["launches_phase12"] = neural_launches[name]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
