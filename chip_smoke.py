"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero; each prints its
seconds):

  0. card identity (nvidia-smi name and power limit);
  1. each CUDA kernel built from yams_tpu_torch/csrc (one nvcc per source,
     in parallel) and held against its plain PyTorch twin on the card, with
     both timed: gear hash and SHA-256 bit-exact (SHA-256 also against
     hashlib on 4,096 chunks of up to 256 KiB and on its edge rows:
     lengths 0-200 and around the padding's, the helpers' span's and the
     schedule ring's edges, starts at every residue mod 16, zero-length
     rows, rows at both ends of buffers that begin 0/1/7/13 bytes past a
     16-byte boundary; its chain floor, one 4 KiB and one 256 KiB message
     alone, and the cycles a round at the SM clock); K3 (exact_topk_cuda) at
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
     and hashlib; then its stages by CUDA events and the SHA-256 kernel
     alone on its chunks;
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
     seeded tree of 1,024 zipf-word notes (96-1,536 words) in 64
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
     (c) the ColBERT tier and the fragment arm on 4,096 documents (one
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
     16 searches equal across a restart;
 13. the rest of the service layer: (a) a card daemon and a CPU daemon,
     each trusting the bundled NER plugin (autoloaded, health ok), add 128
     zipf notes of phase 10's kind and 32 notes naming code identifiers and
     multiword proper names through async ingest; the card's NER logits
     within 1e-4 of the CPU module on 64 notes' windows, tags equal but the
     named near-ties (top-2 margin < 1e-5), extract equal on 16, the KG each
     daemon wrote equal; one window's forward timed against its bound,
     with its CUDA launches (torch.profiler) and the windows/s of extract;
     (b) literal, regex and multi-pattern greps through the daemon equal
     to the CLI's and to the CPU app's, grep_multi too; (d) session pin,
     warm and a session-filtered search, card == CPU; a watch pass with a
     file added, one modified and one deleted, which search then sees;
     (c) a 48 MiB seeded blob downloaded through the daemon's job API from
     a file:// URL and from the fake S3 (tests/fixtures/fake_s3.py, the
     standard library only), each launching gear_hash_cuda and
     sha256_cuda, with hashlib's digest, its chunk boundaries the host
     chunker's and its chunk digests hashlib's, read back byte for byte; a
     .part resumed over HTTP Range from a localhost server; repair's
     downloads op removing a stale .part; the data dir spilled to a
     FilesystemBackend with the DR gates green, restored, and 16 searches
     on the restored dir equal to the same on the original (each from a
     fresh open: SearchService.search touches the hotzone of its top 3);
     (f) the MCP server (python -m yams_tpu_torch.mcp on the card)
     answering initialize and 16 search calls as the in-process app does
     (the daemon's batcher, which touches no hotzone, answers a sequence
     otherwise), and auth keygen, token, verify and revoke
     with traversal names refused; (e) bm25_dense (the reference's per-term
     scatter) at N 1,048,576, V 65,536, window 1,024, B 64, T 8 on phase
     4's kind of postings, equal bit for bit to the same call on the CPU,
     timed against its bytes bound, and LexicalIndex.search on phase 3's
     index, card == CPU;
 14. training and real-text evaluation: (a) a stand-in real-text root
     (scripts/realtext.py assemble_root: the repository's markdown and a
     seeded selection of the installed torch package's headers, linked;
     the files, chunks and heading and symbol queries of its
     realtext-BEIR dataset printed); (b) train_ner_default's corpus and
     configuration through NerModel.fit for 300 steps on the card (twice:
     its run-to-run spread) and on the CPU from the card model's weights:
     losses within 1e-5 relative over the first 20 steps and 0.02
     absolute over all, the step where the two trajectories part, both
     falling; a 50-step fit on each device (within the horizon they
     share) with probabilities within 1e-3 and tags and extract on 16
     notes equal but named near-ties; step ms and steps/s on each device,
     the device operations a step and the step's bound; the real-text
     span F1 (eval_ner_realtext) of the bundled and the fitted models on
     both devices, the fitted ones within 0.02; (c)
     train_encoder_realtext at the in-repo realtext_bert_d192's width
     (D 192, 3 layers, 6 heads, FFN 384, T 16 / 128) for 300 steps on
     the stand-in root: the loss every 50 steps (it must fall), host
     batch prep and device step ms, the device operations a step and the
     step's bound, the first 5 steps within 1e-4 relative of the CPU's,
     and the written .npz through the hf provider on both devices within
     1e-4; (d) eval_beir_scale.run_eval with realtext_bert_d192: the
     whole root on the card (bf16, hybrid and hybrid + ColBERT, chunk and
     file level), and a 300-file cut at f32 on the CSR leg on the card
     and the CPU, every metric within 0.005 and the top-10 equal on >=
     98% of queries, the rest named;
 15. scale-out on a mesh of cards driven from one process (every shard on
     its own card where enough are visible, else a virtual mesh of shards
     on the one card): (a) sharded_hybrid_query at the reference's config
     4 width, a 10,485,760 x 768 int8 corpus with row scales (8.05 GB, made
     on the card in blocks), phase 4's packed postings, rows_are_docs, B
     64, C 32, k 10 over 8 shards, against the single-device
     hybrid_query(int8_corpus=True) on the same arrays (values within 2e-3
     at every rank, top-10 id overlap >= 0.9, each differing id a near-tie
     within 1e-4); the same at 4,194,304 x 768 bf16 (phase 8's generator)
     over 2, 4 and 8 shards and the 2 x 4 ("dcn", "ici") mesh;
     sharded_int8_topk, sharded_topk and sharded_pq_topk (PQ4 codes of a
     1,048,576 x 768 clustered corpus, m 48, group 1 and 64) against
     int8_topk_scan, exact_topk_scan and pq_adc_topk; each timed (CUDA
     events) beside its single-device program, with the local scans, the
     merge and the rest split; (b) phase 3's card engine armed over 4
     shards against itself unarmed (trace sharded_devices 4, results
     within 2e-2 with near-ties named), 64 documents added and 8 deleted
     searchable at once with the bytes re-placed, and chunk_agg "sum" and
     the PQ tier served on one device; (c) AppContext: "auto" arms over
     every card when more than one is visible, else stays on the card, and
     "on" raises the reference's error with one; (d) (b)'s sharded arrays
     saved at epoch 3 over 4 shards and restored onto 2 and 8 shards and
     one device bit-equal, min_epoch 4 refused, save and restore MB/s;
     (e) scripts/dryrun_multichip over 8 shards;
 16. the mobile C ABI and the measurement scripts: (a) a C host compiled
     with gcc against yams_tpu_torch/native/include/yams_mobile.h and
     linked to the port's mobile library drives a daemon on the card in
     this process (add_text, store_document of a 48 MiB random blob,
     search, grep, get_document, doctor): the store returns the blob's
     SHA-256 and launches gear_hash_cuda and sha256_cuda, and the search
     hits equal the same daemon's search from Python; (b) embedded mode
     over a fresh directory spawns the port's daemon (YAMS_TPU_DEVICE
     unset: the CLI's default, cuda), whose status and doctor name the
     card; (c) the scripts at small arguments: bench_ipc_ceiling (16 and
     64 clients), bench_daemon (1,000 documents, 1 and 16 clients, a
     quarter filtered), bench_ingest_device (64 MiB; its end-to-end chunks
     equal the host's), bench_pq at 1,048,576 rows on both routes (K4's
     recall@10 within 0.01 of the plain ADC's), profile_legs at the bench
     shape (2 batches) and bench_encode, no request failing;
 17. the six design experiments at the reference's widths, every row
     logged: profile_vec (1,000,448 x 768 unit-normal, B 256, D0 192; the
     exact top-10, f32 and bf16 scores, the 192-dim prefix scan with its
     full-dimension rescore), exp_coarse_bf16 (bench.py's clustered
     1,000,448 x 768, B 1,024: f32, bf16 without and with the f32 rescore
     at C 32 and 128, against the exact oracle), exp_recall_target (the
     same corpus padded to 1,001,472 dead rows included: the exact top-C
     and K1 at group 16 / 64 / 256 / 1,024 with recall@10, and the widest
     group meeting each of the reference's recall targets), profile_bm25
     and profile_bm25b (1,000,448 docs, 65,536 terms x 512 hashed
     postings, windows of 1,024, B 256, T 16: gathers, production's sort,
     the packed single-key sort, the (V, W) row gathers) and
     profile_lex_stages (B 512, T 16, W 1,024, V 65,536), at the
     reference's depth (8 batches); the exact rows' recall must be 1, each
     K1 row's recall the one its contract allows, the bf16 rows' recall
     rising with the candidates, the packed top-1 sums within the
     quantization's error of production's; then, on the path's inputs,
     K1's winners at each group width equal grouped_max_reference on all
     1,024 queries of a batch, dot_bf16 within one bf16 ulp of dot_f32's
     sums rounded, and the mat192 rescores equal dot_f32's top-32 at
     their candidates;
 18. select.top_k's kernel (select_topk_cuda, csrc/select_topk.cu) against
     the plain path (select._plain_top_k) and the key order itself, values
     and indices bit for bit: seven kinds of adversarial rows (equal
     values, ties across the cut, -1e30 fills, -inf, +-0.0, NaN, rising
     scores) at 128 to 1,000,448 columns and k 1 to 1,024, strided and
     misaligned column slices, bf16 and f16 scores (a -NaN row is held to
     the key order alone: the plain path's torch.topk takes every NaN as
     the largest); top_k on a card launching it with no sync; then the
     benchmark's six calls ((1,024, 1,000,448), (1,024, 262,144), (64,
     262,144), (1,024, 4,096), (1,024, 2,624), (1,024, 128), k 64), each
     checked, timed beside its byte bound and the plain path's time, with
     each stage's device time;
 19. the chunked path's segment max (segment_max_cuda, csrc/segment_max.cu)
     at the chunked benchmark cell's shape and layout ((1,024, 8,388,608)
     f32 scores, 7,095,047 live rows in 685,035 contiguous documents, into
     (1,024, 1,048,577)), then with the rows permuted at 1,048,576 rows;
     each bit for bit against scatter_reduce_ amax on the floats and
     segment_max_plain, timed beside its byte bound, scatter_reduce_ and
     the plain version (the adversarial layouts are the card tests of
     tests/test_torch_segment.py).

The kernel launch counters are zeroed just before each path and read just
after. Every top-k on the card goes through select_topk_cuda (select.top_k),
whose launches are printed with each path's counts; besides it: the add path (phases 2-3) must launch gear_hash_cuda and
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
are printed with their calls on the path, times, bounds and yardsticks;
phase 13's downloads must launch gear_hash_cuda and sha256_cuda, and its
device operations (the NER window forward, bm25_dense) are printed with
their calls, times and bounds; phase 14's path runs torch operations only
(no chunk of its adds reaches K5's 32 MiB), and its counts are printed with
each training step's time, device operations and bound; phase 15's path
runs torch operations only (the shards' scans, the merge, the fusion), and
its counts are printed; phase 16's path must launch gear_hash_cuda,
sha256_cuda (the C host's store, bench_ingest_device) and pq4_adc_cuda
(bench_pq's pallas route); phase 17's must launch grouped_max_cuda
(exp_recall_target's sweep; its check against the twin comes after the
count is read); phase 19's must launch segment_max_cuda, which the
engine's chunked tiers (chunk_agg max and the top-k averages) launch in
every phase that searches them. At
the end no module of
yams_tpu, jax, jaxlib or flax
may be loaded. The second-last line is the kernels' JSON record (each with
its launches, error, time, twin's time and bound), the last line the device
record.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
import types

import numpy as np
import torch

from yams_tpu_torch.scripts._common import cuda_ms, sm_clock_mhz, zipf_text

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
    sha_big_launch_ms = launch_ms(sha256, buf, st, ln, 3)
    log(f"[phase1] sha256 4096 chunks ({len(blob) / 2**20:.1f} MiB): "
        f"cuda {sha_big_ms:.3f} ms (the launch alone {sha_big_launch_ms:.3f}); "
        "all digests == hashlib")
    del buf
    edge_rows = phase1_sha256_edges(dev)
    chain = sha256_chain(dev)

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
    sha_launch_ms = launch_ms(sha256, tb, tst, tln, 10)
    sha_plain_ms = cuda_ms(lambda: sha256.sha256_reference(tb, tst, tln), 1)
    log(f"[phase1] sha256 {rows}x{width} B: cuda {sha_ms:.4f} ms (the launch alone "
        f"{sha_launch_ms:.4f}), plain {sha_plain_ms:.1f} ms")
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
                            shape=f"{rows} rows x ~{width} B", launch_ms=sha_launch_ms,
                            ms_4096_chunks_to_256KiB=sha_big_ms,
                            launch_ms_4096_chunks_to_256KiB=sha_big_launch_ms,
                            edge_rows_equal_hashlib=edge_rows, **chain,
                            **bound(float(lens.sum()) + 44.0 * rows, 2200.0 * blocks,
                                    PEAK_INT)),
    }


# the SHA-256 kernel's staging sizes (yams_tpu_torch/csrc/sha256.cu): a helper
# warp copies kSpanBlocks = 4 blocks of a lane at a time, and the schedule
# ring holds kSlots = 12 blocks of every lane
SHA_SPAN = 4 * 64
SHA_RING = 12 * 64


def sha256_edge_rows(seed: int):
    """Rows at the SHA-256 kernel's edges, in one buffer: lengths 0-200; one
    below, at and one above 55/56, 63/64 and 119/120 (the padding's edges),
    the helpers' span and twice it, the schedule ring and twice it; starts at
    every residue mod 16; a zero-length row after every tenth row; a row at
    byte 0 and one that ends at the buffer's last byte. -> (bytes, (N,)
    int64 starts, (N,) int32 lengths)."""
    lengths = list(range(201))
    for edge in (55, 56, 63, 64, 119, 120, SHA_SPAN, 2 * SHA_SPAN, SHA_RING, 2 * SHA_RING):
        lengths += [edge - 1, edge, edge + 1]
    starts, rows, at = [0], [300], 0
    for i, n in enumerate(lengths):
        at += (i - at) % 16                 # row i starts at residue i mod 16
        starts.append(at)
        rows.append(n)
        at += n
        if i % 10 == 9:
            starts.append(at)
            rows.append(0)
    starts.append(at)                       # the last row ends at the last byte
    rows.append(100)
    blob = np.random.default_rng(seed).bytes(at + 100)
    return blob, np.asarray(starts, np.int64), np.asarray(rows, np.int32)


def launch_ms(sha256, buf, st, ln, reps: int) -> float:
    """CUDA-event ms of the SHA-256 kernel's launch alone (its wrapper's
    checks and plan made once, outside the timing)."""
    order = sha256.block_order(ln)
    out = torch.empty((ln.shape[0], 32), dtype=torch.uint8, device=buf.device)
    return cuda_ms(lambda: sha256.launch(buf, st, ln, order, out), reps)


def phase1_sha256_edges(dev) -> int:
    """sha256_edge_rows on the card against hashlib, in buffers that begin 0,
    1, 7 and 13 bytes past a 16-byte boundary (views into one allocation with
    other bytes around them); a row past the buffer's end refused."""
    from yams_tpu_torch.ingest.device_pipeline import payload_tensor
    from yams_tpu_torch.ops import sha256

    blob, starts, lengths = sha256_edge_rows(SEED + 16)
    want = [hashlib.sha256(blob[s:s + n]).digest() for s, n in zip(starts, lengths)]
    st = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    for lead in (0, 1, 7, 13):
        whole = payload_tensor(b"\xa5" * lead + blob + b"\x5a" * 31, dev)
        buf = whole[lead:lead + len(blob)]
        check(buf.data_ptr() % 16 == lead, f"the edge buffer begins {lead} bytes in")
        dig = sha256.sha256_cuda(buf, st, ln).cpu().numpy()
        for i, (s, n) in enumerate(zip(starts, lengths)):
            check(dig[i].tobytes() == want[i],
                  f"sha256_cuda == hashlib on edge row {i} (start {s}, len {n}, lead {lead})")
        try:
            sha256.sha256_cuda(buf, st + 1, ln)
        except ValueError:
            pass
        else:
            raise RuntimeError("check failed: sha256_cuda refuses a row past the buffer")
    log(f"[phase1] sha256 {len(want)} edge rows x 4 buffer leads == hashlib")
    return len(want)


def sha256_chain(dev, reps: int = 20) -> dict:
    """The chain floor: one message alone as its own launch (the kernel
    alone, CUDA events) at 4 KiB and 256 KiB, and the cycles a round of the
    256 KiB one at the SM clock nvidia-smi reads while it runs."""
    from yams_tpu_torch.ingest.device_pipeline import payload_tensor
    from yams_tpu_torch.ops import sha256

    rng = np.random.default_rng(SEED + 17)
    chain, runs = {}, {}
    for n in (4096, 256 * 1024):
        msg = rng.bytes(n)
        buf = payload_tensor(msg, dev)
        st = torch.zeros(1, dtype=torch.int64, device=dev)
        ln = torch.full((1,), n, dtype=torch.int32, device=dev)
        order = torch.zeros(1, dtype=torch.int64, device=dev)
        out = torch.empty((1, 32), dtype=torch.uint8, device=dev)
        runs[n] = lambda buf=buf, st=st, ln=ln, order=order, out=out: sha256.launch(
            buf, st, ln, order, out)
        chain[f"{n} B"] = cuda_ms(runs[n], reps)
        check(out.cpu().numpy()[0].tobytes() == hashlib.sha256(msg).digest(),
              f"sha256_cuda == hashlib on one {n}-byte message")
    mhz = sm_clock_mhz(runs[256 * 1024])
    rounds = (256 * 1024 + 9 + 63) // 64 * 64
    cycles = chain[f"{256 * 1024} B"] * 1e-3 * mhz * 1e6 / rounds
    log(f"[phase1] sha256 chain floor: 4 KiB {chain['4096 B']:.4f} ms, 256 KiB "
        f"{chain['262144 B']:.4f} ms; SM clock {mhz:.0f} MHz -> {cycles:.1f} cycles a round")
    return {"chain_ms": chain, "sm_clock_mhz": mhz, "cycles_per_round": cycles}


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
    """Stage times of a second pass (not on the counted path), each stage by
    CUDA events around it: the card's clock, which runs on through the host
    stages it waits for. Then the SHA stage's kernel alone: the wrapper
    (checks, plan, launch) and the launch, each over 5 launches."""
    from yams_tpu_torch.ingest.chunker import ChunkingConfig, _masks, select_cuts
    from yams_tpu_torch.ingest.device_pipeline import payload_tensor
    from yams_tpu_torch.ops import cdc, sha256

    c = ChunkingConfig()
    out = {}

    def timed(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        r = fn()
        b.record()
        torch.cuda.synchronize()
        out[name] = a.elapsed_time(b)
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
    timed("sha256_stage_ms", lambda: sha256.sha256_cuda(buf, st, ln).cpu())
    out.update(chunks=len(ends), longest_chunk_blocks=int((int(ln.max()) + 9 + 63) // 64),
               sha256_ms=cuda_ms(lambda: sha256.sha256_cuda(buf, st, ln), 5),
               sha256_launch_ms=launch_ms(sha256, buf, st, ln, 5))
    log("[phase2] breakdown (CUDA events) " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v for k, v in out.items()}))
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
    """Phase 11's device operations (torch but for their top-k), each with
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


def bert_flops(tokens: int, T: int, layers: int = 3, D: int = 192, inter: int = 384) -> float:
    """Multiply-adds x 2 of the BERT layers: q, k, v, o (4 D^2), the MLP
    (2 D I) and the attention's two products (2 T D), a token a layer."""
    return 2.0 * tokens * layers * (4 * D * D + 2 * D * inter + 2 * T * D)


def bert_weight_bytes(layers: int = 3, D: int = 192, inter: int = 384) -> float:
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


def phase12_tiers(dev, docs, queries, subs, counts: CallCounts, n_docs: int = 4_096) -> dict:
    """(c) the ColBERT tier and the fragment arm over 4,096 documents (cut
    from 16,384 to 8,192, then 4,096, to keep the whole smoke well inside
    its time limit on a slow host)."""
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


# -- phase 13 -----------------------------------------------------------------
class RangeServer:
    """A localhost HTTP server of named payloads that answers a Range
    request with 206 and the rest of the payload, as a resumed download
    needs (file:// and the fake S3 ignore Range)."""

    def __init__(self, files: dict[str, bytes]):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.gets: list[str | None] = []
        gets = self.gets

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                data = files.get(self.path.lstrip("/"))
                if data is None:
                    self.send_error(404)
                    return
                rng = self.headers.get("Range")
                gets.append(rng)
                start = int(rng.removeprefix("bytes=").split("-")[0]) if rng else 0
                self.send_response(206 if rng else 200)
                self.send_header("Content-Length", str(len(data) - start))
                if rng:
                    self.send_header("Content-Range",
                                     f"bytes {start}-{len(data) - 1}/{len(data)}")
                self.end_headers()
                self.wfile.write(data[start:])

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


IDENTS = ["CacheManager", "ingest_queue_worker", "HttpServer", "parse_config", "TokenStream",
          "BlockAllocator", "write_ahead_log", "QueryPlanner", "flush_dirty_pages",
          "RaftLeader", "snapshot_writer", "IndexBuilder"]
NAMES = ["New York City", "Widget Factory", "Ada Lovelace", "Grace Hopper", "Linus Torvalds",
         "San Francisco", "Open Source Initiative", "Bell Labs"]


def entity_notes(n: int, seed: int) -> dict[str, str]:
    """Notes that name code identifiers and multiword proper names among
    plain words (the bundled NER checkpoint's kind of text)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        parts = []
        for _ in range(int(rng.integers(4, 12))):
            ident, name = IDENTS[rng.integers(len(IDENTS))], NAMES[rng.integers(len(NAMES))]
            parts.append(f"When the {ident} runs after the {IDENTS[rng.integers(len(IDENTS))]}, "
                         f"the team in {name} reviews the logs and files a report.")
        out[f"entities/e{i:03d}.txt"] = " ".join(parts) + "\n"
    return out


def sql_rows(app, query: str) -> list:
    return [tuple(r) for r in app.db.execute(query).fetchall()]


def count_cuda_launches(fn) -> dict:
    """CUDA work of one fn() call under torch.profiler: the kernels and
    copies the device ran, and the runtime's launch and copy calls on the
    host (the two agree when the profiler sees the device)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    runtime = [e for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                               "cuLaunchKernel", "cudaMemcpyAsync")]
    return {"device_ops": len(device), "runtime_calls": len(runtime),
            "kernels": sorted({e.name for e in device})[:40]}


def ner_bound(cfg, n_windows: int = 1) -> dict:
    """One window's forward: the f32 multiply-adds (x2) of the encoder and
    the label scores, and the bytes of the weights it reads (the rows of
    the subword table it gathers) with its inputs and logits."""
    L, D, G, K = cfg.window, cfg.dm, 8, len(cfg.labels)
    per_layer = 3 * L * D * D + 2 * L * L * D + L * D * D + 2 * L * D * 2 * D
    flops = 2 * (L * 6 * D + cfg.layers * per_layer + L * D * (2 * K + 1))
    weights = 4 * (L * G * D + 6 * D + L * D + cfg.layers * (4 * D * D + 4 * D * D + 8 * D)
                   + 2 * D * D + D)
    io = L * G * 4 + L * 6 * 4 + L * 4 + L * (2 * K + 1) * 4
    return bound(n_windows * (weights + io), n_windows * flops, 2 * PEAK_CORE)


def ner_windows(texts, window: int):
    """Every window of the texts as the NER model tags them."""
    from yams_tpu_torch.embed.ner import featurize, word_tokenize

    rows = []
    for text in texts:
        toks = [t for t, _ in word_tokenize(text)]
        for w0 in range(0, len(toks), window):
            rows.append(featurize(toks[w0:w0 + window], window))
    return [np.stack(a) for a in zip(*rows)]


def near_ties(probs: np.ndarray, margin: float = 1e-5) -> np.ndarray:
    """(windows, L) mask of tokens whose top two tag probabilities lie
    within `margin`."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < margin


def phase13_ner(dev, notes: dict, card_d, cpu_d) -> dict:
    """(a) the NER forward against its CPU twin, and the daemons' KGs."""
    from yams_tpu_torch.embed import ner
    from yams_tpu_torch.plugins.neural_ner import _BUNDLED

    card_m = ner.NerModel.load(_BUNDLED, device=dev)
    cpu_m = ner.NerModel.load(_BUNDLED, device="cpu")
    W = card_m.cfg.window
    sample = list(notes.values())[:64]
    ng, cf, mask = ner_windows(sample, W)
    with torch.inference_mode():
        got = card_m.logits(ng, cf, mask)
        probs_card = torch.softmax(got, -1).cpu().numpy()
        got = got.cpu().numpy()
        want = cpu_m.logits(ng, cf, mask)
        probs_cpu = torch.softmax(want, -1).numpy()
        want = want.numpy()
    err = float(np.abs(got - want).max())
    check(err <= 1e-4, f"card NER logits within 1e-4 of the CPU module ({err:.3g})")
    live = mask > 0
    tags_card, tags_cpu = probs_card.argmax(-1), probs_cpu.argmax(-1)
    ties = near_ties(probs_cpu) & live
    differ = (tags_card != tags_cpu) & live
    check(not (differ & ~ties).any(),
          f"card tags equal the CPU's except near-ties ({int(differ.sum())} differ, "
          f"{int((differ & ~ties).sum())} of them no tie)")
    named = [(int(w), int(t)) for w, t in zip(*np.nonzero(ties))]
    if named:
        log(f"[phase13 ner] near-ties (window, token; top-2 margin < 1e-5): {named[:20]}")
    # extract on 16 notes, timed on each device (one window a forward)
    timed = sample[:16]
    n_win = len(ner_windows(timed, W)[0])
    got_ents, secs = {}, {}
    for name, model in (("card", card_m), ("cpu", cpu_m)):
        t = time.perf_counter()
        got_ents[name] = [[x[:2] for x in model.extract(text)] for text in timed]
        secs[name] = time.perf_counter() - t
    extract_equal = sum(a == b for a, b in zip(got_ents["card"], got_ents["cpu"]))
    check(extract_equal == len(timed) or bool(named),
          f"card extract == CPU extract ({extract_equal} of {len(timed)} notes)")
    wall, cpu_wall = secs["card"], secs["cpu"]
    # one window, as the add runs it
    one = [a[:1] for a in (ng, cf, mask)]
    fwd_ms = cuda_ms(lambda: card_m.logits(*one), 200)
    toks = [t for t, _ in ner.word_tokenize(sample[0])][:W]
    launches = count_cuda_launches(lambda: card_m.tag(toks))
    b = ner_bound(card_m.cfg)
    out = {"windows": len(ng), "timed_windows": n_win, "max_abs_err": err, "differ": int(differ.sum()),
           "near_ties": len(named), "extract_equal": extract_equal,
           "window_ms": fwd_ms, "windows_per_s": n_win / wall,
           "cpu_windows_per_s": n_win / cpu_wall, **b, "launches": launches}
    log(f"[phase13 ner] 64 notes, {len(ng)} windows of {W}: card logits within {err:.3g} of the "
        f"CPU module; tags equal but {int(differ.sum())} ({len(named)} near-ties named); "
        f"extract equal on {extract_equal}/16; one window's forward {fwd_ms:.4f} ms against "
        f"{b['bound_ms']:.6f} ms bound ({b['bound_by']}); extract of 16 notes {n_win / wall:.1f} "
        f"windows/s on the card, {n_win / cpu_wall:.1f} on the CPU; per window {launches['device_ops']} "
        f"device ops, {launches['runtime_calls']} runtime launch/copy calls")
    # the KG each daemon's add wrote
    q_nodes = "SELECT node_key, label, type FROM kg_nodes ORDER BY node_key"
    q_links = ("SELECT d.document_id, n.node_key FROM doc_entities d JOIN kg_nodes n "
               "ON n.id = d.node_id ORDER BY 1, 2")
    kg = {}
    for name, d in (("card", card_d), ("cpu", cpu_d)):
        kg[name] = (sql_rows(d.app, q_nodes), sql_rows(d.app, q_links))
    diff_docs = sorted({doc for doc, _ in set(kg["card"][1]) ^ set(kg["cpu"][1])})
    if diff_docs:
        # a differing document must hold a named near-tie on the card
        for doc in diff_docs:
            text = card_d.app.metadata.get_content(doc)
            ng2, cf2, m2 = ner_windows([text], W)
            with torch.inference_mode():
                p = torch.softmax(cpu_m.logits(ng2, cf2, m2), -1).numpy()
            check((near_ties(p) & (m2 > 0)).any(),
                  f"the KGs differ on document {doc} only where a tag is a near-tie")
        log(f"[phase13 ner] KG links differ on documents {diff_docs} (near-ties)")
    else:
        check(kg["card"][0] == kg["cpu"][0], "the card daemon's KG nodes equal the CPU's")
    check(len(kg["card"][0]) >= len(IDENTS), f"the NER wrote the KG ({len(kg['card'][0])} nodes)")
    out["kg_nodes"] = len(kg["card"][0])
    out["kg_links"] = len(kg["card"][1])
    out["kg_equal"] = not diff_docs
    return out


def cli_json(*argv) -> object:
    """The port's CLI in this process (it routes through a daemon on the
    storage's socket) -> its --json output."""
    import contextlib
    import io

    from yams_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--json", *argv])
    check(rc in (0, 1), f"the CLI ran {argv} (rc {rc})")
    return json.loads(buf.getvalue())


GREPS = [("literal", "CacheManager", {}), ("regex", r"w1\d\d w2\d+", {}),
         ("multi", "CacheManager|ingest_queue_worker|Grace Hopper", {"ignore_case": True})]


def phase13_grep(card_d, cpu_d, data_dir) -> dict:
    """(b) grep through the daemon == the CLI == a CPU AppContext."""
    out = {}
    for name, pattern, kw in GREPS:
        t = time.perf_counter()
        got = card_d.client.grep(pattern, **kw)
        ms = (time.perf_counter() - t) * 1e3
        argv = ["--storage", str(data_dir), "grep", pattern] + (["-i"] if kw else [])
        cli = cli_json(*argv)
        want = cpu_d.app.grep.grep(pattern, **kw)
        rows = [(m["path"], m["line_number"], m["line"]) for m in got["matches"]]
        check(rows and rows == [(m["path"], m["line_number"], m["line"]) for m in cli["matches"]],
              f"grep {name}: the CLI printed the daemon's matches")
        check(rows == [(m.path, m.line_number, m.line) for m in want.matches],
              f"grep {name}: the card daemon's matches equal a CPU AppContext's")
        out[name] = {"ms": ms, "matches": len(rows), "files_matched": got["files_matched"]}
    card_multi = card_d.app.grep.grep_multi(IDENTS[:4])
    cpu_multi = cpu_d.app.grep.grep_multi(IDENTS[:4])
    check([dataclasses.astuple(m) for m in card_multi.matches] ==
          [dataclasses.astuple(m) for m in cpu_multi.matches] and card_multi.matches,
          "grep_multi (Aho-Corasick) on the card's app equals the CPU's")
    out["grep_multi_matches"] = len(card_multi.matches)
    log(f"[phase13 grep] {json.dumps(out)}; daemon == CLI == CPU AppContext")
    return out


def wait_job(client, job: str, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while (st := client.call("download_status", job_id=job))["state"] in ("queued", "running"):
        check(time.monotonic() < deadline, f"download job {job} finished in time")
        time.sleep(0.05)
    return st


def phase13_downloads(dev, card_d, root, blobs: list) -> dict:
    """(c) downloads through the daemon's job API (file:// and the fake S3,
    a seeded blob each: the store takes a payload it holds already without
    hashing it on the device), a resumed .part, the repair op's cleanup,
    and a remote checkpoint."""
    import importlib.util

    from yams_tpu_torch.ingest.chunker import _boundaries_numpy
    from yams_tpu_torch.ops import cdc, sha256
    from yams_tpu_torch.storage.backends import FilesystemBackend, backend_from_url
    from yams_tpu_torch.storage import remote_checkpoint as rc

    c, app = card_d.client, card_d.app
    blob = blobs[0]
    digests = [hashlib.sha256(b).hexdigest() for b in blobs]
    src = root / "dl" / "blob.bin"
    src.parent.mkdir(parents=True)
    src.write_bytes(blob)
    spec = importlib.util.spec_from_file_location(
        "fake_s3", pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "fake_s3.py")
    fake_s3 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake_s3)
    srv, endpoint, _state = fake_s3.make_server()
    ranged = RangeServer({"blob.bin": blob})
    out = {}
    try:
        s3 = backend_from_url("s3://bucket/pre", access_key="k", secret_key="s",
                              endpoint=endpoint)
        t = time.perf_counter()
        s3.put("blob.bin", blobs[1])
        out["s3_put_s"] = time.perf_counter() - t
        jobs = {}
        for name, url, payload, digest in (("file", src.as_uri(), blob, digests[0]),
                                           ("s3", s3._url("blob.bin"), blobs[1], digests[1])):
            g0, s0 = cdc.gear_hash_cuda.launches, sha256.sha256_cuda.launches
            t = time.perf_counter()
            job = c.call("download_start", url=url, tags=["dl", name])["job_id"]
            st = wait_job(c, job)
            secs = time.perf_counter() - t
            gear, sha = cdc.gear_hash_cuda.launches - g0, sha256.sha256_cuda.launches - s0
            res = st["result"]
            check(st["state"] == "completed" and res["sha256"] == digest,
                  f"the {name} download completed with hashlib's digest ({st.get('error')})")
            check(gear >= 1 and sha >= 1,
                  f"the {name} download launched gear_hash_cuda ({gear}) and sha256_cuda ({sha})")
            check(c.cat(res["sha256"]) == payload,
                  f"the {name} download reads back byte for byte")
            # K5 and SHA-256 at this path's own size: the stored chunks'
            # boundaries are the host chunker's, and their digests hashlib's
            chunks = app.content_store.refcounter.get_manifest(res["sha256"]).chunks
            cfg = app.content_store.chunker.config
            check([ch.offset + ch.size for ch in chunks]
                  == _boundaries_numpy(payload, cfg.min_size, cfg.avg_size, cfg.max_size),
                  f"the {name} download's {len(chunks)} chunk boundaries == host chunker oracle")
            check(all(hashlib.sha256(payload[ch.offset:ch.offset + ch.size]).hexdigest()
                      == ch.hash for ch in chunks),
                  f"the {name} download's chunk digests == hashlib")
            jobs[job] = name
            out[name] = {"s": secs, "mb_per_s": len(blob) / 1e6 / secs,
                         "gear_hash_launches": gear, "sha256_launches": sha,
                         "chunks": len(chunks),
                         "document_id": res["document_id"]}
        listed = {j["job_id"] for j in c.call("download_list")["jobs"]}
        check(set(jobs) <= listed, "download_list lists both jobs")
        # a .part that an interrupted download left, resumed over HTTP Range
        url = f"{ranged.url}/blob.bin"
        part, cut = app.downloads._part_path(url), len(blob) * 2 // 5
        part.write_bytes(blob[:cut])
        app.downloads._resume_set(url, {"part": str(part), "bytes": cut})
        res = c.call("download", url=url)
        check(res["resumed_from"] == cut and res["bytes_downloaded"] == len(blob) - cut
              and res["sha256"] == digests[0] and ranged.gets == [f"bytes={cut}-"],
              f"the .part resumed from {cut} bytes ({ {k: res[k] for k in ('resumed_from', 'bytes_downloaded')} })")
        out["resumed_from"] = res["resumed_from"]
        # repair's downloads op removes a stale .part
        (app.downloads.dir / "stale.part").write_bytes(b"left behind")
        rep = c.repair(["downloads"])["downloads"]
        check("1 orphan .part removed" in rep and not (app.downloads.dir / "stale.part").exists(),
              f"repair downloads removed the stale .part ({rep})")
        out["repair"] = rep
    finally:
        srv.shutdown()
        srv.server_close()
        ranged.close()
    # spill the data dir to a FilesystemBackend and restore it
    c.call("checkpoint")
    remote = FilesystemBackend(root / "remote")
    t = time.perf_counter()
    m = rc.spill_checkpoint(app.config.data_dir, remote, "smoke-1", epoch=1)
    spill_s = time.perf_counter() - t
    dr = rc.DRProvider(remote)
    ready, sample, gate = (dr.is_replication_ready("smoke-1"), dr.verify_sample("smoke-1"),
                           dr.pointer_gate("smoke-1"))
    check(ready.ready and sample.passed and gate.allow_advance
          and rc.latest_pointer(remote) == {"manifest_id": "smoke-1", "epoch": 1},
          f"the DR gates are green ({ready}, {sample}, {gate})")
    t = time.perf_counter()
    rc.restore_checkpoint(remote, root / "restored")
    out["checkpoint"] = {"files": len(m["files"]), "bytes": sum(f["size"] for f in m["files"]),
                         "spill_s": spill_s, "restore_s": time.perf_counter() - t}
    log(f"[phase13 downloads] {json.dumps(out)}")
    return out


def app_searches(dev, data_dir, queries) -> list:
    """The queries in order through SearchService.search (the path of the
    CLI's and the MCP server's in-process app) on a freshly opened
    AppContext. That path touches the hotzone of each answer's top 3, so
    a later query's scores depend on the earlier ones: compare sequences
    run from the same fresh state."""
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.services.app import AppContext

    app = AppContext(load_config(data_dir=data_dir), device=dev)
    try:
        return [hits_of(app.search.search(q, limit=10)) for q in queries]
    finally:
        app.close()


def phase13_sessions_watch(card_d, cpu_d, root) -> dict:
    """(d) pin, warm and a session-filtered search (card == CPU); a watch
    pass with a file added, one modified and one deleted."""
    out = {}
    results = {}
    for name, d in (("card", card_d), ("cpu", cpu_d)):
        c = d.client
        c.call("session", op="create", name="work")
        c.call("session", op="pin", pattern="/d03/*", name="work")
        c.call("session", op="pin", pattern="/entities/e00*", name="work")
        warmed = c.call("session", op="warm", name="work")["warmed"]
        hits = c.call("search", query="w3 w7 CacheManager", limit=10,
                      filters={"session": "work"})
        results[name] = (warmed, hits_of(hits), [h["path"] for h in hits["hits"]])
    check(results["card"][0] == results["cpu"][0] > 0, f"warm counts ({results['card'][0]})")
    out["session"] = results_agree("session-filtered search", [results["card"][1]],
                                   [results["cpu"][1]])
    check(out["session"]["equal"] == 1 and results["card"][2]
          and all(p.startswith(("/d03/", "/entities/e00")) for p in results["card"][2]),
          "the session-filtered search answers from the pinned set, card == CPU")
    out["warmed"] = results["card"][0]
    w = root / "watched"
    w.mkdir()
    (w / "keep.txt").write_text("alpha watchkeep note\n")
    (w / "change.txt").write_text("beta watchbefore note\n")
    (w / "gone.txt").write_text("gamma watchgone note\n")
    c = card_d.client
    first = c.call("watch", directory=str(w))["events"]
    check(sorted(e["kind"] for e in first) == ["added"] * 3, f"the first pass added 3 ({first})")
    (w / "new.txt").write_text("delta watchnew note\n")
    (w / "change.txt").write_text("beta watchafter note\n")
    os.utime(w / "change.txt", (1, 1))
    (w / "gone.txt").unlink()
    second = c.call("watch", directory=str(w), delete_missing=True)["events"]
    check(sorted((pathlib.Path(e["path"]).name, e["kind"]) for e in second) ==
          [("change.txt", "modified"), ("gone.txt", "removed"), ("new.txt", "added")],
          f"the second pass saw the add, the change and the delete ({second})")
    found = {word: bool(c.search(word, search_type="keyword")["hits"])
             for word in ("watchnew", "watchafter", "watchgone", "watchkeep")}
    check(found == {"watchnew": True, "watchafter": True, "watchgone": False,
                    "watchkeep": True}, f"search sees the watch pass ({found})")
    out["watch"] = {"first": len(first), "second": len(second)}
    log(f"[phase13 sessions and watch] {json.dumps(out)}")
    return out


def dense_postings(dev, N: int, V: int, WIN: int, gen):
    """Phase 4's postings as CSR for the dense scan: each of V terms holds
    WIN/2 multiplicative-hash docs of N (unique within a term) in impact
    order, tf falling as phase 4's impacts do, seeded doc norms, and the
    idf of a WIN/2-document term."""
    per_term = WIN // 2
    tt = torch.arange(V, device=dev, dtype=torch.int64)[:, None]
    cc = torch.arange(per_term, device=dev, dtype=torch.int64)[None, :]
    docs = ((((tt * per_term + cc) * 2654435761) & 0xFFFFFFFF) % N).reshape(-1)
    tf = (0.5 + 4.75 * (1.0 + cc.float()) ** -0.7).expand(V, per_term).reshape(-1)
    pad = torch.full((WIN,), N, device=dev, dtype=torch.int64)
    postings_doc = torch.cat([docs, pad]).to(torch.int32)
    postings_tf = torch.cat([tf, torch.zeros(WIN, device=dev)])
    offsets = (torch.arange(V, device=dev) * per_term).to(torch.int32)
    lengths = torch.full((V,), per_term, device=dev, dtype=torch.int32)
    doc_norm = 0.5 + torch.rand(N, generator=gen, device=dev)
    idf = torch.full((V,), float(np.log(1.0 + (N - per_term + 0.5) / (per_term + 0.5))),
                     device=dev)
    return postings_doc, postings_tf, offsets, lengths, doc_norm, idf


def phase13_bm25(dev, eng, cpu, queries, N: int = 1 << 20, V: int = 65536,
                 WIN: int = 1024, B: int = 64, T: int = 8) -> dict:
    """(e) bm25_dense at phase 4's scale on the card against the same call on
    the CPU, and LexicalIndex.search on phase 3's index, card == CPU."""
    from yams_tpu_torch.ops import bm25

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    arrs = dense_postings(dev, N, V, WIN, gen)
    rng = np.random.default_rng(SEED + 13)
    tids = torch.from_numpy((rng.zipf(1.3, (B, T)) % V).astype(np.int32)).to(dev)
    tmask = torch.from_numpy(rng.choice([0.5, 1.0, 1.0, 1.0], (B, T)).astype(np.float32)).to(dev)
    kw = dict(window=WIN, num_docs=N)
    got = bm25.bm25_dense(tids, tmask, *arrs, **kw)
    host = [x.cpu() for x in (tids, tmask, *arrs)]
    want = bm25.bm25_dense(*host, **kw)
    check(torch.equal(got.cpu(), want), "bm25_dense on the card equals the CPU's bit for bit")
    again = bm25.bm25_dense(tids, tmask, *arrs, **kw)
    check(torch.equal(got, again), "bm25_dense gives the same scores on every run")
    ms = cuda_ms(lambda: bm25.bm25_dense(tids, tmask, *arrs, **kw), 20)
    t = time.perf_counter()
    for _ in range(3):
        bm25.bm25_dense(*host, **kw)
    cpu_ms = (time.perf_counter() - t) / 3 * 1e3
    per_term = WIN // 2
    nbytes = (B * T * (4 + 4 + 4 + 4)             # ids, weights; offsets, lengths, idf gathers
              + B * T * WIN * (4 + 4)             # each window's docs and tfs
              + B * T * per_term * 4              # the live postings' doc norms
              + B * N * 4)                        # the dense scores
    ops = B * T * per_term * 6                   # mul, mul, fma, div, mul, add a posting
    b = bound(nbytes, ops, PEAK_CORE)
    out = {"shape": {"N": N, "V": V, "window": WIN, "B": B, "T": T}, "ms": ms,
           "cpu_ms": cpu_ms, **b, "nonzero": int((got > 0).sum())}
    lex = []
    for q in queries[:16]:
        a = eng.lexical_index.search(q, k=10, device=dev)
        w = cpu.lexical_index.search(q, k=10, device="cpu")
        check([i for i, _ in a] == [i for i, _ in w], f"LexicalIndex.search card == CPU ({q!r})")
        top = max([s for _, s in w] or [1.0])
        lex.append(max([abs(x - y) for (_, x), (_, y) in zip(a, w)] or [0.0]) / top)
    out["lexical_search_max_rel_err"] = max(lex)
    check(out["lexical_search_max_rel_err"] <= 1e-6, "LexicalIndex.search scores card == CPU")
    log(f"[phase13 bm25_dense] N {N}, V {V}, window {WIN}, B {B}, T {T}: {ms:.4f} ms "
        f"(the same call on the host CPU {cpu_ms:.2f} ms) against {b['bound_ms']:.4f} ms bound "
        f"({b['bound_by']}: {nbytes} bytes, {ops} ops); equal to the CPU's; "
        f"LexicalIndex.search on phase 3's index card == CPU (max rel err "
        f"{out['lexical_search_max_rel_err']:.3g})")
    return out


def phase13_mcp_auth(dev, data_dir, queries, app_hits) -> dict:
    """(f) the MCP server over stdio on the stopped daemon's data dir (its
    searches against the same sequence on a fresh in-process app), and
    `yams auth`."""
    from yams_tpu_torch.cli.auth import AuthStore

    msgs = [{"jsonrpc": "2.0", "id": 0, "method": "initialize", "params": {}}]
    msgs += [{"jsonrpc": "2.0", "id": i + 1, "method": "tools/call",
              "params": {"name": "search", "arguments": {"query": q, "limit": 10}}}
             for i, q in enumerate(queries)]
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "yams_tpu_torch.mcp", str(data_dir), "--device", str(dev)],
        input="\n".join(json.dumps(m) for m in msgs) + "\n", capture_output=True, text=True,
        timeout=300, cwd=pathlib.Path(__file__).resolve().parent)
    mcp_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the MCP server ran ({proc.stderr[-800:]})")
    replies = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines()) if "id" in r}
    check(replies[0]["result"]["serverInfo"]["name"] == "yams-tpu", "MCP initialize")
    got = []
    for i in range(len(queries)):
        hits = json.loads(replies[i + 1]["result"]["content"][0]["text"])["hits"]
        got.append([types.SimpleNamespace(doc_id=h["document_id"], score=h["score"],
                                          kg_score=h["kg_score"]) for h in hits])
    agree = results_agree("MCP search vs the app", got, app_hits, atol=1e-5)
    check(agree["equal"] == len(queries), "16 MCP searches equal the in-process app's")
    store = AuthStore(data_dir)
    store.keygen("hmac", name="smoke")
    tok = store.token("smoke", {"sub": "smoke"}, validity_s=60)
    check(store.verify_token(tok)["sub"] == "smoke", "auth token verifies")
    refused = []
    for bad in ("../x", "..", "a/b"):
        try:
            store.keygen("hmac", name=bad)
        except ValueError:
            refused.append(bad)
    check(refused == ["../x", "..", "a/b"] and not (data_dir / "x.secret").exists(),
          "auth refuses key names outside the keys directory")
    check(store.revoke("smoke") and store.list_keys()[0]["revoked"], "auth revoke")
    out = {"mcp_s": mcp_s, "mcp_searches": len(queries), "auth_refused": refused}
    log(f"[phase13 mcp and auth] initialize + {len(queries)} searches over stdio in "
        f"{mcp_s:.2f} s == the in-process app's; auth keygen, token, verify, revoke; "
        f"{refused} refused")
    return out


def phase13_services(dev, card: str, eng, cpu, queries, n_notes: int = 128,
                     n_entity: int = 32, blob_bytes: int = 48 << 20) -> dict:
    """Phase 13: the rest of the service layer on the card."""
    import tempfile

    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.embed import ner

    out: dict = {"card": card}
    tmp = tempfile.TemporaryDirectory(prefix="ys13")
    root = pathlib.Path(tmp.name)
    daemons = []
    try:
        vocab, texts, _, _, _ = svc_tree(root / "tree", n_notes, 8, 4096, SEED + 13)
        notes = {str(pathlib.Path(p).relative_to((root / "tree").resolve())): t
                 for p, t in texts.items()}
        notes.update(entity_notes(n_entity, SEED + 14))
        plugin = pathlib.Path(__file__).resolve().parent / "yams_tpu_torch/plugins/neural_ner.py"
        windows = {"n": 0}
        orig_logits = ner.NerModel.logits

        def counted(self, *a):
            if self.device.type == "cuda":
                windows["n"] += a[0].shape[0]
            return orig_logits(self, *a)

        ner.NerModel.logits = counted
        try:
            for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
                cfg = load_config(data_dir=root / name)
                cfg.data_dir.mkdir(parents=True)
                (cfg.data_dir / "plugins_trust.txt").write_text(f"{plugin}\n")
                d = ThreadDaemon(cfg, device)
                daemons.append(d)
                health = d.client.call("plugins", op="list")["health"]
                check(health == {"neural_ner": {"status": "ok", "labels": ["entity"]}},
                      f"the {name} daemon autoloaded the NER plugin ({health})")
            # both daemons' post-ingest workers run at once
            t = time.perf_counter()
            for d in daemons:
                for path, text in notes.items():
                    d.client.add_bytes(text.encode(), path, async_ingest=True)
            for name, d in zip(("card", "cpu"), daemons):
                q = d.client.call("queue", op="wait_idle", timeout=600.0)
                check(q["idle"] and all(s["failed"] == 0 for s in q["stages"].values()),
                      f"the {name} daemon's post-ingest drained ({q['stages']})")
                out[f"{name}_add"] = {"s": time.perf_counter() - t, "docs": len(notes)}
            out["card_add"]["ner_windows_on_card"] = windows["n"]
        finally:
            ner.NerModel.logits = orig_logits
        card_d, cpu_d = daemons
        check(out["card_add"]["ner_windows_on_card"] > 0,
              "the card daemon's adds ran the NER forward on the card")
        log(f"[phase13] {len(notes)} notes added through each daemon with the NER plugin, "
            f"both at once: the card's drained in {out['card_add']['s']:.2f} s "
            f"({out['card_add']['ner_windows_on_card']} windows on the card), the CPU's in "
            f"{out['cpu_add']['s']:.2f} s")
        seconds = out["seconds"] = {"adds": out["cpu_add"]["s"]}

        def sub(name, fn, *args):
            t = time.perf_counter()
            out[name] = fn(*args)
            seconds[name] = time.perf_counter() - t

        sub("ner", phase13_ner, dev, notes, card_d, cpu_d)
        sub("grep", phase13_grep, card_d, cpu_d, root / "card")
        sub("sessions_watch", phase13_sessions_watch, card_d, cpu_d, root)
        blobs = [np.random.default_rng(SEED + 15 + i).bytes(blob_bytes) for i in range(2)]
        rng = np.random.default_rng(SEED + 16)
        svc_queries = [" ".join(vocab[rng.zipf(1.3, size=int(rng.integers(2, 4))) % 512])
                       for _ in range(12)] + ["CacheManager logs", "Grace Hopper report",
                                              "ingest_queue_worker", "watchnew note"]
        sub("downloads", phase13_downloads, dev, card_d, root, blobs)
        for d in daemons:
            d.stop()
        daemons.clear()
        t = time.perf_counter()
        want = app_searches(dev, root / "card", svc_queries)
        out["restore"] = results_agree("search after the restore",
                                       app_searches(dev, root / "restored", svc_queries), want,
                                       atol=1e-5)
        check(out["restore"]["equal"] == len(svc_queries),
              "16 searches on the restored data dir equal those on the original")
        seconds["restore"] = time.perf_counter() - t
        sub("mcp_auth", phase13_mcp_auth, dev, root / "card", svc_queries, want)
        sub("bm25", phase13_bm25, dev, eng, cpu, queries)
        log(f"[phase13] seconds {json.dumps(seconds)}")
        return out
    finally:
        for d in daemons:
            if d.thread.is_alive():
                try:
                    d.stop()
                except Exception:       # noqa: BLE001  (the phase already failed)
                    pass
        tmp.cleanup()


def phase13_ops(services: dict) -> list:
    """The device operations of phase 13 with their times and bounds."""
    ner_, bm = services["ner"], services["bm25"]
    return [{"name": "ner_window_forward", "calls_on_path": services["card_add"]["ner_windows_on_card"],
             "ms": ner_["window_ms"], "bound_ms": ner_["bound_ms"], "bound_by": ner_["bound_by"],
             "device_ops_per_window": ner_["launches"]["device_ops"],
             "runtime_calls_per_window": ner_["launches"]["runtime_calls"],
             "windows_per_s": ner_["windows_per_s"], "cpu_windows_per_s": ner_["cpu_windows_per_s"]},
            {"name": "bm25_dense", "ms": bm["ms"], "cpu_ms": bm["cpu_ms"],
             "bound_ms": bm["bound_ms"], "bound_by": bm["bound_by"],
             "bound_bytes": bm["bound_bytes"]}]


# -- phase 14 -----------------------------------------------------------------
NER_FIT_STEPS = 300       # of train_ner_default's 1,200 (the phase's time budget)
NER_SHARED_STEPS = 50     # within the horizon the card and CPU trajectories share
ENC_FIT_STEPS = 300       # of train_encoder_realtext's 1,500
ENC_MATCH_STEPS = 5       # steps held card against CPU at full width
EVAL_CUT_FILES = 300      # of the stand-in root's 900 files for the card == CPU eval


class one_cpu_thread:
    """Runs the block on one intra-op CPU thread when `device` is the CPU.
    A fit on several threads is not reproducible (its reductions follow the
    threads' schedule), so the CPU loss curve the card's is held against
    changed from run to run while the card's stayed bit-equal; on one
    thread it is the same each time, at about the same speed for the NER
    model (tests/test_torch_smoke_checks.py holds the repeat)."""

    def __init__(self, device):
        self.on = device.type == "cpu"

    def __enter__(self):
        self.threads = torch.get_num_threads()
        if self.on:
            torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)


def launches_per_step(run) -> dict:
    """The device operations of one training step: those of run(4) less
    those of run(2), over 2 (so the set-up both share cancels)."""
    four, two = count_cuda_launches(lambda: run(4)), count_cuda_launches(lambda: run(2))
    return {"device_ops": (four["device_ops"] - two["device_ops"]) / 2,
            "runtime_calls": (four["runtime_calls"] - two["runtime_calls"]) / 2,
            "kernels": four["kernels"]}


def adam_bytes(n_params: int) -> float:
    """An AdamW step's bytes: each parameter, its gradient and both moments
    read, and the parameter and the moments written, in f32."""
    return 4.0 * 7 * n_params


def phase14_root(tmp) -> dict:
    """(a) the stand-in real-text root and its realtext-BEIR dataset."""
    from yams_tpu_torch.scripts import realtext

    info = realtext.assemble_root(pathlib.Path(tmp) / "root")
    ds = realtext.realtext_beir(root=info["root"])
    kinds = list(ds.kinds.values())
    out = {"root": info["root"], "ds": ds, "markdown": info["markdown"],
           "headers": info["headers"], "headers_available": info["headers_available"],
           "files": len({d.rsplit("#", 1)[0] for d in ds.corpus}), "chunks": len(ds.corpus),
           "heading_queries": kinds.count("heading"), "symbol_queries": kinds.count("symbol")}
    log(f"[phase14 root] {out['markdown']} markdown files and {out['headers']} of "
        f"{out['headers_available']} torch headers linked; realtext_beir: {out['files']} files, "
        f"{out['chunks']} chunks, {out['heading_queries']} heading and {out['symbol_queries']} "
        "symbol queries")
    return out


def phase14_ner(dev, root) -> dict:
    """(b) train_ner_default's corpus and configuration through NerModel.fit
    on the card and on the CPU (on one thread, so that it is reproducible)
    from the same weights, twice on the card (its run-to-run spread), then
    extract and the real-text span F1."""
    from yams_tpu_torch.embed.ner import NerModel
    from yams_tpu_torch.plugins.neural_ner import _BUNDLED
    from yams_tpu_torch.scripts import eval_ner_realtext as enr
    from yams_tpu_torch.scripts import train_ner_default as tnd

    cfg = tnd.CONFIG
    train, held, n_real = tnd.training_set(cfg)
    models, losses, step_ms, init = {}, {}, {}, None
    for name, device in (("card", dev), ("card_again", dev), ("cpu", torch.device("cpu"))):
        m = NerModel(cfg, seed=0, device=device)
        if init is None:
            init = {k: v.detach().cpu().clone() for k, v in m.model.state_dict().items()}
        else:                     # the card model's weights, carried over
            m.model.load_state_dict(init)
        got = []
        t = time.perf_counter()
        with one_cpu_thread(device):
            m.fit(train, steps=NER_FIT_STEPS, lr=tnd.LR, batch=tnd.BATCH, losses=got)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t) * 1e3 / NER_FIT_STEPS
        models[name], losses[name] = m, np.array([float(x) for x in got])
    card, cpu = losses["card"], losses["cpu"]
    gap = np.abs(card - cpu)
    rel = gap / np.abs(cpu)
    spread = np.abs(card - losses["card_again"]) / np.abs(card)
    # the step from which the two devices' trajectories part by more than x
    # (the same arithmetic in another order: Adam amplifies the rounding as
    # the gradients shrink)
    parts = {f"{x:g}": int(np.argmax(rel > x)) if (rel > x).any() else None
             for x in (1e-5, 1e-4, 1e-3, 1e-2)}
    log(f"[phase14 ner] {len(train)} windows ({n_real} real-text), {NER_FIT_STEPS} steps of "
        f"batch {tnd.BATCH}: loss card / CPU "
        + ", ".join(f"{s}: {card[s]:.5f} / {cpu[s]:.5f}" for s in range(0, NER_FIT_STEPS, 50))
        + f", {NER_FIT_STEPS - 1}: {card[-1]:.5f} / {cpu[-1]:.5f}; card vs CPU relative max "
        f"{rel[:20].max():.3g} over the first 20 steps, absolute max {gap.max():.3g} over all; "
        f"first step relative past 1e-5/1e-4/1e-3/1e-2: {parts}; the card's run-to-run "
        f"spread max {spread.max():.3g}")
    check(rel[:20].max() <= 1e-5,
          f"NER losses card == CPU within 1e-5 relative over 20 steps ({rel[:20].max():.3g})")
    check(gap.max() <= 2e-2, f"NER losses card == CPU within 0.02 absolute over "
          f"{NER_FIT_STEPS} steps ({gap.max():.3g}; step 0's loss {cpu[0]:.3f})")
    for name, curve in (("card", card), ("CPU", cpu)):
        check(curve[-20:].mean() < 0.1 * curve[:20].mean(), f"the NER loss falls on the {name}")
    # The fitted models on 16 notes of entities. Past the step where the
    # two trajectories part the models differ (reported, with the span F1
    # below); within the shared horizon their probabilities agree, and
    # their tags and extract are held equal but for named near-ties.
    notes = list(entity_notes(16, SEED + 14).values())
    ng, cf, mask = ner_windows(notes, cfg.window)
    live = mask > 0

    def agree(a, b) -> dict:
        with torch.inference_mode():
            pa = torch.softmax(a.logits(ng, cf, mask), -1).cpu().numpy()
            pb = torch.softmax(b.logits(ng, cf, mask), -1).cpu().numpy()
        ents = [[[x[:2] for x in m.extract(t)] for t in notes] for m in (a, b)]
        return {"prob_diff": float(np.abs(pa - pb)[live].max()), "probs": pb,
                "differ": (pa.argmax(-1) != pb.argmax(-1)) & live,
                "extract_equal": sum(x == y for x, y in zip(*ents))}

    after = agree(models["card"], models["cpu"])
    short = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        short[name] = NerModel(cfg, seed=0, device=device)
        short[name].model.load_state_dict(init)
        with one_cpu_thread(device):
            short[name].fit(train, steps=NER_SHARED_STEPS, lr=tnd.LR, batch=tnd.BATCH)
    within = agree(short["card"], short["cpu"])
    ties = near_ties(within["probs"], 1e-4) & live
    named = [(int(w), int(t)) for w, t in zip(*np.nonzero(ties))]
    check(within["prob_diff"] <= 1e-3, f"NER probabilities card == CPU within 1e-3 after "
          f"{NER_SHARED_STEPS} steps ({within['prob_diff']:.3g})")
    check(not (within["differ"] & ~ties).any(), f"NER tags card == CPU after "
          f"{NER_SHARED_STEPS} steps but near-ties ({int(within['differ'].sum())} differ)")
    check(within["extract_equal"] == len(notes) or bool(named), f"NER extract card == CPU "
          f"after {NER_SHARED_STEPS} steps ({within['extract_equal']} of {len(notes)} notes)")
    if named:
        log(f"[phase14 ner] near-ties after {NER_SHARED_STEPS} steps (window, token; top-2 "
            f"margin < 1e-4): {named[:20]}")
    # the launches of one step, and the step's bound
    scratch = NerModel(cfg, seed=0, device=dev)
    per_step = launches_per_step(lambda k: scratch.fit(train[:64], steps=k, lr=tnd.LR,
                                                       batch=tnd.BATCH))
    n_params = sum(p.numel() for p in scratch.model.parameters())
    fwd = ner_bound(cfg, tnd.BATCH + len(cfg.labels))["bound_ops"]
    b = bound(adam_bytes(n_params) + tnd.BATCH * cfg.window * (8 * 4 + 6 * 4 + 4 + 8),
              3 * fwd, 2 * PEAK_CORE)
    # the real-text span F1 of the shipped checkpoint and of the fitted one
    sentences = enr.mine_sentences(enr.doc_roots(root))
    f1 = {"bundled_card": enr.evaluate(NerModel.load(_BUNDLED, device=dev), sentences),
          "bundled_cpu": enr.evaluate(NerModel.load(_BUNDLED, device="cpu"), sentences),
          "fitted_card": enr.evaluate(models["card"], sentences),
          "fitted_cpu": enr.evaluate(models["cpu"], sentences)}
    check(abs(f1["fitted_card"]["span_f1"] - f1["fitted_cpu"]["span_f1"]) <= 0.02,
          "the fitted models' real-text span F1 card == CPU within 0.02")
    log(f"[phase14 ner] step {step_ms['card']:.3f} ms on the card ({1e3 / step_ms['card']:.1f} "
        f"steps/s), {step_ms['cpu']:.3f} ms on the CPU ({1e3 / step_ms['cpu']:.1f} steps/s); "
        f"{per_step['device_ops']:.0f} device ops a step; bound {b['bound_ms']:.6f} ms "
        f"({b['bound_by']}); after {NER_SHARED_STEPS} steps probabilities within "
        f"{within['prob_diff']:.3g}, extract equal on {within['extract_equal']}/16; after "
        f"{NER_FIT_STEPS} steps within {after['prob_diff']:.3g}, extract equal on "
        f"{after['extract_equal']}/16")
    log(f"[phase14 ner] real-text span F1 on {len(sentences)} sentences: " + json.dumps(f1))
    return {"windows": len(train), "real_windows": n_real, "steps": NER_FIT_STEPS,
            "loss_card": card[::50].tolist() + [card[-1]], "loss_cpu": cpu[::50].tolist() + [cpu[-1]],
            "gap_max": float(gap.max()), "rel_20": float(rel[:20].max()), "parts_at": parts,
            "card_spread": float(spread.max()), "step_ms": step_ms["card"],
            "cpu_step_ms": step_ms["cpu"], "launches": per_step, "n_params": n_params,
            **b, "shared_steps": NER_SHARED_STEPS,
            "prob_diff_shared": within["prob_diff"], "near_ties": len(named),
            "extract_equal_shared": within["extract_equal"], "prob_diff": after["prob_diff"],
            "extract_equal": after["extract_equal"], "f1": f1}


def encoder_step_bound(shape: dict, n_params: int, B: int, qt: int, dt: int) -> dict:
    """One contrastive step at `shape`: the forward's f32 multiply-adds (x2)
    of both towers' layers, tripled for the backward, and the AdamW bytes
    of every parameter with the batch's ids and masks."""
    D, L, inter = shape["dim"], shape["layers"], shape["intermediate"]
    flops = 3 * (bert_flops(B * qt, qt, L, D, inter) + bert_flops(B * dt, dt, L, D, inter))
    return {**bound(adam_bytes(n_params) + B * (qt + dt) * 12, flops, 2 * PEAK_CORE),
            "n_params": n_params}


def phase14_encoder(dev, ds) -> dict:
    """(c) train_encoder_realtext at the in-repo realtext_bert_d192's width
    and depth on the stand-in root: the card's steps split into host batch
    prep and device step, its first steps held against the CPU's, and the
    written checkpoint reloaded by the hf provider on both devices."""
    import tempfile

    from yams_tpu_torch.embed.provider import DEFAULT_HF_CHECKPOINT, HFProvider
    from yams_tpu_torch.scripts import train_encoder_realtext as ter

    z = np.load(DEFAULT_HF_CHECKPOINT)
    shape = {k: int(z[f"cfg/{k}"]) for k in ("dim", "layers", "heads", "intermediate")}
    data = ter.RealtextData(ds=ds)
    trainer = ter.make_trainer(data, ENC_FIT_STEPS, shape, dev)
    batches = data.batches(np.random.default_rng(3))
    losses, prep, step = [], [], []
    for _ in range(ENC_FIT_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        losses.append(trainer.step(batch))
        torch.cuda.synchronize()
        prep.append(t1 - t0)
        step.append(time.perf_counter() - t1)
    losses = np.array([float(x) for x in losses])
    # the first steps again on the CPU, from the same weights and batches
    cpu = ter.make_trainer(data, ENC_FIT_STEPS, shape, "cpu")
    again = data.batches(np.random.default_rng(3))
    cpu_losses = np.array([float(cpu.step(next(again))) for _ in range(ENC_MATCH_STEPS)])
    rel = np.abs(losses[:ENC_MATCH_STEPS] - cpu_losses) / np.abs(cpu_losses)
    check(rel.max() <= 1e-4, f"encoder losses card == CPU within 1e-4 relative over "
          f"{ENC_MATCH_STEPS} steps ({rel.max():.3g})")
    check(losses[-20:].mean() < losses[:20].mean(), "the encoder loss falls on the card")
    # the written checkpoint through the port's hf provider on both devices
    with tempfile.TemporaryDirectory(prefix="yenc") as tmp:
        path = str(pathlib.Path(tmp) / "realtext_trained.npz")
        trainer.save(path, data.vocab)
        texts = list(ds.queries.values())[:64]
        card_v = HFProvider(path, compute_dtype="float32", device=dev).encode(texts)
        cpu_v = HFProvider(path, compute_dtype="float32", device="cpu").encode(texts)
    vec_err = float(np.abs(card_v - cpu_v).max())
    check(vec_err <= 1e-4, f"the trained checkpoint's vectors card == CPU within 1e-4 ({vec_err:.3g})")
    scratch = ter.make_trainer(data, ENC_FIT_STEPS, shape, dev)
    one = next(data.batches(np.random.default_rng(5)))
    per_step = launches_per_step(lambda k: [scratch.step(one) for _ in range(k)])
    b = encoder_step_bound(shape, sum(p.numel() for p in trainer.leaves), ter.B, ter.QT, ter.DT)
    step_ms, prep_ms = float(np.median(step) * 1e3), float(np.median(prep) * 1e3)
    log(f"[phase14 encoder] D {shape['dim']}, {shape['layers']} layers, {shape['heads']} heads, "
        f"FFN {shape['intermediate']}, vocabulary {len(data.vocab)}: loss "
        + ", ".join(f"{s}: {losses[s]:.4f}" for s in range(0, ENC_FIT_STEPS, 50))
        + f", {ENC_FIT_STEPS - 1}: {losses[-1]:.4f}; first {ENC_MATCH_STEPS} steps card vs CPU "
        f"relative max {rel.max():.3g}; step median {prep_ms:.3f} ms host batch prep + "
        f"{step_ms:.3f} ms device forward + backward + update; {per_step['device_ops']:.0f} "
        f"device ops a step; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
        f"{b['bound_ops'] / 1e9:.2f} GFLOP, {b['bound_bytes'] / 1e6:.1f} MB); checkpoint "
        f"vectors card vs CPU {vec_err:.3g}")
    return {"shape": shape, "vocab": len(data.vocab), "steps": ENC_FIT_STEPS,
            "loss": {str(s): float(losses[s]) for s in list(range(0, ENC_FIT_STEPS, 50))
                     + [ENC_FIT_STEPS - 1]},
            "cpu_rel_max": float(rel.max()), "prep_ms": prep_ms, "step_ms": step_ms,
            "launches": per_step, "vec_err": vec_err, **b}


def eval_summary(res: dict) -> dict:
    return {mode: {lvl: {k: round(r[lvl][k], 4) for k in ("mrr", "ndcg", "recall")}
                   for lvl in ("all", "file_level")} for mode, r in res.items()}


def phase14_retrieval(dev, ds, root) -> dict:
    """(d) eval_beir_scale.run_eval with the in-repo realtext_bert_d192: the
    whole stand-in root on the card (the provider's bf16, as served), then a
    cut of it on the card and on the CPU at f32 on the CSR leg, held equal."""
    from yams_tpu_torch.scripts import eval_beir_scale as ebs
    from yams_tpu_torch.scripts.realtext import realtext_beir

    modes = ("hybrid", ebs.COLBERT)
    t = time.perf_counter()
    full = ebs.run_eval("hf", modes=modes, quiet=True, ds=ds, device=dev)
    full_s = time.perf_counter() - t
    cut = realtext_beir(max_files=EVAL_CUT_FILES, root=root)
    runs, secs = {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t = time.perf_counter()
        runs[name] = ebs.run_eval("hf", modes=modes, quiet=True, ds=cut, device=device,
                                  compute_dtype="float32", packed_max_entries=0)
        secs[name] = time.perf_counter() - t
    differ = {}
    for mode in modes:
        a, b = runs["card"][mode], runs["cpu"][mode]
        for lvl in ("all", "file_level"):
            for k in ("mrr", "ndcg", "recall"):
                check(abs(a[lvl][k] - b[lvl][k]) <= 0.005,
                      f"{mode} {lvl} {k} card == CPU within 0.005 ({a[lvl][k]:.4f} vs "
                      f"{b[lvl][k]:.4f})")
        differ[mode] = [q for q in cut.queries if a["ranked"][q] != b["ranked"][q]]
        check(len(differ[mode]) <= 0.02 * len(cut.queries),
              f"{mode} top-10 card == CPU on >= 98% of queries ({len(differ[mode])} differ)")
        if differ[mode]:
            log(f"[phase14 retrieval] {mode}: top-10 differs card vs CPU on "
                + json.dumps([(q, cut.queries[q]) for q in differ[mode]]))
    out = {"full": eval_summary(full), "full_s": full_s, "chunks": len(ds.corpus),
           "queries": len(ds.queries), "cut_chunks": len(cut.corpus),
           "cut_queries": len(cut.queries), "cut_card": eval_summary(runs["card"]),
           "cut_cpu": eval_summary(runs["cpu"]), "cut_s": secs,
           "differ": {m: len(v) for m, v in differ.items()}}
    log(f"[phase14 retrieval] {len(ds.corpus)} chunks, {len(ds.queries)} queries, card bf16 "
        f"({full_s:.1f} s): " + json.dumps(out["full"]))
    log(f"[phase14 retrieval] cut of {EVAL_CUT_FILES} files ({len(cut.corpus)} chunks, "
        f"{len(cut.queries)} queries) at f32 on the CSR leg, card ({secs['card']:.1f} s) "
        f"vs CPU ({secs['cpu']:.1f} s): card {json.dumps(out['cut_card'])}; CPU "
        f"{json.dumps(out['cut_cpu'])}; top-10 differs on {out['differ']}")
    return out


def phase14_training(dev, card: str) -> dict:
    """Phase 14: (a) the stand-in root, (b) NER training, (c) encoder
    training at full width, (d) real-text retrieval."""
    import tempfile

    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="yrt") as tmp:
        root = phase14_root(tmp)
        for name, fn, args in (("ner", phase14_ner, (dev, root["root"])),
                               ("encoder", phase14_encoder, (dev, root["ds"])),
                               ("retrieval", phase14_retrieval, (dev, root["ds"], root["root"]))):
            t = time.perf_counter()
            out[name] = fn(*args)
            out[name + "_s"] = time.perf_counter() - t
            log(f"[phase14 {name}] {out[name + '_s']:.2f} s")
            torch.cuda.empty_cache()
        out["root"] = {k: v for k, v in root.items() if k not in ("ds", "root")}
    return out


def phase14_ops(training: dict) -> list:
    """Phase 14's device work: a training step of each trainer, its time,
    launches and bound."""
    ner, enc = training["ner"], training["encoder"]
    return [{"name": "ner_fit_step", "steps_on_path": 2 * ner["steps"], "ms": ner["step_ms"],
             "cpu_ms": ner["cpu_step_ms"], "device_ops_per_step": ner["launches"]["device_ops"],
             "bound_ms": ner["bound_ms"], "bound_by": ner["bound_by"]},
            {"name": "encoder_fit_step", "steps_on_path": enc["steps"], "ms": enc["step_ms"],
             "host_prep_ms": enc["prep_ms"], "device_ops_per_step": enc["launches"]["device_ops"],
             "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
             "bound_gflop": enc["bound_ops"] / 1e9, "bound_mb": enc["bound_bytes"] / 1e6}]


# -- phase 15 -----------------------------------------------------------------
def mesh_of(dev, shape: tuple, names: tuple):
    """A mesh of prod(shape) shards: one card each when that many are
    visible, else every shard on `dev` (a virtual mesh). -> (mesh, real)."""
    from yams_tpu_torch.parallel.mesh import Mesh, virtual_mesh

    n = int(np.prod(shape))
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        grid = np.empty(n, dtype=object)
        for i in range(n):
            grid[i] = torch.device("cuda", i)
        return Mesh(grid.reshape(shape), names), True
    return virtual_mesh(shape, names, dev), False


def clustered_int8(dev, gen, N: int, D: int = 768, block: int = 1 << 18):
    """clustered_corpus's rows made a block at a time and quantized on the
    card as they are made (no bf16 copy of the whole corpus, no host
    mirror): (int8 (N, D), f32 row scales (N,))."""
    from yams_tpu_torch.ops.scan import quantize_rows

    centers = torch.randn(4096, D, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True).clamp_min(1e-9)
    E8 = torch.empty(N, D, dtype=torch.int8, device=dev)
    scale = torch.empty(N, dtype=torch.float32, device=dev)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        ar = torch.arange(lo, hi, device=dev, dtype=torch.int64)
        assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % 4096
        noise = torch.randn(hi - lo, D, generator=gen, device=dev, dtype=torch.bfloat16)
        e = (centers[assign].to(torch.bfloat16) + 0.35 * noise).float()
        e = (e / e.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)
        E8[lo:hi], scale[lo:hi] = quantize_rows(e.float())
    return E8, scale


def sharded_split(mesh, axis, args, kw, int8: bool) -> dict:
    """Device ms of one sharded_hybrid_query and of its stages: the local
    scans of every shard, the hierarchical merge with the slot dedup, and
    the rest (the embed once, the lexical leg and the fusion)."""
    from yams_tpu_torch.parallel.sharded_hybrid import (embed_queries, local_candidates,
                                                        merge_candidates, sharded_hybrid_query)

    (sk, tid, tm, proj, E, rv, r2s, rs, pd, pi, to, tl, dm, hot, w) = args
    C, Nd = kw["rrf_cand"], kw["num_slots"]
    q, qs = embed_queries(sk, proj, int8)
    cands = local_candidates(mesh, q, qs, E, rv, r2s, rs, dm, None, C=C, num_slots=Nd,
                             int8_corpus=int8, axis=axis)
    out = {"total_ms": cuda_ms(lambda: sharded_hybrid_query(
        mesh, *args, int8_corpus=int8, axis=axis, **kw), 3)}
    out["local_ms"] = cuda_ms(lambda: local_candidates(
        mesh, q, qs, E, rv, r2s, rs, dm, None, C=C, num_slots=Nd, int8_corpus=int8,
        axis=axis), 3)
    out["merge_ms"] = cuda_ms(lambda: merge_candidates(mesh, cands, C=C, num_slots=Nd,
                                                       axis=axis), 5)
    out["rest_ms"] = out["total_ms"] - out["local_ms"] - out["merge_ms"]
    out["merge_share"] = out["merge_ms"] / out["total_ms"]
    return out


def phase15_hybrid(what: str, mesh, axis, args, kw, int8: bool, B: int) -> dict:
    """sharded_hybrid_query against the single-device hybrid_query on the
    same arrays: the reference's gate (values within 2e-3 at every rank,
    top-10 id overlap >= 0.9), every differing id a near-tie (1e-4), both
    timed, the sharded call split."""
    from yams_tpu_torch.parallel.sharded_hybrid import sharded_hybrid_query
    from yams_tpu_torch.search.fusion import hybrid_query

    hv, hs, _, _ = sharded_hybrid_query(mesh, *args, int8_corpus=int8, axis=axis, **kw)
    sv, ss, _, _ = hybrid_query(*args, int8_corpus=int8, rows_are_docs=True, **kw)
    err, differ = fused_agree(what, hv, hs, sv, ss, tol=2e-3, tie=1e-4)
    overlap = top10_ids_overlap(hs, ss)
    check(overlap >= 0.9, f"{what}: top-10 id overlap {overlap:.4f} >= 0.9")
    out = {"max_err": err, "ids_differ": differ, "id_overlap": overlap,
           "single_ms": cuda_ms(lambda: hybrid_query(*args, int8_corpus=int8,
                                                     rows_are_docs=True, **kw), 3),
           **sharded_split(mesh, axis, args, kw, int8)}
    log(f"[phase15] {what} on {mesh!r}: values within {err:.3g} of the single-device "
        f"program, {differ} of {hs.numel()} ids differ (near-ties within 1e-4), overlap "
        f"{overlap:.4f}; single {out['single_ms']:.2f} ms, sharded {out['total_ms']:.2f} ms "
        f"(local scans {out['local_ms']:.2f}, merge {out['merge_ms']:.3f} = "
        f"{100 * out['merge_share']:.1f}%, embed + lexical + fusion {out['rest_ms']:.2f}) "
        f"at B {B}")
    return out


def top10_ids_overlap(a, b) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / a.shape[1] for x, y in zip(a, b)]))


def phase15_topk(what: str, mesh, sharded, single, k: int, rows_local: int) -> dict:
    """A sharded scan against its single-device scan on the same arrays
    (values within 1e-5, differing ids near-ties), both timed, and the
    merge's own time on lists of the same shapes."""
    from yams_tpu_torch.parallel.sharded_scan import _merge_topk

    hv, hi = sharded()
    sv, si = single()
    err, differ = fused_agree(what, hv, hi, sv, si, tol=1e-5, tie=1e-4)
    S = mesh.size
    out = {"max_err": err, "ids_differ": differ, "single_ms": cuda_ms(single, 3),
           "total_ms": cuda_ms(sharded, 3),
           "merge_ms": cuda_ms(lambda: _merge_topk([hv] * S, [hi] * S, k=k,
                                                   rows_local=rows_local,
                                                   device=mesh.lead), 5)}
    out["local_ms"] = out["total_ms"] - out["merge_ms"]
    log(f"[phase15] {what} over {S} shards: values within {err:.3g} of the single-device "
        f"scan, {differ} ids differ; single {out['single_ms']:.2f} ms, sharded "
        f"{out['total_ms']:.2f} ms (merge {out['merge_ms']:.3f} ms)")
    return out


def phase15_programs(dev, N8: int = 10_485_760, N16: int = 1 << 22, NPQ: int = 1 << 20,
                     D: int = 768, B: int = 64, V: int = 65536, WIN: int = 1024) -> dict:
    """(a) The sharded programs at config 4's width: the int8 corpus of
    10,485,760 x 768 (8.05 GB with its scales) made on the card in blocks,
    phase 4's packed postings, rows_are_docs, B 64, C 32, k 10, over eight
    shards (eight cards, or a virtual mesh on one); then phase 8's bf16
    corpus of 4,194,304 rows on the 1-D mesh of 2, 4 and 8 shards and on
    the 2 x 4 ("dcn", "ici") mesh; sharded_topk, sharded_int8_topk and
    sharded_pq_topk (PQ4 codes, group 1 and 64) against their scans."""
    from yams_tpu_torch.ops.pq import pq4_pack, pq_adc_topk, pq_encode, pq_train
    from yams_tpu_torch.ops.scan import exact_topk_scan, int8_topk_scan
    from yams_tpu_torch.parallel.sharded_scan import (sharded_int8_topk, sharded_pq_topk,
                                                      sharded_topk)
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.search.fusion import pack_weights

    S, T, K, C = 4096, 16, 10, 32
    out: dict = {"batch": B, "rrf_cand": C, "k": K}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    mesh8, real = mesh_of(dev, (8,), ("d",))
    out["mesh"] = {"shards": 8, "real_cards": real}
    proj = torch.where(torch.rand(S, D, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    proj = (proj / np.sqrt(D)).to(torch.bfloat16)
    sk = torch.randn(B, S, generator=gen, device=dev)
    tid = torch.randint(0, V, (B, T), generator=gen, device=dev, dtype=torch.int32)
    tm = torch.ones(B, T, device=dev)
    w = torch.from_numpy(pack_weights(SearchEngineConfig())).to(dev)
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(k=K, rrf_cand=C, window=WIN, packed_lexical=True, bm25_prefilter=256)

    def problem(N, E, scale):
        packed, pscale = packed_postings(dev, N, V, WIN)
        ones = torch.ones(N, device=dev)
        return ((sk, tid, tm, proj, E, ones, torch.arange(N, device=dev, dtype=torch.int32),
                 scale if scale is not None else ones, packed, pscale, dummy, dummy, ones,
                 torch.zeros(N, device=dev), w), dict(kw, num_slots=N))

    # the int8 corpus at config 4's width
    t = time.perf_counter()
    E8, scale8 = clustered_int8(dev, gen, N8, D)
    args, kwn = problem(N8, E8, scale8)
    sync_dev(dev)
    out["int8_build_s"] = time.perf_counter() - t
    out["int8_bytes"] = E8.nbytes + scale8.nbytes
    log(f"[phase15] int8 corpus {N8}x{D} with row scales ({out['int8_bytes'] / 1e9:.2f} GB), "
        f"made on the card in {out['int8_build_s']:.2f} s; mesh of 8 shards "
        f"({'eight cards' if real else 'virtual, on one card'})")
    out["int8_hybrid"] = phase15_hybrid("int8 sharded_hybrid_query", mesh8, "d", args, kwn,
                                        True, B)
    q = torch.nn.functional.normalize(sk @ proj.float(), dim=1)
    out["int8_topk"] = phase15_topk(
        "sharded_int8_topk", mesh8,
        lambda: sharded_int8_topk(mesh8, q, E8, scale8, args[5], K, block_rows=4096),
        lambda: int8_topk_scan(q, E8, scale8, args[5], K, block_rows=4096), K, N8 // 8)
    del E8, scale8, args
    empty_cache(dev)

    # the bf16 corpus: the 1-D mesh of 2, 4 and 8 shards, and 2 x 4
    t = time.perf_counter()
    E16 = clustered_corpus(dev, gen, N16, D)
    args, kwn = problem(N16, E16, None)
    sync_dev(dev)
    log(f"[phase15] bf16 corpus {N16}x{D} ({E16.nbytes / 1e9:.2f} GB) built in "
        f"{time.perf_counter() - t:.2f} s")
    out["bf16_hybrid"] = {}
    for shape, names in (((2,), ("d",)), ((4,), ("d",)), ((8,), ("d",)),
                         ((2, 4), ("dcn", "ici"))):
        mesh, _ = mesh_of(dev, shape, names)
        axis = names if len(names) > 1 else names[0]
        key = "x".join(map(str, shape))
        out["bf16_hybrid"][key] = phase15_hybrid(f"bf16 sharded_hybrid_query {key}", mesh,
                                                 axis, args, kwn, False, B)
    out["bf16_topk"] = phase15_topk(
        "sharded_topk", mesh8,
        lambda: sharded_topk(mesh8, q, E16, args[5], K, block_rows=4096),
        lambda: exact_topk_scan(q, E16, args[5], K, block_rows=4096), K, N16 // 8)
    del E16, args
    empty_cache(dev)

    # PQ4 codes of a clustered corpus (phase 5's m 48, ksub 16, packed)
    t = time.perf_counter()
    Epq = clustered_corpus(dev, gen, NPQ, D)
    sample = Epq[torch.randperm(NPQ, generator=gen, device=dev)[:65_536]].float().cpu().numpy()
    cb = pq_train(sample, m=48, ksub=16, train_limit=65_536, device=dev)
    codes = torch.cat([pq_encode(cb, Epq[lo:lo + (1 << 18)].float())
                       for lo in range(0, NPQ, 1 << 18)])
    packed4 = torch.from_numpy(pq4_pack(codes.cpu().numpy())).to(dev)
    qpq = Epq[:B].float()
    del Epq, codes
    valid = torch.ones(NPQ, device=dev)
    log(f"[phase15] PQ4 codes of {NPQ}x{D} (m 48, ksub 16, packed: "
        f"{packed4.nbytes / 1e6:.1f} MB) in {time.perf_counter() - t:.2f} s")
    out["pq4_topk"] = {}
    for group in (1, 64):
        out["pq4_topk"][f"group{group}"] = phase15_topk(
            f"sharded_pq_topk group {group}", mesh8,
            lambda g=group: sharded_pq_topk(mesh8, qpq, packed4, cb.centroids, valid, K,
                                            packed4=True, group=g),
            lambda g=group: pq_adc_topk(qpq, packed4, cb.centroids, valid, K,
                                        packed4=True, group=g), K, NPQ // 8)
    return out


def sync_dev(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def empty_cache(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase15_engine(dev, eng, queries, n_shards: int = 4) -> tuple[dict, tuple]:
    """(b) Phase 3's card engine armed over a 4-shard mesh against itself
    unarmed (topology off for both): sharded_devices in the trace, the same
    top-10 but near-ties within the reference's engine gate (2e-2); then
    64 documents added and 8 deleted, searchable at once, with the bytes
    re-placed; the PQ tier and chunk_agg "sum" serve on one device."""
    cfg = eng.config
    saved = (cfg.topology_policy, cfg.chunk_agg, cfg.pq_tier_enabled)
    mesh, real = mesh_of(dev, (n_shards,), ("d",))
    out: dict = {"shards": n_shards, "real_cards": real,
                 "rows": eng.vector_index.active_rows,
                 "capacity": eng.vector_index.capacity}
    try:
        cfg.topology_policy = "off"
        _, single_s, want = timed_search(dev, eng, queries)
        check(eng.last_trace.get("sharded_devices") is None, "unarmed: one device")
        check(eng.enable_sharding(mesh), "enable_sharding arms the mesh")
        vi = eng.vector_index
        up0 = vi.upload_bytes_total
        first_s, sharded_s, got = timed_search(dev, eng, queries)
        out["placed_bytes"] = vi.upload_bytes_total - up0
        check(eng.last_trace.get("sharded_devices") == n_shards,
              f"trace names {n_shards} shards ({eng.last_trace.get('sharded_devices')})")
        out["vs_unarmed"] = results_agree("sharded engine against itself unarmed", got, want,
                                          atol=2e-2)
        out["top10_overlap"] = top10_overlap(got, want)
        out.update(single_ms=single_s * 1e3, sharded_first_ms=first_s * 1e3,
                   sharded_ms=sharded_s * 1e3)
        log(f"[phase15] engine ({out['rows']} rows, capacity {out['capacity']}) over "
            f"{n_shards} shards ({'cards' if real else 'virtual'}): search_batch(64) "
            f"{out['sharded_ms']:.1f} ms (first {out['sharded_first_ms']:.1f} ms, placing "
            f"{out['placed_bytes'] / 1e6:.1f} MB) against {out['single_ms']:.1f} ms unarmed; "
            f"top-10 overlap {out['top10_overlap']:.4f}, {json.dumps(out['vs_unarmed'])}")

        # mutations: searchable at once, the whole corpus re-placed
        base = 900_000
        new = [(base + i, f"zq{i}x unique{i}marker sharded scaleout note {i}", f"zq{i}x")
               for i in range(64)]
        eng.add_documents(new)
        for doc_id, *_ in new[:8]:
            eng.remove_document(doc_id)
        up1 = vi.upload_bytes_total
        res = eng.search_batch([f"zq{i}x unique{i}marker" for i in range(64)])
        out["replaced_bytes"] = vi.upload_bytes_total - up1
        check(eng.last_trace.get("sharded_devices") == n_shards, "mutated: still sharded")
        hit = [bool(res[i]) and res[i][0].doc_id == base + i for i in range(8, 64)]
        gone = {base + i for i in range(8)}
        check(all(hit), f"the 56 kept new docs rank first ({sum(hit)})")
        check(not any(x.doc_id in gone for r in res for x in r), "no deleted doc returned")
        log(f"[phase15] 64 documents added and 8 deleted: each kept one first for its own "
            f"words, none deleted returned; {out['replaced_bytes'] / 1e6:.1f} MB re-placed")
        arrays = vi.sharded_device_arrays(mesh, "d")

        # features the sharded program cannot express serve on one device
        cfg.chunk_agg = "sum"
        eng.search_batch(queries[:8])
        check("sharded_devices" not in eng.last_trace, "chunk_agg sum: one device")
        cfg.chunk_agg = "max"
        eng.vector_index.build_pq(m=32, ksub=16, pack4=True, group=64)
        cfg.pq_tier_enabled = True
        eng.search_batch(queries[:8])
        check("sharded_devices" not in eng.last_trace, "the PQ tier: one device")
        log("[phase15] chunk_agg='sum' and the PQ tier served on one device (no "
            "sharded_devices in the trace)")
        return out, arrays
    finally:
        cfg.topology_policy, cfg.chunk_agg, cfg.pq_tier_enabled = saved
        eng._shard_mesh = None


def phase15_app(dev) -> dict:
    """(c) AppContext arming: over every card with "auto" when more than
    one is visible; on one card "auto" stays on it and "on" raises the
    reference's error."""
    import tempfile

    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.parallel.mesh import visible_devices
    from yams_tpu_torch.services.app import AppContext

    n = len(visible_devices(dev))
    old = os.environ.get("YAMS_VECTOR_SHARDED")
    out = {"visible": n}
    try:
        with tempfile.TemporaryDirectory() as td:
            os.environ["YAMS_VECTOR_SHARDED"] = "auto"
            app = AppContext(load_config(data_dir=pathlib.Path(td) / "a"), device=dev)
            try:
                out["auto_armed"] = app.sharded
                mesh = app.search_engine._shard_mesh
                check(app.sharded == (n > 1) and (mesh is None or mesh.size == n),
                      f"'auto' arms over all {n} devices only when more than one")
            finally:
                app.close()
            os.environ["YAMS_VECTOR_SHARDED"] = "on"
            try:
                app = AppContext(load_config(data_dir=pathlib.Path(td) / "b"), device=dev)
            except RuntimeError as e:
                check(n == 1 and "only one device is visible" in str(e), f"'on' raised {e}")
                out["on_raised"] = str(e)
            else:
                check(n > 1 and app.sharded, "'on' armed")
                app.close()
    finally:
        if old is None:
            os.environ.pop("YAMS_VECTOR_SHARDED", None)
        else:
            os.environ["YAMS_VECTOR_SHARDED"] = old
    log(f"[phase15] AppContext with {n} visible device(s): 'auto' armed {out['auto_armed']}; "
        f"'on' {'raised: ' + out['on_raised'] if 'on_raised' in out else 'armed'}")
    return out


def phase15_checkpoint(dev, arrays) -> dict:
    """(d) (b)'s sharded arrays saved at epoch 3 over 4 shards, restored
    onto 2 and 8 shards and one device, each bit-equal; min_epoch 4
    raises. Save and restore MB/s."""
    import tempfile

    from yams_tpu_torch.index.checkpoint import restore_sharded, save_sharded, sharded_template

    names = ("E", "valid", "row2slot", "row_scale")
    tree = dict(zip(names, arrays))
    whole = {k: torch.cat([p.to(dev) for p in v]) for k, v in tree.items()}
    nbytes = sum(t.nbytes for t in whole.values())
    out: dict = {"bytes": nbytes}
    with tempfile.TemporaryDirectory() as td:
        sync_dev(dev)
        t = time.perf_counter()
        save_sharded(td, tree, epoch=3)
        out["save_MBps"] = nbytes / 1e6 / (time.perf_counter() - t)
        out["restore_MBps"] = {}
        for label, shape in (("2 shards", (2,)), ("8 shards", (8,)), ("one device", None)):
            mesh = mesh_of(dev, shape or (1,), ("d",))[0]
            spec = ("d",) if shape else (None,)
            tpl = {k: sharded_template(v, mesh, spec + (None,) * (v.dim() - 1))
                   for k, v in whole.items()}
            t = time.perf_counter()
            got, epoch = restore_sharded(td, tpl, min_epoch=3)
            sync_dev(dev)
            out["restore_MBps"][label] = nbytes / 1e6 / (time.perf_counter() - t)
            for k, v in got.items():
                back = torch.cat(v) if isinstance(v, list) else v
                check(epoch == 3 and torch.equal(back.to(dev), whole[k]),
                      f"{k} restored onto {label} bit-equal")
        try:
            restore_sharded(td, {}, min_epoch=4)
        except ValueError as e:
            check("stale" in str(e), f"min_epoch 4 raised {e}")
        else:
            check(False, "min_epoch 4 raised")
    log(f"[phase15] checkpoint of {nbytes / 1e6:.1f} MB over 4 shards: save "
        f"{out['save_MBps']:.0f} MB/s; restore " + ", ".join(
            f"{k} {v:.0f} MB/s" for k, v in out["restore_MBps"].items())
        + "; every restore bit-equal; min_epoch 4 refused")
    return out


def phase15_scale_out(dev, card: str, eng, queries) -> dict:
    from yams_tpu_torch.scripts.dryrun_multichip import dryrun_multichip

    log(f"[phase15] {card}")
    out = {"programs": phase15_programs(dev)}
    empty_cache(dev)
    out["engine"], arrays = phase15_engine(dev, eng, queries)
    out["app"] = phase15_app(dev)
    out["checkpoint"] = phase15_checkpoint(dev, arrays)
    del arrays
    t = time.perf_counter()
    out["dryrun"] = dryrun_multichip(8, dev)
    out["dryrun"]["seconds"] = time.perf_counter() - t
    return out


# -- phase 16 -----------------------------------------------------------------
ABI_HOST_C = r"""
/* A C host of the port's mobile ABI: the typed surface against a daemon. */
#include <stdio.h>
#include <string.h>
#include "yams_mobile.h"

static void emit(const char* tag, yams_mobile_string_view v) {
    printf("%s %.*s\n", tag, (int)v.length, v.data ? v.data : "");
}

int main(int argc, char** argv) {
    if (argc != 5) return 64;
    const char *sock = argv[1], *path = argv[2], *query = argv[3], *pattern = argv[4];
    yams_mobile_context_config cfg = yams_mobile_context_config_default();
    cfg.backend_mode = YAMS_MOBILE_BACKEND_DAEMON;
    cfg.daemon_socket_path = sock;
    yams_mobile_context_t* ctx = NULL;
    if (yams_mobile_context_create(&cfg, &ctx) != YAMS_MOBILE_STATUS_OK) {
        fprintf(stderr, "context_create: %s\n", yams_mobile_last_error_message());
        return 2;
    }
    void* h = yams_mobile_connect(sock);
    char* added = yams_mobile_add_text(
        h, "abi/host_note.txt",
        "the C host stores notes about tensor kernels and socket frames");
    printf("add_text %s\n", added ? added : "");
    yams_mobile_free(added);
    yams_mobile_disconnect(h);

    yams_mobile_document_store_request sreq;
    memset(&sreq, 0, sizeof sreq);
    sreq.header = yams_mobile_request_header_default();
    sreq.path = path;
    yams_mobile_string_view hash = {0};
    if (yams_mobile_store_document(ctx, &sreq, &hash) != YAMS_MOBILE_STATUS_OK) {
        fprintf(stderr, "store_document: %s\n", yams_mobile_last_error_message());
        return 3;
    }
    emit("store", hash);

    yams_mobile_search_request q;
    memset(&q, 0, sizeof q);
    q.header = yams_mobile_request_header_default();
    q.query = query;
    q.limit = 10;
    yams_mobile_search_result_t* sr = NULL;
    if (yams_mobile_search_execute(ctx, &q, &sr) != YAMS_MOBILE_STATUS_OK) return 4;
    emit("search", yams_mobile_search_result_json(sr));
    yams_mobile_search_result_destroy(sr);

    yams_mobile_grep_request g;
    memset(&g, 0, sizeof g);
    g.header = yams_mobile_request_header_default();
    g.pattern = pattern;
    g.max_matches = 10;
    yams_mobile_grep_result_t* gr = NULL;
    if (yams_mobile_grep_execute(ctx, &g, &gr) != YAMS_MOBILE_STATUS_OK) return 5;
    emit("grep", yams_mobile_grep_result_json(gr));
    yams_mobile_grep_result_destroy(gr);

    yams_mobile_document_get_request dreq;
    memset(&dreq, 0, sizeof dreq);
    dreq.header = yams_mobile_request_header_default();
    dreq.document_hash = hash.data;
    yams_mobile_document_get_result_t* dr = NULL;
    if (yams_mobile_get_document(ctx, &dreq, &dr) != YAMS_MOBILE_STATUS_OK) return 6;
    emit("get_document", yams_mobile_document_get_result_json(dr));
    yams_mobile_document_get_result_destroy(dr);
    yams_mobile_string_view_destroy(&hash);

    yams_mobile_string_view report = {0};
    if (yams_mobile_doctor(ctx, &report) != YAMS_MOBILE_STATUS_OK) return 7;
    emit("doctor", report);
    yams_mobile_doctor_result_destroy(&report);
    yams_mobile_context_destroy(ctx);
    return 0;
}
"""


def phase16_abi(dev, root: pathlib.Path) -> dict:
    """(a) A C host compiled with gcc against the port's yams_mobile.h and
    linked to its mobile library drives a daemon on the card in this
    process: add_text, store_document of a 48 MiB blob (K5 and SHA-256 on
    the card), search, grep, get_document, doctor."""
    from yams_tpu_torch import native
    from yams_tpu_torch.core.config import load_config
    from yams_tpu_torch.ops import cdc, sha256

    out: dict = {}
    t = time.perf_counter()
    lib = native.mobile_library()          # builds, or raises: no Python route
    lib_path = pathlib.Path(lib._name)
    include = pathlib.Path(native.__file__).parent / "include"
    (root / "host.c").write_text(ABI_HOST_C)
    subprocess.run(["gcc", "-O1", "-std=c11", f"-I{include}", str(root / "host.c"),
                    str(lib_path), f"-Wl,-rpath,{lib_path.parent}", "-o", str(root / "host")],
                   check=True, capture_output=True, text=True, timeout=120)
    out["build_s"] = time.perf_counter() - t
    blob = np.random.default_rng(SEED + 16).bytes(48 << 20)
    (root / "blob.bin").write_bytes(blob)
    cfg = load_config(data_dir=root / "data")
    cfg.daemon.socket_path = str(root / "d.sock")
    d = ThreadDaemon(cfg, dev)
    try:
        g0, s0 = cdc.gear_hash_cuda.launches, sha256.sha256_cuda.launches
        t = time.perf_counter()
        proc = subprocess.run([str(root / "host"), str(cfg.socket_path), str(root / "blob.bin"),
                               "tensor kernels socket", "socket frames"],
                              capture_output=True, text=True, timeout=300)
        out["host_s"] = time.perf_counter() - t
        check(proc.returncode == 0, f"the C host ran ({proc.returncode}: {proc.stderr[-500:]})")
        got = {}
        for line in proc.stdout.splitlines():
            tag, _, body = line.partition(" ")
            got[tag] = body
        gear, sha = cdc.gear_hash_cuda.launches - g0, sha256.sha256_cuda.launches - s0
        check(gear >= 1 and sha >= 1,
              f"the C host's 48 MiB store launched gear_hash_cuda ({gear}) and sha256_cuda ({sha})")
        digest = hashlib.sha256(blob).hexdigest()
        check(got["store"] == digest, "store_document returned the blob's SHA-256")
        check(json.loads(got["add_text"])["result"]["indexed"], "add_text indexed the note")
        hits = json.loads(got["search"])["result"]["hits"]
        want = d.client.search("tensor kernels socket", limit=10)["hits"]
        check(bool(hits) and hits[0]["name"] == "host_note.txt",
              f"the C host's search finds the note ({[h['name'] for h in hits]})")
        check([(h["document_id"], h["path"], h["score"]) for h in hits]
              == [(h["document_id"], h["path"], h["score"]) for h in want],
              "the C host's search hits equal the daemon's search from Python")
        grep = json.loads(got["grep"])["result"]
        check(grep["files_matched"] == 1, f"grep found the note ({grep['files_matched']})")
        doc = json.loads(got["get_document"])["result"]
        check(doc["sha256_hash"] == digest and doc["file_size"] == len(blob),
              "get_document describes the blob")
        doctor = json.loads(got["doctor"])["result"]
        check(doctor["device"][1].startswith(str(dev)) and all(v[0] for v in doctor.values()),
              f"doctor is green on {dev} ({doctor})")
        check(d.client.cat(str(root / "blob.bin")) == blob, "the stored blob reads back")
        out.update({"gear_hash_launches": gear, "sha256_launches": sha,
                    "hits": len(hits), "doctor_device": doctor["device"][1]})
    finally:
        d.stop()
    log(f"[phase16] C host: built in {out['build_s']:.2f} s, ran in {out['host_s']:.2f} s; "
        f"48 MiB store launched gear_hash_cuda {out['gear_hash_launches']}, sha256_cuda "
        f"{out['sha256_launches']}; {out['hits']} hits equal to Python's")
    return out


def phase16_embedded(dev, root: pathlib.Path) -> dict:
    """(b) BACKEND_EMBEDDED over a fresh directory: the library spawns the
    port's daemon (python3 -m yams_tpu_torch.cli.main ... daemon start, its
    device from $YAMS_TPU_DEVICE, unset here on a card so that the CLI's
    default, cuda, serves) and its status and doctor report the card."""
    from yams_tpu_torch import native
    from yams_tpu_torch.daemon.client import DaemonClient
    from yams_tpu_torch.native import mobile_abi as abi

    lib = native.mobile_library()
    wd = root / "embedded"
    wd.mkdir()
    env_dev = os.environ.pop("YAMS_TPU_DEVICE", None)
    if dev.type != "cuda":
        os.environ["YAMS_TPU_DEVICE"] = str(dev)     # a dry run on the host
    cfg = lib.yams_mobile_context_config_default()
    cfg.working_directory = str(wd).encode()
    ctx = ctypes.c_void_p()
    t = time.perf_counter()
    try:
        rc = lib.yams_mobile_context_create(ctypes.byref(cfg), ctypes.byref(ctx))
        spawn_s = time.perf_counter() - t
        check(rc == 0, f"embedded context_create ({lib.yams_mobile_last_error_message()})")
        res = ctypes.c_void_p()
        check(lib.yams_mobile_status_execute(ctx.value, 0, ctypes.byref(res)) == 0,
              "status through the embedded context")
        status = json.loads(lib.yams_mobile_status_result_json(res).text())["result"]
        lib.yams_mobile_status_result_destroy(res)
        report = abi.StringView()
        check(lib.yams_mobile_doctor(ctx.value, ctypes.byref(report)) == 0, "doctor (embedded)")
        doctor = json.loads(report.text())["result"]
        lib.yams_mobile_doctor_result_destroy(ctypes.byref(report))
        lib.yams_mobile_context_destroy(ctx.value)
        check(status["backend"] == "torch" and status["device"].startswith(dev.type),
              f"the embedded daemon is the port's on {dev.type} ({status.get('device')})")
        check(doctor["device"][0] and doctor["device"][1].startswith(dev.type),
              f"the embedded daemon's doctor names {dev.type} ({doctor['device']})")
        check(status["data_dir"] == str(wd), "the embedded daemon serves the working directory")
    finally:
        os.environ.pop("YAMS_TPU_DEVICE", None)
        if env_dev is not None:
            os.environ["YAMS_TPU_DEVICE"] = env_dev
        try:
            DaemonClient(wd / "daemon.sock").shutdown()
        except Exception:       # noqa: BLE001  (gone already; the pid wait below decides)
            pass
        pid_file = wd / "daemon.pid"
        if pid_file.exists():
            pid = int(pid_file.read_text())
            for _ in range(300):
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, 9)
                check(False, "the embedded daemon stopped on shutdown")
    log(f"[phase16] embedded: daemon spawned and answering in {spawn_s:.2f} s on "
        f"{status['device']}")
    return {"spawn_s": spawn_s, "device": status["device"]}


class quiet:
    """Collect a script's stdout (its lines go to the log in one piece,
    under the phase's tag)."""

    def __init__(self, tag: str = "phase16"):
        self.tag = tag

    def __enter__(self):
        import contextlib
        import io

        self.buf = io.StringIO()
        self.cm = contextlib.redirect_stdout(self.buf)
        self.cm.__enter__()
        return self

    def __exit__(self, *exc):
        self.cm.__exit__(*exc)
        for line in self.buf.getvalue().splitlines():
            log(f"[{self.tag}]   {line}")
        return False


def phase16_scripts(dev, n_docs: int = 1000, ingest_mb: float = 64, pq_rows: int = 1 << 20,
                    encode_docs: int = 4096, legs_env: dict | None = None) -> dict:
    """(c) The measurement scripts at small arguments, on the card:
    bench_ipc_ceiling (16 and 64 clients), bench_daemon (n_docs, 1 and 16
    clients, a quarter filtered), bench_ingest_device (ingest_mb), bench_pq
    (pq_rows, both routes), profile_legs (the bench shape, 2 batches; or
    legs_env) and bench_encode (encode_docs)."""
    from yams_tpu_torch.ops import cdc, pq_pallas, sha256
    from yams_tpu_torch.scripts import (bench_daemon, bench_encode, bench_ingest_device,
                                        bench_ipc_ceiling, bench_pq, profile_legs)

    out: dict = {}
    seconds: dict = {}

    def run(name, fn):
        t = time.perf_counter()
        with quiet():
            r = fn()
        seconds[name] = time.perf_counter() - t
        return r

    ipc = run("bench_ipc_ceiling", lambda: bench_ipc_ceiling.main(
        ["16,64", "2000", "--device", str(dev)]))
    check(all(r["errors"] == 0 and r["qps"] > 0 for r in ipc), f"ping ceiling ({ipc})")
    out["ipc"] = ipc
    sweep = run("bench_daemon", lambda: bench_daemon.main(
        [str(n_docs), "40", "1,16", "0.25", "--device", str(dev)]))
    check(sweep[0]["docs"] == n_docs and all(r["errors"] == 0 for r in sweep[1:]),
          f"the daemon sweep served every request ({sweep})")
    out["daemon"] = sweep
    g0, s0 = cdc.gear_hash_cuda.launches, sha256.sha256_cuda.launches
    ingest = run("bench_ingest_device", lambda: bench_ingest_device.main(
        [str(ingest_mb), "--device", str(dev)]))
    gear, sha = cdc.gear_hash_cuda.launches - g0, sha256.sha256_cuda.launches - s0
    check(gear >= 1 and sha >= 1,
          f"bench_ingest_device launched gear_hash_cuda ({gear}) and sha256_cuda ({sha})")
    check(ingest[-1]["matches_host"], "the end-to-end chunks and digests equal the host's")
    out["ingest_device"] = ingest
    pq = {}
    for impl in ("pallas", "xla"):
        os.environ["PQ_IMPL"] = impl
        k0 = pq_pallas.pq4_adc_cuda.launches
        try:
            pq[impl] = run(f"bench_pq_{impl}", lambda: bench_pq.main(
                [str(pq_rows), "--device", str(dev)]))
        finally:
            os.environ.pop("PQ_IMPL", None)
        pq[impl]["pq4_adc_launches"] = pq_pallas.pq4_adc_cuda.launches - k0
    check(pq["pallas"]["pq4_adc_launches"] >= 1 and pq["xla"]["pq4_adc_launches"] == 0,
          f"bench_pq launched pq4_adc_cuda on its pallas route only "
          f"({pq['pallas']['pq4_adc_launches']}, {pq['xla']['pq4_adc_launches']})")
    gap = abs(pq["pallas"]["recall10_planted"] - pq["xla"]["recall10_planted"])
    check(gap <= 0.01 and pq["pallas"]["recall10_planted"] >= 0.9,
          f"bench_pq's K4 recall@10 {pq['pallas']['recall10_planted']} within 0.01 of the "
          f"plain ADC's {pq['xla']['recall10_planted']}")
    out["pq"] = pq
    env = {"BENCH_ITERS": "2", **(legs_env or {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        legs = run("profile_legs", lambda: profile_legs.main(["--device", str(dev)]))
    finally:
        for k, v in saved.items():
            os.environ.pop(k)
            if v is not None:
                os.environ[k] = v
    check(list(legs) == ["vec_matmul", "vec_approx_exact", "vec_exact_topk", "bm25", "full"]
          and all(v > 0 for v in legs.values()), f"profile_legs timed its legs ({legs})")
    out["legs_ms"] = legs
    enc = run("bench_encode", lambda: bench_encode.main(
        ["--docs", str(encode_docs), "--device", str(dev)]))
    emb = enc.pop("embeddings")
    check(emb.shape == (encode_docs, 384) and np.allclose(np.linalg.norm(emb, axis=1), 1, atol=1e-3),
          "bench_encode's embeddings are unit rows")
    out["encode"] = enc
    out["seconds"] = seconds
    return out


def phase16_abi_scripts(dev, card: str) -> dict:
    """Phase 16: the mobile C ABI on the card (a C host, embedded mode) and
    the measurement scripts at small arguments."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="y16") as tmp:
        root = pathlib.Path(tmp)
        out = {"card": card, "abi": phase16_abi(dev, root),
               "embedded": phase16_embedded(dev, root)}
    out["scripts"] = phase16_scripts(dev)
    return out


# -- phase 17 -----------------------------------------------------------------
PHASE17_RUNS = {   # the reference's widths and depths (8 batches; lex stages 4 runs)
    "profile_vec": dict(N=1_000_000, D=768, B=256, iters=8, D0=192),
    "exp_coarse_bf16": dict(N=1_000_448, D=768, B=1024, iters=8),
    "exp_recall_target": dict(N=1_000_448, D=768, B=1024, iters=8),
    "profile_bm25": dict(N=1_000_000, B=256, iters=8),
    "profile_bm25b": dict(N=1_000_000, B=256, iters=8),
    "profile_lex_stages": dict(B=512, T=16, W=1024, V=65536, reps=4),
}


def packed_error_allowed(r: dict) -> float:
    """How far a packed top-1 sum may sit from production's f32 one: half
    a quantization step (vmax / (2 * QMAX)) for each of the doc's postings
    (at most `max_postings_per_doc`, which T bounds but for a doc that a
    term's window holds twice), and 8 f32 ulps of the query's total impact
    mass for each side's prefix sums (segment sums are differences of
    running totals, each rounded at the mass's scale)."""
    sh = r["shape"]
    half_step = sh["vmax"] / (2 * ((1 << sh["qbits"]) - 1))
    return (r["max_postings_per_doc"] * half_step
            + 16 * float(np.spacing(np.float32(r["impact_mass_max"]))))


# an id may leave or join a top-10 only at a near-tie between two f32 sums
# of the same bf16 products taken in another order (cuBLAS, K1, the batched
# rescore; ~1e-7 apart at these norms), where neighbouring top-10 scores
# sit ~1e-4 apart: a share of the ids this run's recalls may drift by
RECALL_FLIP_SHARE = 1e-3


def phase17_design_experiments(dev, card: str, runs: dict | None = None) -> dict:
    """The six design experiments at the reference's widths (PHASE17_RUNS,
    or `runs`): every row logged with the card's name and power limit.
    Gates:
      - plumbing only (each of these rows runs the oracle's own program, so
        only mislabelled rows or mixed-up ids fail them): the exact rows'
        recall is 1 (profile_vec's base_f32_exact overlap, exp_coarse_bf16's
        f32 and exact, exp_recall_target's exact);
      - K1's sweep: at each group width the leg's recall is the one K1's
        contract allows against the oracle (exp_recall_target
        contract_recall), within RECALL_FLIP_SHARE;
      - the bf16 rows: a rescore keeps every oracle id its candidates hold,
        and the top-32 candidates hold the norescore row's top-10 and the
        top-128 the top-32, so recall(bf16 C 128) >= recall(bf16 C 32) >=
        recall(bf16 norescore), each within RECALL_FLIP_SHARE;
      - packed1 (profile_bm25) and full_packed (profile_bm25b) within
        packed_error_allowed of production's top-1 sum on every query: at
        vmax 5.5 and QMAX 2,047 (QBITS 11 at N 1,000,448) half a step is
        0.00134 a posting (T 16 postings a doc: 0.0215), and 16 ulps of a
        query's impact mass (T x 512 impacts of at most 5.225, ~23,500 in
        practice and 42,800 at most: an ulp of 0.002-0.004) add
        0.031-0.0625.
    dot_bf16, the matryoshka rescore and K1's winners are held to their
    plain versions by phase17_checks."""
    from yams_tpu_torch.scripts import (exp_coarse_bf16, exp_recall_target, profile_bm25,
                                        profile_bm25b, profile_lex_stages, profile_vec)

    mods = {"profile_vec": profile_vec, "exp_coarse_bf16": exp_coarse_bf16,
            "exp_recall_target": exp_recall_target, "profile_bm25": profile_bm25,
            "profile_bm25b": profile_bm25b, "profile_lex_stages": profile_lex_stages}
    log(f"[phase17] {card}")
    out: dict = {"card": card, "seconds": {}}
    for name, kw in (runs or PHASE17_RUNS).items():
        t = time.perf_counter()
        with quiet("phase17"):
            print(f"{name} {kw}")
            out[name] = mods[name].run(**kw, device=dev, seed=SEED)
        out["seconds"][name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    check(out["profile_vec"]["overlap"]["base_f32_exact"] == 1.0,
          "profile_vec: the exact base_f32 row's overlap is 1")
    rows = out["exp_coarse_bf16"]["rows"]
    check(rows["f32"]["recall10"] == rows["exact"]["recall10"] == 1.0,
          "exp_coarse_bf16: the f32 and exact rows' recall is 1")
    check(out["exp_recall_target"]["rows"]["exact"]["recall10"] == 1.0,
          "exp_recall_target: the exact row's recall is 1")
    for key, r in out["exp_recall_target"]["rows"].items():
        if "group" in r:
            check(abs(r["recall10"] - r["contract_recall10"]) <= RECALL_FLIP_SHARE,
                  f"exp_recall_target {key}: recall@10 {r['recall10']:.6f} is its contract's "
                  f"{r['contract_recall10']:.6f}")
    order = [rows[k]["recall10"] for k in ("bf16nr", "bf16_C32", "bf16_C128")]
    check(all(b >= a - RECALL_FLIP_SHARE for a, b in zip(order, order[1:])),
          f"exp_coarse_bf16: recall@10 norescore <= C 32 <= C 128 ({order})")
    for name, row in (("profile_bm25", "packed1"), ("profile_bm25b", "full_packed")):
        r = out[name]
        r["top1_abs_err_allowed"] = packed_error_allowed(r)
        log(f"[phase17] {name}: {row} top-1 off production's by {r['top1_abs_err']:.6g} "
            f"(allowed {r['top1_abs_err_allowed']:.6g}; {r['max_postings_per_doc']} postings "
            f"a doc at most, impact mass <= {r['impact_mass_max']:.1f})")
        check(r["top1_abs_err"] <= r["top1_abs_err_allowed"],
              f"{name}: {row} within the quantization's error of production")
    return out


def phase17_k1_winners(qs, E, valid) -> dict:
    """K1's winners at each group width of exp_recall_target's sweep against
    grouped_max_reference on the sweep's first batch (every query: B 1,024
    spans four of K1's 256-query tiles), with phase 1's check_topk."""
    from yams_tpu_torch.ops import scan
    from yams_tpu_torch.scripts import exp_recall_target

    q = qs[0].to(torch.bfloat16).contiguous()
    out = {}
    for group in exp_recall_target.GROUPS:
        kv, ki = scan.grouped_max_cuda(q, E, valid, group)
        tv, ti = scan.grouped_max_reference(q, E, valid, group)
        err, d = check_topk(f"K1 sweep group={group}", kv, ki, tv, ti,
                            partition_true_score(q, E, valid=valid),
                            part_owns(valid, group, 1), 1e-4, ordered=False)
        out[group] = {"max_abs_err": err, "ids_differ": d, "winners": ki.numel()}
        log(f"[phase17] K1 group={group}: {ki.numel()} winners of {q.shape[0]} queries == "
            f"grouped_max_reference (max err {err:.3g}, {d} differing ids, all near-ties)")
        del kv, ki, tv, ti
    return out


def phase17_dot_bf16(qs, E) -> dict:
    """dot_bf16 (a bf16 cuBLAS product) on the first batch of
    exp_coarse_bf16's queries against dot_f32's sums rounded to bf16: every
    score within one bf16 ulp of its query's largest score (the CPU tests'
    bound for the bf16 rows)."""
    from yams_tpu_torch.ops.scan import dot_f32
    from yams_tpu_torch.scripts._common import dot_bf16

    q = qs[0]
    got = dot_bf16(q, E).float()
    want = dot_f32(q, E)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().amax(dim=1))) - 7)
    gap = ((got - want.to(torch.bfloat16).float()).abs() / ulp[:, None]).max().item()
    check(gap <= 1.0, f"dot_bf16: within one bf16 ulp of dot_f32's sums rounded "
                      f"({gap:.3g} ulps at most)")
    log(f"[phase17] dot_bf16 on {q.shape[0]} x {E.shape[0]}: {gap:.3g} bf16 ulps at most from "
        "dot_f32's sums rounded")
    return {"max_ulps": gap}


def phase17_rescore(qs, E, E0, C: int = 32, rerank: int = 4) -> dict:
    """profile_vec's mat192 rows on its first batch: rescore_topk (a row
    gather and a batched product with f32 sums) against the top-C of
    dot_f32's full-dimension scores at the same candidates, for the f32
    and the bf16 prefix scores: values within 1e-5, differing ids near-ties
    (fused_agree)."""
    from yams_tpu_torch.ops.matryoshka import rescore_topk
    from yams_tpu_torch.ops.scan import dot_f32
    from yams_tpu_torch.ops.select import top_k
    from yams_tpu_torch.scripts._common import dot_bf16

    q = qs[0]
    full = dot_f32(q, E)
    out = {}
    for name, dot in (("mat192", dot_f32), ("mat192_bf16", dot_bf16)):
        _, ci = top_k(dot(q[:, :E0.shape[1]], E0), C * rerank)
        v, i = rescore_topk(q, E, ci, C)
        tv, pos = top_k(full.gather(1, ci), C)
        err, d = fused_agree(f"{name} rescore", v, i, tv, ci.gather(1, pos))
        out[name] = {"max_abs_err": err, "ids_differ": d}
        log(f"[phase17] {name} rescore of {ci.shape[1]} candidates == dot_f32's top-{C} at "
            f"them (max err {err:.3g}, {d} ids at near-ties)")
    return out


def phase17_checks(dev) -> dict:
    """The card's kernel and products on the path's own inputs (the same
    seeds), made after the path's kernel counts are read."""
    from yams_tpu_torch.scripts import exp_recall_target, profile_vec

    kw = PHASE17_RUNS["exp_recall_target"]
    qs, E, valid = exp_recall_target.make_inputs(kw["N"], kw["D"], kw["B"], kw["iters"], 4096,
                                                 0.35, dev, SEED)
    out = {"k1_winners": phase17_k1_winners(qs, E, valid),
           "dot_bf16": phase17_dot_bf16(qs, E[:kw["N"]])}
    del qs, E, valid
    torch.cuda.empty_cache()
    kw = PHASE17_RUNS["profile_vec"]
    out["rescore"] = phase17_rescore(*profile_vec.make_inputs(kw["N"], kw["D"], kw["B"],
                                                              kw["iters"], kw["D0"], dev, SEED))
    torch.cuda.empty_cache()
    return out


# -- phase 18 -----------------------------------------------------------------
# select.top_k's kernel: the three long-row calls of the benchmark's vector
# legs and the three short-row calls of its merge, lexical leg and fusion
SELECT_SHAPES = ((1024, 1_000_448, 64), (1024, 262_144, 64), (64, 262_144, 64),
                 (1024, 4_096, 64), (1024, 2_624, 64), (1024, 128, 64))
SELECT_KINDS = ("normal", "one_value", "ties", "fills", "specials", "rising")


def select_rows(kind: str, R: int, n: int, gen, dev) -> torch.Tensor:
    """(R, n) f32 rows of one kind, made on the card: the CPU tests' kinds
    (tests/test_torch_select.py) at the card's sizes, and `neg_nan`."""
    def randn():
        return torch.randn((R, n), generator=gen, device=dev)

    if kind == "normal":
        return randn()
    if kind == "one_value":
        return torch.full((R, n), 0.25, device=dev)
    if kind == "ties":
        return torch.round(randn() * 2) / 2
    if kind == "fills":
        live = torch.rand((R, n), generator=gen, device=dev) >= 0.97
        x = torch.where(live, randn(), torch.full((), -1e30, device=dev))
        x[0] = -1e30
        return x
    if kind == "specials":
        x = torch.round(randn())
        x[:, ::5] = -torch.inf
        x[:, 1::7] = 0.0
        x[:, 2::9] = -0.0
        x[1:, 3::31] = torch.nan
        if R > 2:
            x[2] = -0.0
            x[2, ::3] = 0.0
        return x
    if kind == "rising":
        scale = torch.tensor([1.0, -1.0, 0.5, 1e-3], device=dev).repeat(-(-R // 4))[:R]
        return torch.arange(n, device=dev, dtype=torch.float32)[None, :] * scale[:, None]
    if kind == "neg_nan":     # a NaN with the sign bit set: below -inf in the key order
        x = randn()
        x[:, 5::17] = torch.tensor(0xFFC00000 - (1 << 32), dtype=torch.int32).view(torch.float32)
        return x
    raise ValueError(kind)


def key_order_top_k(x: torch.Tensor, k: int):
    """The order's definition: unique int64 keys over the whole row
    (`select._key_top_k`), the k winners ordered by them."""
    from yams_tpu_torch.ops import select

    pos = select._key_top_k(x, k)
    pos = pos.gather(1, select._key_top_k_small(x.gather(1, pos), pos))
    return x.gather(1, pos), pos


def bits_equal(a, b) -> bool:
    """Values and indices equal bit for bit (values as their integer bits)."""
    av, ai = a
    bv, bi = b
    ibits = torch.int16 if av.dtype in (torch.bfloat16, torch.float16) else torch.int32
    return (av.dtype == bv.dtype and ai.dtype == bi.dtype == torch.int64
            and torch.equal(ai, bi) and torch.equal(av.view(ibits), bv.view(ibits)))


SELECT_LENGTHS = (128, 1_000, 2_624, 4_096, 8_192, 8_193, 70_001, 262_144, 1_000_448)


def phase18_select(dev, lengths=SELECT_LENGTHS, shapes=SELECT_SHAPES, slice_cols=262_144) -> dict:
    """select_topk_cuda against the plain path (`select._plain_top_k`, what
    top_k ran on a card before it) and the key order itself, bit for bit,
    values and indices, a synchronize after each launch: adversarial rows at
    short and long lengths, k 1 to 1,024, strided and misaligned column
    slices, bf16 scores; then the benchmark's six calls, each checked and
    timed beside its byte bound and the plain path's time."""
    from yams_tpu_torch.ops import select

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    misses, plain_nan = [], []

    def compare(what, x, k, plain=True):
        got = select.select_topk_cuda(x, k)
        torch.cuda.synchronize()
        if not bits_equal(got, key_order_top_k(x, k)):
            misses.append(f"{what}: != key order")
        if plain and not bits_equal(got, select._plain_top_k(x, k)):
            misses.append(f"{what}: != plain path")

    cases = 0
    for n in lengths:
        for kind in SELECT_KINDS + ("neg_nan",):
            x = select_rows(kind, 8, n, gen, dev)
            for k in sorted({1, 64, 256, 1024, n} & set(range(1, min(n, 1024) + 1))):
                compare(f"{kind} (8, {n}) k {k}", x, k, plain=kind != "neg_nan")
                cases += 1
                if kind == "neg_nan":   # the plain path's torch.topk takes every NaN as the largest
                    same = bits_equal(select.select_topk_cuda(x, k), select._plain_top_k(x, k))
                    plain_nan.append(same)
    log(f"[phase18] {cases} adversarial cases; a -NaN row's top-k equal to the plain path's "
        f"in {sum(plain_nan)} of {len(plain_nan)}")

    # column slices read in place: stride not a multiple of 4 (scalar loads),
    # a misaligned start, a 16-byte-aligned stride (vector loads); bf16 scores
    c = slice_cols
    big = select_rows("ties", 64, c + 11, gen, dev)
    for what, x in ((f"x[:, :{c}] of {c + 11} columns", big[:, :c]),
                    (f"x[:, 3:{c + 3}]", big[:, 3:c + 3]),
                    (f"x[:, :{c // 3}] of {c + 11} columns", big[:, :c // 3]),
                    ("x[:, :4000]", big[:, :4_000])):
        compare(what, x, 64)
    aligned = select_rows("ties", 64, c + 4, gen, dev)
    compare(f"x[:, :{c}] of {c + 4} columns", aligned[:, :c], 64)
    compare(f"bf16 (64, {c})", big[:, :c].to(torch.bfloat16), 64)
    compare("f16 (1024, 4096)", select_rows("ties", 1024, 4_096, gen, dev).half(), 64)
    del big, aligned

    # top_k itself on the card: the kernel, no sync, no repair
    x = select_rows("ties", 64, c, gen, dev)
    before = (select.top_k.syncs, select.top_k.repair_rows, select.top_k.kernel_rows,
              select.top_k.rows, select.select_topk_cuda.launches)
    got = select.top_k(x, 64)
    after = (select.top_k.syncs, select.top_k.repair_rows, select.top_k.kernel_rows,
             select.top_k.rows, select.select_topk_cuda.launches)
    check(tuple(b - a for a, b in zip(before, after)) == (0, 0, 64, 64, 1),
          f"top_k on the card launches the kernel once, no sync or repair ({before} -> {after})")
    check(bits_equal(got, select._plain_top_k(x, 64)), "top_k on the card == the plain path")
    del x, got

    calls = {}
    for R, n, k in shapes:
        torch.cuda.empty_cache()
        x = select_rows("normal", R, n, gen, dev)
        compare(f"normal ({R}, {n}) k {k}", x, k)
        compare(f"ties ({R}, {n}) k {k}", torch.round(x * 8) / 8, k)
        launches = select.select_topk_cuda.launches
        reps = 20 if n > 8192 else 50
        ms = cuda_ms(lambda: select.select_topk_cuda(x, k), reps)
        per_call = (select.select_topk_cuda.launches - launches) / (reps + 1)
        plain_ms = cuda_ms(lambda: select._plain_top_k(x, k), 5)
        topk_ms = cuda_ms(lambda: torch.topk(x, k, dim=1), 5)   # yardstick: no tie order
        slices, slice_len = select.select_plan(R, n, k)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                select.select_topk_cuda(x, k)
            torch.cuda.synchronize()
        stages = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = next((w for w in ("slice_topk", "short_topk") if w in e.key), e.key[:32])
                stages[name] = round(stages.get(name, 0.0) + e.device_time_total / 5e3, 4)
        # the scores read once, k (f32, int64) pairs a row written once
        b = bound(4.0 * R * n + 12.0 * R * k, 0.0, PEAK_INT)
        calls[f"{R}x{n}"] = dict(k=k, ms=ms, plain_ms=plain_ms, library_ms=topk_ms,
                                 launches_a_call=per_call,
                                 slices=slices, slice_len=slice_len, stages_ms=stages, **b)
        log(f"[phase18] ({R}, {n}) k {k}: kernel {ms:.4f} ms against a {b['bound_ms']:.4f} ms "
            f"byte bound ({100 * b['bound_ms'] / ms:.1f}%), the plain path {plain_ms:.4f} ms, "
            f"torch.topk alone {topk_ms:.4f} ms; "
            f"plan {slices} x {slice_len}; {per_call:g} launch a call; device ms a call by "
            f"kernel {stages}")
        del x
    check(not misses, f"select_topk_cuda == key order and plain path: {len(misses)} misses: "
          f"{misses[:20]}")
    torch.cuda.empty_cache()
    return {"cases": cases, "neg_nan_equal_plain": [sum(plain_nan), len(plain_nan)],
            "calls": calls}



# -- phase 19 -----------------------------------------------------------------
# the chunked benchmark cell's segment max: (B, capacity rows) scores, the live
# rows' documents contiguous, the padding at -1, into (B, num_slots + 1)
SEGMENT_CELL = dict(B=1024, rows=8_388_608, live=7_095_047, docs=685_035, m=1_048_577)


def segment_cell_layout(gen, dev, rows: int, live: int, docs: int) -> torch.Tensor:
    """(rows,) int32 row2slot laid out as the chunked cell's store
    (`portbench/systems/chunked.py`): every document one row and the other
    live - docs rows by a multinomial draw with log-normal (sigma 1)
    weights, a document's rows contiguous in slot order, padding at -1."""
    w = torch.exp(torch.randn(docs, generator=gen, device=dev, dtype=torch.float64))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(live - docs, generator=gen, device=dev, dtype=torch.float64)
    counts = 1 + torch.bincount(torch.searchsorted(cdf, u).clamp_max_(docs - 1), minlength=docs)
    r2s = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    r2s[:live] = torch.repeat_interleave(torch.arange(docs, dtype=torch.int32, device=dev), counts)
    return r2s


def phase19_segment_max(dev, cell=SEGMENT_CELL, permuted_rows: int = 1 << 20) -> dict:
    """segment_max_cuda (csrc/segment_max.cu) at the chunked cell's shape and
    layout against its byte bound, beside `scatter_reduce_` amax on the
    floats (what `_aggregate_chunks` ran on a card before it) and the plain
    version; then the same layout's rows permuted at a reduced size, kernel
    against `scatter_reduce_`. Each result bit for bit against both."""
    from yams_tpu_torch.ops import segment

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    out = {}
    for name, B, rows, live, docs, m, permute in (
            ("cell", cell["B"], cell["rows"], cell["live"], cell["docs"], cell["m"], False),
            ("permuted", cell["B"], permuted_rows, permuted_rows * cell["live"] // cell["rows"],
             permuted_rows * cell["docs"] // cell["rows"], permuted_rows // 8 + 1, True)):
        torch.cuda.empty_cache()
        r2s = segment_cell_layout(gen, dev, rows, live, docs)
        if permute:
            r2s = r2s[torch.randperm(rows, generator=gen, device=dev)].contiguous()
        x = torch.randn((B, rows), generator=gen, device=dev)
        fill = torch.full((B, m), -torch.inf, device=dev)
        seg = torch.where(r2s >= 0, r2s.long(), m - 1)    # the sink: the last column

        def scatter():
            return fill.clone().scatter_reduce_(1, seg[None].expand(B, -1), x, reduce="amax",
                                                include_self=True)

        launches = segment.segment_max_cuda.launches
        got = segment.segment_max_cuda(x, r2s, fill.clone())
        torch.cuda.synchronize()
        check(segment.segment_max_cuda.launches == launches + 1, "segment_max_cuda counts a launch")
        flt = scatter()
        flt[:, m - 1] = -torch.inf          # the kernel skips the padding rows
        same = torch.equal(got.view(torch.int32), flt.view(torch.int32))
        twin = torch.equal(got.view(torch.int32),
                           segment.segment_max_plain(x, r2s, fill.clone()).view(torch.int32))
        check(same and twin, f"segment_max_cuda ({name}) == scatter_reduce_ amax ({same}) and "
              f"segment_max_plain ({twin}), bit for bit")
        del flt
        acc = fill.clone()
        ms = cuda_ms(lambda: segment.segment_max_cuda(x, r2s, acc), 10)   # max is idempotent
        scatter_ms = cuda_ms(scatter, 1 if name == "cell" else 3)
        plain_ms = cuda_ms(lambda: segment.segment_max_plain(x, r2s, fill.clone()), 1)
        fill_ms = cuda_ms(lambda: fill.fill_(-torch.inf), 5)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            segment.segment_max_cuda(x, r2s, acc)
            torch.cuda.synchronize()
        names = sorted({e.key[:48] for e in prof.key_averages() if e.device_time_total > 0})
        n_live = int((r2s >= 0).sum())
        touched = int(torch.unique(r2s[r2s >= 0]).numel())
        # live scores read once, row2slot once, each touched slot read and written once
        b = bound(4.0 * B * n_live + 4.0 * rows + 8.0 * B * touched, 0.0, PEAK_INT)
        out[name] = dict(B=B, rows=rows, live_rows=n_live, docs=touched, m=m, ms=ms,
                         scatter_reduce_ms=scatter_ms, plain_ms=plain_ms, fill_ms=fill_ms,
                         device_kernels=names, **b)
        log(f"[phase19] {name} ({B}, {rows}) -> ({B}, {m}), {n_live} live rows in {touched} "
            f"slots: kernel {ms:.4f} ms against a {b['bound_ms']:.4f} ms byte bound "
            f"({100 * b['bound_ms'] / ms:.1f}%), scatter_reduce_ amax {scatter_ms:.4f} ms, "
            f"the plain version {plain_ms:.4f} ms, the -inf fill {fill_ms:.4f} ms; device "
            f"kernels {names}")
        del x, fill, acc, got, seg, r2s
    torch.cuda.empty_cache()
    return out


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
    from yams_tpu_torch.ops import cdc, flash_topk, pq_pallas, scan, segment, select, sha256

    counters = {"gear_hash_cuda": cdc.gear_hash_cuda, "sha256_cuda": sha256.sha256_cuda,
                "exact_topk_cuda": scan.exact_topk_cuda, "pq4_adc_cuda": pq_pallas.pq4_adc_cuda,
                "grouped_max_cuda": scan.grouped_max_cuda,
                "windowed_scan_cuda": flash_topk.windowed_scan_cuda,
                "select_topk_cuda": select.select_topk_cuda,
                "segment_max_cuda": segment.segment_max_cuda}

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
    kernels["sha256_cuda"].update(ms_128MiB_chunks=breakdown["sha256_ms"],
                                  launch_ms_128MiB_chunks=breakdown["sha256_launch_ms"])
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
    log(f"[streaming and int8 path] kernel launches {stream_launches} (its products and "
        "aggregations are torch operations; its top-C select_topk_cuda)")

    zero()
    kg = phase("phase9", phase9_kg, dev, card, eng, cpu, docs, queries,
               search["steady_search_ms"], pq_index)
    kg_launches = read()
    log(f"[KG and persistence path] kernel launches {kg_launches}")
    for name in ("exact_topk_cuda", "pq4_adc_cuda"):
        check(kg_launches[name] >= 1, f"{name} launched on a reloaded index")

    zero()
    keep: dict = {}
    service = phase("phase10", phase10_service, dev, card, 1024, 64, 48 << 20, keep)
    svc_launches = read()
    log(f"[service layer path] kernel launches {svc_launches}")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(svc_launches[name] >= 1, f"{name} launched on the service layer's add")

    zero()
    topology = phase("phase11", phase11_topology, dev, card, eng, cpu, queries, keep)
    topo_launches = read()
    log(f"[topology and repair path] kernel launches {topo_launches} (its builds, routing "
        "and gather scan are torch operations but for their top-k)")
    log("[phase11] device operations " + json.dumps(phase11_ops(topology)))

    zero()
    neural = phase("phase12", phase12_neural, dev, card, docs, queries)
    neural_launches = read()
    log(f"[neural embedding path] kernel launches {neural_launches} (the encoders, MaxSim, "
        "the gather and matryoshka are torch operations but for their top-k)")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(neural_launches[name] >= 1, f"{name} launched on the hf daemon's add")
    log("[phase12] device operations " + json.dumps(phase12_ops(neural)))

    zero()
    services13 = phase("phase13", phase13_services, dev, card, eng, cpu, queries)
    svc13_launches = read()
    log(f"[rest of the service layer path] kernel launches {svc13_launches} (the NER "
        "forward, the identity projection, bm25_dense and the hotzone are torch operations)")
    for name in ("gear_hash_cuda", "sha256_cuda"):
        check(svc13_launches[name] >= 1, f"{name} launched on phase 13's downloads")
    log("[phase13] device operations " + json.dumps(phase13_ops(services13)))

    zero()
    training = phase("phase14", phase14_training, dev, card)
    train_launches = read()
    log(f"[training and real-text path] kernel launches {train_launches} (the trainers' "
        "forward, backward and AdamW and the real-text adds and searches are torch "
        "operations; no chunk reaches K5's 32 MiB)")
    log("[phase14] device operations " + json.dumps(phase14_ops(training)))

    zero()
    scale_out = phase("phase15", phase15_scale_out, dev, card, eng, queries)
    so_launches = read()
    log(f"[scale-out path] kernel launches {so_launches} (the shards' scans, the merge and "
        "the fusion are torch operations but for their top-k, as the reference's shards "
        "run XLA)")

    zero()
    abi_scripts = phase("phase16", phase16_abi_scripts, dev, card)
    abi_launches = read()
    log(f"[mobile ABI and scripts path] kernel launches {abi_launches}")
    for name in ("gear_hash_cuda", "sha256_cuda", "pq4_adc_cuda"):
        check(abi_launches[name] >= 1, f"{name} launched on phase 16's path")

    zero()
    design = phase("phase17", phase17_design_experiments, dev, card)
    design_launches = read()
    log(f"[design experiments path] kernel launches {design_launches}")
    check(design_launches["grouped_max_cuda"] >= 1,
          "grouped_max_cuda launched on exp_recall_target's sweep")
    # the comparisons' launches come after the path's count was read
    design["checks"] = phase("phase17 checks", phase17_checks, dev)

    zero()
    selection = phase("phase18", phase18_select, dev)
    select_launches = read()
    log(f"[select kernel path] kernel launches {select_launches}")
    check(select_launches["select_topk_cuda"] >= 1, "select_topk_cuda launched on phase 18's path")
    big = dict(selection["calls"]["1024x1000448"])
    kernels["select_topk_cuda"] = dict(max_abs_err=0, shape="(1,024, 1,000,448) f32, k 64",
                                       calls=selection["calls"], topk_ms=big.pop("library_ms"),
                                       **big)

    zero()
    segments = phase("phase19", phase19_segment_max, dev)
    segment_launches = read()
    log(f"[segment max path] kernel launches {segment_launches}")
    check(segment_launches["segment_max_cuda"] >= 2, "segment_max_cuda launched on phase 19's path")
    cell = segments["cell"]
    kernels["segment_max_cuda"] = dict(
        max_abs_err=0, plain_ms=cell["plain_ms"], library_ms=cell["scatter_reduce_ms"],
        shape=f"({cell['B']}, {cell['rows']}) f32 -> ({cell['B']}, {cell['m']}), the chunked "
              "cell's layout", permuted=segments["permuted"],
        **{k: cell[k] for k in ("ms", "bound_ms", "bound_by", "bound_bytes", "bound_ops")})

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("yams_tpu", "jax", "jaxlib", "flax"))
    check(not loaded, f"no module of yams_tpu, jax, jaxlib or flax loaded (found {loaded})")
    log(f"[summary] {json.dumps({'card': card, 'seconds': seconds, 'add': add, 'add_breakdown_ms': breakdown, 'search': search, 'bench': bench, 'vector_store': store, 'engine_pq': engine_pq, 'experiments': experiments, 'streaming': streaming, 'engine_streaming': engine8, 'kg': kg, 'service': service, 'topology': topology, 'neural': neural, 'services13': services13, 'training': training, 'scale_out': scale_out, 'abi_scripts': abi_scripts, 'design': design, 'selection': selection, 'segments': segments, 'torch': torch.__version__})}")

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
        "select_topk_cuda": ("yams_tpu_torch/csrc/select_topk.cu",
                             "none (lax.top_k on the hot path)", select_launches),
        "segment_max_cuda": ("yams_tpu_torch/csrc/segment_max.cu",
                             "none (jax.ops.segment_max in the chunk aggregation)",
                             segment_launches),
    }
    records = []
    for name, (src, replaces, launches) in sources.items():
        k = kernels[name]
        # one PyTorch call computes only the segment max: scatter_reduce_ amax
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
                        "shape": k["shape"],
                        "bound_bytes": k["bound_bytes"], "bound_ops": k["bound_ops"],
                        **{key: k[key] for key in (
                            "dot_f32_ms", "tflops", "dot_f32_tflops", "large_k", "rising_ms",
                            "launch_ms", "chain_ms", "cycles_per_round", "sm_clock_mhz",
                            "ms_4096_chunks_to_256KiB", "launch_ms_4096_chunks_to_256KiB",
                            "ms_128MiB_chunks", "launch_ms_128MiB_chunks", "calls",
                            "topk_ms", "permuted") if key in k}})
        if name in ("exact_topk_cuda", "pq4_adc_cuda"):
            records[-1]["launches_phase9"] = kg_launches[name]
        if name in ("gear_hash_cuda", "sha256_cuda"):
            records[-1]["launches_phase10"] = svc_launches[name]
        records[-1]["launches_phase12"] = neural_launches[name]
        records[-1]["launches_phase13"] = svc13_launches[name]
        records[-1]["launches_phase14"] = train_launches[name]
        records[-1]["launches_phase15"] = so_launches[name]
        records[-1]["launches_phase16"] = abi_launches[name]
        records[-1]["launches_phase17"] = design_launches[name]
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
