"""Drive the PyTorch/CUDA port's add -> search path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

  0. card identity (nvidia-smi name and power limit);
  1. each CUDA kernel built from yams_tpu_torch/csrc and held against its
     plain PyTorch twin on the card (bit-exact), with both timed;
  2. add: a 128 MiB seeded zipf-word payload through device_chunk_hash
     (gear-hash CDC + SHA-256 on the card), checked against the host chunker
     and hashlib;
  3. search: a SearchEngine with the default configs fed 70,000 seeded
     documents, a 64-query search_batch on the card, 16 of its queries
     checked against the same state searched on the CPU plain path (with the
     engine's prefilter guard as configured, and with it off so the BM25
     prefilter tier runs too);
  4. the hybrid query at the bench shape (1,048,576 x 768 clustered bf16
     corpus, 65,536 packed postings rows of 1,024), QPS and recall@10.

The kernel launch counters are zeroed just before phase 2 and read after
phase 3; every kernel must have launched on that main path. The second-last
line is the kernels' JSON record, the last line the device record.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    return {
        "gear_hash_cuda": dict(max_abs_err=gear_err, ms=gear_ms, plain_ms=gear_plain_ms,
                               shape="64 MiB (67,108,864 positions)"),
        "sha256_cuda": dict(max_abs_err=sha_err, ms=sha_ms, plain_ms=sha_plain_ms,
                            shape=f"{rows} rows x ~{width} B",
                            ms_4096_chunks_to_256KiB=sha_big_ms),
    }


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
    torch.cuda.synchronize()
    t = time.perf_counter()
    res_pf = eng.search_batch(queries)
    torch.cuda.synchronize()
    pf_s = time.perf_counter() - t
    check("prefilter_disabled_tail_ratio" not in eng.last_trace, "prefilter live")
    overlap_pf = overlap_vs_cpu(res_pf)
    log(f"[phase3] prefilter 256 forced: search_batch(64) {pf_s * 1e3:.1f} ms, "
        f"top-10 overlap with the CPU plain path {overlap_pf:.4f}")
    check(overlap_pf >= 0.99, "prefilter top-10 overlap >= 0.99 vs CPU")
    return {"docs": len(docs), "add_s": add_s, "native_sketch": native_sketch,
            "native_build_s": native_s,
            "first_search_s": first_s, "steady_search_ms": steady_s * 1e3,
            "overlap_vs_cpu": overlap,
            "prefilter_disabled": "prefilter_disabled_tail_ratio" in trace,
            "prefilter_search_ms": pf_s * 1e3, "prefilter_overlap_vs_cpu": overlap_pf}


# -- phase 4 ------------------------------------------------------------------
def phase4_bench(dev, N: int = 1 << 20, D: int = 768, B: int = 1024,
                 V: int = 65536) -> dict:
    from yams_tpu_torch.ops.bm25 import bm25_topk_candidates_packed, packed_qbits
    from yams_tpu_torch.ops.select import top_k
    from yams_tpu_torch.search.config import SearchEngineConfig
    from yams_tpu_torch.search.fusion import dot_f32, hybrid_query, pack_weights

    S, T, K, WIN, ITERS, WINDOWS = 4096, 16, 10, 1024, 8, 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = time.perf_counter()
    centers = torch.randn(4096, D, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True).clamp_min(1e-9)
    ar = torch.arange(N, device=dev, dtype=torch.int64)
    assign = (((ar * 2654435761) & 0xFFFFFFFF) >> 7) % 4096
    noise = torch.randn(N, D, generator=gen, device=dev, dtype=torch.bfloat16)
    e = centers[assign].to(torch.bfloat16) + 0.35 * noise
    del noise
    ef = e.float()
    E = (ef / ef.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)
    del e, ef
    proj = torch.where(torch.rand(S, D, generator=gen, device=dev) < 0.5, 1.0, -1.0)
    proj = (proj / np.sqrt(D)).to(torch.bfloat16)
    # packed postings: each term -> WIN/2 multiplicative-hash docs, zipf impacts
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
    del arp, docs
    scale = torch.tensor(vmax, dtype=torch.float32, device=dev)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; nothing was run", file=sys.stderr)
        return 2
    import yams_tpu_torch  # noqa: F401  (fails fast outside a checkout)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase0_identity()
    from yams_tpu_torch.ops import cdc, sha256

    kernels = phase1_kernels(dev)
    data = zipf_text(128 << 20, SEED)
    log(f"[phase2] payload {len(data)} bytes of zipf-word text")

    # the main path: add, then search; counters zeroed just before it
    cdc.gear_hash_cuda.launches = 0
    sha256.sha256_cuda.launches = 0
    add = phase2_add(dev, data)
    search = phase3_search(dev)
    launches = {"gear_hash_cuda": cdc.gear_hash_cuda.launches,
                "sha256_cuda": sha256.sha256_cuda.launches}
    log(f"[main path] kernel launches {launches}")
    for name, n in launches.items():
        check(n >= 1, f"{name} launched on the main path")

    breakdown = phase2_breakdown(dev, data)
    bench = phase4_bench(dev)
    check("jax" not in sys.modules, "no jax imported")
    log(f"[summary] {json.dumps({'card': card, 'add': add, 'add_breakdown_ms': breakdown, 'search': search, 'bench': bench, 'torch': torch.__version__})}")

    sources = {"gear_hash_cuda": ("yams_tpu_torch/csrc/gear_hash.cu", "yams_tpu/ops/cdc.py:65"),
               "sha256_cuda": ("yams_tpu_torch/csrc/sha256.cu", "yams_tpu/ops/sha256.py:55")}
    records = []
    for name, (src, replaces) in sources.items():
        k = kernels[name]
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "shape": k["shape"]})
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
