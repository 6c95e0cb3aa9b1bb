// Copied from yams_tpu/native/src/yams_native.cpp for the port's own host library
// (yams_tpu_torch/native/__init__.py builds it with g++).
//
// yams_tpu native runtime kernels (host side).
//
// TPU-native rebuild of the reference's byte-throughput C++ paths:
//  - FastCDC content-defined chunking (reference: src/chunking/rabin_chunker.cpp
//    uses Rabin w/ window=48; we use gear-hash FastCDC which parallelizes and is
//    ~10-20x faster at equal boundary quality — boundary-parity, not byte-parity).
//  - substring scan for grep literal fast path (reference:
//    src/app/services/simd_memmem.cpp, Lemire two-byte technique).
//
// Exposed via a C ABI consumed through ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

int ytn_abi_version() { return 1; }

// --- splitmix64-derived gear table (shared derivation with the Python fallback) ---
static uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// 32-bit gear hash: the window self-flushes after 32 bytes and all device
// implementations (TPU has no uint64 vector ops) agree bit-for-bit with the
// host paths. Derived from splitmix64, truncated.
static uint32_t GEAR[256];
static bool gear_init_done = false;
static const uint64_t GEAR_SEED = 0x59414D5354505500ULL; // "YAMSTPU\0"

static void gear_init() {
    if (gear_init_done) return;
    for (int i = 0; i < 256; ++i)
        GEAR[i] = (uint32_t)(splitmix64(GEAR_SEED + (uint64_t)i) >> 32);
    gear_init_done = true;
}

void ytn_gear_table(uint32_t* out256) {
    gear_init();
    std::memcpy(out256, GEAR, sizeof(GEAR));
}

static inline int ilog2(uint64_t v) {
    int r = 0;
    while (v >>= 1) ++r;
    return r;
}

// FastCDC (Xia et al. 2016) with two-level normalized chunking.
// ytn_fastcdc_cut: ONE boundary decision — the length of the next chunk
// starting at `data` with `remaining` bytes left. Exported so the overlapped
// ingest pipeline (ingest_pipeline.cpp) can interleave chunking with
// hash/compress while staying bit-identical to the batch scan below (each
// chunk's decision depends only on its own bytes; the gear window self-
// flushes after 32 bytes).
size_t ytn_fastcdc_cut(const uint8_t* data, size_t remaining,
                       size_t min_size, size_t avg_size, size_t max_size) {
    gear_init();
    if (remaining <= min_size) return remaining;
    const int bits = ilog2(avg_size);
    const uint32_t mask_s = (1u << (bits + 2)) - 1; // harder, before avg
    const uint32_t mask_l = (1u << (bits - 2)) - 1; // easier, after avg
    size_t cap = remaining < max_size ? remaining : max_size;
    size_t mid = remaining < avg_size ? remaining : avg_size;
    uint32_t h = 0;
    size_t i = 0;
    // warm the 32-byte window inside the skipped min region
    size_t warm = min_size >= 32 ? min_size - 32 : 0;
    for (i = warm; i < min_size; ++i) h = (h << 1) + GEAR[data[i]];
    for (; i < mid; ++i) {
        h = (h << 1) + GEAR[data[i]];
        if (!(h & mask_s)) return i + 1;
    }
    for (; i < cap; ++i) {
        h = (h << 1) + GEAR[data[i]];
        if (!(h & mask_l)) return i + 1;
    }
    return cap;
}

// Batch scan: number of chunks; end-offsets into out (up to out_cap).
size_t ytn_fastcdc(const uint8_t* data, size_t n,
                   size_t min_size, size_t avg_size, size_t max_size,
                   uint64_t* out, size_t out_cap) {
    if (n == 0) return 0;
    size_t count = 0;
    size_t pos = 0;
    while (pos < n) {
        pos += ytn_fastcdc_cut(data + pos, n - pos, min_size, avg_size,
                               max_size);
        if (count < out_cap) out[count] = (uint64_t)pos;
        ++count;
    }
    return count;
}

// Find all occurrences of needle in haystack; writes offsets, returns count.
// Two-byte filter in the spirit of the reference's simd_memmem.cpp; the
// compiler vectorizes the first/last-byte comparison loop.
size_t ytn_find_all(const uint8_t* hay, size_t n,
                    const uint8_t* needle, size_t m,
                    uint64_t* out, size_t out_cap) {
    if (m == 0 || m > n) return 0;
    size_t count = 0;
    const uint8_t first = needle[0], last = needle[m - 1];
    for (size_t i = 0; i + m <= n; ++i) {
        if (hay[i] == first && hay[i + m - 1] == last &&
            (m <= 2 || std::memcmp(hay + i + 1, needle + 1, m - 2) == 0)) {
            if (count < out_cap) out[count] = (uint64_t)i;
            ++count;
        }
    }
    return count;
}

// crc32 (zlib polynomial, table-driven) — used for WAL / compression headers
// when we want to avoid Python-loop overheads on large buffers.
static uint32_t CRC_TABLE[256];
static bool crc_init_done = false;
static void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        CRC_TABLE[i] = c;
    }
    crc_init_done = true;
}

// --- Simeon hashed n-gram sketch, ASCII fast path -------------------------
//
// Bit-identical rebuild of yams_tpu/embed/simeon.py:sketch_text for pure-ASCII
// documents (the reference's AVX2/NEON Simeon hash kernels play this role,
// third_party/simeon via src/vector/meson.build:195-216). Semantics mirrored
// exactly: tokens = runs of [a-z0-9_] over tolower'd bytes (== re [\w]+ on
// lowered ASCII), FNV-1a token hashes, polynomial word/char n-gram rolling
// hashes with the FNV prime, splitmix64 finalizer, signed bucket counts.
// Counts are sums of +-1 (exact in f32); the log1p scaling stays in NumPy so
// host paths cannot diverge by a ULP. Docs containing any byte >= 0x80 are
// left to the Python fallback (ok[i]=0): CPython's str.lower()/\w Unicode
// tables are not worth reimplementing.

static const uint64_t FNV_OFF = 0xCBF29CE484222325ULL;
static const uint64_t FNV_P = 0x100000001B3ULL;

static inline uint64_t mix64(uint64_t h) {
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ULL;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBULL;
    return h ^ (h >> 31);
}

static inline void bucket(uint64_t h, float* counts, uint32_t S) {
    uint32_t idx = (uint32_t)(h % (uint64_t)S);
    counts[idx] += (h >> 63) ? -1.0f : 1.0f;
}

// Sketch n_docs concatenated documents into out (n_docs x S signed counts).
// offsets has n_docs+1 entries. ok[i]=1 when doc i was handled natively.
// Returns the number of docs handled.
size_t ytn_sketch_batch(const uint8_t* data, const uint64_t* offsets,
                        size_t n_docs, uint32_t S, uint32_t max_tokens,
                        const uint32_t* word_ngrams, size_t n_word,
                        const uint32_t* char_ngrams, size_t n_char,
                        float* out, uint8_t* ok) {
    size_t handled = 0;
    // reusable scratch across docs (token hashes + joined lowered bytes)
    static thread_local uint64_t* th = nullptr;
    static thread_local uint8_t* joined = nullptr;
    static thread_local size_t th_cap = 0, joined_cap = 0;

    for (size_t di = 0; di < n_docs; ++di) {
        const uint8_t* doc = data + offsets[di];
        size_t len = (size_t)(offsets[di + 1] - offsets[di]);
        float* counts = out + (size_t)di * S;
        std::memset(counts, 0, sizeof(float) * S);
        bool ascii = true;
        for (size_t i = 0; i < len; ++i)
            if (doc[i] >= 0x80) { ascii = false; break; }
        if (!ascii) { ok[di] = 0; continue; }
        ok[di] = 1;
        ++handled;

        if (len / 2 + 2 > th_cap) {
            th_cap = len / 2 + 2;
            delete[] th;
            th = new uint64_t[th_cap];
        }
        if (len + 1 > joined_cap) {
            joined_cap = len + 1;
            delete[] joined;
            joined = new uint8_t[joined_cap];
        }

        // tokenize (runs of [a-z0-9_] after tolower) + FNV-1a per token +
        // build the space-joined lowered token string for char n-grams
        size_t n_tok = 0, jlen = 0;
        size_t i = 0;
        while (i < len) {
            uint8_t c = doc[i];
            if (c >= 'A' && c <= 'Z') c += 32;
            bool w = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
            if (!w) { ++i; continue; }
            if (max_tokens && n_tok >= max_tokens) break;
            if (n_tok) joined[jlen++] = ' ';
            uint64_t h = FNV_OFF;
            while (i < len) {
                uint8_t b = doc[i];
                if (b >= 'A' && b <= 'Z') b += 32;
                bool bw = (b >= 'a' && b <= 'z') || (b >= '0' && b <= '9') ||
                          b == '_';
                if (!bw) break;
                h = (h ^ (uint64_t)b) * FNV_P;
                joined[jlen++] = b;
                ++i;
            }
            th[n_tok++] = h;
        }
        if (n_tok == 0) continue;  // zeros, matching the Python empty case

        // word n-grams: n==1 is mix(token_hash); n>1 is the polynomial roll
        for (size_t wi = 0; wi < n_word; ++wi) {
            uint32_t n = word_ngrams[wi];
            if (n == 0 || n_tok < n) continue;
            if (n == 1) {
                for (size_t t = 0; t < n_tok; ++t)
                    bucket(mix64(th[t]), counts, S);
            } else {
                for (size_t t = 0; t + n <= n_tok; ++t) {
                    uint64_t h = FNV_OFF;
                    for (uint32_t j = 0; j < n; ++j) h = (h * FNV_P) ^ th[t + j];
                    bucket(mix64(h), counts, S);
                }
            }
        }
        // char n-grams over the joined lowered token bytes
        for (size_t ci = 0; ci < n_char; ++ci) {
            uint32_t n = char_ngrams[ci];
            if (n == 0 || jlen < n) continue;
            for (size_t t = 0; t + n <= jlen; ++t) {
                uint64_t h = FNV_OFF;
                for (uint32_t j = 0; j < n; ++j)
                    h = (h * FNV_P) ^ (uint64_t)joined[t + j];
                bucket(mix64(h), counts, S);
            }
        }
    }
    return handled;
}

uint32_t ytn_crc32(const uint8_t* data, size_t n, uint32_t seed) {
    crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = CRC_TABLE[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

} // extern "C"
