// Copied from yams_tpu/native/src/ingest_pipeline.cpp for the port's own host library
// (yams_tpu_torch/native/__init__.py builds it with g++).
//
// Native end-to-end ingest pipeline: FastCDC chunk -> SHA-256 -> zstd,
// multithreaded over chunks (BASELINE config 5: >=1 GB/s/chip chunk+hash+
// compress). SHA-256 is implemented from the FIPS 180-4 spec (no OpenSSL
// headers in this image); zstd links against the system library.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

#include <zstd.h>

#if defined(__SHA__) && defined(__x86_64__)
#include <immintrin.h>
#define YTN_HAVE_SHA_NI 1
#endif

extern "C" size_t ytn_fastcdc(const uint8_t* data, size_t n,
                              size_t min_size, size_t avg_size, size_t max_size,
                              uint64_t* out, size_t out_cap);
extern "C" size_t ytn_fastcdc_cut(const uint8_t* data, size_t remaining,
                                  size_t min_size, size_t avg_size,
                                  size_t max_size);

namespace {

// --- SHA-256 (FIPS 180-4) ---------------------------------------------------
constexpr uint32_t K[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};

inline uint32_t rotr(uint32_t x, int c) { return (x >> c) | (x << (32 - c)); }

#ifdef YTN_HAVE_SHA_NI
// Hardware SHA-256 block compression (x86 SHA extensions). State is the
// standard h[0..7]; processes `blocks` 64-byte blocks.
// noinline+noclone: GCC otherwise const-prop-clones this per call site and
// pessimizes the batch call into a per-block loop (~100x slower).
__attribute__((noinline, noclone))
void sha256_blocks_ni(uint32_t state[8], const uint8_t* data, size_t blocks) {
    __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;
    __m128i ABEF_SAVE, CDGH_SAVE;
    const __m128i MASK = _mm_set_epi64x(
        0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

    TMP = _mm_loadu_si128((const __m128i*)&state[0]);    // DCBA
    STATE1 = _mm_loadu_si128((const __m128i*)&state[4]); // HGFE
    TMP = _mm_shuffle_epi32(TMP, 0xB1);                  // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);            // EFGH
    STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);            // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);         // CDGH

    while (blocks--) {
        ABEF_SAVE = STATE0;
        CDGH_SAVE = STATE1;

        // rounds 0-3
        MSG = _mm_loadu_si128((const __m128i*)(data + 0));
        MSG0 = _mm_shuffle_epi8(MSG, MASK);
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        // rounds 4-7
        MSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 16)), MASK);
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        // rounds 8-11
        MSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 32)), MASK);
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        // rounds 12-15
        MSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 48)), MASK);
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        // rounds 16-19
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        // rounds 20-23
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        // rounds 24-27
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        // rounds 28-31
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        // rounds 32-35
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        // rounds 36-39
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        // rounds 40-43
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        // rounds 44-47
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(0x106AA070F40E3585ULL, 0xD6990624D192E819ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        // rounds 48-51
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        // rounds 52-55
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        // rounds 56-59
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        // rounds 60-63
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
        STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
        data += 64;
    }

    TMP = _mm_shuffle_epi32(STATE0, 0x1B);       // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    // HGFE
    _mm_storeu_si128((__m128i*)&state[0], STATE0);
    _mm_storeu_si128((__m128i*)&state[4], STATE1);
}
#endif  // YTN_HAVE_SHA_NI

void sha256(const uint8_t* data, size_t n, uint8_t out[32]) {
    uint32_t h[8] = {0x6a09e667,0xbb67ae85,0x3c6ef372,0xa54ff53a,
                     0x510e527f,0x9b05688c,0x1f83d9ab,0x5be0cd19};
    uint64_t total_bits = (uint64_t)n * 8;
    size_t full = n / 64;
    uint8_t tail[128];
    size_t rem = n - full * 64;
    std::memcpy(tail, data + full * 64, rem);
    tail[rem] = 0x80;
    size_t tail_len = (rem < 56) ? 64 : 128;
    std::memset(tail + rem + 1, 0, tail_len - rem - 1 - 8);
    for (int i = 0; i < 8; ++i)
        tail[tail_len - 1 - i] = (uint8_t)(total_bits >> (8 * i));

#ifdef YTN_HAVE_SHA_NI
    if (full) sha256_blocks_ni(h, data, full);
    auto process = [&](const uint8_t* p) { sha256_blocks_ni(h, p, 1); };
    (void)K;
#else
    auto process = [&](const uint8_t* p) {
        uint32_t w[64];
        for (int i = 0; i < 16; ++i)
            w[i] = (uint32_t)p[4*i] << 24 | (uint32_t)p[4*i+1] << 16 |
                   (uint32_t)p[4*i+2] << 8 | p[4*i+3];
        for (int i = 16; i < 64; ++i) {
            uint32_t s0 = rotr(w[i-15],7) ^ rotr(w[i-15],18) ^ (w[i-15] >> 3);
            uint32_t s1 = rotr(w[i-2],17) ^ rotr(w[i-2],19) ^ (w[i-2] >> 10);
            w[i] = w[i-16] + s0 + w[i-7] + s1;
        }
        uint32_t a=h[0],b=h[1],c=h[2],d=h[3],e=h[4],f=h[5],g=h[6],hh=h[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t S1 = rotr(e,6) ^ rotr(e,11) ^ rotr(e,25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a,2) ^ rotr(a,13) ^ rotr(a,22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
        }
        h[0]+=a; h[1]+=b; h[2]+=c; h[3]+=d; h[4]+=e; h[5]+=f; h[6]+=g; h[7]+=hh;
    };
    for (size_t i = 0; i < full; ++i) process(data + i * 64);
#endif
    process(tail);
    if (tail_len == 128) process(tail + 64);
    for (int i = 0; i < 8; ++i) {
        out[4*i]   = (uint8_t)(h[i] >> 24);
        out[4*i+1] = (uint8_t)(h[i] >> 16);
        out[4*i+2] = (uint8_t)(h[i] >> 8);
        out[4*i+3] = (uint8_t)h[i];
    }
}

} // namespace

extern "C" {

void ytn_sha256(const uint8_t* data, size_t n, uint8_t* out32) {
    sha256(data, n, out32);
}

// Full pipeline. Returns chunk count (0 on error / capacity overflow).
//  boundaries: chunk end offsets (max_chunks)
//  hashes:     32 bytes per chunk (max_chunks*32)
//  comp_out:   compressed chunks, each at offset comp_offsets[i] (caller
//              reads comp_sizes[i] bytes). comp_cap must be >= sum of
//              ZSTD_compressBound(chunk_size); per-chunk regions are laid
//              out at bound-prefix offsets so threads never overlap.
//  level:      zstd level; 0 disables compression (hash+chunk only).
//              Negative levels select zstd fast mode (the hot ingest tier:
//              ~2x the speed of L1 for ~15% ratio loss).
size_t ytn_ingest_pipeline(
    const uint8_t* data, size_t n,
    size_t min_size, size_t avg_size, size_t max_size,
    int level, int nthreads,
    uint64_t* boundaries, uint8_t* hashes,
    uint8_t* comp_out, size_t comp_cap,
    uint64_t* comp_offsets, uint64_t* comp_sizes,
    size_t max_chunks) {
    if (n == 0) return 0;
    int nt = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;

    // Stages OVERLAP instead of running as whole-buffer passes (the serial
    // version left ~2.6x on the floor: CDC scanned all of `data`, then the
    // workers re-read every chunk twice more from DRAM).
    //
    // nt == 1: FUSED single pass — decide boundary i, then hash + compress
    // chunk i while its bytes are still cache-hot, then CDC scans i+1. Same
    // outputs, one DRAM pass instead of three.
    if (nt == 1) {
        ZSTD_CCtx* cctx = level != 0 ? ZSTD_createCCtx() : nullptr;
        size_t pos = 0, count = 0;
        uint64_t off = 0;
        bool ok = true;
        while (pos < n) {
            size_t cut = ytn_fastcdc_cut(data + pos, n - pos, min_size,
                                         avg_size, max_size);
            if (count >= max_chunks) { ok = false; break; }
            boundaries[count] = (uint64_t)(pos + cut);
            sha256(data + pos, cut, hashes + 32 * count);
            if (level != 0) {
                size_t bound = ZSTD_compressBound(cut);
                if (off + bound > comp_cap) { ok = false; break; }
                comp_offsets[count] = off;
                size_t csz = ZSTD_compressCCtx(
                    cctx, comp_out + off, bound, data + pos, cut, level);
                if (ZSTD_isError(csz)) { ok = false; break; }
                comp_sizes[count] = csz;
                off += bound;
            } else {
                comp_sizes[count] = 0;
            }
            pos += cut;
            ++count;
        }
        if (cctx) ZSTD_freeCCtx(cctx);
        return ok ? count : 0;
    }

    // nt > 1: PIPELINED — a producer thread runs CDC and publishes
    // boundary/offset entries as it finds them; nt-1 worker threads (plus
    // the caller's thread) claim chunks the moment they are published and
    // hash/compress them while CDC is still scanning ahead.
    std::atomic<size_t> published{0};  // boundaries[0..published) are ready
    std::atomic<size_t> total{SIZE_MAX};  // final count once CDC finishes
    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};

    std::thread producer([&]() {
        size_t pos = 0, count = 0;
        uint64_t off = 0;
        while (pos < n) {
            size_t cut = ytn_fastcdc_cut(data + pos, n - pos, min_size,
                                         avg_size, max_size);
            if (count >= max_chunks) { failed = true; break; }
            boundaries[count] = (uint64_t)(pos + cut);
            if (level != 0) {
                uint64_t bound = ZSTD_compressBound(cut);
                if (off + bound > comp_cap) { failed = true; break; }
                comp_offsets[count] = off;
                off += bound;
            }
            pos += cut;
            ++count;
            published.store(count, std::memory_order_release);
        }
        total.store(count, std::memory_order_release);
    });

    auto worker = [&]() {
        ZSTD_CCtx* cctx = level != 0 ? ZSTD_createCCtx() : nullptr;
        for (;;) {
            size_t i = next.fetch_add(1);
            // wait for chunk i to be published (or learn it never will be)
            while (published.load(std::memory_order_acquire) <= i) {
                if (failed.load(std::memory_order_relaxed)) goto out;
                if (total.load(std::memory_order_acquire) <= i) goto out;
                std::this_thread::yield();
            }
            {
                size_t start = i ? (size_t)boundaries[i - 1] : 0;
                size_t len = (size_t)boundaries[i] - start;
                sha256(data + start, len, hashes + 32 * i);
                if (level != 0) {
                    size_t bound = ZSTD_compressBound(len);
                    size_t csz = ZSTD_compressCCtx(
                        cctx, comp_out + comp_offsets[i], bound,
                        data + start, len, level);
                    if (ZSTD_isError(csz)) { failed = true; goto out; }
                    comp_sizes[i] = csz;
                } else {
                    comp_sizes[i] = 0;
                }
            }
        }
    out:
        if (cctx) ZSTD_freeCCtx(cctx);
    };

    std::vector<std::thread> pool;
    for (int t = 0; t < nt - 2; ++t) pool.emplace_back(worker);
    worker();  // the caller's thread works too
    producer.join();
    for (auto& th : pool) th.join();
    return failed ? 0 : total.load();
}

} // extern "C"
