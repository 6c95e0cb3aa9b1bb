// Batched SHA-256 (FIPS 180-4) of byte ranges of one buffer, on Hopper.
//
// Replaces: yams_tpu/ops/sha256.py:55 `sha256_blocks`, with
// `sha256_pad_bytes` and `_digest_bytes` around it: an XLA lax.scan over
// blocks with a 64-round inner scan, not a Pallas kernel.
//
// Row i of the batch is the byte range data[starts[i], starts[i]+lengths[i]);
// digests[i] receives its 32-byte digest. A padded (N, Lp) matrix is the case
// starts[i] = i * Lp; the ingest path passes the chunk boundaries of the
// uploaded payload instead, so no padded matrix is ever built.
//
// What bounds it on the H100: the chain of dependent rounds of the longest
// message. SHA-256 is sequential along a message: block b+1 starts from the
// state block b leaves, and round t+1 from round t's. So no design beats the
// longest message's block count x 64 rounds x the time one warp takes for a
// round. That time is set by the integer pipe: ptxas makes a round of 12
// shifts, logic ops and adds on it (and 2 adds as IMADs on the FMA pipe),
// and with 16 integer lanes a sub-partition each warp instruction holds it
// for two cycles, so a round takes 24 cycles at least, and the dependent
// latency of about four of them adds to that. The bytes (the payload once) and the integer operations
// summed over all messages are small beside that chain: at the ingest
// defaults a 128 MiB payload is ~1,000 chunks of up to 256 KiB, and the
// longest one alone is ~4,100 blocks x 64 rounds.
//
// Design: one CTA hashes 32 messages, one per lane of its round warp, and
// that warp runs nothing but the compression, so each message's chain runs
// at close to the rate at which one warp can issue its rounds.
//   - The wrapper orders the rows by block count, longest first (`order`),
//     so the 32 messages of a CTA are of like length and the longest start
//     first. Digests are written at the rows' own indices.
//   - Warp 0 is the round warp; warps 1-3 are helper warps on the SM's other
//     three sub-partitions, so they take no issue slot from it. Helper h owns
//     spans h, h+3, h+6, ... of kSpanBlocks 64-byte blocks of every lane. Its
//     lane L copies message L's span, 16-byte cp.async aligned down with the
//     lead offset kept, into a two-stage ring of its own (the next span is in
//     flight while it works on this one: the copy and its reader are the same
//     thread, so cp.async groups hand it over). It then builds each block's
//     big-endian words from 16-byte shared loads and byte permutes, applies
//     the padding (0x80, zeros, the 64-bit bit length) in the final blocks,
//     expands the message schedule and stores W[t] + K[t], t = 0..63, into a
//     ring of kSlots schedule slots laid out [slot][t/4][lane] (uint4), so the
//     round warp's reads are conflict-free. Helper h owns slots
//     [h*kSpanBlocks, (h+1)*kSpanBlocks), and a slot is handed over by two
//     mbarriers: `full` (32 helper lanes arrive) and `empty` (32 round lanes).
//   - The round warp reads one uint4 of W+K per four rounds, keeps the state
//     in registers and has no branch inside the round loop. It runs every
//     block up to the CTA's longest message; a lane whose message has ended
//     keeps its state (the sum is predicated), so its digest is frozen.
//   - No load leaves [data, data + nbytes): a 16-byte unit that crosses the
//     buffer's end copies only the bytes inside (cp.async zero-fills the
//     rest), one that crosses its start (a buffer not 16-byte aligned) is
//     read byte by byte, and units past a message's end are not copied.
// Tensor cores, wgmma and TMA tensor maps do not apply to a 32-bit integer
// hash, so none is used.

#include "bf16_scan.cuh"   // smem_u32, mbar_init, mbar_arrive, mbar_wait

namespace {

using yt_scan::mbar_arrive;
using yt_scan::mbar_init;
using yt_scan::mbar_wait;
using yt_scan::smem_u32;

__constant__ uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr int kLanes = 32;                       // messages a CTA
constexpr int kHelpers = 3;                      // helper warps
constexpr int kThreads = kLanes * (1 + kHelpers);
constexpr int kSpanBlocks = 4;                   // blocks a helper copies a lane at a time
constexpr int kSpanUnits = kSpanBlocks * 4 + 1;  // 16-byte units: 256 bytes + the lead offset
constexpr int kSlots = kSpanBlocks * kHelpers;   // schedule slots, 8 KiB each

struct Smem {
  uint4 sched[kSlots][16][kLanes];                 // W[t] + K[t]: [slot][t/4][lane]
  uint4 bytes[kHelpers][2][kLanes][kSpanUnits];    // [helper][stage][lane][unit]
  uint64_t full[kSlots];
  uint64_t empty[kSlots];
};
constexpr int kSmem = sizeof(Smem);              // 150,720 bytes

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// Copy span `span` of one lane's message (bytes [64 span kSpanBlocks, +256)
// of data[start, start + len)) into `dst`, aligned down to 16 bytes. Units
// past the message's end are skipped; none reads outside [lo, hi).
__device__ __forceinline__ void copy_span(uint4* dst, const uint8_t* lo, const uint8_t* hi,
                                          const uint8_t* msg, int64_t len, int span) {
  const int64_t off = static_cast<int64_t>(span) * kSpanBlocks * 64;
  if (off >= len) return;   // nothing of the message in this span (the padding needs none)
  const uintptr_t first = reinterpret_cast<uintptr_t>(msg + off) & ~uintptr_t(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(msg + len);
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(lo), b1 = reinterpret_cast<uintptr_t>(hi);
#pragma unroll
  for (int u = 0; u < kSpanUnits; ++u) {
    const uintptr_t at = first + 16 * u;
    if (at >= end) break;
    if (at >= b0) {
      const int64_t in = static_cast<int64_t>(b1 - at);
      cp_async16(smem_u32(dst + u), reinterpret_cast<const void*>(at), in < 16 ? int(in) : 16);
    } else {   // the unit begins before the buffer: only its bytes inside are read
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; j < 16; ++j)
        if (at + j >= b0 && at + j < b1)
          w[j >> 2] |= uint32_t(*reinterpret_cast<const uint8_t*>(at + j)) << (8 * (j & 3));
      dst[u] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Block k of a span: its 16 big-endian words, from the lane's staged bytes
// whose first message byte sits `lead` bytes into unit 0.
__device__ __forceinline__ void block_words(const uint4* src, int lead, int k, uint32_t (&w)[16]) {
  uint32_t x[20];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const uint4 t = src[4 * k + v];
    x[4 * v] = t.x; x[4 * v + 1] = t.y; x[4 * v + 2] = t.z; x[4 * v + 3] = t.w;
  }
  // shift by lead / 4 words with selects (no indexed registers), then by
  // lead % 4 bytes and into big-endian order with one permute a word
  const bool two = lead & 8, one = lead & 4;
  uint32_t y[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) y[i] = two ? x[i + 2] : x[i];
#pragma unroll
  for (int i = 0; i < 17; ++i) y[i] = one ? y[i + 1] : y[i];
  const uint32_t sel = 0x0123u + 0x1111u * (lead & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __byte_perm(y[j], y[j + 1], sel);
}

// FIPS 180-4 padding of block b of a message of len bytes and nblk blocks:
// bytes from len on are 0x80 then zeros; the last block ends with len * 8.
__device__ __forceinline__ void pad_block(uint32_t (&w)[16], int64_t b, int64_t len, int64_t nblk) {
  const int64_t p0 = 64 * b;
  if (p0 + 64 <= len) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t rem = len - (p0 + 4 * j);   // message bytes left at this word
    const uint32_t keep = rem >= 4 ? 0xffffffffu : rem <= 0 ? 0u : ~(0xffffffffu >> (8 * rem));
    const uint32_t mark = (rem >= 0 && rem < 4) ? 0x80000000u >> (8 * rem) : 0u;
    w[j] = (w[j] & keep) | mark;
  }
  if (b == nblk - 1) {
    const uint64_t bits = static_cast<uint64_t>(len) * 8u;
    w[14] = static_cast<uint32_t>(bits >> 32);
    w[15] = static_cast<uint32_t>(bits);
  }
}

// Expand the schedule and store W[t] + K[t] at dst[(t / 4) * kLanes].
__device__ __forceinline__ void store_schedule(uint32_t (&w)[16], uint4* dst) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * q + i;
      if (t >= 16) {
        const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[t & 15] += s0 + w[(t - 7) & 15] + s1;
      }
      o[i] = w[t & 15] + kK[t];
    }
    dst[q * kLanes] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__device__ __forceinline__ void sha_round(uint32_t (&v)[8], uint32_t wk) {
  const uint32_t e = v[4], a = v[0];
  const uint32_t t1 = v[7] + wk + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                      ((e & v[5]) ^ (~e & v[6]));
  const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                      ((a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]));
  v[7] = v[6]; v[6] = v[5]; v[5] = e; v[4] = v[3] + t1;
  v[3] = v[2]; v[2] = v[1]; v[1] = a; v[0] = t1 + t2;
}

// The 64 rounds of one block on the working state v, reading W + K from the
// slot's column of this lane.
__device__ __forceinline__ void compress(uint32_t (&v)[8], const uint4* wk) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 k4 = wk[q * kLanes];
    sha_round(v, k4.x); sha_round(v, k4.y); sha_round(v, k4.z); sha_round(v, k4.w);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sha256_rows_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                   const int64_t* __restrict__ starts, const int32_t* __restrict__ lengths,
                   const int64_t* __restrict__ order, uint8_t* __restrict__ digests,
                   int64_t n) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // every warp reads the CTA's 32 rows: lane L works on message L
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kLanes + lane;
  int64_t row = -1, start = 0, len = 0;
  if (at < n) {
    row = order[at];
    start = starts[row];
    len = lengths[row];
  }
  const int64_t nblk = row >= 0 ? (len + 9 + 63) / 64 : 0;
  const int nb = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(nblk)));

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(smem_u32(&s.full[i]), kLanes);
      mbar_init(smem_u32(&s.empty[i]), kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {   // the round warp
    uint32_t H[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    for (int b = 0; b < nb; ++b) {
      const int slot = b % kSlots;
      mbar_wait(smem_u32(&s.full[slot]), (b / kSlots) & 1);
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = H[i];
      compress(v, &s.sched[slot][0][lane]);
      mbar_arrive(smem_u32(&s.empty[slot]));
      const bool live = b < nblk;
#pragma unroll
      for (int i = 0; i < 8; ++i) H[i] += live ? v[i] : 0u;
    }
    if (row >= 0) {
      uint4* out = reinterpret_cast<uint4*>(digests + row * 32);
      out[0] = make_uint4(__byte_perm(H[0], 0, 0x0123), __byte_perm(H[1], 0, 0x0123),
                          __byte_perm(H[2], 0, 0x0123), __byte_perm(H[3], 0, 0x0123));
      out[1] = make_uint4(__byte_perm(H[4], 0, 0x0123), __byte_perm(H[5], 0, 0x0123),
                          __byte_perm(H[6], 0, 0x0123), __byte_perm(H[7], 0, 0x0123));
    }
    return;
  }

  // a helper warp: spans h, h + kHelpers, ... of every lane
  const int h = warp - 1;
  const int spans = (nb + kSpanBlocks - 1) / kSpanBlocks;
  const uint8_t* msg = data + start;
  const uint8_t* end = data + nbytes;
  uint4 (*ring)[kLanes][kSpanUnits] = s.bytes[h];
  copy_span(ring[0][lane], data, end, msg, len, h);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  copy_span(ring[1][lane], data, end, msg, len, h + kHelpers);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int span = h, i = 0; span < spans; span += kHelpers, ++i) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // this span's copies landed
    const uint4* src = ring[i & 1][lane];
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(
        msg + static_cast<int64_t>(span) * kSpanBlocks * 64) & 15);
    for (int k = 0; k < kSpanBlocks; ++k) {
      const int b = span * kSpanBlocks + k;
      if (b >= nb) break;
      const int slot = b % kSlots;   // = h * kSpanBlocks + k
      mbar_wait(smem_u32(&s.empty[slot]), ((b / kSlots) & 1) ^ 1);
      uint32_t w[16];
      block_words(src, lead, k, w);
      pad_block(w, b, len, nblk);
      store_schedule(w, &s.sched[slot][0][lane]);
      mbar_arrive(smem_u32(&s.full[slot]));
    }
    copy_span(ring[i & 1][lane], data, end, msg, len, span + 2 * kHelpers);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" int yt_sha256_rows(const void* data, int64_t nbytes, const void* starts,
                              const void* lengths, const void* order, void* digests,
                              int64_t n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(sha256_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ctas = (n + kLanes - 1) / kLanes;
  sha256_rows_kernel<<<static_cast<unsigned int>(ctas), kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(lengths), static_cast<const int64_t*>(order),
      static_cast<uint8_t*>(digests), n);
  return static_cast<int>(cudaGetLastError());
}
