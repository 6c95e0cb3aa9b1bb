// Batched SHA-256 (FIPS 180-4), one thread per message, on Hopper.
//
// Replaces: yams_tpu/ops/sha256.py `sha256_pad_bytes` + `sha256_blocks` +
// `_digest_bytes` (an XLA lax.scan over blocks with a 64-round inner scan;
// not a Pallas kernel). Eager PyTorch would need ~50 launches per round,
// 64 rounds per block and thousands of blocks per chunk, so the round loop
// lives here.
//
// Row i of the batch is the byte range data[starts[i], starts[i]+lengths[i]);
// digests[i] receives its 32-byte digest. A padded (N, Lp) matrix is the
// case starts[i] = i * Lp; the ingest path passes the chunk boundaries of the
// uploaded payload instead, so no padded matrix is ever built.
//
// What bounds it on the H100: the dependency chain of one message. SHA-256 is
// sequential along a message, so the kernel's time is the longest chunk's
// block count times the latency of 64 dependent rounds; bytes moved (the
// payload once) and total integer work are small. At the ingest defaults
// (16/64/256 KiB chunks) a 128 MiB payload is ~2k messages: too few threads
// to fill 132 SMs, so the design spreads them thinly instead.
//
// Design: 32 threads per block so the ~2k messages land on as many SMs as
// possible; the message schedule is a 16-word ring in registers; FIPS padding
// (0x80, zeros, 64-bit big-endian bit length) is applied on the fly while a
// block's words are assembled, byte by byte because chunk starts are not
// aligned. Each thread walks its own message's blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__global__ void sha256_rows_kernel(const uint8_t* __restrict__ data,
                                   const int64_t* __restrict__ starts,
                                   const int32_t* __restrict__ lengths,
                                   uint8_t* __restrict__ digests, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint8_t* msg = data + starts[row];
  const int64_t len = lengths[row];
  const int64_t nblk = (len + 9 + 63) / 64;
  const uint64_t bits = static_cast<uint64_t>(len) * 8u;

  uint32_t H[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  for (int64_t b = 0; b < nblk; ++b) {
    const int64_t off = b * 64;
    uint32_t w[16];
    if (off + 64 <= len) {  // a full block of message bytes
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint8_t* p = msg + off + 4 * j;
        w[j] = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
               (uint32_t(p[2]) << 8) | uint32_t(p[3]);
      }
    } else {  // tail: message bytes, 0x80, zeros, bit length in the last block
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t pos = off + 4 * j + k;
          uint32_t byte = 0;
          if (pos < len) byte = msg[pos];
          else if (pos == len) byte = 0x80;
          word = (word << 8) | byte;
        }
        w[j] = word;
      }
      if (b == nblk - 1) {
        w[14] = static_cast<uint32_t>(bits >> 32);
        w[15] = static_cast<uint32_t>(bits);
      }
    }

    uint32_t a = H[0], bb = H[1], c = H[2], d = H[3];
    uint32_t e = H[4], f = H[5], g = H[6], h = H[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
        w[t & 15] = wt;
      }
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = h + S1 + ch + kK[t] + wt;
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint32_t t2 = S0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = bb; bb = a; a = t1 + t2;
    }
    H[0] += a; H[1] += bb; H[2] += c; H[3] += d;
    H[4] += e; H[5] += f; H[6] += g; H[7] += h;
  }
  uint8_t* out = digests + row * 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out[4 * j + 0] = static_cast<uint8_t>(H[j] >> 24);
    out[4 * j + 1] = static_cast<uint8_t>(H[j] >> 16);
    out[4 * j + 2] = static_cast<uint8_t>(H[j] >> 8);
    out[4 * j + 3] = static_cast<uint8_t>(H[j]);
  }
}

}  // namespace

extern "C" int yt_sha256_rows(const void* data, const void* starts,
                              const void* lengths, void* digests, int64_t n,
                              void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sha256_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(digests), n);
  return static_cast<int>(cudaGetLastError());
}
