// Gear rolling hash for content-defined chunking, on Hopper.
//
// Replaces: yams_tpu/ops/cdc.py `_cdc_block_kernel` / `gear_hash_pallas`
// (the Pallas kernel K5).
//
// Computes h[i] = sum_{j<32} g[i-j] << j (mod 2^32), where positions i-j < 0
// contribute 0. g holds the per-byte gear values (host table lookup done by
// the caller), so the output equals the sequential gear hash
// h = (h << 1) + GEAR[b] of the C++ and NumPy chunkers at every position.
//
// What bounds it on the H100: memory. Each position reads 4 bytes of g and
// writes 4 bytes of h; the 32 shifted adds are ~64 integer ops, far below
// the card's integer rate, so at 3.35 TB/s the kernel needs ~0.16 ms for
// 64 Mi positions. In the ingest path the card-side gear lookup and the
// host-to-device copy of the payload cost more than this kernel.
//
// Design: one block owns a tile of TILE consecutive positions. It stages the
// tile plus the WINDOW-1 gear values before it in shared memory with
// coalesced loads (the TPU kernel needed a separate halo input because
// BlockSpec windows cannot overlap; here the block reads the 31 values before
// its tile straight from global memory). Each thread then sums its 32 terms
// from shared memory, neighbouring threads on neighbouring positions, so the
// reads are bank-conflict free and the stores coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 positions per block

__global__ void gear_hash_kernel(const uint32_t* __restrict__ g,
                                 uint32_t* __restrict__ h, int64_t n) {
  __shared__ uint32_t s[kTile + kWindow - 1];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int k = threadIdx.x; k < kTile + kWindow - 1; k += kThreads) {
    const int64_t p = base - (kWindow - 1) + k;
    s[k] = (p >= 0 && p < n) ? g[p] : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int local = it * kThreads + threadIdx.x;
    const int64_t p = base + local;
    if (p < n) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        acc += s[local + kWindow - 1 - j] << j;
      }
      h[p] = acc;
    }
  }
}

}  // namespace

extern "C" int yt_gear_hash(const void* g, void* h, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kTile - 1) / kTile;
  gear_hash_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<uint32_t*>(h), n);
  return static_cast<int>(cudaGetLastError());
}
