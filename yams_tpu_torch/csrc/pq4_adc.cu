// Grouped ADC scan of the packed 4-bit PQ capacity tier, on Hopper.
//
// Replaces: yams_tpu/ops/pq_pallas.py `_adc_kernel` / `pq4_adc_grouped`
// (the Pallas kernel K4).
//
// Row r holds m 4-bit codes packed two to a byte: subspace s = 2p + parity
// is the low nibble of byte p for even s and the high nibble for odd s. For
// query b its score is sum_s LUT[b][s][code_s(r)] over the bf16 LUT, summed
// in f32 in subspace order, plus (valid_r - 1) * 1e30. Each run of `group`
// consecutive rows (aligned to multiples of group) gives one (max, lowest
// row with that max) pair: out (B, N / group).
//
// What bounds it on the H100: shared-memory LUT reads. At the capacity
// shape (16,777,216 rows, m = 48, 256 queries) the scan makes 2.1e11 LUT
// lookups; the packed codes are only 403 MB. The TPU kernel turned the
// lookup into a one-hot matmul on its MXU; here each lookup is one 16-bit
// shared-memory load, one conversion and one f32 add.
//
// Design: a block of 256 threads owns 32 queries and a span of 32 tiles of
// 256 rows. It stages its queries' LUT once in shared memory, laid out
// [s][query][16 values], so the 32 lanes of a warp that look up one
// (subspace, query) read within one 32-byte run of 8 banks: no bank
// conflicts. Per tile the rows' code bytes are staged with coalesced loads,
// each thread scores one row for the 32 queries in registers, and the group
// reduction runs as a shuffle butterfly over min(group, 32) lanes; groups of
// 64-256 rows combine their warps' results through shared memory in row
// order. The LUT is built by the caller (a small f32 product, rounded to
// bf16), like the TPU kernel's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 32;           // queries per block
constexpr int kTiles = 32;        // 256-row tiles per block

__device__ __forceinline__ void take_max(float& v, int32_t& i, float ov, int32_t oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__global__ void __launch_bounds__(kThreads)
pq4_adc_kernel(const __nv_bfloat16* __restrict__ lut,   // (B, m, 16)
               const uint8_t* __restrict__ codes,       // (N, m/2)
               const float* __restrict__ valid,         // (N,)
               float* __restrict__ out_v,               // (B, N/group)
               int32_t* __restrict__ out_i,             // (B, N/group)
               int B, int m, int64_t N, int group) {
  extern __shared__ unsigned char smem[];
  const int mp = m / 2;
  __nv_bfloat16* lt = reinterpret_cast<__nv_bfloat16*>(smem);     // [m][kQB][16]
  float* red_v = reinterpret_cast<float*>(lt + m * kQB * 16);      // [kQB][kWarps]
  int32_t* red_i = reinterpret_cast<int32_t*>(red_v + kQB * kWarps);
  uint8_t* cs = reinterpret_cast<uint8_t*>(red_i + kQB * kWarps);  // [256][mp]

  const int b0 = blockIdx.y * kQB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < m * kQB * 16; i += kThreads) {
    const int v = i & 15;
    const int b = (i >> 4) % kQB;
    const int s = i / (16 * kQB);
    lt[i] = (b0 + b < B) ? lut[(static_cast<int64_t>(b0 + b) * m + s) * 16 + v]
                         : __float2bfloat16(0.f);
  }
  const int64_t W = N / group;

  for (int t = 0; t < kTiles; ++t) {
    const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kTiles + t) * kThreads;
    if (row0 >= N) break;
    const int64_t rows = (N - row0 < kThreads) ? (N - row0) : kThreads;
    __syncthreads();   // LUT staged / previous tile's codes and partials consumed
    for (int64_t i = tid; i < rows * mp; i += kThreads) cs[i] = codes[row0 * mp + i];
    __syncthreads();

    const int64_t row = row0 + tid;
    const bool live = tid < rows;
    float acc[kQB];
#pragma unroll
    for (int b = 0; b < kQB; ++b) acc[b] = 0.f;
    if (live) {
      const uint8_t* my = cs + tid * mp;
      for (int p = 0; p < mp; ++p) {
        const uint32_t byte = my[p];
        const __nv_bfloat16* lo = lt + (2 * p) * kQB * 16 + (byte & 15u);
        const __nv_bfloat16* hi = lt + (2 * p + 1) * kQB * 16 + (byte >> 4);
#pragma unroll
        for (int b = 0; b < kQB; ++b) acc[b] = __fadd_rn(acc[b], __bfloat162float(lo[b * 16]));
#pragma unroll
        for (int b = 0; b < kQB; ++b) acc[b] = __fadd_rn(acc[b], __bfloat162float(hi[b * 16]));
      }
      const float bias = __fmul_rn(__fsub_rn(valid[row], 1.0f), 1e30f);
#pragma unroll
      for (int b = 0; b < kQB; ++b) acc[b] = __fadd_rn(acc[b], bias);
    }

    const int span = group < 32 ? group : 32;
#pragma unroll
    for (int b = 0; b < kQB; ++b) {
      float v = acc[b];
      int32_t i = static_cast<int32_t>(row);
      for (int off = 1; off < span; off <<= 1)
        take_max(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                 __shfl_xor_sync(0xffffffffu, i, off));
      if (group <= 32) {
        if (live && (lane & (group - 1)) == 0 && b0 + b < B)
          { out_v[(b0 + b) * W + row / group] = v; out_i[(b0 + b) * W + row / group] = i; }
      } else if (lane == 0) {
        red_v[b * kWarps + warp] = v;
        red_i[b * kWarps + warp] = i;
      }
    }
    if (group > 32) {
      __syncthreads();
      const int per = group / 32;              // warps per group
      const int wins = kThreads / group;       // groups per tile
      for (int item = tid; item < kQB * wins; item += kThreads) {
        const int b = item / wins, w = item % wins;
        const int64_t first = row0 + static_cast<int64_t>(w) * group;
        if (first >= N || b0 + b >= B) continue;
        float v = red_v[b * kWarps + w * per];
        int32_t i = red_i[b * kWarps + w * per];
        for (int j = 1; j < per; ++j)
          take_max(v, i, red_v[b * kWarps + w * per + j], red_i[b * kWarps + w * per + j]);
        out_v[(b0 + b) * W + first / group] = v;
        out_i[(b0 + b) * W + first / group] = i;
      }
    }
  }
}

}  // namespace

extern "C" int yt_pq4_adc(const void* lut, const void* codes, const void* valid,
                          void* out_v, void* out_i, int64_t B, int64_t m,
                          int64_t N, int64_t group, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const size_t smem = sizeof(__nv_bfloat16) * m * kQB * 16
                      + (sizeof(float) + sizeof(int32_t)) * kQB * kWarps
                      + static_cast<size_t>(kThreads) * (m / 2);
  cudaError_t err = cudaFuncSetAttribute(
      pq4_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = static_cast<int64_t>(kThreads) * kTiles;
  const dim3 grid(static_cast<unsigned int>((N + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned int>((B + kQB - 1) / kQB));
  pq4_adc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(valid), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), static_cast<int>(B), static_cast<int>(m), N,
      static_cast<int>(group));
  return static_cast<int>(cudaGetLastError());
}
