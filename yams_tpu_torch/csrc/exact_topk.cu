// Exact KNN block step: per row block, each query's top-k, on Hopper.
//
// Replaces: yams_tpu/ops/scan.py `_topk_block_kernel` / `exact_topk_pallas`
// (the Pallas kernel K3).
//
// For row block g (block_rows rows of E) and query b it emits the k pairs
// (score, row) that k rounds of "max, first argmax, knock the winner out to
// -1e30" give over s[r] = q_b . E_r + (valid_r - 1) * 1e30: the block's
// top-k by score, then lower row. When fewer than k live rows remain, every
// further round sees only -1e30 and picks the block's first row again, so
// those slots hold (-1e30, block start), as on the TPU. The caller merges the
// G * k candidates with a top-k.
//
// What bounds it on the H100: the product. At the bench shape (1,048,576 x
// 768 corpus, 1,024 queries) it is 1.65 TFLOP of bf16 products with f32
// sums, against 0.4 MB of output; the per-block selection is k passes over a
// 2,048-float row in shared memory, small beside it.
//
// Design: one block of 16 warps owns (one row block, 16 queries). The query
// tile is staged in shared memory; each warp computes 64-row x 16-query
// score tiles with the tensor cores' warp-level mma.sync (m16n8k16, bf16 in,
// f32 accumulate): A fragments straight from E in global memory, B fragments
// from the query tile. The 16 x block_rows f32 score tile lands in shared
// memory (128 KB at 2,048 rows), the validity bias is added, and then warp w
// runs query w's k rounds: each lane keeps the max of its stripe (lowest
// column on ties), a butterfly of shuffles picks the warp's (max, lowest
// column), and the owning lane knocks it out. The query tile is the fast
// grid axis, so the 64 blocks that read one row block run together and find
// it in L2. No cuBLAS, no wgmma or TMA: a simple kernel that is right.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQT = 16;                 // queries per block: two n-tiles of 8
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMGroup = 4;              // 16-row m-tiles per warp pass
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
exact_topk_kernel(const uint32_t* __restrict__ q,    // (B, D/2) bf16 pairs
                  const uint32_t* __restrict__ e,    // (N, D/2) bf16 pairs
                  const float* __restrict__ valid,   // (N,)
                  float* __restrict__ out_v,         // (G, B, k)
                  int32_t* __restrict__ out_i,       // (G, B, k)
                  int B, int D, int k, int block_rows) {
  extern __shared__ float smem[];
  float* s = smem;                                              // [kQT][block_rows]
  uint32_t* qs = reinterpret_cast<uint32_t*>(s + kQT * block_rows);  // [kQT][D/2]
  const int q0 = blockIdx.x * kQT;
  const int g = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(g) * block_rows;
  const int dw = D / 2;

  for (int i = threadIdx.x; i < kQT * dw; i += kThreads) {
    const int qi = i / dw;
    qs[i] = (q0 + qi < B) ? q[static_cast<int64_t>(q0 + qi) * dw + (i - qi * dw)] : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;   // fragment row (A) / column (B, C)
  const int tig = lane & 3;    // thread in group
  const int mtiles = block_rows / 16;
  for (int mt0 = warp * kMGroup; mt0 < mtiles; mt0 += kWarps * kMGroup) {
    float acc[kMGroup][2][4];
#pragma unroll
    for (int m = 0; m < kMGroup; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;
    const uint32_t* erow[kMGroup];
#pragma unroll
    for (int m = 0; m < kMGroup; ++m)
      erow[m] = e + (row0 + (mt0 + m) * 16 + gid) * dw;
    for (int kw = tig; kw < dw; kw += 8) {   // 16 dims = 8 words per step
      const uint32_t b00 = qs[gid * dw + kw], b01 = qs[gid * dw + kw + 4];
      const uint32_t b10 = qs[(8 + gid) * dw + kw], b11 = qs[(8 + gid) * dw + kw + 4];
#pragma unroll
      for (int m = 0; m < kMGroup; ++m) {
        uint32_t a[4];
        a[0] = __ldg(erow[m] + kw);
        a[1] = __ldg(erow[m] + 8 * dw + kw);
        a[2] = __ldg(erow[m] + kw + 4);
        a[3] = __ldg(erow[m] + 8 * dw + kw + 4);
        mma_bf16(acc[m][0], a, b00, b01);
        mma_bf16(acc[m][1], a, b10, b11);
      }
    }
    // C fragment: c0 (row gid, query 2*tig), c1 (gid, 2*tig+1),
    //             c2 (gid+8, 2*tig), c3 (gid+8, 2*tig+1)
#pragma unroll
    for (int m = 0; m < kMGroup; ++m) {
      const int r = (mt0 + m) * 16 + gid;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int qc = n * 8 + 2 * tig;
        s[qc * block_rows + r] = acc[m][n][0];
        s[(qc + 1) * block_rows + r] = acc[m][n][1];
        s[qc * block_rows + r + 8] = acc[m][n][2];
        s[(qc + 1) * block_rows + r + 8] = acc[m][n][3];
      }
    }
  }
  __syncthreads();

  for (int qi = warp; qi < kQT; qi += kWarps) {
    const int b = q0 + qi;
    if (b >= B) break;
    float* sq = s + qi * block_rows;
    for (int c = lane; c < block_rows; c += 32)
      sq[c] = __fadd_rn(sq[c], __fmul_rn(__fsub_rn(valid[row0 + c], 1.0f), 1e30f));
    __syncwarp();
    const int64_t out0 = (static_cast<int64_t>(g) * B + b) * k;
    for (int j = 0; j < k; ++j) {
      float bv = sq[lane];
      int bi = lane;
      for (int c = lane + 32; c < block_rows; c += 32) {
        const float v = sq[c];
        if (v > bv) { bv = v; bi = c; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        out_v[out0 + j] = bv;
        out_i[out0 + j] = static_cast<int32_t>(row0 + bi);
      }
      if (lane == (bi & 31)) sq[bi] = kNeg;
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int yt_exact_topk(const void* q, const void* e, const void* valid,
                             void* out_v, void* out_i, int64_t B, int64_t N,
                             int64_t D, int64_t k, int64_t block_rows, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const size_t smem = sizeof(float) * kQT * block_rows + sizeof(uint16_t) * kQT * D;
  cudaError_t err = cudaFuncSetAttribute(
      exact_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((B + kQT - 1) / kQT),
                  static_cast<unsigned int>(N / block_rows));
  exact_topk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(e),
      static_cast<const float*>(valid), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), static_cast<int>(B), static_cast<int>(D),
      static_cast<int>(k), static_cast<int>(block_rows));
  return static_cast<int>(cudaGetLastError());
}
