// Fused KNN scans: a bf16 score product with a max/argmax epilogue over a
// fixed partition of the rows, on Hopper. The (B, N) score matrix never
// reaches device memory: only one (max, argmax) per part of the partition
// and query leaves the kernel.
//
// Replaces two Pallas kernels, one template each:
//   K1  yams_tpu/ops/scan.py `_grouped_max_kernel` / `grouped_topk_pallas`
//       (kGrouped): contiguous groups of `group` rows. For query b and group
//       g it emits max over r in [g*group, (g+1)*group) of
//       s[r] = q_b . E_r + (valid_r - 1) * 1e30, and the LAST row that
//       reaches it (the TPU kernel takes max(where(s >= m, lane, -1))). A
//       group with no live row scores -1e30 everywhere and so emits
//       (-1e30, g*group + group - 1). Out: (B, N/group), columns in global
//       group order: the TPU's (G, B, block/group) blocks transposed, which
//       is the same matrix whatever its block_rows, so the tiling here is
//       free.
//   K2  yams_tpu/ops/flash_topk.py `_kernel` / `windowed_scan` (kWindowed):
//       strided windows. Column j*128 + w holds the best of the 128 rows
//       {j*16384 + c*128 + w : c < 128} of s[r] = q_b . E_r + bias_r, folded
//       in increasing row order with a strict `>` from (-1e30, row 0): ties
//       go to the first row, and a window whose every score is <= -1e30
//       emits (-1e30, 0), row 0, not a row of that window, as the TPU
//       kernel's scratch starts. Out: (B, N/128).
//
// What bounds them on the H100: at the experiments' shapes K1 (1,003,520 x
// 768, B 256) needs 0.40 ms of tensor work against 1.54 GB read once
// (0.46 ms), so bytes; K2 (1,015,808 x 768, B 1,024) 1.62 ms of tensor work
// against 1.62 GB (0.49 ms), so operations. The epilogues are small beside
// either.
//
// Design: K3's tile (csrc/exact_topk.cu). One block of 16 warps owns 16
// queries; the query tile is staged in shared memory, and each warp
// computes 64-row x 16-query score tiles with the tensor cores' warp-level
// mma.sync (m16n8k16, bf16 in, f32 accumulate), A fragments straight from E
// in global memory, into a 16 x 2,048 f32 tile in shared memory (128 KB).
//   K1: a block scores one 2,048-row tile, which holds 2,048/group whole
//       groups (group is a power of two <= 2,048). Warp w reduces
//       (query, group) pairs: each lane keeps the max of its stripe with the
//       highest row on ties (`>=` in increasing order), and a butterfly of
//       shuffles keeps (max, highest row). Rows past N (a ragged last tile)
//       are loaded from row N-1 and never read back.
//   K2: a 16,384-row span is wider than a tile, and on the card blocks run
//       in no order, so nothing can carry a running pair between blocks as
//       the TPU's 32 inner grid steps do in VMEM scratch. One block loops
//       over the span's eight tiles in row order instead, and each thread
//       keeps the running (max, argmax) of 4 of the span's 16 x 128
//       (query, window) pairs in registers across them: one pass, no
//       partials in device memory, and the fold order is the TPU's.
// The query tile is the fast grid axis, so the blocks that read one row
// tile run together and find it in L2. No cuBLAS, no wgmma or TMA: a simple
// kernel that is right.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQT = 16;                 // queries per block: two n-tiles of 8
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMGroup = 4;              // 16-row m-tiles per warp pass
constexpr int kTile = 2048;             // rows scored into shared memory per pass
constexpr int kWindow = 128;            // K2: windows per span
constexpr int kSpan = 16384;            // K2: rows folded into one window block
constexpr int kPairs = kQT * kWindow / kThreads;   // K2: (query, window) pairs per thread
constexpr float kNeg = -1e30f;

enum Mode { kGrouped = 0, kWindowed = 1 };

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[qi * kTile + r] = q_tile[qi] . E[row0 + r] (f32 sums) for r < kTile;
// rows at or past n_rows read row n_rows - 1.
__device__ __forceinline__ void score_tile(const uint32_t* __restrict__ qs,
                                           const uint32_t* __restrict__ e,
                                           int64_t row0, int64_t n_rows, int dw,
                                           float* __restrict__ s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;   // fragment row (A) / column (B, C)
  const int tig = lane & 3;    // thread in group
  constexpr int kMTiles = kTile / 16;
  for (int mt0 = warp * kMGroup; mt0 < kMTiles; mt0 += kWarps * kMGroup) {
    float acc[kMGroup][2][4];
#pragma unroll
    for (int m = 0; m < kMGroup; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;
    const uint32_t* lo[kMGroup];
    const uint32_t* hi[kMGroup];
#pragma unroll
    for (int m = 0; m < kMGroup; ++m) {
      const int64_t r = row0 + (mt0 + m) * 16 + gid;
      lo[m] = e + (r < n_rows ? r : n_rows - 1) * dw;
      hi[m] = e + (r + 8 < n_rows ? r + 8 : n_rows - 1) * dw;
    }
    for (int kw = tig; kw < dw; kw += 8) {   // 16 dims = 8 words per step
      const uint32_t b00 = qs[gid * dw + kw], b01 = qs[gid * dw + kw + 4];
      const uint32_t b10 = qs[(8 + gid) * dw + kw], b11 = qs[(8 + gid) * dw + kw + 4];
#pragma unroll
      for (int m = 0; m < kMGroup; ++m) {
        uint32_t a[4];
        a[0] = __ldg(lo[m] + kw);
        a[1] = __ldg(hi[m] + kw);
        a[2] = __ldg(lo[m] + kw + 4);
        a[3] = __ldg(hi[m] + kw + 4);
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
        s[qc * kTile + r] = acc[m][n][0];
        s[(qc + 1) * kTile + r] = acc[m][n][1];
        s[qc * kTile + r + 8] = acc[m][n][2];
        s[(qc + 1) * kTile + r + 8] = acc[m][n][3];
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const uint32_t* __restrict__ q,    // (B, D/2) bf16 pairs
                  const uint32_t* __restrict__ e,    // (N, D/2) bf16 pairs
                  const float* __restrict__ aux,     // (N,): valid (K1) or bias (K2)
                  float* __restrict__ out_v,         // (B, N/group) or (B, N/128)
                  int32_t* __restrict__ out_i,
                  int B, int64_t N, int D, int group) {
  extern __shared__ float smem[];
  float* s = smem;                                                 // [kQT][kTile]
  uint32_t* qs = reinterpret_cast<uint32_t*>(s + kQT * kTile);     // [kQT][D/2]
  const int q0 = blockIdx.x * kQT;
  const int dw = D / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kQT * dw; i += kThreads) {
    const int qi = i / dw;
    qs[i] = (q0 + qi < B) ? q[static_cast<int64_t>(q0 + qi) * dw + (i - qi * dw)] : 0u;
  }
  __syncthreads();

  if constexpr (kMode == kGrouped) {
    const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
    score_tile(qs, e, row0, N, dw, s);
    __syncthreads();
    const int64_t n_groups = N / group;
    const int per_tile = kTile / group;
    for (int p = warp; p < kQT * per_tile; p += kWarps) {
      const int qi = p / per_tile;
      const int gi = p - qi * per_tile;
      const int b = q0 + qi;
      const int64_t g0 = row0 + static_cast<int64_t>(gi) * group;
      if (b >= B || g0 >= N) continue;
      const float* sq = s + qi * kTile + gi * group;
      float bv = __int_as_float(0xff800000u);   // -inf: a lane with no row loses
      int bi = -1;
      for (int c = lane; c < group; c += 32) {   // `>=`: the last row wins ties
        const float v = __fadd_rn(sq[c], __fmul_rn(__fsub_rn(aux[g0 + c], 1.0f), 1e30f));
        if (v >= bv) { bv = v; bi = c; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi > bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        const int64_t o = static_cast<int64_t>(b) * n_groups + g0 / group;
        out_v[o] = bv;
        out_i[o] = static_cast<int32_t>(g0 + bi);
      }
    }
  } else {
    const int64_t span0 = static_cast<int64_t>(blockIdx.y) * kSpan;
    float rv[kPairs];
    int32_t ri[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) { rv[k] = kNeg; ri[k] = 0; }
    for (int t = 0; t < kSpan / kTile; ++t) {
      const int64_t row0 = span0 + static_cast<int64_t>(t) * kTile;
      score_tile(qs, e, row0, N, dw, s);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int p = threadIdx.x + k * kThreads;
        const int qi = p / kWindow;
        const int w = p - qi * kWindow;
        const float* sq = s + qi * kTile;
        for (int c = w; c < kTile; c += kWindow) {   // increasing rows, strict `>`
          const float v = __fadd_rn(sq[c], aux[row0 + c]);
          if (v > rv[k]) { rv[k] = v; ri[k] = static_cast<int32_t>(row0 + c); }
        }
      }
      __syncthreads();   // the next tile overwrites s
    }
    const int64_t width = N / kSpan * kWindow;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = threadIdx.x + k * kThreads;
      const int qi = p / kWindow;
      const int w = p - qi * kWindow;
      if (q0 + qi >= B) continue;
      const int64_t o = static_cast<int64_t>(q0 + qi) * width + blockIdx.y * kWindow + w;
      out_v[o] = rv[k];
      out_i[o] = ri[k];
    }
  }
}

template <int kMode>
int launch(const void* q, const void* e, const void* aux, void* out_v, void* out_i,
           int64_t B, int64_t N, int64_t D, int64_t group, unsigned int grid_y,
           void* stream) {
  const size_t smem = sizeof(float) * kQT * kTile + sizeof(uint16_t) * kQT * D;
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((B + kQT - 1) / kQT), grid_y);
  fused_scan_kernel<kMode><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(e),
      static_cast<const float*>(aux), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), static_cast<int>(B), N, static_cast<int>(D),
      static_cast<int>(group));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int yt_grouped_max(const void* q, const void* e, const void* valid,
                              void* out_v, void* out_i, int64_t B, int64_t N,
                              int64_t D, int64_t group, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  return launch<kGrouped>(q, e, valid, out_v, out_i, B, N, D, group,
                          static_cast<unsigned int>((N + kTile - 1) / kTile), stream);
}

extern "C" int yt_windowed_scan(const void* q, const void* e, const void* bias,
                                void* out_v, void* out_i, int64_t B, int64_t N,
                                int64_t D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  return launch<kWindowed>(q, e, bias, out_v, out_i, B, N, D, 0,
                           static_cast<unsigned int>(N / kSpan), stream);
}
