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
// What bounds them on the H100: K1 at its experiment's shape (1,003,520 x
// 768, B 256) needs 0.40 ms of tensor work against 1.54 GB read once
// (0.46 ms), so bytes; K2 at its experiment's shape (1,015,808 x 768,
// B 1,024) needs 1.62 ms of tensor work against 1.62 GB (0.49 ms), so
// operations. The epilogues are small beside either.
//
// What held the first port back (a 16-query tile whose warps loaded E in
// 4-byte fragments): each E byte that reached an SM fed 2 x 16 FLOP, so E
// crossed from L2 into the SMs B/16 times and both kernels ran at ~45
// TFLOP/s, the rate of that traffic.
//
// Design: the shared mainloop of bf16_scan.cuh. A tile is 128 corpus rows x
// 256 queries, fed by TMA into a 4-stage ring and multiplied by wgmma, so
// each E byte in shared memory feeds 256 queries and E crosses from L2
// B/256 times (K1 at B 256: once; K2 at B 1,024: 4 times), with no load
// instruction per element. The scores stay in the wgmma accumulators (128
// f32 registers a consumer thread); no score tile is staged in shared
// memory. A block is persistent (one per SM) and walks (row tile, query
// tile) units, query tile fastest, so the blocks that read one row tile run
// at the same time and the tile comes from HBM once.
//
// Epilogue, after each tile: a thread holds 2 rows x 64 queries. Each
// column's maximum goes round the 8 lanes that share it by shuffles, 8
// columns side by side so one column's shuffles hide another's latency; a
// ballot of the lanes whose score equals the maximum names the winning row
// (K1 the last, K2 the first), so no row index is shuffled. Lanes 0-3 put
// each warp's 16-row partial into a 16 KB scratch, and after a barrier of
// the 256 consumer threads, thread t merges the 8 warps' partials of query t.
//   K2: the row tile is a window, not 128 consecutive rows. E is seen by a
//       3-D tensor map as (span chunk, window, D), and a box of one window x
//       128 chunks brings exactly the 128 rows {j*16384 + c*128 + w} of
//       window (j, w). The fold over a window is then a reduction over the
//       tile's rows and each unit emits one finished column: no running state
//       crosses units and no second merge pass is needed (neither persistent
//       span walks nor split spans), and the 31,744 units at the experiment's
//       shape (7,936 windows x 4 query tiles) spread evenly over 132 blocks.
//       The reduction takes the maximum and, among equal values, the lowest
//       row; a maximum <= -1e30 becomes (-1e30, 0). That is the fold's result
//       in any order of combination: the fold keeps the first row reaching
//       the largest value above -1e30, and (-1e30, 0) if none is above.
//   K1: a group of 16 rows or more is the merge of its warps' partials; a
//       group wider than the tile (up to 2,048 rows, 16 tiles) is one unit
//       whose tiles are folded in a register per query. Groups of 1-8 rows
//       (kGroupedSmall) are reduced inside a warp and written by their first
//       lane. Rows at or past N (a ragged last tile, which TMA fills with
//       zeros, and a 0 would beat a live negative score) are masked
//       explicitly, and their validity is never read.
// Queries past B (a partial query tile) are zeros from TMA and never
// written.

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16_scan.cuh"

namespace {

using namespace yt_scan;

constexpr int kWindow = 128;            // K2: windows per span = rows per window tile
constexpr int kSpan = kWindow * kRows;  // K2: rows folded into one block of 128 columns
constexpr int kWarps = kConsumerThreads / 32;   // warp w holds tile rows [16 w, 16 w + 16)
constexpr float kNeg = -1e30f;
constexpr int kBatch = 8;               // epilogue columns reduced side by side

// K1 has two instantiations, groups of 16 rows or more (kGrouped) and of
// 1-8 rows (kGroupedSmall), so that each kernel holds only the epilogue it
// runs.
enum Mode { kGrouped = 0, kWindowed = 1, kGroupedSmall = 2 };

struct Params {
  const float* aux;      // (N,): validity (K1) or bias (K2)
  float* out_v;
  int32_t* out_i;
  int B;
  int N;
  int k_slices;          // ceil(D / 64)
  int q_tiles;           // ceil(B / 256)
  int tiles_per_unit;    // K1: group / 128 for groups wider than a tile, else 1
  int64_t n_units;
  int group;             // K1 rows per group; K2 128 (one window per tile)
  int n_cols;            // output columns per query
};

// Per-warp partials of the cross-warp reduction.
struct Scratch {
  float v[kWarps][kQueries];
  int r[kWarps][kQueries];
};

// (value, row) order: K1 keeps the last row on equal values, K2 the first.
template <int kMode>
__device__ __forceinline__ void keep(float& bv, int& br, float v, int r) {
  const bool tie_wins = kMode == kWindowed ? r < br : r > br;
  if (v > bv || (v == bv && tie_wins)) { bv = v; br = r; }
}

// Global row of tile row rl (K2: tile t is window t % 128 of span t / 128).
template <int kMode>
__device__ __forceinline__ int tile_row(int t, int rl) {
  if constexpr (kMode != kWindowed) return t * kRows + rl;
  return (t / kWindow) * kSpan + rl * kWindow + t % kWindow;
}

// The winner among a warp's 16 rows of one column: lo_hit / hi_hit are the
// lanes of that column whose row lane/4 / 8 + lane/4 reaches the maximum.
// K1 takes the last such row, K2 the first. -> row 0..15 of the warp.
template <int kMode>
__device__ __forceinline__ int warp_winner(unsigned lo_hit, unsigned hi_hit) {
  if constexpr (kMode != kWindowed)
    return hi_hit ? 8 + ((31 - __clz(hi_hit)) >> 2) : (31 - __clz(lo_hit)) >> 2;
  return lo_hit ? (__ffs(lo_hit) - 1) >> 2 : 8 + ((__ffs(hi_hit) - 1) >> 2);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void put(const Params& p, int b, int col, float v, int r) {
  const int64_t o = static_cast<int64_t>(b) * p.n_cols + col;
  p.out_v[o] = v;
  p.out_i[o] = r;
}

// A consumer thread's two accumulator rows of tile t (tile rows rl0 and
// rl0 + 8): global rows, whether they lie below N, and their additive terms.
struct TileRows {
  int ra, rb;
  bool la, lb;
  float ta, tb;
};

template <int kMode>
__device__ __forceinline__ TileRows tile_rows(const Params& p, int t, int rl0) {
  TileRows r;
  r.ra = tile_row<kMode>(t, rl0);
  r.rb = tile_row<kMode>(t, rl0 + 8);
  if constexpr (kMode != kWindowed) {   // rows at or past N are TMA's zeros: masked
    r.la = r.ra < p.N;
    r.lb = r.rb < p.N;
    r.ta = r.la ? __fmul_rn(__fsub_rn(__ldg(p.aux + r.ra), 1.0f), 1e30f) : 0.f;
    r.tb = r.lb ? __fmul_rn(__fsub_rn(__ldg(p.aux + r.rb), 1.0f), 1e30f) : 0.f;
  } else {
    r.la = r.lb = true;
    r.ta = __ldg(p.aux + r.ra);
    r.tb = __ldg(p.aux + r.rb);
  }
  return r;
}

__device__ __forceinline__ float neg_inf() {   // loses to any score
  return __int_as_float(0xff800000u);
}

// Groups of 1-8 rows (K1): a thread's two rows lie in different groups. A
// group's lanes share its maximum by shuffles and a ballot of the lanes
// that reach it names its last row.
__device__ __forceinline__ void epilogue_small(const Params& p, const float (&acc)[kAccRegs],
                                               const TileRows& tr, int t, int q0, int ct) {
  const int lane = ct & 31, warp = ct >> 5;
  const int g0 = (lane >> 2) & ~(p.group - 1);
  const unsigned group_lanes = (0x11111111u << (lane & 3)) &
      ((p.group == 8 ? 0xffffffffu : (1u << (4 * p.group)) - 1) << (4 * g0));
  const bool writer = ((lane >> 2) & (p.group - 1)) == 0;
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) {
    const int hi = (i >> 1) & 1;
    const bool live = hi ? tr.lb : tr.la;
    const float s = live ? __fadd_rn(acc[i], hi ? tr.tb : tr.ta) : neg_inf();
    float m = s;
    for (int x = 4; x < 4 * p.group; x <<= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, x));
    const unsigned hit = __ballot_sync(~0u, s == m) & group_lanes;
    const int b = q0 + acc_col(ct & 127, i);
    if (writer && live && b < p.B) {
      const int r = tile_row<kGroupedSmall>(t, 16 * warp + 8 * hi + ((31 - __clz(hit)) >> 2));
      put(p, b, r / p.group, m, r);
    }
  }
}

// Groups of >= 16 rows (K2: the 128-row window): each column's best over
// the warp's 16 rows. Each column's maximum goes round its 8 lanes by
// shuffles, kBatch columns side by side, level by level, so one column's
// shuffles hide another's latency; a ballot of the lanes that reach it
// names the winning row, so no row index is carried or shuffled. The
// warp's partials go to red.
template <int kMode>
__device__ __forceinline__ void epilogue_warp(const float (&acc)[kAccRegs], const TileRows& tr,
                                              int t, int ct, Scratch* red) {
  const int lane = ct & 31, warp = ct >> 5;
  const unsigned same_col = 0x11111111u << (lane & 3);   // the lanes holding my columns
#pragma unroll
  for (int c0 = 0; c0 < kAccRegs / 2; c0 += kBatch) {
    float lo[kBatch], hi[kBatch], m[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {   // column c0 + c: registers i (row rl0), i + 2 (rl0 + 8)
      const int i = 2 * (c0 + c) - ((c0 + c) & 1);
      lo[c] = tr.la ? __fadd_rn(acc[i], tr.ta) : neg_inf();
      hi[c] = tr.lb ? __fadd_rn(acc[i + 2], tr.tb) : neg_inf();
      m[c] = fmaxf(lo[c], hi[c]);
    }
#pragma unroll
    for (int x = 4; x <= 16; x <<= 1)
#pragma unroll
      for (int c = 0; c < kBatch; ++c) m[c] = fmaxf(m[c], __shfl_xor_sync(~0u, m[c], x));
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const unsigned lo_hit = __ballot_sync(~0u, lo[c] == m[c]) & same_col;
      const unsigned hi_hit = __ballot_sync(~0u, hi[c] == m[c]) & same_col;
      if (lane < 4) {
        const int col = acc_col(ct & 127, 2 * (c0 + c) - ((c0 + c) & 1));
        red->v[warp][col] = m[c];
        red->r[warp][col] = tile_row<kMode>(t, 16 * warp + warp_winner<kMode>(lo_hit, hi_hit));
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
fused_scan_kernel(const __grid_constant__ CUtensorMap e_map,
                  const __grid_constant__ CUtensorMap q_map, const Params p) {
  extern __shared__ uint8_t smem[];
  Ring ring;
  Scratch* red = reinterpret_cast<Scratch*>(ring.carve(smem));
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    producer_regs();
    if (threadIdx.x == kConsumerThreads) {
      Cursor c;
      for (int64_t u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int q0 = static_cast<int>(u % p.q_tiles) * kQueries;
        const int t0 = static_cast<int>(u / p.q_tiles) * p.tiles_per_unit;
        for (int t = t0; t < t0 + p.tiles_per_unit; ++t) {
          produce_tile(ring, c, p.k_slices, [&](uint32_t e, uint32_t q, uint32_t bar, int k) {
            if constexpr (kMode != kWindowed)
              tma_load_2d(e, &e_map, bar, k * kK, t * kRows);
            else   // window (j, w) = tile t: chunks [128 j, 128 j + 128) of window w
              tma_load_3d(e, &e_map, bar, k * kK, t % kWindow, (t / kWindow) * kRows);
            tma_load_2d(q, &q_map, bar, k * kK, q0);
          });
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  consumer_regs();
  const int ct = threadIdx.x;
  const int rl0 = 64 * (ct >> 7) + acc_row(ct & 127, 0);   // this thread's tile rows: rl0, rl0 + 8
  float acc[kAccRegs];
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.f;

  Cursor c;
  for (int64_t u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int q0 = static_cast<int>(u % p.q_tiles) * kQueries;
    const int t0 = static_cast<int>(u / p.q_tiles) * p.tiles_per_unit;
    float run_v = neg_inf();   // K1, groups wider than a tile: query q0 + ct's running pair
    int run_r = -1;
    for (int t = t0; t < t0 + p.tiles_per_unit; ++t) {
      const TileRows tr = tile_rows<kMode>(p, t, rl0);
      consume_tile(ring, c, p.k_slices, ct >> 7, acc);
      if constexpr (kMode == kGroupedSmall) {
        epilogue_small(p, acc, tr, t, q0, ct);
        continue;
      }
      consumer_sync();   // the previous tile's readers are done with red
      epilogue_warp<kMode>(acc, tr, t, ct, red);
      consumer_sync();

      // thread ct finishes query q0 + ct: the warps of each group, in row order
      const int b = q0 + ct;
      const int wpg = (p.group < kRows ? p.group : kRows) / 16;   // warps per group in the tile
      for (int g0 = 0; g0 < kWarps; g0 += wpg) {
        float bv = neg_inf();
        int br = -1;
        for (int w = g0; w < g0 + wpg; ++w) keep<kMode>(bv, br, red->v[w][ct], red->r[w][ct]);
        if constexpr (kMode == kWindowed) {
          if (b < p.B) {
            if (bv > kNeg) put(p, b, t, bv, br);
            else put(p, b, t, kNeg, 0);
          }
        } else if (p.group <= kRows) {
          const int row0 = t * kRows + g0 * 16;
          if (b < p.B && row0 < p.N) put(p, b, row0 / p.group, bv, br);
        } else {
          keep<kMode>(run_v, run_r, bv, br);
        }
      }
      if (kMode == kGrouped && p.group > kRows && t == t0 + p.tiles_per_unit - 1 && b < p.B)
        put(p, b, (t0 * kRows) / p.group, run_v, run_r);
    }
  }
}

template <int kMode>
int launch(const CUtensorMap& e_map, const void* q, const void* aux, void* out_v, void* out_i,
           int64_t B, int64_t N, int64_t D, int group, int64_t tiles, int tiles_per_unit,
           int n_cols, void* stream) {
  CUtensorMap q_map;
  cudaError_t err = query_map(&q_map, q, B, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.aux = static_cast<const float*>(aux);
  p.out_v = static_cast<float*>(out_v);
  p.out_i = static_cast<int32_t*>(out_i);
  p.B = static_cast<int>(B);
  p.N = static_cast<int>(N);
  p.k_slices = static_cast<int>((D + kK - 1) / kK);
  p.q_tiles = static_cast<int>((B + kQueries - 1) / kQueries);
  p.tiles_per_unit = tiles_per_unit;
  p.n_units = tiles / tiles_per_unit * p.q_tiles;
  p.group = group;
  p.n_cols = n_cols;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = kRingSmem + static_cast<int>(sizeof(Scratch));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_scan_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = p.n_units < sms ? p.n_units : sms;   // persistent: one block per SM
  fused_scan_kernel<kMode><<<static_cast<unsigned int>(grid), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(e_map, q_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int yt_grouped_max(const void* q, const void* e, const void* valid,
                              void* out_v, void* out_i, int64_t B, int64_t N,
                              int64_t D, int64_t group, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  // E as (N rows, D): boxes of 64 dims x 128 consecutive rows
  CUtensorMap e_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kK, kRows};
  const cudaError_t err = bf16_map(&e_map, e, 2, dims, strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (N + kRows - 1) / kRows;
  const int per_unit = group > kRows ? static_cast<int>(group / kRows) : 1;
  if (group < 16)
    return launch<kGroupedSmall>(e_map, q, valid, out_v, out_i, B, N, D, static_cast<int>(group),
                                 tiles, per_unit, static_cast<int>(N / group), stream);
  return launch<kGrouped>(e_map, q, valid, out_v, out_i, B, N, D, static_cast<int>(group), tiles,
                          per_unit, static_cast<int>(N / group), stream);
}

extern "C" int yt_windowed_scan(const void* q, const void* e, const void* bias,
                                void* out_v, void* out_i, int64_t B, int64_t N,
                                int64_t D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  // E as (N/128 chunks, 128 windows, D): boxes of 64 dims x 1 window x 128
  // chunks, i.e. the 128 rows of one window of a span
  CUtensorMap e_map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(kWindow),
                              static_cast<cuuint64_t>(N / kWindow)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(D) * 2 * kWindow};
  const cuuint32_t box[3] = {kK, 1, kRows};
  const cudaError_t err = bf16_map(&e_map, e, 3, dims, strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<kWindowed>(e_map, q, bias, out_v, out_i, B, N, D, kWindow, N / kWindow, 1,
                           static_cast<int>(N / kWindow), stream);
}
