// Grouped ADC scan of the packed 4-bit PQ capacity tier, on Hopper: the
// lookups as a one-hot product on the tensor cores.
//
// Replaces: yams_tpu/ops/pq_pallas.py:44 `_adc_kernel`, called at :113
// `pq4_adc_grouped` (the Pallas kernel K4).
//
// Row r holds m 4-bit codes packed two to a byte: subspace s = 2p + parity
// is the low nibble of byte p for even s and the high nibble for odd s. For
// query b its score is sum_s LUT[b][s][code_s(r)] over the bf16 LUT, summed
// in f32 in subspace order, plus (valid_r - 1) * 1e30. Each run of `group`
// consecutive rows (aligned to multiples of group) gives one (max, lowest
// row with that max) pair: out (B, N / group).
//
// What bounds it on the H100: the lookups. At the capacity shape
// (16,777,216 rows, m 48, 256 queries) the scan makes 2.06e11 of them
// against 403 MB of codes. As shared-memory loads (one 16-bit load, one
// conversion and one f32 add each, the first port) they are capped near one
// warp-wide load a clock per SM, ~24.6 ms. As a one-hot product they are
// tensor-core work: 16.7M rows x 16m x 256 x 2 = 6.6 TFLOP at m 48, 6.7 ms
// at the bf16 peak.
//
// Design: the TPU kernel's own formulation. The LUT (B, m, 16) is a
// (B, 16m) matrix whose column 16 s + v is subspace s and code v: a K-major
// wgmma B operand in which one k16 step is one subspace. A is the one-hot
// of the rows' codes, built in registers (1.0 = 0x3F80 in the column of the
// code, zeros elsewhere), so wgmma m64nNk16 with A from registers adds, per
// row and query, exactly one LUT entry a step.
//   - A block (two consumer warpgroups, 64 rows each) owns one tile of n
//     queries and a contiguous span of 128-row tiles. It loads that query
//     tile's LUT once, by TMA with the 128-byte swizzle, in slices of 4
//     subspaces (n rows of 128 bytes), and keeps it resident in shared
//     memory; the codes (64 m bytes a tile) are the only operand streamed,
//     double-buffered by cp.async while the current tile's wgmmas run.
//   - n is chosen by m so that the whole contract (m <= 200) fits the 227 KB
//     of shared memory: the launch picks the largest of 128, 64, 32, 16
//     whose LUT, code buffers and epilogue scratch fit (128 up to m 48, 64
//     up to m 104, 32 up to m 192, 16 beyond; `query_tile`), rather than
//     streaming LUT slices through a ring, and halves it while half still
//     covers B. The slices are padded to an even count
//     (two A fragment sets in flight); the padding subspaces get all-zero
//     one-hots and a zero-filled LUT slice.
//   - Per slice a thread turns its two rows' nibbles into four one-hot A
//     fragments (shift, compare, select); one slice's wgmmas run while the
//     next slice's fragments are built.
//   - Epilogue: the validity bias is added after the sum, as the twin does;
//     rows past N (a ragged last tile) are masked. Groups of 1-8 rows are
//     reduced inside a warp by shuffles, and a ballot of the lanes that reach
//     the maximum names the lowest row. Groups of 16 rows or more: each
//     warp's 16-row (max, lowest row) per query goes to a scratch, and after
//     a barrier thread b merges the warps of each group in row order; a
//     256-row group spans two tiles, folded in a register.
// Numerics: with one non-zero product per k16 step, each wgmma adds one LUT
// value to the f32 accumulator, in subspace order, as the twin's chain of
// f32 adds does, but the tensor core does not round that add as the twin's
// round-to-nearest add does: on an H100 most of chip_smoke.py's edge cases
// differ from the twin in the last bits of some values (up to 4.6e-5)
// while no window's row changes. So K4 is held, as K3 is, to values within
// 1e-4 and rows equal except where the window's best two are a near-tie;
// the smoke reports how many cases came out bit-equal.

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16_scan.cuh"

namespace {

using namespace yt_scan;

constexpr int kTileRows = 128;          // code rows per tile: 64 per consumer warpgroup
constexpr int kBlockThreads = 256;      // two warpgroups
constexpr int kBlockWarps = kBlockThreads / 32;   // warp w holds tile rows [16 w, 16 w + 16)
constexpr int kSmemLimit = 232448;      // dynamic shared memory a block may have

// LUT slices of 4 subspaces (128 bytes a query), padded to an even count.
__host__ __device__ constexpr int lut_slices(int m) { return 2 * ((m + 7) / 8); }

// Alignment slack, the resident LUT, two code tiles, the epilogue's scratch
// (8 warps x n queries x (f32, i32)) and one mbarrier.
__host__ __device__ constexpr int smem_bytes(int m, int n) {
  return 1024 + lut_slices(m) * n * 128 + 2 * kTileRows * (m / 2) + kBlockWarps * n * 8 + 8;
}

// Queries a block owns: the widest of 128, 64, 32, 16 whose shared memory
// fits, halved while half still covers B.
int query_tile(int64_t B, int m) {
  int n = 128;
  while (n > 16 && smem_bytes(m, n) > kSmemLimit) n /= 2;
  while (n > 16 && n / 2 >= B) n /= 2;
  return n;
}

struct Params {
  const uint8_t* codes;   // (N, m/2)
  const float* valid;     // (N,)
  float* out_v;           // (B, N/group)
  int32_t* out_i;
  int B, mp, group, N, n_cols;
  int slices;
  int tiles_per_unit;     // 2 for groups of 256 rows, else 1
  int n_units;
};

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x kN, f32) = A (64 x 16, bf16, registers) . B (kN x 16)^T + (accumulate ? d : 0)
template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef F8

template <int kR>
__device__ __forceinline__ void fence_regs(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Tile t's code bytes (rows [128 t, min(N, 128 t + 128)) x m/2, contiguous
// in global memory and 16-byte aligned) into dst, 16 bytes a copy; the last
// copy of a ragged tile reads only the bytes that exist.
__device__ __forceinline__ void stage_codes(const Params& p, int t, uint8_t* dst, int ct) {
  const int rows = min(kTileRows, p.N - t * kTileRows);
  const int bytes = rows * p.mp;
  const uint8_t* src = p.codes + static_cast<int64_t>(t) * kTileRows * p.mp;
  const uint32_t d = smem_u32(dst);
  for (int c = ct; 16 * c < bytes; c += kBlockThreads) {
    const int left = bytes - 16 * c;
    cp_async16(d + 16 * c, src + 16 * c, left < 16 ? left : 16);
  }
}

// The two bf16 of one A register for code c: columns 2 tig, 2 tig + 1 (lo)
// and 2 tig + 8, 2 tig + 9 (hi) of the 16; 1.0 where the column is c. A code
// of 16 (a padding subspace) gives zeros.
__device__ __forceinline__ void onehot(uint32_t c, uint32_t tig, uint32_t& lo, uint32_t& hi) {
  const uint32_t w = 0x3F80u << ((c & 1u) << 4);
  const uint32_t sel = c >> 1;
  lo = sel == tig ? w : 0u;
  hi = sel == tig + 4 ? w : 0u;
}

// A fragments of subspaces 4 j .. 4 j + 3 for this thread's rows (ca: row
// gid's code bytes, cb: row gid + 8's). Register layout of wgmma's A (per
// warp, 16 rows x 16 columns): a[0] row gid, a[1] row gid + 8, columns
// 2 tig, 2 tig + 1; a[2], a[3] the same rows, columns 2 tig + 8, 2 tig + 9.
__device__ __forceinline__ void onehot_slice(const uint8_t* ca, const uint8_t* cb, int j, int mp,
                                             uint32_t tig, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {       // byte 2 j + h: subspaces 4 j + 2 h (low), 4 j + 2 h + 1 (high)
    const int p = 2 * j + h;
    const bool in = p < mp;
    const uint32_t xa = in ? ca[p] : 0u, xb = in ? cb[p] : 0u;
    onehot(in ? (xa & 15u) : 16u, tig, a[2 * h][0], a[2 * h][2]);
    onehot(in ? (xb & 15u) : 16u, tig, a[2 * h][1], a[2 * h][3]);
    onehot(in ? (xa >> 4) : 16u, tig, a[2 * h + 1][0], a[2 * h + 1][2]);
    onehot(in ? (xb >> 4) : 16u, tig, a[2 * h + 1][1], a[2 * h + 1][3]);
  }
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ float bias_of(float valid) {
  return __fmul_rn(__fsub_rn(valid, 1.0f), 1e30f);
}

// (value, row): the larger value, then the lower row
__device__ __forceinline__ void keep_first(float& bv, int& br, float v, int r) {
  if (v > bv || (v == bv && r < br)) { bv = v; br = r; }
}

__device__ __forceinline__ void put(const Params& p, int b, int col, float v, int r) {
  const int64_t o = static_cast<int64_t>(b) * p.n_cols + col;
  p.out_v[o] = v;
  p.out_i[o] = r;
}

template <int kN>
__global__ void __launch_bounds__(kBlockThreads, 1)
pq4_adc_kernel(const __grid_constant__ CUtensorMap lut_map, const Params p) {
  constexpr int kAcc = kN / 2;
  constexpr int kBatch = kAcc / 2 < 8 ? kAcc / 2 : 8;   // epilogue columns reduced side by side
  constexpr int kSliceBytes = kN * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* lut = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* codes = lut + p.slices * kSliceBytes;         // two tiles of 128 rows x m/2 bytes
  const int tile_bytes = kTileRows * p.mp;
  float* red_v = reinterpret_cast<float*>(codes + 2 * tile_bytes);   // [8 warps][kN]
  int* red_r = reinterpret_cast<int*>(red_v + kBlockWarps * kN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(red_r + kBlockWarps * kN);

  const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
  const uint32_t tig = lane & 3;
  const int q0 = blockIdx.y * kN;
  // this block's contiguous span of units (1 or 2 tiles each)
  const int u0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * p.n_units / gridDim.x);
  const int u1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * p.n_units / gridDim.x);
  const int t0 = u0 * p.tiles_per_unit, t1 = u1 * p.tiles_per_unit;

  if (t0 < t1) stage_codes(p, t0, codes, ct);
  cp_async_commit();
  if (ct == 0) {
    mbar_init(smem_u32(bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (ct == 0) {   // the query tile's LUT, once: slices past 16 m columns or rows past B are zeros
    mbar_expect_tx(smem_u32(bar), p.slices * kSliceBytes);
    for (int j = 0; j < p.slices; ++j)
      tma_load_2d(smem_u32(lut + j * kSliceBytes), &lut_map, smem_u32(bar), j * 64, q0);
  }
  mbar_wait(smem_u32(bar), 0);

  const int rl = 16 * warp + (lane >> 2);   // this thread's tile rows: rl, rl + 8
  const uint32_t lut0 = smem_u32(lut);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float run_v = neg_inf();   // groups of 256 rows: query q0 + ct's running pair
  int run_r = -1;

  int buf = 0;
  for (int t = t0; t < t1; ++t, buf ^= 1) {
    __syncthreads();   // everyone is done with the buffer about to be refilled and with red
    if (t + 1 < t1) stage_codes(p, t + 1, codes + (buf ^ 1) * tile_bytes, ct);
    cp_async_commit();
    cp_async_wait_1();   // my copies of tile t have landed
    __syncthreads();     // and everyone's

    const int row0 = t * kTileRows;
    const int ra = row0 + rl, rb = ra + 8;
    const bool la = ra < p.N, lb = rb < p.N;   // rows past N: a ragged last tile, masked
    const float ta = la ? bias_of(__ldg(p.valid + ra)) : 0.f;
    const float tb = lb ? bias_of(__ldg(p.valid + rb)) : 0.f;

    // ---- mainloop: one k16 step per subspace, 4 per LUT slice ----
    const uint8_t* ca = codes + buf * tile_bytes + rl * p.mp;
    const uint8_t* cb = ca + 8 * p.mp;
    fence_regs(acc);
    for (int j = 0; j < p.slices; j += 2) {
      uint32_t a0[4][4], a1[4][4];
      onehot_slice(ca, cb, j, p.mp, tig, a0);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 4; ++x)
        wgmma_rs<kN>(acc, a0[x], sw128_desc(lut0 + j * kSliceBytes) + 2 * x, (j | x) != 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous slice's wgmmas, which read a1, are done
      onehot_slice(ca, cb, j + 1, p.mp, tig, a1);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 4; ++x)
        wgmma_rs<kN>(acc, a1[x], sw128_desc(lut0 + (j + 1) * kSliceBytes) + 2 * x, 1);
      wgmma_commit();
      wgmma_wait<1>();   // slice j's wgmmas, which read a0, are done
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue ----
    if (p.group <= 8) {
      // groups of 1-8 rows: the lanes of one column and one group share its
      // maximum by shuffles; a ballot names the lowest row that reaches it
      const int gid = lane >> 2;
      const unsigned group_lanes = (0x11111111u << tig) &
          ((p.group == 8 ? 0xffffffffu : (1u << (4 * p.group)) - 1) << (4 * (gid & ~(p.group - 1))));
      const bool writer = (gid & (p.group - 1)) == 0;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int hi = (i >> 1) & 1;
        const bool live = hi ? lb : la;
        const float s = live ? __fadd_rn(acc[i], hi ? tb : ta) : neg_inf();
        float m = s;
        for (int x = 4; x < 4 * p.group; x <<= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, x));
        const unsigned hit = __ballot_sync(~0u, s == m) & group_lanes;
        const int b = q0 + acc_col(ct & 127, i);
        if (writer && live && b < p.B) {
          const int r = row0 + 16 * warp + 8 * hi + ((__ffs(hit) - 1) >> 2);
          put(p, b, r / p.group, m, r);
        }
      }
      continue;
    }

    // groups of 16 rows or more: each column's best over the warp's 16 rows,
    // kBatch columns side by side; the lowest row that reaches the maximum
    // comes from a ballot, so no row index is shuffled
    const unsigned same_col = 0x11111111u << tig;
#pragma unroll
    for (int c0 = 0; c0 < kAcc / 2; c0 += kBatch) {
      float lo[kBatch], hi[kBatch], m[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {   // column c0 + c: registers i (row rl) and i + 2 (rl + 8)
        const int i = 2 * (c0 + c) - ((c0 + c) & 1);
        lo[c] = la ? __fadd_rn(acc[i], ta) : neg_inf();
        hi[c] = lb ? __fadd_rn(acc[i + 2], tb) : neg_inf();
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
          const int w = lo_hit ? (__ffs(lo_hit) - 1) >> 2 : 8 + ((__ffs(hi_hit) - 1) >> 2);
          red_v[warp * kN + col] = m[c];
          red_r[warp * kN + col] = row0 + 16 * warp + w;
        }
      }
    }
    __syncthreads();

    // thread ct finishes query q0 + ct: the warps of each group, in row order
    if (ct < kN) {
      const int b = q0 + ct;
      const int wpg = (p.group < kTileRows ? p.group : kTileRows) / 16;   // warps per group in the tile
      for (int w0 = 0; w0 < kBlockWarps; w0 += wpg) {
        float bv = neg_inf();
        int br = -1;
        for (int w = w0; w < w0 + wpg; ++w) keep_first(bv, br, red_v[w * kN + ct], red_r[w * kN + ct]);
        if (p.group <= kTileRows) {
          const int first = row0 + 16 * w0;
          if (b < p.B && first < p.N) put(p, b, first / p.group, bv, br);
        } else {
          keep_first(run_v, run_r, bv, br);
        }
      }
      if (p.group > kTileRows && t % p.tiles_per_unit == p.tiles_per_unit - 1) {
        if (b < p.B) put(p, b, (t + 1 - p.tiles_per_unit) * kTileRows / p.group, run_v, run_r);
        run_v = neg_inf();
        run_r = -1;
      }
    }
  }
}

template <int kN>
int launch(const CUtensorMap& map, const Params& p, int q_tiles, int smem, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pq4_adc_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block per SM (the LUT fills its shared memory), split
  // evenly over the query tiles
  int gx = sms / q_tiles;
  if (gx < 1) gx = 1;
  if (gx > p.n_units) gx = p.n_units;
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(q_tiles));
  pq4_adc_kernel<kN><<<grid, kBlockThreads, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int yt_pq4_adc(const void* lut, const void* codes, const void* valid,
                          void* out_v, void* out_i, int64_t B, int64_t m,
                          int64_t N, int64_t group, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (m < 2 || m % 2 || m > 200 || group < 1 || 256 % group || N % group || N >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tile = query_tile(B, static_cast<int>(m));
  const int smem = smem_bytes(static_cast<int>(m), n_tile);
  const int64_t q_tiles = (B + n_tile - 1) / n_tile;
  if (smem > kSmemLimit || q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the LUT (B, m, 16) as a (B, 16 m) bf16 matrix: boxes of 64 columns (4
  // subspaces) x n_tile queries
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(16 * m), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(32 * m)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(n_tile)};
  const cudaError_t err = bf16_map(&map, lut, 2, dims, strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.codes = static_cast<const uint8_t*>(codes);
  p.valid = static_cast<const float*>(valid);
  p.out_v = static_cast<float*>(out_v);
  p.out_i = static_cast<int32_t*>(out_i);
  p.B = static_cast<int>(B);
  p.mp = static_cast<int>(m / 2);
  p.group = static_cast<int>(group);
  p.N = static_cast<int>(N);
  p.n_cols = static_cast<int>(N / group);
  p.slices = lut_slices(static_cast<int>(m));
  p.tiles_per_unit = group > kTileRows ? static_cast<int>(group / kTileRows) : 1;
  p.n_units = static_cast<int>((N + kTileRows - 1) / kTileRows) / p.tiles_per_unit;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qt = static_cast<int>(q_tiles);
  switch (n_tile) {
    case 128: return launch<128>(map, p, qt, smem, s);
    case 64: return launch<64>(map, p, qt, smem, s);
    case 32: return launch<32>(map, p, qt, smem, s);
    default: return launch<16>(map, p, qt, smem, s);
  }
}
