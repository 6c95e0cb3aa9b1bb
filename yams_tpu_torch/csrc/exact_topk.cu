// Exact KNN block step: per row block, each query's top-k, on Hopper.
//
// Replaces: yams_tpu/ops/scan.py:94 `_topk_block_kernel`, called at :139
// `exact_topk_pallas` (the Pallas kernel K3).
//
// For row block g (block_rows rows of E) and query b it emits the k pairs
// (score, row) that k rounds of "max, first argmax, knock the winner out to
// -1e30" give over s[r] = q_b . E_r + (valid_r - 1) * 1e30: the block's
// top-k of the live rows (s > -1e30) by score, then lower row. When fewer
// than k live rows exist, every further round sees only -1e30 and picks the
// block's first row again, so those slots hold (-1e30, block start), as on
// the TPU. The caller merges the G * k candidates with a top-k.
//
// What bounds it on the H100: the product. At the bench shape (1,048,576 x
// 768 corpus, 1,024 queries) it is 1.65 TFLOP of bf16 products with f32
// sums (1.67 ms at the bf16 peak) against 1.6 GB of corpus and 0.4 MB of
// output.
//
// What held the first port back: a 16-query tile of mma.sync whose warps
// loaded E in 4-byte fragments from L2 (E crossed from L2 into the SMs B/16
// times, ~43 TFLOP/s), and a 16 x 2,048 score tile in shared memory re-read
// by each of k rounds.
//
// Design: the shared mainloop of bf16_scan.cuh, unchanged: 128 E rows x 256
// queries a tile, TMA into a 4-stage ring, wgmma m64n256k16 from two
// consumer warpgroups. A unit is (one row block, one 256-query tile): its
// ceil(block_rows / 128) tiles. E is seen through a 3-D tensor map as
// (G, block_rows, D), so a 128-row box never crosses a block's end, and the
// zeros TMA fills past it (block_rows 64 or 192) are masked like rows past
// N. Persistent blocks walk the units, query tile fastest, so the blocks
// that read one row block run together and find it in L2.
//
// Epilogue for k <= 16 (kThreshold): no score tile and no rounds. Each
// query keeps, in shared memory, its top-k so far (sorted) and a threshold:
// the k-th best score once it has k, else -1e30. After each tile every
// consumer thread compares its 2 rows x 128 queries of scores (validity bias
// added) with the thresholds; the few that beat one are appended to that
// query's list by a shared atomic (20 slots a query: the list, then the
// candidates), and thread b merges query b's candidates into its list by
// (score desc, row asc) and raises the threshold. Tiles arrive in row order,
// so a row of a later tile that only ties the k-th score never enters, as
// the reference's first-row-on-ties keeps it out. When a query's candidates
// overflow their slots, the tile is scanned again against the raised
// thresholds, skipping what each thread already placed (a bit per
// accumulator), until nothing overflows. The slots of a pass go in no fixed
// order, so an unplaced row of the same tile may tie the raised k-th score
// from a lower row: after an overflow the threshold is set just below the
// k-th score, the re-pass takes such ties too, and the merge keeps the
// lowest rows (a tie from a higher row is taken and dropped). The first tile of a unit would
// make every live row a candidate: its threshold starts instead just below
// the k-th largest of 16 sampled scores (each warp's best two of every
// query), which at least k of its rows reach. Scores that rise with the row
// still make every tile insert and take several passes (timed by the
// smoke). A warp skips a batch of 8 accumulators in which no lane has a
// candidate. Shared memory left beside the 4-stage ring (~34 KB) holds 256
// queries x 20 slots. Where the time goes (`PERF.md`): each candidate costs
// a dependent shared atomic and stores, with two consumer warps a scheduler
// to hide them; tried and slower were batching a warp's atomics (spills)
// and per-warp slots found by ballots (more passes).
//
// For 16 < k <= block_rows (kDump) the thresholds would not fit: the kernel
// writes the tile's biased scores to a buffer in device memory, (G, B,
// block_rows) f32 (the caller bounds it by splitting B, 256 queries a
// launch at 1M rows), and a second kernel selects each (block, query)'s k
// best: a radix select of the k-th score, then a bitonic sort of the k
// (score, row) keys alone. The first version sorted all block_rows keys and
// took 64 queries a launch: 87 ms at k 17-128 at the bench shape on an H100
// 80GB HBM3, slower than the plain twin (`PERF.md`).

#include <cstdint>
#include <cuda_runtime.h>

#include "bf16_scan.cuh"

namespace {

using namespace yt_scan;

constexpr float kNeg = -1e30f;
constexpr int kSmallK = 16;     // k above this takes kDump
constexpr int kList = 20;       // slots a query: its top-k so far, then this pass's candidates
constexpr int kMaxBlock = 2048;
constexpr int kSelectThreads = 512;

enum Mode { kThreshold = 0, kDump = 1 };

struct Params {
  const float* valid;    // (N,)
  float* out_v;          // (G, B, k)
  int32_t* out_i;
  float* dump;           // kDump: (G, B, block_rows) biased scores
  int B, k, block_rows, k_slices, q_tiles, tiles_per_unit, n_units;
};

struct TopkScratch {
  float thr[kQueries];               // a candidate must beat this
  int cnt[kQueries];                 // slots in use: the list, then this pass's candidates
  float v[kList][kQueries];          // slot j of query b at [j][b]: thread b's merge is
  uint16_t r[kList][kQueries];       // free of bank conflicts; r is the row within the block
  int overflow[2];                   // by pass parity: some candidate found no slot
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ float bias_of(float valid) {
  return __fmul_rn(__fsub_rn(valid, 1.0f), 1e30f);
}

// Sort query b's slots [len, n) into its sorted list [0, len) by (score
// desc, row asc); the first min(n, k) are its new top-k.
__device__ __forceinline__ void merge_slots(TopkScratch* sc, int b, int len, int n) {
  for (int j = len; j < n; ++j) {
    const float v = sc->v[j][b];
    const uint16_t r = sc->r[j][b];
    int i = j;
    while (i > 0 && (v > sc->v[i - 1][b] || (v == sc->v[i - 1][b] && r < sc->r[i - 1][b]))) {
      sc->v[i][b] = sc->v[i - 1][b];
      sc->r[i][b] = sc->r[i - 1][b];
      --i;
    }
    sc->v[i][b] = v;
    sc->r[i][b] = r;
  }
}

// The first tile of a unit: a threshold that at least k of its rows reach,
// so that its first pass takes ~k candidates a query instead of all 128. Each
// warp's two best scores of every query (16 rows: two distinct rows) go to
// slots [2 warp, 2 warp + 2); thread b takes the k-th largest of query b's 16
// and sets the threshold just below it (a row equal to it may still be in
// the top-k), or -1e30 when that is not a live score. The list is empty.
__device__ __forceinline__ void bootstrap(TopkScratch* sc, const float (&acc)[kAccRegs], float ta,
                                          float tb, int ct, int k) {
  constexpr int kBatch = 8;
  const int lane = ct & 31, warp = ct >> 5;
#pragma unroll
  for (int c0 = 0; c0 < kAccRegs / 2; c0 += kBatch) {
    float m1[kBatch], m2[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {   // column c0 + c: registers i (row rl0) and i + 2 (rl0 + 8)
      const int i = 2 * (c0 + c) - ((c0 + c) & 1);
      const float a = __fadd_rn(acc[i], ta), b = __fadd_rn(acc[i + 2], tb);
      m1[c] = fmaxf(a, b);
      m2[c] = fminf(a, b);
    }
#pragma unroll
    for (int x = 4; x <= 16; x <<= 1) {
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        const float o1 = __shfl_xor_sync(~0u, m1[c], x), o2 = __shfl_xor_sync(~0u, m2[c], x);
        m2[c] = fmaxf(fminf(m1[c], o1), fmaxf(m2[c], o2));
        m1[c] = fmaxf(m1[c], o1);
      }
    }
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        const int col = acc_col(ct & 127, 2 * (c0 + c) - ((c0 + c) & 1));
        sc->v[2 * warp][col] = m1[c];
        sc->v[2 * warp + 1][col] = m2[c];
      }
    }
  }
  consumer_sync();
  float w[2 * kConsumerThreads / 32];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = sc->v[j][ct];
#pragma unroll
  for (int r = 0; r < 16; ++r)           // odd-even transposition: descending
#pragma unroll
    for (int j = r & 1; j + 1 < 16; j += 2) {
      const float hi = fmaxf(w[j], w[j + 1]), lo = fminf(w[j], w[j + 1]);
      w[j] = hi;
      w[j + 1] = lo;
    }
  float th = w[0];
#pragma unroll
  for (int j = 1; j < 16; ++j) th = j == k - 1 ? w[j] : th;
  sc->thr[ct] = fmaxf(kNeg, nextafterf(th, neg_inf()));
  consumer_sync();
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
exact_topk_kernel(const __grid_constant__ CUtensorMap e_map,
                  const __grid_constant__ CUtensorMap q_map, const Params p) {
  extern __shared__ uint8_t smem[];
  Ring ring;
  TopkScratch* sc = reinterpret_cast<TopkScratch*>(ring.carve(smem));
  if (threadIdx.x == 0) {
    ring.init();
    sc->overflow[0] = sc->overflow[1] = 0;
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    producer_regs();
    if (threadIdx.x == kConsumerThreads) {
      Cursor c;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int q0 = (u % p.q_tiles) * kQueries;
        const int g = u / p.q_tiles;
        for (int tt = 0; tt < p.tiles_per_unit; ++tt) {
          produce_tile(ring, c, p.k_slices, [&](uint32_t e, uint32_t q, uint32_t bar, int k) {
            tma_load_3d(e, &e_map, bar, k * kK, tt * kRows, g);   // zeros past the block's end
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
  int pass = 0;   // the same count in every consumer thread

  Cursor c;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int q0 = (u % p.q_tiles) * kQueries;
    const int g = u / p.q_tiles;
    const int64_t base = static_cast<int64_t>(g) * p.block_rows;
    int len = 0;   // kThreshold: the length of query q0 + ct's list
    if constexpr (kMode == kThreshold) {
      sc->thr[ct] = kNeg;
      sc->cnt[ct] = 0;
      consumer_sync();   // every thread sees the reset thresholds
    }
    for (int tt = 0; tt < p.tiles_per_unit; ++tt) {
      // rows within the block; those at or past block_rows are TMA's zeros
      const int la = tt * kRows + rl0, lb = la + 8;
      const float ta = la < p.block_rows ? bias_of(__ldg(p.valid + base + la)) : neg_inf();
      const float tb = lb < p.block_rows ? bias_of(__ldg(p.valid + base + lb)) : neg_inf();
      consume_tile(ring, c, p.k_slices, ct >> 7, acc);

      if constexpr (kMode == kDump) {
#pragma unroll
        for (int i = 0; i < kAccRegs; ++i) {
          const int hi = (i >> 1) & 1;
          const int lr = hi ? lb : la;
          const int b = q0 + acc_col(ct & 127, i);
          if (b < p.B && lr < p.block_rows)
            p.dump[(static_cast<int64_t>(g) * p.B + b) * p.block_rows + lr] =
                __fadd_rn(acc[i], hi ? tb : ta);
        }
        continue;
      }

      if (tt == 0) bootstrap(sc, acc, ta, tb, ct, p.k);
      uint32_t placed[kAccRegs / 32] = {};   // accumulators already given a slot
      for (;;) {
        // scores that beat their query's threshold take a slot; a warp skips
        // a batch of 8 accumulators in which no lane has one
#pragma unroll
        for (int i0 = 0; i0 < kAccRegs; i0 += 8) {
          const float2 th0 = *reinterpret_cast<const float2*>(&sc->thr[acc_col(ct & 127, i0)]);
          const float2 th1 = *reinterpret_cast<const float2*>(&sc->thr[acc_col(ct & 127, i0 + 4)]);
          float s[8];
          uint32_t want = 0;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            s[x] = __fadd_rn(acc[i0 + x], ((x >> 1) & 1) ? tb : ta);
            const float th = x < 4 ? ((x & 1) ? th0.y : th0.x) : ((x & 1) ? th1.y : th1.x);
            want |= static_cast<uint32_t>(s[x] > th) << x;
          }
          want &= ~(placed[i0 >> 5] >> (i0 & 31)) & 0xffu;
          if (!__any_sync(~0u, want != 0)) continue;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            if (!(want & (1u << x))) continue;
            const int i = i0 + x;
            const int col = acc_col(ct & 127, i);
            const int slot = atomicAdd(&sc->cnt[col], 1);
            if (slot < kList) {
              sc->v[slot][col] = s[x];
              sc->r[slot][col] = static_cast<uint16_t>(((x >> 1) & 1) ? lb : la);
              placed[i >> 5] |= 1u << (i & 31);
            } else {
              sc->overflow[pass & 1] = 1;
            }
          }
        }
        consumer_sync();
        // thread ct merges query q0 + ct's candidates into its list; after an
        // overflow the threshold goes just below the k-th score, so that the
        // next pass also takes this tile's unplaced rows that tie it
        const bool over = sc->overflow[pass & 1] != 0;
        const int n = min(sc->cnt[ct], kList);
        if (n > len) {
          merge_slots(sc, ct, len, n);
          len = min(n, p.k);
          const float kth = sc->v[p.k - 1][ct];
          sc->thr[ct] = len < p.k ? kNeg : over ? fmaxf(kNeg, nextafterf(kth, neg_inf())) : kth;
        }
        sc->cnt[ct] = len;
        if (ct == 0) sc->overflow[(pass + 1) & 1] = 0;   // the next pass's flag; read by none now
        consumer_sync();
        const bool again = sc->overflow[pass & 1] != 0;
        ++pass;
        if (!again) break;
      }
    }

    if constexpr (kMode == kThreshold) {
      const int b = q0 + ct;
      if (b < p.B) {
        const int64_t o = (static_cast<int64_t>(g) * p.B + b) * p.k;
        for (int j = 0; j < p.k; ++j) {
          p.out_v[o + j] = j < len ? sc->v[j][ct] : kNeg;
          p.out_i[o + j] = static_cast<int32_t>(base + (j < len ? sc->r[j][ct] : 0));
        }
      }
    }
  }
}

// f32 -> u32 that orders as the floats do
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o >> 31) ? (o ^ 0x80000000u) : ~o);
}

// kDump's second step: block gb = g * B + b keeps the k best of its
// block_rows scores by (score desc, row asc). A radix select finds the k-th
// score T over the scores' 32-bit order keys, 8 bits a pass, each thread
// holding its kPer scores in registers (histograms by warp-aggregated shared
// atomics); the rows above T and the lowest rows equal to T (ranked in row
// order by ballots) make exactly k keys (score, then lower row), which a
// bitonic sort over the next power of two puts in order.
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ dump, float* __restrict__ out_v,
              int32_t* __restrict__ out_i, int B, int k, int block_rows) {
  constexpr int kPer = kMaxBlock / kSelectThreads;     // scores a thread holds
  constexpr int kWarps = kSelectThreads / 32;
  static_assert(kPer * kWarps == 64, "the tie counts are scanned two a lane by one warp");
  __shared__ unsigned long long key[kMaxBlock];
  __shared__ uint32_t hist[256];
  __shared__ int ties_before[kPer * kWarps];   // ties at T in earlier (sweep, warp)s: row order
  __shared__ uint32_t pick[2];                 // T's digits so far; keys still wanted at them
  __shared__ int taken;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t gb = blockIdx.x;
  const int64_t base = (gb / B) * block_rows;
  const float* s = dump + gb * block_rows;
  uint32_t u[kPer];   // the key of row t + kSelectThreads j
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kSelectThreads;
    u[j] = i < block_rows ? ordered(s[i]) : 0u;
  }
  uint32_t prefix = 0, mask = 0;
  int want = k;   // keys still to take among those that match prefix under mask
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (t < 256) hist[t] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = t + j * kSelectThreads < block_rows && (u[j] & mask) == prefix;
      const uint32_t bin = in ? (u[j] >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(~0u, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {   // lane l: bins 255 - 8 l down to 248 - 8 l; the bin of the want-th key
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        c[x] = hist[255 - 8 * lane - x];
        sum += c[x];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += v;
      }
      uint32_t run = incl - sum, bin = 0, above = 0;
      const uint32_t w = static_cast<uint32_t>(want);
      const bool mine = run < w && w <= incl;   // one lane's bins hold the want-th key
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        if (run < w && run + c[x] >= w) {
          bin = 255u - 8 * lane - x;
          above = run;
        }
        run += c[x];
      }
      if (mine) {
        pick[0] = prefix | (bin << shift);
        pick[1] = w - above;
      }
    }
    __syncthreads();
    prefix = pick[0];
    want = static_cast<int>(pick[1]);
    mask |= 255u << shift;
  }
  // prefix is T: take every key above it and the first `want` equal to it in
  // row order (row t + 512 j is lane t % 32 of warp t / 32 in sweep j)
  uint32_t ties[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    ties[j] = __ballot_sync(~0u, t + j * kSelectThreads < block_rows && u[j] == prefix);
    if (lane == 0) ties_before[j * kWarps + warp] = __popc(ties[j]);
  }
  if (t == 0) taken = 0;
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the kPer x kWarps counts, two a lane
    const int a = ties_before[2 * lane], b = ties_before[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    ties_before[2 * lane] = incl - a - b;
    ties_before[2 * lane + 1] = incl - b;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kSelectThreads;
    const int rank = ties_before[j * kWarps + warp] + __popc(ties[j] & ((1u << lane) - 1));
    if (i < block_rows && (u[j] > prefix || (u[j] == prefix && rank < want)))
      key[atomicAdd(&taken, 1)] = (static_cast<unsigned long long>(u[j]) << 32) | (0xffffffffu - i);
  }
  int n2 = 2;
  while (n2 < k) n2 <<= 1;
  for (int i = k + t; i < n2; i += kSelectThreads) key[i] = 0ull;   // padding sorts last
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = key[lo], b = key[hi];
        if (desc ? a < b : a > b) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned long long x = key[j];
    const float v = unordered(static_cast<uint32_t>(x >> 32));
    const int r = static_cast<int>(0xffffffffu - static_cast<uint32_t>(x));
    const bool live = v > kNeg;
    out_v[gb * k + j] = live ? v : kNeg;
    out_i[gb * k + j] = static_cast<int32_t>(base + (live ? r : 0));
  }
}

template <int kMode>
int launch(const CUtensorMap& e_map, const CUtensorMap& q_map, const Params& p,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = kRingSmem + static_cast<int>(sizeof(TopkScratch));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exact_topk_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_units < sms ? p.n_units : sms;   // persistent: one block per SM
  exact_topk_kernel<kMode><<<grid, kThreads, smem, stream>>>(e_map, q_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dump: (G, B, block_rows) f32 scratch when k > 16, else unused (may be null).
extern "C" int yt_exact_topk(const void* q, const void* e, const void* valid,
                             void* out_v, void* out_i, void* dump, int64_t B, int64_t N,
                             int64_t D, int64_t k, int64_t block_rows, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (block_rows % 64 || block_rows > kMaxBlock || N % block_rows || k < 1 || k > block_rows
      || D % 16 || (k > kSmallK && dump == nullptr) || N >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t G = N / block_rows;
  // E as (G, block_rows, D): boxes of 64 dims x 128 rows of one block
  CUtensorMap e_map, q_map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(block_rows),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(D) * 2 * block_rows};
  const cuuint32_t box[3] = {kK, kRows, 1};
  cudaError_t err = bf16_map(&e_map, e, 3, dims, strides, box);
  if (err == cudaSuccess) err = query_map(&q_map, q, B, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.valid = static_cast<const float*>(valid);
  p.out_v = static_cast<float*>(out_v);
  p.out_i = static_cast<int32_t*>(out_i);
  p.dump = static_cast<float*>(dump);
  p.B = static_cast<int>(B);
  p.k = static_cast<int>(k);
  p.block_rows = static_cast<int>(block_rows);
  p.k_slices = static_cast<int>((D + kK - 1) / kK);
  p.q_tiles = static_cast<int>((B + kQueries - 1) / kQueries);
  p.tiles_per_unit = static_cast<int>((block_rows + kRows - 1) / kRows);
  p.n_units = static_cast<int>(G) * p.q_tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kSmallK) return launch<kThreshold>(e_map, q_map, p, s);
  const int rc = launch<kDump>(e_map, q_map, p, s);
  if (rc != 0) return rc;
  select_kernel<<<static_cast<unsigned int>(G * B), kSelectThreads, 0, s>>>(
      p.dump, p.out_v, p.out_i, p.B, p.k, p.block_rows);
  return static_cast<int>(cudaGetLastError());
}
