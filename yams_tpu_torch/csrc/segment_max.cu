// Segment max of chunk scores into document slots, on Hopper:
// `search/fusion.py` `_aggregate_chunks`' amax segments on a CUDA tensor.
//
// out[q, s] = max(out[q, s], max of x[q, r] over the rows r with
// row2slot[r] == s), for every query row q; rows whose slot is negative (a
// tombstone or padding) or not below the output's width are skipped, their
// scores never read.
//
// Replaces no Pallas kernel: the reference's `jax.ops.segment_max`, which
// the port ran as `scatter_reduce_(..., reduce="amax")`. On a card that is
// one float compare-and-swap loop an element: 8.6e9 a request in the
// chunked benchmark cell, ~10 of them on one address a query row.
//
// What bounds it on the H100: bytes. Every live score is read once and
// each touched output sector is read and written once: at (1,024,
// 8,388,608) scores with 7,095,047 live rows in 685,035 contiguous
// documents, 29.06 GB of scores and 2.81 GB of output each way, ~10.4 ms
// at 3.35 TB/s.
//
// Design: a CTA owns a tile of kTile rows of the store and a group of
// kGroup query rows. It loads the tile's row2slot into shared memory once,
// and each warp walks the tile for its query rows, 128 rows a step (32
// lanes x a 16-byte load), the loads of the next four steps in flight while
// it reduces the last four. A step's work is a chain of shuffles, so the
// loads must fly during it and many warps must be resident. On an H100
// 80GB HBM3 at 700 W, at the cell's shape: a first version that loaded
// eight steps, then reduced them with no load in flight, at 90 registers
// (two CTAs an SM), took 18.3 ms; this one (63 registers, four CTAs an SM)
// 13.5 ms, 77% of the byte bound; variants with eight rows a lane, runs
// closed at each step's edge or other groups read 13.3-14.6 ms. A run is a
// stretch of consecutive rows at one slot. Each lane reduces its four rows' runs in registers; a segmented
// scan over the lanes (the segment heads from a ballot of where a lane's
// last run starts, five shuffles) completes the runs that cross lanes, and
// the run still open at the warp's last lane is carried into the next
// step. So a run costs one global update, and runs split only at tile
// edges. The update is a native integer atomic on the float's bits:
// atomicMax on the signed bits of a non-negative float, atomicMin on the
// unsigned bits of a negative one. Both orders agree with float order, so
// it is exact for every non-NaN value, -0 < +0 (IEEE 754 maximum); there
// is no compare-and-swap loop. Inside the registers values are compared
// as their order-preserving integer images (`ordered`).
//
// The layout is read, not configured: where a document's rows are
// contiguous (the engine's `add_documents`) a run is a document's rows in
// the tile; where one slot's rows are scattered (re-adds), each row is its
// own run and its own native atomic. Tiles with no live row return after
// the row2slot load, so the padding rows cost nothing.
//
// Max does not depend on order, so the result equals scatter_reduce_'s
// amax bit for bit, but where a slot's maximum is a zero of both signs:
// there scatter_reduce_ keeps whichever zero its atomics met last, this
// kernel +0. No host sync, no allocation: the launch goes on the caller's
// stream and updates the caller's `out` in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 128;                 // rows a warp reads a step: 32 lanes x 4
constexpr int kUnroll = 4;                 // steps a batch: its loads are issued together
constexpr int kTile = 4096;                // rows a CTA owns: 16 KB of row2slot
constexpr int kGroup = 8 * kWarps;         // query rows a CTA walks its tile for
static_assert(kTile % (kStep * kUnroll) == 0, "batches tile the tile");

// Order-preserving integer image of a float: unsigned order is float order.
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ uint32_t unordered_bits(uint32_t o) {
  return (o >> 31) ? (o ^ 0x80000000u) : ~o;
}

// out_row[slot] = max(out_row[slot], the value of image o); slot < 0 is a
// skipped row.
__device__ __forceinline__ void update(float* out_row, int slot, uint32_t o) {
  if (slot < 0) return;
  const uint32_t b = unordered_bits(o);
  if (b >> 31)
    atomicMin(reinterpret_cast<unsigned int*>(out_row + slot), b);
  else
    atomicMax(reinterpret_cast<int*>(out_row + slot), static_cast<int>(b));
}

// A lane's four scores at rows r..r+3 of the tile, those of skipped rows
// not read (0): one 16-byte load where vec4, else one load a live row.
__device__ __forceinline__ float4 load4(const float* xr, const int* slot, int r, bool vec4) {
  const int4 s = *reinterpret_cast<const int4*>(slot + r);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec4) {
    if (s.x >= 0 || s.y >= 0 || s.z >= 0 || s.w >= 0)
      v = __ldcs(reinterpret_cast<const float4*>(xr + r));
  } else {   // the slots past the tile's last row are -1
    if (s.x >= 0) v.x = __ldcs(xr + r);
    if (s.y >= 0) v.y = __ldcs(xr + r + 1);
    if (s.z >= 0) v.z = __ldcs(xr + r + 2);
    if (s.w >= 0) v.w = __ldcs(xr + r + 3);
  }
  return v;
}

// One step: the 128 rows from r - 4 lane on, the lane's four at r. (cs, cv)
// is the run open at the end of the warp's last step (slot, image of its
// max), carried in and out.
__device__ __forceinline__ void step(const int* slot, int r, float4 v, float* orow, int lane,
                                     int& cs, uint32_t& cv) {
  const int4 sl = *reinterpret_cast<const int4*>(slot + r);
  const int s0 = sl.x, s1 = sl.y, s2 = sl.z, s3 = sl.w;
  // the lane's runs: its first (head, which may have begun in an earlier
  // lane), whole runs inside it (updated here), its last (run)
  uint32_t head = 0, run = ordered(v.x);
  bool split = false;
  if (s1 != s0) {
    head = run;
    split = true;
    run = ordered(v.y);
  } else {
    run = max(run, ordered(v.y));
  }
  if (s2 != s1) {
    if (split) update(orow, s1, run);
    else head = run;
    split = true;
    run = ordered(v.z);
  } else {
    run = max(run, ordered(v.z));
  }
  if (s3 != s2) {
    if (split) update(orow, s2, run);
    else head = run;
    split = true;
    run = ordered(v.w);
  } else {
    run = max(run, ordered(v.w));
  }
  int prev = __shfl_up_sync(~0u, s3, 1);   // the slot of the row before the lane's first
  if (lane == 0) prev = cs;
  const int next = __shfl_down_sync(~0u, s0, 1);
  // segmented inclusive scan of the lanes' last runs: a lane whose last run
  // starts inside it, or at its first row, heads a segment
  const unsigned heads = __ballot_sync(~0u, split || s0 != prev) | 1u;
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
  uint32_t acc = run;
  if (lane == 0 && !split && s0 == cs) acc = max(acc, cv);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t other = __shfl_up_sync(~0u, acc, d);
    if (lane - d >= start) acc = max(acc, other);
  }
  const uint32_t before = __shfl_up_sync(~0u, acc, 1);
  if (split) {   // the lane's first run ends inside it
    if (lane > 0 && s0 == prev) head = max(head, before);
    if (lane == 0 && s0 == cs) head = max(head, cv);
    update(orow, s0, head);
  }
  if (lane == 0 && s0 != cs) update(orow, cs, cv);   // the carried run ended at the step's edge
  if (lane < 31 && next != s3) update(orow, s3, acc);
  cs = __shfl_sync(~0u, s3, 31);
  cv = __shfl_sync(~0u, acc, 31);
}

__global__ void __launch_bounds__(kThreads) segment_max(const float* __restrict__ x,
                                                        const int* __restrict__ row2slot,
                                                        float* __restrict__ out, int64_t B,
                                                        int64_t rows, int64_t m, bool vec4) {
  __shared__ __align__(16) int slot[kTile];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = static_cast<int>(rows - lo < kTile ? rows - lo : kTile);
  bool live = false;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = i < n ? row2slot[lo + i] : -1;
    const bool ok = s >= 0 && s < m;
    slot[i] = ok ? s : -1;
    live |= ok;
  }
  if (!__syncthreads_or(live)) return;

  constexpr int kBatch = kStep * kUnroll;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kGroup;
  const int64_t q1 = q0 + kGroup < B ? q0 + kGroup : B;
  for (int64_t q = q0 + warp; q < q1; q += kWarps) {
    const float* xr = x + q * rows + lo;
    float* orow = out + q * m;
    int cs = -1;          // the run open at the end of the last step: its slot
    uint32_t cv = 0;      // and the image of its max so far
    float4 next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = load4(xr, slot, u * kStep + 4 * lane, vec4);
    for (int c0 = 0; c0 < n; c0 += kBatch) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = next[u];
      if (c0 + kBatch < n) {   // the next batch's loads fly while this one is reduced
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          next[u] = load4(xr, slot, c0 + kBatch + u * kStep + 4 * lane, vec4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        step(slot, c0 + u * kStep + 4 * lane, v[u], orow, lane, cs, cv);
    }
    if (lane == 0) update(orow, cs, cv);   // the run open at the tile's edge
  }
}

}  // namespace

// x: (B, rows) f32, contiguous; row2slot: (rows,) int32; out: (B, m) f32,
// contiguous, updated in place.
extern "C" int yt_segment_max(const void* x, const void* row2slot, void* out, int64_t B,
                              int64_t rows, int64_t m, void* stream) {
  if (B < 0 || rows < 0 || m < 0 || rows >= (1LL << 31) || m >= (1LL << 31)
      || (B + kGroup - 1) / kGroup > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || rows == 0 || m == 0) return 0;
  const bool vec4 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && rows % 4 == 0;
  const dim3 grid(static_cast<unsigned int>((rows + kTile - 1) / kTile),
                  static_cast<unsigned int>((B + kGroup - 1) / kGroup));
  segment_max<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(row2slot), static_cast<float*>(out),
      B, rows, m, vec4);
  return static_cast<int>(cudaGetLastError());
}
