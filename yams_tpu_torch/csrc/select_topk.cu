// Tie-exact top-k of each row of an f32 matrix, on Hopper: `select.top_k`
// for a CUDA tensor.
//
// Replaces no Pallas kernel. It is the port's counterpart of `lax.top_k` on
// the hot path: the vector leg's top-C over every score column (1,000,448 a
// row in the bf16 tier, 262,144 a streamed int8 block), the streaming merge,
// the lexical leg's candidates and the fusion's final top-k. Before it,
// `top_k` ran torch.topk's radix select, read each row again to count ties
// at the cut, synchronized with the host to find the rows where a tie
// straddled it, redid those with int64 keys and argsorted the winners.
//
// The order is a total one. Element j of a row with f32 bits b has the key
//   (ordered(b) << 32) | (0xFFFFFFFF - j),
// ordered(b) flipping b's magnitude bits when it is negative, so that
// unsigned order is float order (-NaN < -inf < ... < -0 < +0 < ... < +inf <
// +NaN): `select._key_top_k`'s key and `_key_top_k_small`'s order. The top k
// are the k largest keys, in descending order: the k largest values, ties to
// the lower column. Keys are unique within a row, so no tie is left to
// settle, and the values come back from the keys bit for bit.
//
// What bounds it on the H100: bytes. Every score is read once and
// nothing but (R, k) values and indices is written: the (1,024, 1,000,448)
// call reads 4.10 GB, 1.22 ms at 3.35 TB/s. The arithmetic (a key and a
// compare a score) is ~1e9 integer operations there, well under that.
//
// Design: one algorithm whose parameters follow the row length n (the
// caller's `select_plan`).
// - Short rows (n <= kShortMax): one CTA a row holds the row's keys in
//   registers. A radix select over the 64-bit keys, 8 bits a pass from the
//   top, finds the prefix that exactly k keys reach, stopping as soon as the
//   chosen digit's keys are all wanted; ties at the k-th value are settled
//   by the column bits, which are part of the key. A bitonic sort orders
//   the k winners in shared memory.
// - Long rows: two stages. Stage 1 is a grid of (row, slice) CTAs; a CTA
//   reads its slice once, with 16-byte loads a chunk ahead of its compares
//   (2,048 scores a chunk), and compares each key with
//   the slice's running k-th best key. Only keys above it enter a shared
//   buffer, which is cut back to its best k (the same radix select) when
//   the next chunk could overflow it: the queue-and-threshold design of
//   FAISS's BlockSelect (Johnson, Douze and Jegou, "Billion-scale similarity
//   search with GPUs", 2017). The first threshold is the k-th largest of the
//   threads' best keys in the first chunk (a radix select over one key a
//   thread), so no CTA starts with a cut. After that a score costs one
//   compare and no shared-memory traffic. Each slice writes its k best keys
//   (0, below every real key, where the slice is shorter than k). Stage 2
//   is the short-row kernel over each row's slices x k keys. It is exact
//   because the order is total: the row's top k lies in the union of the
//   slices' top k.
// K3's score dump (four 8-bit radix passes and a sort per 2,048-row block,
// PERF.md) is what stage 1 avoids: there every score went through shared
// memory and every block paid the passes.
//
// No host sync, no allocation: the caller hands in the outputs and stage
// 1's (R, slices, k) keys, and the launches go on its stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kShortMax = 8192;     // keys a short-row CTA holds (512 threads x 16)
constexpr int kMaxK = 1024;
constexpr int kSliceThreads = 256;
constexpr int kChunk = 2 * 4 * kSliceThreads;   // scores a stage-1 CTA reads between barriers
constexpr int kCap = 2 * kChunk;                // stage 1's candidate buffer
constexpr int kCutPer = kCap / kSliceThreads;   // buffer keys a thread holds during a cut

__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o >> 31) ? (o ^ 0x80000000u) : ~o);
}
__device__ __forceinline__ u64 make_key(float v, int64_t col) {
  return (static_cast<u64>(ordered(v)) << 32) | (0xffffffffu - static_cast<uint32_t>(col));
}

struct RadixSmem {
  uint32_t hist[256];
  u64 prefix;    // the chosen digits so far
  int want;      // keys still wanted among those that match them
  int done;      // every key of the chosen digit is wanted
};

// The keys with (key & mask) >= prefix, key != 0, are exactly the k largest
// nonzero keys held by the block (each thread holds PER; 0 is empty). The
// caller guarantees at least k nonzero keys, all distinct. Starts and ends
// with every thread past a barrier.
template <int T, int PER>
__device__ __forceinline__ void radix_top(const u64 (&u)[PER], int k, RadixSmem& s, u64& prefix_out,
                                          u64& mask_out) {
  static_assert(T % 32 == 0 && T >= 32, "whole warps; warp 0 scans the 256 bins");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  u64 prefix = 0, mask = 0;
  int want = k;
#pragma unroll 1
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += T) s.hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (!__any_sync(~0u, u[j] != 0)) continue;   // a slot empty in every lane
      const bool in = u[j] != 0 && (u[j] & mask) == prefix;
      const uint32_t bin = in ? static_cast<uint32_t>(u[j] >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(~0u, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {   // lane l: bins 255 - 8 l down to 248 - 8 l; the bin of the want-th key
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        c[x] = s.hist[255 - 8 * lane - x];
        sum += c[x];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += v;
      }
      const uint32_t w = static_cast<uint32_t>(want);
      uint32_t run = incl - sum;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        if (run < w && run + c[x] >= w) {   // one lane, one bin
          s.prefix = prefix | (static_cast<u64>(255u - 8 * lane - x) << shift);
          s.want = static_cast<int>(w - run);
          s.done = c[x] == w - run;
        }
        run += c[x];
      }
    }
    __syncthreads();
    prefix = s.prefix;
    want = s.want;
    mask |= 255ull << shift;
    if (s.done) break;   // the same in every thread; s is next written after two barriers
  }
  prefix_out = prefix;
  mask_out = mask;
}

__device__ __forceinline__ bool taken(u64 key, u64 prefix, u64 mask) {
  return key != 0 && (key & mask) >= prefix;
}

// Sort keys[0, n2) descending (n2 a power of two), every thread of the block.
__device__ __forceinline__ void bitonic_desc(u64* keys, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = keys[lo], b = keys[hi];
        if (desc ? a < b : a > b) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One CTA a row: the row's m inputs (f32 scores at stride `stride`, or
// stage 1's keys, m a row) -> its top k, sorted, as values and int64 columns.
template <int T, int PER, bool kFromKeys>
__global__ void __launch_bounds__(T)
short_topk(const float* __restrict__ x, const u64* __restrict__ keys_in, int64_t stride, int m,
           int k, float* __restrict__ out_v, int64_t* __restrict__ out_i) {
  __shared__ RadixSmem s;
  __shared__ u64 sel[kMaxK];
  __shared__ int n_sel;
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  u64 u[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = t + j * T;
    if (kFromKeys)
      u[j] = i < m ? keys_in[row * m + i] : 0ull;
    else
      u[j] = i < m ? make_key(x[row * stride + i], i) : 0ull;
  }
  if (t == 0) n_sel = 0;
  u64 prefix, mask;
  radix_top<T, PER>(u, k, s, prefix, mask);
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (taken(u[j], prefix, mask)) sel[atomicAdd(&n_sel, 1)] = u[j];
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  for (int i = k + t; i < n2; i += T) sel[i] = 0ull;   // padding sorts last
  __syncthreads();
  bitonic_desc(sel, n2);
  for (int j = t; j < k; j += T) {
    const u64 key = sel[j];
    out_v[row * k + j] = unordered(static_cast<uint32_t>(key >> 32));
    out_i[row * k + j] = static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(key));
  }
}

// Cut buf[0, m) back to its k largest keys, in buf[0, k); returns the
// smallest of them, the new threshold. Every thread; m > k.
__device__ __forceinline__ u64 cut(u64* buf, int m, int k, RadixSmem& s, int* cnt, u64* thr) {
  u64 u[kCutPer];
#pragma unroll
  for (int j = 0; j < kCutPer; ++j) {
    const int i = threadIdx.x + j * kSliceThreads;
    u[j] = i < m ? buf[i] : 0ull;
  }
  u64 prefix, mask;
  radix_top<kSliceThreads, kCutPer>(u, k, s, prefix, mask);   // every thread has read buf
  if (threadIdx.x == 0) {
    *cnt = 0;
    *thr = ~0ull;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCutPer; ++j) {
    if (taken(u[j], prefix, mask)) {
      buf[atomicAdd(cnt, 1)] = u[j];
      atomicMin(thr, u[j]);
    }
  }
  __syncthreads();
  return *thr;
}

// Thread t's 8 scores of the chunk at `base`: columns base + 4 t + [0, 4)
// and base + 4 (t + 256) + [0, 4), 16-byte loads where vec4 and whole;
// columns at or past c1 read 0 (the caller drops them).
__device__ __forceinline__ void load_chunk(const float* __restrict__ xr, int64_t base, int64_t c1,
                                           bool vec4, float (&v)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t col = base + 4 * (threadIdx.x + h * kSliceThreads);
    if (vec4 && col + 3 < c1) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(xr + col));
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * h + e] = col + e < c1 ? xr[col + e] : 0.f;
    }
  }
}

// Stage 1: CTA b takes row b / slices, columns [c0, c0 + slice_len) of it,
// and writes that slice's k largest keys (padded with 0) to
// out[(row * slices + slice) * k ...]. vec4: the row starts and the stride
// keep 16-byte alignment (slice_len is a multiple of 4).
__global__ void __launch_bounds__(kSliceThreads, 4)
slice_topk(const float* __restrict__ x, int64_t stride, int64_t n, int k, int64_t slice_len,
           int slices, bool vec4, u64* __restrict__ out) {
  __shared__ u64 buf[kCap];
  __shared__ RadixSmem s;
  __shared__ int cnt;
  __shared__ u64 thr_s;
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x / slices;
  const int sl = static_cast<int>(blockIdx.x % slices);
  const int64_t c0 = sl * slice_len;
  const int64_t c1 = c0 + slice_len < n ? c0 + slice_len : n;
  const float* xr = x + row * stride;
  if (t == 0) cnt = 0;
  __syncthreads();
  u64 thr = 0;   // a key must beat it: 0 is below every real key
  float next[8];   // the next chunk's scores, in flight while this one is compared
  load_chunk(xr, c0, c1, vec4, next);
  for (int64_t base = c0; base < c1; base += kChunk) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = next[e];
    if (base + kChunk < c1) load_chunk(xr, base + kChunk, c1, vec4, next);
    u64 key[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int64_t c = base + 4 * (t + (e >> 2) * kSliceThreads) + (e & 3);
      key[e] = c < c1 ? make_key(v[e], c) : 0ull;
    }
    if (base == c0 && k <= kSliceThreads) {
      // a first threshold without a cut: the k-th largest of the threads'
      // best keys, which at least k keys of the chunk reach
      u64 best[1] = {0ull};
#pragma unroll
      for (int e = 0; e < 8; ++e) best[0] = key[e] > best[0] ? key[e] : best[0];
      if (__syncthreads_count(best[0] != 0) >= k) {
        u64 prefix, mask;
        radix_top<kSliceThreads, 1>(best, k, s, prefix, mask);
        thr = prefix ? prefix - 1 : 0ull;   // keys >= prefix enter, the k best among them
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (key[e] > thr) buf[atomicAdd(&cnt, 1)] = key[e];
    __syncthreads();
    const int m = cnt;
    __syncthreads();   // every thread has read cnt before the next chunk adds to it
    if (m + kChunk > kCap) thr = cut(buf, m, k, s, &cnt, &thr_s);
  }
  const int m = cnt;
  if (m > k) cut(buf, m, k, s, &cnt, &thr_s);
  u64* o = out + (row * slices + sl) * k;
  for (int j = t; j < k; j += kSliceThreads) o[j] = j < m ? buf[j] : 0ull;
}

template <int T, int PER>
int launch_short(const float* x, const u64* keys, int64_t stride, int m, int k, int64_t R,
                 float* out_v, int64_t* out_i, cudaStream_t st) {
  if (keys != nullptr)
    short_topk<T, PER, true><<<static_cast<unsigned int>(R), T, 0, st>>>(x, keys, stride, m, k,
                                                                         out_v, out_i);
  else
    short_topk<T, PER, false><<<static_cast<unsigned int>(R), T, 0, st>>>(x, keys, stride, m, k,
                                                                          out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

// The short-row kernel whose block holds m inputs.
int short_rows(const float* x, const u64* keys, int64_t stride, int m, int k, int64_t R,
               float* out_v, int64_t* out_i, cudaStream_t st) {
  if (m <= 256) return launch_short<128, 2>(x, keys, stride, m, k, R, out_v, out_i, st);
  if (m <= 1024) return launch_short<256, 4>(x, keys, stride, m, k, R, out_v, out_i, st);
  if (m <= 4096) return launch_short<512, 8>(x, keys, stride, m, k, R, out_v, out_i, st);
  return launch_short<512, 16>(x, keys, stride, m, k, R, out_v, out_i, st);
}

}  // namespace

// x: (R, n) f32, row stride `stride` (elements), unit column stride.
// out_v (R, k) f32, out_i (R, k) int64. slices == 0: the short-row kernel
// (n <= 8192). Otherwise keys is (R, slices, k) int64 scratch and the row is
// cut into `slices` slices of slice_len columns (a multiple of 2,048).
extern "C" int yt_select_topk(const void* x, void* out_v, void* out_i, void* keys, int64_t R,
                              int64_t n, int64_t stride, int64_t k, int64_t slices,
                              int64_t slice_len, void* stream) {
  if (R <= 0) return 0;
  if (n < 1 || n >= (1LL << 31) || k < 1 || k > n || k > kMaxK || stride < n
      || R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* ov = static_cast<float*>(out_v);
  int64_t* oi = static_cast<int64_t*>(out_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slices == 0) {
    if (n > kShortMax) return static_cast<int>(cudaErrorInvalidValue);
    return short_rows(xf, nullptr, stride, static_cast<int>(n), static_cast<int>(k), R, ov, oi, st);
  }
  if (slices < 1 || keys == nullptr || slice_len % kChunk || slices * k > kShortMax
      || slices * slice_len < n || (slices - 1) * slice_len >= n || R * slices >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && stride % 4 == 0;
  u64* kb = static_cast<u64*>(keys);
  slice_topk<<<static_cast<unsigned int>(R * slices), kSliceThreads, 0, st>>>(
      xf, stride, n, static_cast<int>(k), slice_len, static_cast<int>(slices), vec4, kb);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return short_rows(nullptr, kb, 0, static_cast<int>(slices * k), static_cast<int>(k), R, ov, oi,
                    st);
}
