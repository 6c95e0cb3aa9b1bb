// Shared bf16 scan mainloop for Hopper (sm_90a): a tile of s = E_rows . q^T
// with f32 sums, fed by TMA through an mbarrier ring and multiplied by
// wgmma, handed to an epilogue that keeps it in registers.
//
// Tile: kRows = 128 corpus rows (the wgmma M side, 64 rows for each of two
// consumer warpgroups) x kQueries = 256 queries (the N side). E (N, D) and
// q (B, D) are row-major with D contiguous, so both operands are K-major and
// need no transpose flag. D goes in kK = 64-element (128-byte) slices: one
// TMA box of E rows and one of queries per slice, 128-byte swizzled, into a
// ring of kStages stages. TMA fills zeros past a tensor's edge, so a D that
// is not a multiple of 64 (its last slice), rows past N and queries past B
// all read as zeros: the epilogue masks rows past N and never writes
// queries past B.
//
// Roles: threads [0, 256) are the two consumer warpgroups; the last
// warpgroup is the producer, of which one thread issues the copies, and it
// hands registers to the consumers (setmaxnreg: 40 a thread for it, 232 for
// them, which the 128 accumulators and the epilogue need). A stage
// is `full` when its bytes have landed (one arrival with the byte count,
// then the TMA's transactions) and `empty` again when all 256 consumer
// threads have arrived after their wgmmas on it completed. The producer runs
// ahead across tiles, so a tile's epilogue overlaps the next tile's loads.

#pragma once

#include <cstdint>
#include <cuda.h>          // CUtensorMap (types only; the driver is reached at run time)
#include <cuda_runtime.h>

namespace yt_scan {

constexpr int kRows = 128;                      // corpus rows per tile
constexpr int kQueries = 256;                   // queries per tile (wgmma N)
constexpr int kK = 64;                          // D elements per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumerThreads = 256;           // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kEBytes = kRows * kK * 2;         // 16 KB
constexpr int kQBytes = kQueries * kK * 2;      // 32 KB
constexpr int kStageBytes = kEBytes + kQBytes;  // 48 KB
constexpr int kAccRegs = kQueries / 2;          // f32 accumulators per consumer thread
// dynamic shared memory the ring needs (1 KB slack to align it to 1,024 bytes,
// which the 128-byte swizzle assumes; then the barriers)
constexpr int kRingSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO);
// the leading offset is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[kAccRegs]) {
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) = A (64 x 16) . B (256 x 16)^T + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAccRegs], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The ring: stage s holds kRows E rows then kQueries queries, one D slice.
struct Ring {
  uint8_t* stages;      // 1,024-byte aligned
  uint64_t* full;       // [kStages]
  uint64_t* empty;      // [kStages]

  // Lay the ring out at the start of dynamic shared memory; returns the
  // first byte after it (8-byte aligned) for the epilogue's scratch.
  __device__ __forceinline__ uint8_t* carve(uint8_t* smem) {
    const uint32_t a = smem_u32(smem);
    stages = smem + ((1024 - (a & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
    empty = full + kStages;
    return reinterpret_cast<uint8_t*>(empty + kStages);
  }

  // One thread, before the role split (then __syncthreads).
  __device__ __forceinline__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Position in the ring; producer and consumers step through the same
// sequence of (tile, slice) pairs.
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
};

// Producer (one thread): the k_slices D slices of one tile. load(e_dst,
// q_dst, bar, k) issues the TMA copies of slice k into the stage.
template <class Load>
__device__ __forceinline__ void produce_tile(const Ring& ring, Cursor& c, int k_slices,
                                             Load&& load) {
  for (int k = 0; k < k_slices; ++k) {
    mbar_wait(smem_u32(&ring.empty[c.stage]), c.phase ^ 1);
    const uint32_t bar = smem_u32(&ring.full[c.stage]);
    mbar_expect_tx(bar, kStageBytes);
    const uint32_t e = smem_u32(ring.stages + c.stage * kStageBytes);
    load(e, e + kEBytes, bar, k);
    c.next();
  }
}

// Consumer warpgroup wg (0 or 1): acc = rows [64 wg, 64 wg + 64) of the
// tile times its 256 queries, summed over all slices in f32. One slice's
// wgmmas stay in flight while the next slice's are issued; a stage is
// released once the wgmmas that read it have completed.
__device__ __forceinline__ void consume_tile(const Ring& ring, Cursor& c, int k_slices, int wg,
                                             float (&acc)[kAccRegs]) {
  int prev = -1;
  fence_acc(acc);
  for (int k = 0; k < k_slices; ++k) {
    mbar_wait(smem_u32(&ring.full[c.stage]), c.phase);
    const uint32_t stage = smem_u32(ring.stages + c.stage * kStageBytes);
    const uint64_t da = sw128_desc(stage + wg * (64 * kK * 2));   // this warpgroup's 64 rows
    const uint64_t db = sw128_desc(stage + kEBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)   // 16 elements = 32 bytes = 2 descriptor units
      wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(smem_u32(&ring.empty[prev]));
    prev = c.stage;
    c.next();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0) mbar_arrive(smem_u32(&ring.empty[prev]));
}

// Register rebalancing between the producer and the consumer warpgroups
// (128 x 40 + 256 x 232 <= 65,536); every warp of a warpgroup executes it.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// Accumulator layout of wgmma m64nNk16 (f32) for thread t of a warpgroup:
// register i holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) of the
// warpgroup's 64 rows and column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

}  // namespace yt_scan

// ---------------------------------------------------------------------------
// Host: TMA descriptors. cuTensorMapEncodeTiled is a driver entry point; it is
// looked up in the already loaded driver library at run time, so the link
// line needs no -lcuda.
// ---------------------------------------------------------------------------
#include <dlfcn.h>

namespace yt_scan {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), strides in bytes of
// dims 1.., box of `box` elements, 128-byte swizzle, zeros past the edges.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Queries (B, D) as the wgmma N operand: boxes of 64 dims x kQueries rows.
inline cudaError_t query_map(CUtensorMap* map, const void* q, int64_t B, int64_t D) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kK, kQueries};
  return bf16_map(map, q, 2, dims, strides, box);
}

}  // namespace yt_scan
