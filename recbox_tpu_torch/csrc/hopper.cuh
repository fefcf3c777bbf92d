// Hopper (sm_90a) building blocks for the port's tensor-core kernels: TMA
// tile loads into 128- or 64-byte-swizzled shared memory (multicast into a
// cluster too), mbarriers, warpgroup matrix multiplies (`wgmma`, bf16 and
// s8; operands K-major or MN-major in shared memory, A from registers),
// thread block clusters (ranks, distributed shared memory addresses,
// remote arrivals) and the host-side tensor maps (2-D, and the 3-D
// segment-major view). Used by B4's `wgmma` and segment-major routes
// (`mips_topk.cu` `segment_candidates_wgmma`, `segment_major_candidates`),
// which B3's stage (a) runs, and by B2 (`fused_ce.cu`).

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` more from TMA copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait of more than ~2^34 cycles (seconds) traps: a launch that would
// deadlock fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// -- TMA ---------------------------------------------------------------------

// Copy the box at (c0 innermost, c1) of `map` into shared memory at `dst`,
// completing its bytes on `bar`. Rows and columns past the tensor are
// zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// As tma_load_2d for a 3-D map: the box at (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a K-major tile in shared memory as TMA writes it under the
// 128- or 64-byte swizzle (SWIZZLE = 128 or 64): rows of SWIZZLE bytes, 8-row
// groups 8 * SWIZZLE bytes apart, the tile 1024-byte aligned. Adding 2 steps
// 32 bytes (one k16 bf16 or k32 s8 slice) along K.
template <int SWIZZLE>
__device__ __forceinline__ uint64_t swizzled_desc(const void* tile) {
  static_assert(SWIZZLE == 128 || SWIZZLE == 64, "128- or 64-byte rows");
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SWIZZLE >> 4) << 32) |
         ((uint64_t)(SWIZZLE == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a
// wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128 f32) = A (64 x 16) B^T (128 x 16) [+ D]; A and B bf16, K-major
// in shared memory. Thread t of the warpgroup holds rows 16(t/32) + t%32/4
// (+8) and columns 8j + 2(t%4) (+1): d[4j + e] and d[4j + 2 + e].
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// max(a, b) that returns NaN when either is NaN (fmaxf drops a NaN).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// D (64 x 128 s32) = A (64 x 32) B^T (128 x 32) [+ D]; A and B s8, K-major
// in shared memory (a k32 slice is 32 bytes, as bf16's k16). The same
// fragment layout as the bf16 product.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Descriptor of an MN-major tile in shared memory under the 128-byte
// swizzle: rows of 64 bf16 along M (or N), one row for each k, as TMA
// writes a row-major (k, 64) box or as `swz128` places values; 8-row groups
// 1024 bytes apart (SBO), 64-wide chunks along M/N `chunk_bytes` apart (LBO;
// unused for a 64-wide operand). Adding 128 steps 16 rows (one k16 slice).
__device__ __forceinline__ uint64_t mn_major_desc(const void* tile,
                                                  uint32_t chunk_bytes) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)((chunk_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of bf16 column `col` (0-63) of row `row` in a 128-byte-swizzled
// tile of 128-byte rows (1024-byte aligned), as TMA's 128-byte swizzle
// places it: 16-byte chunk c of row r lies at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
                    (col & 7) * 2);
}

// The accumulator operands of an m64nNk16 product: N / 2 floats a thread.
#define RB_D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RB_D32 RB_D8(0), RB_D8(8), RB_D8(16), RB_D8(24)
#define RB_D64 RB_D32, RB_D8(32), RB_D8(40), RB_D8(48), RB_D8(56)
#define RB_REGS32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "  \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "    \
  "%27, %28, %29, %30, %31}"
#define RB_REGS64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "  \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "    \
  "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "    \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x N f32) [+]= A (64 x 16) B (16 x N), bf16, both from shared memory.
// TA / TB: 0 = K-major, 1 = MN-major (the transpose bits). Thread t of the
// warpgroup holds rows 16(t/32) + t%32/4 (+8) and columns 8j + 2(t%4) (+1):
// d[4j + e] and d[4j + 2 + e]. N is 64 or 128.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RB_REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n}"
        : RB_D32
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RB_REGS64
        ", %64, %65, p, 1, 1, %67, %68;\n}"
        : RB_D64
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// D (64 x N f32) [+]= A (64 x 16, registers) B (16 x N, shared memory).
// A as mma.sync's m16n8k16 A fragment in each warp's 16 rows: a[0] (row
// t%32/4, k 2(t%4)..+1), a[1] (row +8), a[2] (k +8), a[3] (row +8, k +8),
// bf16 pairs, the lower k in the low half. TB as in `wgmma_ss`.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RB_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
        : RB_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RB_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}"
        : RB_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TB));
  }
}

#undef RB_D8
#undef RB_D32
#undef RB_D64
#undef RB_REGS32
#undef RB_REGS64

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma's operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits; orders
// the blocks' shared-memory writes before the others' later reads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of `p` (a shared::cta pointer of this block)
// in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// Arrive once on the mbarrier at shared::cluster address `a` (this block's
// or another's), with the default semantics (release at CTA scope), as
// CUTLASS's cluster barriers arrive.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(a)
               : "memory");
}

// As tma_load_2d, the box written at the same offset of every block in
// `mask` (bit i: cluster rank i), each completing its bytes on its own
// mbarrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// -- registers and barriers of warp-specialised blocks -----------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// bar.sync on barrier `id` (1-15) for `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// -- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library `libcuda`, found through the
// runtime's entry-point query (no link against it).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of the tensor-map encode, kept apart from the runtime's.
constexpr int MAP_NO_ENCODER = 9001;
constexpr int MAP_ENCODE_FAILED = 9002;

// Map of a row-major (rows, cols) matrix of 2-byte (bf16) or 1-byte (s8)
// values in boxes of box_bytes (128 or 64) of a row x box_rows rows, under
// the swizzle of that width, zeros past the edges.
inline int k_major_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                       uint64_t cols, int elem_bytes, uint32_t box_rows,
                       int box_bytes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return MAP_NO_ENCODER;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem_bytes), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ENCODE_FAILED;
}

// Map of a row-major matrix of `cols` 2-byte or 1-byte values a row seen as
// 3-D (cols, n_seg, seg_rows): element (k, g, j) is value k of row
// j * n_seg + g, g stepping `stride_g` bytes (a row) and j `stride_j` (n_seg
// rows). A box is box_bytes of a row x 1 x box_rows: box_rows consecutive
// rows of one strided segment, laid out in shared memory as box_rows rows of
// a 2-D box under the swizzle of that width; zeros past the view.
inline int segment_major_map(CUtensorMap* map, const void* ptr,
                             uint64_t seg_rows, uint64_t n_seg, uint64_t cols,
                             int elem_bytes, uint64_t stride_g,
                             uint64_t stride_j, uint32_t box_rows,
                             int box_bytes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return MAP_NO_ENCODER;
  const cuuint64_t dims[3] = {cols, n_seg, seg_rows};
  const cuuint64_t strides[2] = {stride_g, stride_j};
  const cuuint32_t box[3] = {(cuuint32_t)(box_bytes / elem_bytes), 1,
                             box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ENCODE_FAILED;
}

}  // namespace
