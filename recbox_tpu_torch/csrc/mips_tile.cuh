// Tile scoring of the MIPS kernels for Hopper (sm_90a): the tile route of
// the segment-candidate generator (`mips_topk.cu`, B4, which is also the
// fused top-k's stage (a)) scores a (64 query, 128 corpus row) tile, and
// the segment winners' packing is defined here for both routes and for the
// fused top-k's decode (`mips_fused_topk.cu`, B3).
//
// A block stages one k-block of the corpus chunk and of the query tile in
// shared memory and scores them: bf16 / int8 on the tensor cores through
// WMMA m16n16k16 fragments, f32 on the CUDA cores. The (RC, QT) scores land
// in a shared "stage" that the caller folds into its segment winners.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int SEGMENT = 128;
constexpr int MAX_SUB_ROWS = 32768;        // 256 segments per sub-chunk
constexpr int QT = 64;                     // queries per block
constexpr int RC = 128;                    // corpus rows per chunk
constexpr int KB = 64;                     // depth of one staged k-block
constexpr int THREADS = 256;
constexpr int LDS = QT + 4;                // score stage row stride
constexpr float PACK_FLOOR = 3.0e38f;
constexpr int PACK_MASK = 127;
constexpr unsigned int NEG_INF_BITS = 0xff800000u;

static_assert(RC == 16 * (THREADS / 32), "one 16-row WMMA strip per warp");

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

template <typename T> constexpr bool kIsF32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool kIsInt8 = std::is_same<T, signed char>::value;

// Shared memory: the corpus chunk and the query tile of one k-block, then
// the (RC, LDS) score stage, the chunk's RC row scales (int8), and the
// (n_seg, QT) running winners. WMMA types keep each 16x16 tile contiguous
// ("slab" layout: (r, k) at [(k/16)*R*16 + r*16 + k%16]); f32 is stored
// k-major with a padded row, (r, k) at [k*(R+1) + r], for the CUDA cores.
template <typename T> __host__ __device__ constexpr int cs_elems() {
  return kIsF32<T> ? KB * (RC + 1) : RC * KB;
}
template <typename T> __host__ __device__ constexpr int qs_elems() {
  return kIsF32<T> ? KB * (QT + 1) : QT * KB;
}
template <typename T> __host__ __device__ constexpr int stage_offset() {
  return ((cs_elems<T>() + qs_elems<T>()) * (int)sizeof(T) + 127) / 128 * 128;
}
template <typename T> __host__ __device__ constexpr int scales_offset() {
  return stage_offset<T>() + RC * LDS * 4;
}
template <typename T> __host__ __device__ constexpr int winners_offset() {
  return scales_offset<T>() + RC * 4;
}
template <typename T> int smem_bytes(int n_seg) {
  return winners_offset<T>() + QT * (n_seg + 1) * 4;
}

// Copy rows [row0, row0+R) x depth [k0, k0+KB) of a (rows, d) matrix into
// shared memory, zeros past the edges. d is a multiple of 16 elements, so a
// 16-byte vector never straddles the depth edge.
template <typename T, int R>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst,
                                           const T* __restrict__ src, int row0,
                                           int rows, int d, int k0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = KB / VEC;
  for (int v = threadIdx.x; v < R * VPR; v += THREADS) {
    const int r = v / VPR;
    const int kv = (v % VPR) * VEC;
    const int row = row0 + r;
    const int k = k0 + kv;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && k < d)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * d + k));
    if constexpr (kIsF32<T>) {
      dst[(kv + 0) * (R + 1) + r] = __uint_as_float(val.x);
      dst[(kv + 1) * (R + 1) + r] = __uint_as_float(val.y);
      dst[(kv + 2) * (R + 1) + r] = __uint_as_float(val.z);
      dst[(kv + 3) * (R + 1) + r] = __uint_as_float(val.w);
    } else {
      *reinterpret_cast<uint4*>(dst + (kv / 16) * R * 16 + r * 16 + kv % 16) =
          val;
    }
  }
}

// Scores of corpus rows [row0, row0+RC) against queries [q0, q0+QT) into
// stage[r * LDS + q].
template <typename T>
__device__ __forceinline__ void score_chunk(
    const T* __restrict__ q, const T* __restrict__ c, T* cs, T* qs,
    typename AccOf<T>::type* stage, int q0, int nq, int row0, int n, int d) {
  using Acc = typename AccOf<T>::type;
  if constexpr (kIsF32<T>) {
    const int rg = threadIdx.x / 16;  // rows rg*8 .. rg*8+7
    const int qg = threadIdx.x % 16;  // queries qg, qg+16, qg+32, qg+48
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KB) {
      stage_tile<T, RC>(cs, c, row0, n, d, k0);
      stage_tile<T, QT>(qs, q, q0, nq, d, k0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KB; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = cs[k * (RC + 1) + rg * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = qs[k * (QT + 1) + qg + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        stage[(rg * 8 + i) * LDS + qg + 16 * j] = acc[i][j];
  } else {
    const int warp = threadIdx.x / 32;  // rows warp*16 .. warp*16+15
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[QT / 16];
#pragma unroll
    for (int j = 0; j < QT / 16; ++j) wmma::fill_fragment(acc[j], (Acc)0);
    for (int k0 = 0; k0 < d; k0 += KB) {
      stage_tile<T, RC>(cs, c, row0, n, d, k0);
      stage_tile<T, QT>(qs, q, q0, nq, d, k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, cs + kk * RC * 16 + warp * 16 * 16, 16);
#pragma unroll
        for (int j = 0; j < QT / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
          wmma::load_matrix_sync(b, qs + kk * QT * 16 + j * 16 * 16, 16);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
      wmma::store_matrix_sync(stage + warp * 16 * LDS + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
  }
}

__device__ __forceinline__ float pack(float s, bool live, int idx) {
  s = fminf(fmaxf(s, -PACK_FLOOR), PACK_FLOOR);
  if (!live) s = -PACK_FLOOR;
  return __int_as_float((__float_as_int(s) & ~PACK_MASK) | idx);
}

// Float max through integer atomics: a non-negative value wins as a signed
// int, a negative one as the smaller unsigned int. Packed scores are finite.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

constexpr int SEG_LANES = 8;                 // segment lanes of a block
constexpr int QUERY_LANES = THREADS / SEG_LANES;
static_assert(2 * QUERY_LANES == QT, "two queries a thread");

}  // namespace
