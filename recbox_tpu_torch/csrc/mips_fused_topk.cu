// Fused MIPS top-k for Hopper (sm_90a): score, one packed winner per
// 128-row segment, exact top-k of the winners.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/mips_fused_topk.py`
// (`_make_fused_kernel` :100, `_cmp_stage` :80, `mips_fused_topk` :197).
// The function is the TPU kernel's, not its block structure. For each query
// and each corpus row: the dot product in f32 accumulation (bf16 / f32
// inputs; int8 s8 x s8 -> s32, converted to f32 and times the row's scale),
// clipped to +-PACK_FLOOR, rows >= `valid` set to -PACK_FLOOR, the row's
// 7-bit in-segment index OR-ed into the low mantissa bits. The corpus is
// cut into sub-chunks of `sub_rows` rows (a multiple of 128 up to 32768,
// chosen by the wrapper from the JAX package's block plan); segment g of a
// sub-chunk is rows {g, g+n_seg, ..., g+127*n_seg}, n_seg = sub_rows/128
// (the strided plan of `mips_topk.py:248-253`), and gives one winner by
// FLOAT max of the packed values. The exact top-k of the winners comes back
// descending, bits cleared and ids rebuilt; pads are (-inf, -1).
//
// Bound on the H100: at the serving shape (Q=8192, N=1M, D=128) the
// scoring is 2*Q*N*D = 2.1e12 operations, 2.2 ms at the bf16 tensor-core
// peak (989 TFLOP/s) and 1.1 ms at int8's (1979 TOP/s); the corpus is 128 or
// 256 MB, under 0.1 ms of HBM. So the kernel is bound by operations.
//
// Design (a first, simple and right version; wgmma/TMA and fusing the two
// launches come later):
//  (a) `score_winners`: a block takes 64 queries and the 128-row chunks
//      of one sub-chunk (all of them, or one of `splits` runs of them when
//      there are too few (query tile, sub-chunk) blocks to fill the card),
//      scores each chunk (bf16/int8 on the tensor cores through WMMA
//      m16n16k16 fragments from shared memory, f32 on the CUDA cores), and
//      folds it into the running winners of its (query, segment) pairs,
//      kept in shared memory (n_seg need not divide 128, so a chunk may
//      hold a different number of rows of each segment). A thread takes
//      segments g = t % 8 + 8j for two queries, so one pass over a
//      segment's rows serves both. It writes one packed winner per pair;
//      split runs merge theirs with an atomic float max. The TPU kept a
//      running top-k in VMEM across a grid that ran in order; blocks here
//      run in parallel, so the selection is a second pass.
//  (b) `topk_winners`: one block per query sorts (order key, candidate)
//      pairs in shared memory with a bitonic network, in windows of at most
//      16384 keys, keeping the top k between windows.
// The order key is the float's bits made to sort as a signed integer, with
// the candidate position in the low 32 bits: a total order that the plain
// PyTorch version reproduces, so ties break the same way in both.

#include <climits>
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
constexpr int TOPK_THREADS = 512;
constexpr float PACK_FLOOR = 3.0e38f;
constexpr int PACK_MASK = 127;
constexpr unsigned int NEG_INF_BITS = 0xff800000u;

static_assert(RC == 16 * (THREADS / 32), "one 16-row WMMA strip per warp");

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

template <typename T> constexpr bool kIsF32 = std::is_same<T, float>::value;

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

// Grid (ceil(nq / QT), ceil(n / sub_rows), splits); winners is (nq, n_cand)
// with candidate sub * n_seg + g, filled with -inf beforehand when
// splits > 1. The block's winners are win[q * (n_seg + 1) + g], padded so
// the 8 segment lanes of a warp fall in distinct banks. FIXED_SEG = 8 is
// the serving plan (1024-row sub-chunks, every query tile of 1024): with
// n_seg known at compile time the row loops unroll fully; 0 reads n_seg
// from sub_rows.
template <typename T, int FIXED_SEG>
__global__ void __launch_bounds__(THREADS)
    score_winners(const T* __restrict__ q, const T* __restrict__ c,
                  const float* __restrict__ row_scale,
                  float* __restrict__ winners, int nq, int n, int d,
                  int valid, int sub_rows) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  T* qs = cs + cs_elems<T>();
  Acc* stage = reinterpret_cast<Acc*>(smem + stage_offset<T>());
  float* scales = reinterpret_cast<float*>(smem + scales_offset<T>());
  float* win = reinterpret_cast<float*>(smem + winners_offset<T>());
  const int n_seg = FIXED_SEG ? FIXED_SEG : sub_rows / SEGMENT;
  const int ws = n_seg + 1;
  const int q0 = blockIdx.x * QT;
  const int sub = blockIdx.y;
  const int n_cand = gridDim.y * n_seg;
  const int chunks = n_seg * SEGMENT / RC;
  const int per_split = (chunks + gridDim.z - 1) / gridDim.z;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(chunks, c_begin + per_split);
  const int gl = threadIdx.x % SEG_LANES;
  const int qa = threadIdx.x / SEG_LANES;  // queries qa and qa + QUERY_LANES
  for (int p = threadIdx.x; p < QT * ws; p += THREADS)
    win[p] = __uint_as_float(NEG_INF_BITS);
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int l0 = chunk * RC;  // first row of the chunk within the sub-chunk
    const int row0 = sub * sub_rows + l0;
    if constexpr (std::is_same<T, signed char>::value) {
      // read before score_chunk's first barrier, after the last chunk's
      for (int r = threadIdx.x; r < RC; r += THREADS)
        scales[r] = row0 + r < n ? __ldg(row_scale + row0 + r) : 1.f;
    }
    score_chunk<T>(q, c, cs, qs, stage, q0, nq, row0, n, d);
    __syncthreads();
    for (int g = gl; g < n_seg; g += SEG_LANES) {
      float w0 = win[qa * ws + g];
      float w1 = win[(qa + QUERY_LANES) * ws + g];
      // the rows r = g + n_seg * idx - l0 of segment g in this chunk
      const int idx0 = (l0 - g + n_seg - 1) / n_seg;
#pragma unroll 4
      for (int r = g + n_seg * idx0 - l0, idx = idx0; r < RC;
           r += n_seg, ++idx) {
        float s0 = (float)stage[r * LDS + qa];
        float s1 = (float)stage[r * LDS + qa + QUERY_LANES];
        if constexpr (std::is_same<T, signed char>::value) {
          s0 *= scales[r];
          s1 *= scales[r];
        }
        const bool live = row0 + r < valid;
        w0 = fmaxf(w0, pack(s0, live, idx));
        w1 = fmaxf(w1, pack(s1, live, idx));
      }
      win[qa * ws + g] = w0;
      win[(qa + QUERY_LANES) * ws + g] = w1;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < QT * n_seg; p += THREADS) {
    const int qq = p / n_seg;
    const int g = p % n_seg;
    if (q0 + qq >= nq) continue;
    float* dst = winners + (size_t)(q0 + qq) * n_cand + sub * n_seg + g;
    if (gridDim.z == 1)
      *dst = win[qq * ws + g];
    else
      atomic_max_float(dst, win[qq * ws + g]);
  }
}

__device__ __forceinline__ long long order_key(float v, int cand) {
  const int b = __float_as_int(v);
  const int ks = b ^ ((b >> 31) & 0x7FFFFFFF);
  return (long long)(((unsigned long long)(unsigned int)ks << 32) |
                     (unsigned int)cand);
}

__device__ void bitonic_sort_desc(long long* s, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const long long a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Grid (nq); p is a power of two holding every candidate, or, when there
// are more, a window with k <= p/2 so each window adds p - k new ones.
__global__ void __launch_bounds__(TOPK_THREADS)
    topk_winners(const float* __restrict__ winners,
                 const float* __restrict__ q_scale, float* __restrict__ out_s,
                 int* __restrict__ out_i, int n_cand, int k, int p,
                 int sub_rows) {
  extern __shared__ long long keys[];
  const int n_seg = sub_rows / SEGMENT;
  const int q = blockIdx.x;
  const float* w = winners + (size_t)q * n_cand;
  int keep = 0;
  for (int off = 0; off < n_cand;) {
    const int take = p - keep;
    for (int j = threadIdx.x; j < take; j += blockDim.x) {
      const int cand = off + j;
      keys[keep + j] =
          cand < n_cand ? order_key(__ldg(w + cand), cand) : LLONG_MIN;
    }
    __syncthreads();
    bitonic_sort_desc(keys, p);
    off += take;
    keep = k;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long key = keys[j];
    const int ks = (int)(key >> 32);
    const int bits = ks ^ ((ks >> 31) & 0x7FFFFFFF);
    const int cand = (int)(key & 0xFFFFFFFFLL);
    float clean = __int_as_float(bits & ~PACK_MASK);
    // a pad key decodes to a NaN, which is not alive either
    const bool alive = clean > -PACK_FLOOR * 0.5f;
    const int id = (cand / n_seg) * sub_rows + cand % n_seg +
                   (bits & PACK_MASK) * n_seg;
    if (q_scale != nullptr) clean *= q_scale[q];
    out_s[(size_t)q * k + j] = alive ? clean : __uint_as_float(NEG_INF_BITS);
    out_i[(size_t)q * k + j] = alive ? id : -1;
  }
}

template <typename T>
int launch_score(const void* q, const void* c, const void* row_scale,
                 void* winners, int nq, int n, int d, int valid, int sub_rows,
                 int splits, cudaStream_t stream) {
  const int smem = smem_bytes<T>(sub_rows / SEGMENT);
  auto kernel = sub_rows == 8 * SEGMENT ? score_winners<T, 8>
                                        : score_winners<T, 0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + QT - 1) / QT, (n + sub_rows - 1) / sub_rows, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c),
      static_cast<const float*>(row_scale), static_cast<float*>(winners), nq,
      n, d, valid, sub_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (row_scale required).
// q (nq, d), c (n, d) row-major of that dtype, d a multiple of 16;
// sub_rows a multiple of 128 up to 32768; splits runs of chunks per
// sub-chunk, 1 <= splits <= sub_rows / 128;
// winners (nq, ceil(n / sub_rows) * sub_rows / 128) float32, all -inf
// when splits > 1.
int recbox_mips_score_winners(int dtype, const void* q, const void* c,
                              const void* row_scale, void* winners, int nq,
                              int n, int d, int valid, int sub_rows,
                              int splits, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || d % 16 != 0 || sub_rows < SEGMENT ||
      sub_rows > MAX_SUB_ROWS || sub_rows % SEGMENT != 0 || splits < 1 ||
      splits > sub_rows / RC ||
      (n + sub_rows - 1) / sub_rows > 65535 ||
      (dtype == 2) != (row_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_score<float>(q, c, row_scale, winners, nq, n, d, valid,
                                 sub_rows, splits, st);
    case 1:
      return launch_score<__nv_bfloat16>(q, c, row_scale, winners, nq, n, d,
                                         valid, sub_rows, splits, st);
    case 2:
      return launch_score<signed char>(q, c, row_scale, winners, nq, n, d,
                                       valid, sub_rows, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// winners (nq, n_cand) float32 of the plan with `sub_rows`; q_scale (nq,)
// float32 or null; out_s (nq, k) float32, out_i (nq, k) int32.
int recbox_mips_topk_winners(const void* winners, const void* q_scale,
                             void* out_s, void* out_i, int nq, int n_cand,
                             int k, int p, int sub_rows, void* stream) {
  if (nq <= 0 || k <= 0 || k > n_cand || p < 2 || (p & (p - 1)) != 0 ||
      p > 16384 || (p < n_cand && 2 * k > p) || sub_rows < SEGMENT ||
      sub_rows > MAX_SUB_ROWS || sub_rows % SEGMENT != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = p * (int)sizeof(long long);
  cudaError_t e = cudaFuncSetAttribute(
      topk_winners, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  topk_winners<<<nq, TOPK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(winners), static_cast<const float*>(q_scale),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_cand, k, p,
      sub_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
