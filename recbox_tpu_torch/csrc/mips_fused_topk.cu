// Fused MIPS top-k for Hopper (sm_90a): score, one packed winner per
// 128-row segment, exact top-k of the winners.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/mips_fused_topk.py`
// (`_make_fused_kernel` :100, `_cmp_stage` :80, `mips_fused_topk` :197).
// The function is the TPU kernel's, not its block structure. For each query
// and each corpus row: the dot product in f32 accumulation (bf16 / f32
// inputs; int8 s8 x s8 -> s32, converted to f32 and times the row's scale),
// clipped to +-PACK_FLOOR, rows >= `valid` set to -PACK_FLOOR, the row's
// 7-bit in-segment index OR-ed into the low mantissa bits. Each segment of
// a 1024-row sub-chunk (rows {g, g+8, ..., g+127*8}, the strided plan of
// `mips_topk.py:248-253`) gives one winner by FLOAT max of the packed
// values. The exact top-k of the N/128 winners comes back descending, bits
// cleared and ids rebuilt; pads are (-inf, -1).
//
// Bound on the H100: at the serving shape (Q=8192, N=1M, D=128) the
// scoring is 2*Q*N*D = 2.1e12 operations, 2.2 ms at the bf16 tensor-core
// peak (989 TFLOP/s) and 1.1 ms at int8's (1979 TOP/s); the corpus is 128 or
// 256 MB, under 0.1 ms of HBM. So the kernel is bound by operations.
//
// Design (a first, simple and right version; wgmma/TMA and fusing the two
// launches come later):
//  (a) `score_winners`: a block takes 64 queries and one 1024-row
//      sub-chunk, scores it in 128-row chunks (bf16/int8 on the tensor
//      cores through WMMA m16n16k16 fragments from shared memory, f32 on
//      the CUDA cores), reduces every chunk into its running segment
//      winners and writes one packed winner per (query, segment). The TPU
//      kept a running top-k in VMEM across a grid that ran in order; blocks
//      here run in parallel, so the selection is a second pass.
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
constexpr int SUB_ROWS = 1024;
constexpr int N_SEG = SUB_ROWS / SEGMENT;  // segments per sub-chunk
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
static_assert(QT * N_SEG == 2 * THREADS, "two (query, segment) pairs a thread");

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

template <typename T> constexpr bool kIsF32 = std::is_same<T, float>::value;

// Shared memory: the corpus chunk and the query tile of one k-block, then
// the (RC, LDS) score stage. WMMA types keep each 16x16 tile contiguous
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
template <typename T> __host__ __device__ constexpr int smem_bytes() {
  return stage_offset<T>() + RC * LDS * 4;
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

// Grid (ceil(nq / QT), ceil(n / SUB_ROWS)); winners is (nq, n_cand) with
// candidate sub * N_SEG + g.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    score_winners(const T* __restrict__ q, const T* __restrict__ c,
                  const float* __restrict__ row_scale,
                  float* __restrict__ winners, int nq, int n, int d,
                  int valid) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  T* qs = cs + cs_elems<T>();
  Acc* stage = reinterpret_cast<Acc*>(smem + stage_offset<T>());
  const int q0 = blockIdx.x * QT;
  const int sub = blockIdx.y;
  const int n_cand = gridDim.y * N_SEG;
  const int g = threadIdx.x % N_SEG;
  const int qa = threadIdx.x / N_SEG;  // queries qa and qa + THREADS/N_SEG
  float win[2] = {__uint_as_float(NEG_INF_BITS), __uint_as_float(NEG_INF_BITS)};
  for (int chunk = 0; chunk < SUB_ROWS / RC; ++chunk) {
    const int row0 = sub * SUB_ROWS + chunk * RC;
    score_chunk<T>(q, c, cs, qs, stage, q0, nq, row0, n, d);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < RC / N_SEG; ++i) {
      const int r = g + N_SEG * i;
      const int row = row0 + r;
      const int idx = chunk * (RC / N_SEG) + i;  // (row - sub start) / N_SEG
      float scale = 1.f;
      if constexpr (std::is_same<T, signed char>::value)
        scale = row < n ? __ldg(row_scale + row) : 1.f;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float s =
            (float)stage[r * LDS + qa + w * (THREADS / N_SEG)] * scale;
        win[w] = fmaxf(win[w], pack(s, row < valid, idx));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int qq = q0 + qa + w * (THREADS / N_SEG);
    if (qq < nq) winners[(size_t)qq * n_cand + sub * N_SEG + g] = win[w];
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
                 int* __restrict__ out_i, int n_cand, int k, int p) {
  extern __shared__ long long keys[];
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
    const int id = (cand / N_SEG) * SUB_ROWS + cand % N_SEG +
                   (bits & PACK_MASK) * N_SEG;
    if (q_scale != nullptr) clean *= q_scale[q];
    out_s[(size_t)q * k + j] = alive ? clean : __uint_as_float(NEG_INF_BITS);
    out_i[(size_t)q * k + j] = alive ? id : -1;
  }
}

template <typename T>
int launch_score(const void* q, const void* c, const void* row_scale,
                 void* winners, int nq, int n, int d, int valid,
                 cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      score_winners<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + QT - 1) / QT, (n + SUB_ROWS - 1) / SUB_ROWS);
  score_winners<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c),
      static_cast<const float*>(row_scale), static_cast<float*>(winners), nq,
      n, d, valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int recbox_mips_sub_rows() { return SUB_ROWS; }

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (row_scale required).
// q (nq, d), c (n, d) row-major of that dtype, d a multiple of 16;
// winners (nq, ceil(n / SUB_ROWS) * N_SEG) float32.
int recbox_mips_score_winners(int dtype, const void* q, const void* c,
                              const void* row_scale, void* winners, int nq,
                              int n, int d, int valid, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || d % 16 != 0 ||
      (n + SUB_ROWS - 1) / SUB_ROWS > 65535 || (dtype == 2) != (row_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_score<float>(q, c, row_scale, winners, nq, n, d, valid, st);
    case 1:
      return launch_score<__nv_bfloat16>(q, c, row_scale, winners, nq, n, d,
                                         valid, st);
    case 2:
      return launch_score<signed char>(q, c, row_scale, winners, nq, n, d,
                                       valid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// winners (nq, n_cand) float32; q_scale (nq,) float32 or null;
// out_s (nq, k) float32, out_i (nq, k) int32.
int recbox_mips_topk_winners(const void* winners, const void* q_scale,
                             void* out_s, void* out_i, int nq, int n_cand,
                             int k, int p, void* stream) {
  if (nq <= 0 || k <= 0 || k > n_cand || p < 2 || (p & (p - 1)) != 0 ||
      p > 16384 || (p < n_cand && 2 * k > p))
    return (int)cudaErrorInvalidValue;
  const int smem = p * (int)sizeof(long long);
  cudaError_t e = cudaFuncSetAttribute(
      topk_winners, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  topk_winners<<<nq, TOPK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(winners), static_cast<const float*>(q_scale),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_cand, k, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
