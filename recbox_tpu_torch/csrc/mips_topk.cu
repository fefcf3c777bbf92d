// MIPS segment candidates for Hopper (sm_90a): one winner per (128-row
// segment, query), written candidate-major.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/mips_topk.py`
// (`_make_packed_kernel` :117, `_make_packed_kernel_q8` :165,
// `_make_kernel` :213, called from `mips_segment_candidates` :315, :332,
// :340). For each query and corpus row: the dot product in f32 accumulation
// (bf16 / f32 inputs; int8 s8 x s8 -> s32, converted to f32 and times the
// row's scale). The corpus is cut into sub-chunks of `sub_rows` rows (the
// JAX package's block plan, chosen by the wrapper); segment g of a sub-chunk
// is rows {g, g+n_seg, ..., g+127*n_seg}, n_seg = sub_rows/128. Candidate
// sub*n_seg + g of query q is written at [(sub*n_seg + g) * nq + q]:
//  * packed (f32, bf16, int8): clip to +-PACK_FLOOR, rows >= `valid` to
//    -PACK_FLOOR, the 7-bit in-segment index OR-ed into the low mantissa
//    bits, the float max of the segment;
//  * unpacked (f32, bf16): rows >= `valid` to -inf, the segment's max and
//    the FIRST index that reaches it (jnp.argmax's rule), written as a score
//    and a global row id sub*sub_rows + g + idx*n_seg.
//
// Bound on the H100: at the profiling shape (Q=8192, N=1M, D=128) the
// scoring is 2*Q*N*D = 2.1e12 operations, 2.2 ms at the bf16 tensor-core
// peak and 1.1 ms at int8's; the corpus (128-256 MB) and the candidates
// (260 MB, twice that unpacked) are under 0.2 ms of HBM. Bound by
// operations.
//
// Design: B3's stage (a) (`mips_tile.cuh`): a block takes 64 queries and
// the 128-row chunks of one sub-chunk, scores each chunk into shared memory
// and folds it into running winners of its (query, segment) pairs, then
// stores them candidate-major, 64 consecutive queries of one candidate at a
// time. The TPU looped over query tiles; here one launch covers every
// query (the segment plan is the same for every tile). When there are too
// few blocks to fill the card, the packed variants split a sub-chunk's
// chunks over `splits` blocks merged by an atomic float max; the unpacked
// variant runs without splits, so its first-index rule needs no 64-bit
// atomics (rows reach a block's fold in ascending index order).

#include "mips_tile.cuh"

namespace {

// Grid (ceil(nq / QT), ceil(n / sub_rows), splits). cand_s is
// (>= ceil(n / sub_rows) * n_seg, nq); its first rows are filled with -inf
// beforehand when splits > 1. FIXED_SEG = 8 is the plan of query tiles of
// 1024 rows over a 128-wide bf16 / int8 corpus; 0 reads n_seg from
// sub_rows.
template <typename T, int FIXED_SEG, bool PACKED>
__global__ void __launch_bounds__(THREADS)
    segment_candidates(const T* __restrict__ q, const T* __restrict__ c,
                       const float* __restrict__ row_scale,
                       float* __restrict__ cand_s, int* __restrict__ cand_i,
                       int nq, int n, int d, int valid, int sub_rows) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  T* qs = cs + cs_elems<T>();
  Acc* stage = reinterpret_cast<Acc*>(smem + stage_offset<T>());
  float* scales = reinterpret_cast<float*>(smem + scales_offset<T>());
  float* win = reinterpret_cast<float*>(smem + winners_offset<T>());
  const int n_seg = FIXED_SEG ? FIXED_SEG : sub_rows / SEGMENT;
  const int ws = n_seg + 1;
  int* win_idx = reinterpret_cast<int*>(win + QT * ws);  // unpacked only
  const int q0 = blockIdx.x * QT;
  const int sub = blockIdx.y;
  const int chunks = n_seg * SEGMENT / RC;
  const int per_split = (chunks + gridDim.z - 1) / gridDim.z;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(chunks, c_begin + per_split);
  const int gl = threadIdx.x % SEG_LANES;
  const int qa = threadIdx.x / SEG_LANES;  // queries qa and qa + QUERY_LANES
  const float neg_inf = __uint_as_float(NEG_INF_BITS);
  for (int p = threadIdx.x; p < QT * ws; p += THREADS) {
    win[p] = neg_inf;
    if constexpr (!PACKED) win_idx[p] = 0;
  }
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int l0 = chunk * RC;  // first row of the chunk within the sub-chunk
    const int row0 = sub * sub_rows + l0;
    if constexpr (kIsInt8<T>) {
      // read before score_chunk's first barrier, after the last chunk's
      for (int r = threadIdx.x; r < RC; r += THREADS)
        scales[r] = row0 + r < n ? __ldg(row_scale + row0 + r) : 1.f;
    }
    score_chunk<T>(q, c, cs, qs, stage, q0, nq, row0, n, d);
    __syncthreads();
    for (int g = gl; g < n_seg; g += SEG_LANES) {
      float w0 = win[qa * ws + g];
      float w1 = win[(qa + QUERY_LANES) * ws + g];
      int i0 = 0, i1 = 0;
      if constexpr (!PACKED) {
        i0 = win_idx[qa * ws + g];
        i1 = win_idx[(qa + QUERY_LANES) * ws + g];
      }
      // the rows r = g + n_seg * idx - l0 of segment g in this chunk
      const int idx0 = (l0 - g + n_seg - 1) / n_seg;
#pragma unroll 4
      for (int r = g + n_seg * idx0 - l0, idx = idx0; r < RC;
           r += n_seg, ++idx) {
        float s0 = (float)stage[r * LDS + qa];
        float s1 = (float)stage[r * LDS + qa + QUERY_LANES];
        if constexpr (kIsInt8<T>) {
          s0 *= scales[r];
          s1 *= scales[r];
        }
        const bool live = row0 + r < valid;
        if constexpr (PACKED) {
          w0 = fmaxf(w0, pack(s0, live, idx));
          w1 = fmaxf(w1, pack(s1, live, idx));
        } else {
          // strictly greater: the first index of the max is kept
          if (live && s0 > w0) {
            w0 = s0;
            i0 = idx;
          }
          if (live && s1 > w1) {
            w1 = s1;
            i1 = idx;
          }
        }
      }
      win[qa * ws + g] = w0;
      win[(qa + QUERY_LANES) * ws + g] = w1;
      if constexpr (!PACKED) {
        win_idx[qa * ws + g] = i0;
        win_idx[(qa + QUERY_LANES) * ws + g] = i1;
      }
    }
    __syncthreads();
  }
  // candidate-major store: consecutive threads take consecutive queries
  for (int p = threadIdx.x; p < QT * n_seg; p += THREADS) {
    const int qq = p % QT;
    const int g = p / QT;
    if (q0 + qq >= nq) continue;
    const size_t at = (size_t)(sub * n_seg + g) * nq + q0 + qq;
    const float w = win[qq * ws + g];
    if constexpr (PACKED) {
      if (gridDim.z == 1)
        cand_s[at] = w;
      else
        atomic_max_float(cand_s + at, w);
    } else {
      cand_s[at] = w;
      cand_i[at] = sub * sub_rows + g + win_idx[qq * ws + g] * n_seg;
    }
  }
}

template <typename T, bool PACKED>
int launch(const void* q, const void* c, const void* row_scale, void* cand_s,
           void* cand_i, int nq, int n, int d, int valid, int sub_rows,
           int splits, cudaStream_t stream) {
  const int n_seg = sub_rows / SEGMENT;
  const int smem = smem_bytes<T>(n_seg) + (PACKED ? 0 : QT * (n_seg + 1) * 4);
  auto kernel = sub_rows == 8 * SEGMENT ? segment_candidates<T, 8, PACKED>
                                        : segment_candidates<T, 0, PACKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + QT - 1) / QT, (n + sub_rows - 1) / sub_rows, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c),
      static_cast<const float*>(row_scale), static_cast<float*>(cand_s),
      static_cast<int*>(cand_i), nq, n, d, valid, sub_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (row_scale required, packed
// only). q (nq, d), c (n, d) row-major of that dtype, d a multiple of 16;
// sub_rows a multiple of 128 up to 32768; cand_s float32 and, unpacked,
// cand_i int32, each with at least ceil(n / sub_rows) * sub_rows / 128 rows
// of nq; splits 1 unpacked, else 1 <= splits <= sub_rows / 128 (cand_s's
// rows then start at -inf).
int recbox_mips_segment_candidates(int dtype, int packed, const void* q,
                                   const void* c, const void* row_scale,
                                   void* cand_s, void* cand_i, int nq, int n,
                                   int d, int valid, int sub_rows, int splits,
                                   void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || d % 16 != 0 || sub_rows < SEGMENT ||
      sub_rows > MAX_SUB_ROWS || sub_rows % SEGMENT != 0 || splits < 1 ||
      splits > sub_rows / RC || (n + sub_rows - 1) / sub_rows > 65535 ||
      (dtype == 2) != (row_scale != nullptr) ||
      (!packed && (dtype == 2 || splits != 1 || cand_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (packed ? 1 : 0)) {
    case 0:
      return launch<float, false>(q, c, row_scale, cand_s, cand_i, nq, n, d,
                                  valid, sub_rows, splits, st);
    case 1:
      return launch<float, true>(q, c, row_scale, cand_s, cand_i, nq, n, d,
                                 valid, sub_rows, splits, st);
    case 2:
      return launch<__nv_bfloat16, false>(q, c, row_scale, cand_s, cand_i, nq,
                                          n, d, valid, sub_rows, splits, st);
    case 3:
      return launch<__nv_bfloat16, true>(q, c, row_scale, cand_s, cand_i, nq,
                                         n, d, valid, sub_rows, splits, st);
    case 5:
      return launch<signed char, true>(q, c, row_scale, cand_s, cand_i, nq, n,
                                       d, valid, sub_rows, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
