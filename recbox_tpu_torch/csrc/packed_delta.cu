// Fused row-wise AdaGrad update of a packed embedding table for Hopper
// (sm_90a): the delta and its scatter-add in one pass.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/packed_delta.py`
// (`_make_kernel` :62, `fused_adagrad_delta` :90) together with the
// `pack.at[ids].add(operand)` that consumed its output
// (`recbox_tpu/training/packed.py:649`). For row i of a step, with G the
// gathered pre-step pack rows and g_s the row gradient of slot s:
//
//   g2_s    = mean(g_s^2)
//   delta_s = (-lr * g_s) / (sqrt(G[i, acc_s] + g2_s) + eps)
//
// in f32, in the op order of the JAX kernel, and pack[ids[i]] += the operand
// row [delta_0 .. delta_K | g2_0 .. g2_K | 0 pad]. The (N, store_w) operand
// the TPU wrote between the two steps never exists here. A duplicate id adds
// one update per occurrence, each from the pre-step accumulator plus its own
// g^2 (the per-example semantics of `packed.py:27-32`); the atomics make the
// order of those sums vary from run to run. Ids outside the pack are
// skipped, as `.at[ids].add` drops them.
//
// Bound on the H100 at the Criteo training shape (N = 851,968 rows, slots of
// 64 and 1 columns in bf16, 67 used f32 columns): per row 4 B of id, 8 B of
// accumulators, 130 B of gradients and a 536 B read-modify-write of the used
// columns of each distinct pack row, ~510 MB a step, 0.152 ms at 3.35 TB/s.
// So the kernel is bound by bytes; it does ~6 operations per element.
//
// The first version (one warp a row, one f32 atomicAdd per column, slots in
// turn) took 4x that. This design:
// - emits a row's operand as VEC-wide reductions (`atomicAdd` on float4 /
//   float2, global memory, sm_90: REDG.E.ADD.F32x4) over columns [0,
//   round_up(used, VEC)): 17 a row instead of 67 at the Criteo layout,
//   columns 64-67 (slot 1's value, the two g^2s, one zero of the pad) as one
//   vector. The pad adds +0.0, as JAX's operand does there. The wrapper
//   picks VEC from the pack's row width and base alignment; the entry
//   derives the warps of a block from the rows they stage;
// - builds each operand row in shared memory, slot by slot, so that no
//   lane has to know which slot a column of a mixed chunk belongs to: a
//   row's LPR = 16 lanes read the slot's gradient in VEC-wide vectors (8 or
//   16 bytes where aligned; wider slots in several passes), store it and
//   sum its squares, reduce the sum by shuffles, and rewrite their own
//   columns as deltas; lane 0 adds the g^2 column. The ids and
//   accumulators are read beside the gradients;
// - lets a lane carry ROWS rows at once, so a warp has 4 rows' loads in
//   flight, at most 40 registers a thread for 6 blocks of 8 warps an SM;
// - sums the block's staged rows of one id (32 rows at the Criteo layout)
//   into the first of them, which alone adds them to the pack. Each delta
//   is still computed from the pre-step accumulator, so the per-occurrence
//   semantics stand; at Zipf(1.2) ids the reductions that queue on the
//   hottest rows fall ~5-fold, which the card showed to pay more than
//   twice over; at uniform ids it costs a block barrier;
// - keeps the general layout: up to 8 slots of any width, acc_cols
//   anywhere in G (rows wider than ~29k columns are refused).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLOTS = 8;
constexpr int MAX_WARPS = 8;
constexpr int ROWS = 2;  // rows a lane group carries at once
constexpr int LPR = 16;  // lanes of a row
constexpr int GROUPS = 32 / LPR;
constexpr int SMEM_MAX = 227 * 1024;

struct Layout {
  const void* grad[MAX_SLOTS];  // (n_rows, dim[s]) row-major
  int dim[MAX_SLOTS];
  int col[MAX_SLOTS];           // first value column of slot s
  int acc[MAX_SLOTS];           // accumulator column of the slot in G
  int n;
  int val_w;                    // sum of dims: slot s's g2 at val_w + s
  int used;                     // val_w + n
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BYTES> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned int; };
template <> struct Vec<2> { using T = unsigned short; };

// Whole vectors: slot s's values load VEC at a time, aligned, and store
// aligned into the operand row.
template <typename GT, int VEC>
__device__ __forceinline__ bool whole_vectors(const Layout& lay, int s) {
  using LD = typename Vec<VEC * sizeof(GT)>::T;
  return lay.dim[s] % VEC == 0 && lay.col[s] % VEC == 0 &&
         reinterpret_cast<uintptr_t>(lay.grad[s]) % sizeof(LD) == 0;
}

// Values j0 + [0, VEC) of row i of slot s's gradient (0 past the slot or
// for a row past the end).
template <typename GT, int VEC>
__device__ __forceinline__ void load_step(const Layout& lay, int s,
                                          long long i, bool live, int j0,
                                          float (&v)[VEC]) {
  using LD = typename Vec<VEC * sizeof(GT)>::T;
  const int d = lay.dim[s];
  const GT* src = static_cast<const GT*>(lay.grad[s]) + (size_t)i * d + j0;
  if (!live || j0 >= d) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = 0.f;
  } else if (whole_vectors<GT, VEC>(lay, s)) {
    const LD raw = __ldg(reinterpret_cast<const LD*>(src));
    const GT* e = reinterpret_cast<const GT*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = j0 + j < d ? to_float(__ldg(src + j)) : 0.f;
  }
}

// Chunk k (VEC floats) of an operand row in shared memory.
template <int VEC>
__device__ __forceinline__ void load_operand(const float* row, int k,
                                             float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = reinterpret_cast<const float4*>(row)[k];
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = reinterpret_cast<const float2*>(row)[k];
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = row[k];
  }
}

template <int VEC>
__device__ __forceinline__ void reduce_add(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Grid: ceil(n_rows / (warps * GROUPS * ROWS)) blocks of 32 * warps
// threads. Lane group g (LPR lanes) of warp w takes rows first + r GROUPS
// + g, r < ROWS, each staged as its operand row of width =
// round_up(used, VEC) floats in the warp's part of the dynamic shared
// memory. Lane q of a group takes a slot's values j0 + [0, VEC), j0 = VEC
// (q + LPR m), and the operand's chunks q + LPR m.
template <typename GT, int VEC>
__global__ void __launch_bounds__(32 * MAX_WARPS, 6)
    packed_adagrad_update(float* __restrict__ pack, long long pack_rows,
                          int pack_w, const int* __restrict__ ids,
                          const float* __restrict__ G, int g_w, int n_rows,
                          Layout lay, float lr, float eps) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % LPR, group = lane / LPR;
  const int width = (lay.used + VEC - 1) / VEC * VEC;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x / 32) + warp) * GROUPS * ROWS +
      group;
  long long i[ROWS];
  bool live[ROWS];
  int id[ROWS];
  float* row[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    i[r] = first + (long long)r * GROUPS;
    live[r] = i[r] < n_rows;
    id[r] = live[r] ? __ldg(ids + i[r]) : -1;
    row[r] = reinterpret_cast<float*>(smem) +
             (size_t)((warp * ROWS + r) * GROUPS + group) * width;
    for (int c = lay.used + q; c < width; c += LPR) row[r][c] = 0.f;
  }
  for (int s = 0; s < lay.n; ++s) {
    const int d = lay.dim[s], col = lay.col[s];
    const bool whole = whole_vectors<GT, VEC>(lay, s);
    float acc[ROWS], ss[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r] = live[r] ? __ldg(G + (size_t)i[r] * g_w + lay.acc[s]) : 0.f;
      ss[r] = 0.f;
    }
    // g_s into the operand rows as it is, and the sums of its squares
    for (int j0 = q * VEC; j0 < d; j0 += LPR * VEC) {
      float v[ROWS][VEC];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        load_step<GT, VEC>(lay, s, i[r], live[r], j0, v[r]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss[r] = fmaf(v[r][j], v[r][j], ss[r]);
        float* dst = row[r] + col + j0;
        if (whole) {
          if constexpr (VEC == 4)
            *reinterpret_cast<float4*>(dst) =
                make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
          else if constexpr (VEC == 2)
            *reinterpret_cast<float2*>(dst) = make_float2(v[r][0], v[r][1]);
          else
            dst[0] = v[r][0];
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (j0 + j < d) dst[j] = v[r][j];
        }
      }
    }
    // g2 and the denominator in every lane of the row, then the deltas in
    // place: each lane rewrites the columns it wrote
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        ss[r] += __shfl_xor_sync(FULL, ss[r], o);
      const float g2 = ss[r] / (float)d;
      const float den = sqrtf(acc[r] + g2) + eps;
      for (int j0 = q * VEC; j0 < d; j0 += LPR * VEC) {
        float* x = row[r] + col + j0;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (j0 + j < d) x[j] = (-lr * x[j]) / den;
      }
      if (q == 0) row[r][lay.val_w + s] = g2;
    }
  }
  // the block's staged rows of one id are summed into the first of them,
  // which alone adds them to the pack: at skewed ids far fewer reductions
  // queue on the same few rows
  __shared__ int staged_id[32];
  const int staged = blockDim.x / 32 * ROWS * GROUPS;
  int t[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    t[r] = (warp * ROWS + r) * GROUPS + group;
    if (q == 0) staged_id[t[r]] = id[r] >= 0 && id[r] < pack_rows ? id[r] : -1;
  }
  __syncthreads();
  unsigned int same[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    same[r] = 0;
    for (int u = q; u < staged; u += LPR)
      if (staged_id[u] == id[r]) same[r] |= 1u << u;
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      same[r] |= __shfl_xor_sync(FULL, same[r], o);
  }
  // one VEC-wide reduction per chunk of each operand row
  const int chunks = width / VEC;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (staged_id[t[r]] < 0 || (same[r] & ((1u << t[r]) - 1)) != 0)
      continue;  // outside the pack, or summed into an earlier row
    const unsigned int rest = same[r] & ~(1u << t[r]);
    float* dst = pack + (size_t)id[r] * pack_w;
    for (int k = q; k < chunks; k += LPR) {
      float x[VEC];
      load_operand<VEC>(row[r], k, x);
      for (unsigned int m = rest; m; m &= m - 1) {
        float y[VEC];
        load_operand<VEC>(reinterpret_cast<float*>(smem) +
                              (size_t)(__ffs(m) - 1) * width,
                          k, y);
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[j] += y[j];
      }
      reduce_add<VEC>(dst + k * VEC, x);
    }
  }
}

// Bytes of shared memory a warp stages: GROUPS * ROWS operand rows of
// round_up(used, vec) floats.
long long staged_bytes(int used, int vec) {
  return (long long)GROUPS * ROWS * ((used + vec - 1) / vec * vec) * 4;
}

template <typename GT, int VEC>
int launch(int warps, cudaStream_t st, float* p, long long pack_rows,
           int pack_w, const int* id, const float* g, int g_w, int n_rows,
           const Layout& lay, float lr, float eps) {
  const long long per_block = (long long)warps * GROUPS * ROWS;
  const unsigned int blocks =
      (unsigned int)(((long long)n_rows + per_block - 1) / per_block);
  const size_t smem = (size_t)(warps * staged_bytes(lay.used, VEC));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_adagrad_update<GT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  packed_adagrad_update<GT, VEC><<<blocks, 32 * warps, smem, st>>>(
      p, pack_rows, pack_w, id, g, g_w, n_rows, lay, lr, eps);
  return (int)cudaGetLastError();
}

template <typename GT>
int launch_vec(int vec, int warps, cudaStream_t st, float* p,
               long long pack_rows, int pack_w, const int* id,
               const float* g, int g_w, int n_rows, const Layout& lay,
               float lr, float eps) {
  switch (vec) {
    case 4:
      return launch<GT, 4>(warps, st, p, pack_rows, pack_w, id, g, g_w,
                           n_rows, lay, lr, eps);
    case 2:
      return launch<GT, 2>(warps, st, p, pack_rows, pack_w, id, g, g_w,
                           n_rows, lay, lr, eps);
    default:
      return launch<GT, 1>(warps, st, p, pack_rows, pack_w, id, g, g_w,
                           n_rows, lay, lr, eps);
  }
}

}  // namespace

extern "C" {

// grad_dtype: 0 = float32, 1 = bfloat16 (every slot the same).
// pack (pack_rows, pack_w) f32, updated in place; ids (n_rows,) int32;
// G (n_rows, g_w) f32; grads[s] (n_rows, dims[s]); host arrays of n_slots;
// slot s's values at pack columns cols[s] = dims[0] + .. + dims[s - 1], its
// g2 at g2_col0 + s with g2_col0 = the sum of dims. vec in {4, 2, 1}: the
// width of a reduction, with pack_w and the pack's base (in floats) its
// multiples. A block has 8 warps, or fewer where their staged rows (4 a
// warp, round_up(used, vec) floats each) would pass 227 KB; rows too wide
// for one warp's are refused.
int recbox_packed_adagrad_update(int grad_dtype, void* pack,
                                 long long pack_rows, int pack_w,
                                 const void* ids, const void* G, int g_w,
                                 int n_rows, int n_slots,
                                 const void* const* grads, const int* dims,
                                 const int* cols, const int* accs,
                                 int g2_col0, float lr, float eps, int vec,
                                 void* stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_slots > MAX_SLOTS || pack_w <= 0 ||
      g_w <= 0 || g2_col0 < 0 || g2_col0 + n_slots > pack_w ||
      (vec != 1 && vec != 2 && vec != 4) || pack_w % vec != 0 ||
      reinterpret_cast<uintptr_t>(pack) % (4 * vec) != 0)
    return (int)cudaErrorInvalidValue;
  Layout lay{};
  lay.n = n_slots;
  int col = 0;
  for (int s = 0; s < n_slots; ++s) {
    if (grads[s] == nullptr || dims[s] <= 0 || cols[s] != col ||
        accs[s] < 0 || accs[s] >= g_w)
      return (int)cudaErrorInvalidValue;
    lay.grad[s] = grads[s];
    lay.dim[s] = dims[s];
    lay.col[s] = col;
    lay.acc[s] = accs[s];
    col += dims[s];
  }
  if (g2_col0 != col) return (int)cudaErrorInvalidValue;
  lay.val_w = col;
  lay.used = col + n_slots;
  const long long fit = SMEM_MAX / staged_bytes(lay.used, vec);
  if (fit == 0) return (int)cudaErrorInvalidValue;
  const int warps = fit < MAX_WARPS ? (int)fit : MAX_WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(pack);
  const int* id = static_cast<const int*>(ids);
  const float* g = static_cast<const float*>(G);
  switch (grad_dtype) {
    case 0:
      return launch_vec<float>(vec, warps, st, p, pack_rows, pack_w, id,
                               g, g_w, n_rows, lay, lr, eps);
    case 1:
      return launch_vec<__nv_bfloat16>(vec, warps, st, p, pack_rows, pack_w,
                                       id, g, g_w, n_rows, lay, lr, eps);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
