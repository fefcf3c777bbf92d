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
// in f32, in the op order of the JAX kernel, and pack[ids[i], col_s + j] +=
// delta_s[j], pack[ids[i], g2_col0 + s] += g2_s. The (N, store_w) operand the
// TPU wrote between the two steps never exists here. A duplicate id adds one
// update per occurrence, each from the pre-step accumulator plus its own g^2
// (the per-example semantics of `packed.py:27-32`); the atomics make the
// order of those sums vary from run to run. Ids outside the pack are
// skipped, as `.at[ids].add` drops them.
//
// Bound on the H100 at the Criteo training shape (N = 851,968 rows, slots of
// 64 and 1 columns in bf16, 67 used f32 columns): per row 4 B of id, 8 B of
// accumulators, 130 B of gradients and a 536 B read-modify-write of the used
// columns, ~578 MB a step, 0.17 ms at 3.35 TB/s. So the kernel is bound by
// bytes; it does ~6 operations per element.
//
// Design (a first, simple and right version): one warp per row. The warp
// reduces g^2 with shuffles, reads only the accumulator columns of G, and
// adds with f32 atomicAdd into the used columns only (the zero pad adds
// nothing), 32 neighbouring columns per instruction. Vector atomics
// (red.global.add.v4.f32), sorted ids and fusing the gather come later.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLOTS = 8;
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

struct Slots {
  const void* grad[MAX_SLOTS];  // (n_rows, dim[s]) row-major
  int dim[MAX_SLOTS];
  int col[MAX_SLOTS];           // first value column of the slot in the pack
  int acc[MAX_SLOTS];           // accumulator column of the slot in G
  int n;
  int g2_col0;                  // pack column of slot 0's g2; slot s at +s
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename GT>
__global__ void __launch_bounds__(THREADS)
    packed_adagrad_update(float* __restrict__ pack, long long pack_rows,
                          int pack_w, const int* __restrict__ ids,
                          const float* __restrict__ G, int g_w, int n_rows,
                          Slots slots, float lr, float eps) {
  const long long i = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_rows) return;
  const int id = __ldg(ids + i);
  if (id < 0 || id >= pack_rows) return;
  float* dst = pack + (size_t)id * pack_w;
  const float* gi = G + (size_t)i * g_w;
  for (int s = 0; s < slots.n; ++s) {
    const int d = slots.dim[s];
    const GT* g = static_cast<const GT*>(slots.grad[s]) + (size_t)i * d;
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = to_float(g[j]);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float g2 = ss / (float)d;
    const float denom = sqrtf(__ldg(gi + slots.acc[s]) + g2) + eps;
    for (int j = lane; j < d; j += 32)
      atomicAdd(dst + slots.col[s] + j, (-lr * to_float(g[j])) / denom);
    if (lane == 0) atomicAdd(dst + slots.g2_col0 + s, g2);
  }
}

}  // namespace

extern "C" {

// grad_dtype: 0 = float32, 1 = bfloat16 (every slot the same).
// pack (pack_rows, pack_w) f32, updated in place; ids (n_rows,) int32;
// G (n_rows, g_w) f32; grads[s] (n_rows, dims[s]); host arrays of n_slots.
int recbox_packed_adagrad_update(int grad_dtype, void* pack,
                                 long long pack_rows, int pack_w,
                                 const void* ids, const void* G, int g_w,
                                 int n_rows, int n_slots,
                                 const void* const* grads, const int* dims,
                                 const int* cols, const int* accs,
                                 int g2_col0, float lr, float eps,
                                 void* stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_slots > MAX_SLOTS || pack_w <= 0 ||
      g_w <= 0 || g2_col0 < 0 || g2_col0 + n_slots > pack_w)
    return (int)cudaErrorInvalidValue;
  Slots slots{};
  slots.n = n_slots;
  slots.g2_col0 = g2_col0;
  for (int s = 0; s < n_slots; ++s) {
    if (grads[s] == nullptr || dims[s] <= 0 || cols[s] < 0 ||
        cols[s] + dims[s] > pack_w || accs[s] < 0 || accs[s] >= g_w)
      return (int)cudaErrorInvalidValue;
    slots.grad[s] = grads[s];
    slots.dim[s] = dims[s];
    slots.col[s] = cols[s];
    slots.acc[s] = accs[s];
  }
  const unsigned int blocks =
      (unsigned int)(((long long)n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(pack);
  const int* id = static_cast<const int*>(ids);
  const float* g = static_cast<const float*>(G);
  switch (grad_dtype) {
    case 0:
      packed_adagrad_update<float><<<blocks, THREADS, 0, st>>>(
          p, pack_rows, pack_w, id, g, g_w, n_rows, slots, lr, eps);
      break;
    case 1:
      packed_adagrad_update<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          p, pack_rows, pack_w, id, g, g_w, n_rows, slots, lr, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
