// Fused sequence-embedding gather + masked pooling for Hopper (sm_90a).
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/embedding_gather.py`
// (`_kernel` :44, called from `_pallas_pool` :94 under `seq_embedding_pool`
// :123). out[b] = sum over l of table[ids[b, l]] for ids[b, l] != pad_id,
// accumulated in f32; mode mean divides by max(count, 1e-12), so a row of
// pads gives 0. The (B, L, D) gather never exists in device memory.
//
// Bound on the H100: bytes. At B=8192, L=50, D=128 f32 the rows gathered
// are at most 210 MB (each distinct row read once is the least: fewer under
// skewed ids), 0.064 ms of HBM; the sum is one add an element.
//
// Design: one warp per output row; each lane holds VEC consecutive columns
// (16-, 8-, 4- or 2-byte loads, the widest that keeps every lane busy), so a
// warp reads a whole row in one coalesced sweep. The row's ids are read 32
// at a time, one per lane, and broadcast by shuffle; UNROLL rows are loaded
// before any is added, so several gathers are in flight per warp, and the
// 8 warps of a block and the blocks of an SM add more. The TPU kernel lost
// to XLA's gather because its one DMA per (row, position) waited on memory
// latency in turn. A pad position is not read. As in JAX's gather, an id in
// [-V, 0) counts from the end, and a row holding an id outside [-V, V) is
// written as NaN without reading any of its rows.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Grid (ceil(B / 8)), 8 warps a block, warp w of the grid pools row w.
// LD is the load unit (uint4, uint2, unsigned int, unsigned short): VEC =
// sizeof(LD) / sizeof(T) columns a lane, D a multiple of VEC.
template <typename T, typename LD>
__global__ void __launch_bounds__(THREADS)
    seq_pool(const T* __restrict__ table, const int* __restrict__ ids,
             T* __restrict__ out, int b_rows, int L, int D, int V, int pad_id,
             int mean) {
  constexpr int VEC = sizeof(LD) / sizeof(T);
  const int b = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= b_rows) return;  // a whole warp leaves together
  const int* row_ids = ids + (size_t)b * L;
  int count = 0;
  bool bad = false;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int id = l0 + lane < L ? __ldg(row_ids + l0 + lane) : pad_id;
    count += __popc(__ballot_sync(FULL, id != pad_id));
    bad |= __any_sync(FULL, id != pad_id && (id < -V || id >= V));
  }
  if (bad) {
    for (int col = lane; col < D; col += 32)
      out[(size_t)b * D + col] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  const float div = mean ? fmaxf((float)count, 1e-12f) : 1.f;
  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < D;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int my_id = l0 + lane < L ? __ldg(row_ids + l0 + lane) : pad_id;
      const int n = min(32, L - l0);
      for (int j = 0; j < n; j += UNROLL) {
        LD v[UNROLL];
        bool use[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          int id = __shfl_sync(FULL, my_id, (j + u) & 31);
          use[u] = j + u < n && id != pad_id;
          if (id < 0) id += V;  // in [0, V): the row has no id out of range
          if (use[u] && active)
            v[u] = __ldg(reinterpret_cast<const LD*>(table + (size_t)id * D +
                                                     col));
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (!(use[u] && active)) continue;
          const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += to_f32(e[i]);
        }
      }
    }
    if (active) {
      alignas(sizeof(LD)) T res[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) res[i] = from_f32<T>(acc[i] / div);
      *reinterpret_cast<LD*>(out + (size_t)b * D + col) =
          *reinterpret_cast<const LD*>(res);
    }
  }
}

template <typename T, typename LD>
int launch(const void* table, const void* ids, void* out, int b_rows, int L,
           int D, int V, int pad_id, int mean, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  seq_pool<T, LD><<<(b_rows + per_block - 1) / per_block, THREADS, 0,
                    stream>>>(static_cast<const T*>(table),
                              static_cast<const int*>(ids),
                              static_cast<T*>(out), b_rows, L, D, V, pad_id,
                              mean);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec_bytes, const void* table, const void* ids, void* out,
               int b_rows, int L, int D, int V, int pad_id, int mean,
               cudaStream_t st) {
  switch (vec_bytes) {
    case 16:
      return launch<T, uint4>(table, ids, out, b_rows, L, D, V, pad_id, mean,
                              st);
    case 8:
      return launch<T, uint2>(table, ids, out, b_rows, L, D, V, pad_id, mean,
                              st);
    case 4:
      return launch<T, unsigned int>(table, ids, out, b_rows, L, D, V, pad_id,
                                     mean, st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, unsigned short>(table, ids, out, b_rows, L, D, V,
                                         pad_id, mean, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. table (V, D) and out (B, D) row-major of
// that dtype, ids (B, L) int32 row-major; vec_bytes in {16, 8, 4, 2} with
// D * itemsize and both base addresses multiples of it (2 for bf16 only);
// mean 1 for mode 'mean', 0 for 'sum'.
int recbox_seq_embedding_pool(int dtype, int vec_bytes, const void* table,
                              const void* ids, void* out, int b_rows, int L,
                              int D, int V, int pad_id, int mean,
                              void* stream) {
  if (b_rows <= 0 || L <= 0 || D <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(vec_bytes, table, ids, out, b_rows, L, D, V,
                             pad_id, mean, st);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec_bytes, table, ids, out, b_rows, L,
                                     D, V, pad_id, mean, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
