// Row-wise exact top-k of (score, id) pairs for Hopper (sm_90a).
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/bitonic_topk.py`
// (`_make_kernel` :61, called from `_block_topk_call` :123 under
// `pallas_bitonic_topk_cmajor` :152 and `pallas_bitonic_topk` :189). For
// each query: the k largest of its C scores, descending, with their ids.
// The order is total: score descending (the float's bits made to sort as an
// integer, so -inf < finite < +inf < NaN), then candidate position
// ascending, which is lax.top_k's order; the plain PyTorch version sorts
// the same keys.
//
// Bound on the H100: at the B4 path's shape (C=7936 candidates, Q=8192,
// k=500) the kernel must read 520 MB of scores and ids and write 33 MB,
// 0.165 ms of HBM. A selection need not sort; this kernel sorts, some
// 3.0e9 compare-exchanges at that shape, so it is bound by its shared-memory
// sort, not by bytes.
//
// Design (a first, simple and right version): one block of 512 threads per
// query builds 64-bit keys (order bits of the score << 32 | ~position) in
// shared memory and sorts them with a bitonic network, in windows of at
// most 16384 keys, keeping the top k between windows. Ids are read by
// position once the k winners are known, so the sort moves 8-byte keys
// only. The JAX kernel sorted 4096-candidate blocks and recursed on the
// survivors because of VMEM; here one window holds up to 16384. Inputs and
// outputs are addressed by strides, so the candidate-major (C, Q) layout of
// the candidate generator and the row-major (Q, C) one need no transpose:
// in the candidate-major layout a block reads one column, a strided read
// (one 32-byte sector per 4-byte score), which neighbouring blocks share
// through L2.

#include "bitonic.cuh"

namespace {

constexpr int THREADS = 512;

// Grid (nq). Score (q, c) at scores[q * s_q + c * s_c], id at
// ids[q * i_q + c * i_c] (ids null: the position c); output j of query q
// at out[q * o_q + j * o_k]. p is a power of two holding every candidate,
// or, when there are more, a window with k <= p/2.
__global__ void __launch_bounds__(THREADS)
    bitonic_topk(const float* __restrict__ scores, const int* __restrict__ ids,
                 float* __restrict__ out_s, int* __restrict__ out_i, int c,
                 int k, int p, long long s_q, long long s_c, long long i_q,
                 long long i_c, long long o_q, long long o_k) {
  extern __shared__ long long keys[];
  const long long q = blockIdx.x;
  const float* row = scores + q * s_q;
  int keep = 0;
  for (int off = 0; off < c;) {
    const int take = p - keep;
    for (int j = threadIdx.x; j < take; j += blockDim.x) {
      const int pos = off + j;
      keys[keep + j] =
          pos < c ? float_order_bits(__ldg(row + pos * s_c)) |
                        (long long)(0xFFFFFFFFu - (unsigned int)pos)
                  : LLONG_MIN;
    }
    __syncthreads();
    bitonic_sort_desc(keys, p);
    off += take;
    keep = k;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long key = keys[j];
    const int pos = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFLL));
    out_s[q * o_q + j * o_k] = key_float(key);
    out_i[q * o_q + j * o_k] = ids != nullptr ? __ldg(ids + q * i_q + pos * i_c)
                                              : pos;
  }
}

}  // namespace

extern "C" {

// scores float32, ids int32 or null, out_s float32, out_i int32, all
// addressed by the element strides given; 1 <= k <= c, p a power of two up
// to 16384 with p >= c or 2k <= p.
int recbox_bitonic_topk(const void* scores, const void* ids, void* out_s,
                        void* out_i, int nq, int c, int k, int p,
                        long long s_q, long long s_c, long long i_q,
                        long long i_c, long long o_q, long long o_k,
                        void* stream) {
  if (nq <= 0 || c <= 0 || k <= 0 || k > c || k > p || p < 2 ||
      (p & (p - 1)) != 0 || p > 16384 || (p < c && 2 * k > p))
    return (int)cudaErrorInvalidValue;
  const int smem = p * (int)sizeof(long long);
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bitonic_topk<<<nq, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(ids),
      static_cast<float*>(out_s), static_cast<int*>(out_i), c, k, p, s_q, s_c,
      i_q, i_c, o_q, o_k);
  return (int)cudaGetLastError();
}

}  // extern "C"
