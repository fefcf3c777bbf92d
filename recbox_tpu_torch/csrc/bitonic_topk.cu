// Row-wise exact top-k of (score, id) pairs for Hopper (sm_90a): B5.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/bitonic_topk.py`
// (`_make_kernel` :61, called from `_block_topk_call` :123 under
// `pallas_bitonic_topk_cmajor` :152 and `pallas_bitonic_topk` :189). For
// each query: the k largest of its C scores, descending, with their ids.
// The order is total: score descending, then candidate position
// ascending, which is lax.top_k's order; the plain PyTorch version sorts
// the same keys.
//
// Bound on the H100: at the B4 path's shape (C=7936 candidates, Q=8192,
// k=500) the function must read 260 MB of scores, the ids of its k winners
// and write 33 MB: 0.092 ms of HBM. Selecting needs ~C operations a query,
// far below the card's rate, so the bound is bytes.
//
// The selection (up to 16384 candidates a radix select over keys in
// registers, then a sort of the k survivors; past that while 2k <= 16384 a
// streaming filter on a running threshold; beyond, its global-memory
// mode) is `select_topk.cuh`'s; this file gives it B5's epilogue, which
// writes each winner's score and gathers its id. Over a chunk's segments of
// `segmented_mips_topk` (8192 rows x 125,000, k = 93) the function must
// read 4.1 GB: 1.22 ms of HBM. At (Q, C) = (1024, 131072) it must read 512
// MB of scores and write the k pairs: 0.18 ms of HBM at k = 10,000, 0.32
// ms at k = 65,536.

#include "select_topk.cuh"

namespace {

// Winner j of query q: its score at s[q * o_q + j * o_k], its id ids[q *
// i_q + position * i_c] (ids null: the position) at the same place of i.
struct RowOut {
  float* s;
  int* i;
  const int* ids;
  long long i_q, i_c, o_q, o_k;
  __device__ __forceinline__ void operator()(int q, int j,
                                             unsigned long long key) const {
    const long long pos = key_position(key);
    const long long at = (long long)q * o_q + j * o_k;
    s[at] = key_score(key);
    i[at] = ids != nullptr ? __ldg(ids + (long long)q * i_q + pos * i_c)
                           : (int)pos;
  }
};

}  // namespace

extern "C" {

// scores float32, ids int32 or null, out_s float32, out_i int32, all
// addressed by the element strides given; (k, p, window, qb, kpt) as
// `launch_select` takes them; with qb 0 the scratch of `large_layout` for
// chunks of q_chunk queries (null otherwise).
int recbox_select_topk(const void* scores, const void* ids, void* out_s,
                       void* out_i, int nq, int c, int k, int p, int window,
                       int qb, int kpt, long long s_q, long long s_c,
                       long long i_q, long long i_c, long long o_q,
                       long long o_k, void* scratch, long long scratch_bytes,
                       int q_chunk, void* stream) {
  const RowOut out{static_cast<float*>(out_s), static_cast<int*>(out_i),
                   static_cast<const int*>(ids), i_q, i_c, o_q, o_k};
  return launch_select(static_cast<const float*>(scores), nq, c, k, p,
                       window, qb, kpt, s_q, s_c, scratch, scratch_bytes,
                       q_chunk, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
