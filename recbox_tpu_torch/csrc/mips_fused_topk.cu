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
// cut into sub-chunks of `sub_rows` rows (the JAX package's block plan,
// chosen by the wrapper); segment g of a sub-chunk is rows {g, g+n_seg,
// ..., g+127*n_seg}, n_seg = sub_rows/128, and gives one winner by FLOAT
// max of the packed values. The exact top-k of the winners comes back
// descending, bits cleared and ids rebuilt; pads are (-inf, -1).
//
// Bound on the H100: at the serving shape (Q=8192, N=1M, D=64) the scoring
// is 2*Q*N*D = 1.07e12 operations, 1.06 ms at the bf16 tensor-core peak
// (989 TFLOP/s) and 0.53 ms at int8's (1979 TOP/s); the corpus is 64 or
// 128 MB and the winners 250 MB written and read once, about 0.2 ms of HBM.
// So the kernel is bound by operations. A served request of up to 64
// queries is bound by the corpus read instead (128 MB bf16, 0.038 ms).
//
// Design: two launches, each a kernel shared with another function.
//  (a) the packed form of B4's segment-candidate kernel (`mips_topk.cu`):
//      bf16 and int8 at D = 64 or 128 on its `wgmma` route (TMA ring, two
//      consumer warpgroups, the segment fold in registers) where n_seg is
//      in {1, 2, 4, 8} (911 queries or more; the serving plan is 8), on
//      its segment-major route (TMA boxes of whole segments, queries as
//      wgmma's A, the fold along a query's row) at the plans of 910
//      queries or fewer; f32, which TF32 would change, and other depths on
//      its tile route. It writes the winners candidate-major, (n_cand, Q).
//      The first design scored 64 queries a block through WMMA fragments
//      and a shared f32 stage, its own copy of the tile route, and sat at
//      13-18x its bound.
//  (b) B5's selection (`select_topk.cuh`) reads those winners in place by
//      strides, the position being the candidate, and selects the k largest
//      packed winners a query by radix over keys in registers; past 16384
//      winners (131,072 a query at 16.8M x 64) its streaming filter, 8
//      adjacent queries a block so that each 32-byte sector of the winners
//      is read whole, while 2k <= 16384, else its global-memory mode; this
//      file's
//      epilogue decodes each: clears the index bits, rebuilds the row id
//      from the candidate and the index, applies the query's int8 scale and
//      writes (-inf, -1) for a winner that is only padding. The first
//      design sorted every winner of a query with a bitonic network in
//      shared memory.
// The order is the selection's: packed score descending, then candidate
// position ascending (lax.top_k's); the plain PyTorch version sorts the
// same keys. The JAX kernel ranks the winners in a bitonic network that
// sets no order among equal scores.

#include "mips_tile.cuh"
#include "select_topk.cuh"

namespace {

// Winner j of query q, from the key of its packed winner at candidate
// `pos`: the clean score (times q_scale[q] for int8) and the global row id
// at [q * k + j], or (-inf, -1) where the winner is only padding (at or
// below -PACK_FLOOR / 2, or NaN).
struct WinnerOut {
  float* s;
  int* i;
  const float* q_scale;
  int k, n_seg, sub_rows;
  __device__ __forceinline__ void operator()(int q, int j,
                                             unsigned long long key) const {
    const int pos = key_position(key);
    const int bits = __float_as_int(key_score(key));
    float clean = __int_as_float(bits & ~PACK_MASK);
    const bool alive = clean > -PACK_FLOOR * 0.5f;
    const int id = (pos / n_seg) * sub_rows + pos % n_seg +
                   (bits & PACK_MASK) * n_seg;
    if (q_scale != nullptr) clean *= q_scale[q];
    const size_t at = (size_t)q * k + j;
    s[at] = alive ? clean : __uint_as_float(NEG_INF_BITS);
    i[at] = alive ? id : -1;
  }
};

}  // namespace

extern "C" {

// winners (n_cand, nq) float32, candidate-major, the packed winners of the
// plan with `sub_rows` (a multiple of 128 up to 32768); q_scale (nq,)
// float32 or null; out_s (nq, k) float32, out_i (nq, k) int32; (k, p,
// window, qb, kpt) as `launch_select` takes them; with qb 0 the scratch of
// `large_layout` for chunks of q_chunk queries (null otherwise).
int recbox_mips_select_winners(const void* winners, const void* q_scale,
                               void* out_s, void* out_i, int nq, int n_cand,
                               int k, int p, int window, int qb, int kpt,
                               int sub_rows, void* scratch,
                               long long scratch_bytes, int q_chunk,
                               void* stream) {
  if (sub_rows < SEGMENT || sub_rows > MAX_SUB_ROWS ||
      sub_rows % SEGMENT != 0)
    return (int)cudaErrorInvalidValue;
  const WinnerOut out{static_cast<float*>(out_s), static_cast<int*>(out_i),
                      static_cast<const float*>(q_scale), k,
                      sub_rows / SEGMENT, sub_rows};
  return launch_select(static_cast<const float*>(winners), nq, n_cand, k, p,
                       window, qb, kpt, 1, nq, scratch, scratch_bytes,
                       q_chunk, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
