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
// operations; at D = 64 (B3's serving corpus) half of them.
//
// Three routes, picked by the wrapper's rule (`candidate_route`) on
// (dtype, depth, plan, variant): bf16 and int8 at D = 64 or 128 take
// `wgmma` where n_seg is in {1, 2, 4, 8} (the plans of 911 queries or more)
// and, packed, `segment` at every other n_seg (the plans of 910 queries or
// fewer: 9 to 256 segments); f32, other depths and the unpacked variant
// off the `wgmma` plans take `tile`.
//
// `segment_candidates_wgmma` (bf16 packed and unpacked, and int8 packed,
// at D = 64 or 128 and n_seg in {1, 2, 4, 8}; the 1024-query plan is n_seg
// = 8). B3's stage (a) (`mips_fused_topk.py`) runs its packed form. The
// first design (below) reached 11x its bound: WMMA fragments, synchronous
// loads with two barriers a k-block, the query tile staged again for every
// 128-row chunk, every score through a shared f32 stage, 64 queries a
// block (the corpus read 128 times from L2). This one:
//  * a block takes 256 queries, loaded once by TMA and resident (64 KB of
//    bf16 at D = 128, 32 at D = 64 or of int8 at 128, 16 of int8 at 64):
//    the corpus is read 32 times from L2. Blocks run query tiles fastest,
//    so the query tiles of one sub-chunk run together and the corpus comes
//    from HBM about once;
//  * one producer thread keeps a ring of 4 corpus tiles (64 rows x D) filled,
//    behind mbarriers, in TMA boxes of 128 bytes of a row under the 128-byte
//    swizzle (a 64-byte int8 row at D = 64: one box under the 64-byte
//    swizzle); rows past N arrive as zeros and are masked by `valid`;
//  * two consumer warpgroups each run `wgmma` over half the queries
//    (m64n128k16 bf16 into f32, or m64n128k32 s8 into s32 then f32 times
//    the row's scale; 32-byte k-slices, 2 to 8 of them by depth and type,
//    operands from shared memory, accumulators in registers), one's fold
//    overlapping the other's product (a second accumulator set a
//    warpgroup, to overlap its own fold, spilled past the registers and
//    lost time);
//  * the fold reads the accumulators in registers, no score stage. A
//    thread holds rows 16w + lane/4 and +8 of every 64-row tile; row mod 8
//    is lane/4, so for n_seg dividing 8 every row it sees is in segment
//    (lane/4) mod n_seg, and it keeps one running winner per query column
//    (32, plus their indices unpacked). The fold's instructions, not the
//    products, set the pace, so the packed fold skips the clip to
//    +-PACK_FLOOR (an identity there) unless a score of the tile passes
//    it or is NaN, and the row mask unless the tile reaches `valid`.
//    Unpacked, rows reach a thread in ascending order (tile by tile, row r
//    before r + 8), so a strict `>` keeps the first index; lanes and warps
//    of one segment are merged once a sub-chunk (shuffles, then shared
//    memory), ties to the smaller index;
//  * then the candidate-major store, consecutive threads on consecutive
//    queries.
//
// `segment_major_candidates` (bf16 and int8 packed, D = 64 or 128, any
// other n_seg; B3's stage (a) below 911 queries). There a 64-row tile of
// consecutive rows touches up to 64 segments, so the `wgmma` route's fold
// cannot keep a thread in one segment. Bound on the H100 at 1M x 64: up to
// 64 queries by the corpus read (128 MB bf16, 0.038 ms; int8 64 MB), at 600
// queries by operations (0.078 ms bf16). This design:
//  * TMA sees the corpus as 3-D (d, n_seg, rows / n_seg), element (k, g, j)
//    row j * n_seg + g (`segment_view` in ops/mips_topk.py computes the
//    view and the wrapper passes it), so a box of 128 consecutive j at one
//    g is one whole segment, in the rows of a 2-D box under the 128-byte
//    (int8 D = 64: 64-byte) swizzle. The view reaches rows below
//    (n / n_seg) * n_seg; the last n % n_seg rows (index n / n_seg of
//    segments g < n % n_seg of the ragged sub-chunk) come from the same
//    view shifted by n % n_seg rows, read there at (g - n % n_seg + n_seg,
//    sub * 128 - 1). No box reaches past the corpus: rows past it arrive
//    as zeros. A corpus shorter than one sub-chunk whose rows are not a
//    whole number of n_seg is padded by the wrapper with zero rows (a copy
//    of under sub_rows rows, at most 4 MB);
//  * the products are transposed against the `wgmma` route's: A is a
//    64-query tile, resident in shared memory (loaded once by TMA, up to
//    15 tiles a block, more in blocks over query groups), B the segment's
//    128 rows, m64n128 bf16 k16 or s8 k32 into registers; a thread holds
//    two query rows and 32 indices of the segment, so the fold is a max
//    along the row: in registers, then over the four lanes of a row
//    (shuffles), no shared memory, no atomics, no split runs;
//  * persistent blocks, one an SM, each over a contiguous run of segments:
//    a thread issues the boxes into a ring of 4-8 stages behind mbarriers,
//    an int8 warp stages each segment's 128 row scales beside them, two
//    consumer warpgroups take the segments in turn, each with two
//    accumulator sets: one query tile's product runs while the one before
//    it is folded. No product is in flight across a barrier wait, and each
//    branch has the same products in flight in and out, or ptxas
//    serializes every `wgmma` (its C7518 warning);
//  * the fold, not the products, sets the pace past 64 queries (ALU
//    instructions at half rate): one LOP3 packs a score (the index's
//    constant bits, the mask held in a register), one FMNMX keeps it, the
//    lanes' common index bits are OR-ed in after the max; the clip to
//    +-PACK_FLOOR and the row mask run only for a warp whose maxima leave
//    +-1e38 (a score past the clip, or NaN, would put them there) or a
//    segment that reaches `valid`. int8 converts its exact s32 sum to f32
//    by two full-rate instructions (|acc| < 2^22) before the row's scale;
//  * each (segment, query) winner is written once, candidate-major.
//
// `segment_candidates` (every other dtype and plan: f32, other depths,
// the unpacked variant off the `wgmma` plans) is the first design, B3's
// first stage (a)
// (`mips_tile.cuh`): a block takes 64 queries and the 128-row chunks of one
// sub-chunk, scores each chunk into shared memory and folds it into running
// winners of its (query, segment) pairs, then stores them candidate-major.
// When there are too few blocks to fill the card, the packed variants split
// a sub-chunk's chunks over `splits` blocks merged by an atomic float max;
// the unpacked variant runs without splits, so its first-index rule needs
// no 64-bit atomics (rows reach a block's fold in ascending index order).
//
// The TPU looped over query tiles; here one launch covers every query (the
// segment plan is the same for every tile).

#include "hopper.cuh"
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


// -- the wgmma route ---------------------------------------------------------

// pack() of a live score within +-PACK_FLOOR, where the clip is the
// identity: the in-segment index in the low mantissa bits.
__device__ __forceinline__ float pack_bits(float s, int idx) {
  return __int_as_float((__float_as_int(s) & ~PACK_MASK) | idx);
}

// One k-slice of the tile product: bf16 k16 into f32, s8 k32 into s32.
__device__ __forceinline__ void mma_slice(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  wgmma_m64n128k16_bf16(d, a, b, accumulate);
}
__device__ __forceinline__ void mma_slice(int (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  wgmma_m64n128k32_s8(d, a, b, accumulate);
}

// A score from its accumulator: bf16's f32 sum as it is; s8's exact s32 sum
// in f32 times the row's scale, as the tile route and the plain version
// form it.
__device__ __forceinline__ float score_of(float acc, float) { return acc; }
__device__ __forceinline__ float score_of(int acc, float scale) {
  return (float)acc * scale;
}

constexpr int WG = 128;                   // threads of a warpgroup
constexpr int W_TILE_M = 64;              // corpus rows a stage
constexpr int W_HALF_N = 128;             // queries a consumer warpgroup
constexpr int W_TILE_N = 2 * W_HALF_N;    // queries a block
constexpr int W_STAGES = 4;
constexpr int W_MERGE_LD = W_HALF_N + 8;  // merge buffer row stride
constexpr int W_ROWS_PER_BLOCK = 4096;    // sub-chunks a block: this many rows

// How a row of DEPTH values of T lies in shared memory: TMA boxes of BOX
// bytes of the row (128, or 64 for a 64-byte s8 row), each under the
// swizzle of its width, BOXES of them across the row; a box holds
// BOX_SLICES of the product's 32-byte k-slices.
template <typename T, int DEPTH> struct WRow {
  static constexpr int BYTES = DEPTH * (int)sizeof(T);
  static constexpr int BOX = BYTES < 128 ? BYTES : 128;
  static constexpr int BOXES = BYTES / BOX;
  static constexpr int BOX_K = BOX / (int)sizeof(T);  // values in a box row
  static constexpr int BOX_SLICES = BOX / 32;
  static constexpr int SLICES = BYTES / 32;
  static constexpr int A_BOX = W_TILE_M * BOX;  // a box of a corpus tile
  static constexpr int Q_BOX = W_TILE_N * BOX;  // and of the query tile
  static constexpr int STAGE = BOXES * A_BOX;
  static_assert(BOX == 128 || BOX == 64, "128- or 64-byte swizzled boxes");
};

// Dynamic shared memory: the query tile, the ring, then per consumer
// warpgroup the (warp, segment, query) winners (and indices unpacked) it
// merges; +1024 to align the swizzled tiles.
__host__ __device__ constexpr int wgmma_merge_bytes(int n_seg) {
  return 4 * n_seg * W_MERGE_LD * 4;
}
template <typename T, int DEPTH>
__host__ __device__ constexpr int wgmma_smem(bool packed, int n_seg) {
  return 1024 + WRow<T, DEPTH>::BOXES * WRow<T, DEPTH>::Q_BOX +
         W_STAGES * WRow<T, DEPTH>::STAGE +
         2 * wgmma_merge_bytes(n_seg) * (packed ? 1 : 2);
}

// Grid (ceil(nq / 256), ceil(n_sub / subs_per_block)), 384 threads:
// warpgroup 0 loads, 1 and 2 score queries [0, 128) and [128, 256) of the
// block's tile. Sub-chunks [y * subs_per_block, ...) of NSEG * 128 rows.
// T is bf16 or s8 (packed, with row_scale); rows are DEPTH (64 or 128)
// values.
template <typename T, bool PACKED, int NSEG, int DEPTH>
__global__ void __launch_bounds__(3 * WG, 1)
    segment_candidates_wgmma(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap cmap,
                             const float* __restrict__ row_scale,
                             float* __restrict__ cand_s,
                             int* __restrict__ cand_i, int nq, int n,
                             int n_sub, int valid, int subs_per_block) {
  using Acc = typename AccOf<T>::type;
  using R = WRow<T, DEPTH>;
  constexpr int SUB_ROWS = NSEG * SEGMENT;
  constexpr int TILES = SUB_ROWS / W_TILE_M;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES], qfull;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + R::BOXES * R::Q_BOX;
  const int wg = threadIdx.x / WG;
  const int q0 = blockIdx.x * W_TILE_N;
  const int sub0 = blockIdx.y * subs_per_block;
  const int sub1 = min(n_sub, sub0 + subs_per_block);
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_init(&qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 0) {
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&qfull, R::BOXES * R::Q_BOX);
      for (int b = 0; b < R::BOXES; ++b)
        tma_load_2d(smem + b * R::Q_BOX, &qmap, &qfull, b * R::BOX_K, q0);
      const int tiles = (sub1 - sub0) * TILES;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % W_STAGES;
        if (t >= W_STAGES) mbar_wait(&empty[s], (t / W_STAGES - 1) & 1);
        unsigned char* dst = ring + s * R::STAGE;
        const int row = sub0 * SUB_ROWS + t * W_TILE_M;
        mbar_arrive_tx(&full[s], R::STAGE);
        for (int b = 0; b < R::BOXES; ++b)
          tma_load_2d(dst + b * R::A_BOX, &cmap, &full[s], b * R::BOX_K, row);
      }
    }
  } else {
    regs_alloc<232>();
    const int half = wg - 1;
    const int t = threadIdx.x - wg * WG;
    const int warp = t / 32, lane = t % 32;
    const int seg = (lane >> 2) & (NSEG - 1);
    float* mbuf = reinterpret_cast<float*>(ring + W_STAGES * R::STAGE +
                                           half * wgmma_merge_bytes(NSEG));
    int* mbuf_i = reinterpret_cast<int*>(ring + W_STAGES * R::STAGE +
                                         (2 + half) * wgmma_merge_bytes(NSEG));
    const uint64_t qdesc =
        swizzled_desc<R::BOX>(smem + half * W_HALF_N * R::BOX);
    const float neg_inf = __uint_as_float(NEG_INF_BITS);
    Acc d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    float win[32];
    int wi[PACKED ? 1 : 32];
    mbar_wait(&qfull, 0);
    int tile = 0;
    for (int sub = sub0; sub < sub1; ++sub) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        win[j] = neg_inf;
        if constexpr (!PACKED) wi[j] = 0;
      }
      for (int tt = 0; tt < TILES; ++tt, ++tile) {
        const int s = tile % W_STAGES;
        mbar_wait(&full[s], (tile / W_STAGES) & 1);
        const uint64_t adesc = swizzled_desc<R::BOX>(ring + s * R::STAGE);
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < R::SLICES; ++kk) {
          // BOX_SLICES 32-byte slices to a box
          const uint64_t ka = (kk / R::BOX_SLICES) * (R::A_BOX >> 4) +
                              (kk % R::BOX_SLICES) * 2;
          const uint64_t kq = (kk / R::BOX_SLICES) * (R::Q_BOX >> 4) +
                              (kk % R::BOX_SLICES) * 2;
          mma_slice(d, adesc + ka, qdesc + kq, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        // this thread's two rows of the tile, within the sub-chunk
        const int r0 = tt * W_TILE_M + 16 * warp + (lane >> 2);
        const int idx0 = r0 / NSEG, idx1 = (r0 + 8) / NSEG;
        const int row0 = sub * SUB_ROWS + tt * W_TILE_M;
        // a tile wholly below `valid` (all but the corpus's last) needs no
        // masking
        const bool all_live = row0 + W_TILE_M <= valid;
        const bool live0 = all_live || sub * SUB_ROWS + r0 < valid;
        const bool live1 = all_live || sub * SUB_ROWS + r0 + 8 < valid;
        float sc0 = 1.f, sc1 = 1.f;
        if constexpr (kIsInt8<T>) {
          const int row = sub * SUB_ROWS + r0;
          sc0 = row < n ? __ldg(row_scale + row) : 1.f;
          sc1 = row + 8 < n ? __ldg(row_scale + row + 8) : 1.f;
        }
        if constexpr (PACKED) {
          // the clip to +-PACK_FLOOR changes nothing unless a score passes
          // it (or is NaN): then the warp folds the tile with the clip
          float big = 0.f;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            big = fmax_nan(big, fabsf(score_of(d[4 * (j / 2) + j % 2], sc0)));
            big = fmax_nan(big,
                           fabsf(score_of(d[4 * (j / 2) + 2 + j % 2], sc1)));
          }
          if (all_live && !__any_sync(0xFFFFFFFFu, !(big <= PACK_FLOOR))) {
#pragma unroll
            for (int j = 0; j < 32; ++j)
              win[j] = fmaxf(
                  win[j],
                  fmaxf(pack_bits(score_of(d[4 * (j / 2) + j % 2], sc0), idx0),
                        pack_bits(score_of(d[4 * (j / 2) + 2 + j % 2], sc1),
                                  idx1)));
          } else {
#pragma unroll
            for (int j = 0; j < 32; ++j)
              win[j] = fmaxf(
                  win[j],
                  fmaxf(pack(score_of(d[4 * (j / 2) + j % 2], sc0), live0,
                             idx0),
                        pack(score_of(d[4 * (j / 2) + 2 + j % 2], sc1), live1,
                             idx1)));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            // strictly greater: rows arrive in ascending order (r0 before
            // r0 + 8, tile by tile), so the first index of the max is kept
            const float s0 = score_of(d[4 * (j / 2) + j % 2], sc0);
            const float s1 = score_of(d[4 * (j / 2) + 2 + j % 2], sc1);
            if (live0 && s0 > win[j]) {
              win[j] = s0;
              wi[j] = idx0;
            }
            if (live1 && s1 > win[j]) {
              win[j] = s1;
              wi[j] = idx1;
            }
          }
        }
      }
      // lanes of one segment (same lane%4 columns, lane/4 equal mod NSEG)
#pragma unroll
      for (int m = 4 * NSEG; m < 32; m <<= 1) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float v = __shfl_xor_sync(0xFFFFFFFFu, win[j], m);
          if constexpr (PACKED) {
            win[j] = fmaxf(win[j], v);
          } else {
            const int vi = __shfl_xor_sync(0xFFFFFFFFu, wi[j], m);
            if (v > win[j] || (v == win[j] && vi < wi[j])) {
              win[j] = v;
              wi[j] = vi;
            }
          }
        }
      }
      if ((lane >> 2) < NSEG) {
        const int base = (warp * NSEG + seg) * W_MERGE_LD + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(mbuf + base + 8 * j) =
              make_float2(win[2 * j], win[2 * j + 1]);
          if constexpr (!PACKED)
            *reinterpret_cast<int2*>(mbuf_i + base + 8 * j) =
                make_int2(wi[2 * j], wi[2 * j + 1]);
        }
      }
      named_sync(wg, WG);
      // the four warps, then the coalesced candidate-major store
      for (int p = t; p < NSEG * W_HALF_N; p += WG) {
        const int g = p / W_HALF_N, col = p % W_HALF_N;
        float v = mbuf[g * W_MERGE_LD + col];
        int vi = 0;
        if constexpr (!PACKED) vi = mbuf_i[g * W_MERGE_LD + col];
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const int at = (w * NSEG + g) * W_MERGE_LD + col;
          if constexpr (PACKED) {
            v = fmaxf(v, mbuf[at]);
          } else {
            const float u = mbuf[at];
            const int ui = mbuf_i[at];
            if (u > v || (u == v && ui < vi)) {
              v = u;
              vi = ui;
            }
          }
        }
        const int q = q0 + half * W_HALF_N + col;
        if (q < nq) {
          const size_t at = (size_t)(sub * NSEG + g) * nq + q;
          cand_s[at] = v;
          if constexpr (!PACKED) cand_i[at] = sub * SUB_ROWS + g + vi * NSEG;
        }
      }
      named_sync(wg, WG);
    }
  }
}

template <typename T, bool PACKED, int NSEG, int DEPTH>
int launch_wgmma(const CUtensorMap& qmap, const CUtensorMap& cmap,
                 const void* row_scale, void* cand_s, void* cand_i, int nq,
                 int n, int valid, cudaStream_t stream) {
  constexpr int SUB_ROWS = NSEG * SEGMENT;
  const int smem = wgmma_smem<T, DEPTH>(PACKED, NSEG);
  auto kernel = segment_candidates_wgmma<T, PACKED, NSEG, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_sub = (n + SUB_ROWS - 1) / SUB_ROWS;
  const int spb = W_ROWS_PER_BLOCK / SUB_ROWS;
  const dim3 grid((nq + W_TILE_N - 1) / W_TILE_N, (n_sub + spb - 1) / spb);
  kernel<<<grid, 3 * WG, smem, stream>>>(
      qmap, cmap, static_cast<const float*>(row_scale),
      static_cast<float*>(cand_s), static_cast<int*>(cand_i), nq, n, n_sub,
      valid, spb);
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED, int DEPTH>
int launch_wgmma_plan(const void* q, const void* c, const void* row_scale,
                      void* cand_s, void* cand_i, int nq, int n, int valid,
                      int n_seg, cudaStream_t st) {
  using R = WRow<T, DEPTH>;
  CUtensorMap qmap, cmap;
  int rc = k_major_map(&qmap, q, nq, DEPTH, sizeof(T), W_TILE_N, R::BOX);
  if (rc == 0)
    rc = k_major_map(&cmap, c, n, DEPTH, sizeof(T), W_TILE_M, R::BOX);
  if (rc != 0) return rc;
  switch (n_seg) {
    case 1:
      return launch_wgmma<T, PACKED, 1, DEPTH>(qmap, cmap, row_scale, cand_s,
                                               cand_i, nq, n, valid, st);
    case 2:
      return launch_wgmma<T, PACKED, 2, DEPTH>(qmap, cmap, row_scale, cand_s,
                                               cand_i, nq, n, valid, st);
    case 4:
      return launch_wgmma<T, PACKED, 4, DEPTH>(qmap, cmap, row_scale, cand_s,
                                               cand_i, nq, n, valid, st);
    case 8:
      return launch_wgmma<T, PACKED, 8, DEPTH>(qmap, cmap, row_scale, cand_s,
                                               cand_i, nq, n, valid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool PACKED>
int launch_wgmma_depth(const void* q, const void* c, const void* row_scale,
                       void* cand_s, void* cand_i, int nq, int n, int d,
                       int valid, int n_seg, cudaStream_t st) {
  return d == 64 ? launch_wgmma_plan<T, PACKED, 64>(q, c, row_scale, cand_s,
                                                    cand_i, nq, n, valid,
                                                    n_seg, st)
                 : launch_wgmma_plan<T, PACKED, 128>(q, c, row_scale, cand_s,
                                                     cand_i, nq, n, valid,
                                                     n_seg, st);
}


// -- the segment-major route -------------------------------------------------

constexpr int S_MAX_STAGES = 8;
constexpr int S_MIN_STAGES = 4;
// dynamic shared memory for the query tiles and the ring (of the H100's
// 232,448 bytes a block, less the 1024 of alignment and the barriers)
constexpr int S_BUDGET = 225 * 1024;
// Where a thread's running maxima of packed unclipped scores lie within
// +-S_UNCLIPPED, the clip to +-PACK_FLOOR changes no winner: no score passed
// PACK_FLOOR, one below -PACK_FLOOR loses either way, and a NaN or infinite
// score would have made a maximum NaN or infinite.
constexpr float S_UNCLIPPED = 1e38f;

// s8's exact s32 sum in f32 (|acc| < 2^22: the low mantissa bits of 1.5 *
// 2^23 + acc, then less 1.5 * 2^23; two full-rate instructions where a
// conversion runs at a quarter rate) times the row's scale: the value the
// plain version forms.
__device__ __forceinline__ float score_of_fast(float acc, float) {
  return acc;
}
__device__ __forceinline__ float score_of_fast(int acc, float scale) {
  return (__int_as_float(acc + 0x4B400000) - 12582912.f) * scale;
}

// The segment route's threads: two consumer warpgroups (warps 0-7); then a
// warp whose first thread issues the TMA boxes, and (int8) a warp that
// loads the row scales.
constexpr int S_THREADS = 2 * WG + 64;

// (bits of s & keep) | idx in one LOP3 (idx a constant, keep = ~PACK_MASK
// in a register: with both constants ptxas splits it in two).
__device__ __forceinline__ float pack_lop3(float s, uint32_t idx,
                                           uint32_t keep) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEC;"
      : "=r"(r)
      : "r"(__float_as_uint(s)), "r"(idx), "r"(keep));
  return __uint_as_float(r);
}

// The packed maximum of one query row over this thread's 32 indices of a
// segment, unclipped and unmasked, NaN kept (the caller's check decides
// whether it stands): four chains (short dependency chains) over the
// indices' bits 8j + e; the thread's common bits col0 (1-2, clear in every
// 8j + e) are OR-ed in once after the max, which they do not reorder. The
// fold's ALU instructions (half rate) set the segment route's pace: one
// LOP3 and one FMNMX a score.
template <typename Acc, int OFF>
__device__ __forceinline__ float fold_fast(const Acc (&d)[64],
                                          const float* sc, int col0,
                                          uint32_t keep) {
  // int8's longer chain a score (its conversion and scale) hides more
  // latency, and its registers are the scarcer
  constexpr int CH = std::is_same<Acc, int>::value ? 2 : 4;
  float r[CH];
#pragma unroll
  for (int u = 0; u < CH; ++u) r[u] = __uint_as_float(NEG_INF_BITS);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      r[(2 * j + e) % CH] = fmax_nan(
          r[(2 * j + e) % CH],
          pack_lop3(score_of_fast(d[4 * j + OFF + e], sc[8 * j + e]),
                    8 * j + e, keep));
  float m = r[0];
#pragma unroll
  for (int u = 1; u < CH; ++u) m = fmax_nan(m, r[u]);
  return __uint_as_float(__float_as_uint(m) | col0);
}

// The same with the clip to +-PACK_FLOOR and the row mask: index 8j + col0
// + e is live where 8j + e < live_from_col0 (the segment's rows ascend with
// the index, so its live indices are those below a count).
template <typename Acc, int OFF>
__device__ __forceinline__ float fold_clipped(const Acc (&d)[64],
                                             const float* sc, int col0,
                                             int live_from_col0) {
  float w = __uint_as_float(NEG_INF_BITS);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w = fmaxf(w, pack(score_of(d[4 * j + OFF + e], sc[8 * j + e]),
                        8 * j + e < live_from_col0, 8 * j + col0 + e));
  return w;
}

// Issue one product: the 64 queries at `qdesc` against the segment at
// `cdesc`, into d.
template <typename T, int DEPTH, typename Acc>
__device__ __forceinline__ void segment_product(Acc (&d)[64], uint64_t qdesc,
                                                uint64_t cdesc) {
  using R = WRow<T, DEPTH>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R::SLICES; ++kk) {
    const uint64_t k_box = kk / R::BOX_SLICES;
    const uint64_t k_in = (kk % R::BOX_SLICES) * 2;
    mma_slice(d, qdesc + k_box * ((W_TILE_M * R::BOX) >> 4) + k_in,
              cdesc + k_box * ((SEGMENT * R::BOX) >> 4) + k_in, kk > 0);
  }
  wgmma_commit();
}

// Fold a complete product and store the winners of its 64 queries (from
// query q_base on) at candidate p. Thread t of the warpgroup holds queries
// q_base + 16 * (t / 32) + t % 32 / 4 (+ 8) and indices 8j + col0 + e.
template <typename Acc>
__device__ __forceinline__ void segment_winners(
    Acc (&d)[64], const float* sc, int col0, uint32_t keep,
    int live_from_col0, bool all_live, float* __restrict__ cand_s, int p,
    int nq, int q_base) {
  fence_regs(d);
  float wa = __uint_as_float(NEG_INF_BITS), wb = wa;
  if (all_live) {
    wa = fold_fast<Acc, 0>(d, sc, col0, keep);
    wb = fold_fast<Acc, 2>(d, sc, col0, keep);
  }
  if (!__all_sync(0xFFFFFFFFu,
                  fabsf(wa) < S_UNCLIPPED && fabsf(wb) < S_UNCLIPPED)) {
    // the segment's last rows are masked, or a score needs the clip
    wa = fold_clipped<Acc, 0>(d, sc, col0, live_from_col0);
    wb = fold_clipped<Acc, 2>(d, sc, col0, live_from_col0);
  }
  // the four lanes of a query row hold its 128 indices between them
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    wa = fmaxf(wa, __shfl_xor_sync(0xFFFFFFFFu, wa, m));
    wb = fmaxf(wb, __shfl_xor_sync(0xFFFFFFFFu, wb, m));
  }
  const int lane = threadIdx.x % 32;
  const int q =
      q_base + 16 * (threadIdx.x % WG / 32) + (lane >> 2) + 8 * (lane & 1);
  if ((lane & 3) < 2 && q < nq)
    cand_s[(size_t)p * nq + q] = (lane & 1) ? wb : wa;
}

// Grid (query groups, corpus blocks), S_THREADS threads. The two consumer
// warpgroups take the block's segments in turn, each segment against every
// 64-query tile of the block's group (`group_tiles` tiles from tile
// blockIdx.x * group_tiles), with two accumulator sets: one query tile's
// product in flight while the one before it is folded. Segment p = sub *
// n_seg + g (its candidate) is rows (sub * 128 + i) * n_seg + g for i <
// 128; a block takes segments [p0, p1) of the n_cand. `cmap` is the
// segment-major view of the corpus (element (k, g, j): row j * n_seg + g)
// and `shifted` the same view from row tail_segs on: segments g < tail_segs
// of sub-chunk tail_sub read it at (g - tail_segs + n_seg, sub * 128 - 1),
// where it holds the corpus's last tail_segs rows that `cmap` cannot reach.
// `keep` is ~PACK_MASK, a parameter so that it stays in a register.
template <typename T, int DEPTH>
__global__ void __launch_bounds__(S_THREADS, 1)
    segment_major_candidates(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap cmap,
                             const __grid_constant__ CUtensorMap shifted,
                             const float* __restrict__ row_scale,
                             float* __restrict__ cand_s, int nq, int n,
                             int valid, int n_seg, int n_cand, int tail_sub,
                             int tail_segs, int group_tiles, int stages,
                             uint32_t keep) {
  using Acc = typename AccOf<T>::type;
  using R = WRow<T, DEPTH>;
  constexpr int Q_BOX = W_TILE_M * R::BOX;  // a box of a 64-query tile
  constexpr int C_BOX = SEGMENT * R::BOX;   // a box of a segment
  constexpr int Q_TILE = R::BOXES * Q_BOX;
  constexpr int STAGE = R::BOXES * C_BOX;
  constexpr bool INT8 = kIsInt8<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S_MAX_STAGES], empty[S_MAX_STAGES],
      qfull;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + group_tiles * Q_TILE;
  float* scales = reinterpret_cast<float*>(ring + stages * STAGE);  // int8
  const int wg = threadIdx.x / WG, lane = threadIdx.x % 32;
  const int qt0 = blockIdx.x * group_tiles;
  const int q_tiles = min(group_tiles, (nq + W_TILE_M - 1) / W_TILE_M - qt0);
  const int p0 = (int)((long long)n_cand * blockIdx.y / gridDim.y);
  const int tiles = (int)((long long)n_cand * (blockIdx.y + 1) / gridDim.y) -
                    p0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], INT8 ? 2 : 1);  // the boxes (and the scales)
      mbar_init(&empty[s], 4);  // each warp of the warpgroup that read it
    }
    mbar_init(&qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == 2 * WG) {
      mbar_arrive_tx(&qfull, q_tiles * Q_TILE);
      for (int qt = 0; qt < q_tiles; ++qt)
        for (int b = 0; b < R::BOXES; ++b)
          tma_load_2d(smem + qt * Q_TILE + b * Q_BOX, &qmap, &qfull,
                      b * R::BOX_K, (qt0 + qt) * W_TILE_M);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&empty[s], (t / stages - 1) & 1);
        const int sub = (p0 + t) / n_seg, g = (p0 + t) % n_seg;
        const bool tail = sub == tail_sub && g < tail_segs;
        const CUtensorMap* map = tail ? &shifted : &cmap;
        const int c1 = tail ? g - tail_segs + n_seg : g;
        const int c2 = sub * SEGMENT - (tail ? 1 : 0);
        mbar_arrive_tx(&full[s], STAGE);
        for (int b = 0; b < R::BOXES; ++b)
          tma_load_3d(ring + s * STAGE + b * C_BOX, map, &full[s],
                      b * R::BOX_K, c1, c2);
      }
    } else if (INT8 && threadIdx.x / 32 == 2 * WG / 32 + 1) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&empty[s], (t / stages - 1) & 1);
        const int sub = (p0 + t) / n_seg, g = (p0 + t) % n_seg;
        float v[4];  // indices 4 * lane ... + 3 (1 past the corpus)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (sub * SEGMENT + 4 * lane + u) * n_seg + g;
          v[u] = row < n ? __ldg(row_scale + row) : 1.f;
        }
        *reinterpret_cast<float4*>(scales + s * SEGMENT + 4 * lane) =
            make_float4(v[0], v[1], v[2], v[3]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
  } else {
    // the consumer warpgroups, each on every other segment
    const int col0 = 2 * (lane & 3);
    Acc d0[64], d1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d0[i] = d1[i] = Acc(0);
    mbar_wait(&qfull, 0);
    // No product is in flight across a barrier wait, and every path in and
    // out of a branch has the same products in flight (ptxas serializes
    // every product where it cannot follow them): within a segment, the
    // next query tile's product runs while one is folded.
    for (int tile = wg; tile < tiles; tile += 2) {
      const int s = tile % stages;
      const int p = p0 + tile;
      const int sub = p / n_seg, g = p % n_seg;
      const int row0 = sub * SEGMENT * n_seg + g;  // the row of index 0
      // a segment wholly below `valid` (all but the corpus's last) needs no
      // masking
      const bool all_live = row0 + (SEGMENT - 1) * n_seg < valid;
      // its live indices: those below ceil((valid - row0) / n_seg)
      const int live_from_col0 =
          (valid > row0 ? min(SEGMENT, (valid - row0 + n_seg - 1) / n_seg)
                        : 0) - col0;
      mbar_wait(&full[s], (tile / stages) & 1);
      // int8: the row scales of this thread's indices, 8j + e on (bf16
      // reads none)
      const float* sc = scales + s * SEGMENT + col0;
      const uint64_t cdesc = swizzled_desc<R::BOX>(ring + s * STAGE);
      const uint64_t qdesc = swizzled_desc<R::BOX>(smem);
      constexpr uint64_t Q_STEP = Q_TILE >> 4;  // a query tile, 16-byte units
      segment_product<T, DEPTH>(d0, qdesc, cdesc);
      int qt = 0;
      for (; qt + 2 < q_tiles; qt += 2) {
        segment_product<T, DEPTH>(d1, qdesc + (qt + 1) * Q_STEP, cdesc);
        wgmma_wait<1>();
        segment_winners(d0, sc, col0, keep, live_from_col0, all_live, cand_s,
                        p, nq, (qt0 + qt) * W_TILE_M);
        segment_product<T, DEPTH>(d0, qdesc + (qt + 2) * Q_STEP, cdesc);
        wgmma_wait<1>();
        segment_winners(d1, sc, col0, keep, live_from_col0, all_live, cand_s,
                        p, nq, (qt0 + qt + 1) * W_TILE_M);
      }
      if (qt + 1 < q_tiles) {  // two tiles left
        segment_product<T, DEPTH>(d1, qdesc + (qt + 1) * Q_STEP, cdesc);
        wgmma_wait<1>();
        segment_winners(d0, sc, col0, keep, live_from_col0, all_live, cand_s,
                        p, nq, (qt0 + qt) * W_TILE_M);
        wgmma_wait<0>();
        segment_winners(d1, sc, col0, keep, live_from_col0, all_live, cand_s,
                        p, nq, (qt0 + qt + 1) * W_TILE_M);
      } else {
        wgmma_wait<0>();
        segment_winners(d0, sc, col0, keep, live_from_col0, all_live, cand_s,
                        p, nq, (qt0 + qt) * W_TILE_M);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
    }
  }
}

template <typename T, int DEPTH>
int launch_segment(const void* q, const void* c, const void* row_scale,
                   void* cand_s, int nq, int n, int valid, int n_seg,
                   long long seg_rows, long long stride_g, long long stride_j,
                   int tail_sub, int tail_segs, cudaStream_t st) {
  using R = WRow<T, DEPTH>;
  constexpr int Q_TILE = R::BOXES * W_TILE_M * R::BOX;
  // a segment's rows and, int8, its 128 row scales
  constexpr int STAGE = R::BOXES * SEGMENT * R::BOX +
                        (kIsInt8<T> ? SEGMENT * 4 : 0);
  const int sub_rows = n_seg * SEGMENT;
  const int n_cand = (n + sub_rows - 1) / sub_rows * n_seg;
  // the query tiles a block keeps resident: as many as leave a ring of
  // S_MIN_STAGES segments, spread evenly over the groups; the ring takes the
  // rest, up to S_MAX_STAGES
  const int q_tiles = (nq + W_TILE_M - 1) / W_TILE_M;
  int per = min(q_tiles, (S_BUDGET - S_MIN_STAGES * STAGE) / Q_TILE);
  const int groups = (q_tiles + per - 1) / per;
  per = (q_tiles + groups - 1) / groups;
  const int stages = min(S_MAX_STAGES, (S_BUDGET - per * Q_TILE) / STAGE);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // one block an SM in all, each over a contiguous run of segments
  const int blocks = max(1, min(n_cand, sms / groups));
  CUtensorMap qmap, cmap, smap;
  int rc = k_major_map(&qmap, q, nq, DEPTH, sizeof(T), W_TILE_M, R::BOX);
  if (rc == 0)
    rc = segment_major_map(&cmap, c, seg_rows, n_seg, DEPTH, sizeof(T),
                           stride_g, stride_j, SEGMENT, R::BOX);
  if (rc == 0)
    rc = segment_major_map(
        &smap, static_cast<const unsigned char*>(c) + tail_segs * stride_g,
        seg_rows, n_seg, DEPTH, sizeof(T), stride_g, stride_j, SEGMENT,
        R::BOX);
  if (rc != 0) return rc;
  const int smem = 1024 + per * Q_TILE + stages * STAGE;
  auto kernel = segment_major_candidates<T, DEPTH>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(groups, blocks), S_THREADS, smem, st>>>(
      qmap, cmap, smap, static_cast<const float*>(row_scale),
      static_cast<float*>(cand_s), nq, n, valid, n_seg, n_cand, tail_sub,
      tail_segs, per, stages, ~(uint32_t)PACK_MASK);
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

// The wgmma route: dtype 1 = bfloat16 (packed or not), 2 = int8 (packed,
// row_scale required); q (nq, d) and c (n, d) row-major of that dtype, d
// 64 or 128; sub_rows = 128 * n_seg with n_seg in {1, 2, 4, 8}; cand_s
// float32 and, unpacked, cand_i int32, each with at least ceil(n /
// sub_rows) * n_seg rows of nq. Every winner of those rows is written (no
// split runs).
int recbox_mips_segment_candidates_wgmma(int dtype, int packed, const void* q,
                                         const void* c, const void* row_scale,
                                         void* cand_s, void* cand_i, int nq,
                                         int n, int d, int valid,
                                         int sub_rows, void* stream) {
  const int n_seg = sub_rows / SEGMENT;
  if (nq <= 0 || n <= 0 || (d != 64 && d != 128) ||
      sub_rows % SEGMENT != 0 ||
      (n_seg != 1 && n_seg != 2 && n_seg != 4 && n_seg != 8) ||
      (dtype != 1 && dtype != 2) || (dtype == 2) != (row_scale != nullptr) ||
      (!packed && (dtype == 2 || cand_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return launch_wgmma_depth<signed char, true>(q, c, row_scale, cand_s,
                                                 cand_i, nq, n, d, valid,
                                                 n_seg, st);
  return packed ? launch_wgmma_depth<__nv_bfloat16, true>(
                      q, c, row_scale, cand_s, cand_i, nq, n, d, valid,
                      n_seg, st)
                : launch_wgmma_depth<__nv_bfloat16, false>(
                      q, c, row_scale, cand_s, cand_i, nq, n, d, valid,
                      n_seg, st);
}

// The segment-major route, packed: dtype 1 = bfloat16, 2 = int8 (row_scale
// required); q (nq, d) and c (n, d) row-major of that dtype, d 64 or 128;
// sub_rows = 128 * n_seg, n_seg up to 256. The corpus's segment-major view
// (`segment_view` in ops/mips_topk.py): seg_rows = n / n_seg (>= 1),
// strides stride_g = d * itemsize and stride_j = n_seg * stride_g bytes;
// tail_segs = n % n_seg and, when it is not 0, tail_sub = n / sub_rows >= 1
// (else -1). cand_s float32 with at least ceil(n / sub_rows) * n_seg rows of
// nq; every winner of those rows is written.
int recbox_mips_segment_candidates_segment(
    int dtype, const void* q, const void* c, const void* row_scale,
    void* cand_s, int nq, int n, int d, int valid, int sub_rows,
    long long seg_rows, long long stride_g, long long stride_j, int tail_sub,
    int tail_segs, void* stream) {
  const int n_seg = sub_rows / SEGMENT;
  const long long itemsize = dtype == 2 ? 1 : 2;
  if (nq <= 0 || n <= 0 || (d != 64 && d != 128) ||
      (dtype != 1 && dtype != 2) || (dtype == 2) != (row_scale != nullptr) ||
      sub_rows % SEGMENT != 0 || n_seg < 1 || sub_rows > MAX_SUB_ROWS ||
      seg_rows != n / n_seg || seg_rows < 1 || stride_g != d * itemsize ||
      stride_j != n_seg * stride_g || tail_segs != n % n_seg ||
      tail_sub != (tail_segs == 0 ? -1 : n / sub_rows) || tail_sub == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return d == 64 ? launch_segment<signed char, 64>(
                         q, c, row_scale, cand_s, nq, n, valid, n_seg,
                         seg_rows, stride_g, stride_j, tail_sub, tail_segs, st)
                   : launch_segment<signed char, 128>(
                         q, c, row_scale, cand_s, nq, n, valid, n_seg,
                         seg_rows, stride_g, stride_j, tail_sub, tail_segs, st);
  return d == 64 ? launch_segment<__nv_bfloat16, 64>(
                       q, c, row_scale, cand_s, nq, n, valid, n_seg, seg_rows,
                       stride_g, stride_j, tail_sub, tail_segs, st)
                 : launch_segment<__nv_bfloat16, 128>(
                       q, c, row_scale, cand_s, nq, n, valid, n_seg, seg_rows,
                       stride_g, stride_j, tail_sub, tail_segs, st);
}

}  // extern "C"
