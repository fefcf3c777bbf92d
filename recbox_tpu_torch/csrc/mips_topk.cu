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
// Two routes, picked by the wrapper's rule on (dtype, depth, plan):
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
// `segment_candidates` (every other dtype and plan: f32, other depths,
// n_seg not dividing 8) is the first design, B3's first stage (a)
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

}  // extern "C"
