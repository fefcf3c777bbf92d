// Fused full-softmax cross-entropy ("flash-CE") for Hopper (sm_90a): the
// row logsumexp of u . t^T and its gradients, with the (B, V) logits never
// in device memory.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/fused_ce.py`: `_fwd_kernel`
// :100 with `_lse_impl` :166 (the forward sweep) and `_bwd_kernel` :212,
// `_bwd_kernel_nb1` :241 with `_bwd_impl` :263 (the backward sweep). For
// u = bf16(user) (B, D) and t = bf16(table) (V, D), D zero-padded to a
// multiple of 16 by the wrapper:
//   forward   lse_i = log sum_v exp(u_i . t_v), bf16 products, f32 sums;
//   backward  given lse_eff (lse - log w: a row of weight 0 has +inf and
//             drops out exactly) and a device scalar `scale`,
//             p = bf16(exp(x - lse_eff)) (the JAX kernel's cast, :232),
//             du = scale * p T (B, D) and dt = scale * p^T U (V, D), f32.
// The label logits, the one-hot corrections and the weights stay in the
// wrapper (`ops/fused_ce.py`), as they stayed outside the TPU kernel.
//
// Bound on the H100 at B = 1024, V = 1M, D = 64. Forward: one exp per logit,
// BV = 1.02e9, 0.263 ms at the special-function units' ~3.9e12/s, above
// its product (2BVD = 1.31e11 operations, 0.133 ms at the bf16 tensor-core
// peak of 989 TFLOP/s) and its bytes (the 128 MB table, 0.038 ms at 3.35
// TB/s): bound by exps. Backward: three products (3.93e11, 0.398 ms) above
// the same exps (0.263 ms, formed once) and its bytes (table read, f32 dt
// written, 0.115 ms): bound by the tensor cores.
//
// Design: one kernel for each direction on one skeleton, the counterpart of
// the TPU kernel's B tile resident over its sequential V grid.
//  * Clusters over B. A cluster of C = 1, 2 or 4 blocks covers C x R rows
//    of u: R = 256 at a padded depth <= 64 (DEPTH 64), R = 128 up to 128
//    (DEPTH 128). Each
//    block loads its R rows once by TMA (128-byte swizzle, columns past the
//    depth zero-filled) and keeps them in shared memory. B beyond C x R rows
//    goes in passes of C x R rows, one launch each, in stream order.
//  * A persistent walk over V: as many clusters as the card runs at once
//    (at most SMs / C; the wrapper asks `recbox_fused_ce_max_clusters`),
//    each over a contiguous run of 64-row table tiles; the runs cover every
//    tile once. One producer thread keeps a ring of table tiles filled; the
//    cluster's rank 0 loads each tile once with a TMA multicast into every
//    block of the cluster, and every block's consumer warps release a stage
//    on the `empty` barrier of every block before any refills it.
//  * Consumer warpgroups on `wgmma`: S = U T^T (m64n64k16, both operands
//    K-major in shared memory) for 64 or 128 rows of u each.
//  * Forward: four consumer warpgroups of 64 rows at DEPTH 64 (two of 64 at
//    128): each folds S into an online max and sum of exp2 (log2(e) in one
//    FFMA) in registers; one (m, l) per (row, cluster), folded by
//    `lse_combine`. The fold's latencies, not the exp unit, set the pace
//    with two warpgroups; four hide more of them.
//  * Backward, one sweep, each logit's exp formed once, two consumer
//    warpgroups of 128 (64) rows, `setmaxnreg` moving the producer's
//    registers to them: p = bf16(exp2(x log2e - lse_eff log2e)) in
//    registers; du += p T with p as the register A operand (the accumulator
//    layout after the cast is the A fragment) and the table tile as an
//    MN-major B (the transpose bit); p to shared memory (128-byte swizzle)
//    for dT = p^T U_share, MN-major A and B. du stays in registers over the
//    whole walk; its per-cluster partials are summed by `du_reduce` in
//    cluster order. dT is reduced and scattered over the cluster: block k
//    sums rows [k 64/C, (k + 1) 64/C) of every tile. Each warpgroup stages
//    its f32 dT partial of a tile in its p buffer and sends chunk k to a
//    slot of block k with one bulk copy (distributed shared memory; the
//    bytes complete block k's `ready` mbarrier, so the sender neither waits
//    nor fences); block k sums its 2C slots in rank order one walk step
//    later (DEPTH 64: two slot sets; 128: one), when the data has long
//    arrived, releases them (`freed`) and writes those dt rows once (a
//    later pass adds to them). Every sum is in a fixed order: two calls
//    give the same bits. The lag matters: a block that waits for the
//    current tile's partials stalls the whole cluster's walk.
// Columns past V are masked by bounds on the last tile; rows past B are
// zeros from TMA with lse_eff = +inf. No bias column.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int WG = 128;      // threads of a warpgroup
constexpr int NT = 64;       // table rows a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;

// Layout of a block at padded depth DEPTH (64 or 128): u rows and table
// tiles as 128-byte TMA boxes of 64 columns, BOXES of them across a row.
// The forward at DEPTH 64 takes four consumer warpgroups of 64 rows (more
// warps to hide the fold's latencies), the rest two.
template <int DEPTH, bool BWD = true> struct Ce {
  static constexpr int BOXES = DEPTH / 64;
  static constexpr int R = DEPTH == 64 ? 256 : 128;  // rows of u a block
  static constexpr int WGS = !BWD && DEPTH == 64 ? 4 : 2;
  static constexpr int THREADS = (WGS + 1) * 128;
  static constexpr int RW = R / WGS;                 // a consumer warpgroup
  static constexpr int MT = RW / 64;                 // its m64 tiles
  static constexpr int STAGES = DEPTH == 64 ? 4 : 2;
  static constexpr int U_BOX = R * 128;
  static constexpr int T_BOX = NT * 128;
  static constexpr int STAGE = BOXES * T_BOX;
  static constexpr int SLOT = NT * DEPTH * 4;  // a warpgroup's dT partial
  // p of a warpgroup (bf16), then its dT partial on the way out
  static constexpr int P_BYTES = RW * 128 > SLOT ? RW * 128 : SLOT;
  static constexpr int RING_OFF = BOXES * U_BOX;
  static constexpr int P_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int DT_OFF = P_OFF + 2 * P_BYTES;
  // + 1024 to align the swizzled tiles
  static constexpr int FWD_SMEM = 1024 + P_OFF;
  // the backward: NBUF slot sets, each the 2C chunks (one from every
  // warpgroup of the cluster) of this block's share of a tile; at DEPTH 64
  // two, so that a tile's share is summed one walk step later (LAG), when
  // its chunks have long arrived
  static constexpr int NBUF = DEPTH == 64 ? 2 : 1;
  static constexpr int LAG = NBUF - 1;
  static constexpr int BWD_SMEM = 1024 + DT_OFF + NBUF * 2 * SLOT;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, round to nearest even, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `bytes` of this block's shared memory at `src` to shared::cluster
// address `dst` (this block's or another's) in one bulk transfer, the bytes
// completing on the mbarrier at shared::cluster address `bar` (in the
// destination block); then commit it as a bulk async-group.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      "cp.async.bulk.commit_group;" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until this thread's bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Release stage `bar` (an `empty` barrier) in every block of the cluster:
// lane r arrives on block r's.
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane,
                                              int c) {
  __syncwarp();
  if (lane < c) mbar_arrive_cluster(cluster_addr(bar, lane));
}

// Grid: clusters x C blocks of 384 threads; warpgroup 0 loads, 1 and 2
// compute. This pass's rows of u start at row0; cluster k walks table tiles
// [k * per, min(n_tiles, (k + 1) * per)).
// Forward: m_part, l_part (clusters, b), log2 domain. Backward: du_part
// (clusters, b, d_out) unscaled; dt (v, d_out) = scale * p^T u, written
// (acc_dt = 0) or added to (acc_dt = 1).
template <int DEPTH, bool BWD>
__device__ __forceinline__ void ce_sweep(
    const CUtensorMap* umap, const CUtensorMap* tmap,
    const float* __restrict__ lse_eff, const float* __restrict__ scale,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ du_part, float* __restrict__ dt, int b, int v,
    int d_out, int row0, int per, int acc_dt) {
  using L = Ce<DEPTH, BWD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[L::STAGES], empty[L::STAGES], ufull;
  __shared__ __align__(8) uint64_t ready[2], freed[2];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + L::RING_OFF;
  const int c = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const int cluster = blockIdx.x / c;
  const int n_tiles = (v + NT - 1) / NT;
  const int t_begin = cluster * per;
  const int n = min(n_tiles, t_begin + per) - t_begin;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::WGS * c);  // each consumer warp
    }
    mbar_init(&ufull, 1);
    for (int k = 0; k < 2; ++k) {
      mbar_init(&ready[k], 1);  // this block's arrival, then the bytes
      mbar_init(&freed[k], 8 * c);  // each consumer warp of the cluster
    }
    mbar_fence_init();
  }
  // barriers armed in every block before any block signals another
  cluster_sync();
  if (wg == 0) {
    if constexpr (BWD) regs_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&ufull, L::BOXES * L::U_BOX);
      for (int bx = 0; bx < L::BOXES; ++bx)
        tma_load_2d(smem + bx * L::U_BOX, umap, &ufull, bx * 64,
                    row0 + rank * L::R);
      const uint16_t mask = (uint16_t)((1u << c) - 1);
      for (int i = 0; i < n; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
        mbar_arrive_tx(&full[s], L::STAGE);
        if (rank == 0) {
          unsigned char* dst = ring + s * L::STAGE;
          for (int bx = 0; bx < L::BOXES; ++bx) {
            if (c == 1)
              tma_load_2d(dst + bx * L::T_BOX, tmap, &full[s], bx * 64,
                          (t_begin + i) * NT);
            else
              tma_load_2d_multicast(dst + bx * L::T_BOX, tmap, &full[s],
                                    bx * 64, (t_begin + i) * NT, mask);
          }
        }
      }
    }
    cluster_sync();
    return;
  }
  if constexpr (BWD) regs_alloc<232>();
  const int h = wg - 1;
  const int t = threadIdx.x - wg * WG;
  const int warp = t / 32, lane = t % 32;
  const int gid = lane / 4, tig = lane % 4;
  // this warpgroup's first row within the pass, and this thread's rows
  const int wrow = rank * L::R + h * L::RW;
  int rows[L::MT][2];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      rows[mt][h2] = row0 + wrow + mt * 64 + 16 * warp + gid + 8 * h2;
  float rm[L::MT][2], rl[L::MT][2];  // forward
  float l2[L::MT][2];                // backward: lse_eff * log2(e)
  float du[L::MT][DEPTH / 2];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      rm[mt][h2] = NEG_BIG;
      rl[mt][h2] = 0.f;
      l2[mt][h2] = 0.f;
      if constexpr (BWD)
        l2[mt][h2] = rows[mt][h2] < b ? __ldg(lse_eff + rows[mt][h2]) * LOG2E
                                      : INFINITY;
    }
#pragma unroll
    for (int i = 0; i < DEPTH / 2; ++i) du[mt][i] = 0.f;
  }
  unsigned char* pbuf = smem + L::P_OFF + h * L::P_BYTES;
  float* slots = reinterpret_cast<float*>(smem + L::DT_OFF);
  // a tile's rows are cut into C shares of `rs` rows, share k summed by
  // block k: the partials' chunk k goes to block k
  const int rs = NT / c;
  // sum this block's share of the tile of walk step j over the 2C chunks
  // (rank order, then warpgroup), scale it into dt (or add it there), then
  // release the slots
  auto reduce_share = [&](int j) {
    const int bj = j % L::NBUF;
    if (t == 0 && h == 0) mbar_arrive_tx(&ready[bj], 2 * c * rs * DEPTH * 4);
    mbar_wait(&ready[bj], (j / L::NBUF) & 1);
    constexpr int V4 = DEPTH / 4;
    const int half = rs / 2;  // rows of the share for each warpgroup
    const float* in = slots + bj * (2 * NT * DEPTH);
    const float sc = __ldg(scale);
    for (int q = t; q < half * V4; q += WG) {
      const int r = h * half + q / V4;
      const int col = (q % V4) * 4;
      const int row = (t_begin + j) * NT + rank * rs + r;
      if (row >= v || col >= d_out) continue;
      const float* at = in + r * DEPTH + (col ^ ((r & 7) << 3));
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < 2 * c; ++k) {
        const float4 x =
            *reinterpret_cast<const float4*>(at + k * (rs * DEPTH));
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      float* out = dt + (size_t)row * d_out + col;
      const float vals[4] = {acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d_out) out[e] = acc_dt ? out[e] + vals[e] : vals[e];
    }
    __syncwarp();
    if (lane < c) mbar_arrive_cluster(cluster_addr(&freed[bj], lane));
  };
  mbar_wait(&ufull, 0);
  // S's A operand: the warpgroup's rows of u, K-major
  uint64_t udesc[L::MT];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
    udesc[mt] = swizzled_desc<128>(smem + (h * L::RW + mt * 64) * 128);
  // S = U T^T for the tile of walk step i (the warpgroup's rows x the
  // tile's 64 rows), both operands K-major in shared memory
  auto logits = [&](float (&S)[L::MT][32], int i) {
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const uint64_t tdesc = swizzled_desc<128>(ring + s * L::STAGE);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < DEPTH / 16; ++kk) {
        const uint64_t ka = (kk / 4) * (L::U_BOX >> 4) + (kk % 4) * 2;
        const uint64_t kb = (kk / 4) * (L::T_BOX >> 4) + (kk % 4) * 2;
        wgmma_ss<64, 0, 0>(S[mt], udesc[mt] + ka, tdesc + kb, kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) fence_regs(S[mt]);
  };
  if constexpr (!BWD) {
    // the online max and sum of exp2 over each tile's columns; the stage
    // is released once its product is done
    for (int i = 0; i < n; ++i) {
      float S[L::MT][32];
      logits(S, i);
      release_stage(&empty[i % L::STAGES], lane, c);
      const int tr0 = (t_begin + i) * NT;
      const bool edge = tr0 + NT > v;
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          if (edge) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (tr0 + 8 * j + 2 * tig + e >= v)
                  S[mt][4 * j + 2 * h2 + e] = -INFINITY;
          }
          float mx = NEG_BIG;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mx = fmaxf(mx, S[mt][4 * j + 2 * h2 + e]);
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float mn = fmaxf(rm[mt][h2], mx * LOG2E);
          float acc = rl[mt][h2] * ex2(rm[mt][h2] - mn);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc += ex2(fmaf(S[mt][4 * j + 2 * h2 + e], LOG2E, -mn));
          rm[mt][h2] = mn;
          rl[mt][h2] = acc;
        }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int s = i % L::STAGES;
      const int tile = t_begin + i;
      const int tr0 = tile * NT;
      const bool edge = tr0 + NT > v;
      unsigned char* st = ring + s * L::STAGE;
      float S[L::MT][32];
      logits(S, i);
      // p = bf16(exp2(x log2e - lse_eff log2e)) as A fragments over the
      // tile's rows (k), and into shared memory for p^T
      uint32_t pa[L::MT][4][4];
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = S[mt][4 * j + 2 * h2 + e];
              x = ex2(fmaf(x, LOG2E, -l2[mt][h2]));
              if (edge && tr0 + 8 * j + 2 * tig + e >= v) x = 0.f;
            }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pa[mt][kk][q] = pack_bf16(S[mt][8 * kk + 2 * q],
                                      S[mt][8 * kk + 2 * q + 1]);
        // the buffer is free once the last tile's dT partial has left it
        if (mt == 0) {
          if (t == 0) bulk_wait_read();
          named_sync(1 + h, WG);
        }
        // fragment q: row +8 for q odd, column +8 for q >= 2
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = mt * 64 + 16 * warp + gid + 8 * (q & 1);
            const int col = 16 * kk + 2 * tig + 8 * (q >> 1);
            *reinterpret_cast<uint32_t*>(pbuf + swz128(r, col)) =
                pa[mt][kk][q];
          }
      }
      fence_proxy_async();
      named_sync(1 + h, WG);
      // du += p T (table tile MN-major); dT = p^T U (both MN-major)
      float dtacc[DEPTH / 2];
      const uint64_t tdesc_mn = mn_major_desc(st, L::T_BOX);
      const uint64_t pdesc = mn_major_desc(pbuf, 0);
      const uint64_t udesc_mn =
          mn_major_desc(smem + h * L::RW * 128, L::U_BOX);
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) fence_regs(du[mt]);
      fence_regs(dtacc);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<DEPTH, 1>(du[mt], pa[mt][kk], tdesc_mn + kk * 128, 1);
#pragma unroll
      for (int kk = 0; kk < L::RW / 16; ++kk)
        wgmma_ss<DEPTH, 1, 1>(dtacc, pdesc + kk * 128, udesc_mn + kk * 128,
                              kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) fence_regs(du[mt]);
      fence_regs(dtacc);
      release_stage(&empty[s], lane, c);
      // this warpgroup's dT partial (float pairs at column ^ 8 (row % 8):
      // no bank conflicts) through the p buffer, its chunk k (rows [k rs,
      // (k + 1) rs)) by one bulk copy into this block's slot at block k,
      // once every block has summed that slot set's last contents (step
      // i - NBUF's); the bytes complete block k's `ready` phase
      const int bi = i % L::NBUF;
      float* part = reinterpret_cast<float*>(pbuf);
#pragma unroll
      for (int j = 0; j < DEPTH / 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = 16 * warp + gid + 8 * h2;
          const int col = (8 * j + 2 * tig) ^ ((r & 7) << 3);
          *reinterpret_cast<float2*>(part + r * DEPTH + col) =
              make_float2(dtacc[4 * j + 2 * h2], dtacc[4 * j + 2 * h2 + 1]);
        }
      fence_proxy_async();
      named_sync(1 + h, WG);
      if (t == 0) {
        if (i >= L::NBUF) mbar_wait(&freed[bi], (i / L::NBUF - 1) & 1);
        float* slot = slots + bi * (2 * NT * DEPTH) + (rank * 2 + h) * rs * DEPTH;
        for (int k = 0; k < c; ++k)
          bulk_copy_cluster(cluster_addr(slot, k), part + k * rs * DEPTH,
                            rs * DEPTH * 4, cluster_addr(&ready[bi], k));
      }
      if (i >= L::LAG) reduce_share(i - L::LAG);
    }
    for (int j = n - L::LAG > 0 ? n - L::LAG : 0; j < n; ++j) reduce_share(j);
  }
  if constexpr (!BWD) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float l = rl[mt][h2];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        const int row = rows[mt][h2];
        if (tig == 0 && row < b) {
          m_part[(size_t)cluster * b + row] = rm[mt][h2];
          l_part[(size_t)cluster * b + row] = l;
        }
      }
  } else {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int j = 0; j < DEPTH / 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = rows[mt][h2];
            const int col = 8 * j + 2 * tig + e;
            if (row < b && col < d_out)
              du_part[((size_t)cluster * b + row) * d_out + col] =
                  du[mt][4 * j + 2 * h2 + e];
          }
  }
  // no block leaves while another may still read its partials or signal
  // its barriers
  cluster_sync();
}

template <int DEPTH>
__global__ void __launch_bounds__(Ce<DEPTH, false>::THREADS, 1)
    ce_fwd(const __grid_constant__ CUtensorMap umap,
           const __grid_constant__ CUtensorMap tmap,
           float* __restrict__ m_part, float* __restrict__ l_part, int b,
           int v, int row0, int per) {
  ce_sweep<DEPTH, false>(&umap, &tmap, nullptr, nullptr, m_part, l_part,
                         nullptr, nullptr, b, v, 0, row0, per, 0);
}

template <int DEPTH>
__global__ void __launch_bounds__(Ce<DEPTH>::THREADS, 1)
    ce_bwd(const __grid_constant__ CUtensorMap umap,
           const __grid_constant__ CUtensorMap tmap,
           const float* __restrict__ lse_eff, const float* __restrict__ scale,
           float* __restrict__ du_part, float* __restrict__ dt, int b, int v,
           int d_out, int row0, int per, int acc_dt) {
  ce_sweep<DEPTH, true>(&umap, &tmap, lse_eff, scale, nullptr, nullptr,
                        du_part, dt, b, v, d_out, row0, per, acc_dt);
}

__global__ void lse_combine(const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            float* __restrict__ lse, int b, int n_parts) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  float mx = NEG_BIG;
  for (int c = 0; c < n_parts; ++c)
    mx = fmaxf(mx, m_part[(size_t)c * b + row]);
  float l = 0.f;
  for (int c = 0; c < n_parts; ++c)
    l += l_part[(size_t)c * b + row] * exp2f(m_part[(size_t)c * b + row] - mx);
  lse[row] = (mx + log2f(l)) * LN2;
}

__global__ void du_reduce(const float* __restrict__ du_part,
                          const float* __restrict__ scale,
                          float* __restrict__ du, int n, int n_parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_parts; ++c) s += du_part[(size_t)c * n + i];
  du[i] = s * __ldg(scale);
}

// The cluster plan the wrapper computed (`ops/fused_ce.py` `_plan`).
struct Plan {
  int cluster, passes, clusters, per;
};

bool plan_ok(int b, int v, int dp, const Plan& p) {
  const int rows = dp <= 64 ? Ce<64>::R : Ce<128>::R;
  const int n_tiles = (v + NT - 1) / NT;
  const long long pass_rows = (long long)p.cluster * rows;
  return b > 0 && v > 0 && dp > 0 && dp % 16 == 0 && dp <= 128 &&
         p.cluster >= 1 &&
         (p.cluster == 1 || p.cluster == 2 || p.cluster == 4) &&
         p.passes >= 1 &&
         (long long)p.passes * pass_rows >= b &&
         (long long)(p.passes - 1) * pass_rows < b && p.clusters >= 1 &&
         (long long)p.clusters * p.cluster <= 65535 && p.per >= 1 &&
         (long long)p.clusters * p.per >= n_tiles &&
         (long long)(p.clusters - 1) * p.per < n_tiles;
}

cudaLaunchConfig_t cluster_config(int threads, int smem, const Plan& p,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int maps(CUtensorMap* umap, CUtensorMap* tmap, const void* u, const void* t,
         int b, int v, int dp) {
  const int rows = dp <= 64 ? Ce<64>::R : Ce<128>::R;
  const int rc = k_major_map(umap, u, b, dp, 2, rows, 128);
  return rc != 0 ? rc : k_major_map(tmap, t, v, dp, 2, NT, 128);
}

template <int DEPTH>
int launch_lse(const void* u, const void* t, float* m_part, float* l_part,
               float* lse, int b, int v, int dp, const Plan& p,
               cudaStream_t st) {
  CUtensorMap umap, tmap;
  int rc = maps(&umap, &tmap, u, t, b, v, dp);
  if (rc != 0) return rc;
  auto kernel = ce_fwd<DEPTH>;
  constexpr int smem = Ce<DEPTH, false>::FWD_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(Ce<DEPTH, false>::THREADS, smem, p, st, attr);
  for (int pass = 0; pass < p.passes; ++pass) {
    e = cudaLaunchKernelEx(&cfg, kernel, umap, tmap, m_part, l_part, b, v,
                           pass * p.cluster * Ce<DEPTH>::R, p.per);
    if (e != cudaSuccess) return (int)e;
  }
  lse_combine<<<(b + 255) / 256, 256, 0, st>>>(m_part, l_part, lse, b,
                                               p.clusters);
  return (int)cudaGetLastError();
}

template <int DEPTH>
int launch_bwd(const void* u, const void* t, const float* lse_eff,
               const float* scale, float* du_part, float* du, float* dt,
               int b, int v, int dp, int d_out, const Plan& p,
               cudaStream_t st) {
  CUtensorMap umap, tmap;
  int rc = maps(&umap, &tmap, u, t, b, v, dp);
  if (rc != 0) return rc;
  auto kernel = ce_bwd<DEPTH>;
  constexpr int smem = Ce<DEPTH>::BWD_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(Ce<DEPTH>::THREADS, smem, p, st, attr);
  for (int pass = 0; pass < p.passes; ++pass) {
    e = cudaLaunchKernelEx(&cfg, kernel, umap, tmap, lse_eff, scale, du_part,
                           dt, b, v, d_out, pass * p.cluster * Ce<DEPTH>::R,
                           p.per, pass > 0 ? 1 : 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int n = b * d_out;
  du_reduce<<<(n + 255) / 256, 256, 0, st>>>(du_part, scale, du, n,
                                             p.clusters);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int max_clusters_of(Kernel kernel, int threads, int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(threads, smem, Plan{cluster, 1, 1, 1}, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <int DEPTH>
int max_clusters(int cluster, bool bwd) {
  return bwd ? max_clusters_of(ce_bwd<DEPTH>, Ce<DEPTH>::THREADS,
                               Ce<DEPTH>::BWD_SMEM, cluster)
             : max_clusters_of(ce_fwd<DEPTH>, Ce<DEPTH, false>::THREADS,
                               Ce<DEPTH, false>::FWD_SMEM, cluster);
}

}  // namespace

extern "C" {

// u (b, dp), t (v, dp) bf16 row-major, dp a multiple of 16 up to 128; the
// plan of `ops/fused_ce.py` `_plan`: clusters of `cluster` blocks, `passes`
// passes over b, `clusters` clusters of `per` 64-row table tiles; m_part,
// l_part (clusters, b) f32 scratch; lse (b,) f32 out.
int recbox_fused_ce_lse(const void* u, const void* t, void* m_part,
                        void* l_part, void* lse, int b, int v, int dp,
                        int cluster, int passes, int clusters, int per,
                        void* stream) {
  const Plan p{cluster, passes, clusters, per};
  if (!plan_ok(b, v, dp, p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* out = static_cast<float*>(lse);
  return dp <= 64 ? launch_lse<64>(u, t, mp, lp, out, b, v, dp, p, st)
                  : launch_lse<128>(u, t, mp, lp, out, b, v, dp, p, st);
}

// As above, with lse_eff (b,) f32 and scale (a device f32 scalar);
// du_part (clusters, b, d_out) f32 scratch; du (b, d_out), dt (v, d_out)
// f32 out, d_out <= dp.
int recbox_fused_ce_bwd(const void* u, const void* t, const void* lse_eff,
                        const void* scale, void* du_part, void* du, void* dt,
                        int b, int v, int dp, int d_out, int cluster,
                        int passes, int clusters, int per, void* stream) {
  const Plan p{cluster, passes, clusters, per};
  if (!plan_ok(b, v, dp, p) || d_out <= 0 || d_out > dp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* le = static_cast<const float*>(lse_eff);
  const float* sc = static_cast<const float*>(scale);
  float* dpart = static_cast<float*>(du_part);
  float* duo = static_cast<float*>(du);
  float* dto = static_cast<float*>(dt);
  return dp <= 64 ? launch_bwd<64>(u, t, le, sc, dpart, duo, dto, b, v, dp,
                                   d_out, p, st)
                  : launch_bwd<128>(u, t, le, sc, dpart, duo, dto, b, v, dp,
                                    d_out, p, st);
}

// Clusters of `cluster` blocks of the forward (bwd = 0) or backward kernel
// at padded depth dp that the current device runs at once; negative: a
// CUDA error.
int recbox_fused_ce_max_clusters(int cluster, int dp, int bwd) {
  if (cluster < 1 || dp <= 0 || dp > 128 ||
      (cluster != 1 && cluster != 2 && cluster != 4))
    return -(int)cudaErrorInvalidValue;
  return dp <= 64 ? max_clusters<64>(cluster, bwd != 0)
                  : max_clusters<128>(cluster, bwd != 0);
}

}  // extern "C"
