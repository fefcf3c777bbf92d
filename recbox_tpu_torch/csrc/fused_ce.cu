// Fused full-softmax cross-entropy ("flash-CE") for Hopper (sm_90a): the
// row logsumexp of u . t^T and its gradients, with the (B, V) logits never
// in device memory.
//
// Replaces the TPU kernel `recbox_tpu/ops/pallas/fused_ce.py`: `_fwd_kernel`
// :100 with `_lse_impl` :166 (the forward sweep) and `_bwd_kernel` :212,
// `_bwd_kernel_nb1` :241 with `_bwd_impl` :263 (the backward sweeps). For
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
// Bound on the H100 at B = 1024, V = 1M, D = 64: the forward's product is
// 2BVD = 1.31e11 operations, 0.133 ms at the bf16 tensor-core peak
// (989 TFLOP/s); its bytes (the 128 MB bf16 table) 0.038 ms at 3.35 TB/s;
// and it takes one exp per logit, BV = 1.02e9, about 0.26 ms at the
// special-function units' ~3.9e12/s. The backward's three products
// (3.93e11) take 0.398 ms at the peak, its bytes (table read, f32 dt
// written) 0.115 ms; this design recomputes the exps in each of its two
// sweeps. At D = 64 the kernel is bound by exps, then by the tensor cores,
// not by memory: exp2 with log2(e) folded into one FFMA, sums in registers.
//
// Design (a first, simple and deterministic version). The TPU ran its V
// grid in order, with the running max/sum and du resident in VMEM across
// it; Hopper's blocks run in parallel, so each reduction over V is split
// into chunks and finished by a second small launch:
//  (a) `lse_partial`: grid (B tiles, V chunks). Each warp keeps its rows
//      of u as mma.sync m16n8k16 A fragments in registers for the whole
//      sweep; 64-row tiles of t stream through a two-stage cp.async ring
//      in shared memory (rows padded so ldmatrix is free of bank
//      conflicts). Each 32-column slice of logits is folded into an online
//      max and sum of exp2 in registers; a row's four lanes share its max
//      by shuffles. One (m, l) per (row, chunk); `lse_combine` folds them.
//  (b) `dt_sweep`: a block owns 256 rows of t (A fragments in registers),
//      streams all of u (L2-resident at any B) and keeps its dt rows in
//      registers, written once. p leaves the first product in the
//      accumulator layout, which after the bf16 cast is the A-fragment
//      layout of the second (p^T u), so p never touches shared memory; the
//      second product's B fragments come from ldmatrix.trans.
//  (c) `du_sweep`: as (a), accumulating p T per (row, chunk) into partials
//      that `du_reduce` sums in a fixed order (deterministic).
// The sweeps of (b) and (c) take 16-column slices and are held to 128
// registers, so two blocks share an SM: measured on the H100 at the 1M
// shape, 2.32 ms for the backward against 3.24 ms with 32-column slices at
// one block per SM. The forward keeps 32-column slices at two blocks per
// SM; three (80 registers, with spills) measured slower.
// Rows and columns past B and V are masked by bounds: no bias column. One
// sweep with du in f32 atomics, wgmma with TMA-fed tiles and a persistent
// schedule are later work.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 64;   // rows of the streamed operand a stage
constexpr int SUB = 32;   // logit columns the forward handles at once
constexpr int SUB_BWD = 16;  // and the backward (fewer live registers)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;

// KMAX: 16-deep k-steps of the padded depth (D <= 16 * KMAX);
// MT: m16 tiles of the resident operand one warp holds.
template <int KMAX> struct Cfg {
  static constexpr int MT = KMAX <= 4 ? 2 : 1;
  static constexpr int ROWS = WARPS * MT * 16;  // resident rows a block
  static constexpr int LDS = KMAX * 16 + 8;     // stage row stride (bf16)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Rows [row0, row0 + NT) of a (rows, dp) bf16 matrix into a stage (row
// stride LDS) through cp.async, zeros past `rows`.
template <int KMAX>
__device__ __forceinline__ void load_stage(bf16* st,
                                           const bf16* __restrict__ src,
                                           int row0, int rows, int dp) {
  const int vpr = dp / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < NT * vpr; i += THREADS) {
    const int r = i / vpr;
    const int c = (i % vpr) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(st + r * Cfg<KMAX>::LDS + c,
               src + (size_t)(ok ? row : 0) * dp + c, ok);
  }
}

// The warp's MT x 16 rows from row0 of a (rows, dp) bf16 matrix as A
// fragments: (row gid, k 2tig), (row gid+8, k 2tig), (gid, 2tig+8),
// (gid+8, 2tig+8); zeros past `rows` and past the depth.
template <int KMAX>
__device__ __forceinline__ void load_resident(
    uint32_t (&a)[Cfg<KMAX>::MT][KMAX][4], const bf16* __restrict__ x,
    int row0, int rows, int dp) {
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ksteps = dp / 16;
#pragma unroll
  for (int m = 0; m < Cfg<KMAX>::MT; ++m) {
    const int ra = row0 + m * 16 + gid, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < KMAX; ++ks) {
      const int k = ks * 16 + 2 * tig;
      const bool kin = ks < ksteps;
      const bool oka = kin && ra < rows, okb = kin && rb < rows;
      a[m][ks][0] = oka ? ld_u32(x + (size_t)ra * dp + k) : 0u;
      a[m][ks][1] = okb ? ld_u32(x + (size_t)rb * dp + k) : 0u;
      a[m][ks][2] = oka ? ld_u32(x + (size_t)ra * dp + k + 8) : 0u;
      a[m][ks][3] = okb ? ld_u32(x + (size_t)rb * dp + k + 8) : 0u;
    }
  }
}

// s[m][j] = the warp's rows . stage rows c0 + 8j .. c0 + 8j + 7 (C layout:
// (row gid, cols 2tig, 2tig+1), then row gid + 8).
template <int KMAX, int W>
__device__ __forceinline__ void logits_slice(
    float (&s)[Cfg<KMAX>::MT][W / 8][4],
    const uint32_t (&a)[Cfg<KMAX>::MT][KMAX][4], const bf16* st, int c0,
    int ksteps) {
  constexpr int MT = Cfg<KMAX>::MT;
  const int lane = threadIdx.x % 32;
  // x4 matrices: (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi)
  const int lrow = (lane % 8) + 8 * (lane / 16);
  const int lcol = 8 * ((lane / 8) % 2);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KMAX; ++ks) {
    if (ks < ksteps) {
#pragma unroll
      for (int jj = 0; jj < W / 16; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, st + (c0 + 16 * jj + lrow) * Cfg<KMAX>::LDS + 16 * ks +
                       lcol);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(s[m][2 * jj], a[m][ks], b[0], b[1]);
          mma_bf16(s[m][2 * jj + 1], a[m][ks], b[2], b[3]);
        }
      }
    }
  }
}

// p in the C layout of `logits_slice` as A fragments over k = its columns
template <int MT, int W>
__device__ __forceinline__ void p_fragments(uint32_t (&pa)[MT][W / 16][4],
                                            const float (&p)[MT][W / 8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      pa[m][kk][0] = pack_bf16(p[m][2 * kk][0], p[m][2 * kk][1]);
      pa[m][kk][1] = pack_bf16(p[m][2 * kk][2], p[m][2 * kk][3]);
      pa[m][kk][2] = pack_bf16(p[m][2 * kk + 1][0], p[m][2 * kk + 1][1]);
      pa[m][kk][3] = pack_bf16(p[m][2 * kk + 1][2], p[m][2 * kk + 1][3]);
    }
}

// acc[m][n] += p (the warp's rows x stage rows c0 .. c0 + W) . stage
// (those rows, depth columns 8n .. 8n + 7)
template <int KMAX, int W>
__device__ __forceinline__ void accumulate_pv(
    float (&acc)[Cfg<KMAX>::MT][2 * KMAX][4],
    const uint32_t (&pa)[Cfg<KMAX>::MT][W / 16][4], const bf16* st, int c0,
    int ksteps) {
  constexpr int MT = Cfg<KMAX>::MT;
  const int lane = threadIdx.x % 32;
  // x4.trans matrices: (k lo, n lo), (k hi, n lo), (k lo, n hi), (k hi, n hi)
  const int lrow = (lane % 8) + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
#pragma unroll
    for (int dn = 0; dn < KMAX; ++dn) {
      if (dn < ksteps) {
        uint32_t b[4];
        ldsm_x4_trans(b, st + (c0 + 16 * kk + lrow) * Cfg<KMAX>::LDS +
                             16 * dn + lcol);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * dn], pa[m][kk], b[0], b[1]);
          mma_bf16(acc[m][2 * dn + 1], pa[m][kk], b[2], b[3]);
        }
      }
    }
  }
}

// Grid (ceil(b / ROWS), n_chunks): rows of u against the V tiles of one
// chunk; (m, l) in the log2 domain, one pair per (chunk, row).
template <int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
    lse_partial(const bf16* __restrict__ u, const bf16* __restrict__ t,
                float* __restrict__ m_part, float* __restrict__ l_part, int b,
                int v, int dp, int tiles_per_chunk) {
  constexpr int MT = Cfg<KMAX>::MT;
  __shared__ __align__(128) bf16 stage[2][NT * Cfg<KMAX>::LDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ksteps = dp / 16;
  const int row0 = blockIdx.x * Cfg<KMAX>::ROWS + warp * MT * 16;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min((v + NT - 1) / NT, t_begin + tiles_per_chunk);
  uint32_t a[MT][KMAX][4];
  load_resident<KMAX>(a, u, row0, b, dp);
  float rm[MT][2], rl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rm[m][h] = NEG_BIG;
      rl[m][h] = 0.f;
    }
  if (t_begin < t_end) load_stage<KMAX>(stage[0], t, t_begin * NT, v, dp);
  cp_async_commit();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end)
      load_stage<KMAX>(stage[buf ^ 1], t, (tile + 1) * NT, v, dp);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += SUB) {
      float s[MT][SUB / 8][4];
      logits_slice<KMAX, SUB>(s, a, stage[buf], c0, ksteps);
      const int col0 = tile * NT + c0 + 2 * tig;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = NEG_BIG;
#pragma unroll
          for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (col0 + 8 * j + e >= v) s[m][j][2 * h + e] = -INFINITY;
              mx = fmaxf(mx, s[m][j][2 * h + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float mn = fmaxf(rm[m][h], mx * LOG2E);
          float acc = rl[m][h] * ex2(rm[m][h] - mn);
#pragma unroll
          for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc += ex2(fmaf(s[m][j][2 * h + e], LOG2E, -mn));
          rm[m][h] = mn;
          rl[m][h] = acc;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = rl[m][h];
      l += __shfl_xor_sync(FULL, l, 1);
      l += __shfl_xor_sync(FULL, l, 2);
      const int row = row0 + m * 16 + gid + 8 * h;
      if (tig == 0 && row < b) {
        m_part[(size_t)chunk * b + row] = rm[m][h];
        l_part[(size_t)chunk * b + row] = l;
      }
    }
}

__global__ void lse_combine(const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            float* __restrict__ lse, int b, int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  float mx = NEG_BIG;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, m_part[(size_t)c * b + row]);
  float l = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    l += l_part[(size_t)c * b + row] * exp2f(m_part[(size_t)c * b + row] - mx);
  lse[row] = (mx + log2f(l)) * LN2;
}

// Grid (ceil(b / ROWS), n_chunks): du partial of (chunk, rows), unscaled.
template <int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
    du_sweep(const bf16* __restrict__ u, const bf16* __restrict__ t,
             const float* __restrict__ lse_eff, float* __restrict__ du_part,
             int b, int v, int dp, int d_out, int tiles_per_chunk) {
  constexpr int MT = Cfg<KMAX>::MT;
  __shared__ __align__(128) bf16 stage[2][NT * Cfg<KMAX>::LDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ksteps = dp / 16;
  const int row0 = blockIdx.x * Cfg<KMAX>::ROWS + warp * MT * 16;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min((v + NT - 1) / NT, t_begin + tiles_per_chunk);
  uint32_t a[MT][KMAX][4];
  load_resident<KMAX>(a, u, row0, b, dp);
  float l2[MT][2];
  float acc[MT][2 * KMAX][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + m * 16 + gid + 8 * h;
      l2[m][h] = row < b ? __ldg(lse_eff + row) * LOG2E : INFINITY;
    }
#pragma unroll
    for (int n = 0; n < 2 * KMAX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  }
  if (t_begin < t_end) load_stage<KMAX>(stage[0], t, t_begin * NT, v, dp);
  cp_async_commit();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end)
      load_stage<KMAX>(stage[buf ^ 1], t, (tile + 1) * NT, v, dp);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += SUB_BWD) {
      float s[MT][SUB_BWD / 8][4];
      logits_slice<KMAX, SUB_BWD>(s, a, stage[buf], c0, ksteps);
      const int col0 = tile * NT + c0 + 2 * tig;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < SUB_BWD / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[m][j][2 * h + e];
              x = col0 + 8 * j + e < v ? ex2(fmaf(x, LOG2E, -l2[m][h])) : 0.f;
            }
      uint32_t pa[MT][SUB_BWD / 16][4];
      p_fragments<MT, SUB_BWD>(pa, s);
      accumulate_pv<KMAX, SUB_BWD>(acc, pa, stage[buf], c0, ksteps);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * KMAX; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + m * 16 + gid + 8 * h;
          const int col = 8 * n + 2 * tig + e;
          if (row < b && col < d_out)
            du_part[((size_t)chunk * b + row) * d_out + col] =
                acc[m][n][2 * h + e];
        }
}

__global__ void du_reduce(const float* __restrict__ du_part,
                          const float* __restrict__ scale,
                          float* __restrict__ du, int n, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += du_part[(size_t)c * n + i];
  du[i] = s * __ldg(scale);
}

// Grid (ceil(v / ROWS)): a block's rows of t against every row of u;
// dt rows written once, times *scale.
template <int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
    dt_sweep(const bf16* __restrict__ u, const bf16* __restrict__ t,
             const float* __restrict__ lse_eff,
             const float* __restrict__ scale, float* __restrict__ dt, int b,
             int v, int dp, int d_out) {
  constexpr int MT = Cfg<KMAX>::MT;
  __shared__ __align__(128) bf16 stage[2][NT * Cfg<KMAX>::LDS];
  __shared__ float l2s[2][NT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ksteps = dp / 16;
  const int row0 = blockIdx.x * Cfg<KMAX>::ROWS + warp * MT * 16;
  const int n_tiles = (b + NT - 1) / NT;
  uint32_t a[MT][KMAX][4];
  load_resident<KMAX>(a, t, row0, v, dp);
  float acc[MT][2 * KMAX][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * KMAX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  load_stage<KMAX>(stage[0], u, 0, b, dp);
  for (int i = threadIdx.x; i < NT; i += THREADS)
    l2s[0][i] = i < b ? __ldg(lse_eff + i) * LOG2E : INFINITY;
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_stage<KMAX>(stage[buf ^ 1], u, (tile + 1) * NT, b, dp);
      for (int i = threadIdx.x; i < NT; i += THREADS) {
        const int r = (tile + 1) * NT + i;
        l2s[buf ^ 1][i] = r < b ? __ldg(lse_eff + r) * LOG2E : INFINITY;
      }
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += SUB_BWD) {
      float s[MT][SUB_BWD / 8][4];
      logits_slice<KMAX, SUB_BWD>(s, a, stage[buf], c0, ksteps);
#pragma unroll
      for (int j = 0; j < SUB_BWD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = l2s[buf][c0 + 8 * j + 2 * tig + e];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& x = s[m][j][2 * h + e];
              x = ex2(fmaf(x, LOG2E, -l2));
            }
        }
      uint32_t pa[MT][SUB_BWD / 16][4];
      p_fragments<MT, SUB_BWD>(pa, s);
      accumulate_pv<KMAX, SUB_BWD>(acc, pa, stage[buf], c0, ksteps);
    }
    __syncthreads();
  }
  const float sc = __ldg(scale);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * KMAX; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + m * 16 + gid + 8 * h;
          const int col = 8 * n + 2 * tig + e;
          if (row < v && col < d_out)
            dt[(size_t)row * d_out + col] = acc[m][n][2 * h + e] * sc;
        }
}

bool plan_ok(int b, int v, int dp, int n_chunks, int tiles_per_chunk) {
  const int n_tiles = (v + NT - 1) / NT;
  return b > 0 && v > 0 && dp > 0 && dp % 16 == 0 && dp <= 128 &&
         n_chunks >= 1 && n_chunks <= 65535 && tiles_per_chunk >= 1 &&
         (long long)n_chunks * tiles_per_chunk >= n_tiles &&
         (long long)(n_chunks - 1) * tiles_per_chunk < n_tiles;
}

template <int KMAX>
int launch_lse(const bf16* u, const bf16* t, float* m_part, float* l_part,
               float* lse, int b, int v, int dp, int n_chunks,
               int tiles_per_chunk, cudaStream_t st) {
  const dim3 grid((b + Cfg<KMAX>::ROWS - 1) / Cfg<KMAX>::ROWS, n_chunks);
  lse_partial<KMAX><<<grid, THREADS, 0, st>>>(u, t, m_part, l_part, b, v, dp,
                                              tiles_per_chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lse_combine<<<(b + 255) / 256, 256, 0, st>>>(m_part, l_part, lse, b,
                                               n_chunks);
  return (int)cudaGetLastError();
}

template <int KMAX>
int launch_bwd(const bf16* u, const bf16* t, const float* lse_eff,
               const float* scale, float* du_part, float* du, float* dt, int b,
               int v, int dp, int d_out, int n_chunks, int tiles_per_chunk,
               cudaStream_t st) {
  constexpr int ROWS = Cfg<KMAX>::ROWS;
  dt_sweep<KMAX><<<(v + ROWS - 1) / ROWS, THREADS, 0, st>>>(
      u, t, lse_eff, scale, dt, b, v, dp, d_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((b + ROWS - 1) / ROWS, n_chunks);
  du_sweep<KMAX><<<grid, THREADS, 0, st>>>(u, t, lse_eff, du_part, b, v, dp,
                                           d_out, tiles_per_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = b * d_out;
  du_reduce<<<(n + 255) / 256, 256, 0, st>>>(du_part, scale, du, n, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u (b, dp), t (v, dp) bf16 row-major, dp a multiple of 16 up to 128;
// V tiles of 64 rows cut into n_chunks runs of tiles_per_chunk;
// m_part, l_part (n_chunks, b) f32 scratch; lse (b,) f32 out.
int recbox_fused_ce_lse(const void* u, const void* t, void* m_part,
                        void* l_part, void* lse, int b, int v, int dp,
                        int n_chunks, int tiles_per_chunk, void* stream) {
  if (!plan_ok(b, v, dp, n_chunks, tiles_per_chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* uu = static_cast<const bf16*>(u);
  const bf16* tt = static_cast<const bf16*>(t);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* out = static_cast<float*>(lse);
  if (dp <= 64)
    return launch_lse<4>(uu, tt, mp, lp, out, b, v, dp, n_chunks,
                         tiles_per_chunk, st);
  return launch_lse<8>(uu, tt, mp, lp, out, b, v, dp, n_chunks,
                       tiles_per_chunk, st);
}

// As above, with lse_eff (b,) f32 and scale (a device f32 scalar);
// du_part (n_chunks, b, d_out) f32 scratch; du (b, d_out), dt (v, d_out)
// f32 out, d_out <= dp.
int recbox_fused_ce_bwd(const void* u, const void* t, const void* lse_eff,
                        const void* scale, void* du_part, void* du, void* dt,
                        int b, int v, int dp, int d_out, int n_chunks,
                        int tiles_per_chunk, void* stream) {
  if (!plan_ok(b, v, dp, n_chunks, tiles_per_chunk) || d_out <= 0 ||
      d_out > dp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* uu = static_cast<const bf16*>(u);
  const bf16* tt = static_cast<const bf16*>(t);
  const float* le = static_cast<const float*>(lse_eff);
  const float* sc = static_cast<const float*>(scale);
  float* dpart = static_cast<float*>(du_part);
  float* duo = static_cast<float*>(du);
  float* dto = static_cast<float*>(dt);
  if (dp <= 64)
    return launch_bwd<4>(uu, tt, le, sc, dpart, duo, dto, b, v, dp, d_out,
                         n_chunks, tiles_per_chunk, st);
  return launch_bwd<8>(uu, tt, le, sc, dpart, duo, dto, b, v, dp, d_out,
                       n_chunks, tiles_per_chunk, st);
}

}  // extern "C"
