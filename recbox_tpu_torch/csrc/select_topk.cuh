// Row-wise exact top-k selection for Hopper (sm_90a): a radix selection
// over keys held in registers, then a sort of the k survivors, written out
// through an epilogue the caller gives. Used by B5 (`bitonic_topk.cu`:
// scores and ids) and by B3's stage (b) (`mips_fused_topk.cu`: packed
// segment winners, decoded to scores and row ids).
//
// The order is total: score descending (the float's bits made to sort as an
// integer, so -inf < finite < +inf < NaN), then candidate position
// ascending, which is lax.top_k's order.
//
// Design. B5's first version sorted every candidate (3.05e9
// compare-exchanges at (C, Q) = (7936, 8192)) and read its column with one 32-byte
// sector per 4-byte score. This one:
//  * reads every score once. 256 threads take a query, each holding up to
//    64 of its scores in registers as 32-bit order keys (positions t,
//    t + 256, ...). A block takes QB queries: 4 while a thread holds at
//    most 32 keys (1024 threads, the register file's 64 a thread), else 2
//    or 1 as shared memory allows. In the candidate-major layout (queries
//    contiguous) it loads each candidate's QB scores as one 16- or 8-byte
//    vector and hands them to their queries' threads through shared
//    memory; in the row-major layout each query's threads read its row.
//  * selects by radix. The key of candidate i is the 64-bit (order key << 32
//    | ~position), all distinct, so the k-th largest key is one key and
//    exactly k keys are >= it: no tie rule is needed beyond the key itself,
//    and the set is the total order's own. A first pass counts the top 11
//    bits of every key into 2048 bins (shared atomics, spread enough that
//    lanes rarely collide; a first version's 8-bit digit with
//    __match_any_sync aggregation cost most of its time), later passes 8
//    bits (cut at bit 32) of the keys that share the prefix chosen so far;
//    a warp walks the bins from the top with `redux` sums and picks the
//    bin that holds the k-th key, and the passes stop once that bin's keys
//    are exactly the ones still needed: two passes for N(0, 1) scores, more
//    when scores tie (the position bits then decide). Every pass sweeps
//    registers, comparing the two 32-bit words of a key, not memory.
//  * places the k survivors with one shared atomic a warp (a lane counts
//    its own, a warp scan gives the offsets), sorts them (up to 512: a
//    bitonic network in registers, two keys a thread, shuffles up to
//    stride 32 and shared memory beyond; more: the network in shared
//    memory) and hands those k alone to the epilogue (B5 gathers their
//    ids, B3 decodes their packed row indices).
// Each query's 256 threads sync on their own named barrier, so one query's
// barriers overlap another's work. Candidates past what one pass holds
// (C > 16384) come in windows of 16384: each window's keys are selected
// together with the k survivors carried from the windows before it.
// A persistent grid that asked L2 for the next query set's scores while
// selecting the current one was tried and was slower on the card.
//
// Past one window with 2k > 16384 (k above 8192 over more than 16384
// candidates) the carry and a window no longer fit a block, and the
// global-memory mode (`launch_select_large`) takes over, for any k <= C.
// Per chunk of queries, five kernels: (1) a candidate-major source's order
// keys copied row-major into a (rows, C) u32 scratch through 32 x 32 tiles
// in shared memory, so it is read and written in whole lines (a row-major
// source is read in place); (2) one
// 1024-thread block a row runs the same radix selection over the row's
// keys in device memory (11 / 11 / 10-bit digits of each 32-bit word, a
// shared histogram a pass) and compacts the k keys at or above the found
// prefix into a (rows, p) survivor buffer, warp-aggregated, the rest of
// the row's p slots set to 0, below every key; (3) runs of 16384
// survivors sorted by the bitonic network, each run's direction its place
// in the row's network, 16 keys a thread in registers for the strides
// below 16 and shared memory for the rest; (4) the strides of 16384 and
// more of the larger merges in global memory, one launch a stride, each
// merge finished in shared memory by (3); (5) the epilogue over the first
// k keys of each row. A simple design that is right; its time is in
// `PERF.md`.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int G = 256;                      // threads of a query
constexpr int FIRST_BITS = 11;              // the first pass's digit
constexpr int HIST_BINS = 1 << FIRST_BITS;  // bins of the largest digit
constexpr int MAX_WINDOW = 16384;           // 64 keys a thread
constexpr int SMEM_LIMIT = 232448;          // a block's shared memory, sm_90

// What a query's warp 0 tells its other threads: the bin of the k-th key,
// the keys still needed in it and its count; the survivors written so far.
struct GroupState {
  int bin;
  int remaining;
  int bin_count;
  int filled;
};

// The float's bits made to sort as an unsigned integer: -NaN < -inf < ...
// < -0 < +0 < ... < +inf < NaN.
__device__ __forceinline__ unsigned int order_key(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The score and the candidate position of a 64-bit key (order key << 32 |
// ~position).
__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned int u = (unsigned int)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}
__device__ __forceinline__ int key_position(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)key);
}

// bar.sync on barrier `id` for the G threads of one query.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(G) : "memory");
}

template <int QB> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void put(float* s, int stride, T v) {
    s[0] = v.x;
    s[stride] = v.y;
    s[2 * stride] = v.z;
    s[3 * stride] = v.w;
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ void put(float* s, int stride, T v) {
    s[0] = v.x;
    s[stride] = v.y;
  }
};

// One warp (lane) walks the `bins` histogram from the top, 32 bins at a
// time, to the bin where the count of keys reaches `remaining`; writes the
// bin, what is still needed inside it and its count to `st`.
__device__ __forceinline__ void find_bin(const int* hist, int bins,
                                         int remaining, int lane,
                                         GroupState* st) {
  int above = 0;
  for (int top = bins - 1; top >= 0; top -= 32) {
    const int b = top - lane;
    const int v = b >= 0 ? hist[b] : 0;
    const int total = __reduce_add_sync(0xFFFFFFFFu, v);
    if (above + total >= remaining) {
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += x;
      }
      const unsigned int hit =
          __ballot_sync(0xFFFFFFFFu, above + incl >= remaining);
      if (lane == __ffs(hit) - 1) {
        st->bin = b;
        st->remaining = remaining - (above + incl - v);
        st->bin_count = v;
      }
      return;
    }
    above += total;
  }
}

// The digit after the one ending at bit `shift` of the 64-bit key: 11 bits
// first, then 8, cut at bit 32 so no digit spans the two words.
__device__ __forceinline__ int next_bits(int shift) {
  return shift == 64 ? FIRST_BITS : min(8, shift > 32 ? shift - 32 : shift);
}

// The bits of the k-th key found so far: the key's two 32-bit words under
// their masks.
struct Prefix {
  unsigned int hi, mask_hi, lo, mask_lo;
  __device__ __forceinline__ bool matches(unsigned int h,
                                          unsigned int l) const {
    return (h & mask_hi) == hi && (l & mask_lo) == lo;
  }
  __device__ __forceinline__ bool at_or_above(unsigned int h,
                                              unsigned int l) const {
    const unsigned int m = h & mask_hi;
    return m > hi || (m == hi && (l & mask_lo) >= lo);
  }
};

// The low word of a window key: the inverted position.
__device__ __forceinline__ unsigned int low_word(int pos) {
  return 0xFFFFFFFFu - (unsigned int)pos;
}

// Write into `out` the exactly k candidates whose keys are the k largest,
// in no order: the w window keys (order key u[j], position off + t + G*j)
// and nc carried 64-bit keys. All G threads of the query (barrier `bar`).
// Keys are compared as their two 32-bit words, the low one (~position)
// recomputed where needed, so a thread keeps KPT registers of keys.
template <int KPT>
__device__ __forceinline__ void radix_select(
    const unsigned int (&u)[KPT], int w, int off,
    const unsigned long long* carry, int nc, int k, unsigned long long* out,
    int* hist, GroupState* st, int bar) {
  const int t = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  Prefix pre{0u, 0u, 0u, 0u};
  int remaining = k;
  for (int shift = 64;;) {
    const int bits = next_bits(shift);
    shift -= bits;
    const int bins = 1 << bits;
    const bool high = shift >= 32;
    const int s = high ? shift - 32 : shift;
    for (int b = t; b < bins; b += G) hist[b] = 0;
    group_sync(bar);
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int pos = t + G * j;
      const unsigned int lo = low_word(off + pos);
      if (pos < w && pre.matches(u[j], lo))
        atomicAdd(hist + (((high ? u[j] : lo) >> s) & (bins - 1)), 1);
    }
    for (int i = t; i < nc; i += G) {
      const unsigned int hi = (unsigned int)(carry[i] >> 32);
      const unsigned int lo = (unsigned int)carry[i];
      if (pre.matches(hi, lo))
        atomicAdd(hist + (((high ? hi : lo) >> s) & (bins - 1)), 1);
    }
    group_sync(bar);
    if (t < 32) find_bin(hist, bins, remaining, lane, st);
    group_sync(bar);
    if (high) {
      pre.hi |= (unsigned int)st->bin << s;
      pre.mask_hi |= (unsigned int)(bins - 1) << s;
    } else {
      pre.lo |= (unsigned int)st->bin << s;
      pre.mask_lo |= (unsigned int)(bins - 1) << s;
    }
    remaining = st->remaining;
    // every key left in the bin is needed (always so at the last bits: the
    // keys are distinct)
    if (st->bin_count == remaining || shift == 0) break;
  }
  // the k keys at or above the prefix, in no order: a lane counts its
  // own, a warp scan places them, one shared atomic a warp
  int mine = 0;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int pos = t + G * j;
    mine += pos < w && pre.at_or_above(u[j], low_word(off + pos));
  }
  for (int i = t; i < nc; i += G)
    mine += pre.at_or_above((unsigned int)(carry[i] >> 32),
                            (unsigned int)carry[i]);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += x;
  }
  if (t == 0) st->filled = 0;
  group_sync(bar);
  int slot = 0;
  if (lane == 31 && incl > 0) slot = atomicAdd(&st->filled, incl);
  slot = __shfl_sync(0xFFFFFFFFu, slot, 31) + incl - mine;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int pos = t + G * j;
    const unsigned int lo = low_word(off + pos);
    if (pos < w && pre.at_or_above(u[j], lo))
      out[slot++] = ((unsigned long long)u[j] << 32) | lo;
  }
  for (int i = t; i < nc; i += G) {
    const unsigned long long x = carry[i];
    if (pre.at_or_above((unsigned int)(x >> 32), (unsigned int)x))
      out[slot++] = x;
  }
  group_sync(bar);
}

// One compare-exchange of a bitonic network, seen from element i holding
// `mine` against its partner's `other`: the lower index of a pair keeps the
// larger key where the run sorts descending.
__device__ __forceinline__ unsigned long long exchange(
    unsigned long long mine, unsigned long long other, int i, int stride,
    int size) {
  const bool first = (i & stride) == 0;
  const bool desc = (i & size) == 0;
  const unsigned long long hi = mine > other ? mine : other;
  const unsigned long long lo = mine > other ? other : mine;
  return first == desc ? hi : lo;
}

// Sort s[0, 512) descending; the G threads of a query, two keys each
// (positions 2t, 2t+1) in registers. Strides up to 32 pair threads of one
// warp (shuffles, no barrier); strides of 64 and more go through s.
__device__ void sort512_desc(unsigned long long* s, int bar) {
  const int t = threadIdx.x % G;
  const int i0 = 2 * t, i1 = 2 * t + 1;
  unsigned long long v0 = s[i0], v1 = s[i1];
  for (int size = 2; size <= 2 * G; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long o0, o1;
      if (stride == 1) {
        o0 = v1;
        o1 = v0;
      } else if (stride < 64) {
        o0 = __shfl_xor_sync(0xFFFFFFFFu, v0, stride >> 1);
        o1 = __shfl_xor_sync(0xFFFFFFFFu, v1, stride >> 1);
      } else {
        group_sync(bar);
        s[i0] = v0;
        s[i1] = v1;
        group_sync(bar);
        o0 = s[i0 ^ stride];
        o1 = s[i1 ^ stride];
      }
      v0 = exchange(v0, o0, i0, stride, size);
      v1 = exchange(v1, o1, i1, stride, size);
    }
  }
  group_sync(bar);
  s[i0] = v0;
  s[i1] = v1;
  group_sync(bar);
}

// Sort s[0, p) descending, p a power of two; the G threads of a query.
__device__ void sort_desc(unsigned long long* s, int p, int bar) {
  const int t = threadIdx.x % G;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < p / 2; i += G) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      group_sync(bar);
    }
  }
}

// Shared memory of a block: the staging of a batch of (up to 2) vector
// loads of every thread (QB > 1), then per query the histogram, its state
// and `nbuf` buffers of max(p, 512) 64-bit keys.
constexpr int MAX_BATCH = 2;
__host__ __device__ constexpr int staging_bytes(int qb) {
  return qb > 1 ? MAX_BATCH * qb * qb * G * 4 : 0;
}
__host__ __device__ constexpr int group_bytes(int p, int nbuf) {
  return HIST_BINS * 4 + 32 + nbuf * (p > 2 * G ? p : 2 * G) * 8;
}
__host__ __device__ constexpr int smem_bytes(int qb, int p, int nbuf) {
  return staging_bytes(qb) + qb * group_bytes(p, nbuf);
}

// Grid (ceil(nq / QB)), QB * G threads. Score (q, c) at scores[q * s_q +
// c * s_c]; the j-th largest key of query q goes to out(q, j, key), the
// caller's epilogue (its score `key_score`, its position `key_position`).
// `window` keys a pass (C when C fits), at most G * KPT; p a power of two
// >= k.
template <int QB, int KPT, class Out>
__global__ void __launch_bounds__(QB * G)
    select_topk(const float* __restrict__ scores, int nq, int c, int k,
                int p, int window, long long s_q, long long s_c, Out out) {
  static_assert(KPT % QB == 0, "a vector load feeds QB keys a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbuf = window < c ? 2 : 1;
  const int width = max(p, 2 * G);  // a buffer: p keys, 512 at least
  const int group = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int bar = 1 + group;
  const int q0 = blockIdx.x * QB;
  const int q = q0 + group;
  float* staging = reinterpret_cast<float*>(smem);
  unsigned char* gmem =
      smem + staging_bytes(QB) + group * group_bytes(p, nbuf);
  int* hist = reinterpret_cast<int*>(gmem);
  GroupState* st = reinterpret_cast<GroupState*>(gmem + HIST_BINS * 4);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(gmem + HIST_BINS * 4 + 32);
  const bool vec = QB > 1 && s_q == 1 && q0 + QB <= nq && s_c % QB == 0 &&
                   (reinterpret_cast<uintptr_t>(scores + q0) %
                    (QB * sizeof(float))) == 0;
  unsigned int u[KPT];
  int nc = 0, rounds = 0;
  for (int off = 0; off < c; off += window, ++rounds) {
    const int w = min(window, c - off);
    if constexpr (QB > 1) {
      if (vec) {
        // thread x loads rows r = x + QB*G*m (m < KPT/QB), all QB queries
        // of each; row r's score of query j reaches register r / G of
        // query j's thread r % G
        using V = typename Vec<QB>::T;
        constexpr int LOADS = KPT / QB;           // vectors a thread
        constexpr int BATCH = LOADS < MAX_BATCH ? LOADS : MAX_BATCH;
#pragma unroll
        for (int m0 = 0; m0 < LOADS; m0 += BATCH) {
          V v[BATCH];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const int r = threadIdx.x + QB * G * (m0 + b);
            v[b] = r < w ? __ldg(reinterpret_cast<const V*>(
                               scores + q0 + (long long)(off + r) * s_c))
                         : V{};
          }
#pragma unroll
          for (int b = 0; b < BATCH; ++b)
            Vec<QB>::put(staging + b * QB * QB * G + threadIdx.x, QB * G,
                         v[b]);
          __syncthreads();
#pragma unroll
          for (int b = 0; b < BATCH; ++b)
#pragma unroll
            for (int i = 0; i < QB; ++i)
              u[QB * (m0 + b) + i] = order_key(
                  staging[b * QB * QB * G + group * QB * G + i * G + t]);
          __syncthreads();
        }
      }
    }
    if (!vec && q < nq) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int pos = t + G * j;
        u[j] = pos < w ? order_key(__ldg(scores + q * s_q +
                                         (long long)(off + pos) * s_c))
                       : 0u;
      }
    }
    if (q < nq) {
      // rounds alternate the two buffers: carry in one, survivors to the
      // other
      unsigned long long* carry = buf + (rounds % 2 == 1 ? 0 : width);
      unsigned long long* dest =
          buf + (nbuf == 2 && rounds % 2 == 1 ? width : 0);
      radix_select<KPT>(u, w, off, carry, nc, k, dest, hist, st, bar);
    }
    nc = k;
  }
  if (q >= nq) return;
  unsigned long long* top =
      buf + (nbuf == 2 && (rounds - 1) % 2 == 1 ? width : 0);
  for (int j = k + t; j < width; j += G) top[j] = 0;  // below every key
  group_sync(bar);
  if (p <= 2 * G)
    sort512_desc(top, bar);
  else
    sort_desc(top, p, bar);
  for (int j = t; j < k; j += G) out(q, j, top[j]);
}

template <int QB, int KPT, class Out>
int launch(const float* scores, int nq, int c, int k, int p, int window,
           long long s_q, long long s_c, const Out& out, cudaStream_t stream) {
  const int smem = smem_bytes(QB, p, window < c ? 2 : 1);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      select_topk<QB, KPT, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  select_topk<QB, KPT, Out><<<(nq + QB - 1) / QB, QB * G, smem, stream>>>(
      scores, nq, c, k, p, window, s_q, s_c, out);
  return (int)cudaGetLastError();
}

template <int QB, class Out>
int launch_kpt(int kpt, const float* scores, int nq, int c, int k, int p,
               int window, long long s_q, long long s_c, const Out& out,
               cudaStream_t st) {
  // the plans: 4 queries a block with 8-32 keys a thread; 2 with 64; 1
  // with 32 or 64 (survivors too many for more queries, or a window of
  // 16384)
  if constexpr (QB == 4) {
    if (kpt == 8)
      return launch<QB, 8>(scores, nq, c, k, p, window, s_q, s_c, out, st);
    if (kpt == 16)
      return launch<QB, 16>(scores, nq, c, k, p, window, s_q, s_c, out, st);
  }
  if constexpr (QB != 2) {
    if (kpt == 32)
      return launch<QB, 32>(scores, nq, c, k, p, window, s_q, s_c, out, st);
  }
  if constexpr (QB != 4) {
    if (kpt == 64)
      return launch<QB, 64>(scores, nq, c, k, p, window, s_q, s_c, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// -- the global-memory mode: any k <= C ----------------------------------------

constexpr int LARGE_THREADS = 1024;   // a block of the row and sort kernels
constexpr int LARGE_RUN = 16384;      // survivors a run sorted in shared memory
constexpr int LARGE_TILE = 32;        // the key copy's square tile

// (1) Keys of candidate-major scores (q, c), rows q < nqc, into keys[q * c
// + c] as order keys: a 32 x 32 tile read along the queries (the source's
// contiguous axis) and written along the row, 32 x 8 threads, four
// elements each. A row-major source needs no copy: (2) reads it in place.
constexpr int TILE_ROWS = 8;
__global__ void __launch_bounds__(LARGE_TILE * TILE_ROWS)
    select_large_keys(const float* __restrict__ scores, int nqc, int c,
                      long long s_c, unsigned int* __restrict__ keys) {
  __shared__ unsigned int tile[LARGE_TILE][LARGE_TILE + 1];  // [col][row]
  const int tx = threadIdx.x % LARGE_TILE, ty = threadIdx.x / LARGE_TILE;
  const long long c0 = (long long)blockIdx.x * LARGE_TILE;
  const int r0 = blockIdx.y * LARGE_TILE;
#pragma unroll
  for (int j = ty; j < LARGE_TILE; j += TILE_ROWS)
    if (r0 + tx < nqc && c0 + j < c)
      tile[j][tx] = order_key(__ldg(scores + r0 + tx + (c0 + j) * s_c));
  __syncthreads();
#pragma unroll
  for (int j = ty; j < LARGE_TILE; j += TILE_ROWS)
    if (r0 + j < nqc && c0 + tx < c)
      keys[(long long)(r0 + j) * c + c0 + tx] = tile[tx][j];
}

// A row's order keys: from a row-major source in place (IN_PLACE: the
// scores, row stride s_q), else from the (rows, c) copy (1) made.
template <bool IN_PLACE>
struct RowKeys {
  const void* base;
  long long s_q;
  __device__ __forceinline__ unsigned int operator()(int row, int c,
                                                     int i) const {
    if constexpr (IN_PLACE)
      return order_key(
          __ldg(static_cast<const float*>(base) + row * s_q + i));
    else
      return static_cast<const unsigned int*>(base)[(long long)row * c + i];
  }
};

// (2) One block a row: the radix selection of `radix_select` over the
// row's keys in device memory, then the k keys at or above the prefix into
// surv[row * p, +k) in no order and 0 in the row's other p - k slots.
template <class Src>
__global__ void __launch_bounds__(LARGE_THREADS)
    select_large_rows(Src src, int c, int k, int p,
                      unsigned long long* __restrict__ surv) {
  __shared__ int hist[HIST_BINS];
  __shared__ GroupState st;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int row = blockIdx.x;
  unsigned long long* out = surv + (long long)blockIdx.x * p;
  Prefix pre{0u, 0u, 0u, 0u};
  int remaining = k;
  for (int shift = 64;;) {
    // 11 / 11 / 10 bits of each word
    const int bits = (shift == 42 || shift == 10) ? 10 : 11;
    shift -= bits;
    const int bins = 1 << bits;
    const bool high = shift >= 32;
    const int s = high ? shift - 32 : shift;
    for (int b = t; b < bins; b += LARGE_THREADS) hist[b] = 0;
    __syncthreads();
    // four loads in flight a thread before their counts
    for (int i0 = t; i0 < c; i0 += 4 * LARGE_THREADS) {
      unsigned int h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * LARGE_THREADS;
        h[u] = i < c ? src(row, c, i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * LARGE_THREADS;
        const unsigned int l = low_word(i);
        if (i < c && pre.matches(h[u], l))
          atomicAdd(hist + (((high ? h[u] : l) >> s) & (bins - 1)), 1);
      }
    }
    __syncthreads();
    if (t < 32) find_bin(hist, bins, remaining, lane, &st);
    __syncthreads();
    if (high) {
      pre.hi |= (unsigned int)st.bin << s;
      pre.mask_hi |= (unsigned int)(bins - 1) << s;
    } else {
      pre.lo |= (unsigned int)st.bin << s;
      pre.mask_lo |= (unsigned int)(bins - 1) << s;
    }
    remaining = st.remaining;
    // every key left in the bin is needed (always so at the last bits)
    if (st.bin_count == remaining || shift == 0) break;
  }
  __syncthreads();
  if (t == 0) st.filled = 0;
  __syncthreads();
  // the whole block walks the row in steps of its width, so every lane of
  // a warp takes part in its ballot
  for (int i0 = 0; i0 < c; i0 += LARGE_THREADS) {
    const int i = i0 + t;
    unsigned int h = 0u, l = 0u;
    bool take = false;
    if (i < c) {
      h = src(row, c, i);
      l = low_word(i);
      take = pre.at_or_above(h, l);
    }
    const unsigned int mask = __ballot_sync(0xFFFFFFFFu, take);
    int base = 0;
    if (lane == 0 && mask != 0u) base = atomicAdd(&st.filled, __popc(mask));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (take)
      out[base + __popc(mask & ((1u << lane) - 1u))] =
          ((unsigned long long)h << 32) | l;
  }
  for (int j = k + t; j < p; j += LARGE_THREADS) out[j] = 0ull;
}

// (3) Runs of LARGE_RUN survivors in shared memory: the bitonic network's
// sizes size_from..size_to, each at its strides below LARGE_RUN, each
// pair's direction from its place in the row's p. A thread holds 16
// consecutive keys in registers, where the strides below 16 run with no
// barrier; the larger strides run in shared memory, one key in 17 a pad so
// a thread's 16 keys sit in other banks than its neighbours'.
constexpr int SORT_E = LARGE_RUN / LARGE_THREADS;  // 16 keys a thread

__host__ __device__ constexpr int padded(int i) { return i + (i >> 4); }

// The steps of `size` at strides STRIDE, STRIDE / 2, ..., 1 on a thread's
// keys v, at row positions g0 + j.
template <int STRIDE>
__device__ __forceinline__ void register_steps(
    unsigned long long (&v)[SORT_E], int g0, int size) {
  if constexpr (STRIDE >= 1) {
#pragma unroll
    for (int j = 0; j < SORT_E; ++j) {
      if ((j & STRIDE) == 0) {
        const bool desc = ((g0 + j) & size) == 0;
        const unsigned long long a = v[j], b = v[j + STRIDE];
        if ((a < b) == desc) {
          v[j] = b;
          v[j + STRIDE] = a;
        }
      }
    }
    register_steps<STRIDE / 2>(v, g0, size);
  }
}

__global__ void __launch_bounds__(LARGE_THREADS)
    select_large_sort(unsigned long long* __restrict__ surv, int p,
                      int size_from, int size_to) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s = reinterpret_cast<unsigned long long*>(smem);
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * LARGE_RUN;
  const int first = (int)(blockIdx.x % (unsigned)(p / LARGE_RUN)) * LARGE_RUN;
  const int g0 = first + t * SORT_E;
  for (int i = t; i < LARGE_RUN; i += LARGE_THREADS)
    s[padded(i)] = surv[base + i];
  __syncthreads();
  unsigned long long v[SORT_E];
#pragma unroll
  for (int j = 0; j < SORT_E; ++j) v[j] = s[padded(t * SORT_E + j)];
  for (int size = size_from; size <= size_to; size <<= 1) {
    if (size > SORT_E) {
      // the strides of 16 and more, through shared memory
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SORT_E; ++j) s[padded(t * SORT_E + j)] = v[j];
      __syncthreads();
      for (int stride = (size < LARGE_RUN ? size : LARGE_RUN) >> 1;
           stride >= SORT_E; stride >>= 1) {
        for (int i = t; i < LARGE_RUN / 2; i += LARGE_THREADS) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const bool desc = ((first + lo) & size) == 0;
          const unsigned long long a = s[padded(lo)], b = s[padded(hi)];
          if ((a < b) == desc) {
            s[padded(lo)] = b;
            s[padded(hi)] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < SORT_E; ++j) v[j] = s[padded(t * SORT_E + j)];
    }
    switch (size) {  // the strides below 16, in registers
      case 2:
        register_steps<1>(v, g0, size);
        break;
      case 4:
        register_steps<2>(v, g0, size);
        break;
      case 8:
        register_steps<4>(v, g0, size);
        break;
      default:
        register_steps<8>(v, g0, size);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SORT_E; ++j) s[padded(t * SORT_E + j)] = v[j];
  __syncthreads();
  for (int i = t; i < LARGE_RUN; i += LARGE_THREADS)
    surv[base + i] = s[padded(i)];
}

// (4) One stride (>= LARGE_RUN) of the network's merge of `size` over each
// of the rows' p survivors.
__global__ void __launch_bounds__(LARGE_THREADS)
    select_large_merge(unsigned long long* __restrict__ surv, int nqc, int p,
                       int size, int stride) {
  const long long half = p / 2;
  const long long pairs = (long long)nqc * half;
  for (long long x = (long long)blockIdx.x * LARGE_THREADS + threadIdx.x;
       x < pairs; x += (long long)gridDim.x * LARGE_THREADS) {
    const long long r = x / half;
    const int i = (int)(x % half);
    const int lo = 2 * i - (i & (stride - 1));
    const int hi = lo + stride;
    const bool desc = (lo & size) == 0;
    unsigned long long* row = surv + r * p;
    const unsigned long long a = row[lo], b = row[hi];
    if ((a < b) == desc) {
      row[lo] = b;
      row[hi] = a;
    }
  }
}

// (5) The epilogue over the first k sorted survivors of each row.
template <class Out>
__global__ void __launch_bounds__(LARGE_THREADS)
    select_large_emit(const unsigned long long* __restrict__ surv, int q0,
                      int nqc, int k, int p, Out out) {
  const long long n = (long long)nqc * k;
  for (long long x = (long long)blockIdx.x * LARGE_THREADS + threadIdx.x;
       x < n; x += (long long)gridDim.x * LARGE_THREADS) {
    const int r = (int)(x / k), j = (int)(x % k);
    out(q0 + r, j, surv[(long long)r * p + j]);
  }
}

__host__ inline int large_blocks(long long items) {
  const long long b = (items + LARGE_THREADS - 1) / LARGE_THREADS;
  return (int)(b < (1 << 20) ? (b > 0 ? b : 1) : (1 << 20));
}

// The global-memory mode: the top k of each of nq queries over c scores,
// any 1 <= k <= c, p the power of two >= k and >= LARGE_RUN (the mode
// serves k above 8192); in chunks of
// q_chunk queries through the caller's scratch: keys (q_chunk, c) u32 and
// surv (q_chunk, p) u64.
template <class Out>
int launch_select_large(const float* scores, int nq, int c, int k, int p,
                        long long s_q, long long s_c, unsigned int* keys,
                        unsigned long long* surv, int q_chunk,
                        const Out& out, cudaStream_t st) {
  // a source of strides other than row-major (s_c 1) or candidate-major
  // (s_q 1) is not taken
  if (nq <= 0 || c <= 0 || k <= 0 || k > c || k > p || p < LARGE_RUN ||
      (p & (p - 1)) != 0 || surv == nullptr || q_chunk <= 0 ||
      q_chunk > 65535 * LARGE_TILE || (s_c != 1 && s_q != 1) ||
      (s_c != 1 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const int sort_smem = padded(LARGE_RUN) * 8;
  cudaError_t e = cudaFuncSetAttribute(
      select_large_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sort_smem);
  if (e != cudaSuccess) return (int)e;
  for (int q0 = 0; q0 < nq; q0 += q_chunk) {
    const int nqc = nq - q0 < q_chunk ? nq - q0 : q_chunk;
    if (s_c != 1) {  // candidate-major (B3's winners): the row-major copy
      select_large_keys<<<
          dim3((unsigned)((c + LARGE_TILE - 1) / LARGE_TILE),
               (unsigned)((nqc + LARGE_TILE - 1) / LARGE_TILE)),
          LARGE_TILE * TILE_ROWS, 0, st>>>(scores + q0 * s_q, nqc, c, s_c,
                                           keys);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      select_large_rows<<<nqc, LARGE_THREADS, 0, st>>>(
          RowKeys<false>{keys, 0}, c, k, p, surv);
    } else {
      select_large_rows<<<nqc, LARGE_THREADS, 0, st>>>(
          RowKeys<true>{scores + q0 * s_q, s_q}, c, k, p, surv);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const unsigned runs = (unsigned)((long long)nqc * (p / LARGE_RUN));
    select_large_sort<<<runs, LARGE_THREADS, sort_smem, st>>>(surv, p, 2,
                                                              LARGE_RUN);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int size = 2 * LARGE_RUN; size <= p; size <<= 1) {
      for (int stride = size / 2; stride >= LARGE_RUN; stride >>= 1) {
        select_large_merge<<<large_blocks((long long)nqc * (p / 2)),
                             LARGE_THREADS, 0, st>>>(surv, nqc, p, size,
                                                     stride);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      }
      select_large_sort<<<runs, LARGE_THREADS, sort_smem, st>>>(
          surv, p, size, size);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    select_large_emit<Out><<<large_blocks((long long)nqc * k), LARGE_THREADS,
                             0, st>>>(surv, q0, nqc, k, p, out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The top k of each of nq queries over c scores at the given element
// strides into the epilogue `out`: 1 <= k <= c; p a power of two, k <= p.
// In shared memory (qb 1, 2 or 4): window = c when c <= 16384, else 16384
// with 2k <= window (the carry and a window both fit); qb 1 when windowed;
// kpt keys a thread with window <= 256 * kpt: 8, 16 or 32 for qb 4, 64 for
// qb 2, 32 or 64 for qb 1. qb 0: the global-memory mode, any k <= c, over
// the scratch `keys` and `surv` in chunks of q_chunk queries
// (`ops/bitonic_topk.py` `select_plan`).
template <class Out>
int launch_select(const float* scores, int nq, int c, int k, int p,
                  int window, int qb, int kpt, long long s_q, long long s_c,
                  unsigned int* keys, unsigned long long* surv, int q_chunk,
                  const Out& out, cudaStream_t st) {
  if (qb == 0)
    return launch_select_large(scores, nq, c, k, p, s_q, s_c, keys, surv,
                               q_chunk, out, st);
  if (nq <= 0 || c <= 0 || k <= 0 || k > c || k > p || p < 2 ||
      (p & (p - 1)) != 0 || window <= 0 || window > MAX_WINDOW ||
      window > c || window > G * kpt ||
      (window < c && (qb != 1 || 2 * k > window)))
    return (int)cudaErrorInvalidValue;
  switch (qb) {
    case 1:
      return launch_kpt<1>(kpt, scores, nq, c, k, p, window, s_q, s_c, out,
                           st);
    case 2:
      return launch_kpt<2>(kpt, scores, nq, c, k, p, window, s_q, s_c, out,
                           st);
    case 4:
      return launch_kpt<4>(kpt, scores, nq, c, k, p, window, s_q, s_c, out,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
