// Row-wise exact top-k selection for Hopper (sm_90a), written out through
// an epilogue the caller gives. Used by B5 (`bitonic_topk.cu`: scores and
// ids) and by B3's stage (b) (`mips_fused_topk.cu`: packed segment
// winners, decoded to scores and row ids).
//
// The order is total: score descending (the float's bits made to sort as an
// integer, so -inf < finite < +inf < NaN), then candidate position
// ascending, which is lax.top_k's order. The key of candidate i is the
// 64-bit (order key << 32 | ~position), all distinct, so the k-th largest
// key is one key, exactly k keys are >= it, and any exact selection equals
// the plain version bit for bit.
//
// Three paths, by (C, k) (`ops/bitonic_topk.py` `select_plan`):
//  * one window, C <= 16384 (`select_topk`; B5's first redesign). 256
//    threads take a query, each holding up to 64 of its scores in
//    registers as 32-bit order keys; a block takes 4 queries while a thread
//    holds at most 32 keys (a candidate-major row read as one 16- or 8-byte
//    vector a candidate and handed out through shared memory), else 2 or 1.
//    A radix selection: the top 11 bits of every key into 2048 shared bins,
//    later 8-bit digits of the keys that share the prefix so far, a warp
//    walking the bins from the top (`find_bin`), until the bin of the k-th
//    key holds exactly the keys still needed; then the k survivors placed
//    with one shared atomic a warp, sorted (a bitonic network, registers
//    and shuffles up to 512 keys, shared memory beyond) and handed out.
//  * the streaming path, C > 16384 while 2k <= 16384 (`select_stream`).
//    The row streams through registers, 8 or 16 scores a thread a tile, the
//    next tile's loads in flight while this one is filtered. Each query keeps a
//    buffer of `cap` keys in shared memory and a threshold: the k-th
//    largest key kept so far (0, below every key, before the first k, so
//    the first `cap` keys are a sample of the row whose k-th key bounds the
//    row's from below). A key above the threshold is appended by warp
//    ballot, one atomic a warp; a buffer that fills keeps its k largest in
//    place (`keep_largest`: the radix passes of `narrow`, then an in-order
//    compaction), the least of them the new threshold, and the keys that
//    found no slot are offered again: exact under any order, each refill
//    at least cap - k keys after the last. At k = 93 over N(0, 1) rows of
//    125,000 the buffer fills once; later keys are rejected by one compare.
//    A candidate-major source (B3's winners) goes 4 adjacent queries a
//    block, so that a 32-byte sector is read by adjacent queries, not one
//    a block. The first design of this
//    regime loaded windows of 16384 keys into registers and ran full radix
//    passes over every window with the carried k (8.5 ms at 8192 rows x
//    125,000, k = 93; PERF.md).
//  * the global-memory mode, C > 16384 at k above 8192 (`select_large_*`),
//    in chunks of queries through the caller's scratch (`large_layout`):
//    (1) the first digit (11 bits) of every score into each row's
//    histogram, 8 adjacent rows a block of a candidate-major source (whole
//    sectors), the rows split over enough blocks to fill the card; (2) a
//    warp a row finds the bin of the k-th key; (3) a second read sends each
//    key above that bin straight to the row's survivors and each key in it
//    to the row's bin buffer; (4) a block a row keeps the bin's keys still
//    needed: levels of (histogram, split) over the buffer in device memory
//    while it holds more than 12,288 keys, then `narrow` in shared memory;
//    (5) the k survivors sorted in runs of 16384, 16 keys a thread sorted in
//    registers and merged pairwise in shared memory by merge-path searches,
//    with no padding to a power of two; past one run (6, 7) merge-path
//    merges in device memory, the last into the epilogue. Each score is read
//    twice. The first design read a row 4-5 times for its radix passes
//    and sorted the survivors padded to a power of two with the bitonic
//    network (2.5 ms at (1024, 131,072), k = 10,000; PERF.md).
// A persistent grid that asked L2 for the next query set's scores while
// selecting the current one was tried on the single window and was slower.

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
// in no order, of the c keys (order key u[j], position t + G*j). All G
// threads of the query (barrier `bar`). Keys are compared as their two
// 32-bit words, the low one (~position) recomputed where needed, so a
// thread keeps KPT registers of keys.
template <int KPT>
__device__ __forceinline__ void radix_select(
    const unsigned int (&u)[KPT], int c, int k, unsigned long long* out,
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
      const unsigned int lo = low_word(pos);
      if (pos < c && pre.matches(u[j], lo))
        atomicAdd(hist + (((high ? u[j] : lo) >> s) & (bins - 1)), 1);
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
    mine += pos < c && pre.at_or_above(u[j], low_word(pos));
  }
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
    const unsigned int lo = low_word(pos);
    if (pos < c && pre.at_or_above(u[j], lo))
      out[slot++] = ((unsigned long long)u[j] << 32) | lo;
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
// and a buffer of max(p, 512) 64-bit keys.
constexpr int MAX_BATCH = 2;
__host__ __device__ constexpr int staging_bytes(int qb) {
  return qb > 1 ? MAX_BATCH * qb * qb * G * 4 : 0;
}
__host__ __device__ constexpr int group_bytes(int p) {
  return HIST_BINS * 4 + 32 + (p > 2 * G ? p : 2 * G) * 8;
}
__host__ __device__ constexpr int smem_bytes(int qb, int p) {
  return staging_bytes(qb) + qb * group_bytes(p);
}

// Grid (ceil(nq / QB)), QB * G threads. Score (q, c) at scores[q * s_q +
// c * s_c], c <= G * KPT; the j-th largest key of query q goes to out(q, j,
// key), the caller's epilogue (its score `key_score`, its position
// `key_position`). p a power of two >= k.
template <int QB, int KPT, class Out>
__global__ void __launch_bounds__(QB * G)
    select_topk(const float* __restrict__ scores, int nq, int c, int k,
                int p, long long s_q, long long s_c, Out out) {
  static_assert(KPT % QB == 0, "a vector load feeds QB keys a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = max(p, 2 * G);  // a buffer: p keys, 512 at least
  const int group = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int bar = 1 + group;
  const int q0 = blockIdx.x * QB;
  const int q = q0 + group;
  float* staging = reinterpret_cast<float*>(smem);
  unsigned char* gmem = smem + staging_bytes(QB) + group * group_bytes(p);
  int* hist = reinterpret_cast<int*>(gmem);
  GroupState* st = reinterpret_cast<GroupState*>(gmem + HIST_BINS * 4);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(gmem + HIST_BINS * 4 + 32);
  const bool vec = QB > 1 && s_q == 1 && q0 + QB <= nq && s_c % QB == 0 &&
                   (reinterpret_cast<uintptr_t>(scores + q0) %
                    (QB * sizeof(float))) == 0;
  unsigned int u[KPT];
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
          v[b] = r < c ? __ldg(reinterpret_cast<const V*>(
                             scores + q0 + (long long)r * s_c))
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
      u[j] = pos < c ? order_key(__ldg(scores + q * s_q + (long long)pos * s_c))
                     : 0u;
    }
  }
  if (q >= nq) return;
  unsigned long long* top = buf;
  radix_select<KPT>(u, c, k, top, hist, st, bar);
  for (int j = k + t; j < width; j += G) top[j] = 0;  // below every key
  group_sync(bar);
  if (p <= 2 * G)
    sort512_desc(top, bar);
  else
    sort_desc(top, p, bar);
  for (int j = t; j < k; j += G) out(q, j, top[j]);
}

template <int QB, int KPT, class Out>
int launch(const float* scores, int nq, int c, int k, int p, long long s_q,
           long long s_c, const Out& out, cudaStream_t stream) {
  const int smem = smem_bytes(QB, p);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      select_topk<QB, KPT, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  select_topk<QB, KPT, Out><<<(nq + QB - 1) / QB, QB * G, smem, stream>>>(
      scores, nq, c, k, p, s_q, s_c, out);
  return (int)cudaGetLastError();
}

template <int QB, class Out>
int launch_kpt(int kpt, const float* scores, int nq, int c, int k, int p,
               long long s_q, long long s_c, const Out& out,
               cudaStream_t st) {
  // the plans: 4 queries a block with 8-32 keys a thread; 2 with 64; 1
  // with 32 or 64 (survivors too many for more queries)
  if constexpr (QB == 4) {
    if (kpt == 8)
      return launch<QB, 8>(scores, nq, c, k, p, s_q, s_c, out, st);
    if (kpt == 16)
      return launch<QB, 16>(scores, nq, c, k, p, s_q, s_c, out, st);
  }
  if constexpr (QB != 2) {
    if (kpt == 32)
      return launch<QB, 32>(scores, nq, c, k, p, s_q, s_c, out, st);
  }
  if constexpr (QB != 4) {
    if (kpt == 64)
      return launch<QB, 64>(scores, nq, c, k, p, s_q, s_c, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// -- pieces shared by the streaming path and the global-memory mode -----------

constexpr unsigned int FULL = 0xFFFFFFFFu;
constexpr int KEEP_R = 2;       // rows of a block's keys a chunk of `compact`

__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}

// A score read that asks L2 for its whole 128-byte line: a 4-query block
// of a candidate-major source reads 16 bytes of each line, and the blocks
// of the neighbouring queries then find theirs in L2.
__device__ __forceinline__ float ldg_line(const float* p) {
  float v;
  asm("ld.global.nc.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The 64-bit key of order key u at candidate position pos.
__device__ __forceinline__ unsigned long long full_key(unsigned int u,
                                                       int pos) {
  return ((unsigned long long)u << 32) | low_word(pos);
}

// The digit after the one ending at bit `shift`: 11 bits, 10 where a word
// ends (11 / 11 / 10 of each 32-bit word).
__device__ __forceinline__ int wide_bits(int shift) {
  return min(11, shift > 32 ? shift - 32 : shift);
}

// Narrow `pre` digit by digit from bit `shift` down over the keys get(i),
// i < n, that match it, until the bin of the `remaining`-th largest of them
// holds exactly the keys still needed (always so at the last bit: the keys
// are distinct). Every thread of a block of THREADS.
template <int THREADS, class Get>
__device__ void narrow(Get get, int n, Prefix& pre, int& shift,
                       int& remaining, int* hist, GroupState* st) {
  const int t = threadIdx.x;
  for (;;) {
    const int bits = wide_bits(shift);
    shift -= bits;
    const int bins = 1 << bits;
    const bool high = shift >= 32;
    const int s = high ? shift - 32 : shift;
    for (int b = t; b < bins; b += THREADS) hist[b] = 0;
    __syncthreads();
    for (int i = t; i < n; i += THREADS) {
      const unsigned long long x = get(i);
      const unsigned int h = (unsigned int)(x >> 32), l = (unsigned int)x;
      if (pre.matches(h, l))
        atomicAdd(hist + (((high ? h : l) >> s) & (bins - 1)), 1);
    }
    __syncthreads();
    if (t < 32) find_bin(hist, bins, remaining, t, st);
    __syncthreads();
    if (high) {
      pre.hi |= (unsigned int)st->bin << s;
      pre.mask_hi |= (unsigned int)(bins - 1) << s;
    } else {
      pre.lo |= (unsigned int)st->bin << s;
      pre.mask_lo |= (unsigned int)(bins - 1) << s;
    }
    const bool done = st->bin_count == st->remaining || shift == 0;
    remaining = st->remaining;
    __syncthreads();  // st read by every thread before it is written again
    if (done) return;
  }
}

// Put `key` (where `take`) at the next slot of `dst` from the counter
// `cursor`, one atomic for the lanes of the warp in `lanes` that take;
// false where its slot is `cap` or more (the key is not written). Every
// lane of the warp calls it.
__device__ __forceinline__ bool place(bool take, unsigned long long key,
                                      unsigned long long* dst, int* cursor,
                                      int cap, unsigned int lanes) {
  const int lane = threadIdx.x % 32;
  const unsigned int all = __ballot_sync(FULL, take);
  if (all == 0u) return true;
  const unsigned int mine = all & lanes;
  const int leader = __ffs(mine) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor, __popc(mine));
  base = __shfl_sync(FULL, base, leader >= 0 ? leader : lane);
  if (!take) return true;
  const int slot = base + __popc(mine & ((1u << lane) - 1u));
  if (slot >= cap) return false;
  dst[slot] = key;
  return true;
}

// Keep, in place and in their order, the keys of a[0, n) for which
// `keep(x, true)` holds at a[0, m), m their count; returns m. Every lane
// calls keep, past n with (0, false). The block's THREADS threads;
// `counts` KEEP_R * THREADS / 32 ints of shared scratch. A key moves only
// to a lower index, once every key of its chunk was read.
template <int THREADS, class Keep>
__device__ int compact(unsigned long long* a, int n, Keep keep, int* counts) {
  constexpr int W = THREADS / 32;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  int filled = 0;
  for (int base = 0; base < n; base += THREADS * KEEP_R) {
    unsigned long long x[KEEP_R];
    unsigned int ball[KEEP_R];
#pragma unroll
    for (int r = 0; r < KEEP_R; ++r) {
      const int i = base + r * THREADS + t;
      x[r] = i < n ? a[i] : 0ull;
      ball[r] = __ballot_sync(FULL, keep(x[r], i < n));
      if (lane == 0) counts[r * W + warp] = __popc(ball[r]);
    }
    __syncthreads();
    int off[KEEP_R], total = 0;
#pragma unroll
    for (int r = 0; r < KEEP_R; ++r) off[r] = 0;
    for (int s = 0; s < KEEP_R * W; ++s) {
      const int v = counts[s];
#pragma unroll
      for (int r = 0; r < KEEP_R; ++r)
        if (s < r * W + warp) off[r] += v;
      total += v;
    }
    __syncthreads();  // counts read before the next chunk writes them
    const unsigned int below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < KEEP_R; ++r)
      if ((ball[r] >> lane) & 1u)
        a[filled + off[r] + __popc(ball[r] & below)] = x[r];
    filled += total;
  }
  __syncthreads();
  return filled;
}

// -- the streaming path: past one window while 2k <= 16384 --------------------

// A streaming block: QB queries (1, or 4 adjacent ones of a candidate-major
// source, so that a 32-byte sector is read by adjacent queries), THREADS
// threads, U scores a thread a tile: one query 256 threads loading 8, four
// blocks an SM in 64 registers a thread; 4 queries 512 threads loading 16,
// a block an SM (108 registers a thread).
// Either way two tiles in registers keep ~32 KB of loads in flight an SM.
template <int QB>
struct Stream {
  static constexpr int THREADS = QB == 1 ? G : 2 * G;
  static constexpr int U = QB == 1 ? 8 : 16;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int STEP = THREADS / QB;  // candidates of a query a load
  static constexpr int TILE = STEP * U;      // candidates of a query a tile
};

// Shared memory of a streaming block ahead of its QB buffers of `cap`
// keys: the histogram and its state, the compaction's counts, the warps'
// least keys, each query's threshold and fill, and the scores of a tile
// that found no slot.
__host__ __device__ constexpr int stream_fixed_bytes(int qb) {
  return HIST_BINS * 4 + 32 +
         (KEEP_R * 4 + 8) * ((qb == 1 ? G : 2 * G) / 32) + qb * 16 +
         (qb == 1 ? G * 8 : 2 * G * 16) * 4;
}

// The lanes of a warp that load query 0 of a block of QB queries (lane %
// QB is the query).
template <int QB>
__host__ __device__ constexpr unsigned int query_lanes() {
  unsigned int m = 0u;
  for (int i = 0; i < 32; i += QB) m |= 1u << i;
  return m;
}

// Move the k largest of a[0, n) (n > k) to a[0, k), in their order, and
// return the smallest of them: the k-th largest. Every thread of a block of
// THREADS.
template <int THREADS>
__device__ unsigned long long keep_largest(unsigned long long* a, int n,
                                           int k, int* hist, GroupState* st,
                                           int* counts,
                                           unsigned long long* least_w) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  Prefix pre{0u, 0u, 0u, 0u};
  int shift = 64, remaining = k;
  narrow<THREADS>([a](int i) { return a[i]; }, n, pre, shift, remaining,
                  hist, st);
  unsigned long long least = ~0ull;
  compact<THREADS>(a, n,
                   [&](unsigned long long x, bool valid) {
                     const bool in = valid && pre.at_or_above(
                                                  (unsigned int)(x >> 32),
                                                  (unsigned int)x);
                     if (in) least = min64(least, x);
                     return in;
                   },
                   counts);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    least = min64(least, __shfl_xor_sync(FULL, least, d));
  if (lane == 0) least_w[warp] = least;
  __syncthreads();
  unsigned long long kth = least_w[0];
  for (int w = 1; w < THREADS / 32; ++w) kth = min64(kth, least_w[w]);
  __syncthreads();
  return kth;
}

// Grid (ceil(nq / QB)), Stream<QB>::THREADS threads. Score (q, c) at
// scores[q * s_q + c * s_c]. Each thread holds U scores
// of a tile in registers while the next tile's loads are in flight. A key
// above its query's threshold (the k-th largest key kept so far; 0, below
// every key, before the first k) goes to the query's buffer of `cap` keys
// in shared memory (one atomic a warp and query). A buffer that fills keeps
// its k largest (`keep_largest`), whose least becomes the threshold, and
// the keys that found no slot (parked in shared memory meanwhile) are
// offered again. At the end each query keeps its k largest, sorts them (p a
// power of two >= k, cap >= max(p, 512); the first 256 threads) and hands
// them to out(q, j, key).
template <int QB, class Out>
__global__ void __launch_bounds__(Stream<QB>::THREADS, QB == 1 ? 4 : 1)
    select_stream(const float* __restrict__ scores, int nq, int c, int k,
                  int p, int cap, long long s_q, long long s_c, Out out) {
  using S = Stream<QB>;
  constexpr int THREADS = S::THREADS, U = S::U, STEP = S::STEP;
  constexpr int TILE = S::TILE, W = S::WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  GroupState* st = reinterpret_cast<GroupState*>(smem + HIST_BINS * 4);
  int* counts = reinterpret_cast<int*>(smem + HIST_BINS * 4 + 32);
  unsigned long long* least =
      reinterpret_cast<unsigned long long*>(counts + KEEP_R * W);
  unsigned long long* thr = least + W;
  int* fill = reinterpret_cast<int*>(thr + QB);
  float* parked = reinterpret_cast<float*>(fill + 2 * QB);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + stream_fixed_bytes(QB));
  const int t = threadIdx.x;
  const int j = t % QB, cc = t / QB;
  const int q0 = blockIdx.x * QB;
  const bool live = q0 + j < nq;
  // a query past nq reads the block's first row and keeps nothing
  const float* row = scores + (long long)(live ? q0 + j : q0) * s_q;
  const long long step = (long long)STEP * s_c;
  unsigned long long* buf = keys + (long long)j * cap;
  const unsigned int lanes = query_lanes<QB>() << j;
  auto load = [&](float (&v)[U], int first) {
    const float* a = row + (long long)first * s_c;
    auto ld = [](const float* x) { return QB > 1 ? ldg_line(x) : __ldg(x); };
    if (first + (U - 1) * STEP < c) {
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = ld(a + u * step);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = first + u * STEP < c ? ld(a + u * step) : 0.f;
    }
  };
  if (t < QB) {
    thr[t] = 0ull;
    fill[t] = 0;
  }
  __syncthreads();
  float cur[U], next[U];
  load(cur, cc);
  for (int c0 = 0; c0 < c; c0 += TILE) {
    if (c0 + TILE < c) load(next, c0 + TILE + cc);
    unsigned long long bound = thr[j];
    // bit u: key u above the threshold (compared as two words; most keys
    // fail on the first), then: key u found no slot
    unsigned int above = 0u, left = 0u;
    {
      const unsigned int bh = (unsigned int)(bound >> 32);
      const unsigned int bl = (unsigned int)bound;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = c0 + cc + STEP * u;
        const unsigned int o = order_key(cur[u]);
        if (live && pos < c && (o > bh || (o == bh && low_word(pos) > bl)))
          above |= 1u << u;
      }
    }
    if (__any_sync(FULL, above != 0u)) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool take = (above >> u) & 1u;
        const int pos = c0 + cc + STEP * u;
        if (!place(take, take ? full_key(order_key(cur[u]), pos) : 0ull, buf,
                   fill + j, cap, lanes)) {
          left |= 1u << u;
          parked[u * THREADS + t] = cur[u];
        }
      }
    }
    // a full buffer keeps its k largest and raises its threshold; the keys
    // that found no slot are offered again
    while (__syncthreads_or(left != 0u)) {
      for (int jj = 0; jj < QB; ++jj) {
        if (fill[jj] > cap) {
          const unsigned long long kth = keep_largest<THREADS>(
              keys + (long long)jj * cap, cap, k, hist, st, counts, least);
          if (t == 0) {
            thr[jj] = kth;
            fill[jj] = k;
          }
          __syncthreads();
        }
      }
      __syncthreads();  // every fill read before any is offered to again
      bound = thr[j];
      unsigned int again = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool was = (left >> u) & 1u;
        const unsigned long long key =
            was ? full_key(order_key(parked[u * THREADS + t]),
                           c0 + cc + STEP * u)
                : 0ull;
        if (!place(was && key > bound, key, buf, fill + j, cap, lanes))
          again |= 1u << u;
      }
      left = again;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
  }
  for (int jj = 0; jj < QB && q0 + jj < nq; ++jj) {
    unsigned long long* a = keys + (long long)jj * cap;
    const int n = fill[jj];
    if (n > k) keep_largest<THREADS>(a, n, k, hist, st, counts, least);
    for (int i = k + t; i < max(p, 2 * G); i += THREADS) a[i] = 0ull;
    __syncthreads();
    if (t < G) {
      if (p <= 2 * G)
        sort512_desc(a, 1);
      else
        sort_desc(a, p, 1);
      for (int i = t; i < k; i += G) out(q0 + jj, i, a[i]);
    }
  }
}

template <int QB, class Out>
int launch_stream(const float* scores, int nq, int c, int k, int p, int cap,
                  long long s_q, long long s_c, const Out& out,
                  cudaStream_t stream) {
  const long long smem = stream_fixed_bytes(QB) + (long long)QB * cap * 8;
  if (cap <= k || cap < p || cap < 2 * G || smem > SMEM_LIMIT ||
      (QB > 1 && s_q != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      select_stream<QB, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  select_stream<QB, Out>
      <<<(nq + QB - 1) / QB, Stream<QB>::THREADS, (int)smem, stream>>>(
          scores, nq, c, k, p, cap, s_q, s_c, out);
  return (int)cudaGetLastError();
}

// -- the global-memory mode: past one window at k above 8192 ------------------

constexpr int SPLIT_U = 8;          // keys a thread loads a step of (1), (3)
constexpr int REFINE_THREADS = 512; // a block of (4) and of a merge (7)
constexpr int REFINE_CAP = 12288;   // bin keys (4) holds in shared memory
constexpr int LARGE_THREADS = 1024; // a block of the run sort (5)
constexpr int LARGE_RUN = 16384;    // keys (5) sorts in shared memory
constexpr int SORT_E = 16;          // keys a thread of (5) holds
constexpr int MERGE_E = 8;          // keys a thread of (7) merges
constexpr int MERGE_TILE = REFINE_THREADS * MERGE_E;
constexpr int MAX_SPLITS = 8;       // blocks of (1) and (3) over one row
// a row's state in device memory: its threshold bin, the keys still needed
// from it, its count, the keys above it; then each split's first slots
// (above the bin, in it)
constexpr int STATE_INTS = 4 + 2 * MAX_SPLITS;

// Shared-memory index of key i: one slot in 17 a pad, so that a thread's
// consecutive keys sit in other banks than its neighbours'.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 4); }

// The scratch of a chunk of `rows` queries, at 256-byte aligned offsets:
// each split's first-digit histogram of each row (MAX_SPLITS x rows x
// HIST_BINS ints), each row's state, its threshold bin's keys (c u64), its
// k survivors (u64), past one run a second buffer of them and the merges'
// split points.
struct LargeLayout {
  long long hist, state, bins, surv, surv2, parts, bytes;
};

__host__ __device__ inline long long align256(long long x) {
  return (x + 255) / 256 * 256;
}

__host__ inline LargeLayout large_layout(long long rows, int c, int k) {
  LargeLayout l;
  const bool runs = k > LARGE_RUN;
  const long long tiles = (k + MERGE_TILE - 1) / MERGE_TILE;
  l.hist = 0;
  l.state = l.hist + align256(MAX_SPLITS * rows * HIST_BINS * 4);
  l.bins = l.state + align256(rows * STATE_INTS * 4);
  l.surv = l.bins + align256(rows * c * 8);
  l.surv2 = l.surv + align256(rows * k * 8);
  l.parts = l.surv2 + (runs ? align256(rows * k * 8) : 0);
  l.bytes = l.parts + (runs ? align256(rows * tiles * 4) : 0);
  return l;
}

// (1) The first digit (the top 11 bits of the order key) of every score
// into a histogram a row and split: grid (ceil(rows / QB), splits), G
// threads, QB rows a block (8 adjacent rows of a candidate-major source,
// whole sectors; 1 of a row-major one), each split `span` candidates; a
// shared histogram a row, written whole to hist[split][row].
template <int QB>
__global__ void __launch_bounds__(G)
    select_large_count(const float* __restrict__ scores, int rows, int c,
                       int span, long long s_q, long long s_c,
                       int* __restrict__ hist) {
  constexpr int STEP = G / QB;
  extern __shared__ int hists[];  // QB x HIST_BINS
  const int t = threadIdx.x, j = t % QB, cc = t / QB;
  const int r0 = blockIdx.x * QB;
  for (int i = t; i < QB * HIST_BINS; i += G) hists[i] = 0;
  __syncthreads();
  const bool live = r0 + j < rows;
  const float* row = scores + (long long)(live ? r0 + j : r0) * s_q;
  int* h = hists + j * HIST_BINS;
  const int from = blockIdx.y * span, to = min(c, from + span);
  for (int c0 = from; c0 < to; c0 += STEP * SPLIT_U) {
    float v[SPLIT_U];
#pragma unroll
    for (int u = 0; u < SPLIT_U; ++u) {
      const int pos = c0 + cc + STEP * u;
      v[u] = live && pos < to ? __ldg(row + pos * s_c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SPLIT_U; ++u)
      if (live && c0 + cc + STEP * u < to)
        atomicAdd(h + (order_key(v[u]) >> (32 - FIRST_BITS)), 1);
  }
  __syncthreads();
  int* dst = hist + ((long long)blockIdx.y * rows + r0) * HIST_BINS;
  for (int i = t; i < QB * HIST_BINS; i += G)
    if (r0 + i / HIST_BINS < rows) dst[i] = hists[i];
}

// (2) One block a row: the splits' histograms summed, the bin of the row's
// k-th key, the keys still needed from it, its count and the keys above it
// into the row's state, and each split's first slots among the keys above
// the bin and among the bin's (the splits in order), so that (3) places
// keys with shared atomics alone.
__global__ void __launch_bounds__(G)
    select_large_pick(const int* __restrict__ hist, int rows, int splits,
                      int k, int* __restrict__ state) {
  __shared__ int total[HIST_BINS];
  __shared__ GroupState st;
  __shared__ int part[MAX_SPLITS][G / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int row = blockIdx.x;
  // split s's histogram of the row at h + s * per_split
  const int* h = hist + (long long)row * HIST_BINS;
  const long long per_split = (long long)rows * HIST_BINS;
  for (int b = t; b < HIST_BINS; b += G) {
    int v = 0;
    for (int s = 0; s < splits; ++s) v += h[s * per_split + b];
    total[b] = v;
  }
  __syncthreads();
  if (t < 32) find_bin(total, HIST_BINS, k, lane, &st);
  __syncthreads();
  const int bin = st.bin;
  for (int s = 0; s < splits; ++s) {
    int above = 0;
    for (int b = bin + 1 + t; b < HIST_BINS; b += G)
      above += h[s * per_split + b];
    above = __reduce_add_sync(FULL, above);
    if (lane == 0) part[s][warp] = above;
  }
  __syncthreads();
  if (t == 0) {
    int* out = state + row * STATE_INTS;
    out[0] = bin;
    out[1] = st.remaining;
    out[2] = st.bin_count;
    out[3] = k - st.remaining;
    int above = 0, in = 0;
    for (int s = 0; s < splits; ++s) {
      out[4 + 2 * s] = above;
      out[5 + 2 * s] = in;
      for (int w = 0; w < G / 32; ++w) above += part[s][w];
      in += h[s * per_split + bin];
    }
  }
}

// (3) The second read, as (1) reads: each key above its row's threshold bin
// straight to the row's survivors, each key in that bin to the row's bin
// buffer, in no order, from the split's first slots (one shared atomic a
// warp and row).
template <int QB>
__global__ void __launch_bounds__(G)
    select_large_split(const float* __restrict__ scores, int rows, int c,
                       int k, int span, long long s_q, long long s_c,
                       int* __restrict__ state,
                       unsigned long long* __restrict__ bins,
                       unsigned long long* __restrict__ surv) {
  constexpr int STEP = G / QB;
  const int t = threadIdx.x, j = t % QB, cc = t / QB;
  const int r0 = blockIdx.x * QB;
  const bool live = r0 + j < rows;
  const int r = live ? r0 + j : r0;
  const float* row = scores + (long long)r * s_q;
  const int* s = state + r * STATE_INTS;
  __shared__ int cursor[QB][2];
  if (t < QB) {
    const int* sr = state + (r0 + t < rows ? r0 + t : r0) * STATE_INTS;
    cursor[t][0] = sr[4 + 2 * blockIdx.y];
    cursor[t][1] = sr[5 + 2 * blockIdx.y];
  }
  __syncthreads();
  const unsigned int bin = (unsigned int)s[0];
  unsigned long long* above = surv + (long long)r * k;
  unsigned long long* inbin = bins + (long long)r * c;
  const int lane = t % 32;
  const unsigned int lanes = query_lanes<QB>() << j;
  const int from = blockIdx.y * span, to = min(c, from + span);
  for (int c0 = from; c0 < to; c0 += STEP * SPLIT_U) {
    float v[SPLIT_U];
#pragma unroll
    for (int u = 0; u < SPLIT_U; ++u) {
      const int pos = c0 + cc + STEP * u;
      v[u] = live && pos < to ? __ldg(row + pos * s_c) : 0.f;
    }
    // the row's lanes that take key slot u, above the bin / in it; the
    // row's first lane takes both ranges with one shared atomic each, and
    // slot u's keys land contiguously (whole sectors)
    unsigned int bu[SPLIT_U], be[SPLIT_U];
    int nu = 0, ne = 0;
#pragma unroll
    for (int u = 0; u < SPLIT_U; ++u) {
      const unsigned int d = order_key(v[u]) >> (32 - FIRST_BITS);
      const bool in = live && c0 + cc + STEP * u < to;
      bu[u] = __ballot_sync(FULL, in && d > bin) & lanes;
      be[u] = __ballot_sync(FULL, in && d == bin) & lanes;
      nu += __popc(bu[u]);
      ne += __popc(be[u]);
    }
    int base_u = 0, base_e = 0;
    if (lane == j) {
      if (nu) base_u = atomicAdd(&cursor[j][0], nu);
      if (ne) base_e = atomicAdd(&cursor[j][1], ne);
    }
    base_u = __shfl_sync(FULL, base_u, j);
    base_e = __shfl_sync(FULL, base_e, j);
    const unsigned int below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < SPLIT_U; ++u) {
      const unsigned long long key =
          full_key(order_key(v[u]), c0 + cc + STEP * u);
      if ((bu[u] >> lane) & 1u) above[base_u + __popc(bu[u] & below)] = key;
      if ((be[u] >> lane) & 1u) inbin[base_e + __popc(be[u] & below)] = key;
      base_u += __popc(bu[u]);
      base_e += __popc(be[u]);
    }
  }
}

// (4) One block a row: the keys still needed from its threshold bin's
// buffer, appended to its survivors. While the bin holds more keys than
// shared memory does, a level in device memory: the next digit's histogram
// over the buffer, then its keys above that digit's bin to the survivors
// and the bin's to the buffer's front (two reads of the buffer); then the
// rest in shared memory (`narrow`) and the keys at or above the prefix.
__host__ __device__ constexpr int refine_fixed_bytes() {
  return HIST_BINS * 4 + 32 + KEEP_R * (REFINE_THREADS / 32) * 4 + 16;
}

__global__ void __launch_bounds__(REFINE_THREADS)
    select_large_refine(int c, int k, const int* __restrict__ state,
                        unsigned long long* __restrict__ bins,
                        unsigned long long* __restrict__ surv) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  GroupState* st = reinterpret_cast<GroupState*>(smem + HIST_BINS * 4);
  int* counts = reinterpret_cast<int*>(smem + HIST_BINS * 4 + 32);
  int* cursor = counts + KEEP_R * (REFINE_THREADS / 32);
  unsigned long long* held =
      reinterpret_cast<unsigned long long*>(smem + refine_fixed_bytes());
  const int t = threadIdx.x;
  const int row = blockIdx.x;
  const int* s = state + row * STATE_INTS;
  const unsigned int bin = (unsigned int)s[0];
  int remaining = s[1], n = s[2];
  unsigned long long* a = bins + (long long)row * c;
  unsigned long long* out = surv + (long long)row * k;
  Prefix pre{bin << (32 - FIRST_BITS), ~0u << (32 - FIRST_BITS), 0u, 0u};
  int shift = 64 - FIRST_BITS;
  if (t == 0) *cursor = s[3];
  __syncthreads();
  while (n > remaining && n > REFINE_CAP) {
    const int bits = wide_bits(shift);
    shift -= bits;
    const int nbins = 1 << bits;
    const bool high = shift >= 32;
    const int sh = high ? shift - 32 : shift;
    auto digit = [=](unsigned long long x) {
      return ((high ? (unsigned int)(x >> 32) : (unsigned int)x) >> sh) &
             (unsigned int)(nbins - 1);
    };
    for (int b = t; b < nbins; b += REFINE_THREADS) hist[b] = 0;
    __syncthreads();
    for (int i = t; i < n; i += REFINE_THREADS)
      atomicAdd(hist + digit(a[i]), 1);
    __syncthreads();
    if (t < 32) find_bin(hist, nbins, remaining, t, st);
    __syncthreads();
    const unsigned int d = (unsigned int)st->bin;
    const int need = st->remaining, count = st->bin_count;
    __syncthreads();
    if (high) {
      pre.hi |= d << sh;
      pre.mask_hi |= (unsigned int)(nbins - 1) << sh;
    } else {
      pre.lo |= d << sh;
      pre.mask_lo |= (unsigned int)(nbins - 1) << sh;
    }
    // the keys above the bin to the survivors, in no order; the bin's to
    // the front of the buffer
    compact<REFINE_THREADS>(
        a, n,
        [&](unsigned long long x, bool valid) {
          const unsigned int g = digit(x);
          place(valid && g > d, x, out, cursor, 0x7FFFFFFF, FULL);
          return valid && g == d;
        },
        counts);
    n = count;
    remaining = need;
  }
  if (n > remaining) {
    for (int i = t; i < n; i += REFINE_THREADS) held[i] = a[i];
    __syncthreads();
    narrow<REFINE_THREADS>([held](int i) { return held[i]; }, n, pre, shift,
                           remaining, hist, st);
    a = held;
  }
  // every key of a[0, n) at or above the prefix (all of them when the bin's
  // keys are all needed)
  for (int i0 = 0; i0 < n; i0 += REFINE_THREADS) {
    const int i = i0 + t;
    const unsigned long long x = i < n ? a[i] : 0ull;
    place(i < n && pre.at_or_above((unsigned int)(x >> 32), (unsigned int)x),
          x, out, cursor, 0x7FFFFFFF, FULL);
  }
}

// The count of keys from A among the first d of the descending merge of
// A = g(a0 + [0, na)) and B = g(b0 + [0, nb)) (an equal key from B first).
template <class Get>
__device__ __forceinline__ int merge_split(Get g, int a0, int na, int b0,
                                           int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int m = (lo + hi) / 2;
    if (g(a0 + m) > g(b0 + d - 1 - m))
      lo = m + 1;
    else
      hi = m;
  }
  return lo;
}

// E keys of the descending merge of A and B (as `merge_split`) from A[i],
// B[j] into v; the two heads in registers, one load a key.
template <int E, class Get>
__device__ __forceinline__ void merge_run(Get g, int a0, int na, int i,
                                          int b0, int nb, int j,
                                          unsigned long long (&v)[E]) {
  unsigned long long x = i < na ? g(a0 + i) : 0ull;
  unsigned long long y = j < nb ? g(b0 + j) : 0ull;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool from_a = j >= nb || (i < na && x > y);
    v[e] = from_a ? x : y;
    if (e + 1 < E) {
      i += from_a;
      j += !from_a;
      const bool more = from_a ? i < na : j < nb;
      const unsigned long long nx =
          more ? g(from_a ? a0 + i : b0 + j) : 0ull;
      if (from_a)
        x = nx;
      else
        y = nx;
    }
  }
}

// Sort v[0, SORT_E) descending: a bitonic network in registers.
__device__ __forceinline__ void sort16_desc(unsigned long long (&v)[SORT_E]) {
#pragma unroll
  for (int size = 2; size <= SORT_E; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < SORT_E; ++i) {
        const int o = i ^ stride;
        if (o > i) {
          const bool desc = (i & size) == 0;
          const unsigned long long x = v[i], y = v[o];
          if ((x < y) == desc) {
            v[i] = y;
            v[o] = x;
          }
        }
      }
}

// (5) One block of LARGE_THREADS a run of up to LARGE_RUN survivors (runs
// a row): its keys into shared memory (zeros, below every key, up to a
// multiple of 16), 16 a thread sorted in registers, then merged pairwise
// in shared memory (a thread's 16 outputs found by a merge-path search),
// no power-of-two padding. With EMIT (one run a row) the k keys go to the
// epilogue, else the sorted run back to the survivors.
template <bool EMIT, class Out>
__global__ void __launch_bounds__(LARGE_THREADS)
    select_large_sort(unsigned long long* __restrict__ surv, int k, int runs,
                      int q0, Out out) {
  extern __shared__ __align__(16) unsigned long long sk[];
  const int t = threadIdx.x;
  const int row = blockIdx.x / runs, first = (blockIdx.x % runs) * LARGE_RUN;
  const int len = min(LARGE_RUN, k - first);
  const int n = (len + SORT_E - 1) / SORT_E * SORT_E;
  unsigned long long* src = surv + (long long)row * k + first;
  for (int i = t; i < n; i += LARGE_THREADS)
    sk[padded(i)] = i < len ? src[i] : 0ull;
  __syncthreads();
  const bool active = t * SORT_E < n;
  unsigned long long* keys = sk;
  auto at = [keys](int i) { return keys[padded(i)]; };
  unsigned long long v[SORT_E];
  if (active) {
#pragma unroll
    for (int e = 0; e < SORT_E; ++e) v[e] = sk[padded(t * SORT_E + e)];
    sort16_desc(v);
  }
  for (int width = SORT_E;; width <<= 1) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int e = 0; e < SORT_E; ++e) sk[padded(t * SORT_E + e)] = v[e];
    }
    __syncthreads();
    if (width >= n) break;
    if (active) {
      const int o = t * SORT_E;
      const int start = o / (2 * width) * (2 * width);
      const int na = min(width, n - start);
      const int nb = max(0, min(width, n - start - na));
      const int d = o - start;
      const int i = merge_split(at, start, na, start + na, nb, d);
      merge_run<SORT_E>(at, start, na, i, start + na, nb, d - i, v);
    }
  }
  if constexpr (EMIT) {
    for (int i = t; i < len; i += LARGE_THREADS) out(q0 + row, i, sk[padded(i)]);
  } else {
    for (int i = t; i < len; i += LARGE_THREADS) src[i] = sk[padded(i)];
  }
}

// The pair of sorted runs of `width` that output `o` of a row's k falls
// in: its start, and the lengths of its two runs.
__device__ __forceinline__ void merge_pair(int o, int width, int k,
                                           int& start, int& na, int& nb) {
  start = o / (2 * width) * (2 * width);
  na = min(width, k - start);
  nb = max(0, min(width, k - start - na));
}

// (6) For each MERGE_TILE outputs of the merges of runs of `width` into
// 2 * width, the keys its first output takes from the pair's first run.
__global__ void __launch_bounds__(256)
    select_large_partition(const unsigned long long* __restrict__ src,
                           int rows, int k, int width, int tiles,
                           int* __restrict__ parts) {
  const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
  if (x >= (long long)rows * tiles) return;
  const int row = (int)(x / tiles), o = (int)(x % tiles) * MERGE_TILE;
  int start, na, nb;
  merge_pair(o, width, k, start, na, nb);
  const unsigned long long* A = src + (long long)row * k + start;
  parts[x] = merge_split([A](int i) { return A[i]; }, 0, na, na, nb,
                         o - start);
}

// (7) One block a tile of MERGE_TILE outputs of a merge of runs of `width`:
// the two runs' parts it takes into shared memory, a thread's MERGE_E
// outputs by a merge-path search there, then the tile to `dst` or, with
// EMIT (the last merge), to the epilogue.
template <bool EMIT, class Out>
__global__ void __launch_bounds__(REFINE_THREADS)
    select_large_merge(const unsigned long long* __restrict__ src,
                       unsigned long long* __restrict__ dst, int k, int width,
                       int tiles, const int* __restrict__ parts, int q0,
                       Out out) {
  __shared__ unsigned long long w[padded(MERGE_TILE)];
  const int t = threadIdx.x;
  const int row = blockIdx.x / tiles, o = (blockIdx.x % tiles) * MERGE_TILE;
  int start, na, nb;
  merge_pair(o, width, k, start, na, nb);
  const int d0 = o - start, d1 = min(d0 + MERGE_TILE, na + nb);
  const int i0 = parts[blockIdx.x];
  const int i1 = d1 == na + nb ? na : parts[blockIdx.x + 1];
  const int ca = i1 - i0, cb = (d1 - i1) - (d0 - i0), total = d1 - d0;
  const unsigned long long* A = src + (long long)row * k + start + i0;
  const unsigned long long* B = src + (long long)row * k + start + na + (d0 - i0);
  for (int i = t; i < total; i += REFINE_THREADS)
    w[padded(i)] = i < ca ? A[i] : B[i - ca];
  __syncthreads();
  unsigned long long* keys = w;
  auto at = [keys](int i) { return keys[padded(i)]; };
  unsigned long long v[MERGE_E];
  const int dd = t * MERGE_E;
  if (dd < total) {
    const int i = merge_split(at, 0, ca, ca, cb, dd);
    merge_run<MERGE_E>(at, 0, ca, i, ca, cb, dd - i, v);
  }
  __syncthreads();
  if (dd < total) {
#pragma unroll
    for (int e = 0; e < MERGE_E; ++e)
      if (dd + e < total) w[padded(dd + e)] = v[e];
  }
  __syncthreads();
  for (int i = t; i < total; i += REFINE_THREADS) {
    if constexpr (EMIT)
      out(q0 + row, o + i, w[padded(i)]);
    else
      dst[(long long)row * k + o + i] = w[padded(i)];
  }
}

// The global-memory mode: the top k of each of nq queries over c scores,
// any 1 <= k <= c, from a row-major (s_c 1) or a candidate-major (s_q 1)
// source, in chunks of q_chunk queries through the caller's scratch
// (`large_layout`). Two reads of each score: (1) the first digit's
// histogram, (3) the split into survivors and the threshold bin's keys;
// (4) the bin's keys needed; (5) the sort of the k survivors in runs, and
// past one run (6, 7) merges of runs in device memory, the last into the
// epilogue.
template <class Out>
int launch_select_large(const float* scores, int nq, int c, int k,
                        long long s_q, long long s_c, void* scratch,
                        long long scratch_bytes, int q_chunk, const Out& out,
                        cudaStream_t st) {
  if (nq <= 0 || c <= 0 || k <= 0 || k > c || q_chunk <= 0 ||
      scratch == nullptr || (s_c != 1 && s_q != 1) ||
      large_layout(q_chunk, c, k).bytes > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const bool cmajor = s_c != 1;
  const int refine_smem = refine_fixed_bytes() + REFINE_CAP * 8;
  const int runs = (k + LARGE_RUN - 1) / LARGE_RUN;
  const int run_keys = runs > 1 ? LARGE_RUN : (k + SORT_E - 1) / SORT_E * SORT_E;
  const int sort_smem = padded(run_keys) * 8;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(select_large_count<8>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                8 * HIST_BINS * 4)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(select_large_refine,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                refine_smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(select_large_sort<true, Out>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sort_smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(select_large_sort<false, Out>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sort_smem)) != cudaSuccess)
    return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int qb = cmajor ? 8 : 1;
  const int step = (G / qb) * SPLIT_U;
  const int tiles = (k + MERGE_TILE - 1) / MERGE_TILE;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  for (int q0 = 0; q0 < nq; q0 += q_chunk) {
    const int rows = nq - q0 < q_chunk ? nq - q0 : q_chunk;
    const LargeLayout l = large_layout(rows, c, k);
    int* hist = reinterpret_cast<int*>(base + l.hist);
    int* state = reinterpret_cast<int*>(base + l.state);
    unsigned long long* bins =
        reinterpret_cast<unsigned long long*>(base + l.bins);
    unsigned long long* surv =
        reinterpret_cast<unsigned long long*>(base + l.surv);
    unsigned long long* surv2 =
        reinterpret_cast<unsigned long long*>(base + l.surv2);
    int* parts = reinterpret_cast<int*>(base + l.parts);
    // splits of each row's candidates, so that the card holds ~4 blocks an
    // SM for any number of rows
    const int bx = (rows + qb - 1) / qb;
    int splits = (4 * sms + bx - 1) / bx;
    splits = max(1, min(min(splits, MAX_SPLITS), (c + step - 1) / step));
    const int span = ((c + splits - 1) / splits + step - 1) / step * step;
    splits = (c + span - 1) / span;
    const float* src = scores + (long long)q0 * s_q;
    const dim3 grid((unsigned)bx, (unsigned)splits);
    if (cmajor)
      select_large_count<8><<<grid, G, 8 * HIST_BINS * 4, st>>>(
          src, rows, c, span, s_q, s_c, hist);
    else
      select_large_count<1><<<grid, G, HIST_BINS * 4, st>>>(
          src, rows, c, span, s_q, s_c, hist);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    select_large_pick<<<rows, G, 0, st>>>(hist, rows, splits, k, state);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (cmajor)
      select_large_split<8><<<grid, G, 0, st>>>(src, rows, c, k, span, s_q,
                                                s_c, state, bins, surv);
    else
      select_large_split<1><<<grid, G, 0, st>>>(src, rows, c, k, span, s_q,
                                                s_c, state, bins, surv);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    select_large_refine<<<rows, REFINE_THREADS, refine_smem, st>>>(
        c, k, state, bins, surv);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (runs == 1) {
      select_large_sort<true, Out><<<rows, LARGE_THREADS, sort_smem, st>>>(
          surv, k, 1, q0, out);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      continue;
    }
    select_large_sort<false, Out><<<(unsigned)rows * runs, LARGE_THREADS,
                                    sort_smem, st>>>(surv, k, runs, q0, out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    unsigned long long *from = surv, *to = surv2;
    for (int width = LARGE_RUN; width < k; width <<= 1) {
      const long long n_parts = (long long)rows * tiles;
      select_large_partition<<<(unsigned)((n_parts + 255) / 256), 256, 0,
                               st>>>(from, rows, k, width, tiles, parts);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      if (2 * width >= k)
        select_large_merge<true, Out><<<(unsigned)n_parts, REFINE_THREADS, 0,
                                        st>>>(from, to, k, width, tiles,
                                              parts, q0, out);
      else
        select_large_merge<false, Out><<<(unsigned)n_parts, REFINE_THREADS,
                                         0, st>>>(from, to, k, width, tiles,
                                                  parts, q0, out);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      unsigned long long* x = from;
      from = to;
      to = x;
    }
  }
  return (int)cudaSuccess;
}

// The top k of each of nq queries over c scores at the given element
// strides into the epilogue `out`: 1 <= k <= c; p a power of two, k <= p.
// One window (window = c <= 16384): qb 1, 2 or 4 queries a block, kpt keys
// a thread with c <= 256 * kpt (8, 16 or 32 for qb 4, 64 for qb 2, 32 or
// 64 for qb 1). Past it while 2k <= 16384, the streaming path: window <
// c is the buffer of keys a query holds (`cap`), qb 1, or 4 (a
// candidate-major source). qb 0: the global-memory mode, any k <= c,
// through `scratch` (`large_layout`) in chunks of q_chunk queries
// (`ops/bitonic_topk.py` `select_plan`, `large_scratch`).
template <class Out>
int launch_select(const float* scores, int nq, int c, int k, int p,
                  int window, int qb, int kpt, long long s_q, long long s_c,
                  void* scratch, long long scratch_bytes, int q_chunk,
                  const Out& out, cudaStream_t st) {
  if (qb == 0)
    return launch_select_large(scores, nq, c, k, s_q, s_c, scratch,
                               scratch_bytes, q_chunk, out, st);
  if (nq <= 0 || c <= 0 || k <= 0 || k > c || k > p || p < 2 ||
      (p & (p - 1)) != 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  if (window < c) {
    switch (qb) {
      case 1:
        return launch_stream<1>(scores, nq, c, k, p, window, s_q, s_c, out,
                                st);
      case 4:
        return launch_stream<4>(scores, nq, c, k, p, window, s_q, s_c, out,
                                st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (window != c || c > MAX_WINDOW || c > G * kpt)
    return (int)cudaErrorInvalidValue;
  switch (qb) {
    case 1:
      return launch_kpt<1>(kpt, scores, nq, c, k, p, s_q, s_c, out, st);
    case 2:
      return launch_kpt<2>(kpt, scores, nq, c, k, p, s_q, s_c, out, st);
    case 4:
      return launch_kpt<4>(kpt, scores, nq, c, k, p, s_q, s_c, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
