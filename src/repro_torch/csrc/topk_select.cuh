// Exact selection for the top-k kernels past one warp (pq_scan_topk.cu,
// rerank_topk.cu, and the wide paths of centroid_topk.cu and
// posting_scan_topk.cu): the kk smallest of n (score, key) pairs in
// lexicographic order, so equal scores rank by the lower key.  Block-wide
// (block_select, block_rank_emit) below; warp_select at the end runs the
// same rule on one warp's list of 64-bit composites.
//
// The pairs sit in shared memory as float2 (score, key as int bits), each
// with its score's order key beside it.  The selection is one radix select
// and one stable compaction, with no sort of a candidate buffer:
//   1. order_key maps a score to an unsigned key in the scores' order
//      (-0.0 first made +0.0, because lex_less calls the two equal and
//      breaks their tie by key); the callers write it as they score.  A
//      block reduction finds the range the kk-th smallest lies in (the
//      least key to the largest below BIG's, where those reach kk).  Then
//      passes of an 8-bit digit each, from the first bit the range's ends
//      differ in, histogram the keys in the range that share the prefix
//      chosen so far (shared atomics, which the compiler aggregates a warp
//      at a time) and pick the digit where the kk-th smallest falls.  A
//      pass stops early once every entry of the chosen bin is needed.
//      Starting below the range's shared bits keeps scores of one range
//      out of a single first bin.
//   2. With T the prefix found and krem the entries still needed at it,
//      the entries whose masked key is below T are all taken, and of those
//      in the range equal to T the first krem in array order.  Warp
//      ballots and one scan of their counts give each pair its output
//      offset; the compaction keeps array order within both groups.
// When the array holds equal scores in ascending key order (the callers
// write positions or ranks in order, and a list compacted here keeps that
// order), "first in array order" is "lowest key first", the reference's
// tie rule.  block_rank_emit then sorts the kk chosen pairs once, on
// 64-bit composites (order key << 32 | key) that the compaction writes
// beside the pairs: one unsigned compare orders two pairs.
//
// Measured on the H100 (PERF.md): a warp match to aggregate the atomics,
// keys held in registers over unrolled loops, and a decision by every warp
// instead of warp 0 each ran slower than this.
//
// Every function here is called by all SEL_THREADS threads of the block.
#pragma once

#include "topk_common.cuh"

#define SEL_THREADS 256
#define SEL_WARPS (SEL_THREADS / 32)
#define SEL_MAX_ROUNDS 20       // rounds of 256 pairs: n <= 5,120
// ints of shared scratch: a 256-bin histogram (the compaction's counts
// after it), the pass decision (4), the warps' range (4 each), the
// compaction's ballots (2 a warp and round)
#define SEL_SCRATCH_INTS \
  (256 + 4 + 4 * SEL_WARPS + 2 * SEL_WARPS * SEL_MAX_ROUNDS)

__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t b = __float_as_uint(s);
  if ((b << 1) == 0) b = 0;                  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The score whose order key is ``key`` (bit for bit, but for -0.0, which
// order_key makes +0.0; the score kernels never give -0.0: s = n - 2 p with
// n >= +0 rounds an exact zero to +0.0).
__device__ __forceinline__ float key_score(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ float2 sel_pair(float s, int key) {
  return make_float2(s, __int_as_float(key));
}

// sel[0, kk) = the kk smallest pairs of u[0, n), 1 <= kk <= n <= 5,120
// (SEL_MAX_ROUNDS rounds of the block), those below the threshold first,
// each group in array order; rk[0, kk) their composites (order key << 32
// | key).  uk[i] = order_key(u[i].x): the callers write it beside each
// pair.  Thread t takes pairs t, t + 256, ... (consecutive threads on
// consecutive pairs: no bank conflicts) and reads their keys again in each
// pass, so the loops stay rolled and the code small.  Ends with a barrier.
// ``scratch``: SEL_SCRATCH_INTS ints of shared memory, 16-byte aligned.
__device__ inline void block_select(const float2* u, const uint32_t* uk,
                                    int n, int kk, float2* sel, uint64_t* rk,
                                    int* scratch) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n + SEL_THREADS - 1) / SEL_THREADS;   // block-uniform
  uint32_t prefix = ~0u, mask = ~0u;   // kk == n: every key at or below
  uint32_t hi = ~0u;                   // the keys that can be chosen
  int krem = n;
  int* hist = scratch;
  int* ctl = scratch + 256;
  if (kk < n) {
    int* red = scratch + 256 + 4;            // [warps][4]
    // The range first: the least key and the largest below the masked
    // score's (BIG), with their count; where that count reaches kk the
    // kk-th smallest lies in it.  The passes start below the bits that
    // both ends share.
    const uint32_t big = order_key(REPRO_BIG / 2);
    uint32_t kmin = ~0u, kmax = 0u, kreal = 0u, nreal = 0u;
    for (int i = tid; i < n; i += SEL_THREADS) {
      const uint32_t key = uk[i];
      kmin = min(kmin, key);
      kmax = max(kmax, key);
      if (key < big) {
        kreal = max(kreal, key);
        ++nreal;
      }
    }
    kmin = __reduce_min_sync(REPRO_FULL_MASK, kmin);
    kmax = __reduce_max_sync(REPRO_FULL_MASK, kmax);
    kreal = __reduce_max_sync(REPRO_FULL_MASK, kreal);
    nreal = __reduce_add_sync(REPRO_FULL_MASK, nreal);
    if (lane == 0) {
      red[4 * warp] = (int)kmin;
      red[4 * warp + 1] = (int)kmax;
      red[4 * warp + 2] = (int)kreal;
      red[4 * warp + 3] = (int)nreal;
    }
    hist[tid] = 0;
    __syncthreads();
    kmin = ~0u;
    kmax = kreal = nreal = 0u;
    for (int w = 0; w < SEL_WARPS; ++w) {
      kmin = min(kmin, (uint32_t)red[4 * w]);
      kmax = max(kmax, (uint32_t)red[4 * w + 1]);
      kreal = max(kreal, (uint32_t)red[4 * w + 2]);
      nreal += (uint32_t)red[4 * w + 3];
    }
    hi = nreal >= (uint32_t)kk ? kreal : kmax;
    int top = 32 - __clz(kmin ^ hi);         // bits still to decide
    mask = top == 32 ? 0u : ~0u << top;
    prefix = kmin & mask;
    krem = kk;
    while (top > 0) {
      const int width = min(8, top);
      const int shift = top - width;
      const uint32_t dmask = (1u << width) - 1u;
      for (int i = tid; i < n; i += SEL_THREADS) {
        const uint32_t key = uk[i];
        if (key <= hi && (key & mask) == prefix)
          atomicAdd(&hist[(key >> shift) & dmask], 1);
      }
      __syncthreads();
      if (warp == 0) {                       // bins 8 lane .. 8 lane + 7
        int4* h4 = reinterpret_cast<int4*>(hist) + 2 * lane;
        const int4 a = h4[0], b = h4[1];
        const int h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        int sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += h[i];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
          if (lane >= o) incl += y;
        }
        h4[0] = h4[1] = make_int4(0, 0, 0, 0);  // ready for the next pass
        int ex = incl - sum;
        if (ex < krem && krem <= incl) {     // one lane: the bin is here
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (ex < krem && krem <= ex + h[i]) {
              ctl[0] = 8 * lane + i;
              ctl[1] = krem - ex;
              ctl[2] = h[i] == krem - ex;    // the whole bin is taken
            }
            ex += h[i];
          }
        }
      }
      __syncthreads();
      prefix |= (uint32_t)ctl[0] << shift;
      mask |= dmask << shift;
      krem = ctl[1];
      top = shift;
      if (ctl[2]) break;
    }
  }
  // Stable compaction: pair i = 256 j + 32 w + lane, so array order is
  // (j, warp, lane) order.  Each warp's ballots (kept for the second
  // loop) give each lane its place within (j, w); warp 0 scans the (j, w)
  // counts (below the threshold in the low half-word, at it in the high
  // one), held where the histogram was (per * 8 <= 256 of them).
  const unsigned below = (1u << lane) - 1u;
  int* cnt = hist;
  unsigned* bal =
      reinterpret_cast<unsigned*>(scratch + 256 + 4 + 4 * SEL_WARPS);
  for (int j = 0; j < per; ++j) {            // block-uniform trips
    const int i = j * SEL_THREADS + tid;
    const uint32_t key = i < n ? uk[i] : ~0u;
    const uint32_t mk = key & mask;
    const unsigned bl = __ballot_sync(REPRO_FULL_MASK, i < n && mk < prefix);
    const unsigned be = __ballot_sync(REPRO_FULL_MASK,
                                      i < n && mk == prefix && key <= hi);
    if (lane == 0) {
      cnt[j * SEL_WARPS + warp] = __popc(bl) | (__popc(be) << 16);
      bal[2 * (j * SEL_WARPS + warp)] = bl;
      bal[2 * (j * SEL_WARPS + warp) + 1] = be;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int E = per * SEL_WARPS;
    const int epl = (E + 31) / 32;           // counts a lane
    int sum = 0;
    for (int e = 0; e < epl; ++e) {
      const int at = epl * lane + e;
      sum += at < E ? cnt[at] : 0;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    int ex = incl - sum;
    for (int e = 0; e < epl; ++e) {
      const int at = epl * lane + e;
      if (at < E) {
        const int v = cnt[at];
        cnt[at] = ex;
        ex += v;
      }
    }
    if (lane == 31) ctl[3] = incl;
  }
  __syncthreads();
  const int lt_total = ctl[3] & 0xffff;
  for (int j = 0; j < per; ++j) {
    const int w = j * SEL_WARPS + warp;
    const unsigned bl = bal[2 * w], be = bal[2 * w + 1];
    const unsigned me = 1u << lane;
    if (!((bl | be) & me)) continue;
    const int base = cnt[w];
    int o = -1;
    if (bl & me) {
      o = (base & 0xffff) + __popc(bl & below);
    } else {
      const int r = (base >> 16) + __popc(be & below);
      if (r < krem) o = lt_total + r;
    }
    if (o >= 0) {
      const int i = j * SEL_THREADS + tid;
      sel[o] = u[i];
      rk[o] = ((uint64_t)uk[i] << 32) | (uint32_t)__float_as_int(u[i].y);
    }
  }
  __syncthreads();
}

// Sort sel[0, kk) once: emit(rank, score, key, composite) for each pair.
// Each warp sorts runs of 32 composites in registers (a bitonic network
// over the lanes, the score carried along) and writes them back in place;
// then a pair's rank is its index in its run plus, in each other run, the
// number of composites below its own (binary searches, eight runs in
// lockstep).  Keys are unique, so the ranks are 0..kk-1.  Leaves sel and
// rk sorted within runs.  Barriers: one.
#define SEL_LOCKSTEP 8

template <class Emit>
__device__ inline void block_rank_emit(float2* sel, uint64_t* rk, int kk,
                                       Emit emit) {
  const int lane = threadIdx.x & 31;
  const int runs = (kk + 31) / 32;
  for (int r = threadIdx.x >> 5; r < runs; r += SEL_WARPS) {
    const int i = 32 * r + lane;
    uint64_t c = i < kk ? rk[i] : ~0ull;     // pads sort last
    float s = i < kk ? sel[i].x : 0.f;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint64_t oc = __shfl_xor_sync(REPRO_FULL_MASK, c, stride);
        const float os = __shfl_xor_sync(REPRO_FULL_MASK, s, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        if (keep_min ? oc < c : oc > c) {
          c = oc;
          s = os;
        }
      }
    }
    if (i < kk) {
      rk[i] = c;
      sel[i] = sel_pair(s, (int)(uint32_t)c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kk; i += SEL_THREADS) {
    const uint64_t e = rk[i];
    const int own = i >> 5;
    int rank = i & 31;
    for (int r0 = 0; r0 < runs; r0 += SEL_LOCKSTEP) {
      int at[SEL_LOCKSTEP], len[SEL_LOCKSTEP];
#pragma unroll
      for (int b = 0; b < SEL_LOCKSTEP; ++b) {
        const int r = r0 + b;
        at[b] = 0;
        len[b] = r < runs && r != own ? min(32, kk - 32 * r) : 0;
      }
#pragma unroll
      for (int step = 32; step > 0; step >>= 1) {
#pragma unroll
        for (int b = 0; b < SEL_LOCKSTEP; ++b)
          if (at[b] + step <= len[b] && rk[32 * (r0 + b) + at[b] + step - 1] < e)
            at[b] += step;
      }
#pragma unroll
      for (int b = 0; b < SEL_LOCKSTEP; ++b) rank += at[b];
    }
    const float2 p = sel[i];
    emit(rank, p.x, __float_as_int(p.y), e);
  }
}

// One warp's selection, in place: of the n unique composites buf[0, n)
// (order key << 32 | key), keep the kk smallest in buf[0, kk), in array
// order, and return the largest kept.  1 <= kk <= n.  All 32 lanes call
// it; ``hist`` is 256 ints of shared memory, 16-byte aligned, the warp's
// own.  The rule is block_select's: a radix select over the order keys
// from the range the kk-th smallest lies in (8-bit digits, a histogram by
// shared atomics, the digit found by one warp scan), then the entries
// below the threshold and the first krem at it, in array order.  Where the
// entries of equal order key stand in ascending key order in the array
// (callers append in key order and this keeps array order), those are the
// kk smallest composites.  The compaction writes each kept entry at or
// below its own index, so one pass in array order can work in place.
__device__ inline uint64_t warp_select(uint64_t* buf, int n, int kk,
                                       int* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t big = order_key(REPRO_BIG / 2);
  uint32_t kmin = ~0u, kmax = 0u, kreal = 0u, nreal = 0u;
  for (int i = lane; i < n; i += 32) {
    const uint32_t key = (uint32_t)(buf[i] >> 32);
    kmin = min(kmin, key);
    kmax = max(kmax, key);
    if (key < big) {
      kreal = max(kreal, key);
      ++nreal;
    }
  }
  kmin = __reduce_min_sync(REPRO_FULL_MASK, kmin);
  kmax = __reduce_max_sync(REPRO_FULL_MASK, kmax);
  kreal = __reduce_max_sync(REPRO_FULL_MASK, kreal);
  nreal = __reduce_add_sync(REPRO_FULL_MASK, nreal);
  const uint32_t hi = nreal >= (uint32_t)kk ? kreal : kmax;
  int top = 32 - __clz(kmin ^ hi);           // bits still to decide
  uint32_t mask = top == 32 ? 0u : ~0u << top;
  uint32_t prefix = kmin & mask;
  int krem = kk;
  int4* h4 = reinterpret_cast<int4*>(hist) + 2 * lane;  // bins 8 lane + 0..7
  while (top > 0) {
    const int width = min(8, top);
    const int shift = top - width;
    const uint32_t dmask = (1u << width) - 1u;
    h4[0] = h4[1] = make_int4(0, 0, 0, 0);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const uint32_t key = (uint32_t)(buf[i] >> 32);
      if (key <= hi && (key & mask) == prefix)
        atomicAdd(&hist[(key >> shift) & dmask], 1);
    }
    __syncwarp();
    const int4 a = h4[0], b = h4[1];
    const int h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += h[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    int ex = incl - sum, bin = 0, need = 0, whole = 0;
    if (ex < krem && krem <= incl) {         // one lane: the bin is here
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ex < krem && krem <= ex + h[i]) {
          bin = 8 * lane + i;
          need = krem - ex;
          whole = h[i] == need;              // the whole bin is taken
        }
        ex += h[i];
      }
    }
    const int src = __ffs(__ballot_sync(REPRO_FULL_MASK, need > 0)) - 1;
    bin = __shfl_sync(REPRO_FULL_MASK, bin, src);
    krem = __shfl_sync(REPRO_FULL_MASK, need, src);
    whole = __shfl_sync(REPRO_FULL_MASK, whole, src);
    prefix |= (uint32_t)bin << shift;
    mask |= dmask << shift;
    top = shift;
    if (whole) break;
  }
  int out = 0, at = 0;
  uint64_t last = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {       // warp-uniform trips
    const int i = i0 + lane;
    const uint64_t e = i < n ? buf[i] : ~0ull;
    const uint32_t key = (uint32_t)(e >> 32);
    const bool lt = i < n && (key & mask) < prefix;
    const bool eq = i < n && (key & mask) == prefix && key <= hi;
    const unsigned be = __ballot_sync(REPRO_FULL_MASK, eq);
    const bool take = lt || (eq && at + __popc(be & below) < krem);
    const unsigned bt = __ballot_sync(REPRO_FULL_MASK, take);
    if (take) {                  // every lane read its entry before the votes
      buf[out + __popc(bt & below)] = e;
      last = e > last ? e : last;
    }
    out += __popc(bt);
    at += __popc(be);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(REPRO_FULL_MASK, last, o);
    last = y > last ? y : last;
  }
  __syncwarp();
  return last;
}
