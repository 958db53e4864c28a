// Warp-level top-k selection shared by the fused search kernels.
//
// A top-k list lives in one warp's registers, one entry per lane: lane j
// holds the j-th best (score, key) pair, ascending in lexicographic order,
// so equal scores rank by the lower key.  That order does not depend on
// the order in which candidates arrive, which is what lets blocks that run
// in parallel, in no fixed order, reproduce the reference's "lowest index
// first" tie rule exactly.  Lanes at or past k, and list slots not filled
// yet, hold the empty entry (+inf, INT_MAX): a masked but real candidate
// carries BIG (< +inf) and therefore always outranks an empty slot.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

#define REPRO_BIG 1e30f
#define REPRO_FULL_MASK 0xffffffffu

__device__ __forceinline__ bool lex_less(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(REPRO_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ void topk_empty(float& ls, int& li) {
  ls = CUDART_INF_F;
  li = INT_MAX;
}

// Insert one candidate, the same on every lane, into the warp's list.
// The lanes whose entry the candidate beats form a suffix of [0, k); the
// candidate takes the first of them and the rest shift one lane up.
__device__ __forceinline__ void topk_insert(float& ls, int& li, float cs,
                                            int ci, int k, int lane) {
  const bool beaten = lane < k && lex_less(cs, ci, ls, li);
  const unsigned m = __ballot_sync(REPRO_FULL_MASK, beaten);
  if (m == 0) return;
  const int pos = __ffs(m) - 1;
  const float ps = __shfl_up_sync(REPRO_FULL_MASK, ls, 1);
  const int pi = __shfl_up_sync(REPRO_FULL_MASK, li, 1);
  if (lane == pos) {
    ls = cs;
    li = ci;
  } else if (lane > pos && lane < k) {
    ls = ps;
    li = pi;
  }
}

// Insert up to 32 candidates, one per lane (``has`` false where the lane
// holds none).  Only the candidates that beat the current k-th entry go
// through the serial insert.
__device__ __forceinline__ void topk_insert_lanes(float& ls, int& li,
                                                  float my_s, int my_i,
                                                  bool has, int k, int lane) {
  const float ts = __shfl_sync(REPRO_FULL_MASK, ls, k - 1);
  const int ti = __shfl_sync(REPRO_FULL_MASK, li, k - 1);
  unsigned m = __ballot_sync(REPRO_FULL_MASK, has && lex_less(my_s, my_i, ts, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(REPRO_FULL_MASK, my_s, src);
    const int ci = __shfl_sync(REPRO_FULL_MASK, my_i, src);
    topk_insert(ls, li, cs, ci, k, lane);
  }
}

// ---------------------------------------------------------------------------
// Block-wide top-k, for k wider than one warp (up to TOPK_BLOCK_MAX_K).
//
// The running list lives in shared memory as (score, key) pairs, keys unique
// per call.  Every thread of the block calls ``block_topk_push`` once per
// round with at most one candidate.  A candidate that beats the current k-th
// entry is appended behind the list (slot from a shared atomic counter: the
// arrival order does not matter, because the sort below orders the pairs
// lexicographically and keys are unique); when the buffer could overflow in
// the next round, a block-wide bitonic sort of the filled prefix keeps the k
// best in front.  ``block_topk_finish`` sorts once more, so that buf[0..k)
// is the ascending top-k with ties by the lower key, whatever the block size
// or the order of the rounds.
// ---------------------------------------------------------------------------

#define TOPK_BLOCK_MAX_K 1024

struct BlockTopK {
  float* s;       // [cap] scores
  int* i;         // [cap] keys
  int* ctl;       // [0] fill counter, [1] threshold key
  float* thr;     // [0] threshold score
  int cap;        // power of two, >= k + blockDim.x
  int k;
  int fill;       // block-uniform copy of ctl[0]
};

// Shared bytes a BlockTopK with ``cap`` entries needs (see block_topk_init).
__host__ __device__ inline size_t block_topk_bytes(int cap) {
  return (size_t)cap * (sizeof(float) + sizeof(int)) + 4 * sizeof(int);
}

// Smallest power of two >= max(k + threads, floor).
__host__ __device__ inline int block_topk_cap(int k, int threads, int floor) {
  int need = k + threads > floor ? k + threads : floor;
  int cap = 2;
  while (cap < need) cap <<= 1;
  return cap;
}

// Ascending lexicographic bitonic sort of s/i[0, n), n a power of two.
__device__ inline void block_sort_pairs(float* s, int* i, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float a = s[lo], b = s[hi];
        const int ia = i[lo], ib = i[hi];
        const bool up = (lo & size) == 0;
        if (up ? lex_less(b, ib, a, ia) : lex_less(a, ia, b, ib)) {
          s[lo] = b;
          s[hi] = a;
          i[lo] = ib;
          i[hi] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// ``mem``: block_topk_bytes(cap) bytes of shared memory.
__device__ inline BlockTopK block_topk_init(void* mem, int cap, int k) {
  BlockTopK t;
  t.s = (float*)mem;
  t.i = (int*)(t.s + cap);
  t.ctl = t.i + cap;
  t.thr = (float*)(t.ctl + 2);
  t.cap = cap;
  t.k = k;
  t.fill = k;
  for (int e = threadIdx.x; e < cap; e += blockDim.x) topk_empty(t.s[e], t.i[e]);
  if (threadIdx.x == 0) {
    t.ctl[0] = k;                 // [0, k): the running list, empty so far
    topk_empty(t.thr[0], t.ctl[1]);
  }
  __syncthreads();
  return t;
}

__device__ inline void block_topk_flush(BlockTopK& t) {
  int n = 2;
  while (n < t.fill) n <<= 1;
  block_sort_pairs(t.s, t.i, n);  // entries past ``fill`` are empty
  for (int e = t.k + threadIdx.x; e < n; e += blockDim.x) topk_empty(t.s[e], t.i[e]);
  if (threadIdx.x == 0) {
    t.ctl[0] = t.k;
    t.thr[0] = t.s[t.k - 1];
    t.ctl[1] = t.i[t.k - 1];
  }
  __syncthreads();
  t.fill = t.k;
}

// Every thread of the block calls this, with ``has`` false where it holds
// no candidate this round.
__device__ inline void block_topk_push(BlockTopK& t, bool has, float cs, int ci) {
  const bool want = has && lex_less(cs, ci, t.thr[0], t.ctl[1]);
  if (want) {
    const int pos = atomicAdd(t.ctl, 1);
    t.s[pos] = cs;
    t.i[pos] = ci;
  }
  t.fill += __syncthreads_count(want);
  if (t.fill > t.cap - (int)blockDim.x) block_topk_flush(t);
}

// After the last push: buf[0, k) is the ascending top-k.
__device__ inline void block_topk_finish(BlockTopK& t) {
  if (t.fill > t.k) block_topk_flush(t);
}
