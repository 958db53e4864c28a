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

// One compare-exchange of a bitonic network across the warp: the lane
// keeps the lower (keep_min) or the higher of its entry and the one at
// lane ^ stride.
__device__ __forceinline__ void topk_cas(float& s, int& i, int stride,
                                         bool keep_min) {
  const float os = __shfl_xor_sync(REPRO_FULL_MASK, s, stride);
  const int oi = __shfl_xor_sync(REPRO_FULL_MASK, i, stride);
  if (lex_less(os, oi, s, i) == keep_min) {
    s = os;
    i = oi;
  }
}

// Up to this many candidates that beat the k-th entry go through the
// serial insert (a chain of about seven shuffles and votes each); more
// are merged by the bitonic network (21 compare-exchange stages).
#define TOPK_SERIAL_MAX 6

struct TopkEntry {
  float s;
  int i;
};

// The two ways into the list, each compiled once (not inlined at every
// call site: a kernel that ranks many rows would otherwise carry dozens of
// copies of both and run out of instruction cache).  The lane's list entry
// goes in and comes out by value.

// The candidates of the lanes in ``m``, one after another.
__device__ __noinline__ TopkEntry topk_insert_serial(float ls, int li,
                                                     float my_s, int my_i,
                                                     unsigned m, int k,
                                                     int lane) {
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(REPRO_FULL_MASK, my_s, src);
    const int ci = __shfl_sync(REPRO_FULL_MASK, my_i, src);
    topk_insert(ls, li, cs, ci, k, lane);
  }
  return {ls, li};
}

// The candidates of the lanes where ``pass`` holds, all at once: sorted
// descending by a bitonic network and merged with the list.  The
// lane-wise lower of the ascending list and the descending candidates are
// the 32 smallest of both, a bitonic sequence that five more stages sort.
__device__ __noinline__ TopkEntry topk_insert_bitonic(float ls, int li,
                                                      float my_s, int my_i,
                                                      bool pass, int k,
                                                      int lane) {
  if (!pass) topk_empty(my_s, my_i);
  if (lane >= k) topk_empty(ls, li);
  // every direction of the ascending network reversed: a descending sort
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      topk_cas(my_s, my_i, stride,
               ((lane & stride) == 0) == ((lane & size) != 0));
  if (lex_less(my_s, my_i, ls, li)) {
    ls = my_s;
    li = my_i;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    topk_cas(ls, li, stride, (lane & stride) == 0);
  return {ls, li};
}

// Insert up to 32 candidates, one per lane (``has`` false where the lane
// holds none).  Only the candidates that beat the current k-th entry
// count: a few go through the serial insert, more through the bitonic
// merge.  Either way the list is the k best (score, key) pairs seen,
// ascending.
__device__ __forceinline__ void topk_insert_lanes(float& ls, int& li,
                                                  float my_s, int my_i,
                                                  bool has, int k, int lane) {
  const float ts = __shfl_sync(REPRO_FULL_MASK, ls, k - 1);
  const int ti = __shfl_sync(REPRO_FULL_MASK, li, k - 1);
  const bool pass = has && lex_less(my_s, my_i, ts, ti);
  const unsigned m = __ballot_sync(REPRO_FULL_MASK, pass);
  if (m == 0) return;
  const TopkEntry e =
      __popc(m) <= TOPK_SERIAL_MAX
          ? topk_insert_serial(ls, li, my_s, my_i, m, k, lane)
          : topk_insert_bitonic(ls, li, my_s, my_i, pass, k, lane);
  ls = e.s;
  li = e.i;
}

// The k best of each query's ``nparts`` partial lists (part_s/part_i (Q,
// nparts, k), empty entries skipped; the lists hold disjoint keys),
// written to out_s/out_i (Q, k).  With ``probe`` (Q, P) given, a key is a
// position p*C + c and goes out as the id probe[q, p]*C + c.  The split
// kernels of centroid_topk.cu and posting_scan_topk.cu end with it.
// One block per query: warp w takes the parts w, w + 8, ..., loading four
// parts ahead of the one it inserts (a merge is a chain of loads, each
// waiting on device memory, when one warp walks the parts in turn), and
// warp 0 merges the 8 lists.
#define MERGE_WARPS 8
#define MERGE_AHEAD 4

static __global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_parts(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, int nparts, int k,
                 const int* __restrict__ probe, int P, int C,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float ms[MERGE_WARPS * 32];
  __shared__ int mi[MERGE_WARPS * 32];
  const int qq = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has = lane < k;
  const float* ps = part_s + (size_t)qq * nparts * k + lane;
  const int* pi = part_i + (size_t)qq * nparts * k + lane;
  float ls;
  int li;
  topk_empty(ls, li);
  for (int p0 = warp; p0 < nparts; p0 += MERGE_WARPS * MERGE_AHEAD) {
    float s[MERGE_AHEAD];
    int i[MERGE_AHEAD];
#pragma unroll
    for (int a = 0; a < MERGE_AHEAD; ++a) {
      const int p = p0 + a * MERGE_WARPS;
      const bool in = has && p < nparts;
      s[a] = in ? ps[(size_t)p * k] : CUDART_INF_F;
      i[a] = in ? pi[(size_t)p * k] : INT_MAX;
    }
#pragma unroll
    for (int a = 0; a < MERGE_AHEAD; ++a)
      topk_insert_lanes(ls, li, s[a], i[a], i[a] != INT_MAX, k, lane);
  }
  ms[threadIdx.x] = ls;
  mi[threadIdx.x] = li;
  __syncthreads();
  if (warp != 0) return;
  topk_empty(ls, li);
  for (int w = 0; w < MERGE_WARPS; ++w) {
    const float s = ms[w * 32 + lane];
    const int i = mi[w * 32 + lane];
    topk_insert_lanes(ls, li, s, i, has && i != INT_MAX, k, lane);
  }
  if (has) {
    int id = li;
    if (probe != nullptr) {
      const int p = li / C;
      id = probe[(size_t)qq * P + p] * C + (li - p * C);
    }
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = id;
  }
}

// The widest k of the top-k kernels past one warp (their selection is in
// topk_select.cuh).
#define TOPK_BLOCK_MAX_K 1024

// Every byte of shared memory a block may take on the H100.
#define TOPK_SMEM_MAX 232448

// Lets ``fn`` take up to TOPK_SMEM_MAX bytes of dynamic shared memory, once
// per device (``opted``: a bit a device, static to the caller's instance).
static inline int allow_smem(const void* fn, unsigned long long& opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && ((opted >> dev) & 1ull)) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, TOPK_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted |= 1ull << dev;
  return 0;
}
