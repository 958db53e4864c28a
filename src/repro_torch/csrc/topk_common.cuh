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
