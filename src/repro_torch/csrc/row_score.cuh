// One slot row's score terms, s = ||v||^2 - 2 q.v, as the float plane's
// probe scans compute them: posting_scan_topk.cu (fused with a top-k) and
// posting_scan_gather.cu (unselected) walk a row with these functions, so
// both give the same bits for the same row, query and unit layout.
//
// A thread walks one row held in shared memory, dw words (float4 words
// where V4, else floats), from the word j0 = row_start(r, dw) on and
// wrapping round, accumulating in this order
//     vn = fmaf(v, v, vn);   dot = fmaf(q, v, dot)
// so integer inputs are exact.  Rows a stride of d floats apart then start
// in distinct banks.  The two sums are independent chains, so a norm taken
// alone (row_walk<V4, true, false>) has the bits of one taken beside the
// dot product.
#pragma once

#include <algorithm>

#define PS_UNIT_FLOATS 12288   // 48 KB: the largest staged unit of a tile

// Rows of a (C, d) tile that one staged unit holds (the last unit may hold
// fewer).  A row's walk starts from its index within its unit, so two
// kernels give a row the same bits only where they cut tiles alike.
inline int unit_rows(int C, int d) {
  return std::min(C, std::max(1, PS_UNIT_FLOATS / d));
}

// the first word of row r's walk: r when rows are an even number of words
// apart, else 0 (the bank of word j of row r is then distinct anyway)
__device__ __forceinline__ int row_start(int r, int dw) {
  return (dw % 2 == 0) ? r % dw : 0;
}

template <bool V4, bool NORM, bool DOT>
__device__ __forceinline__ void row_walk(const float* __restrict__ row,
                                         const float* __restrict__ qv,
                                         int dw, int j, float& vn,
                                         float& dot) {
  if (V4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qv);
    for (int t = 0; t < dw; ++t) {
      const float4 v = row4[j];
      if (NORM) {
        vn = fmaf(v.x, v.x, vn);
        vn = fmaf(v.y, v.y, vn);
        vn = fmaf(v.z, v.z, vn);
        vn = fmaf(v.w, v.w, vn);
      }
      if (DOT) {
        const float4 w = q4[j];
        dot = fmaf(w.x, v.x, dot);
        dot = fmaf(w.y, v.y, dot);
        dot = fmaf(w.z, v.z, dot);
        dot = fmaf(w.w, v.w, dot);
      }
      j = j + 1 == dw ? 0 : j + 1;
    }
  } else {
    for (int t = 0; t < dw; ++t) {
      const float v = row[j];
      if (NORM) vn = fmaf(v, v, vn);
      if (DOT) dot = fmaf(qv[j], v, dot);
      j = j + 1 == dw ? 0 : j + 1;
    }
  }
}
