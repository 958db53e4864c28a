// centroid_topk: per query, the k smallest of
//     s[i, j] = vis[j] ? ||c_j||^2 - 2 q_i . c_j : BIG
// ascending, ties by the lower centroid index; no (Q, M) matrix is written.
//
// Replaces the Pallas TPU kernel src/repro/kernels/centroid_topk.py:
// centroid_topk (with its merge_topk running selection).  On the TPU the
// grid walks the centroid axis in order and carries the running top-k in
// the output block.  Hopper blocks run in parallel and in no order, so:
//   pass 1: a block takes 64 queries and one chunk of the centroid axis;
//           each warp owns 8 queries and keeps their top-k lists in
//           registers (lane j = j-th best), 32 centroids scored per step,
//           one per lane; the chunk's lists go to a small partial buffer;
//   pass 2: one warp per query merges the chunks' lists.
// Selection is by the (score, index) pair in lexicographic order, so the
// result, ties included, is the same whatever order blocks finish in.
//
// Bound on the H100: fp32 arithmetic (2*Q*M*d FLOP against reads of
// (Q + M) * d floats: at Q = 256, M = 65,504, d = 128 that is 4.3 GFLOP
// over 34 MB).  The design keeps the score matrix out of device memory,
// stages a 32 x 128 centroid slice in shared memory (row stride 129, so the
// 32 lanes read 32 banks), and gives every centroid value loaded from shared
// memory 8 FMAs (one per query of the warp).  Selection costs one ballot per
// 32 candidates once the lists are full.  Simple SIMT; no tensor cores yet.
#include "topk_common.cuh"

#define CT_WARPS 8
#define CT_QPW 8                       // queries per warp
#define CT_BQ (CT_WARPS * CT_QPW)      // queries per block
#define CT_TM 32                       // centroids per step (one per lane)
#define CT_DK 128                      // feature slice staged at a time

__global__ void __launch_bounds__(CT_WARPS * 32)
centroid_topk_partial(const float* __restrict__ q, const float* __restrict__ c,
                      const uint8_t* __restrict__ vis, int Q, int M, int d,
                      int k, int chunk, int nchunks,
                      float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [CT_BQ][CT_DK]
  float* cs = smem + CT_BQ * CT_DK;          // [CT_TM][CT_DK + 1]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.y * CT_BQ;
  const int m_begin = blockIdx.x * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bool q_once = d <= CT_DK;

  float ls[CT_QPW];
  int li[CT_QPW];
#pragma unroll
  for (int qi = 0; qi < CT_QPW; ++qi) topk_empty(ls[qi], li[qi]);

  if (q_once) {
    for (int e = tid; e < CT_BQ * d; e += blockDim.x) {
      const int r = e / d, col = e % d;
      qs[r * CT_DK + col] = (q0 + r < Q) ? q[(size_t)(q0 + r) * d + col] : 0.f;
    }
  }

  for (int mt = m_begin; mt < m_end; mt += CT_TM) {
    float acc[CT_QPW];
#pragma unroll
    for (int qi = 0; qi < CT_QPW; ++qi) acc[qi] = 0.f;
    float nrm = 0.f;
    for (int k0 = 0; k0 < d; k0 += CT_DK) {
      const int kw = min(CT_DK, d - k0);
      __syncthreads();   // previous slice fully consumed
      if (!q_once) {
        for (int e = tid; e < CT_BQ * kw; e += blockDim.x) {
          const int r = e / kw, col = e % kw;
          qs[r * CT_DK + col] =
              (q0 + r < Q) ? q[(size_t)(q0 + r) * d + k0 + col] : 0.f;
        }
      }
      for (int e = tid; e < CT_TM * kw; e += blockDim.x) {
        const int r = e / kw, col = e % kw;
        const int m = mt + r;
        cs[r * (CT_DK + 1) + col] =
            (m < m_end) ? c[(size_t)m * d + k0 + col] : 0.f;
      }
      __syncthreads();
      const float* crow = cs + lane * (CT_DK + 1);
      const float* qrow = qs + warp * CT_QPW * CT_DK;
      for (int kk = 0; kk < kw; ++kk) {
        const float cv = crow[kk];
        nrm += cv * cv;
#pragma unroll
        for (int qi = 0; qi < CT_QPW; ++qi)
          acc[qi] += qrow[qi * CT_DK + kk] * cv;
      }
    }
    const int m = mt + lane;
    const bool in_range = m < m_end;
    const bool visible = in_range && vis[m];
#pragma unroll
    for (int qi = 0; qi < CT_QPW; ++qi) {
      const float s = visible ? nrm - 2.f * acc[qi] : REPRO_BIG;
      topk_insert_lanes(ls[qi], li[qi], s, m, in_range, k, lane);
    }
  }

#pragma unroll
  for (int qi = 0; qi < CT_QPW; ++qi) {
    const int qq = q0 + warp * CT_QPW + qi;
    if (qq < Q && lane < k) {
      const size_t o = ((size_t)qq * nchunks + blockIdx.x) * k + lane;
      part_s[o] = ls[qi];
      part_i[o] = li[qi];
    }
  }
}

__global__ void __launch_bounds__(256)
topk_merge_parts(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, int Q, int nparts, int k,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qq = blockIdx.x * (blockDim.x / 32) + warp;
  if (qq >= Q) return;                       // whole warp leaves together
  float ls;
  int li;
  topk_empty(ls, li);
  for (int p = 0; p < nparts; ++p) {
    const size_t o = ((size_t)qq * nparts + p) * k + lane;
    const bool has = lane < k;
    const float s = has ? part_s[o] : CUDART_INF_F;
    const int i = has ? part_i[o] : INT_MAX;
    topk_insert_lanes(ls, li, s, i, has && i != INT_MAX, k, lane);
  }
  if (lane < k) {
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = li;
  }
}

// q (Q, d), c (M, d) fp32; vis (M,) bool bytes; 1 <= k <= min(32, M).
// part_s/part_i: (Q, nchunks, k) scratch; out_s/out_i: (Q, k).
// ``chunk`` is a multiple of 32 with nchunks * chunk >= M.
extern "C" int centroid_topk(const float* q, const float* c,
                             const uint8_t* vis, int Q, int M, int d, int k,
                             int chunk, int nchunks, float* part_s,
                             int* part_i, float* out_s, int* out_i,
                             void* stream) {
  const size_t smem =
      sizeof(float) * (CT_BQ * CT_DK + CT_TM * (CT_DK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      centroid_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid1(nchunks, (Q + CT_BQ - 1) / CT_BQ);
  centroid_topk_partial<<<grid1, CT_WARPS * 32, smem, st>>>(
      q, c, vis, Q, M, d, k, chunk, nchunks, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_parts<<<(Q + 7) / 8, 256, 0, st>>>(part_s, part_i, Q, nchunks,
                                                k, out_s, out_i);
  return (int)cudaGetLastError();
}
