// kmeans_assign: for each batch b and point n, the nearest centroid
//     assign[b, n] = argmin_j ||c_bj||^2 - 2 p_bn . c_bj,  best[b, n] = its score
// with the lowest index winning ties; masked points get -1 and BIG.
// Point batch b reads points[b % Bp], so one launch encodes a set of rows
// under several codebook versions (B = V*m centroid batches, Bp = m).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign.py:
// kmeans_assign, which the JAX package vmaps over the m PQ subspaces and
// which carries a running (best, index) pair across centroid tiles of a
// sequential grid.  Here the subspaces are the grid's y axis (one launch
// for all of them), each thread owns one point, and the block walks the
// centroid axis in tiles of 32 staged in shared memory (8 features at a
// time): the thread keeps 32 dot-product accumulators in registers and a
// running (best, index) pair, updated with a strict < in index order, so
// the lowest index wins a tie.  Every sum runs in feature order, so a
// point's result does not depend on how many points share the launch.
//
// Bound on the H100: fp32 arithmetic, 2*B*N*K*d FLOP (16 x 20,000 x 256 x
// 8 x 2 = 1.3 GFLOP per Lloyd step of the generation-0 codebooks) against
// (B*N + B*K)*d*4 bytes read.  Every centroid value loaded from shared
// memory (a broadcast to the warp) feeds one FMA; no tensor cores.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define KA_THREADS 256
#define KA_TK 32     // centroids per tile: one accumulator each
#define KA_DC 8      // features staged per step (KA_TK * KA_DC == KA_THREADS)
#define KA_BIG 1e30f

__global__ void __launch_bounds__(KA_THREADS)
kmeans_assign_kernel(const float* __restrict__ pts, long long sb,
                     long long sn, int Bp, const float* __restrict__ cents,
                     int N, int K, int d, const uint8_t* __restrict__ mask,
                     int* __restrict__ out_a, float* __restrict__ out_b) {
  __shared__ float cs[KA_TK][KA_DC];
  __shared__ float cn[KA_TK];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * KA_THREADS + tid;
  const bool live = n < N;
  const float* prow = pts + (size_t)(b % Bp) * sb + (size_t)(live ? n : 0) * sn;
  const float* cb = cents + (size_t)b * K * d;
  float best = CUDART_INF_F;
  int bidx = 0;
  for (int k0 = 0; k0 < K; k0 += KA_TK) {
    const int kw = min(KA_TK, K - k0);
    float acc[KA_TK];
#pragma unroll
    for (int j = 0; j < KA_TK; ++j) acc[j] = 0.f;
    float mynorm = 0.f;
    for (int t0 = 0; t0 < d; t0 += KA_DC) {
      __syncthreads();                       // previous slice consumed
      {
        const int j = tid / KA_DC, t = tid % KA_DC;
        cs[j][t] = (j < kw && t0 + t < d) ? cb[(size_t)(k0 + j) * d + t0 + t]
                                          : 0.f;
      }
      __syncthreads();
      if (tid < KA_TK) {
#pragma unroll
        for (int t = 0; t < KA_DC; ++t) mynorm += cs[tid][t] * cs[tid][t];
      }
      float x[KA_DC];
#pragma unroll
      for (int t = 0; t < KA_DC; ++t)
        x[t] = (live && t0 + t < d) ? prow[t0 + t] : 0.f;
#pragma unroll
      for (int j = 0; j < KA_TK; ++j) {
#pragma unroll
        for (int t = 0; t < KA_DC; ++t) acc[j] += x[t] * cs[j][t];
      }
    }
    if (tid < KA_TK) cn[tid] = mynorm;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KA_TK; ++j) {
      if (j < kw) {
        const float s = cn[j] - 2.f * acc[j];
        if (s < best) {
          best = s;
          bidx = k0 + j;
        }
      }
    }
  }
  if (!live) return;
  const bool keep = mask == nullptr || mask[n];
  out_a[(size_t)b * N + n] = keep ? bidx : -1;
  out_b[(size_t)b * N + n] = keep ? best : KA_BIG;
}

// pts: point batch b' at pts + b'*sb, point n at + n*sn, features
// contiguous (dsub = d of them); Bp point batches, B centroid batches
// (B % Bp == 0); cents (B, K, d) contiguous; mask (N,) bool bytes or null.
// out_a (B, N) int32, out_b (B, N) fp32.
extern "C" int kmeans_assign(const float* pts, long long sb, long long sn,
                             int Bp, const float* cents, int B, int N, int K,
                             int d, const uint8_t* mask, int* out_a,
                             float* out_b, void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  dim3 grid((N + KA_THREADS - 1) / KA_THREADS, B);
  kmeans_assign_kernel<<<grid, KA_THREADS, 0, (cudaStream_t)stream>>>(
      pts, sb, sn, Bp, cents, N, K, d, mask, out_a, out_b);
  return (int)cudaGetLastError();
}
