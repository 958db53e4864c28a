// masked_score: out[i, j] = mask[j] ? ||x_j||^2 - 2 q_i . x_j : BIG  (fp32)
//
// Replaces two Pallas TPU kernels that compute the same function:
//   src/repro/kernels/centroid_score.py:centroid_score  (x = centroids,
//       mask = posting visibility; insert locate, balance scoring, cache scan)
//   src/repro/kernels/posting_scan.py:posting_scan      (x = posting tiles
//       flattened to (M*C, d), mask = live slots; the exact oracle)
//
// Bound on the H100: at the main path's shapes (Q = 32..1024 rows against
// 65,504 centroids or 6.3M slots, d = 128) the product has 64-256 FLOP per
// byte of input and output, so it is bound by fp32 arithmetic outside the
// tensor cores.  The design is a plain tiled SIMT product: a 64x64 output
// tile per block, 16-deep slices of q and x staged in shared memory, 4x4
// outputs per thread held in registers.  The norm ||x_j||^2 is summed from
// the resident x slices (the TPU kernel's fused norm epilogue, so x is read
// once) and the mask is applied when the tile is written.  No tensor cores,
// TMA or wgmma yet: a simple, right kernel first.
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BN 64
#define BK 16
#define NTHREADS 256
#define SCORE_BIG 1e30f

__global__ void __launch_bounds__(NTHREADS)
masked_score_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const uint8_t* __restrict__ mask, int Q, int N, int d,
                    float* __restrict__ out) {
  __shared__ float qs[BK][BQ + 1];
  __shared__ float xs[BK][BN + 1];
  __shared__ float xn[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * BQ;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BQ * BK) / NTHREADS; ++e) {
      const int idx = tid + NTHREADS * e;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int col = k0 + kk;
      const int qr = q0 + r;
      const int xr = n0 + r;
      qs[kk][r] = (qr < Q && col < d) ? q[(size_t)qr * d + col] : 0.f;
      xs[kk][r] = (xr < N && col < d) ? x[(size_t)xr * d + col] : 0.f;
    }
    __syncthreads();
    if (tid < BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm += xs[kk][tid] * xs[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  if (tid < BN) xn[tid] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      out[(size_t)row * N + col] =
          mask[col] ? xn[tx + 16 * j] - 2.f * acc[i][j] : SCORE_BIG;
    }
  }
}

// q (Q, d), x (N, d) fp32 row-major; mask (N,) bool bytes; out (Q, N) fp32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int masked_score(const float* q, const float* x,
                            const uint8_t* mask, int Q, int N, int d,
                            float* out, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid((N + BN - 1) / BN, (Q + BQ - 1) / BQ);
  masked_score_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      q, x, mask, Q, N, d, out);
  return (int)cudaGetLastError();
}
