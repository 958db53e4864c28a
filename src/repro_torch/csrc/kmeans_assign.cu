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
// for all of them).
//
// Bound on the H100: fp32 arithmetic, 2*B*N*K*d FLOP against (B*N + B*K)*d*4
// bytes read.  At the generation-0 fit (16 x 20,000 x 256 x 8) that is 1.3
// GFLOP, 0.0196 ms at 67 TFLOP/s; at the re-train's full re-encode (16 x
// 6,288,384 slots x 256 x 8) 4.1e11 FLOP, 6.2 ms.  No tensor cores: at d = 8
// the product is one MMA k-step, and a TF32 split could move near-tie codes.
//
// Design (register tiles, SIMT fp32):
//   * The block stages its batch's codebook in shared memory once (K*d
//     floats, 8 KB at K=256, d=8), rows padded to DR, a multiple of 4, with
//     zeros, and computes each centroid's norm once there; only a codebook
//     past SMEM_FLOATS goes through in tiles of centroids.
//   * Each thread owns PPT points (4 at d <= 16), loaded once into registers
//     (16-byte loads where the rows allow).  Every 16-byte broadcast of a
//     centroid from shared memory then feeds 4 * PPT FMAs, so the FMA pipe,
//     not the load/store unit, sets the pace; the score cn - 2 acc and a
//     strict < in index order keep the running (best, index) pair.
//   * Every dot product and norm is summed in feature order by one thread, so
//     a point's result does not depend on how many points or batches share
//     the launch (the codes invariant re-encodes on the card and compares
//     exactly), and on integer inputs it equals the plain version bit for bit.
//   * Blocks of 128 threads (512 points), halved down to 64 while the grid
//     has fewer than two blocks per SM: the fit (N = 20,000 under 16
//     codebooks) gets 640 blocks, the insert round's encode (N = 2,048
//     under 32) 256; small blocks even out the blocks an SM gets.
//   * Past d = 32 the point does not fit in registers: one point per thread,
//     its features read from L1 for every centroid (no main path has it).
// `-Xptxas -v` for sm_90a (printed in phase 1 of chip_smoke.py): 56, 64 (8
// bytes spilled), 96 and 96 registers at d <= 4, 8, 16 and 32, and 32 past
// that.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 128;
constexpr int MIN_THREADS = 64;
constexpr float BIG = 1e30f;
// the codebook stage, rows and norms: 32 KB, under the 48 KB that needs no
// opt-in
constexpr int SMEM_FLOATS = 8192;

// DR: features a thread keeps in registers (d rounded up to a multiple of
// 4), or 0 past 32; PPT: points per thread
template <int DR, int PPT>
__global__ void __launch_bounds__(MAX_THREADS)
kmeans_assign_kernel(const float* __restrict__ pts, long long sb,
                     long long sn, int Bp, const float* __restrict__ cents,
                     int N, int K, int d, const uint8_t* __restrict__ mask,
                     int* __restrict__ out_a, float* __restrict__ out_b,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ds = DR > 0 ? DR : (d + 3) & ~3;      // staged row stride
  const int kt = min(K, max(1, SMEM_FLOATS / (ds + 1)));  // centroids a stage
  float* cs = smem;                               // [kt][ds]
  float* cn = smem + kt * ds;                     // [kt]
  const float* cb = cents + (size_t)b * K * d;
  const float* pb = pts + (size_t)(b % Bp) * sb;

  int n[PPT];
  float x[PPT][DR > 0 ? DR : 1];
  float best[PPT];
  int bidx[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    n[p] = (blockIdx.x * PPT + p) * nt + tid;
    best[p] = CUDART_INF_F;
    bidx[p] = 0;
    if constexpr (DR > 0) {
      const float* row = pb + (size_t)(n[p] < N ? n[p] : 0) * sn;
      if (vec && n[p] < N) {
#pragma unroll
        for (int f = 0; f < DR; f += 4) {
          const float4 v =
              f < d ? __ldg(reinterpret_cast<const float4*>(row + f))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
          x[p][f] = v.x;
          x[p][f + 1] = v.y;
          x[p][f + 2] = v.z;
          x[p][f + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int f = 0; f < DR; ++f)
          x[p][f] = (n[p] < N && f < d) ? __ldg(row + f) : 0.f;
      }
    }
  }
  const float* prow = pb + (size_t)(n[0] < N ? n[0] : 0) * sn;  // DR == 0

  for (int k0 = 0; k0 < K; k0 += kt) {
    const int kw = min(kt, K - k0);
    if (k0 > 0) __syncthreads();                  // the last stage is read
    for (int e = tid; e < kw * ds; e += nt) {
      const int j = e / ds, f = e - j * ds;
      cs[e] = f < d ? cb[(size_t)(k0 + j) * d + f] : 0.f;
    }
    __syncthreads();
    for (int j = tid; j < kw; j += nt) {
      float s = 0.f;
      for (int f = 0; f < d; ++f) s = fmaf(cs[j * ds + f], cs[j * ds + f], s);
      cn[j] = s;
    }
    __syncthreads();

    if constexpr (DR > 0) {
#pragma unroll 2
      for (int j = 0; j < kw; ++j) {
        const float4* c4 = reinterpret_cast<const float4*>(cs + j * DR);
        float acc[PPT];
#pragma unroll
        for (int p = 0; p < PPT; ++p) acc[p] = 0.f;
#pragma unroll
        for (int f = 0; f < DR / 4; ++f) {
          const float4 c = c4[f];
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            acc[p] = fmaf(x[p][4 * f], c.x, acc[p]);
            acc[p] = fmaf(x[p][4 * f + 1], c.y, acc[p]);
            acc[p] = fmaf(x[p][4 * f + 2], c.z, acc[p]);
            acc[p] = fmaf(x[p][4 * f + 3], c.w, acc[p]);
          }
        }
        const float cj = cn[j];
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          const float s = cj - 2.f * acc[p];
          if (s < best[p]) {
            best[p] = s;
            bidx[p] = k0 + j;
          }
        }
      }
    } else {
      for (int j = 0; j < kw; ++j) {
        const float* c = cs + j * ds;
        float acc = 0.f;
        for (int f = 0; f < d; ++f) acc = fmaf(__ldg(prow + f), c[f], acc);
        const float s = cn[j] - 2.f * acc;
        if (s < best[0]) {
          best[0] = s;
          bidx[0] = k0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    if (n[p] >= N) continue;
    const bool keep = mask == nullptr || mask[n[p]];
    out_a[(size_t)b * N + n[p]] = keep ? bidx[p] : -1;
    out_b[(size_t)b * N + n[p]] = keep ? best[p] : BIG;
  }
}

template <int DR, int PPT>
int launch(const float* pts, long long sb, long long sn, int Bp,
           const float* cents, int B, int N, int K, int d,
           const uint8_t* mask, int* out_a, float* out_b, cudaStream_t s) {
  static int sm_count[64] = {0};                  // per device, read once
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sm_count[dev & 63];
  if (sms == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int nt = MAX_THREADS;
  while (nt > MIN_THREADS &&
         (long long)B * ((N + (long long)nt * PPT - 1) / (nt * PPT)) <
             2LL * sms)
    nt /= 2;
  const int ds = DR > 0 ? DR : (d + 3) & ~3;
  const int kt = min(K, max(1, SMEM_FLOATS / (ds + 1)));
  const size_t smem = sizeof(float) * (size_t)kt * (ds + 1);
  const int vec = d % 4 == 0 && sn % 4 == 0 && sb % 4 == 0 &&
                  (uintptr_t)pts % 16 == 0;
  dim3 grid((unsigned)((N + (long long)nt * PPT - 1) / (nt * PPT)), B);
  kmeans_assign_kernel<DR, PPT><<<grid, nt, smem, s>>>(
      pts, sb, sn, Bp, cents, N, K, d, mask, out_a, out_b, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// pts: point batch b' at pts + b'*sb, point n at + n*sn, features
// contiguous (dsub = d of them); Bp point batches, B centroid batches
// (B % Bp == 0); cents (B, K, d) contiguous; mask (N,) bool bytes or null.
// out_a (B, N) int32, out_b (B, N) fp32.
extern "C" int kmeans_assign(const float* pts, long long sb, long long sn,
                             int Bp, const float* cents, int B, int N, int K,
                             int d, const uint8_t* mask, int* out_a,
                             float* out_b, void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define KA_LAUNCH(DR, PPT)                                                \
  launch<DR, PPT>(pts, sb, sn, Bp, cents, B, N, K, d, mask, out_a, out_b, \
                  s)
  if (d <= 4) return KA_LAUNCH(4, 4);
  if (d <= 8) return KA_LAUNCH(8, 4);
  if (d <= 16) return KA_LAUNCH(16, 4);
  if (d <= 32) return KA_LAUNCH(32, 2);
  return KA_LAUNCH(0, 1);
#undef KA_LAUNCH
}
