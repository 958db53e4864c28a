// masked_score: out[i, j] = mask[j] ? ||x_j||^2 - 2 q_i . x_j : BIG  (fp32)
//
// Replaces two Pallas TPU kernels that compute the same function:
//   src/repro/kernels/centroid_score.py:centroid_score  (x = centroids,
//       mask = posting visibility; insert locate, balance scoring, cache scan)
//   src/repro/kernels/posting_scan.py:posting_scan      (x = posting tiles
//       flattened to (M*C, d), mask = live slots; the exact oracle)
//
// Bound on the H100, at the main path's two shapes (d = 128):
//   * insert locate, Q = 2048 against 65,504 centroids: 34 GFLOP of fp32
//     products and a 537 MB (Q, N) write.  At 67 TFLOP/s outside the
//     tensor cores that is bound by operations (0.51 ms); on the tensor
//     cores in 3xTF32 (three TF32 products at 495 TFLOP/s) by about 0.21 ms.
//   * exact chunk, Q = 32 against 6.3M posting slots: 3.2 GB of tiles read
//     and an 805 MB write, 16 FLOP per byte of tiles: bound by bytes
//     (1.20 ms), but only if the products keep pace, which fp32 FMA cannot
//     (it would need 80% of its peak).
// Design: each block owns 128 rows of x (the wide operand) and a query
// tile of BQ rows, a template parameter: BQ = 32 for Q <= 32 (the exact
// chunk; no padded query rows) and BQ = 128 otherwise (the insert locate).
// The blocks that share an x tile are adjacent in the launch order, so the
// tile is read from HBM once and from L2 by the others.  The mainloop is
// score_tile.cuh, which centroid_topk.cu runs too: the product on the
// tensor cores in 3xTF32 (tf32x3.cuh: the split and its error bound, about
// 3 * 2^-22 relative a product, exact on integer-valued inputs below
// 2^11), d through a three-stage cp.async ring of 32-deep slices, and
// ||x_j||^2 from the staged slices, so x is read once.  The accumulators go
// through shared memory and out in 16-byte streaming stores along N, with
// the norm and the mask applied on the way.
// Not yet: wgmma (it needs both TF32 halves staged in shared memory), TMA,
// and a persistent grid; those are a later step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

template <int BQ>
struct Smem {
  static constexpr int MIN_BLOCKS = BQ == 32 ? 3 : 2;  // per SM
  // the output tile reuses the ring, after the loop
  static constexpr int CT = Tile<BQ>::PIPE > Tile<BQ>::EPI ? Tile<BQ>::PIPE
                                                           : Tile<BQ>::EPI;
  static constexpr size_t BYTES = sizeof(float) * (CT + BN);
};

template <int BQ, bool VEC>
__global__ void __launch_bounds__(Tile<BQ>::NT, Smem<BQ>::MIN_BLOCKS)
masked_score_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const uint8_t* __restrict__ mask, int Q, int N, int d,
                    float* __restrict__ out, int n_qtiles, bool vec_out) {
  using T = Tile<BQ>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;
  float* xn = smem + Smem<BQ>::CT;         // the tile's ||x_j||^2
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int n0 = (blockIdx.x / n_qtiles) * BN;

  Acc<BQ> acc;
  float nrm;
  tile_prologue<BQ, VEC>(smem, q, x, Q, N, d, q0, n0);
  tile_mainloop<BQ, VEC>(smem, q, x, Q, N, d, q0, n0, acc, nrm);
  tile_stage<BQ>(ct, xn, acc, nrm);
  __syncthreads();

  // each thread writes 4 consecutive outputs of one row: a warp writes
  // 512 contiguous bytes of a row of out
#pragma unroll 4
  for (int i = 0; i < BQ * (BN / 4) / T::NT; ++i) {
    const int e = tid + i * T::NT;
    const int r = e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    const int row = q0 + r;
    const int col = n0 + c;
    if (row >= Q || col >= N) continue;
    const float4 a = *reinterpret_cast<const float4*>(ct + r * CTS + c);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = tile_score(xn[c + u], av[u], col + u < N && mask[col + u]);
    float* o = out + (size_t)row * N + col;
    if (vec_out && col + 3 < N) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < N) __stcs(o + u, v[u]);
    }
  }
}

template <int BQ, bool VEC>
int launch(const float* q, const float* x, const uint8_t* mask, int Q, int N,
           int d, float* out, cudaStream_t stream) {
  using T = Tile<BQ>;
  constexpr size_t smem = Smem<BQ>::BYTES;
  // above 48 KB of shared memory only by opting in, once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !((opted >> dev) & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_score_kernel<BQ, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted |= 1ull << dev;
  }
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)n_qtiles * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec_out = (N % 4 == 0) && ((uintptr_t)out % 16 == 0);
  masked_score_kernel<BQ, VEC><<<(unsigned)blocks, T::NT, smem, stream>>>(
      q, x, mask, Q, N, d, out, n_qtiles, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Q, d), x (N, d) fp32 row-major; mask (N,) bool bytes; out (Q, N) fp32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int masked_score(const float* q, const float* x,
                            const uint8_t* mask, int Q, int N, int d,
                            float* out, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  if (Q <= 32)
    return vec ? launch<32, true>(q, x, mask, Q, N, d, out, s)
               : launch<32, false>(q, x, mask, Q, N, d, out, s);
  return vec ? launch<128, true>(q, x, mask, Q, N, d, out, s)
             : launch<128, false>(q, x, mask, Q, N, d, out, s);
}
