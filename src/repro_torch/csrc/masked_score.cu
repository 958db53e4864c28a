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
// Design: the product runs on the tensor cores, mma.sync m16n8k8 TF32 with
// fp32 accumulation, in 3xTF32: each fp32 operand a is split in registers,
// as its fragment is loaded, into hi = tf32_rna(a) and lo = tf32_rna(a - hi),
// and a.b is taken as lo.hi + hi.lo + hi.hi (small products first).  Each
// block owns 128 rows of x (the wide operand) and a query tile of BQ rows,
// a template parameter: BQ = 32 for Q <= 32 (the exact chunk; no padded
// query rows) and BQ = 128 otherwise (the insert locate).  The blocks that
// share an x tile are adjacent in the launch order, so the tile is read
// from HBM once and from L2 by the others.  d goes through shared memory
// in 32-deep slices, copied with cp.async into a three-stage ring: 16-byte
// copies where q and x are 16-byte aligned and d % 4 == 0, else 4-byte
// copies; the ragged edge (d, Q or N not a multiple of the tile) is
// zero-filled by the copy.  ||x_j||^2 is summed with fp32 FMA from the
// staged fp32 slices, so x is read once; the accumulators go through
// shared memory and out in 16-byte streaming stores along N, with the norm
// and the mask applied on the way.
// The split, the product and the copies are in tf32x3.cuh, with the error
// bound (about 3 * 2^-22 relative a product; exact on integer-valued
// inputs below 2^11).
// Not yet: wgmma (it needs both TF32 halves staged in shared memory), TMA,
// and a persistent grid; those are a later step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define SCORE_BIG 1e30f

namespace {

constexpr int BN = 128;               // x rows per block
constexpr int BK = 32;                // depth of one staged slice
constexpr int LDS = BK + 4;           // padded row of a staged slice
constexpr int CTS = BN + 8;           // padded row of the output tile
constexpr int STAGES = 3;

// Stage rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of a (rows, d)
// row-major matrix into dst[ROWS][LDS]; out-of-range elements are zero.
template <int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int rows, int row0, int d, int k0,
                                           int tid) {
  static_assert((ROWS * BK / 4) % NT == 0, "whole chunks per thread");
  if (VEC) {
#pragma unroll
    for (int i = 0; i < ROWS * (BK / 4) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BK / 4);
      const int kc = (c % (BK / 4)) * 4;
      const int gr = row0 + r;
      const int col = k0 + kc;
      const bool ok = gr < rows && col < d;
      cp_async16(dst + r * LDS + kc, ok ? src + (size_t)gr * d + col : src,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * BK / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / BK;
      const int kk = e % BK;
      const int gr = row0 + r;
      const int col = k0 + kk;
      const bool ok = gr < rows && col < d;
      cp_async4(dst + r * LDS + kk, ok ? src + (size_t)gr * d + col : src,
                ok ? 4 : 0);
    }
  }
}

template <int BQ>
struct Tile {
  static constexpr int WARPS_Q = BQ == 32 ? 1 : 2;
  static constexpr int WARPS_N = 4;
  static constexpr int NT = 32 * WARPS_Q * WARPS_N;    // threads
  static constexpr int MT = BQ / WARPS_Q / 16;         // m16 tiles a warp
  static constexpr int NTL = BN / WARPS_N / 8;         // n8 tiles a warp
  static constexpr int NPART = NT / BN;                // threads per x row
  static constexpr int MIN_BLOCKS = BQ == 32 ? 3 : 2;  // per SM
  static constexpr int PIPE = STAGES * (BQ + BN) * LDS;  // floats
  static constexpr int EPI = BQ * CTS;                  // floats
  static constexpr size_t SMEM =
      sizeof(float) * ((PIPE > EPI ? PIPE : EPI) + NPART * BN);
};

template <int BQ, bool VEC>
__global__ void __launch_bounds__(Tile<BQ>::NT, Tile<BQ>::MIN_BLOCKS)
masked_score_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    const uint8_t* __restrict__ mask, int Q, int N, int d,
                    float* __restrict__ out, int n_qtiles, bool vec_out) {
  using T = Tile<BQ>;
  extern __shared__ __align__(16) float smem[];
  float* pipe = smem;
  float* ct = smem;                          // the output tile, after the loop
  float* part = smem + (T::PIPE > T::EPI ? T::PIPE : T::EPI);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // mma groupID
  const int t = lane & 3;                    // mma threadID_in_group
  const int wq0 = (warp / T::WARPS_N) * (BQ / T::WARPS_Q);
  const int wn0 = (warp % T::WARPS_N) * (BN / T::WARPS_N);
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int n0 = (blockIdx.x / n_qtiles) * BN;
  const int nr = tid % BN;                   // the x row this thread norms
  const int np = tid / BN;                   // and which part of the slice

  float acc[T::MT][T::NTL][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float nrm = 0.f;

  auto stage_q = [&](int s) { return pipe + s * (BQ + BN) * LDS; };
  auto stage_x = [&](int s) { return pipe + s * (BQ + BN) * LDS + BQ * LDS; };
  auto load = [&](int s, int k0) {
    load_slice<BQ, T::NT, VEC>(stage_q(s), q, Q, q0, d, k0, tid);
    load_slice<BN, T::NT, VEC>(stage_x(s), x, N, n0, d, k0, tid);
  };

  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled here was read in iteration kt - 1, which every
    // thread has finished at the barrier above
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();

    const float* qs = stage_q(kt % STAGES);
    const float* xs = stage_x(kt % STAGES);
    // ||x_j||^2 from the staged fp32 slice: 16-byte reads along the row
    // (a quarter warp reads 8 rows at one column: no bank conflict)
#pragma unroll
    for (int c = 0; c < BK / 4 / T::NPART; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          xs + nr * LDS + (np * (BK / 4 / T::NPART) + c) * 4);
      nrm = fmaf(v.x, v.x, nrm);
      nrm = fmaf(v.y, v.y, nrm);
      nrm = fmaf(v.z, v.z, nrm);
      nrm = fmaf(v.w, v.w, nrm);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[T::NTL][2], bl[T::NTL][2];
#pragma unroll
      for (int j = 0; j < T::NTL; ++j) {
        const float* xr = xs + (wn0 + j * 8 + g) * LDS + kk + t;
        split_tf32(xr[0], bh[j][0], bl[j][0]);
        split_tf32(xr[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float* qr = qs + (wq0 + i * 16 + g) * LDS + kk + t;
        uint32_t ah[4], al[4];
        split_tf32(qr[0], ah[0], al[0]);
        split_tf32(qr[8 * LDS], ah[1], al[1]);
        split_tf32(qr[4], ah[2], al[2]);
        split_tf32(qr[8 * LDS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < T::NTL; ++j) {
          mma_tf32(acc[i][j], al, bh[j]);
          mma_tf32(acc[i][j], ah, bl[j]);
          mma_tf32(acc[i][j], ah, bh[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free: reuse it as ct

  part[np * BN + nr] = nrm;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j) {
      const int r = wq0 + i * 16 + g;
      const int c = wn0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(ct + r * CTS + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(ct + (r + 8) * CTS + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
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
    for (int u = 0; u < 4; ++u) {
      float xn = part[c + u];
#pragma unroll
      for (int p = 1; p < T::NPART; ++p) xn += part[p * BN + c + u];
      v[u] = (col + u < N && mask[col + u]) ? xn - 2.f * av[u] : SCORE_BIG;
    }
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
  // above 48 KB of shared memory only by opting in, once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !((opted >> dev) & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_score_kernel<BQ, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted |= 1ull << dev;
  }
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)n_qtiles * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec_out = (N % 4 == 0) && ((uintptr_t)out % 16 == 0);
  masked_score_kernel<BQ, VEC><<<(unsigned)blocks, T::NT, T::SMEM, stream>>>(
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
