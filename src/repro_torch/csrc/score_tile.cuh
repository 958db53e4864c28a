// The scoring mainloop shared by masked_score.cu and centroid_topk.cu:
//     s[i, j] = mask[j] ? ||x_j||^2 - 2 q_i . x_j : SCORE_BIG   (fp32)
// over one tile of BQ query rows by BN = 128 rows of x.
//
// The product runs on the tensor cores, mma.sync m16n8k8 TF32 with fp32
// accumulation, in 3xTF32 (tf32x3.cuh): a.b is taken as lo.hi + hi.lo +
// hi.hi, small products first.  d goes through shared memory in 32-deep
// slices, copied with cp.async into a three-stage ring: 16-byte copies
// where q and x are 16-byte aligned and d % 4 == 0 (VEC), else 4-byte
// copies; the ragged edge (d, Q or N not a multiple of the tile) is
// zero-filled by the copy.  ||x_j||^2 is summed with fp32 FMA from the
// staged fp32 slices, one thread a row of x (the first BN threads, in
// feature order), so x is read once.  After the loop the accumulators and
// the norms go to shared memory (tile_stage), and tile_score applies the
// norm and the mask.
//
// Both kernels run exactly this code, so a score that centroid_topk ranks
// is bit for bit the score masked_score writes for the same (q, x, mask):
// the same slices in the same order, the same three products and the same
// norm, whatever query tile either kernel takes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define SCORE_BIG 1e30f

namespace score_tile {

constexpr int BN = 128;               // x rows per tile
constexpr int BK = 32;                // depth of one staged slice
constexpr int LDS = BK + 4;           // padded row of a staged slice
constexpr int CTS = BN + 8;           // padded row of the staged scores
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

// The warp layout of a BQ x BN tile: BQ = 16 or 32 takes 4 warps (one warp
// row), a wider query tile 8 (two warp rows).
template <int BQ>
struct Tile {
  static constexpr int WARPS_Q = BQ <= 32 ? 1 : 2;
  static constexpr int WARPS_N = 4;
  static constexpr int NT = 32 * WARPS_Q * WARPS_N;    // threads
  static constexpr int MT = BQ / WARPS_Q / 16;         // m16 tiles a warp
  static constexpr int NTL = BN / WARPS_N / 8;         // n8 tiles a warp
  static constexpr int STAGE = (BQ + BN) * LDS;        // floats a stage
  static constexpr int PIPE = STAGES * STAGE;          // floats
  static constexpr int EPI = BQ * CTS;                 // floats
};

template <int BQ>
using Acc = float[Tile<BQ>::MT][Tile<BQ>::NTL][4];

// Issue the first STAGES - 1 slices of the tile (q0, n0) into the ring
// ``pipe``.  Every thread calls it; the ring must be free.
template <int BQ, bool VEC>
__device__ __forceinline__ void tile_prologue(float* pipe, const float* q,
                                              const float* x, int Q, int N,
                                              int d, int q0, int n0) {
  using T = Tile<BQ>;
  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_slice<BQ, T::NT, VEC>(pipe + s * T::STAGE, q, Q, q0, d, s * BK,
                                 threadIdx.x);
      load_slice<BN, T::NT, VEC>(pipe + s * T::STAGE + BQ * LDS, x, N, n0, d,
                                 s * BK, threadIdx.x);
    }
    cp_async_commit();
  }
}

// The tile's products and norm partials, after tile_prologue.  Ends with
// every copy landed and a block barrier: the ring is free again.  Stage
// STAGES - 1 is first written in the first iteration, after its barrier.
template <int BQ, bool VEC>
__device__ __forceinline__ void tile_mainloop(float* pipe, const float* q,
                                              const float* x, int Q, int N,
                                              int d, int q0, int n0,
                                              Acc<BQ>& acc, float& nrm) {
  using T = Tile<BQ>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // mma groupID
  const int t = lane & 3;                    // mma threadID_in_group
  const int wq0 = (warp / T::WARPS_N) * (BQ / T::WARPS_Q);
  const int wn0 = (warp % T::WARPS_N) * (BN / T::WARPS_N);

#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  nrm = 0.f;

  const int nk = (d + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled here was read in iteration kt - 1, which every
    // thread has finished at the barrier above
    if (kt + STAGES - 1 < nk) {
      float* st = pipe + ((kt + STAGES - 1) % STAGES) * T::STAGE;
      const int k0 = (kt + STAGES - 1) * BK;
      load_slice<BQ, T::NT, VEC>(st, q, Q, q0, d, k0, tid);
      load_slice<BN, T::NT, VEC>(st + BQ * LDS, x, N, n0, d, k0, tid);
    }
    cp_async_commit();

    const float* qs = pipe + (kt % STAGES) * T::STAGE;
    const float* xs = qs + BQ * LDS;
    // ||x_j||^2 from the staged fp32 slice, thread j for row j: 16-byte
    // reads along the row (a quarter warp reads 8 rows at one column: no
    // bank conflict)
    if (tid < BN) {                          // whole warps
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + tid * LDS + c * 4);
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
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
  __syncthreads();
}

// The accumulators to ct[BQ][CTS] and the norms to xn[BN]; the caller
// syncs the block before reading either.
template <int BQ>
__device__ __forceinline__ void tile_stage(float* ct, float* xn,
                                           const Acc<BQ>& acc, float nrm) {
  using T = Tile<BQ>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq0 = (warp / T::WARPS_N) * (BQ / T::WARPS_Q);
  const int wn0 = (warp % T::WARPS_N) * (BN / T::WARPS_N);
  if (tid < BN) xn[tid] = nrm;
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
}

__device__ __forceinline__ float tile_score(float xn, float dot, bool ok) {
  return ok ? xn - 2.f * dot : SCORE_BIG;
}

}  // namespace score_tile
