// flash_attention: online-softmax attention for the serving embed backbone.
//     out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over the keys j that the mask keeps, g = h / (Hq / Hkv) (GQA).  Query row
// i sits at position Lk - Lq + i (the ends align); causal keeps keys at or
// before it, window > 0 keeps keys after qpos - window.  Masked logits are
// NEG = -1e30 and the denominator is clamped at 1e-30, as in the
// reference, so a row with no valid key never turns into NaN.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (called at flash_attention.py:107).  There the sequential grid axis over
// key tiles carries (m, l, acc) in VMEM scratch from one grid step to the
// next; blocks on Hopper run in no order, so the key-tile loop runs inside
// the block.  q is scaled before the product, as the TPU kernel does.
//
// Bound on the H100: operations.  At the serving path's shape (B=64, Hq=32,
// Hkv=4, L=512, D=64, causal) the two products are 4 B Hq D L(L+1)/2 =
// 6.9e10 FLOP: 1.03 ms at 67 TFLOP/s in fp32 outside the tensor cores, and
// 0.42 ms in 3xTF32 (three TF32 products at 495 TFLOP/s), against 604 MB
// read and written once (0.18 ms at 3.35 TB/s).
//
// Design (FA2's work split on mma.sync):
//   * Both products on the tensor cores, mma.sync m16n8k8 TF32 with fp32
//     accumulation, in 3xTF32 (tf32x3.cuh): fp32 accuracy, exact products
//     on integer-valued inputs below 2^11.  Every operand is split into its
//     hi and lo halves with integer operations as its fragment is loaded;
//     the same split with cvt.rna.tf32 bounded an earlier version of this
//     kernel on the conversion unit.
//   * A block of 4 warps owns 64 query rows of one (b, h); each warp owns 16
//     of them and walks the key tiles of 32 on its own, keeping the score
//     tile S (16 x 32), the output O (16 x D) and its rows' running max and
//     sum in registers.  The row max reduces over the 4 lanes of a quad;
//     the sum stays per lane and reduces once, at the end.  S sums its
//     depth in two accumulators (even and odd k-steps), and the three
//     products of each pair go out pass by pass over the n8 tiles, so
//     independent products sit between two that update one accumulator.
//   * P feeds the second product from registers, with no shuffle: both
//     products run their depth in the order (2t, 2t+1) -> (t, t+4), which
//     puts lane (g, t)'s accumulator pair S[g][8j+2t], S[g][8j+2t+1] where
//     the A fragment of P.V wants it, and makes each q and k fragment one
//     8-byte load.  Row strides of 8 mod 32 floats (q, k) and 4 mod 32 (v)
//     keep those loads free of bank conflicts.
//   * q is scaled once into shared memory; the k and v tiles are
//     double-buffered with cp.async (16-byte copies where k and v are
//     16-byte aligned and D % 4 == 0, else 4-byte ones), the copy of tile
//     t+1 in flight behind the products of tile t; the ragged edge (Lk, and
//     D rounded up to the MMA depth of 8) is zero-filled by the copy, so
//     nothing is padded by the wrapper.
//   * Tiles that the mask empties for the whole block are never loaded (the
//     TPU kernel's `live` predicate; what makes a windowed layer
//     sub-quadratic), a warp skips the tiles it empties for its own 16 rows,
//     and only tiles that cross a row's mask boundary are masked element by
//     element.
//   * Launch order: query tiles from the last (causal: the heaviest) to the
//     first, and within one, the Hq/Hkv query heads that share a kv head
//     next to each other, so their k and v come from L2 after the first.
// Shared memory is 256 (2 LDQ + LDV) bytes: 54,272 at D <= 64, four blocks
// (16 warps) an SM under a cap of 128 registers; 103,424 at D = 128, two.
// `-Xptxas -v` for sm_90a (printed in phase 1 of chip_smoke.py): 190, 176,
// 128 (16 bytes spilled), 122, 118 and 96 registers at D = 128, 96, 64,
// 32, 16 and 8.
// Not yet: wgmma with TMA (both TF32 halves staged in shared memory), a
// persistent grid, and q tiles of several heads packed into one block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block, 16 a warp
constexpr int BK = 32;        // keys per tile
constexpr int NJ = BK / 8;    // n8 tiles of a score tile
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// DP: D rounded up to a multiple of the MMA depth (8), one of the widths
// the launch instantiates.  LDQ (q and k rows) = 8 mod 32 and LDV (v rows)
// = 4 mod 32, each at least DP.
template <int DP>
struct Dims {
  static constexpr int LDQ = (DP - 8 + 31) / 32 * 32 + 8;
  static constexpr int LDV = (DP - 4 + 31) / 32 * 32 + 4;
  static constexpr int NTD = DP / 8;            // n8 tiles of the output
  // q, two stages of k and of v
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * LDQ + 2 * BK * LDQ + 2 * BK * LDV);
  // blocks an SM holds: the register cap that lets shared memory decide
  static constexpr int MIN_BLOCKS = DP <= 64 ? 4 : 2;
};

template <int DP>
__global__ void __launch_bounds__(NT, Dims<DP>::MIN_BLOCKS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int B, int Hq, int Hkv, int Lq, int Lk, int D,
                       int causal, int window, float scale, int vec) {
  using T = Dims<DP>;
  constexpr int LDQ = T::LDQ, LDV = T::LDV;
  // output tiles a pass: all of them up to 8, else a divisor of NTD
  constexpr int NG = T::NTD <= 8 ? T::NTD : T::NTD % 8 == 0 ? 8 : 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // [BQ][LDQ]
  float* kst = qs + BQ * LDQ;                       // [2][BK][LDQ]
  float* vst = kst + 2 * BK * LDQ;                  // [2][BK][LDV]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2;                 // mma groupID: row g, g + 8
  const int tig = lane & 3;                  // mma threadID_in_group

  // launch order: query tile (last first), then (b, kv head), then the
  // G query heads that share that kv head
  const int G = Hq / Hkv;
  const int nqt = (Lq + BQ - 1) / BQ;
  int idx = blockIdx.x;
  const int hh = idx % G;
  idx /= G;
  const int bg = idx % (B * Hkv);
  const int qt = nqt - 1 - idx / (B * Hkv);
  const int b = bg / Hkv, h = (bg % Hkv) * G + hh;
  const float* qb = q + ((size_t)b * Hq + h) * Lq * D;
  const float* kb = k + (size_t)bg * Lk * D;
  const float* vb = v + (size_t)bg * Lk * D;
  const int q0 = qt * BQ;

  // the key tiles some row of the block keeps
  const int q_first = Lk - Lq + q0;          // position of the block's row 0
  const int q_last = Lk - Lq + min(q0 + BQ, Lq) - 1;
  int kt_end = (Lk + BK - 1) / BK;
  if (causal) kt_end = q_last < 0 ? 0 : min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q_first - window + 1 > 0)
    kt_begin = (q_first - window + 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    float* ks = kst + stage * BK * LDQ;
    float* vs = vst + stage * BK * LDV;
    if (vec) {
      constexpr int C4 = DP / 4;
#pragma unroll 4
      for (int c = tid; c < BK * C4; c += NT) {
        const int r = c / C4, col = (c % C4) * 4;
        const bool ok = k0 + r < Lk && col < D;
        const size_t off = ok ? (size_t)(k0 + r) * D + col : 0;
        cp_async16(ks + r * LDQ + col, kb + off, ok ? 16 : 0);
        cp_async16(vs + r * LDV + col, vb + off, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < BK * DP; e += NT) {
        const int r = e / DP, col = e % DP;
        const bool ok = k0 + r < Lk && col < D;
        const size_t off = ok ? (size_t)(k0 + r) * D + col : 0;
        cp_async4(ks + r * LDQ + col, kb + off, ok ? 4 : 0);
        cp_async4(vs + r * LDV + col, vb + off, ok ? 4 : 0);
      }
    }
  };

  if (kt_begin < kt_end) load_tile(0, kt_begin);
  cp_async_commit();

  // q, scaled once (rows past Lq and columns past D are zero)
  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, c = e % DP;
    const float x =
        (q0 + r < Lq && c < D) ? qb[(size_t)(q0 + r) * D + c] * scale : 0.f;
    qs[r * LDQ + c] = x;
  }

  // this warp's rows: positions w_first .. w_last, w_rows of them real
  const int wr0 = warp * 16;
  const int w_rows = min(16, Lq - (q0 + wr0));
  const int w_first = q_first + wr0;
  const int w_last = w_first + w_rows - 1;

  float o[T::NTD][4];
#pragma unroll
  for (int n = 0; n < T::NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG, NEG};     // rows gid, gid + 8
  float l_run[2] = {0.f, 0.f};     // this lane's part of the row sums

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < kt_end) load_tile(stage ^ 1, kt + 1);
    cp_async_commit();

    const int k0 = kt * BK;
    if (w_rows <= 0) continue;
    if (causal && k0 > w_last) continue;
    if (window > 0 && k0 + BK - 1 <= w_first - window) continue;
    const float* ks = kst + stage * BK * LDQ;
    const float* vs = vst + stage * BK * LDV;

    // S = q k^T: 16 x BK, NJ n8 tiles, summed in two accumulators (even
    // and odd k-steps) for twice the independent products in flight.  The
    // three products of a pair go out pass by pass over the NJ tiles (every
    // lo.hi, then every hi.lo, then every hi.hi).
    float s[NJ][4], s1[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s1[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      float (*acc)[4] = (kk / 8) % 2 ? s1 : s;
      const int qo = (wr0 + gid) * LDQ + kk + 2 * tig;
      const float2 x0 = *reinterpret_cast<const float2*>(qs + qo);
      const float2 x1 = *reinterpret_cast<const float2*>(qs + qo + 8 * LDQ);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (j * 8 + gid) * LDQ + kk + 2 * tig);
        split_tf32(kv.x, bh[j][0], bl[j][0]);
        split_tf32(kv.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bh[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s1[j][e];

    // element-wise mask, only where the tile crosses a row's boundary
    if (k0 + BK > Lk || (causal && k0 + BK - 1 > w_first) ||
        (window > 0 && k0 <= w_last - window)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = w_first + gid + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * tig + (e & 1);
          bool ok = kpos < Lk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) s[j][e] = NEG;
        }
    }

    // online softmax: the row max over the quad, the sum per lane
    float mt[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = exp2f((m_run[r] - mt[r]) * LOG2E);
      m_run[r] = mt[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mt[e >> 1]) * LOG2E);
        l_run[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < T::NTD; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P v: P's A fragments are this lane's accumulators of S; the
    // products go out pass by pass over groups of up to 8 output tiles
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* vr = vs + (j * 8 + 2 * tig) * LDV + gid;
#pragma unroll
      for (int n0 = 0; n0 < T::NTD; n0 += NG) {
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          split_tf32(vr[(n0 + n) * 8], bh[n][0], bl[n][0]);
          split_tf32(vr[LDV + (n0 + n) * 8], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_tf32(o[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_tf32(o[n0 + n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_tf32(o[n0 + n], ah, bh[n]);
      }
    }
  }
  cp_async_wait<0>();

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
  float* ob = out + ((size_t)b * Hq + h) * Lq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr0 + gid + 8 * r;
    if (row >= Lq) continue;
    float* orow = ob + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < T::NTD; ++n) {
      const int c = n * 8 + 2 * tig;
      if (c < D) orow[c] = o[n][2 * r] / den[r];
      if (c + 1 < D) orow[c + 1] = o[n][2 * r + 1] / den[r];
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Hq, int Hkv, int Lq, int Lk, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Dims<DP>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * Hq * ((Lq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  flash_attention_kernel<DP><<<(unsigned)blocks, NT, smem, stream>>>(
      q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), out (B, Hq, Lq, D): contiguous
// fp32.  1 <= D <= 128, Hq % Hkv == 0, Lk >= 1; window <= 0 means none.
extern "C" int flash_attention(const float* q, const float* k, const float* v,
                               float* out, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int causal, int window,
                               float scale, void* stream) {
  if (D < 1 || D > MAX_D || Hkv < 1 || Hq % Hkv != 0 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Lq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define FA_LAUNCH(DP) \
  launch<DP>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal, window, scale, s)
  if (D <= 8) return FA_LAUNCH(8);
  if (D <= 16) return FA_LAUNCH(16);
  if (D <= 32) return FA_LAUNCH(32);
  if (D <= 64) return FA_LAUNCH(64);
  if (D <= 96) return FA_LAUNCH(96);
  return FA_LAUNCH(128);
#undef FA_LAUNCH
}
