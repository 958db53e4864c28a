// flash_attention: online-softmax attention for the serving embed backbone.
//     out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over the keys j that the mask keeps, g = h / (Hq / Hkv) (GQA).  Query row
// i sits at position Lk - Lq + i (the ends align); causal keeps keys at or
// before it, window > 0 keeps keys in (qpos - window, qpos].  Masked logits
// are NEG = -1e30 and the denominator is clamped at 1e-30, as in the
// reference, so a row with no valid key never turns into NaN.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (called at flash_attention.py:107).  There the sequential grid axis over
// key tiles carries (m, l, acc) in VMEM scratch from one grid step to the
// next; blocks on Hopper run in no order, so the key-tile loop runs inside
// the block.  One block serves one (b, h, 64-row query tile): the query
// tile (pre-scaled, as the TPU kernel scales q before the product), a 64-row
// key tile and a 64-row value tile sit in shared memory, and the running
// (m, l) and the 64 x D accumulator in registers.  Key tiles that the mask
// empties for every row of the query tile are skipped (the TPU kernel's
// `live` predicate), which is what makes a windowed layer sub-quadratic;
// the tile edges (Lq, Lk and D not multiples of the tile) are masked here,
// so the wrapper pads nothing.
//
// Bound on the H100: operations.  At the serving path's shape (B=64, Hq=32,
// Hkv=4, L=512, D=64, causal) the two products are 4 B Hq D L(L+1)/2 =
// 6.9e10 FLOP (1.03 ms at 67 TFLOP/s fp32 outside the tensor cores) against
// 604 MB read and written once (0.18 ms at 3.35 TB/s).  The design keeps
// the FMA units fed from shared memory: 256 threads as a 16 x 16 grid, each
// thread owning 4 query rows and 4 key columns of the 64 x 64 score tile
// (and the same 4 rows of the output), reading float4 along D, so one
// 16-byte load feeds 4 FMAs; strides padded to an odd number of float4 keep
// the key and probability tiles free of bank conflicts.  fp32 throughout
// (the reference's precision); tensor cores (wgmma in TF32 or bf16), TMA and
// a pipelined key loop are for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_MAX_D 128
#define FA_NEG (-1e30f)
#define FA_PS (FA_BK + 4)  // probability-tile row stride: 17 float4 (odd)

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// DV: float4 columns of the output per thread (1 for D <= 64, 2 for D <= 128).
// Dp: D rounded up to a multiple of 4; KS: key-tile row stride (floats), an
// odd number of float4 >= Dp / 4.
template <int DV>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Hq, int Hkv, int Lq, int Lk, int D, int Dp, int KS,
                       int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][Dp]
  float* Ks = Qs + FA_BQ * Dp;                  // [BK][KS]
  float* Vs = Ks + FA_BK * KS;                  // [BK][Dp]
  float* Ps = Vs + FA_BK * Dp;                  // [BQ][FA_PS]
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const float4* K4 = reinterpret_cast<const float4*>(Ks);
  const float4* V4 = reinterpret_cast<const float4*>(Vs);
  const float4* P4 = reinterpret_cast<const float4*>(Ps);
  const int D4 = Dp / 4, KS4 = KS / 4;

  const int nqt = (Lq + FA_BQ - 1) / FA_BQ;
  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;             // b * Hq + h
  const int h = bh % Hq, b = bh / Hq;
  const int g = h / (Hq / Hkv);
  const float* qb = q + (size_t)bh * Lq * D;
  const size_t kvoff = ((size_t)b * Hkv + g) * Lk * D;
  const float* kb = k + kvoff;
  const float* vb = v + kvoff;
  const int q0 = qt * FA_BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < FA_BQ * Dp; e += FA_THREADS) {
    const int r = e / Dp, d = e - r * Dp;
    Qs[e] = (q0 + r < Lq && d < D) ? qb[(size_t)(q0 + r) * D + d] * scale : 0.f;
  }

  // positions of this tile's first and last real query row
  const int q_start = Lk - Lq + q0;
  const int q_last = Lk - Lq + min(q0 + FA_BQ, Lq) - 1;
  float m[4], l[4], acc[4][4 * DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DV; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Lk + FA_BK - 1) / FA_BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * FA_BK;
    if (causal && k0 > q_last) break;                 // and every later tile
    if (window > 0 && k0 + FA_BK - 1 <= q_start - window) continue;
    __syncthreads();                                  // last tile's reads done
    for (int e = tid; e < FA_BK * Dp; e += FA_THREADS) {
      const int r = e / Dp, d = e - r * Dp;
      const bool in = k0 + r < Lk && d < D;
      const size_t src = (size_t)(k0 + r) * D + d;
      Ks[r * KS + d] = in ? kb[src] : 0.f;
      Vs[e] = in ? vb[src] : 0.f;                     // 0, never garbage: p * v
    }
    __syncthreads();

    // scores: rows ty*4 + i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Q4[(ty * 4 + i) * D4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = K4[(tx + 16 * j) * KS4 + d4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], bk[j], s[i][j]);
    }

    // mask, running max and sum; the row's 64 columns live in 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q_start + r;
      float mt = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Lk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] : FA_NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[r * FA_PS + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * DV; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, output float4 columns tx + 16 jj
    for (int c4 = 0; c4 < FA_BK / 4; ++c4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = P4[(ty * 4 + i) * (FA_PS / 4) + c4];
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) {
        const int f = tx + 16 * jj;
        if (f >= D4) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 vv = V4[(c4 * 4 + cc) * D4 + f];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z : p[i].w;
            acc[i][jj * 4 + 0] = fmaf(pi, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pi, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pi, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pi, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

  float* ob = out + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (tx + 16 * jj) * 4 + e;
        if (d < D) ob[(size_t)r * D + d] = acc[i][jj * 4 + e] / den;
      }
  }
}

template <int DV>
static int launch(const float* q, const float* k, const float* v, float* out,
                  int B, int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                  int window, float scale, cudaStream_t stream) {
  const int Dp = (D + 3) / 4 * 4;
  const int KS = ((Dp / 4) | 1) * 4;
  const size_t smem =
      sizeof(float) * ((size_t)FA_BQ * Dp + FA_BK * KS + FA_BK * Dp + FA_BQ * FA_PS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * Hq * ((Lq + FA_BQ - 1) / FA_BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<DV><<<(unsigned)blocks, FA_THREADS, smem, stream>>>(
      q, k, v, out, Hq, Hkv, Lq, Lk, D, Dp, KS, causal, window, scale);
  return (int)cudaGetLastError();
}

// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), out (B, Hq, Lq, D): contiguous
// fp32.  1 <= D <= 128, Hq % Hkv == 0, Lk >= 1; window <= 0 means none.
extern "C" int flash_attention(const float* q, const float* k, const float* v,
                               float* out, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int causal, int window,
                               float scale, void* stream) {
  if (D < 1 || D > FA_MAX_D || Hkv < 1 || Hq % Hkv != 0 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Lq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return launch<1>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal, window, scale, s);
  return launch<2>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal, window, scale, s);
}
