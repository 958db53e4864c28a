// rerank_topk: the quant plane's exact rerank.  Per query, for each of the
// R candidates r of the ADC stage (flat slot id cand[q, r], ADC score
// adc[q, r]):
//     e[r] = spilled[cand / C] ? adc[q, r] : ||v||^2 - 2 q.v,  v = rows[cand]
//     e[r] = adc[q, r] < BIG/2 ? e[r] : BIG
// and the k smallest e, ascending, ties by the lower ADC rank r (the order
// in which the ADC stage ranked them); the id written out is cand[q, r].
//
// Replaces the Pallas TPU kernel src/repro/kernels/rerank.py:rerank_topk,
// which streams the candidate rows from HBM one at a time with a DMA per
// row.  Here one block serves one query: each warp scores 32 candidates per
// round (lanes over the feature axis on consecutive floats, one warp
// reduction per candidate, ||v||^2 from the gathered row itself), lane j
// keeps candidate j's score, and the block keeps the k best in shared
// memory (BlockTopK), keyed by r.  No (Q, R, d) gather is written.
//
// Bound on the H100: device-memory bytes, R rows of d floats per query
// (192 x 128 x 4 = 96 KB at the quant path's shapes), gathered at random,
// against 4 FLOP per float read.
#include "topk_common.cuh"

#define RR_THREADS 256

__global__ void __launch_bounds__(RR_THREADS)
rerank_topk_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                   const uint8_t* __restrict__ spilled,
                   const int* __restrict__ cand,
                   const float* __restrict__ adc, int N, int C, int d, int R,
                   int k, int cap, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qsh = smem;                         // [d]
  const int qq = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qsh[t] = q[(size_t)qq * d + t];
  BlockTopK top = block_topk_init(smem + d, cap, k);   // syncs: qsh ready
  const int* crow = cand + (size_t)qq * R;
  const float* arow = adc + (size_t)qq * R;
  for (int r0 = 0; r0 < R; r0 += RR_THREADS) {
    const int base = r0 + warp * 32;
    float mine = REPRO_BIG;
    for (int j = 0; j < 32 && base + j < R; ++j) {      // warp-uniform
      const int ci = min(max(crow[base + j], 0), N - 1);
      const float* row = rows + (size_t)ci * d;
      float vn = 0.f, dot = 0.f;
      for (int t = lane; t < d; t += 32) {
        const float v = row[t];
        vn += v * v;
        dot += qsh[t] * v;
      }
      vn = warp_sum(vn);
      dot = warp_sum(dot);
      if (lane == j) {
        const float a = arow[base + j];
        const float e = spilled[ci / C] ? a : vn - 2.f * dot;
        mine = a < REPRO_BIG / 2 ? e : REPRO_BIG;
      }
    }
    block_topk_push(top, base + lane < R, mine, base + lane);
  }
  block_topk_finish(top);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_s[(size_t)qq * k + e] = top.s[e];
    out_i[(size_t)qq * k + e] = crow[top.i[e]];
  }
}

// q (Q, d) fp32; rows (N = M*C, d) fp32; spilled (M,) bool bytes;
// cand (Q, R) int32 in [0, N); adc (Q, R) fp32;
// 1 <= k <= min(TOPK_BLOCK_MAX_K, R).  out_s (Q, k) fp32, out_i (Q, k) int32.
extern "C" int rerank_topk(const float* q, const float* rows,
                           const uint8_t* spilled, const int* cand,
                           const float* adc, int Q, int N, int C, int d,
                           int R, int k, float* out_s, int* out_i,
                           void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K || k > R) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int cap = block_topk_cap(k, RR_THREADS, 512);
  const size_t smem = sizeof(float) * d + block_topk_bytes(cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rerank_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rerank_topk_kernel<<<Q, RR_THREADS, smem, (cudaStream_t)stream>>>(
      q, rows, spilled, cand, adc, N, C, d, R, k, cap, out_s, out_i);
  return (int)cudaGetLastError();
}
