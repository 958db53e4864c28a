// pq_scan_topk: per query, the ADC score of every slot of its P probed
// posting tiles and the k smallest of
//     s[p, c] = ok(p, c) ? sum_{j=0}^{m-1} lut[q, slot[pid], j, codes[pid, j, c]]
//                        : BIG,                      pid = probe[q, p]
//     ok(p, c) = valid[pid, c] && qp_ok[q, p] != 0
// ascending, ties by the position p*C + c in the flattened (P, C) order;
// the id written out is probe[q, p]*C + c.  The m lookups are summed in
// order j = 0..m-1 in fp32, as the plain version does, so the two agree
// bit for bit.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_scan.py:pq_scan_topk.
// The TPU has no lane gather, so that kernel turns each lookup into a
// one-hot matrix product on the MXU.  Hopper can index shared memory
// directly: one block serves one query, stages the query's lookup tables
// for all V codebook slots in shared memory (V*m*ksub floats: 32 KB at
// V=2, m=16, ksub=256), and each thread scores one probed slot per round
// (m byte loads from the code tile, consecutive threads on consecutive
// bytes, and m table lookups).  The k best (up to TOPK_BLOCK_MAX_K, 192
// on the quant path) are kept block-wide in shared memory (BlockTopK).
//
// Bound on the H100: device-memory bytes.  Each probed code tile is m*C
// bytes (1.5 KB at m=16, C=96), read once per query, against m adds per
// slot; the tables (Q*V*m*ksub*4 bytes) are read once.  The block-wide
// selection (a shared-memory bitonic sort each time the candidate buffer
// fills) is the kernel's own cost beyond that.
#include "topk_common.cuh"

#define PQ_THREADS 256

__global__ void __launch_bounds__(PQ_THREADS)
pq_scan_topk_kernel(const float* __restrict__ luts,
                    const uint8_t* __restrict__ codes,
                    const int* __restrict__ slot,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ qp_ok,
                    const int* __restrict__ probe, int M, int C, int V,
                    int m, int ksub, int P, int k, int cap,
                    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int lut_n = V * m * ksub;
  float* lut = smem;                         // [V][m][ksub]
  const int qq = blockIdx.x;
  const float* lq = luts + (size_t)qq * lut_n;
  for (int e = threadIdx.x; e < lut_n; e += blockDim.x) lut[e] = lq[e];
  BlockTopK top = block_topk_init(smem + lut_n, cap, k);   // syncs: lut ready
  const int total = P * C;
  const int* prow = probe + (size_t)qq * P;
  for (int r0 = 0; r0 < total; r0 += PQ_THREADS) {
    const int pos = r0 + threadIdx.x;
    const bool has = pos < total;
    float s = REPRO_BIG;
    if (has) {
      const int p = pos / C;
      const int cc = pos - p * C;
      const int pid = min(max(prow[p], 0), M - 1);
      const int sl = min(max(slot[pid], 0), V - 1);
      const float* L = lut + (size_t)sl * m * ksub;
      const uint8_t* cd = codes + (size_t)pid * m * C + cc;
      float acc = 0.f;
      for (int j = 0; j < m; ++j) acc += L[j * ksub + cd[(size_t)j * C]];
      const bool ok = qp_ok[(size_t)qq * P + p] != 0 &&
                      valid[(size_t)pid * C + cc];
      s = ok ? acc : REPRO_BIG;
    }
    block_topk_push(top, has, s, pos);
  }
  block_topk_finish(top);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int li = top.i[e];
    const int p = li / C;
    out_s[(size_t)qq * k + e] = top.s[e];
    out_i[(size_t)qq * k + e] = prow[p] * C + (li - p * C);
  }
}

// luts (Q, V, m, ksub) fp32; codes (M, m, C) uint8; slot (M,) int32;
// valid (M, C) bool bytes (slot validity and posting visibility combined);
// qp_ok, probe (Q, P) int32; 1 <= k <= min(TOPK_BLOCK_MAX_K, P*C).
// out_s (Q, k) fp32, out_i (Q, k) int32.
extern "C" int pq_scan_topk(const float* luts, const uint8_t* codes,
                            const int* slot, const uint8_t* valid,
                            const int* qp_ok, const int* probe, int Q, int M,
                            int C, int V, int m, int ksub, int P, int k,
                            float* out_s, int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int cap = block_topk_cap(k, PQ_THREADS, 1024);
  const size_t smem = sizeof(float) * (size_t)V * m * ksub + block_topk_bytes(cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_scan_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pq_scan_topk_kernel<<<Q, PQ_THREADS, smem, (cudaStream_t)stream>>>(
      luts, codes, slot, valid, qp_ok, probe, M, C, V, m, ksub, P, k, cap,
      out_s, out_i);
  return (int)cudaGetLastError();
}
