// pq_scan_gather: the unfused ADC scan.  For each query q and each of its P
// probed postings pid = probe[q, p], every slot c of the code tile:
//     out[q, p, c] = valid[pid, c]
//         ? sum_{j=0}^{m-1} lut[q, slot[pid], j, codes[pid, j, c]] : BIG
// (Q, P, C) fp32; ``valid`` is slot validity and posting visibility combined
// and ``slot`` is clamped to [0, V) by the wrapper.  The m lookups are summed
// in order j = 0..m-1 in fp32, as pq_scan_topk.cu and the plain version sum
// them, so the three agree bit for bit on the same tables.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_scan.py:pq_scan_gather.
// The TPU has no lane gather, so that kernel turns each lookup into a one-hot
// matrix product on the MXU, one (query, probe) tile per grid step.  Hopper
// indexes shared memory directly: one block serves one query, stages all
// V*m*ksub floats of its lookup tables in shared memory (32 KB at V=2, m=16,
// ksub=256), and its threads go over the (probe, slot) positions p*C + c,
// consecutive threads on consecutive code bytes, m table lookups each.
//
// Bound on the H100: device-memory bytes.  Each probed code tile is m*C
// bytes read once per query that probes it, the tables Q*V*m*ksub*4 bytes
// read once, the output Q*P*C*4 bytes written once; a position costs m
// shared-memory lookups and adds.
#include <cuda_runtime.h>
#include <stdint.h>

#define PQG_THREADS 256
#define PQG_BIG 1e30f

__global__ void __launch_bounds__(PQG_THREADS)
pq_scan_gather_kernel(const float* __restrict__ luts,
                      const uint8_t* __restrict__ codes,
                      const int* __restrict__ slot,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ probe, int M, int C, int V,
                      int m, int ksub, int P, float* __restrict__ out) {
  extern __shared__ float lut[];             // [V][m][ksub]
  const int lut_n = V * m * ksub;
  const int qq = blockIdx.x;
  const float* lq = luts + (size_t)qq * lut_n;
  for (int e = threadIdx.x; e < lut_n; e += blockDim.x) lut[e] = lq[e];
  __syncthreads();
  const int total = P * C;
  const int* prow = probe + (size_t)qq * P;
  float* orow = out + (size_t)qq * total;
  for (int pos = threadIdx.x; pos < total; pos += blockDim.x) {
    const int p = pos / C;
    const int cc = pos - p * C;
    const int pid = min(max(prow[p], 0), M - 1);
    const int sl = min(max(slot[pid], 0), V - 1);
    const float* L = lut + (size_t)sl * m * ksub;
    const uint8_t* cd = codes + (size_t)pid * m * C + cc;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc += L[j * ksub + cd[(size_t)j * C]];
    orow[pos] = valid[(size_t)pid * C + cc] ? acc : PQG_BIG;
  }
}

// luts (Q, V, m, ksub) fp32; codes (M, m, C) uint8; slot (M,) int32; valid
// (M, C) bool bytes; probe (Q, P) int32, entries in [0, M) (clamped for
// safety); out (Q, P, C) fp32.  Returns cudaGetLastError() after the launch.
extern "C" int pq_scan_gather(const float* luts, const uint8_t* codes,
                              const int* slot, const uint8_t* valid,
                              const int* probe, int Q, int M, int C, int V,
                              int m, int ksub, int P, float* out,
                              void* stream) {
  if (Q <= 0 || P <= 0 || C <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (size_t)V * m * ksub;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_scan_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pq_scan_gather_kernel<<<Q, PQG_THREADS, smem, (cudaStream_t)stream>>>(
      luts, codes, slot, valid, probe, M, C, V, m, ksub, P, out);
  return (int)cudaGetLastError();
}
