// posting_scan_topk: per query, scan the P probed posting tiles and keep
// the k smallest of
//     s[p, c] = ok(p, c) ? ||v||^2 - 2 q . v : BIG,   v = vectors[probe[p], c]
//     ok(p, c) = valid[probe[p], c] && qp_ok[p] != 0
// ascending, ties by the position p*C + c in the flattened (P, C) order
// (not by the emitted id); the candidate id written out is probe[p]*C + c.
//
// Replaces the Pallas TPU kernel src/repro/kernels/posting_scan.py:
// posting_scan_topk (the probe-indexed tile stream with merge_topk carried
// in the output block).  Here one block serves one query: its 8 warps take
// the probes round-robin, each warp streams a probed (C, d) tile from
// device memory once, reads one slot row per step with the 32 lanes on
// consecutive floats, reduces ||v||^2 and q.v across the warp, and keeps its
// own top-k list in registers (lane j = j-th best).  At the end one warp
// merges the 8 lists through shared memory.  Selection is by the
// (score, position) pair in lexicographic order, so the tie order does not
// depend on which warp saw which probe.
//
// Bound on the H100: device-memory bytes.  Each probed tile (96 x 128 fp32,
// 48 KB at the slice's shapes) is read once per query and used for 2 FLOP
// per byte read, far below the card's ~20 FLOP/byte fp32 balance point.  The
// design reads each tile exactly once per query with coalesced 128-byte
// warp loads, keeps 4 slot rows in flight per warp, and writes only the
// (Q, k) result.  Probes shared by several queries are re-read (L2 may catch
// them); sharing a tile across queries is work for a later kernel.
#include "topk_common.cuh"

#define PS_WARPS 8
#define PS_UNROLL 4

__global__ void __launch_bounds__(PS_WARPS * 32)
posting_scan_topk_kernel(const float* __restrict__ q,
                         const float* __restrict__ vec,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ qp_ok,
                         const int* __restrict__ probe, int M, int C, int d,
                         int P, int k, float* __restrict__ out_s,
                         int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qsh = smem;                         // [d]
  float* ms = smem + d;                      // [PS_WARPS * 32]
  int* mi = (int*)(ms + PS_WARPS * 32);      // [PS_WARPS * 32]
  const int qq = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qsh[t] = q[(size_t)qq * d + t];
  __syncthreads();

  float ls;
  int li;
  topk_empty(ls, li);

  for (int p = warp; p < P; p += PS_WARPS) {
    int pid = probe[(size_t)qq * P + p];
    pid = min(max(pid, 0), M - 1);   // probes come from centroid_topk (< M)
    const bool p_ok = qp_ok[(size_t)qq * P + p] != 0;
    const float* tile = vec + (size_t)pid * C * d;
    const uint8_t* vrow = valid + (size_t)pid * C;
    for (int c0 = 0; c0 < C; c0 += PS_UNROLL) {
      float vn[PS_UNROLL], dot[PS_UNROLL];
#pragma unroll
      for (int u = 0; u < PS_UNROLL; ++u) {
        vn[u] = 0.f;
        dot[u] = 0.f;
      }
      for (int t = lane; t < d; t += 32) {
        const float qv = qsh[t];
#pragma unroll
        for (int u = 0; u < PS_UNROLL; ++u) {
          if (c0 + u < C) {
            const float v = tile[(size_t)(c0 + u) * d + t];
            vn[u] += v * v;
            dot[u] += qv * v;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PS_UNROLL; ++u) {
        const int c = c0 + u;
        if (c >= C) break;                   // uniform across the warp
        const float s_vn = warp_sum(vn[u]);
        const float s_dot = warp_sum(dot[u]);
        const float s = (p_ok && vrow[c]) ? s_vn - 2.f * s_dot : REPRO_BIG;
        topk_insert(ls, li, s, p * C + c, k, lane);
      }
    }
  }

  ms[warp * 32 + lane] = ls;
  mi[warp * 32 + lane] = li;
  __syncthreads();
  if (warp != 0) return;
  topk_empty(ls, li);
  for (int w = 0; w < PS_WARPS; ++w) {
    const float s = ms[w * 32 + lane];
    const int i = mi[w * 32 + lane];
    topk_insert_lanes(ls, li, s, i, lane < k && i != INT_MAX, k, lane);
  }
  if (lane < k) {
    const int p = li / C;
    const int c = li - p * C;
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = probe[(size_t)qq * P + p] * C + c;
  }
}

// q (Q, d), vectors (M, C, d) fp32; valid (M, C) bool bytes (slot validity
// and posting visibility combined); qp_ok, probe (Q, P) int32;
// 1 <= k <= min(32, P*C).  out_s (Q, k) fp32, out_i (Q, k) int32.
extern "C" int posting_scan_topk(const float* q, const float* vec,
                                 const uint8_t* valid, const int* qp_ok,
                                 const int* probe, int Q, int M, int C, int d,
                                 int P, int k, float* out_s, int* out_i,
                                 void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * d + PS_WARPS * 32 * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        posting_scan_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  posting_scan_topk_kernel<<<Q, PS_WARPS * 32, smem, (cudaStream_t)stream>>>(
      q, vec, valid, qp_ok, probe, M, C, d, P, k, out_s, out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide path, 32 < k <= TOPK_BLOCK_MAX_K (and any P): one block per query.
// The probed slots are taken in their flattened (P, C) order, 256 per round:
// warp w scores positions round*256 + w*32 + j, j = 0..31, with the same
// per-row arithmetic as the warp path (so both paths give the same scores),
// and lane j keeps position j's score.  The block's top-k lives in shared
// memory (BlockTopK), keyed by position; ids are mapped at write-out.
// ---------------------------------------------------------------------------

#define PSW_THREADS 256

__global__ void __launch_bounds__(PSW_THREADS)
posting_scan_topk_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ vec,
                              const uint8_t* __restrict__ valid,
                              const int* __restrict__ qp_ok,
                              const int* __restrict__ probe, int M, int C,
                              int d, int P, int k, int cap,
                              float* __restrict__ out_s,
                              int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qsh = smem;                         // [d]
  const int qq = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qsh[t] = q[(size_t)qq * d + t];
  BlockTopK top = block_topk_init(smem + d, cap, k);   // syncs: qsh ready
  const int total = P * C;
  const int* prow = probe + (size_t)qq * P;
  for (int r0 = 0; r0 < total; r0 += PSW_THREADS) {
    const int base = r0 + warp * 32;
    float mine = REPRO_BIG;
    for (int j = 0; j < 32 && base + j < total; ++j) {   // warp-uniform
      const int pos = base + j;
      const int p = pos / C;
      const int cc = pos - p * C;
      const int pid = min(max(prow[p], 0), M - 1);
      const float* row = vec + ((size_t)pid * C + cc) * d;
      float vn = 0.f, dot = 0.f;
      for (int t = lane; t < d; t += 32) {
        const float v = row[t];
        vn += v * v;
        dot += qsh[t] * v;
      }
      vn = warp_sum(vn);
      dot = warp_sum(dot);
      if (lane == j) {
        const bool ok = qp_ok[(size_t)qq * P + p] != 0 &&
                        valid[(size_t)pid * C + cc];
        mine = ok ? vn - 2.f * dot : REPRO_BIG;
      }
    }
    block_topk_push(top, base + lane < total, mine, base + lane);
  }
  block_topk_finish(top);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int li = top.i[e];
    const int p = li / C;
    out_s[(size_t)qq * k + e] = top.s[e];
    out_i[(size_t)qq * k + e] = prow[p] * C + (li - p * C);
  }
}

// As posting_scan_topk, for 1 <= k <= min(TOPK_BLOCK_MAX_K, P*C).
extern "C" int posting_scan_topk_wide(const float* q, const float* vec,
                                      const uint8_t* valid, const int* qp_ok,
                                      const int* probe, int Q, int M, int C,
                                      int d, int P, int k, float* out_s,
                                      int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int cap = block_topk_cap(k, PSW_THREADS, 1024);
  const size_t smem = sizeof(float) * d + block_topk_bytes(cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        posting_scan_topk_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  posting_scan_topk_wide_kernel<<<Q, PSW_THREADS, smem,
                                  (cudaStream_t)stream>>>(
      q, vec, valid, qp_ok, probe, M, C, d, P, k, cap, out_s, out_i);
  return (int)cudaGetLastError();
}
