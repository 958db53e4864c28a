// posting_scan_gather: the unfused probe scan.  For each query q and each of
// its P probed postings pid = probe[q, p], every slot c of the tile:
//     out[q, p, c] = valid[pid, c] ? ||v||^2 - 2 q.v : BIG,  v = vectors[pid, c]
// (Q, P, C) fp32, accumulated in fp32; ``valid`` is slot validity and posting
// visibility combined by the wrapper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/posting_scan.py:
// posting_scan_gather, which DMAs each probed tile into VMEM (scalar-
// prefetched probe ids) and scores it on the MXU against the query block.
// Here a block serves one query and a group of PSG_PROBES probes: the query
// row sits in shared memory, each warp takes one tile row at a time (rows
// warp, warp + 8, ... of the group's tiles), its lanes read the row along d
// with float4 loads (scalar loads where d is not a multiple of 4 or the pool
// is not 16-byte aligned), accumulate ||v||^2 and q.v in fp32 and reduce
// across the warp.  Rows past C and lanes past d do nothing, so neither d
// nor C needs padding (the TPU wrapper pads both to 128).
//
// Bound on the H100: device-memory bytes.  Each probed row is d floats read
// for 4 FLOP per float (about 0.5 FLOP per byte with the (Q, P, C) output);
// queries that probe the same tile read it again, which the 50 MB L2 may
// serve.  Ordering the launch so that they do is left for later.
#include <cuda_runtime.h>
#include <stdint.h>

#define PSG_THREADS 256
#define PSG_WARPS (PSG_THREADS / 32)
#define PSG_PROBES 4          // probes per block
#define PSG_BIG 1e30f

__device__ __forceinline__ float psg_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool VEC4>
__global__ void __launch_bounds__(PSG_THREADS)
posting_scan_gather_kernel(const float* __restrict__ q,
                           const float* __restrict__ vectors,
                           const uint8_t* __restrict__ valid,
                           const int* __restrict__ probe, int M, int C, int d,
                           int P, float* __restrict__ out) {
  extern __shared__ float qsh[];             // [d]
  const int qq = blockIdx.x;
  const int p0 = blockIdx.y * PSG_PROBES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qsh[t] = q[(size_t)qq * d + t];
  __syncthreads();
  const int np = min(PSG_PROBES, P - p0);
  for (int r = warp; r < np * C; r += PSG_WARPS) {
    const int p = p0 + r / C;
    const int cc = r - (r / C) * C;
    const int pid = min(max(probe[(size_t)qq * P + p], 0), M - 1);
    const float* row = vectors + ((size_t)pid * C + cc) * d;
    float vn = 0.f, dot = 0.f;
    if (VEC4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* q4 = reinterpret_cast<const float4*>(qsh);
      for (int t = lane; t < d / 4; t += 32) {
        const float4 v = __ldg(row4 + t);
        const float4 w = q4[t];
        vn += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        dot += w.x * v.x + w.y * v.y + w.z * v.z + w.w * v.w;
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float v = __ldg(row + t);
        vn += v * v;
        dot += qsh[t] * v;
      }
    }
    vn = psg_warp_sum(vn);
    dot = psg_warp_sum(dot);
    if (lane == 0)
      out[((size_t)qq * P + p) * C + cc] =
          valid[(size_t)pid * C + cc] ? vn - 2.f * dot : PSG_BIG;
  }
}

// q (Q, d), vectors (M, C, d) fp32; valid (M, C) bool bytes; probe (Q, P)
// int32, entries in [0, M) (clamped for safety); out (Q, P, C) fp32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int posting_scan_gather(const float* q, const float* vectors,
                                   const uint8_t* valid, const int* probe,
                                   int Q, int M, int C, int d, int P,
                                   float* out, void* stream) {
  if (Q <= 0 || P <= 0 || C <= 0) return (int)cudaGetLastError();
  dim3 grid(Q, (P + PSG_PROBES - 1) / PSG_PROBES);
  const size_t smem = sizeof(float) * (size_t)d;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (d % 4 == 0 && (uintptr_t)vectors % 16 == 0)
    posting_scan_gather_kernel<true><<<grid, PSG_THREADS, smem,
                                       (cudaStream_t)stream>>>(
        q, vectors, valid, probe, M, C, d, P, out);
  else
    posting_scan_gather_kernel<false><<<grid, PSG_THREADS, smem,
                                        (cudaStream_t)stream>>>(
        q, vectors, valid, probe, M, C, d, P, out);
  return (int)cudaGetLastError();
}
