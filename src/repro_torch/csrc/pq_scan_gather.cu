// pq_scan_gather: the unfused ADC scan.  For each query q and each of its P
// probed postings pid = probe[q, p], every slot c of the code tile:
//     out[q, p, c] = vis[pid] && slot_valid[pid, c]
//         ? sum_{j=0}^{m-1} lut[q, slot[pid], j, codes[pid, j, c]] : BIG
// (Q, P, C) fp32, slot[pid] clamped to [0, V).  The m lookups are summed in
// order j = 0..m-1 in fp32, as the plain version sums them.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_scan.py:pq_scan_gather.
// The TPU has no lane gather, so that kernel turns each lookup into a
// one-hot matrix product on the MXU, one (query, probe) tile per grid step.
// Hopper indexes shared memory directly.
//
// Bound on the H100: device-memory bytes.  The tables are 32 KB a query
// (V=2, m=16, ksub=256), a code tile 1.5 KB (m=16, C=96), the scores 384
// bytes a (query, probe): at the oracle's Q=256, P=32, 8.4 MB of tables,
// about 8.8 MB of distinct code tiles and 3.1 MB of scores, 0.0063 ms,
// against m shared-memory lookups a slot.  The tables are the large part,
// so the scan stays query-major: this is pq_scan_topk's staged scan
// (adc_scan.cuh: the tables by one bulk copy, each warp's code tiles and
// slot_valid rows through a two-stage ring, four slots a lane) with a
// store for an epilogue, so the two agree bit for bit by construction.
// The scores go straight to out[q, p, :], a lane's four slots as one
// 16-byte store, consecutive lanes on consecutive slots.  A block serves
// one query and a group of its
// probes, grid (Q, S): at a small batch S > 1 splits a query's probes so
// that about two blocks an SM work (kernels/pq_scan.py: gather_split); no
// merge, so no cluster.  The BULK = false instance reads unaligned tables,
// tiles or slot_valid rows (or m*C or C no multiple of 16) from device
// memory.
#include <algorithm>

#include "adc_scan.cuh"

#define PQG_CHUNK_TILES 256   // probe records a block holds at a time

struct PqgLayout {
  int lut, ring, info, stage_bytes, valid_off, bytes;
};

// mbarriers, the tables, the code-tile ring (BULK only), a chunk's probe
// records; each region 16-byte aligned
static PqgLayout pqg_layout(bool bulk, int lut_n, int m, int C) {
  PqgLayout L;
  adc_stage_bytes(bulk, m, C, L.valid_off, L.stage_bytes);
  int o = (8 * ADC_BARS + 15) & ~15;
  L.lut = o;  o += (lut_n * 4 + 15) & ~15;
  L.ring = o; o += ADC_WARPS * ADC_STAGES * L.stage_bytes;
  L.info = o; o += PQG_CHUNK_TILES * 16;
  L.bytes = o;
  return L;
}

template <bool BULK>
__global__ void __launch_bounds__(ADC_THREADS)
pq_scan_gather_kernel(const float* __restrict__ luts,
                      const uint8_t* __restrict__ codes,
                      const int* __restrict__ slot,
                      const uint8_t* __restrict__ slot_valid,
                      const uint8_t* __restrict__ vis,
                      const int* __restrict__ probe, int M, int C, int V,
                      int m, int ksub, int P, int group, PqgLayout lay,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AdcRing ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem),
                     lay.stage_bytes, lay.valid_off};
  float* lut = reinterpret_cast<float*>(smem + lay.lut);
  int4* info = reinterpret_cast<int4*>(smem + lay.info);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qq = blockIdx.x;
  const int pb = blockIdx.y * group;
  const int pe = min(P, pb + group);
  const int lut_n = V * m * ksub;
  const int* prow = probe + (size_t)qq * P;
  float* orow = out + (size_t)qq * P * C;

  adc_start<BULK>(ring, lut, luts + (size_t)qq * lut_n, lut_n);
  __syncthreads();
  int g = 0;        // code tiles this warp has consumed (its ring phase)
  for (int c0 = pb; c0 < pe; c0 += PQG_CHUNK_TILES) {
    const int nt = min(pe, c0 + PQG_CHUNK_TILES) - c0;
    if (BULK && lane == 0)                   // the first tiles on their way
      adc_prime(ring, warp, g, nt, codes, slot_valid, M, m, C,
                [&](int t) { return prow[c0 + t]; });
    for (int t = tid; t < nt; t += ADC_THREADS)
      info[t] = adc_record(prow[c0 + t], M, slot, V, m, ksub, vis, true);
    __syncthreads();
    if (BULK) mbar_wait(&ring.bars[0], 0);
    float* prow_out = orow + (size_t)c0 * C;
    adc_scan_chunk<BULK, true>(
        ring, lut, info, nt, g, codes, slot_valid, m, C, ksub,
        [&](int t, int c, float sc) { prow_out[(size_t)t * C + c] = sc; },
        [&](int t, int c, float4 sc) {    // 16-byte aligned: C % 16 == 0
          *reinterpret_cast<float4*>(prow_out + (size_t)t * C + c) = sc;
        });
    __syncthreads();                  // info is rewritten by the next chunk
  }
}

template <bool BULK>
static int launch(int Q, int S, const PqgLayout& lay, cudaStream_t st,
                  const float* luts, const uint8_t* codes, const int* slot,
                  const uint8_t* slot_valid, const uint8_t* vis,
                  const int* probe, int M, int C, int V, int m, int ksub,
                  int P, int group, float* out) {
  auto kern = pq_scan_gather_kernel<BULK>;
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(Q, S), ADC_THREADS, lay.bytes, st>>>(
      luts, codes, slot, slot_valid, vis, probe, M, C, V, m, ksub, P, group,
      lay, out);
  return (int)cudaGetLastError();
}

// luts (Q, V, m, ksub) fp32; codes (M, m, C) uint8; slot (M,) int32 (the
// kernel clamps it to [0, V)); slot_valid (M, C) and vis (M,) bool bytes;
// probe (Q, P) int32, entries in [0, M) (clamped for safety); the probes go
// in groups of ``group``, S = ceil(P / group) <= 65535 blocks a query; out
// (Q, P, C) fp32.  Returns cudaErrorInvalidValue where the tables do not
// fit a block's shared memory (kernels/pq_scan.py checks that first), else
// cudaGetLastError() after the launch.
extern "C" int pq_scan_gather(const float* luts, const uint8_t* codes,
                              const int* slot, const uint8_t* slot_valid,
                              const uint8_t* vis, const int* probe, int Q,
                              int M, int C, int V, int m, int ksub, int P,
                              int group, float* out, void* stream) {
  if (group < 1 || M < 1 || V < 1) return (int)cudaErrorInvalidValue;
  if (Q <= 0 || P <= 0 || C <= 0) return (int)cudaGetLastError();
  const int S = (P + group - 1) / group;
  const int lut_n = V * m * ksub;
  bool bulk = adc_bulk_ok(luts, lut_n, codes, m, C, slot_valid);
  PqgLayout lay = pqg_layout(bulk, lut_n, m, C);
  const int smem_max = 232448;
  if (lay.bytes > smem_max && bulk) {          // no room for the ring
    bulk = false;
    lay = pqg_layout(bulk, lut_n, m, C);
  }
  if (lay.bytes > smem_max) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bulk ? launch<true>(Q, S, lay, st, luts, codes, slot, slot_valid,
                             vis, probe, M, C, V, m, ksub, P, group, out)
              : launch<false>(Q, S, lay, st, luts, codes, slot, slot_valid,
                              vis, probe, M, C, V, m, ksub, P, group, out);
}
