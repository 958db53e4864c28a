// posting_scan_topk: per query, scan the P probed posting tiles and keep
// the k smallest of
//     s[p, c] = ok(p, c) ? ||v||^2 - 2 q . v : BIG,   v = vectors[probe[p], c]
//     ok(p, c) = valid[probe[p], c] && qp_ok[p] != 0
// ascending, ties by the position p*C + c in the flattened (P, C) order
// (not by the emitted id); the candidate id written out is probe[p]*C + c.
//
// Replaces the Pallas TPU kernel src/repro/kernels/posting_scan.py:
// posting_scan_topk (the probe-indexed tile stream with merge_topk carried
// in the output block).
//
// Bound on the H100: device-memory bytes.  Each probed tile (96 x 128 fp32,
// 48 KB at the main path's shapes) is used for 2 FLOP per byte, far below
// the card's ~20 FLOP/byte fp32 balance point: 403 MB of tiles for 256
// queries x 32 probes, or 262 MB if every distinct probed tile were read
// once (0.078 ms at 3.35 TB/s).
// Design, k <= 32: a block serves one query and a group of its probes,
// grid (Q, S); at a small batch S > 1 splits the probes so that about two
// blocks per SM run, and topk_merge_parts (topk_common.cuh) merges the
// groups' lists.  The block streams its probed tiles through shared memory
// in units: a unit is a row slice of one tile of at most 48 KB
// (PS_UNIT_FLOATS), so any (C, d) fits and two blocks share an SM.  A
// two-stage ring keeps the next unit's copy in flight while the current
// one is scored: one thread issues it as a Hopper bulk copy (bulk_copy.cuh,
// completion counted in bytes on an mbarrier) where the tile is 16-byte
// aligned and d % 4 == 0, else every thread copies 4-byte cp.async
// elements (the BULK = false instance).  Each thread scores one slot row
// at a time from shared memory, with no reduction across lanes: it walks
// the row's features from a start rotated by the row (rows a stride of
// d floats apart then fall in distinct banks), as
//     vn = fmaf(v, v, vn);  dot = fmaf(q, v, dot)     (in that order)
// and s = vn - 2 * dot, so integer inputs are exact (row_score.cuh, which
// posting_scan_gather.cu shares: the two give a row the same bits).  Each
// warp keeps its own k-list in registers (lane j = j-th best); a unit's 32
// candidates of a warp are filtered against the list's k-th entry with one
// ballot before any insert (topk_insert_lanes).  At the end one warp merges the block's
// lists.  Selection is by the (score, position) pair in lexicographic
// order, so the tie order depends neither on which warp or block saw
// which probe nor on the order they finish in.
#include <algorithm>

#include "bulk_copy.cuh"
#include "row_score.cuh"
#include "topk_common.cuh"

#define PS_MAX_THREADS 256

template <bool BULK, bool V4>
__global__ void __launch_bounds__(PS_MAX_THREADS, 2)
posting_scan_topk_kernel(const float* __restrict__ q,
                         const float* __restrict__ vec,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ qp_ok,
                         const int* __restrict__ probe, int M, int C, int d,
                         int P, int k, int group, int R, int stage_floats,
                         float* __restrict__ out_s, int* __restrict__ out_i,
                         float* __restrict__ part_s,
                         int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  const int dq = (d + 3) & ~3;
  float* qs = smem;                                   // [dq]
  float* stage = smem + dq;                           // [2][stage_floats]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 2 * stage_floats);
  float* ms = reinterpret_cast<float*>(full + 2);     // [warps][32]
  int* mi = reinterpret_cast<int*>(ms + blockDim.x);  // [warps][32]
  const int qq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p_begin = blockIdx.y * group;
  const int upt = (C + R - 1) / R;                    // units a tile
  const int units = (min(P, p_begin + group) - p_begin) * upt;
  const int* prow = probe + (size_t)qq * P;

  // unit u: rows [r0, r0 + rows) of probe p's tile
  auto unit = [&](int u, int& p, int& r0, int& rows, int& pid) {
    p = p_begin + u / upt;
    r0 = (u % upt) * R;
    rows = min(R, C - r0);
    pid = min(max(prow[p], 0), M - 1);   // probes come from centroid_topk
  };
  auto issue = [&](int u) {
    int p, r0, rows, pid;
    unit(u, p, r0, rows, pid);
    const float* src = vec + ((size_t)pid * C + r0) * d;
    float* dst = stage + (u & 1) * stage_floats;
    if (BULK) {
      if (tid == 0) {
        const uint32_t bytes = (uint32_t)(rows * d) * 4u;
        mbar_arrive_expect(&full[u & 1], bytes);
        bulk_copy_g2s(dst, src, bytes, &full[u & 1]);
      }
    } else {
      for (int e = tid; e < rows * d; e += blockDim.x)
        cp_async4(dst + e, src + e, 4);
    }
  };

  for (int t = tid; t < d; t += blockDim.x) qs[t] = q[(size_t)qq * d + t];
  if (BULK && tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int u = 0; u < 2; ++u) {
    if (u < units) issue(u);
    if (!BULK) cp_async_commit();
  }

  const int dw = V4 ? d / 4 : d;             // words a row (row_score.cuh)
  float ls;
  int li;
  topk_empty(ls, li);
  for (int u = 0; u < units; ++u) {
    if (BULK) {
      mbar_wait(&full[u & 1], (u >> 1) & 1);
    } else {
      cp_async_wait<1>();
      __syncthreads();
    }
    const float* tile = stage + (u & 1) * stage_floats;
    int p, r0, rows, pid;
    unit(u, p, r0, rows, pid);
    const bool p_ok = qp_ok[(size_t)qq * P + p] != 0;
    for (int rb = warp * 32; rb < rows; rb += blockDim.x) {  // warp-uniform
      const int r = rb + lane;
      const bool has = r < rows;
      float sc = REPRO_BIG;
      if (has) {
        float vn = 0.f, dot = 0.f;
        row_walk<V4, true, true>(tile + r * d, qs, dw, row_start(r, dw), vn,
                                 dot);
        if (p_ok && valid[(size_t)pid * C + r0 + r]) sc = vn - 2.f * dot;
      }
      topk_insert_lanes(ls, li, sc, p * C + r0 + r, has, k, lane);
    }
    __syncthreads();                  // every thread is done with the stage
    if (u + 2 < units) issue(u + 2);
    if (!BULK) cp_async_commit();
  }

  ms[tid] = ls;
  mi[tid] = li;
  __syncthreads();
  if (warp != 0) return;
  topk_empty(ls, li);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const float s = ms[w * 32 + lane];
    const int i = mi[w * 32 + lane];
    topk_insert_lanes(ls, li, s, i, lane < k && i != INT_MAX, k, lane);
  }
  if (lane >= k) return;
  if (part_s == nullptr) {            // one group: the final list
    const int p = li / C;
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = prow[p] * C + (li - p * C);
  } else {
    const size_t o = ((size_t)qq * gridDim.y + blockIdx.y) * k + lane;
    part_s[o] = ls;
    part_i[o] = li;
  }
}

template <bool BULK, bool V4>
static int launch_scan(dim3 grid, int threads, size_t smem, cudaStream_t st,
                       const float* q, const float* vec, const uint8_t* valid,
                       const int* qp_ok, const int* probe, int M, int C,
                       int d, int P, int k, int group, int R,
                       int stage_floats, float* out_s, int* out_i,
                       float* part_s, int* part_i) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        posting_scan_topk_kernel<BULK, V4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  posting_scan_topk_kernel<BULK, V4><<<grid, threads, smem, st>>>(
      q, vec, valid, qp_ok, probe, M, C, d, P, k, group, R, stage_floats,
      out_s, out_i, part_s, part_i);
  return (int)cudaGetLastError();
}

// q (Q, d), vectors (M, C, d) fp32; valid (M, C) bool bytes (slot validity
// and posting visibility combined); qp_ok, probe (Q, P) int32;
// 1 <= k <= min(32, P*C).  out_s (Q, k) fp32, out_i (Q, k) int32.  The
// probes go in groups of ``group`` (kernels/posting_scan.py sizes them),
// S = ceil(P / group) blocks a query, S <= 65535; with S > 1, part_s and
// part_i are (Q, S, k) scratch, else unused.
extern "C" int posting_scan_topk(const float* q, const float* vec,
                                 const uint8_t* valid, const int* qp_ok,
                                 const int* probe, int Q, int M, int C, int d,
                                 int P, int k, int group, float* out_s,
                                 int* out_i, float* part_s, int* part_i,
                                 void* stream) {
  if (k < 1 || k > 32 || group < 1) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int S = (P + group - 1) / group;
  const int R = unit_rows(C, d);                 // rows a unit
  const int threads = std::min(PS_MAX_THREADS, (R + 31) / 32 * 32);
  const int stage_floats = (R * d + 3) & ~3;
  const size_t smem = sizeof(float) * (((d + 3) & ~3) + 2 * stage_floats) +
                      2 * sizeof(uint64_t) +
                      threads * (sizeof(float) + sizeof(int));
  const bool v4 = d % 4 == 0;
  const bool bulk = v4 && (uintptr_t)vec % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ps = S > 1 ? part_s : nullptr;
  int* pi = S > 1 ? part_i : nullptr;
  const dim3 grid(Q, S);
  int err = bulk ? launch_scan<true, true>(grid, threads, smem, st, q, vec,
                                           valid, qp_ok, probe, M, C, d, P, k,
                                           group, R, stage_floats, out_s,
                                           out_i, ps, pi)
            : v4 ? launch_scan<false, true>(grid, threads, smem, st, q, vec,
                                            valid, qp_ok, probe, M, C, d, P,
                                            k, group, R, stage_floats, out_s,
                                            out_i, ps, pi)
                 : launch_scan<false, false>(grid, threads, smem, st, q, vec,
                                             valid, qp_ok, probe, M, C, d, P,
                                             k, group, R, stage_floats, out_s,
                                             out_i, ps, pi);
  if (err || S == 1) return err;
  topk_merge_parts<<<Q, MERGE_WARPS * 32, 0, st>>>(part_s, part_i, S, k,
                                                    probe, P, C, out_s, out_i);
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
