// centroid_topk: per query, the k smallest of
//     s[i, j] = vis[j] ? ||c_j||^2 - 2 q_i . c_j : BIG
// ascending, ties by the lower centroid index; no (Q, M) matrix is written.
//
// Replaces the Pallas TPU kernel src/repro/kernels/centroid_topk.py:
// centroid_topk (with its merge_topk running selection).  On the TPU the
// grid walks the centroid axis in order and carries the running top-k in
// the output block.  Hopper blocks run in parallel and in no order, so:
//   pass 1: a block takes a query tile and one chunk of the centroid axis
//           and keeps the tile's k-lists; the chunk's lists go to a small
//           (Q, nchunks, k) buffer;
//   pass 2: one warp per query merges the chunks' lists
//           (topk_merge_parts, topk_common.cuh).
// Selection is by the (score, index) pair in lexicographic order, so the
// result, ties included, is the same whatever order blocks finish in.
//
// Bound on the H100 at the main shape (Q = 256, M = 65,504, d = 128, k =
// 32): 4.3 GFLOP of products over 34 MB of reads.  In fp32 outside the
// tensor cores that is 0.064 ms; in 3xTF32 on them (three TF32 products
// at 495 TFLOP/s) 0.026 ms.
// Design, k <= 32: the products are masked_score's, run by the same code
// (score_tile.cuh: 3xTF32 mma.sync, a three-stage cp.async ring of 32-deep
// slices, the norms from the staged slices), so each score ranked here is
// bit for bit the score ops.centroid_score gives for the same (q, c, vis).
// A block owns a query tile (32 rows and 4 warps for Q <= 32, else 64
// rows and 8 warps) and walks its chunk in 128-centroid tiles; the blocks
// that share a chunk are adjacent in the launch order, so the chunk comes
// from HBM once.  After each tile the accumulators, norms and mask meet in
// a shared score tile (nothing goes to device memory), and the next
// tile's first two slices are already in flight while the tile is ranked:
// each warp owns 8 query rows and keeps their k-lists in registers (lane
// j = j-th best); a lane reads four scores of a row, one ballot filters
// them against the row's k-th entry, and only the survivors go through
// topk_insert_lanes.
// The ranking, not the product, sets the pace (PERF.md, section 6): each
// (row, chunk) pair builds its list from nothing, and a list's first
// tiles take most of its inserts, each a chain of shuffles and votes.
#include "score_tile.cuh"
#include "topk_common.cuh"

namespace {

using namespace score_tile;

template <int BQ>
struct Split {
  using T = Tile<BQ>;
  static constexpr int RPW = BQ / (T::NT / 32);        // rows a warp: 8
  static constexpr int MIN_BLOCKS = BQ == 32 ? 3 : 2;  // per SM
  // ring stages 0 and 1, then the score tile from stage 2 on (it may run
  // past the ring's end), then the norms
  static constexpr int CT = (STAGES - 1) * T::STAGE;
  static constexpr int XN = CT + (T::EPI > T::STAGE ? T::EPI : T::STAGE);
  static constexpr size_t SMEM = sizeof(float) * (XN + BN);
};

template <int BQ, bool VEC>
__global__ void __launch_bounds__(Tile<BQ>::NT, Split<BQ>::MIN_BLOCKS)
centroid_topk_partial(const float* __restrict__ q, const float* __restrict__ c,
                      const uint8_t* __restrict__ vis, int Q, int M, int d,
                      int k, int chunk, int n_qtiles, int nchunks,
                      float* __restrict__ part_s, int* __restrict__ part_i) {
  using S = Split<BQ>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem + S::CT;
  float* xn = smem + S::XN;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * S::RPW;  // the warp's first row
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int ch = blockIdx.x / n_qtiles;
  const int m_begin = ch * chunk;
  const int m_end = min(M, m_begin + chunk);

  float ls[S::RPW];
  int li[S::RPW];
#pragma unroll
  for (int r = 0; r < S::RPW; ++r) topk_empty(ls[r], li[r]);

  Acc<BQ> acc;
  float nrm;
  tile_prologue<BQ, VEC>(smem, q, c, Q, M, d, q0, m_begin);
  for (int n0 = m_begin; n0 < m_end; n0 += BN) {
    tile_mainloop<BQ, VEC>(smem, q, c, Q, M, d, q0, n0, acc, nrm);
    tile_stage<BQ>(ct, xn, acc, nrm);
    __syncthreads();
    // stages 0 and 1 are free; stage 2 (under the score tile) is refilled
    // only after the next mainloop's first barrier
    if (n0 + BN < m_end)
      tile_prologue<BQ, VEC>(smem, q, c, Q, M, d, q0, n0 + BN);

    const int c0 = lane * 4;                 // this lane's 4 columns
    float cn[4];
    bool in[4], ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = n0 + c0 + u;
      in[u] = m < m_end;
      ok[u] = in[u] && vis[m] != 0;
      cn[u] = xn[c0 + u];
    }
#pragma unroll
    for (int r = 0; r < S::RPW; ++r) {
      if (q0 + row0 + r >= Q) continue;      // uniform across the warp
      const float4 a =
          *reinterpret_cast<const float4*>(ct + (row0 + r) * CTS + c0);
      const float sc[4] = {tile_score(cn[0], a.x, ok[0]),
                           tile_score(cn[1], a.y, ok[1]),
                           tile_score(cn[2], a.z, ok[2]),
                           tile_score(cn[3], a.w, ok[3])};
      const float ts = __shfl_sync(REPRO_FULL_MASK, ls[r], k - 1);
      const int ti = __shfl_sync(REPRO_FULL_MASK, li[r], k - 1);
      bool any = false;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        any |= in[u] && lex_less(sc[u], n0 + c0 + u, ts, ti);
      if (!__any_sync(REPRO_FULL_MASK, any)) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        topk_insert_lanes(ls[r], li[r], sc[u], n0 + c0 + u, in[u], k, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < S::RPW; ++r) {
    const int qq = q0 + row0 + r;
    if (qq < Q && lane < k) {
      const size_t o = ((size_t)qq * nchunks + ch) * k + lane;
      part_s[o] = ls[r];
      part_i[o] = li[r];
    }
  }
}

template <int BQ, bool VEC>
int launch_partial(const float* q, const float* c, const uint8_t* vis, int Q,
                   int M, int d, int k, int chunk, int nchunks,
                   float* part_s, int* part_i, cudaStream_t st) {
  constexpr size_t smem = Split<BQ>::SMEM;
  // above 48 KB of shared memory only by opting in, once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !((opted >> dev) & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(
        centroid_topk_partial<BQ, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted |= 1ull << dev;
  }
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)n_qtiles * nchunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  centroid_topk_partial<BQ, VEC><<<(unsigned)blocks, Tile<BQ>::NT, smem,
                                   st>>>(q, c, vis, Q, M, d, k, chunk,
                                         n_qtiles, nchunks, part_s, part_i);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Q, d), c (M, d) fp32; vis (M,) bool bytes; 1 <= k <= min(32, M).
// part_s/part_i: (Q, nchunks, k) scratch; out_s/out_i: (Q, k).
// ``chunk`` is a multiple of 128 with nchunks * chunk >= M; the query tile
// is 32 rows for Q <= 32, else 64 (kernels/centroid_topk.py sizes the
// chunks by the same rule).
extern "C" int centroid_topk(const float* q, const float* c,
                             const uint8_t* vis, int Q, int M, int d, int k,
                             int chunk, int nchunks, float* part_s,
                             int* part_i, float* out_s, int* out_i,
                             void* stream) {
  if (k < 1 || k > 32 || chunk % BN != 0) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)c % 16 == 0;
  int err;
  if (Q <= 32)
    err = vec ? launch_partial<32, true>(q, c, vis, Q, M, d, k, chunk,
                                         nchunks, part_s, part_i, st)
              : launch_partial<32, false>(q, c, vis, Q, M, d, k, chunk,
                                          nchunks, part_s, part_i, st);
  else
    err = vec ? launch_partial<64, true>(q, c, vis, Q, M, d, k, chunk,
                                         nchunks, part_s, part_i, st)
              : launch_partial<64, false>(q, c, vis, Q, M, d, k, chunk,
                                          nchunks, part_s, part_i, st);
  if (err) return err;
  topk_merge_parts<<<Q, MERGE_WARPS * 32, 0, st>>>(
      part_s, part_i, nchunks, k, nullptr, 0, 0, out_s, out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide path, 32 < k <= TOPK_BLOCK_MAX_K: one block per (chunk, query).
// Each warp scores 32 centroids per round (lanes over the feature axis, one
// warp reduction per centroid; lane j keeps the j-th score), and the block
// keeps its chunk's top-k in shared memory (BlockTopK).  A second kernel
// merges the chunks' lists per query the same way.  The centroid table is
// read once per query (from L2 when it fits there): this path is not on
// the search's main path (nprobe <= 32 there) and is kept simple.
// ---------------------------------------------------------------------------

#define CTW_THREADS 256

__global__ void __launch_bounds__(CTW_THREADS)
centroid_topk_wide_partial(const float* __restrict__ q,
                           const float* __restrict__ c,
                           const uint8_t* __restrict__ vis, int M, int d,
                           int k, int chunk, int nchunks, int cap,
                           float* __restrict__ part_s,
                           int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qsh = smem;                         // [d]
  const int qq = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qsh[t] = q[(size_t)qq * d + t];
  BlockTopK top = block_topk_init(smem + d, cap, k);   // syncs: qsh ready
  const int m_begin = blockIdx.x * chunk;
  const int m_end = min(M, m_begin + chunk);
  for (int mt = m_begin; mt < m_end; mt += CTW_THREADS) {
    const int base = mt + warp * 32;
    float mine = REPRO_BIG;
    for (int j = 0; j < 32 && base + j < m_end; ++j) {   // warp-uniform
      const float* row = c + (size_t)(base + j) * d;
      float nrm = 0.f, dot = 0.f;
      for (int t = lane; t < d; t += 32) {
        const float cv = row[t];
        nrm += cv * cv;
        dot += qsh[t] * cv;
      }
      nrm = warp_sum(nrm);
      dot = warp_sum(dot);
      if (lane == j) mine = vis[base + j] ? nrm - 2.f * dot : REPRO_BIG;
    }
    block_topk_push(top, base + lane < m_end, mine, base + lane);
  }
  block_topk_finish(top);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const size_t o = ((size_t)qq * nchunks + blockIdx.x) * k + e;
    part_s[o] = top.s[e];
    part_i[o] = top.i[e];
  }
}

// One block per query: the top-k of its nparts partial lists (empty
// entries skipped; the lists hold disjoint keys).
__global__ void __launch_bounds__(CTW_THREADS)
topk_merge_parts_wide(const float* __restrict__ part_s,
                      const int* __restrict__ part_i, int nparts, int k,
                      int cap, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int qq = blockIdx.x;
  BlockTopK top = block_topk_init(smem, cap, k);
  const int total = nparts * k;
  for (int base = 0; base < total; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const bool in = e < total;
    const float s = in ? part_s[(size_t)qq * total + e] : CUDART_INF_F;
    const int i = in ? part_i[(size_t)qq * total + e] : INT_MAX;
    block_topk_push(top, in && i != INT_MAX, s, i);
  }
  block_topk_finish(top);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_s[(size_t)qq * k + e] = top.s[e];
    out_i[(size_t)qq * k + e] = top.i[e];
  }
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// As centroid_topk, for 1 <= k <= min(TOPK_BLOCK_MAX_K, M); Q <= 65535.
// part_s/part_i: (Q, nchunks, k); ``chunk`` * nchunks >= M.
extern "C" int centroid_topk_wide(const float* q, const float* c,
                                  const uint8_t* vis, int Q, int M, int d,
                                  int k, int chunk, int nchunks,
                                  float* part_s, int* part_i, float* out_s,
                                  int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K) return (int)cudaErrorInvalidValue;
  const int cap = block_topk_cap(k, CTW_THREADS, 1024);
  const size_t smem1 = sizeof(float) * d + block_topk_bytes(cap);
  const size_t smem2 = block_topk_bytes(cap);
  int err = set_smem((const void*)centroid_topk_wide_partial, smem1);
  if (err) return err;
  err = set_smem((const void*)topk_merge_parts_wide, smem2);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  centroid_topk_wide_partial<<<dim3(nchunks, Q), CTW_THREADS, smem1, st>>>(
      q, c, vis, M, d, k, chunk, nchunks, cap, part_s, part_i);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_merge_parts_wide<<<Q, CTW_THREADS, smem2, st>>>(
      part_s, part_i, nchunks, k, cap, out_s, out_i);
  return (int)cudaGetLastError();
}
