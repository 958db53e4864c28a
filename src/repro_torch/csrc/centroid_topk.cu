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
//
// Wide path, 32 < k <= 1024.  It runs on main paths: phase 1 past nprobe
// 32 and every tiered search's cache scan (at rerank_k = 192).  Bounds
// (3xTF32 at 495 TFLOP/s, or bytes at 3.35 TB/s, the larger): phase 1
// 256 x 65,504 x 128 as above, 0.026 ms at any k; Q = 32, 0.010 ms
// (bytes); the cache scan 256 x 4,096 x 128, 0.0016 ms.  Design:
// - Scoring: the warp path's mainloop and score tile (score_tile.cuh) at a
//   query tile of 16 or 32 rows (4 warps), so every score ranked is bit
//   for bit the one the warp path and ops.centroid_score give: a k = 64
//   answer's first 32 are the k = 32 answer, and each centroid tile comes
//   from L2 once per query tile.
// - Selection: a row's list is a run of 64-bit composites (order key <<
//   32 | index: one unsigned compare orders two (score, index) pairs) in
//   shared memory.  After each tile a warp's rows take, 32 columns a vote,
//   the composites below the row's threshold, appended in index order;
//   where the next tile might not fit, the row is cut to its k best by
//   warp_select (topk_select.cuh: a radix select over the order keys and
//   one in-place compaction in array order, so equal scores stay in index
//   order) and the threshold becomes the k-th.  A chunk's list is its k
//   best, in index order among ties.
// - Merging: a second launch, one block a query, takes the chunks' lists
//   in chunk order through block_select, 5,120 pairs a window behind the
//   k kept so far, then block_rank_emit, as pq_scan_topk.cu does.
// - Layout (kernels/centroid_topk.py: wide_plan): one block an SM with
//   the longest lists that fit (608 composites at 32 rows, 1,280 at 16),
//   or two an SM (16 rows, 352) where k is small or a chunk is two tiles.
// What sets the pace: the mainloop at 4 or 8 warps an SM (the warp path
// runs 16), then the cuts, each a few histogram passes over the list;
// PERF.md, section 6 has the times of both layouts at each shape.  Not
// measured: a warp bitonic sort of the list for the cut (about ten times
// the radix select's compare steps at 600 entries), and the merge inside
// a cluster (the merge is 2-25% of the wide path's time at the shapes it
// runs).
#include "score_tile.cuh"
#include "topk_select.cuh"

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
// Wide path, 32 < k <= TOPK_BLOCK_MAX_K (the header note says how).
// ---------------------------------------------------------------------------

namespace {

using namespace score_tile;

// The partial kernel's shared bytes: the warp path's ring, score tile and
// norms, then BQ row lists of ``cap`` composites, then a 256-bin
// histogram a warp.
template <int BQ>
constexpr size_t wide_bytes(int cap) {
  return sizeof(float) * (Split<BQ>::XN + BN) + (size_t)BQ * cap * 8 +
         (size_t)(Tile<BQ>::NT / 32) * 256 * sizeof(int);
}

template <int BQ, bool VEC>
__global__ void __launch_bounds__(Tile<BQ>::NT, 1)
centroid_topk_wide_partial(const float* __restrict__ q,
                           const float* __restrict__ c,
                           const uint8_t* __restrict__ vis, int Q, int M,
                           int d, int k, int chunk, int n_qtiles, int cap,
                           uint64_t* __restrict__ part) {
  using S = Split<BQ>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem + S::CT;
  float* xn = smem + S::XN;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + S::XN + BN);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* hist = reinterpret_cast<int*>(lists + (size_t)BQ * cap) + warp * 256;
  const unsigned below = (1u << lane) - 1u;
  const int row0 = warp * S::RPW;            // the warp's first row
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int ch = blockIdx.x / n_qtiles;
  const int nchunks = gridDim.x / n_qtiles;
  const int m_begin = ch * chunk;
  const int m_end = min(M, m_begin + chunk);

  // each row's list: fill entries, all below thr (none kept yet: ~0)
  int fill[S::RPW];
  uint64_t thr[S::RPW];
#pragma unroll
  for (int r = 0; r < S::RPW; ++r) {
    fill[r] = 0;
    thr[r] = ~0ull;
  }

  Acc<BQ> acc;
  float nrm;
  tile_prologue<BQ, VEC>(smem, q, c, Q, M, d, q0, m_begin);
  for (int n0 = m_begin; n0 < m_end; n0 += BN) {
    tile_mainloop<BQ, VEC>(smem, q, c, Q, M, d, q0, n0, acc, nrm);
    tile_stage<BQ>(ct, xn, acc, nrm);
    __syncthreads();
    if (n0 + BN < m_end)
      tile_prologue<BQ, VEC>(smem, q, c, Q, M, d, q0, n0 + BN);

    // lane takes columns lane, lane + 32, ...: each vote covers 32
    // centroids in index order, so a row's list grows in index order
    float cn[4];
    bool in[4], ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = n0 + u * 32 + lane;
      in[u] = m < m_end;
      ok[u] = in[u] && vis[m] != 0;
      cn[u] = xn[u * 32 + lane];
    }
#pragma unroll
    for (int r = 0; r < S::RPW; ++r) {
      const int row = row0 + r;
      if (q0 + row >= Q) continue;           // uniform across the warp
      uint64_t* buf = lists + (size_t)row * cap;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float sc =
            tile_score(cn[u], ct[row * CTS + u * 32 + lane], ok[u]);
        const uint64_t e = ((uint64_t)order_key(sc) << 32) |
                           (uint32_t)(n0 + u * 32 + lane);
        const bool pass = in[u] && e < thr[r];
        const unsigned b = __ballot_sync(REPRO_FULL_MASK, pass);
        if (pass) buf[fill[r] + __popc(b & below)] = e;
        fill[r] += __popc(b);
      }
      if (fill[r] + BN > cap) {              // the next tile might not fit
        __syncwarp();
        thr[r] = warp_select(buf, fill[r], k, hist);
        fill[r] = k;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < S::RPW; ++r) {
    const int qq = q0 + row0 + r;
    if (qq >= Q) continue;
    uint64_t* buf = lists + (size_t)(row0 + r) * cap;
    __syncwarp();
    if (fill[r] > k) {
      warp_select(buf, fill[r], k, hist);
      fill[r] = k;
    }
    // min(k, chunk's centroids) composites, in index order among ties
    uint64_t* dst = part + ((size_t)qq * nchunks + ch) * k;
    for (int e = lane; e < fill[r]; e += 32) dst[e] = buf[e];
  }
}

// The merge's shared layout for n candidates and k picks: the pairs, their
// order keys, the k picked and their composites, the selection's scratch
// (16-byte aligned regions).
struct MergeLayout {
  size_t u, uk, sel, rk, scratch, bytes;
};

__host__ __device__ inline size_t a16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

__host__ __device__ inline MergeLayout merge_layout(int n, int k) {
  MergeLayout L;
  L.u = 0;
  L.uk = L.u + a16((size_t)n * 8);
  L.sel = L.uk + a16((size_t)n * 4);
  L.rk = L.sel + a16((size_t)k * 8);
  L.scratch = L.rk + a16((size_t)k * 8);
  L.bytes = L.scratch + a16(SEL_SCRATCH_INTS * 4);
  return L;
}

// The candidates of a query's chunks: every chunk but the last holds
// min(k, chunk) of them.
__host__ __device__ inline int merge_count(int M, int k, int chunk,
                                           int nchunks) {
  const int last = M - (nchunks - 1) * chunk;
  return (nchunks - 1) * (k < chunk ? k : chunk) + (k < last ? k : last);
}

// The merge's pair buffer: block_select's n at most.
#define CTW_MERGE_N (SEL_MAX_ROUNDS * SEL_THREADS)

// One block per query: the k best of its chunks' lists, sorted.  Each
// chunk's list is in index order (appended so, compacted in array order),
// and the lists go in chunk order, so the candidates stand in index order.
// They go through block_select in windows of CTW_MERGE_N - k behind the k
// kept so far (lower indices than any new one), as pq_scan_topk.cu's
// chunks do, so equal scores stay in index order as block_select needs.
__global__ void __launch_bounds__(SEL_THREADS)
centroid_topk_wide_merge(const uint64_t* __restrict__ part, int M, int k,
                         int chunk, int nchunks, float* __restrict__ out_s,
                         int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char msmem[];
  const int n = merge_count(M, k, chunk, nchunks);
  const int nb = min(n, CTW_MERGE_N);
  const MergeLayout L = merge_layout(nb, k);
  float2* u = reinterpret_cast<float2*>(msmem + L.u);
  uint32_t* uk = reinterpret_cast<uint32_t*>(msmem + L.uk);
  float2* sel = reinterpret_cast<float2*>(msmem + L.sel);
  uint64_t* rk = reinterpret_cast<uint64_t*>(msmem + L.rk);
  int* scratch = reinterpret_cast<int*>(msmem + L.scratch);
  const int qq = blockIdx.x;
  const int per = min(k, chunk);
  const uint64_t* src = part + (size_t)qq * nchunks * k;
  int nrun = 0;                    // pairs kept from earlier windows, in sel
  int w0 = 0;                      // candidates taken so far
  do {                             // block-uniform trips
    const int cnt = min(nb - nrun, n - w0);
    for (int i = threadIdx.x; i < nrun; i += SEL_THREADS) {
      u[i] = sel[i];
      uk[i] = (uint32_t)(rk[i] >> 32);
    }
    for (int i = threadIdx.x; i < cnt; i += SEL_THREADS) {
      const int at = w0 + i;
      const int ch = at / per;
      const uint64_t e = src[(size_t)ch * k + (at - ch * per)];
      const uint32_t key = (uint32_t)(e >> 32);
      u[nrun + i] = sel_pair(key_score(key), (int)(uint32_t)e);
      uk[nrun + i] = key;
    }
    __syncthreads();
    const int m = nrun + cnt;
    nrun = min(k, m);
    block_select(u, uk, m, nrun, sel, rk, scratch);
    w0 += cnt;
  } while (w0 < n);
  block_rank_emit(sel, rk, nrun, [=](int r, float s, int key, uint64_t) {
    out_s[(size_t)qq * k + r] = s;
    out_i[(size_t)qq * k + r] = key;
  });
}

template <int BQ, bool VEC>
int launch_wide(const float* q, const float* c, const uint8_t* vis, int Q,
                int M, int d, int k, int chunk, int nchunks, int cap,
                uint64_t* part, cudaStream_t st) {
  static unsigned long long opted = 0;
  const int err = allow_smem(
      (const void*)centroid_topk_wide_partial<BQ, VEC>, opted);
  if (err) return err;
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)n_qtiles * nchunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  centroid_topk_wide_partial<BQ, VEC>
      <<<(unsigned)blocks, Tile<BQ>::NT, wide_bytes<BQ>(cap), st>>>(
          q, c, vis, Q, M, d, k, chunk, n_qtiles, cap, part);
  return (int)cudaGetLastError();
}

}  // namespace

// As centroid_topk, for 1 <= k <= min(TOPK_BLOCK_MAX_K, M) (the wrapper
// takes it past 32).  bq: the query tile, 16 or 32 rows; ``chunk`` a
// multiple of 128 with nchunks chunks covering M, none empty; ``cap`` the
// composites a row's list holds, even and >= k + 128; part (Q, nchunks, k)
// uint64 scratch.  kernels/centroid_topk.py: wide_plan sizes them; the
// partial kernel and the merge must each fit TOPK_SMEM_MAX bytes.
extern "C" int centroid_topk_wide(const float* q, const float* c,
                                  const uint8_t* vis, int Q, int M, int d,
                                  int k, int bq, int chunk, int nchunks,
                                  int cap, void* part, float* out_s,
                                  int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K || k > M || chunk % BN != 0 ||
      nchunks < 1 || (long long)(nchunks - 1) * chunk >= M ||
      (long long)nchunks * chunk < M || cap < k + BN || cap % 2 != 0 ||
      (bq != 16 && bq != 32))
    return (int)cudaErrorInvalidValue;
  const int n = merge_count(M, k, chunk, nchunks);
  const int nb = n < CTW_MERGE_N ? n : CTW_MERGE_N;
  const size_t bytes = bq == 16 ? wide_bytes<16>(cap) : wide_bytes<32>(cap);
  if (bytes > TOPK_SMEM_MAX || merge_layout(nb, k).bytes > TOPK_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  uint64_t* pt = (uint64_t*)part;
  const bool vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)c % 16 == 0;
  int err;
  if (bq == 16)
    err = vec ? launch_wide<16, true>(q, c, vis, Q, M, d, k, chunk, nchunks,
                                      cap, pt, st)
              : launch_wide<16, false>(q, c, vis, Q, M, d, k, chunk, nchunks,
                                       cap, pt, st);
  else
    err = vec ? launch_wide<32, true>(q, c, vis, Q, M, d, k, chunk, nchunks,
                                      cap, pt, st)
              : launch_wide<32, false>(q, c, vis, Q, M, d, k, chunk, nchunks,
                                       cap, pt, st);
  if (err) return err;
  static unsigned long long opted = 0;
  err = allow_smem((const void*)centroid_topk_wide_merge, opted);
  if (err) return err;
  centroid_topk_wide_merge<<<Q, SEL_THREADS, merge_layout(nb, k).bytes,
                             st>>>(pt, M, k, chunk, nchunks, out_s, out_i);
  return (int)cudaGetLastError();
}
