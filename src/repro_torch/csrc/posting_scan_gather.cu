// posting_scan_gather: the unfused probe scan.  For each query q and each of
// its P probed postings pid = probe[q, p], every slot c of the tile:
//     out[q, p, c] = vis[pid] && slot_valid[pid, c] ? ||v||^2 - 2 q.v : BIG
// with v = vectors[pid, c]; (Q, P, C) fp32, accumulated in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/posting_scan.py:
// posting_scan_gather, whose (Q, P) grid DMAs one probed tile a step into
// VMEM (scalar-prefetched probe ids) and scores it on the MXU against the
// query block: query-major, because a TPU grid step copies one tile.
//
// Bound on the H100: device-memory bytes.  Each slot row is d floats used
// for 2 FLOP per float and query; 256 queries x 32 probes of 96 x 128
// tiles touch about 5,400 distinct 48 KB tiles, 265 MB (0.079 ms at 3.35
// TB/s), where a query-major order reads each (query, probe) pair's tile,
// 403 MB, the pairs that share a tile too far apart in time for L2.
// Design: tile-major, so that each distinct probed tile is read once.
// - Inversion (posting_scan_gather_invert): the Q*P pairs e = q*P + p
//   are grouped by pid and each group cut into items of at most ``qch``
//   pairs, so that a popular posting does not set the tail.  Block b of
//   at least 128 owns the postings pid = b mod G and counts their pairs
//   in shared memory; an atomic on two totals reserves its items and
//   pairs, so no block waits on another and no order is imposed beyond
//   the grouping (a pair's score does not depend on which item holds
//   it).  A single block sorting the pairs (radix or atomic grouping)
//   spends its time on one SM's scattered accesses; spread over the
//   grid, the same work is a few loads a thread.
// - Scoring (posting_scan_gather_kernel): a persistent grid, about two
//   blocks an SM, takes the items one at a time from a shared counter, so
//   that the blocks finish together.  A producer warp streams each item's
//   tile through a two-stage ring in shared memory, in units of at most
//   48 KB (row_score.cuh): one Hopper bulk copy of the unit, issued first,
//   and one of each of the item's query rows on the stage's mbarrier
//   (bulk_copy.cuh), the item's pairs written beside them; an invisible
//   posting's unit is not copied, its barrier takes the arrival alone.  Where
//   the tiles or queries are not 16-byte aligned or d % 4 != 0 (BULK =
//   false) the producer warp copies with 4-byte cp.async.  Eight consumer
//   warps score a landed unit and release the stage on a second mbarrier,
//   so the producer's dependent loads (item, pairs, posting) stay off their
//   path.  A consumer thread takes one slot row of one pair at a time:
//   the item's first pair walks norm and dot product together and keeps
//   the norm, its other pairs reuse it (row_walk, shared with
//   posting_scan_topk.cu: both give a row the same bits).  Consecutive
//   threads take consecutive slots, so out[q, p, :] is written coalesced;
//   an invisible posting's rows are written BIG.
#include <algorithm>

#include "bulk_copy.cuh"
#include "row_score.cuh"

#define PSG_BIG 1e30f
#define PSG_CONSUMERS 256              // eight consumer warps
#define PSG_THREADS (PSG_CONSUMERS + 32)   // and one producer warp
#define PSG_QMAX 16                    // pairs an item at most
#define PSG_QS_FLOATS 2048             // query rows a stage, in floats
#define INV_THREADS 1024
#define INV_WARPS (INV_THREADS / 32)
#define INV_BATCH 8                    // probe loads a thread has in flight
#define INV_TABLE 3072                 // postings an inversion block owns
#define INV_BLOCKS 128                 // inversion blocks at least

// ---------------------------------------------------------------------------
// the inversion
// ---------------------------------------------------------------------------

// Exclusive sum scan of a[0..n) in place by all INV_THREADS threads;
// returns the total.  Warp w takes a contiguous span, 32 consecutive
// elements a step (a shuffle scan and a carry), then adds the spans before
// it: no two lanes of a warp touch one bank.  ``part`` holds INV_WARPS + 1
// ints.
__device__ int inv_scan(int* a, int n, int* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (n + INV_THREADS - 1) / INV_THREADS * 32;
  const int w0 = min(n, warp * span), w1 = min(n, w0 + span);
  int carry = 0;
  for (int b = w0; b < w1; b += 32) {
    const int i = b + lane;
    const int v = i < w1 ? a[i] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    inc += carry;
    if (i < w1) a[i] = inc - v;
    carry = __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) part[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    int w = lane < INV_WARPS ? part[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < INV_WARPS) part[lane] = w;         // inclusive over warps
    if (lane == INV_WARPS - 1) part[INV_WARPS] = w;
  }
  __syncthreads();
  if (warp > 0)
    for (int i = w0 + lane; i < w1; i += 32) a[i] += part[warp - 1];
  const int total = part[INV_WARPS];
  __syncthreads();                                // part may be reused
  return total;
}

// probe (N = Q*P pairs) -> entries (N: the pairs e = q*P + p grouped by
// clamped pid) and items (int4: first entry, length <= qch, the posting or
// ~pid where vis[pid] is false).  totals, zero at the launch: the items
// reserved so far in the high word, the pairs in the low word, one 64-bit
// atomic a block.
//
// Block b of G owns the postings pid = b, b + G, ..., counted in shared
// memory at pid / G (ceil(M / G) <= INV_TABLE of them).  It reads the
// probes twice, INV_BATCH loads a thread in flight (one L2 latency a batch
// of 8,192): first it counts its postings' pairs; then one atomic a total
// reserves its items and pairs, a scan places them, and it writes the item
// records; then each of its pairs takes the next place in its posting's
// run.  No block waits on another, and the groups and the pairs within
// one fall in an order the atomics choose; the scores do not depend on
// which item holds a pair.
struct InvBatch {
  int p[INV_BATCH];
  __device__ __forceinline__ void load(const int* __restrict__ probe, int N,
                                       int i0) {
#pragma unroll
    for (int u = 0; u < INV_BATCH; ++u) {
      const int i = i0 + u * INV_THREADS;
      p[u] = i < N ? probe[i] : 0;
    }
  }
  // each(i, pid / G) for the batch's pairs of this block's postings
  template <class Each>
  __device__ __forceinline__ void visit(int N, int M, int G, int b, int i0,
                                        Each each) const {
#pragma unroll
    for (int u = 0; u < INV_BATCH; ++u) {
      const int i = i0 + u * INV_THREADS;
      const int pid = min(max(p[u], 0), M - 1);
      if (i < N && pid % G == b) each(i, pid / G);
    }
  }
};

__global__ void __launch_bounds__(INV_THREADS)
posting_scan_gather_invert(const int* __restrict__ probe,
                           const uint8_t* __restrict__ vis, int N, int M,
                           int qch, int* __restrict__ entries,
                           int4* __restrict__ items,
                           unsigned long long* totals) {
  __shared__ int cnt[INV_TABLE], first[INV_TABLE], at[INV_TABLE];
  __shared__ int part[INV_WARPS + 1], base[2];
  const int tid = threadIdx.x;
  const int G = gridDim.x, b = blockIdx.x;
  const int T = (M - b + G - 1) / G;               // postings of this block
  for (int j = tid; j < T; j += INV_THREADS) cnt[j] = 0;
  __syncthreads();
  const int step = INV_THREADS * INV_BATCH;
  InvBatch batch;
  for (int i0 = tid; i0 < N; i0 += step) {
    batch.load(probe, N, i0);
    batch.visit(N, M, G, b, i0, [&](int, int j) { atomicAdd(&cnt[j], 1); });
  }
  __syncthreads();
  for (int j = tid; j < T; j += INV_THREADS) {
    first[j] = cnt[j];
    at[j] = (cnt[j] + qch - 1) / qch;
  }
  __syncthreads();
  const int pairs = inv_scan(first, T, part);
  const int n_items = inv_scan(at, T, part);
  if (tid == 0 && pairs > 0) {
    const unsigned long long at0 = atomicAdd(
        totals, ((unsigned long long)n_items << 32) | (unsigned)pairs);
    base[0] = (int)(at0 & 0xffffffffu);
    base[1] = (int)(at0 >> 32);
  }
  __syncthreads();
  if (pairs == 0) return;
  for (int j = tid; j < T; j += INV_THREADS) {
    const int n = cnt[j];
    if (n == 0) continue;
    const int pid = j * G + b;
    const int p0 = base[0] + first[j], i0 = base[1] + at[j];
    const int pv = vis[pid] ? pid : ~pid;
    for (int k = 0; k * qch < n; ++k)
      items[i0 + k] = make_int4(p0 + k * qch, min(qch, n - k * qch), pv, 0);
    first[j] = p0;                                 // the run's first entry
    cnt[j] = 0;                                    // now its fill count
  }
  __syncthreads();
  for (int i0 = tid; i0 < N; i0 += step) {
    batch.load(probe, N, i0);
    batch.visit(N, M, G, b, i0, [&](int i, int j) {
      entries[first[j] + atomicAdd(&cnt[j], 1)] = i;
    });
  }
}

// ---------------------------------------------------------------------------
// the scoring
// ---------------------------------------------------------------------------

struct PsgLayout {        // byte offsets in shared memory (host-computed)
  int rec, ent, stage, qs, vn, bytes;
};

static PsgLayout psg_layout(int stage_floats, int qs_floats, int R) {
  PsgLayout L;
  int o = 4 * 8;                               // full[2], empty[2]
  L.rec = o;  o += 2 * 16;                     // int4 a stage
  L.ent = o;  o += 2 * PSG_QMAX * 4;
  L.stage = o; o += 2 * stage_floats * 4;      // 16-byte aligned
  L.qs = o;   o += 2 * qs_floats * 4;
  L.vn = o;   o += 2 * ((R + 3) & ~3) * 4;
  L.bytes = o;
  return L;
}

template <bool BULK, bool V4>
__global__ void __launch_bounds__(PSG_THREADS, 2)
posting_scan_gather_kernel(const float* __restrict__ q,
                           const float* __restrict__ vec,
                           const uint8_t* __restrict__ slot_valid,
                           const int* __restrict__ entries,
                           const int4* __restrict__ items,
                           const unsigned long long* __restrict__ totals,
                           int* __restrict__ next_item, int C, int d, int P,
                           int R, int stage_floats, int qs_floats,
                           PsgLayout lay, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);       // [2]
  uint64_t* empty = full + 2;                               // [2]
  int4* rec = reinterpret_cast<int4*>(smem + lay.rec);      // [2]
  int* ent = reinterpret_cast<int*>(smem + lay.ent);        // [2][QMAX]
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* vn = reinterpret_cast<float*>(smem + lay.vn);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int dq = (d + 3) & ~3;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], PSG_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 32) {                 // the producer warp
    // block b's first item is item b; then one item at a time from a
    // counter all blocks share, so that they finish together; the next
    // item's index is fetched a turn early
    const int n = (int)(*totals >> 32);             // the items
    int it = blockIdx.x, nxt = 0;
    int4 rc = items[it];            // in bounds: the grid is at most N
    for (int s = 0;; ) {
      const bool done = it >= n;
      int start = 0, len = 0, pv = 0;
      if (!done) {
        if (s > 0) rc = items[it];
        start = rc.x;
        len = rc.y;
        pv = rc.z;
        if (lane == 0) nxt = gridDim.x + atomicAdd(next_item, 1);
      }
      const bool visible = pv >= 0;
      const int pid = visible ? pv : ~pv;
      for (int r0 = 0; r0 < (done ? 1 : C); r0 += R, ++s) {
        const int st = s & 1;
        if (s >= 2) mbar_wait(&empty[st], ((s >> 1) - 1) & 1);
        if (done) {                          // the consumers' last record
          if (lane == 0) {
            rec[st] = make_int4(-1, 0, 0, 0);
            mbar_arrive(&full[st]);
          }
          break;
        }
        const int rows = min(R, C - r0);
        float* dst = stage + (size_t)st * stage_floats;
        float* qdst = qs + (size_t)st * qs_floats;
        const float* src = vec + ((size_t)pid * C + r0) * d;
        if (BULK && visible && lane == 0) {  // the tile first: it is large
          mbar_expect_tx(&full[st], (uint32_t)((rows + len) * d) * 4u);
          bulk_copy_g2s(dst, src, (uint32_t)(rows * d) * 4u, &full[st]);
        }
        const int e = lane < len ? entries[start + lane] : 0;
        if (lane < len) ent[st * PSG_QMAX + lane] = e;
        if (lane == 0) rec[st] = make_int4(len, pid, visible, r0);
        if (BULK) {
          __syncwarp();
          if (visible && lane < len)
            bulk_copy_g2s(qdst + lane * dq, q + (size_t)(e / P) * d,
                          (uint32_t)d * 4u, &full[st]);
          __syncwarp();          // the arrival releases rec and ent
          if (lane == 0) mbar_arrive(&full[st]);
        } else {                 // 4-byte cp.async, all in flight at once
          if (visible) {
            for (int x = lane; x < rows * d; x += 32)
              cp_async4(dst + x, src + x, 4);
            for (int l = 0; l < len; ++l) {
              const int el = __shfl_sync(0xffffffffu, e, l);
              const float* qrow = q + (size_t)(el / P) * d;
              for (int t = lane; t < d; t += 32)
                cp_async4(qdst + l * dq + t, qrow + t, 4);
            }
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[st]);
        }
      }
      if (done) break;
      it = __shfl_sync(0xffffffffu, nxt, 0);
    }
    return;
  }

  const int ctid = tid - 32;                  // consumer thread
  const int dw = V4 ? d / 4 : d;
  for (int s = 0;; ++s) {
    const int st = s & 1;
    mbar_wait(&full[st], (s >> 1) & 1);
    const int4 rc = rec[st];
    if (rc.x < 0) break;                      // no items left
    const int len = rc.x, pid = rc.y, r0 = rc.w;
    const int rows = min(R, C - r0);
    const int* en = ent + st * PSG_QMAX;
    if (!rc.z) {
      for (int x = ctid; x < len * rows; x += PSG_CONSUMERS) {
        const int l = x / rows;
        out[(size_t)en[l] * C + r0 + (x - l * rows)] = PSG_BIG;
      }
    } else {
      const float* tile = stage + (size_t)st * stage_floats;
      const float* qv = qs + (size_t)st * qs_floats;
      float* norm = vn + st * ((R + 3) & ~3);
      const uint8_t* ok = slot_valid + (size_t)pid * C + r0;
      // the first pair: norm and dot product in one walk, the norm kept
      for (int r = ctid; r < rows; r += PSG_CONSUMERS) {
        float a = 0.f, dot = 0.f;
        row_walk<V4, true, true>(tile + r * d, qv, dw, row_start(r, dw), a,
                                 dot);
        norm[r] = a;
        out[(size_t)en[0] * C + r0 + r] = ok[r] ? a - 2.f * dot : PSG_BIG;
      }
      if (len > 1) {
        asm volatile("bar.sync 1, %0;\n" :: "n"(PSG_CONSUMERS) : "memory");
        for (int x = rows + ctid; x < len * rows; x += PSG_CONSUMERS) {
          const int l = x / rows;
          const int r = x - l * rows;
          float a = 0.f, dot = 0.f;
          row_walk<V4, false, true>(tile + r * d, qv + l * dq, dw,
                                    row_start(r, dw), a, dot);
          out[(size_t)en[l] * C + r0 + r] =
              ok[r] ? norm[r] - 2.f * dot : PSG_BIG;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
  }
}

template <bool BULK, bool V4>
static int launch_scan(int N, cudaStream_t st, const float* q,
                       const float* vec, const uint8_t* slot_valid,
                       const int* entries, const int4* items,
                       const unsigned long long* totals, int* next_item,
                       int C, int d, int P, int R, int stage_floats,
                       int qs_floats, const PsgLayout& lay, float* out) {
  auto kern = posting_scan_gather_kernel<BULK, V4>;
  // the opt-in and the grid for this smem, per device (the attribute is
  // set on the current device, which the wrapper makes the tensors')
  static int cached_smem[64], cached_blocks[64];
  static unsigned long long seen = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev & 63;
  if (!((seen >> slot) & 1ull) || lay.bytes != cached_smem[slot] ||
      dev >= 64) {
    if (lay.bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
      if (err != cudaSuccess) return (int)err;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  PSG_THREADS, lay.bytes);
    cached_blocks[slot] = std::max(1, per_sm) * std::max(1, sms);
    cached_smem[slot] = lay.bytes;
    seen |= 1ull << slot;
  }
  const int blocks = cached_blocks[slot];
  kern<<<std::min(N, blocks), PSG_THREADS, lay.bytes, st>>>(
      q, vec, slot_valid, entries, items, totals, next_item, C, d, P, R,
      stage_floats, qs_floats, lay, out);
  return (int)cudaGetLastError();
}

// Ints of device scratch posting_scan_gather needs for Q*P = N pairs: the
// items (4N, int4), the inversion's totals (2) and the scoring's item
// counter (1, padded to 2), the grouped pairs (N).
extern "C" long long posting_scan_gather_scratch(long long N) {
  return 5 * N + 4;
}

// q (Q, d), vectors (M, C, d) fp32; slot_valid (M, C) and vis (M,) bool
// bytes; probe (Q, P) int32, entries in [0, M) (clamped for safety);
// scratch: posting_scan_gather_scratch(Q * P) ints, 16-byte aligned; out
// (Q, P, C) fp32.  Needs 1 <= d <= PS_UNIT_FLOATS and 5*Q*P + 4 < 2^31.
// Returns the first CUDA error of the memset and the two launches (0 =
// launched).
extern "C" int posting_scan_gather(const float* q, const float* vec,
                                   const uint8_t* slot_valid,
                                   const uint8_t* vis, const int* probe,
                                   int Q, int M, int C, int d, int P,
                                   int* scratch, float* out, void* stream) {
  if (Q <= 0 || P <= 0 || C <= 0) return (int)cudaGetLastError();
  if (M < 1 || d < 1 || d > PS_UNIT_FLOATS ||
      5LL * Q * P + 4 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = Q * P;
  const int dq = (d + 3) & ~3;
  const int qch = std::max(1, std::min(PSG_QMAX, PSG_QS_FLOATS / dq));
  int4* items = reinterpret_cast<int4*>(scratch);
  int* tail = scratch + 4 * (size_t)N;
  auto* totals = reinterpret_cast<unsigned long long*>(tail);
  int* next_item = tail + 2;
  int* entries = tail + 4;
  cudaError_t err = cudaMemsetAsync(totals, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int G = std::max(INV_BLOCKS, (M + INV_TABLE - 1) / INV_TABLE);
  posting_scan_gather_invert<<<G, INV_THREADS, 0, st>>>(
      probe, vis, N, M, qch, entries, items, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int R = unit_rows(C, d);
  const int stage_floats = (R * d + 3) & ~3;
  const int qs_floats = qch * dq;
  const PsgLayout lay = psg_layout(stage_floats, qs_floats, R);
  const bool v4 = d % 4 == 0;
  const bool bulk = v4 && (uintptr_t)vec % 16 == 0 && (uintptr_t)q % 16 == 0;
  return bulk ? launch_scan<true, true>(N, st, q, vec, slot_valid, entries,
                                        items, totals, next_item, C, d, P, R,
                                        stage_floats, qs_floats, lay, out)
         : v4 ? launch_scan<false, true>(N, st, q, vec, slot_valid, entries,
                                         items, totals, next_item, C, d, P, R,
                                         stage_floats, qs_floats, lay, out)
              : launch_scan<false, false>(N, st, q, vec, slot_valid, entries,
                                          items, totals, next_item, C, d, P, R,
                                          stage_floats, qs_floats, lay, out);
}
