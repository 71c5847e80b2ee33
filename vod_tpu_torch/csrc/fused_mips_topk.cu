// fused_mips_topk: exact top-k by inner product, without a [B, N] score array
// in device memory.
//
// Replaces the TPU kernel `vod_tpu/ops/mips_pallas.py:_exact_kernel`
// (wrapper `fused_mips_topk`). For queries q [B, D] and corpus rows v [N, D]
// it writes, for each query b, the k (1 <= k <= 128) highest scores q_b . v_j
// over rows j < n_real, ordered by (score descending, row id ascending), with
// their row ids. Slots that no row fills hold -inf with id -1 (the repo's
// padding contract; the TPU kernel leaves a stale id there, see
// `vod_tpu_torch/ops/mips.py`).
//
// What bounds it on the H100: the corpus read (N * D * element size bytes over
// HBM) at serving batch (B <= 64), the 2 * B * N * D operations at B = 2048.
//
// Two bodies compute the scores of a tile of 64 queries x 64 or 128 rows; the
// wrapper names the one a call takes by a fixed rule on dtype and shape
// (`ops/mips.py:_topk_body`):
//   * "wgmma" (`topk_wgmma_kernel`), a bf16 corpus with D % 8 == 0, D <= 896
//     and 16-byte-aligned rows: the product runs on the tensor cores
//     (`wgmma.mma_async` m64n128k16, bf16 in, f32 accumulate, never rounded
//     to bf16). The block's 64 queries are M and its corpus rows N, 128 a
//     tile; both operands are K-major as they lie in memory. The query tile is
//     loaded once (ceil(D / 64) TMA boxes of 64 x 64, 96 KB at D = 768) and
//     stays resident; the rows stream through a ring of TMA boxes of 128 rows
//     x 64 bf16 (16 KB, 128-byte swizzle, the layout the `wgmma` descriptors
//     name), completed on `mbarrier`s, as deep as the rest of shared memory
//     allows (at D = 768: 5 boxes at k <= 32, 4 at k <= 64, 3 above).
//     Warpgroup 0 multiplies tile t + 1 while 8 to 16 warps of their own
//     select from tile t. The tensor maps' zero fill covers the ragged ends
//     of B, N and D.
//     What the design answers: the operation bound at B = 2048 (tensor cores;
//     an m64n64k16 reads 4 KB of shared memory per 32 tensor-core cycles, all
//     the SM's shared-memory bandwidth, an m64n128k16 6 KB per 64, so the
//     rows are N and 128 wide), the byte bound at B <= 64 (the loads run
//     ahead across the product and the selection, so the corpus streams
//     without stopping), and the selection at wide k, which must keep up
//     with the product: inserted one candidate at a time into lists in
//     shared memory (the first port's design, still the CUDA-core body's),
//     it took 2.5 ms of a B = 64, k = 128 call whose product takes 0.73
//     (PERF.md §6), and its 64 KB of lists cut the ring to 2 boxes.
//   * "fma" (`topk_float_kernel`), f32 and every other bf16 call: f32 FMAs on
//     CUDA cores (no TF32: the f32 contract is full f32), on the product core
//     of `sm90.cuh` (namespace `simt`): 4 warps multiply (8 x 4 sums a
//     thread) while 4 stage k-slices of rows at any alignment through a ring
//     in shared memory. At k <= 64 the multiplying warps fold each tile into
//     the lists; above, 4 warps of their own fold tile t while tile t + 1 is
//     multiplied, the one score tile passing between them on named barriers.
//     What the design answers: the CUDA-core operation bound (the
//     multiplying warps' issue slots go to FMAs, memory latency stalls only
//     the staging warps), and the selection at k = 128, which in the first
//     port's body, run after each tile by every warp, took 40% of the time
//     at B = 64 (12.07 ms against 7.22 ms at k = 1, PERF.md §6).
//
// Design of the selection:
//   * A block owns 64 queries and one contiguous range of rows (a "split"),
//     which it walks in tiles of 64 rows (CUDA cores) or 128 rows (tensor
//     cores) in increasing row order. Each tile's
//     scores are written to a score tile S[query][row] in shared memory.
//   * Each query keeps a list sorted by (score descending, id ascending). A
//     score is a candidate only if it is strictly greater than the list's
//     k-th score; a warp ballot over the tile's row picks the candidates.
//     Since every row of a tile lies above every row already in the lists,
//     an equal score never displaces an earlier row, so ties keep the lowest
//     id. After the first rows candidates are rare (about k ln(N / k) per
//     query for rows in random order); adversarial data (rows sorted by
//     score) is slow but still right.
//   * CUDA-core body: the lists (k pairs) sit in dynamic shared memory, one
//     warp serves a query at a time and inserts its candidates one by one in
//     increasing row order, each after every equal score.
//   * Tensor-core body: 8, 12 or 16 folding warps by k (`fold_warps_of`),
//     each serving its queries in turn. A list keeps its k scores in shared
//     memory, and its ids there too as 16-bit offsets where a split is short
//     enough and they cost the ring no box, else in the block's own output
//     row in device memory (`NarrowIds`, `WideIds`). A query's candidates
//     are compacted, in row order, into the front of its row of the score
//     tile and taken 32 at a time; each batch is merged by ranks (a pass
//     over the batch counts, for each list pair and candidate, the
//     candidates above it; a binary search of the list counts the list
//     pairs at or above each candidate), every pair is written once to its
//     new place, and the threshold (the k-th score) moves once a batch. A
//     threshold left stale by a batch only admits candidates that the merge
//     then drops. Tried and measured slower or spilling (PERF.md §6):
//     lists in registers (8 queries x 128 pairs a warp spilled at 168
//     registers, and `setmaxnreg` did not raise what ptxas allocated),
//     bitonic sorts and merges of each batch and one-at-a-time inserts of a
//     few candidates (chains of dependent shuffles), 32-bit ids in shared
//     memory (2 boxes at k = 128), queries taken from a shared counter,
//     ranks by ballots, and a batch a 32-row part in place of the offsets'
//     buffer (4 boxes at k = 128, but more batches).
//   * The TPU grid carries the buffer across corpus tiles in order on one core;
//     GPU blocks run in parallel. So the rows are split across the grid's second
//     dimension (at serving batch one query tile would leave most SMs idle),
//     into as many splits as fill every SM with resident blocks in one wave,
//     each split writes a partial list [splits, B, k], and a merge kernel
//     (`merge_splits_kernel`, design at the kernel) selects the k best of a
//     query's splits x k pairs, the lower split first on equal scores. Split z
//     holds only rows below those of split z + 1, so the result equals one
//     sequential pass over all rows.
//   * Rows at or past n_real are never read.

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// QT, RT, WRT and MAX_CHUNKS have twins in `ops/mips.py` (_QUERY_TILE,
// _TOPK_ROW_TILE, _WGMMA_MAX_D): change both sides together.
constexpr int QT = 64;        // queries per block
constexpr int RT = 64;        // rows per tile of the CUDA-core body
constexpr int KMAX = 128;     // the TPU kernel's _K_PAD: the widest list
constexpr unsigned FULL = 0xffffffffu;
constexpr int FSP = RT + 4;   // score tile row stride of the CUDA-core body: rows of float4
static_assert(simt::TILE == QT && simt::TILE == RT, "the product core's tile is the block's");
// tensor-core body
constexpr int MAX_STAGES = 16;             // cap on the TMA boxes in flight per block
constexpr int KC = 64;                     // bf16 per TMA box row: 128 bytes, one swizzle span
constexpr int WRT = 128;                   // corpus rows per tile: the wgmma's N
constexpr int QBOX_BYTES = QT * KC * 2;    // 8 KB: a box of 64 queries x 64 bf16
constexpr int BOX_BYTES = WRT * KC * 2;    // 16 KB: a ring box of 128 rows x 64 bf16
constexpr int SP = WRT + 4;                // score tile row stride: 2-way conflicts on the float2 stores
constexpr int MAX_CHUNKS = 14;             // D <= 896 (the query tile beside the score tile and a ring)
// The tensor-core body's folding warps at list width 32 KP: 8 (k <= 32), 12
// (k <= 64) or 16 (k <= 128, 4 queries each), after the multiplying
// warpgroup. More folding warps fold faster (the fold waits on latency, not
// on issue slots) but leave fewer registers a thread: at 640 threads, 96,
// which slowed the product at B = 2048 by 7% (PERF.md §6), so the
// narrow lists, whose fold is light, keep 8.
__host__ __device__ constexpr int fold_warps_of(int kp) { return kp == 1 ? 8 : kp == 2 ? 12 : 16; }
__host__ __device__ constexpr int wgmma_threads(int kp) { return 128 + 32 * fold_warps_of(kp); }

// Insert (sc, id) into the warp's list ls/li of k entries sorted by (score
// descending, id ascending). The caller guarantees sc > ls[k - 1] and that every
// entry with a score equal to sc has a lower id, so the new entry goes after
// all entries with score >= sc. Called by all 32 lanes of the warp.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k, float sc, int id, int lane) {
  float ms[KMAX / 32];
  int mi[KMAX / 32];
  int pos = 0;
#pragma unroll
  for (int c = 0; c < KMAX / 32; ++c) {
    const int j = c * 32 + lane;
    const bool in = j < k;
    ms[c] = in ? ls[j] : -INFINITY;
    mi[c] = in ? li[j] : -1;
    pos += __popc(__ballot_sync(FULL, in && ms[c] >= sc));
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < KMAX / 32; ++c) {
    const int j = c * 32 + lane;
    if (j >= pos && j + 1 < k) { ls[j + 1] = ms[c]; li[j + 1] = mi[c]; }
  }
  if (lane == 0) { ls[pos] = sc; li[pos] = id; }
  __syncwarp();
}

// Fold a tile of scores S[query][row] (row stride `sp`, rows r0 .. r0 + ROWS
// - 1) into the block's running lists: warp w of the `warps` selecting warps
// serves queries w, w + warps, ... Called by all of them between two barriers.
template <int ROWS>
__device__ __forceinline__ void fold_tile(const float* S, int sp, float* Ls, int* Li, int k, int kp,
                                          int queries, long long r0, int warp, int warps, int lane) {
  for (int qq = warp; qq < queries; qq += warps) {
    float* ls = Ls + qq * kp;
    int* li = Li + qq * kp;
    float thr = ls[k - 1];
#pragma unroll
    for (int part = 0; part < ROWS / 32; ++part) {
      const float sc = S[qq * sp + part * 32 + lane];
      unsigned cand = __ballot_sync(FULL, sc > thr);
      while (cand) {  // in increasing row order
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float c = __shfl_sync(FULL, sc, src);
        if (c > thr) {
          warp_insert(ls, li, k, c, (int)(r0 + part * 32 + src), lane);
          thr = ls[k - 1];
        }
      }
    }
  }
}

// Write the block's lists for its queries to split blockIdx.y of [splits, B, k]
// (NT threads).
template <int NT>
__device__ __forceinline__ void store_lists(const float* Ls, const int* Li, float* out_s, int* out_i,
                                            int B, int k, int kp, int q0) {
  const size_t base = (size_t)blockIdx.y * B * k;
  for (int e = threadIdx.x; e < QT * k; e += NT) {
    const int qq = e / k, slot = e % k;
    if (q0 + qq >= B) break;
    out_s[base + (size_t)(q0 + qq) * k + slot] = Ls[qq * kp + slot];
    out_i[base + (size_t)(q0 + qq) * k + slot] = Li[qq * kp + slot];
  }
}

// Named barriers of the CUDA-core body, after the product core's ring
// (simt::BAR_FREE up): the score tile is full (the multiplying warps stored a
// tile), it is empty (the folding warps have folded it), and the
// multiplying warps' own barrier where they fold themselves.
constexpr int FMA_BAR_FULL = simt::BAR_FREE, FMA_BAR_EMPTY = simt::BAR_FREE + 1, FMA_BAR_MATH = simt::BAR_FREE + 2;
template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() { asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(COUNT) : "memory"); }
template <int ID, int COUNT>
__device__ __forceinline__ void named_arrive() { asm volatile("bar.arrive %0, %1;\n" :: "n"(ID), "n"(COUNT) : "memory"); }

// Warps that fold in the CUDA-core body: none where the lists hold at most 64
// scores (the multiplying warps fold each tile, a few percent of its time),
// 4 above: at k = 128 a split's first tiles insert every row, the insertions
// are chains of shared-memory round trips, and folded by every warp after
// each tile they took 40% of the time at B = 64 (PERF.md §6); the folding
// warps fold tile t while the others multiply tile t + 1.
__host__ __device__ constexpr int fold_warps(int k) { return k <= 64 ? 0 : 4; }
template <int FOLDERS> __host__ __device__ constexpr int fma_threads() { return simt::CORE_THREADS + 32 * FOLDERS; }
template <int FOLDERS> __host__ __device__ constexpr int fma_min_blocks() { return FOLDERS == 0 ? 3 : 2; }

// The CUDA-core body on the product core (`sm90.cuh`, namespace `simt`):
// warps 0-3 multiply the block's tiles in order (S = the tile's 64 x 64
// sums), warps 4-7 stage their slices through the ring, and the lists take
// each S in turn, from the multiplying warps themselves (FOLDERS = 0) or from
// FOLDERS warps of their own that fold tile t while tile t + 1 is multiplied,
// the one score tile passing between them on named barriers as in the
// tensor-core body.
template <typename T, int FOLDERS, bool ALIGNED>
__global__ void __launch_bounds__(fma_threads<FOLDERS>(), fma_min_blocks<FOLDERS>())
topk_float_kernel(const T* __restrict__ q, const T* __restrict__ v,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int D, int k, int kp, int n_real, long long rows_per_split) {
  constexpr int NT = fma_threads<FOLDERS>();
  extern __shared__ float4 smem_fma[];
  float* ring_base = reinterpret_cast<float*>(smem_fma);  // the product core's ring
  float* S = ring_base + simt::STAGE_FLOATS;                // [QT][FSP]
  float* Ls = S + QT * FSP;                                 // [QT][kp] scores, then [QT][kp] ids
  int* Li = reinterpret_cast<int*>(Ls + QT * kp);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QT;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end = min((long long)n_real, row_begin + rows_per_split);
  const int tiles = row_end > row_begin ? (int)((row_end - row_begin + RT - 1) / RT) : 0;
  const int queries = min(QT, B - q0);
  simt::Ring ring{ring_base, 0, tiles * simt::slices_of(D)};

  for (int e = tid; e < QT * kp; e += NT) { Ls[e] = -INFINITY; Li[e] = -1; }
  __syncthreads();

  if (tid >= simt::THREADS && tid < simt::CORE_THREADS) {
    // staging: the tile's queries, or its corpus rows
    constexpr int CH = simt::Span<T>::CH;
    const int first = simt::first_staged_row<T>(tid - simt::THREADS);
    const int q_live = max(0, min(CH, B - q0 - first));
    for (int t = 0; t < tiles; ++t) {
      const long long j = row_begin + (long long)t * RT + first - QT;
      const T* rows = first < QT ? q + (size_t)(q0 + first) * D : v + (size_t)j * D;
      const int live = first < QT ? q_live : (int)max(0ll, min((long long)CH, row_end - j));
      simt::stage_tile<T, ALIGNED>(rows, live, D, ring);
    }
  } else if (tid < simt::THREADS) {
    const int row0 = simt::row_of(tid, 0);
    for (int t = 0; t < tiles; ++t) {
      const long long r0 = row_begin + (long long)t * RT;
      float acc[simt::MQ][simt::MR];
      simt::multiply_tile<T>(D, ring, acc);
      if constexpr (FOLDERS > 0) {
        if (t > 0) named_sync<FMA_BAR_EMPTY, simt::THREADS + 32 * FOLDERS>();  // tile t - 1 is folded
      } else {
        named_sync<FMA_BAR_MATH, simt::THREADS>();  // every multiplying warp has folded tile t - 1
      }
#pragma unroll
      for (int i = 0; i < simt::MQ; ++i) {
        float4 s4;
        s4.x = r0 + row0 < row_end ? acc[i][0] : -INFINITY;
        s4.y = r0 + row0 + 1 < row_end ? acc[i][1] : -INFINITY;
        s4.z = r0 + row0 + 2 < row_end ? acc[i][2] : -INFINITY;
        s4.w = r0 + row0 + 3 < row_end ? acc[i][3] : -INFINITY;
        *reinterpret_cast<float4*>(S + simt::query_of(tid, i) * FSP + row0) = s4;
      }
      if constexpr (FOLDERS > 0) {
        named_arrive<FMA_BAR_FULL, simt::THREADS + 32 * FOLDERS>();
      } else {
        named_sync<FMA_BAR_MATH, simt::THREADS>();
        fold_tile<RT>(S, FSP, Ls, Li, k, kp, queries, r0, warp, simt::THREADS / 32, lane);
      }
    }
  } else {
    for (int t = 0; t < tiles; ++t) {
      named_sync<FMA_BAR_FULL, simt::THREADS + 32 * FOLDERS>();
      fold_tile<RT>(S, FSP, Ls, Li, k, kp, queries, row_begin + (long long)t * RT, warp - simt::CORE_THREADS / 32,
                    FOLDERS, lane);
      if (t + 1 < tiles) named_arrive<FMA_BAR_EMPTY, simt::THREADS + 32 * FOLDERS>();
    }
  }
  __syncthreads();
  store_lists<NT>(Ls, Li, out_s, out_i, B, k, kp, q0);
}

// ---- tensor-core body (TMA, mbarriers and wgmma from sm90.cuh) --------------

// Dynamic shared memory of the tensor-core body: 1 KB to align the boxes,
// the query tile, the ring, the score tile, the lists' scores (32 KP a
// query) and narrow ids, the mbarriers, the folding warps' candidate
// offsets.
size_t wgmma_smem(int chunks, int kp, bool narrow, int stages) {
  return 1024 + (size_t)chunks * QBOX_BYTES + (size_t)stages * BOX_BYTES + (size_t)QT * SP * sizeof(float) +
         (size_t)QT * 32 * kp * (sizeof(float) + (narrow ? sizeof(unsigned short) : 0)) +
         (stages + 1) * sizeof(uint64_t) + fold_warps_of(kp) * WRT;
}

// Named barriers between the multiplying warpgroup and the folding ones (0 is
// __syncthreads'): the score tile is full (warpgroup 0 stored a tile), the
// score tile is empty (warpgroups 1 and 2 have folded it).
constexpr int BAR_FULL = 1, BAR_EMPTY = 2;
template <int NT>
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(NT) : "memory"); }
template <int NT>
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(NT) : "memory"); }

// Where the lists keep their ids. A split of at most 65,535 rows (B <= 448
// at N = 2^20 on an H100) keeps them in shared memory as 16-bit offsets
// from its first row, 0xFFFF for none (`NarrowIds`); a longer one in the
// block's own output rows in device memory (`WideIds`), which only the block
// touches until it ends: 64 lists of 128 32-bit ids in shared memory would
// take the ring from 3 boxes to 1, and at B = 2048 the ring's depth sets the
// pace, while at B = 64 the fold does, which waits on every read of device
// memory (PERF.md §6).
struct NarrowIds {
  unsigned short* p;
  long long base;
  __device__ __forceinline__ int get(int e) const { return p[e] == 0xFFFFu ? -1 : static_cast<int>(base + p[e]); }
  __device__ __forceinline__ void set(int e, int id) const {
    p[e] = id < 0 ? 0xFFFFu : static_cast<unsigned short>(id - base);
  }
};
struct WideIds {
  int* p;
  __device__ __forceinline__ int get(int e) const { return p[e]; }
  __device__ __forceinline__ void set(int e, int id) const { p[e] = id; }
};

// Fold one query's row of the score tile (rows r0 .. r0 + WRT - 1) into its
// list, by one warp. The list (k pairs, sorted by score descending, then id
// ascending) keeps its scores in shared memory (lsm[e]) and its ids in `gid`
// (`NarrowIds` or `WideIds`). The scores above the list's k-th (strict) are
// the candidates: compacted in row order into the front of the row itself
// (which only this warp reads), their row offsets in `offs`, they go in 32
// at a time, and each batch is merged by ranks: a list pair moves down by
// the candidates above it, a candidate lands after the candidates above it
// and the list pairs at or above its score (every list id is below every
// candidate's: the tiles, and the batches of a tile, come in row order), and
// pairs ranked k or lower drop. The ranks come from a pass over the batch
// (one shuffle and KP + 2 compares a candidate, independent of each other,
// so unrolled) and a binary search of the list: a batch costs a few hundred
// instructions without a long chain of dependent steps. The threshold moves
// up once a batch; a candidate that a batch before it has pushed under the
// threshold is dropped (a stale threshold only admits extra candidates).
template <int KP, typename Ids>
__device__ __forceinline__ void fold_row(float* row, unsigned char* offs, float* lsm, const Ids& gid, int k,
                                         long long r0, int lane) {
  float thr = lsm[k - 1];
  float sc[WRT / 32];
  unsigned take[WRT / 32];
  int count = 0;
#pragma unroll
  for (int part = 0; part < WRT / 32; ++part) {
    sc[part] = row[part * 32 + lane];
    take[part] = __ballot_sync(FULL, sc[part] > thr);
    count += __popc(take[part]);
  }
  if (count == 0) return;
  __syncwarp();  // every lane has read its scores
  int at = 0;
#pragma unroll
  for (int part = 0; part < WRT / 32; ++part) {
    if ((take[part] >> lane) & 1u) {
      const int n = at + __popc(take[part] & ((1u << lane) - 1u));
      row[n] = sc[part];
      offs[n] = static_cast<unsigned char>(part * 32 + lane);
    }
    at += __popc(take[part]);
  }
  __syncwarp();
  for (int g0 = 0; g0 < count; g0 += 32) {
    float cs = -INFINITY;
    int ci = -1;
    if (g0 + lane < count && row[g0 + lane] > thr) {
      cs = row[g0 + lane];
      ci = static_cast<int>(r0 + offs[g0 + lane]);
    }
    const unsigned live = __ballot_sync(FULL, ci >= 0);
    if (live == 0u) continue;
    float ls[KP];
    int li[KP], up[KP];
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int e = r * 32 + lane;
      ls[r] = e < k ? lsm[e] : -INFINITY;
      li[r] = e < k ? gid.get(e) : -1;
      up[r] = 0;
    }
    // the batch fills lanes 0 .. nb - 1 (a stale one holds -inf, which
    // counts for no one); its iterations are independent, so unrolled
    const int nb = 32 - __clz(live);
    int rank = 0;  // the batch's candidates above this lane's
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      const float s = __shfl_sync(FULL, cs, j);
#pragma unroll
      for (int r = 0; r < KP; ++r) up[r] += s > ls[r] ? 1 : 0;
      rank += s > cs || (s == cs && j < lane) ? 1 : 0;
    }
    int below = 0;  // the list's pairs at or above this lane's candidate (fewer than k)
    if (ci >= 0) {
#pragma unroll
      for (int w = 16 * KP; w > 0; w >>= 1)
        if (below + w <= k && lsm[below + w - 1] >= cs) below += w;
    }
    __syncwarp();  // every lane has read the list
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int e = r * 32 + lane;
      if (e < k && e + up[r] < k) {
        lsm[e + up[r]] = ls[r];
        gid.set(e + up[r], li[r]);
      }
    }
    if (ci >= 0 && rank + below < k) {
      lsm[rank + below] = cs;
      gid.set(rank + below, ci);
    }
    __syncwarp();  // orders the warp's shared and device memory writes before its next reads
    thr = lsm[k - 1];
  }
}

// Warpgroup 0 (warps 0-3) runs the product, S = Q_tile V_tileᵀ with the 64
// queries as M and 128 corpus rows as N (`wgmma` m64n128k16: the queries'
// A operand is read once per 128 rows), and its thread 0 issues every TMA
// load. The folding warps (`fold_warps_of(KP)`) fold tile t while warpgroup
// 0 multiplies tile t + 1; the one score tile passes between them on named
// barriers. Ring box g (g = tile * chunks + chunk) sits in slot g % stages
// and completes phase g / stages of that slot's barrier; a slot is reloaded
// once the wgmma that read it has retired. The ring takes the rest of shared
// memory.
template <int KP, bool NARROW>
__global__ void __launch_bounds__(wgmma_threads(KP), 1)
topk_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_v,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int chunks, int stages, int k, int n_real, long long rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtile = base;                                     // [chunks][64 queries][64] bf16
  unsigned char* ring = qtile + chunks * QBOX_BYTES;               // [stages][128 rows][64] bf16
  float* S = reinterpret_cast<float*>(ring + stages * BOX_BYTES);  // [QT][SP]
  float* Ls = S + QT * SP;                                         // [QT][32 KP] the lists' scores
  unsigned short* Lid = reinterpret_cast<unsigned short*>(Ls + QT * 32 * KP);  // [QT][32 KP] (NARROW) their ids
  uint64_t* full = reinterpret_cast<uint64_t*>(Lid + (NARROW ? QT * 32 * KP : 0));  // [stages], the query tile's
  uint64_t* qbar = full + stages;
  constexpr int NT = wgmma_threads(KP), FOLD_WARPS = fold_warps_of(KP);
  unsigned char* offs = reinterpret_cast<unsigned char*>(qbar + 1);  // [FOLD_WARPS][WRT]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QT;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end = min((long long)n_real, row_begin + rows_per_split);
  const int tiles = row_end > row_begin ? (int)((row_end - row_begin + WRT - 1) / WRT) : 0;
  const int total = tiles * chunks;  // ring boxes this block loads

  for (int e = tid; e < QT * 32 * KP; e += NT) {
    Ls[e] = -INFINITY;
    if (NARROW) Lid[e] = 0xFFFFu;
  }
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    int issued = 0;  // thread 0's count of ring boxes issued
    auto issue = [&](int g) {
      uint64_t* bar = full + g % stages;
      mbar_expect_tx(bar, BOX_BYTES);
      tma_load(ring + (g % stages) * BOX_BYTES, &map_v, (g % chunks) * KC, (int)(row_begin + (g / chunks) * WRT), bar);
    };
    if (tid == 0 && tiles > 0) {
      mbar_expect_tx(qbar, chunks * QBOX_BYTES);
      for (int c = 0; c < chunks; ++c) tma_load(qtile + c * QBOX_BYTES, &map_q, c * KC, q0, qbar);
      for (; issued < total && issued < stages; ++issued) issue(issued);
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // with one slot, the box in use must retire before the next can load
    const int in_flight = stages > 1 ? 1 : 0;
    for (int t = 0; t < tiles; ++t) {
      const long long r0 = row_begin + (long long)t * WRT;
      if (t == 0) mbar_wait(qbar, 0);  // the query tile
      for (int c = 0; c < chunks; ++c) {
        const int g = t * chunks + c;
        const unsigned char* box = ring + (g % stages) * BOX_BYTES;
        mbar_wait(full + g % stages, (uint32_t)((g / stages) & 1));
        __syncwarp();  // the wgmma instructions are warp-aligned
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KC / 16; ++s)  // 16 bf16 = 32 bytes of K per instruction
          wgmma_m64n128k16(acc, sw128_desc(qtile + c * QBOX_BYTES + 32 * s), sw128_desc(box + 32 * s), (c | s) != 0);
        wgmma_commit();
        if (in_flight) wgmma_wait<1>(); else wgmma_wait<0>();
        if (tid == 0)  // boxes below g + 1 - in_flight have retired: refill their slots
          for (; issued < total && issued < g + 1 - in_flight + stages; ++issued) issue(issued);
        __syncwarp();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0)
        for (; issued < total && issued < (t + 1) * chunks + stages; ++issued) issue(issued);
      if (t > 0) bar_sync<NT>(BAR_EMPTY);  // the folding warps have folded tile t - 1
      // accumulator fragment i of thread (warp, lane): query 16 warp + lane / 4
      // + 8 ((i / 2) % 2), corpus row 8 (i / 4) + 2 (lane % 4) + i % 2
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int qq = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int row = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(S + qq * SP + row) =
            make_float2(r0 + row < row_end ? acc[i] : -INFINITY, r0 + row + 1 < row_end ? acc[i + 1] : -INFINITY);
      }
      bar_arrive<NT>(BAR_FULL);
    }
    return;  // the folding warps write the lists; no block-wide barrier follows
  }

  // folding warp f serves queries f, f + FOLD_WARPS, ...; wide ids live in
  // the block's output rows from the start, narrow ones go there at the end
  const int f = warp - 4;
  const int queries = min(QT, B - q0);
  int* ids = out_i + (size_t)blockIdx.y * B * k + (size_t)q0 * k;
  if (!NARROW) {
    for (int qq = f; qq < queries; qq += FOLD_WARPS)
      for (int e = lane; e < k; e += 32) ids[qq * k + e] = -1;
    __syncwarp();
  }
  for (int t = 0; t < tiles; ++t) {
    bar_sync<NT>(BAR_FULL);
    for (int qq = f; qq < queries; qq += FOLD_WARPS)
      if constexpr (NARROW)
        fold_row<KP>(S + qq * SP, offs + f * WRT, Ls + qq * 32 * KP, NarrowIds{Lid + qq * 32 * KP, row_begin}, k,
                     row_begin + (long long)t * WRT, lane);
      else
        fold_row<KP>(S + qq * SP, offs + f * WRT, Ls + qq * 32 * KP, WideIds{ids + qq * k}, k,
                     row_begin + (long long)t * WRT, lane);
    if (t + 1 < tiles) bar_arrive<NT>(BAR_EMPTY);
  }
  float* scores = out_s + (size_t)blockIdx.y * B * k + (size_t)q0 * k;
  for (int qq = f; qq < queries; qq += FOLD_WARPS)
    for (int e = lane; e < k; e += 32) {
      scores[qq * k + e] = Ls[qq * 32 * KP + e];
      if (NARROW) ids[qq * k + e] = NarrowIds{Lid + qq * 32 * KP, row_begin}.get(e);
    }
}

// ---- the merge of the splits' lists ---------------------------------------
//
// `merge_splits_kernel` replaces no TPU kernel: the TPU grid carries one list
// across the corpus tiles in order on one core, and the card's blocks run
// the splits in parallel, so their lists need a merge. Its contract: partial
// lists [splits, B, k], each sorted by (score descending, id ascending),
// split z's ids all above split z - 1's, empty slots (-inf, -1); out [B, k]
// by (score descending, id ascending), id -1 where the score is -inf: what
// one list carried over all the rows in order holds.
//
// What bounds it: the lists are sorted, so a merge must read only each
// split's scores down to its first loser and the winners' ids (32-byte
// sectors), and write [B, k] (`wide_k_bench.merge_bound_bytes`: about 0.5 MB,
// 0.00015 ms at B = 64, k = 128, 132 splits, on an H100's 3.35 TB/s; 8 KB at
// B = 1): far under the time of a launch, so the bound is latency, the
// loads' round trips and the block's barriers, and at small B the card's
// width. This design reads every score (it stages them all at once, which
// costs one round trip) and only the winners' ids. The first port (one warp a query walking the
// splits in order, inserting each candidate by a chain of shuffles and
// shared-memory shifts) took 0.21 ms at B = 1 and 64, k = 128, on one warp of
// one SM at B = 1 (PERF.md §6). The design:
//   * one block a query. Its cells (split z, position j: cell z k + j; cell
//     order is id order among equal scores) reach shared memory by
//     `cp.async`, 16 bytes a copy where a split's row allows it, all in
//     flight at once (TMA bulk copies of a split's row each, issued by one
//     warp, took longer); past shared memory they are read in place
//     (`STAGED` false);
//   * the lists are sorted, so a bound comes cheap: with c = ceil(k /
//     splits), the first c cells of every split are at least k cells, and
//     their k-th largest (counted, or by `radix::threshold` past
//     RANK_SORT_MAX of them) is at most the k-th largest of all. Each split's
//     cells at or above it are a prefix, its length found by a binary
//     search; with scores in random order their total is a few times k,
//     against splits x k. Those cells go, in cell order, to a list in shared
//     memory (more than MERGE_DENSE_MAX: all cells stay in play, still at or
//     above the bound). The bound costs its own steps, so it runs only above
//     MERGE_BOUND_CELLS cells a query;
//   * then the selection of `sm90.cuh` (namespace `radix`), as
//     `select_kernel` runs it: radix passes for the k-th largest among the
//     cells in play, the candidates gathered in cell order (the first `need`
//     of those equal to the threshold: the lowest ids), each candidate
//     placed by counting the candidates above it; where the cells, or the
//     cells in play, are already few enough to count, no pass at all; then
//     the k winners' ids read from their splits;
//   * two paces (PERF.md §6 has the variants' times). With few queries an SM
//     a block's latency counts: 512 threads, and passes that stop at
//     RANK_SORT_MAX candidates. With many (B = 2048) its instructions do:
//     128 threads, and passes down to the k candidates themselves (counting
//     is quadratic).
constexpr int MERGE_THREADS = 1024;      // at most a block (read in place: all of them)
constexpr int MERGE_DENSE_MAX = 2048;    // cells at or above the bound listed in shared memory
constexpr int MERGE_BOUND_CELLS = 256;   // the bound runs above this many cells a query
constexpr int MERGE_MANY_PER_SM = 2;     // queries an SM from which a block's instructions set the pace
constexpr int MERGE_COUNT_MAX = 64;      // cells a query placed by counting alone, below the bound
// the kernel's static shared memory, at most (its scratch, the candidates'
// keys, slack for the compiler's own)
constexpr size_t MERGE_STATIC_SMEM = sizeof(radix::Scratch) + 8 * radix::RANK_SORT_MAX + 1024;

// A query's cells: cell z k + j is position j of split z; its score in
// shared memory (STAGED: [splits][k]) or in the partials in place (`p` = the
// query's row of split 0, `plane` = B k floats between splits).
template <bool STAGED>
struct MergeCells {
  const float* p;
  size_t plane;
  int k;
  __device__ __forceinline__ float score(int c) const {
    if constexpr (STAGED) return p[c];
    else return p[(size_t)(c / k) * plane + c % k];
  }
  __device__ __forceinline__ uint32_t bits(int c) const { return radix::order_bits(score(c)); }
};

template <bool STAGED>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_splits_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i, float* __restrict__ out_s,
                    int* __restrict__ out_i, int B, int k, int splits, int cap, int rank_max) {
  extern __shared__ __align__(16) unsigned char smem_merge[];
  __shared__ radix::Scratch rs;
  __shared__ unsigned long long keys[radix::RANK_SORT_MAX];
  __shared__ uint32_t ends[2];  // the bound's largest cell and its k-th
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x, lane = tid % 32, warp = tid / 32,
            warps = T / 32;
  const int n = splits * k;
  const bool bound = n > MERGE_BOUND_CELLS;
  const size_t plane = (size_t)B * k;
  const float* ps = part_s + (size_t)b * k;
  float* sc = reinterpret_cast<float*>(smem_merge);  // STAGED: [splits][k] scores
  uint32_t* dense = reinterpret_cast<uint32_t*>(smem_merge + (STAGED ? ((size_t)n * 4 + 15) / 16 * 16 : 0));  // [cap]
  const MergeCells<STAGED> cells{STAGED ? sc : ps, plane, k};

  for (int d = tid; d < radix::RADIX; d += T) rs.hist[0][d] = 0u;

  // 1. stage: all of the query's scores in flight at once, 16 bytes a copy
  // where a split's row is a multiple of 16 bytes on a 16-byte address
  if constexpr (STAGED) {
    if (k % 4 == 0 && reinterpret_cast<uintptr_t>(part_s) % 16 == 0) {
      const int q4 = k / 4;  // 16-byte words a split
      for (int w = tid; w < n / 4; w += T) radix::cp_async16(sc + 4 * w, ps + (size_t)(w / q4) * plane + 4 * (w % q4));
    } else {
      for (int i = tid; i < n; i += T) radix::cp_async4(sc + i, ps + (size_t)(i / k) * plane + i % k);
    }
    radix::cp_async_wait_all();
  }
  __syncthreads();

  // a winner's score, and its id read from its split
  auto emit = [&](int place, int c) {
    const float s = cells.score(c);
    out_s[(size_t)b * k + place] = s;
    out_i[(size_t)b * k + place] = s == -INFINITY ? -1 : part_i[(size_t)(c / k) * plane + (size_t)b * k + c % k];
  };

  if (!bound && n <= MERGE_COUNT_MAX) {  // a handful: each cell placed by counting
    for (int i = tid; i < n; i += T) keys[i] = (static_cast<unsigned long long>(cells.bits(i)) << 32) | (0xFFFFFFFFu - i);
    __syncthreads();
    radix::rank(keys, n, k, [&](int place, unsigned long long key) { emit(place, radix::cell_of(key)); });
    return;
  }

  // 2. the cells in play: all, or (the bound) each split's prefix at or above
  // the k-th largest of the first c cells of every split
  uint32_t hi = 0u, lo = 0xFFFFFFFFu;  // the largest cell; the least bits in play
  int live = n;                        // cells at or above lo
  bool listed = false;                 // the cells in play are dense[0, live)
  if (bound) {
    const int c = (k + splits - 1) / splits, m0 = splits * c;
    auto head = [&](int i) { return cells.bits((i / c) * k + i % c); };
    if (m0 == k) {  // the k-th largest is the least
      for (int i = tid; i < m0; i += T) {
        const uint32_t x = head(i);
        hi = max(hi, x);
        lo = min(lo, x);
      }
      radix::block_max_min(hi, lo, rs);
    } else if (m0 <= rank_max) {  // a handful: each placed by counting, the first and the k-th kept
      for (int i = tid; i < m0; i += T) keys[i] = (static_cast<unsigned long long>(head(i)) << 32) | (0xFFFFFFFFu - i);
      __syncthreads();
      radix::rank(keys, m0, k, [&](int place, unsigned long long key) {
        if (place == 0) ends[0] = static_cast<uint32_t>(key >> 32);
        if (place == k - 1) ends[1] = static_cast<uint32_t>(key >> 32);
      });
      __syncthreads();
      hi = ends[0];
      lo = ends[1];
    } else {
      for (int i = tid; i < m0; i += T) {
        const uint32_t x = head(i);
        hi = max(hi, x);
        lo = min(lo, x);
      }
      radix::block_max_min(hi, lo, rs);
      lo = radix::threshold(head, m0, k, hi, lo, m0, 0, rs).prefix;  // its low bits are zero: a lower bound
      for (int d = tid; d < radix::RADIX; d += T) rs.hist[0][d] = 0u;  // for the next passes
    }
    // each thread's run of splits: the prefixes' lengths, then their offsets
    const int per = (splits + T - 1) / T, z0 = min(splits, tid * per), z1 = min(splits, z0 + per);
    auto prefix_len = [&](int z) {  // cells of split z at or above lo: the list is sorted
      int len = 0;
#pragma unroll
      for (int w = KMAX; w > 0; w >>= 1)
        if (len + w <= k && cells.bits(z * k + len + w - 1) >= lo) len += w;
      return len;
    };
    int mine = 0;
    for (int z = z0; z < z1; ++z) mine += prefix_len(z);
    const int incl = radix::warp_scan(mine, lane);
    if (lane == 31) rs.warp_up[warp] = incl;
    __syncthreads();
    const int wt = lane < warps ? rs.warp_up[lane] : 0, w_incl = radix::warp_scan(wt, lane);
    live = __shfl_sync(FULL, w_incl, 31);
    int at = __shfl_sync(FULL, w_incl - wt, warp) + incl - mine;
    listed = live <= cap;
    if (listed) {  // the cells in play, in cell order
      const int first = at;
      for (int z = z0; z < z1; ++z)
        for (int j = 0, len = prefix_len(z); j < len; ++j, ++at) dense[at] = static_cast<uint32_t>(z * k + j);
      if (live <= rank_max)  // a handful: all are candidates, keyed by their place in the list
        for (int i = first; i < at; ++i)
          keys[i] = (static_cast<unsigned long long>(cells.bits(dense[i])) << 32) | (0xFFFFFFFFu - i);
    }
    __syncthreads();  // the list is whole, and every warp has read rs.warp_up (`gather` writes it next)
  } else {
    for (int i = tid; i < n; i += T) {
      const uint32_t x = cells.bits(i);
      hi = max(hi, x);
      lo = min(lo, x);
    }
    radix::block_max_min(hi, lo, rs);
  }

  // 3. the k-th largest in play, the candidates in cell order, each placed by
  // the candidates above it
  if (listed) {
    int m = live;
    if (live > rank_max) {
      auto bits = [&](int i) { return cells.bits(dense[i]); };
      m = radix::gather(bits, live, radix::threshold(bits, live, k, hi, lo, live, rank_max, rs), rank_max, keys, rs);
    }
    radix::rank(keys, m, k, [&](int place, unsigned long long key) { emit(place, dense[radix::cell_of(key)]); });
  } else {
    auto bits = [&](int i) { return cells.bits(i); };
    const int m = radix::gather(bits, n, radix::threshold(bits, n, k, hi, lo, live, rank_max, rs), rank_max, keys,
                                rs);
    radix::rank(keys, m, k, [&](int place, unsigned long long key) { emit(place, radix::cell_of(key)); });
  }
}

int list_stride(int k) { return (k + 31) / 32 * 32; }
int wgmma_chunks(int D) { return (D + KC - 1) / KC; }

template <typename T, int FOLDERS, bool ALIGNED> struct ListsTag {};
template <int KP, bool NARROW> struct WgmmaTag {};

// Dynamic shared memory of the CUDA-core body: the product core's ring
// (24.75 KB), the score tile (17 KB) and the lists (16-64 KB). Every k
// exceeds the 48 KB a block gets by default, so opt in (once per card,
// sm90.cuh).
template <typename T, int FOLDERS, bool ALIGNED>
cudaError_t allow_fma(int k, size_t* dyn) {
  *dyn = (size_t)(simt::STAGE_FLOATS + QT * FSP) * sizeof(float) + (size_t)QT * list_stride(k) * (sizeof(float) + sizeof(int));
  return allow_max_smem<ListsTag<T, FOLDERS, ALIGNED>>(topk_float_kernel<T, FOLDERS, ALIGNED>);
}

// How many blocks of the CUDA-core body an SM holds at this k (the same for
// rows on and off the grid).
template <typename T>
cudaError_t fma_blocks_per_sm(int k, int* blocks) {
  size_t dyn = 0;
  cudaError_t err;
  if (fold_warps(k) == 0) {
    if ((err = allow_fma<T, 0, false>(k, &dyn)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, topk_float_kernel<T, 0, false>, fma_threads<0>(), dyn);
  } else if ((err = allow_fma<T, 4, false>(k, &dyn)) == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, topk_float_kernel<T, 4, false>, fma_threads<4>(), dyn);
  }
  return err;
}

// The tensor-core body's variant at this k: its lists' scores take 32 KP
// floats a query in shared memory (KP = 1, 2 or 4).
int list_regs(int k) { return k <= 32 ? 1 : k <= 64 ? 2 : 4; }

using WgmmaKernel = decltype(&topk_wgmma_kernel<1, true>);

template <int KP, bool NARROW>
cudaError_t allow_variant(WgmmaKernel* kernel) {
  *kernel = topk_wgmma_kernel<KP, NARROW>;
  return allow_max_smem<WgmmaTag<KP, NARROW>>(topk_wgmma_kernel<KP, NARROW>);
}

// The tensor-core body's variant at this k and split length, and its ring
// depth and dynamic shared memory: the query tile, the score tile, the
// lists' scores (and narrow ids), the candidates' offsets, and as many 16 KB
// ring boxes as the rest of the card's per-block limit holds, up to
// MAX_STAGES (at D = 768 on an H100: 5 boxes at k <= 32, 4 at k <= 64, 3
// above). One block per SM. The limit is read, and the variant's opt-in
// set, once per card (sm90.cuh).
cudaError_t allow_wgmma(int D, int k, long long rows_per_split, WgmmaKernel* kernel, int* stages, size_t* dyn) {
  // the refusal twin of `ops/mips.py:_topk_body`'s D rule
  if (D < 8 || D % 8 != 0 || wgmma_chunks(D) > MAX_CHUNKS) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = optin_smem(&limit);
  if (err != cudaSuccess) return err;
  auto depth = [&](bool narrow) {
    const size_t fixed = wgmma_smem(wgmma_chunks(D), list_regs(k), narrow, 0);
    const int boxes = limit > (long long)fixed ? (int)((limit - fixed) / (BOX_BYTES + sizeof(uint64_t))) : 0;
    return min(boxes, MAX_STAGES);
  };
  // narrow ids where a split's row offsets fit in 16 bits and they cost the
  // ring no box (at D = 768: k <= 64; at k = 128 the box is worth more)
  const bool narrow = rows_per_split <= 65535 && depth(true) == depth(false);
  *stages = depth(narrow);
  if (*stages < 1) return cudaErrorInvalidValue;
  *dyn = wgmma_smem(wgmma_chunks(D), list_regs(k), narrow, *stages);
  switch (list_regs(k)) {
    case 1: return narrow ? allow_variant<1, true>(kernel) : allow_variant<1, false>(kernel);
    case 2: return narrow ? allow_variant<2, true>(kernel) : allow_variant<2, false>(kernel);
    default: return narrow ? allow_variant<4, true>(kernel) : allow_variant<4, false>(kernel);
  }
}

// Rows of each split: whole tiles of `tile` rows, the last split ragged (or empty).
long long split_rows(int n_real, int splits, int tile) {
  const long long tiles = ((long long)n_real + tile - 1) / tile;
  return (tiles + splits - 1) / splits * tile;
}

template <typename T, int FOLDERS, bool ALIGNED>
cudaError_t launch_fma_with(const void* q, const void* v, void* part_s, void* part_i,
                            int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  size_t dyn;
  cudaError_t err = allow_fma<T, FOLDERS, ALIGNED>(k, &dyn);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + QT - 1) / QT, splits);  // query tile fastest: the blocks of a split run together
  topk_float_kernel<T, FOLDERS, ALIGNED><<<grid, fma_threads<FOLDERS>(), dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<float*>(part_s), static_cast<int*>(part_i), B, D, k, list_stride(k), n_real,
      split_rows(n_real, splits, RT));
  return cudaGetLastError();
}

// The body's variant: folding warps or not (by k), rows on the 16-byte grid
// or not (both pointers and the row pitch).
template <typename T>
cudaError_t launch_fma(const void* q, const void* v, void* part_s, void* part_i,
                       int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  const bool aligned = simt::on_grid(q, v, D * sizeof(T));
  if (fold_warps(k) == 0)
    return aligned ? launch_fma_with<T, 0, true>(q, v, part_s, part_i, B, D, k, n_real, splits, stream)
                   : launch_fma_with<T, 0, false>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  return aligned ? launch_fma_with<T, 4, true>(q, v, part_s, part_i, B, D, k, n_real, splits, stream)
                 : launch_fma_with<T, 4, false>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
}

cudaError_t launch_wgmma(const void* q, const void* v, void* part_s, void* part_i,
                         int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  size_t dyn;
  int stages;
  WgmmaKernel kernel;
  const long long rows_per_split = split_rows(n_real, splits, WRT);
  cudaError_t err = allow_wgmma(D, k, rows_per_split, &kernel, &stages, &dyn);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_v;
  // boxes of KC = 64 bf16 (128 bytes)
  if ((err = sw128_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, B, D, QT)) != cudaSuccess) return err;
  if ((err = sw128_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, n_real, D, WRT)) != cudaSuccess)
    return err;  // rows past n_real are never read
  const dim3 grid((B + QT - 1) / QT, splits);  // query tile fastest: the blocks of a split share rows in L2
  kernel<<<grid, wgmma_threads(list_regs(k)), dyn, stream>>>(
      map_q, map_v, static_cast<float*>(part_s), static_cast<int*>(part_i), B, wgmma_chunks(D), stages, k,
      n_real, rows_per_split);
  return cudaGetLastError();
}

template <bool STAGED> struct MergeTag {};

// The merge on `stream`: partials [splits, B, k] in, [B, k] out. The cells
// sit in shared memory where they fit beside the list of cells in play (at
// most 54,000 or so a query on an H100), else they are read in place.
cudaError_t launch_merge(const void* part_s, const void* part_i, void* out_s, void* out_i, int B, int k, int splits,
                         cudaStream_t stream) {
  if (B < 1 || k < 1 || k > KMAX || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  const int n = splits * k, cap = min(n, MERGE_DENSE_MAX);
  int limit = 0, sms = 0;
  cudaError_t err = optin_smem(&limit);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const size_t staged = ((size_t)n * 4 + 15) / 16 * 16 + (size_t)cap * 4;
  // few queries an SM: a block's latency sets the pace (more threads a
  // block, radix passes that stop at RANK_SORT_MAX candidates); many: its
  // instructions do (fewer threads, passes down to k candidates)
  const bool few = B < MERGE_MANY_PER_SM * sms;
  auto kernel = merge_splits_kernel<false>;
  size_t dyn = (size_t)cap * 4;
  int threads = MERGE_THREADS;
  if (staged + MERGE_STATIC_SMEM <= (size_t)limit) {
    if ((err = allow_max_smem<MergeTag<true>>(merge_splits_kernel<true>)) != cudaSuccess) return err;
    kernel = merge_splits_kernel<true>;
    dyn = staged;
    threads = few ? 512 : 128;
  }
  kernel<<<B, threads, dyn, stream>>>(static_cast<const float*>(part_s), static_cast<const int*>(part_i),
                                      static_cast<float*>(out_s), static_cast<int*>(out_i), B, k, splits, cap,
                                      few ? radix::RANK_SORT_MAX : k);
  return cudaGetLastError();
}

int merge(cudaError_t err, void* part_s, void* part_i, void* out_s, void* out_i, int B, int k, int splits,
          cudaStream_t stream) {
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_merge(part_s, part_i, out_s, out_i, B, k, splits, stream));
}

}  // namespace

// How many blocks of a body (0 = CUDA cores, 1 = tensor cores) an SM of the
// current card holds at this dtype, D and k (registers and shared memory
// decide it for the CUDA-core body, which takes no folding warps or 4 by k;
// shared memory for the tensor-core body, 1),
// or minus a CUDA error code. The wrapper sizes the splits so that every block
// is resident at once: a second wave of a few blocks costs as much as the first.
extern "C" int vod_fused_mips_topk_blocks_per_sm(int body, int dtype, int D, int k) {
  if (k < 1 || k > KMAX) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, stages = 0;
  size_t dyn = 0;
  WgmmaKernel kernel;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && dtype == 0) err = fma_blocks_per_sm<float>(k, &blocks);
  if (body == 0 && dtype == 1) err = fma_blocks_per_sm<__nv_bfloat16>(k, &blocks);
  if (body == 1 && dtype == 1 && (err = allow_wgmma(D, k, WRT, &kernel, &stages, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, wgmma_threads(list_regs(k)), dyn);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The tensor-core body's ring depth (TMA boxes in flight) on the current card
// for a call at this D and k over n_real rows in `splits` splits, or minus a
// CUDA error code. A benchmark reads it.
extern "C" int vod_fused_mips_topk_ring_stages(int D, int k, int n_real, int splits) {
  if (k < 1 || k > KMAX || splits < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int stages = 0;
  size_t dyn = 0;
  WgmmaKernel kernel;
  const cudaError_t err = allow_wgmma(D, k, split_rows(n_real, splits, WRT), &kernel, &stages, &dyn);
  return err == cudaSuccess ? stages : -static_cast<int>(err);
}

// The CUDA-core body. dtype: 0 = float32, 1 = bfloat16 (queries already cast
// to the corpus type). With splits == 1 the caller passes part == out and no
// merge runs; otherwise part is [splits, B, k]. The caller makes the card that
// holds the tensors current; `stream_ptr` is PyTorch's current stream there.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int vod_fused_mips_topk_fma(int dtype, const void* q, const void* v,
                                       void* part_s, void* part_i, void* out_s, void* out_i,
                                       int B, int D, int k, int n_real, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > KMAX || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bind_thread();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) {
    err = launch_fma<float>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  } else if (dtype == 1) {
    err = launch_fma<__nv_bfloat16>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return merge(err, part_s, part_i, out_s, out_i, B, k, splits, stream);
}

// The tensor-core body, the same arguments: bf16 only (dtype 1), D % 8 == 0,
// D <= 896, q and v 16-byte aligned; anything else is refused with
// cudaErrorInvalidValue, never run on another body.
extern "C" int vod_fused_mips_topk_wgmma(int dtype, const void* q, const void* v,
                                         void* part_s, void* part_i, void* out_s, void* out_i,
                                         int B, int D, int k, int n_real, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype != 1 || k < 1 || k > KMAX || splits < 1 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bind_thread();
  if (err == cudaSuccess) err = launch_wgmma(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  return merge(err, part_s, part_i, out_s, out_i, B, k, splits, stream);
}

// The merge alone, on partial lists [splits, B, k] that the caller made (the
// wrapper `merge_splits`): scores f32, ids int32, contiguous; out [B, k].
// Returns the CUDA error code of the launch (0 = success).
extern "C" int vod_fused_mips_topk_merge(const void* part_s, const void* part_i, void* out_s, void* out_i, int B,
                                         int k, int splits, void* stream_ptr) {
  const cudaError_t err = bind_thread();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_merge(part_s, part_i, out_s, out_i, B, k, splits, static_cast<cudaStream_t>(stream_ptr)));
}
