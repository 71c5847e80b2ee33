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
//     allows (5 boxes at D = 768, k <= 32; 2 at k = 128). Warpgroup 0
//     multiplies tile t + 1 while warpgroup 1 selects from tile t. The tensor
//     maps' zero fill covers the ragged ends of B, N and D.
//     What the design answers: the operation bound at B = 2048 (tensor cores;
//     an m64n64k16 reads 4 KB of shared memory per 32 tensor-core cycles, all
//     the SM's shared-memory bandwidth, an m64n128k16 6 KB per 64, so the
//     rows are N and 128 wide), and the byte bound at B <= 64 (the loads run
//     ahead across the product and the selection, so the corpus streams
//     without stopping).
//   * "fma" (`topk_float_kernel`), f32 and every other bf16 call: f32 FMAs on
//     CUDA cores (no TF32: the f32 contract is full f32) with k-slices of both
//     tiles staged through shared memory, a 4 x 4 micro-tile per thread.
//
// Design of the selection, shared by both bodies:
//   * A block owns 64 queries and one contiguous range of rows (a "split"),
//     which it walks in tiles of 64 rows (CUDA cores) or 128 rows (tensor
//     cores) in increasing row order. Each tile's
//     scores are written to a score tile S[query][row] in shared memory.
//   * Each query keeps a list of k (score, id) pairs in dynamic shared memory,
//     sorted by (score descending, id ascending); one warp serves a query at a
//     time. A score enters only if it is strictly greater than the list's k-th
//     score: a warp ballot over the tile picks the candidates, which are
//     inserted one by one in increasing row order. A later row that ties never
//     displaces an earlier one, and one that enters goes after every equal
//     score, so ties keep the lowest id. After the first rows inserts are rare
//     (about k ln(N / k) per query for rows in random order); adversarial data
//     (rows sorted by score) is slow but still right.
//   * The TPU grid carries the buffer across corpus tiles in order on one core;
//     GPU blocks run in parallel. So the rows are split across the grid's second
//     dimension (at serving batch one query tile would leave most SMs idle),
//     into as many splits as fill every SM with resident blocks in one wave,
//     each split writes a partial list [splits, B, k], and a merge kernel folds
//     the splits in increasing order with the same insertion rule. Split z
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
constexpr int KT = 32;        // reduction slice staged in shared memory (elements)
constexpr int THREADS = 256;  // CUDA cores: 16 x 16 threads, 4 x 4 scores each; tensor cores: two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 128;     // the TPU kernel's _K_PAD: the widest list
constexpr int MERGE_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
// tensor-core body
constexpr int MAX_STAGES = 16;             // cap on the TMA boxes in flight per block
constexpr int KC = 64;                     // bf16 per TMA box row: 128 bytes, one swizzle span
constexpr int WRT = 128;                   // corpus rows per tile: the wgmma's N
constexpr int QBOX_BYTES = QT * KC * 2;    // 8 KB: a box of 64 queries x 64 bf16
constexpr int BOX_BYTES = WRT * KC * 2;    // 16 KB: a ring box of 128 rows x 64 bf16
constexpr int SP = WRT + 4;                // score tile row stride: 2-way conflicts on the float2 stores
constexpr int MAX_CHUNKS = 14;             // D <= 896: the query tile fits beside the k = 128 lists

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Write the block's lists for its queries to split blockIdx.y of [splits, B, k].
__device__ __forceinline__ void store_lists(const float* Ls, const int* Li, float* out_s, int* out_i,
                                            int B, int k, int kp, int q0) {
  const size_t base = (size_t)blockIdx.y * B * k;
  for (int e = threadIdx.x; e < QT * k; e += THREADS) {
    const int qq = e / k, slot = e % k;
    if (q0 + qq >= B) break;
    out_s[base + (size_t)(q0 + qq) * k + slot] = Ls[qq * kp + slot];
    out_i[base + (size_t)(q0 + qq) * k + slot] = Li[qq * kp + slot];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_float_kernel(const T* __restrict__ q, const T* __restrict__ v,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int D, int k, int kp, int n_real, long long rows_per_split) {
  __shared__ float As[KT][QT + 1];
  __shared__ float Bs[KT][RT + 1];
  __shared__ float S[QT][RT + 1];
  extern __shared__ float lists[];  // [QT][kp] scores, then [QT][kp] ids
  float* Ls = lists;
  int* Li = reinterpret_cast<int*>(lists + QT * kp);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * QT;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end = min((long long)n_real, row_begin + rows_per_split);

  for (int e = threadIdx.x; e < QT * kp; e += THREADS) { Ls[e] = -INFINITY; Li[e] = -1; }
  __syncthreads();

  for (long long r0 = row_begin; r0 < row_end; r0 += RT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      // stage q[q0 : q0+64, k0 : k0+32] and v[r0 : r0+64, k0 : k0+32], k-major
      for (int e = threadIdx.x; e < QT * KT; e += THREADS) {
        const int row = e / KT, kk = e % KT;
        const int qb = q0 + row, kg = k0 + kk;
        As[kk][row] = (qb < B && kg < D) ? to_f32(q[(size_t)qb * D + kg]) : 0.f;
        const long long j = r0 + row;
        Bs[kk][row] = (j < row_end && kg < D) ? to_f32(v[(size_t)j * D + kg]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool real = r0 + tx + 16 * j < row_end;
#pragma unroll
      for (int i = 0; i < 4; ++i) S[ty + 16 * i][tx + 16 * j] = real ? acc[i][j] : -INFINITY;
    }
    __syncthreads();
    fold_tile<RT>(&S[0][0], RT + 1, Ls, Li, k, kp, min(QT, B - q0), r0, warp, WARPS, lane);
    __syncthreads();
  }
  store_lists(Ls, Li, out_s, out_i, B, k, kp, q0);
}

// ---- tensor-core body (TMA, mbarriers and wgmma from sm90.cuh) --------------

// Dynamic shared memory of the tensor-core body: 1 KB to align the boxes,
// the query tile, the ring, the score tile, the lists, the mbarriers.
size_t wgmma_smem(int chunks, int kp, int stages) {
  return 1024 + (size_t)chunks * QBOX_BYTES + (size_t)stages * BOX_BYTES + (size_t)QT * SP * sizeof(float) +
         (size_t)QT * kp * (sizeof(float) + sizeof(int)) + (stages + 1) * sizeof(uint64_t);
}

// Named barriers between the two warpgroups (0 is __syncthreads'): the score
// tile is full (warpgroup 0 stored a tile), the score tile is empty
// (warpgroup 1 has folded it).
constexpr int BAR_FULL = 1, BAR_EMPTY = 2;
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory"); }

// Warpgroup 0 (warps 0-3) runs the product, S = Q_tile V_tileᵀ with the 64
// queries as M and 128 corpus rows as N (`wgmma` m64n128k16: the queries'
// A operand is read once per 128 rows), and its thread 0 issues every TMA
// load. Warpgroup 1 (warps 4-7) folds tile t into the lists while warpgroup 0
// multiplies tile t + 1; the one score tile passes between them on named
// barriers. Ring box g (g = tile * chunks + chunk) sits in slot g % stages and
// completes phase g / stages of that slot's barrier; a slot is reloaded once
// the wgmma that read it has retired. The ring takes the rest of shared
// memory.
__global__ void __launch_bounds__(THREADS, 1)
topk_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_v,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int chunks, int stages, int k, int kp, int n_real, long long rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtile = base;                                     // [chunks][64 queries][64] bf16
  unsigned char* ring = qtile + chunks * QBOX_BYTES;               // [stages][128 rows][64] bf16
  float* S = reinterpret_cast<float*>(ring + stages * BOX_BYTES);  // [QT][SP]
  float* Ls = S + QT * SP;
  int* Li = reinterpret_cast<int*>(Ls + QT * kp);
  uint64_t* full = reinterpret_cast<uint64_t*>(Li + QT * kp);      // [stages], then the query tile's
  uint64_t* qbar = full + stages;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QT;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end = min((long long)n_real, row_begin + rows_per_split);
  const int tiles = row_end > row_begin ? (int)((row_end - row_begin + WRT - 1) / WRT) : 0;
  const int total = tiles * chunks;  // ring boxes this block loads

  for (int e = tid; e < QT * kp; e += THREADS) { Ls[e] = -INFINITY; Li[e] = -1; }
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
      if (t > 0) bar_sync(BAR_EMPTY);  // warpgroup 1 has folded tile t - 1
      // accumulator fragment i of thread (warp, lane): query 16 warp + lane / 4
      // + 8 ((i / 2) % 2), corpus row 8 (i / 4) + 2 (lane % 4) + i % 2
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int qq = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int row = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(S + qq * SP + row) =
            make_float2(r0 + row < row_end ? acc[i] : -INFINITY, r0 + row + 1 < row_end ? acc[i + 1] : -INFINITY);
      }
      bar_arrive(BAR_FULL);
    }
  } else {
    for (int t = 0; t < tiles; ++t) {
      bar_sync(BAR_FULL);
      fold_tile<WRT>(S, SP, Ls, Li, k, kp, min(QT, B - q0), row_begin + (long long)t * WRT, warp - 4, WARPS - 4, lane);
      if (t + 1 < tiles) bar_arrive(BAR_EMPTY);
    }
  }
  __syncthreads();
  store_lists(Ls, Li, out_s, out_i, B, k, kp, q0);
}

// Fold the splits' sorted partial lists [splits, B, k] in increasing split
// order into [B, k]: one warp per query, the same insertion rule. Split z's
// ids all exceed those of the splits before it, and inside a split equal
// scores come in increasing id order, so warp_insert's precondition holds.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_splits_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                    float* __restrict__ out_s, int* __restrict__ out_i, int B, int k, int splits) {
  __shared__ float Ls[MERGE_WARPS][KMAX];
  __shared__ int Li[MERGE_WARPS][KMAX];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x * MERGE_WARPS + warp;
  if (b >= B) return;  // the whole warp leaves; no block-wide barrier follows
  float* ls = Ls[warp];
  int* li = Li[warp];
  for (int e = lane; e < k; e += 32) { ls[e] = part_s[(size_t)b * k + e]; li[e] = part_i[(size_t)b * k + e]; }
  __syncwarp();
  float thr = ls[k - 1];
  for (int z = 1; z < splits; ++z) {
    const float* ps = part_s + ((size_t)z * B + b) * k;
    const int* pi = part_i + ((size_t)z * B + b) * k;
    for (int e0 = 0; e0 < k; e0 += 32) {
      const int e = e0 + lane;
      const float sc = e < k ? ps[e] : -INFINITY;
      const int id = e < k ? pi[e] : -1;
      unsigned cand = __ballot_sync(FULL, sc > thr);
      if (!cand) break;  // the list is sorted: nothing further down enters
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float c = __shfl_sync(FULL, sc, src);
        const int cid = __shfl_sync(FULL, id, src);
        if (c > thr) {
          warp_insert(ls, li, k, c, cid, lane);
          thr = ls[k - 1];
        }
      }
    }
  }
  for (int e = lane; e < k; e += 32) { out_s[(size_t)b * k + e] = ls[e]; out_i[(size_t)b * k + e] = li[e]; }
}

int list_stride(int k) { return (k + 31) / 32 * 32; }
int wgmma_chunks(int D) { return (D + KC - 1) / KC; }

// The lists' dynamic shared memory (16-64 KB). With the 33 KB of static tiles
// every k exceeds the 48 KB a block gets by default, so opt in.
template <typename T>
cudaError_t allow_lists(int k, size_t* dyn) {
  *dyn = (size_t)QT * list_stride(k) * (sizeof(float) + sizeof(int));
  return cudaFuncSetAttribute(topk_float_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*dyn);
}

// The tensor-core body's ring depth and dynamic shared memory: the query
// tile, score tile and lists, and as many 16 KB ring boxes as the rest of the
// card's per-block limit holds, up to MAX_STAGES (at D = 768 on an H100: 5
// boxes at k <= 32, 2 at k = 128; 226 KB either way). One block per SM.
cudaError_t allow_wgmma(int D, int k, int* stages, size_t* dyn) {
  // the refusal twin of `ops/mips.py:_topk_body`'s D rule
  if (D < 8 || D % 8 != 0 || wgmma_chunks(D) > MAX_CHUNKS) return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = wgmma_smem(wgmma_chunks(D), list_stride(k), 0);
  *stages = limit > (long long)fixed ? (int)((limit - fixed) / (BOX_BYTES + sizeof(uint64_t))) : 0;
  *stages = min(*stages, MAX_STAGES);
  if (*stages < 1) return cudaErrorInvalidValue;
  *dyn = wgmma_smem(wgmma_chunks(D), list_stride(k), *stages);
  return cudaFuncSetAttribute(topk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*dyn);
}

// Rows of each split: whole tiles of `tile` rows, the last split ragged (or empty).
long long split_rows(int n_real, int splits, int tile) {
  const long long tiles = ((long long)n_real + tile - 1) / tile;
  return (tiles + splits - 1) / splits * tile;
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* v, void* part_s, void* part_i,
                       int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  size_t dyn;
  cudaError_t err = allow_lists<T>(k, &dyn);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + QT - 1) / QT, splits);  // query tile fastest: the blocks of a split run together
  topk_float_kernel<T><<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<float*>(part_s), static_cast<int*>(part_i), B, D, k, list_stride(k), n_real,
      split_rows(n_real, splits, RT));
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* q, const void* v, void* part_s, void* part_i,
                         int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  size_t dyn;
  int stages;
  cudaError_t err = allow_wgmma(D, k, &stages, &dyn);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_v;
  // boxes of KC = 64 bf16 (128 bytes)
  if ((err = sw128_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, B, D, QT)) != cudaSuccess) return err;
  if ((err = sw128_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, n_real, D, WRT)) != cudaSuccess)
    return err;  // rows past n_real are never read
  const dim3 grid((B + QT - 1) / QT, splits);  // query tile fastest: the blocks of a split share rows in L2
  topk_wgmma_kernel<<<grid, THREADS, dyn, stream>>>(
      map_q, map_v, static_cast<float*>(part_s), static_cast<int*>(part_i), B, wgmma_chunks(D), stages, k,
      list_stride(k), n_real, split_rows(n_real, splits, WRT));
  return cudaGetLastError();
}

int merge(cudaError_t err, void* part_s, void* part_i, void* out_s, void* out_i, int B, int k, int splits,
          cudaStream_t stream) {
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_splits_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many blocks of a body (0 = CUDA cores, 1 = tensor cores) an SM of the
// current card holds at this dtype, D and k (shared memory decides it: the
// CUDA-core body holds 4 at k <= 32 and 2 at k = 128, the tensor-core body 1),
// or minus a CUDA error code. The wrapper sizes the splits so that every block
// is resident at once: a second wave of a few blocks costs as much as the first.
extern "C" int vod_fused_mips_topk_blocks_per_sm(int body, int dtype, int D, int k) {
  if (k < 1 || k > KMAX) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, stages = 0;
  size_t dyn = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && dtype == 0 && (err = allow_lists<float>(k, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topk_float_kernel<float>, THREADS, dyn);
  if (body == 0 && dtype == 1 && (err = allow_lists<__nv_bfloat16>(k, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topk_float_kernel<__nv_bfloat16>, THREADS, dyn);
  if (body == 1 && dtype == 1 && (err = allow_wgmma(D, k, &stages, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topk_wgmma_kernel, THREADS, dyn);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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
  cudaError_t err;
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
  const cudaError_t err = launch_wgmma(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  return merge(err, part_s, part_i, out_s, out_i, B, k, splits, stream);
}
