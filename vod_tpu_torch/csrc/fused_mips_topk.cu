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
// Types: bf16 x bf16 or f32 x f32, converted to f32 and accumulated in f32
// with FMAs (no TF32, the accumulator is never rounded to bf16).
//
// What bounds it on the H100: the corpus read (N * D * element size bytes over
// HBM) at serving batch (B <= 64), the 2 * B * N * D operations at B = 2048.
// This first version does nothing about either beyond the threshold filter
// below: it runs on CUDA cores, not tensor cores, and stages tiles through
// shared memory without a pipelined load ring. Tensor-core products (`wgmma`)
// and a cheaper selection are later work.
//
// Design (right and simple first):
//   * A block owns 64 queries and one contiguous range of rows (a "split"),
//     which it walks in tiles of 64 rows in increasing row order. Each tile's
//     64 x 64 scores are computed as in `fused_mips_binned.cu` (k-slices of the
//     query and row tiles staged in shared memory, a 4 x 4 micro-tile of FMAs
//     per thread) and written to a score tile in shared memory.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // queries per block
constexpr int RT = 64;        // rows per tile
constexpr int KT = 32;        // reduction slice staged in shared memory (elements)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each; 8 warps select
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 128;     // the TPU kernel's _K_PAD: the widest list
constexpr int MERGE_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

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

    // fold the tile into the running lists: warp w serves queries w, w + 8, ...
    for (int qq = warp; qq < QT && q0 + qq < B; qq += WARPS) {
      float* ls = Ls + qq * kp;
      int* li = Li + qq * kp;
      float thr = ls[k - 1];
#pragma unroll
      for (int half = 0; half < RT / 32; ++half) {
        const float sc = S[qq][half * 32 + lane];
        unsigned cand = __ballot_sync(FULL, sc > thr);
        while (cand) {  // in increasing row order
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float c = __shfl_sync(FULL, sc, src);
          if (c > thr) {
            warp_insert(ls, li, k, c, (int)(r0 + half * 32 + src), lane);
            thr = ls[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t base = (size_t)blockIdx.y * B * k;
  for (int e = threadIdx.x; e < QT * k; e += THREADS) {
    const int qq = e / k, slot = e % k;
    if (q0 + qq >= B) break;
    out_s[base + (size_t)(q0 + qq) * k + slot] = Ls[qq * kp + slot];
    out_i[base + (size_t)(q0 + qq) * k + slot] = Li[qq * kp + slot];
  }
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

// The lists' dynamic shared memory (16-64 KB). With the 33 KB of static tiles
// every k exceeds the 48 KB a block gets by default, so opt in.
template <typename T>
cudaError_t allow_lists(int k, size_t* dyn) {
  *dyn = (size_t)QT * list_stride(k) * (sizeof(float) + sizeof(int));
  return cudaFuncSetAttribute(topk_float_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*dyn);
}

template <typename T>
cudaError_t blocks_per_sm(int k, int* blocks) {
  size_t dyn;
  cudaError_t err = allow_lists<T>(k, &dyn);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, topk_float_kernel<T>, THREADS, dyn);
}

template <typename T>
cudaError_t launch_topk(const void* q, const void* v, void* part_s, void* part_i,
                        int B, int D, int k, int n_real, int splits, cudaStream_t stream) {
  const int kp = list_stride(k);
  size_t dyn;
  cudaError_t err = allow_lists<T>(k, &dyn);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)n_real + RT - 1) / RT;
  const long long rows_per_split = (tiles + splits - 1) / splits * RT;
  const dim3 grid((B + QT - 1) / QT, splits);
  topk_float_kernel<T><<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<float*>(part_s), static_cast<int*>(part_i), B, D, k, kp, n_real, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// How many blocks of the selection kernel an SM of the current card holds at
// this k (the lists' shared memory decides it: 4 at k <= 32, 2 at k = 128), or
// minus a CUDA error code. The wrapper sizes the splits so that every block is
// resident at once: a block is latency-bound, and a second wave of a few
// blocks costs as much as the first.
extern "C" int vod_fused_mips_topk_blocks_per_sm(int dtype, int k) {
  if (k < 1 || k > KMAX) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = blocks_per_sm<float>(k, &blocks);
  if (dtype == 1) err = blocks_per_sm<__nv_bfloat16>(k, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (queries already cast to the corpus type).
// With splits == 1 the caller passes part == out and no merge runs; otherwise
// part is [splits, B, k]. The caller makes the card that holds the tensors
// current; `stream_ptr` is PyTorch's current stream there. Returns the CUDA
// error code of the launches (0 = success).
extern "C" int vod_fused_mips_topk(int dtype, const void* q, const void* v,
                                   void* part_s, void* part_i, void* out_s, void* out_i,
                                   int B, int D, int k, int n_real, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > KMAX || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_topk<float>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  } else if (dtype == 1) {
    err = launch_topk<__nv_bfloat16>(q, v, part_s, part_i, B, D, k, n_real, splits, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_splits_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, k, splits);
  return static_cast<int>(cudaGetLastError());
}
