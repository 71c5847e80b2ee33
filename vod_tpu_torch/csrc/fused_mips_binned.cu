// fused_mips_binned: inner-product scores folded into binned running maxima,
// without a [B, N] score array in device memory.
//
// Replaces the TPU kernel `vod_tpu/ops/mips_pallas.py:_binned_kernel`
// (wrapper `fused_mips_binned`). For queries q [B, D] and corpus rows v [N, D]
// it writes, for each query b and bin c in [0, bins):
//
//   cell(b, c) = max over rows j < n_real with j % bins == c of q_b . v_j
//
// with the lowest row id winning a tie (rows are folded in increasing order
// with a strict `>`). An empty cell holds -inf (float path) or
// -(2^31)+1 (int8 path) with id -1. Selecting k of the `bins` cells happens in
// the Python wrapper (`vod_tpu_torch/ops/mips.py`), as on the TPU.
//
// Types: bf16 x bf16 or f32 x f32 rows and queries, converted to f32 and
// accumulated in f32 (the accumulator is never rounded to bf16); or
// int8 x int8, accumulated exactly in int32 with __dp4a.
//
// What bounds it on the H100: the kernel reads the corpus once (N * D bytes
// per element size) and does 2 * B * N * D operations. At serving batch
// (B = 64) the corpus read dominates and the kernel is memory-bound; at
// B = 2048 the products dominate and it is compute-bound.
//
// Design (a first version that is right and simple; tensor-core wgmma, TMA and
// a pipelined load ring are later work):
//   * A block owns a tile of 64 queries x 64 bins and walks the row strides
//     r in increasing order, taking rows j = r * bins + bin. For each stride it
//     stages k-slices of the query tile and of the 64 rows in shared memory and
//     computes the 64 x 64 products with CUDA-core FMAs (or __dp4a), each thread
//     owning a 4 x 4 micro-tile (queries ty + 16 i, bins tx + 16 j, which keeps
//     the shared-memory reads free of bank conflicts). The running
//     (score, id) cells stay in registers.
//   * At serving batch, 64 queries x 512 bins is only 8 such tiles for 132 SMs,
//     so a third grid dimension splits the strides into contiguous ranges.
//     Each split writes partial cells; a merge kernel folds the splits in
//     increasing order with the same strict `>`, which keeps the lowest-id rule
//     because split z only holds rows below those of split z + 1.
//   * Strides at or past n_real are never visited, and rows at or past n_real
//     inside the last stride are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;       // queries per block
constexpr int BT = 64;       // bins per block
constexpr int KT = 32;       // reduction slice staged in shared memory (elements)
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 cells each
constexpr int INT8_NEG = -2147483647;  // -(2^31) + 1, the TPU kernel's _INT32_MIN

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Float path (f32 or bf16 inputs, f32 accumulation).
template <typename T>
__global__ void __launch_bounds__(THREADS)
binned_float_kernel(const T* __restrict__ q, const T* __restrict__ v,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int B, int D, int bins, int n_real, int strides_per_split, int n_strides) {
  __shared__ float As[KT][QT + 1];
  __shared__ float Bs[KT][BT + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bin0 = blockIdx.x * BT, q0 = blockIdx.y * QT;
  const int split = blockIdx.z;
  const int r_begin = split * strides_per_split;
  const int r_end = min(n_strides, r_begin + strides_per_split);

  float best[4][4];
  int best_id[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { best[i][j] = -INFINITY; best_id[i][j] = -1; }

  for (int r = r_begin; r < r_end; ++r) {
    const long long row_base = (long long)r * bins + bin0;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KT) {
      // stage q[q0 : q0+64, k0 : k0+32] and v[rows, k0 : k0+32], k-major
      for (int e = threadIdx.x; e < QT * KT; e += THREADS) {
        const int row = e / KT, kk = e % KT;
        const int qb = q0 + row, kg = k0 + kk;
        As[kk][row] = (qb < B && kg < D) ? to_f32(q[(size_t)qb * D + kg]) : 0.f;
        const int bin = bin0 + row;
        const long long j = row_base + row;
        Bs[kk][row] = (bin < bins && j < n_real && kg < D) ? to_f32(v[(size_t)j * D + kg]) : 0.f;
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
    // fold this stride's scores into the running cells: strict '>' in
    // increasing row order, so a tie keeps the lowest row id
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = bin0 + tx + 16 * j;
      const long long row = row_base + tx + 16 * j;
      if (bin < bins && row < n_real) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (acc[i][j] > best[i][j]) { best[i][j] = acc[i][j]; best_id[i][j] = (int)row; }
      }
    }
  }

  const size_t base = (size_t)split * B * bins;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qb = q0 + ty + 16 * i;
    if (qb >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = bin0 + tx + 16 * j;
      if (bin >= bins) continue;
      out_s[base + (size_t)qb * bins + bin] = best[i][j];
      out_i[base + (size_t)qb * bins + bin] = best_id[i][j];
    }
  }
}

// int8 path: int8 x int8 products summed exactly in int32 with __dp4a.
// Requires D % 4 == 0 (checked by the wrapper) so that 4 int8 values pack into
// one 32-bit word.
__global__ void __launch_bounds__(THREADS)
binned_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ v,
                   int* __restrict__ out_s, int* __restrict__ out_i,
                   int B, int D, int bins, int n_real, int strides_per_split, int n_strides) {
  constexpr int KW = KT / 4;  // 32-bit words per staged slice
  __shared__ int As[KW][QT + 1];
  __shared__ int Bs[KW][BT + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bin0 = blockIdx.x * BT, q0 = blockIdx.y * QT;
  const int split = blockIdx.z;
  const int r_begin = split * strides_per_split;
  const int r_end = min(n_strides, r_begin + strides_per_split);
  const int DW = D / 4;
  const int* q32 = reinterpret_cast<const int*>(q);
  const int* v32 = reinterpret_cast<const int*>(v);

  int best[4][4];
  int best_id[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { best[i][j] = INT8_NEG; best_id[i][j] = -1; }

  for (int r = r_begin; r < r_end; ++r) {
    const long long row_base = (long long)r * bins + bin0;
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < DW; w0 += KW) {
      for (int e = threadIdx.x; e < QT * KW; e += THREADS) {
        const int row = e / KW, ww = e % KW;
        const int qb = q0 + row, wg = w0 + ww;
        As[ww][row] = (qb < B && wg < DW) ? q32[(size_t)qb * DW + wg] : 0;
        const int bin = bin0 + row;
        const long long j = row_base + row;
        Bs[ww][row] = (bin < bins && j < n_real && wg < DW) ? v32[(size_t)j * DW + wg] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int ww = 0; ww < KW; ++ww) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ww][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[ww][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = bin0 + tx + 16 * j;
      const long long row = row_base + tx + 16 * j;
      if (bin < bins && row < n_real) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (acc[i][j] > best[i][j]) { best[i][j] = acc[i][j]; best_id[i][j] = (int)row; }
      }
    }
  }

  const size_t base = (size_t)split * B * bins;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qb = q0 + ty + 16 * i;
    if (qb >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = bin0 + tx + 16 * j;
      if (bin >= bins) continue;
      out_s[base + (size_t)qb * bins + bin] = best[i][j];
      out_i[base + (size_t)qb * bins + bin] = best_id[i][j];
    }
  }
}

// Fold the splits' partial cells in increasing split order (strict '>').
template <typename S>
__global__ void merge_splits_kernel(const S* __restrict__ part_s, const int* __restrict__ part_i,
                                    S* __restrict__ out_s, int* __restrict__ out_i,
                                    int cells, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  S best = part_s[c];
  int id = part_i[c];
  for (int z = 1; z < splits; ++z) {
    const S s = part_s[(size_t)z * cells + c];
    if (s > best) { best = s; id = part_i[(size_t)z * cells + c]; }
  }
  out_s[c] = best;
  out_i[c] = id;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (then out/part scores are int32).
// With splits == 1 the caller passes part == out and no merge runs. The caller
// makes the card that holds the tensors current; `stream_ptr` is PyTorch's
// current stream there. Returns the CUDA error code of the launches (0 = success).
extern "C" int vod_fused_mips_binned(int dtype, const void* q, const void* v,
                                     void* part_s, void* part_i, void* out_s, void* out_i,
                                     int B, int D, int bins, int n_real, int splits,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_strides = (n_real + bins - 1) / bins;
  const int per_split = (n_strides + splits - 1) / splits;
  const dim3 grid((bins + BT - 1) / BT, (B + QT - 1) / QT, splits);
  if (dtype == 0) {
    binned_float_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(v),
        static_cast<float*>(part_s), static_cast<int*>(part_i),
        B, D, bins, n_real, per_split, n_strides);
  } else if (dtype == 1) {
    binned_float_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(v),
        static_cast<float*>(part_s), static_cast<int*>(part_i),
        B, D, bins, n_real, per_split, n_strides);
  } else if (dtype == 2) {
    binned_int8_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
        static_cast<int*>(part_s), static_cast<int*>(part_i),
        B, D, bins, n_real, per_split, n_strides);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int cells = B * bins;
  const int threads = 256;
  const int blocks = (cells + threads - 1) / threads;
  if (dtype == 2) {
    merge_splits_kernel<int><<<blocks, threads, 0, stream>>>(
        static_cast<const int*>(part_s), static_cast<const int*>(part_i),
        static_cast<int*>(out_s), static_cast<int*>(out_i), cells, splits);
  } else {
    merge_splits_kernel<float><<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i),
        static_cast<float*>(out_s), static_cast<int*>(out_i), cells, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
