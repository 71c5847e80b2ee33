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
// -(2^31)+1 (int8 path) with id -1. Then, on the same stream, `select_kernel`
// writes the k best cells of each query: the TPU wrapper's `lax.top_k`
// (`vod_tpu/ops/mips_pallas.py:286`), in its order (score descending, lower
// cell first on ties), with id -1 where the score is -inf (float; NaN and
// +inf too, as the wrapper's `isfinite`) or the int8 sentinel.
//
// Types: bf16 x bf16 or f32 x f32 rows and queries, accumulated in f32 (the
// accumulator is never rounded to bf16); or int8 x int8, accumulated exactly
// in int32.
//
// What bounds it on the H100: the kernel reads the corpus once (N * D bytes
// per element size) and does 2 * B * N * D operations. At serving batch
// (B <= 64) the corpus read dominates and the kernel is memory-bound; at
// B = 2048 the products dominate and it is compute-bound.
//
// Two bodies; the wrapper names the one a call takes by a fixed rule on dtype
// and shape (`ops/mips.py:_binned_body`):
//   * "wgmma" (`binned_wgmma_kernel`), bf16 with D % 8 == 0 or int8 with
//     D % 16 == 0 (16-byte rows, as TMA needs), bins % 128 == 0, the query
//     tile within shared memory and 16-byte-aligned pointers. A block owns 64
//     queries x 128 consecutive bins. For stride r the 128 rows
//     r * bins + bin0 ... + 127 are contiguous, so they are one TMA box, and
//     the product runs on the tensor cores: `wgmma.mma_async` m64n128k16
//     (bf16 in, f32 accumulate) or m64n128k32 (s8 in, s32 accumulate), the
//     queries as M and the stride's rows as N (the query operand is read once
//     per 128 rows). The query tile is loaded once (boxes of 64 queries x 128
//     bytes of K; 96 KB at D = 768 bf16, 48 KB int8) and stays resident; the
//     rows stream through a ring of 16 KB boxes (128 rows x 128 bytes,
//     128-byte swizzle) completed on `mbarrier`s, as deep as the rest of
//     shared memory allows (8 boxes at D = 768 bf16, 11 int8). A slot is
//     reloaded once the `wgmma` that read it has retired. One warpgroup
//     multiplies and folds; a fifth warp issues every load, waiting on a
//     per-slot "empty" barrier, so the multiplying warps never stop to issue.
//     The epilogue needs no shared memory: fragment i of a thread lands on
//     the same (query, bin) cell at every stride, so after the stride's last
//     K box each thread folds its 64 fragments into its own running cells
//     with a strict `>` (rows at or past n_real masked explicitly, since the
//     tensor map reads zeros there and a zero can win). A cell keeps its
//     winner's stride within the split in 16 bits, two cells to a register,
//     so a split holds at most 65,535 strides.
//     What the design answers: the operation bound at B = 2048 (tensor
//     cores) and the byte bound at B <= 64 (the ring keeps the corpus
//     streaming across the product and the fold). What it leaves: at
//     B = 2048 each of the 32 query tiles re-reads the corpus, and that
//     traffic, which L2 serves only in part, sets the pace.
//   * "fma" (`binned_float_kernel`, `binned_int8_kernel`), f32 and every other
//     call: a block owns 64 queries x 64 bins and stages k-slices of the query
//     tile and of the stride's 64 rows in shared memory, computing the
//     products with CUDA-core FMAs in f32 (or `__dp4a` for int8, D % 4 == 0),
//     each thread owning a 4 x 4 micro-tile (queries ty + 16 i, bins
//     tx + 16 j, which keeps the shared-memory reads free of bank conflicts);
//     the running (score, id) cells stay in registers.
//
// Shared by both bodies: the TPU grid walks the strides in order on one core;
// GPU blocks run in parallel. So a third grid dimension splits the strides
// into contiguous ranges, as many as fill the card with resident blocks in
// one wave. Each split writes partial cells [splits, B, bins]. Strides at or
// past n_real are never visited.
//
// The selection (`select_kernel`), one block per query, replaces a merge
// kernel and a sort, gather and mask in PyTorch (five or more launches) by
// one launch. It folds the query's splits cell by cell in increasing split
// order with the same strict `>`, which keeps the lowest-id rule because split
// z only holds rows below those of split z + 1, and makes each cell a 64-bit
// key: the score's bits in an order-preserving form above the complement of
// the cell index, so that one descending sort of the keys gives score
// descending, then lower cell first, and no two keys tie. The keys, padded to
// a power of two with zeros (below every cell), go through a bitonic sort in
// shared memory (up to 8,192 cells: keys, folded scores and ids, 128 KB), or
// in a workspace in device memory above that. The first k keys name the
// cells, whose folded score (with its bits: a -0 stays -0 though it sorts as
// +0) and id are written out. What bounds it: at a narrow call it reads
// splits x B x bins partials (4.3 MB at B = 32, 512 bins, 33 splits), a few
// microseconds of the card; of its log2(bins)^2 / 2 sort stages only those
// of strides above 32, and the stage after each, wait on a block-wide barrier.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// QT, BT, WBT, MAX_CHUNKS (times each type's KC) and MAX_STRIDES have twins
// in `ops/mips.py` (_QUERY_TILE, _BINNED_BIN_TILE, _BINNED_WGMMA_MAX_D,
// _BINNED_MAX_STRIDES): change both sides together.
constexpr int QT = 64;       // queries per block
constexpr int BT = 64;       // bins per block of the CUDA-core body
constexpr int KT = 32;       // reduction slice staged in shared memory (elements)
constexpr int THREADS = 256; // CUDA-core body: 16 x 16 threads, 4 x 4 cells each
constexpr int INT8_NEG = -2147483647;  // -(2^31) + 1, the TPU kernel's _INT32_MIN
// tensor-core body
constexpr int WBT = 128;                      // bins per block: the wgmma's N
constexpr int WTHREADS = 128;                 // the multiplying warpgroup (a loader warp comes on top)
constexpr int KB = 128;                       // bytes of K per TMA box row: one swizzle span
constexpr int QBOX_BYTES = QT * KB;           // 8 KB: a box of 64 queries
constexpr int BOX_BYTES = WBT * KB;           // 16 KB: a ring box of 128 rows
constexpr int MAX_CHUNKS = 24;                // query tile <= 192 KB: two ring boxes still fit beside it
constexpr int MAX_STRIDES = 65535;            // strides per split: 16-bit winners, 0xFFFF = none
constexpr uint32_t NO_WINNER = 0xFFFFFFFFu;   // both halves 0xFFFF
// selection; SELECT_SMEM_CELLS has a twin in `ops/mips.py` (_SELECT_SMEM_CELLS)
constexpr int SELECT_SMEM_CELLS = 8192;       // cells (16 bytes each) sorted in shared memory; more go to the workspace
constexpr int SELECT_THREADS = 1024;          // at most; one a cell (padded) when fewer

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

// ---- selection: the splits folded and k of the cells chosen ------------------

// The score's bits in an order-preserving form: a larger score gives a larger
// key. NaN sorts above every number (as torch's descending sort puts it) and
// -0 ties with +0.
__device__ __forceinline__ uint32_t order_bits(int s) { return static_cast<uint32_t>(s) ^ 0x80000000u; }
__device__ __forceinline__ uint32_t order_bits(float s) {
  if (isnan(s)) return 0xFFFFFFFFu;
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
// A cell the wrapper gives id -1: `isfinite` fails (float) or the int8 sentinel.
__device__ __forceinline__ bool no_id(float s) { return !isfinite(s); }
__device__ __forceinline__ bool no_id(int s) { return s <= INT8_NEG; }

// Cell c of one query: its splits (`plane` apart) folded in increasing split
// order with a strict `>`. The loads do not wait on the compares, so the
// unrolled loop keeps several in flight.
template <typename S>
__device__ __forceinline__ void fold_cell(const S* __restrict__ ps, const int* __restrict__ pi, size_t plane,
                                          int splits, S& best, int& id) {
  best = ps[0];
  id = pi[0];
#pragma unroll 8
  for (int z = 1; z < splits; ++z) {
    const S s = ps[(size_t)z * plane];
    const int i = pi[(size_t)z * plane];
    if (s > best) { best = s; id = i; }
  }
}

// Block b: query b. Its n_pad keys, folded scores and ids (16 bytes a cell) go
// to dynamic shared memory (GLOBAL false) or to the workspace's row b (GLOBAL
// true); barriers order both for the block. Thread t folds cells t,
// t + blockDim, ...; in the sort, thread t handles pairs t, t + blockDim, ...,
// so a stage of stride <= 32 stays inside each warp's 64 keys and needs only
// the warp's barrier, unless the stage before it crossed warps.
template <typename S, bool GLOBAL>
__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const S* __restrict__ part_s, const int* __restrict__ part_i, S* __restrict__ out_s,
              int* __restrict__ out_i, unsigned char* __restrict__ sort_ws, int B, int bins, int splits, int k,
              int n_pad) {
  extern __shared__ __align__(16) unsigned char smem_cells[];
  const int b = blockIdx.x;
  unsigned char* base = GLOBAL ? sort_ws + (size_t)b * n_pad * 16 : smem_cells;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  S* cell_s = reinterpret_cast<S*>(base + (size_t)n_pad * 8);
  int* cell_i = reinterpret_cast<int*>(base + (size_t)n_pad * 12);
  const size_t plane = (size_t)B * bins;
  const S* ps = part_s + (size_t)b * bins;
  const int* pi = part_i + (size_t)b * bins;
  for (int c = threadIdx.x; c < n_pad; c += blockDim.x) {
    unsigned long long key = 0ull;  // padding: below every cell
    if (c < bins) {
      S s;
      int id;
      fold_cell(ps + c, pi + c, plane, splits, s, id);
      cell_s[c] = s;
      cell_i[c] = id;
      key = (static_cast<unsigned long long>(order_bits(s)) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(c));
    }
    keys[c] = key;
  }
  // bitonic sort, descending: pair (i, i + stride) runs descending where
  // (i & size) == 0, so the last merge (size == n_pad) is descending throughout
  bool wide = true;  // the keys were written block-wide
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (wide || stride > 32) __syncthreads(); else __syncwarp();
      wide = stride > 32;
      for (int t = threadIdx.x; t < n_pad / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long lo = keys[i], hi = keys[i + stride];
        if ((lo < hi) == ((i & size) == 0)) { keys[i] = hi; keys[i + stride] = lo; }
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int c = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(keys[r]));
    const S s = cell_s[c];
    out_s[(size_t)b * k + r] = s;
    out_i[(size_t)b * k + r] = no_id(s) ? -1 : cell_i[c];
  }
}

template <typename S> struct SelectTag {};

// The select kernel on `stream`: partials [splits, B, bins] in, [B, k] out.
// `sort_ws` holds B * n_pad cells of 16 bytes where n_pad (bins padded to a
// power of two) exceeds SELECT_SMEM_CELLS, and may be null otherwise.
template <typename S>
cudaError_t launch_select(const void* part_s, const void* part_i, void* out_s, void* out_i, void* sort_ws, int B,
                          int bins, int splits, int k, cudaStream_t stream) {
  if (B < 1 || bins < 1 || bins > (1 << 30) || splits < 1 || k < 1 || k > bins) return cudaErrorInvalidValue;
  int n_pad = 1;
  while (n_pad < bins) n_pad <<= 1;
  const int threads = min(SELECT_THREADS, max(32, n_pad));  // a thread a cell while the fold lasts
  if (n_pad <= SELECT_SMEM_CELLS) {
    const cudaError_t err = allow_max_smem<SelectTag<S>>(select_kernel<S, false>);
    if (err != cudaSuccess) return err;
    select_kernel<S, false><<<B, threads, (size_t)n_pad * 16, stream>>>(
        static_cast<const S*>(part_s), static_cast<const int*>(part_i), static_cast<S*>(out_s),
        static_cast<int*>(out_i), nullptr, B, bins, splits, k, n_pad);
  } else {
    if (sort_ws == nullptr) return cudaErrorInvalidValue;
    select_kernel<S, true><<<B, threads, 0, stream>>>(
        static_cast<const S*>(part_s), static_cast<const int*>(part_i), static_cast<S*>(out_s),
        static_cast<int*>(out_i), static_cast<unsigned char*>(sort_ws), B, bins, splits, k, n_pad);
  }
  return cudaGetLastError();
}

// ---- tensor-core body (TMA, mbarriers and wgmma from sm90.cuh) --------------

// The two operand types of the tensor-core body: 128 bytes of K per box row
// are KC elements, and each wgmma takes 32 bytes of K.
struct Bf16Body {
  using Acc = float;
  static constexpr int ELEM = 2;  // bytes per element
  static constexpr int KC = KB / ELEM;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ float empty() { return -INFINITY; }
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    wgmma_m64n128k16(d, da, db, scale_d);
  }
};
struct Int8Body {
  using Acc = int;
  static constexpr int ELEM = 1;
  static constexpr int KC = KB / ELEM;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes moved, not interpreted
  static __device__ __forceinline__ int empty() { return INT8_NEG; }
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    wgmma_m64n128k32_s8(d, da, db, scale_d);
  }
};

// Block (query tile x, bin tile y, split z) walks the strides of its split in
// increasing order. Warps 0-3 (one warpgroup) multiply and fold; warp 4's
// lane 0 issues every TMA load. Ring box g (g = stride * chunks + chunk) sits
// in slot g % stages; its load completes phase g / stages of the slot's `full`
// barrier, and once the `wgmma` that read it has retired, thread 0 completes
// the same phase of the slot's `empty` barrier, which the loader waits for
// before it reuses the slot.
template <typename Body>
__global__ void __launch_bounds__(WTHREADS + 32, 1)
binned_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_v,
                    typename Body::Acc* __restrict__ out_s, int* __restrict__ out_i,
                    int B, int bins, int chunks, int stages, int n_real, int strides_per_split) {
  using Acc = typename Body::Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtile = base;                                              // [chunks][64 queries][128 bytes]
  unsigned char* ring = qtile + chunks * QBOX_BYTES;                        // [stages][128 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * BOX_BYTES);  // [stages]
  uint64_t* empty = full + stages;                                          // [stages]
  uint64_t* qbar = empty + stages;                                          // the query tile's

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QT, bin0 = blockIdx.y * WBT, split = blockIdx.z;
  const int r_begin = split * strides_per_split;
  // strides whose first row at these bins lies below n_real (the last may be ragged)
  const int r_stop = n_real > bin0 ? (n_real - bin0 + bins - 1) / bins : 0;
  const int strides = max(0, min(r_begin + strides_per_split, r_stop) - r_begin);
  const int total = strides * chunks;  // ring boxes this block loads

  if (tid == 0) {
    for (int s = 0; s < 2 * stages + 1; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WTHREADS / 32) {  // the loader warp
    if (lane == 0 && total > 0) {
      mbar_expect_tx(qbar, chunks * QBOX_BYTES);
      for (int c = 0; c < chunks; ++c) tma_load(qtile + c * QBOX_BYTES, &map_q, c * Body::KC, q0, qbar);
      for (int g = 0; g < total; ++g) {
        const int slot = g % stages;
        if (g >= stages) mbar_wait(empty + slot, (uint32_t)((g / stages - 1) & 1));  // box g - stages retired
        mbar_expect_tx(full + slot, BOX_BYTES);
        tma_load(ring + slot * BOX_BYTES, &map_v, (g % chunks) * Body::KC, (r_begin + g / chunks) * bins + bin0,
                 full + slot);
      }
    }
    return;  // no block-wide barrier follows
  }

  // Fragment i of thread (warp, lane): query 16 warp + lane / 4 + 8 ((i / 2) % 2),
  // bin bin0 + 8 (i / 4) + 2 (lane % 4) + i % 2, the same at every stride.
  Acc acc[64], best[64];
  uint32_t won[32];  // winning stride within the split: fragment 2p in the low half of won[p], 2p + 1 in the high
#pragma unroll
  for (int i = 0; i < 64; ++i) { acc[i] = 0; best[i] = Body::empty(); }
#pragma unroll
  for (int p = 0; p < 32; ++p) won[p] = NO_WINNER;
  // one product group stays in flight; with one slot, the box in use must retire first
  const bool in_flight = stages > 1;
  for (int s = 0; s < strides; ++s) {
    if (s == 0) mbar_wait(qbar, 0);  // the query tile
    for (int c = 0; c < chunks; ++c) {
      const int g = s * chunks + c;
      const unsigned char* box = ring + (g % stages) * BOX_BYTES;
      mbar_wait(full + g % stages, (uint32_t)((g / stages) & 1));
      __syncwarp();  // the wgmma instructions are warp-aligned
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)  // 32 bytes of K per instruction
        Body::mma(acc, sw128_desc(qtile + c * QBOX_BYTES + 32 * kk), sw128_desc(box + 32 * kk), (c | kk) != 0);
      wgmma_commit();
      if (in_flight) {
        wgmma_wait<1>();  // box g - 1 has retired (the stride's last box is released below)
        if (tid == 0 && c > 0) mbar_arrive(empty + (g - 1) % stages);
      } else {
        wgmma_wait<0>();
        if (tid == 0) mbar_arrive(empty + g % stages);
      }
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tid == 0 && in_flight) mbar_arrive(empty + (s * chunks + chunks - 1) % stages);
    // fold the stride into the running cells; bins at or past `real` hold rows at or past n_real
    const int real = min(WBT, n_real - ((r_begin + s) * bins + bin0));
    const uint32_t tag_lo = (uint32_t)s, tag_hi = (uint32_t)s << 16;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const Acc a0 = col < real ? acc[i] : Body::empty();
      const Acc a1 = col + 1 < real ? acc[i + 1] : Body::empty();
      uint32_t w = won[i / 2];
      if (a0 > best[i]) { best[i] = a0; w = (w & 0xFFFF0000u) | tag_lo; }
      if (a1 > best[i + 1]) { best[i + 1] = a1; w = (w & 0x0000FFFFu) | tag_hi; }
      won[i / 2] = w;
    }
  }

  const size_t split_base = (size_t)split * B * bins;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int qb = q0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    if (qb >= B) continue;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    const uint32_t lo = won[i / 2] & 0xFFFFu, hi = won[i / 2] >> 16;
    const size_t o = split_base + (size_t)qb * bins + bin0 + col;
    out_s[o] = best[i];
    out_s[o + 1] = best[i + 1];
    out_i[o] = lo == 0xFFFFu ? -1 : (r_begin + (int)lo) * bins + bin0 + col;
    out_i[o + 1] = hi == 0xFFFFu ? -1 : (r_begin + (int)hi) * bins + bin0 + col + 1;
  }
}

// Dynamic shared memory of the tensor-core body: 1 KB to align the boxes,
// the query tile, the ring, the mbarriers (full and empty per slot, the query
// tile's).
size_t wgmma_smem(int chunks, int stages) {
  return 1024 + (size_t)chunks * QBOX_BYTES + (size_t)stages * BOX_BYTES + (2 * stages + 1) * sizeof(uint64_t);
}

template <typename Body>
int wgmma_chunks(int D) { return (D + Body::KC - 1) / Body::KC; }

// The tensor-core body's ring depth and dynamic shared memory: the query
// tile, and as many 16 KB ring boxes as the rest of the card's per-block limit
// holds (at D = 768 on an H100: 8 boxes bf16, 11 int8). One block per SM. The
// limit is read, and the kernel's opt-in set, once per card (sm90.cuh).
template <typename Body>
cudaError_t allow_wgmma(int D, int* stages, size_t* dyn) {
  // the refusal twin of `ops/mips.py:_binned_body`'s D rule: 16-byte rows, the query tile fits
  if (D <= 0 || D * Body::ELEM % 16 != 0 || wgmma_chunks<Body>(D) > MAX_CHUNKS) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = optin_smem(&limit);
  if (err != cudaSuccess) return err;
  const size_t fixed = wgmma_smem(wgmma_chunks<Body>(D), 0);
  *stages = limit > (long long)fixed ? (int)((limit - fixed) / (BOX_BYTES + 2 * sizeof(uint64_t))) : 0;
  if (*stages < 1) return cudaErrorInvalidValue;
  *dyn = wgmma_smem(wgmma_chunks<Body>(D), *stages);
  return allow_max_smem<Body>(binned_wgmma_kernel<Body>);
}

template <typename Body>
cudaError_t launch_wgmma(const void* q, const void* v, void* part_s, void* part_i,
                         int B, int D, int bins, int n_real, int splits, cudaStream_t stream) {
  const int n_strides = (n_real + bins - 1) / bins;
  const int per_split = (n_strides + splits - 1) / splits;
  if (bins % WBT != 0 || per_split > MAX_STRIDES) return cudaErrorInvalidValue;
  size_t dyn;
  int stages;
  cudaError_t err = allow_wgmma<Body>(D, &stages, &dyn);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_v;
  if ((err = sw128_map(&map_q, Body::MAP, Body::ELEM, q, B, D, QT)) != cudaSuccess) return err;
  // rows past n_real are never read; a shard of padding only (n_real = 0, a
  // sharded index's last shards) loads nothing, but its map still needs a row
  if ((err = sw128_map(&map_v, Body::MAP, Body::ELEM, v, n_real > 0 ? n_real : 1, D, WBT)) != cudaSuccess) return err;
  const dim3 grid((B + QT - 1) / QT, bins / WBT, splits);  // query tile fastest: blocks reading the same rows run together
  binned_wgmma_kernel<Body><<<grid, WTHREADS + 32, dyn, stream>>>(
      map_q, map_v, static_cast<typename Body::Acc*>(part_s), static_cast<int*>(part_i), B, bins,
      wgmma_chunks<Body>(D), stages, n_real, per_split);
  return cudaGetLastError();
}

// After the body's launch (`err`), the select kernel on the same stream.
int then_select(cudaError_t err, int dtype, const void* part_s, const void* part_i, void* out_s, void* out_i,
           void* sort_ws, int B, int bins, int splits, int k, cudaStream_t stream) {
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 2) return static_cast<int>(launch_select<int>(part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k, stream));
  return static_cast<int>(launch_select<float>(part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k, stream));
}

}  // namespace

// How many blocks of a body (0 = CUDA cores, 1 = tensor cores) an SM of the
// current card holds at this dtype and D, or minus a CUDA error code. The
// wrapper sizes the splits so that every block is resident at once.
extern "C" int vod_fused_mips_binned_blocks_per_sm(int body, int dtype, int D) {
  int blocks = 0, stages = 0;
  size_t dyn = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && dtype == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<float>, THREADS, 0);
  if (body == 0 && dtype == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<__nv_bfloat16>, THREADS, 0);
  if (body == 0 && dtype == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_int8_kernel, THREADS, 0);
  if (body == 1 && dtype == 1 && (err = allow_wgmma<Bf16Body>(D, &stages, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_wgmma_kernel<Bf16Body>, WTHREADS + 32, dyn);
  if (body == 1 && dtype == 2 && (err = allow_wgmma<Int8Body>(D, &stages, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_wgmma_kernel<Int8Body>, WTHREADS + 32, dyn);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The CUDA-core body, then the select kernel. dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then part/out scores are int32). part is the
// [splits, B, bins] partials' workspace (scores, ids), out the [B, k] result,
// sort_ws the select kernel's workspace (B * n_pad 8-byte keys, or null where
// the keys fit in shared memory). The caller makes the card that holds the
// tensors current; `stream_ptr` is PyTorch's current stream there. Returns the
// CUDA error code of the launches (0 = success).
extern "C" int vod_fused_mips_binned_fma(int dtype, const void* q, const void* v,
                                         void* part_s, void* part_i, void* out_s, void* out_i, void* sort_ws,
                                         int B, int D, int bins, int n_real, int splits, int k,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_thread();
  if (bound != cudaSuccess) return static_cast<int>(bound);
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
  return then_select(cudaGetLastError(), dtype, part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k, stream);
}

// The tensor-core body, then the select kernel, the same arguments: bf16
// (dtype 1) with D % 8 == 0 or int8 (dtype 2) with D % 16 == 0, at most
// MAX_CHUNKS boxes of query tile, bins % 128 == 0, at most 65,535 strides a
// split, q and v 16-byte aligned; anything else is refused with
// cudaErrorInvalidValue, never run on another body.
extern "C" int vod_fused_mips_binned_wgmma(int dtype, const void* q, const void* v,
                                           void* part_s, void* part_i, void* out_s, void* out_i, void* sort_ws,
                                           int B, int D, int bins, int n_real, int splits, int k,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (splits < 1 || reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bind_thread();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1) {
    err = launch_wgmma<Bf16Body>(q, v, part_s, part_i, B, D, bins, n_real, splits, stream);
  } else if (dtype == 2) {
    err = launch_wgmma<Int8Body>(q, v, part_s, part_i, B, D, bins, n_real, splits, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return then_select(err, dtype, part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k, stream);
}

// The select kernel alone, on partials [splits, B, bins] that the caller made
// (the wrapper `merge_select`): dtype 2 = int32 scores, else f32; the other
// arguments as above.
extern "C" int vod_fused_mips_binned_select(int dtype, const void* part_s, const void* part_i, void* out_s,
                                            void* out_i, void* sort_ws, int B, int bins, int splits, int k,
                                            void* stream_ptr) {
  return then_select(bind_thread(), dtype, part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k,
                     static_cast<cudaStream_t>(stream_ptr));
}
