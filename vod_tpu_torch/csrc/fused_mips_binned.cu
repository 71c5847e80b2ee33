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
//     call: a block owns 64 queries x 64 bins and walks its strides. The float
//     body runs the product core of `sm90.cuh` (namespace `simt`: 4 warps
//     multiply, 8 x 4 sums a thread, while 4 stage k-slices of rows at any
//     alignment through a ring in shared memory) and each multiplying thread
//     folds its sums into its own running cells in shared memory; the int8
//     body stages k-slices in shared memory and sums with `__dp4a` (D % 4 ==
//     0), a 4 x 4 micro-tile per thread (queries ty + 16 i, bins tx + 16 j),
//     its running (score, id) cells in registers.
//
// Shared by both bodies: the TPU grid walks the strides in order on one core;
// GPU blocks run in parallel. So a third grid dimension splits the strides
// into contiguous ranges, as many as fill the card with resident blocks in
// one wave. Each split writes partial cells [splits, B, bins]. Strides at or
// past n_real are never visited.
//
// The selection (`select_kernel`) replaces a merge kernel and a sort, gather
// and mask in PyTorch (five or more launches) by one launch. It folds each
// cell's splits in increasing split order with the same strict `>`, which
// keeps the lowest-id rule because split z only holds rows below those of
// split z + 1, and writes k cells in `lax.top_k`'s order: score descending,
// then lower cell first, one block a query. What bounds it: it must read
// every partial score once and the k winners' ids (2.2 MB at the CLI loop's
// 33 splits x 32 queries x 512 bins, under a microsecond of the card's memory
// rate), so it is bound by latency: the loads of the fold and the barriers
// of its steps, not by bytes. The design keeps both few:
//   * the fold reads scores only, each cell keeping its winning split; only
//     the k winners' ids are read, at the end, from that split. The scores
//     reach shared memory by TMA bulk copies (a split's row of cells is
//     contiguous; `cp.async` off the 16-byte grid), a whole chunk of splits
//     in flight at once without holding registers, so the fold waits on
//     memory once a chunk (once a call at the main paths' shapes);
//   * radix passes over the scores' bits in an order-preserving form find
//     the k-th score, 8 bits a pass (a 256-digit histogram, shared atomics
//     aggregated a warp at a time) starting at the highest bit in which the
//     block's cells differ (a clustered row skips its common bits); they
//     stop once the digit that holds the k-th score holds exactly the cells
//     still needed, or, for k <= 256, once at most 256 cells lie at or
//     above it;
//   * those cells are gathered in cell order (ballots and a block prefix,
//     no atomics deciding which, so the lowest cells win a tie at the
//     threshold) and only they are ordered: 64-bit keys (the bits above the
//     complemented cell index, so no two tie), each placed by counting the
//     keys above it (k <= 256: no barrier), else a bitonic sort of k keys
//     padded to a power of two. The winners' own scores go out (a -0 stays
//     -0, though it sorts as +0).
// A thread-block cluster a query (its blocks folding slices of the cells, and
// in a first version summing their histograms at every pass through
// distributed shared memory) was built twice and measured slower (PERF.md,
// PR 21): the cluster's launch and barrier cost more than spreading a query's
// partials over more SMs saves, since the fold waits mostly on one round trip
// to memory. Cells (order bits and winning split) and the candidates take 8
// bytes each in shared memory up to 8,192 bins (padded), and sit in a
// workspace in device memory above that.

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
constexpr int THREADS = 256; // int8 CUDA-core body: 16 x 16 threads, 4 x 4 cells each (the float one's: simt::THREADS)
constexpr int INT8_NEG = -2147483647;  // -(2^31) + 1, the TPU kernel's _INT32_MIN
static_assert(simt::TILE == QT && simt::TILE == BT, "the product core's tile is the block's");
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
constexpr int SELECT_SMEM_CELLS = 8192;       // bins (padded) whose cells and candidates stay in shared memory; more: the workspace
constexpr int SELECT_THREADS = 1024;          // at most a block
constexpr int RADIX = 256;                    // digits of an 8-bit radix pass
constexpr int RANK_SORT_MAX = 256;            // k up to this: at most this many candidates, each placed by counting
constexpr int SELECT_STAGE_BYTES = 80 * 1024; // the fold's stage of partial scores in shared memory

// Float path (f32 or bf16 inputs, f32 accumulation): the product core of
// `sm90.cuh` (namespace `simt`): warps 0-3 multiply a tile of the block's 64
// queries x 64 bins a stride, warps 4-7 stage the strides' slices through
// the ring. Sum acc[i][j] of a multiplying thread is the same (query, bin)
// cell at every stride, so each thread folds its 32 sums into its own
// running cells after each stride: a strict `>` in increasing row order, so
// a tie keeps the lowest row id. The running cells (score and id) sit in
// shared memory, cell m of thread t at m * THREADS + t, which only thread t
// reads and writes: in registers, 64 beside the 32 sums, they would raise
// every thread of the block, the staging warps' too, past 128 registers
// and the SM from 3 blocks to 1, while in shared memory the fold reads 32
// floats a stride against 32 D FMAs.
constexpr int FLOAT_CELLS = simt::MQ * simt::MR;  // running cells a multiplying thread
constexpr size_t FLOAT_SMEM = (simt::STAGE_FLOATS + 2 * FLOAT_CELLS * simt::THREADS) * sizeof(float);

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(simt::CORE_THREADS, 3)
binned_float_kernel(const T* __restrict__ q, const T* __restrict__ v,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int B, int D, int bins, int n_real, int strides_per_split, int n_strides) {
  extern __shared__ float4 smem_float[];
  float* ring_base = reinterpret_cast<float*>(smem_float);  // the product core's ring
  float* cell_s = ring_base + simt::STAGE_FLOATS;             // [FLOAT_CELLS][THREADS]
  int* cell_i = reinterpret_cast<int*>(cell_s + FLOAT_CELLS * simt::THREADS);
  const int tid = threadIdx.x;
  const int bin0 = blockIdx.x * BT, q0 = blockIdx.y * QT;
  const int split = blockIdx.z;
  const int r_begin = split * strides_per_split;
  const int r_end = min(n_strides, r_begin + strides_per_split);
  simt::Ring ring{ring_base, 0, max(0, r_end - r_begin) * simt::slices_of(D)};

  if (tid >= simt::THREADS) {
    // staging: the tile's queries, or the stride's rows at the block's bins
    constexpr int CH = simt::Span<T>::CH;
    const int first = simt::first_staged_row<T>(tid - simt::THREADS);
    const int q_live = max(0, min(CH, B - q0 - first));
    for (int r = r_begin; r < r_end; ++r) {
      const long long j = (long long)r * bins + bin0 + first - QT;
      const T* rows = first < QT ? q + (size_t)(q0 + first) * D : v + (size_t)j * D;
      const int live = first < QT ? q_live
                                  : (int)max(0ll, min((long long)min(CH, bins - (bin0 + first - QT)), n_real - j));
      simt::stage_tile<T, ALIGNED>(rows, live, D, ring);
    }
    return;  // no block-wide barrier follows
  }

  const int row0 = simt::row_of(tid, 0);  // this thread's first bin in the tile
#pragma unroll
  for (int m = 0; m < FLOAT_CELLS; ++m) { cell_s[m * simt::THREADS + tid] = -INFINITY; cell_i[m * simt::THREADS + tid] = -1; }
  for (int r = r_begin; r < r_end; ++r) {
    const long long row_base = (long long)r * bins + bin0;
    float acc[simt::MQ][simt::MR];
    simt::multiply_tile<T>(D, ring, acc);
#pragma unroll
    for (int j = 0; j < simt::MR; ++j) {
      const long long id = row_base + row0 + j;
      if (bin0 + row0 + j < bins && id < n_real) {
#pragma unroll
        for (int i = 0; i < simt::MQ; ++i) {
          const int m = (i * simt::MR + j) * simt::THREADS + tid;
          if (acc[i][j] > cell_s[m]) { cell_s[m] = acc[i][j]; cell_i[m] = (int)id; }
        }
      }
    }
  }

  const size_t base = (size_t)split * B * bins;
#pragma unroll
  for (int i = 0; i < simt::MQ; ++i) {
    const int qb = q0 + simt::query_of(tid, i);
    if (qb >= B) continue;
#pragma unroll
    for (int j = 0; j < simt::MR; ++j) {
      const int bin = bin0 + row0 + j;
      if (bin >= bins) continue;
      const int m = (i * simt::MR + j) * simt::THREADS + tid;
      out_s[base + (size_t)qb * bins + bin] = cell_s[m];
      out_i[base + (size_t)qb * bins + bin] = cell_i[m];
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

// 4 bytes from device memory to shared memory, asynchronously (no register
// holds them); `cp_async_wait_all` waits for the thread's copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Inclusive sum over the warp's lanes up to this one.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The largest and smallest of a warp's values, in every lane.
__device__ __forceinline__ void warp_max_min(uint32_t& hi, uint32_t& lo) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
    lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
  }
}

struct SelectState {
  uint32_t prefix;  // the threshold's bits found so far
  int need;         // cells still to take among those matching the prefix
  int above;        // cells above every value with the prefix
  int count;        // cells matching the prefix
  int done;         // 1 once the candidates are settled
};

// Block b: query b. Shared memory (GLOBAL false) or the workspace's row b
// (GLOBAL true) holds each cell's order bits and winning split, and the
// candidate keys. Steps:
//   1. fold: the query's partial scores (not their ids, which step 4 reads
//      for the winners only) are copied to shared memory, as many splits at
//      a time as the stage holds, by the TMA unit (a split's row of cells
//      is contiguous), or by 4-byte `cp.async` where a row is off the
//      16-byte grid, so that every load of a chunk is in flight at once and
//      holds no register; then each thread folds its cells over them in
//      split order. The block's largest and smallest order bits come with
//      it;
//   2. radix passes over the order bits, 8 bits a pass from the highest bit
//      in which the largest and smallest differ (the bits above it are
//      common): a 256-digit histogram of the cells matching the prefix (a
//      warp's lanes on its first lane's digit add in one shared atomic), and
//      the digit that holds the k-th cell. The passes stop once that digit's
//      cells are all needed, or (k <= RANK_SORT_MAX) once the cells above it
//      and in it number at most RANK_SORT_MAX, all of which become
//      candidates;
//   3. gather, in cell order (each warp a run of cells, ballots within it
//      and a block prefix of the runs' counts): the cells above the prefix,
//      and those matching it (all of them, or the first `need`: lowest cell
//      first);
//   4. order the candidates' keys (k <= RANK_SORT_MAX: each key's place is
//      the count of keys above it, and places past k go nowhere; else a
//      bitonic sort of k keys padded to a power of two) and write each
//      winner's own score and id, read from its winning split.
template <typename S, bool GLOBAL>
__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const S* __restrict__ part_s, const int* __restrict__ part_i, S* __restrict__ out_s,
              int* __restrict__ out_i, unsigned char* __restrict__ ws, int B, int bins, int splits, int k, int tile,
              int planes, int n_keys, int n_pad) {
  extern __shared__ __align__(16) unsigned char smem_sel[];
  __shared__ uint32_t hist[2][RADIX];
  __shared__ uint32_t warp_hi[32], warp_lo[32];
  __shared__ int warp_up[32], warp_eq[32];
  __shared__ SelectState st;
  __shared__ uint64_t staged;  // the stage's mbarrier (TMA copies)
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid % 32, warp = tid / 32, warps = T / 32;
  unsigned long long* keys;  // the candidates' keys
  uint32_t *cbits, *cz;      // the cells: order bits (the running score while folding), winning split
  S* stage = reinterpret_cast<S*>(smem_sel);  // [planes][tile] partial scores
  unsigned char* rest = smem_sel + ((size_t)planes * tile * 4 + 15) / 16 * 16;
  if (GLOBAL) {
    unsigned char* row = ws + (size_t)b * n_pad * 16;
    cbits = reinterpret_cast<uint32_t*>(row);
    cz = reinterpret_cast<uint32_t*>(row + (size_t)n_pad * 4);
    keys = reinterpret_cast<unsigned long long*>(row + (size_t)n_pad * 8);
  } else {
    keys = reinterpret_cast<unsigned long long*>(rest);
    cbits = reinterpret_cast<uint32_t*>(rest + (size_t)n_keys * 8);
    cz = cbits + bins;
  }
  for (int d = tid; d < RADIX; d += T) hist[0][d] = 0u;
  if (k > RANK_SORT_MAX)
    for (int r = k + tid; r < n_keys; r += T) keys[r] = 0ull;  // the sort's padding: below every cell
  // rows of 16-byte multiples on 16-byte addresses go by TMA, else by 4-byte `cp.async`
  const bool bulk = reinterpret_cast<uintptr_t>(part_s) % 16 == 0 && bins % 4 == 0;
  if (tid == 0 && bulk) {
    mbar_init(&staged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 1. fold: `tile` cells and `planes` splits at a time are copied to shared
  // memory, then each thread folds its cells over them in split order
  const size_t plane = (size_t)B * bins;
  const S* ps = part_s + (size_t)b * bins;
  uint32_t hi = 0u, lo = 0xFFFFFFFFu;  // this thread's cells' largest and smallest order bits
  uint32_t phase = 0u;
  for (int c0 = 0; c0 < bins; c0 += tile) {
    const int n = min(tile, bins - c0);
    for (int z0 = 0; z0 < splits; z0 += planes) {
      const int nz = min(planes, splits - z0);
      if (bulk) {
        if (tid == 0) {
          mbar_expect_tx(&staged, static_cast<uint32_t>(nz * n * 4));
          for (int z = 0; z < nz; ++z) bulk_load(stage + z * n, ps + (size_t)(z0 + z) * plane + c0, n * 4, &staged);
        }
        mbar_wait(&staged, phase);
        phase ^= 1u;
      } else {
        for (int z = 0; z < nz; ++z)
          for (int i = tid; i < n; i += T) cp_async4(stage + z * n + i, ps + (size_t)(z0 + z) * plane + c0 + i);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int i = tid; i < n; i += T) {
        S best = z0 == 0 ? stage[i] : reinterpret_cast<const S*>(cbits)[c0 + i];
        int zb = z0 == 0 ? 0 : static_cast<int>(cz[c0 + i]);
#pragma unroll 8
        for (int z = z0 == 0 ? 1 : 0; z < nz; ++z) {
          const S v = stage[z * n + i];
          if (v > best) { best = v; zb = z0 + z; }
        }
        cz[c0 + i] = static_cast<uint32_t>(zb);
        if (z0 + nz < splits) {
          reinterpret_cast<S*>(cbits)[c0 + i] = best;
        } else {
          const uint32_t x = order_bits(best);
          cbits[c0 + i] = x;
          hi = max(hi, x);
          lo = min(lo, x);
        }
      }
      if (z0 + nz < splits || c0 + n < bins) __syncthreads();  // the stage is filled again
    }
  }
  warp_max_min(hi, lo);
  if (lane == 0) {
    warp_hi[warp] = hi;
    warp_lo[warp] = lo;
  }
  __syncthreads();
  hi = lane < warps ? warp_hi[lane] : 0u;  // every warp reduces the warps' values
  lo = lane < warps ? warp_lo[lane] : 0xFFFFFFFFu;
  warp_max_min(hi, lo);

  // 2. radix passes, from the highest bit in which the cells differ: the
  // bits at and above `settled` are the prefix's
  const int small = k <= RANK_SORT_MAX;
  uint32_t prefix = hi;
  int settled = 0, need = k, above = 0, count = bins;
  if (hi != lo) {
    settled = 32 - __clz(hi ^ lo);
    prefix = settled > 31 ? 0u : hi & (0xFFFFFFFFu << settled);
    for (int pass = 0;; ++pass) {
      const int shift = max(0, settled - 8);
      const uint32_t smask = settled > 31 ? 0u : 0xFFFFFFFFu << settled;
      uint32_t* h = hist[pass & 1];
      for (int i0 = 0; i0 < bins; i0 += T) {  // the same trip count in every warp
        const int i = i0 + tid;
        uint32_t x = 0u;
        bool match = false;
        if (i < bins) {
          x = cbits[i];
          match = (x & smask) == prefix;
        }
        // the first matching lane adds its digit's lanes at once (ties share
        // a digit); each other lane adds itself
        const uint32_t digit = (x >> shift) & (RADIX - 1);
        const unsigned active = __ballot_sync(0xFFFFFFFFu, match);
        if (active != 0u) {
          const int first = __ffs(active) - 1;
          const uint32_t lead = __shfl_sync(0xFFFFFFFFu, digit, first);
          const unsigned same = __ballot_sync(0xFFFFFFFFu, match && digit == lead);
          if (lane == first) atomicAdd(&h[lead], static_cast<uint32_t>(__popc(same)));
          else if (match && digit != lead) atomicAdd(&h[digit], 1u);
        }
      }
      __syncthreads();
      if (warp == 0) {  // lane l: digits 255 - 8l down to 248 - 8l
        uint32_t cnt[8], sum = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += cnt[j] = h[RADIX - 1 - 8 * lane - j];
        uint32_t incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += v;
        }
        const uint32_t excl = incl - sum, want = static_cast<uint32_t>(need);
        if (excl < want && want <= incl) {  // the lane whose digits hold the k-th cell
          uint32_t up = excl, in = 0u;
          int digit = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (up + cnt[j] >= want) {
              digit = RADIX - 1 - 8 * lane - j;
              in = cnt[j];
              break;
            }
            up += cnt[j];
          }
          const int now_above = above + static_cast<int>(up), now_need = need - static_cast<int>(up);
          st.prefix = prefix | (static_cast<uint32_t>(digit) << shift);
          st.above = now_above;
          st.need = now_need;
          st.count = static_cast<int>(in);
          st.done = shift == 0 || static_cast<int>(in) == now_need ||
                    (small && now_above + static_cast<int>(in) <= RANK_SORT_MAX);
        }
        for (int d = lane; d < RADIX; d += 32) hist[(pass + 1) & 1][d] = 0u;  // the next pass's
      }
      __syncthreads();
      prefix = st.prefix;
      need = st.need;
      above = st.above;
      count = st.count;
      settled = shift;
      if (st.done) break;
    }
  }

  // 3. gather: the cells above the prefix, and those matching it (all where
  // they fit the count-ordering, else the first `need`)
  const uint32_t mask = 0xFFFFFFFFu << settled;
  const int take = small && above + count <= RANK_SORT_MAX ? count : need;
  const int m = above + take;  // candidates
  // warp w: cells [w * 32 * per, (w + 1) * 32 * per), 32 a round; counted,
  // then each warp's first rank from the counts of the warps before it
  const int per = (bins + T - 1) / T, c_warp = warp * 32 * per;
  const unsigned before = (1u << lane) - 1u;
  int up = 0, eq = 0;
  for (int r = 0; r < per; ++r) {
    const int c = c_warp + 32 * r + lane;
    const uint32_t x = c < bins ? cbits[c] & mask : 0u;
    up += __popc(__ballot_sync(0xFFFFFFFFu, c < bins && x > prefix));
    eq += __popc(__ballot_sync(0xFFFFFFFFu, c < bins && x == prefix));
  }
  if (lane == 0) {
    warp_up[warp] = up;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  const int wu = lane < warps ? warp_up[lane] : 0, we = lane < warps ? warp_eq[lane] : 0;
  int up_rank = __shfl_sync(0xFFFFFFFFu, warp_scan(wu, lane) - wu, warp);
  int eq_rank = __shfl_sync(0xFFFFFFFFu, warp_scan(we, lane) - we, warp);
  for (int r = 0; r < per; ++r) {
    const int c = c_warp + 32 * r + lane;
    const uint32_t x = c < bins ? cbits[c] : 0u;
    const bool is_up = c < bins && (x & mask) > prefix, is_eq = c < bins && (x & mask) == prefix;
    const unsigned up_bits = __ballot_sync(0xFFFFFFFFu, is_up), eq_bits = __ballot_sync(0xFFFFFFFFu, is_eq);
    const int slot = is_up ? up_rank + __popc(up_bits & before)
                           : is_eq && eq_rank + __popc(eq_bits & before) < take
                                 ? above + eq_rank + __popc(eq_bits & before) : -1;
    if (slot >= 0)
      keys[slot] = (static_cast<unsigned long long>(x) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(c));
    up_rank += __popc(up_bits);
    eq_rank += __popc(eq_bits);
  }
  __syncthreads();

  // 4. each key's place in the output; a winner's own score and id are read
  // from its winning split
  auto source = [&](unsigned long long key) {  // a key's cell, at its winning split
    const int c = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    return (size_t)cz[c] * plane + (size_t)b * bins + c;
  };
  auto emit = [&](int place, S s, int id) {
    out_s[(size_t)b * k + place] = s;
    out_i[(size_t)b * k + place] = no_id(s) ? -1 : id;
  };
  if (small) {
    // a key's place: the keys above it (no two keys tie), counted by `share`
    // neighbouring lanes a key, four keys a step; only the k winners' scores
    // and ids are read, and places past k go nowhere
    int share = 1;
    while (share < 32 && 2 * share * m <= T) share <<= 1;
    for (int r0 = 0; r0 < m; r0 += T / share) {  // the same trip count in every warp
      const int r = r0 + tid / share;
      const unsigned long long key = r < m ? keys[r] : 0ull;
      int place = 0, j = tid % share;
      if (r < m) {
        for (; j + 3 * share < m; j += 4 * share) {
          const unsigned long long k0 = keys[j], k1 = keys[j + share], k2 = keys[j + 2 * share],
                                   k3 = keys[j + 3 * share];
          place += (k0 > key ? 1 : 0) + (k1 > key ? 1 : 0) + (k2 > key ? 1 : 0) + (k3 > key ? 1 : 0);
        }
        for (; j < m; j += share) place += keys[j] > key ? 1 : 0;
      }
      for (int o = share / 2; o > 0; o >>= 1) place += __shfl_xor_sync(0xFFFFFFFFu, place, o);
      if (r < m && tid % share == 0 && place < k) {
        const size_t o = source(key);
        emit(place, part_s[o], part_i[o]);
      }
    }
  } else {
    // bitonic sort of the n_keys (k padded) keys, descending: pair
    // (i, i + stride) runs descending where (i & size) == 0, so the last
    // merge is descending throughout. Thread t handles pairs t, t + T, ...,
    // so a stage of stride <= 32 stays inside each warp's 64 keys and needs
    // only the warp's barrier, unless the stage before it crossed warps.
    bool wide = true;
    for (int size = 2; size <= n_keys; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (wide || stride > 32) __syncthreads(); else __syncwarp();
        wide = stride > 32;
        for (int t = tid; t < n_keys / 2; t += T) {
          const int i = 2 * t - (t & (stride - 1));
          const unsigned long long lo_key = keys[i], hi_key = keys[i + stride];
          if ((lo_key < hi_key) == ((i & size) == 0)) { keys[i] = hi_key; keys[i + stride] = lo_key; }
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < k; r += T) {
      const size_t o = source(keys[r]);
      emit(r, part_s[o], part_i[o]);
    }
  }
}

template <typename S, bool GLOBAL> struct SelectTag {};

// The select kernel on `stream`: partials [splits, B, bins] in, [B, k] out.
// `ws` holds B * n_pad cells of 16 bytes where n_pad (bins padded to a power
// of two) exceeds SELECT_SMEM_CELLS, and may be null otherwise.
template <typename S>
cudaError_t launch_select(const void* part_s, const void* part_i, void* out_s, void* out_i, void* ws, int B,
                          int bins, int splits, int k, cudaStream_t stream) {
  if (B < 1 || bins < 1 || bins > (1 << 30) || splits < 1 || k < 1 || k > bins) return cudaErrorInvalidValue;
  int n_pad = 1, kpad = 1;
  while (n_pad < bins) n_pad <<= 1;
  while (kpad < k) kpad <<= 1;
  const int n_keys = k <= RANK_SORT_MAX ? RANK_SORT_MAX : kpad;  // candidates' room
  const int threads = min(SELECT_THREADS, (bins + 31) / 32 * 32);  // a thread a cell, rounded up to warps
  // the fold's stage: `tile` cells of `planes` splits
  const int tile = min(bins, SELECT_SMEM_CELLS);
  const int planes = max(1, min(splits, SELECT_STAGE_BYTES / (tile * 4)));
  size_t dyn = ((size_t)planes * tile * 4 + 15) / 16 * 16;
  if (n_pad > SELECT_SMEM_CELLS) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = allow_max_smem<SelectTag<S, true>>(select_kernel<S, true>);
    if (err != cudaSuccess) return err;
    select_kernel<S, true><<<B, threads, dyn, stream>>>(
        static_cast<const S*>(part_s), static_cast<const int*>(part_i), static_cast<S*>(out_s),
        static_cast<int*>(out_i), static_cast<unsigned char*>(ws), B, bins, splits, k, tile, planes, n_keys, n_pad);
  } else {
    dyn += (size_t)n_keys * 8 + (size_t)bins * 8;
    const cudaError_t err = allow_max_smem<SelectTag<S, false>>(select_kernel<S, false>);
    if (err != cudaSuccess) return err;
    select_kernel<S, false><<<B, threads, dyn, stream>>>(
        static_cast<const S*>(part_s), static_cast<const int*>(part_i), static_cast<S*>(out_s),
        static_cast<int*>(out_i), nullptr, B, bins, splits, k, tile, planes, n_keys, n_pad);
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

// The float CUDA-core body's shared memory (56.75 KB) exceeds the 48 KB a
// block gets by default: opt in once per card (sm90.cuh).
template <typename T, bool ALIGNED> struct FloatTag {};
template <typename T, bool ALIGNED>
cudaError_t allow_float() { return allow_max_smem<FloatTag<T, ALIGNED>>(binned_float_kernel<T, ALIGNED>); }

// The float CUDA-core body, rows on the 16-byte grid or not (both pointers
// and the row pitch).
template <typename T>
cudaError_t launch_float(const void* q, const void* v, void* part_s, void* part_i, int B, int D, int bins,
                         int n_real, int per_split, int n_strides, const dim3& grid, cudaStream_t stream) {
  const bool aligned = simt::on_grid(q, v, D * sizeof(T));
  const cudaError_t err = aligned ? allow_float<T, true>() : allow_float<T, false>();
  if (err != cudaSuccess) return err;
  auto kernel = aligned ? binned_float_kernel<T, true> : binned_float_kernel<T, false>;
  kernel<<<grid, simt::CORE_THREADS, FLOAT_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<float*>(part_s), static_cast<int*>(part_i),
      B, D, bins, n_real, per_split, n_strides);
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
  if (body == 0 && dtype == 0 && (err = allow_float<float, false>()) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<float, false>,
                                                        simt::CORE_THREADS, FLOAT_SMEM);
  if (body == 0 && dtype == 1 && (err = allow_float<__nv_bfloat16, false>()) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<__nv_bfloat16, false>,
                                                        simt::CORE_THREADS, FLOAT_SMEM);
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
// sort_ws the select kernel's workspace (B * n_pad cells of 16 bytes, or
// null where n_pad fits in shared memory). The caller makes the card that
// holds the tensors current; `stream_ptr` is PyTorch's current stream there.
// Returns the CUDA error code of the launches (0 = success).
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
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    err = launch_float<float>(q, v, part_s, part_i, B, D, bins, n_real, per_split, n_strides, grid, stream);
  } else if (dtype == 1) {
    err = launch_float<__nv_bfloat16>(q, v, part_s, part_i, B, D, bins, n_real, per_split, n_strides, grid, stream);
  } else if (dtype == 2) {
    binned_int8_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
        static_cast<int*>(part_s), static_cast<int*>(part_i),
        B, D, bins, n_real, per_split, n_strides);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return then_select(err, dtype, part_s, part_i, out_s, out_i, sort_ws, B, bins, splits, k, stream);
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
