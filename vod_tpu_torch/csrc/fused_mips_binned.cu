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
//     call: a block owns 64 queries x 64 bins and walks its strides. The name
//     means "off the `wgmma` rule" (the body rule and its tests use it); for
//     int8 the body runs on the tensor cores through `mma.sync`. The float
//     body runs the product core of `sm90.cuh` (namespace `simt`: 4 warps
//     multiply, 8 x 4 sums a thread, while 4 stage k-slices of rows at any
//     alignment through a ring in shared memory) and each multiplying thread
//     folds its sums into its own running cells in shared memory; the int8
//     body (any D, rows at any byte offset) stages realigned k-slices through
//     a ring in shared memory and sums with `mma.sync` m16n8k32 (s8 in, s32
//     accumulate) on 4 warps, 32 x 32 cells each, its running (score, id)
//     cells in registers (design at the kernel).
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

// int8 path: int8 x int8 products summed exactly in int32 on the tensor
// cores through `mma.sync` m16n8k32 (s8 in, s32 accumulate), for rows of any
// D at any byte offset (the calls off the `wgmma` rule). What bounds it on
// the H100: the corpus read (N * D bytes) at B <= 64, the 2 * B * N * D
// operations at B = 2048. The design:
//   * Two roles, as in the float body's product core: 4 multiplying warps
//     (threads 0-127), each 32 queries x 32 bins of the block's 64 x 64 (8
//     `mma.sync` a 32-byte k step, their fragments read by `ldmatrix` from
//     rows padded to 16 x odd bytes, so that the 8 rows of a matrix fall in
//     8 different bank groups), and 4 staging warps (threads 128-255) that
//     load, realign and store k-slices of KS = 128 bytes through a ring of
//     NST slices in shared memory, on named barriers.
//   * Staging at any byte offset, without byte loads: a thread reads the
//     aligned 16-byte word that holds its chunk's first byte (and, off the
//     grid, the next one), realigns it in registers (`simt::realign`) and
//     zeroes the bytes at or past D; 8 lanes cover a row's 128 bytes, so a
//     warp's loads are 4 rows' whole slices.
//   * The query tile: where it and the ring fit in half the SM's shared
//     memory (2 blocks an SM; D <= 1,152 on an H100), it is staged once and
//     stays resident (QRES), the ring carries the corpus rows alone, and a
//     staging thread issues the next slice's loads before it stores the
//     current one; above, each slice carries the 64 queries and the 64 rows
//     (which, forced at D = 768 with rows 4 bytes off and 512 bins, took
//     1.34x as long at B = 64 and 1.46x at B = 2048 on an H100).
//     What sets the pace (PERF.md §6): not the products (the call
//     took as long with them left out), but the ring itself, a handoff of
//     a few hundred instructions a slice on named barriers among 4 warps a
//     sub-partition, which without loads, realignment or products still
//     took about half the call, and the loads' latency. A third slice in
//     flight, a 6-slice ring and an L2 prefetch of the next stride changed
//     little; working a row's address out once a stride, not once a slice,
//     took B = 2048 from 14.2 to 12.3 ms.
//   * The fold: accumulator fragment (m, n, c) of a thread is the same
//     (query, bin) cell at every stride, so after each stride the thread
//     folds its 32 sums into running cells in registers with a strict `>`
//     (rows at or past n_real and bins past `bins` masked), keeping the
//     winning stride. Sums are exact int32 up to D of about 133,000.
namespace i8 {
constexpr int KS = 128;           // bytes of K a slice: 4 k steps of 32
constexpr int PITCH = KS + 16;    // bytes between a slice's staged rows (16 x odd)
constexpr int NST = 4;            // slices in the ring
constexpr int MMA_THREADS = 128;  // the multiplying warps; the staging warps follow
constexpr int THREADS = 256;
// named barriers: slot s of the ring is full at BAR_FULL + s and empty at
// BAR_EMPTY + s; the resident query tile is staged at BAR_QUERIES
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + NST, BAR_QUERIES = BAR_EMPTY + NST;
static_assert(BAR_QUERIES < 16, "16 named barriers");

__host__ __device__ constexpr int slices_of(int D) { return (D + KS - 1) / KS; }
// bytes between the resident query tile's rows (16 x odd, like PITCH)
__host__ __device__ constexpr int qpitch(int D) { return slices_of(D) * KS + 16; }
// rows of a ring slot: the corpus rows, or (not QRES) the queries, then the rows
template <bool QRES>
__host__ __device__ constexpr int slot_rows() { return QRES ? BT : QT + BT; }
template <bool QRES>
size_t smem_bytes(int D) { return (QRES ? (size_t)QT * qpitch(D) : 0) + (size_t)NST * slot_rows<QRES>() * PITCH; }

// The aligned words that cover chunk c (bytes k0 + 16 c .. + 15) of the row
// that starts at `row` (null: not a real row, zeros): the word that holds
// the chunk's first byte and, off the grid, the next one. A word is read
// only if it holds a byte of the row.
struct Words {
  uint4 lo, hi;
};

__device__ __forceinline__ Words load_words(const int8_t* row, int D, int k0, int c) {
  Words w;
  w.lo = make_uint4(0u, 0u, 0u, 0u);
  w.hi = w.lo;
  if (row == nullptr) return w;
  const uintptr_t start = reinterpret_cast<uintptr_t>(row), end = start + static_cast<uintptr_t>(D);
  const uintptr_t a = ((start + static_cast<uintptr_t>(k0)) & ~static_cast<uintptr_t>(15)) + 16u * c;
  if (a < end) w.lo = __ldg(reinterpret_cast<const uint4*>(a));
  if ((start & 15) != 0 && a + 16 < end) w.hi = __ldg(reinterpret_cast<const uint4*>(a + 16));
  return w;
}

// The chunk realigned, its bytes at or past D zeroed, stored at dst.
__device__ __forceinline__ void store_chunk(const Words& w, const int8_t* row, int D, int k0, int c,
                                            unsigned char* dst) {
  uint32_t r[4];
  simt::realign(w.lo, w.hi, static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15), r);
  const int valid = D - k0 - 16 * c;  // bytes of the chunk below D
  if (valid < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int keep = valid - 4 * j;  // bytes of word j below D
      r[j] = keep >= 4 ? r[j] : keep <= 0 ? 0u : r[j] & ((1u << (8 * keep)) - 1u);
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d[16 x 8] += a[16 x 32] b[8 x 32]^T, s8 in, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The staging warps: thread st = threadIdx.x - MMA_THREADS stages chunk
// c = st % 8 of R rows of every slice, rows first + 4 i (i < R), first =
// 4 R (st / 32) + (st % 32) / 8: 8 lanes cover a row's slice. A row's
// address is worked out once a stride. QRES: the query tile is staged once,
// then the ring takes the corpus rows, the next slice's loads in flight
// while the current one is stored; else each slice takes the queries and
// the rows, loaded and stored in turn.
template <bool QRES>
__device__ __forceinline__ void stage(const int8_t* q, const int8_t* v, unsigned char* qtile, unsigned char* ring,
                                      int B, int D, int bins, int n_real, int q0, int bin0, int r_begin,
                                      int strides) {
  constexpr int R = slot_rows<QRES>() / 16;  // 4 or 8
  const int st = threadIdx.x - MMA_THREADS, c = st % 8;
  const int first = 4 * R * (st / 32) + (st % 32) / 8;
  const int slices = slices_of(D), total = strides * slices;
  auto query = [&](int i) -> const int8_t* { return q0 + i < B ? q + (size_t)(q0 + i) * D : nullptr; };
  // this thread's rows of the ring slots at stride r (null: not real)
  auto rows_at = [&](int r, const int8_t* (&rows)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = first + 4 * i;
      if (!QRES && row < QT) {
        rows[i] = query(row);
      } else {
        const int b = row - (QRES ? 0 : QT);
        const long long j = (long long)r * bins + bin0 + b;
        rows[i] = bin0 + b < bins && j < n_real ? v + (size_t)j * D : nullptr;
      }
    }
  };
  auto load = [&](const int8_t* const(&rows)[R], int k0, Words(&w)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = load_words(rows[i], D, k0, c);
  };
  auto put = [&](int p, const int8_t* const(&rows)[R], int k0, const Words(&w)[R]) {
    const int slot = p % NST;
    if (p >= NST) simt::bar_sync_id(BAR_EMPTY + slot, THREADS);
    unsigned char* base = ring + (size_t)slot * slot_rows<QRES>() * PITCH + 16 * c;
#pragma unroll
    for (int i = 0; i < R; ++i) store_chunk(w[i], rows[i], D, k0, c, base + (first + 4 * i) * PITCH);
    simt::bar_arrive_id(BAR_FULL + slot, THREADS);
  };
  const int8_t *ra[R], *rb[R];  // the rows of the current stride, and of the next
  if constexpr (QRES) {
#pragma unroll
    for (int i = 0; i < R; ++i) ra[i] = query(first + 4 * i);
    for (int s = 0; s < slices; ++s) {
      Words w[R];
      load(ra, s * KS, w);
#pragma unroll
      for (int i = 0; i < R; ++i)
        store_chunk(w[i], ra[i], D, s * KS, c, qtile + (size_t)(first + 4 * i) * qpitch(D) + s * KS + 16 * c);
    }
    simt::bar_arrive_id(BAR_QUERIES, THREADS);
    Words w0[R], w1[R];
    if (total > 0) {
      rows_at(r_begin, ra);
      load(ra, 0, w0);
    }
    for (int p = 0, s = 0, r = r_begin; p < total; ++p) {
      const bool last = s + 1 == slices;  // the stride's last slice
      if (p + 1 < total) {
        if (last) {
          rows_at(r + 1, rb);
          load(rb, 0, w1);
        } else {
          load(ra, (s + 1) * KS, w1);
        }
      }
      put(p, ra, s * KS, w0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        w0[i] = w1[i];
        if (last) ra[i] = rb[i];
      }
      s = last ? 0 : s + 1;
      r += last ? 1 : 0;
    }
  } else {
    for (int r = r_begin, p = 0; r < r_begin + strides; ++r) {
      rows_at(r, ra);
      for (int s = 0; s < slices; ++s, ++p) {
        Words w[R];
        load(ra, s * KS, w);
        put(p, ra, s * KS, w);
      }
    }
  }
}
}  // namespace i8

// Block (bin tile x, query tile y, split z) walks the strides of its split
// in increasing order; see the int8 path above.
template <bool QRES>
__global__ void __launch_bounds__(i8::THREADS, 2)
binned_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ v,
                   int* __restrict__ out_s, int* __restrict__ out_i,
                   int B, int D, int bins, int n_real, int strides_per_split, int n_strides) {
  using namespace i8;
  extern __shared__ __align__(16) unsigned char smem_i8[];
  unsigned char* qtile = smem_i8;                                      // [QT][qpitch(D)] (QRES)
  unsigned char* ring = smem_i8 + (QRES ? (size_t)QT * qpitch(D) : 0);  // [NST][slot_rows][PITCH]
  const int bin0 = blockIdx.x * BT, q0 = blockIdx.y * QT;
  const int r_begin = blockIdx.z * strides_per_split;
  const int strides = max(0, min(n_strides, r_begin + strides_per_split) - r_begin);
  if (threadIdx.x >= MMA_THREADS) {
    stage<QRES>(q, v, qtile, ring, B, D, bins, n_real, q0, bin0, r_begin, strides);
    return;  // no block-wide barrier follows
  }

  // warp w: queries mq .. mq + 31, bins nb .. nb + 31 of the tile; fragment
  // (m, n, c) of lane (g = lane / 4, t = lane % 4): query mq + 16 m + g +
  // 8 (c / 2), bin nb + 8 n + 2 t + c % 2
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int mq = 32 * (warp / 2), nb = 32 * (warp % 2);
  // the rows and 16-byte columns this lane names to `ldmatrix`: matrices
  // (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) of an
  // m-tile give its a0-a3; (rows 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15),
  // (8-15, 16-31) of two n-tiles give their b0, b1
  const int a_row = mq + lane % 8 + 8 * ((lane / 8) % 2), a_col = 16 * (lane / 16);
  const int b_row = (QRES ? 0 : QT) + nb + lane % 8 + 8 * (lane / 16), b_col = 16 * ((lane / 8) % 2);
  const int a_pitch = QRES ? qpitch(D) : PITCH;
  int best[2][4][4], won[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) { best[m][n][c] = INT8_NEG; won[m][n][c] = -1; }
  if (QRES) simt::bar_sync_id(BAR_QUERIES, THREADS);
  const int slices = slices_of(D), total = strides * slices;
  int p = 0;
  for (int s = 0; s < strides; ++s) {
    int acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] = 0;
    for (int ks = 0; ks < slices; ++ks, ++p) {
      const int slot = p % NST;
      simt::bar_sync_id(BAR_FULL + slot, THREADS);
      const unsigned char* base = ring + (size_t)slot * slot_rows<QRES>() * PITCH;
      const unsigned char* a = (QRES ? qtile + ks * KS : base) + (size_t)a_row * a_pitch + a_col;
      const unsigned char* b = base + b_row * PITCH + b_col;
      const int steps = min(KS / 32, (D - ks * KS + 31) / 32);  // k steps holding a byte below D
#pragma unroll
      for (int kk = 0; kk < KS / 32; ++kk) {
        if (kk < steps) {
          uint32_t a0[4], a1[4], b01[4], b23[4];
          ldsm_x4(a0, a + 32 * kk);
          ldsm_x4(a1, a + 16 * a_pitch + 32 * kk);  // m-tile 1: 16 rows down
          ldsm_x4(b01, b + 32 * kk);
          ldsm_x4(b23, b + 16 * PITCH + 32 * kk);   // n-tiles 2 and 3
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_s8(acc[0][n], a0, b01[2 * n], b01[2 * n + 1]);
            mma_s8(acc[1][n], a1, b01[2 * n], b01[2 * n + 1]);
            mma_s8(acc[0][n + 2], a0, b23[2 * n], b23[2 * n + 1]);
            mma_s8(acc[1][n + 2], a1, b23[2 * n], b23[2 * n + 1]);
          }
        }
      }
      if (p + NST < total) simt::bar_arrive_id(BAR_EMPTY + slot, THREADS);
    }
    // fold the stride; rows at or past n_real and bins past `bins` never win
    const int r = r_begin + s;
    const long long row0 = (long long)r * bins + bin0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nb + 8 * n + 2 * t + c % 2;
        if (bin0 + col < bins && row0 + col < n_real) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (acc[m][n][c] > best[m][n][c]) { best[m][n][c] = acc[m][n][c]; won[m][n][c] = r; }
        }
      }
  }

  const size_t base = (size_t)blockIdx.z * B * bins;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qb = q0 + mq + 16 * m + g + 8 * (c / 2);
      if (qb >= B) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int bin = bin0 + nb + 8 * n + 2 * t + c % 2;
        if (bin >= bins) continue;
        out_s[base + (size_t)qb * bins + bin] = best[m][n][c];
        out_i[base + (size_t)qb * bins + bin] = won[m][n][c] < 0 ? -1 : won[m][n][c] * bins + bin;
      }
    }
}

// ---- selection: the splits folded and k of the cells chosen ------------------

// A cell the wrapper gives id -1: `isfinite` fails (float) or the int8 sentinel.
__device__ __forceinline__ bool no_id(float s) { return !isfinite(s); }
__device__ __forceinline__ bool no_id(int s) { return s <= INT8_NEG; }

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
//   2. radix passes over the order bits (`sm90.cuh:radix::threshold`); for
//      k <= RANK_SORT_MAX they stop once at most RANK_SORT_MAX cells lie at
//      or above the k-th cell's digit, all of which become candidates;
//   3. gather, in cell order (`radix::gather`): the cells above the prefix,
//      and those matching it (all of them, or the first `need`: lowest cell
//      first);
//   4. order the candidates' keys (k <= RANK_SORT_MAX: each key's place is
//      the count of keys above it, `radix::rank`, and places past k go
//      nowhere; else a bitonic sort of k keys padded to a power of two) and
//      write each winner's own score and id, read from its winning split.
template <typename S, bool GLOBAL>
__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const S* __restrict__ part_s, const int* __restrict__ part_i, S* __restrict__ out_s,
              int* __restrict__ out_i, unsigned char* __restrict__ ws, int B, int bins, int splits, int k, int tile,
              int planes, int n_keys, int n_pad) {
  extern __shared__ __align__(16) unsigned char smem_sel[];
  __shared__ radix::Scratch rs;
  __shared__ uint64_t staged;  // the stage's mbarrier (TMA copies)
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
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
  for (int d = tid; d < radix::RADIX; d += T) rs.hist[0][d] = 0u;
  if (k > radix::RANK_SORT_MAX)
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
          for (int i = tid; i < n; i += T) radix::cp_async4(stage + z * n + i, ps + (size_t)(z0 + z) * plane + c0 + i);
        radix::cp_async_wait_all();
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
          const uint32_t x = radix::order_bits(best);
          cbits[c0 + i] = x;
          hi = max(hi, x);
          lo = min(lo, x);
        }
      }
      if (z0 + nz < splits || c0 + n < bins) __syncthreads();  // the stage is filled again
    }
  }
  radix::block_max_min(hi, lo, rs);

  // 2.-3. the threshold, then the candidates in cell order
  const int small = k <= radix::RANK_SORT_MAX;
  const int rank_max = small ? radix::RANK_SORT_MAX : 0;
  auto bits = [cbits](int i) { return cbits[i]; };
  const radix::Threshold t = radix::threshold(bits, bins, k, hi, lo, bins, rank_max, rs);
  const int m = radix::gather(bits, bins, t, rank_max, keys, rs);

  // 4. each key's place in the output; a winner's own score and id are read
  // from its winning split
  auto emit = [&](int place, unsigned long long key) {
    const int c = radix::cell_of(key);
    const size_t o = (size_t)cz[c] * plane + (size_t)b * bins + c;
    const S s = part_s[o];
    out_s[(size_t)b * k + place] = s;
    out_i[(size_t)b * k + place] = no_id(s) ? -1 : part_i[o];
  };
  if (small) {
    radix::rank(keys, m, k, emit);
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
        for (int t2 = tid; t2 < n_keys / 2; t2 += T) {
          const int i = 2 * t2 - (t2 & (stride - 1));
          const unsigned long long lo_key = keys[i], hi_key = keys[i + stride];
          if ((lo_key < hi_key) == ((i & size) == 0)) { keys[i] = hi_key; keys[i + stride] = lo_key; }
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < k; r += T) emit(r, keys[r]);
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
  const int n_keys = k <= radix::RANK_SORT_MAX ? radix::RANK_SORT_MAX : kpad;  // candidates' room
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
template <bool QRES> struct Int8Tag {};

// The int8 CUDA-core body's variant at this D (the query tile resident where
// it and the ring fit in half the card's per-block opt-in, so that 2 blocks
// share an SM: D <= 1,152 on an H100) and its dynamic shared memory, the
// variant's opt-in set once per card (sm90.cuh).
cudaError_t allow_int8(int D, bool* qres, size_t* dyn) {
  if (D < 0) return cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = optin_smem(&limit);
  if (err != cudaSuccess) return err;
  *qres = i8::smem_bytes<true>(D) <= (size_t)limit / 2;
  *dyn = *qres ? i8::smem_bytes<true>(D) : i8::smem_bytes<false>(D);
  return *qres ? allow_max_smem<Int8Tag<true>>(binned_int8_kernel<true>)
               : allow_max_smem<Int8Tag<false>>(binned_int8_kernel<false>);
}

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
  bool qres = false;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && dtype == 0 && (err = allow_float<float, false>()) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<float, false>,
                                                        simt::CORE_THREADS, FLOAT_SMEM);
  if (body == 0 && dtype == 1 && (err = allow_float<__nv_bfloat16, false>()) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, binned_float_kernel<__nv_bfloat16, false>,
                                                        simt::CORE_THREADS, FLOAT_SMEM);
  if (body == 0 && dtype == 2 && (err = allow_int8(D, &qres, &dyn)) == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, qres ? binned_int8_kernel<true> : binned_int8_kernel<false>, i8::THREADS, dyn);
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
    bool qres;
    size_t dyn;
    if ((err = allow_int8(D, &qres, &dyn)) == cudaSuccess) {
      auto kernel = qres ? binned_int8_kernel<true> : binned_int8_kernel<false>;
      kernel<<<grid, i8::THREADS, dyn, stream>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
          static_cast<int*>(part_s), static_cast<int*>(part_i),
          B, D, bins, n_real, per_split, n_strides);
      err = cudaGetLastError();
    }
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
