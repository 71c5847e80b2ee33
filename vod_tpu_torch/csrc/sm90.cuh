// sm90.cuh: the Hopper (sm_90a) pieces that both MIPS kernels' tensor-core
// bodies build on: shared-memory addresses, `mbarrier`s, TMA loads of
// 128-byte-swizzled boxes, `wgmma` descriptors and instructions, the host
// lookup of the driver's tensor-map encoder, and the host's once-per-card
// set-up (the shared-memory opt-in of a kernel); then the product core of
// both kernels' CUDA-core bodies (namespace `simt`); and, at its end, the
// block-wide selection both kernels' selections share (namespace `radix`).
//
// Included by `fused_mips_topk.cu` and `fused_mips_binned.cu`, each built into
// its own library; `ops/cuda_build.py` hashes this header into the build key
// of every source that includes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One arrival on `bar` (initialised with a count of 1: completes its phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A load that
// never lands (a bad tensor map) traps after about ten seconds instead of
// hanging the card; the launch then reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// `bytes` contiguous bytes of device memory into shared memory by the TMA
// unit, completing them on `bar`; both addresses and `bytes` multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One box of a 2-D tensor map at element coordinates (col, row) into shared
// memory, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// `wgmma` descriptor of a K-major operand in a 128-byte-swizzled box (rows of
// 128 bytes, 8-row groups 1024 bytes apart, box 1024-byte aligned). Advancing
// along K inside the box adds bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4)   // start address, 16-byte units
         | (1ull << 16)            // leading byte offset (unused by swizzled K-major)
         | ((1024ull >> 4) << 32)  // stride byte offset: to the next 8-row group
         | (1ull << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, both K-major bf16 in shared
// memory, f32 accumulate. scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 32] * B[128 x 32]^T, both K-major int8 in shared
// memory, summed exactly in int32. scale_d == 0 overwrites d. The 8-bit forms
// take no transpose or negation operands.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime: no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major [rows, cols] array of `elem_bytes`-byte elements
// in boxes of `box_rows` rows x 128 bytes, 128-byte swizzle (the layout
// `sw128_desc` names); reads outside the array give zeros. Rows must be
// 16-byte strided and the pointer 16-byte aligned.
inline cudaError_t sw128_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr, int rows,
                             int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Set-up done once per card: the first call from the current card runs
// `setup(card)` under a lock, and every later call from that card returns its
// result without calling the runtime again (but for `cudaGetDevice`, a read of
// the thread's state). Each `Tag` type has a table of its own. The wrappers
// call from several host threads at once (a server's).
template <typename Tag, typename F>
cudaError_t once_per_card(F setup) {
  constexpr int MAX_CARDS = 64;
  static std::mutex mu;
  static bool done[MAX_CARDS];
  static cudaError_t result[MAX_CARDS];
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card < 0 || card >= MAX_CARDS) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[card]) {
    result[card] = setup(card);
    done[card] = true;
  }
  return result[card];
}

// Make the current card's primary context current in the calling host thread
// (`cudaSetDevice`), once per thread and card. A thread that never set a
// device (a server's handler) has the card's index but no context of its own:
// there, on an H100 with CUDA 12.8, a launch after the once-per-card set-up
// below failed with "invalid argument". Every entry that launches calls it.
inline cudaError_t bind_thread() {
  thread_local int bound = -1;
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess || card == bound) return err;
  err = cudaSetDevice(card);
  if (err == cudaSuccess) bound = card;
  return err;
}

struct OptinTag {};

// The current card's opt-in shared memory per block (227 KB on an H100), read
// once per card.
inline cudaError_t optin_smem(int* limit) {
  static int limits[64];
  const cudaError_t err = once_per_card<OptinTag>([](int card) {
    return cudaDeviceGetAttribute(&limits[card], cudaDevAttrMaxSharedMemoryPerBlockOptin, card);
  });
  int card = 0;
  if (err == cudaSuccess && cudaGetDevice(&card) == cudaSuccess) *limit = limits[card];
  return err;
}

struct SmsTag {};

// The current card's SMs, read once per card.
inline cudaError_t sm_count(int* sms) {
  static int counts[64];
  const cudaError_t err = once_per_card<SmsTag>([](int card) {
    return cudaDeviceGetAttribute(&counts[card], cudaDevAttrMultiProcessorCount, card);
  });
  int card = 0;
  if (err == cudaSuccess && cudaGetDevice(&card) == cudaSuccess) *sms = counts[card];
  return err;
}

// Let `kernel` take, on the current card, as much dynamic shared memory as
// the card allows beside its static shared memory: once per card and `Tag`
// (one tag per kernel). Each launch then asks for what it needs.
template <typename Tag, typename K>
cudaError_t allow_max_smem(K* kernel) {
  return once_per_card<Tag>([kernel](int card) {
    int limit = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, card);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit - static_cast<int>(attr.sharedSizeBytes));
    return err;
  });
}

}  // namespace sm90

// ---- the CUDA-core product core (namespace simt), which both MIPS kernels'
// "fma" bodies build on (`topk_float_kernel` in fused_mips_topk.cu,
// `binned_float_kernel` in fused_mips_binned.cu). It computes tiles of 64
// queries x 64 corpus rows of f32 sums q . v into registers, from f32 or
// bf16 operands; each kernel keeps its own epilogue.
//
// What bounds it on the H100: 64 * 64 * D FMAs a tile, in f32 (no TF32: the
// fma bodies take every f32 call, whose contract is full f32). An SM issues
// one warp instruction a clock on each of its four sub-partitions, so every
// instruction that is not an FMA takes an FMA's slot, and a warp that waits
// on memory issues nothing. The design:
//   * Two roles. Four multiplying warps (threads 0-127) only read shared
//     memory and multiply; four staging warps (threads 128-255) only load,
//     realign, widen and store. They meet on a ring of NST = 3 slices in
//     shared memory, each slice with a "full" and an "empty" named barrier,
//     so the staging warps run up to two slices ahead and memory latency
//     stalls only them. (Staging inside the multiplying warps, one slice
//     ahead, was slower at every fma shape, PERF.md §6: the loads came back
//     late, and the realignment, which the compiler schedules early to free
//     registers, waited on them.)
//   * Registers. Each multiplying thread owns a micro-tile of 8 queries x 4
//     rows (32 sums). A k step reads its operands from k-major shared tiles
//     as three 16-byte vectors, 12 floats for 32 FMAs. Lane l of warp w
//     takes queries 4 (l % 8) + {0..3} and 32 + 4 (l % 8) + {0..3}, rows
//     4 (4 w + l / 8) + {0..3}: a warp's query vectors are 8 neighbours (128
//     bytes) and its row vectors 4 (64 bytes, each shared by 8 lanes), so
//     each load is one shared-memory wavefront. 8 x 8 would read 16 floats
//     for 64 FMAs, but double the sums' registers, which hold the block to
//     fewer warps an SM.
//   * Slices. K goes in slices of KT = 16 elements, 128 rows a slice (the
//     tile's 64 queries, then its 64 corpus rows). A row's span of a slice is
//     CH 16-byte chunks (4 for f32, 2 for bf16), and each staging thread
//     stages one chunk of CH consecutive rows: a warp's loads cover whole
//     spans of 8 or 16 rows (one row a lane would touch 32 cache lines a
//     load). It widens the chunks to f32 and stores them transposed
//     (k-major) as vectors across its rows (16 bytes f32, 8 bytes bf16). The
//     ring holds f32, not bf16: widening at staging costs one conversion per
//     staged element, widening at use one per element per reading thread, 8
//     times as many on the FMAs' issue slots.
//   * Any alignment, without element-wise loads. A chunk is read as the
//     aligned 16-byte word that holds its first byte, and the next one where
//     the row is off the grid, and realigned in registers (the whole-word
//     part of the shift by selects, the rest by `__funnelshift_r`): rows 2
//     bytes off the grid, or D % 8 != 0 with a different offset on each row.
//     A word is read only if it holds a byte of the row; elements at or past
//     D are zeros. Where every row is on the grid (the kernels' ALIGNED
//     variant, chosen on the host) a chunk is one word, nothing is realigned,
//     and the staging warps keep two slices' loads in flight.
//   * Masking. The kernel says how many of a staging thread's rows are real
//     (a query below B; a corpus row below n_real, at a bin below the bins):
//     the others are zeros, and the kernel's epilogue masks their sums.

namespace simt {

constexpr int TILE = 64;       // queries, and corpus rows or bins, of a tile
constexpr int THREADS = 128;   // multiplying threads: the block's first 128
constexpr int STAGERS = 128;   // staging threads: the next 128
constexpr int CORE_THREADS = THREADS + STAGERS;
constexpr int MQ = 8;          // queries of a thread's micro-tile
constexpr int MR = 4;          // rows of a thread's micro-tile
constexpr int KT = 16;         // elements of K a slice
constexpr int NST = 3;         // slices in the ring
// Named barriers: slice s of the ring is full (staged) at BAR_FULL + s and
// empty (multiplied) at BAR_EMPTY + s. A kernel's own barriers take IDs from
// BAR_FREE up (0 is __syncthreads').
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + NST, BAR_FREE = BAR_EMPTY + NST;

// A row's span of one slice: KT elements in CH chunks of 16 bytes.
template <typename T>
struct Span {
  static constexpr int CH = KT * static_cast<int>(sizeof(T)) / 16;  // 4 (f32) or 2 (bf16)
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));      // elements of a chunk: 4 or 8
};

// Staging thread `st` (0-127) stages chunk st % CH of the CH consecutive
// rows from first_staged_row(st) (of the tile's 128: queries, then corpus
// rows), so that a quarter-warp's loads fall in two rows' spans.
template <typename T>
__device__ __forceinline__ int first_staged_row(int st) { return Span<T>::CH * (st / Span<T>::CH); }

// Offset (floats) of row k of an operand's k-major tile: 64 floats a k row,
// and 2 EPC more after each EPC rows. A quarter-warp's 16-byte stores (f32)
// write the 4 chunks of 2 row groups, k rows EPC apart, at the same columns;
// the padding puts them in different banks (a half-warp's 8-byte stores,
// bf16, likewise). The loads of a k step read one k row and pay nothing.
template <typename T>
__host__ __device__ constexpr int k_row(int k) { return k * TILE + (k / Span<T>::EPC) * 2 * Span<T>::EPC; }
constexpr int OPERAND_FLOATS = KT * TILE + 2 * KT;  // k_row(KT) for either type
constexpr int SLICE_FLOATS = 2 * OPERAND_FLOATS;    // a slice of the ring: queries, then rows
constexpr int STAGE_FLOATS = NST * SLICE_FLOATS;    // the ring: 24.75 KB

__device__ __forceinline__ void bar_sync_id(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive_id(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Whether every row of q and v starts on the 16-byte grid: both pointers and
// the row pitch are multiples of 16 bytes (a kernel then takes its ALIGNED
// variant).
inline bool on_grid(const void* q, const void* v, size_t pitch) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(v) | pitch) & 15) == 0;
}

// Where a staging thread's chunks lie: chunk c of row i at slice k0 starts at
// byte base + i * pitch + k0 * sizeof(T); the first `live` rows are real;
// `shifts` holds each row's offset from the 16-byte grid (4 bits a row),
// which no slice changes (a slice is a multiple of 16 bytes).
struct Rows {
  uintptr_t base, pitch;
  int live, shifts;
};

template <typename T>
__device__ __forceinline__ Rows rows_of(const T* first, int live, int D, int c) {
  Rows r;
  r.base = reinterpret_cast<uintptr_t>(first) + 16 * c;
  r.pitch = static_cast<uintptr_t>(D) * sizeof(T);
  r.live = live;
  r.shifts = 0;
#pragma unroll
  for (int i = 0; i < Span<T>::CH; ++i) r.shifts |= static_cast<int>((r.base + i * r.pitch) & 15) << (4 * i);
  return r;
}

// The aligned words that cover a staging thread's chunk of each of its rows:
// word 0 holds the chunk's first byte, word 1 the bytes after it (zeros on
// the grid). ALIGNED: the kernel knows every row starts on the grid (both
// pointers and the row pitch multiples of 16 bytes), so word 0 is the chunk
// and there is no word 1.
template <typename T, bool ALIGNED>
struct Chunks {
  static constexpr int W = ALIGNED ? 1 : 2;
  uint4 w[Span<T>::CH][W];
};

// Load the words of slice k0 (zeros for rows that are not real). A word is
// read only if it holds a byte of its row.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_chunks(const Rows& r, int k0, int c, Chunks<T, ALIGNED>& x) {
#pragma unroll
  for (int i = 0; i < Span<T>::CH; ++i) {
#pragma unroll
    for (int w = 0; w < Chunks<T, ALIGNED>::W; ++w) x.w[i][w] = make_uint4(0u, 0u, 0u, 0u);
    if (i < r.live) {
      const uintptr_t row = r.base + i * r.pitch;  // chunk c at slice 0
      const uintptr_t end = row - 16 * c + r.pitch;
      const uintptr_t a = (row + static_cast<uintptr_t>(k0) * sizeof(T)) & ~static_cast<uintptr_t>(15);
      if (a < end) x.w[i][0] = __ldg(reinterpret_cast<const uint4*>(a));
      if constexpr (!ALIGNED) {
        if (a + 16 < end && ((r.shifts >> (4 * i)) & 15) != 0) x.w[i][1] = __ldg(reinterpret_cast<const uint4*>(a + 16));
      }
    }
  }
}

// The 16 bytes at byte offset `shift` of the 32 bytes lo:hi, as 4 words.
__device__ __forceinline__ void realign(const uint4& lo, const uint4& hi, int shift, uint32_t (&r)[4]) {
  if (shift == 0) {
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    return;
  }
  const uint32_t c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = shift >> 2, bits = (shift & 3) * 8;
  uint32_t t[7];  // c shifted by (q & 1) words
#pragma unroll
  for (int j = 0; j < 7; ++j) t[j] = (q & 1) ? c[j + 1] : c[j];
  uint32_t d[5];  // c shifted by q words
#pragma unroll
  for (int j = 0; j < 5; ++j) d[j] = (q & 2) ? t[j + 2] : t[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __funnelshift_r(d[j], d[j + 1], bits);
}

// Realign the loaded chunks, widen them to f32 and store them k-major:
// element e of the chunk, rows first .. first + CH - 1, go to
// dst[k_row(c * EPC + e) + 0 .. CH - 1] as one vector; elements at or past
// D are zeros.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void store_chunks(const Chunks<T, ALIGNED>& x, int shifts, int D, int k0, int c,
                                             float* dst) {
  constexpr int CH = Span<T>::CH, EPC = Span<T>::EPC;
  float e[CH][EPC];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    uint32_t r[4];
    if constexpr (ALIGNED) {
      r[0] = x.w[i][0].x; r[1] = x.w[i][0].y; r[2] = x.w[i][0].z; r[3] = x.w[i][0].w;
    } else {
      realign(x.w[i][0], x.w[i][1], (shifts >> (4 * i)) & 15, r);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        e[i][j] = __uint_as_float(r[j]);
      } else {  // bf16 -> f32 is a shift: the low element, then the high one
        e[i][2 * j] = __uint_as_float(r[j] << 16);
        e[i][2 * j + 1] = __uint_as_float(r[j] & 0xFFFF0000u);
      }
    }
  }
  const int valid = D - k0 - c * EPC;  // elements of the chunk below D
  if (valid < EPC) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int j = 0; j < EPC; ++j) e[i][j] = j < valid ? e[i][j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < EPC; ++j) {
    float* at = dst + k_row<T>(c * EPC + j);
    if constexpr (CH == 4) {
      *reinterpret_cast<float4*>(at) = make_float4(e[0][j], e[1][j], e[2][j], e[3][j]);
    } else {
      *reinterpret_cast<float2*>(at) = make_float2(e[0][j], e[1][j]);
    }
  }
}

// 32 FMAs per k step of one slice: a and b are the slice's k-major query and
// row tiles (k row kk at k_row(kk)).
template <typename T>
__device__ __forceinline__ void fma_slice(const float* a, const float* b, int qg, int rg, float (&acc)[MQ][MR]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k_row<T>(kk) + 4 * qg);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k_row<T>(kk) + 32 + 4 * qg);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k_row<T>(kk) + 4 * rg);
    const float av[MQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[MR] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The query of sum acc[i][.] and the row of sum acc[.][j] of multiplying
// thread `tid`, within the tile.
__device__ __forceinline__ int query_of(int tid, int i) {
  return (i < 4 ? 0 : 32) + 4 * (tid % 8) + i % 4;
}
__device__ __forceinline__ int row_of(int tid, int j) { return 4 * (4 * (tid / 32) + (tid % 32) / 8) + j; }

// The ring's position, which both roles advance in the same order: `slice`
// counts the slices staged (or multiplied) so far, `total` the slices of the
// block's whole walk (its tiles times slices a tile).
struct Ring {
  float* base;
  int slice, total;
};

__device__ __forceinline__ int slices_of(int D) { return (D + KT - 1) / KT; }

// One tile's slices into the ring, by staging thread st = threadIdx.x -
// THREADS: its CH rows start at `rows` (rows D elements apart) and the first
// `live` are real. A slice waits until the multiplying warps have emptied its
// place in the ring. On the grid (one word a chunk, nothing to realign) the
// loads of slice s + 1 are issued before slice s is stored, so that two
// slices' loads are in flight; off the grid one is (two slices' words and
// the realignment spill registers, and ran slower).
template <typename T, bool ALIGNED>
__device__ __forceinline__ void stage_tile(const T* rows, int live, int D, Ring& ring) {
  using X = Chunks<T, ALIGNED>;
  const int st = threadIdx.x - THREADS;
  const int c = st % Span<T>::CH, first = first_staged_row<T>(st);
  const Rows r = rows_of(rows, live, D, c);
  float* mine = ring.base + (first / TILE) * OPERAND_FLOATS + first % TILE;  // my rows' columns, slice 0
  const int slices = slices_of(D);
  auto put = [&](const X& x, int s) {  // slice s of the tile into the ring
    const int at = ring.slice % NST;
    if (ring.slice >= NST) bar_sync_id(BAR_EMPTY + at, CORE_THREADS);
    store_chunks(x, r.shifts, D, s * KT, c, mine + at * SLICE_FLOATS);
    bar_arrive_id(BAR_FULL + at, CORE_THREADS);
    ++ring.slice;
  };
  if constexpr (ALIGNED) {
    X x0, x1;
    load_chunks(r, 0, c, x0);
    for (int s = 0; s < slices; s += 2) {
      if (s + 1 < slices) load_chunks(r, (s + 1) * KT, c, x1);
      put(x0, s);
      if (s + 1 < slices) {
        if (s + 2 < slices) load_chunks(r, (s + 2) * KT, c, x0);
        put(x1, s + 1);
      }
    }
  } else {
    for (int s = 0; s < slices; ++s) {
      X x;
      load_chunks(r, s * KT, c, x);
      put(x, s);
    }
  }
}

// One tile of sums, by multiplying thread tid < THREADS: acc[i][j] = sum over
// k < D of q[query_of(i)][k] * v[row_of(j)][k], summed in f32 in increasing k.
template <typename T>
__device__ __forceinline__ void multiply_tile(int D, Ring& ring, float (&acc)[MQ][MR]) {
  const int tid = threadIdx.x;
  const int qg = tid % 8, rg = 4 * (tid / 32) + (tid % 32) / 8;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;
  const int slices = slices_of(D);
  for (int s = 0; s < slices; ++s, ++ring.slice) {
    const int at = ring.slice % NST;
    bar_sync_id(BAR_FULL + at, CORE_THREADS);
    const float* base = ring.base + at * SLICE_FLOATS;
    fma_slice<T>(base, base + OPERAND_FLOATS, qg, rg, acc);
    if (ring.slice + NST < ring.total) bar_arrive_id(BAR_EMPTY + at, CORE_THREADS);
  }
}

}  // namespace simt

// ---- the selection of a query's k largest cells (namespace radix), which
// both MIPS kernels' selections build on: `select_kernel`
// (`fused_mips_binned.cu`, k of a query's folded bins) and
// `merge_splits_kernel` (`fused_mips_topk.cu`, k of a query's split lists).
// One block serves one query. A cell is read through an accessor `bits(i)`
// that gives its score's order bits (`order_bits`), so a kernel keeps its
// cells where it likes: shared memory, device memory, or a list of cell
// indices into either.
//
// The steps (each called by every thread of the block, blockDim.x a multiple
// of 32; the block's barriers are inside):
//   * `threshold`: radix passes over the order bits, 8 bits a pass from the
//     highest bit in which the largest and the smallest cell differ (the
//     bits above it are common): a 256-digit histogram of the cells matching
//     the prefix (a warp's lanes on its first lane's digit add in one shared
//     atomic), and the digit that holds the k-th cell. The passes stop once
//     that digit's cells are all needed, or once the cells above it and in
//     it number at most `rank_max`, all of which become candidates;
//   * `gather`: in cell order (each warp a run of cells, ballots within it
//     and a block prefix of the runs' counts), the cells above the prefix
//     and those matching it (all of them, or the first `need`: lowest cell
//     first), as 64-bit keys: the order bits above the complemented cell
//     index, so that no two keys tie and a lower cell ranks first among
//     equal scores;
//   * `rank`: each key's place is the count of keys above it; the caller
//     emits the places below k.

namespace radix {

constexpr int RADIX = 256;          // digits of an 8-bit radix pass
constexpr int RANK_SORT_MAX = 256;  // candidates that `rank` places by counting

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

// 4 bytes from device memory to shared memory, asynchronously (no register
// holds them); `cp_async_wait_all` waits for the thread's copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(sm90::smem_addr(dst)), "l"(src) : "memory");
}
// 16 bytes, both addresses 16-byte aligned, the same way (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(sm90::smem_addr(dst)), "l"(src) : "memory");
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

// The block's shared scratch of the steps (a kernel declares one).
struct Scratch {
  uint32_t hist[2][RADIX];  // hist[0] must be zero when `threshold` starts
  uint32_t warp_hi[32], warp_lo[32];
  int warp_up[32], warp_eq[32];
  SelectState st;
};

// Every thread's (hi, lo) reduced to the block's largest and smallest, in
// every thread.
__device__ __forceinline__ void block_max_min(uint32_t& hi, uint32_t& lo, Scratch& s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  warp_max_min(hi, lo);
  if (lane == 0) {
    s.warp_hi[warp] = hi;
    s.warp_lo[warp] = lo;
  }
  __syncthreads();
  hi = lane < warps ? s.warp_hi[lane] : 0u;  // every warp reduces the warps' values
  lo = lane < warps ? s.warp_lo[lane] : 0xFFFFFFFFu;
  warp_max_min(hi, lo);
}

// Where the k-th cell lies: the bits at and above `settled` are `prefix`'s;
// `above` cells lie above every value with the prefix, `count` match it, and
// `need` of those are still to take.
struct Threshold {
  uint32_t prefix;
  int settled, need, above, count;
};

// Radix passes over the n cells' order bits (`bits(i)`, i < n) for the k-th
// largest. Every cell is at most `hi`; `live` cells are at least `lo` (at
// least k of them), and where hi == lo those are the cells matching it. The
// passes stop once the k-th cell's digit holds exactly the cells still
// needed, or once the cells above it and in it number at most `rank_max`.
template <typename Bits>
__device__ __forceinline__ Threshold threshold(const Bits& bits, int n, int k, uint32_t hi, uint32_t lo, int live,
                                               int rank_max, Scratch& s) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid % 32, warp = tid / 32;
  uint32_t prefix = hi;
  int settled = 0, need = k, above = 0, count = live;
  if (hi != lo) {
    settled = 32 - __clz(hi ^ lo);
    prefix = settled > 31 ? 0u : hi & (0xFFFFFFFFu << settled);
    for (int pass = 0;; ++pass) {
      const int shift = max(0, settled - 8);
      const uint32_t smask = settled > 31 ? 0u : 0xFFFFFFFFu << settled;
      uint32_t* h = s.hist[pass & 1];
      for (int i0 = 0; i0 < n; i0 += T) {  // the same trip count in every warp
        const int i = i0 + tid;
        uint32_t x = 0u;
        bool match = false;
        if (i < n) {
          x = bits(i);
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
          s.st.prefix = prefix | (static_cast<uint32_t>(digit) << shift);
          s.st.above = now_above;
          s.st.need = now_need;
          s.st.count = static_cast<int>(in);
          s.st.done = shift == 0 || static_cast<int>(in) == now_need || now_above + static_cast<int>(in) <= rank_max;
        }
        for (int d = lane; d < RADIX; d += 32) s.hist[(pass + 1) & 1][d] = 0u;  // the next pass's
      }
      __syncthreads();
      prefix = s.st.prefix;
      need = s.st.need;
      above = s.st.above;
      count = s.st.count;
      settled = shift;
      if (s.st.done) break;
    }
  }
  return Threshold{prefix, settled, need, above, count};
}

// The candidates in cell order into keys[0, m), returned m: the cells above
// the prefix, and those matching it (all where the cells above and in it
// number at most `rank_max`, else the first `need`). Ends on a barrier.
template <typename Bits>
__device__ __forceinline__ int gather(const Bits& bits, int n, const Threshold& t, int rank_max,
                                      unsigned long long* keys, Scratch& s) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid % 32, warp = tid / 32, warps = T / 32;
  const uint32_t mask = 0xFFFFFFFFu << t.settled;  // settled <= 24 after a pass, or 0
  const int take = t.above + t.count <= rank_max ? t.count : t.need;
  // warp w: cells [w * 32 * per, (w + 1) * 32 * per), 32 a round; counted,
  // then each warp's first rank from the counts of the warps before it
  const int per = (n + T - 1) / T, c_warp = warp * 32 * per;
  const unsigned before = (1u << lane) - 1u;
  int up = 0, eq = 0;
  for (int r = 0; r < per; ++r) {
    const int c = c_warp + 32 * r + lane;
    const uint32_t x = c < n ? bits(c) & mask : 0u;
    up += __popc(__ballot_sync(0xFFFFFFFFu, c < n && x > t.prefix));
    eq += __popc(__ballot_sync(0xFFFFFFFFu, c < n && x == t.prefix));
  }
  if (lane == 0) {
    s.warp_up[warp] = up;
    s.warp_eq[warp] = eq;
  }
  __syncthreads();
  const int wu = lane < warps ? s.warp_up[lane] : 0, we = lane < warps ? s.warp_eq[lane] : 0;
  int up_rank = __shfl_sync(0xFFFFFFFFu, warp_scan(wu, lane) - wu, warp);
  int eq_rank = __shfl_sync(0xFFFFFFFFu, warp_scan(we, lane) - we, warp);
  for (int r = 0; r < per; ++r) {
    const int c = c_warp + 32 * r + lane;
    const uint32_t x = c < n ? bits(c) : 0u;
    const bool is_up = c < n && (x & mask) > t.prefix, is_eq = c < n && (x & mask) == t.prefix;
    const unsigned up_bits = __ballot_sync(0xFFFFFFFFu, is_up), eq_bits = __ballot_sync(0xFFFFFFFFu, is_eq);
    const int slot = is_up ? up_rank + __popc(up_bits & before)
                           : is_eq && eq_rank + __popc(eq_bits & before) < take
                                 ? t.above + eq_rank + __popc(eq_bits & before) : -1;
    if (slot >= 0)
      keys[slot] = (static_cast<unsigned long long>(x) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(c));
    up_rank += __popc(up_bits);
    eq_rank += __popc(eq_bits);
  }
  __syncthreads();
  return t.above + take;
}

// The cell a key names.
__device__ __forceinline__ int cell_of(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Each of the m keys' place among them (no two tie), counted by `share`
// neighbouring lanes a key, four keys a step; `emit(place, key)` for the
// places below k, places past k go nowhere. m <= RANK_SORT_MAX.
template <typename Emit>
__device__ __forceinline__ void rank(const unsigned long long* keys, int m, int k, const Emit& emit) {
  const int tid = threadIdx.x, T = blockDim.x;
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
    if (r < m && tid % share == 0 && place < k) emit(place, key);
  }
}

}  // namespace radix
