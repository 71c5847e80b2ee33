// sm90.cuh: the Hopper (sm_90a) pieces that both MIPS kernels' tensor-core
// bodies build on: shared-memory addresses, `mbarrier`s, TMA loads of
// 128-byte-swizzled boxes, `wgmma` descriptors and instructions, the host
// lookup of the driver's tensor-map encoder, and the host's once-per-card
// set-up (the shared-memory opt-in of a kernel).
//
// Included by `fused_mips_topk.cu` and `fused_mips_binned.cu`, each built into
// its own library; `ops/cuda_build.py` hashes this header into the build key
// of every source that includes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is reached through the runtime
#include <cuda_runtime.h>
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
