// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, TMA
// tile loads, the wgmma shared-memory descriptor and products, the shared
// layout of bf16 tiles with their K-major and MN-major descriptors, and the
// host-side tensor-map encoders. Each low-level device helper wraps the one
// PTX instruction named in its comment.
//
// Shared-memory operands of wgmma follow the canonical swizzled layouts
// (CUTLASS's GmmaDescriptor): a tile whose rows are exactly one swizzle
// span (64 B or 128 B), written there by a TMA load with the same swizzle,
// starting at an address aligned to the swizzle's 8-row atom (512 B or
// 1024 B).
#pragma once

#include <cuda.h>          // CUtensorMap and its enums
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
// mbarrier.init.shared::cta.b64: a barrier in shared memory expecting
// `count` arrivals per phase
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// fence.mbarrier_init.release.cluster: make the inits visible to the
// async proxy (TMA) before any load reports to the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.expect_tx.shared::cta.b64: one arrival, and `bytes`
// more to land (by complete_tx) before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// mbarrier.try_wait.parity.shared::cta.b64, polled until the phase with
// this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA, proxies, named barriers
// ---------------------------------------------------------------------------
// cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes:
// the box of `map` at element coordinates (c0 innermost, c1, c2) into
// shared memory at `dst`, completing `bar`'s transaction bytes. Boxes that
// run past the tensor's bounds are zero-filled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// fence.proxy.async.shared::cta: this thread's generic-proxy writes to
// shared memory become visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync id, n: named barrier over n threads (a multiple of 32)
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor layout types (bits 62-63)
constexpr int kSwizzle128B = 1;
constexpr int kSwizzle64B = 2;

// The 64-bit shared-memory matrix descriptor of wgmma.mma_async: start
// address, leading and stride byte offsets (all >> 4) and layout type.
//   K-major operand (rows of the swizzle span, contraction along a row):
//     sbo = 8 rows x row bytes; lbo unused (1). A k-step of 16 bf16
//     advances the start address by 32 B inside the swizzled row.
//   MN-major operand (transposed B, N along a row): sbo = stride between
//     groups of 8 k-rows; lbo = stride between swizzle-span chunks of N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// wgmma.fence.sync.aligned: order this thread's register writes (A
// fragments, accumulators) before the next wgmma.mma_async reads them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// wgmma.commit_group.sync.aligned: close the group of issued products
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wgmma.wait_group.sync.aligned N: wait until at most N groups are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator's registers at this point, so the compiler neither
// reads them before the wgmma_wait that covers them nor writes them after
// a product was issued.
template <int N> __device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for packed A fragments: their registers stay live, unchanged,
// until the wgmma_wait that covers the products reading them.
template <int N> __device__ __forceinline__ void fence_operand(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define RTT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RTT_F16(d, i) RTT_F4(d, i), RTT_F4(d, i + 4), RTT_F4(d, i + 8), RTT_F4(d, i + 12)
#define RTT_WGMMA_D16(d) RTT_F16(d, 0)
#define RTT_WGMMA_D32(d) RTT_F16(d, 0), RTT_F16(d, 16)
#define RTT_WGMMA_D64(d) RTT_F16(d, 0), RTT_F16(d, 16), RTT_F16(d, 32), RTT_F16(d, 48)

// wgmma.mma_async m64nNk16.f32.bf16.bf16, both operands in shared memory,
// both K-major: d (+)= A (64x16) . B (16xN); scale_d = 0 overwrites d.
// Accumulator layout per warp w of the warpgroup (g = lane / 4,
// t = lane % 4): d[4j + {0,1}] = row 16w + g, cols 8j + 2t + {0,1};
// d[4j + {2,3}] = row 16w + g + 8, the same cols.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <> __device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_D16(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RTT_WGMMA_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// wgmma.mma_async m64nNk16.f32.bf16.bf16 with A in registers and B in
// shared memory, MN-major (transpose-B = 1): d (+)= A . B. The A fragment
// of warp w is mma.sync m16n8k16's for rows 16w..16w+15: a[0] = (row g,
// k 2t..2t+1), a[1] = (row g + 8, same k), a[2] = (row g, k 2t+8..2t+9),
// a[3] = (row g + 8, k 2t+8..2t+9), so an accumulator's columns 16k..16k+15
// are the A fragment of k-step k.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : RTT_WGMMA_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RTT_WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef RTT_WGMMA_D64
#undef RTT_WGMMA_D32
#undef RTT_WGMMA_D16
#undef RTT_F16
#undef RTT_F4

// ---------------------------------------------------------------------------
// bf16 [rows, D] tiles in shared memory: layout, descriptors, TMA
// ---------------------------------------------------------------------------
// A tile is stored as D / kCols boxes of kCols columns, box after box; a
// box row is one swizzle span (kRowBytes: 64 B at D = 32, else 128 B),
// written by a TMA load of a map with the same swizzle (encode_tile_map).
// rows is a multiple of 8 and the tile starts on 1024 B.
template <int D> struct TileBoxes {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kSwizzle = kRowBytes == 128 ? kSwizzle128B : kSwizzle64B;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// Descriptor of k-step kk (columns 16kk..16kk+15) of a tile read K-major:
// the contraction runs along its rows (an A operand, or B = rows^T)
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  using B = TileBoxes<D>;
  constexpr int kSteps = B::kCols / 16;  // k-steps per box
  return wgmma_desc(tile + (kk / kSteps) * rows * B::kRowBytes + (kk % kSteps) * 32, 16,
                    8 * B::kRowBytes, B::kSwizzle);
}

// Descriptor of k-step kk (rows 16kk..16kk+15) of a tile read MN-major as
// B (transpose-B): the contraction runs down its rows, N = D along them,
// box after box
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  using B = TileBoxes<D>;
  return wgmma_desc(tile + kk * 16 * B::kRowBytes, rows * B::kRowBytes, 8 * B::kRowBytes,
                    B::kSwizzle);
}

// Rows [row, row + ROWS) of head bh of a [bh, rows, D] map into the tile at
// dst, one TMA load per box, completing on bar (whose expected bytes the
// caller has set); a ring stage is refilled by a few of these
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int bh) {
  using B = TileBoxes<D>;
#pragma unroll
  for (int b = 0; b < B::kBoxes; ++b)
    tma_load_3d(dst + b * ROWS * B::kRowBytes, map, bar, b * B::kCols, row, bh);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library needs no -lcuda. A 3-D map of a contiguous
// [d2, d1, d0] tensor (d0 innermost) of elem_bytes-sized elements, box
// [1, box1, box0], with the given swizzle; out-of-bounds elements of a box
// read as zero. Returns CUDA_SUCCESS or the encoder's error.
inline CUresult encode_map_3d(CUtensorMap* map, CUtensorMapDataType type, uint64_t elem_bytes,
                              const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                              uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return CUDA_ERROR_NOT_FOUND;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem_bytes, d0 * d1 * elem_bytes};  // of dims 1 and 2
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A bf16 [bh, rows, D] tensor in tiles of box_rows rows (TileBoxes<D>)
template <int D>
inline CUresult encode_tile_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t bh,
                                uint32_t box_rows) {
  using B = TileBoxes<D>;
  return encode_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, D, rows, bh, B::kCols,
                       box_rows, B::kMapSwizzle);
}

// An f32 [bh, 1, t] tensor (lse, delta) in runs of box values, unswizzled:
// element (head h, position p) sits at coordinates (p, h, 0)
inline CUresult encode_row_map(CUtensorMap* map, const float* ptr, uint64_t t, uint64_t bh,
                               uint32_t box) {
  return encode_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, t, bh, 1, box, 1,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
}  // namespace rtt
