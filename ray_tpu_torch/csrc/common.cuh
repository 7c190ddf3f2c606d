// Helpers shared by the port's kernels: element conversion, 16-byte tile
// loads into f32 shared memory, the f32 flash kernels' geometry, bf16
// packing and in-place scaling of a bf16 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// dtype codes, as ray_tpu_torch/_cuda.py DTYPE_CODES
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the point where the JAX kernels cast to the
// input dtype (q * scale, P before P.V)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Unpack one 16-byte vector of T into f32 shared memory at dst[0..N).
template <typename T>
__device__ __forceinline__ void store_vec(float* dst, const uint4& u) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_f(e[i]);
}

// Copy a [ROWS, D] tile of T from global memory (row stride `stride`, D
// unless given) into f32 shared memory (row stride LD) over THREADS
// threads, optionally times `mul` rounded to T.
template <typename T, int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void tile_to_smem(float* dst, const T* src, int tid, float mul,
                                             bool scaled, int stride = D) {
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;
  constexpr int CH = ROWS * CPR / THREADS;
  static_assert((ROWS * CPR) % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int idx = tid + c * THREADS;
    const int row = idx / CPR, col = (idx % CPR) * VN;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)row * stride + col);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VN; ++i)
      dst[row * LD + col + i] = scaled ? round_to<T>(to_f(e[i]) * mul) : to_f(e[i]);
  }
}

// The flash FMA kernels (f32 at every head_dim, bf16 at D = 256) by
// head_dim: kTpr threads share a 64-row tile's row (D / kTpr accumulators
// each, so D = 256 takes 4 threads a row and 256 threads a block), and at
// D = 256 the tile walked beside the resident one is halved (the dQ
// kernel's key tile, the dK/dV kernel's Q tile) so that its f32 tiles fit
// the 227 KB of shared memory a block may have
template <int D> struct FmaGeom {
  static constexpr int kTpr = D > 128 ? 4 : 2;
  static constexpr int kThreads = 64 * kTpr;
  static constexpr int kWalk = D > 128 ? 32 : 64;
};

// head_dim above 256: the flash kernels walk D in chunks of this many
// columns (the wrapper pads D to a multiple of it), each block writing one
// chunk of the output columns, on FmaGeom<kWideChunk>'s geometry
constexpr int kWideChunk = 256;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Multiply a bf16 tile of BYTES bytes in shared memory by mul in place,
// each product rounded to bf16, 16 bytes at a time over THREADS threads
// (elementwise, so the tile's swizzle does not matter)
template <int BYTES, int THREADS>
__device__ __forceinline__ void scale_bf16_tile(void* tile, int tid, float mul) {
  static_assert(BYTES % (16 * THREADS) == 0, "tile must split evenly");
  uint4* v = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int i = 0; i < BYTES / 16 / THREADS; ++i) {
    uint4 u = v[tid + i * THREADS];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * mul);
    v[tid + i * THREADS] = u;
  }
}

}  // namespace rtt
