// Helpers shared by the port's kernels: element conversion, 16-byte tile
// loads into f32 shared memory, bf16 packing and in-place scaling of a
// bf16 tile.
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
