// Helpers shared by the port's kernels: element conversion and 16-byte
// tile loads into f32 shared memory.
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

}  // namespace rtt
