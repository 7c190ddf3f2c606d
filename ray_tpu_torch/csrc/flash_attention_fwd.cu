// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _fwd_impl): blockwise causal or non-causal
// attention over the grouped layout [B*KH*G, T, D] with an online softmax,
// writing O and the per-row logsumexp [bh, 1, T] (f32) that the backward
// kernels will read.
//
// Bound on the H100: at the serving and training shapes (T = 2048,
// D = 64) the work is ~4 * T * T * D / 2 flops per (batch, head) against
// ~4 * T * D bytes, so it is bound by operations, and the tensor cores
// (989 TFLOP/s bf16) set the floor. Two kernels, one design:
//   - bf16 (the model's dtype): warp-level tensor-core products
//     (mma.sync m16n8k16, f32 accumulate). Each of the 4 warps owns 16 Q
//     rows, keeps its Q fragments, running max/sum and O accumulator in
//     registers, and turns the S accumulator into the A operand of P.V in
//     registers (FlashAttention-2's layout trick), so P never touches
//     shared memory. V is stored transposed in shared memory so that its
//     B fragments are single 32-bit loads.
//   - f32 (tests and checks): plain f32 FMAs from shared memory.
//   - one block per (bh, 64-row Q tile); K/V tiles of 64 rows stream through
//     shared memory with coalesced 16-byte loads issued before the barrier,
//     overlapping the previous tile's work; causal blocks stop at the
//     diagonal, and the heaviest Q tiles are scheduled first;
//   - the Pallas rounding points: q * scale in the input dtype, P cast to
//     V's dtype before P.V, f32 accumulation.
// Not yet done (later work): wgmma and TMA, a cp.async/TMA pipeline of
// several K/V stages, and warp specialisation.
#include <type_traits>

#include "common.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;  // FMA kernel: two threads per Q row; MMA: 16 rows per warp
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma_kernel(
    const T* __restrict__ q,  // [bh, T, D]
    const T* __restrict__ k,  // [bh, S, D]
    const T* __restrict__ v,  // [bh, S, D]
    T* __restrict__ o,        // [bh, T, D]
    float* __restrict__ lse,  // [bh, 1, T]
    int t_len, int s_len, int causal, float scale) {
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int LP = kBK + 1;
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;                // 16-byte chunks per row
  constexpr int CH = kBK * CPR / kThreads;   // chunks per thread per K/V tile
  constexpr int QCH = kBQ * CPR / kThreads;  // chunks per thread of the Q tile
  constexpr int HD = D / 2;                  // output columns per thread
  constexpr int HK = kBK / 2;                // score columns per thread
  static_assert((kBK * CPR) % kThreads == 0, "tile must split evenly");

  extern __shared__ float sm[];
  float* qs = sm;             // [kBQ][LD] q * scale, rounded to T
  float* ks = qs + kBQ * LD;  // [kBK][LD]
  float* vs = ks + kBK * LD;  // [kBK][LD]
  float* ps = vs + kBK * LD;  // [kBQ][LP] P rounded to T

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, r = tid >> 1, hf = tid & 1;
  const int q_pos = qi * kBQ + r;
  const T* qb = q + ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const T* kbase = k + (size_t)bh * s_len * D;
  const T* vbase = v + (size_t)bh * s_len * D;
  const float scale_t = round_to<T>(scale);

#pragma unroll
  for (int c = 0; c < QCH; ++c) {
    const int idx = tid + c * kThreads;
    const int row = idx / CPR, col = (idx % CPR) * VN;
    const uint4 u = *reinterpret_cast<const uint4*>(qb + row * D + col);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VN; ++i) qs[row * LD + col + i] = round_to<T>(to_f(e[i]) * scale_t);
  }

  float m = -INFINITY, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;

  int n_kb = s_len / kBK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    uint4 kbuf[CH], vbuf[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const size_t off = ((size_t)kb * kBK + idx / CPR) * D + (idx % CPR) * VN;
      kbuf[c] = *reinterpret_cast<const uint4*>(kbase + off);
      vbuf[c] = *reinterpret_cast<const uint4*>(vbase + off);
    }
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int row = idx / CPR, col = (idx % CPR) * VN;
      store_vec<T>(ks + row * LD + col, kbuf[c]);
      store_vec<T>(vs + row * LD + col, vbuf[c]);
    }
    __syncthreads();

    // scores of row r against columns 2j + hf
    float s[HK];
#pragma unroll
    for (int j = 0; j < HK; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < HK; ++j) s[j] += qd * ks[(2 * j + hf) * LD + d];
    }
    if (causal) {
#pragma unroll
      for (int j = 0; j < HK; ++j)
        if (kb * kBK + 2 * j + hf > q_pos) s[j] = -1e30f;
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < HK; ++j) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      ps[r * LP + 2 * j + hf] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncthreads();  // the row's P is complete

#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float pc = ps[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] += pc * vs[c * LD + 2 * j + hf];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  T* ob = o + ((size_t)bh * t_len + q_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) ob[2 * j + hf] = from_f<T>(acc[j] / l_safe);
  if (hf == 0) lse[(size_t)bh * t_len + q_pos] = m + logf(l_safe);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [bh, T, D]
    const __nv_bfloat16* __restrict__ k,  // [bh, S, D]
    const __nv_bfloat16* __restrict__ v,  // [bh, S, D]
    __nv_bfloat16* __restrict__ o,        // [bh, T, D]
    float* __restrict__ lse,              // [bh, 1, T]
    int t_len, int s_len, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LDK = D + 8;    // Q/K rows: 16-byte aligned, conflict-free fragments
  constexpr int LDV = kBK + 8;  // rows of V transposed
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  constexpr int CH = kBK * CPR / kThreads;
  constexpr int QCH = kBQ * CPR / kThreads;
  constexpr int NT = kBK / 8;   // score column tiles
  constexpr int DT = D / 8;     // output column tiles
  constexpr int KS = D / 16;    // k-steps of Q.K^T
  static_assert(kBQ == 16 * (kThreads / 32), "one 16-row strip per warp");
  static_assert(D % 16 == 0 && (kBK * CPR) % kThreads == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LDK]
  bf16* ks = qs + kBQ * LDK;                     // [kBK][LDK]
  bf16* vt = ks + kBK * LDK;                     // [D][LDV], V transposed

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const bf16* kbase = k + (size_t)bh * s_len * D;
  const bf16* vbase = v + (size_t)bh * s_len * D;
  const float scale_t = round_to<bf16>(scale);

  // Q tile, q * scale rounded to bf16, then this warp's A fragments
#pragma unroll
  for (int c = 0; c < QCH; ++c) {
    const int idx = tid + c * kThreads;
    const int row = idx / CPR, col = (idx % CPR) * 8;
    uint4 u = *reinterpret_cast<const uint4*>(qb + row * D + col);
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * scale_t);
    *reinterpret_cast<uint4*>(qs + row * LDK + col) = u;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = ld32(qs + r0 * LDK + kk * 16 + 2 * t4);
    qf[kk][1] = ld32(qs + (r0 + 8) * LDK + kk * 16 + 2 * t4);
    qf[kk][2] = ld32(qs + r0 * LDK + kk * 16 + 8 + 2 * t4);
    qf[kk][3] = ld32(qs + (r0 + 8) * LDK + kk * 16 + 8 + 2 * t4);
  }
  const int q_pos0 = qi * kBQ + r0, q_pos1 = q_pos0 + 8;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  int n_kb = s_len / kBK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    uint4 kbuf[CH], vbuf[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const size_t off = ((size_t)kb * kBK + idx / CPR) * D + (idx % CPR) * 8;
      kbuf[c] = *reinterpret_cast<const uint4*>(kbase + off);
      vbuf[c] = *reinterpret_cast<const uint4*>(vbase + off);
    }
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int row = idx / CPR, col = (idx % CPR) * 8;
      *reinterpret_cast<uint4*>(ks + row * LDK + col) = kbuf[c];
      const bf16* e = reinterpret_cast<const bf16*>(&vbuf[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(col + i) * LDV + row] = e[i];
    }
    __syncthreads();

    // S = (q * scale) . K^T for this warp's 16 rows x 64 columns
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = ks + (nt * 8 + g) * LDK + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma_bf16(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    if (causal) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k_pos = kb * kBK + nt * 8 + 2 * t4 + j;
          if (k_pos > q_pos0) s[nt][j] = -1e30f;
          if (k_pos > q_pos1) s[nt][2 + j] = -1e30f;
        }
    }
    // online softmax: a row's 64 scores sit in the 4 threads of a quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
    uint32_t pf[NT][2];  // P rounded to bf16, packed as A-fragment halves
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p00 = expf(s[nt][0] - mn0), p01 = expf(s[nt][1] - mn0);
      const float p10 = expf(s[nt][2] - mn1), p11 = expf(s[nt][3] - mn1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pf[nt][0] = pack_bf16(p00, p01);
      pf[nt][1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    // O += P . V: the S accumulator of column tiles 2kk, 2kk+1 is the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* vr = vt + (j * 8 + g) * LDV + kk * 16 + 2 * t4;
        mma_bf16(acc[j], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  bf16* o0 = o + ((size_t)bh * t_len + q_pos0) * D + 2 * t4;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(acc[j][0] / ls0, acc[j][1] / ls0);
    *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(acc[j][2] / ls1, acc[j][3] / ls1);
  }
  if (t4 == 0) {
    lse[(size_t)bh * t_len + q_pos0] = m0 + logf(ls0);
    lse[(size_t)bh * t_len + q_pos1] = m1 + logf(ls1);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int t, int s, int causal, float scale, cudaStream_t stream) {
  const unsigned blocks = (unsigned)bh * (unsigned)(t / kBQ);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = sizeof(T) * ((kBQ + kBK) * (D + 8) + D * (kBK + 8));
    auto kern = flash_fwd_mma_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, t, s, causal, scale);
  } else {
    const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
    auto kern = flash_fwd_fma_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, t, s, causal, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int t, int s, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). T and S must be
// multiples of 64; the caller allocates o and lse and checks shapes,
// dtypes, contiguity and 16-byte alignment.
extern "C" int ray_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int t, int s, int d, int causal,
                                       float scale, int dtype, void* stream) {
  if (bh == 0 || t == 0) return cudaSuccess;
  if (t % kBQ != 0 || s % kBK != 0 || s == 0) return cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(d, q, k, v, o, lse_f, bh, t, s, causal, scale, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse_f, bh, t, s, causal, scale, st);
  return cudaErrorInvalidValue;
}
