// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel of FlashAttention-2.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/flash_attention.py
// _dq_kernel and _dkv_kernel (launched by _flash_grouped_bwd). On the
// grouped layout [B*KH*G, T, D], given dO, the forward's per-row logsumexp
// lse and delta = rowsum(dO * O) (both [bh, 1, T] f32), each kernel
// recomputes P = exp(S - lse) tile by tile and never writes P to memory:
//   - dQ: one block per (bh, 64-row Q tile), walking the forward's live K
//     tiles: dS = P * (dO.V^T - delta), dQ = scale * dS.K;
//   - dK/dV: one block per (bh, 64-row K tile), walking the Q tiles from
//     the diagonal on: dV += P^T.dO, dK += dS^T.(scale * Q).
// The split is the Pallas one: no atomics, each output written once by
// one block, so both kernels are deterministic.
//
// Bound on the H100: per live (query, key) pair dQ does 3 products of
// 2*D flops (S, dP, dS.K) and dK/dV 4 (S, dP, dV, dK) against ~4*D bytes
// per row of Q, K, V, dO; at the training shapes (T = 1024..2048, D = 64
// or 128) that is far above the card's ~295 flops per byte, so both are
// bound by operations and the tensor cores (989 TFLOP/s bf16) set the
// floor. Designs:
//   - bf16 (the model's dtype): warp-level tensor-core products
//     (mma.sync m16n8k16, f32 accumulate), 4 warps of 16 rows each. The
//     accumulator of S (or S^T in dK/dV) becomes, after the elementwise
//     step, the A operand of the next product in registers (the
//     FlashAttention-2 layout trick), so P and dS never touch shared
//     memory. Tiles that feed a B operand along their rows are stored
//     transposed in shared memory as well.
//   - f32 (tests and checks): plain f32 FMAs from shared memory, two
//     threads per row.
//   - the Pallas rounding points: q * scale rounded to the input dtype, dO
//     and dP in f32, dS rounded to the input dtype before dS.K and
//     dS^T.(scale * Q), dQ scaled once more at the end, dK not. Pallas
//     keeps P in f32 for dV = P^T.dO (dO was cast to f32). The bf16 kernel
//     keeps that: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//     and dV takes both products (dO is bf16, so each product is exact),
//     which leaves P's error near 2^-17 of P instead of the 2^-9 of
//     rounding it as FlashAttention-2 does on GPUs, at one extra product
//     of the four.
//   - masked entries (k_pos > q_pos) take S = -1e30 and underflow to
//     exactly 0 through exp(S - lse); padded query rows have dO = 0 and
//     delta = 0, so they add nothing to dK/dV.
// Not yet done (later work): wgmma and TMA, a multi-stage pipeline for the
// streamed tiles, and ldmatrix in place of the transposed copies.
#include <type_traits>

#include "common.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;  // FMA: two threads per row; MMA: 16 rows per warp
constexpr int kBQ = 64;        // Q tile of the dQ kernel (and of the f32 dK/dV kernel)
constexpr int kBK = 64;        // K tile of both kernels

// ---------------------------------------------------------------------------
// f32 (and any T): FMA kernels
// ---------------------------------------------------------------------------

// Copy a [rows, D] tile of T from global memory (row stride D) into f32
// shared memory (row stride LD), optionally times `mul` rounded to T.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void tile_to_smem(float* dst, const T* src, int tid, float mul,
                                             bool scaled) {
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;
  constexpr int CH = ROWS * CPR / kThreads;
  static_assert((ROWS * CPR) % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int idx = tid + c * kThreads;
    const int row = idx / CPR, col = (idx % CPR) * VN;
    const uint4 u = *reinterpret_cast<const uint4*>(src + row * D + col);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VN; ++i)
      dst[row * LD + col + i] = scaled ? round_to<T>(to_f(e[i]) * mul) : to_f(e[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int t_len, int s_len, int causal, float scale) {
  constexpr int LD = D + 1;  // padded rows: conflict-free column reads
  constexpr int LP = kBK + 1;
  constexpr int HD = D / 2;    // dq columns per thread
  constexpr int HK = kBK / 2;  // score columns per thread

  extern __shared__ float sm[];
  float* qs = sm;              // [kBQ][LD] q * scale, rounded to T
  float* dos = qs + kBQ * LD;  // [kBQ][LD]
  float* ks = dos + kBQ * LD;  // [kBK][LD]
  float* vs = ks + kBK * LD;   // [kBK][LD]
  float* dss = vs + kBK * LD;  // [kBQ][LP] dS rounded to T

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, r = tid >> 1, hf = tid & 1;
  const int q_pos = qi * kBQ + r;
  const size_t q_off = ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const T* kbase = k + (size_t)bh * s_len * D;
  const T* vbase = v + (size_t)bh * s_len * D;

  tile_to_smem<T, D, kBQ, LD>(qs, q + q_off, tid, round_to<T>(scale), true);
  tile_to_smem<T, D, kBQ, LD>(dos, dout + q_off, tid, 1.f, false);
  const float lse_r = lse[(size_t)bh * t_len + q_pos];
  const float delta_r = delta[(size_t)bh * t_len + q_pos];

  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;

  int n_kb = s_len / kBK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // every thread is done with the previous K/V and dS
    tile_to_smem<T, D, kBK, LD>(ks, kbase + (size_t)kb * kBK * D, tid, 1.f, false);
    tile_to_smem<T, D, kBK, LD>(vs, vbase + (size_t)kb * kBK * D, tid, 1.f, false);
    __syncthreads();

    // S and dP of row r against columns 2j + hf
    float s[HK], dp[HK];
#pragma unroll
    for (int j = 0; j < HK; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d], od = dos[r * LD + d];
#pragma unroll
      for (int j = 0; j < HK; ++j) {
        s[j] += qd * ks[(2 * j + hf) * LD + d];
        dp[j] += od * vs[(2 * j + hf) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const int c = 2 * j + hf;
      const float sv = (causal && kb * kBK + c > q_pos) ? -1e30f : s[j];
      const float p = expf(sv - lse_r);
      dss[r * LP + c] = round_to<T>(p * (dp[j] - delta_r));
    }
    __syncthreads();  // the row's dS is complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float dsc = dss[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] += dsc * ks[c * LD + 2 * j + hf];
    }
  }

  T* out = dq + ((size_t)bh * t_len + q_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) out[2 * j + hf] = from_f<T>(acc[j] * scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = kBQ + 1;
  constexpr int HD = D / 2;    // dk/dv columns per thread
  constexpr int HQ = kBQ / 2;  // score columns (queries) per thread

  extern __shared__ float sm[];
  float* ks = sm;              // [kBK][LD]
  float* vs = ks + kBK * LD;   // [kBK][LD]
  float* qs = vs + kBK * LD;   // [kBQ][LD] q * scale, rounded to T
  float* dos = qs + kBQ * LD;  // [kBQ][LD]
  float* ps = dos + kBQ * LD;  // [kBK][LP] P^T in f32
  float* dss = ps + kBK * LP;  // [kBK][LP] dS^T rounded to T
  float* lse_s = dss + kBK * LP;  // [kBQ]
  float* delta_s = lse_s + kBQ;   // [kBQ]

  const int nk = s_len / kBK;
  const int bh = blockIdx.x / nk;
  const int ki = (int)(blockIdx.x % nk);  // causal: early K tiles see the most Q tiles
  const int tid = threadIdx.x, r = tid >> 1, hf = tid & 1;
  const int k_pos = ki * kBK + r;
  const size_t k_off = ((size_t)bh * s_len + (size_t)ki * kBK) * D;
  const float scale_t = round_to<T>(scale);

  tile_to_smem<T, D, kBK, LD>(ks, k + k_off, tid, 1.f, false);
  tile_to_smem<T, D, kBK, LD>(vs, v + k_off, tid, 1.f, false);

  float dka[HD], dva[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) dka[j] = dva[j] = 0.f;

  const int n_qb = t_len / kBQ;
  const int qb_start = causal ? ki * kBK / kBQ : 0;  // earlier Q tiles see nothing
  for (int qb = qb_start; qb < n_qb; ++qb) {
    __syncthreads();  // every thread is done with the previous Q tile
    const size_t q_off = ((size_t)bh * t_len + (size_t)qb * kBQ) * D;
    tile_to_smem<T, D, kBQ, LD>(qs, q + q_off, tid, scale_t, true);
    tile_to_smem<T, D, kBQ, LD>(dos, dout + q_off, tid, 1.f, false);
    if (tid < kBQ) lse_s[tid] = lse[(size_t)bh * t_len + qb * kBQ + tid];
    else if (tid < 2 * kBQ) delta_s[tid - kBQ] = delta[(size_t)bh * t_len + qb * kBQ + tid - kBQ];
    __syncthreads();

    // S^T and dP^T of key row r against queries 2j + hf
    float s[HQ], dp[HQ];
#pragma unroll
    for (int j = 0; j < HQ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[r * LD + d], vd = vs[r * LD + d];
#pragma unroll
      for (int j = 0; j < HQ; ++j) {
        s[j] += kd * qs[(2 * j + hf) * LD + d];
        dp[j] += vd * dos[(2 * j + hf) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < HQ; ++j) {
      const int c = 2 * j + hf;
      const float sv = (causal && k_pos > qb * kBQ + c) ? -1e30f : s[j];
      const float p = expf(sv - lse_s[c]);
      ps[r * LP + c] = p;
      dss[r * LP + c] = round_to<T>(p * (dp[j] - delta_s[c]));
    }
    __syncthreads();  // the row's P^T and dS^T are complete

#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      const float pc = ps[r * LP + c], dsc = dss[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        dva[j] += pc * dos[c * LD + 2 * j + hf];
        dka[j] += dsc * qs[c * LD + 2 * j + hf];
      }
    }
  }

  T* dk_row = dk + ((size_t)bh * s_len + k_pos) * D;
  T* dv_row = dv + ((size_t)bh * s_len + k_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) {
    dk_row[2 * j + hf] = from_f<T>(dka[j]);
    dv_row[2 * j + hf] = from_f<T>(dva[j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// Copy a [ROWS, D] bf16 tile (global row stride D) into shared memory, row
// by row (stride LDN) and, if tr is given, transposed (stride LDT); with
// `scaled`, each element times `mul` rounded to bf16 first.
template <int D, int ROWS, int LDN, int LDT>
__device__ __forceinline__ void bf16_tile(bf16* nat, bf16* tr, const bf16* src, int tid,
                                          float mul, bool scaled) {
  constexpr int CPR = D / 8;
  constexpr int CH = ROWS * CPR / kThreads;
  static_assert((ROWS * CPR) % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int idx = tid + c * kThreads;
    const int row = idx / CPR, col = (idx % CPR) * 8;
    uint4 u = *reinterpret_cast<const uint4*>(src + row * D + col);
    bf16* e = reinterpret_cast<bf16*>(&u);
    if (scaled) {
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * mul);
    }
    *reinterpret_cast<uint4*>(nat + row * LDN + col) = u;
    if (tr != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(col + i) * LDT + row] = e[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int t_len, int s_len, int causal,
    float scale) {
  constexpr int LDN = D + 8;    // rows: 16-byte aligned, conflict-free fragments
  constexpr int LDT = kBK + 8;  // rows of K transposed
  constexpr int NT = kBK / 8;   // score column tiles
  constexpr int DT = D / 8;     // dq column tiles
  constexpr int KS = D / 16;    // k-steps over D
  static_assert(kBQ == 16 * (kThreads / 32), "one 16-row strip per warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LDN] q * scale
  bf16* dos = qs + kBQ * LDN;                    // [kBQ][LDN]
  bf16* ks = dos + kBQ * LDN;                    // [kBK][LDN]
  bf16* vs = ks + kBK * LDN;                     // [kBK][LDN]
  bf16* kt = vs + kBK * LDN;                     // [D][LDT], K transposed

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_off = ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const bf16* kbase = k + (size_t)bh * s_len * D;
  const bf16* vbase = v + (size_t)bh * s_len * D;

  bf16_tile<D, kBQ, LDN, 1>(qs, nullptr, q + q_off, tid, round_to<bf16>(scale), true);
  bf16_tile<D, kBQ, LDN, 1>(dos, nullptr, dout + q_off, tid, 1.f, false);
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int q_pos0 = qi * kBQ + r0, q_pos1 = q_pos0 + 8;
  const float lse0 = lse[(size_t)bh * t_len + q_pos0], lse1 = lse[(size_t)bh * t_len + q_pos1];
  const float dl0 = delta[(size_t)bh * t_len + q_pos0], dl1 = delta[(size_t)bh * t_len + q_pos1];

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_kb = s_len / kBK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // every warp is done with the previous K/V tile
    bf16_tile<D, kBK, LDN, LDT>(ks, kt, kbase + (size_t)kb * kBK * D, tid, 1.f, false);
    bf16_tile<D, kBK, LDN, 1>(vs, nullptr, vbase + (size_t)kb * kBK * D, tid, 1.f, false);
    __syncthreads();

    // S = (q * scale).K^T and dP = dO.V^T for this warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, qs, LDN, r0, kk * 16, t4);
      load_a(ao, dos, LDN, r0, kk * 16, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * LDN + kk * 16 + 2 * t4;
        const bf16* vr = vs + (nt * 8 + g) * LDN + kk * 16 + 2 * t4;
        mma_bf16(s[nt], aq, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], ao, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P * (dP - delta), P = exp(S - lse), packed as A-fragment halves
    uint32_t dsf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k_pos = kb * kBK + nt * 8 + 2 * t4 + (i & 1);
        const int q_pos = i < 2 ? q_pos0 : q_pos1;
        const float sv = (causal && k_pos > q_pos) ? -1e30f : s[nt][i];
        const float p = expf(sv - (i < 2 ? lse0 : lse1));
        ds[i] = p * (dp[nt][i] - (i < 2 ? dl0 : dl1));
      }
      dsf[nt][0] = pack_bf16(ds[0], ds[1]);
      dsf[nt][1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS.K: the dS accumulator of column tiles 2kk, 2kk+1 is the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {dsf[2 * kk][0], dsf[2 * kk][1], dsf[2 * kk + 1][0],
                             dsf[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* kr = kt + (j * 8 + g) * LDT + kk * 16 + 2 * t4;
        mma_bf16(acc[j], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

  bf16* o0 = dq + ((size_t)bh * t_len + q_pos0) * D + 2 * t4;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// Q tile of the bf16 dK/dV kernel: 32 rows at head_dim 128 keeps the dK
// and dV accumulators (2 x 64 registers a thread) and the S^T/dP^T tiles
// inside the register file; 64 rows below that.
template <int D> __host__ __device__ constexpr int dkv_q_tile() { return D >= 128 ? 32 : 64; }

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
    int s_len, int causal, float scale) {
  constexpr int QT = dkv_q_tile<D>();
  constexpr int LDN = D + 8;   // rows of K, V, Q, dO
  constexpr int LDT = QT + 8;  // rows of Q and dO transposed
  constexpr int NQ = QT / 8;   // S^T column tiles (queries)
  constexpr int DT = D / 8;    // dk/dv column tiles
  constexpr int KS = D / 16;   // k-steps over D
  static_assert(kBK == 16 * (kThreads / 32), "one 16-key strip per warp");
  static_assert(kBK % QT == 0 && 2 * QT <= kThreads, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kBK][LDN]
  bf16* vs = ks + kBK * LDN;                     // [kBK][LDN]
  bf16* qs = vs + kBK * LDN;                     // [QT][LDN] q * scale
  bf16* dos = qs + QT * LDN;                     // [QT][LDN]
  bf16* qt = dos + QT * LDN;                     // [D][LDT] (q * scale)^T
  bf16* dot = qt + D * LDT;                      // [D][LDT] dO^T
  float* lse_s = reinterpret_cast<float*>(dot + D * LDT);  // [QT]
  float* delta_s = lse_s + QT;                              // [QT]

  const int nk = s_len / kBK;
  const int bh = blockIdx.x / nk;
  const int ki = (int)(blockIdx.x % nk);  // causal: early K tiles see the most Q tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t k_off = ((size_t)bh * s_len + (size_t)ki * kBK) * D;
  const float scale_t = round_to<bf16>(scale);

  bf16_tile<D, kBK, LDN, 1>(ks, nullptr, k + k_off, tid, 1.f, false);
  bf16_tile<D, kBK, LDN, 1>(vs, nullptr, v + k_off, tid, 1.f, false);
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  const int k_pos0 = ki * kBK + r0, k_pos1 = k_pos0 + 8;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.f;

  const int n_qb = t_len / QT;
  const int qb_start = causal ? ki * kBK / QT : 0;  // earlier Q tiles see nothing
  for (int qb = qb_start; qb < n_qb; ++qb) {
    __syncthreads();  // every warp is done with the previous Q tile
    const size_t q_off = ((size_t)bh * t_len + (size_t)qb * QT) * D;
    bf16_tile<D, QT, LDN, LDT>(qs, qt, q + q_off, tid, scale_t, true);
    bf16_tile<D, QT, LDN, LDT>(dos, dot, dout + q_off, tid, 1.f, false);
    if (tid < QT) lse_s[tid] = lse[(size_t)bh * t_len + qb * QT + tid];
    else if (tid < 2 * QT) delta_s[tid - QT] = delta[(size_t)bh * t_len + qb * QT + tid - QT];
    __syncthreads();

    // S^T = K.(q * scale)^T and dP^T = V.dO^T: this warp's 16 keys x QT queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, ks, LDN, r0, kk * 16, t4);
      load_a(av, vs, LDN, r0, kk * 16, t4);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const bf16* qr = qs + (nt * 8 + g) * LDN + kk * 16 + 2 * t4;
        const bf16* orow = dos + (nt * 8 + g) * LDN + kk * 16 + 2 * t4;
        mma_bf16(s[nt], ak, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[nt], av, ld32(orow), ld32(orow + 8));
      }
    }
    // P^T (split into bf16 hi + lo) and dS^T = P^T * (dP^T - delta)
    uint32_t phi[NQ][2], plo[NQ][2], dsf[NQ][2];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      float p[4], lo[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * t4 + (i & 1);  // query within the tile
        const int k_pos = i < 2 ? k_pos0 : k_pos1;
        const float sv = (causal && k_pos > qb * QT + c) ? -1e30f : s[nt][i];
        p[i] = expf(sv - lse_s[c]);
        lo[i] = p[i] - round_to<bf16>(p[i]);
        ds[i] = p[i] * (dp[nt][i] - delta_s[c]);
      }
      phi[nt][0] = pack_bf16(p[0], p[1]);
      phi[nt][1] = pack_bf16(p[2], p[3]);
      plo[nt][0] = pack_bf16(lo[0], lo[1]);
      plo[nt][1] = pack_bf16(lo[2], lo[3]);
      dsf[nt][0] = pack_bf16(ds[0], ds[1]);
      dsf[nt][1] = pack_bf16(ds[2], ds[3]);
    }
    // dV += P^T.dO (hi and lo parts) and dK += dS^T.(q * scale)
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t ah[4] = {phi[2 * kk][0], phi[2 * kk][1], phi[2 * kk + 1][0],
                              phi[2 * kk + 1][1]};
      const uint32_t al[4] = {plo[2 * kk][0], plo[2 * kk][1], plo[2 * kk + 1][0],
                              plo[2 * kk + 1][1]};
      const uint32_t ad[4] = {dsf[2 * kk][0], dsf[2 * kk][1], dsf[2 * kk + 1][0],
                              dsf[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* orow = dot + (j * 8 + g) * LDT + kk * 16 + 2 * t4;
        const uint32_t b0 = ld32(orow), b1 = ld32(orow + 8);
        mma_bf16(dva[j], ah, b0, b1);
        mma_bf16(dva[j], al, b0, b1);
        const bf16* qr = qt + (j * 8 + g) * LDT + kk * 16 + 2 * t4;
        mma_bf16(dka[j], ad, ld32(qr), ld32(qr + 8));
      }
    }
  }

  // (q * scale) carried the scale into dS^T.Q already: no second factor
  const size_t row0 = ((size_t)bh * s_len + k_pos0) * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(dk + row0 + j * 8) = pack_bf16(dka[j][0], dka[j][1]);
    *reinterpret_cast<uint32_t*>(dk + row0 + 8 * D + j * 8) = pack_bf16(dka[j][2], dka[j][3]);
    *reinterpret_cast<uint32_t*>(dv + row0 + j * 8) = pack_bf16(dva[j][0], dva[j][1]);
    *reinterpret_cast<uint32_t*>(dv + row0 + 8 * D + j * 8) = pack_bf16(dva[j][2], dva[j][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, t, s, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  const unsigned blocks = (unsigned)a.bh * (unsigned)(a.t / kBQ);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = sizeof(bf16) * ((2 * kBQ + 2 * kBK) * (D + 8) + D * (kBK + 8));
    auto kern = flash_bwd_dq_mma_kernel<D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dq, a.t, a.s,
                                               a.causal, a.scale);
  } else {
    const size_t smem = sizeof(float) * ((2 * kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
    auto kern = flash_bwd_dq_fma_kernel<T, D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dq, a.t, a.s,
                                               a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  const unsigned blocks = (unsigned)a.bh * (unsigned)(a.s / kBK);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int QT = dkv_q_tile<D>();
    const size_t smem = sizeof(bf16) * ((2 * kBK + 2 * QT) * (D + 8) + 2 * D * (QT + 8)) +
                        sizeof(float) * 2 * QT;
    auto kern = flash_bwd_dkv_mma_kernel<D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dk, dv, a.t,
                                               a.s, a.causal, a.scale);
  } else {
    const size_t smem = sizeof(float) * ((2 * kBK + 2 * kBQ) * (D + 1) +
                                         2 * kBK * (kBQ + 1) + 2 * kBQ);
    auto kern = flash_bwd_dkv_fma_kernel<T, D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, dk, dv, a.t,
                                               a.s, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool is_dq, int d, const BwdArgs& a) {
  switch (d) {
    case 32:
      return is_dq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64:
      return is_dq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return is_dq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool is_dq, const BwdArgs& a, int d, int dtype) {
  // no queries: dQ is empty, but dK/dV still launches and writes zeros
  if (a.bh == 0 || (is_dq && a.t == 0)) return cudaSuccess;
  if (a.t % kBQ != 0 || a.s % kBK != 0 || a.s == 0) return cudaErrorInvalidValue;
  if (dtype == kF32) return dispatch<float>(is_dq, d, a);
  if (dtype == kBF16) return dispatch<bf16>(is_dq, d, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 = success). T
// and S must be multiples of 64; the caller allocates the outputs and
// checks shapes, dtypes, contiguity and 16-byte alignment. lse and delta
// are [bh, 1, T] f32.
extern "C" int ray_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int bh, int t, int s, int d, int causal,
                                          float scale, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr, bh, t, s, causal,
                  scale, static_cast<cudaStream_t>(stream)};
  return run(true, a, d, dtype);
}

extern "C" int ray_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int bh, int t, int s, int d,
                                           int causal, float scale, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, bh, t, s, causal,
                  scale, static_cast<cudaStream_t>(stream)};
  return run(false, a, d, dtype);
}
