// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _fwd_impl): blockwise causal or non-causal
// attention over the grouped layout [B*KH*G, T, D] with an online softmax,
// writing O and the per-row logsumexp [bh, 1, T] (f32, natural log) that
// the backward kernels read.
//
// Bound on the H100: ~4 * D flops per (query, visible key) pair against
// q, k, v and O read or written once. At the forward cell's shape (bh 32,
// T 2048, D 64, causal) that is operations: 17.2 GFLOP over 989 TFLOP/s
// bf16 = 0.0174 ms. At the train shape (bh 128, T 1024, D 128, causal) it
// is bytes: 4 x 33.5 MB over 3.35 TB/s = 0.0402 ms.
//
// bf16 (the model's dtype): one warpgroup (128 threads) per 64-row Q tile,
// built from the Hopper blocks of hopper.cuh:
//   - K/V tiles (kBK rows: 128 at D 32/64, 64 at D 128) come by TMA into a
//     ring of swizzled shared-memory stages, each completing on its own
//     mbarrier; thread 0 refills a stage as soon as all four warps are past
//     their products on it (a named barrier), so the next tiles' loads run
//     under this tile's math. No thread spends registers or instructions on
//     a copy, and there is no per-element V transpose.
//   - S = (q * scale) . K^T is one wgmma chain with Q and K read straight
//     from shared memory (K-major descriptors); O += P . V is a wgmma with
//     P as its register A operand (the S accumulator's layout is the A
//     fragment's) and V read MN-major (transpose-B) from its row-major
//     tile. Shared-memory bandwidth no longer paces the tensor cores: each
//     operand byte is read once per 64-row product, not once per warp.
//   - the online softmax runs on the accumulator in registers, in base 2
//     (exp2f of S * log2 e), its max and sum reduced over the quad that
//     holds a row; lse goes back to natural-log units.
//   - a box past a head's last key row is zero-filled by TMA (3-D maps
//     [bh, S, D]), and those keys are masked at -1e30 like the causal
//     future; causal blocks stop at the diagonal, heaviest Q tiles first.
// f32 (tests and checks), and bf16 at D = 256, which the wgmma kernel does
// not take: plain f32 FMAs from shared memory, 64x64 tiles (at D = 256,
// 214,016 B of shared memory and four threads a row). Above 256, D a
// multiple of 256: the same block walking D in 256-column chunks, the grid
// split over the output's chunks (flash_fwd_wide_kernel).
// Both keep the Pallas rounding points: q * scale in the input dtype, P cast
// to V's dtype before P.V, f32 accumulation.
// Not yet done (later work): persistent blocks, and on them
// FlashAttention-3's block (128-row Q tiles over two consumer warpgroups, a
// producer warpgroup, setmaxnreg; without persistence its one block per SM
// loses to 2-3 of these blocks overlapping); overlap of the softmax with
// the next Q.K^T inside a warpgroup.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;  // the wgmma kernel's warpgroup (FMA kernels: FmaGeom)
constexpr int kBQ = 64;
constexpr int kBK = 64;  // FMA kernel's key tile, and the granularity of S

template <typename T, int D>
__global__ void __launch_bounds__(FmaGeom<D>::kThreads) flash_fwd_fma_kernel(
    const T* __restrict__ q,  // [bh, T, D]
    const T* __restrict__ k,  // [bh, S, D]
    const T* __restrict__ v,  // [bh, S, D]
    T* __restrict__ o,        // [bh, T, D]
    float* __restrict__ lse,  // [bh, 1, T]
    int t_len, int s_len, int causal, float scale) {
  constexpr int TPR = FmaGeom<D>::kTpr, NT = FmaGeom<D>::kThreads;  // threads a row, a block
  constexpr int LD = D + 1;    // padded rows: conflict-free column reads
  constexpr int LP = kBK + 1;
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;           // 16-byte chunks per row
  constexpr int CH = kBK * CPR / NT;    // chunks per thread per K/V tile
  constexpr int HD = D / TPR;           // output columns per thread
  constexpr int HK = kBK / TPR;         // score columns per thread
  static_assert((kBK * CPR) % NT == 0, "tile must split evenly");

  extern __shared__ float sm[];
  float* qs = sm;             // [kBQ][LD] q * scale, rounded to T
  float* ks = qs + kBQ * LD;  // [kBK][LD]
  float* vs = ks + kBK * LD;  // [kBK][LD]
  float* ps = vs + kBK * LD;  // [kBQ][LP] P rounded to T

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, r = tid / TPR, hf = tid % TPR;  // row, and part of it
  const int q_pos = qi * kBQ + r;
  const T* qb = q + ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const T* kbase = k + (size_t)bh * s_len * D;
  const T* vbase = v + (size_t)bh * s_len * D;
  const float scale_t = round_to<T>(scale);

  tile_to_smem<T, D, kBQ, LD, NT>(qs, qb, tid, scale_t, true);

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
      const int idx = tid + c * NT;
      const size_t off = ((size_t)kb * kBK + idx / CPR) * D + (idx % CPR) * VN;
      kbuf[c] = *reinterpret_cast<const uint4*>(kbase + off);
      vbuf[c] = *reinterpret_cast<const uint4*>(vbase + off);
    }
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * NT;
      const int row = idx / CPR, col = (idx % CPR) * VN;
      store_vec<T>(ks + row * LD + col, kbuf[c]);
      store_vec<T>(vs + row * LD + col, vbuf[c]);
    }
    __syncthreads();

    // scores of row r against columns TPR * j + hf
    float s[HK];
#pragma unroll
    for (int j = 0; j < HK; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < HK; ++j) s[j] += qd * ks[(TPR * j + hf) * LD + d];
    }
    if (causal) {
#pragma unroll
      for (int j = 0; j < HK; ++j)
        if (kb * kBK + TPR * j + hf > q_pos) s[j] = -1e30f;
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < HK; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      ps[r * LP + TPR * j + hf] = round_to<T>(p);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * alpha + sum;
    m = m_new;
    __syncthreads();  // the row's P is complete

#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float pc = ps[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] += pc * vs[c * LD + TPR * j + hf];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  T* ob = o + ((size_t)bh * t_len + q_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) ob[TPR * j + hf] = from_f<T>(acc[j] / l_safe);
  if (hf == 0) lse[(size_t)bh * t_len + q_pos] = m + logf(l_safe);
}

// head_dim above 256 (any multiple of kWideChunk, f32 or bf16): the FMA
// kernel's block on FmaGeom<kWideChunk>, with D walked in chunks. Block
// (bh, Q tile, oc) writes output columns [oc * 256, oc * 256 + 256): per key
// tile, S accumulates over every chunk of q * scale and K (each staged in
// shared memory in turn), then P . V reads only V's chunk oc. Every block of
// a Q tile computes the same S, so the row max, sum and lse agree; the
// oc = 0 block writes lse.
template <typename T>
__global__ void __launch_bounds__(FmaGeom<kWideChunk>::kThreads) flash_fwd_wide_kernel(
    const T* __restrict__ q,  // [bh, T, D]
    const T* __restrict__ k,  // [bh, S, D]
    const T* __restrict__ v,  // [bh, S, D]
    T* __restrict__ o,        // [bh, T, D]
    float* __restrict__ lse,  // [bh, 1, T]
    int t_len, int s_len, int d, int causal, float scale) {
  constexpr int DC = kWideChunk;
  constexpr int TPR = FmaGeom<DC>::kTpr, NT = FmaGeom<DC>::kThreads;
  constexpr int LD = DC + 1, LP = kBK + 1;
  constexpr int HD = DC / TPR, HK = kBK / TPR;

  extern __shared__ float sm[];
  float* qs = sm;             // [kBQ][LD] a chunk of q * scale, rounded to T
  float* ks = qs + kBQ * LD;  // [kBK][LD] a chunk of K, then chunk oc of V
  float* ps = ks + kBK * LD;  // [kBQ][LP] P rounded to T

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int oc = blockIdx.y, n_c = d / DC;
  const int tid = threadIdx.x, r = tid / TPR, hf = tid % TPR;
  const int q_pos = qi * kBQ + r;
  const T* qb = q + ((size_t)bh * t_len + (size_t)qi * kBQ) * d;
  const T* kbase = k + (size_t)bh * s_len * d;
  const T* vbase = v + (size_t)bh * s_len * d;
  const float scale_t = round_to<T>(scale);

  float m = -INFINITY, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;

  int n_kb = s_len / kBK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const size_t k_off = (size_t)kb * kBK * d;
    float s[HK];
#pragma unroll
    for (int j = 0; j < HK; ++j) s[j] = 0.f;
    for (int c = 0; c < n_c; ++c) {
      __syncthreads();  // every thread is done with the previous chunk (or V)
      tile_to_smem<T, DC, kBQ, LD, NT>(qs, qb + c * DC, tid, scale_t, true, d);
      tile_to_smem<T, DC, kBK, LD, NT>(ks, kbase + k_off + c * DC, tid, 1.f, false, d);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        const float qd = qs[r * LD + dd];
#pragma unroll
        for (int j = 0; j < HK; ++j) s[j] += qd * ks[(TPR * j + hf) * LD + dd];
      }
    }
    if (causal) {
#pragma unroll
      for (int j = 0; j < HK; ++j)
        if (kb * kBK + TPR * j + hf > q_pos) s[j] = -1e30f;
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < HK; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      ps[r * LP + TPR * j + hf] = round_to<T>(p);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * alpha + sum;
    m = m_new;
    __syncthreads();  // the row's P is complete, and K's last chunk is read
    tile_to_smem<T, DC, kBK, LD, NT>(ks, vbase + k_off + oc * DC, tid, 1.f, false, d);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float pc = ps[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] += pc * ks[c * LD + TPR * j + hf];
    }
  }

  const float l_safe = fmaxf(l, 1e-30f);
  T* ob = o + ((size_t)bh * t_len + q_pos) * d + oc * DC;
#pragma unroll
  for (int j = 0; j < HD; ++j) ob[TPR * j + hf] = from_f<T>(acc[j] / l_safe);
  if (oc == 0 && hf == 0) lse[(size_t)bh * t_len + q_pos] = m + logf(l_safe);
}

// The bf16 kernel's key-tile rows and K/V ring stages by head_dim (the
// stages bound shared memory: 2-3 blocks share an SM)
template <int D> struct WgTiles;
template <> struct WgTiles<32> { static constexpr int kBK = 128, kStages = 2; };
template <> struct WgTiles<64> { static constexpr int kBK = 128, kStages = 2; };
template <> struct WgTiles<128> { static constexpr int kBK = 64, kStages = 2; };

// Shared-memory plan of the bf16 kernel: the Q tile, then the K/V ring,
// each tile laid out as hopper::TileBoxes<D>
template <int D> struct WgLayout {
  static constexpr int kBK = WgTiles<D>::kBK;
  static constexpr int kStages = WgTiles<D>::kStages;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (kStages + 1);  // + alignment slack
};

// Key tile kb of K and V into one ring stage, completing on its barrier
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        uint32_t k_dst, uint32_t v_dst, uint32_t bar, int kb,
                                        int bh) {
  using L = WgLayout<D>;
  hopper::mbar_arrive_expect_tx(bar, 2 * L::kTileBytes);
  hopper::tma_load_tile<D, L::kBK>(k_dst, k_map, bar, kb * L::kBK, bh);
  hopper::tma_load_tile<D, L::kBK>(v_dst, v_map, bar, kb * L::kBK, bh);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,  // [bh, T, D] bf16, box [kBQ, kCols]
    const __grid_constant__ CUtensorMap k_map,  // [bh, S, D] bf16, box [kBK, kCols]
    const __grid_constant__ CUtensorMap v_map,  // [bh, S, D] bf16, box [kBK, kCols]
    __nv_bfloat16* __restrict__ o,              // [bh, T, D]
    float* __restrict__ lse,                    // [bh, 1, T]
    int t_len, int s_len, int causal, float scale) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  using L = WgLayout<D>;
  constexpr int BK = L::kBK, NS = L::kStages;
  constexpr int NT = BK / 8;  // score column tiles
  constexpr int DT = D / 8;   // output column tiles
  constexpr float kLog2e = 1.4426950408889634f;
  static_assert(kThreads == 128 && kBQ == 64, "one warpgroup, one wgmma row block");

  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024 B: the swizzle atom is 8 rows of 128 B
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  bf16* q_tile = reinterpret_cast<bf16*>(smem_raw + (base - raw));
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQBytes;       // stage st at + st * kTileBytes
  const uint32_t v_s = k_s + NS * L::kTileBytes;
  const uint32_t full = base + L::kBarOffset;   // stage st's barrier at + 8 * st
  const uint32_t q_bar = full + 8 * NS;

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;

  int n_kb = (s_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / BK + 1);

  // thread 0 owns the barriers and issues every TMA load; ring stage st
  // holds key tiles kb with kb % NS == st
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(full + 8 * st, 1);
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(q_bar, L::kQBytes);
    tma_load_tile<D, kBQ>(q_s, &q_map, q_bar, qi * kBQ, bh);
    for (int kb = 0; kb < NS && kb < n_kb; ++kb)
      load_kv<D>(&k_map, &v_map, k_s + kb * L::kTileBytes, v_s + kb * L::kTileBytes,
                 full + 8 * kb, kb, bh);
  }

  // q * scale rounded to bf16, in place (elementwise, so the swizzle does
  // not matter), then fenced so that wgmma reads the scaled tile
  mbar_wait(q_bar, 0);
  scale_bf16_tile<L::kQBytes, kThreads>(q_tile, tid, round_to<bf16>(scale));
  fence_proxy_async();
  named_barrier_sync(1, kThreads);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int q_pos0 = qi * kBQ + r0, q_pos1 = q_pos0 + 8;
  float s[BK / 2], acc[D / 2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % NS;
    const uint32_t k_tile = k_s + st * L::kTileBytes, v_tile = v_s + st * L::kTileBytes;
    mbar_wait(full + 8 * st, (kb / NS) & 1);
    __syncwarp();

    // S = (q * scale) . K^T, both operands K-major in shared memory
    fence_operand(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, kmajor_desc<D>(q_s, kBQ, kk), kmajor_desc<D>(k_tile, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // -1e30 for the causal future and for keys past S (a box that runs
    // past the head's last row is zero-filled, and a zero key scores 0)
    if ((causal && kb * BK + BK - 1 > qi * kBQ) || kb * BK + BK > s_len) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = kb * BK + nt * 8 + 2 * t4 + e;
          const bool past = k_pos >= s_len;
          if (past || (causal && k_pos > q_pos0)) s[4 * nt + e] = -1e30f;
          if (past || (causal && k_pos > q_pos1)) s[4 * nt + 2 + e] = -1e30f;
        }
    }
    // online softmax in base 2: a row's scores sit in the 4 threads of a quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f((m0 - mn0) * kLog2e), a1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * kLog2e, ms1 = mn1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[NT][2];  // P rounded to bf16, packed as A-fragment halves
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p00 = exp2f(fmaf(s[4 * nt], kLog2e, -ms0));
      const float p01 = exp2f(fmaf(s[4 * nt + 1], kLog2e, -ms0));
      const float p10 = exp2f(fmaf(s[4 * nt + 2], kLog2e, -ms1));
      const float p11 = exp2f(fmaf(s[4 * nt + 3], kLog2e, -ms1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pf[nt][0] = pack_bf16(p00, p01);
      pf[nt][1] = pack_bf16(p10, p11);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }

    // O += P . V: P from registers (the S accumulator of column tiles 2kk
    // and 2kk + 1 is the A fragment of k-step kk), V read MN-major
    // (transpose-B) from its row-major tile
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
      wgmma_rs<D>(acc, a, mnmajor_desc<D>(v_tile, BK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);

    // every warp has waited out its products on this stage: hand it back
    named_barrier_sync(1, kThreads);
    if (tid == 0 && kb + NS < n_kb)
      load_kv<D>(&k_map, &v_map, k_tile, v_tile, full + 8 * st, kb + NS, bh);
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
    *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(acc[4 * j] / ls0, acc[4 * j + 1] / ls0);
    *reinterpret_cast<uint32_t*>(o1 + j * 8) =
        pack_bf16(acc[4 * j + 2] / ls1, acc[4 * j + 3] / ls1);
  }
  if (t4 == 0) {
    lse[(size_t)bh * t_len + q_pos0] = m0 + logf(ls0);
    lse[(size_t)bh * t_len + q_pos1] = m1 + logf(ls1);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                         int t, int s, int causal, float scale, cudaStream_t stream) {
  using L = WgLayout<D>;
  // the maps hold this call's pointers, so they are encoded per call
  CUtensorMap q_map, k_map, v_map;
  if (hopper::encode_tile_map<D>(&q_map, q, t, bh, kBQ) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&k_map, k, s, bh, L::kBK) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&v_map, v, s, bh, L::kBK) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)bh * (unsigned)(t / kBQ), kThreads, L::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, t, s, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int t, int s, int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D <= 128) {
    return launch_wgmma<D>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
  } else {  // f32, and bf16 at D = 256
    const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
    auto kern = flash_fwd_fma_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)bh * (unsigned)(t / kBQ), FmaGeom<D>::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, t, s, causal, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int t, int s, int d, int causal, float scale, cudaStream_t stream) {
  constexpr int DC = kWideChunk;
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (DC + 1) + kBQ * (kBK + 1));
  auto kern = flash_fwd_wide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh * (unsigned)(t / kBQ), (unsigned)(d / DC));
  kern<<<grid, FmaGeom<DC>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, t, s, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int t, int s, int causal, float scale, cudaStream_t stream) {
  if (d > kWideChunk && d % kWideChunk == 0)
    return launch_wide<T>(q, k, v, o, lse, bh, t, s, d, causal, scale, stream);
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, bh, t, s, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success; cudaErrorInvalidValue
// also for a tensor map that cuTensorMapEncodeTiled refuses). D is 32, 64,
// 128, 256 or a larger multiple of 256; T and S must be multiples of 64; the caller allocates o and lse and checks shapes,
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
