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
//   - bf16 dK/dV (the model's dtype): one warpgroup (128 threads) per
//     (bh, 64-key tile), built from the Hopper blocks of hopper.cuh. K and
//     V arrive once by TMA and stay in swizzled shared memory as the A
//     operands of S^T = K.(q * scale)^T and dP^T = V.dO^T; the dK and dV
//     accumulators (64 x D f32 each) stay in registers for the whole walk.
//     The walk's Q tiles stream with their dO tiles, lse and delta by TMA
//     through a ring of mbarrier-completed stages that thread 0 refills once
//     all four warps are past their products on one (a named barrier), so
//     the next tiles' loads run under this tile's math. Five wgmma products
//     a tile: S^T and dP^T read the Q and dO tiles K-major; dV += P^T_hi.dO
//     + P^T_lo.dO and dK += dS^T.(q * scale) take P^T and dS^T from
//     registers (the S^T accumulator's layout is the A fragment's) and read
//     the same dO and Q tiles MN-major (transpose-B), so nothing is copied
//     transposed. P is formed while dP^T runs and dV is issued before dP^T
//     is read; dK runs while the next Q tile is scaled (q * scale, rounded
//     to bf16, in place and fenced for the async proxy). A key tile that no
//     query sees (causal, ki * 64 >= T) writes zeros and issues nothing;
//     T = 0 is a memset, since a tensor map cannot have an empty dimension.
//   - bf16 dQ: the forward's block on the same Hopper blocks: one
//     warpgroup per (bh, 64-row Q tile), heaviest causal tiles first. The
//     Q and dO tiles arrive once by TMA and stay resident (Q scaled in
//     place to bf16(q * scale) and fenced for the async proxy), as do each
//     thread's two lse and delta values and the 64 x D f32 dQ accumulator.
//     K/V tiles (DqTiles: 64 keys at D = 64/128, 128 at D = 32) stream by
//     TMA through a ring of mbarrier-completed stages that thread 0 refills
//     once all four warps are past their products on one (a named
//     barrier). Three wgmma products a key tile: S = (q * scale).K^T and
//     dP = dO.V^T read both operands K-major, in two groups, so that P is
//     formed (and masked on the diagonal tile and past S) while dP runs;
//     dS = P * (dP - delta) is rounded to bf16 into A fragments (the S
//     accumulator's layout is the A fragment's) and dQ += dS.K reads the
//     same K tile MN-major (transpose-B), so nothing is copied transposed.
//   - f32 (tests and checks), and bf16 at D = 256, which the wgmma kernels
//     do not take: plain f32 FMAs from shared memory, two threads a row (at
//     D = 256 four, with 32-row tiles walked beside the resident 64-row
//     one, to fit 227 KB of shared memory: FmaGeom in common.cuh).
//   - the Pallas rounding points: q * scale rounded to the input dtype, dO
//     and dP in f32, dS rounded to the input dtype before dS.K and
//     dS^T.(scale * Q), dQ scaled once more at the end, dK not. Pallas
//     keeps P in f32 for dV = P^T.dO (dO was cast to f32). The bf16 kernel
//     keeps that: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//     and dV takes both products (dO is bf16, so each product is exact),
//     which leaves P's error near 2^-17 of P instead of the 2^-9 of
//     rounding it as FlashAttention-2 does on GPUs, at one extra product
//     of the four; dS is formed from P_hi + P_lo.
//   - masked entries (k_pos > q_pos) take S = -1e30 and underflow to
//     exactly 0 through exp(S - lse); padded query rows have dO = 0 and
//     delta = 0, so they add nothing to dK/dV.
// Not yet done (later work): persistent blocks; overlapping one key tile's
// dS.K with the next tile's S and dP; FlashAttention-2's single pass with
// atomic dQ.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;  // wgmma: a warpgroup (FMA kernels: FmaGeom)
constexpr int kBQ = 64;        // Q tile of the dQ kernels (and of the FMA dK/dV kernel below D = 256)
constexpr int kBK = 64;        // K tile of the dK/dV kernels (and of the FMA dQ kernel below D = 256)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32 (and any T): FMA kernels
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(FmaGeom<D>::kThreads) flash_bwd_dq_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int t_len, int s_len, int causal, float scale) {
  constexpr int TPR = FmaGeom<D>::kTpr, NT = FmaGeom<D>::kThreads;  // threads a row, a block
  constexpr int BK = FmaGeom<D>::kWalk;  // key tile
  constexpr int LD = D + 1;  // padded rows: conflict-free column reads
  constexpr int LP = BK + 1;
  constexpr int HD = D / TPR;  // dq columns per thread
  constexpr int HK = BK / TPR;  // score columns per thread

  extern __shared__ float sm[];
  float* qs = sm;              // [kBQ][LD] q * scale, rounded to T
  float* dos = qs + kBQ * LD;  // [kBQ][LD]
  float* ks = dos + kBQ * LD;  // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* dss = vs + BK * LD;   // [kBQ][LP] dS rounded to T

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, r = tid / TPR, hf = tid % TPR;  // row, and part of it
  const int q_pos = qi * kBQ + r;
  const size_t q_off = ((size_t)bh * t_len + (size_t)qi * kBQ) * D;
  const T* kbase = k + (size_t)bh * s_len * D;
  const T* vbase = v + (size_t)bh * s_len * D;

  tile_to_smem<T, D, kBQ, LD, NT>(qs, q + q_off, tid, round_to<T>(scale), true);
  tile_to_smem<T, D, kBQ, LD, NT>(dos, dout + q_off, tid, 1.f, false);
  const float lse_r = lse[(size_t)bh * t_len + q_pos];
  const float delta_r = delta[(size_t)bh * t_len + q_pos];

  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;

  int n_kb = s_len / BK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / BK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // every thread is done with the previous K/V and dS
    tile_to_smem<T, D, BK, LD, NT>(ks, kbase + (size_t)kb * BK * D, tid, 1.f, false);
    tile_to_smem<T, D, BK, LD, NT>(vs, vbase + (size_t)kb * BK * D, tid, 1.f, false);
    __syncthreads();

    // S and dP of row r against columns TPR * j + hf
    float s[HK], dp[HK];
#pragma unroll
    for (int j = 0; j < HK; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d], od = dos[r * LD + d];
#pragma unroll
      for (int j = 0; j < HK; ++j) {
        s[j] += qd * ks[(TPR * j + hf) * LD + d];
        dp[j] += od * vs[(TPR * j + hf) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const int c = TPR * j + hf;
      const float sv = (causal && kb * BK + c > q_pos) ? -1e30f : s[j];
      const float p = expf(sv - lse_r);
      dss[r * LP + c] = round_to<T>(p * (dp[j] - delta_r));
    }
    __syncthreads();  // the row's dS is complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float dsc = dss[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] += dsc * ks[c * LD + TPR * j + hf];
    }
  }

  T* out = dq + ((size_t)bh * t_len + q_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) out[TPR * j + hf] = from_f<T>(acc[j] * scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(FmaGeom<D>::kThreads) flash_bwd_dkv_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len, int causal, float scale) {
  constexpr int TPR = FmaGeom<D>::kTpr, NT = FmaGeom<D>::kThreads;  // threads a row, a block
  constexpr int BQ = FmaGeom<D>::kWalk;  // Q tile
  constexpr int LD = D + 1;
  constexpr int LP = BQ + 1;
  constexpr int HD = D / TPR;  // dk/dv columns per thread
  constexpr int HQ = BQ / TPR;  // score columns (queries) per thread

  extern __shared__ float sm[];
  float* ks = sm;              // [kBK][LD]
  float* vs = ks + kBK * LD;   // [kBK][LD]
  float* qs = vs + kBK * LD;   // [BQ][LD] q * scale, rounded to T
  float* dos = qs + BQ * LD;   // [BQ][LD]
  float* ps = dos + BQ * LD;   // [kBK][LP] P^T in f32
  float* dss = ps + kBK * LP;  // [kBK][LP] dS^T rounded to T
  float* lse_s = dss + kBK * LP;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int nk = s_len / kBK;
  const int bh = blockIdx.x / nk;
  const int ki = (int)(blockIdx.x % nk);  // causal: early K tiles see the most Q tiles
  const int tid = threadIdx.x, r = tid / TPR, hf = tid % TPR;  // row, and part of it
  const int k_pos = ki * kBK + r;
  const size_t k_off = ((size_t)bh * s_len + (size_t)ki * kBK) * D;
  const float scale_t = round_to<T>(scale);

  tile_to_smem<T, D, kBK, LD, NT>(ks, k + k_off, tid, 1.f, false);
  tile_to_smem<T, D, kBK, LD, NT>(vs, v + k_off, tid, 1.f, false);

  float dka[HD], dva[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) dka[j] = dva[j] = 0.f;

  const int n_qb = t_len / BQ;
  const int qb_start = causal ? ki * kBK / BQ : 0;  // earlier Q tiles see nothing
  for (int qb = qb_start; qb < n_qb; ++qb) {
    __syncthreads();  // every thread is done with the previous Q tile
    const size_t q_off = ((size_t)bh * t_len + (size_t)qb * BQ) * D;
    tile_to_smem<T, D, BQ, LD, NT>(qs, q + q_off, tid, scale_t, true);
    tile_to_smem<T, D, BQ, LD, NT>(dos, dout + q_off, tid, 1.f, false);
    if (tid < BQ) lse_s[tid] = lse[(size_t)bh * t_len + qb * BQ + tid];
    else if (tid < 2 * BQ) delta_s[tid - BQ] = delta[(size_t)bh * t_len + qb * BQ + tid - BQ];
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
        s[j] += kd * qs[(TPR * j + hf) * LD + d];
        dp[j] += vd * dos[(TPR * j + hf) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < HQ; ++j) {
      const int c = TPR * j + hf;
      const float sv = (causal && k_pos > qb * BQ + c) ? -1e30f : s[j];
      const float p = expf(sv - lse_s[c]);
      ps[r * LP + c] = p;
      dss[r * LP + c] = round_to<T>(p * (dp[j] - delta_s[c]));
    }
    __syncthreads();  // the row's P^T and dS^T are complete

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      const float pc = ps[r * LP + c], dsc = dss[r * LP + c];
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        dva[j] += pc * dos[c * LD + TPR * j + hf];
        dka[j] += dsc * qs[c * LD + TPR * j + hf];
      }
    }
  }

  T* dk_row = dk + ((size_t)bh * s_len + k_pos) * D;
  T* dv_row = dv + ((size_t)bh * s_len + k_pos) * D;
#pragma unroll
  for (int j = 0; j < HD; ++j) {
    dk_row[TPR * j + hf] = from_f<T>(dka[j]);
    dv_row[TPR * j + hf] = from_f<T>(dva[j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernels (hopper.cuh)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// The bf16 dQ kernel's key-tile rows (the N of S and dP, the contraction
// of dS.K) and K/V ring stages by head_dim, timed by flash_tiles.py dq at
// D = 64 and 128 (at D = 64, 128-key tiles take 234 registers and lose to
// 64-key tiles at 122); D = 32 is not timed and keeps 128-key tiles, whose
// last tile may end inside S
template <int D> struct DqTiles;
template <> struct DqTiles<32> { static constexpr int kBK = 128, kStages = 2; };
template <> struct DqTiles<64> { static constexpr int kBK = 64, kStages = 3; };
template <> struct DqTiles<128> { static constexpr int kBK = 64, kStages = 2; };

// Shared-memory plan of the bf16 dQ kernel (offsets from a 1024 B aligned
// base): the Q and dO tiles, then the ring's K tiles and V tiles, stage
// after stage, then the barriers (one per stage, then Q/dO's). Tiles are
// laid out as hopper::TileBoxes<D>.
template <int D> struct DqLayout {
  static constexpr int kBK = DqTiles<D>::kBK;
  static constexpr int kStages = DqTiles<D>::kStages;
  static constexpr int kQBytes = kBQ * D * 2;   // the Q or dO tile
  static constexpr int kKVBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kSmem = 1024 + kBar + 8 * (kStages + 1);  // + alignment slack
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "TMA destinations stay aligned");
};

// Key tile kb of K and V into ring stage st, completing on its barrier
template <int D>
__device__ __forceinline__ void load_kv_stage(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                              uint32_t base, int st, int kb, int bh) {
  using L = DqLayout<D>;
  const uint32_t bar = base + L::kBar + 8 * st;
  hopper::mbar_arrive_expect_tx(bar, 2 * L::kKVBytes);
  hopper::tma_load_tile<D, L::kBK>(base + L::kK + st * L::kKVBytes, k_map, bar, kb * L::kBK, bh);
  hopper::tma_load_tile<D, L::kBK>(base + L::kV + st * L::kKVBytes, v_map, bar, kb * L::kBK, bh);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,   // [bh, T, D] bf16, box [kBQ, kCols]
    const __grid_constant__ CUtensorMap k_map,   // [bh, S, D] bf16, box [kBK, kCols]
    const __grid_constant__ CUtensorMap v_map,   // [bh, S, D] bf16, box [kBK, kCols]
    const __grid_constant__ CUtensorMap do_map,  // [bh, T, D] bf16, box [kBQ, kCols]
    const float* __restrict__ lse,               // [bh, 1, T]
    const float* __restrict__ delta,             // [bh, 1, T]
    bf16* __restrict__ dq, int t_len, int s_len, int causal, float scale) {
  using namespace hopper;
  using L = DqLayout<D>;
  constexpr int BK = L::kBK, NS = L::kStages;
  constexpr int NT = BK / 8;  // S and dP column tiles (keys)
  constexpr int DT = D / 8;   // dQ column tiles
  static_assert(kThreads == 128 && kBQ == 64, "one warpgroup, one wgmma row block of queries");

  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024 B: the swizzle atom is 8 rows of 128 B
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + L::kDO;
  const uint32_t full = base + L::kBar;  // stage st's barrier at + 8 * st
  const uint32_t qd_bar = full + 8 * NS;

  const int nq = t_len / kBQ;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int q_pos0 = qi * kBQ + r0, q_pos1 = q_pos0 + 8;

  int n_kb = (s_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (qi * kBQ + kBQ - 1) / BK + 1);

  // thread 0 owns the barriers and issues every TMA load; ring stage st
  // holds key tiles kb with kb % NS == st
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(full + 8 * st, 1);
    mbar_init(qd_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(qd_bar, 2 * L::kQBytes);
    tma_load_tile<D, kBQ>(q_s, &q_map, qd_bar, qi * kBQ, bh);
    tma_load_tile<D, kBQ>(do_s, &do_map, qd_bar, qi * kBQ, bh);
    for (int kb = 0; kb < NS && kb < n_kb; ++kb)
      load_kv_stage<D>(&k_map, &v_map, base, kb, kb, bh);
  }
  // this thread's rows' lse (in base 2) and delta, read while the tiles land
  const size_t row0 = (size_t)bh * t_len + q_pos0;
  const float l0 = lse[row0] * kLog2e, l1 = lse[row0 + 8] * kLog2e;
  const float dl0 = delta[row0], dl1 = delta[row0 + 8];

  // q * scale rounded to bf16, in place, fenced so that wgmma reads the
  // scaled tile
  mbar_wait(qd_bar, 0);
  scale_bf16_tile<L::kQBytes, kThreads>(sm, tid, round_to<bf16>(scale));
  fence_proxy_async();
  named_barrier_sync(1, kThreads);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % NS;
    const uint32_t k_t = base + L::kK + st * L::kKVBytes;
    const uint32_t v_t = base + L::kV + st * L::kKVBytes;
    mbar_wait(full + 8 * st, (kb / NS) & 1);
    __syncwarp();

    // S = (q * scale).K^T and dP = dO.V^T: both operands K-major, two
    // groups, so that P is formed while dP runs. The accumulators start
    // from zeros, so no register of the last tile's stays live into this one.
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, kmajor_desc<D>(q_s, kBQ, kk), kmajor_desc<D>(k_t, BK, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(dp, kmajor_desc<D>(do_s, kBQ, kk), kmajor_desc<D>(v_t, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(s);

    // P = exp(S - lse) in base 2, in place; -1e30 (it underflows to 0) for
    // the causal future and for keys past S (a box that runs past the
    // head's last row is zero-filled)
    const bool edge = (causal && kb * BK + BK - 1 > qi * kBQ) || kb * BK + BK > s_len;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * nt + e], x1 = s[4 * nt + 2 + e];
        if (edge) {
          const int k_pos = kb * BK + nt * 8 + 2 * t4 + e;
          const bool past = k_pos >= s_len;
          if (past || (causal && k_pos > q_pos0)) x0 = -1e30f;
          if (past || (causal && k_pos > q_pos1)) x1 = -1e30f;
        }
        s[4 * nt + e] = exp2f(fmaf(x0, kLog2e, -l0));
        s[4 * nt + 2 + e] = exp2f(fmaf(x1, kLog2e, -l1));
      }
    wgmma_wait<0>();
    fence_operand(dp);

    // dS = P * (dP - delta), rounded to bf16: the accumulator's column
    // tiles 2kk, 2kk + 1 are the A fragment of k-step kk
    uint32_t ds[BK / 4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      ds[2 * nt] =
          pack_bf16(s[4 * nt] * (dp[4 * nt] - dl0), s[4 * nt + 1] * (dp[4 * nt + 1] - dl0));
      ds[2 * nt + 1] =
          pack_bf16(s[4 * nt + 2] * (dp[4 * nt + 2] - dl1), s[4 * nt + 3] * (dp[4 * nt + 3] - dl1));
    }

    // dQ += dS.K: dS from registers, K read MN-major (transpose-B) from the
    // same tile S read K-major
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      wgmma_rs<D>(acc, a, mnmajor_desc<D>(k_t, BK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    fence_operand(ds);

    // every warp has waited out its products on this stage: hand it back
    named_barrier_sync(1, kThreads);
    if (tid == 0 && kb + NS < n_kb) load_kv_stage<D>(&k_map, &v_map, base, st, kb + NS, bh);
  }

  bf16* o0 = dq + row0 * D + 2 * t4;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(o0 + j * 8) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(o1 + j * 8) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The bf16 dK/dV kernel's Q-tile rows (the N of S^T and dP^T, the
// contraction of dV and dK) and Q/dO ring stages by head_dim, timed by
// flash_tiles.py dkv (registers, not shared memory, hold D = 64 and 128 to
// two blocks an SM)
template <int D> struct DkvTiles;
template <> struct DkvTiles<32> { static constexpr int kQT = 64, kStages = 2; };
template <> struct DkvTiles<64> { static constexpr int kQT = 64, kStages = 3; };
template <> struct DkvTiles<128> { static constexpr int kQT = 64, kStages = 2; };

// Shared-memory plan of the bf16 dK/dV kernel (offsets from a 1024 B
// aligned base): the K and V tiles, then the ring's Q tiles, dO tiles,
// lse rows and delta rows, stage after stage, then the barriers (one per
// stage, then K/V's). Tiles are laid out as hopper::TileBoxes<D>.
template <int D> struct DkvLayout {
  static constexpr int kQT = DkvTiles<D>::kQT;
  static constexpr int kStages = DkvTiles<D>::kStages;
  static constexpr int kKVBytes = kBK * D * 2;   // one K or V tile
  static constexpr int kQBytes = kQT * D * 2;    // one Q or dO tile
  static constexpr int kRowBytes = kQT * 4;      // one tile's lse or delta
  static constexpr int kStageTx = 2 * kQBytes + 2 * kRowBytes;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kLse = kDO + kStages * kQBytes;
  static constexpr int kDelta = kLse + kStages * kRowBytes;
  static constexpr int kBar = kDelta + kStages * kRowBytes;
  static constexpr int kSmem = 1024 + kBar + 8 * (kStages + 1);  // + alignment slack
  static_assert(kQBytes % 1024 == 0 && kRowBytes % 128 == 0, "TMA destinations stay aligned");
};

// Q tile qb of Q, dO, lse and delta into ring stage st, completing on its
// barrier
template <int D>
__device__ __forceinline__ void load_q_stage(const CUtensorMap* q_map, const CUtensorMap* do_map,
                                             const CUtensorMap* lse_map,
                                             const CUtensorMap* delta_map, uint32_t base, int st,
                                             int qb, int bh) {
  using L = DkvLayout<D>;
  const uint32_t bar = base + L::kBar + 8 * st;
  const int row = qb * L::kQT;
  hopper::mbar_arrive_expect_tx(bar, L::kStageTx);
  hopper::tma_load_tile<D, L::kQT>(base + L::kQ + st * L::kQBytes, q_map, bar, row, bh);
  hopper::tma_load_tile<D, L::kQT>(base + L::kDO + st * L::kQBytes, do_map, bar, row, bh);
  hopper::tma_load_3d(base + L::kLse + st * L::kRowBytes, lse_map, bar, row, bh, 0);
  hopper::tma_load_3d(base + L::kDelta + st * L::kRowBytes, delta_map, bar, row, bh, 0);
}

// Split a, b into bf16 hi = bf16(x) and lo = bf16(x - hi), each packed as
// an A-fragment half (a in the low half)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// hi + lo of a split_bf16 pair, back in f32
__device__ __forceinline__ float2 join_bf16(uint32_t hi, uint32_t lo) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  const float2 l = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&lo));
  return make_float2(h.x + l.x, h.y + l.y);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,      // [bh, T, D] bf16, box [kQT, kCols]
    const __grid_constant__ CUtensorMap k_map,      // [bh, S, D] bf16, box [kBK, kCols]
    const __grid_constant__ CUtensorMap v_map,      // [bh, S, D] bf16, box [kBK, kCols]
    const __grid_constant__ CUtensorMap do_map,     // [bh, T, D] bf16, box [kQT, kCols]
    const __grid_constant__ CUtensorMap lse_map,    // [bh, 1, T] f32, box kQT
    const __grid_constant__ CUtensorMap delta_map,  // [bh, 1, T] f32, box kQT
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int s_len, int causal,
    float scale) {
  using namespace hopper;
  using L = DkvLayout<D>;
  constexpr int QT = L::kQT, NS = L::kStages;
  constexpr int NQ = QT / 8;  // S^T column tiles (queries)
  constexpr int DT = D / 8;   // dK/dV column tiles
  static_assert(kThreads == 128 && kBK == 64, "one warpgroup, one wgmma row block of keys");
  static_assert(NS >= 2, "the next Q tile is scaled while this one is in use");

  const int nk = s_len / kBK;
  const int bh = blockIdx.x / nk;
  const int ki = (int)(blockIdx.x % nk);  // causal: early K tiles see the most Q tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  const int k_pos0 = ki * kBK + r0, k_pos1 = k_pos0 + 8;
  bf16* dk0 = dk + ((size_t)bh * s_len + k_pos0) * D + 2 * t4;
  bf16* dv0 = dv + ((size_t)bh * s_len + k_pos0) * D + 2 * t4;

  const int qb_start = causal ? ki * kBK / QT : 0;  // earlier Q tiles see nothing
  const int n = t_len / QT - qb_start;              // Q tiles on the walk
  if (n <= 0) {  // a key tile no query sees: zeros, with no load and no product
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dk0 + j * 8) = 0u;
      *reinterpret_cast<uint32_t*>(dk0 + 8 * D + j * 8) = 0u;
      *reinterpret_cast<uint32_t*>(dv0 + j * 8) = 0u;
      *reinterpret_cast<uint32_t*>(dv0 + 8 * D + j * 8) = 0u;
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024 B: the swizzle atom is 8 rows of 128 B
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + L::kV;
  const uint32_t full = base + L::kBar;  // stage st's barrier at + 8 * st
  const uint32_t kv_bar = full + 8 * NS;
  const float scale_t = round_to<bf16>(scale);

  // thread 0 owns the barriers and issues every TMA load; ring stage st
  // holds the walk's Q tiles j with j % NS == st
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(full + 8 * st, 1);
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kv_bar, 2 * L::kKVBytes);
    tma_load_tile<D, kBK>(k_s, &k_map, kv_bar, ki * kBK, bh);
    tma_load_tile<D, kBK>(v_s, &v_map, kv_bar, ki * kBK, bh);
    for (int j = 0; j < NS && j < n; ++j)
      load_q_stage<D>(&q_map, &do_map, &lse_map, &delta_map, base, j, qb_start + j, bh);
  }
  // q * scale rounded to bf16 in the first tile, in place, fenced so that
  // wgmma reads the scaled tile; each later tile is scaled one step ahead
  mbar_wait(full, 0);
  scale_bf16_tile<L::kQBytes, kThreads>(sm + L::kQ, tid, scale_t);
  fence_proxy_async();
  mbar_wait(kv_bar, 0);
  named_barrier_sync(1, kThreads);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int st = j % NS, qb = qb_start + j;
    const uint32_t q_t = base + L::kQ + st * L::kQBytes;
    const uint32_t do_t = base + L::kDO + st * L::kQBytes;
    const float* lse_t = reinterpret_cast<const float*>(sm + L::kLse + st * L::kRowBytes);
    const float* delta_t = reinterpret_cast<const float*>(sm + L::kDelta + st * L::kRowBytes);

    // S^T = K.(q * scale)^T and dP^T = V.dO^T: both operands K-major, two
    // groups, so that P is formed while dP^T runs. The accumulators start
    // from zeros, so no register of the last tile's stays live into this one.
    float s[QT / 2], dp[QT / 2];
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<QT>(s, kmajor_desc<D>(k_s, kBK, kk), kmajor_desc<D>(q_t, QT, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<QT>(dp, kmajor_desc<D>(v_s, kBK, kk), kmajor_desc<D>(do_t, QT, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(s);

    // P^T = exp(S^T - lse) in base 2, -1e30 where k_pos > q_pos (it
    // underflows to 0), split into bf16 hi + lo: the S^T accumulator's
    // column tiles 2kk, 2kk + 1 are the A fragment of k-step kk
    const bool diag = causal && ki * kBK + kBK - 1 > qb * QT;
    uint32_t ph[QT / 4], pl[QT / 4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int c = nt * 8 + 2 * t4;  // this thread's queries c, c + 1 of the tile
      const float2 ls = *reinterpret_cast<const float2*>(lse_t + c);
      const float l0 = ls.x * kLog2e, l1 = ls.y * kLog2e;
      float x[4] = {s[4 * nt], s[4 * nt + 1], s[4 * nt + 2], s[4 * nt + 3]};
      if (diag) {
        const int q_pos = qb * QT + c;
        if (k_pos0 > q_pos) x[0] = -1e30f;
        if (k_pos0 > q_pos + 1) x[1] = -1e30f;
        if (k_pos1 > q_pos) x[2] = -1e30f;
        if (k_pos1 > q_pos + 1) x[3] = -1e30f;
      }
      split_bf16(exp2f(fmaf(x[0], kLog2e, -l0)), exp2f(fmaf(x[1], kLog2e, -l1)), ph[2 * nt],
                 pl[2 * nt]);
      split_bf16(exp2f(fmaf(x[2], kLog2e, -l0)), exp2f(fmaf(x[3], kLog2e, -l1)),
                 ph[2 * nt + 1], pl[2 * nt + 1]);
    }

    // dV += P^T_hi.dO + P^T_lo.dO: P^T from registers, dO read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
      const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
      const uint64_t b = mnmajor_desc<D>(do_t, QT, kk);
      wgmma_rs<D>(dva, ah, b, 1);
      wgmma_rs<D>(dva, al, b, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T and dP^T are done; dV may still run
    fence_operand(dp);

    // dS^T = P^T * (dP^T - delta), P^T as hi + lo, rounded to bf16
    uint32_t ds[QT / 4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * t4);
      const float2 p0 = join_bf16(ph[2 * nt], pl[2 * nt]);
      const float2 p1 = join_bf16(ph[2 * nt + 1], pl[2 * nt + 1]);
      ds[2 * nt] = pack_bf16(p0.x * (dp[4 * nt] - dl.x), p0.y * (dp[4 * nt + 1] - dl.y));
      ds[2 * nt + 1] =
          pack_bf16(p1.x * (dp[4 * nt + 2] - dl.x), p1.y * (dp[4 * nt + 3] - dl.y));
    }

    // dK += dS^T.(q * scale): dS^T from registers, Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      wgmma_rs<D>(dka, a, mnmajor_desc<D>(q_t, QT, kk), 1);
    }
    wgmma_commit();

    // while dV and dK run: wait for the next Q tile and scale it
    if (j + 1 < n) {
      const int st1 = (j + 1) % NS;
      mbar_wait(full + 8 * st1, ((j + 1) / NS) & 1);
      scale_bf16_tile<L::kQBytes, kThreads>(sm + L::kQ + st1 * L::kQBytes, tid, scale_t);
    }
    fence_proxy_async();  // the scaled tile, and this tile's generic reads, before any TMA
    wgmma_wait<0>();
    fence_operand(dka);
    fence_operand(dva);
    fence_operand(ph);
    fence_operand(pl);
    fence_operand(ds);

    // every warp has waited out its products on this stage: hand it back
    named_barrier_sync(1, kThreads);
    if (tid == 0 && j + NS < n)
      load_q_stage<D>(&q_map, &do_map, &lse_map, &delta_map, base, st, qb + NS, bh);
  }

  // (q * scale) carried the scale into dS^T.Q already: no second factor
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(dk0 + j * 8) = pack_bf16(dka[4 * j], dka[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dk0 + 8 * D + j * 8) = pack_bf16(dka[4 * j + 2], dka[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(dv0 + j * 8) = pack_bf16(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dv0 + 8 * D + j * 8) = pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
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

template <int D>
cudaError_t launch_dq_wgmma(const BwdArgs& a) {
  using L = DqLayout<D>;
  // the maps hold this call's pointers, so they are encoded per call
  CUtensorMap q_map, k_map, v_map, do_map;
  if (hopper::encode_tile_map<D>(&q_map, a.q, a.t, a.bh, kBQ) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&k_map, a.k, a.s, a.bh, L::kBK) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&v_map, a.v, a.s, a.bh, L::kBK) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&do_map, a.dout, a.t, a.bh, kBQ) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  const cudaError_t err = allow_smem(kern, L::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)a.bh * (unsigned)(a.t / kBQ), kThreads, L::kSmem, a.stream>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, static_cast<bf16*>(a.dq), a.t, a.s, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128) {
    return launch_dq_wgmma<D>(a);
  } else {  // f32, and bf16 at D = 256
    constexpr int BK = FmaGeom<D>::kWalk;
    const size_t smem = sizeof(float) * ((2 * kBQ + 2 * BK) * (D + 1) + kBQ * (BK + 1));
    auto kern = flash_bwd_dq_fma_kernel<T, D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)a.bh * (unsigned)(a.t / kBQ), FmaGeom<D>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.t, a.s, a.causal,
        a.scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const BwdArgs& a) {
  using L = DkvLayout<D>;
  if (a.t == 0) {  // no queries: zeros, and no tensor map (the encoder refuses an empty T)
    const size_t bytes = (size_t)a.bh * a.s * D * sizeof(bf16);
    const cudaError_t err = cudaMemsetAsync(a.dk, 0, bytes, a.stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(a.dv, 0, bytes, a.stream);
  }
  // the maps hold this call's pointers, so they are encoded per call
  CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
  if (hopper::encode_tile_map<D>(&q_map, a.q, a.t, a.bh, L::kQT) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&k_map, a.k, a.s, a.bh, kBK) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&v_map, a.v, a.s, a.bh, kBK) != CUDA_SUCCESS ||
      hopper::encode_tile_map<D>(&do_map, a.dout, a.t, a.bh, L::kQT) != CUDA_SUCCESS ||
      hopper::encode_row_map(&lse_map, a.lse, a.t, a.bh, L::kQT) != CUDA_SUCCESS ||
      hopper::encode_row_map(&delta_map, a.delta, a.t, a.bh, L::kQT) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_wgmma_kernel<D>;
  const cudaError_t err = allow_smem(kern, L::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)a.bh * (unsigned)(a.s / kBK), kThreads, L::kSmem, a.stream>>>(
      q_map, k_map, v_map, do_map, lse_map, delta_map, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.t, a.s, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128) {
    return launch_dkv_wgmma<D>(a);
  } else {  // f32, and bf16 at D = 256
    constexpr int BQ = FmaGeom<D>::kWalk;
    const size_t smem = sizeof(float) * ((2 * kBK + 2 * BQ) * (D + 1) +
                                         2 * kBK * (BQ + 1) + 2 * BQ);
    auto kern = flash_bwd_dkv_fma_kernel<T, D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)a.bh * (unsigned)(a.s / kBK), FmaGeom<D>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.t, a.s, a.causal, a.scale);
    return cudaGetLastError();
  }
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
    case 256:
      return is_dq ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool is_dq, const BwdArgs& a, int d, int dtype) {
  // no queries: dQ is empty, but dK/dV still writes zeros
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
