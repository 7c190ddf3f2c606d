// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py
// _paged_kernel (launched by paged_attention_decode): one query token per
// slot attends over the slot's pages of a head-major pool
// [KH, N, page, D], walking its block-table row, with an online softmax.
//
// Bound on the H100: memory bandwidth. Each (slot, kv head) reads
// 2 * len * D * bytes of K/V and does ~4 * G * len * D flops, far below the
// card's ~295 flops per byte. Design for that:
//   - one block per (slot, kv head); the G query rows of the head share
//     every K/V byte the block reads;
//   - 64 tokens (several pages) per iteration, fetched with coalesced
//     16-byte loads that are all issued before the first use, so each
//     block keeps 8-16 KB in flight;
//   - the block reads its own block-table row and length from device
//     memory, page id by page id; nothing stages the whole table (the
//     Pallas version puts all of it in SMEM, which bounds B * P_max);
//   - only ceil(len / page) pages are visited, and tokens past the length
//     are neither loaded nor summed;
//   - running max, sum and output stay in f32; P is rounded to the input
//     dtype before P.V and q * scale is formed in the input dtype, as the
//     Pallas kernel does.
// Not yet done (later work): splitting a long sequence over several blocks
// (flash-decoding), which the engine's small batches at short lengths need
// to fill 132 SMs, and cp.async/TMA double buffering.
#include "common.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;     // tokens per iteration (two per lane in step 3)
constexpr int kMaxPairs = 8;  // (g, d) outputs per thread: G * D <= 1024

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,        // [B, KH, G, D]
    const T* __restrict__ k_pages,  // [KH, N, page, D]
    const T* __restrict__ v_pages,  // [KH, N, page, D]
    const int* __restrict__ tables,   // [B, P_max]
    const int* __restrict__ lengths,  // [B]
    T* __restrict__ out,              // [B, KH, G, D]
    int kh, int g, int n_pages, int page, int p_max, float scale) {
  constexpr int LD = D + 1;  // padded row: conflict-free column reads
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;                 // 16-byte chunks per row
  constexpr int CH = kTile * CPR / kThreads;  // chunks per thread per tensor
  static_assert(kTile == 64, "step 3 gives each lane two tokens");
  static_assert((kTile * CPR) % kThreads == 0, "tile must split evenly");

  extern __shared__ float sm[];
  float* ks = sm;               // [kTile][LD]
  float* vs = ks + kTile * LD;  // [kTile][LD]
  float* qs = vs + kTile * LD;  // [g][D]
  float* ss = qs + g * D;       // [g][kTile] scores, then rounded P
  float* m_s = ss + g * kTile;  // [g] running max
  float* l_s = m_s + g;         // [g] running sum
  float* a_s = l_s + g;         // [g] this tile's rescale factor

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int length = lengths[b];
  const int live = min(p_max, (length + page - 1) / page);
  const int n_valid = min(length, live * page);
  const float scale_t = round_to<T>(scale);

  const T* qb = q + ((size_t)b * kh + h) * g * D;
  for (int i = tid; i < g * D; i += kThreads) qs[i] = round_to<T>(to_f(qb[i]) * scale_t);
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float o[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) o[j] = 0.f;
  __syncthreads();

  const int* table = tables + (size_t)b * p_max;
  const size_t head_off = (size_t)h * n_pages * page * D;
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = 0; t0 < n_valid; t0 += kTile) {
    // 1. this tile's K/V rows into registers, then f32 shared memory
    uint4 kbuf[CH], vbuf[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int pos = t0 + idx / CPR, col = (idx % CPR) * VN;
      if (pos < n_valid) {
        const int pid = table[pos / page];
        const size_t off = head_off + ((size_t)pid * page + pos % page) * D + col;
        kbuf[c] = *reinterpret_cast<const uint4*>(k_pages + off);
        vbuf[c] = *reinterpret_cast<const uint4*>(v_pages + off);
      } else {
        kbuf[c] = make_uint4(0, 0, 0, 0);
        vbuf[c] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int tok = idx / CPR, col = (idx % CPR) * VN;
      store_vec<T>(ks + tok * LD + col, kbuf[c]);
      store_vec<T>(vs + tok * LD + col, vbuf[c]);
    }
    __syncthreads();

    // 2. scores [g][kTile]; positions at or past the length are masked
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, tok = i % kTile;
      float s = -1e30f;
      if (t0 + tok < n_valid) {
        s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s += qs[gi * D + d] * ks[tok * LD + d];
      }
      ss[i] = s;
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      const float s0 = ss[gi * kTile + lane], s1 = ss[gi * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      ss[gi * kTile + lane] = round_to<T>(p0);
      ss[gi * kTile + lane + 32] = round_to<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // 4. O = O * alpha + P.V over the tile's valid tokens
    const int nt = min(kTile, n_valid - t0);
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int i = tid + j * kThreads;
      if (i < g * D) {
        const int gi = i / D, d = i % D;
        float acc = 0.f;
        for (int tok = 0; tok < nt; ++tok) acc += ss[gi * kTile + tok] * vs[tok * LD + d];
        o[j] = o[j] * a_s[gi] + acc;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * kh + h) * g * D;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int i = tid + j * kThreads;
    if (i < g * D) ob[i] = from_f<T>(o[j] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, int b, int kh, int g, int n_pages,
                   int page, int p_max, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + g * D + g * kTile + 3 * g);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(b, kh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, static_cast<T*>(out), kh, g, n_pages, page, p_max, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const int* tables,
                       const int* lengths, void* out, int b, int kh, int g, int n_pages,
                       int page, int p_max, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, tables, lengths, out, b, kh, g, n_pages, page, p_max,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, tables, lengths, out, b, kh, g, n_pages, page, p_max,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, tables, lengths, out, b, kh, g, n_pages, page, p_max,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). The caller allocates
// `out` and checks shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int ray_paged_attention_decode(const void* q, const void* k_pages,
                                          const void* v_pages, const void* tables,
                                          const void* lengths, void* out, int b, int kh, int g,
                                          int d, int n_pages, int page, int p_max, float scale,
                                          int dtype, void* stream) {
  if (b == 0) return cudaSuccess;
  if (page < 1 || g * d > kThreads * kMaxPairs) return cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k_pages, v_pages, tbl, len, out, b, kh, g, n_pages, page,
                             p_max, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, tbl, len, out, b, kh, g, n_pages,
                                     page, p_max, scale, s);
  return cudaErrorInvalidValue;
}
