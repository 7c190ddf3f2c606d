// Paged-attention decode for Hopper (sm_90a), split over blocks
// (flash-decoding).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py
// _paged_kernel (launched by paged_attention_decode): one query token per
// slot attends over the slot's pages of a head-major pool [KH, N, page, D],
// walking its block-table row, with an online softmax.
//
// Bound on the H100: memory bandwidth. Each (slot, kv head) reads
// 2 * len * D * bytes of K/V and does ~4 * G * len * D flops: about G flops
// per byte (2 at the flagship, G = 2), far below the card's ~295 flops per
// byte, so the tensor cores would buy nothing and the math stays in f32
// registers. What the design does about the bytes:
//   - the grid is (slot * kv head, split, chunk of query rows); the host
//     picks the split count from B * KH * chunks and the SM count, without
//     reading the lengths, so a small batch still fills the card. Each
//     block takes its share of the slot's device-side length, rounded up to
//     16 tokens; a block whose share is empty writes an empty partial;
//   - a block first loads its share's block-table entries into shared
//     memory, then streams the share's K/V rows through a ring of
//     PagedRing::kStages shared-memory stages of ~16 KB (64 tokens at the
//     flagship's D = 64, bf16) with cp.async (16, 8 or 4 bytes a copy,
//     whichever divides a row; 2-byte rows of an odd bf16 head_dim by plain
//     loads), keeping kStages - 1 stages (~32 KB) in flight while it
//     computes on one; one __syncthreads a stage. Three 16 KB stages let
//     four blocks share an SM (118 registers a thread bound it there too):
//     more or larger stages cost blocks an SM and lose (flash_tiles.py
//     paged);
//   - math in registers: a warp takes 32 / TG tokens at once, TG lanes
//     across a token's row (each lane VPL vectors), and every query row of
//     the chunk reads the same K/V registers, so the G rows of a head share
//     every byte the block moves. Dot products reduce by xor shuffles
//     inside the TG lanes; each lane group keeps its own running max, sum
//     and output, merged at the end over the warp (shuffles) and the four
//     warps (shared memory), in a fixed order;
//   - a deterministic combine in the same launch: with more than one
//     split, each block writes its partial (m, l, o) in f32 to a workspace,
//     takes a ticket from a per-(slot, head, chunk) counter, and the block
//     that draws the last ticket merges all partials in split order, writes
//     the output and resets the counter to 0 for the next launch. Equal
//     inputs give equal bits, whichever block finishes last;
//   - every head_dim from 1 to 256, by instances over (vector bytes, lanes
//     per token, vectors per lane); lanes past a row's end are masked.
//     Above 256, a plain wide kernel (paged_decode_wide_kernel): one query
//     row and 256 output columns a block, rows read from global memory,
//     the same split and combine.
// The Pallas rounding points stay: q * scale is formed in the input dtype,
// P is rounded to the input dtype before P.V, and the running max, sum and
// output are f32. Length 0 gives zeros, as the Pallas kernel's
// o / max(l, 1e-30) does. Only the tokens below the length are loaded and
// summed.
#include <atomic>

#include "common.cuh"

using namespace rtt;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;  // the widest head of paged_decode_kernel's instances
constexpr int kWideCols = 256;    // output columns a block of the wide kernel writes
constexpr int kShareRound = 16;  // a split's share is a multiple of this many tokens

// Bytes of K and V a ring stage aims at (its tokens: this over 2 * row
// bytes, a whole number of the four warps' steps, at most kMaxStageTokens)
// and stages in the ring, timed by flash_tiles.py paged
struct PagedRing { static constexpr int kStageBytes = 16384, kStages = 3; };
constexpr int kMaxStageTokens = 256;

template <int VW> struct Bytes;
template <> struct Bytes<16> { using type = uint4; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<2> { using type = uint16_t; };

// cp.async of VW bytes from global to shared memory (.cg, past L1, for 16
// bytes; .ca for 4 and 8); 2 bytes by a plain load and store
template <int VW>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
  } else if constexpr (VW >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "n"(VW) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VW bytes of T at p (global or shared) into f32 f[0 .. VW / sizeof(T))
template <typename T, int VW>
__device__ __forceinline__ void unpack(const void* p, float* f) {
  const typename Bytes<VW>::type u = *static_cast<const typename Bytes<VW>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VW / (int)sizeof(T); ++i) f[i] = to_f(e[i]);
}

struct PagedArgs {
  const void *q, *k, *v;  // [B, KH, G, D], [KH, N, page, D] x 2
  const int *tables, *lengths;  // [B, P_max], [B]
  void* out;                    // [B, KH, G, D]
  float* part_o;                // [B * KH * G, n_split, D] f32 partial outputs
  float* part_ml;               // [B * KH * G, n_cc, n_split, 2] f32 partial max and sum
  int* tickets;                 // [B * KH * chunks], 0 between launches
  int n_cc;                     // wide kernel: column chunks of kWideCols (else 1)
  int kh, g_all, rows, d, n_pages, page, p_max, n_split, tbl_cap;
  int stage_tokens;  // Inst::stage_tokens(d)
  float scale;
};

// One instance: T, VW bytes a vector, TG lanes a token (a power of 2 from 4
// to 32), VPL vectors a lane
template <typename T, int VW, int TG, int VPL> struct Inst {
  static constexpr int kEpv = VW / (int)sizeof(T);  // elements a vector
  static constexpr int kEpl = kEpv * VPL;           // elements a lane, per row
  static constexpr int kTpw = 32 / TG;              // tokens a warp takes at once
  static constexpr int kStep = kWarps * kTpw;       // tokens the block takes at once
  static constexpr int kMaxRows = 32 / kEpl < 8 ? 32 / kEpl : 8;  // query rows a block
  static_assert(kEpl <= 8 && kMaxStageTokens % kStep == 0, "instance out of range");

  // tokens a ring stage holds at head_dim d
  __host__ __device__ static int stage_tokens(int d) {
    const int fit = PagedRing::kStageBytes / (2 * d * (int)sizeof(T)) / kStep * kStep;
    return fit < kStep ? kStep : fit > kMaxStageTokens ? kMaxStageTokens : fit;
  }

  // dynamic shared memory: the ring (reused by the warps' merge), then the
  // block-table window
  __host__ __device__ static size_t smem(int d, int tbl_cap) {
    const size_t ring = (size_t)PagedRing::kStages * 2 * stage_tokens(d) * d * sizeof(T);
    const size_t merge = sizeof(float) * (size_t)kWarps * kMaxRows * (d + 2);
    return (ring > merge ? ring : merge) + sizeof(int) * (size_t)tbl_cap;
  }
};

template <typename T, int VW, int TG, int VPL>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedArgs a) {
  using I = Inst<T, VW, TG, VPL>;
  constexpr int EPV = I::kEpv, EPL = I::kEpl, TPW = I::kTpw, STEP = I::kStep;
  constexpr int NS = PagedRing::kStages, MR = I::kMaxRows;

  const int bh = blockIdx.x, b = bh / a.kh, h = bh - b * a.kh;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * a.rows, nr = min(a.rows, a.g_all - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / TG, li = lane % TG;
  const int d = a.d, row_bytes = d * (int)sizeof(T), nvec = row_bytes / VW;
  const int TT = a.stage_tokens, stage_bytes = 2 * TT * row_bytes;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t ring_bytes = I::smem(d, 0);
  int* tbl = reinterpret_cast<int*>(smem + ring_bytes);

  // this split's tokens [t_begin, t_end) and the pages they lie on
  const int n_valid = max(0, min(a.lengths[b], a.p_max * a.page));
  const int share =
      ((n_valid + a.n_split - 1) / a.n_split + kShareRound - 1) / kShareRound * kShareRound;
  const int t_begin = min(n_valid, split * share), t_end = min(n_valid, t_begin + share);
  const int p_first = t_begin / a.page;
  const int n_tp = t_end > t_begin ? (t_end - 1) / a.page - p_first + 1 : 0;
  const int* table = a.tables + (size_t)b * a.p_max + p_first;
  for (int i = tid; i < n_tp; i += kThreads) tbl[i] = table[i];

  // q * scale in the input dtype, this lane's columns of each row
  const float scale_t = round_to<T>(a.scale);
  const T* qb = static_cast<const T*>(a.q) + ((size_t)bh * a.g_all + g0) * d;
  float qr[MR][EPL];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int vi = li + j * TG;
      float f[EPV];
      if (r < nr && vi < nvec) {
        unpack<T, VW>(qb + (size_t)r * d + vi * EPV, f);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) qr[r][j * EPV + e] = round_to<T>(f[e] * scale_t);
    }
  }
  __syncthreads();  // the table window is in

  const size_t head_off = (size_t)h * a.n_pages * a.page * d;
  const T* kbase = static_cast<const T*>(a.k) + head_off;
  const T* vbase = static_cast<const T*>(a.v) + head_off;
  const int n_st = (t_end - t_begin + TT - 1) / TT;
  // stage st's K and V rows into its ring slot: TG threads a row (the
  // compute's lanes), kThreads / TG rows at once, one table lookup a row
  auto load_stage = [&](int st) {
    unsigned char* dst = smem + (st % NS) * stage_bytes;
    const int t0 = t_begin + st * TT, n_here = min(TT, t_end - t0);
    for (int tok = tid / TG; tok < n_here; tok += kThreads / TG) {
      const int pos = t0 + tok, pid = tbl[pos / a.page - p_first];
      const size_t row = ((size_t)pid * a.page + pos % a.page) * d;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = li + j * TG;
        if (vi < nvec) {
          copy_async<VW>(dst + tok * row_bytes + vi * VW, kbase + row + vi * EPV);
          copy_async<VW>(dst + (TT + tok) * row_bytes + vi * VW, vbase + row + vi * EPV);
        }
      }
    }
  };

  float m[MR], l[MR], o[MR][EPL];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[r][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_st) load_stage(s);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage st has landed; every warp is past stage st - 1
    if (st + NS - 1 < n_st) load_stage(st + NS - 1);
    cp_async_commit();
    const unsigned char* ks = smem + (st % NS) * stage_bytes;
    const unsigned char* vs = ks + TT * row_bytes;
    const int n_here = min(TT, t_end - (t_begin + st * TT));
    for (int base = 0; base < n_here; base += STEP) {  // the same count in every warp
      const int tok = base + warp * TPW + grp;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = li + j * TG;
        if (vi < nvec) {
          unpack<T, VW>(ks + tok * row_bytes + vi * VW, kf + j * EPV);
          unpack<T, VW>(vs + tok * row_bytes + vi * VW, vf + j * EPV);
        } else {
#pragma unroll
          for (int e = 0; e < EPV; ++e) kf[j * EPV + e] = vf[j * EPV + e] = 0.f;
        }
      }
      const bool valid = tok < n_here;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= nr) break;  // nr is the block's own: no lane leaves a shuffle
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) sc += qr[r][e] * kf[e];
#pragma unroll
        for (int w = TG / 2; w > 0; w >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, w);
        if (valid) {
          if (sc > m[r]) {  // new running max: rescale, and P = 1
            const float alpha = expf(m[r] - sc);
            m[r] = sc;
            l[r] = l[r] * alpha + 1.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) o[r][e] = o[r][e] * alpha + vf[e];
          } else {
            const float p = expf(sc - m[r]);
            const float pt = round_to<T>(p);
            l[r] += p;
#pragma unroll
            for (int e = 0; e < EPL; ++e) o[r][e] += pt * vf[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (xor partners hold the same columns)
#pragma unroll
  for (int w = TG; w < 32; w <<= 1) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nr) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], w);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], w);
      const float mn = fmaxf(m[r], mo);
      const float as = m[r] == -INFINITY ? 0.f : expf(m[r] - mn);
      const float ao = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[r] = l[r] * as + lo * ao;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float oo = __shfl_xor_sync(0xffffffffu, o[r][e], w);
        o[r][e] = o[r][e] * as + oo * ao;
      }
      m[r] = mn;
    }
  }
  __syncthreads();  // every warp is done with the ring: reuse it for the merge
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][MR] max
  float* wl = wm + kWarps * MR;                // [kWarps][MR] sum
  float* wo = wl + kWarps * MR;                // [kWarps][MR][d] output
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nr) break;
      if (li == 0) {
        wm[warp * MR + r] = m[r];
        wl[warp * MR + r] = l[r];
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = li + j * TG;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < EPV; ++e) wo[(warp * MR + r) * d + vi * EPV + e] = o[r][j * EPV + e];
        }
      }
    }
  }
  __syncthreads();

  // merge the four warps in order: the block's (m, l, o), row by row
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.g_all + g0) * d;
  const size_t row0 = (size_t)bh * a.g_all + g0;  // global index of the chunk's first row
  for (int i = tid; i < nr * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * MR + r]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * MR + r];
      const float alpha = mw == -INFINITY ? 0.f : expf(mw - mx);
      sum += wl[w * MR + r] * alpha;
      acc += wo[(w * MR + r) * d + c] * alpha;
    }
    if (a.n_split == 1) {
      out[i] = from_f<T>(acc / fmaxf(sum, 1e-30f));
    } else {
      const size_t pi = (row0 + r) * a.n_split + split;
      a.part_o[pi * d + c] = acc;
      if (c == 0) {
        a.part_ml[2 * pi] = mx;
        a.part_ml[2 * pi + 1] = sum;
      }
    }
  }
  if (a.n_split == 1) return;

  // the block that takes the last ticket merges the partials in split order
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + (size_t)blockIdx.x * gridDim.z + blockIdx.z;
  const bool last = __syncthreads_or(tid == 0 && atomicAdd(ticket, 1) == a.n_split - 1);
  if (!last) return;
  __threadfence();
  for (int i = tid; i < nr * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const size_t p0 = (row0 + r) * a.n_split;
    float mx = -INFINITY;
    for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, __ldcg(a.part_ml + 2 * (p0 + s)));
    float sum = 0.f, acc = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float ms = __ldcg(a.part_ml + 2 * (p0 + s));
      const float alpha = ms == -INFINITY ? 0.f : expf(ms - mx);
      sum += __ldcg(a.part_ml + 2 * (p0 + s) + 1) * alpha;
      acc += __ldcg(a.part_o + (p0 + s) * d + c) * alpha;
    }
    out[i] = from_f<T>(acc / fmaxf(sum, 1e-30f));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// head_dim above kMaxHeadDim (any width, f32 or bf16): one query row a
// block, grid (slot * kv head, split, row * n_cc + column chunk), each block
// writing kWideCols output columns of its row. A warp takes every fourth
// token of the split's share: its lanes stride the whole K row from global
// memory (the q row waits in shared memory, as q * scale in the input
// dtype) for the score, reduce it by shuffles, and keep the running max,
// sum and their 8 columns of the chunk's output; V is read for the chunk's
// columns only. The warps merge in order through shared memory and the
// splits through the workspace and ticket, as paged_decode_kernel does
// (part_ml holds a (max, sum) per column chunk, so each chunk's merge reads
// only what its own blocks wrote).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_wide_kernel(const PagedArgs a) {
  constexpr int CPL = kWideCols / 32;  // output columns a lane
  const int bh = blockIdx.x, b = bh / a.kh, h = bh - b * a.kh;
  const int split = blockIdx.y;
  const int r = blockIdx.z / a.n_cc, cc = blockIdx.z - r * a.n_cc;
  const int d = a.d, c0 = cc * kWideCols, nc = min(kWideCols, d - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [d] q * scale
  float* wm = qs + d;                          // [kWarps] max
  float* wl = wm + kWarps;                     // [kWarps] sum
  float* wo = wl + kWarps;                     // [kWarps][kWideCols] output
  int* tbl = reinterpret_cast<int*>(wo + kWarps * kWideCols);

  const int n_valid = max(0, min(a.lengths[b], a.p_max * a.page));
  const int share =
      ((n_valid + a.n_split - 1) / a.n_split + kShareRound - 1) / kShareRound * kShareRound;
  const int t_begin = min(n_valid, split * share), t_end = min(n_valid, t_begin + share);
  const int p_first = t_begin / a.page;
  const int n_tp = t_end > t_begin ? (t_end - 1) / a.page - p_first + 1 : 0;
  const int* table = a.tables + (size_t)b * a.p_max + p_first;
  for (int i = tid; i < n_tp; i += kThreads) tbl[i] = table[i];
  const size_t row_g = (size_t)bh * a.g_all + r;  // global index of this query row
  const T* qb = static_cast<const T*>(a.q) + row_g * d;
  const float scale_t = round_to<T>(a.scale);
  for (int i = tid; i < d; i += kThreads) qs[i] = round_to<T>(to_f(qb[i]) * scale_t);
  __syncthreads();

  const size_t head_off = (size_t)h * a.n_pages * a.page * d;
  const T* kbase = static_cast<const T*>(a.k) + head_off;
  const T* vbase = static_cast<const T*>(a.v) + head_off + c0;
  float m = -INFINITY, l = 0.f, o[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) o[j] = 0.f;
  for (int pos = t_begin + warp; pos < t_end; pos += kWarps) {
    const int pid = tbl[pos / a.page - p_first];
    const size_t row = ((size_t)pid * a.page + pos % a.page) * d;
    float sc = 0.f;
    for (int i = lane; i < d; i += 32) sc += qs[i] * to_f(kbase[row + i]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, w);
    float vf[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      vf[j] = c < nc ? to_f(vbase[row + c]) : 0.f;
    }
    if (sc > m) {  // new running max: rescale, and P = 1
      const float alpha = expf(m - sc);
      m = sc;
      l = l * alpha + 1.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) o[j] = o[j] * alpha + vf[j];
    } else {
      const float p = expf(sc - m);
      const float pt = round_to<T>(p);
      l += p;
#pragma unroll
      for (int j = 0; j < CPL; ++j) o[j] += pt * vf[j];
    }
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) wo[warp * kWideCols + lane + 32 * j] = o[j];
  __syncthreads();

  // merge the four warps in order: the block's (m, l, o) for its columns
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
  T* out = static_cast<T*>(a.out) + row_g * d + c0;
  const size_t ml = (row_g * a.n_cc + cc) * a.n_split;  // this chunk's (max, sum) slots
  for (int c = tid; c < nc; c += kThreads) {
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float alpha = wm[w] == -INFINITY ? 0.f : expf(wm[w] - mx);
      sum += wl[w] * alpha;
      acc += wo[w * kWideCols + c] * alpha;
    }
    if (a.n_split == 1) {
      out[c] = from_f<T>(acc / fmaxf(sum, 1e-30f));
    } else {
      a.part_o[(row_g * a.n_split + split) * d + c0 + c] = acc;
      if (c == 0) {
        a.part_ml[2 * (ml + split)] = mx;
        a.part_ml[2 * (ml + split) + 1] = sum;
      }
    }
  }
  if (a.n_split == 1) return;

  // the block that takes the last ticket merges the partials in split order
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)blockIdx.x * gridDim.z + blockIdx.z;
  const bool last = __syncthreads_or(tid == 0 && atomicAdd(ticket, 1) == a.n_split - 1);
  if (!last) return;
  __threadfence();
  float big = -INFINITY;
  for (int sp = 0; sp < a.n_split; ++sp) big = fmaxf(big, __ldcg(a.part_ml + 2 * (ml + sp)));
  for (int c = tid; c < nc; c += kThreads) {
    float sum = 0.f, acc = 0.f;
    for (int sp = 0; sp < a.n_split; ++sp) {
      const float ms = __ldcg(a.part_ml + 2 * (ml + sp));
      const float alpha = ms == -INFINITY ? 0.f : expf(ms - big);
      sum += __ldcg(a.part_ml + 2 * (ml + sp) + 1) * alpha;
      acc += __ldcg(a.part_o + (row_g * a.n_split + sp) * d + c0 + c) * alpha;
    }
    out[c] = from_f<T>(acc / fmaxf(sum, 1e-30f));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// Raise a kernel's dynamic shared-memory cap to the device's opt-in
// maximum, once per device (`done` holds a bit per device; a launch under
// 48 KB needs no call)
template <typename Kern>
cudaError_t allow_smem_once(Kern kern, size_t smem, std::atomic<unsigned>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int VW, int TG, int VPL>
cudaError_t launch(const PagedArgs& a, int b, cudaStream_t stream) {
  using I = Inst<T, VW, TG, VPL>;
  static std::atomic<unsigned> smem_set{0};  // this instance's devices
  const size_t smem = I::smem(a.d, a.tbl_cap);
  auto kern = paged_decode_kernel<T, VW, TG, VPL>;
  const cudaError_t err = allow_smem_once(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  PagedArgs args = a;
  args.rows = a.g_all < I::kMaxRows ? a.g_all : I::kMaxRows;
  args.stage_tokens = I::stage_tokens(a.d);
  const dim3 grid((unsigned)b * a.kh, a.n_split, (a.g_all + args.rows - 1) / args.rows);
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The instance for a row of `row_bytes`: vectors of the widest of 16/8/4/2
// bytes that divides the row, TG lanes a token (the vector count's power of
// 2, 4 to 32) and VPL vectors a lane (a power of 2, at most 8 elements a
// lane). Returns op.template run<T, VW, TG, VPL>().
template <typename T, int VW, typename Op>
cudaError_t with_lanes(int nvec, Op& op) {
  constexpr int kEpv = VW / (int)sizeof(T);
  if (nvec <= 4) return op.template run<T, VW, 4, 1>();
  if (nvec <= 8) return op.template run<T, VW, 8, 1>();
  if (nvec <= 16) return op.template run<T, VW, 16, 1>();
  if (nvec <= 32) return op.template run<T, VW, 32, 1>();
  if constexpr (2 * kEpv <= 8) {
    if (nvec <= 64) return op.template run<T, VW, 32, 2>();
  }
  if constexpr (4 * kEpv <= 8) {
    if (nvec <= 128) return op.template run<T, VW, 32, 4>();
  }
  if constexpr (8 * kEpv <= 8) {
    if (nvec <= 256) return op.template run<T, VW, 32, 8>();
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename Op>
cudaError_t with_instance(int d, Op& op) {
  const int row_bytes = d * (int)sizeof(T);
  if (row_bytes % 16 == 0) return with_lanes<T, 16>(row_bytes / 16, op);
  if (row_bytes % 8 == 0) return with_lanes<T, 8>(row_bytes / 8, op);
  if (row_bytes % 4 == 0) return with_lanes<T, 4>(row_bytes / 4, op);
  if constexpr (sizeof(T) == 2) return with_lanes<T, 2>(row_bytes / 2, op);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_wide(const PagedArgs& a, int b, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  const size_t smem = sizeof(float) * ((size_t)a.d + kWarps * (2 + kWideCols)) +
                      sizeof(int) * (size_t)a.tbl_cap;
  auto kern = paged_decode_wide_kernel<T>;
  const cudaError_t err = allow_smem_once(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  PagedArgs args = a;
  args.rows = 1;
  const dim3 grid((unsigned)b * a.kh, a.n_split, (unsigned)a.g_all * a.n_cc);
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

struct LaunchOp {
  const PagedArgs& a;
  int b;
  cudaStream_t stream;
  template <typename T, int VW, int TG, int VPL> cudaError_t run() {
    return launch<T, VW, TG, VPL>(a, b, stream);
  }
};

struct RowsOp {
  int rows = 0;
  template <typename T, int VW, int TG, int VPL> cudaError_t run() {
    rows = Inst<T, VW, TG, VPL>::kMaxRows;
    return cudaSuccess;
  }
};

}  // namespace

// Query rows of one head that a block takes at this head_dim and dtype (a
// head with more is chunked over blocks, each re-reading the head's K/V);
// 1 above kMaxHeadDim (the wide kernel); 0 for a head_dim or dtype the
// kernel does not take.
extern "C" int ray_paged_attention_rows(int d, int dtype) {
  RowsOp op;
  if (d < 1 || (dtype != kF32 && dtype != kBF16)) return 0;
  if (d > kMaxHeadDim) return 1;
  if (dtype == kF32) with_instance<float>(d, op);
  if (dtype == kBF16) with_instance<__nv_bfloat16>(d, op);
  return op.rows;
}

// Returns the cudaError_t of the launch (0 = success; cudaErrorInvalidValue
// for a head_dim below 1). With n_split > 1 `workspace` holds
// B * KH * G * n_split * (D + 2 * n_cc) floats and `tickets`
// B * KH * G * n_cc ints that are 0 (each launch leaves them 0), where
// n_cc = ceil(D / 256) above D = 256 and 1 up to it. tbl_cap bounds the pages one split
// touches. The caller allocates `out` and checks shapes, dtypes,
// contiguity and 16-byte alignment.
extern "C" int ray_paged_attention_decode(const void* q, const void* k_pages,
                                          const void* v_pages, const void* tables,
                                          const void* lengths, void* out, void* workspace,
                                          void* tickets, int b, int kh, int g, int d,
                                          int n_pages, int page, int p_max, int n_split,
                                          int tbl_cap, float scale, int dtype, void* stream) {
  if (b == 0 || g == 0 || kh == 0) return cudaSuccess;
  if (page < 1 || n_split < 1 || d < 1 || tbl_cap < 1) return cudaErrorInvalidValue;
  if (n_split > 1 && (workspace == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(workspace);
  const size_t rows_all = (size_t)b * kh * g;
  const int n_cc = d > kMaxHeadDim ? (d + kWideCols - 1) / kWideCols : 1;
  const PagedArgs a{q, k_pages, v_pages, static_cast<const int*>(tables),
                    static_cast<const int*>(lengths), out, part_o,
                    part_o ? part_o + rows_all * n_split * d : nullptr,
                    static_cast<int*>(tickets), n_cc, kh, g, g, d, n_pages, page, p_max,
                    n_split, tbl_cap, 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kMaxHeadDim) {
    if (dtype == kF32) return launch_wide<float>(a, b, st);
    if (dtype == kBF16) return launch_wide<__nv_bfloat16>(a, b, st);
    return cudaErrorInvalidValue;
  }
  LaunchOp op{a, b, st};
  if (dtype == kF32) return with_instance<float>(d, op);
  if (dtype == kBF16) return with_instance<__nv_bfloat16>(d, op);
  return cudaErrorInvalidValue;
}
