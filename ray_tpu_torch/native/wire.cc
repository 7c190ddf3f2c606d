// Port of ray_tpu/native/wire.cc, copied.
// C hot path for the pickle-5 out-of-band wire format (RTP5 frames).
//
// The frame layout is owned by ray_tpu_torch/cluster/serialization.py:
//
//   MAGIC("RTP5") | u16 version | u16 nbufs | u64 pkl_len
//                 | nbufs x u64 buf_len | pickle bytes | raw buffers...
//
// Python keeps the pickling itself (cloudpickle + PickleBuffer
// callbacks are interpreter work by definition); what moves here is the
// *framing*: header pack, buffer-length table scan with overflow-checked
// bounds validation, and the scatter/gather joins. One C call replaces a
// per-buffer Python loop of struct.pack / unpack_from / slice-copies, so
// a frame with dozens of out-of-band buffers costs one FFI hop instead
// of O(nbufs) interpreter ops. serialization.py selects this library at
// import time and keeps the pure-Python implementation as the fallback
// (RAY_TPU_NATIVE_WIRE=0 kill switch, toolchain-missing degrade).
//
// Pure C ABI consumed via ctypes (no pybind11, per the environment
// constraints) — same convention as object_store.cc / ring.cc.
#include <cstdint>
#include <cstring>

namespace {

constexpr char kMagic[4] = {'R', 'T', 'P', '5'};
constexpr uint16_t kVersion = 1;
// MAGIC + u16 version + u16 nbufs + u64 pkl_len
constexpr uint64_t kFixedHeader = 4 + 2 + 2 + 8;

inline void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void put_u64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }
inline uint16_t get_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint64_t get_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// Dark-plane counter slots (native/counters.py CounterBlock): an
// mmap-resident int64 page registered once per process. Relaxed atomics
// — rate indicators, not ordering primitives. Slot indices are ABI
// shared with counters.py SLOTS.
long long* g_counters = nullptr;
constexpr int kSlotJoins = 0;
constexpr int kSlotParses = 1;
constexpr int kSlotBytes = 2;

inline void bump(int slot, long long v) {
  if (g_counters)
    __atomic_add_fetch(&g_counters[slot], v, __ATOMIC_RELAXED);
}

}  // namespace

extern "C" {

// Register the shm counter page (nullptr disables). Counting is off
// until the first registration, so standalone users pay nothing.
void rtpu_wire_set_counters(long long* slots) { g_counters = slots; }

// Total frame size for a build with these parts (0 buffers = bare pickle,
// no frame). Overflow-safe: returns 0 on length-table overflow.
uint64_t rtpu_wire_frame_size(uint64_t pkl_len, const uint64_t* buf_lens,
                              uint32_t nbufs) {
  if (nbufs == 0) return pkl_len;
  uint64_t total = kFixedHeader + static_cast<uint64_t>(nbufs) * 8;
  if (total + pkl_len < total) return 0;
  total += pkl_len;
  for (uint32_t i = 0; i < nbufs; ++i) {
    if (total + buf_lens[i] < total) return 0;
    total += buf_lens[i];
  }
  return total;
}

// Gather-join header + pickle + buffers into dst (one pass, one copy per
// part). Returns bytes written, or:
//  -1 dst too small, -2 nbufs exceeds the u16 header field.
int64_t rtpu_wire_join(const uint8_t* pkl, uint64_t pkl_len,
                       const uint8_t* const* bufs, const uint64_t* buf_lens,
                       uint32_t nbufs, uint8_t* dst, uint64_t dst_cap) {
  if (nbufs > 0xFFFF) return -2;
  uint64_t total = rtpu_wire_frame_size(pkl_len, buf_lens, nbufs);
  if (total == 0 || total > dst_cap) return -1;
  if (nbufs == 0) {
    // frame_size's contract: zero buffers = bare pickle, no frame —
    // keep join consistent instead of writing a header it didn't size
    std::memcpy(dst, pkl, pkl_len);
    return static_cast<int64_t>(pkl_len);
  }
  uint8_t* p = dst;
  std::memcpy(p, kMagic, 4);
  p += 4;
  put_u16(p, kVersion);
  p += 2;
  put_u16(p, static_cast<uint16_t>(nbufs));
  p += 2;
  put_u64(p, pkl_len);
  p += 8;
  for (uint32_t i = 0; i < nbufs; ++i) {
    put_u64(p, buf_lens[i]);
    p += 8;
  }
  std::memcpy(p, pkl, pkl_len);
  p += pkl_len;
  for (uint32_t i = 0; i < nbufs; ++i) {
    if (buf_lens[i]) std::memcpy(p, bufs[i], buf_lens[i]);
    p += buf_lens[i];
  }
  bump(kSlotJoins, 1);
  bump(kSlotBytes, static_cast<long long>(p - dst));
  return static_cast<int64_t>(p - dst);
}

// Parse a frame into an offset table. `out` receives
// [pkl_off, pkl_len, buf0_off, buf0_len, buf1_off, buf1_len, ...]
// (2 + 2*max_bufs u64 slots). Returns nbufs (>= 0), or:
//  -1 no RTP5 magic (caller treats data as a plain pickle)
//  -2 truncated or corrupt frame (lengths overrun the data)
//  -3 unknown wire-format version
//  -4 frame has more buffers than max_bufs (caller re-calls with room)
int64_t rtpu_wire_parse(const uint8_t* data, uint64_t len, uint64_t* out,
                        uint32_t max_bufs) {
  if (len < 4 || std::memcmp(data, kMagic, 4) != 0) return -1;
  if (len < kFixedHeader) return -2;
  uint16_t version = get_u16(data + 4);
  if (version != kVersion) return -3;
  uint32_t nbufs = get_u16(data + 6);
  uint64_t pkl_len = get_u64(data + 8);
  uint64_t off = kFixedHeader + static_cast<uint64_t>(nbufs) * 8;
  if (off > len) return -2;
  if (nbufs > max_bufs) return -4;
  const uint8_t* lens = data + kFixedHeader;
  // pickle bounds
  if (pkl_len > len - off) return -2;
  out[0] = off;
  out[1] = pkl_len;
  off += pkl_len;
  for (uint32_t i = 0; i < nbufs; ++i) {
    uint64_t blen = get_u64(lens + static_cast<uint64_t>(i) * 8);
    if (blen > len - off) return -2;
    out[2 + 2 * i] = off;
    out[3 + 2 * i] = blen;
    off += blen;
  }
  bump(kSlotParses, 1);
  return static_cast<int64_t>(nbufs);
}

}  // extern "C"
