// Shared-memory SPSC byte-ring channel for compiled-DAG edges.
//
// TPU-native analog of the reference's compiled-DAG channel substrate
// (Ray's python/ray/experimental/channel/shared_memory_channel.py):
// one producer process, one consumer process, a file-backed mmap ring.
// Messages are length-prefixed byte blobs in a power-of-two byte ring;
// payloads (and the length prefix itself) wrap around the ring end, so
// any message up to capacity-4 bytes fits and no tail space is wasted —
// the writer's only wait condition is `capacity - (w - r) >= 4 + len`.
//
// Blocking uses a futex on a 32-bit generation word (one for "data
// available", one for "space available"), so a parked reader wakes in
// microseconds without spinning. All cross-process synchronization is C++
// atomics on the shared pages — Python (via ctypes, GIL released during
// the call) never has to reason about memory ordering.
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055524E4732ULL;  // "RTPURNG2"

struct Header {
  uint64_t magic;
  uint64_t capacity;  // ring bytes (power of two)
  alignas(64) std::atomic<uint64_t> write_pos;  // monotonic byte offset
  alignas(64) std::atomic<uint64_t> read_pos;   // monotonic byte offset
  alignas(64) std::atomic<uint32_t> data_gen;   // futex: bumped on write
  alignas(64) std::atomic<uint32_t> space_gen;  // futex: bumped on read
  alignas(64) std::atomic<uint32_t> closed;     // producer hung up
};

struct Ring {
  Header* h;
  uint8_t* data;
  size_t map_len;
};

int futex_wait(std::atomic<uint32_t>* addr, uint32_t expect,
               const timespec* ts) {
  return syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
                 expect, ts, nullptr, 0);
}

void futex_wake(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE, INT32_MAX,
          nullptr, nullptr, 0);
}

// Wait until gen != seen (or deadline). Returns false on timeout.
bool wait_gen(std::atomic<uint32_t>* gen, uint32_t seen, double timeout_s) {
  timespec ts;
  ts.tv_sec = static_cast<time_t>(timeout_s);
  ts.tv_nsec = static_cast<long>((timeout_s - ts.tv_sec) * 1e9);
  int rc = futex_wait(gen, seen, timeout_s < 0 ? nullptr : &ts);
  if (rc == -1 && errno == ETIMEDOUT) return false;
  return true;  // woken, spurious wake, or value already changed
}

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// ring<->linear copies that wrap at the capacity boundary
void copy_in(uint8_t* ring, uint64_t cap, uint64_t pos, const uint8_t* src,
             uint64_t len) {
  uint64_t off = pos & (cap - 1);
  uint64_t first = cap - off < len ? cap - off : len;
  std::memcpy(ring + off, src, first);
  if (first < len) std::memcpy(ring, src + first, len - first);
}

void copy_out(const uint8_t* ring, uint64_t cap, uint64_t pos, uint8_t* dst,
              uint64_t len) {
  uint64_t off = pos & (cap - 1);
  uint64_t first = cap - off < len ? cap - off : len;
  std::memcpy(dst, ring + off, first);
  if (first < len) std::memcpy(dst + first, ring, len - first);
}

}  // namespace

extern "C" {

void* rtpu_ring_open(const char* path, uint64_t capacity, int create) {
  // round capacity up to a power of two
  uint64_t cap = 4096;
  while (cap < capacity) cap <<= 1;
  size_t map_len = sizeof(Header) + cap;
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (create) {
    struct stat st;
    if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < map_len) {
      if (ftruncate(fd, map_len) != 0) {
        close(fd);
        return nullptr;
      }
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    map_len = st.st_size;
  }
  void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  if (create) {
    if (h->magic != kMagic) {
      h->capacity = cap;
      h->write_pos.store(0, std::memory_order_relaxed);
      h->read_pos.store(0, std::memory_order_relaxed);
      h->data_gen.store(0, std::memory_order_relaxed);
      h->space_gen.store(0, std::memory_order_relaxed);
      h->closed.store(0, std::memory_order_relaxed);
      std::atomic_thread_fence(std::memory_order_seq_cst);
      h->magic = kMagic;
    }
  } else if (h->magic != kMagic) {
    munmap(mem, map_len);
    return nullptr;
  }
  Ring* r = new Ring{h, reinterpret_cast<uint8_t*>(mem) + sizeof(Header),
                     map_len};
  return r;
}

// Blocks until 4+len free bytes exist (the reader frees space as it
// drains) or the deadline passes.
//  0 = ok, -1 = timeout, -2 = message too large for ring
int rtpu_ring_write(void* rp, const void* buf, uint64_t len, double timeout_s) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->h;
  const uint64_t cap = h->capacity;
  uint64_t need = 4 + len;
  if (need > cap) return -2;
  double deadline = timeout_s < 0 ? -1 : now_s() + timeout_s;
  for (;;) {
    uint64_t w = h->write_pos.load(std::memory_order_relaxed);
    uint64_t rd = h->read_pos.load(std::memory_order_acquire);
    if (cap - (w - rd) >= need) {
      uint32_t len32 = static_cast<uint32_t>(len);
      copy_in(r->data, cap, w, reinterpret_cast<const uint8_t*>(&len32), 4);
      copy_in(r->data, cap, w + 4, static_cast<const uint8_t*>(buf), len);
      h->write_pos.store(w + need, std::memory_order_release);
      h->data_gen.fetch_add(1, std::memory_order_release);
      futex_wake(&h->data_gen);
      return 0;
    }
    // channel torn down: a parked writer must not wait for a reader that
    // will never drain the ring
    if (h->closed.load(std::memory_order_acquire)) return -3;
    // full: re-sample, then futex-park on the reader's generation word
    uint32_t seen = h->space_gen.load(std::memory_order_acquire);
    uint64_t rd2 = h->read_pos.load(std::memory_order_acquire);
    if (rd2 != rd) continue;  // space appeared while sampling
    double remain = -1;
    if (deadline >= 0) {
      remain = deadline - now_s();
      if (remain <= 0) return -1;
    }
    if (!wait_gen(&h->space_gen, seen, remain < 0 ? -1 : remain) &&
        deadline >= 0 && now_s() >= deadline)
      return -1;
  }
}

// Size of the next message, blocking until one arrives.
//  >=0 size, -1 timeout, -3 channel closed and drained
int64_t rtpu_ring_next_size(void* rp, double timeout_s) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->h;
  const uint64_t cap = h->capacity;
  double deadline = timeout_s < 0 ? -1 : now_s() + timeout_s;
  for (;;) {
    uint64_t rd = h->read_pos.load(std::memory_order_relaxed);
    uint64_t w = h->write_pos.load(std::memory_order_acquire);
    if (w != rd) {
      uint32_t len32;
      copy_out(r->data, cap, rd, reinterpret_cast<uint8_t*>(&len32), 4);
      return static_cast<int64_t>(len32);
    }
    if (h->closed.load(std::memory_order_acquire)) return -3;
    uint32_t seen = h->data_gen.load(std::memory_order_acquire);
    if (h->write_pos.load(std::memory_order_acquire) != rd) continue;
    double remain = -1;
    if (deadline >= 0) {
      remain = deadline - now_s();
      if (remain <= 0) return -1;
    }
    if (!wait_gen(&h->data_gen, seen, remain < 0 ? -1 : remain) &&
        deadline >= 0 && now_s() >= deadline)
      return -1;
  }
}

// Copy the next message into buf (must be >= its size; use next_size first).
//  >=0 bytes copied, -1 timeout, -3 closed+drained, -4 buffer too small
int64_t rtpu_ring_read(void* rp, void* buf, uint64_t buflen, double timeout_s) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->h;
  const uint64_t cap = h->capacity;
  int64_t size = rtpu_ring_next_size(rp, timeout_s);
  if (size < 0) return size;
  if (static_cast<uint64_t>(size) > buflen) return -4;
  uint64_t rd = h->read_pos.load(std::memory_order_relaxed);
  copy_out(r->data, cap, rd + 4, static_cast<uint8_t*>(buf), size);
  h->read_pos.store(rd + 4 + size, std::memory_order_release);
  h->space_gen.fetch_add(1, std::memory_order_release);
  futex_wake(&h->space_gen);
  return size;
}

void rtpu_ring_close_write(void* rp) {
  Ring* r = static_cast<Ring*>(rp);
  r->h->closed.store(1, std::memory_order_release);
  r->h->data_gen.fetch_add(1, std::memory_order_release);
  futex_wake(&r->h->data_gen);
  // also wake writers parked on a full ring (teardown stall-breaker)
  r->h->space_gen.fetch_add(1, std::memory_order_release);
  futex_wake(&r->h->space_gen);
}

uint64_t rtpu_ring_capacity(void* rp) {
  return static_cast<Ring*>(rp)->h->capacity;
}

// Bytes currently buffered (unread) in the ring — observability only
// (fill-level gauges); racy by nature, never used for flow control.
// Load order matters even for a racy gauge: read_pos FIRST (like the
// reader path) so a concurrent drain between the loads can only make
// the result small, never underflow w - r past zero.
uint64_t rtpu_ring_used(void* rp) {
  Header* h = static_cast<Ring*>(rp)->h;
  uint64_t r = h->read_pos.load(std::memory_order_acquire);
  uint64_t w = h->write_pos.load(std::memory_order_acquire);
  return w >= r ? w - r : 0;
}

void rtpu_ring_close(void* rp) {
  Ring* r = static_cast<Ring*>(rp);
  munmap(r->h, r->map_len);
  delete r;
}

}  // extern "C"
