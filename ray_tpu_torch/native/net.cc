// Port of ray_tpu/native/net.cc, copied.
// C hot path for the cross-node data plane: scatter-gather socket I/O.
//
// The same-node fast paths (shm arena views, ring pairs) stop at the
// node boundary; this file is the wire under cluster/transport.py — the
// worker<->worker data sockets that carry RTP5 frames (wire.cc) across
// nodes. What moves to C is the syscall loop: one rtpu_net_send_vec call
// sendmsg()s an arbitrary iovec of frame parts (header + arena views)
// with NO joins or intermediate copies on the send side, and
// rtpu_net_recv_exact / rtpu_net_recv_vec land the payload straight into
// the receiving arena's pages (put_frames-style scatter-writes) instead
// of through per-chunk Python bytes.
//
// Pure C ABI consumed via ctypes (no pybind11, per the environment
// constraints) — same convention as object_store.cc / wire.cc. All
// functions return >= 0 on success and -errno on failure; partial
// sends/recvs are retried internally until the full byte count moved or
// the peer/timeout broke the transfer.
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMaxIov = 64;  // well under IOV_MAX on every target

int set_timeout_ms(int fd, int which, int timeout_ms) {
  struct timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  return setsockopt(fd, SOL_SOCKET, which, &tv, sizeof(tv));
}

// Dark-plane counter slots (native/counters.py CounterBlock, same page
// wire.cc registers). Relaxed atomics; slot indices are ABI shared with
// counters.py SLOTS.
long long* g_counters = nullptr;
constexpr int kSlotTxBytes = 3;
constexpr int kSlotTxFrames = 4;
constexpr int kSlotRxBytes = 5;

inline void bump(int slot, long long v) {
  if (g_counters)
    __atomic_add_fetch(&g_counters[slot], v, __ATOMIC_RELAXED);
}

}  // namespace

extern "C" {

// Register the shm counter page (nullptr disables).
void rtpu_net_set_counters(long long* slots) { g_counters = slots; }

// Bind + listen on host:port (port 0 = ephemeral). Returns the listen fd
// or -errno.
int rtpu_net_listen(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    int err = errno;
    close(fd);
    return -err;
  }
  return fd;
}

// The port a listen fd actually bound (ephemeral-port discovery).
int rtpu_net_local_port(int fd) {
  struct sockaddr_in addr;
  socklen_t len = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<struct sockaddr*>(&addr), &len) != 0)
    return -errno;
  return ntohs(addr.sin_port);
}

// Accept one connection (bounded by timeout_ms; <=0 blocks). Returns the
// connection fd, -EAGAIN on timeout, or -errno. TCP_NODELAY is set: the
// protocol is request/response and a delayed header ACK would serialize
// every stripe on Nagle.
int rtpu_net_accept(int listen_fd, int timeout_ms) {
  if (timeout_ms > 0 &&
      set_timeout_ms(listen_fd, SO_RCVTIMEO, timeout_ms) != 0)
    return -errno;
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd < 0)
    return (errno == EAGAIN || errno == EWOULDBLOCK) ? -EAGAIN : -errno;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Connect to host:port with a connect timeout. Returns the fd or -errno.
int rtpu_net_connect(const char* host, int port, int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  // SO_SNDTIMEO bounds a blocking connect() on Linux — no nonblocking
  // dance needed for a data-plane dial with second-scale budgets
  if (timeout_ms > 0) set_timeout_ms(fd, SO_SNDTIMEO, timeout_ms);
  if (connect(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)) !=
      0) {
    int err = errno;
    close(fd);
    return -((err == EAGAIN || err == EWOULDBLOCK) ? ETIMEDOUT : err);
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Per-operation I/O deadline for an established connection (applies to
// every subsequent send/recv loop iteration).
int rtpu_net_set_timeout(int fd, int timeout_ms) {
  if (set_timeout_ms(fd, SO_RCVTIMEO, timeout_ms) != 0) return -errno;
  if (set_timeout_ms(fd, SO_SNDTIMEO, timeout_ms) != 0) return -errno;
  return 0;
}

// Gather-send the whole iovec (bufs[i], lens[i]) x n. One sendmsg per
// kernel round; partial writes advance the iovec in place — frame parts
// (header bytes + arena views) go out with ZERO user-space joins/copies.
// Returns total bytes sent or -errno.
int64_t rtpu_net_send_vec(int fd, const void* const* bufs,
                          const uint64_t* lens, uint32_t n) {
  struct iovec iov[kMaxIov];
  uint64_t total = 0;
  uint32_t idx = 0;
  uint64_t consumed0 = 0;  // bytes of bufs[idx] already sent
  while (idx < n) {
    uint32_t cnt = 0;
    for (uint32_t i = idx; i < n && cnt < kMaxIov; ++i) {
      uint64_t skip = (i == idx) ? consumed0 : 0;
      if (lens[i] <= skip) {
        if (i == idx) {  // fully-sent head segment: advance past it
          ++idx;
          consumed0 = 0;
        }
        continue;
      }
      iov[cnt].iov_base =
          const_cast<uint8_t*>(static_cast<const uint8_t*>(bufs[i]) + skip);
      iov[cnt].iov_len = static_cast<size_t>(lens[i] - skip);
      ++cnt;
    }
    if (cnt == 0) break;  // only empty segments remained
    struct msghdr msg;
    std::memset(&msg, 0, sizeof(msg));
    msg.msg_iov = iov;
    msg.msg_iovlen = cnt;
    ssize_t sent = sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (sent < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    total += static_cast<uint64_t>(sent);
    // advance (idx, consumed0) past what the kernel took
    uint64_t left = static_cast<uint64_t>(sent);
    while (left > 0 && idx < n) {
      uint64_t avail = lens[idx] - consumed0;
      if (left >= avail) {
        left -= avail;
        ++idx;
        consumed0 = 0;
      } else {
        consumed0 += left;
        left = 0;
      }
    }
    while (idx < n && lens[idx] == consumed0) {  // skip exhausted heads
      ++idx;
      consumed0 = 0;
    }
  }
  bump(kSlotTxBytes, static_cast<long long>(total));
  bump(kSlotTxFrames, 1);
  return static_cast<int64_t>(total);
}

// Receive exactly len bytes into buf (e.g. straight into an arena
// offset). Returns len, 0 if the peer closed before any byte, or -errno
// (-EAGAIN = timeout; a mid-stream close returns -ECONNRESET so a
// half-delivered stripe can never read as success).
int64_t rtpu_net_recv_exact(int fd, void* buf, uint64_t len) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  uint64_t got = 0;
  while (got < len) {
    ssize_t r = recv(fd, p + got, static_cast<size_t>(len - got), 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return (errno == EAGAIN || errno == EWOULDBLOCK) ? -EAGAIN : -errno;
    }
    if (r == 0) return got == 0 ? 0 : -ECONNRESET;
    got += static_cast<uint64_t>(r);
  }
  bump(kSlotRxBytes, static_cast<long long>(len));
  return static_cast<int64_t>(len);
}

// Scatter-receive exactly sum(lens) bytes across the iovec — the
// receiving half of send_vec (payload lands across arena segments with
// no staging buffer). Returns total bytes or -errno (mid-stream close =
// -ECONNRESET, same contract as recv_exact).
int64_t rtpu_net_recv_vec(int fd, void* const* bufs, const uint64_t* lens,
                          uint32_t n) {
  int64_t total = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (lens[i] == 0) continue;
    int64_t rc = rtpu_net_recv_exact(fd, bufs[i], lens[i]);
    if (rc < 0) return rc;
    if (static_cast<uint64_t>(rc) != lens[i]) return -ECONNRESET;
    total += rc;
  }
  return total;
}

int rtpu_net_close(int fd) {
  return close(fd) == 0 ? 0 : -errno;
}

}  // extern "C"
