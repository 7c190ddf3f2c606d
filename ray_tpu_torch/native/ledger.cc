// Port of ray_tpu/native/ledger.cc, copied.
// Native fixed-point resource ledger: the grant/reject admission hot path.
//
// C++ equivalent of the reference's LocalResourceManager + FixedPoint
// arithmetic (Ray's src/ray/raylet/scheduling/
// local_resource_manager.h:58, src/ray/common/scheduling/fixed_point.h:26):
// per-resource int64 amounts scaled by 1/10000, atomic multi-resource
// try-allocate under a mutex, over-release detection. Consumed from Python
// via ctypes (pure C ABI — no pybind11 in this environment); the node
// agent's every lease admission runs through this.
//
// Capacity model: a fixed-size column vocabulary (indices interned by the
// Python side, scheduling_ids.h:45 analog), dense int64 arrays.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Ledger {
  std::mutex mu;
  std::vector<int64_t> total;
  std::vector<int64_t> avail;
};

}  // namespace

extern "C" {

// Create a ledger with `capacity` resource columns (all zero).
void* rtpu_ledger_create(uint64_t capacity) {
  auto* l = new Ledger();
  l->total.assign(capacity, 0);
  l->avail.assign(capacity, 0);
  return l;
}

void rtpu_ledger_destroy(void* h) { delete static_cast<Ledger*>(h); }

// Grow the column space (vocab interned a new resource name).
int rtpu_ledger_grow(void* h, uint64_t capacity) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  if (capacity < l->total.size()) return -1;
  l->total.resize(capacity, 0);
  l->avail.resize(capacity, 0);
  return 0;
}

// Add capacity to columns: cols[i] += amounts_fp[i] on both total and avail.
int rtpu_ledger_add_capacity(void* h, const uint32_t* cols,
                             const int64_t* amounts_fp, uint64_t n) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  for (uint64_t i = 0; i < n; ++i) {
    if (cols[i] >= l->total.size()) return -1;
    l->total[cols[i]] += amounts_fp[i];
    l->avail[cols[i]] += amounts_fp[i];
  }
  return 0;
}

// Atomic multi-resource admission: all-or-nothing (grant-or-reject).
// Returns 1 on grant, 0 on reject, -1 on bad column.
int rtpu_ledger_try_allocate(void* h, const uint32_t* cols,
                             const int64_t* demands_fp, uint64_t n) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  for (uint64_t i = 0; i < n; ++i) {
    if (cols[i] >= l->avail.size()) return -1;
    if (l->avail[cols[i]] < demands_fp[i]) return 0;
  }
  for (uint64_t i = 0; i < n; ++i) l->avail[cols[i]] -= demands_fp[i];
  return 1;
}

// Release a previously granted demand. Returns -2 on over-release
// (avail would exceed total — a double-release bug), 0 on success.
int rtpu_ledger_release(void* h, const uint32_t* cols,
                        const int64_t* demands_fp, uint64_t n) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  int rc = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (cols[i] >= l->avail.size()) return -1;
    l->avail[cols[i]] += demands_fp[i];
    if (l->avail[cols[i]] > l->total[cols[i]]) {
      l->avail[cols[i]] = l->total[cols[i]];  // clamp, then report
      rc = -2;
    }
  }
  return rc;
}

// Feasibility (against totals, ignoring current usage).
int rtpu_ledger_is_feasible(void* h, const uint32_t* cols,
                            const int64_t* demands_fp, uint64_t n) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  for (uint64_t i = 0; i < n; ++i) {
    if (cols[i] >= l->total.size()) return -1;
    if (l->total[cols[i]] < demands_fp[i]) return 0;
  }
  return 1;
}

// Snapshot both arrays into caller buffers of size `capacity`.
int rtpu_ledger_snapshot(void* h, int64_t* total_out, int64_t* avail_out,
                         uint64_t capacity) {
  auto* l = static_cast<Ledger*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  if (capacity < l->total.size()) return -1;
  std::memcpy(total_out, l->total.data(), l->total.size() * sizeof(int64_t));
  std::memcpy(avail_out, l->avail.data(), l->avail.size() * sizeof(int64_t));
  return static_cast<int>(l->total.size());
}

}  // extern "C"
