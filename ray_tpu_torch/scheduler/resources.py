"""Resource model: string-interned vocabulary + dense tensor packing.

Port of ``ray_tpu/scheduler/resources.py``, copied with its imports
rewritten.

TPU-first redesign of the reference's resource model
(Ray's src/ray/common/scheduling/cluster_resource_data.h:39,308 and
scheduling_ids.h:45). Instead of per-node hash maps of FixedPoint scalars, the
cluster view is a pair of dense ``float32 [num_nodes, num_resources]`` arrays
(totals / available) so that every scheduling decision can be a batched XLA
program. String resource names are interned to dense column ids at the edge
only (like StringIdMap), and the *authoritative* bookkeeping on grant/return
is exact int64 fixed-point (1e-4 quantum, mirroring fixed_point.h:26) host-side;
the device arrays are the approximate scoring view (eventually-consistent, the
same trust model the reference assigns to ClusterResourceManager).

Unit & exactness contract
-------------------------
Quantities are floats in HUMAN units — CPU/GPU/TPU as device counts,
``memory`` / ``object_store_memory`` in whatever unit the caller adopts
(counts, GiB, or bytes), custom resources likewise. Two layers, two
guarantees:

- **Admission is exact.** Every quantity is quantized once at the edge to
  int64 fixed point (``to_fp``, 1e-4 quantum like the reference's
  FixedPoint) and all grant/release arithmetic — the agent ledger
  (native/ledger.cc) and the local-runtime ``NodeResourceLedger`` — is
  integer. Bytes-valued resources (e.g. ``memory: 2**30``) admit exactly:
  int64 fixed point is exact through 2**59, so sums/compares never drift
  and the last byte is grantable (tests/test_resource_units.py proves the
  boundary).
- **Scoring is float32 and approximate past ``MAX_EXACT_VIEW_TOTAL``.**
  The dense view arrays feed the batched XLA kernels; float32 represents
  the 1e-4 quantum exactly only while value/1e-4 fits the 24-bit
  mantissa, i.e. magnitudes ≤ 2**24 × 1e-4 ≈ 1677.72. Larger totals
  (bytes-valued memory) degrade only *scoring/feasibility pre-checks*
  (float32 spacing at 2**30 is 128) — a stale-view over-grant is caught by
  the agents' exact grant-or-reject and re-queued, the same trust model
  the reference assigns its eventually-consistent
  ClusterResourceManager. ``ClusterView.add_node`` warns once per
  resource name when a total crosses the bound so the precision trade is
  loud, not silent.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# Fixed-point quantum: 1/10000, like the reference FixedPoint
# (Ray's src/ray/common/scheduling/fixed_point.h:26).
FP_SCALE = 10_000

# Predefined resource columns. The reference's predefined set is
# CPU/MEM/GPU/OBJECT_STORE_MEM (cluster_resource_data.h); we add TPU as a
# first-class accelerator column.
CPU = 0
MEMORY = 1
OBJECT_STORE_MEMORY = 2
GPU = 3
TPU = 4
NUM_PREDEFINED = 5

PREDEFINED_NAMES = ("CPU", "memory", "object_store_memory", "GPU", "TPU")

# Columns used by CalculateCriticalResourceUtilization
# (cluster_resource_data.cc:62-77): CPU, MEM, OBJECT_STORE_MEM.
CRITICAL_COLUMNS = (CPU, MEMORY, OBJECT_STORE_MEMORY)


# Above this magnitude the float32 VIEW can no longer represent the 1e-4
# quantum exactly: exactness needs value/1e-4 ≤ 2^24 (float32's 24-bit
# mantissa), i.e. value ≤ 1677.7216. Admission stays exact (int64
# ledger) at any magnitude; scoring becomes approximate past this.
MAX_EXACT_VIEW_TOTAL = float(1 << 24) / FP_SCALE

_warned_view_precision: set = set()


def _warn_view_precision(name: str, value: float) -> None:
    if name in _warned_view_precision:
        return
    _warned_view_precision.add(name)
    import logging

    logging.getLogger("ray_tpu.scheduler").warning(
        "resource %r total %.4g exceeds MAX_EXACT_VIEW_TOTAL (%.4g): the "
        "float32 scoring view is approximate at this magnitude (admission "
        "stays exact via the int64 ledger). Consider coarser units (GiB "
        "instead of bytes) for exact scoring.",
        name,
        value,
        MAX_EXACT_VIEW_TOTAL,
    )


def to_fp(value: float) -> int:
    """Quantize a python float to exact int64 fixed point (round-to-nearest)."""
    return int(round(float(value) * FP_SCALE))


def from_fp(value: int) -> float:
    return value / FP_SCALE


class ResourceVocab:
    """Interns resource names to dense column indices.

    Thread-safe, append-only. Column layout: predefined columns first, then
    custom resources in interning order. ``capacity`` fixes the dense width so
    jitted kernels see a static resource axis; growing past capacity doubles
    it (a recompile boundary, expected to be rare — the reference similarly
    treats the resource universe as small and slowly-growing).
    """

    def __init__(self, capacity: int = 16):
        assert capacity >= NUM_PREDEFINED
        self._lock = threading.Lock()
        self._name_to_col: Dict[str, int] = {
            name: i for i, name in enumerate(PREDEFINED_NAMES)
        }
        self._names: List[str] = list(PREDEFINED_NAMES)
        self.capacity = capacity

    def intern(self, name: str) -> int:
        with self._lock:
            col = self._name_to_col.get(name)
            if col is None:
                col = len(self._names)
                self._names.append(name)
                self._name_to_col[name] = col
                while col >= self.capacity:
                    self.capacity *= 2
            return col

    def get(self, name: str) -> Optional[int]:
        return self._name_to_col.get(name)

    def name(self, col: int) -> str:
        return self._names[col]

    @property
    def num_resources(self) -> int:
        return len(self._names)

    def pack(self, resource_map: Mapping[str, float]) -> np.ndarray:
        """Pack a {name: quantity} map into a dense float32 row [capacity]."""
        row = np.zeros(self.capacity, dtype=np.float32)
        for name, qty in resource_map.items():
            row[self.intern(name)] = float(qty)
        return row

    def pack_fp(self, resource_map: Mapping[str, float]) -> Dict[int, int]:
        """Exact fixed-point form: {column: int64 quantity}, zeros dropped."""
        out: Dict[int, int] = {}
        for name, qty in resource_map.items():
            v = to_fp(qty)
            if v != 0:
                out[self.intern(name)] = v
        return out

    def unpack(self, row: np.ndarray) -> Dict[str, float]:
        return {
            self._names[i]: float(row[i])
            for i in range(min(len(self._names), len(row)))
            if row[i] != 0
        }


@dataclass
class ResourceRequest:
    """A task/bundle resource demand (reference: ResourceRequest,
    cluster_resource_data.h:39). Exact fixed-point host form."""

    demands: Dict[int, int] = field(default_factory=dict)  # col -> fp qty

    @classmethod
    def from_map(cls, vocab: ResourceVocab, m: Mapping[str, float]) -> "ResourceRequest":
        return cls(vocab.pack_fp(m))

    def is_empty(self) -> bool:
        return not self.demands

    def dense(self, width: int) -> np.ndarray:
        # memoized per width: schedulers re-densify the same parked request
        # every retry round under contention (requests are immutable)
        cache = getattr(self, "_dense_cache", None)
        if cache is not None and cache[0] == width:
            return cache[1]
        row = np.zeros(width, dtype=np.float32)
        for col, fp in self.demands.items():
            row[col] = from_fp(fp)
        row.flags.writeable = False  # shared: accidental mutation raises
        object.__setattr__(self, "_dense_cache", (width, row))
        return row

    def has(self, col: int) -> bool:
        return self.demands.get(col, 0) > 0


class NodeResourceLedger:
    """Authoritative per-node resource accounting in exact fixed point.

    This is the grant-time admission check — the analog of the reference's
    LocalResourceManager (local_resource_manager.h:58): the dense device view
    may be stale, but a grant only succeeds if this ledger says so
    (grant-or-reject under eventually-consistent views,
    local_lease_manager.h:39-61).
    """

    def __init__(self, vocab: ResourceVocab, total: Mapping[str, float]):
        self.vocab = vocab
        self._lock = threading.Lock()
        self.total_fp: Dict[int, int] = vocab.pack_fp(total)
        self.avail_fp: Dict[int, int] = dict(self.total_fp)

    def is_feasible(self, req: ResourceRequest) -> bool:
        with self._lock:
            return all(self.total_fp.get(c, 0) >= q for c, q in req.demands.items())

    def is_available(self, req: ResourceRequest) -> bool:
        with self._lock:
            return all(self.avail_fp.get(c, 0) >= q for c, q in req.demands.items())

    def try_allocate(self, req: ResourceRequest) -> bool:
        with self._lock:
            if any(
                self.avail_fp.get(c, 0) < q for c, q in req.demands.items()
            ):
                return False
            for c, q in req.demands.items():
                self.avail_fp[c] = self.avail_fp.get(c, 0) - q
            return True

    def release(self, req: ResourceRequest) -> None:
        with self._lock:
            for c, q in req.demands.items():
                self.avail_fp[c] = self.avail_fp.get(c, 0) + q
                # Floating credit is a bug; exact arithmetic makes this checkable.
                assert self.avail_fp[c] <= self.total_fp.get(c, 0) + 0, (
                    f"over-release of resource {self.vocab.name(c)}"
                )

    def add_capacity(self, extra: Mapping[str, float]) -> None:
        with self._lock:
            for c, q in self.vocab.pack_fp(extra).items():
                self.total_fp[c] = self.total_fp.get(c, 0) + q
                self.avail_fp[c] = self.avail_fp.get(c, 0) + q

    def total_map(self) -> Dict[str, float]:
        with self._lock:
            return {
                self.vocab.name(c): from_fp(q) for c, q in self.total_fp.items() if q
            }

    def avail_map(self) -> Dict[str, float]:
        with self._lock:
            return {
                self.vocab.name(c): from_fp(q) for c, q in self.avail_fp.items() if q
            }


def make_ledger(vocab: ResourceVocab, total: Mapping[str, float]):
    """Prefer the native C++ ledger (``native/ledger.cc`` — the
    LocalResourceManager-analog admission hot path); fall back to the pure
    Python implementation when the toolchain is unavailable. Both keep the
    same exact fixed-point arithmetic. Disable with RAY_TPU_NATIVE_LEDGER=0."""
    from ..config import cfg

    if cfg.native_ledger:
        try:
            from ..native.native_ledger import NativeNodeResourceLedger

            return NativeNodeResourceLedger(vocab, total)
        except Exception:  # noqa: BLE001 - no compiler / build failure
            pass
    return NodeResourceLedger(vocab, total)


class ClusterView:
    """Dense cluster resource view: the scheduler dataplane.

    The analog of ClusterResourceManager (cluster_resource_manager.h) — every
    node's totals/availables as rows of dense arrays, fed by the resource
    gossip (§ray_syncer). Kernels consume ``totals``/``avail`` as float32
    device arrays; this class owns the host mirrors and the node-id interning.
    """

    #: label key the head's node registration carries a node type under
    #: (autoscaler.NODE_TYPE_LABEL) — ``add_node`` interns it automatically
    NODE_TYPE_LABEL = "ray_tpu.io/node-type"

    def __init__(self, vocab: ResourceVocab, capacity_nodes: int = 8):
        self.vocab = vocab
        self.capacity_nodes = capacity_nodes
        self._node_ids: List[str] = []
        self._id_to_row: Dict[str, int] = {}
        self.totals = np.zeros((capacity_nodes, vocab.capacity), dtype=np.float32)
        self.avail = np.zeros((capacity_nodes, vocab.capacity), dtype=np.float32)
        self.alive = np.zeros(capacity_nodes, dtype=bool)
        self.labels: List[Dict[str, str]] = [dict() for _ in range(capacity_nodes)]
        # --- heterogeneity (Gavel-style throughput matrix, factorized) ---
        # node_types[row] = interned node-type id; type_throughput[t, c] =
        # relative throughput of resource column c on type t (1.0 =
        # baseline). The kernels derive a per-(shape, node-type) effective
        # throughput from these (hybrid._het_penalty) — the resident
        # encoding of Gavel's throughput matrix for an open-ended shape
        # universe. Type 0 ("default") is the all-ones baseline.
        self.node_types = np.zeros(capacity_nodes, dtype=np.int32)
        self.type_names: List[str] = ["default"]
        self._type_to_id: Dict[str, int] = {"default": 0}
        self.type_throughput = np.ones(
            (4, vocab.capacity), dtype=np.float32
        )
        # Device-mirror bookkeeping (DeviceSchedulerState): topo_version bumps
        # on any change that needs a full re-upload (membership, array
        # reshapes, totals edits); dirty_rows are availability rows whose
        # host value changed since the last device sync.
        self.topo_version = 0
        self.dirty_rows: set = set()
        # Monotone counter over ALL mutations — schedulers use it to retry
        # parked-infeasible work only when the cluster actually changed.
        self.change_counter = 0

    @property
    def num_nodes(self) -> int:
        return len(self._node_ids)

    def _grow(self, min_nodes: int, min_res: int) -> None:
        n_cap, r_cap = self.totals.shape
        new_n = n_cap
        while new_n < min_nodes:
            new_n *= 2
        new_r = r_cap
        while new_r < min_res:
            new_r *= 2
        if (new_n, new_r) != (n_cap, r_cap):
            for attr in ("totals", "avail"):
                old = getattr(self, attr)
                new = np.zeros((new_n, new_r), dtype=np.float32)
                new[:n_cap, :r_cap] = old
                setattr(self, attr, new)
            self.alive = np.resize(self.alive, new_n)
            self.alive[n_cap:] = False
            self.node_types = np.resize(self.node_types, new_n)
            self.node_types[n_cap:] = 0
            if new_r != r_cap:
                thr = np.ones(
                    (self.type_throughput.shape[0], new_r), dtype=np.float32
                )
                thr[:, :r_cap] = self.type_throughput
                self.type_throughput = thr
            self.labels.extend(dict() for _ in range(new_n - n_cap))
            self.capacity_nodes = new_n

    def register_node_type(
        self,
        name: str,
        throughput: Optional[Mapping[str, float]] = None,
    ) -> int:
        """Intern a node type and (optionally) its per-resource relative
        throughput factors ({resource name: factor}, 1.0 = baseline,
        unnamed columns default to 1.0). Re-registering updates the
        factors. Any change bumps ``topo_version`` — the resident
        throughput matrix full-syncs with the next round."""
        tid = self._type_to_id.get(name)
        if tid is None:
            tid = len(self.type_names)
            self.type_names.append(name)
            self._type_to_id[name] = tid
            if tid >= self.type_throughput.shape[0]:
                thr = np.ones(
                    (self.type_throughput.shape[0] * 2,
                     self.type_throughput.shape[1]),
                    dtype=np.float32,
                )
                thr[: self.type_throughput.shape[0]] = self.type_throughput
                self.type_throughput = thr
        if throughput:
            cols = {self.vocab.intern(n): float(v) for n, v in throughput.items()}
            if self.vocab.capacity > self.type_throughput.shape[1]:
                self._grow(max(self.num_nodes, 1), self.vocab.capacity)
            row = np.ones(self.type_throughput.shape[1], dtype=np.float32)
            for col, factor in cols.items():
                row[col] = factor
            self.type_throughput[tid] = row
        self.topo_version += 1
        self.change_counter += 1
        return tid

    def add_node(
        self,
        node_id: str,
        total: Mapping[str, float],
        labels: Optional[Mapping[str, str]] = None,
        node_type: Optional[str] = None,
    ) -> int:
        for name, v in total.items():
            if float(v) > MAX_EXACT_VIEW_TOTAL:
                _warn_view_precision(name, float(v))
        row_total = self.vocab.pack(total)
        self._grow(len(self._node_ids) + 1, self.vocab.capacity)
        if row_total.shape[0] < self.totals.shape[1]:
            row_total = np.resize(row_total, self.totals.shape[1])
        row = self._id_to_row.get(node_id)
        if row is None:
            row = len(self._node_ids)
            self._node_ids.append(node_id)
            self._id_to_row[node_id] = row
        self.totals[row, : len(row_total)] = row_total
        self.avail[row, : len(row_total)] = row_total
        self.alive[row] = True
        self.labels[row] = dict(labels or {})
        if node_type is None and labels:
            node_type = labels.get(self.NODE_TYPE_LABEL)
        self.node_types[row] = (
            self.register_node_type(node_type) if node_type else 0
        )
        self.topo_version += 1
        self.change_counter += 1
        return row

    def remove_node(self, node_id: str) -> None:
        row = self._id_to_row.get(node_id)
        if row is not None:
            self.alive[row] = False
            self.totals[row] = 0
            self.avail[row] = 0
            self.topo_version += 1
            self.change_counter += 1

    def row_of(self, node_id: str) -> int:
        return self._id_to_row[node_id]

    def row_if_known(self, node_id: str) -> Optional[int]:
        """Row index, or None for a node this view never interned —
        locality scoring must skip stale directory locations instead of
        raising (the object outlives its node's membership)."""
        return self._id_to_row.get(node_id)

    def node_id(self, row: int) -> str:
        return self._node_ids[row]

    def update_available(self, node_id: str, avail: Mapping[str, float]) -> None:
        """Apply a gossip snapshot (RaySyncer RESOURCE_VIEW analog)."""
        row = self._id_to_row[node_id]
        packed = self.vocab.pack(avail)
        if packed.shape[0] > self.avail.shape[1]:
            self._grow(self.num_nodes, packed.shape[0])
            self.topo_version += 1
        self.avail[row, : len(packed)] = packed
        self.dirty_rows.add(row)
        self.change_counter += 1

    def subtract(self, row: int, demand: np.ndarray) -> None:
        self.avail[row, : len(demand)] -= demand
        self.dirty_rows.add(row)
        self.change_counter += 1

    def subtract_many(self, rows: np.ndarray, demands: np.ndarray) -> None:
        """Vectorized grant deduction: one duplicate-safe scatter-add for a
        whole round's placements instead of a per-spec Python call (the
        per-grant loop was the dominant host cost of a 4k-lease round at
        10k nodes). ``rows`` int[B], ``demands`` f32[B,<=R]."""
        if rows.size == 0:
            return
        np.subtract.at(
            self.avail[:, : demands.shape[1]],
            rows,
            demands,
        )
        self.dirty_rows.update(int(r) for r in np.unique(rows))
        self.change_counter += 1

    def add(self, row: int, demand: np.ndarray) -> None:
        self.avail[row, : len(demand)] += demand
        self.dirty_rows.add(row)
        self.change_counter += 1

    def active_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(totals, avail, alive) trimmed to the populated node rows."""
        n = self.num_nodes
        return self.totals[:n], self.avail[:n], self.alive[:n]

    def active_type_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(node_types int32[N], type_throughput f32[T,R]) trimmed to the
        populated node rows / registered types — the heterogeneity inputs
        the device mirror keeps resident (full-synced on topo_version
        moves, which every type registration bumps)."""
        n = self.num_nodes
        t = len(self.type_names)
        return (
            self.node_types[:n],
            self.type_throughput[:t, : self.totals.shape[1]],
        )
