"""Device-resident scheduler state: the live runtime's default placement path.

Port of ``ray_tpu/scheduler/device.py``. The cluster's resource arrays
stay resident on the scheduler device (``cuda`` by default,
``cfg.sched_platform``), and per round the host ships only

  - dirty availability rows (delta sync: a bucket-padded ``index_copy``), and
  - the batch's unique demand shapes + per-request shape ids,

and reads back one int32 node row per request. Full re-uploads happen only
on topology changes (node add/remove, array growth) tracked by
``ClusterView.topo_version``.

Pipelined rounds: ``schedule_async`` dispatches the round's program,
starts a ``non_blocking`` copy of the placement rows into pinned host
memory and records a CUDA event, and returns a ``PendingRound``. Its
``result()`` waits on that event alone, so round N+1, dispatched behind
it, keeps running: it consumes round N's ``avail_out`` on the same stream
and no program reads a value back to the host. ``scheduler/pipeline.py``
drains the handles on a completion thread; ``schedule()`` is the
synchronous form.

The same resident arrays feed the PG bundle programs
(``resident_arrays()``), the unpark estimator (``shape_slots``), and the
parked-demand ring (``ring_park`` / ``ring_schedule``: resident shape rows
placed by count).

There is no fallback: a ``cuda`` platform without CUDA raises. The
reference's jit cache, persistent compile cache and background compiles
have no eager counterpart; ``prewarm`` runs one warm-up round per bucket.
``bring_up_device_state`` keeps the reference's bring-up timeout but not
its degrade to the host golden model: the card is used or the runtime
fails.
"""
from __future__ import annotations

import atexit
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..util.metrics import Histogram as _MetricHistogram

logger = logging.getLogger(__name__)

_BIG = 1e18  # padding demand: larger than any node total → never placed

# Round-latency decomposition. upload = dirty-row/ring pushes + demand
# uploads (host-blocking); kernel = dispatch → the round's event done, as
# observed at harvest; readback = host materialization of the pinned copy.
SCHED_UPLOAD_MS = _MetricHistogram(
    "sched_upload_ms",
    "Per-round host→device sync cost: dirty-row scatter pushes + demand "
    "shape/id uploads, in ms.",
    boundaries=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 25, 100, 500),
)
SCHED_KERNEL_MS = _MetricHistogram(
    "sched_kernel_ms",
    "Per-round kernel latency (dispatch to computation-ready) in ms.",
    boundaries=(0.1, 0.25, 0.5, 1, 2, 5, 10, 25, 50, 100, 500, 5000),
)
SCHED_READBACK_MS = _MetricHistogram(
    "sched_readback_ms",
    "Per-round placement readback materialization cost in ms.",
    boundaries=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 25, 100, 500),
)


def device_scheduler_default() -> bool:
    """Default ON: the device programs ARE the product scheduler;
    RAY_TPU_DEVICE_SCHEDULER=0 selects the NumPy golden model."""
    from ..config import cfg

    return cfg.device_scheduler


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def pad_scatter(rows: np.ndarray, vals: np.ndarray):
    """Bucket-pad a scatter-set's (rows, vals) by repeating row 0 — a
    duplicate scatter-set of one row with identical values is
    deterministic (on CUDA too, whichever duplicate lands last), and the
    padding keeps the shapes to bucket sizes. The ONE encoding of that
    invariant, shared by the avail delta path, the ring flush, and the
    autoscaler's DeltaBinPacker."""
    pad = _bucket(rows.shape[0], 1) - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.repeat(rows[:1], pad)])
        vals = np.concatenate([vals, np.repeat(vals[:1], pad, axis=0)])
    return rows, vals


def elastic_pack_solve(
    avail: np.ndarray,
    shapes: np.ndarray,
    counts: np.ndarray,
    *,
    iters: int = 24,
    device=None,
):
    """One batched ``solve_pack_counts`` for the unified elasticity plane,
    both axes bucket-padded (node rows with zero capacity, shape rows with
    zero count). Returns host-side ``(placed f32[U], per_node f32[U, N])``
    trimmed back to true sizes."""
    n, r = int(avail.shape[0]), int(avail.shape[1])
    u = int(shapes.shape[0])
    if n == 0 or u == 0:
        return (
            np.zeros((u,), dtype=np.float32),
            np.zeros((u, n), dtype=np.float32),
        )
    np_pad = _bucket(n) - n
    up_pad = _bucket(u) - u
    if np_pad:
        avail = np.concatenate(
            [avail, np.zeros((np_pad, r), dtype=np.float32)]
        )
    if up_pad:
        shapes = np.concatenate(
            [shapes, np.zeros((up_pad, r), dtype=np.float32)]
        )
        counts = np.concatenate(
            [counts, np.zeros((up_pad,), dtype=np.float32)]
        )
    from .binpack import solve_pack_counts

    res = solve_pack_counts(
        np.asarray(avail, dtype=np.float32),
        np.asarray(shapes, dtype=np.float32),
        np.asarray(counts, dtype=np.float32),
        iters=int(iters),
        device=device,
    )
    placed = res.placed.cpu().numpy()[:u]
    per_node = res.per_node.cpu().numpy()[:u, :n]
    return placed.astype(np.float32), per_node.astype(np.float32)


# Interpreter-exit guard for prewarm threads: the flag stops the warm loop
# between rounds; the join bounds how long exit waits for the one round that
# may be mid-flight.
_shutting_down = False
_live_prewarms: list = []


def _drain_prewarms() -> None:
    global _shutting_down
    _shutting_down = True
    for t in list(_live_prewarms):
        t.join(timeout=30.0)


atexit.register(_drain_prewarms)


def score_weights_from_cfg():
    """The round programs' multi-objective weights (hybrid.ScoreWeights)
    from config."""
    from ..config import cfg
    from .hybrid import ScoreWeights

    return ScoreWeights(
        util=float(cfg.sched_w_util),
        het=float(cfg.sched_w_het),
        frag=float(cfg.sched_w_frag),
        starve=float(cfg.sched_w_starve),
        locality=float(cfg.sched_w_locality),
    )


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, copied without waiting on the card's
    queue (a blocking copy would wait for every round in flight)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class PendingRound:
    """Handle to a dispatched scheduling round.

    The program is in flight (or done) on the device and a copy of the
    placement rows into pinned host memory is queued behind it, marked by
    a CUDA event; ``result()`` waits on THIS round's event only — later
    rounds already dispatched keep executing behind it (avail chain).
    """

    __slots__ = (
        "_node", "_b", "_preempt", "_u", "_terms", "_event", "dispatched_at", "ctx",
    )

    def __init__(
        self, node, b: int, ctx=None, preempt=None, u: int = 0, terms=None, event=None
    ):
        self._node = node        # int32[B_pad] host (pinned on CUDA)
        self._b = b
        self._preempt = preempt  # int32[U_pad] host, or None
        self._u = u              # real (unpadded) shape count
        self._terms = terms      # f32[B_pad, 5] host, or None
        self._event = event      # torch.cuda.Event after the copies, or None
        self.dispatched_at = time.perf_counter()
        self.ctx = ctx  # opaque caller payload (e.g. the round's specs)

    def _wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    def result(self) -> np.ndarray:
        """int32[B] node row per request (-1 = unplaceable now)."""
        node = self._node
        if node is None:
            raise RuntimeError("PendingRound.result() consumed twice")
        self._wait()
        SCHED_KERNEL_MS.observe(
            (time.perf_counter() - self.dispatched_at) * 1e3
        )
        t0 = time.perf_counter()
        rows = node[: self._b].numpy().copy()
        SCHED_READBACK_MS.observe((time.perf_counter() - t0) * 1e3)
        self._node = None  # drop the buffer eagerly
        return rows

    def preempt_rows(self) -> Optional[np.ndarray]:
        """int32[U] per-shape nominated victim node (-1 = none), or None
        when the round dispatched without preemption. It rode the same
        copy as the rows: call after ``result()``."""
        p = self._preempt
        if p is None:
            return None
        self._wait()
        self._preempt = None
        return p[: self._u].numpy().copy()

    def terms_rows(self) -> Optional[np.ndarray]:
        """f32[B, 5] per-request cost attribution (hybrid.TERM_NAMES
        order; zero rows for unplaced requests), or None when the round
        dispatched without explain."""
        t = self._terms
        if t is None:
            return None
        self._wait()
        self._terms = None
        return t[: self._b].numpy().copy()


class DeviceSchedulerState:
    """Resident mirror of a ClusterView on one torch device + the
    scheduling round.

    Sync protocol (host view stays canonical, fed by agent reports): every
    host mutation of an availability row marks it dirty; ``sync(view)``
    pushes dirty rows (or everything when topo_version moved) before a
    round; the round's in-program deductions live in its avail_out, which
    becomes the resident avail, and the host applies the same deductions to
    its mirror (marking those rows dirty), so the next sync is an
    idempotent overwrite. See the reference for the staleness this allows
    while rounds are in flight.

    Thread contract: ``sync`` under the caller's view lock; ``_lock``
    serializes device-buffer swaps (dirty push, round dispatch, ring round)
    and is held only across the dispatch + swap — never across a readback.
    """

    def __init__(self, platform: Optional[str] = None):
        from .._device import resolve_device
        from ..config import cfg

        if platform is None:
            platform = cfg.sched_platform
        if str(platform).startswith("cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"scheduler platform {platform!r} needs CUDA and no CUDA device "
                    "is available; pass platform='cpu' to schedule on the host"
                )
        self.device = resolve_device(platform)
        self._totals = None  # f32[C,R] device
        self._avail = None   # f32[C,R] device
        self._alive = None   # bool[C] device
        self._ntypes = None  # int64[C] device node-type ids
        self._thr = None     # f32[T,R] device per-type throughput factors
        self._synced_topo = -1
        self._seed = 0
        self._lock = threading.Lock()
        # delta-sync / round accounting, surfaced via QueryState("sched")
        self.stats: Dict[str, int] = {
            "full_syncs": 0,
            "delta_pushes": 0,
            "delta_rows": 0,
            "delta_rows_hwm": 0,
            "rounds": 0,
            "ring_rounds": 0,
            "prewarmed": 0,
        }
        # --- parked-demand ring (device-resident shapes) ---
        self.ring_slots = max(0, int(cfg.sched_ring_slots))
        self._ring_rows: Optional[np.ndarray] = None   # host mirror [S,R]
        self._ring_dev = None                          # f32[S,R] device
        self._ring_keys: Dict[object, int] = {}        # shape key -> slot
        self._ring_free: list = list(range(self.ring_slots))
        self._ring_dirty: set = set()
        self._prewarm_thread: Optional[threading.Thread] = None

    # -- sync ----------------------------------------------------------

    def sync(self, view) -> None:
        """Bring the device mirror up to date. Caller holds the view lock."""
        t0 = time.perf_counter()
        with self._lock:
            if view.topo_version != self._synced_topo:
                self._full_sync(view)
            elif view.dirty_rows:
                self._push_dirty(view)
            else:
                return
        SCHED_UPLOAD_MS.observe((time.perf_counter() - t0) * 1e3)

    def _full_sync(self, view) -> None:
        dev = self.device
        self._totals = _upload(view.totals, dev)
        self._avail = _upload(view.avail, dev)
        self._alive = _upload(view.alive, dev)
        # heterogeneity inputs ride the same full-sync: node-type ids at
        # node capacity, throughput factors bucket-padded on the type axis
        # with all-ones rows (no node references a pad type)
        ntypes = getattr(view, "node_types", None)
        if ntypes is None:
            self._ntypes = torch.zeros(view.totals.shape[0], dtype=torch.int64, device=dev)
            self._thr = torch.ones((1, view.totals.shape[1]), dtype=torch.float32, device=dev)
        else:
            self._ntypes = _upload(ntypes.astype(np.int64), dev)
            t = len(view.type_names)
            t_pad = _bucket(t, 1)
            thr = np.ones((t_pad, view.totals.shape[1]), dtype=np.float32)
            thr[:t] = view.type_throughput[:t, : view.totals.shape[1]]
            self._thr = _upload(thr, dev)
        self._synced_topo = view.topo_version
        view.dirty_rows.clear()
        self.stats["full_syncs"] += 1
        # resource-axis growth invalidates the resident ring rows too
        if self._ring_rows is not None and (
            self._ring_rows.shape[1] != view.totals.shape[1]
        ):
            widened = np.zeros(
                (self.ring_slots, view.totals.shape[1]), dtype=np.float32
            )
            widened[:, : self._ring_rows.shape[1]] = self._ring_rows
            self._ring_rows = widened
            self._ring_dev = None  # re-upload lazily at next ring round
        self.prewarm(view.totals.shape[0], view.totals.shape[1])

    def _scatter_push(self, dev, rows: np.ndarray, vals: np.ndarray):
        """Bucket-padded scatter-set of ``rows``/``vals`` into a copy of
        ``dev`` (``pad_scatter`` invariant: duplicate rows carry identical
        values, so the scatter is deterministic on every device)."""
        rows, vals = pad_scatter(rows, vals)
        return dev.index_copy(0, _upload(rows.astype(np.int64), self.device),
                              _upload(vals, self.device))

    def _push_dirty(self, view) -> None:
        rows = np.fromiter(view.dirty_rows, dtype=np.int64)
        view.dirty_rows.clear()
        vals = view.avail[rows].copy()
        self.stats["delta_pushes"] += 1
        self.stats["delta_rows"] += int(rows.shape[0])
        if int(rows.shape[0]) > self.stats["delta_rows_hwm"]:
            self.stats["delta_rows_hwm"] = int(rows.shape[0])
        self._avail = self._scatter_push(self._avail, rows, vals)

    def invalidate(self) -> None:
        """Force the next sync() to full-upload from the host mirror (a
        round that died before its readback left deductions on the device
        that the canonical host mirror never applied)."""
        with self._lock:
            self._synced_topo = -1

    def resident_arrays(self):
        """(totals, avail, alive) device refs for read-only consumers (PG
        bundle packing, autoscaler residual packing, slot estimation).
        Caller must have sync()ed under its view lock."""
        return self._totals, self._avail, self._alive

    # -- the scheduling round ------------------------------------------

    def schedule_async(
        self,
        demands: Optional[np.ndarray] = None,
        spread_threshold: float = 0.5,
        ctx=None,
        shapes=None,
        ages: Optional[np.ndarray] = None,
        weights=None,
        locality: Optional[np.ndarray] = None,
    ) -> PendingRound:
        """Dispatch a placement round without blocking on its readback.

        f32[B,R] demands → PendingRound whose ``result()`` yields int32[B]
        node rows (-1 = unplaceable now). The caller must have called
        sync() under its view lock. ``shapes``: optional precomputed
        ``(shape_rows f32[U,R], shape_ids int32[B])`` dedupe. ``ages``:
        optional f32[U] normalized wait-age per shape; it arms preemption
        nomination (cfg.sched_preempt). ``weights``: hybrid.ScoreWeights
        override (default: the cfg knobs). ``locality``: optional
        f32[U, N'] per-shape per-node locality, used only when the weights
        carry locality > 0.
        """
        from ..config import cfg
        from .hybrid import dedupe_shapes, hybrid_schedule_shapes_multi_impl

        r = self._totals.shape[1]
        if shapes is not None:
            shape_demands, shape_ids = shapes
        else:
            assert demands.shape[1] == r, (demands.shape, r)
            shape_demands, shape_ids = dedupe_shapes(demands)
        b = shape_ids.shape[0]
        u = shape_demands.shape[0]
        assert shape_demands.shape[1] == r, (shape_demands.shape, r)
        if weights is None:
            weights = score_weights_from_cfg()
        preempt = bool(cfg.sched_preempt) and ages is not None
        explain = bool(cfg.sched_explain)

        u_pad = _bucket(u + 1, 2)
        b_pad = _bucket(b)
        sd = np.full((u_pad, r), _BIG, dtype=np.float32)
        sd[:u] = shape_demands
        sids = np.full(b_pad, u_pad - 1, dtype=np.int64)  # padding → BIG shape
        sids[:b] = shape_ids
        age_vec = np.zeros(u_pad, dtype=np.float32)
        if ages is not None:
            age_vec[:u] = ages

        dev = self.device
        t_up = time.perf_counter()
        sd_dev = _upload(sd, dev)
        sids_dev = _upload(sids, dev)
        ages_dev = _upload(age_vec, dev)
        loc_dev = None
        if locality is not None and getattr(weights, "locality", 0.0):
            c = int(self._totals.shape[0])
            loc = np.zeros((u_pad, c), dtype=np.float32)
            nn = min(int(locality.shape[1]), c)
            loc[:u, :nn] = locality[:u, :nn]
            loc_dev = _upload(loc, dev)
        SCHED_UPLOAD_MS.observe((time.perf_counter() - t_up) * 1e3)
        with self._lock:
            self._seed += 1
            self.stats["rounds"] += 1
            res = hybrid_schedule_shapes_multi_impl(
                self._totals,
                self._avail,
                self._alive,
                self._ntypes,
                self._thr,
                sd_dev,
                sids_dev,
                ages_dev,
                self._seed & 0xFFFFFFFF,
                spread_threshold=spread_threshold,
                weights=weights,
                preempt=preempt,
                locality=loc_dev,
                explain=explain,
            )
            self._avail = res.avail_out
        node, pre, terms, event = self._readback(
            res.node, res.preempt_node if preempt else None, res.terms if explain else None)
        return PendingRound(node, b, ctx=ctx, preempt=pre, u=u, terms=terms, event=event)

    def _readback(self, *tensors):
        """Queue host copies of ``tensors`` (None passes through) behind the
        work on the stream; returns the host tensors and, on CUDA, the
        event that marks them complete. On the CPU the outputs already are
        host tensors."""
        if self.device.type != "cuda":
            return (*tensors, None)
        out = []
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out.append(host)
        event = torch.cuda.Event()
        event.record()
        return (*out, event)

    def schedule(self, demands: np.ndarray, spread_threshold: float = 0.5):
        """Synchronous round: dispatch + immediate readback."""
        return self.schedule_async(demands, spread_threshold).result()

    # -- parked-demand ring --------------------------------------------

    def ring_park(self, key, dense_row: np.ndarray) -> bool:
        """Pin a resource shape in the on-device ring. Idempotent per key;
        returns False when the ring is full (caller falls back to the
        re-upload path for that shape)."""
        if self.ring_slots <= 0:
            return False
        with self._lock:
            if key in self._ring_keys:
                return True
            if not self._ring_free:
                return False
            r = self._totals.shape[1] if self._totals is not None else None
            if r is None or dense_row.shape[0] != r:
                return False
            if self._ring_rows is None or self._ring_rows.shape[1] != r:
                self._ring_rows = np.zeros(
                    (self.ring_slots, r), dtype=np.float32
                )
                self._ring_dev = None
            slot = self._ring_free.pop()
            self._ring_keys[key] = slot
            self._ring_rows[slot] = dense_row
            self._ring_dirty.add(slot)
            return True

    def ring_drop(self, key) -> None:
        """Release a shape's ring slot (its parked queue drained)."""
        with self._lock:
            slot = self._ring_keys.pop(key, None)
            if slot is not None:
                self._ring_rows[slot] = 0.0
                self._ring_dirty.add(slot)
                self._ring_free.append(slot)

    def ring_occupancy(self) -> int:
        return len(self._ring_keys)

    def ring_keys(self) -> list:
        """Snapshot of the currently-pinned shape keys."""
        with self._lock:
            return list(self._ring_keys)

    def ring_slot_of(self, key) -> Optional[int]:
        return self._ring_keys.get(key)

    def _ring_flush_locked(self) -> None:
        """Upload dirty ring rows (scatter, bucketed like avail pushes).
        Caller holds self._lock."""
        if self._ring_dev is None:
            if self._ring_rows is None:
                self._ring_rows = np.zeros(
                    (self.ring_slots, self._totals.shape[1]), dtype=np.float32
                )
            self._ring_dev = _upload(self._ring_rows, self.device)
            self._ring_dirty.clear()
            return
        if not self._ring_dirty:
            return
        rows = np.fromiter(self._ring_dirty, dtype=np.int64)
        self._ring_dirty.clear()
        vals = self._ring_rows[rows].copy()
        self._ring_dev = self._scatter_push(self._ring_dev, rows, vals)

    def ring_schedule(
        self,
        counts_by_slot: Dict[int, int],
        spread_threshold: float = 0.5,
        ages_by_slot: Optional[Dict[int, float]] = None,
        weights=None,
    ):
        """Place parked demand straight from the resident ring.

        ``counts_by_slot``: pending request count per ring slot. Returns
        (placed int32[S], per_node int32[S,N], preempt int32[S]) on the
        host. Only the count (and age) vectors cross to the device; the
        shapes are already resident.
        """
        from ..config import cfg
        from .hybrid import ring_schedule_impl

        t_up = time.perf_counter()
        counts = np.zeros(self.ring_slots, dtype=np.int32)
        for slot, c in counts_by_slot.items():
            counts[slot] = min(int(c), np.iinfo(np.int32).max)
        ages = np.zeros(self.ring_slots, dtype=np.float32)
        if ages_by_slot:
            for slot, a in ages_by_slot.items():
                ages[slot] = float(a)
        if weights is None:
            weights = score_weights_from_cfg()
        preempt = bool(cfg.sched_preempt) and ages_by_slot is not None
        with self._lock:
            self._ring_flush_locked()
            counts_dev = _upload(counts, self.device)
            ages_dev = _upload(ages, self.device)
            SCHED_UPLOAD_MS.observe((time.perf_counter() - t_up) * 1e3)
            self._seed += 1
            self.stats["ring_rounds"] += 1
            t_k = time.perf_counter()
            res = ring_schedule_impl(
                self._totals,
                self._avail,
                self._alive,
                self._ntypes,
                self._thr,
                self._ring_dev,
                counts_dev,
                ages_dev,
                self._seed & 0xFFFFFFFF,
                spread_threshold=spread_threshold,
                weights=weights,
                preempt=preempt,
            )
            self._avail = res.avail_out
        placed = res.placed.cpu().numpy()
        per_node = res.per_node.cpu().numpy()
        preempt_rows = res.preempt_node.cpu().numpy()
        SCHED_KERNEL_MS.observe((time.perf_counter() - t_k) * 1e3)
        return placed, per_node, preempt_rows

    # -- unpark slot estimation ----------------------------------------

    def shape_slots(self, shapes: np.ndarray) -> np.ndarray:
        """int64[S] grantable-slot estimate per demand shape, computed on
        the resident arrays in one dispatch. Shapes are bucket-padded with
        _BIG rows (0 slots)."""
        from .hybrid import shape_slots_impl

        s = shapes.shape[0]
        r = self._totals.shape[1]
        s_pad = _bucket(s, 1)
        mat = np.full((s_pad, r), _BIG, dtype=np.float32)
        mat[:s] = shapes
        with self._lock:
            res = shape_slots_impl(
                self._totals,
                self._avail,
                self._alive,
                _upload(mat, self.device),
            )
        return res.cpu().numpy()[:s].astype(np.int64)

    # -- prewarm ---------------------------------------------------------

    def prewarm(self, n_cap: int, r: int, spread_threshold: float = 0.5):
        """Run one warm-up round per (batch, unique-shape) bucket for the
        CURRENT array geometry on a background thread, so the first real
        round at each size does not pay first-touch costs inline (CUDA
        context and kernel loading, allocator growth). The reference
        compiles its jit cache here; eager programs have nothing to
        compile. Idempotent per geometry; no-op while a warm thread is
        still running, and off when cfg.sched_prewarm is."""
        from ..config import cfg

        if not cfg.sched_prewarm:
            return
        if self._prewarm_thread is not None and self._prewarm_thread.is_alive():
            return
        key = (n_cap, r)
        if getattr(self, "_prewarmed_geometry", None) == key:
            return
        self._prewarmed_geometry = key

        def _warm():
            from .hybrid import hybrid_schedule_shapes_multi_impl

            try:
                max_b = _bucket(int(cfg.sched_max_batch))
                b_sizes, b = [], 8
                while b <= max_b:
                    b_sizes.append(b)
                    b *= 4  # every other bucket: 8,32,128,512,2048(,8192)
                if b_sizes[-1] != max_b:
                    b_sizes.append(max_b)
                dev = self.device
                ones = torch.ones((n_cap, r), dtype=torch.float32, device=dev)
                alive = torch.ones(n_cap, dtype=torch.bool, device=dev)
                weights = score_weights_from_cfg()
                t_pad = self._thr.shape[0] if self._thr is not None else 1
                ntypes = torch.zeros(n_cap, dtype=torch.int64, device=dev)
                thr = torch.ones((t_pad, r), dtype=torch.float32, device=dev)
                for u_pad in (2, 4, 8, 16):
                    sd = np.full((u_pad, r), _BIG, dtype=np.float32)
                    sd[0, 0] = 1.0
                    sd_dev = _upload(sd, dev)
                    ages = torch.zeros(u_pad, dtype=torch.float32, device=dev)
                    for b_pad in b_sizes:
                        if _shutting_down:
                            return
                        sids = torch.zeros(b_pad, dtype=torch.int64, device=dev)
                        res = hybrid_schedule_shapes_multi_impl(
                            ones, ones, alive, ntypes, thr, sd_dev, sids, ages, 1,
                            spread_threshold=spread_threshold, weights=weights,
                            preempt=bool(cfg.sched_preempt),
                            explain=bool(cfg.sched_explain),
                        )
                        res.node.cpu()
                        self.stats["prewarmed"] += 1
            except Exception:  # noqa: BLE001 - warm-up is best-effort
                logger.debug("scheduler prewarm failed", exc_info=True)
            finally:
                try:
                    _live_prewarms.remove(threading.current_thread())
                except ValueError:  # pragma: no cover
                    pass

        self._prewarm_thread = threading.Thread(
            target=_warm, name="sched-prewarm", daemon=True
        )
        _live_prewarms.append(self._prewarm_thread)
        self._prewarm_thread.start()


def bring_up_device_state(timeout_s: Optional[float] = None) -> DeviceSchedulerState:
    """The runtime's DeviceSchedulerState on ``cfg.sched_platform``, brought
    up (the state and one round trip through the device) within
    ``sched_init_timeout_s``, or a RuntimeError naming the platform and the
    timeout: CUDA absent, bring-up failed, or out of time.

    The reference's ``LazyDeviceState`` (``ray_tpu/scheduler/device.py:273``)
    defers bring-up to the first round and, past its timeout, quietly
    schedules on the NumPy golden model. The port does neither: the runtime
    calls this at ``init()``, and the golden model runs only when asked for
    (``use_device_scheduler=False`` or ``RAY_TPU_DEVICE_SCHEDULER=0``).
    """
    from ..config import cfg

    timeout_s = cfg.sched_init_timeout_s if timeout_s is None else timeout_s
    platform = cfg.sched_platform
    box: Dict[str, object] = {}

    def _init() -> None:
        try:
            state = DeviceSchedulerState(platform)
            torch.zeros(1, device=state.device).add_(1).cpu()
            box["state"] = state
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc

    t = threading.Thread(target=_init, name="sched-device-init", daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    where = f"scheduler platform {platform!r} (sched_init_timeout_s={timeout_s})"
    if t.is_alive():
        raise RuntimeError(f"{where}: the device did not come up in time")
    if "error" in box:
        raise RuntimeError(f"{where}: bring-up failed: {box['error']}") from box["error"]
    return box["state"]
