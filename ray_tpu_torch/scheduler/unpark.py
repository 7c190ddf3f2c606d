"""Capacity-capped unparking of infeasible-queued work.

Port of ``ray_tpu/scheduler/unpark.py``, copied.

Shared by the cluster head and the in-process runtime: re-feeding the
ENTIRE parked queue into the pending queue on every capacity-freeing
event is O(parked²) aggregate scheduling work under a deep backlog (5k
parked specs × ~40 unpark events re-scores ~200k placements to grant
5k) — exactly the storm the reference avoids by leaving unschedulable
scheduling classes parked until resources change and retrying them
per-class (cluster_lease_manager.cc:298 TryScheduleInfeasibleLease +
local_lease_manager.h per-class backoff). Per resource shape, the
grantable-slot count is estimated from the live availability arrays and
only that many specs (+slack for estimate error) unpark; the remainder
stays parked for the next change event.

Slot estimation has two backends: the host NumPy scan (one pass per
shape over a fresh copy of the availability arrays — the original), and
``slots_fn`` — a batched estimator over the scheduler device's RESIDENT
arrays (``DeviceSchedulerState.shape_slots``: one kernel dispatch for
ALL shapes, no host copy, no re-upload). The head passes the device
estimator whenever the device scheduler is live.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

UNPARK_SLACK = 32


def select_unparkable_resilient(
    parked: List[Any],
    avail: Optional[np.ndarray],
    alive: Optional[np.ndarray],
    *,
    device_state: Any,
    slots_fn: Optional[Callable[[np.ndarray], np.ndarray]],
    refetch: Callable[[], Tuple[np.ndarray, np.ndarray]],
    **kwargs: Any,
) -> Tuple[List[Any], List[Any]]:
    """``select_unparkable`` with the device-estimator survival contract
    shared by the head and the single-process runtime: a ``slots_fn``
    failure (it dispatches on the scheduler device mid-scan) must not
    kill the caller's scheduler thread — invalidate the device mirror
    (full re-sync next round) and redo the scan host-side on fresh
    copies from ``refetch`` (called under the caller's locking
    discipline). A raise on the pure-NumPy path is a real bug and
    propagates."""
    try:
        return select_unparkable(
            parked, avail, alive, slots_fn=slots_fn, **kwargs
        )
    except Exception:  # noqa: BLE001 - scheduler must survive
        if slots_fn is None:
            raise
        logger.exception("device slot estimation failed; host scan")
        device_state.invalidate()
        a0, al0 = refetch()
        return select_unparkable(parked, a0, al0, slots_fn=None, **kwargs)


def select_unparkable(
    parked: List[Any],
    avail: Optional[np.ndarray],
    alive: Optional[np.ndarray],
    *,
    is_constrained: Callable[[Any], bool],
    resources_of: Callable[[Any], dict],
    request_of: Callable[[Any], Any],
    slack: int = UNPARK_SLACK,
    reserved: Any = None,
    slots_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    age_of: Optional[Callable[[Any], int]] = None,
) -> Tuple[List[Any], List[Any]]:
    """(take, keep): specs to re-queue now vs. keep parked.

    ``is_constrained``: shape-capacity math doesn't apply (affinity /
    PG / target-node routed) — those unpark ``slack`` at a time.
    ``request_of`` returns a ResourceRequest (``demands`` keyed by dense
    column, ``dense(width)``). ``reserved``: dense demand rows already
    granted but not yet reflected in ``avail`` (e.g. worker leases being
    placed — the agent's ledger deduction reaches the view only with its
    next report); each reserved row that overlaps a shape's demand
    columns is assumed to consume one of that shape's slots.
    ``slots_fn``: batched slot estimator f32[S,R] → int[S] (the
    device-resident path); when given, ``avail``/``alive`` are only used
    for the resource-axis width and may be the live views (no copy
    needed — they are never scanned host-side).
    ``age_of``: optional shape-key → wait-age lookup (head._shape_wait);
    shapes unpark in age-descending order so a STARVING shape claims the
    grantable slots before younger shapes re-consume the freed capacity
    (the unpark half of the starvation/fairness term)."""
    if len(parked) <= slack:
        return list(parked), []
    r = avail.shape[1] if avail is not None and avail.ndim == 2 else 0
    by_shape: dict = {}
    order: List[Any] = []
    for spec in parked:
        if is_constrained(spec):
            key: Any = None
        else:
            key = tuple(sorted(resources_of(spec).items()))
        q = by_shape.get(key)
        if q is None:
            q = by_shape[key] = []
            order.append(key)
        q.append(spec)

    # resolve each unconstrained shape to a dense row (or None: names a
    # resource no node reported — infeasible until the cluster changes
    # shape; slack covers vocab growth)
    dense_rows: dict = {}
    for key in order:
        if key is None:
            continue
        req = request_of(by_shape[key][0])
        if any(c >= r for c in req.demands):
            dense_rows[key] = None
        else:
            dense_rows[key] = req.dense(r)

    slot_counts: dict = {}
    batchable = [k for k in order if k is not None and dense_rows[k] is not None]
    if slots_fn is not None and batchable:
        # one batched kernel over ALL shapes (device-resident arrays)
        mat = np.stack([dense_rows[k] for k in batchable])
        counts = slots_fn(mat)
        for k, c in zip(batchable, counts):
            slot_counts[k] = int(c)
    else:
        for k in batchable:
            d = dense_rows[k]
            cols = d > 0
            if not cols.any():
                slot_counts[k] = len(by_shape[k])  # zero-demand: all grantable
                continue
            slots = np.floor(avail[:, cols] / d[cols][None, :]).min(axis=1)
            slots = np.where(alive, np.maximum(slots, 0.0), 0.0)
            slot_counts[k] = int(slots.sum())

    if age_of is not None:
        # starving shapes first (stable: equal ages keep arrival order)
        order.sort(key=lambda k: -(age_of(k) if k is not None else 0))
    take: List[Any] = []
    keep: List[Any] = []
    for key in order:
        q = by_shape[key]
        if key is None or dense_rows[key] is None:
            cap = slack
        else:
            cap = slot_counts[key]
            d = dense_rows[key]
            cols = d > 0
            if not cols.any():
                cap = len(q)
            elif reserved is not None:
                # outstanding grants eat into the estimate before
                # the view hears about them
                overlap = sum(
                    1
                    for row in reserved
                    if row.shape[0] >= r and (row[:r][cols] > 0).any()
                )
                cap = max(0, cap - overlap)
            if cols.any():
                cap += slack
        n = min(len(q), cap)
        take.extend(q[:n])
        keep.extend(q[n:])
    return take, keep
