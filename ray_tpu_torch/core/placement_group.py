"""Placement groups: gang resource reservation via the batched bin-pack programs.

Port of ``ray_tpu/core/placement_group.py``, with its imports rewritten.
The bundle programs get the runtime's scheduler device
(``Runtime.sched_device``, from ``cfg.sched_platform``): they are given host
arrays, so without it they would pick ``cuda`` even on the CPU path. Remote
placement groups (``init(address=...)``) are placed by the cluster head.


Analog of the reference PG stack (GcsPlacementGroupManager/Scheduler +
bundle policies + 2-phase commit, /root/reference/src/ray/gcs/
gcs_placement_group_scheduler.cc:41-219 and python/ray/util/
placement_group.py). Bundle placement runs through
``scheduler.schedule_bundles`` (the batched PACK/SPREAD/STRICT_*
programs); the chosen layout is then committed two-phase against each node's
exact ledger — all bundles allocate or the whole reservation rolls back and
the PG is retried when cluster resources change.
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..scheduler import ResourceRequest, schedule_bundles
from .object_store import ObjectRef


@dataclass
class _Bundle:
    request: ResourceRequest
    node_id: Optional[str] = None
    avail_fp: Optional[Dict[int, int]] = None  # remaining capacity inside bundle


class PlacementGroupState:
    """Head-side PG record + per-bundle reserved-resource ledgers."""

    def __init__(self, runtime, bundles: List[Dict[str, float]], strategy: str,
                 name: str = "", avoid_nodes: Optional[List[str]] = None):
        self.runtime = runtime
        self.id = uuid.uuid4().hex[:16]
        self.name = name
        self.strategy = strategy
        self.avoid_nodes = [str(n) for n in (avoid_nodes or ())]
        self.bundle_specs = [dict(b) for b in bundles]
        self.bundles = [
            _Bundle(ResourceRequest.from_map(runtime.vocab, b)) for b in bundles
        ]
        self.ready_event = threading.Event()
        self.ready_ref = ObjectRef.new(owner="pg")
        runtime.store.create(self.ready_ref)
        self._lock = threading.Lock()
        self.removed = False
        # dense demand matrix memo: a pending PG retries try_schedule on
        # every view change — restacking the (immutable) bundle demands
        # per attempt was pure overhead (keyed by view width, which can
        # grow when new resource names appear)
        self._dense: Optional[tuple] = None  # (width, np.ndarray)

    # -- scheduling (called from the scheduler thread) ------------------
    def try_schedule(self) -> bool:
        """Run the bundle kernel + 2PC commit. True if now ready."""
        rt = self.runtime
        totals, avail, alive = rt.view.active_arrays()
        if rt.view.num_nodes == 0:
            return False
        width = totals.shape[1]
        if self._dense is None or self._dense[0] != width:
            self._dense = (
                width,
                np.stack([b.request.dense(width) for b in self.bundles]),
            )
        mat = self._dense[1]
        if self.avoid_nodes:
            from ..scheduler.bundles import (
                schedule_bundles_soft_avoid,
            )

            nodes_idx, success, _ = schedule_bundles_soft_avoid(
                totals, avail, alive, mat, self.strategy,
                [rt.view.row_if_known(n) for n in self.avoid_nodes],
                device=rt.sched_device,
            )
        else:
            nodes_idx, success, _ = schedule_bundles(
                totals, avail, alive, mat, strategy=self.strategy,
                device=rt.sched_device,
            )
        if not success:
            return False
        chosen = [rt.view.node_id(int(r)) for r in nodes_idx]
        # Phase 1: prepare — allocate on every node ledger, rollback on any
        # failure (PrepareBundleResources, gcs_placement_group_scheduler.cc:192).
        done: List[int] = []
        for i, node_id in enumerate(chosen):
            node = rt.nodes.get(node_id)
            if node is None or not node.alive or not node.ledger.try_allocate(
                self.bundles[i].request
            ):
                for j in done:
                    rt.nodes[chosen[j]].ledger.release(self.bundles[j].request)
                return False
            done.append(i)
        # Phase 2: commit.
        for i, node_id in enumerate(chosen):
            b = self.bundles[i]
            b.node_id = node_id
            b.avail_fp = dict(b.request.demands)
            rt.view.update_available(node_id, rt.nodes[node_id].ledger.avail_map())
        self.ready_event.set()
        rt.store.seal(self.ready_ref, True)
        return True

    # -- bundle-resource accounting ------------------------------------
    def pick_bundle(self, bundle_index: int, req: ResourceRequest):
        """Choose a bundle that can host ``req``. Returns (node_id, idx) or
        None."""
        with self._lock:
            if not self.ready_event.is_set() or self.removed:
                return None
            candidates = (
                range(len(self.bundles))
                if bundle_index < 0
                else [bundle_index]
            )
            for i in candidates:
                b = self.bundles[i]
                if all(
                    b.avail_fp.get(c, 0) >= q for c, q in req.demands.items()
                ):
                    return b.node_id, i
            return None

    def try_allocate(self, bundle_index: int, req: ResourceRequest) -> bool:
        with self._lock:
            b = self.bundles[bundle_index]
            if b.avail_fp is None or any(
                b.avail_fp.get(c, 0) < q for c, q in req.demands.items()
            ):
                return False
            for c, q in req.demands.items():
                b.avail_fp[c] -= q
            return True

    def release(self, bundle_index: int, req: ResourceRequest) -> None:
        with self._lock:
            b = self.bundles[bundle_index]
            if b.avail_fp is None:
                return
            for c, q in req.demands.items():
                b.avail_fp[c] = b.avail_fp.get(c, 0) + q

    def remove(self) -> None:
        with self._lock:
            if self.removed:
                return
            self.removed = True
            if self.ready_event.is_set():
                for b in self.bundles:
                    node = self.runtime.nodes.get(b.node_id)
                    if node is not None and node.alive:
                        node.ledger.release(b.request)
                        self.runtime.view.update_available(
                            b.node_id, node.ledger.avail_map()
                        )


class PlacementGroup:
    """User-facing handle (reference: python/ray/util/placement_group.py)."""

    def __init__(self, state: PlacementGroupState):
        self._state = state

    @property
    def id(self) -> str:
        return self._state.id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self._state.bundle_specs

    def ready(self) -> ObjectRef:
        return self._state.ready_ref

    def wait(self, timeout_seconds: float = 30) -> bool:
        return self._state.ready_event.wait(timeout_seconds)

    def __repr__(self) -> str:
        return f"PlacementGroup({self.id[:8]}, {self._state.strategy})"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    avoid_nodes: Optional[List[str]] = None,
):
    """``avoid_nodes`` is a SOFT anti-affinity list (gang-aware reshape
    placement): the bundle kernels first run with those nodes masked out
    and fall back to the full cluster when the masked placement is
    infeasible — an elastic gang avoiding a flapping node must never
    park behind the preference."""
    from .runtime import get_runtime

    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        from ..cluster.client import RemotePlacementGroup

        pg_id = rt.create_placement_group(
            list(bundles), strategy, avoid_nodes=avoid_nodes
        )
        return RemotePlacementGroup(pg_id, list(bundles), strategy)
    state = PlacementGroupState(
        rt, bundles, strategy, name=name, avoid_nodes=avoid_nodes
    )
    rt.register_pg(state)
    return PlacementGroup(state)


def remove_placement_group(pg) -> None:
    from .runtime import get_runtime

    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        rt.remove_placement_group(pg.id)
        return
    pg._state.remove()
    rt._pgs.pop(pg.id, None)
    rt.notify_resources_changed()


def placement_group_table() -> Dict[str, dict]:
    from .runtime import get_runtime

    rt = get_runtime()
    out = {}
    for pg_id, st in rt._pgs.items():
        out[pg_id] = {
            "placement_group_id": pg_id,
            "name": st.name,
            "strategy": st.strategy,
            "state": "REMOVED"
            if st.removed
            else ("CREATED" if st.ready_event.is_set() else "PENDING"),
            "bundles": {
                i: {"node_id": b.node_id, "resources": st.bundle_specs[i]}
                for i, b in enumerate(st.bundles)
            },
        }
    return out
