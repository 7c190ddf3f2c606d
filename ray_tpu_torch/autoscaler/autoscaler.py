"""Autoscaler: pending demand → node launches/terminations.

V2-shaped (declarative reconcile, Ray's python/ray/autoscaler/v2/
scheduler.py:782,1016-1060) with the scoring/packing math running through the
batched programs in ray_tpu_torch.scheduler.binpack:

  tick():
    1. read pending demand from the runtime (queued + infeasible leases and
       unplaced PG bundles — GcsAutoscalerStateManager's ClusterResourceState)
    2. enforce min_workers per type
    3. residual = bin_pack_residual(current availability, demands)
    4. while residual nonempty and below max: pick node type via the
       utilization scorer (get_nodes_for semantics), add hypothetical node,
       recompute residual
    5. launch via the NodeProvider; terminate nodes idle past idle_timeout

The SimNodeProvider adds/removes nodes of the in-process runtime — the
fake_multi_node provider analog (autoscaler/_private/fake_multi_node/).

Port of ``ray_tpu/autoscaler/autoscaler.py``, copied with its imports
rewritten. The packing and scoring programs run on the runtime's scheduler
device (``Runtime.sched_device``); a runtime without one (the cluster
client) packs on ``cfg.sched_platform``: ``cuda`` unless
``RAY_TPU_SCHED_PLATFORM=cpu``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.scheduler.binpack import (
    DeltaBinPacker,
    bin_pack_residual,
    pick_best_node_type,
    sort_demands,
    utilization_scores,
)

NODE_TYPE_LABEL = "ray_tpu.io/node-type"


@dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class ScalingDecision:
    launch: Dict[str, int] = field(default_factory=dict)  # type -> count
    terminate: List[str] = field(default_factory=list)  # node ids


class SimNodeProvider:
    """Cloud provider stand-in: nodes materialize in the runtime."""

    def __init__(self, runtime):
        self.runtime = runtime

    def create_node(self, node_type: NodeTypeConfig) -> str:
        return self.runtime.add_node(
            dict(node_type.resources), labels={NODE_TYPE_LABEL: node_type.name}
        )

    def terminate_node(self, node_id: str) -> None:
        self.runtime.kill_node(node_id)

    def non_terminated_nodes(self) -> List[dict]:
        return [n for n in self.runtime.nodes_info() if n["Alive"]]


class Autoscaler:
    def __init__(
        self,
        runtime,
        node_types: List[NodeTypeConfig],
        *,
        provider: Optional[SimNodeProvider] = None,
        idle_timeout_s: float = 60.0,
        tick_interval_s: float = 1.0,
    ):
        self.runtime = runtime
        self.node_types = {t.name: t for t in node_types}
        self.provider = provider or SimNodeProvider(runtime)
        # cluster-mode runtimes have no resource vocab of their own
        if getattr(runtime, "vocab", None) is not None:
            self.vocab = runtime.vocab
        else:
            from ray_tpu_torch.scheduler import ResourceVocab

            self.vocab = ResourceVocab()
        self.idle_timeout_s = idle_timeout_s
        self.tick_interval_s = tick_interval_s
        self._idle_since: Dict[str, float] = {}
        self.device = getattr(runtime, "sched_device", None)
        if self.device is None:
            from ray_tpu_torch.config import cfg
            from ray_tpu_torch.core.runtime import _scheduler_device

            self.device = _scheduler_device(cfg.sched_platform)
        # device-resident residual packer: node rows stay on the scheduler
        # device across ticks; only changed rows are pushed per reconcile
        self._packer = DeltaBinPacker(device=self.device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- control loop ---------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="ray_tpu-autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - keep reconciling
                pass

    # -- one reconcile pass --------------------------------------------
    def tick(self) -> ScalingDecision:
        from ray_tpu_torch.config import cfg

        if cfg.elastic_controller:
            # unified elasticity plane: the head controller's
            # single solve owns provision/retire — a second loop sizing
            # the same fleet would race it (the exact thrash the
            # controller exists to end). No-op decision; flipping
            # RAY_TPU_ELASTIC_CONTROLLER=0 restores this loop untouched.
            return ScalingDecision()
        # v2 reconciler: retry lost launches, promote REQUESTED->RUNNING
        if hasattr(self.provider, "reconcile"):
            self.provider.reconcile()
        decision = self.plan()
        for type_name, count in decision.launch.items():
            for _ in range(count):
                self.provider.create_node(self.node_types[type_name])
        for node_id in decision.terminate:
            self.provider.terminate_node(node_id)
        return decision

    def plan(self) -> ScalingDecision:
        decision = ScalingDecision()
        nodes = self.provider.non_terminated_nodes()
        counts: Dict[str, int] = {t: 0 for t in self.node_types}
        for n in nodes:
            t = n["Labels"].get(NODE_TYPE_LABEL)
            if t in counts:
                counts[t] += 1
        # launches still in flight (REQUESTED at the instance manager)
        # count as existing capacity — otherwise every tick re-launches
        # the same demand until the first agents finish registering
        pending_launches: Dict[str, int] = {}
        if hasattr(self.provider, "pending_launches"):
            pending_launches = self.provider.pending_launches()
            for t, c in pending_launches.items():
                if t in counts:
                    counts[t] += c

        # 1. min_workers fill (_add_min_workers_nodes)
        for t in self.node_types.values():
            if counts[t.name] < t.min_workers:
                decision.launch[t.name] = t.min_workers - counts[t.name]
                counts[t.name] = t.min_workers

        # 2. demand-driven launches
        demands = self.runtime.pending_resource_demands()
        if demands:
            width = self.vocab.capacity
            dmat = np.stack(
                [self.vocab.pack(d).astype(np.float32) for d in demands]
            )[:, :width]
            dmat = dmat[sort_demands(dmat)]
            avail_keys = [n["NodeID"] for n in nodes]
            avail_rows = [
                self.vocab.pack(n["Available"])[:width] for n in nodes
            ]
            # nodes already queued for launch (min_workers fill) AND
            # launches in flight count as capacity — otherwise demand
            # double-provisions on cold start
            hypothetical = dict(decision.launch)
            for t, c in pending_launches.items():
                hypothetical[t] = hypothetical.get(t, 0) + c
            for type_name, count in hypothetical.items():
                if type_name not in self.node_types:
                    continue
                row = self.vocab.pack(
                    self.node_types[type_name].resources
                )[:width]
                avail_rows.extend([row] * count)
                avail_keys.extend(
                    f"hypothetical:{type_name}:{i}" for i in range(count)
                )
            if avail_rows:
                # delta-synced: node rows live on the scheduler device
                # across ticks, changed rows scatter-push; big demand
                # batches route through the projected-gradient solve,
                # small ones through the exact first-fit scan (binpack.py)
                packed = self._packer.pack_or_solve(
                    avail_keys, avail_rows, dmat
                )
                unfulfilled = dmat[packed < 0]
            else:
                # zero nodes (cold cluster): everything is unfulfilled —
                # the packing kernel needs at least one bin
                unfulfilled = dmat
            type_rows = {
                t.name: self.vocab.pack(t.resources)[:width]
                for t in self.node_types.values()
            }
            names = list(type_rows)
            guard = 0
            while len(unfulfilled) and guard < 64:
                guard += 1
                allowed = [
                    n
                    for n in names
                    if counts[n] + decision.launch.get(n, 0)
                    < self.node_types[n].max_workers
                ]
                if not allowed:
                    break
                types_mat = np.stack([type_rows[n] for n in allowed])
                scores = utilization_scores(
                    types_mat, unfulfilled, device=self.device
                )
                best = pick_best_node_type(scores)
                if best < 0:
                    break
                chosen = allowed[best]
                decision.launch[chosen] = decision.launch.get(chosen, 0) + 1
                res = bin_pack_residual(
                    type_rows[chosen][None, :], unfulfilled,
                    device=self.device,
                )
                unfulfilled = unfulfilled[res.node.cpu().numpy() < 0]

        # 3. idle termination (keep min_workers)
        now = time.monotonic()
        local_nodes = getattr(self.runtime, "nodes", None)
        for n in nodes:
            nid = n["NodeID"]
            # Available==Resources alone is NOT idle: zero-resource actors
            # and tasks hold nothing — consult the Busy flag (cluster mode)
            # or running tasks + hosted alive actors (in-process mode)
            idle = n["Available"] == n["Resources"] and not n.get("Busy")
            if idle and local_nodes is not None and nid in local_nodes:
                idle = not local_nodes[nid].running_tasks
                if idle:
                    actors = getattr(self.runtime, "_actors", {})
                    idle = not any(
                        st.alive and st.node_id == nid
                        for st in actors.values()
                    )
            if idle:
                self._idle_since.setdefault(nid, now)
                t = n["Labels"].get(NODE_TYPE_LABEL)
                min_w = self.node_types[t].min_workers if t in self.node_types else 0
                if (
                    now - self._idle_since[nid] > self.idle_timeout_s
                    and t in counts
                    and counts[t] > min_w
                ):
                    decision.terminate.append(nid)
                    counts[t] -= 1
            else:
                self._idle_since.pop(nid, None)
        return decision
