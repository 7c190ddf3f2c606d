"""The local runtime: nodes, leases, batched scheduling, lineage.

Port of ``ray_tpu/core/runtime.py``, with its imports rewritten. Every
placement round runs ``DeviceSchedulerState`` (``scheduler/device.py``) on the
scheduler device, ``cuda`` unless ``RAY_TPU_SCHED_PLATFORM=cpu``; the state
comes up in ``Runtime()`` or the constructor raises (the reference defers it
and degrades to the golden model). ``hybrid_schedule_reference`` runs only
when the caller asks for it (``use_device_scheduler=False`` or
``RAY_TPU_DEVICE_SCHEDULER=0``). Rounds that fail are logged on the
``ray_tpu_torch`` logger as "scheduler round failed" and requeued, as in the
reference. A cluster head address raises: the cluster runtime is not ported.


Single-process, multi-node-simulated runtime — the analog of the reference's
raylet + GCS + core-worker stack (/root/reference/src/ray/raylet/,
src/ray/gcs/, src/ray/core_worker/), with the crucial difference that *all*
placement decisions flow through the batched scheduler programs in
``scheduler/`` instead of per-request C++ scans:

- Every task/actor-creation submission becomes a *lease request* queued with
  the scheduler thread (ClusterLeaseManager::QueueAndScheduleLease analog,
  cluster_lease_manager.cc:47).
- The scheduler thread drains the queue and places the whole batch with one
  ``hybrid_schedule_batch`` call (ScheduleAndGrantLeases hot loop,
  cluster_lease_manager.cc:196 — but batched).
- Grants are admitted against each node's exact fixed-point ledger
  (grant-or-reject under a possibly-stale dense view, the reference's
  LocalResourceManager contract); rejected grants are requeued (spillback).
- Node death drops that node's objects; lost objects are rebuilt by lineage
  re-execution (ObjectRecoveryManager / TaskManager::ResubmitTask analog,
  core_worker/task_manager.h:229).

This process-level harness is also the test vehicle for multi-node scheduling
logic, mirroring how the reference tests multi-node behavior in a single
process (python/ray/cluster_utils.py:137).
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..scheduler import (
    ClusterView,
    HybridConfig,
    NodeResourceLedger,
    ResourceRequest,
    ResourceVocab,
    hybrid_schedule_reference,
)
from .object_store import GetTimeoutError, ObjectRef, ObjectStore, TaskError

logger = logging.getLogger("ray_tpu_torch")

# Leases per scheduling round (the batching that makes a device round pay).
MAX_SCHEDULE_BATCH = 1024

_STREAM_END = object()  # generator-exhausted sentinel (values can be None)


def _now() -> float:
    import time

    return time.monotonic()


class ActorDiedError(Exception):
    pass


class NodeDiedError(Exception):
    pass


@dataclass
class TaskSpec:
    """A task/actor-creation/actor-method invocation (LeaseSpecification +
    TaskSpecification analog, src/ray/common/lease/)."""

    task_id: str
    func: Callable
    args: tuple
    kwargs: dict
    returns: List[ObjectRef]  # transient: emptied by submit() so queued
    # specs pin their *args* (live ObjectRef instances) but never their own
    # outputs — lineage release is what frees args when outputs die
    resources: Dict[str, float]
    name: str = ""
    kind: str = "task"  # task | actor_creation | actor_method
    actor_id: Optional[str] = None
    strategy: Any = None  # scheduling strategy object or None
    max_retries: int = 3
    retry_exceptions: bool = False
    attempt: int = 0
    # per-task runtime env override (merged over the job-level env by the
    # submitting client); {"pip": ...} entries route to env-bound workers
    runtime_env: Optional[dict] = None
    # distributed trace context {trace_id, span_id, parent_id} — minted at
    # submission, inherited by nested submissions (util/tracing.py)
    trace: Optional[dict] = None
    # return object ids; a slot is None once that output has been freed
    return_ids: List[Optional[str]] = field(default_factory=list)
    # num_returns="streaming": executor iterates the function's generator,
    # sealing each yield under stream_item_id(task_id, i); the caller
    # consumes an ObjectRefGenerator
    streaming: bool = False


@dataclass
class Node:
    """A simulated cluster node: ledger + worker pool (raylet + workers)."""

    node_id: str
    ledger: NodeResourceLedger
    pool: ThreadPoolExecutor
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    running_tasks: Dict[str, TaskSpec] = field(default_factory=dict)
    objects: set = field(default_factory=set)  # hex ids sealed on this node
    accel: Any = None  # NodeAcceleratorState: chip-index assignment


class _GcConsumer:
    """Tracker-consumer token for the in-process runtime's GC thread."""

    def __init__(self, stop_event: threading.Event):
        self._stop_event = stop_event

    def stop(self) -> None:
        self._stop_event.set()


class WorkerContext(threading.local):
    node_id: Optional[str] = None
    task_id: Optional[str] = None
    actor_id: Optional[str] = None
    accelerator_ids: Dict[str, list] = {}


_context = WorkerContext()


def get_context() -> WorkerContext:
    return _context


class Runtime:
    """Cluster-in-a-process. One instance per init()."""

    def __init__(
        self,
        num_nodes: int = 1,
        resources_per_node: Optional[Dict[str, float]] = None,
        use_device_scheduler: Optional[bool] = None,
        hybrid_config: HybridConfig = HybridConfig(),
    ):
        from ..config import cfg
        from ..scheduler.device import bring_up_device_state, device_scheduler_default

        if use_device_scheduler is None:
            use_device_scheduler = device_scheduler_default()
        self.use_device_scheduler = use_device_scheduler
        # the scheduler device comes up here, before any thread or arena
        # exists, or the runtime fails (no degrade to the golden model)
        # The DeviceSchedulerState; None only when the golden model was
        # asked for.
        self.device_state = bring_up_device_state() if use_device_scheduler else None
        self.sched_device = (
            self.device_state.device
            if self.device_state is not None
            else _scheduler_device(cfg.sched_platform)
        )
        self.vocab = ResourceVocab()
        self.view = ClusterView(self.vocab)
        native = None
        if cfg.native_store:
            try:
                from ..native import NativeObjectStore

                native = NativeObjectStore(
                    capacity=int(
                        cfg.store_bytes
                    )
                )
            except Exception:  # noqa: BLE001 - toolchain missing → in-proc only
                logger.warning("native object store unavailable; using in-process")
        self.native_store = native
        self.store = ObjectStore(native)
        self.nodes: Dict[str, Node] = {}
        self.hybrid_config = hybrid_config
        self._parked_at_change = -1
        self._last_park_retry = 0.0
        self._rng = np.random.default_rng(0)
        # streaming-generator state: task_id -> {"items": [hex...],
        # "done": bool} (num_returns="streaming" tasks; cluster analog
        # lives on the head)
        self._streams: Dict[str, dict] = {}
        # tombstones for abandoned streams: popping the live state must
        # not let a lineage re-execution of the same task resurrect a
        # fresh un-abandoned stream and drive the generator with no
        # consumer (one small string per abandoned stream)
        self._abandoned_streams: set = set()
        self._stream_cv = threading.Condition()
        self._spread_rr = 0  # SPREAD round-robin cursor
        self._label_rr = 0  # label-selector tie-break cursor
        self._seed_counter = itertools.count(1)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[TaskSpec] = []
        self._infeasible: List[TaskSpec] = []
        self._dep_waiting: List[TaskSpec] = []  # args not sealed yet
        self._lineage: Dict[str, TaskSpec] = {}  # object hex -> creating spec
        self._actors: Dict[str, "ActorState"] = {}
        self._named_actors: Dict[str, str] = {}
        self._pgs: Dict[str, Any] = {}  # pg_id -> PlacementGroupState
        self._pending_pgs: List[Any] = []  # PG states awaiting placement
        self._dirty = False
        self._shutdown = False
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="ray_tpu_torch-scheduler", daemon=True
        )
        # automatic object GC (ReferenceCounter analog): drains instance-count
        # zeros from the process tracker and frees store entries + lineage
        from .refcount import FreedLRU, install_consumer

        self._freed = FreedLRU()
        self._gc_stop = threading.Event()
        self._gc_thread = threading.Thread(
            target=self._gc_loop, name="ray_tpu_torch-gc", daemon=True
        )
        install_consumer(_GcConsumer(self._gc_stop))
        self.metrics: Dict[str, int] = {
            "tasks_submitted": 0,
            "tasks_finished": 0,
            "tasks_failed": 0,
            "leases_spilled_back": 0,
            "sched_rounds": 0,
        }
        from .events import TaskEventBuffer

        self.events = TaskEventBuffer()
        if resources_per_node is None:
            resources_per_node = {"CPU": 8, "memory": float(4 << 30)}
        for i in range(num_nodes):
            self.add_node(resources_per_node)
        self._sched_thread.start()
        self._gc_thread.start()

    # ------------------------------------------------------------------
    # automatic object GC (reference_counter.h:44 analog)
    # ------------------------------------------------------------------
    def _gc_loop(self) -> None:
        from .refcount import TRACKER

        while not self._gc_stop.is_set():
            TRACKER.zero_event.wait(timeout=1.0)
            if self._gc_stop.is_set():
                return
            for hex_id in TRACKER.drain_zeros():
                try:
                    self._free_local(hex_id)
                except Exception:  # noqa: BLE001 - GC must survive
                    logger.exception("object GC failed for %s", hex_id)

    def _free_local(self, hex_id: str) -> None:
        """No live handle remains for this object: drop the sealed value
        (or flag an unsealed entry to be dropped at seal) and release its
        lineage — which releases the creating task's argument refs, so
        frees cascade exactly like the reference's lineage release
        (reference_counter.h ReleaseLineageReferences)."""
        removed = self.store.free_id(hex_id)
        spec = self._lineage.pop(hex_id, None)
        if spec is not None and removed:
            # tombstone the slot: a lineage re-execution of a sibling output
            # must not resurrect this one
            for i, rid in enumerate(spec.return_ids):
                if rid == hex_id:
                    spec.return_ids[i] = None
        if removed:
            self._freed.add(hex_id)
            for node in self.nodes.values():
                node.objects.discard(hex_id)

    def _seal_id(self, node: Optional[Node], hex_id: Optional[str], value, is_error=False) -> None:
        """Seal one output by id, honoring freed tombstones and
        dropped-before-sealed outputs."""
        if hex_id is None or hex_id in self._freed:
            return
        if node is not None:
            node.objects.add(hex_id)
        if self.store.seal_id(hex_id, value, is_error):
            self._free_local(hex_id)

    # ------------------------------------------------------------------
    # membership (GcsNodeManager analog)
    # ------------------------------------------------------------------
    def add_node(
        self,
        resources: Dict[str, float],
        labels: Optional[Dict[str, str]] = None,
    ) -> str:
        from ..scheduler.instances import NodeAcceleratorState

        node_id = uuid.uuid4().hex[:16]
        num_workers = max(1, int(resources.get("CPU", 1)))
        node = Node(
            node_id=node_id,
            ledger=NodeResourceLedger(self.vocab, resources),
            pool=ThreadPoolExecutor(
                max_workers=num_workers, thread_name_prefix=f"worker-{node_id[:6]}"
            ),
            labels=dict(labels or {}),
            accel=NodeAcceleratorState(resources),
        )
        with self._cond:
            self.nodes[node_id] = node
            self.view.add_node(node_id, resources, labels)
            # new capacity may unblock infeasible leases and pending PGs
            self._dirty = True
            self._pending.extend(self._infeasible)
            self._infeasible.clear()
            self._cond.notify_all()
        return node_id

    def kill_node(self, node_id: str) -> None:
        """Simulated node failure (test chaos hook, like RayletKiller,
        /root/reference/python/ray/_private/test_utils.py:1408)."""
        with self._cond:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            self.view.remove_node(node_id)
            lost_objects = list(node.objects)
            node.objects.clear()
            running = list(node.running_tasks.values())
            node.running_tasks.clear()
            # Actors on this node die.
            for actor in list(self._actors.values()):
                if actor.node_id == node_id and actor.alive:
                    actor.mark_died(restart=True)
            self._cond.notify_all()
        node.pool.shutdown(wait=False, cancel_futures=True)
        # Drop the node's objects; lineage rebuilds them on demand.
        for hex_id in lost_objects:
            self._invalidate_object(hex_id)
        # Resubmit tasks that were running there.
        for spec in running:
            if spec.attempt < spec.max_retries:
                spec.attempt += 1
                self.metrics["leases_spilled_back"] += 1
                self._enqueue(spec)
            else:
                err = NodeDiedError(f"node {node_id} died running {spec.name}")
                for rid in spec.return_ids:
                    self._seal_id(None, rid, err, is_error=True)

    def _invalidate_object(self, hex_id: str) -> None:
        if hex_id in self._freed:
            return  # nobody holds it anymore; no point reconstructing
        spec = self._lineage.get(hex_id)
        if spec is not None and (
            spec.kind != "task" or spec.attempt >= spec.max_retries
        ):
            # Lineage exhausted (or not a re-executable plain task): the
            # object is permanently lost — fail pending gets.
            if hex_id in spec.return_ids and self.store.contains(
                ObjectRef.weak(hex_id)
            ):
                return  # already sealed elsewhere (e.g. resubmitted copy won)
            from .object_store import ObjectLostError

            self._seal_id(
                None,
                hex_id,
                ObjectLostError(
                    f"object {hex_id} lost with its node; lineage retries "
                    f"exhausted ({spec.attempt}/{spec.max_retries})"
                ),
                is_error=True,
            )
            return
        with self.store._lock:
            entry = self.store._objects.get(hex_id)
            if entry is not None and entry.event.is_set():
                entry.event.clear()
                entry.value = None
        if spec is not None:
            clone = TaskSpec(
                task_id=uuid.uuid4().hex[:16],
                func=spec.func,
                args=spec.args,
                kwargs=spec.kwargs,
                returns=[],
                return_ids=list(spec.return_ids),
                resources=spec.resources,
                name=spec.name,
                kind=spec.kind,
                actor_id=spec.actor_id,
                strategy=spec.strategy,
                max_retries=spec.max_retries,
                retry_exceptions=spec.retry_exceptions,
                attempt=spec.attempt + 1,
            )
            for rid in clone.return_ids:
                if rid is not None:
                    self._lineage[rid] = clone  # retry budget advances
            self._enqueue(clone)

    # ------------------------------------------------------------------
    # submission (NormalTaskSubmitter analog)
    # ------------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        from ..cluster.pip_env import has_env

        if has_env(spec.runtime_env):
            raise NotImplementedError(
                "pip/uv/conda runtime environments need per-env worker processes — "
                "need the cluster runtime, which is not ported yet; the "
                "in-process runtime shares one interpreter"
            )
        refs = spec.returns
        spec.return_ids = [r.hex for r in refs]
        # the queued/lineage spec keeps only ids: the user's handles are the
        # sole owners of the outputs (dropping them all → automatic GC)
        spec.returns = []
        for ref in refs:
            self.store.create(ref, creating_task=spec.task_id)
            self._lineage[ref.hex] = spec
        self.metrics["tasks_submitted"] += 1
        if spec.streaming:
            self.register_stream(spec.task_id)
        from ..util import tracing

        if spec.trace is None:
            spec.trace = tracing.child_context(spec.task_id)
        self.events.record(
            spec.task_id, spec.name, "SUBMITTED",
            **tracing.event_args(spec.trace)
        )
        self._enqueue(spec)
        return refs

    def _enqueue(self, spec: TaskSpec) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._pending.append(spec)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # the batched scheduler (ScheduleAndGrantLeases analog)
    # ------------------------------------------------------------------
    def _unready_args(self, spec: TaskSpec) -> List[ObjectRef]:
        """Top-level ObjectRef args not yet sealed (the set the reference's
        LeaseDependencyManager waits on before making a lease dispatchable,
        lease_dependency_manager.h:41)."""
        refs = [a for a in spec.args if isinstance(a, ObjectRef)]
        refs += [v for v in spec.kwargs.values() if isinstance(v, ObjectRef)]
        return [r for r in refs if not self.store.contains(r)]

    def _admit_dep_ready(self) -> List[TaskSpec]:
        ready = []
        still = []
        for spec in self._dep_waiting:
            (ready if not self._unready_args(spec) else still).append(spec)
        self._dep_waiting = still
        return ready

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._pending and not self._dirty and not self._shutdown
                ):
                    self._cond.wait(timeout=0.5)
                    # Lost-wakeup backstop: a spec parked *after* the release
                    # event that would have drained it would otherwise sleep
                    # until the next cluster change. Retry parked work only
                    # when the view actually moved since the last drain, so
                    # truly-infeasible specs don't spin the kernel at 2 Hz.
                    self._maybe_unpark_locked()
                    if self._dep_waiting:
                        self._pending.extend(self._admit_dep_ready())
                if self._shutdown:
                    return
                # parked work also retries while NEW submissions keep the
                # queue hot (a steady submit stream would otherwise starve
                # every parked spec — same discipline as the cluster head)
                self._maybe_unpark_locked()
                self._dirty = False
                take = min(len(self._pending), MAX_SCHEDULE_BATCH)
                batch = self._admit_dep_ready() + self._pending[:take]
                del self._pending[:take]
                # dependency-aware dispatch: leases with unsealed args wait
                # here holding NOTHING (no resources, no worker thread) —
                # ready leases interleave past them
                waiting = [s for s in batch if self._unready_args(s)]
                if waiting:
                    w = {id(s) for s in waiting}
                    batch = [s for s in batch if id(s) not in w]
                    self._dep_waiting.extend(waiting)
            try:
                self._try_schedule_pgs()
                if batch:
                    self._schedule_batch(batch)
            except Exception:  # pragma: no cover - scheduler must survive
                logger.exception("scheduler round failed; requeueing batch")
                with self._cond:
                    self._pending.extend(batch)

    def register_pg(self, state) -> None:
        """Queue a placement group for scheduling (SchedulePendingPlacementGroups
        analog, gcs_placement_group_manager.cc:300)."""
        with self._cond:
            self._pgs[state.id] = state
            self._pending_pgs.append(state)
            self._dirty = True
            self._cond.notify_all()

    def notify_resources_changed(self) -> None:
        # completions only NOTIFY; the scheduler loop's capacity-capped
        # unpark retries parked work. Draining the whole parked queue here
        # (pre-r5) re-scheduled every parked spec on every completion —
        # O(parked²) churn under a deep backlog (see cluster/head.py).
        with self._cond:
            # some callers free capacity the ClusterView can't see (PG
            # bundle releases mutate bundle-local books only): bump the
            # change counter HERE so the change-gated unpark always fires
            # for an explicit resource-changed notification
            self.view.change_counter += 1
            self._dirty = True
            self._cond.notify_all()

    def _maybe_unpark_locked(self) -> None:
        """Rate-limited, change-gated unpark. Caller holds self._cond."""
        if self._infeasible and (
            (
                self.view.change_counter != self._parked_at_change
                and _now() - self._last_park_retry > 0.02
            )
            # liveness fallback: capacity can free without a view change
            # (PG bundle books are bundle-local) — retry parked work at
            # 1 Hz regardless, bounded by the per-shape cap
            or _now() - self._last_park_retry > 1.0
        ):
            self._parked_at_change = self.view.change_counter
            self._last_park_retry = _now()
            try:
                self._unpark_grantable()
            except Exception:  # noqa: BLE001 - reported as a failed round
                # as a failing round is: logged, and the scheduler thread
                # lives; the parked work stays parked
                logger.exception("scheduler round failed in unpark; work stays parked")

    def _unpark_grantable(self) -> None:
        """Move parked specs back to pending, capped per resource shape
        at what the view could grant (scheduler/unpark.py, shared with
        the cluster head). Caller holds self._cond."""
        from ..scheduler.unpark import UNPARK_SLACK, select_unparkable

        parked = self._infeasible
        if not parked:
            return
        if len(parked) <= UNPARK_SLACK:
            self._pending.extend(parked)
            self._infeasible = []
            return
        from ..config import cfg as _cfg

        device_state = self.device_state
        slots_fn = None
        _, avail, alive = self.view.active_arrays()
        if device_state is not None and _cfg.sched_unpark_device:
            # slot estimation on the resident device arrays: one batched
            # program for every shape. A failure raises to the scheduler
            # loop, and the parked work stays parked: no host scan stands
            # in for the card.
            device_state.sync(self.view)
            slots_fn = device_state.shape_slots
        else:
            avail, alive = avail.copy(), alive.copy()
        take, keep = select_unparkable(
            parked,
            avail,
            alive,
            slots_fn=slots_fn,
            # "DEFAULT" routes through the hybrid kernels like None —
            # only real placement constraints skip the capacity math
            is_constrained=lambda s: s.strategy is not None
            and s.strategy != "DEFAULT",
            resources_of=lambda s: s.resources,
            request_of=lambda s: ResourceRequest.from_map(
                self.vocab, s.resources
            ),
        )
        self._pending.extend(take)
        self._infeasible = keep

    def _try_schedule_pgs(self) -> None:
        with self._cond:
            pending = list(self._pending_pgs)
        for state in pending:
            if state.removed:
                with self._cond:
                    if state in self._pending_pgs:
                        self._pending_pgs.remove(state)
                continue
            if state.try_schedule():
                with self._cond:
                    if state in self._pending_pgs:
                        self._pending_pgs.remove(state)
                    # PG-waiting leases were parked as infeasible; retry them.
                    self._pending.extend(self._infeasible)
                    self._infeasible.clear()
                    self._cond.notify_all()

    def _schedule_batch(self, batch: List[TaskSpec]) -> None:
        self.metrics["sched_rounds"] += 1
        # Split out strategy-constrained leases; they bypass the hybrid kernel
        # (the reference dispatches them to other policies —
        # composite_scheduling_policy.cc).
        hybrid_batch: List[TaskSpec] = []
        for spec in batch:
            target = self._strategy_target(spec)
            if target is _HYBRID:
                hybrid_batch.append(spec)
            elif target is _FAIL:
                self.metrics["tasks_failed"] += 1
                err = TaskError(
                    NodeDiedError(
                        f"task {spec.name}: hard scheduling constraint can "
                        "never be satisfied (target node is dead/unknown)"
                    ),
                    spec.name,
                )
                for rid in spec.return_ids:
                    self._seal_id(None, rid, err, is_error=True)
            elif target is None:
                self._park_infeasible(spec)
            else:
                node_id, via_pg = target
                self._grant_or_requeue(spec, node_id, via_pg=via_pg)
        if not hybrid_batch:
            return

        totals = avail = alive = None
        device_state = self.device_state
        with self._lock:
            n = self.view.num_nodes
            r = self.view.totals.shape[1]
            if device_state is not None and n > 0:
                device_state.sync(self.view)
            else:
                totals, avail, alive = self.view.active_arrays()
        if n == 0:
            for spec in hybrid_batch:
                self._park_infeasible(spec)
            return
        sched: List[TaskSpec] = []
        dense_rows: List[np.ndarray] = []
        for spec in hybrid_batch:
            req = ResourceRequest.from_map(self.vocab, spec.resources)
            if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                # demands a resource no node carries — unplaceable for now
                self._park_infeasible(spec)
            else:
                sched.append(spec)
                dense_rows.append(req.dense(r))
        if not sched:
            return
        demands = np.stack(dense_rows)
        if device_state is not None:
            nodes_idx = device_state.schedule(
                demands, spread_threshold=self.hybrid_config.spread_threshold
            )
            granted = nodes_idx >= 0
        else:
            prefer = np.zeros(len(sched), dtype=np.int32)
            force_spill = np.zeros(len(sched), dtype=bool)
            nodes_idx, granted, _ = hybrid_schedule_reference(
                totals,
                avail,
                alive,
                demands,
                prefer,
                force_spill,
                config=self.hybrid_config,
                rng=self._rng,
            )
        for spec, row, ok in zip(sched, nodes_idx, granted):
            if row < 0 or not ok:
                # Infeasible anywhere, or feasible but no node has the
                # resources free right now: park until a release/new node
                # notifies (the reference queues at the target raylet,
                # local_lease_manager.h:39). The ledger's grant-or-reject in
                # _grant_or_requeue corrects any stale-view optimism.
                self._park_infeasible(spec)
            else:
                self._grant_or_requeue(spec, self.view.node_id(int(row)))

    _SENTINEL = object()

    def _pick_spread_node(
        self, spec: TaskSpec, random: bool = False
    ) -> Optional[str]:
        """Distinct SPREAD (round-robin) / RANDOM (uniform) over feasible
        alive nodes (spread_scheduling_policy.cc:26 /
        random_scheduling_policy.cc analogs)."""
        req = ResourceRequest.from_map(self.vocab, spec.resources)
        with self._lock:
            avail, alive = self.view.active_arrays()[1:]
            n = self.view.num_nodes
            r = avail.shape[1] if n else 0
            if n == 0 or any(
                c >= r and fp > 0 for c, fp in req.demands.items()
            ):
                return None  # no nodes / unknown resource: park infeasible
            d = req.dense(r)
            feasible = (avail >= d).all(axis=1) & alive
            if random:
                cand = np.flatnonzero(feasible)
                if cand.size == 0:
                    return None
                return self.view.node_id(int(self._rng.choice(cand)))
            order = np.roll(np.arange(n), -self._spread_rr)
            cand = order[feasible[order]]
            if cand.size == 0:
                return None
            row = int(cand[0])
            self._spread_rr = (row + 1) % n
            return self.view.node_id(row)

    def _pick_labeled_node(self, strat, resources) -> Optional[str]:
        """Label-selector placement (node_label_scheduling_policy.cc
        analog): hard selectors + resource feasibility filter, soft
        selectors prefer, ties round-robin."""
        from ..scheduler.labels import match_labels

        req = ResourceRequest.from_map(self.vocab, resources)
        with self._lock:
            hard = [
                n.node_id
                for n in self.nodes.values()
                if n.alive
                and match_labels(n.labels, strat.hard)
                and n.ledger.is_available(req)
            ]
            preferred = [
                nid
                for nid in hard
                if match_labels(self.nodes[nid].labels, strat.soft)
            ]
        pool = preferred or hard
        if not pool:
            return None
        self._label_rr += 1
        return pool[self._label_rr % len(pool)]

    def _strategy_target(self, spec: TaskSpec):
        """Resolve scheduling strategies. Returns _HYBRID, None (infeasible
        now), or (node_id, via_pg) to dispatch directly."""
        from .scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
            NodeLabelSchedulingStrategy,
            PlacementGroupSchedulingStrategy,
        )

        strat = spec.strategy
        if strat is None or strat == "DEFAULT":
            return _HYBRID
        if strat in ("SPREAD", "RANDOM"):
            target = self._pick_spread_node(spec, random=strat == "RANDOM")
            return None if target is None else (target, None)
        if isinstance(strat, NodeLabelSchedulingStrategy):
            target = self._pick_labeled_node(strat, spec.resources)
            if target is None:
                return None if strat.hard else _HYBRID
            return (target, None)
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            node = self.nodes.get(strat.node_id)
            if node is not None and node.alive:
                return (strat.node_id, None)
            # Hard affinity to a dead/unknown node can never succeed — fail
            # fast (the reference raises an unschedulable error).
            return _HYBRID if strat.soft else _FAIL
        if isinstance(strat, PlacementGroupSchedulingStrategy):
            pg = self._pgs.get(strat.placement_group.id)
            if pg is None or not pg.ready_event.is_set():
                return None  # wait for PG (requeued when PG commits)
            picked = pg.pick_bundle(
                strat.placement_group_bundle_index,
                ResourceRequest.from_map(self.vocab, spec.resources),
            )
            if picked is None:
                return None
            node_id, bundle_idx = picked
            return (node_id, (pg.id, bundle_idx))
        return _HYBRID

    def _park_infeasible(self, spec: TaskSpec) -> None:
        with self._cond:
            self._infeasible.append(spec)

    def requeue_parked(self) -> None:
        """Re-test infeasible/PG-waiting leases (cluster state changed)."""
        with self._cond:
            self._pending.extend(self._infeasible)
            self._infeasible.clear()
            self._cond.notify_all()

    def _grant_or_requeue(
        self, spec: TaskSpec, node_id: str, via_pg: Optional[tuple] = None
    ) -> None:
        node = self.nodes.get(node_id)
        req = ResourceRequest.from_map(self.vocab, spec.resources)
        if node is None or not node.alive:
            self._enqueue(spec)
            return
        if via_pg is not None:
            pg_id, bundle_idx = via_pg
            pg = self._pgs.get(pg_id)
            if pg is None or not pg.try_allocate(bundle_idx, req):
                self._park_infeasible(spec)
                return
        elif not node.ledger.try_allocate(req):
            # Stale dense view → grant rejected → spill back to the queue
            # (grant-or-reject, local_lease_manager.h:39-61).
            self.metrics["leases_spilled_back"] += 1
            self.view.update_available(node_id, node.ledger.avail_map())
            self._enqueue(spec)
            return
        # chip-index assignment on top of the scalar grant
        assign = node.accel.allocate(spec.resources) if node.accel else {}
        if assign is None:  # fractional-share fragmentation
            if via_pg is not None:
                pg.release(bundle_idx, req)
            else:
                node.ledger.release(req)
            self._park_infeasible(spec)
            return
        if via_pg is None:
            self.view.update_available(node_id, node.ledger.avail_map())
        node.running_tasks[spec.task_id] = spec
        self.events.record(spec.task_id, spec.name, "SCHEDULED", node.node_id)
        node.pool.submit(self._execute, spec, node, req, via_pg, assign)

    # ------------------------------------------------------------------
    # execution (TaskReceiver analog)
    # ------------------------------------------------------------------
    def _execute(
        self,
        spec: TaskSpec,
        node: Node,
        req: ResourceRequest,
        via_pg: Optional[tuple],
        assign: Optional[dict] = None,
    ) -> None:
        _context.node_id = node.node_id
        _context.task_id = spec.task_id
        _context.actor_id = spec.actor_id
        _context.accelerator_ids = {
            name: [i for i, _ in a] for name, a in (assign or {}).items()
        }
        actor_holds_resources = False
        assign_held = False
        from ..util import tracing

        self.events.record(
            spec.task_id, spec.name, "RUNNING", node.node_id,
            **tracing.event_args(spec.trace)
        )
        _trace_token = tracing.install(spec.trace)
        try:
            args, kwargs = self._resolve_args(spec.args, spec.kwargs)
            result = spec.func(*args, **kwargs)
            if spec.kind == "actor_creation":
                state = self._actors[spec.actor_id]
                # the actor keeps its chip assignment for life even when the
                # scalar resources came from a PG bundle (the bundle is
                # released at creation end, the silicon is not)
                state.on_created(
                    node.node_id,
                    result,
                    (node.node_id, None if via_pg else req, assign),
                )
                actor_holds_resources = via_pg is None
                assign_held = True
                self._seal_results(spec, node, spec.actor_id)
            elif spec.streaming:
                self._run_streaming(spec, node, result)
            else:
                self._seal_results(spec, node, result)
            self.metrics["tasks_finished"] += 1
            self.events.record(
                spec.task_id, spec.name, "FINISHED", node.node_id,
                **tracing.event_args(spec.trace)
            )
        except BaseException as exc:  # noqa: BLE001 - task errors are values
            if spec.retry_exceptions and spec.attempt < spec.max_retries:
                spec.attempt += 1
                self._enqueue(spec)
            else:
                self.metrics["tasks_failed"] += 1
                self.events.record(
                    spec.task_id, spec.name, "FAILED", node.node_id,
                    error=repr(exc),
                )
                err = TaskError(exc, spec.name or spec.task_id)
                err.__cause__ = exc
                for rid in spec.return_ids:
                    self._seal_id(None, rid, err, is_error=True)
                if spec.streaming:
                    self._fail_stream(spec.task_id, err)
                if spec.kind == "actor_creation":
                    state = self._actors.get(spec.actor_id)
                    if state is not None:
                        state.mark_died(restart=False)
                logger.debug(
                    "task %s failed:\n%s", spec.name, traceback.format_exc()
                )
        finally:
            tracing.uninstall(_trace_token)
            node.running_tasks.pop(spec.task_id, None)
            if not node.alive or actor_holds_resources:
                pass  # dropped with the node / held for the actor lifetime
            elif via_pg is not None:
                pg_id, bundle_idx = via_pg
                pg = self._pgs.get(pg_id)
                if pg is not None:
                    pg.release(bundle_idx, req)
                if assign and node.accel and not assign_held:
                    node.accel.release(assign)
                self.notify_resources_changed()
            else:
                node.ledger.release(req)
                if assign and node.accel and not assign_held:
                    node.accel.release(assign)
                with self._cond:
                    self.view.update_available(node.node_id, node.ledger.avail_map())
                    # freed capacity may unblock queued/infeasible leases:
                    # notify only — the scheduler loop's capacity-capped
                    # unpark retries parked work (O(parked²) otherwise)
                    self._dirty = True
                    self._cond.notify_all()
            _context.node_id = None
            _context.task_id = None
            _context.actor_id = None
            _context.accelerator_ids = {}

    # ------------------------------------------------------------------
    # actor creation (GcsActorScheduler analog)
    # ------------------------------------------------------------------
    def _submit_actor_creation(self, state, strategy=None) -> None:
        ready = ObjectRef.new(owner="actor")
        self.store.create(ready)
        spec = TaskSpec(
            task_id=uuid.uuid4().hex[:16],
            func=state.cls,
            args=state.ctor_args,
            kwargs=state.ctor_kwargs,
            returns=[ready],
            resources=state.resources,
            name=f"{state.cls.__name__}.__init__",
            kind="actor_creation",
            actor_id=state.actor_id,
            strategy=strategy,
            max_retries=0,
        )
        state.creation_ref = ready
        state.creation_strategy = strategy
        self.submit(spec)

    def _resubmit_actor_creation(self, state) -> None:
        self._submit_actor_creation(state, getattr(state, "creation_strategy", None))

    def _resolve_args(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        """Inline ObjectRef arguments (DependencyResolver analog)."""
        res_args = tuple(
            self.get_object(a) if isinstance(a, ObjectRef) else a for a in args
        )
        res_kwargs = {
            k: self.get_object(v) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return res_args, res_kwargs

    def _run_streaming(self, spec: TaskSpec, node: Node, gen: Any) -> None:
        """Drive a ``num_returns="streaming"`` task (lineage registered:
        tasks re-execute on object loss)."""
        self._drive_stream(spec.task_id, node, gen, lineage_spec=spec)

    def run_actor_stream(self, task_id: str, node_id: str, gen: Any) -> None:
        """Drive a streaming ACTOR-method call (no lineage — actor
        methods are not re-executable)."""
        self._drive_stream(task_id, self.nodes.get(node_id), gen)

    def register_stream(self, task_id: str) -> None:
        """Stream state exists from SUBMISSION (cluster-head parity): an
        abandon arriving before the executor starts must stick, or a
        dropped generator would later drive to completion on the
        executor — wedging a sync actor's only thread forever."""
        with self._stream_cv:
            self._streams.setdefault(
                task_id, {"items": [], "done": False}
            )
            self._stream_cv.notify_all()

    def _drive_stream(
        self, task_id: str, node, gen: Any, lineage_spec=None
    ) -> None:
        """Seal every yield as its own object under
        stream_item_id(task_id, i) and publish it to the stream state
        consumers long-poll via ``stream_next``. Item appends are
        idempotent by index, so a retried generator re-seals the same
        ids without duplicating stream entries."""
        from ..cluster.common import stream_item_id

        if not hasattr(gen, "__next__"):
            gen = iter(gen)
        idx = 0
        while True:
            with self._stream_cv:
                if task_id in self._abandoned_streams:
                    # abandoned before (or during a re-execution of) this
                    # drive: never resurrect a consumer-less stream
                    try:
                        gen.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._streams.pop(task_id, None)
                    self._stream_cv.notify_all()
                    return
                st = self._streams.setdefault(
                    task_id, {"items": [], "done": False}
                )
                if st.get("abandoned"):
                    # consumer gone (possibly before our first yield):
                    # stop producing instead of running the generator out
                    try:
                        gen.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._abandoned_streams.add(task_id)
                    self._streams.pop(task_id, None)
                    self._stream_cv.notify_all()
                    return
            value = next(gen, _STREAM_END)
            if value is _STREAM_END:
                break
            oid = stream_item_id(task_id, idx)
            if lineage_spec is not None:
                self._lineage[oid] = lineage_spec
            self._seal_id(node, oid, value)
            with self._stream_cv:
                st = self._streams.setdefault(
                    task_id, {"items": [], "done": False}
                )
                if idx == len(st["items"]):
                    st["items"].append(oid)
                self._stream_cv.notify_all()
            idx += 1
        with self._stream_cv:
            st = self._streams.setdefault(
                task_id, {"items": [], "done": False}
            )
            st["done"] = True
            if st.get("abandoned"):
                self._streams.pop(task_id, None)
            self._stream_cv.notify_all()

    def _fail_stream(self, task_id: str, err: Any) -> None:
        """Mid-stream failure, retries exhausted: the NEXT item the
        consumer sees is a ref whose get() raises (reference generator
        semantics), then the stream ends."""
        from ..cluster.common import stream_item_id

        with self._stream_cv:
            st = self._streams.setdefault(
                task_id, {"items": [], "done": False}
            )
            if not st["done"]:
                oid = stream_item_id(task_id, len(st["items"]))
                self._seal_id(None, oid, err, is_error=True)
                st["items"].append(oid)
                st["done"] = True
            self._stream_cv.notify_all()

    def stream_next(
        self, task_id: str, index: int, timeout: Optional[float]
    ) -> Optional[ObjectRef]:
        """Blocking fetch of stream item ``index``; None = stream ended
        before it (StopIteration for the caller's generator)."""
        deadline = None if timeout is None else _now() + timeout
        with self._stream_cv:
            while True:
                st = self._streams.get(task_id)
                if st is not None:
                    if index < len(st["items"]):
                        return ObjectRef(st["items"][index], owner=task_id)
                    if st["done"]:
                        # fully drained: drop the state (it would leak one
                        # entry per streaming call otherwise)
                        self._streams.pop(task_id, None)
                        return None
                elif self._shutdown:
                    return None
                wait_s = 0.5
                if deadline is not None:
                    wait_s = min(wait_s, deadline - _now())
                    if wait_s <= 0:
                        raise GetTimeoutError(
                            f"stream {task_id} item {index} not ready"
                        )
                self._stream_cv.wait(timeout=wait_s)

    def stream_abandon(self, task_id: str) -> None:
        """Consumer dropped the generator: stop production and make the
        state GC-able."""
        with self._stream_cv:
            self._abandoned_streams.add(task_id)
            st = self._streams.get(task_id)
            if st is not None and st["done"]:
                self._streams.pop(task_id, None)
            else:
                st = self._streams.setdefault(
                    task_id, {"items": [], "done": False}
                )
                st["abandoned"] = True
            self._stream_cv.notify_all()

    def _seal_results(self, spec: TaskSpec, node: Node, result: Any) -> None:
        rids = spec.return_ids
        if len(rids) == 1:
            values: Sequence[Any] = [result]
        else:
            values = tuple(result)
            if len(values) != len(rids):
                raise ValueError(
                    f"task {spec.name} returned {len(values)} values, "
                    f"expected {len(rids)}"
                )
        for rid, value in zip(rids, values):
            self._seal_id(node, rid, value)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def put_object(self, value: Any) -> ObjectRef:
        ref = ObjectRef.new(owner=_context.task_id or "driver")
        self.store.create(ref)
        self.store.seal(ref, value)
        node_id = _context.node_id
        if node_id and node_id in self.nodes:
            self.nodes[node_id].objects.add(ref.hex)
        return ref

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        # Lost objects were either resubmitted by _invalidate_object (lineage
        # reconstruction, object_recovery_manager.h:41) — in which case this
        # blocks until the re-execution seals — or sealed with ObjectLostError.
        return self.store.get(ref, timeout)

    def free_objects(self, refs: List[ObjectRef]) -> None:
        """Manual force-free (ray._private.internal_api.free analog); the
        automatic GC normally makes this unnecessary."""
        for r in refs:
            self._free_local(r.hex)

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        from .refcount import TRACKER, clear_consumer

        self._gc_stop.set()
        TRACKER.zero_event.set()
        clear_consumer()
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        for actor in list(self._actors.values()):
            actor.stop()
        for node in self.nodes.values():
            node.pool.shutdown(wait=False, cancel_futures=True)
        self._sched_thread.join(timeout=2)
        if self.native_store is not None:
            self.native_store.close(unlink=True)

    # introspection (ray.nodes / state API analog)
    def nodes_info(self) -> List[Dict[str, Any]]:
        return [
            {
                "NodeID": n.node_id,
                "Alive": n.alive,
                "Resources": n.ledger.total_map(),
                "Available": n.ledger.avail_map(),
                "Labels": dict(n.labels),
            }
            for n in self.nodes.values()
        ]

    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.ledger.total_map().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Resource shapes the cluster cannot currently place — what the
        autoscaler sees (GcsAutoscalerStateManager::HandleGetClusterResourceState
        analog, gcs_autoscaler_state_manager.cc:48)."""
        out: List[Dict[str, float]] = []
        with self._cond:
            for spec in self._pending + self._infeasible:
                if spec.resources:
                    out.append(dict(spec.resources))
            for pg in self._pending_pgs:
                if not pg.removed:
                    out.extend(dict(b) for b in pg.bundle_specs)
        return out

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.ledger.avail_map().items():
                out[k] = out.get(k, 0.0) + v
        return out


_HYBRID = object()
_FAIL = object()

CLUSTER_NOT_PORTED = (
    "connecting to a cluster head (init(address=...), RAY_TPU_HEAD_ADDRESS) "
    "needs the cluster runtime, which ray_tpu_torch has not ported yet "
    "(ROADMAP Queue A item 4); call init() without an address for the "
    "local runtime"
)


def _scheduler_device(platform: str):
    """The scheduler's torch device for ``platform``; ``cuda`` without
    CUDA raises (the port does not move to the CPU on its own)."""
    import torch

    if str(platform).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"scheduler platform {platform!r} needs CUDA and no CUDA device is "
            "available; set RAY_TPU_SCHED_PLATFORM=cpu to schedule on the host"
        )
    return torch.device(platform)

_runtime: Optional[Runtime] = None
_runtime_lock = threading.Lock()


def get_runtime() -> Runtime:
    if _runtime is None:
        from ..config import cfg

        if cfg.head_address:
            raise NotImplementedError(CLUSTER_NOT_PORTED)
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _runtime


def set_runtime(rt: Optional[Runtime]) -> None:
    global _runtime
    with _runtime_lock:
        _runtime = rt


def runtime_initialized() -> bool:
    return _runtime is not None


# ActorState lives in actor.py; imported late to avoid a cycle.
from .actor import ActorState  # noqa: E402,F401  (re-export for runtime users)
