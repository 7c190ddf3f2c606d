"""Head server: the cluster control plane (GCS analog).

One process per cluster, the equivalent of the reference's ``gcs_server``
(Ray's src/ray/gcs/gcs_server.h:255-319): node membership + health
checks, the object directory, the actor directory, placement groups with
2-phase commit, an internal KV store — and, unlike the reference, the *task*
scheduler too: every lease in the cluster is placed here by the batched
hybrid program over the dense global resource view (the north-star
design — the raylet's per-request ``ScheduleAndGrantLeases`` scan,
cluster_lease_manager.cc:196, becomes one batched kernel call per round).
Agents keep authoritative per-node ledgers and grant-or-reject, so a stale
view degrades into spillback-and-retry exactly like the reference
(local_lease_manager.h:39-61).

Port of ``ray_tpu/cluster/head.py``, copied with its imports rewritten.
The rounds run ``DeviceSchedulerState`` (``scheduler/device.py``) on the
scheduler device, ``cuda`` unless ``RAY_TPU_SCHED_PLATFORM=cpu``. The
state comes up in ``HeadServer()`` or the constructor raises: the
reference defers bring-up to the first round and degrades to the golden
model. The golden model runs only when asked for
(``use_device_scheduler=False`` or ``RAY_TPU_DEVICE_SCHEDULER=0``). The
reference's two host paths in the unpark (a failed ring unpark retried
through the host, a failed slot estimate redone by a host scan) are gone:
a device failure there is a failed round, logged as "scheduler round
failed", and the parked work stays parked.
"""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.scheduler import (
    ClusterView,
    HybridConfig,
    ResourceRequest,
    ResourceVocab,
    hybrid_schedule_reference,
    schedule_bundles,
)
from ray_tpu_torch.scheduler.hybrid import hardest_first_order
from ray_tpu_torch.scheduler.device import (
    SCHED_KERNEL_MS,
    SCHED_READBACK_MS,
    SCHED_UPLOAD_MS,
    DeviceSchedulerState,
    bring_up_device_state,
    device_scheduler_default,
)

from .common import (
    INLINE_OBJECT_MAX,
    ActorInfo,
    LeaseRequest,
    NodeInfo,
    NodeReport,
    SealInfo,
    new_id,
    stream_item_id,
)
from .object_plane import PEER_CONN_GRANTED, PEER_CONN_REVOKED
from .replication import ReplicationHub, set_role
from .rpc import RpcClient, RpcError, RpcNotLeaderError, RpcServer
from .shards import ShardedTable

logger = logging.getLogger("ray_tpu_torch.cluster.head")

# creation payloads at least this large are shared between the actors that
# carry equal ones (HeadServer._shared_payload)
_SHARED_PAYLOAD_MIN = 1 << 20


def _trace_args(spec) -> dict:
    from ray_tpu_torch.util.tracing import event_args

    return event_args(getattr(spec, "trace", None))

from ray_tpu_torch.config import cfg

SCHED_TICK_S = cfg.sched_tick_s
MAX_BATCH = cfg.sched_max_batch


from ray_tpu_torch.util.metrics import Counter as _MetricCounter
from ray_tpu_torch.util.metrics import Histogram as _MetricHistogram

# best-effort callbacks the head dropped (chaos runs watch this: a swallowed
# recovery error is invisible in logs at default level but not in metrics)
HEAD_DROPPED_CALLBACKS = _MetricCounter(
    "head_dropped_callbacks",
    "Best-effort head-side callbacks that raised and were swallowed.",
    label_names=("callable",),
)

# scheduler-loop round latency (until now only sched_rounds counted; a
# slow round — a device stall, deep batch — was invisible)
SCHED_ROUND_MS = _MetricHistogram(
    "sched_round_ms",
    "Head scheduler loop round latency in ms (rounds with work only).",
    boundaries=(0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
)

# task-lease lifecycle (lease-cached direct dispatch: the head grants
# worker leases to owners; tasks stream caller->worker off the head path)
TASK_LEASE_GRANTED = _MetricCounter(
    "task_lease_granted_total",
    "Worker leases granted to task owners for direct dispatch.",
)
TASK_LEASE_RETURNED = _MetricCounter(
    "task_lease_returned_total",
    "Worker leases returned by their owners (queue drain / idle TTL).",
)
TASK_LEASE_REVOKED = _MetricCounter(
    "task_lease_revoked_total",
    "Worker leases revoked by the head (worker/node death, TTL expiry, "
    "owner disconnect).",
)

# recursive lineage reconstruction (depth 0 = the requested object's own
# creating lease; depth N = a lost input N generations up the chain)
OBJECTS_RECONSTRUCTED = _MetricCounter(
    "objects_reconstructed_total",
    "Objects rebuilt by re-executing their creating lease, by lineage "
    "depth of the reconstruction walk that requeued them.",
    label_names=("depth",),
)
RECONSTRUCTION_MS = _MetricHistogram(
    "reconstruction_ms",
    "Latency from an object's loss being detected to its re-seal.",
    boundaries=(10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 15000, 60000),
)

# owner fate-sharing
OWNERS_REAPED = _MetricCounter(
    "owners_reaped_total",
    "Owner sessions reaped, by how the owner left (disconnect|crash).",
    label_names=("mode",),
)

# locality-scored placement: specs placed WITH residency data
# and the summed fraction of their input bytes already resident on the
# chosen node. hit_frac_total / scored_total == the plane's locality
# hit-rate (bytes served same-node / total input bytes, in expectation).
SCHED_LOCALITY_SCORED = _MetricCounter(
    "sched_locality_scored_total",
    "Leases placed while carrying a per-node input-residency vector "
    "(sched_w_locality > 0 and located, sized deps).",
)
SCHED_LOCALITY_HIT_FRAC = _MetricCounter(
    "sched_locality_hit_frac_total",
    "Sum over locality-scored placements of the fraction of the "
    "lease's input bytes resident on its chosen node.",
)

# preemption / migration: the kernel nominates a victim node
# per starving shape; the head kills-and-requeues concrete victims there
SCHED_PREEMPT_NOMINATED = _MetricCounter(
    "sched_preempt_nominated_total",
    "Preemption nominations emitted by the round/ring kernels (starving "
    "shape with unmet demand and zero capacity anywhere).",
)
SCHED_PREEMPTIONS = _MetricCounter(
    "sched_preemptions_total",
    "Victim leases actually preempted, by victim class (queued = "
    "cancelled before start, requeued attempt-free; worker_lease = "
    "revoked, owner spills; running = force-killed retryable task, "
    "requeued attempt-free through the lineage machinery).",
    label_names=("kind",),
)
GANG_EPOCH_BUMPS = _MetricCounter(
    "gang_epoch_bumps_total",
    "Gang-epoch advances in the elastic-training membership protocol, "
    "by cause (node_death = a member's node was declared dead by the "
    "health loop; fence = owner-requested fence, e.g. resize/grow or "
    "actor-level death observed driver-side; register = a new gang "
    "generation registered its membership).",
    label_names=("reason",),
)


def _shape_key_of(spec) -> tuple:
    """Memoized resource-shape identity of a spec — the ONE key the
    dense-row cache, the fair-batch classes, and the device ring all
    index by (they must agree, so there is exactly one derivation)."""
    key = getattr(spec, "_shape_key", None)
    if key is None:
        key = tuple(sorted(spec.resources.items()))
        spec._shape_key = key
    return key


def _best_effort(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception:  # noqa: BLE001
        # label by callable (+ rpc method when fn is RpcClient.call): the
        # name set is small and fixed, so metric cardinality stays bounded
        name = getattr(fn, "__name__", None) or repr(fn)
        if args and isinstance(args[0], str):
            name = f"{name}:{args[0]}"
        HEAD_DROPPED_CALLBACKS.inc(labels={"callable": name})
        logger.debug("best-effort call %s dropped", name, exc_info=True)


# One writer per persist path per process: restart_head() keeps the old and
# new HeadServer in the same process for a moment; the old instance must not
# overwrite the new instance's snapshots with stale state.
_PERSIST_LOCKS: Dict[str, threading.Lock] = {}
_PERSIST_OWNER: Dict[str, int] = {}
_PERSIST_REG_LOCK = threading.Lock()


@dataclass
class _ObjEntry:
    """Object-directory row (ownership_object_directory analog) — also the
    cluster-wide refcount row (reference_counter.h:44 analog): the head is
    the single ownership authority in this centralized design."""

    event: threading.Event = field(default_factory=threading.Event)
    inline: Optional[bytes] = None
    error: Optional[bytes] = None
    locations: set = field(default_factory=set)
    size: int = 0
    creating_lease: Optional[str] = None
    # holder process id -> count (negative transients tolerate a release
    # overtaking its matching borrow report on the wire)
    holders: Dict[str, int] = field(default_factory=dict)
    # in-flight lease arg pins + containing-object pins
    pins: int = 0
    # return-object owner hold registered (exactly once across the direct
    # seal path, its at-least-once retries, AND a head-path fallback lease)
    owner_registered: bool = False
    # ids of ObjectRefs serialized inside this object's sealed value
    contained: List[str] = field(default_factory=list)
    # a holder/pin was registered at least once. Entries that were never
    # tracked (e.g. seals reported to a freshly-restarted head, whose
    # refcount tables died with the old head) are exempt from GC — they
    # leak-until-shutdown instead of being wrongly freed.
    tracked: bool = False


@dataclass
class _PGState:
    pg_id: str
    bundles: List[Dict[str, float]]
    strategy: str
    ready: threading.Event = field(default_factory=threading.Event)
    node_per_bundle: List[str] = field(default_factory=list)
    removed: bool = False
    # soft anti-affinity (gang-aware reshape placement): prefer not to
    # land bundles on these nodes — the kernel first runs with them
    # masked out and falls back to the full cluster when the masked
    # placement is infeasible
    avoid_nodes: List[str] = field(default_factory=list)


class HeadServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        use_device_scheduler: Optional[bool] = None,
        dashboard_port: Optional[int] = None,
        persist_path: Optional[str] = None,
        persist_backend: Optional[Any] = None,
    ):
        self.vocab = ResourceVocab()
        self.view = ClusterView(self.vocab)
        self.hybrid_config = HybridConfig()
        if use_device_scheduler is None:
            use_device_scheduler = device_scheduler_default()
        self.use_device_scheduler = use_device_scheduler
        # the scheduler device comes up here, before any thread, socket or
        # WAL exists, or the head fails (no degrade to the golden model).
        # The DeviceSchedulerState; None only when the golden model was
        # asked for, and then the bundle programs run on the host.
        self.device_state = (
            bring_up_device_state() if use_device_scheduler else None
        )
        self.sched_device = (
            self.device_state.device
            if self.device_state is not None
            else torch.device("cpu")
        )
        # pipelined rounds (scheduler/pipeline.py): created lazily on the
        # scheduler thread at the first device round; None means rounds
        # are synchronous (RAY_TPU_SCHED_PIPELINE=0 or host golden model)
        self._pipeline = None
        # specs mid-flight in a dispatched-but-uncompleted pipelined round:
        # still pending demand for the autoscaler, already popped from
        # every scannable queue
        self._deferred_rounds: Dict[int, List[LeaseRequest]] = {}
        self._parked_at_change = -1
        self._last_park_retry = 0.0
        # per-shape dense demand rows at the current resource-axis width
        # (_round_shapes); None value = oversized/infeasible at this width
        self._dense_cache: Tuple[int, Dict[tuple, Optional[np.ndarray]]] = (
            -1,
            {},
        )
        self._rng = np.random.default_rng(0)
        self._seed = 0
        self._spread_rr = 0  # SPREAD round-robin cursor
        self._label_rr = 0  # label-selector tie-break cursor

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.nodes: Dict[str, NodeInfo] = {}
        self._clients: Dict[str, RpcClient] = {}
        self._last_report: Dict[str, float] = {}
        # owner-sharded object directory (shards.py): dict-compatible,
        # but every lookup routes to one fixed shard and shipped-WAL
        # replay partitions by the same routing
        self._objects: ShardedTable = ShardedTable(cfg.head_shards)
        self._leases: Dict[str, LeaseRequest] = {}  # lineage: lease_id -> spec
        # --- distributed refcounting state ---
        from ray_tpu_torch.core.refcount import FreedLRU

        self._freed = FreedLRU()
        self._holder_hexes: Dict[str, set] = {}  # holder -> ids it counts
        self._lease_arg_pins: Dict[str, List[str]] = {}  # lease -> pinned args
        self._lease_live_returns: Dict[str, int] = {}  # lease -> unfreed outs
        self._pending: deque = deque()
        self._infeasible: List[LeaseRequest] = []
        self._scheduling_batch: List[LeaseRequest] = []
        # lease ids cancelled while mid-schedule: dropped at dispatch time
        # (the round already popped them out of every scannable queue)
        self._cancelled_leases: set = set()
        # --- starvation / preemption state ---
        # per-shape wait age in park-retry rounds: bumped every time a
        # round leaves the shape (partly) unplaced, cleared when the
        # shape's parked queue fully drains. Normalized by
        # cfg.sched_starve_rounds and uploaded with the demand rows
        # (kernel term d: starvation discount + preemption arming).
        self._shape_wait: Dict[tuple, int] = {}
        # lease ids whose running worker the head force-killed to
        # preempt: the agent's worker-death "failed" report requeues them
        # WITHOUT consuming a retry attempt (a preemption is a scheduler
        # action, not a task failure)
        self._preempted_leases: set = set()
        # per-shape monotonic deadline before the next preemption action
        # (freed capacity takes an agent report round-trip to appear)
        self._preempt_cooldown: Dict[tuple, float] = {}
        self._in_flight: Dict[str, Tuple[LeaseRequest, str]] = {}
        # tasks the last incarnation held unfinished that no re-registered
        # agent has named as on hand yet (_recover_unfinished_tasks)
        self._unfinished_at_load: set = set()
        # streaming-generator state: task_id -> {"items": [hex...],
        # "done": bool, "consumed": int, "touched": monotonic}
        # (object_ref_generator.py analog; items arrive via ReportSeals
        # "stream" entries, consumers long-poll WaitStream)
        self._streams: Dict[str, dict] = {}
        self._stream_cv = threading.Condition()
        # drained/GC'd stream ids: a late WaitStream reads "done" instead
        # of parking forever on a stream that will never reappear
        self._stream_tombstones: set = set()
        self._stream_tombstone_order: deque = deque()
        # task-lease table (lease-cached direct dispatch): lease_id ->
        # {state: granting|active, resources, client_id, fn_id, node_id,
        #  worker_address, worker_id, accel_env, expires_at, abandoned}.
        # Active entries persist in the snapshot/WAL so TTL expiry and
        # revoke-on-death survive a head restart (owners keep streaming
        # to their leased workers regardless — the head is off that path).
        # Owner-sharded like the object directory.
        self._task_leases: ShardedTable = ShardedTable(cfg.head_shards)
        self._grant_gate = threading.BoundedSemaphore(8)
        # peer-link lease table (cross-node data plane, transport.py):
        # link_id -> {link_id, src, dst, endpoint, granted_at,
        # expires_at}. The grant hands the requester the destination's
        # data endpoint + auth token ONCE per (src, dst) pair;
        # steady-state transfers then make zero head RPCs. Rows persist
        # in the snapshot/WAL (granted links keep serving across a head
        # restart), renew via piggybacked agent reports, and are revoked
        # on either endpoint node's death.
        self._peer_links: ShardedTable = ShardedTable(cfg.head_shards)
        self._peer_links_by_pair: Dict[tuple, str] = {}
        # revocation fan-outs queued as WAL records (revoke_pending /
        # revoke_done): a promoted standby or restarted head re-drives
        # any the dying leader never delivered, idempotently, instead of
        # trusting the corpse's best-effort last breaths.
        self._pending_revokes: Dict[str, dict] = {}
        self._actors: Dict[str, ActorInfo] = {}
        self._actor_specs: Dict[str, LeaseRequest] = {}
        # digest -> the one bytes object of each large creation payload
        self._payloads: Dict[bytes, bytes] = {}
        self._named_actors: Dict[str, str] = {}
        self._actor_send: Dict[str, deque] = {}  # per-actor ordered sender
        self._actor_sending: set = set()
        self._pgs: Dict[str, _PGState] = {}
        self._pending_pgs: List[_PGState] = []
        self._pgs_dirty = True  # retry pending PGs only after view changes
        self._kv: Dict[str, bytes] = {}
        self._jobs: Dict[str, dict] = {}
        # owner liveness (session leases): client_id -> {"last", "strikes",
        # "last_strike"}. Registered by ClientHello / first owner_beat;
        # reaped by _check_owner_liveness on missed strikes or by a clean
        # DisconnectClient.
        self._owner_sessions: Dict[str, dict] = {}
        # objects whose loss has been detected and whose rebuild is in
        # flight: oid -> (t0, depth) — dedups concurrent reconstruction
        # triggers and feeds the reconstruction metrics on re-seal
        self._reconstructing: Dict[str, tuple] = {}
        self._shutdown = False
        self._persist_path = persist_path
        self._persist_dirty = False
        self._lineage_dirty_at = 0.0  # rate gate for per-lease dirtying
        self._wal_queue: deque = deque()
        # pluggable persistence (store_client analog): any object with
        # load/save_snapshot/wal_append/wal_replay; FilePersistence default
        self._backend = persist_backend
        if persist_backend is not None and not persist_path:
            persist_path = f"<backend:{id(persist_backend)}>"
            self._persist_path = persist_path
        if persist_path and self._backend is None:
            from .persistence import FilePersistence

            self._backend = FilePersistence(persist_path)
        if self._backend is not None:
            # lock/owner registration guards EVERY backend (a custom one
            # too), or _wal_flush/_persist_now KeyError on first use
            with _PERSIST_REG_LOCK:
                _PERSIST_LOCKS.setdefault(persist_path, threading.Lock())
                _PERSIST_OWNER[persist_path] = id(self)
        from ray_tpu_torch.core.events import TaskEventBuffer

        self.events = TaskEventBuffer()
        self._recovered_epoch = 0
        # router-fleet assignment tables (horizontally scaled ingress):
        # deployment -> {"epoch": int, "members": [router_id]}. The
        # epoch is the fence for every fleet control RPC — a deposed
        # router's late acquire/ckpt/budget traffic is rejected exactly
        # like stale cluster-epoch stamps. Durable (snapshot + WAL) so
        # a promoted standby keeps fencing the same epochs.
        self._serve_fleets: Dict[str, dict] = {}
        # weights-version epochs (online-RL publish fence): deployment ->
        # {"committed": int, "meta": dict, "sealed": {"epoch", "meta"}|None}.
        # Publish is two-phase (seal -> commit), each phase its own WAL
        # record replicated to standbys, so a head killed mid-publish
        # leaves either the old or the new epoch fully visible — never a
        # torn in-between. Fenced exactly like gang epochs: commit of an
        # epoch that is not the currently sealed one is rejected stale.
        self._weights_epochs: Dict[str, dict] = {}
        # fleet stream leases: stream_id -> {stream_id, deployment,
        # tenant, router_id, delivered, ts}. The delivered-count
        # checkpoints are what make router failover token-exact — a
        # sibling inheriting the hash range resumes from here. Sharded
        # + WAL-persisted like task leases / peer links.
        self._serve_streams: ShardedTable = ShardedTable(cfg.head_shards)
        if persist_path:
            self._load_persisted()
        # cluster epoch (epoch-fenced control plane): strictly increases
        # across head incarnations — the persisted epoch + 1 when a
        # snapshot survives, floored by wall-clock millis so even an
        # UNPERSISTED restart (or a lost snapshot) still fences out
        # pre-restart traffic. Agents/owners adopt it at registration and
        # stamp their control RPCs; stale stamps are rejected before any
        # handler can touch the rebuilt tables.
        self.cluster_epoch = max(
            int(self._recovered_epoch) + 1, int(time.time() * 1000.0)
        )
        # control-plane replication (replication.py): WAL records and
        # snapshot barriers ship to registered warm standbys; this head
        # is the leader until it observes a higher epoch and fences
        # itself (role: leader -> fenced; a fenced head refuses writes).
        self.role = "leader"
        self._fenced = False
        self._leader_hint = ""
        self._repl = ReplicationHub(self)
        set_role("leader")
        self.metrics: Dict[str, int] = {
            "leases_submitted": 0,
            "leases_finished": 0,
            "leases_spilled_back": 0,
            "sched_rounds": 0,
            "nodes_dead": 0,
            "task_leases_granted": 0,
            "task_leases_returned": 0,
            "task_leases_revoked": 0,
            "peer_links_granted": 0,
            "peer_links_revoked": 0,
            "preempt_nominations": 0,
            "preemptions": 0,
        }
        # serving-plane state reported by ingress routers (1/s control
        # traffic, never per-request): (client_id, deployment) -> blob.
        # Ephemeral by design — a restarted head repopulates within one
        # report period.
        self._serve_state: Dict[tuple, dict] = {}
        # per-deployment router budget reports (ephemeral — one
        # reconcile window repopulates): dep -> rid -> report
        self._serve_budget: Dict[str, dict] = {}
        # last serve-pressure capacity verdict per deployment:
        # dep -> {"hint": {...}|None, "ts"} — advisory, ephemeral
        self._serve_capacity_hints: Dict[str, dict] = {}
        # elastic-training gang membership: gang_id -> {"epoch", "owner",
        # "members" {rank -> node_id}, "min_size", "dead_ranks", "updated"}.
        # The epoch is the fence for every gang collective — stragglers
        # from a dead epoch are rejected at the rendezvous exactly like
        # stale control RPCs at the cluster fence. Ephemeral like
        # _serve_state: the owning driver re-registers (with an epoch
        # floor) after a head failover, and re-registration itself bumps
        # the epoch, so a pre-failover straggler can never pass the fence.
        self._gangs: Dict[str, dict] = {}
        # nodes mid drain-ahead: node_id -> monotonic deadline.
        # While a node drains, NodeReport's advertised availability is
        # clamped to zero so no loop — legacy or unified — schedules new
        # work onto a machine the provider is about to reclaim.
        self._draining_nodes: Dict[str, float] = {}
        # metrics federation: typed registry deltas shipped by
        # agents (their workers' relayed through them) merge here,
        # namespaced by node/role labels; the dashboard /metrics scrape
        # renders this plus the head's own registry. Ephemeral like
        # _serve_state: senders keep shipping deltas to whichever head
        # is leading, so a restarted head's accumulation restarts at the
        # fault boundary (counters are since-head-start, documented).
        from ray_tpu_torch.util.metrics import FederatedRegistry
        from ray_tpu_torch.util.metrics import Gauge as _MetricGauge

        self.federation = FederatedRegistry()
        # created eagerly: a lazy first-scrape construction would race
        # the dashboard executor against the crash-bundle pool, and a
        # loser's instance could shadow the registry slot forever
        self._node_avail_gauge = _MetricGauge(
            "ray_tpu_node_available",
            "Per-node available resource quantity.",
            ("node", "resource"),
        )
        # scheduler decision attribution: task_id -> explanation (the
        # five per-term cost contributions of the winning placement),
        # bounded FIFO (cfg.sched_explain_keep)
        self._explain: "OrderedDict[str, dict]" = OrderedDict()
        self._explain_lock = threading.Lock()

        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="head-dispatch"
        )
        handlers = {
            "RegisterNode": self._h_register_node,
            "NodeReport": self._h_node_report,
            "ReportSeals": self._h_report_seals,
            "SubmitLease": self._h_submit_lease,
            "ClientBatch": self._h_client_batch,
            "PutObject": self._h_put_object,
            "WaitObject": self._h_wait_object,
            "LocateObjects": self._h_locate_objects,
            "ObjectSizes": self._h_object_sizes,
            "WaitObjectBatch": self._h_wait_object_batch,
            "WaitStream": self._h_wait_stream,
            "StreamConsumed": self._h_stream_consumed,
            "StreamAbandon": self._h_stream_abandon,
            "FreeObjects": self._h_free_objects,
            "RefUpdate": lambda r: self._h_ref_update(r, src="direct"),
            "GrantTaskLease": self._h_grant_task_lease,
            "GrantPeerLink": self._h_grant_peer_link,
            "ReturnPeerLink": self._h_return_peer_link,
            # drivers renew directly (agents piggyback on ReportSeals)
            "RenewPeerLinks": lambda r: self._renew_peer_links(
                r.get("link_ids", ())
            ),
            "CreateActor": self._h_create_actor,
            "GetActor": self._h_get_actor,
            "WaitActor": self._h_wait_actor,
            "PendingDemands": self._h_pending_demands,
            "CancelLease": self._h_cancel_lease,
            "KillActor": self._h_kill_actor,
            "DisconnectClient": self._h_disconnect_client,
            "ClientHello": self._h_client_hello,
            "ObjectMissing": self._h_object_missing,
            "CreatePlacementGroup": self._h_create_pg,
            "WaitPlacementGroup": self._h_wait_pg,
            "RemovePlacementGroup": self._h_remove_pg,
            "KvPut": self._h_kv_put,
            "KvGet": lambda r: self._kv.get(r["key"]),
            "KvDel": self._h_kv_del,
            "KvKeys": lambda r: [
                k for k in self._kv if k.startswith(r.get("prefix", ""))
            ],
            "ClusterInfo": self._h_cluster_info,
            "GangRegister": self._h_gang_register,
            "GangSync": self._h_gang_sync,
            "GangFence": self._h_gang_fence,
            "GangUnregister": self._h_gang_unregister,
            "GangHint": self._h_gang_hint,
            "ReportServeState": self._h_report_serve_state,
            "ServeFleetJoin": self._h_serve_fleet_join,
            "ServeFleetLeave": self._h_serve_fleet_leave,
            "ServeAssignment": self._h_serve_assignment,
            "ServeStreamAcquire": self._h_serve_stream_acquire,
            "ServeStreamCkpt": self._h_serve_stream_ckpt,
            "ServeStreamRelease": self._h_serve_stream_release,
            "ServeStreamLookup": self._h_serve_stream_lookup,
            "ServeBudget": self._h_serve_budget,
            "WeightsPublishSeal": self._h_weights_publish_seal,
            "WeightsPublishCommit": self._h_weights_publish_commit,
            "WeightsEpochGet": self._h_weights_epoch_get,
            "QueryState": self._h_query_state,
            "StandbyHello": self._h_standby_hello,
            "HeadRole": self._h_head_role,
            "Timeline": lambda r: self.events.dump_timeline(None),
            "SubmitJob": lambda r: self.jobs.submit(
                entrypoint=r["entrypoint"],
                runtime_env=r.get("runtime_env"),
                submission_id=r.get("submission_id"),
                metadata=r.get("metadata"),
            ),
            "JobStatus": lambda r: self.jobs.status(r["job_id"]),
            "JobLogs": lambda r: self.jobs.logs(r["job_id"]),
            "ListJobs": lambda r: self.jobs.list(),
            "StopJob": lambda r: self.jobs.stop(r["job_id"]),
            "Ping": lambda r: "pong",
        }
        # jobs must exist before the RPC server accepts its first request:
        # a SubmitJob/ListJobs arriving in the gap would hit AttributeError.
        # JobManager needs the head address, which is only known after bind,
        # so construct it lazily-addressed and fill in below.
        from .jobs import JobManager

        self.jobs = JobManager(None, on_change=self.mark_dirty)
        self._server = RpcServer(handlers, host=host, port=port)
        if cfg.epoch_fencing:
            self._server.epoch = self.cluster_epoch
            # the resync protocol itself must pass the fence: RegisterNode
            # re-attaches an agent (and hands out the new epoch),
            # ClientHello does the same for owners, Ping is liveness,
            # StandbyHello/HeadRole are the replication bootstrap + role
            # probe (a standby has no epoch to stamp yet)
            self._server.fence_exempt = {
                "RegisterNode",
                "ClientHello",
                "Ping",
                "StandbyHello",
                "HeadRole",
            }
            # a request stamped with a HIGHER epoch proves a newer head
            # incarnation exists: step down (self-fence) immediately
            self._server.on_newer_epoch = self._observed_newer_epoch
        self.address = self._server.address
        self.jobs.head_address = self.address
        for job in getattr(self, "_recovered_jobs", []):
            self.jobs.restore(job)
        self.dashboard = None
        if dashboard_port is not None:
            from .dashboard import Dashboard

            self.dashboard = Dashboard(self, host=host, port=dashboard_port)

        # unified elasticity plane: constructed always (so a
        # provider can attach and QueryState can introspect), ticking
        # only when cfg.elastic_controller is on — OFF leaves the three
        # legacy loops (autoscaler, serve SLO, gang grow probe) as the
        # sole capacity authorities, bit-for-bit.
        from ray_tpu_torch.scheduler.elasticity import ElasticityController

        self._elasticity = ElasticityController(self)
        if cfg.elastic_controller:
            self._elasticity.start()

        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="head-scheduler", daemon=True
        )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="head-health", daemon=True
        )
        self._sched_thread.start()
        self._health_thread.start()
        if persist_path:
            threading.Thread(
                target=self._persist_loop, name="head-persist", daemon=True
            ).start()

    # ------------------------------------------------------------------
    # state persistence (GCS fault tolerance analog: the reference persists
    # its tables to Redis, store_client/redis_store_client.cc; here a
    # debounced pickle snapshot of the durable tables — KV, jobs, and the
    # actor directory; live actors re-attach when agents re-register)
    # ------------------------------------------------------------------
    def _snapshot_state(self) -> dict:
        # streams first, OUTSIDE self._lock: _snapshot_streams takes
        # _stream_cv then (separately) _lock — nesting it under _lock here
        # would invert _h_wait_stream's (_stream_cv -> _lock) order
        streams_part = self._snapshot_streams()
        with self._lock:
            return {
                # the NEXT incarnation starts at a strictly higher epoch
                "epoch": self.cluster_epoch,
                "kv": dict(self._kv),
                "named_actors": dict(self._named_actors),
                "actors": {
                    a.actor_id: dict(vars(a)) for a in self._actors.values()
                },
                "actor_specs": dict(self._actor_specs),
                "jobs": self.jobs.snapshot() if hasattr(self, "jobs") else [],
                # lineage: the head is this design's ownership authority,
                # so task lineage must survive it the way the reference's
                # owner workers survive a GCS restart. Without this, an
                # object whose only copy dies AFTER a head restart is
                # unrecoverable (no spec to re-execute). Debounced with
                # the rest of the snapshot; a hard crash can lose the
                # last ~1s of lineage, a clean restart loses none.
                "leases": {
                    lid: spec
                    for lid, spec in self._leases.items()
                    if spec.kind == "task" and spec.return_ids
                },
                # the tasks among them whose returns were not sealed yet
                # (queued, parked or running here): a queue lives only in
                # this process, so the next incarnation re-drives those
                # that no agent finishes (_recover_unfinished_tasks)
                "unfinished_leases": [
                    lid
                    for lid, spec in self._leases.items()
                    if spec.kind == "task"
                    and spec.return_ids
                    and any(
                        self._objects.get(rid) is not None
                        and not self._objects[rid].event.is_set()
                        for rid in spec.return_ids
                    )
                ],
                # active task leases: TTL expiry / revoke-on-death keep
                # working across a restart (owners stream direct anyway)
                "task_leases": [
                    self._lease_snapshot_row(e)
                    for e in self._task_leases.values()
                    if e["state"] == "active"
                ],
                # granted peer data links: revocation/expiry bookkeeping
                # survives a restart (the links themselves keep serving
                # head-free; tokens re-learn from re-registration)
                "peer_links": [
                    self._peer_link_row(e) for e in self._peer_links.values()
                ],
                # undelivered revocation fan-outs: a successor re-drives
                # them (idempotent receiver-side) instead of relying on
                # this process's best-effort sends having landed
                "pending_revokes": {
                    rid: dict(row)
                    for rid, row in self._pending_revokes.items()
                },
                # router-fleet assignment epochs + stream-lease ckpts:
                # a restarted head must keep fencing the same epochs
                # and resuming streams token-exact
                "serve_fleets": {
                    dep: dict(f) for dep, f in self._serve_fleets.items()
                },
                # weights-version publish fence: committed epoch + any
                # sealed-but-uncommitted phase survive restart/promotion
                # so the publisher's retry resolves to exactly one epoch
                "weights_epochs": {
                    dep: dict(w) for dep, w in self._weights_epochs.items()
                },
                "serve_streams": [
                    dict(row) for row in self._serve_streams.values()
                ],
            } | streams_part

    def _snapshot_streams(self) -> dict:
        """Streaming-generator state for the snapshot: a head restart with
        unconsumed items must not strand the consumer's WaitStream loop.
        Inline item values ride along (they live nowhere else — large
        items re-advertise from node stores on agent re-registration)."""
        with self._stream_cv:
            streams = {
                tid: {
                    "items": list(st["items"]),
                    "done": st["done"],
                    "consumed": st["consumed"],
                    "delivered": st["delivered"],
                    "abandoned": bool(st.get("abandoned")),
                }
                for tid, st in self._streams.items()
            }
            tombstones = list(self._stream_tombstone_order)
        inline: Dict[str, tuple] = {}
        with self._lock:
            for st in streams.values():
                for oid in st["items"]:
                    e = self._objects.get(oid)
                    if e is None:
                        continue
                    if e.inline is not None:
                        inline[oid] = ("inline", e.inline)
                    elif e.error is not None:
                        inline[oid] = ("error", e.error)
        return {
            "streams": streams,
            "stream_tombstones": tombstones,
            "stream_inline": inline,
        }

    def _wal(self, record: tuple) -> None:
        """Queue a durable registration for the WAL. Called UNDER
        self._lock so queue order matches memory-mutation order; the
        actual disk append happens in _wal_flush() AFTER the head lock is
        released — taking the persist lock here would invert the
        persist-thread's (persist lock -> head lock) order and deadlock
        the whole head."""
        if self._backend is None:
            return
        self._wal_queue.append(record)

    def _wal_flush(self) -> None:
        """Drain queued WAL records to disk (call with self._lock NOT
        held) and publish them to the replication stream. Records drain
        in queue order regardless of which handler thread flushes, so
        replay order always matches acknowledged state; the replication
        seq is assigned under the same persist lock, so shipped order
        matches disk order."""
        if self._backend is None or not self._wal_queue:
            return
        if self._fenced:
            # a deposed leader writes nothing: not to disk, not to the
            # stream — its late mutations must be provably rejected
            self._wal_queue.clear()
            return
        lock = _PERSIST_LOCKS[self._persist_path]
        with lock:
            if _PERSIST_OWNER.get(self._persist_path) != id(self):
                self._wal_queue.clear()
                return
            records = []
            while True:
                try:
                    records.append(self._wal_queue.popleft())
                except IndexError:
                    break
            for record in records:
                try:
                    self._backend.wal_append(record)
                except Exception:  # noqa: BLE001 - durability best-effort
                    logger.exception("WAL append failed")
            last_seq = self._repl.publish(records)
        # acked shipping (cfg.wal_ship_acked) waits OUTSIDE the persist
        # lock: the shipper thread never takes it, but other handlers'
        # flushes must not serialize behind this one's ack wait
        if last_seq and cfg.wal_ship_acked:
            self._repl.wait_acked(
                last_seq, timeout=cfg.wal_ship_ack_timeout_s
            )

    def _load_persisted(self) -> None:
        snap = self._backend.load() or {}
        records = self._backend.wal_replay()
        if not snap and not records:
            return
        self._recovered_epoch = int(snap.get("epoch", 0))
        self._kv = dict(snap.get("kv", {}))
        self._named_actors = dict(snap.get("named_actors", {}))
        self._actor_specs = dict(snap.get("actor_specs", {}))
        # recovered lineage: pre-create directory entries wired to their
        # creating leases (unsealed, no locations — agents re-advertise
        # the bytes on re-registration). Untracked entries are GC-exempt,
        # consistent with all refcount state that predates a restart.
        for lid, spec in snap.get("leases", {}).items():
            self._leases[lid] = spec
            for rid in spec.return_ids:
                entry = self._objects.setdefault(rid, _ObjEntry())
                entry.creating_lease = lid
        # streaming-generator state: restored so consumers' WaitStream
        # loops pick up where they left off. Inline item values are
        # re-seeded here; store-resident items regain locations when
        # their agents re-register.
        now = time.monotonic()
        for tid, st in snap.get("streams", {}).items():
            self._streams[tid] = {**st, "touched": now}
        for tid in snap.get("stream_tombstones", []):
            self._tombstone_stream(tid)
        for oid, (kind, blob) in snap.get("stream_inline", {}).items():
            entry = self._objects.setdefault(oid, _ObjEntry())
            if kind == "error":
                entry.error = blob
            else:
                entry.inline = blob
                entry.size = len(blob)
            entry.event.set()
        now_m = time.monotonic()
        ttl = cfg.task_lease_ttl_s
        for row in snap.get("task_leases", []):
            self._restore_task_lease(row, now_m, ttl)
        for row in snap.get("peer_links", []):
            self._restore_peer_link(row)
        for rid, row in snap.get("pending_revokes", {}).items():
            self._pending_revokes[rid] = dict(row)
        for dep, f in snap.get("serve_fleets", {}).items():
            self._serve_fleets[dep] = {
                "epoch": int(f.get("epoch", 0)),
                "members": list(f.get("members", ())),
            }
        for dep, w in snap.get("weights_epochs", {}).items():
            self._weights_epochs[dep] = {
                "committed": int(w.get("committed", 0)),
                "meta": dict(w.get("meta", {})),
                "sealed": dict(w["sealed"]) if w.get("sealed") else None,
            }
        for row in snap.get("serve_streams", []):
            self._serve_streams[row["stream_id"]] = dict(row)
        for actor_id, fields in snap.get("actors", {}).items():
            info = ActorInfo(**fields)
            # hosting agents re-register and re-attach; until then, unknown
            if info.state != "DEAD":
                info.state = "RESTARTING"
                info.node_id = None
                info.address = None
            self._actors[actor_id] = info
        self._recovered_jobs = snap.get("jobs", [])
        # replay registrations that landed after the last snapshot tick
        for rec in records:
            kind = rec[0]
            if kind == "kv_put":
                self._kv[rec[1]] = rec[2]
            elif kind == "kv_del":
                self._kv.pop(rec[1], None)
            elif kind == "actor":
                fields, spec, name = rec[1], rec[2], rec[3]
                info = ActorInfo(**fields)
                if info.state != "DEAD":
                    info.state = "RESTARTING"
                    info.node_id = None
                    info.address = None
                self._actors[info.actor_id] = info
                if spec is not None:
                    self._actor_specs[info.actor_id] = spec
                if name:
                    self._named_actors[name] = info.actor_id
            elif kind == "actor_dead":
                info = self._actors.get(rec[1])
                if info is not None:
                    info.state = "DEAD"
                    if (
                        info.name
                        and self._named_actors.get(info.name) == rec[1]
                    ):
                        del self._named_actors[info.name]
            elif kind == "task_lease":
                self._restore_task_lease(
                    rec[1], time.monotonic(), cfg.task_lease_ttl_s
                )
            elif kind == "task_lease_gone":
                self._task_leases.pop(rec[1], None)
            elif kind == "peer_link":
                self._restore_peer_link(rec[1])
            elif kind == "peer_link_gone":
                e = self._peer_links.pop(rec[1], None)
                if e is not None:
                    self._peer_links_by_pair.pop(
                        (e["src"], e["dst"]), None
                    )
            elif kind == "revoke_pending":
                self._pending_revokes[rec[1]["revoke_id"]] = dict(rec[1])
            elif kind == "revoke_done":
                self._pending_revokes.pop(rec[1], None)
            elif kind == "serve_fleet":
                row = rec[1]
                self._serve_fleets[row["deployment"]] = {
                    "epoch": int(row.get("epoch", 0)),
                    "members": list(row.get("members", ())),
                }
            elif kind == "serve_stream":
                row = dict(rec[1])
                self._serve_streams[row["stream_id"]] = row
            elif kind == "serve_stream_ckpt":
                row = self._serve_streams.get(rec[1]["stream_id"])
                if row is not None:
                    row["delivered"] = max(
                        int(row.get("delivered", 0)),
                        int(rec[1].get("delivered", 0)),
                    )
                    if rec[1].get("router_id"):
                        row["router_id"] = rec[1]["router_id"]
            elif kind == "serve_stream_gone":
                self._serve_streams.pop(rec[1], None)
            elif kind == "weights_epoch":
                self._replay_weights_epoch(rec[1])
        logger.info(
            "recovered head state: %d kv keys, %d actors, %d jobs, "
            "%d WAL records",
            len(self._kv),
            len(self._actors),
            len(self._recovered_jobs),
            len(records),
        )
        # owner sessions are in-memory only, so fate-sharing must survive
        # the restart: re-seed a session (fresh deadline) for every owner
        # the restored actors/leases reference. A live owner's next beat
        # keeps it fresh; one that crashed around the restart accrues
        # strikes and gets the full reap — otherwise its actors and
        # leases would leak forever and dependents would hang instead of
        # raising OwnerDiedError.
        if cfg.owner_liveness:
            owners = {
                info.owner_client
                for info in self._actors.values()
                if info.owner_client
                and info.lifetime != "detached"
                and info.state != "DEAD"
            }
            owners.update(
                e["client_id"]
                for e in self._task_leases.values()
                if e.get("client_id")
            )
            for cid in owners:
                self._touch_owner(cid)
        # actors recovered as RESTARTING normally re-attach when their
        # hosting agents re-register. One registered-but-never-created
        # (the WAL window) has NO hosting agent — after a grace period,
        # resubmit its creation lease or it parks RESTARTING forever.
        if any(a.state == "RESTARTING" for a in self._actors.values()):
            threading.Thread(
                target=self._recover_orphan_actors,
                name="head-actor-recover",
                daemon=True,
            ).start()
        # tasks the last incarnation held unfinished: re-registering agents
        # name those they still run and redeliver the seals of those they
        # ran; after a grace period, re-drive the rest or their getters
        # wait forever
        unfinished = [
            lid for lid in snap.get("unfinished_leases", ())
            if lid in self._leases
        ]
        self._unfinished_at_load = set(unfinished)
        if unfinished:
            threading.Thread(
                target=self._recover_unfinished_tasks,
                args=(unfinished,),
                name="head-task-recover",
                daemon=True,
            ).start()

    def _restore_peer_link(self, row: dict) -> None:
        """Rebuild one persisted peer-link row (expiry rebased; at least
        one TTL of grace so live holders get a renewal in first)."""
        e = dict(row)
        remaining = float(e.pop("ttl_remaining_s", 0.0))
        e["expires_at"] = time.monotonic() + max(
            remaining, cfg.peer_link_ttl_s
        )
        self._peer_links[e["link_id"]] = e
        self._peer_links_by_pair[(e["src"], e["dst"])] = e["link_id"]

    def _restore_task_lease(self, row: dict, now_m: float, ttl: float) -> None:
        """Rebuild one persisted lease row (expiry rebased onto this
        process's monotonic clock; at least one TTL of grace so live
        owners get a renewal in before the sweep runs)."""
        e = dict(row)
        remaining = float(e.pop("ttl_remaining_s", 0.0))
        e["state"] = "active"
        e["abandoned"] = False
        e["expires_at"] = now_m + max(remaining, ttl)
        self._task_leases[e["lease_id"]] = e

    def _recover_orphan_actors(self, grace_s: float = 10.0) -> None:
        time.sleep(grace_s)
        to_create = []
        with self._cond:
            if self._shutdown:
                return
            for info in self._actors.values():
                if info.state != "RESTARTING" or info.node_id is not None:
                    continue
                spec = self._actor_specs.get(info.actor_id)
                if spec is None:
                    continue
                clone = LeaseRequest(
                    task_id=new_id(),
                    name=spec.name,
                    payload=spec.payload,
                    return_ids=[],
                    resources=spec.resources,
                    kind="actor_creation",
                    actor_id=info.actor_id,
                    max_retries=0,
                    strategy=spec.strategy,
                    runtime_env=spec.runtime_env,
                    actor_meta=spec.actor_meta,
                )
                to_create.append(clone)
                self._leases[clone.task_id] = clone
                self._pending.append(clone)
            if to_create:
                self._cond.notify_all()
        if to_create:
            logger.info(
                "resubmitting %d recovered actor creations with no "
                "hosting agent",
                len(to_create),
            )

    def _recover_unfinished_tasks(self, lease_ids: List[str]) -> None:
        """Re-drive the tasks a previous incarnation held unfinished (its
        queue, its parked work, its dispatches) that no re-registered agent
        named as on hand and whose returns are still unsealed, uncopied and
        unclaimed after the health timeout: every live agent has
        re-registered, named the tasks it still runs and redelivered the
        seals of the tasks it ran by then, and one that has not is declared
        dead, its work lost anyway.
        A task with retries left is queued again (at-least-once, as lineage
        reconstruction is); a ``max_retries=0`` task's returns fail with
        ``ObjectLostError`` (at-most-once: it may have run) instead of
        leaving their getters waiting forever."""
        from ray_tpu_torch.core.object_store import ObjectLostError

        time.sleep(cfg.health_timeout_s)
        requeued, failed = [], []
        with self._cond:
            if self._shutdown:
                return
            lease_ids = [
                lid for lid in lease_ids if lid in self._unfinished_at_load
            ]
            self._unfinished_at_load = set()
            queued = {
                s.task_id
                for q in (
                    self._pending,
                    self._infeasible,
                    self._scheduling_batch,
                    *self._deferred_rounds.values(),
                )
                for s in q
            }
            for lid in lease_ids:
                spec = self._leases.get(lid)
                if spec is None or lid in self._in_flight or lid in queued:
                    continue
                entries = [self._objects.get(rid) for rid in spec.return_ids]
                if any(
                    e is None
                    or e.event.is_set()
                    or e.locations
                    or e.inline is not None
                    or e.error is not None
                    for e in entries
                ):
                    continue
                if spec.attempt >= spec.max_retries:
                    failed.append(spec)
                    continue
                spec.attempt += 1
                spec.target_node = None
                self._pending.append(spec)
                requeued.append(lid)
            if requeued:
                self._cond.notify_all()
        for spec in failed:
            self._seal_error_ids(
                list(spec.return_ids),
                ObjectLostError(
                    f"task {spec.task_id[:8]} was unfinished when the head "
                    "restarted and no agent finished it; max_retries="
                    f"{spec.max_retries} refuses to re-execute it"
                ),
            )
        if requeued or failed:
            logger.info(
                "re-driving %d tasks unfinished at the head's restart "
                "(%d failed: no retries left)",
                len(requeued),
                len(failed),
            )

    def mark_dirty(self) -> None:
        self._persist_dirty = True

    def _mark_hot_dirty(self) -> None:
        """Rate-gated mark_dirty for HOT paths (lease submission, stream
        item flow): dirtying per event would re-pickle the whole live
        lease/stream state at the 1s persist tick — O(in-flight) work per
        second on head threads. ~5s staleness is fine: clean restarts
        flush on shutdown; only a hard crash can lose the gap."""
        now = time.monotonic()
        if now - self._lineage_dirty_at > 5.0:
            self._lineage_dirty_at = now
            self.mark_dirty()

    def _persist_now(self) -> None:
        if self._fenced:
            return  # deposed: never overwrite the successor's state
        lock = _PERSIST_LOCKS[self._persist_path]
        with lock:
            if _PERSIST_OWNER.get(self._persist_path) != id(self):
                return  # a newer head owns this file now; never write stale
            try:
                snap = self._snapshot_state()
                self._backend.save_snapshot(snap)
                # snapshot barrier into the replication stream, still
                # under the persist lock: a record that mutated AFTER
                # this capture cannot be sequenced before the barrier
                # (its flush needs this same lock), so a standby
                # applying [.., barrier, record..] never loses it
                self._repl.publish_snapshot(snap)
            except Exception:  # noqa: BLE001
                self._persist_dirty = True  # don't lose the write; retry
                logger.exception("head state persistence failed")

    def _persist_loop(self) -> None:
        while True:
            time.sleep(1.0)
            if self._shutdown or self._fenced:
                return  # shutdown() does the final flush itself
            if not self._persist_dirty:
                continue
            self._persist_dirty = False
            self._persist_now()

    # ------------------------------------------------------------------
    # control-plane replication: WAL shipping to warm standbys + fenced
    # leadership (replication.py, standby.py)
    # ------------------------------------------------------------------
    def _h_standby_hello(self, req: dict) -> dict:
        """Standby bootstrap: register it for WAL shipping and hand back
        a full snapshot + the stream position it covers. The seq is read
        BEFORE the capture, so records racing the capture are both in
        the snapshot and shipped again — double-applied (idempotent),
        never lost."""
        if self._fenced:
            raise RpcNotLeaderError(
                "this head is fenced (deposed leader)",
                leader_hint=self._leader_hint,
            )
        if self._backend is None:
            # no persistence stream to ship: a standby of this head
            # would bootstrap once and silently never converge again
            raise RuntimeError(
                "WAL shipping requires head persistence "
                "(start the head with persist_path/persist_backend)"
            )
        from_seq = self._repl.seq
        # register BEFORE capturing: records flushed during the capture
        # are retained for shipping AND already inside the snapshot —
        # double-applied (idempotent), never lost
        self._repl.register_standby(
            req["standby_id"], req["address"], from_seq
        )
        snap = self._snapshot_state()
        return {
            "snapshot": snap,
            "from_seq": from_seq,
            "epoch": self.cluster_epoch,
            "leader": self.address,
        }

    def _h_head_role(self, req) -> dict:
        """Leadership probe (fence-exempt, served even while fenced):
        agents/clients walk their head-candidate list with this when the
        configured head stops answering as leader."""
        return {
            "role": self.role,
            "epoch": self.cluster_epoch,
            "leader_hint": self._leader_hint,
            "address": self.address,
        }

    def _observed_newer_epoch(self, epoch: int) -> None:
        """RPC-layer callback: a request arrived stamped with a HIGHER
        epoch than ours — proof a newer head incarnation exists (its
        sender registered there). Self-fence immediately."""
        self._step_down(epoch, "request stamped with a newer epoch")

    def _step_down(
        self, new_epoch: int, why: str, leader_hint: str = ""
    ) -> None:
        """Deposed-leader self-fencing: refuse every write from here on.
        Mutating RPCs are rejected at the server layer with
        RpcNotLeaderError (callers walk to the real leader), internal
        loops exit, and neither the snapshot file nor the WAL is ever
        written again — the successor owns them. The process stays up
        only to redirect stragglers."""
        with self._lock:
            if self._fenced or self._shutdown:
                return
            self._fenced = True
            self.role = "fenced"
            if leader_hint:
                self._leader_hint = leader_hint
        set_role("fenced")
        logger.warning(
            "head %s stepping down (epoch %d observed > ours %d): %s",
            self.address,
            int(new_epoch),
            self.cluster_epoch,
            why,
        )
        self._server.role_hint = "fenced"
        self._server.not_leader_hint = self._leader_hint or None
        self._server.refuse_non_leader = True
        self._repl.stop()
        # wake the scheduler loop so it observes the fence and exits
        with self._cond:
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # membership + health (GcsNodeManager / GcsHealthCheckManager analog)
    # ------------------------------------------------------------------
    def _h_kv_put(self, r: dict) -> None:
        with self._lock:
            # queue under the same lock as the memory write: replay order
            # must match acknowledged state (two racing puts to one key)
            self._kv[r["key"]] = r["value"]
            self._wal(("kv_put", r["key"], r["value"]))
        self._wal_flush()
        self.mark_dirty()

    def _h_kv_del(self, r: dict) -> None:
        with self._lock:
            self._kv.pop(r["key"], None)
            self._wal(("kv_del", r["key"]))
        self._wal_flush()
        self.mark_dirty()

    def _h_register_node(self, info: NodeInfo) -> dict:
        with self._cond:
            self.nodes[info.node_id] = info
            old_client = self._clients.get(info.node_id)
            # breaker -> health path: a wedged/blackholed transport to this
            # node opens its circuit and declares it unreachable in
            # ~rpc_breaker_window_s instead of stalling every dispatch for
            # its full timeout (the 600s accelerator-transport wedge class)
            self._clients[info.node_id] = RpcClient(
                info.address,
                on_unreachable=lambda nid=info.node_id: (
                    self._peer_unreachable(nid)
                ),
            )
            if old_client is not None:
                # in-flight calls on the old channel fail with RpcError and
                # take the normal retry paths; never leak channels on rejoin
                old_client.close()
            self._last_report[info.node_id] = time.monotonic()
            self.view.add_node(info.node_id, info.resources, info.labels)
            # fresh capacity may unblock parked leases / pending PGs
            self._pending.extend(self._infeasible)
            self._infeasible.clear()
            self._pgs_dirty = True
            # a task this agent still runs finishes there: never re-drive it
            self._unfinished_at_load.difference_update(info.tasks_on_hand)
            self._cond.notify_all()
        # re-attach actors this agent still hosts (head-restart recovery:
        # the actor instances kept running in the agent's workers)
        for meta in info.hosted_actors:
            actor_id = meta["actor_id"]
            with self._lock:
                existing = self._actors.get(actor_id)
                if existing is None:
                    name = meta.get("name")
                    self._actors[actor_id] = ActorInfo(
                        actor_id=actor_id,
                        name=name,
                        node_id=info.node_id,
                        address=info.address,
                        state="ALIVE",
                        max_restarts=meta.get("max_restarts", 0),
                        lifetime=meta.get("lifetime"),
                        owner_client=meta.get("owner_client", ""),
                    )
                    if name and name not in self._named_actors:
                        self._named_actors[name] = actor_id
                    continue
            # _mark_actor_alive handles the DEAD case by tearing the
            # zombie instance down on the agent
            self._mark_actor_alive(actor_id, info.node_id, info.address)
        # re-seed the object directory from the agent's store inventory
        # (head-restart recovery: the directory died with the old head but
        # the bytes live on in node stores). Entries new to this head stay
        # untracked — exempt from GC exactly like any refcount state that
        # predates a restart — while entries the head already tracks just
        # regain a location.
        if info.stored_objects:
            self._apply_seals(
                [
                    SealInfo(
                        object_id=oid, node_id=info.node_id, size=int(size)
                    )
                    for oid, size in info.stored_objects
                ]
            )
        # task-lease reconciliation: leases the agent still holds that
        # this head no longer tracks (unpersisted restart, WAL window)
        # are released so their workers don't stay pinned forever
        for lid in getattr(info, "held_task_leases", ()) or ():
            with self._lock:
                known = lid in self._task_leases
                if known:
                    # re-learn the hosting node (snapshot rows survive,
                    # but a row restored before agents re-registered may
                    # predate a node-id change)
                    self._task_leases[lid]["node_id"] = info.node_id
            if not known:
                logger.info(
                    "agent %s holds unknown task lease %s; releasing",
                    info.node_id,
                    lid[:8],
                )
                self._agent_return_lease(info.node_id, lid)
        # re-drive any revocation fan-out queued for this node that a
        # previous incarnation (or an earlier outage window) never
        # delivered — idempotent on the agent side
        self._redrive_revokes(info.node_id)
        logger.info("node %s registered at %s", info.node_id, info.address)
        return {
            "node_id": info.node_id,
            "head_address": self.address,
            # adopted by the agent: its control RPCs stamp this epoch, so
            # a future head restart fences it until it re-registers
            "epoch": self.cluster_epoch,
        }

    def _peer_unreachable(self, node_id: str) -> None:
        """Circuit breaker opened on this peer: its transport has been
        failing for the whole server-unavailable window. Feed the health
        path immediately — leases requeue, actors restart, and the agent
        (if actually alive behind a one-way partition) re-registers on its
        next report once the path heals."""
        if self._shutdown:
            return
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
        logger.warning(
            "rpc circuit to node %s opened; marking unreachable", node_id
        )
        self._on_node_death(node_id)

    def _h_node_report(self, report: NodeReport) -> dict:
        with self._cond:
            self._last_report[report.node_id] = time.monotonic()
            node = self.nodes.get(report.node_id)
            alive = node is not None and node.alive
            draining = report.node_id in self._draining_nodes
            if alive:
                avail = report.available
                if draining:
                    # drain-ahead: a retiring node advertises zero so no
                    # scheduling path lands new work on it mid-drain
                    avail = {k: 0.0 for k in (avail or {})}
                self.view.update_available(report.node_id, avail)
                self._pgs_dirty = True
        if report.seals:
            self._apply_seals(report.seals)
        if report.finished_leases:
            self._finish_leases(report.finished_leases)
        # alive=False tells an agent that was (transiently) declared dead to
        # re-register — nodes can rejoin after a heartbeat gap. draining=True
        # tells the agent to stop warming its pool (drain-ahead).
        return {"alive": alive, "draining": draining}

    def _health_loop(self) -> None:
        """Strike-based liveness (gcs_health_check_manager.h analog:
        period x failure_threshold): a node is dead only after
        ``health_miss_threshold`` CONSECUTIVE missed windows of
        ``health_timeout_s / threshold`` each — total detection latency
        stays ~health_timeout_s, but one wall-clock gap (GC pause,
        transfer storm on a loaded host) no longer kills a healthy node.
        The poll period is jittered so co-located heads (tests, multi-head
        hosts) don't phase-align their scans."""
        import random as _random

        rng = _random.Random(0x4EA17)
        strikes: Dict[str, int] = {}
        last_strike: Dict[str, float] = {}
        while not self._shutdown and not self._fenced:
            threshold = max(1, int(cfg.health_miss_threshold))
            window = cfg.health_timeout_s / threshold
            time.sleep(window / 2.0 * rng.uniform(0.7, 1.3))
            now = time.monotonic()
            dead = []
            with self._lock:
                known = set(self.nodes)
                for nid, node in self.nodes.items():
                    if not node.alive:
                        continue
                    gap = now - self._last_report.get(nid, now)
                    if gap <= window:
                        strikes.pop(nid, None)
                        last_strike.pop(nid, None)
                        continue
                    # one strike per window, not per poll: the poll runs
                    # ~2x per window, and a single long gap must not be
                    # double-counted into an instant death
                    if now - last_strike.get(nid, 0.0) >= window * 0.9:
                        strikes[nid] = strikes.get(nid, 0) + 1
                        last_strike[nid] = now
                    if strikes.get(nid, 0) >= threshold:
                        dead.append(nid)
            for nid in list(strikes):
                if nid not in known:
                    strikes.pop(nid, None)
                    last_strike.pop(nid, None)
            for nid in dead:
                strikes.pop(nid, None)
                last_strike.pop(nid, None)
                logger.warning(
                    "node %s missed %d consecutive health windows; "
                    "marking dead",
                    nid,
                    threshold,
                )
                self._on_node_death(nid)
            self._gc_idle_streams()
            self._expire_task_leases()
            self._expire_peer_links()
            self._check_owner_liveness()
            self._expire_pending_revokes()
            self._expire_serve_streams()

    def _expire_serve_streams(self) -> None:
        """Reap fleet stream-lease rows whose owner stopped
        checkpointing (consumer crashed without release): a bounded
        leak, mirroring task-lease TTL expiry. The TTL is generous —
        a live stream checkpoints every reconcile window."""
        ttl = max(60.0, 40 * float(cfg.serve_budget_reconcile_s))
        now = time.time()
        with self._lock:
            stale = [
                sid
                for sid, row in self._serve_streams.items()
                if now - float(row.get("ts") or now) > ttl
            ]
            for sid in stale:
                self._serve_streams.pop(sid, None)
                self._wal(("serve_stream_gone", sid))
        if stale:
            self._wal_flush()

    def _on_node_death(self, node_id: str) -> None:
        with self._cond:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            self.metrics["nodes_dead"] += 1
            self.view.remove_node(node_id)
            lost_leases = [
                (lid, spec)
                for lid, (spec, nid) in self._in_flight.items()
                if nid == node_id
            ]
            for lid, _ in lost_leases:
                self._in_flight.pop(lid, None)
            # every object ADVERTISED on the dead node, not only those
            # whose locations are exactly {node_id}: _recover_object
            # prunes the stale row either way, and reconstructs only when
            # no live copy remains — a multi-copy object whose replica
            # nodes die one by one would otherwise keep its stale rows
            # forever and never rebuild
            lost_objects = [
                oid
                for oid, e in self._objects.items()
                if node_id in e.locations and e.inline is None
            ]
            dead_actors = [
                a for a in self._actors.values() if a.node_id == node_id
            ]
            # task leases on the dead node: revoke (the owners' channels
            # discover via RPC failure and spill their queues to the
            # per-task head path — chaos-safe by construction)
            dead_leases = [
                lid
                for lid, e in self._task_leases.items()
                if e.get("node_id") == node_id
            ]
            for lid in dead_leases:
                self._drop_task_lease_locked(lid)
                self.metrics["task_leases_revoked"] += 1
                TASK_LEASE_REVOKED.inc()
            self._cond.notify_all()
        # peer data links touching the dead node: revoke + notify holders
        self._revoke_node_peer_links(node_id)
        # elastic gangs with a member on the corpse: advance their epochs
        # so the membership protocol fences the dead generation
        self._gangs_note_node_death(node_id)
        # in-flight leases on the dead node: retry or fail
        requeued = set()
        for lid, spec in lost_leases:
            requeued.add(lid)
            self._retry_or_fail(spec, f"node {node_id} died running {spec.name}")
        # objects whose only copy died: lineage reconstruction — requeue each
        # creating lease ONCE even if several of its returns were lost
        for oid in lost_objects:
            self._recover_object(oid, node_id, requeued)
        # actors: restart state machine (GcsActorManager analog)
        for info in dead_actors:
            self._restart_or_kill_actor(info, f"node {node_id} died")

    def _retry_or_fail(self, spec: LeaseRequest, reason: str) -> None:
        if spec.kind == "worker_lease":
            # a grant lost in flight (agent unreachable / node died):
            # drop the table row — the waiting owner's long-poll returns
            # "grant failed" and it stays on the per-task head path
            with self._cond:
                e = self._task_leases.get(spec.task_id)
                was_active = e is not None and e["state"] == "active"
                self._drop_task_lease_locked(spec.task_id)
                if was_active:
                    self.metrics["task_leases_revoked"] += 1
                    TASK_LEASE_REVOKED.inc()
                self._cond.notify_all()
            self._wal_flush()
            return
        if spec.kind == "actor_creation":
            # a creation lease lost to node death / unreachable agent is a
            # SCHEDULING failure, not an actor failure: reschedule without
            # consuming the actor's restart budget (GcsActorScheduler
            # reschedule-on-node-death analog). Without this, an actor
            # whose hosting node died mid-creation parked PENDING forever
            # (found by the chaos soak's early kill_node fault).
            info = self._actors.get(spec.actor_id)
            if info is not None and info.state != "DEAD":
                logger.info(
                    "actor %s creation lost (%s); rescheduling",
                    spec.actor_id,
                    reason,
                )
                spec.target_node = None
                with self._cond:
                    self._pending.append(spec)
                    self._cond.notify_all()
                return
            self._release_lease_pins(spec.task_id)
            return
        if spec.kind == "actor_method":
            self._seal_error_ids(spec.return_ids, RuntimeError(reason))
            if spec.streaming:
                # streaming methods have no return ids; without this the
                # consumer's WaitStream long-poll would never end
                self._fail_stream(spec, reason)
            self._release_lease_pins(spec.task_id)
            return
        with self._cond:
            preempted = spec.task_id in self._preempted_leases
            self._preempted_leases.discard(spec.task_id)
        if preempted or spec.attempt < spec.max_retries:
            # a victim whose preemption kill raced node death still
            # requeues attempt-free (the kill was the scheduler's doing)
            if not preempted:
                spec.attempt += 1
            spec.target_node = None
            with self._cond:
                self.metrics["leases_spilled_back"] += 1
                self._pending.append(spec)
                self._cond.notify_all()
        else:
            self._seal_error_ids(spec.return_ids, RuntimeError(reason))
            if spec.streaming:
                self._fail_stream(spec, reason)
            self._release_lease_pins(spec.task_id)
            # a task that burned its whole retry budget is a post-mortem
            # moment: snapshot the flight recorder while the evidence
            # (events, spans, metrics) is still in the windows
            self._dump_crash_bundle(
                f"task-retries-exhausted-{spec.task_id[:8]}"
            )

    def _recover_object(
        self, object_id: str, dead_node: str, requeued: set
    ) -> None:
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                return
            entry.locations.discard(dead_node)
            if not self._object_lost_locked(entry):
                return
        self._reconstruct_object(
            object_id, f"node {dead_node} died", requeued=requeued
        )

    def _object_lost_locked(self, entry: _ObjEntry) -> bool:
        """A sealed value with no reachable copy. Caller holds self._lock.
        Entries still being produced (never sealed, no locations) are NOT
        lost — their creating lease is already in flight."""
        if entry.inline is not None or entry.error is not None:
            return False
        if entry.locations:
            return not any(
                nid in self.nodes and self.nodes[nid].alive
                for nid in entry.locations
            )
        return entry.event.is_set()

    def _note_reconstructing(self, object_id: str, depth: int) -> None:
        with self._lock:
            if object_id not in self._reconstructing:
                self._reconstructing[object_id] = (time.monotonic(), depth)

    def _reconstruct_object(
        self,
        object_id: str,
        reason: str,
        depth: int = 0,
        requeued: Optional[set] = None,
    ) -> None:
        """Recursive lineage reconstruction (the reference's
        ObjectRecoveryManager walk): requeue the lost object's creating
        lease — and, FIRST, the lineage of any of its inputs that are
        also lost, so the requeued lease's dependency wait resolves.
        Depth-bounded by ``cfg.reconstruction_max_depth``; attempt-bounded
        per lease by ``max_retries`` (``max_retries=0`` keeps strict
        at-most-once semantics: the object fails instead of re-executing);
        concurrent triggers for one object dedup through ``requeued`` and
        the already-pending check."""
        from ray_tpu_torch.core.object_store import ObjectLostError

        if requeued is None:
            requeued = set()
        max_depth = max(0, int(cfg.reconstruction_max_depth))
        if depth > max_depth:
            self._seal_error_ids(
                [object_id],
                ObjectLostError(
                    f"object {object_id} lost ({reason}); rebuilding it "
                    f"needs more than reconstruction_max_depth={max_depth} "
                    "generations of lineage re-execution"
                ),
            )
            return
        with self._cond:
            entry = self._objects.get(object_id)
            if entry is None or not self._object_lost_locked(entry):
                return
            entry.event.clear()  # getters park until the re-seal (or error)
            lease_id = entry.creating_lease
            spec = self._leases.get(lease_id) if lease_id else None
            pending_already = lease_id is not None and (
                lease_id in requeued
                or lease_id in self._in_flight
                or any(s.task_id == lease_id for s in self._pending)
                or any(s.task_id == lease_id for s in self._scheduling_batch)
                or any(
                    s.task_id == lease_id
                    for specs in self._deferred_rounds.values()
                    for s in specs
                )
            )
        if spec is None or spec.kind != "task":
            self._seal_error_ids(
                [object_id],
                ObjectLostError(
                    f"object {object_id} lost ({reason}); no re-executable "
                    "lineage (not produced by a plain task)"
                ),
            )
            return
        self._note_reconstructing(object_id, depth)
        if pending_already:
            # one rebuild of this lease re-seals every lost sibling
            # return; this trigger just joins the in-flight attempt
            return
        if spec.attempt >= spec.max_retries:
            why = (
                "max_retries=0 (at-most-once): refusing to re-execute"
                if spec.max_retries == 0
                else f"lineage retries exhausted ({spec.max_retries})"
            )
            self._seal_error_ids(
                [object_id],
                ObjectLostError(f"object {object_id} lost ({reason}); {why}"),
            )
            if spec.max_retries > 0:
                self._dump_crash_bundle(
                    f"lineage-retries-exhausted-{spec.task_id[:8]}"
                )
            return
        # lost INPUTS first: the requeued lease parks in dependency wait
        # until they re-seal, so their lineage must be re-executing too
        for arg in dict.fromkeys(spec.arg_ids):
            with self._lock:
                if arg in self._freed:
                    broken = True
                    arg_lost = False
                else:
                    broken = False
                    ae = self._objects.get(arg)
                    arg_lost = ae is not None and self._object_lost_locked(ae)
            if broken:
                # an input was already GC'd: the chain cannot re-execute
                self._seal_error_ids(
                    [object_id],
                    ObjectLostError(
                        f"object {object_id} lost ({reason}); lineage "
                        f"input {arg} was already freed"
                    ),
                )
                return
            if arg_lost:
                self._reconstruct_object(
                    arg,
                    f"lineage input of {object_id[:8]}",
                    depth=depth + 1,
                    requeued=requeued,
                )
        requeued.add(lease_id)
        logger.info(
            "reconstructing object %s (depth %d, attempt %d/%d): %s",
            object_id[:8],
            depth,
            spec.attempt + 1,
            spec.max_retries,
            reason,
        )
        spec.attempt += 1
        spec.target_node = None
        with self._cond:
            self._pending.append(spec)
            self._cond.notify_all()

    def _h_object_missing(self, req: dict) -> None:
        """A fetcher found an advertised copy definitively absent (the
        peer answered without the object — evicted, lost mid-spill, or a
        stale directory row): prune those locations, and if that was the
        last reachable copy, rebuild through lineage. Transient fetch
        failures never land here."""
        oid = req["object_id"]
        with self._lock:
            e = self._objects.get(oid)
            if e is None:
                return
            for nid in req.get("node_ids") or ():
                e.locations.discard(nid)
            lost = self._object_lost_locked(e)
        if lost:
            self._reconstruct_object(oid, "all advertised copies missing")

    def chaos_drop_objects(self, object_ids: List[str]) -> int:
        """Chaos fault: destroy every stored copy of the given sealed
        objects and drop their directory locations BEFORE driving
        recovery — so a chain dropped together exercises the recursive
        walk (an object whose inputs are also gone). Returns how many
        were actually dropped."""
        victims: List[Tuple[str, Any, str]] = []
        dropped: List[str] = []
        with self._lock:
            for oid in object_ids:
                e = self._objects.get(oid)
                if (
                    e is None
                    or e.inline is not None
                    or e.error is not None
                    or not e.locations
                ):
                    continue
                victims.extend(
                    (nid, self._clients.get(nid), oid)
                    for nid in list(e.locations)
                )
                e.locations.clear()
                dropped.append(oid)
        for nid, client, oid in victims:
            if client is not None:
                _best_effort(
                    client.call, "DeleteObjects", {"object_ids": [oid]}
                )
        requeued: set = set()
        for oid in dropped:
            self._reconstruct_object(oid, "<chaos drop>", requeued=requeued)
        return len(dropped)

    def chaos_drop_object(self, object_id: str) -> bool:
        """Single-object drop (see chaos_drop_objects). Returns False for
        objects that can't be meaningfully dropped (unknown,
        inline-valued, or never sealed)."""
        return self.chaos_drop_objects([object_id]) == 1

    def _restart_or_kill_actor(self, info: ActorInfo, reason: str) -> None:
        with self._lock:
            if info.state == "DEAD":
                return
            spec = self._actor_specs.get(info.actor_id)
            if spec is not None and info.num_restarts < info.max_restarts:
                info.num_restarts += 1
                info.state = "RESTARTING"
                info.node_id = None
                info.address = None
                restart = True
            else:
                info.state = "DEAD"
                restart = False
                # release the name so a replacement can rebind it
                if info.name and self._named_actors.get(info.name) == info.actor_id:
                    del self._named_actors[info.name]
                # death must out-survive a WAL'd registration, or recovery
                # resurrects a killed actor from the log
                self._wal(("actor_dead", info.actor_id))
            # wake WaitActor long-polls (push-based actor-state plane)
            self._cond.notify_all()
        self._wal_flush()
        self.mark_dirty()
        if not restart and spec is not None:
            # the actor is gone for good: its ctor args no longer need to
            # outlive it (the lifetime pin from _h_create_actor)
            self._release_lease_pins(spec.task_id)
        if restart:
            clone = LeaseRequest(
                task_id=new_id(),
                name=spec.name,
                payload=spec.payload,
                return_ids=[],
                resources=spec.resources,
                kind="actor_creation",
                actor_id=info.actor_id,
                max_retries=0,
                strategy=spec.strategy,
                runtime_env=spec.runtime_env,
                # the new agent reports the name, restart budget, lifetime
                # and owner back to a head that lost its tables
                actor_meta=spec.actor_meta,
            )
            with self._cond:
                self._pending.append(clone)
                self._cond.notify_all()
        else:
            logger.info("actor %s is dead: %s", info.actor_id, reason)

    # ------------------------------------------------------------------
    # object directory (ownership_object_directory + memory store analog)
    # ------------------------------------------------------------------
    def _entry(self, object_id: str) -> _ObjEntry:
        with self._lock:
            return self._objects.setdefault(object_id, _ObjEntry())

    def _apply_seals(self, seals: List[SealInfo]) -> None:
        check: List[str] = []
        stale: List[Tuple[str, str]] = []  # (node_id, object_id)
        with self._cond:
            for s in seals:
                if s.object_id in self._freed:
                    # every handle died before this seal/re-advertisement
                    # landed: the advertising node's copy must still be
                    # deleted or its shm leaks
                    if not s.is_error and s.node_id:
                        stale.append((s.node_id, s.object_id))
                    continue
                e = self._objects.setdefault(s.object_id, _ObjEntry())
                if s.owner and not e.owner_registered:
                    # direct-call return object: the caller is its holder
                    # (no lease ever registered one). Guarded: seal reports
                    # are at-least-once (worker retries on transport blips)
                    # and a fallback lease may also register the owner —
                    # counting twice would leak the object forever.
                    e.owner_registered = True
                    self._add_holder(s.object_id, s.owner)
                if s.is_error:
                    e.error = s.error
                else:
                    if s.inline_value is not None:
                        e.inline = s.inline_value
                    e.locations.add(s.node_id)
                    e.size = s.size
                    if s.contained_ids and not e.contained:
                        # nested-ref pinning: only the original seal carries
                        # contained ids (peer-fetch re-advertisements don't)
                        e.contained = list(s.contained_ids)
                        for inner in e.contained:
                            self._pin(inner)
                e.event.set()
                rec = self._reconstructing.pop(s.object_id, None)
                if rec is not None and not s.is_error:
                    t0, rec_depth = rec
                    RECONSTRUCTION_MS.observe((time.monotonic() - t0) * 1e3)
                    OBJECTS_RECONSTRUCTED.inc(
                        labels={"depth": str(rec_depth)}
                    )
                check.append(s.object_id)
            self._cond.notify_all()
        for nid, oid in stale:
            client = self._clients.get(nid)
            if client is not None:
                self._dispatch_pool.submit(
                    _best_effort,
                    client.call,
                    "DeleteObjects",
                    {"object_ids": [oid]},
                )
        # a seal may land after the last holder left: free immediately
        self._maybe_free_many(check)

    def _finish_leases(self, lease_ids: List[str]) -> None:
        unpin: List[str] = []
        with self._cond:
            for lid in lease_ids:
                self._in_flight.pop(lid, None)
                self.metrics["leases_finished"] += 1
                spec = self._leases.get(lid)
                if spec is not None:
                    self.events.record(
                        lid, spec.name, "FINISHED", **_trace_args(spec)
                    )
                # a restartable actor's ctor args stay pinned for the actor's
                # lifetime (lineage for restarts); released when it dies
                if spec is None or spec.kind != "actor_creation":
                    unpin.append(lid)
            # completed leases freed resources somewhere: notify the
            # scheduler loop, whose capacity-capped unpark retries parked
            # work. Draining the WHOLE parked queue here
            # re-scheduled every parked spec on every completion batch —
            # O(parked²) churn that halved e2e throughput under a deep
            # backlog.
            self._pgs_dirty = True
            self._cond.notify_all()
        for lid in unpin:
            self._release_lease_pins(lid)

    def _h_report_seals(self, req: dict) -> None:
        node_id = req.get("node_id")
        if node_id and req.get("available") is not None:
            with self._lock:
                node = self.nodes.get(node_id)
                if node is not None and node.alive:
                    self.view.update_available(node_id, req["available"])
        # metrics federation: typed registry deltas piggybacking on the
        # coalesced report (agent's own + its workers', pre-labeled)
        for ent in req.get("metrics", ()):
            try:
                self.federation.apply(
                    ent.get("node", node_id or ""),
                    ent.get("role", "agent"),
                    ent.get("records", ()),
                )
            except Exception:  # noqa: BLE001 - a bad record must not
                logger.exception("metrics federation apply failed")
        # borrows must land before the finished-lease unpin below: the pin is
        # what keeps a borrowed arg alive until its borrow is on the books
        if req.get("borrows"):
            self._apply_borrows(req["borrows"])
        self._apply_seals(req.get("seals", []))
        # stream entries AFTER their seals (same report): an item is only
        # announced once its object is resolvable
        if req.get("stream"):
            self._apply_stream_items(req["stream"])
        if req.get("stream_done"):
            self._apply_stream_done(req["stream_done"])
        if req.get("finished"):
            self._finish_leases(req["finished"])
        for holder in req.get("holders_gone", []):
            self._drop_holder(holder)
        for fail in req.get("failed", []):
            with self._cond:
                item = self._in_flight.pop(fail["task_id"], None)
            spec = item[0] if item else self._leases.get(fail["task_id"])
            if spec is None:
                continue
            if spec.task_id in self._cancelled_leases:
                self._cancelled_leases.discard(spec.task_id)
                continue  # force-cancel kill: already sealed cancelled
            preempted = spec.task_id in self._preempted_leases
            if preempted:
                # preemption kill (migration): a scheduler action, not a
                # task failure — requeue with NO retry attempt burned;
                # the next round places it on a different node
                with self._cond:
                    self._preempted_leases.discard(spec.task_id)
                    self.metrics["leases_spilled_back"] += 1
                    spec.target_node = None
                    self._pending.append(spec)
                    self._cond.notify_all()
                continue
            if fail.get("requeue"):
                # contention spillback: back to the queue, no retry burned
                with self._cond:
                    self.metrics["leases_spilled_back"] += 1
                    spec.target_node = None
                    self._pending.append(spec)
                    self._cond.notify_all()
                continue
            if fail.get("retryable", True):
                self._retry_or_fail(spec, fail.get("reason", "worker failure"))
            else:
                self._seal_error_ids(
                    spec.return_ids,
                    RuntimeError(fail.get("reason", "worker failure")),
                )
        for miss in req.get("objects_missing", ()):
            self._h_object_missing(miss)
        if req.get("task_leases"):
            self._apply_task_lease_reports(req["task_leases"])
        if req.get("peer_links"):
            # renew-while-hot: ids of links this agent used recently,
            # piggybacked on the coalesced report (no dedicated RPC)
            self._renew_peer_links(req["peer_links"])
        for actor_ready in req.get("actors_alive", []):
            self._mark_actor_alive(**actor_ready)
        for actor_dead in req.get("actors_dead", []):
            info = self._actors.get(actor_dead["actor_id"])
            if info is not None:
                self._restart_or_kill_actor(info, actor_dead.get("reason", ""))

    # ------------------------------------------------------------------
    # streaming generators (object_ref_generator.py analog)
    # ------------------------------------------------------------------
    def _stream_state(self, task_id: str) -> dict:
        """Caller holds self._stream_cv."""
        st = self._streams.get(task_id)
        if st is None:
            st = self._streams[task_id] = {
                "items": [],
                "done": False,
                "consumed": 0,
                "delivered": 0,  # holder-registration watermark
                "touched": time.monotonic(),
            }
        return st

    def _tombstone_stream(self, task_id: str) -> None:
        """Caller holds self._stream_cv."""
        if task_id not in self._stream_tombstones:
            self._stream_tombstones.add(task_id)
            self._stream_tombstone_order.append(task_id)
            while len(self._stream_tombstone_order) > 4096:
                self._stream_tombstones.discard(
                    self._stream_tombstone_order.popleft()
                )

    def _apply_stream_items(self, items: List[dict]) -> None:
        with self._stream_cv:
            for it in items:
                st = self._stream_state(it["task_id"])
                idx = it["index"]
                if idx == len(st["items"]):
                    st["items"].append(it["object_id"])
                # idx < len: a retried executor re-announced an item —
                # the re-seal already refreshed its location; nothing to do
                st["touched"] = time.monotonic()
            self._stream_cv.notify_all()
        self._mark_hot_dirty()  # stream state rides the debounced snapshot

    def _apply_stream_done(self, dones: List[dict]) -> None:
        with self._stream_cv:
            for d in dones:
                st = self._stream_state(d["task_id"])
                err = d.get("error")
                if err is not None and not st["done"]:
                    # mid-stream task failure: the next ref raises
                    oid = stream_item_id(d["task_id"], len(st["items"]))
                    self._apply_seals(
                        [
                            SealInfo(
                                object_id=oid,
                                node_id="",
                                is_error=True,
                                error=err,
                            )
                        ]
                    )
                    st["items"].append(oid)
                st["done"] = True
                st["touched"] = time.monotonic()
            self._stream_cv.notify_all()
        self._mark_hot_dirty()

    def _fail_stream(self, spec: LeaseRequest, reason: str) -> None:
        """Lease-level failure (worker/node death, retries exhausted)."""
        import pickle as _pickle

        self._apply_stream_done(
            [
                {
                    "task_id": spec.task_id,
                    "error": _pickle.dumps(RuntimeError(reason)),
                }
            ]
        )

    def _h_wait_stream(self, req: dict) -> dict:
        """Consumer long-poll for items past ``after``; ``after`` is also
        the consumption watermark that frees the executor's backpressure
        window (StreamConsumed)."""
        task_id = req["task_id"]
        after = int(req.get("after", 0))
        deadline = time.monotonic() + min(float(req.get("timeout", 2.0)), 30.0)
        with self._stream_cv:
            if task_id in self._stream_tombstones:
                # drained or GC'd: definitively over
                return {"items": [], "done": True}
            st = self._streams.get(task_id)
            if st is None:
                # not yet known: the pipelined lease submission (or the
                # first item) may still be in flight — wait for it
                while st is None:
                    wait_s = deadline - time.monotonic()
                    if wait_s <= 0:
                        return {"items": [], "done": False}
                    self._stream_cv.wait(timeout=min(wait_s, 0.5))
                    if task_id in self._stream_tombstones:
                        return {"items": [], "done": True}
                    st = self._streams.get(task_id)
            st["consumed"] = max(st["consumed"], after)
            st["touched"] = time.monotonic()
            self._stream_cv.notify_all()  # executor credit poll may wait
            while len(st["items"]) <= after and not st["done"]:
                wait_s = deadline - time.monotonic()
                if wait_s <= 0:
                    return {"items": [], "done": False}
                self._stream_cv.wait(timeout=min(wait_s, 0.5))
            items = st["items"][after:]
            done = st["done"]
            # holder registration is watermarked so an at-least-once
            # retried WaitStream can't double-count the consumer
            holder = req.get("holder")
            fresh = (
                st["items"][st["delivered"]:] if holder else []
            )
            st["delivered"] = max(st["delivered"], len(st["items"]))
            if done and st["consumed"] >= len(st["items"]) and not items:
                # fully drained: the generator saw StopIteration
                self._streams.pop(task_id, None)
                self._tombstone_stream(task_id)
        if fresh:
            # the consumer holds live refs the moment the reply lands;
            # count it as holder BEFORE replying so nothing frees the
            # items in between
            with self._lock:
                for oid in fresh:
                    self._add_holder(oid, holder)
        return {"items": items, "done": done}

    def _h_stream_consumed(self, req: dict) -> dict:
        """Executor credit poll. Long-polls until the consumer watermark
        moves past ``after_consumed`` (or the stream is abandoned) so a
        backpressured executor parks one request instead of spinning
        20 RPC/s through its agent."""
        after = req.get("after_consumed")
        deadline = time.monotonic() + min(
            float(req.get("timeout", 0.0) or 0.0), 30.0
        )
        with self._stream_cv:
            while True:
                st = self._streams.get(req["task_id"])
                if st is None:
                    # unknown/GC'd: report infinite credit so the executor
                    # can finish (its items free through normal GC)
                    return {"consumed": 1 << 62, "abandoned": True}
                if st.get("abandoned"):
                    return {"consumed": 1 << 62, "abandoned": True}
                if after is None or st["consumed"] > after:
                    return {"consumed": st["consumed"], "abandoned": False}
                wait_s = deadline - time.monotonic()
                if wait_s <= 0:
                    return {"consumed": st["consumed"], "abandoned": False}
                self._stream_cv.wait(timeout=min(wait_s, 0.5))

    def _h_stream_abandon(self, req: dict) -> None:
        """Best-effort consumer-drop notice (ObjectRefGenerator.__del__):
        opens the executor's window so it can't wedge on backpressure,
        and makes the stream eligible for idle GC."""
        with self._stream_cv:
            st = self._streams.get(req["task_id"])
            if st is not None:
                st["abandoned"] = True
                st["done"] = True  # idle GC reclaims it
                st["touched"] = time.monotonic() - 0.0
                self._stream_cv.notify_all()

    def _gc_idle_streams(self) -> None:
        """Abandoned finished streams: drop state after cfg.stream_idle_gc_s
        (their sealed items remain normal ref-counted objects; the
        submitting client's holds release through the usual paths)."""
        ttl = cfg.stream_idle_gc_s
        now = time.monotonic()
        undelivered: List[str] = []
        with self._stream_cv:
            dead = [
                tid
                for tid, st in self._streams.items()
                if st["done"] and now - st["touched"] > ttl
            ]
            for tid in dead:
                st = self._streams.pop(tid)
                self._tombstone_stream(tid)
                undelivered.extend(st["items"][st["delivered"]:])
        if undelivered:
            # never-delivered items have no holder (delivery is what
            # registers the consumer); mark tracked so the normal free
            # path reclaims them
            with self._lock:
                for oid in undelivered:
                    e = self._objects.get(oid)
                    if e is not None:
                        e.tracked = True
            self._maybe_free_many(undelivered)

    def _seal_error_ids(
        self,
        object_ids: List[str],
        exc: BaseException,
        keep_for_owner: bool = False,
    ) -> None:
        """Seal error values. ``keep_for_owner`` is the owner-death mode:
        already-produced values win over the error (the reap only fails
        UNproduced objects) and the sealed error entry is made GC-exempt
        so the typed OwnerDiedError outlives the dead owner's holder drop
        (bounded: one small pickled exception per unproduced object)."""
        blob = pickle.dumps(exc)
        with self._cond:
            for oid in object_ids:
                if oid in self._freed:
                    continue
                e = self._objects.setdefault(oid, _ObjEntry())
                if keep_for_owner:
                    if e.event.is_set() and e.error is None:
                        continue  # produced before the owner died
                    e.tracked = False
                e.error = blob
                e.event.set()
                # a failed rebuild ends the reconstruction attempt (no
                # success metric)
                self._reconstructing.pop(oid, None)
            self._cond.notify_all()
        if not keep_for_owner:
            self._maybe_free_many(object_ids)

    def _h_put_object(self, req: dict) -> dict:
        """Driver put: small values inline at the head; large ones are
        forwarded into a node's shared-memory store."""
        object_id, data = req["object_id"], req["data"]
        e = self._entry(object_id)
        holder = req.get("holder")
        with self._lock:
            # owner registration is once-only: an owner-held direct result
            # uploaded here may race a worker's fallback seal (push timed
            # out but actually delivered) — counting the owner twice would
            # leak the object forever
            if holder and not e.owner_registered:
                e.owner_registered = True
                self._add_holder(object_id, holder)
            for inner in req.get("contained_ids", ()):
                if inner not in e.contained:
                    e.contained.append(inner)
                    self._pin(inner)
        if len(data) <= INLINE_OBJECT_MAX:
            e.inline = data
            e.size = len(data)
            e.event.set()
            return {"where": "inline"}
        with self._lock:
            targets = [
                (nid, self._clients[nid])
                for nid, n in self.nodes.items()
                if n.alive
            ]
        for nid, client in targets:
            try:
                client.call(
                    "StoreObject", {"object_id": object_id, "data": data}
                )
                e.locations.add(nid)
                e.size = len(data)
                e.event.set()
                return {"where": nid}
            except RpcError:
                continue
        # no live nodes: keep it inline regardless of size
        e.inline = data
        e.size = len(data)
        e.event.set()
        return {"where": "inline"}

    def _freed_reply(self, object_id: str) -> dict:
        from ray_tpu_torch.core.object_store import ObjectLostError

        return {
            "status": "error",
            "error": pickle.dumps(
                ObjectLostError(
                    f"object {object_id} was freed (all references "
                    "dropped or explicitly freed)"
                )
            ),
        }

    def _sealed_reply(self, e: _ObjEntry) -> dict:
        """Reply for a sealed entry. Caller holds self._lock."""
        if e.error is not None:
            return {"status": "error", "error": e.error}
        if e.inline is not None:
            return {"status": "inline", "data": e.inline}
        locs = [
            (nid, self.nodes[nid].address)
            for nid in e.locations
            if nid in self.nodes and self.nodes[nid].alive
        ]
        if not locs:
            return {"status": "pending"}  # recovery in progress
        return {"status": "located", "locations": locs}

    def _h_locate_objects(self, req: dict) -> Dict[str, List[str]]:
        """Non-blocking batched location lookup from the object directory
        (ray.experimental.get_object_locations analog) — locality-ranked
        dispatch in the Data actor pools rides this."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            for oid in req["object_ids"]:
                e = self._objects.get(oid)
                out[oid] = sorted(e.locations) if e is not None else []
        return out

    def _h_object_sizes(self, req: dict) -> Dict[str, int]:
        """Sealed sizes from the directory (0 = unknown/unsealed); the
        Data executor samples these to calibrate its byte budget."""
        out: Dict[str, int] = {}
        with self._lock:
            for oid in req["object_ids"]:
                e = self._objects.get(oid)
                out[oid] = int(e.size) if e is not None else 0
        return out

    def _h_wait_object(self, req: dict) -> dict:
        """Long-poll for availability (pubsub long-poll analog,
        src/ray/pubsub/)."""
        if req["object_id"] in self._freed:
            return self._freed_reply(req["object_id"])
        e = self._entry(req["object_id"])
        t = req.get("timeout")
        timeout = min(2.0 if t is None else t, 10.0)
        if not e.event.wait(timeout):
            return {"status": "pending"}
        with self._lock:
            return self._sealed_reply(e)

    def _h_wait_object_batch(self, req: dict) -> List[dict]:
        """Batched long-poll: resolve many object ids in one RPC (the
        client's list-get path — one message instead of one per ref,
        matching the reference's batched plasma Get)."""
        ids = req["object_ids"]
        t = req.get("timeout")
        deadline = time.monotonic() + min(2.0 if t is None else t, 10.0)
        replies: Dict[str, dict] = {}
        with self._cond:
            while True:
                for oid in ids:
                    if oid in replies and replies[oid]["status"] != "pending":
                        continue
                    if oid in self._freed:
                        replies[oid] = self._freed_reply(oid)
                        continue
                    e = self._objects.setdefault(oid, _ObjEntry())
                    if e.event.is_set():
                        replies[oid] = self._sealed_reply(e)
                    else:
                        replies[oid] = {"status": "pending"}
                unresolved = sum(
                    1 for r in replies.values() if r["status"] == "pending"
                )
                now = time.monotonic()
                # ray.wait semantics: return as soon as num_returns distinct
                # ids resolved (default: all of them)
                want = req.get("num_returns") or len(set(ids))
                if len(set(ids)) - unresolved >= want or now >= deadline:
                    break
                # seals notify _cond (_apply_seals), so this wakes promptly
                self._cond.wait(timeout=min(0.25, deadline - now))
        return [replies[oid] for oid in ids]

    def _h_free_objects(self, req: dict) -> None:
        """Manual force-free (internal_api.free analog): zero the holder
        counts and let the normal free path cascade (contained pins,
        lineage release, per-node deletes)."""
        ids = req["object_ids"]
        with self._lock:
            for oid in ids:
                e = self._objects.get(oid)
                if e is None:
                    continue
                for holder in list(e.holders):
                    hx = self._holder_hexes.get(holder)
                    if hx is not None:
                        hx.discard(oid)
                e.holders.clear()
                e.pins = 0
                # an explicit free overrides the untracked-entry GC
                # exemption (entries whose refcount state predates a head
                # restart are still force-freeable)
                e.tracked = True
        self._maybe_free_many(ids)

    # ------------------------------------------------------------------
    # distributed refcounting (reference_counter.h:44 analog; centralized
    # at the head instead of the reference's per-owner borrow protocol)
    # ------------------------------------------------------------------
    def _add_holder(self, oid: str, holder: str) -> None:
        """Count one hold of ``oid`` by process ``holder``. Caller holds
        self._lock."""
        e = self._objects.setdefault(oid, _ObjEntry())
        e.holders[holder] = e.holders.get(holder, 0) + 1
        e.tracked = True
        self._holder_hexes.setdefault(holder, set()).add(oid)

    def _pin(self, oid: str) -> None:
        """Pin ``oid`` (lease arg / containing object). Caller holds
        self._lock."""
        e = self._objects.setdefault(oid, _ObjEntry())
        e.pins += 1
        e.tracked = True

    def _h_ref_update(self, req: dict, src: str = "batch") -> None:
        """Client/worker holder-count deltas: ``increfs`` are synchronous
        borrow registrations (sent while the borrowed id is still pinned by
        its outer object or lease), ``decrefs`` are 1→0 instance-count
        releases from a process."""
        holder = req["holder"]
        to_check: List[str] = []
        with self._lock:
            for oid in req.get("increfs", ()):
                if oid in self._freed:
                    continue
                self._add_holder(oid, holder)
            for oid in req.get("decrefs", ()):
                logger.debug("decref %s by %s via %s", oid[:8], holder, src)
                if oid in self._freed:
                    continue
                # a decref can overtake its matching registration across
                # channels (worker decref via agent vs pipelined lease):
                # record the negative so the late registration nets to zero
                e = self._objects.setdefault(oid, _ObjEntry())
                c = e.holders.get(holder, 0) - 1
                if c == 0:
                    e.holders.pop(holder, None)
                else:
                    e.holders[holder] = c
                hx = self._holder_hexes.get(holder)
                if hx is not None:
                    hx.discard(oid)
                to_check.append(oid)
        self._maybe_free_many(to_check)

    def _register_return_holder(self, spec: LeaseRequest) -> None:
        holder = spec.client_id
        with self._lock:
            for oid in spec.return_ids:
                e = self._objects.setdefault(oid, _ObjEntry())
                if e.error is not None and spec.attempt > 0:
                    # owner-side lineage resubmission of a LOST object:
                    # the stale loss error must not shadow the rebuild —
                    # getters park until the re-seal lands
                    e.error = None
                    e.event.clear()
                e.creating_lease = spec.task_id
                e.tracked = True
                if holder and not e.owner_registered:
                    logger.debug("register %s holder %s", oid[:8], holder)
                    e.owner_registered = True
                    self._add_holder(oid, holder)
            if spec.return_ids:
                self._lease_live_returns[spec.task_id] = len(spec.return_ids)
            if spec.arg_ids:
                self._lease_arg_pins[spec.task_id] = list(spec.arg_ids)
                for oid in spec.arg_ids:
                    self._pin(oid)

    def _release_lease_pins(self, task_id: str) -> None:
        """The lease finished (or failed for good): its args no longer need
        to outlive it (LeaseDependencyManager unpin analog)."""
        with self._lock:
            args = self._lease_arg_pins.pop(task_id, None)
            if not args:
                return
            for oid in args:
                e = self._objects.get(oid)
                if e is not None:
                    e.pins -= 1
        self._maybe_free_many(args)

    def _apply_borrows(self, borrows: List[dict]) -> None:
        """A worker finished a task still holding some of its args (stored
        them in actor state): transfer the lease pin into a holder count
        before the pin is released."""
        with self._lock:
            for b in borrows:
                holder = b["holder"]
                for oid in b.get("object_ids", ()):
                    if oid in self._freed:
                        continue
                    self._add_holder(oid, holder)

    def _drop_holder(self, holder: str) -> None:
        """A process died: forget every count it held."""
        with self._lock:
            hexes = list(self._holder_hexes.pop(holder, ()))
            for oid in hexes:
                e = self._objects.get(oid)
                if e is not None:
                    e.holders.pop(holder, None)
        self._maybe_free_many(hexes)

    def _maybe_free_many(self, oids) -> None:
        """Free every listed object whose counts/pins are exhausted, then
        cascade through contained refs and lineage releases."""
        work = list(oids or ())
        deletes: Dict[str, List[str]] = {}  # node -> object ids
        freed_leases: List[str] = []
        with self._lock:
            while work:
                oid = work.pop()
                e = self._objects.get(oid)
                if (
                    e is None
                    or not e.tracked
                    or not e.event.is_set()
                    or e.pins > 0
                    or any(c > 0 for c in e.holders.values())
                ):
                    continue
                logger.debug(
                    "GC free %s holders=%s pins=%s", oid[:8], e.holders, e.pins
                )
                del self._objects[oid]
                self._freed.add(oid)
                for nid in e.locations:
                    deletes.setdefault(nid, []).append(oid)
                for inner in e.contained:
                    ie = self._objects.get(inner)
                    if ie is not None:
                        ie.pins -= 1
                        work.append(inner)
                lid = e.creating_lease
                if lid is not None and lid in self._lease_live_returns:
                    self._lease_live_returns[lid] -= 1
                    if self._lease_live_returns[lid] <= 0:
                        del self._lease_live_returns[lid]
                        freed_leases.append(lid)
            # lineage release: all outputs of these leases are gone — the
            # spec (and the arg refs its payload pins) can go too
            for lid in freed_leases:
                self._leases.pop(lid, None)
            if freed_leases:
                self._persist_dirty = True  # lineage shrank
            clients = {
                nid: self._clients.get(nid)
                for nid in deletes
                if self.nodes.get(nid) is not None
            }
        for nid, ids in deletes.items():
            client = clients.get(nid)
            if client is not None:
                self._dispatch_pool.submit(
                    _best_effort,
                    client.call,
                    "DeleteObjects",
                    {"object_ids": ids},
                )

    # ------------------------------------------------------------------
    # lease intake + the batched scheduler
    # ------------------------------------------------------------------
    def _h_submit_lease(self, spec: LeaseRequest) -> dict:
        # reconstruction-class resubmissions (attempt > 0: owner-side
        # lineage rebuilds, at-least-once redeliveries) dedup by task_id —
        # one rebuild re-seals every getter's wait; first submissions
        # (the hot path) skip the scan entirely
        if spec.attempt > 0:
            with self._cond:
                if spec.task_id in self._in_flight or any(
                    s.task_id == spec.task_id
                    for q in (
                        self._pending,
                        self._scheduling_batch,
                        # dispatched-but-uncompleted pipelined rounds hold
                        # specs no other queue shows
                        *self._deferred_rounds.values(),
                    )
                    for s in q
                ):
                    return {"queued": True, "dedup": True}
        self._register_return_holder(spec)
        if spec.streaming:
            # the stream exists from submission: a consumer's WaitStream
            # can land before the first item (or even before dispatch)
            with self._stream_cv:
                self._stream_state(spec.task_id)
                self._stream_cv.notify_all()
        with self._cond:
            self._leases[spec.task_id] = spec
            self.metrics["leases_submitted"] += 1
            self._pending.append(spec)
            self._cond.notify_all()
        self.events.record(
            spec.task_id, spec.name, "SUBMITTED", **_trace_args(spec)
        )
        # lineage rides the debounced snapshot (no WAL: too hot per-lease)
        if spec.kind == "task" and spec.return_ids:
            self._mark_hot_dirty()
        return {"queued": True}

    def _h_client_batch(self, items: List[tuple]) -> None:
        """Pipelined client control stream: ordered lease submissions,
        refcount updates, and actor create/kill coalesced into one RPC
        (see client._PipelinedSender). Actor churn riding the pipeline is
        the control-plane fast path: the driver never blocks a creation
        behind a loaded head's reply, and create→kill order is preserved
        by the single queue."""
        for kind, payload in items:
            if kind == "lease":
                self._h_submit_lease(payload)
            elif kind == "ref":
                self._h_ref_update(payload)
            elif kind == "create_actor":
                # swallowed, not re-raised: the sender retries a failed
                # ClientBatch forever, so one poison creation must not
                # wedge every lease queued behind it (unnamed creations
                # have no name-taken failure mode; anything else here is
                # a bug surfaced via head_dropped_callbacks)
                _best_effort(self._h_create_actor, payload)
            elif kind == "kill_actor":
                _best_effort(self._h_kill_actor, payload)
            elif kind == "lease_renew":
                _best_effort(self._h_lease_renew, payload)
            elif kind == "lease_return":
                _best_effort(self._h_lease_return, payload)
            elif kind == "owner_beat":
                _best_effort(self._h_owner_beat, payload)

    # ------------------------------------------------------------------
    # task leases (lease-cached direct dispatch): the head schedules
    # LEASE GRANTS through the same batched kernel that places tasks —
    # a worker_lease spec rides the pending queue, the kernel picks its
    # node, the agent allocates the shape + pins a worker, and the
    # activation report closes the loop back to the waiting owner. From
    # then on the owner streams same-shape tasks straight to the leased
    # worker; the head only sees renewals, the eventual return, and the
    # batched seal reports that keep its object directory authoritative.
    # ------------------------------------------------------------------
    def _h_grant_task_lease(self, req: dict) -> dict:
        """Owner requests a cacheable worker lease for a task shape.
        Long-polls until the grant activates (or the window closes — the
        owner keeps using the per-task head path and may retry)."""
        if not cfg.task_leases:
            return {"granted": False, "reason": "task leases disabled"}
        # bound concurrent grant long-polls: each occupies an RPC server
        # thread for up to its window, and a burst of cold shapes against
        # a full cluster must not starve ReportSeals/ClientBatch/renewal
        # traffic out of the pool — rejected grants fail fast and the
        # owner's cooldown retries later
        if not self._grant_gate.acquire(blocking=False):
            return {"granted": False, "reason": "grant queue full"}
        try:
            return self._grant_task_lease_inner(req)
        finally:
            self._grant_gate.release()

    def _grant_task_lease_inner(self, req: dict) -> dict:
        resources = dict(req.get("resources") or {})
        lease_id = new_id()
        ttl = cfg.task_lease_ttl_s
        spec = LeaseRequest(
            task_id=lease_id,
            name=f"worker_lease:{(req.get('fn_id') or '')[:8]}",
            payload=b"",
            return_ids=[],
            resources=resources,
            kind="worker_lease",
            max_retries=0,
            client_id=req.get("client_id", ""),
        )
        with self._cond:
            self._task_leases[lease_id] = {
                "lease_id": lease_id,
                "state": "granting",
                "resources": resources,
                "client_id": spec.client_id,
                "fn_id": req.get("fn_id", ""),
                "node_id": None,
                "worker_address": None,
                "worker_id": None,
                "accel_env": None,
                "expires_at": time.monotonic() + max(3.0 * ttl, 15.0),
                "abandoned": False,
            }
            self._leases[lease_id] = spec
            self._pending.append(spec)
            self._cond.notify_all()
        deadline = time.monotonic() + min(
            float(req.get("timeout") or 10.0), 30.0
        )
        with self._cond:
            while True:
                e = self._task_leases.get(lease_id)
                if e is None:
                    return {
                        "granted": False,
                        "reason": "grant failed (no worker available)",
                    }
                if e["state"] == "active":
                    return {
                        "granted": True,
                        "lease_id": lease_id,
                        "node_id": e["node_id"],
                        "worker_address": e["worker_address"],
                        "accel_env": e["accel_env"],
                        "max_inflight": int(cfg.task_lease_max_inflight),
                        "ttl_s": float(ttl),
                    }
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # still queued/in flight: mark abandoned — the
                    # dispatch-time filter drops it if unplaced, and a
                    # late activation is released straight back
                    e["abandoned"] = True
                    self._cancelled_leases.add(lease_id)
                    return {
                        "granted": False,
                        "reason": "grant timed out (no capacity)",
                    }
                self._cond.wait(remaining)

    def _apply_task_lease_reports(self, reports: List[dict]) -> None:
        """Agent-side grant activations and losses (ReportSeals
        ``task_leases`` entries)."""
        for tl in reports:
            lease_id = tl["lease_id"]
            release_node = None
            with self._cond:
                e = self._task_leases.get(lease_id)
                if not tl.get("ok"):
                    # grant failed agent-side, or the leased worker died
                    if e is not None:
                        was_active = e["state"] == "active"
                        self._drop_task_lease_locked(lease_id)
                        if was_active or tl.get("lost"):
                            self.metrics["task_leases_revoked"] += 1
                            TASK_LEASE_REVOKED.inc()
                    self._cond.notify_all()
                elif e is None or e.get("abandoned"):
                    # nobody is waiting for this grant anymore (owner
                    # timed out / head restarted): release it right back
                    self._drop_task_lease_locked(lease_id)
                    release_node = tl.get("node_id")
                else:
                    e.update(
                        state="active",
                        node_id=tl.get("node_id"),
                        worker_address=tl.get("worker_address"),
                        worker_id=tl.get("worker_id"),
                        accel_env=tl.get("accel_env"),
                        expires_at=time.monotonic()
                        + max(3.0 * cfg.task_lease_ttl_s, 15.0),
                        abandoned=False,
                    )
                    self.metrics["task_leases_granted"] += 1
                    TASK_LEASE_GRANTED.inc()
                    self._wal(("task_lease", self._lease_snapshot_row(e)))
                    self._cond.notify_all()
            self._wal_flush()
            if release_node is not None:
                self._agent_return_lease(release_node, lease_id)

    @staticmethod
    def _lease_snapshot_row(e: dict) -> dict:
        """Durable slice of a lease row (monotonic expiry rebased on
        load)."""
        row = {
            k: e[k]
            for k in (
                "lease_id",
                "resources",
                "client_id",
                "fn_id",
                "node_id",
                "worker_address",
                "worker_id",
                "accel_env",
            )
        }
        row["ttl_remaining_s"] = max(
            0.0, e["expires_at"] - time.monotonic()
        )
        return row

    def _drop_task_lease_locked(self, lease_id: str) -> Optional[dict]:
        """Forget a lease everywhere. Caller holds self._lock."""
        e = self._task_leases.pop(lease_id, None)
        self._in_flight.pop(lease_id, None)
        self._leases.pop(lease_id, None)
        if e is not None:
            self._wal(("task_lease_gone", lease_id))
        return e

    def _agent_return_lease(self, node_id: str, lease_id: str) -> None:
        self._queue_revoke(
            "ReturnWorkerLease", node_id, {"lease_id": lease_id}
        )

    # ------------------------------------------------------------------
    # durable revocation fan-out: every agent-bound revoke (worker-lease
    # returns, peer-link revokes) is WAL-recorded BEFORE the send and
    # cleared only after delivery. A dying leader's best-effort sends
    # used to race the standby's rebuild; now the successor re-drives
    # whatever is still pending — the receivers are idempotent, so a
    # duplicate delivery is a no-op.
    # ------------------------------------------------------------------
    def _queue_revoke(self, method: str, node_id: str, payload: dict) -> None:
        rid = new_id()
        row = {
            "revoke_id": rid,
            "method": method,
            "node_id": node_id,
            "payload": payload,
            "queued_at": time.time(),
            "attempted_at": time.monotonic(),
        }
        with self._lock:
            if self._fenced:
                return  # deposed: the new leader drives its own revokes
            self._pending_revokes[rid] = row
            self._wal(("revoke_pending", dict(row)))
        self._wal_flush()
        try:
            self._dispatch_pool.submit(_best_effort, self._drive_revoke, rid)
        except RuntimeError:
            pass  # pool closed (shutdown); the record re-drives elsewhere

    def _drive_revoke(self, rid: str) -> None:
        with self._lock:
            row = self._pending_revokes.get(rid)
            if row is None or self._fenced:
                return
            client = self._clients.get(row["node_id"])
        if client is None:
            return  # node not (re-)registered yet: re-driven when it is
        try:
            # closed revoke-kind set, dispatched through literal call
            # sites (the static rpc-table check sees them; a new kind
            # must be added here deliberately)
            if row["method"] == "ReturnWorkerLease":
                client.call(
                    "ReturnWorkerLease",
                    dict(row["payload"]),
                    timeout=10.0,
                    retries=2,
                )
            elif row["method"] == "RevokePeerLink":
                client.call(
                    "RevokePeerLink",
                    dict(row["payload"]),
                    timeout=10.0,
                    retries=2,
                )
            else:
                raise ValueError(
                    f"unknown revoke kind {row['method']!r}"
                )
        except Exception:  # noqa: BLE001 - stays pending; re-driven later
            HEAD_DROPPED_CALLBACKS.inc(
                labels={"callable": f"revoke:{row['method']}"}
            )
            logger.debug(
                "revoke %s to %s not delivered; re-driving later",
                row["method"],
                row["node_id"],
                exc_info=True,
            )
            return
        with self._lock:
            if self._pending_revokes.pop(rid, None) is not None:
                self._wal(("revoke_done", rid))
        self._wal_flush()

    def _redrive_revokes(self, node_id: Optional[str] = None) -> None:
        """Re-send pending revokes (all, or one re-registering node's) —
        the promotion/restart path that replaces trusting a dead
        leader's last best-effort breaths."""
        with self._lock:
            rids = [
                rid
                for rid, row in self._pending_revokes.items()
                if node_id is None or row["node_id"] == node_id
            ]
        for rid in rids:
            try:
                self._dispatch_pool.submit(
                    _best_effort, self._drive_revoke, rid
                )
            except RuntimeError:
                return

    def _expire_pending_revokes(self) -> None:
        """Health-loop sweep over undelivered revokes: rows whose target
        node is LIVE re-drive periodically (a one-off send failure to a
        healthy agent must not pin its worker forever — RegisterNode is
        not the only re-drive trigger); rows whose node is gone past the
        redrive TTL can never deliver and drop (the agent-side resource
        died with the node anyway)."""
        ttl = float(cfg.revoke_redrive_ttl_s)
        now = time.time()
        now_m = time.monotonic()
        victims = []
        retry = []
        with self._lock:
            for rid, row in self._pending_revokes.items():
                node = self.nodes.get(row["node_id"])
                alive = node is not None and node.alive
                if alive:
                    if now_m - row.get("attempted_at", 0.0) > 5.0:
                        row["attempted_at"] = now_m
                        retry.append(rid)
                elif now - row.get("queued_at", now) > ttl:
                    victims.append(rid)
            for rid in victims:
                self._pending_revokes.pop(rid, None)
                self._wal(("revoke_done", rid))
        if victims:
            self._wal_flush()
        for rid in retry:
            try:
                self._dispatch_pool.submit(
                    _best_effort, self._drive_revoke, rid
                )
            except RuntimeError:
                return

    def _h_lease_renew(self, req: dict) -> None:
        """Owner heartbeat while its queue is non-empty (ClientBatch
        ``lease_renew``): pushes the expiry out so the dead-owner sweep
        never revokes a flowing lease."""
        horizon = time.monotonic() + max(3.0 * cfg.task_lease_ttl_s, 15.0)
        with self._lock:
            for lid in req.get("lease_ids", ()):
                e = self._task_leases.get(lid)
                if e is not None:
                    e["expires_at"] = horizon

    def _h_lease_return(self, req: dict) -> None:
        """Owner returned a lease (queue drain / idle TTL / shutdown)."""
        lease_id = req["lease_id"]
        with self._cond:
            e = self._drop_task_lease_locked(lease_id)
            if e is not None:
                self.metrics["task_leases_returned"] += 1
                TASK_LEASE_RETURNED.inc()
            self._cond.notify_all()
        self._wal_flush()
        node_id = (e or {}).get("node_id") or req.get("node_id")
        if node_id:
            # forward even when the table missed it (unpersisted head
            # restart): the agent-side release is what unpins the worker
            self._agent_return_lease(node_id, lease_id)

    def _expire_task_leases(self) -> None:
        """Dead-owner safety net: revoke leases not renewed within
        3x TTL (floored at 15s — renewals ride the pipelined ClientBatch
        and may lag under load; revoking a healthy flowing lease costs a
        spill storm). A live owner renews while busy, returns on idle."""
        now = time.monotonic()
        with self._lock:
            victims = [
                (lid, e.get("node_id"))
                for lid, e in self._task_leases.items()
                if now > e["expires_at"]
            ]
        for lid, node_id in victims:
            logger.info("task lease %s expired; revoking", lid[:8])
            with self._cond:
                if self._drop_task_lease_locked(lid) is None:
                    continue
                self.metrics["task_leases_revoked"] += 1
                TASK_LEASE_REVOKED.inc()
                self._cond.notify_all()
            self._wal_flush()
            if node_id:
                self._agent_return_lease(node_id, lid)

    # ------------------------------------------------------------------
    # peer data links (cross-node transport, transport.py): the task-
    # lease pattern applied to connections — the head grants a peer link
    # ONCE per (src, dst) pair (endpoint + auth token + epoch in the
    # grant), then steady-state transfers make zero head RPCs. Links
    # renew while hot via piggybacked agent reports, are reclaimed on
    # the requester's idle TTL (ReturnPeerLink), expire on a missed-
    # renewal sweep, and are revoked when either endpoint node dies.
    # ------------------------------------------------------------------
    def _h_grant_peer_link(self, req: dict) -> dict:
        if not cfg.native_net:
            return {"granted": False, "reason": "native net disabled"}
        src = req.get("src_node", "")
        dst = req["dst_node"]
        ttl = cfg.peer_link_ttl_s
        with self._lock:
            node = self.nodes.get(dst)
            if (
                node is None
                or not node.alive
                or not getattr(node, "data_endpoint", "")
            ):
                return {
                    "granted": False,
                    "reason": f"node {dst} has no live data endpoint",
                }
            lid = self._peer_links_by_pair.get((src, dst))
            e = self._peer_links.get(lid) if lid else None
            if e is None:
                e = {
                    "link_id": new_id(),
                    "src": src,
                    "dst": dst,
                    "endpoint": node.data_endpoint,
                    "granted_at": time.time(),
                    "expires_at": time.monotonic() + max(3.0 * ttl, 15.0),
                }
                self._peer_links[e["link_id"]] = e
                self._peer_links_by_pair[(src, dst)] = e["link_id"]
                self.metrics["peer_links_granted"] += 1
                PEER_CONN_GRANTED.inc()
                self._wal(("peer_link", self._peer_link_row(e)))
            else:
                # same pair re-granting (requester restarted or dropped
                # its cache): refresh the existing row, don't duplicate
                e["endpoint"] = node.data_endpoint
                e["expires_at"] = time.monotonic() + max(3.0 * ttl, 15.0)
            reply = {
                "granted": True,
                "link_id": e["link_id"],
                "node_id": dst,
                "endpoint": node.data_endpoint,
                # the token travels only in the grant reply (never the
                # WAL/snapshot — parity with the on-disk endpoint file)
                "token": getattr(node, "net_token", ""),
                "epoch": self.cluster_epoch,
                "ttl_s": float(ttl),
            }
        self._wal_flush()
        return reply

    @staticmethod
    def _peer_link_row(e: dict) -> dict:
        row = {
            k: e[k] for k in ("link_id", "src", "dst", "endpoint", "granted_at")
        }
        row["ttl_remaining_s"] = max(0.0, e["expires_at"] - time.monotonic())
        return row

    def _drop_peer_link_locked(
        self, link_id: str, revoked: bool = True
    ) -> Optional[dict]:
        e = self._peer_links.pop(link_id, None)
        if e is None:
            return None
        pair = (e["src"], e["dst"])
        if self._peer_links_by_pair.get(pair) == link_id:
            del self._peer_links_by_pair[pair]
        self._wal(("peer_link_gone", link_id))
        if revoked:
            self.metrics["peer_links_revoked"] += 1
            PEER_CONN_REVOKED.inc()
        return e

    def _h_return_peer_link(self, req: dict) -> None:
        """Requester reclaimed an idle link (idle TTL / shutdown)."""
        with self._lock:
            self._drop_peer_link_locked(req["link_id"], revoked=False)
        self._wal_flush()

    def _renew_peer_links(self, link_ids) -> None:
        """Piggybacked renewals from agent reports (renew-while-hot)."""
        horizon = time.monotonic() + max(3.0 * cfg.peer_link_ttl_s, 15.0)
        with self._lock:
            for lid in link_ids:
                e = self._peer_links.get(lid)
                if e is not None:
                    e["expires_at"] = horizon

    def _expire_peer_links(self) -> None:
        """Dead-holder safety net: drop links not renewed within 3x TTL
        (a crashed requester can't ReturnPeerLink). No agent callout —
        the requester side re-grants on next use, and the serving side
        authenticates per handshake, not per table row."""
        now = time.monotonic()
        with self._lock:
            victims = [
                lid
                for lid, e in self._peer_links.items()
                if now > e["expires_at"]
            ]
            for lid in victims:
                self._drop_peer_link_locked(lid)
        if victims:
            self._wal_flush()

    def _revoke_node_peer_links(self, node_id: str) -> None:
        """Node death: revoke every link touching it, and tell surviving
        REQUESTERS to drop their cached grants promptly (best-effort —
        a stale cached link also dies on its next handshake, because the
        dead node's token/endpoint are gone)."""
        with self._lock:
            victims = [
                dict(e)
                for e in self._peer_links.values()
                if node_id in (e["src"], e["dst"])
            ]
            for e in victims:
                self._drop_peer_link_locked(e["link_id"])
        if not victims:
            return
        self._wal_flush()
        for e in victims:
            if e["dst"] != node_id:
                continue  # only the requester side holds a cache
            # WAL-backed fan-out: a leader dying mid-revoke leaves the
            # record for its successor to re-drive (pool-closed races
            # are absorbed inside _queue_revoke)
            self._queue_revoke(
                "RevokePeerLink",
                e["src"],
                {"link_id": e["link_id"], "node_id": e["dst"]},
            )

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._pending
                    and not (self._pending_pgs and self._pgs_dirty)
                    and not self._shutdown
                    and not self._fenced
                ):
                    self._cond.wait(timeout=0.5)
                    # Retry parked work only when the view actually moved,
                    # so truly-infeasible specs don't spin the kernel at
                    # 2 Hz.
                    self._maybe_unpark_locked()
                if self._shutdown or self._fenced:
                    # fenced: a deposed leader must not grant anything —
                    # the new leader owns every queued spec's fate (its
                    # owners re-hello and resubmit there)
                    return
                # parked work also retries while NEW submissions keep the
                # queue hot — without this, a steady submit stream starves
                # every parked spec (the wait loop above never runs)
                self._maybe_unpark_locked()
                batch = self._pop_fair_batch()
                # demand visibility: the popped batch is mid-schedule, not
                # gone — the autoscaler must still see it (the first round
                # can stall behind a slow device)
                self._scheduling_batch = batch
            t_round = time.perf_counter()
            deferred = False
            try:
                self._try_schedule_pgs()
                if batch:
                    deferred = bool(self._schedule_batch(batch))
            except Exception:  # pragma: no cover - scheduler must survive
                logger.exception("scheduler round failed; requeueing")
                with self._cond:
                    self._pending.extend(batch)
            finally:
                # pipelined rounds observe dispatch→grant latency from the
                # completion thread instead (the loop only dispatched)
                if batch and not deferred:
                    SCHED_ROUND_MS.observe(
                        (time.perf_counter() - t_round) * 1e3
                    )
                self._scheduling_batch = []
            time.sleep(SCHED_TICK_S)

    def _maybe_unpark_locked(self) -> None:
        """Rate-limited, change-gated entry to ``_unpark_grantable``:
        completions bump the change counter continuously under load;
        re-routing parked specs each 2ms tick multiplies per-spec Python
        work ~10x for no placement gain. Caller holds ``self._cond``."""
        if self._infeasible and (
            (
                self.view.change_counter != self._parked_at_change
                and time.monotonic() - self._last_park_retry > 0.02
            )
            # liveness fallback: capacity can free without a view change
            # (PG bundle books are bundle-local) — retry parked work at
            # 1 Hz regardless, bounded by the per-shape cap
            or time.monotonic() - self._last_park_retry > 1.0
        ):
            self._parked_at_change = self.view.change_counter
            self._last_park_retry = time.monotonic()
            try:
                self._unpark_grantable()
            except Exception:  # noqa: BLE001 - reported as a failed round
                # a device failure here is a failed round: logged, and the
                # scheduler thread lives; the parked work stays parked (no
                # host scan stands in for the card). The ring round may
                # have deducted on the device: the next sync is a full one.
                logger.exception(
                    "scheduler round failed in unpark; work stays parked"
                )
                if self.device_state is not None:
                    self.device_state.invalidate()

    def _unpark_grantable(self) -> None:
        """Move parked specs back to pending, capped per resource shape at
        what the current view could actually grant.

        Re-feeding the ENTIRE parked queue on every capacity-freeing event
        is O(parked²) aggregate scheduling work under a deep backlog (5k
        parked specs × ~40 unpark events re-scores ~200k placements to
        grant 5k) — exactly the storm the reference avoids by leaving
        unschedulable scheduling classes parked until resources change and
        retrying them per-class (cluster_lease_manager.cc:298
        TryScheduleInfeasibleLease + local_lease_manager.h per-class
        backoff). Here: per shape, estimate grantable slots from the live
        avail arrays and unpark only that many (+slack for estimate
        error); the remainder stays parked for the next change event.
        Constrained specs (strategy / PG / target-node routed) don't fit
        the shape-capacity math and unpark slack-at-a-time. Caller holds
        ``self._cond``."""
        from ray_tpu_torch.scheduler.unpark import UNPARK_SLACK, select_unparkable

        parked = self._infeasible
        device_state = self.device_state
        if not parked:
            self._reconcile_ring(device_state)
            return
        if len(parked) <= UNPARK_SLACK:
            # below the slack there is nothing to cap: skip the view
            # lock + array copies entirely (steady-state common case)
            self._pending.extend(parked)
            self._infeasible = []
            self._reconcile_ring(device_state)
            return
        keep_ring: List[LeaseRequest] = []
        rest = parked
        if device_state is not None and device_state.ring_slots > 0:
            # ring-resident shapes place straight off the device (no
            # demand re-upload, no trip back through the round path);
            # the remainder below is constrained / unknown-resource /
            # ring-overflow work. A failure raises to
            # _maybe_unpark_locked: no grants were sent (the round and
            # its readback precede every side effect except harmless ring
            # parks), and self._infeasible is untouched until the end.
            rest, keep_ring = self._unpark_via_ring(device_state, parked)
        if not rest:
            self._infeasible = keep_ring
            self._reconcile_ring(device_state)
            return
        slots_fn = None
        if device_state is not None and cfg.sched_unpark_device:
            # batched slot estimate over the RESIDENT arrays — avail/alive
            # below are only consulted for the resource-axis width. A
            # failure raises (no host scan stands in for the card).
            with self._lock:
                device_state.sync(self.view)
                _, avail, alive = self.view.active_arrays()
            slots_fn = device_state.shape_slots
        else:
            with self._lock:
                _, a0, al0 = self.view.active_arrays()
                avail = a0.copy()
                alive = al0.copy()
        # grants in flight (worker leases being placed) consume capacity
        # the availability arrays won't show until the agent's next
        # report: count their demand against the slot estimate
        reserved = [
            self._spec_req(
                self._leases.get(lid)
            ).dense(avail.shape[1])
            for lid, e in self._task_leases.items()
            if e["state"] == "granting" and self._leases.get(lid) is not None
        ]
        take, keep = select_unparkable(
            rest,
            avail,
            alive,
            slots_fn=slots_fn,
            is_constrained=lambda s: (
                s.strategy is not None or s.target_node or s.pg_reservation
            ),
            resources_of=lambda s: s.resources,
            request_of=self._spec_req,
            reserved=reserved or None,
            age_of=lambda k: self._shape_wait.get(k, 0),
        )
        self._pending.extend(take)
        self._infeasible = keep + keep_ring
        self._reconcile_ring(device_state)

    def _reconcile_ring(self, device_state) -> None:
        """Drop ring slots whose shape has no parked spec left. Specs
        routinely leave the parked state WITHOUT passing the in-ring
        drain that calls ring_drop (the small-queue fast path and
        select_unparkable's take list above) — without this sweep, 64
        distinct ever-parked shapes would permanently exhaust the ring
        and silently disable it for the life of the process. Caller
        holds self._cond."""
        if device_state is None or not device_state.ring_occupancy():
            return
        still = {_shape_key_of(s) for s in self._infeasible}
        for key in device_state.ring_keys():
            if key not in still:
                device_state.ring_drop(key)

    def _unpark_via_ring(
        self, device_state, parked: List[LeaseRequest]
    ) -> Tuple[List[LeaseRequest], List[LeaseRequest]]:
        """Place ring-eligible parked specs straight from the on-device
        parked-demand ring. Returns (rest, still_parked): specs the ring
        cannot serve (constrained, unknown resource, ring full), and
        ring-eligible specs the cluster had no capacity for. Placed specs
        are granted here (same optimistic-deduction + grant-or-reject
        contract as a kernel round). Caller holds self._cond."""
        with self._lock:
            r = self.view.totals.shape[1]
        ring_q: Dict[tuple, List[LeaseRequest]] = {}
        rest: List[LeaseRequest] = []
        for spec in parked:
            if (
                spec.strategy is not None
                or spec.target_node
                or spec.pg_reservation
            ):
                rest.append(spec)
                continue
            req = self._spec_req(spec)
            if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                rest.append(spec)
                continue
            key = _shape_key_of(spec)
            if (
                device_state.ring_slot_of(key) is None
                and not device_state.ring_park(key, req.dense(r))
            ):
                rest.append(spec)  # ring full: normal unpark path
                continue
            ring_q.setdefault(key, []).append(spec)
        if not ring_q:
            return rest, []
        with self._lock:
            device_state.sync(self.view)
        counts = {
            device_state.ring_slot_of(key): len(q)
            for key, q in ring_q.items()
        }
        starve_rounds = max(1, int(cfg.sched_starve_rounds))
        ages = {
            device_state.ring_slot_of(key): (
                self._shape_wait.get(key, 0) / starve_rounds
            )
            for key in ring_q
        }
        placed, per_node, pre_rows = device_state.ring_schedule(
            counts,
            spread_threshold=self.hybrid_config.spread_threshold,
            ages_by_slot=ages,
        )
        still_parked: List[LeaseRequest] = []
        grants: Dict[str, List[LeaseRequest]] = {}
        nominations: List[Tuple[tuple, int]] = []
        n = per_node.shape[1]
        for key, q in ring_q.items():
            slot = device_state.ring_slot_of(key)
            k = min(int(placed[slot]), len(q))
            if k:
                # per-node placement counts → node row per FIFO rank; the
                # host mirror deducts EXACTLY what the kernel deducted
                # (k × shape), keeping the two copies convergent
                node_rows = np.repeat(np.arange(n), per_node[slot])[:k]
                d = self._spec_req(q[0]).dense(r)
                with self._lock:
                    self.view.subtract_many(
                        node_rows, np.broadcast_to(d, (k, r))
                    )
                    for spec, row in zip(q[:k], node_rows):
                        grants.setdefault(
                            self.view.node_id(int(row)), []
                        ).append(spec)
            still_parked.extend(q[k:])
            if k == len(q):
                device_state.ring_drop(key)  # queue drained: free the slot
                self._shape_wait.pop(key, None)
                self._preempt_cooldown.pop(key, None)
            elif k > 0:
                # class made progress: not starving (see _fan_out_grants)
                self._shape_wait.pop(key, None)
            else:
                # the ring retry IS this shape's scheduling round: age it
                self._shape_wait[key] = self._shape_wait.get(key, 0) + 1
                if int(pre_rows[slot]) >= 0:
                    nominations.append(
                        (key, int(pre_rows[slot]), self._spec_req(q[0]).dense(r))
                    )
        if nominations:
            self._handle_ring_preempt(nominations)
        if grants:
            self.metrics["leases_unparked_ring"] = self.metrics.get(
                "leases_unparked_ring", 0
            ) + sum(len(v) for v in grants.values())
            self._send_grants(grants)
        return rest, still_parked

    def _pop_fair_batch(self) -> List[LeaseRequest]:
        """Take up to MAX_BATCH leases. When the queue overflows one round,
        round-robin across scheduling classes (resource shapes) so a storm
        of one shape cannot monopolize dispatch for rounds on end
        (local_lease_manager.h per-class throttling analog). Caller holds
        self._cond."""
        if self._cancelled_leases:
            drop = self._cancelled_leases
            kept = [s for s in self._pending if s.task_id not in drop]
            for s in self._pending:
                if s.task_id in drop:
                    drop.discard(s.task_id)
            self._pending = deque(kept)
        if len(self._pending) <= MAX_BATCH:
            batch = list(self._pending)
            self._pending.clear()
            return batch
        # bound the rebucketing window: scanning the WHOLE queue per tick
        # would be O(pending) under the head lock during exactly the storm
        # that triggers this branch. Fairness applies within the window;
        # the untouched tail keeps FIFO order.
        window = min(len(self._pending), 4 * MAX_BATCH)
        scanned = [self._pending.popleft() for _ in range(window)]
        by_class: Dict[tuple, deque] = {}
        order: List[tuple] = []
        for spec in scanned:
            # same cached key _round_shapes uses: a spec re-scanned every
            # storm round must not re-sort its resources dict each time
            key = _shape_key_of(spec)
            q = by_class.get(key)
            if q is None:
                q = by_class[key] = deque()
                order.append(key)
            q.append(spec)
        batch: List[LeaseRequest] = []
        while len(batch) < MAX_BATCH:
            progressed = False
            for key in order:
                q = by_class[key]
                if q:
                    batch.append(q.popleft())
                    progressed = True
                    if len(batch) >= MAX_BATCH:
                        break
            if not progressed:
                break
        # window remainder returns to the FRONT (per-class FIFO preserved),
        # ahead of the untouched tail
        for key in reversed(order):
            self._pending.extendleft(reversed(by_class[key]))
        return batch

    def _spec_req(self, spec: LeaseRequest) -> "ResourceRequest":
        """Memoized packed demand: a spec spilled back under contention is
        re-routed many times; packing its (immutable) resources dict once
        removes the dominant per-round Python cost."""
        req = getattr(spec, "_req_cache", None)
        if req is None:
            req = ResourceRequest.from_map(self.vocab, spec.resources)
            spec._req_cache = req
        return req

    def _schedule_batch(self, batch: List[LeaseRequest]) -> bool:
        """Route and place one popped batch. Returns True when the kernel
        half was dispatched into the pipeline (grants fan out from the
        completion thread); False when the round completed inline."""
        self.metrics["sched_rounds"] += 1
        kernel_batch: List[LeaseRequest] = []
        spread_batch: List[LeaseRequest] = []
        for spec in batch:
            routed = self._route_constrained(spec)
            if routed == "kernel":
                kernel_batch.append(spec)
            elif routed == "spread":
                spread_batch.append(spec)
        if spread_batch:
            self._schedule_spread(spread_batch)
        if not kernel_batch:
            return False
        totals = avail = alive = None
        # crossover: tiny rounds pay more in device dispatch than the
        # kernel saves — below the threshold use the host golden model
        # (same math; scheduler/hybrid.py golden tests pin equivalence).
        # The default threshold is 0: every round goes to the device.
        if len(kernel_batch) < cfg.sched_device_min_batch:
            device_state = None
        else:
            device_state = self.device_state
        with self._lock:
            n = self.view.num_nodes
            r = self.view.totals.shape[1]
            any_alive = bool(self.view.alive.any())
            if device_state is not None and n > 0:
                device_state.sync(self.view)
            else:
                # snapshot copies for the host reference scheduler: RPC
                # threads mutate the view concurrently (node add/remove,
                # resource reports); rows never shift, so row->node_id stays
                # valid after release.
                t0, a0, al0 = self.view.active_arrays()
                totals, avail, alive = t0.copy(), a0.copy(), al0.copy()
        if n == 0 or not any_alive:
            with self._cond:
                self._infeasible.extend(kernel_batch)
            return False
        (
            specs,
            shape_rows,
            sids,
            infeasible,
            keys,
            ages,
            loc,
        ) = self._round_shapes(kernel_batch, r)
        if infeasible:
            # a demand column past the view's resource axis names a
            # resource no node has ever reported — unplaceable until the
            # cluster changes
            with self._cond:
                self._infeasible.extend(infeasible)
        if not specs:
            return False
        if device_state is not None:
            # the default path: shape-grouped waterfall kernel over the
            # device-resident view (device.py module docstring). Pipelined
            # (cfg.sched_pipeline): dispatch round N+1 while round N's
            # placements are still being read back — the avail chain
            # sequences the rounds on device, and grants fan out from the
            # pipeline's completion thread.
            if cfg.sched_pipeline:
                pending = device_state.schedule_async(
                    spread_threshold=self.hybrid_config.spread_threshold,
                    shapes=(shape_rows, sids),
                    ages=ages,
                    locality=loc,
                )
                sched = (specs, shape_rows, sids, keys, pending, loc)
                pending.ctx = sched
                with self._cond:
                    self._deferred_rounds[id(sched)] = specs
                try:
                    self._ensure_pipeline().submit(pending)
                except Exception:
                    # pipeline stopped (shutdown race) or submit died. The
                    # kernel already dispatched — its deductions sit on the
                    # resident avail with no completion to mirror them, so
                    # purge via full re-sync and respill ONLY this round's
                    # specs: re-raising would make the loop requeue the
                    # whole batch, duplicating specs _schedule_spread
                    # already granted (at-most-once violation) and specs
                    # already parked infeasible. A round dispatched while
                    # shutdown() stops the pipeline is that race, not a fault.
                    if self._shutdown:
                        logger.debug("pipeline stopped by shutdown; respilling round")
                    else:
                        logger.exception(
                            "pipeline submit failed; respilling round"
                        )
                    device_state.invalidate()
                    with self._cond:
                        self._deferred_rounds.pop(id(sched), None)
                        self._pending.extend(specs)
                        self._cond.notify_all()
                    return False
                return True
            pending = device_state.schedule_async(
                spread_threshold=self.hybrid_config.spread_threshold,
                shapes=(shape_rows, sids),
                ages=ages,
                locality=loc,
            )
            sched = (specs, shape_rows, sids, keys, pending, loc)
            rows = pending.result()
        else:
            demands = shape_rows[sids]
            prefer = np.zeros(len(specs), dtype=np.int32)
            force_spill = np.zeros(len(specs), dtype=bool)
            rows, _granted, _ = hybrid_schedule_reference(
                totals,
                avail,
                alive,
                demands,
                prefer,
                force_spill,
                config=self.hybrid_config,
                rng=self._rng,
            )
            # feasible-but-unavailable picks are not grants: park them
            rows = np.where(np.asarray(_granted), rows, -1)
            sched = (specs, shape_rows, sids, keys)
        self._fan_out_grants(sched, np.asarray(rows))
        if len(sched) > 4:
            self._handle_preempt(sched, sched[4].preempt_rows())
        return False

    def _round_shapes(self, batch: List[LeaseRequest], r: int):
        """Round demand prep off the per-shape dense-row cache:
        ``(specs, shape_rows f32[U,r], sids int32[B], infeasible,
        keys, ages f32[U])`` in the waterfall kernel's shape order.
        Replaces the per-spec ``dense()`` + stack + ``np.unique`` pass
        (O(B·R), the dominant host cost of a round at 10k nodes) with one
        dict lookup per spec and an O(U log U) sort over the round's
        unique shapes.

        Shape order: hardest-first (``hardest_first_order``), with
        STARVING shapes (integer wait-age buckets, from ``_shape_wait``)
        stably promoted to the front — a shape that has waited longest
        claims capacity first, the fairness half of the starvation term.
        With no waiting shapes the order is byte-identical to the
        single-objective prep. ``ages`` are normalized by
        ``sched_starve_rounds`` and ride the demand upload (kernel
        starvation discount + preemption arming).

        Locality (cfg.sched_w_locality > 0): specs whose top-level
        ObjectRef deps resolve to located, sized directory entries carry
        a per-node resident-bytes vector; specs with DIFFERENT vectors
        get their own kernel slot even at the same resource shape (a
        shuffle's reduce tasks share one shape but want different
        nodes), and the per-slot vectors ride the demand upload as the
        row-normalized f32[U, N] ``loc`` matrix (kernel locality bonus).
        Weight 0 — the default — skips every bit of this: slot keys,
        shape order, and the uploaded arrays are byte-identical to the
        pre-locality prep."""
        cache_r, cache = self._dense_cache
        if cache_r != r or len(cache) > 8192:
            # width change invalidates; the size cap bounds a workload
            # that never repeats a shape (per-task fractional demands) —
            # steady shape sets rebuild in one round
            cache = {}
            self._dense_cache = (r, cache)
        w_loc = float(cfg.sched_w_locality)
        loc_l: Optional[List[Optional[np.ndarray]]] = (
            [] if w_loc > 0 else None
        )
        loc_c = 0
        loc_by_spec: Dict[int, Optional[np.ndarray]] = {}
        if loc_l is not None:
            # ONE brief lock acquisition snapshots just the directory
            # facts ((size, view rows) per unique dep); the O(deps)
            # vector builds run lock-free below — neither a per-spec
            # take/release nor holding the head's most contended lock
            # across ndarray writes survives shuffle-sized rounds
            dep_info: Dict[str, Optional[Tuple[float, Tuple[int, ...]]]] = {}
            with self._lock:
                loc_c = self.view.totals.shape[0]
                for spec in batch:
                    for dep in spec.deps:
                        if dep in dep_info:
                            continue
                        e = self._objects.get(dep)
                        if e is None or not e.size or not e.locations:
                            dep_info[dep] = None
                            continue
                        rows_t = []
                        for nid in e.locations:
                            row = self.view.row_if_known(nid)
                            if row is not None and row < loc_c:
                                rows_t.append(row)
                        dep_info[dep] = (
                            (float(e.size), tuple(rows_t))
                            if rows_t
                            else None
                        )
            for spec in batch:
                if not spec.deps:
                    continue
                vec: Optional[np.ndarray] = None
                for dep in spec.deps:
                    info = dep_info.get(dep)
                    if info is None:
                        continue
                    size, rows_t = info
                    if vec is None:
                        vec = np.zeros(loc_c, dtype=np.float32)
                    for row in rows_t:
                        vec[row] += size
                loc_by_spec[id(spec)] = vec
        slots: Dict[tuple, int] = {}
        rows_l: List[np.ndarray] = []
        keys_l: List[tuple] = []
        specs: List[LeaseRequest] = []
        sid_l: List[int] = []
        infeasible: List[LeaseRequest] = []
        for spec in batch:
            key = _shape_key_of(spec)
            if key in cache:
                row = cache[key]
            else:
                req = self._spec_req(spec)
                if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                    row = None  # oversized at width r: infeasible for now
                else:
                    row = req.dense(r)
                cache[key] = row
            if row is None:
                infeasible.append(spec)
                continue
            if loc_l is None:
                skey: tuple = key
                lv = None
            else:
                lv = loc_by_spec.get(id(spec))
                # the byte signature splits slots ONLY between specs with
                # genuinely different residency; identical reduce fan-ins
                # (and every no-dep spec) still share one slot
                skey = (key, None if lv is None else lv.tobytes())
            slot = slots.get(skey)
            if slot is None:
                slot = len(rows_l)
                slots[skey] = slot
                rows_l.append(row)
                keys_l.append(key)
                if loc_l is not None:
                    loc_l.append(lv)
            specs.append(spec)
            sid_l.append(slot)
        if not specs:
            return specs, None, None, infeasible, None, None, None
        shape_rows = np.stack(rows_l).astype(np.float32, copy=False)
        sids = np.asarray(sid_l, dtype=np.int32)
        order = hardest_first_order(shape_rows)
        starve_rounds = max(1, int(cfg.sched_starve_rounds))
        with self._cond:  # _shape_wait is shared with the completion thread
            ages = np.asarray(
                [self._shape_wait.get(k, 0) / starve_rounds for k in keys_l],
                dtype=np.float32,
            )
        if ages.any():
            # starving-first, stable within equal age buckets (all-zero
            # ages leave the hardest-first order untouched)
            buckets = np.minimum(ages[order], 8.0).astype(np.int32)
            order = order[np.argsort(-buckets, kind="stable")]
        remap = np.empty(shape_rows.shape[0], dtype=np.int32)
        remap[order] = np.arange(shape_rows.shape[0], dtype=np.int32)
        keys = [keys_l[i] for i in order]
        loc = None
        if loc_l is not None and any(v is not None for v in loc_l):
            loc = np.zeros((len(loc_l), loc_c), dtype=np.float32)
            for i, lv in enumerate(loc_l):
                if lv is not None:
                    total = float(lv.sum())
                    if total > 0:
                        loc[i] = lv / total
            loc = loc[order]
        return (
            specs,
            shape_rows[order],
            remap[sids],
            infeasible,
            keys,
            ages[order],
            loc,
        )

    def _ensure_pipeline(self):
        """The completion-side of pipelined rounds; created on first use
        (scheduler thread only — no construction race)."""
        if self._pipeline is None:
            from ray_tpu_torch.scheduler.pipeline import SchedulerPipeline

            self._pipeline = SchedulerPipeline(
                on_complete=self._finish_round,
                on_error=self._round_failed,
            )
        return self._pipeline

    def _finish_round(self, sched, rows: np.ndarray, round_ms: float) -> None:
        """Completion-thread half of a pipelined round: the dispatch side
        has long moved on to later rounds; this fans the read-back
        placements out into grants."""
        SCHED_ROUND_MS.observe(round_ms)
        try:
            from ray_tpu_torch.util.tracing import SPANS

            SPANS.record(
                "sched_round",
                "scheduler",
                time.time() - round_ms / 1e3,
                round_ms / 1e3,
                pid="head",
                batch=len(sched[0]),
                placed=int((rows >= 0).sum()),
            )
        except Exception:  # noqa: BLE001 - observability only
            pass
        try:
            self._fan_out_grants(sched, rows)
            if len(sched) > 4:
                self._handle_preempt(sched, sched[4].preempt_rows())
        except Exception:  # noqa: BLE001 - must not reach _round_failed
            # a PARTIAL fan-out is not safely unwindable (unplaced specs
            # already parked, host deductions applied, some grants sent):
            # letting this reach the pipeline's on_error would respill
            # the whole round and double-schedule the handled specs.
            # _round_failed's respill-everything recovery is only correct
            # for result() failures, where nothing has happened yet.
            logger.exception("grant fan-out failed mid-round")
        finally:
            with self._cond:
                self._deferred_rounds.pop(id(sched), None)
                self._cond.notify_all()

    def _round_failed(self, sched, exc: Exception) -> None:
        """A pipelined round died (kernel/readback error): respill its
        specs to the pending queue — same recovery as a synchronous round
        raising in the scheduler loop. The dead round's deductions were
        committed to the resident avail at dispatch but will never reach
        the host mirror, so force a full device re-sync to purge the
        phantom capacity loss."""
        device_state = self.device_state
        if device_state is not None:
            device_state.invalidate()
        with self._cond:
            self._deferred_rounds.pop(id(sched), None)
            self._pending.extend(sched[0])
            self._cond.notify_all()

    def _fan_out_grants(self, sched, rows: np.ndarray) -> None:
        """Turn one round's placement rows into per-node grant batches.
        ``sched`` is a ``(specs, shape_rows, sids[, keys[, pending]])``
        round context (_round_shapes). Unplaced specs park (and pin their
        shape in the device ring); placements deduct from the host mirror
        in ONE vectorized scatter-subtract and group per node off one
        argsort — the per-spec lock/subtract/setdefault loop dominated
        the host cost of a full round at 10k nodes. Shape wait-ages bump
        for shapes the round left (partly) unplaced and clear for fully
        placed ones (the starvation term's input)."""
        specs, shape_rows, sids = sched[0], sched[1], sched[2]
        keys = sched[3] if len(sched) > 3 else None
        placed_mask = rows >= 0
        if keys is not None:
            u = shape_rows.shape[0]
            total_per_shape = np.bincount(sids, minlength=u)
            placed_per_shape = np.bincount(
                sids[placed_mask], minlength=u
            )
            # aggregate per shape KEY first: locality slot-splitting can
            # put the same resource key in several kernel slots, and the
            # class's progress must be judged across ALL of them — a
            # per-slot loop would let an unplaced slot re-age a class
            # another slot just served (order-dependent starvation)
            per_key: Dict[tuple, List[int]] = {}
            for i, key in enumerate(keys):
                if total_per_shape[i] == 0:
                    continue
                ent = per_key.get(key)
                if ent is None:
                    ent = per_key[key] = [0, 0]
                ent[0] += int(placed_per_shape[i])
                ent[1] += int(total_per_shape[i])
            # under the lock: the scheduler thread (_round_shapes ages
            # read, ring-path bumps), RPC threads (QueryState), and this
            # completion thread all touch the wait tables
            with self._cond:
                for key, (placed_n, total_n) in per_key.items():
                    if placed_n > 0:
                        # the CLASS made progress this round: it is not
                        # starving, even with instances left over —
                        # aging a continuously-served shape made it
                        # "starve" and preempt its own running peers in
                        # a kill/requeue livelock
                        self._shape_wait.pop(key, None)
                        if placed_n >= total_n:
                            self._preempt_cooldown.pop(key, None)
                    else:
                        self._shape_wait[key] = (
                            self._shape_wait.get(key, 0) + 1
                        )
                if len(self._shape_wait) > 4096:
                    # bound the tables: entries normally clear on full
                    # placement; cancelled-last-spec shapes can leak —
                    # evict the youngest half (oldest = closest to
                    # starving, keep) and their cooldown rows with them
                    for k in sorted(
                        self._shape_wait, key=self._shape_wait.get
                    )[:2048]:
                        self._shape_wait.pop(k, None)
                        self._preempt_cooldown.pop(k, None)
                if len(self._preempt_cooldown) > 4096:
                    # cooldowns for shapes that drained while parked
                    # have no other reaper: drop the expired ones
                    now = time.monotonic()
                    for k in [
                        k
                        for k, t in self._preempt_cooldown.items()
                        if t <= now
                    ]:
                        self._preempt_cooldown.pop(k, None)
        unplaced = [specs[i] for i in np.flatnonzero(~placed_mask)]
        if unplaced:
            with self._cond:
                if self._cancelled_leases:
                    # cancelled / owner-reaped while the round was in
                    # flight: the dispatch-time filter in _send_grants
                    # only covers the granted half — drop, don't park
                    kept = []
                    for s in unplaced:
                        if s.task_id in self._cancelled_leases:
                            self._cancelled_leases.discard(s.task_id)
                        else:
                            kept.append(s)
                    unplaced = kept
                self._infeasible.extend(unplaced)
            if unplaced:
                self._ring_park_specs(unplaced)
        idx = np.flatnonzero(placed_mask)
        if idx.size == 0:
            return
        demands_mat = shape_rows[sids[idx]]
        row_arr = rows[idx].astype(np.int64)
        loc = sched[5] if len(sched) > 5 else None
        if loc is not None:
            # locality accounting: loc rows are normalized residency
            # fractions, so loc[slot, chosen_row] IS the fraction of this
            # lease's input bytes already on its node
            slot_arr = sids[idx]
            scored = loc[slot_arr].sum(axis=1) > 0
            n_scored = int(scored.sum())
            if n_scored:
                frac = loc[slot_arr, np.clip(row_arr, 0, loc.shape[1] - 1)]
                SCHED_LOCALITY_SCORED.inc(n_scored)
                SCHED_LOCALITY_HIT_FRAC.inc(float(frac[scored].sum()))
        order = np.argsort(row_arr, kind="stable")
        srt = row_arr[order]
        starts = np.flatnonzero(
            np.concatenate([[True], srt[1:] != srt[:-1]])
        )
        grants: Dict[str, List[LeaseRequest]] = {}
        row_to_node: Dict[int, str] = {}
        with self._lock:
            # optimistic deduction so later rounds see the placement; the
            # agent's authoritative report will overwrite the rows.
            self.view.subtract_many(row_arr, demands_mat)
            for k, start in enumerate(starts):
                end = starts[k + 1] if k + 1 < len(starts) else srt.size
                node_id = self.view.node_id(int(srt[start]))
                row_to_node[int(srt[start])] = node_id
                grants[node_id] = [
                    specs[idx[order[j]]] for j in range(start, end)
                ]
        self._send_grants(grants)
        if cfg.sched_explain:
            try:
                self._note_explanations(sched, rows, idx, row_arr, row_to_node)
            except Exception:  # noqa: BLE001 - attribution is best-effort
                logger.exception("placement attribution failed")

    def _note_explanations(
        self,
        sched,
        rows: np.ndarray,
        idx: np.ndarray,
        row_arr: np.ndarray,
        row_to_node: Dict[int, str],
    ) -> None:
        """Scheduler decision attribution: record, per placed
        spec, the five per-term cost contributions of its winning node
        (``hybrid.TERM_NAMES``) into the bounded explanation table and a
        SCHEDULED task event — so both ``QueryState explain_placement``
        and the Chrome-trace export answer "why THIS node". Kernel
        rounds carry exact terms read back with the placements; host
        golden-model rounds record the placement with zeroed terms
        (single-objective by construction), labeled by source."""
        from ray_tpu_torch.scheduler.hybrid import TERM_NAMES

        specs = sched[0]
        pending = sched[4] if len(sched) > 4 else None
        terms = pending.terms_rows() if pending is not None else None
        source = "kernel" if terms is not None else "host"
        now = time.time()
        entries: List[Tuple[str, dict]] = []
        for j, i in enumerate(np.asarray(idx)):
            spec = specs[int(i)]
            node_id = row_to_node.get(int(row_arr[j]))
            if node_id is None:
                continue
            if terms is not None:
                tvec = terms[int(i)]
                tdict = {
                    name: float(tvec[t]) for t, name in enumerate(TERM_NAMES)
                }
            else:
                tdict = {name: 0.0 for name in TERM_NAMES}
                tdict["starve_discount"] = 1.0
            trace = getattr(spec, "trace", None) or {}
            entries.append(
                (
                    spec.task_id,
                    {
                        "task_id": spec.task_id,
                        "name": spec.name,
                        "node": node_id,
                        "source": source,
                        "terms": tdict,
                        "trace_id": trace.get("trace_id"),
                        "ts": now,
                    },
                )
            )
            self.events.record(
                spec.task_id,
                spec.name,
                "SCHEDULED",
                node_id,
                sched_terms=tdict,
                **_trace_args(spec),
            )
        if not entries:
            return
        keep = max(64, int(cfg.sched_explain_keep))
        with self._explain_lock:
            for tid, ent in entries:
                self._explain[tid] = ent
                self._explain.move_to_end(tid)
            while len(self._explain) > keep:
                self._explain.popitem(last=False)

    def explain_placement(self, task_id: str) -> Optional[dict]:
        """The recorded decision attribution for one scheduled task (or
        None: never kernel-scheduled, evicted, or explain off)."""
        with self._explain_lock:
            return self._explain.get(task_id)

    def _ring_park_specs(self, specs: List[LeaseRequest]) -> None:
        """Pin freshly-parked kernel shapes in the on-device parked-demand
        ring so their retries run count-driven off resident rows
        (device.py ring_schedule) instead of re-uploading demand."""
        device_state = self.device_state
        if device_state is None or device_state.ring_slots <= 0:
            return
        with self._lock:
            r = self.view.totals.shape[1]
        for spec in specs:
            if spec.strategy is not None or spec.target_node or spec.pg_reservation:
                continue
            req = self._spec_req(spec)
            if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                continue
            device_state.ring_park(_shape_key_of(spec), req.dense(r))

    # ------------------------------------------------------------------
    # preemption / migration: the kernel NOMINATES (per
    # starving shape, the lowest-cost feasible-by-totals node); the head
    # maps the node to concrete victim leases and kill-and-requeues
    # through the lineage/fate-sharing machinery. State machine per
    # victim (COMPONENTS.md):
    #   queued-on-agent  --CancelLease--> requeued (no attempt burned)
    #   worker_lease     --revoke------->  owner spills to head path
    #   running retryable --force kill--> worker-death report -->
    #                                     requeued via _preempted_leases
    #                                     (no attempt burned)
    #   running max_retries=0            NEVER a victim (at-most-once)
    # ------------------------------------------------------------------

    def _nominate(self, key: tuple, row: int, need: np.ndarray) -> bool:
        """One nomination: per-shape cooldown gate, metrics, node
        resolution, and the async victim fan-out. The ONE copy of the
        nomination policy, shared by the round-kernel and ring paths.
        Returns False when the dispatch pool is gone (caller stops)."""
        now = time.monotonic()
        with self._lock:  # cooldown table is shared across threads
            if self._preempt_cooldown.get(key, 0.0) > now:
                return True
            self._preempt_cooldown[key] = (
                now + float(cfg.sched_preempt_cooldown_s)
            )
            self.metrics["preempt_nominations"] += 1
            if row >= self.view.num_nodes:
                node_id = None
            else:
                node_id = self.view.node_id(row)
        SCHED_PREEMPT_NOMINATED.inc()
        if node_id is None:
            return True
        # victim kills do RPCs: off the completion thread
        try:
            self._dispatch_pool.submit(
                self._preempt_on_node, node_id, need, key
            )
        except RuntimeError:  # dispatch pool shut down
            return False
        return True

    def _handle_preempt(self, sched, pre_rows: Optional[np.ndarray]) -> None:
        """Fan one round's preemption nominations out into victim kills.
        ``sched`` = (specs, shape_rows, sids, keys, pending)."""
        if pre_rows is None or not cfg.sched_preempt:
            return
        keys, shape_rows = sched[3], sched[1]
        for u, row in enumerate(np.asarray(pre_rows)):
            if row < 0 or keys is None or u >= len(keys):
                continue
            if not self._nominate(keys[u], int(row), shape_rows[u]):
                return

    def _handle_ring_preempt(
        self, nominations: List[Tuple[tuple, int, np.ndarray]]
    ) -> None:
        """Ring-round nominations: (shape key, node row, dense demand)
        triples from ``_unpark_via_ring`` — same cooldown + victim
        fan-out as the round-kernel path (``_nominate``)."""
        if not cfg.sched_preempt:
            return
        for key, row, need in nominations:
            if not self._nominate(key, row, need):
                return

    def _pick_preemption_victims(
        self, node_id: str, need: np.ndarray
    ) -> Tuple[List[str], List[Tuple[LeaseRequest, bool]]]:
        """(worker-lease victims, (task spec, may_force) victims) on
        ``node_id``, lowest-cost-first, accumulating until the freed
        demand covers ``need`` on its demanded columns (bounded by
        sched_preempt_max_per_round). Lowest cost = least work lost:
        worker leases (spill, nothing re-executes) before task leases
        (smallest resource footprint first). Running max_retries=0 work
        is never force-killable; queued work of any retry class is (it
        has not started — requeue is not re-execution). Victims must be
        STRICTLY CHEAPER than the starving shape (demand sum): a shape
        preempting peers of its own size just swaps who waits while
        losing work — observed as a kill/requeue livelock. Caller need
        not hold the lock."""
        cols = need > 0
        need_sum = float(need.sum())
        limit = max(1, int(cfg.sched_preempt_max_per_round))
        lease_victims: List[str] = []
        task_victims: List[Tuple[LeaseRequest, bool]] = []
        freed = np.zeros_like(need)
        with self._cond:
            cands: List[Tuple[float, str, object]] = []
            for lid, e in self._task_leases.items():
                if e.get("node_id") != node_id or e["state"] != "active":
                    continue
                spec = self._leases.get(lid)
                d = (
                    self._spec_req(spec).dense(need.shape[0])
                    if spec is not None
                    else self.vocab.pack(e["resources"])[: need.shape[0]]
                )
                if not (d[cols] > 0).any():
                    continue  # frees nothing the starving shape needs
                if float(d.sum()) >= need_sum:
                    continue  # not strictly cheaper: peer churn, skip
                cands.append((float(d.sum()), "lease", (lid, d)))
            for lid, (spec, nid) in self._in_flight.items():
                if nid != node_id or spec.kind != "task":
                    continue
                d = self._spec_req(spec).dense(need.shape[0])
                if not (d[cols] > 0).any():
                    continue
                if float(d.sum()) >= need_sum:
                    continue  # not strictly cheaper: peer churn, skip
                # +1.0 sort bias: prefer worker leases at equal footprint
                cands.append((float(d.sum()) + 1.0, "task", (spec, d)))
            cands.sort(key=lambda c: c[0])
            for _, kind, payload in cands:
                if (
                    len(lease_victims) + len(task_victims) >= limit
                    or np.all(freed[cols] >= need[cols])
                ):
                    break
                if kind == "lease":
                    lid, d = payload
                    lease_victims.append(lid)
                    freed = freed + d
                else:
                    spec, d = payload
                    may_force = (
                        bool(cfg.sched_preempt_running)
                        and spec.attempt < spec.max_retries
                    )
                    task_victims.append((spec, may_force))
                    freed = freed + d
        return lease_victims, task_victims

    def _preempt_on_node(
        self, node_id: str, need: np.ndarray, shape_key: tuple
    ) -> None:
        """Execute one nomination: revoke/kill the chosen victims so the
        starving shape's next round finds capacity on ``node_id``."""
        lease_victims, task_victims = self._pick_preemption_victims(
            node_id, need
        )
        self._evict_victims(node_id, lease_victims, task_victims, shape_key)

    def _evict_victims(
        self,
        node_id: str,
        lease_victims: List[str],
        task_victims: List[Tuple[LeaseRequest, bool]],
        shape_key: tuple,
    ) -> None:
        """The execution half of a preemption/migration: revoke worker
        leases (spill, nothing re-executes), CancelLease(force=False)
        queued task leases (requeue, no attempt burned), and force-kill
        running RETRYABLE tasks via the ``_preempted_leases`` attempt-free
        requeue path. Shared by shape-starvation preemption (victims
        strictly cheaper than the starving shape) and drain-ahead
        migration (every movable lease on a retiring node)."""
        for lid in lease_victims:
            with self._cond:
                if self._drop_task_lease_locked(lid) is None:
                    continue
                self.metrics["task_leases_revoked"] += 1
                TASK_LEASE_REVOKED.inc()
                self.metrics["preemptions"] += 1
                SCHED_PREEMPTIONS.inc(labels={"kind": "worker_lease"})
                self._cond.notify_all()
            self._wal_flush()
            logger.info(
                "preempted worker lease %s on %s for starving shape %r",
                lid[:8],
                node_id,
                shape_key,
            )
            self._agent_return_lease(node_id, lid)
        if not task_victims:
            return
        client = self._clients.get(node_id)
        if client is None:
            return
        for spec, may_force in task_victims:
            lid = spec.task_id
            try:
                reply = client.call(
                    "CancelLease", {"task_id": lid, "force": False},
                    timeout=10.0,
                )
            except RpcError:
                continue  # unreachable: the health path owns this node
            if reply.get("cancelled"):
                # still queued agent-side: it never started — requeue
                # with no attempt burned (a preemption is a scheduler
                # action, not a task failure)
                with self._cond:
                    self._in_flight.pop(lid, None)
                    spec.target_node = None
                    self._pending.append(spec)
                    self.metrics["preemptions"] += 1
                    SCHED_PREEMPTIONS.inc(labels={"kind": "queued"})
                    self._cond.notify_all()
                logger.info(
                    "preempted queued lease %s on %s (requeued)",
                    lid[:8],
                    node_id,
                )
                continue
            if not may_force:
                continue  # running and not safely re-executable: skip
            # running retryable task: kill-and-requeue. The flag makes
            # the agent's worker-death "failed" report requeue WITHOUT
            # consuming a retry attempt (_h_report_seals).
            with self._cond:
                self._preempted_leases.add(lid)
            try:
                reply = client.call(
                    "CancelLease", {"task_id": lid, "force": True},
                    timeout=10.0,
                )
                if reply.get("cancelled"):
                    self.metrics["preemptions"] += 1
                    SCHED_PREEMPTIONS.inc(labels={"kind": "running"})
                    logger.info(
                        "preempted running lease %s on %s (migrating)",
                        lid[:8],
                        node_id,
                    )
                else:
                    # finished (or vanished) before the kill landed
                    with self._cond:
                        self._preempted_leases.discard(lid)
            except RpcError:
                with self._cond:
                    self._preempted_leases.discard(lid)

    # ------------------------------------------------------------------
    # drain-ahead retirement (unified elasticity plane)
    # ------------------------------------------------------------------
    def begin_node_drain(
        self, node_id: str, deadline_s: Optional[float] = None
    ) -> bool:
        """Mark ``node_id`` draining: its NodeReport availability is
        clamped to zero (no new placements) and its ClusterView row is
        zeroed immediately so in-flight scheduling rounds stop choosing
        it. Returns False for unknown/dead nodes."""
        if deadline_s is None:
            deadline_s = float(cfg.elastic_drain_deadline_s)
        with self._cond:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return False
            if node_id in self._draining_nodes:
                return True
            self._draining_nodes[node_id] = time.monotonic() + deadline_s
            self.view.update_available(
                node_id, {k: 0.0 for k in node.resources}
            )
            self._pgs_dirty = True
            self._cond.notify_all()
        logger.info(
            "node %s draining (deadline %.1fs)", node_id, deadline_s
        )
        return True

    def migrate_node_leases(self, node_id: str) -> int:
        """Drain-ahead migration: move every movable lease off a node
        selected for retirement BEFORE the drain deadline. Unlike
        starvation preemption there is no strictly-cheaper constraint —
        the node is going away, so everything that can be relocated
        without losing completed work is: worker leases spill, queued
        tasks requeue, running retryable tasks kill-and-requeue with no
        attempt burned. Running max_retries=0 work is left to finish
        inside the deadline (forcing it would turn a planned retirement
        into a task failure). Returns the victim count."""
        lease_victims: List[str] = []
        task_victims: List[Tuple[LeaseRequest, bool]] = []
        with self._cond:
            for lid, e in self._task_leases.items():
                if e.get("node_id") == node_id and e["state"] == "active":
                    lease_victims.append(lid)
            for lid, (spec, nid) in self._in_flight.items():
                if nid != node_id or spec.kind != "task":
                    continue
                task_victims.append(
                    (spec, spec.attempt < spec.max_retries)
                )
        if lease_victims or task_victims:
            self._evict_victims(
                node_id, lease_victims, task_victims, ("drain", node_id)
            )
        return len(lease_victims) + len(task_victims)

    def node_drained(self, node_id: str) -> bool:
        """True once nothing leased remains on a draining node."""
        with self._cond:
            for e in self._task_leases.values():
                if e.get("node_id") == node_id and e["state"] == "active":
                    return False
            for _, (spec, nid) in self._in_flight.items():
                if nid == node_id:
                    return False
        return True

    def finish_node_drain(self, node_id: str, retire: bool) -> None:
        """Close a drain: either the provider terminated the node
        (``retire=True`` — declare it dead so leases/gangs/objects run
        their death paths) or the drain was cancelled (``retire=False``
        — the next NodeReport restores its advertised availability)."""
        with self._cond:
            self._draining_nodes.pop(node_id, None)
        if retire:
            self._on_node_death(node_id)

    def _dispatch_batch_blocking(
        self, specs: List[LeaseRequest], node_id: str, client: RpcClient
    ) -> None:
        try:
            reply = client.call("ExecuteLeaseBatch", specs, timeout=60.0)
        except RpcError:
            with self._cond:
                for s in specs:
                    self._in_flight.pop(s.task_id, None)
            for s in specs:
                self._retry_or_fail(s, f"agent {node_id} unreachable")
            return
        rejected = []
        for s, status in zip(specs, reply["statuses"]):
            if status == "granted":
                self.events.record(
                    s.task_id, s.name, "RUNNING", node_id, **_trace_args(s)
                )
            else:
                rejected.append(s)
        if rejected:
            # stale view: grant-or-reject → spill back to the queue
            with self._cond:
                self.metrics["leases_spilled_back"] += len(rejected)
                for s in rejected:
                    self._in_flight.pop(s.task_id, None)
                if reply.get("available") is not None:
                    node = self.nodes.get(node_id)
                    if node is not None and node.alive:
                        self.view.update_available(node_id, reply["available"])
                self._pending.extend(rejected)
                self._cond.notify_all()

    def _schedule_spread(self, specs: List[LeaseRequest]) -> None:
        """Distinct SPREAD policy: round-robin over feasible alive nodes
        (spread_scheduling_policy.cc:26 analog), vectorized over the batch
        with in-batch deductions so one round can't stack one node."""
        with self._lock:
            t0, a0, al0 = self.view.active_arrays()
            totals, avail, alive = t0.copy(), a0.copy(), al0.copy()
            node_ids = [
                self.view.node_id(i) for i in range(self.view.num_nodes)
            ]
        n = len(node_ids)
        if n == 0 or not alive.any():
            with self._cond:
                self._infeasible.extend(specs)
            return
        r = totals.shape[1]
        reqs = [self._spec_req(s) for s in specs]
        # demands naming a resource no node has ever reported are
        # unplaceable until the cluster changes (same guard as the kernel)
        sched: List[Tuple[LeaseRequest, np.ndarray]] = []
        with self._cond:
            for spec, req in zip(specs, reqs):
                if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                    self._infeasible.append(spec)
                else:
                    sched.append((spec, req.dense(r)))
        if not sched:
            return
        specs = [s for s, _ in sched]
        demands = np.stack([d for _, d in sched])
        grants: Dict[str, List[LeaseRequest]] = {}
        order = np.arange(n)
        for i, spec in enumerate(specs):
            feasible = (avail >= demands[i]).all(axis=1) & alive
            if spec.strategy == "RANDOM":
                # random_scheduling_policy.cc analog: uniform over feasible
                cand = np.flatnonzero(feasible)
                if cand.size == 0:
                    with self._cond:
                        self._infeasible.append(spec)
                    continue
                row = int(self._rng.choice(cand))
            else:
                rot = np.roll(order, -self._spread_rr)
                cand = rot[feasible[rot]]
                if cand.size == 0:
                    with self._cond:
                        self._infeasible.append(spec)
                    continue
                row = int(cand[0])
                self._spread_rr = (row + 1) % n
            avail[row] -= demands[i]
            with self._lock:
                self.view.subtract(row, demands[i])
            grants.setdefault(node_ids[row], []).append(spec)
        self._send_grants(grants)

    def _send_grants(self, grants: Dict[str, List[LeaseRequest]]) -> None:
        if self._cancelled_leases:
            with self._cond:
                filtered: Dict[str, List[LeaseRequest]] = {}
                for nid, specs in grants.items():
                    keep = []
                    for s in specs:
                        if s.task_id in self._cancelled_leases:
                            self._cancelled_leases.discard(s.task_id)
                        else:
                            keep.append(s)
                    if keep:
                        filtered[nid] = keep
                grants = filtered
        for node_id, specs in grants.items():
            with self._lock:
                client = self._clients.get(node_id)
                node = self.nodes.get(node_id)
                for s in specs:
                    s.target_node = node_id
                    self._in_flight[s.task_id] = (s, node_id)
            if client is None or node is None or not node.alive:
                with self._cond:
                    for s in specs:
                        self._in_flight.pop(s.task_id, None)
                    self._pending.extend(specs)
                    self._cond.notify_all()
                continue
            try:
                self._prestart_hint(client, specs)
                self._dispatch_pool.submit(
                    self._dispatch_batch_blocking, specs, node_id, client
                )
            except RuntimeError:
                # dispatch pool shut down mid-round: respill like a dead
                # client. Raising here would make the caller's recovery
                # respill the WHOLE round — duplicating specs already
                # submitted to other nodes (at-most-once violation for
                # max_retries=0 leases).
                with self._cond:
                    for s in specs:
                        self._in_flight.pop(s.task_id, None)
                    self._pending.extend(specs)
                    self._cond.notify_all()

    def _prestart_hint(
        self, client: RpcClient, specs: List[LeaseRequest]
    ) -> None:
        """Actor creations pin workers for life: tell the target agent how
        many are inbound so replacement capacity warms WHILE the leases
        are in flight instead of after each one pins its worker
        (worker_pool.cc PrestartWorkers semantics)."""
        n = sum(1 for s in specs if s.kind == "actor_creation")
        if n:
            self._dispatch_pool.submit(
                _best_effort,
                client.call,
                "PrestartWorkers",
                {"count": n},
            )

    def _pick_labeled_node(self, strat, resources) -> Optional[str]:
        """Label-selector placement (node_label_scheduling_policy.cc
        analog): hard selectors filter, resource feasibility filters
        (the reference policy only considers feasible labeled nodes),
        soft selectors prefer; ties go round-robin."""
        from ray_tpu_torch.scheduler.labels import match_labels

        req = ResourceRequest.from_map(self.vocab, resources)
        with self._lock:
            r = self.view.totals.shape[1]
            if any(c >= r and fp > 0 for c, fp in req.demands.items()):
                return None  # unknown resource: no node can fit it yet
            d = req.dense(r)
            avail = self.view.active_arrays()[1]
            hard = [
                nid
                for nid, node in self.nodes.items()
                if node.alive
                and match_labels(node.labels, strat.hard)
                and (avail[self.view.row_of(nid)] >= d).all()
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

    def _route_constrained(self, spec: LeaseRequest):
        """Actor methods, node affinity, label selectors, and PG-bound
        leases bypass the kernel (composite policy dispatch,
        composite_scheduling_policy.cc); SPREAD gets its own round-robin
        pass."""
        from ray_tpu_torch.core.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
            NodeLabelSchedulingStrategy,
            PlacementGroupSchedulingStrategy,
        )

        if spec.kind == "actor_method":
            info = self._actors.get(spec.actor_id)
            if info is None or info.state == "DEAD":
                self._seal_error_ids(
                    spec.return_ids,
                    RuntimeError(f"actor {spec.actor_id} is dead"),
                )
                return "done"
            if info.state != "ALIVE":
                with self._cond:
                    self._infeasible.append(spec)
                return "done"
            self._dispatch(spec, info.node_id)
            return "done"
        strat = spec.strategy
        if strat in ("SPREAD", "RANDOM"):
            return "spread"  # both use the vectorized round-robin pass
        if isinstance(strat, NodeLabelSchedulingStrategy):
            node_id = self._pick_labeled_node(strat, spec.resources)
            if node_id is None:
                if strat.hard:
                    # no labeled node yet — parked until membership changes
                    with self._cond:
                        self._infeasible.append(spec)
                    return "done"
                return "kernel"  # soft-only: any node will do
            self._dispatch(spec, node_id)
            return "done"
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            node = self.nodes.get(strat.node_id)
            if node is not None and node.alive:
                self._dispatch(spec, strat.node_id)
                return "done"
            if strat.soft:
                return "kernel"
            self._seal_error_ids(
                spec.return_ids,
                RuntimeError(
                    f"node affinity target {strat.node_id} is dead/unknown"
                ),
            )
            return "done"
        if isinstance(strat, PlacementGroupSchedulingStrategy):
            pg = self._pgs.get(strat.placement_group.id)
            if pg is None or pg.removed:
                self._seal_error_ids(
                    spec.return_ids, RuntimeError("placement group removed")
                )
                return "done"
            if not pg.ready.is_set():
                with self._cond:
                    self._infeasible.append(spec)
                return "done"
            idx = strat.placement_group_bundle_index
            if idx is None or idx < 0:
                idx = self._pick_pg_bundle(pg, spec.resources)
            if idx is None:
                with self._cond:
                    self._infeasible.append(spec)
                return "done"
            spec.pg_reservation = (pg.pg_id, int(idx))
            self._dispatch(spec, pg.node_per_bundle[int(idx)])
            return "done"
        return "kernel"

    def _pick_pg_bundle(self, pg: _PGState, resources: Dict[str, float]):
        for i, b in enumerate(pg.bundles):
            if all(b.get(k, 0.0) >= v for k, v in resources.items()):
                return i
        return None

    def _dispatch(self, spec: LeaseRequest, node_id: str) -> None:
        spec.target_node = node_id
        with self._lock:
            client = self._clients.get(node_id)
            node = self.nodes.get(node_id)
            self._in_flight[spec.task_id] = (spec, node_id)
        if client is None or node is None or not node.alive:
            with self._cond:
                self._in_flight.pop(spec.task_id, None)
                self._pending.append(spec)
            return
        if spec.kind == "actor_method":
            # per-actor single-flight sender: preserves driver submission
            # order end-to-end (the reference's per-actor sequence-numbered
            # ordered queue, task_execution/ordered_actor_task_execution_queue.cc)
            with self._lock:
                q = self._actor_send.setdefault(spec.actor_id, deque())
                q.append((spec, node_id, client))
                if spec.actor_id in self._actor_sending:
                    return
                self._actor_sending.add(spec.actor_id)
            self._dispatch_pool.submit(self._drain_actor_sends, spec.actor_id)
            return
        if spec.kind == "actor_creation":
            # constrained routes (PG / affinity / labels) bypass
            # _send_grants; they still warrant a warm-pool hint
            self._prestart_hint(client, [spec])
        self._dispatch_pool.submit(self._dispatch_blocking, spec, node_id, client)

    def _drain_actor_sends(self, actor_id: str) -> None:
        """Single-flight per-actor sender. Everything queued while the
        previous RPC was in flight ships as ONE ordered ExecuteLeaseBatch —
        submission order is preserved (the reference's sequence-numbered
        actor queue), but the wire cost amortizes under load."""
        while True:
            with self._lock:
                q = self._actor_send.get(actor_id)
                if not q:
                    self._actor_sending.discard(actor_id)
                    return
                items = []
                while q and len(items) < 128:
                    items.append(q.popleft())
            if len(items) == 1:
                spec, node_id, client = items[0]
                self._dispatch_blocking(spec, node_id, client)
                continue
            # one batch per (node, client) run, preserving order
            i = 0
            while i < len(items):
                j = i
                client = items[i][2]
                node_id = items[i][1]
                while j < len(items) and items[j][2] is client:
                    j += 1
                self._dispatch_actor_batch(
                    [it[0] for it in items[i:j]], node_id, client
                )
                i = j

    def _dispatch_actor_batch(
        self, specs: List[LeaseRequest], node_id: str, client: RpcClient
    ) -> None:
        try:
            reply = client.call("ExecuteLeaseBatch", specs, timeout=60.0)
        except RpcError:
            with self._cond:
                for s in specs:
                    self._in_flight.pop(s.task_id, None)
            for s in specs:
                self._retry_or_fail(s, f"agent {node_id} unreachable")
            return
        for s, status in zip(specs, reply["statuses"]):
            if status == "granted":
                self.events.record(
                    s.task_id, s.name, "RUNNING", node_id, **_trace_args(s)
                )
            else:
                # actor gone on that agent: fail/requeue via the normal path
                with self._cond:
                    self._in_flight.pop(s.task_id, None)
                self._retry_or_fail(s, f"actor lease rejected by {node_id}")

    def _dispatch_blocking(
        self, spec: LeaseRequest, node_id: str, client: RpcClient
    ) -> None:
        try:
            reply = client.call("ExecuteLease", spec, timeout=30.0)
        except RpcError:
            with self._cond:
                self._in_flight.pop(spec.task_id, None)
            self._retry_or_fail(spec, f"agent {node_id} unreachable")
            return
        if reply.get("status") == "granted":
            self.events.record(
                spec.task_id, spec.name, "RUNNING", node_id,
                **_trace_args(spec)
            )
        if reply.get("status") == "reject":
            # stale view: grant-or-reject → spill back to the queue
            with self._cond:
                self.metrics["leases_spilled_back"] += 1
                self._in_flight.pop(spec.task_id, None)
                if reply.get("available") is not None:
                    node = self.nodes.get(node_id)
                    if node is not None and node.alive:
                        self.view.update_available(node_id, reply["available"])
                self._pending.append(spec)
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # actors (GcsActorManager / GcsActorScheduler analog)
    # ------------------------------------------------------------------
    def _shared_payload(self, payload):
        """The one bytes object of a large creation payload. The replicas
        of a deployment carry the same class and arguments (its weights,
        where a closure holds them: ~170 MB at ``ModelConfig()`` f32), and
        pickle writes a shared object once, so the snapshots, their
        barriers to the standbys and the WAL ship batches carry it once
        instead of once an actor (two replicas' 340 MB outgrew the RPC
        message limit, and a standby froze). Entries no spec holds go."""
        if not isinstance(payload, bytes) or len(payload) < _SHARED_PAYLOAD_MIN:
            return payload
        key = hashlib.blake2b(payload, digest_size=16).digest()
        with self._lock:
            held = {id(s.payload) for s in self._actor_specs.values()}
            self._payloads = {k: v for k, v in self._payloads.items() if id(v) in held}
            return self._payloads.setdefault(key, payload)

    def _h_create_actor(self, req: dict) -> dict:
        spec: LeaseRequest = req["spec"]
        with self._cond:
            if spec.actor_id in self._actors:
                # at-least-once redelivery (a pipelined ClientBatch whose
                # reply was lost re-sends): creating twice would run ctor
                # side effects twice and leak a pinned worker
                return {"actor_id": spec.actor_id}
        spec.payload = self._shared_payload(spec.payload)
        name = req.get("name")
        info = ActorInfo(
            actor_id=spec.actor_id,
            name=name,
            class_name=req.get("class_name", ""),
            max_restarts=req.get("max_restarts", 0),
            lifetime=req.get("lifetime"),
            owner_client=spec.client_id,
        )
        spec.actor_meta = {
            "name": name,
            "max_restarts": info.max_restarts,
            "max_concurrency": req.get("max_concurrency"),
            "concurrency_groups": req.get("concurrency_groups", {}),
            # ride to the agent so re-attach after an unpersisted head
            # restart keeps disconnect-reaping semantics
            "lifetime": info.lifetime,
            "owner_client": info.owner_client,
        }
        # ctor args stay pinned for the actor's whole life (restarts replay
        # the creation payload); released when the actor is finally DEAD
        self._register_return_holder(spec)
        with self._cond:
            if name:
                if name in self._named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = spec.actor_id
            self._actors[spec.actor_id] = info
            self._actor_specs[spec.actor_id] = spec
            self._leases[spec.task_id] = spec
            self._pending.append(spec)
            self._wal(("actor", dict(vars(info)), spec, name))
            self._cond.notify_all()
        self._wal_flush()
        self.mark_dirty()
        return {"actor_id": spec.actor_id}

    def _mark_actor_alive(self, actor_id: str, node_id: str, address: str) -> None:
        with self._cond:
            info = self._actors.get(actor_id)
            if info is None:
                return
            if info.state == "DEAD":
                # killed while its creation lease was still in flight: don't
                # resurrect — tear the instance down on the hosting agent.
                client = self._clients.get(node_id)
                if client is not None:
                    self._dispatch_pool.submit(
                        lambda: _best_effort(
                            client.call, "KillActor", {"actor_id": actor_id}
                        )
                    )
                return
            info.state = "ALIVE"
            info.node_id = node_id
            info.address = address
            # parked actor-method leases can now route
            self._pending.extend(self._infeasible)
            self._infeasible.clear()
            self._cond.notify_all()
        self.mark_dirty()

    def _h_cancel_lease(self, req: dict) -> dict:
        """Best-effort cancel by return-object id (ray.cancel parity):
        queued work (pending / infeasible / mid-schedule / agent
        dep-waiting) is dropped and its returns sealed cancelled; running
        tasks are not preempted unless force=True kills the worker — the
        reference's non-force semantics."""
        oid = req["object_id"]
        force = bool(req.get("force"))
        with self._cond:
            entry = self._objects.get(oid)
            lid = entry.creating_lease if entry is not None else None
            spec = self._leases.get(lid) if lid else None
            if spec is None:
                return {"cancelled": False, "reason": "unknown lease"}
            dropped = False
            for q in (self._pending, self._infeasible):
                for s in list(q):
                    if s.task_id == lid:
                        q.remove(s)
                        dropped = True
            # mid-schedule: the round popped it out of every queue above
            # (this window spans a slow device round and any
            # dispatched-but-uncompleted pipelined round) — flag it for
            # the dispatch-time filter
            if not dropped and any(
                s.task_id == lid
                for q in (
                    self._scheduling_batch,
                    *self._deferred_rounds.values(),
                )
                for s in q
            ):
                self._cancelled_leases.add(lid)
                dropped = True
            in_flight = self._in_flight.get(lid)
        if dropped:
            self._seal_error_ids(
                spec.return_ids, RuntimeError("task cancelled")
            )
            self._release_lease_pins(lid)
            return {"cancelled": True}
        if in_flight is not None:
            _, node_id = in_flight
            client = self._clients.get(node_id)
            if client is not None:
                if force:
                    # the kill trips the worker-death report; the flag
                    # tells the failure handler this was a cancel, not a
                    # crash to retry
                    with self._cond:
                        self._cancelled_leases.add(lid)
                try:
                    reply = client.call(
                        "CancelLease",
                        {"task_id": lid, "force": force},
                        timeout=10.0,
                    )
                    if reply.get("cancelled"):
                        with self._cond:
                            self._in_flight.pop(lid, None)
                        self._seal_error_ids(
                            spec.return_ids,
                            RuntimeError("task cancelled"),
                        )
                        self._release_lease_pins(lid)
                        return {"cancelled": True}
                except RpcError:
                    pass
                if force:
                    with self._cond:
                        self._cancelled_leases.discard(lid)
        return {"cancelled": False, "reason": "not queued"}

    def _h_pending_demands(self, req=None) -> List[Dict[str, float]]:
        """Queued + infeasible lease shapes and unplaced PG bundles — the
        autoscaler's demand source (GcsAutoscalerStateManager
        ClusterResourceState analog)."""
        with self._cond:
            parked: Dict[tuple, int] = {}
            deferred: Dict[tuple, int] = {}
            # mid-schedule leases count too, but a round can move a spec
            # into _infeasible/_pending before its finally clears the
            # batch — dedupe by identity or the autoscaler sees 2x demand
            seen: set = set()
            for q in (self._pending, self._infeasible, self._scheduling_batch):
                for s in q:
                    if not s.resources or id(s) in seen:
                        continue
                    seen.add(id(s))
                    k = _shape_key_of(s)
                    parked[k] = parked.get(k, 0) + 1
            # specs in dispatched-but-unread pipelined rounds are demand too
            for specs in self._deferred_rounds.values():
                for s in specs:
                    if not s.resources or id(s) in seen:
                        continue
                    seen.add(id(s))
                    k = _shape_key_of(s)
                    deferred[k] = deferred.get(k, 0) + 1
            device_state = self.device_state
            ring_keys = (
                list(device_state.ring_keys())
                if device_state is not None
                else []
            )
            pg_bundles = [
                dict(b)
                for pg in self._pending_pgs
                if not pg.ready.is_set() and not pg.removed
                for b in pg.bundles
            ]
        # a shape both ring-parked and riding a deferred retry round is
        # ONE logical backlog seen from two tables — max() it instead of
        # summing, or the autoscaler provisions for phantom demand
        from ray_tpu_torch.scheduler.elasticity import dedupe_task_shapes

        merged = dedupe_task_shapes(parked, deferred, ring_keys)
        out: List[Dict[str, float]] = []
        for key, n in merged.items():
            out.extend(dict(key) for _ in range(n))
        out.extend(pg_bundles)
        return out

    def _h_wait_actor(self, req: dict) -> ActorInfo:
        """Long-poll an actor's state: blocks server-side until it leaves
        PENDING/RESTARTING or the window closes (publisher.h actor-state
        channel analog; replaces 20 Hz GetActor polling from clients).
        An actor UNKNOWN at poll start is waited for within the window
        too: creations ride the pipelined client batch, so a fast caller
        (first method's direct-channel resolve) can legitimately long-poll
        before its creation message lands."""
        actor_id = req["actor_id"]
        deadline = time.monotonic() + min(float(req.get("timeout") or 2.0), 10.0)
        with self._cond:
            while True:
                info = self._actors.get(actor_id)
                if info is not None and info.state in ("ALIVE", "DEAD"):
                    return info
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if info is None:
                        raise ValueError(f"unknown actor {actor_id}")
                    return info
                self._cond.wait(remaining)

    def _h_get_actor(self, req: dict) -> ActorInfo:
        actor_id = req.get("actor_id")
        if actor_id is None:
            name = req["name"]
            actor_id = self._named_actors.get(name)
            if actor_id is None:
                raise ValueError(f"no actor named {name!r}")
        info = self._actors.get(actor_id)
        if info is None:
            raise ValueError(f"unknown actor {actor_id}")
        return info

    # ------------------------------------------------------------------
    # owner liveness + fate-sharing (GcsJobManager / worker-failure
    # ownership analog): clients hold a session lease, heartbeat it on
    # the pipelined ClientBatch, and a crashed owner is fully reaped —
    # actors killed, worker leases revoked immediately, queued/in-flight
    # tasks cancelled, unproduced objects failed with OwnerDiedError.
    # ------------------------------------------------------------------
    def _h_client_hello(self, req: dict) -> dict:
        """Connection handshake: registers the owner session (when the
        caller runs one) and hands out the cluster epoch the client
        stamps its control stream with. Fence-exempt — this IS the
        owner-side resync protocol after a head restart."""
        cid = req.get("client_id")
        if cid and req.get("session") and cfg.owner_liveness:
            self._touch_owner(cid)
        return {
            "epoch": self.cluster_epoch,
            "owner_ttl_s": float(cfg.owner_lease_ttl_s),
            "owner_liveness": bool(cfg.owner_liveness),
        }

    def _touch_owner(self, cid: str) -> None:
        with self._lock:
            sess = self._owner_sessions.get(cid)
            if sess is None:
                sess = self._owner_sessions[cid] = {"last_strike": 0.0}
            sess["last"] = time.monotonic()
            sess["strikes"] = 0

    def _h_owner_beat(self, req: dict) -> None:
        """Owner session heartbeat (ClientBatch ``owner_beat``). Also the
        re-registration path after a head restart: the first beat the
        rebuilt head sees recreates the session."""
        cid = req.get("client_id")
        if cid and cfg.owner_liveness:
            self._touch_owner(cid)

    def _check_owner_liveness(self) -> None:
        """Strike-based owner death detection (same shape as the node
        health loop): an owner that misses ``owner_miss_threshold``
        consecutive windows of ``owner_lease_ttl_s`` is declared dead and
        fully reaped. One strike per window, not per poll."""
        if not cfg.owner_liveness:
            return
        ttl = max(0.1, float(cfg.owner_lease_ttl_s))
        threshold = max(1, int(cfg.owner_miss_threshold))
        now = time.monotonic()
        dead = []
        with self._lock:
            for cid, sess in self._owner_sessions.items():
                gap = now - sess.get("last", now)
                if gap <= ttl:
                    sess["strikes"] = 0
                    continue
                if now - sess.get("last_strike", 0.0) >= ttl * 0.9:
                    sess["strikes"] = sess.get("strikes", 0) + 1
                    sess["last_strike"] = now
                if sess.get("strikes", 0) >= threshold:
                    dead.append(cid)
        for cid in dead:
            logger.warning(
                "owner %s missed %d consecutive heartbeat windows; "
                "declaring it dead and reaping",
                cid[:8],
                threshold,
            )
            self._reap_owner(cid, crashed=True, reason="owner heartbeat lost")

    def _h_disconnect_client(self, req: dict) -> None:
        """A driver disconnected cleanly: reap its NON-detached actors
        (reference job-exit semantics — actors die with their owner
        unless lifetime="detached", actor.py:1875). Detached actors are
        owned by the head and only die on explicit kill."""
        cid = req.get("client_id")
        if not cid:
            return
        self._reap_owner(cid, crashed=False, reason="client disconnected")

    def _reap_owner(self, cid: str, crashed: bool, reason: str) -> None:
        """The full owner reap. Clean disconnects return worker leases
        and kill non-detached actors; a CRASHED owner additionally has
        its queued/in-flight tasks cancelled, its unproduced objects
        failed with OwnerDiedError (fate-sharing — dependents raise a
        typed error instead of hanging forever), and its holder counts
        dropped so produced objects it alone referenced are freed."""
        with self._lock:
            self._owner_sessions.pop(cid, None)
            victims = [
                info.actor_id
                for info in self._actors.values()
                if info.owner_client == cid
                and info.lifetime != "detached"
                and info.state != "DEAD"
            ]
            dead_leases = [
                (lid, e.get("node_id"))
                for lid, e in self._task_leases.items()
                if e.get("client_id") == cid
            ]
        # cached worker leases go back to their pools IMMEDIATELY — a
        # crashed owner's leases must not pin workers for 3x TTL
        for lid, node_id in dead_leases:
            with self._cond:
                if self._drop_task_lease_locked(lid) is not None:
                    key = (
                        "task_leases_revoked"
                        if crashed
                        else "task_leases_returned"
                    )
                    self.metrics[key] += 1
                    (TASK_LEASE_REVOKED if crashed else TASK_LEASE_RETURNED).inc()
                self._cond.notify_all()
            self._wal_flush()
            if node_id:
                self._agent_return_lease(node_id, lid)
        # reap OFF the handler thread: agent kill RPCs can block up to
        # their timeout per victim, while a disconnecting client only
        # waits ~5s for this reply
        for aid in victims:
            self._dispatch_pool.submit(
                _best_effort,
                self._h_kill_actor,
                {"actor_id": aid, "no_restart": True},
            )
        if crashed:
            self._fail_owner_work(cid)
        # produced objects fate-share through the refcount: the departed
        # owner's holds drop, freeing anything it alone referenced. Clean
        # disconnects normally release everything themselves first (then
        # this is a no-op), but a bounded exit drain may leave stragglers
        # — a client that is GONE can never send those releases later.
        self._drop_holder(cid)
        OWNERS_REAPED.inc(labels={"mode": "crash" if crashed else "disconnect"})
        if victims or dead_leases or crashed:
            logger.info(
                "owner %s reaped (%s): %d actors, %d worker leases",
                cid[:8],
                reason,
                len(victims),
                len(dead_leases),
            )

    def _fail_owner_work(self, cid: str) -> None:
        """Cancel a dead owner's queued and in-flight tasks and fail their
        return objects with OwnerDiedError."""
        from ray_tpu_torch.core.object_store import OwnerDiedError

        doomed: List[LeaseRequest] = []
        in_flight: List[Tuple[str, str]] = []

        def _owned(s: LeaseRequest) -> bool:
            return s.client_id == cid and s.kind in ("task", "actor_method")

        with self._cond:
            for q in (self._pending, self._infeasible):
                kept = [s for s in q if not _owned(s)]
                doomed.extend(s for s in q if _owned(s))
                q.clear()
                q.extend(kept)
            for q in (
                self._scheduling_batch,
                # dispatched-but-uncompleted pipelined rounds: the
                # dispatch-time filter (and _fan_out_grants' unplaced
                # drop) honors the flag when the round completes
                *self._deferred_rounds.values(),
            ):
                for s in q:
                    # mid-schedule: flag for the dispatch-time filter
                    if _owned(s):
                        self._cancelled_leases.add(s.task_id)
                        doomed.append(s)
            for lid, (spec, nid) in list(self._in_flight.items()):
                if _owned(spec):
                    del self._in_flight[lid]
                    self._cancelled_leases.add(lid)
                    in_flight.append((lid, nid))
                    doomed.append(spec)
            self._cond.notify_all()
        for lid, nid in in_flight:
            client = self._clients.get(nid)
            if client is not None:
                self._dispatch_pool.submit(
                    _best_effort,
                    client.call,
                    "CancelLease",
                    {"task_id": lid, "force": False},
                )
        if not doomed:
            return
        err = OwnerDiedError(
            f"the owner of this object (client {cid[:8]}) died before the "
            "object was produced; objects fate-share with their owner"
        )
        ids = [oid for s in doomed for oid in s.return_ids]
        # keep_for_owner: the typed error must outlive the owner's holder
        # drop so dependents observe OwnerDiedError, not a generic
        # freed-object error
        self._seal_error_ids(ids, err, keep_for_owner=True)
        for s in doomed:
            if s.streaming:
                self._fail_stream(s, "owner died")
            self._release_lease_pins(s.task_id)
        logger.info(
            "owner %s: cancelled %d queued/in-flight tasks", cid[:8], len(doomed)
        )

    def _h_kill_actor(self, req: dict) -> None:
        info = self._actors.get(req["actor_id"])
        if info is None:
            return
        no_restart = req.get("no_restart", True)
        with self._lock:
            if no_restart:
                info.max_restarts = info.num_restarts  # exhaust the budget
            node_id = info.node_id
            client = self._clients.get(node_id) if node_id else None
        if client is not None:
            if no_restart:
                # permanent kill (the churn path, and what the pipelined
                # client batch carries): the actor id can never rebind to
                # a new worker, so the agent-side teardown can run off
                # this thread — a batched kill must not head-of-line
                # block the lease stream behind an agent round trip
                self._dispatch_pool.submit(
                    _best_effort,
                    client.call,
                    "KillActor",
                    {"actor_id": info.actor_id},
                )
            else:
                # restartable kill: the teardown must land BEFORE the
                # restart's creation lease can rebind this actor id on
                # the same agent, or a late KillActor would tear down
                # the replacement worker
                try:
                    client.call("KillActor", {"actor_id": info.actor_id})
                except RpcError:
                    pass
        self._restart_or_kill_actor(info, "killed by user")

    # ------------------------------------------------------------------
    # placement groups (GcsPlacementGroupManager/Scheduler analog, with the
    # batched bundle kernels + 2PC prepare/commit to agents)
    # ------------------------------------------------------------------
    def _h_create_pg(self, req: dict) -> dict:
        state = _PGState(
            pg_id=req.get("pg_id") or new_id(),
            bundles=[dict(b) for b in req["bundles"]],
            strategy=req.get("strategy", "PACK"),
            avoid_nodes=[str(n) for n in (req.get("avoid_nodes") or ())],
        )
        with self._cond:
            self._pgs[state.pg_id] = state
            self._pending_pgs.append(state)
            self._pgs_dirty = True
            self._cond.notify_all()
        return {"pg_id": state.pg_id}

    def _try_schedule_pgs(self) -> None:
        with self._lock:
            pending = list(self._pending_pgs)
            # consume the dirty bit: retry again only after the view changes
            # (node joins, reports, freed leases) — an unschedulable PG must
            # not busy-spin the scheduler thread.
            self._pgs_dirty = False
        for state in pending:
            if state.removed:
                with self._lock:
                    if state in self._pending_pgs:
                        self._pending_pgs.remove(state)
                continue
            if self._schedule_pg(state):
                with self._cond:
                    if state in self._pending_pgs:
                        self._pending_pgs.remove(state)
                    self._pending.extend(self._infeasible)
                    self._infeasible.clear()
                    self._cond.notify_all()

    def _schedule_pg(self, state: _PGState) -> bool:
        # device residency for the bundle packer too: when the scheduler
        # device is up, the PACK/SPREAD kernels read the RESIDENT arrays
        # (delta-synced dirty rows) instead of re-uploading a fresh host
        # copy of the cluster matrices per PG attempt. The capacity rows
        # beyond num_nodes are alive=False and score out of every kernel.
        # Rounds replace device_state._avail with a new tensor and never
        # write the old one in place, so a pack in flight keeps its inputs.
        device_state = self.device_state
        with self._lock:
            num_nodes = self.view.num_nodes
            any_alive = bool(self.view.alive.any())
            width = self.view.totals.shape[1]
            if device_state is not None and num_nodes > 0:
                device_state.sync(self.view)
                totals, avail, alive = device_state.resident_arrays()
            else:
                t0, a0, al0 = self.view.active_arrays()
                totals, avail, alive = t0.copy(), a0.copy(), al0.copy()
        if num_nodes == 0 or not any_alive:
            return False
        bundles = np.stack(
            [
                ResourceRequest.from_map(self.vocab, b).dense(width)
                for b in state.bundles
            ]
        )
        if state.avoid_nodes:
            from ray_tpu_torch.scheduler.bundles import (
                schedule_bundles_soft_avoid,
            )

            # rows are resolved under a later lock window than the
            # arrays snapshot (and a client-supplied node id can intern
            # a fresh row past it) — the helper bounds-guards them
            with self._lock:
                rows_to_avoid = [
                    self.view.row_if_known(n) for n in state.avoid_nodes
                ]
            rows, success, _ = schedule_bundles_soft_avoid(
                totals, avail, alive, bundles, state.strategy,
                rows_to_avoid, device=self.sched_device,
            )
        else:
            rows, success, _ = schedule_bundles(
                totals, avail, alive, bundles, state.strategy,
                device=self.sched_device,
            )
        if not success:
            return False
        chosen = [self.view.node_id(int(r)) for r in rows]
        # Pipelined 2PC (PrepareBundleResources/CommitBundleResources,
        # gcs_placement_group_scheduler.cc:192,219): prepares go out to
        # every involved agent CONCURRENTLY and the PG turns ready as soon
        # as the full quorum of prepare acks is in; commits are fired
        # asynchronously after that (agents admit leases against prepared
        # entries, so the commit flip is bookkeeping, not a gate). The old
        # serial prepare→serial commit chain cost one RPC round trip per
        # node per phase on the scheduler thread.
        by_node: Dict[str, List[int]] = {}
        for i, nid in enumerate(chosen):
            by_node.setdefault(nid, []).append(i)

        def prepare(nid: str, idxs: List[int]) -> bool:
            client = self._clients.get(nid)
            try:
                reply = client.call(
                    "PrepareBundles",
                    {
                        "pg_id": state.pg_id,
                        "bundles": {i: state.bundles[i] for i in idxs},
                    },
                )
                return bool(reply.get("ok"))
            except (RpcError, AttributeError):
                return False

        items = list(by_node.items())
        if len(items) == 1:
            acks = [prepare(*items[0])]
        else:
            futs = [
                self._dispatch_pool.submit(prepare, nid, idxs)
                for nid, idxs in items
            ]
            acks = [f.result() for f in futs]
        prepared = [nid for (nid, _), ack in zip(items, acks) if ack]
        if not all(acks):
            # rollback stays SYNCHRONOUS: a retry of this PG can start the
            # moment we return False, and a stale async rollback landing
            # after the retry's successful prepare would destroy the new
            # prepared entry on the agent (failure-path latency is free;
            # only the happy path needed pipelining)
            for nid in prepared:
                client = self._clients.get(nid)
                if client is not None:
                    _best_effort(
                        client.call,
                        "RollbackBundles",
                        {"pg_id": state.pg_id},
                    )
            return False
        for nid in prepared:
            client = self._clients.get(nid)
            if client is not None:
                self._dispatch_pool.submit(
                    _best_effort,
                    client.call,
                    "CommitBundles",
                    {"pg_id": state.pg_id},
                )
        with self._lock:
            for i, nid in enumerate(chosen):
                self.view.subtract(self.view.row_of(nid), bundles[i])
        state.node_per_bundle = chosen
        state.ready.set()
        return True

    def _h_wait_pg(self, req: dict) -> dict:
        state = self._pgs.get(req["pg_id"])
        if state is None:
            raise ValueError(f"unknown placement group {req['pg_id']}")
        t = req.get("timeout")
        ready = state.ready.wait(min(2.0 if t is None else t, 10.0))
        return {
            "ready": ready,
            "node_per_bundle": state.node_per_bundle if ready else [],
        }

    def _h_remove_pg(self, req: dict) -> None:
        state = self._pgs.get(req["pg_id"])
        if state is None:
            return
        state.removed = True
        involved = set(state.node_per_bundle)
        refund: Dict[str, np.ndarray] = {}
        if state.ready.is_set():
            with self._lock:
                width = self.view.active_arrays()[0].shape[1]
            for i, nid in enumerate(state.node_per_bundle):
                d = ResourceRequest.from_map(self.vocab, state.bundles[i]).dense(
                    width
                )
                refund[nid] = refund.get(nid, 0) + d
        for nid in involved:
            client = self._clients.get(nid)
            if client is None:
                continue
            try:
                client.call("ReturnBundles", {"pg_id": state.pg_id})
            except RpcError:
                continue
            with self._lock:
                node = self.nodes.get(nid)
                if nid in refund and node is not None and node.alive:
                    self.view.add(self.view.row_of(nid), refund[nid])

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def metrics_text(self) -> str:
        """The head scrape body (dashboard /metrics): dark-plane
        counters synced, the head's hand-counted table and cluster
        gauges published typed, the head's own registry merged into the
        federation (node="head", role="head", cumulative), and the whole
        federated registry — agents' and workers' shipped deltas
        included — rendered as one parser-valid exposition."""
        from ray_tpu_torch.util.metrics import (
            registry_dump,
            sync_counter,
            sync_gauge,
        )

        try:
            from .event_loop import publish_dark_plane

            publish_dark_plane()
        except Exception:  # noqa: BLE001 - dark-plane sync is optional
            pass
        info = self._h_cluster_info(None)
        for name, value in info["metrics"].items():
            # the historical hand-rolled scrape names (ray_tpu_*) stay,
            # now typed through the registry instead of string-built
            sync_counter(
                f"ray_tpu_{name}", float(value),
                "Head lifecycle counter (HeadServer.metrics table).",
            )
        alive = sum(1 for n in info["nodes"] if n["Alive"])
        sync_gauge(
            "ray_tpu_nodes_alive", float(alive), "Live nodes in the view."
        )
        for n in info["nodes"]:
            for res, avail_v in (n["Available"] or {}).items():
                safe = (
                    res.replace("-", "_").replace(".", "_").replace("/", "_")
                )
                self._node_avail_gauge.set(
                    float(avail_v),
                    {"node": n["NodeID"], "resource": safe},
                )
        self.federation.apply("head", "head", registry_dump(), replace=True)
        return self.federation.text()

    def _dump_crash_bundle(self, reason: str) -> None:
        """Flight-recorder trigger (async: file I/O stays off whatever
        failure path tripped it; the recorder's own throttle bounds
        storms)."""
        if not cfg.crash_bundles:
            return
        from ray_tpu_torch.util import flight_recorder

        if flight_recorder.throttled():
            return  # storm: don't even burn a pool slot
        try:
            self._dispatch_pool.submit(self._dump_crash_bundle_now, reason)
        except RuntimeError:  # pool shut down
            pass

    def _dump_crash_bundle_now(self, reason: str) -> Optional[str]:
        from ray_tpu_torch.util import flight_recorder

        if flight_recorder.throttled():
            # re-checked here: the expensive QueryState snapshots below
            # must not run for a dump the recorder would discard
            return None
        try:
            state = {
                "summary": self._h_query_state({"kind": "summary"}),
                "sched": self._h_query_state({"kind": "sched"}),
            }
        except Exception:  # noqa: BLE001 - partial state beats none
            state = {}
        return flight_recorder.dump_bundle(
            reason,
            events=self.events,
            state=state,
            metrics_text=self.metrics_text,
            extra_meta={"epoch": self.cluster_epoch, "role": self.role},
        )

    def _h_cluster_info(self, req) -> dict:
        with self._lock:
            totals, avail, _ = self.view.active_arrays()
            busy_nodes = {nid for _, nid in self._in_flight.values()}
            for info in self._actors.values():
                if info.state == "ALIVE" and info.node_id:
                    busy_nodes.add(info.node_id)
            nodes = []
            for nid, n in self.nodes.items():
                row = self.view.row_of(nid) if n.alive else None
                nodes.append(
                    {
                        "NodeID": nid,
                        "Alive": n.alive,
                        "Address": n.address,
                        "Resources": dict(n.resources),
                        "Available": self.vocab.unpack(avail[row])
                        if row is not None
                        else {},
                        "Labels": dict(n.labels),
                        # zero-resource work keeps Available==Resources: the
                        # autoscaler needs a liveness signal beyond arithmetic
                        "Busy": nid in busy_nodes,
                    }
                )
        return {"nodes": nodes, "metrics": dict(self.metrics)}

    # ------------------------------------------------------------------
    # elastic-training gang membership (train/elastic.py rides these).
    # The head is the epoch AUTHORITY: the health loop's node-death
    # verdict bumps every gang with a member on the corpse, the owning
    # driver mirrors the epoch into the gang's rendezvous hub, and any
    # collective contribution stamped with a dead epoch is rejected at
    # the hub exactly like a stale control RPC at the cluster fence.
    # ------------------------------------------------------------------
    def _h_gang_register(self, req: dict) -> dict:
        gid = req["gang_id"]
        members = {int(r): str(n) for r, n in (req.get("members") or {}).items()}
        with self._cond:
            prev = self._gangs.get(gid)
            # monotone across generations AND head failovers: the owner
            # passes the last epoch it saw as a floor after re-connecting
            # to a promoted head that lost the (ephemeral) gang table
            floor = max(
                int(req.get("epoch_floor", 0)),
                prev["epoch"] if prev else 0,
            )
            epoch = floor + 1
            self._gangs[gid] = {
                "epoch": epoch,
                "owner": str(req.get("owner", "")),
                "members": members,
                "min_size": int(req.get("min_size", 1)),
                "dead_ranks": [],
                "updated": time.monotonic(),
                # unified elasticity plane: the driver declares
                # its grow-back want so the controller can put the
                # gang's deficit into the demand matrix; world_hint is
                # the controller's last solver verdict (sustainable
                # world size), polled by the driver via GangHint. A
                # re-register (new generation) keeps no stale hint.
                "want_world": int(req.get("want_world", 0)),
                "resources_per_rank": dict(
                    req.get("resources_per_rank") or {}
                ),
                "grow": bool(req.get("grow", False)),
                "world_hint": None,
            }
            self._cond.notify_all()
        GANG_EPOCH_BUMPS.inc(labels={"reason": "register"})
        return {"epoch": epoch}

    def _h_gang_hint(self, req: dict) -> dict:
        """Driver poll of the elasticity controller's world-size verdict
        for one gang: ``{"world_hint": int|None, "epoch": int}``. None
        means the controller has not judged this gang (or is off) — the
        driver falls back to its legacy capacity probe."""
        with self._cond:
            g = self._gangs.get(req["gang_id"])
            if g is None:
                return {"world_hint": None, "epoch": 0}
            return {
                "world_hint": g.get("world_hint"),
                "epoch": g["epoch"],
            }

    def _h_gang_sync(self, req: dict) -> dict:
        """Long-poll the gang's membership epoch: returns immediately
        when the head's epoch differs from the caller's, else parks up
        to min(timeout, cfg.gang_sync_max_wait_s) on the head cond (the
        node-death bump notifies it)."""
        gid = req["gang_id"]
        known = int(req.get("epoch", -1))
        wait_s = min(
            float(req.get("timeout", 0.0)), float(cfg.gang_sync_max_wait_s)
        )
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while True:
                g = self._gangs.get(gid)
                if g is None:
                    return {"epoch": 0, "members": {}, "dead_ranks": []}
                now = time.monotonic()
                if g["epoch"] != known or now >= deadline or self._shutdown:
                    return {
                        "epoch": g["epoch"],
                        "members": {
                            str(r): n for r, n in g["members"].items()
                        },
                        "dead_ranks": list(g["dead_ranks"]),
                    }
                self._cond.wait(timeout=min(1.0, deadline - now))

    def _h_gang_fence(self, req: dict) -> dict:
        """Owner-requested epoch bump: resize/grow decisions and actor-
        level deaths the driver observed before the health loop did."""
        gid = req["gang_id"]
        with self._cond:
            g = self._gangs.get(gid)
            if g is None:
                return {"epoch": 0}
            g["epoch"] += 1
            g["updated"] = time.monotonic()
            epoch = g["epoch"]
            self._cond.notify_all()
        GANG_EPOCH_BUMPS.inc(
            labels={"reason": str(req.get("reason", "fence"))}
        )
        return {"epoch": epoch}

    def _h_gang_unregister(self, req: dict) -> None:
        with self._cond:
            self._gangs.pop(req["gang_id"], None)
            self._cond.notify_all()

    def _gangs_note_node_death(self, node_id: str) -> None:
        """Health-loop feed into the membership protocol: any gang with
        a member on the dead node advances its epoch, so in-flight
        collectives of the dead generation are rejected as stale the
        moment the owner (or any rank) next touches the hub."""
        bumped = []
        with self._cond:
            for gid, g in self._gangs.items():
                dead = [
                    r for r, n in g["members"].items() if n == node_id
                ]
                if not dead:
                    continue
                g["epoch"] += 1
                g["updated"] = time.monotonic()
                seen = set(g["dead_ranks"])
                g["dead_ranks"].extend(
                    r for r in dead if r not in seen
                )
                bumped.append((gid, g["epoch"], dead))
            if bumped:
                self._cond.notify_all()
        for gid, epoch, dead in bumped:
            GANG_EPOCH_BUMPS.inc(labels={"reason": "node_death"})
            logger.warning(
                "gang %s: node %s died with rank(s) %s; epoch -> %d",
                gid,
                node_id,
                dead,
                epoch,
            )

    def _h_report_serve_state(self, req: dict) -> dict:
        with self._lock:
            self._serve_state[
                (req.get("client_id", ""), req.get("deployment", ""))
            ] = {"state": req.get("state") or {}, "ts": time.time()}
        return {"ok": True}

    # ------------------------------------------------------------------
    # router-fleet control plane (horizontally scaled ingress): the head
    # owns the tenant->router assignment table (epoch-fenced, WAL-
    # persisted) and the stream-lease checkpoints that make router
    # failover token-exact. Steady-state serving makes ZERO of these
    # calls — only membership changes, one batched checkpoint per
    # reconcile window per fleet, and budget reconciliation at
    # cfg.serve_budget_reconcile_s cadence touch the head.
    # ------------------------------------------------------------------
    def _serve_fence_locked(
        self, deployment: str, epoch: int
    ) -> Optional[dict]:
        """Assignment-epoch fence (caller holds self._lock): a control
        RPC stamped with a stale fleet epoch gets a typed stale reply —
        the sender was deposed and must refresh its assignment before
        touching stream leases or budgets again."""
        f = self._serve_fleets.get(deployment)
        cur = int(f["epoch"]) if f else 0
        if int(epoch) != cur:
            return {"stale": True, "epoch": cur}
        return None

    def _h_serve_fleet_join(self, req: dict) -> dict:
        dep = req["deployment"]
        rid = req["router_id"]
        with self._lock:
            f = self._serve_fleets.setdefault(
                dep, {"epoch": 0, "members": []}
            )
            if rid not in f["members"]:
                f["members"] = sorted(f["members"] + [rid])
                f["epoch"] = int(f["epoch"]) + 1
                self._wal(
                    (
                        "serve_fleet",
                        {
                            "deployment": dep,
                            "epoch": f["epoch"],
                            "members": list(f["members"]),
                        },
                    )
                )
            reply = {"epoch": f["epoch"], "members": list(f["members"])}
        self._wal_flush()
        return reply

    def _h_serve_fleet_leave(self, req: dict) -> dict:
        dep = req["deployment"]
        rid = req["router_id"]
        with self._lock:
            f = self._serve_fleets.setdefault(
                dep, {"epoch": 0, "members": []}
            )
            if rid in f["members"]:
                f["members"] = [m for m in f["members"] if m != rid]
                f["epoch"] = int(f["epoch"]) + 1
                self._wal(
                    (
                        "serve_fleet",
                        {
                            "deployment": dep,
                            "epoch": f["epoch"],
                            "members": list(f["members"]),
                        },
                    )
                )
            (self._serve_budget.get(dep) or {}).pop(rid, None)
            reply = {"epoch": f["epoch"], "members": list(f["members"])}
        self._wal_flush()
        return reply

    def _h_serve_assignment(self, req: dict) -> dict:
        with self._lock:
            f = self._serve_fleets.get(req["deployment"]) or {
                "epoch": 0,
                "members": [],
            }
            return {"epoch": f["epoch"], "members": list(f["members"])}

    def _h_serve_stream_acquire(self, req: dict) -> dict:
        dep = req["deployment"]
        with self._lock:
            stale = self._serve_fence_locked(dep, req.get("epoch", 0))
            if stale is not None:
                return stale
            sid = req["stream_id"]
            row = self._serve_streams.get(sid) or {
                "stream_id": sid,
                "deployment": dep,
                "tenant": req.get("tenant", "default"),
                "delivered": 0,
            }
            row["router_id"] = req["router_id"]
            row["delivered"] = max(
                int(row.get("delivered", 0)),
                int(req.get("delivered", 0)),
            )
            row["ts"] = time.time()
            self._serve_streams[sid] = row
            self._wal(("serve_stream", dict(row)))
            reply = {"row": dict(row)}
        self._wal_flush()
        return reply

    def _h_serve_stream_ckpt(self, req: dict) -> dict:
        dep = req["deployment"]
        rid = req["router_id"]
        with self._lock:
            stale = self._serve_fence_locked(dep, req.get("epoch", 0))
            if stale is not None:
                return stale
            applied = 0
            for sid, delivered in (req.get("ckpts") or {}).items():
                row = self._serve_streams.get(sid)
                if row is None or row.get("router_id") != rid:
                    # the stream moved to a sibling after this batch was
                    # cut: its checkpoint is stale, drop it
                    continue
                nxt = max(int(row.get("delivered", 0)), int(delivered))
                if nxt == row.get("delivered"):
                    continue
                row["delivered"] = nxt
                row["ts"] = time.time()
                # one WAL record per stream id: the replication layer
                # shards records by stream_id, a batched record could
                # not be routed to owner shards
                self._wal(
                    (
                        "serve_stream_ckpt",
                        {
                            "stream_id": sid,
                            "delivered": nxt,
                            "router_id": rid,
                        },
                    )
                )
                applied += 1
            reply = {"ok": True, "applied": applied}
        self._wal_flush()
        return reply

    def _h_serve_stream_release(self, req: dict) -> dict:
        with self._lock:
            dropped = 0
            for sid in req.get("stream_ids") or ():
                if self._serve_streams.pop(sid, None) is not None:
                    self._wal(("serve_stream_gone", sid))
                    dropped += 1
            reply = {"ok": True, "dropped": dropped}
        self._wal_flush()
        return reply

    def _h_serve_stream_lookup(self, req: dict) -> dict:
        with self._lock:
            row = self._serve_streams.get(req.get("stream_id", ""))
            return {"row": dict(row) if row else None}

    def _h_serve_budget(self, req: dict) -> dict:
        """Budget reconciliation: fold this router's per-tenant usage/
        demand report in, prune stale or deposed reporters, and hand
        back its share of the GLOBAL admission rate (∝ summed WFQ
        weights of its active tenants) plus the cluster-headroom bit
        that fixes shed retry hints."""
        from ray_tpu_torch.serve.fleet import compute_budget_shares

        dep = req["deployment"]
        rid = req["router_id"]
        window = max(0.05, float(cfg.serve_budget_reconcile_s))
        with self._lock:
            stale = self._serve_fence_locked(dep, req.get("epoch", 0))
            if stale is not None:
                return stale
            members = set(
                (self._serve_fleets.get(dep) or {}).get("members", ())
            )
            reports = self._serve_budget.setdefault(dep, {})
            reports[rid] = {
                "usage": dict(req.get("usage") or {}),
                "waiting": dict(req.get("waiting") or {}),
                "weights": dict(req.get("weights") or {}),
                "pressure": dict(req.get("pressure") or {}),
                "ts": time.monotonic(),
            }
            now = time.monotonic()
            for other in list(reports):
                if other not in members or now - reports[other][
                    "ts"
                ] > max(3.0, 4 * window):
                    del reports[other]
            shares = compute_budget_shares(
                reports,
                float(cfg.serve_admission_qps),
                float(cfg.serve_admission_burst),
                window,
            )
            share = shares.get(rid) or {
                "rate": 0.0,
                "burst": float(cfg.serve_admission_burst),
                "headroom": True,
            }
            # serve pressure → scheduler demand rows: fold the
            # fleet's queued prefill tokens through the autoscaler
            # kernel against the alive nodes' residual CPU rows; the
            # hint rides the reply back to the fleet's SLO autoscaler
            avail = [
                float((n.resources or {}).get("CPU", 0.0))
                for n in self.nodes.values()
                if getattr(n, "alive", True)
            ]
            snapshot = {r: dict(rep) for r, rep in reports.items()}
        hint = None
        # unified elasticity plane: when the controller is on
        # and has a fresh solver verdict for this deployment, it IS the
        # capacity hint — one solve sized serve, gangs, and tasks
        # together, so the one-shot plan below would just disagree with
        # what the fleet was actually granted.
        if cfg.elastic_controller:
            with self._lock:
                row = self._serve_capacity_hints.get(dep)
            if (
                row is not None
                and (row.get("hint") or {}).get("source")
                == "elastic_controller"
                and time.monotonic() - row.get("ts", 0.0)
                <= max(3.0, 4 * float(cfg.elastic_tick_s))
            ):
                hint = dict(row["hint"])
        if hint is None:
            try:
                from ray_tpu_torch.scheduler.serve_demand import (
                    capacity_plan,
                    pressure_rollup,
                )

                pressure = pressure_rollup(snapshot)
                if pressure:
                    hint = capacity_plan(avail, pressure, device=self.sched_device)
            except Exception:  # noqa: BLE001 - hint is advisory
                hint = None
            with self._lock:
                self._serve_capacity_hints[dep] = {
                    "hint": hint,
                    "ts": time.monotonic(),
                }
        # the hint key is ALWAYS present — a None is the positive
        # "demand drained" signal that lets the fleet clear its
        # hold-capacity latch immediately instead of waiting out the
        # staleness window (hold-capacity latch fix)
        reply = {**share, "window_s": window}
        reply["capacity_hint"] = hint
        return reply

    def _replay_weights_epoch(self, row: dict) -> None:
        """Apply one ``weights_epoch`` WAL record (seal or commit phase).
        Shared by replay-after-restart and the standby's replication
        apply path — both must converge on the leader's exact state."""
        dep = row["deployment"]
        w = self._weights_epochs.setdefault(
            dep, {"committed": 0, "meta": {}, "sealed": None}
        )
        if row.get("phase") == "seal":
            w["sealed"] = {
                "epoch": int(row["epoch"]),
                "meta": dict(row.get("meta", {})),
            }
        else:  # commit
            w["committed"] = int(row["epoch"])
            w["meta"] = dict(row.get("meta", {}))
            w["sealed"] = None

    def _h_weights_publish_seal(self, req: dict) -> dict:
        """Phase 1 of a weights publish: reserve committed+1 and WAL the
        seal. A re-seal (publisher retrying after a head death) simply
        supersedes any dangling sealed phase — only a commit that names
        the currently sealed epoch lands, so the fence can never tear."""
        dep = req["deployment"]
        with self._lock:
            w = self._weights_epochs.setdefault(
                dep, {"committed": 0, "meta": {}, "sealed": None}
            )
            epoch = int(w["committed"]) + 1
            meta = dict(req.get("meta") or {})
            w["sealed"] = {"epoch": epoch, "meta": meta}
            self._wal(
                (
                    "weights_epoch",
                    {
                        "deployment": dep,
                        "phase": "seal",
                        "epoch": epoch,
                        "meta": meta,
                    },
                )
            )
            reply = {"epoch": epoch, "committed": int(w["committed"])}
        self._wal_flush()
        return reply

    def _h_weights_publish_commit(self, req: dict) -> dict:
        """Phase 2: flip the sealed epoch to committed. Stale-fenced like
        gang epochs — a commit for anything other than the currently
        sealed epoch is rejected so a deposed publisher (or a retry that
        raced a newer seal) can never clobber the fence."""
        dep = req["deployment"]
        epoch = int(req["epoch"])
        with self._lock:
            w = self._weights_epochs.setdefault(
                dep, {"committed": 0, "meta": {}, "sealed": None}
            )
            sealed = w.get("sealed")
            if int(w["committed"]) >= epoch:
                # idempotent re-commit after a lost reply
                reply = {"committed": int(w["committed"]), "stale": False}
            elif sealed is None or int(sealed["epoch"]) != epoch:
                reply = {"committed": int(w["committed"]), "stale": True}
            else:
                w["committed"] = epoch
                w["meta"] = dict(sealed.get("meta", {}))
                w["sealed"] = None
                self._wal(
                    (
                        "weights_epoch",
                        {
                            "deployment": dep,
                            "phase": "commit",
                            "epoch": epoch,
                            "meta": w["meta"],
                        },
                    )
                )
                reply = {"committed": epoch, "stale": False}
        self._wal_flush()
        return reply

    def _h_weights_epoch_get(self, req: dict) -> dict:
        with self._lock:
            w = self._weights_epochs.get(req["deployment"])
            if w is None:
                return {"committed": 0, "meta": {}, "sealed": None}
            return {
                "committed": int(w["committed"]),
                "meta": dict(w.get("meta", {})),
                "sealed": dict(w["sealed"]) if w.get("sealed") else None,
            }

    def _h_query_state(self, req: dict) -> Any:
        kind = req.get("kind", "summary")
        if kind == "explain_placement":
            # scheduler decision attribution: the five
            # per-term cost contributions of one task's winning placement
            return self.explain_placement(req.get("task_id", ""))
        if kind == "metrics_text":
            # the federated scrape body over RPC (dashboard-less tests,
            # remote bundle collection)
            return self.metrics_text()
        if kind == "rpc_handlers":
            # per-handler timing (instrumented_io_context stats analog)
            from .rpc import HANDLER_STATS

            return HANDLER_STATS.snapshot()
        if kind == "object_plane":
            # cross-node transport: peer-link table occupancy + grant/
            # revoke lifecycle counts and the head-process transfer
            # counters (agents expose their own via DebugState "net")
            from .object_plane import (
                OBJECT_TRANSFER_BYTES,
                PEER_CONN_REUSED,
                TRANSFER_STRIPE_MS,
            )

            with self._lock:
                links = [
                    self._peer_link_row(e)
                    for e in self._peer_links.values()
                ]
            return {
                "peer_links": links,
                "peer_link_count": len(links),
                "peer_links_granted": self.metrics["peer_links_granted"],
                "peer_links_revoked": self.metrics["peer_links_revoked"],
                "peer_links_reused": int(PEER_CONN_REUSED.value()),
                "transfer_bytes": {
                    path: int(OBJECT_TRANSFER_BYTES.value({"path": path}))
                    for path in ("shm", "inline", "rpc", "socket")
                },
                "transfer_stripe_ms": TRANSFER_STRIPE_MS.summary(),
            }
        if kind == "gangs":
            # elastic-training membership: epoch + member map per gang
            with self._lock:
                return {
                    gid: {
                        "epoch": g["epoch"],
                        "owner": g["owner"],
                        "members": {
                            str(r): n for r, n in g["members"].items()
                        },
                        "min_size": g["min_size"],
                        "dead_ranks": list(g["dead_ranks"]),
                        "want_world": g.get("want_world", 0),
                        "grow": g.get("grow", False),
                        "world_hint": g.get("world_hint"),
                    }
                    for gid, g in self._gangs.items()
                }
        if kind == "weights_epochs":
            # online-RL publish fence: committed epoch + any in-flight
            # sealed phase per deployment
            with self._lock:
                return {
                    dep: {
                        "committed": int(w["committed"]),
                        "meta": dict(w.get("meta", {})),
                        "sealed": dict(w["sealed"])
                        if w.get("sealed")
                        else None,
                    }
                    for dep, w in self._weights_epochs.items()
                }
        if kind == "elasticity":
            # unified elasticity plane: tick latency
            # percentiles, last actuation plan, drain table
            ctrl = getattr(self, "_elasticity", None)
            if ctrl is None:
                return {"enabled": False}
            state = ctrl.state()
            state["enabled"] = bool(cfg.elastic_controller)
            with self._lock:
                state["draining_nodes"] = {
                    n: round(d - time.monotonic(), 2)
                    for n, d in self._draining_nodes.items()
                }
            return state
        if kind == "replication":
            # replicated control plane: role, shipping stream position,
            # per-standby follower lag, owner-shard occupancy, pending
            # revocation fan-outs
            repl = self._repl.state()
            with self._lock:
                shards = {
                    "objects": self._objects.shard_sizes(),
                    "task_leases": self._task_leases.shard_sizes(),
                    "peer_links": self._peer_links.shard_sizes(),
                }
                pending_revokes = len(self._pending_revokes)
            from .replication import FAILOVER_MS

            return {
                "role": self.role,
                "epoch": self.cluster_epoch,
                "fenced": self._fenced,
                "leader_hint": self._leader_hint,
                "last_shipped_seq": repl["seq"],
                "ring_records": repl["ring_records"],
                "standbys": repl["standbys"],
                "follower_lag_records": max(
                    (s["lag_records"] for s in repl["standbys"]),
                    default=0,
                ),
                "shards": shards,
                "pending_revokes": pending_revokes,
                "failover_ms": FAILOVER_MS.summary(),
            }
        if kind == "hotpath":
            # execution-plane hot path: framing-path selection + native
            # vs fallback counters, fused-event-loop occupancy, ring
            # fill levels, live pipelines, dispatch decomposition — the
            # head process's own view (owners/agents expose theirs via
            # the agent DebugState "hotpath" block)
            from .event_loop import hotpath_state

            return hotpath_state()
        with self._lock:
            if kind == "actors":
                return [dict(vars(a)) for a in self._actors.values()]
            if kind == "objects":
                return [
                    {
                        "object_id": oid,
                        "sealed": e.event.is_set(),
                        "size": e.size,
                        "locations": sorted(e.locations),
                        "error": e.error is not None,
                    }
                    for oid, e in self._objects.items()
                ]
            if kind == "placement_groups":
                return [
                    {
                        "pg_id": p.pg_id,
                        "strategy": p.strategy,
                        "ready": p.ready.is_set(),
                        "bundles": p.bundles,
                        "nodes": p.node_per_bundle,
                    }
                    for p in self._pgs.values()
                ]
            if kind == "leases":
                return {
                    "pending": len(self._pending),
                    "infeasible": len(self._infeasible),
                    "in_flight": len(self._in_flight),
                }
            if kind == "sched":
                # the scheduling plane: round-latency decomposition,
                # pipeline occupancy, delta-sync and parked-ring state,
                # multi-objective weights + starvation/preemption state,
                # and the autoscaler solver's health — observable without
                # a bench run
                from ray_tpu_torch.scheduler.binpack import (
                    SOLVER_FALLBACKS,
                    SOLVER_ITERS,
                    SOLVER_RUNS,
                )
                from ray_tpu_torch.scheduler.device import score_weights_from_cfg

                ds = self.device_state
                return {
                    "pipeline_enabled": bool(cfg.sched_pipeline),
                    "pipeline": (
                        self._pipeline.stats()
                        if self._pipeline is not None
                        else None
                    ),
                    "rounds_deferred": len(self._deferred_rounds),
                    "round_ms": SCHED_ROUND_MS.summary(),
                    "upload_ms": SCHED_UPLOAD_MS.summary(),
                    "kernel_ms": SCHED_KERNEL_MS.summary(),
                    "readback_ms": SCHED_READBACK_MS.summary(),
                    # device stats carry the delta-sync counters incl.
                    # delta_rows_hwm (largest single dirty-row push)
                    "device": dict(ds.stats) if ds is not None else None,
                    "delta_rows_hwm": (
                        ds.stats.get("delta_rows_hwm", 0)
                        if ds is not None
                        else 0
                    ),
                    "ring_occupancy": (
                        ds.ring_occupancy() if ds is not None else 0
                    ),
                    "ring_slots": ds.ring_slots if ds is not None else 0,
                    "unparked_via_ring": self.metrics.get(
                        "leases_unparked_ring", 0
                    ),
                    "sched_rounds": self.metrics["sched_rounds"],
                    "score_weights": tuple(score_weights_from_cfg()),
                    "shape_wait_max_rounds": (
                        max(self._shape_wait.values())
                        if self._shape_wait
                        else 0
                    ),
                    "shapes_waiting": len(self._shape_wait),
                    "preempt_nominations": self.metrics[
                        "preempt_nominations"
                    ],
                    "preemptions": self.metrics["preemptions"],
                    "preemptions_by_kind": (
                        SCHED_PREEMPTIONS.values_by_label()
                    ),
                    # locality-scored placement: hit_frac_sum / scored ==
                    # the shuffle plane's locality hit-rate
                    "locality": {
                        "scored": SCHED_LOCALITY_SCORED.value(),
                        "hit_frac_sum": round(
                            SCHED_LOCALITY_HIT_FRAC.value(), 3
                        ),
                    },
                    "autoscaler_solver": {
                        "runs": SOLVER_RUNS.value(),
                        "fallbacks": SOLVER_FALLBACKS.value(),
                        "iters_per_solve": SOLVER_ITERS.value(),
                    },
                }
            if kind == "serve":
                # the serving plane, as last reported by each ingress
                # router: replica tables, lease-hit and prefix-cache hit
                # rates, admission/shed counters, latency summaries
                now = time.time()
                deployments = {}
                for (cid, dep), entry in list(self._serve_state.items()):
                    if now - entry["ts"] > 30.0:
                        del self._serve_state[(cid, dep)]
                        continue
                    blob = dict(entry["state"])
                    blob["reporter"] = cid
                    blob["age_s"] = round(now - entry["ts"], 2)
                    deployments[dep] = blob
                return {
                    "deployments": deployments,
                    # router-fleet assignment tables: epoch + member
                    # list per deployment (the ring derives from these)
                    "fleets": {
                        dep: dict(f)
                        for dep, f in self._serve_fleets.items()
                    },
                    "stream_leases": len(self._serve_streams),
                    # per-tenant serve pressure (queued prefill tokens)
                    # as last reported through the budget RPCs, plus the
                    # scheduler kernel's capacity verdict on it
                    "pressure": {
                        dep: {
                            rid: dict(rep.get("pressure") or {})
                            for rid, rep in reports.items()
                        }
                        for dep, reports in self._serve_budget.items()
                    },
                    # hint timestamps are monotonic (stored at budget
                    # reconcile time), so age against the same clock
                    "capacity_hints": {
                        dep: entry.get("hint")
                        for dep, entry in (
                            self._serve_capacity_hints.items()
                        )
                        if time.monotonic() - entry.get("ts", 0) < 30.0
                    },
                }
            if kind == "dispatch":
                # the task-lease dispatch plane (lease-cached direct
                # dispatch): active leases + per-owner counts + lifecycle
                per_owner: Dict[str, int] = {}
                for e in self._task_leases.values():
                    per_owner[e["client_id"]] = (
                        per_owner.get(e["client_id"], 0) + 1
                    )
                return {
                    "task_leases": [
                        {
                            "lease_id": e["lease_id"],
                            "state": e["state"],
                            "client_id": e["client_id"],
                            "node_id": e["node_id"],
                            "fn_id": e["fn_id"],
                            "resources": dict(e["resources"]),
                        }
                        for e in self._task_leases.values()
                    ],
                    "per_owner": per_owner,
                    "granted": self.metrics["task_leases_granted"],
                    "returned": self.metrics["task_leases_returned"],
                    "revoked": self.metrics["task_leases_revoked"],
                }
            return {
                "metrics": dict(self.metrics),
                "num_nodes": sum(1 for n in self.nodes.values() if n.alive),
                "num_actors": len(self._actors),
                "num_objects": len(self._objects),
            }

    def shutdown(self, stop_agents: bool = True) -> None:
        """Stop the head. With ``stop_agents=False`` the agents (and their
        actors) keep running — the head-restart recovery path."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if getattr(self, "_elasticity", None) is not None:
            self._elasticity.stop()
        self._repl.stop()
        if self._pipeline is not None:
            # drain in-flight rounds (their grants are already paid for on
            # the device mirror) before tearing the completion thread down
            self._pipeline.flush(timeout=5.0)
            self._pipeline.stop()
        if self._persist_path:
            # UNCONDITIONAL final snapshot: hot-path dirtying is rate-gated
            # (_mark_hot_dirty), so the dirty bit alone can't prove the
            # last snapshot is current — a clean shutdown must never lose
            # the gate window
            self._persist_dirty = False
            self._persist_now()
        self.jobs.shutdown()
        if self.dashboard is not None:
            self.dashboard.stop()
        with self._lock:
            clients = list(self._clients.values())
        if stop_agents:
            for client in clients:
                try:
                    client.call("Shutdown", timeout=1.0)
                except RpcError:
                    pass
        # close channels AND unregister this head's breaker callbacks: a
        # successor head (restart_head keeps both in-process for a moment)
        # must not see stale unreachable-callbacks fire into dead state
        for client in clients:
            _best_effort(client.close)
        self._dispatch_pool.shutdown(wait=False, cancel_futures=True)
        self._server.stop()
        self.release_device_state()

    def release_device_state(self) -> None:
        """Frees the scheduler state's device memory once the scheduler
        loop has seen ``_shutdown`` and ended (a head restart or a killed
        in-process leader keeps the process, and the collector would reach
        the old head's cycles only later). The host tables stay."""
        sched = getattr(self, "_sched_thread", None)
        if self.device_state is not None and sched is not None:
            if sched.is_alive() and threading.current_thread() is not sched:
                sched.join(timeout=5.0)
            if not sched.is_alive():
                self.device_state.release()


def main() -> None:  # pragma: no cover - exercised via subprocess in tests
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch head server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--dashboard-port", type=int, default=8265)
    parser.add_argument("--no-dashboard", action="store_true")
    parser.add_argument(
        "--device-scheduler",
        default=None,
        action=argparse.BooleanOptionalAction,
        help="device scheduler on the card (default on; "
        "--no-device-scheduler for the NumPy golden model)",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    head = HeadServer(
        host=args.host,
        port=args.port,
        use_device_scheduler=args.device_scheduler,
        dashboard_port=None if args.no_dashboard else args.dashboard_port,
    )
    print(f"ray_tpu_torch head listening on {head.address}", flush=True)
    if head.dashboard is not None:
        print(
            f"dashboard at http://{args.host}:{head.dashboard.port}", flush=True
        )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        head.shutdown()


if __name__ == "__main__":
    main()
