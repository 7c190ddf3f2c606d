"""Shared control-plane message types for the distributed runtime.

These are the moral equivalent of the reference's protobuf messages
(Ray's src/ray/protobuf/common.proto, gcs_service.proto,
node_manager.proto) — dataclasses shipped over the generic gRPC layer.

Port of ``ray_tpu/cluster/common.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.config import cfg

# Values at or below this ride inline through the head's object table
# (max_direct_call_object_size analog, ray_config_def.h:218).
INLINE_OBJECT_MAX = cfg.inline_object_max

# Resource report cadence (raylet_report_resources_period_milliseconds=100,
# ray_config_def.h:65). Health detection reads cfg.health_timeout_s /
# cfg.health_miss_threshold LIVE in head._health_loop — no import-time
# binding, so runtime env overrides (tests, chaos soaks) take effect.
REPORT_PERIOD_S = cfg.report_period_s


def new_id() -> str:
    from ray_tpu_torch._ids import rand_hex

    return rand_hex(8)  # buffered urandom: no syscall per id


from ray_tpu_torch.util.metrics import Histogram as _Histogram

# execution-plane hot-path decomposition, SAMPLED 1-in-64 per call site
# (a locked observe per item would be per-item Python on the very path
# this histogram exists to prove clean): serialize = payload framing,
# enqueue = lease-manager/channel hand-off, wire = one window's RPC send
# (per-item share), execute = worker-side run, result = owner-side
# delivery of a merged result batch (per-item share). Shared here so the
# owner (client.py) and worker observe the same instrument name.
DISPATCH_OVERHEAD_US = _Histogram(
    "dispatch_overhead_us",
    "Per-stage dispatch overhead decomposition (sampled), microseconds.",
    boundaries=[1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000, 25000, 100000],
    label_names=("stage",),
)
_sample_tick = 0


def dispatch_sampled() -> bool:
    global _sample_tick
    _sample_tick = (_sample_tick + 1) & 63
    return _sample_tick == 0


def stream_item_id(task_id: str, index: int) -> str:
    """Deterministic object id for item ``index`` of a streaming-generator
    task. Determinism is the recovery story: a retried generator re-seals
    the SAME ids, so refs a consumer already iterated resolve to the
    re-executed copies (the reference derives generator return ids from
    task id + return index the same way)."""
    import hashlib

    return hashlib.blake2b(
        f"{task_id}:{index}".encode(), digest_size=14
    ).hexdigest()


@dataclass
class NodeInfo:
    node_id: str
    address: str  # agent RPC address
    resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    # actors whose workers this agent still hosts, as
    # {"actor_id", "name", "max_restarts"} — lets a restarted head re-attach
    # live actors (GCS FT resubscribe analog, gcs_init_data.cc)
    hosted_actors: List[dict] = field(default_factory=list)
    # (object_id, size) inventory of this node's store — a restarted head
    # re-seeds its object directory from these, so refs minted before the
    # restart resolve (the directory died with the old head; the
    # bytes didn't)
    stored_objects: List[Tuple[str, int]] = field(default_factory=list)
    # task-lease ids whose worker this agent still has pinned — a restarted
    # head reconciles these against its (possibly unpersisted) lease table
    # and releases any it no longer tracks, so leased workers never stay
    # pinned to a lease the control plane forgot
    held_task_leases: List[str] = field(default_factory=list)
    # task ids this agent admitted and has not reported finished or failed
    # yet — a restarted head never re-drives these (they finish here)
    tasks_on_hand: List[str] = field(default_factory=list)
    # cross-node data plane (transport.py): where this node's stripe
    # server listens, and the per-incarnation auth token peers must
    # present on the data-path handshake. The head hands both out in
    # peer-link grants; an agent restart mints a fresh token, so stale
    # cached links are rejected and re-granted automatically.
    data_endpoint: str = ""
    net_token: str = ""


@dataclass
class LeaseRequest:
    """A task / actor-creation / actor-method lease (LeaseSpecification
    analog, src/ray/common/lease/)."""

    task_id: str
    name: str
    payload: bytes  # cloudpickled (func, args, kwargs); (args, kwargs) when fn_blob set
    return_ids: List[str]
    resources: Dict[str, float]
    # worker_lease: not a task — a request to pin one worker + this
    # resource shape for an owner's direct task dispatch (task leases)
    kind: str = "task"  # task | actor_creation | actor_method | worker_lease
    actor_id: Optional[str] = None
    max_retries: int = 3
    retry_exceptions: bool = False
    attempt: int = 0
    strategy: Any = None
    runtime_env: Optional[dict] = None
    # set by the head when routing:
    target_node: Optional[str] = None
    pg_reservation: Optional[Tuple[str, int]] = None  # (pg_id, bundle_idx)
    # actor_creation only: {"name", "max_restarts"} so the hosting agent can
    # re-describe its actors to a restarted head
    actor_meta: Optional[dict] = None
    # --- distributed refcounting (reference_counter.h analog) ---
    # every ObjectRef serialized into the payload (nested included): the
    # head pins these for the lease's lifetime (args must outlive dispatch)
    arg_ids: List[str] = field(default_factory=list)
    # TOP-LEVEL ObjectRef args only: the set the worker resolves before
    # running, i.e. what dependency-aware dispatch waits on. Nested refs
    # reach user code unresolved (reference semantics) and must NOT gate
    # dispatch — a task may exist precisely to unblock the object a nested
    # ref points at.
    deps: List[str] = field(default_factory=list)
    # submitting process's holder id: the initial owner of the return ids
    client_id: str = ""
    # distributed trace context (util/tracing.py); rides the wire so every
    # hop's lifecycle events share one trace id
    trace: Optional[dict] = None
    # plain tasks only: the function pickled SEPARATELY from (args, kwargs)
    # so the client pickles it once per function object and executors
    # deserialize it once per (worker, fn_id) — the reference exports a
    # remote function's pickle once at first submission for the same
    # reason (function_manager export path) instead of re-pickling per
    # call. fn_cache=False (fn closes over ObjectRefs) keeps per-call
    # deserialization so ref lifetimes stay per-execution.
    fn_blob: Optional[bytes] = None
    fn_id: str = ""
    fn_cache: bool = True
    # num_returns="streaming": the executor yields N results incrementally;
    # each is sealed as its own object under a DETERMINISTIC id
    # (stream_item_id), the head tracks per-stream item order/done state,
    # and the caller iterates an ObjectRefGenerator
    # (object_ref_generator.py / _raylet.pyx:246 analog)
    streaming: bool = False

    def __getstate__(self):
        # head-side scheduling memos (e.g. _req_cache) never ride the wire
        return {
            k: v for k, v in self.__dict__.items() if not k.startswith("_")
        }


@dataclass
class SealInfo:
    """Worker -> agent -> head: an object became available."""

    object_id: str
    node_id: str
    size: int = 0
    inline_value: Optional[bytes] = None  # pickled value if small
    is_error: bool = False
    error: Optional[bytes] = None  # pickled exception
    # ObjectRefs serialized inside the sealed value: the head pins them
    # while this object is alive (nested-ref ownership,
    # reference_counter.h AddNestedObjectIds)
    contained_ids: List[str] = field(default_factory=list)
    # direct actor calls: the caller that owns the return object. The head
    # registers it as a holder when the seal lands (the lease path does
    # this at submission; direct calls never create a lease).
    owner: Optional[str] = None


@dataclass
class WalShipBatch:
    """Leader -> standby replication batch (``ReplWal``): a contiguous
    run of the leader's persistence stream. ``records`` items are
    ``("wal", record)`` WAL records or ``("snap", snapshot)`` barriers,
    sequence-numbered from ``start_seq``; a bootstrap/re-sync batch
    instead carries a full ``snapshot`` at position ``snap_seq``. The
    standby replies ``{"applied_to": seq}``, ``{"resync_from": seq}``
    on a gap, or ``{"fenced": epoch}`` once it has promoted — the reply
    that fences a deposed leader off its own shipping stream."""

    epoch: int
    leader: str
    start_seq: int
    records: List[Tuple[str, Any]] = field(default_factory=list)
    snapshot: Optional[dict] = None
    snap_seq: int = 0


@dataclass
class NodeReport:
    """Agent -> head periodic report (RaySyncer RESOURCE_VIEW analog,
    src/ray/ray_syncer/ray_syncer.h:81)."""

    node_id: str
    available: Dict[str, float]
    seals: List[SealInfo] = field(default_factory=list)
    finished_leases: List[str] = field(default_factory=list)
    version: int = 0


@dataclass
class ActorInfo:
    actor_id: str
    name: Optional[str]
    node_id: Optional[str] = None
    address: Optional[str] = None  # agent address hosting the actor
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    class_name: str = ""
    max_restarts: int = 0
    num_restarts: int = 0
    # lifetime="detached": owned by the head, survives its creating
    # driver's disconnect and head restarts; killed only explicitly
    # (reference actor.py:1875 detached lifetimes). Default (None):
    # reaped when the owning client disconnects.
    lifetime: Optional[str] = None
    owner_client: str = ""
