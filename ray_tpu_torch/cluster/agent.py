"""Node agent: the per-node runtime (raylet analog).

One process per node, the equivalent of the reference's raylet
(Ray's src/ray/raylet/node_manager.h:140): it owns the node's
authoritative resource ledger (grant-or-reject admission,
local_lease_manager.h:39-61), a pool of worker subprocesses
(worker_pool.h), the node's shared-memory object store (the plasma
store runs inside the raylet process — plasma/store_runner.h:28), and
object pulls from remote nodes (pull_manager.h). It heartbeats resource
snapshots to the head (raylet_report_resources_period_milliseconds=100).

Port of ``ray_tpu/cluster/agent.py``, copied with its imports rewritten.
The agent never touches CUDA:
a GPU lease exports ``CUDA_VISIBLE_DEVICES`` to its worker
(``scheduler/instances.py``), and only the worker's task body uses the
card.
"""
from __future__ import annotations

import logging
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.scheduler import ResourceRequest, ResourceVocab
from ray_tpu_torch.scheduler.instances import NodeAcceleratorState
from ray_tpu_torch.scheduler.resources import make_ledger

from .pip_env import env_slice, has_env as _has_env

from .common import (
    REPORT_PERIOD_S,
    LeaseRequest,
    NodeInfo,
    NodeReport,
    SealInfo,
    new_id,
)
from .object_plane import (
    CHUNKED_PULLS_INFLIGHT,
    OBJECT_TRANSFER_BYTES,
    PEER_CONN_GRANTED,
    PEER_CONN_REUSED,
    PEER_CONN_REVOKED,
    TRANSFER_CHUNK_MS,
    TRANSFER_STRIPE_MS,
    ChunkFetchError,
    fetch_chunked,
)
from .rpc import (
    HANDLER_STATS,
    RpcClient,
    RpcError,
    RpcNotLeaderError,
    RpcServer,
    RpcStaleEpochError,
)
from .zygote import PreforkedZygote, ZygoteClient, fork_available, prefork


from ray_tpu_torch.config import cfg
from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Gauge as _Gauge
from ray_tpu_torch.util.metrics import Histogram as _Histogram

logger = logging.getLogger("ray_tpu_torch.cluster.agent")

_EPS = 1e-9

# worker-lifecycle instruments (worker_pool.cc stats analog). Process-wide
# like every metric in util.metrics; per-agent counts live in
# NodeAgent.pool_stats and surface through DebugState.
WORKER_SPAWN_MS = _Histogram(
    "worker_spawn_ms",
    "Worker spawn-to-register latency; path=fork (zygote) vs spawn (cold).",
    boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000),
    label_names=("path",),
)
WORKER_POOL_HITS = _Counter(
    "worker_pool_hits_total",
    "Lease dispatches served immediately by an idle pooled worker.",
)
WORKER_POOL_MISSES = _Counter(
    "worker_pool_misses_total",
    "Lease dispatches that found the idle pool empty and had to wait.",
)
WORKER_PRESTART_INFLIGHT = _Gauge(
    "worker_prestart_inflight",
    "Prestarted workers spawned on a head hint, not yet registered.",
)


class _MemStore:
    """Fallback object store when the native shm arena can't build."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put_bytes(self, oid: str, data: bytes) -> None:
        with self._lock:
            self._data[oid] = data

    def get_bytes(self, oid: str) -> bytes:
        with self._lock:
            return self._data[oid]

    def get_range(self, oid: str, offset: int, length: int) -> bytes:
        with self._lock:
            return self._data[oid][offset : offset + length]

    def object_size(self, oid: str) -> int:
        with self._lock:
            return len(self._data[oid])

    def contains(self, oid: str) -> bool:
        with self._lock:
            return oid in self._data

    def delete(self, oid: str) -> None:
        with self._lock:
            self._data.pop(oid, None)

    def close(self, unlink: bool = False) -> None:
        self._data.clear()


class _ClassedAdmission:
    """Priority admission over N transfer slots — the object-plane QoS of
    the reference's PullManager/PushManager (pull_manager.h:40-47 GET >
    WAIT > TASK_ARGS classes; push_manager.h:28-36 in-flight cap): a
    waiting higher class always gets the next free slot, so a storm of
    task-arg transfers cannot starve an interactive get.

    Scope note (push side): the slot covers the store read + reply
    construction, not the kernel's socket send that happens after the
    handler returns — the enforced property is priority ORDERING of
    admissions plus a bound on concurrently materialized replies, an
    approximation of the reference's chunked in-flight cap.

    ``timeout``: a bounded wait keeps a storm from parking the RPC
    server's whole thread pool forever — on expiry the transfer errors
    and the requester retries through its locate loop."""

    PRIO = {"get": 0, "wait": 1, "task_args": 2}

    def __init__(self, slots: int, timeout: Optional[float] = None):
        self._slots = max(1, int(slots))
        self._timeout = timeout
        self._cv = threading.Condition()
        self._in_flight = 0
        self._waiting = [0, 0, 0]

    def __call__(self, purpose: str):
        return _AdmissionSlot(self, self.PRIO.get(purpose, 2))


class _AdmissionSlot:
    __slots__ = ("_adm", "_prio")

    def __init__(self, adm: _ClassedAdmission, prio: int):
        self._adm = adm
        self._prio = prio

    def __enter__(self):
        adm, p = self._adm, self._prio
        deadline = (
            None
            if adm._timeout is None
            else time.monotonic() + adm._timeout
        )
        with adm._cv:
            adm._waiting[p] += 1
            try:
                while adm._in_flight >= adm._slots or any(
                    adm._waiting[q] for q in range(p)
                ):
                    if (
                        deadline is not None
                        and time.monotonic() >= deadline
                    ):
                        raise TimeoutError(
                            "transfer admission timed out "
                            f"(class={p}, slots={adm._slots})"
                        )
                    adm._cv.wait(timeout=1.0)
            finally:
                adm._waiting[p] -= 1
            adm._in_flight += 1
        return self

    def __exit__(self, *exc):
        adm = self._adm
        with adm._cv:
            adm._in_flight -= 1
            adm._cv.notify_all()
        return False


class _WorkerHandle:
    def __init__(self, worker_id: str, proc):
        self.worker_id = worker_id
        self.proc = proc  # subprocess.Popen or zygote.ForkedProc
        self.client: Optional[RpcClient] = None
        self.ready = threading.Event()
        self.actor_id: Optional[str] = None  # pinned for an actor
        self.lease_id: Optional[str] = None  # pinned for a task lease
        self.pip_key: Optional[str] = None  # bound to a pip runtime env
        self.idle_since: float = 0.0  # env workers: reap when idle long
        self.lock = threading.Lock()  # serializes pushes (actor ordering)
        self.spawned_at: float = 0.0  # monotonic spawn time (spawn_ms metric)
        self.spawn_path: str = "spawn"  # "fork" (zygote) | "spawn" (cold)
        self.spawn_pending: bool = False  # spawned, not yet registered
        self.prestart_pending: bool = False  # head-hinted, not yet registered
        # actor creation applied a persisted runtime env here: reuse denied
        self.env_tainted: bool = False
        # task_id -> dispatch time of in-flight plain tasks (OOM victim
        # selection: the memory monitor kills the NEWEST task first)
        self.running: Dict[str, float] = {}


class NodeAgent:
    def __init__(
        self,
        head_address: str,
        resources: Dict[str, float],
        labels: Optional[Dict[str, str]] = None,
        host: str = "127.0.0.1",
        num_workers: Optional[int] = None,
        store_capacity: int = 1 << 28,
        node_id: Optional[str] = None,
        preforked: Optional[PreforkedZygote] = None,
    ):
        self.node_id = node_id or new_id()
        self.head_address = head_address
        # the zygote forked before this process had threads (``main``):
        # the first zygote, with no import to wait out
        self._preforked = preforked
        self.head = RpcClient(head_address)
        self.vocab = ResourceVocab()
        self.ledger = make_ledger(self.vocab, resources)
        # chip-index assignment on top of the scalar ledger: granted leases
        # carry TPU_VISIBLE_CHIPS / CUDA_VISIBLE_DEVICES
        self.accel = NodeAcceleratorState(resources)
        self.resources = dict(resources)
        self.labels = dict(labels or {})
        self._lock = threading.RLock()
        self._shutdown = False
        # set for real from the RegisterNode reply below; None (unstamped,
        # always accepted) until then so reporter threads that start early
        # never race the registration round-trip
        self._head_epoch: Optional[int] = None

        # --- object store (plasma-in-raylet analog), wrapped with LRU
        # disk spill + restore so a full arena backpressures to disk
        # instead of erroring (eviction_policy.h / local_object_manager.h)
        # paths carry the pid: a node id can be reused across cluster
        # incarnations (tests, restarts), and a lingering agent from an old
        # incarnation must never share an arena or spill dir with a new one
        self.store_path = os.path.join(
            tempfile.gettempdir(),
            f"ray_tpu_torch_store_{self.node_id}_{os.getpid()}.shm",
        )
        try:
            # a killed agent (chaos kill tier) never reaches the unlink in
            # shutdown(): sweep arenas/spill dirs whose owning pid is dead
            # so /tmp does not accrete one orphaned arena per kill
            from ray_tpu_torch.native.shm_store import sweep_orphan_stores

            swept = sweep_orphan_stores()
            if swept:
                logger.info("swept %d orphaned store files", len(swept))
        except Exception:  # noqa: BLE001 - hygiene, never fatal
            logger.debug("orphan store sweep failed", exc_info=True)
        try:
            # same hygiene for DAG/pipeline ring files: a SIGKILLed
            # producer or consumer never reaches its unlink
            from ray_tpu_torch.dag.channel import sweep_orphan_rings

            swept = sweep_orphan_rings()
            if swept:
                logger.info("swept %d orphaned ring files", len(swept))
        except Exception:  # noqa: BLE001 - hygiene, never fatal
            logger.debug("orphan ring sweep failed", exc_info=True)
        try:
            # and for data-plane endpoint sidecars (transport.py): a
            # SIGKILLed agent never unlinks its own .ep file
            from ray_tpu_torch.native.net import sweep_orphan_endpoints

            swept = sweep_orphan_endpoints()
            if swept:
                logger.info("swept %d orphaned net endpoints", len(swept))
        except Exception:  # noqa: BLE001 - hygiene, never fatal
            logger.debug("orphan endpoint sweep failed", exc_info=True)
        try:
            # and for dark-plane counter pages (native/counters.py)
            from ray_tpu_torch.native.counters import sweep_orphan_counters

            swept = sweep_orphan_counters()
            if swept:
                logger.info("swept %d orphaned counter pages", swept)
        except Exception:  # noqa: BLE001 - hygiene, never fatal
            logger.debug("orphan counter sweep failed", exc_info=True)
        try:
            from ray_tpu_torch.native import NativeObjectStore

            inner = NativeObjectStore(
                path=self.store_path, capacity=store_capacity
            )
        except Exception:  # noqa: BLE001 - toolchain missing
            logger.warning("native store unavailable; using in-memory store")
            inner = _MemStore()
            self.store_path = ""
        from ray_tpu_torch.native.spill import SpillingStore
        from ray_tpu_torch.native.spill_storage import storage_from_uri

        spill_dir = os.path.join(
            tempfile.gettempdir(),
            f"ray_tpu_torch_spill_{self.node_id}_{os.getpid()}",
        )
        self.store = SpillingStore(
            inner,
            spill_dir=spill_dir,
            capacity=store_capacity,
            # remote spill (external_storage.py analog): file:// (default)
            # | memory:// | s3://bucket/prefix
            backend=storage_from_uri(cfg.spill_storage_uri, spill_dir),
        )

        # --- bundle (placement group) reservations ---
        # pg_id -> {"state": prepared|committed, "bundles": {idx: avail_map}}
        self._bundles: Dict[str, dict] = {}

        # --- RPC surface ---
        handlers = {
            "ExecuteLease": self._h_execute_lease,
            "ExecuteLeaseBatch": self._h_execute_lease_batch,
            "StoreObject": self._h_store_object,
            "FetchObject": self._h_fetch_object,
            "FetchObjectBatch": self._h_fetch_object_batch,
            "FetchObjectMeta": self._h_fetch_object_meta,
            "FetchObjectChunk": self._h_fetch_object_chunk,
            "DeleteObjects": self._h_delete_objects,
            "GetObjectForWorker": self._h_get_object_for_worker,
            "WorkerPut": self._h_worker_put,
            "WorkerSealed": self._h_worker_sealed,
            "StreamConsumed": self._h_stream_consumed,
            "RegisterWorker": self._h_register_worker,
            "TaskDone": self._h_task_done,
            "TaskDoneBatch": lambda reqs: [
                self._h_task_done(r) for r in reqs
            ],
            "RefUpdate": self._h_ref_update,
            "PrepareBundles": self._h_prepare_bundles,
            "CommitBundles": self._h_commit_bundles,
            "RollbackBundles": self._h_rollback_bundles,
            "ReturnBundles": self._h_return_bundles,
            "KillActor": self._h_kill_actor,
            "PrestartWorkers": self._h_prestart_workers,
            "ActorWorkerAddress": self._h_actor_worker_address,
            "ReturnWorkerLease": self._h_return_worker_lease,
            "CancelLease": self._h_cancel_lease,
            "DagInstall": lambda r: self._forward_to_actor_worker(
                "DagInstall", r
            ),
            "DagTeardown": lambda r: self._forward_to_actor_worker(
                "DagTeardown", r
            ),
            "PipelineInstall": lambda r: self._forward_to_actor_worker(
                "PipelineInstall", r
            ),
            "PipelineTeardown": lambda r: self._forward_to_actor_worker(
                "PipelineTeardown", r
            ),
            "Shutdown": self._h_shutdown,
            "DebugState": self._h_debug_state,
            "ServeStats": self._h_serve_stats,
            "RevokePeerLink": self._h_revoke_peer_link,
            "ChaosKillZygote": self._h_chaos_kill_zygote,
            "ChaosDropPeerConn": self._h_chaos_drop_peer_conn,
            "Ping": lambda r: "pong",
        }
        # serving-plane stats pushed by co-located replica workers
        # (node-local control traffic): pid -> {deployment, stats, ts}
        self._serve_stats: Dict[int, dict] = {}
        self._server = RpcServer(handlers, host=host, port=0)
        self.address = self._server.address

        # --- worker pool (worker_pool.h analog) ---
        if num_workers is None:
            num_workers = max(2, min(int(resources.get("CPU", 2)), 8))
        self._workers: Dict[str, _WorkerHandle] = {}
        self._idle: List[str] = []
        self._idle_cv = threading.Condition(self._lock)
        self._actor_workers: Dict[str, str] = {}  # actor_id -> worker_id
        # task leases held by this node's workers (worker_lease grants):
        # lease_id -> {worker_id, alloc, owner, granted_at}. The lease pins
        # its worker out of the idle pool like an actor does, and the pool
        # backfills 1:1 for the same reason.
        self._task_leases: Dict[str, dict] = {}
        self._lease_stats: Dict[str, int] = {
            "granted": 0,
            "returned": 0,
            "lost": 0,
        }
        self._actor_meta: Dict[str, dict] = {}  # actor_id -> {name, max_restarts}
        self._actor_allocs: Dict[str, Any] = {}  # actor_id -> held lease alloc
        self._actor_fifo: Dict[str, list] = {}  # actor_id -> ordered methods
        self._actor_draining: set = set()
        self._async_actors: set = set()  # actor_ids multiplexing on a loop
        # async-actor methods accepted by a worker, completion pending
        # (worker reports via TaskDone): task_id -> (spec, worker handle)
        self._async_pending: Dict[str, tuple] = {}
        # TaskDone replies that arrived before their PushTask reply did
        self._early_task_done: Dict[str, dict] = {}
        # per-async-actor push coalescing (see _drain_async_methods)
        self._async_buf: Dict[str, deque] = {}
        self._async_draining: set = set()
        self._num_workers = num_workers
        # pool observability (DebugState "pool"): per-agent counts behind
        # the process-wide Prometheus instruments above
        self.pool_stats: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "reused": 0,
            "forked": 0,
            "cold_spawned": 0,
        }
        self._prestart_inflight = 0
        # head-signalled drain-ahead: while retiring, don't warm
        # the pool — new work is steered elsewhere and any prestarted
        # worker would die with the node
        self._draining = False
        # ALL spawns not yet registered (prestarted or not): the backfill
        # and prestart sizing both count these as future-free capacity, so
        # N concurrent creations cannot each trigger their own spawn for
        # the same hole (the overspawn burned ~100ms of fork+init CPU per
        # duplicate on a loaded host)
        self._spawns_pending = 0
        # fork-server: one zygote pays the worker import graph once; new
        # workers fork from it in milliseconds (cold spawn stays the
        # fallback — see zygote.py)
        self._zygote: Optional[ZygoteClient] = None
        self._zygote_restarts = 0
        if cfg.fork_server and fork_available():
            self._start_zygote()
        # initial pool fill happens OFF the construction path: the first
        # fork blocks on the zygote's one-time import warmup (~seconds
        # with torch), and head registration must not wait behind it —
        # leases arriving early just park in _pop_idle_worker meanwhile
        threading.Thread(
            target=self._fill_pool, name="agent-pool-fill", daemon=True
        ).start()

        # remote-fetch client cache (peer addresses come from head lookups)
        self._peer_clients: Dict[str, RpcClient] = {}
        # pull admission (push_manager.h / pull_manager.h analog): bound
        # concurrent inbound transfers, and coalesce concurrent pulls of
        # ONE object into a single fetch (broadcast of a big object to N
        # workers on this node = one wire transfer, not N)
        self._pull_adm = _ClassedAdmission(cfg.max_concurrent_pulls)
        # outbound (serving) side: bound concurrent transfers shipped to
        # peers/clients, same GET > WAIT > TASK_ARGS classes; bounded wait
        # so a fetch storm can't park the RPC thread pool forever
        self._push_adm = _ClassedAdmission(
            cfg.max_concurrent_pushes, timeout=60.0
        )
        self._pull_waiters: Dict[str, threading.Event] = {}

        # --- cross-node data plane (transport.py): stripe server beside
        # the RPC server + the peer-link cache (head-granted connection
        # leases). The per-incarnation auth token never leaves memory
        # except inside grant replies; a fresh token per agent process
        # means stale cached links die at the handshake and re-grant.
        import secrets

        from .transport import PeerLinkCache

        self.net_token = secrets.token_hex(16)
        self._data_server = None
        if cfg.native_net:
            try:
                from .transport import DataPlaneServer

                self._data_server = DataPlaneServer(
                    self.store,
                    self.node_id,
                    self.net_token,
                    epoch_fn=lambda: self._head_epoch,
                    admission=self._push_adm,
                    host=host,
                )
            except Exception:  # noqa: BLE001 - chunked RPC still serves
                logger.exception(
                    "data-plane server failed to start; peers fall back "
                    "to chunked RPC"
                )
        self._links = PeerLinkCache(self._grant_peer_link)

        # IO-bound pool: threads mostly park on worker RPCs. Sized well past
        # the worker count so async-actor methods (which each hold a thread
        # while multiplexing on the worker's event loop) can overlap deeply.
        self._exec_pool = ThreadPoolExecutor(
            max_workers=num_workers + 32,
            thread_name_prefix=f"agent-{self.node_id[:6]}",
        )

        # memory-pressure monitor (pressure_memory_monitor.h analog): when
        # host memory usage crosses the threshold, kill the worker running
        # the NEWEST plain task (its lease retries; earlier work survives)
        self.metrics_oom_kills = 0
        if cfg.memory_monitor_interval_s > 0:
            threading.Thread(
                target=self._memory_monitor_loop,
                name="agent-memmon",
                daemon=True,
            ).start()

        # metrics federation: this agent's registry ships as
        # typed deltas on the coalesced head report at
        # cfg.metrics_interval_s cadence; workers' deltas (relayed via
        # WorkerSealed) queue here pre-labeled and ride the same report
        from ray_tpu_torch.util.metrics import DeltaExporter

        self._metric_exporter = DeltaExporter()
        self._metric_lock = threading.Lock()
        self._worker_metric_relays: List[Dict[str, Any]] = []
        self._metrics_last_ship = 0.0

        # coalescing completion/seal reporter (see _reporter_loop)
        self._report_queue: List[Dict[str, Any]] = []
        self._report_cv = threading.Condition()
        # tasks admitted and not yet reported finished or failed, named in
        # RegisterNode so a restarted head lets them finish here
        self._tasks_on_hand: set = set()
        threading.Thread(
            target=self._reporter_loop, name="agent-reporter", daemon=True
        ).start()
        # plain-task batch dispatcher (see _task_drain_loop)
        self._task_buf: deque = deque()
        self._task_cv = threading.Condition()
        threading.Thread(
            target=self._task_drain_loop, name="agent-task-drain", daemon=True
        ).start()
        # pip runtime environments (reference runtime_env pip/uv builders):
        # dedicated workers per env key, reaped after idle timeout
        from .pip_env import PipEnvManager

        # per-agent base dir: GC liveness is tracked by THIS agent's
        # refcounts, so the directory must not be shared with other
        # agents on the host (each simulated node is its own "machine")
        self._pip_mgr = PipEnvManager(
            os.path.join(
                os.environ.get("RAY_TPU_PIP_ENV_BASE", "")
                or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pip_envs"),
                self.node_id,
            )
        )
        self._pip_idle: Dict[str, List[str]] = {}
        threading.Thread(
            target=self._pip_gc_loop, name="agent-pipgc", daemon=True
        ).start()

        # dependency-waiting leases (see _dep_loop)
        self._dep_waiting: Dict[str, tuple] = {}  # task_id -> (spec, missing)
        self._dep_cv = threading.Condition()
        # ids fetchable from the head without store locality (inline/error)
        self._dep_ready_ids: set = set()
        self._pulls_in_flight: set = set()
        threading.Thread(
            target=self._dep_loop, name="agent-deps", daemon=True
        ).start()

        reply = self.head.call(
            "RegisterNode",
            self._node_info(),
            retries=30,
            retry_interval=0.2,
        )
        assert reply["node_id"] == self.node_id
        # cluster epoch adopted at registration: control RPCs to the head
        # are stamped with it, so a rebuilt head fences this agent out the
        # moment it restarts — until the agent re-registers (the resync
        # protocol) and adopts the new epoch
        self._head_epoch = reply.get("epoch")
        self._report_thread = threading.Thread(
            target=self._report_loop, name="agent-report", daemon=True
        )
        self._report_thread.start()

    # ------------------------------------------------------------------
    # worker pool
    # ------------------------------------------------------------------
    def _fill_pool(self) -> None:
        for _ in range(self._num_workers):
            if self._shutdown:
                return
            try:
                self._spawn_worker()
            except Exception:  # noqa: BLE001 - report loop backfills later
                logger.exception("initial worker spawn failed")

    def _start_zygote(self) -> None:
        env = dict(os.environ)
        env["RAY_TPU_HEAD_ADDRESS"] = self.head_address
        env["RAY_TPU_NODE_ID"] = self.node_id
        # the zygote forked at process start serves first; a replacement
        # is spawned (this process has threads now)
        pre, self._preforked = self._preforked, None
        try:
            self._zygote = ZygoteClient(self.address, self.store_path, env, preforked=pre)
        except OSError:
            logger.exception("zygote start failed; using cold spawn")
            self._zygote = None

    def _zygote_for_fork(self) -> Optional[ZygoteClient]:
        """Live zygote client, restarting a broken one (bounded) —
        repeated breakage means fork doesn't work here; stop trying."""
        z = self._zygote
        if z is None or not z.broken:
            return z
        with self._lock:
            if self._zygote is z:
                z.close()
                self._zygote_restarts += 1
                if self._zygote_restarts > 3:
                    logger.warning(
                        "zygote broke %d times; cold spawn from now on",
                        self._zygote_restarts,
                    )
                    self._zygote = None
                else:
                    self._start_zygote()
            return self._zygote

    def _h_prestart_workers(self, req: dict) -> dict:
        """Head hint: N actor-creation leases are headed here — warm the
        pool while they are in flight (worker_pool.cc PrestartWorkers).
        Bounded by prestart_max_workers above the steady pool size, and
        discounted by workers already idle or warming."""
        want = int(req.get("count", 0))
        if want <= 0 or self._shutdown or self._draining:
            return {"spawned": 0}
        with self._idle_cv:
            free = len(self._idle) + self._spawns_pending
            cap = (
                self._num_workers
                + cfg.prestart_max_workers
                - len(self._workers)
            )
        # target: enough warm capacity for every inbound creation AND a
        # full free pool after they pin — the creations' 1:1 backfills
        # would spawn the same workers anyway, just later (trailing the
        # churn instead of overlapping the leases' flight time)
        n = min(max(0, want + self._num_workers - free), max(0, cap))
        spawned = 0
        for _ in range(n):
            try:
                self._spawn_worker(prestart=True)
                spawned += 1
            except Exception:  # noqa: BLE001 - fork pressure
                logger.exception("prestart spawn failed")
                break
        return {"spawned": spawned}

    def _spawn_worker(
        self, pip_env: Optional[Tuple] = None, prestart: bool = False
    ) -> _WorkerHandle:
        worker_id = new_id()
        t0 = time.monotonic()
        if pip_env is None:
            # fast path: fork from the warm zygote (ms) instead of a cold
            # interpreter + import (seconds). Env-bound workers keep the
            # cold path: their interpreter/sys.path differ by design.
            zc = self._zygote_for_fork()
            if zc is not None:
                forked = zc.fork_worker(worker_id)
                if forked is not None:
                    handle = _WorkerHandle(worker_id, forked)
                    handle.spawned_at = t0
                    handle.spawn_path = "fork"
                    return self._track_spawn(handle, prestart)
        env = dict(os.environ)
        env["RAY_TPU_HEAD_ADDRESS"] = self.head_address
        env["RAY_TPU_NODE_ID"] = self.node_id
        interpreter = sys.executable
        if pip_env is not None:
            kind = pip_env[2] if len(pip_env) > 2 else "pip"
            if kind == "conda":
                # conda envs bring their own interpreter (pip_env.py) and
                # must have ray_tpu_torch importable inside them — reference
                # conda.py injects ray into the env's dependencies the
                # same way. RAY_TPU_CONDA_INJECT_SOURCE=1 opts into
                # prepending this source checkout's parent dir instead
                # (dev convenience only: PYTHONPATH entries shadow the
                # env's own site-packages, defeating isolation for any
                # package both provide).
                from .pip_env import PipEnvManager

                interpreter = PipEnvManager.interpreter_for(kind, pip_env[1])
                if os.environ.get("RAY_TPU_CONDA_INJECT_SOURCE"):
                    env["PYTHONPATH"] = (
                        os.path.dirname(
                            os.path.dirname(os.path.dirname(__file__))
                        )
                        + os.pathsep
                        + env.get("PYTHONPATH", "")
                    )
            else:
                # pip/uv --target env: the worker prepends this dir to
                # sys.path at startup, shadowing base site-packages
                env["RAY_TPU_PIP_ENV_DIR"] = pip_env[1]
        proc = subprocess.Popen(
            [
                interpreter,
                "-m",
                "ray_tpu_torch.cluster.worker",
                "--agent",
                self.address,
                "--worker-id",
                worker_id,
                "--store",
                self.store_path,
            ],
            env=env,
        )
        handle = _WorkerHandle(worker_id, proc)
        handle.spawned_at = t0
        if pip_env is not None:
            handle.pip_key = pip_env[0]
        return self._track_spawn(handle, prestart)

    def _track_spawn(
        self, handle: _WorkerHandle, prestart: bool
    ) -> _WorkerHandle:
        self.pool_stats[
            "forked" if handle.spawn_path == "fork" else "cold_spawned"
        ] += 1
        with self._idle_cv:
            if prestart:
                handle.prestart_pending = True
                self._prestart_inflight += 1
                WORKER_PRESTART_INFLIGHT.inc()
            if handle.pip_key is None:
                # pip-bound workers register into _pip_idle, never the
                # plain pool — counting them here would let an env build
                # storm suppress plain-worker backfill
                handle.spawn_pending = True
                self._spawns_pending += 1
            self._workers[handle.worker_id] = handle
        return handle

    def _prestart_done_locked(self, handle: _WorkerHandle) -> None:
        """Clear spawn/prestart reservations exactly once (register or
        death). Caller holds self._idle_cv."""
        if handle.spawn_pending:
            handle.spawn_pending = False
            self._spawns_pending -= 1
        if handle.prestart_pending:
            handle.prestart_pending = False
            self._prestart_inflight -= 1
            WORKER_PRESTART_INFLIGHT.dec()

    def _h_register_worker(self, req: dict) -> dict:
        # channel construction stays OUTSIDE the idle lock: a burst of
        # registrations (prestart landing) must not serialize grpc
        # channel setup under the lock every _pop_idle_worker needs
        client = RpcClient(req["address"])
        with self._idle_cv:
            handle = self._workers.get(req["worker_id"])
            if handle is None:
                client.close()
                return {"ok": False}
            handle.client = client
            handle.ready.set()
            handle.idle_since = time.monotonic()
            self._prestart_done_locked(handle)
            if handle.spawned_at:
                WORKER_SPAWN_MS.observe(
                    (time.monotonic() - handle.spawned_at) * 1000.0,
                    labels={"path": handle.spawn_path},
                )
                handle.spawned_at = 0.0
            if handle.pip_key is not None:
                handle.idle_since = time.monotonic()
                self._pip_idle.setdefault(handle.pip_key, []).append(
                    handle.worker_id
                )
            else:
                self._idle.append(handle.worker_id)
            self._idle_cv.notify_all()
        return {"ok": True, "node_id": self.node_id}

    def _pop_idle_worker(self, timeout: float = 60.0) -> Optional[_WorkerHandle]:
        deadline = time.monotonic() + timeout
        with self._idle_cv:
            if self._idle:
                self.pool_stats["hits"] += 1
                WORKER_POOL_HITS.inc()
                return self._workers[self._idle.pop()]
            self.pool_stats["misses"] += 1
            WORKER_POOL_MISSES.inc()
            while not self._idle:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._shutdown:
                    return None
                self._idle_cv.wait(timeout=min(remaining, 0.5))
            return self._workers[self._idle.pop()]

    @staticmethod
    def _close_worker_client(handle: _WorkerHandle) -> None:
        """Release a dead/reaped worker's channel (and its breaker-registry
        hold — worker ports are ephemeral, so leaving these behind grows
        process state with every churn cycle)."""
        if handle.client is not None:
            try:
                handle.client.close()
            except Exception:  # noqa: BLE001 - already torn down
                pass

    def _return_worker(self, handle: _WorkerHandle) -> None:
        with self._idle_cv:
            if (
                handle.actor_id is None
                and handle.lease_id is None
                and handle.worker_id in self._workers
            ):
                handle.idle_since = time.monotonic()
                if handle.pip_key is not None:
                    self._pip_idle.setdefault(handle.pip_key, []).append(
                        handle.worker_id
                    )
                else:
                    self._idle.append(handle.worker_id)
                self._idle_cv.notify_all()

    def _on_worker_death(self, handle: _WorkerHandle, running: List[LeaseRequest]) -> None:
        """A worker process died (socket/process detection in worker_pool.cc)."""
        running = list(running)
        with self._idle_cv:
            # death can be observed concurrently (failed RPC + health
            # sweep): the pop result marks the FIRST observer, which alone
            # releases once-only state like the pip env refcount
            first = self._workers.pop(handle.worker_id, None) is not None
            if first:
                self._prestart_done_locked(handle)
            if handle.worker_id in self._idle:
                self._idle.remove(handle.worker_id)
            if handle.pip_key is not None:
                lst = self._pip_idle.get(handle.pip_key)
                if lst and handle.worker_id in lst:
                    lst.remove(handle.worker_id)
                if first:
                    self._pip_mgr.release(handle.pip_key)
            # async methods awaiting a TaskDone from this worker die with it
            for tid in [
                t for t, (_, h) in self._async_pending.items() if h is handle
            ]:
                running.append(self._async_pending.pop(tid)[0])
            actor_id = handle.actor_id
            if actor_id:
                self._drop_actor_state(actor_id)
            lease_id = handle.lease_id
            lease_entry = None
            if lease_id:
                handle.lease_id = None
                lease_entry = self._task_leases.pop(lease_id, None)
                if lease_entry is not None:
                    self._lease_stats["lost"] += 1
        try:
            handle.proc.kill()
        except OSError:
            pass
        self._close_worker_client(handle)
        # zombie-pin reclamation: replay the dead reader's view-pin log and
        # release what its finalizers never could (SIGKILL). Waits briefly
        # for the process to be truly gone first — replaying while a
        # half-dead worker's finalizer races its own release could
        # double-release a share (the log's R-before-release ordering
        # protects every other interleaving).
        pid = getattr(handle.proc, "pid", None)
        if pid and self.store_path:
            deadline = time.monotonic() + 1.0
            while handle.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.01)
            if handle.proc.poll() is None:
                # not confirmed dead (D-state under memory pressure):
                # replaying now could double-release against the live
                # process's own finalizer. Leak the pins instead — the
                # arena restart sweep reclaims them.
                logger.warning(
                    "worker %s (pid %d) not reaped within 1s; skipping "
                    "pin-log replay (pins reclaimed at arena restart)",
                    handle.worker_id[:8],
                    pid,
                )
                pid = None
        if pid and self.store_path:
            try:
                released = self.store.release_dead_pins(pid)
                if released:
                    logger.info(
                        "released %d arena view pins leaked by dead "
                        "worker %s (pid %d)",
                        released,
                        handle.worker_id[:8],
                        pid,
                    )
            except Exception:  # noqa: BLE001 - reclamation is best-effort
                logger.debug("pin-log replay failed", exc_info=True)
        if lease_entry is not None:
            self._release(lease_entry["alloc"])
        report: Dict[str, Any] = {"node_id": self.node_id}
        if lease_id and lease_entry is not None:
            # the owner's channel discovers the death by RPC failure and
            # spills its queue; this report lets the head drop the lease
            # from its table (revoked) without waiting for TTL expiry
            report["task_leases"] = [
                {
                    "lease_id": lease_id,
                    "ok": False,
                    "reason": "worker died",
                    "lost": True,
                }
            ]
        # the dead process's holder counts die with it
        report["holders_gone"] = [handle.worker_id]
        if actor_id:
            report["actors_dead"] = [
                {"actor_id": actor_id, "reason": "worker process died"}
            ]
        if running:
            report["failed"] = [
                {
                    "task_id": s.task_id,
                    "reason": f"worker died running {s.name}",
                    "retryable": s.kind == "task",
                }
                for s in running
            ]
        self._report_to_head(report)
        if not self._shutdown and len(self._workers) < self._num_workers:
            self._spawn_worker()

    # ------------------------------------------------------------------
    # lease admission + execution
    # ------------------------------------------------------------------
    def _h_execute_lease_batch(self, specs: List[LeaseRequest]) -> dict:
        """Batched grant-or-reject admission: one RPC per scheduling round
        per node instead of one per lease (the reference amortizes this with
        lease pipelining, normal_task_submitter pipelining; a batched
        scheduler makes the whole round one message)."""
        statuses = [self._h_execute_lease(s)["status"] for s in specs]
        out: Dict[str, Any] = {"statuses": statuses}
        if "reject" in statuses:
            out["available"] = self.ledger.avail_map()
        return out

    def _h_execute_lease(self, spec: LeaseRequest) -> dict:
        req = ResourceRequest.from_map(self.vocab, spec.resources)
        if spec.kind == "actor_method":
            with self._lock:
                worker_id = self._actor_workers.get(spec.actor_id)
                handle = self._workers.get(worker_id) if worker_id else None
                if handle is None:
                    return {
                        "status": "reject",
                        "available": self.ledger.avail_map(),
                    }
                if spec.actor_id in self._async_actors:
                    # asyncio actor: methods multiplex on the worker's event
                    # loop — no FIFO. Pushes coalesce per actor: everything
                    # queued while the previous PushTaskBatch was in flight
                    # rides the next one.
                    self._async_buf.setdefault(spec.actor_id, deque()).append(
                        spec
                    )
                    if spec.actor_id not in self._async_draining:
                        self._async_draining.add(spec.actor_id)
                        self._exec_pool.submit(
                            self._drain_async_methods, spec.actor_id
                        )
                    return {"status": "granted"}
                # per-actor FIFO: the pool must not reorder method calls
                fifo = self._actor_fifo.setdefault(spec.actor_id, [])
                fifo.append(spec)
                if spec.actor_id in self._actor_draining:
                    return {"status": "granted"}
                self._actor_draining.add(spec.actor_id)
            self._exec_pool.submit(self._drain_actor_fifo, spec.actor_id)
            return {"status": "granted"}
        if spec.kind == "worker_lease":
            # task-lease grant: allocate the shape ONCE and pin one worker
            # for the owner's direct dispatch; grant-or-reject against the
            # authoritative ledger like any lease. Worker pinning happens
            # off the admission thread (it can wait on the pool).
            if not self.ledger.try_allocate(req):
                return {
                    "status": "reject",
                    "available": self.ledger.avail_map(),
                }
            assign = self.accel.allocate(spec.resources)
            if assign is None:
                self.ledger.release(req)
                return {
                    "status": "reject",
                    "available": self.ledger.avail_map(),
                }
            self._exec_pool.submit(
                self._activate_task_lease, spec, ("ledger", req, assign)
            )
            return {"status": "granted"}
        if spec.kind == "task" and spec.deps and not self._args_ready(spec):
            # dependency-aware dispatch: wait for args BEFORE taking
            # resources or a worker (lease_dependency_manager.h:41-53) —
            # a ready lease interleaves past this one
            self._note_on_hand(spec)
            self._park_for_deps(spec)
            return {"status": "granted"}
        if spec.pg_reservation is not None:
            if not self._bundle_allocate(spec.pg_reservation, spec.resources):
                return {"status": "reject", "available": self.ledger.avail_map()}
            scalar_alloc = ("pg", spec.pg_reservation, dict(spec.resources))
        elif self.ledger.try_allocate(req):
            scalar_alloc = ("ledger", req)
        else:
            # stale head view → reject with the authoritative snapshot
            return {"status": "reject", "available": self.ledger.avail_map()}
        # chip-index assignment (resource_instance_set.h analog): a
        # scalar-feasible integer demand always fits; fractional shares can
        # hit fragmentation → undo the scalar grant and reject
        assign = self.accel.allocate(spec.resources)
        if assign is None:
            self._release(scalar_alloc)
            return {"status": "reject", "available": self.ledger.avail_map()}
        alloc = scalar_alloc + (assign,)
        self._note_on_hand(spec)
        if _has_env(spec.runtime_env):
            # pip/uv/conda runtime env: needs a worker bound to the built
            # env (dedicated interpreter path); dispatched individually —
            # env builds can take seconds and must not stall the batch
            # drainer
            self._exec_pool.submit(self._dispatch_pip_task, spec, alloc)
        elif spec.kind == "actor_creation":
            # pins its worker for life — dispatched individually
            self._exec_pool.submit(self._dispatch_to_worker, spec, alloc)
        else:
            # plain tasks queue for the batching drainer: one PushTaskBatch
            # RPC carries several tasks to one worker (amortizes the
            # per-push round trip the way the reference pipelines leases)
            with self._task_cv:
                self._task_buf.append((spec, alloc))
                self._task_cv.notify()
        return {"status": "granted"}

    # ------------------------------------------------------------------
    # dependency-aware dispatch (LeaseDependencyManager analog,
    # raylet/lease_dependency_manager.h:41-53): a lease whose args are not
    # yet fetchable waits here WITHOUT resources or a worker — a ready
    # lease interleaves past it. Missing remote args are prefetched into
    # the local store while waiting (pull-before-grant, the reference's
    # "args ready → lease dispatchable" contract).
    # ------------------------------------------------------------------
    def _args_ready(self, spec: LeaseRequest) -> bool:
        """True if every TOP-LEVEL arg is local, inline-fetchable, or
        errored (the worker can resolve all of them without blocking).
        Nested refs never gate dispatch — a task may be the very thing that
        unblocks the object a nested ref names."""
        for oid in spec.deps:
            if not self.store.contains(oid) and oid not in self._dep_ready_ids:
                return False
        return True

    def _park_for_deps(self, spec: LeaseRequest) -> None:
        missing = [
            oid
            for oid in spec.deps
            if not self.store.contains(oid) and oid not in self._dep_ready_ids
        ]
        with self._dep_cv:
            self._dep_waiting[spec.task_id] = (spec, set(missing))
            self._dep_cv.notify()

    def _dep_loop(self) -> None:
        """Resolve waiting leases: one batched head query per tick covers
        every missing arg; sealed-remote args trigger background pulls."""
        while not self._shutdown:
            if len(self._dep_ready_ids) > (1 << 16):
                self._dep_ready_ids.clear()  # cache, not ground truth
            with self._dep_cv:
                if not self._dep_waiting:
                    self._dep_cv.wait(timeout=0.5)
                    continue
                missing_all = sorted(
                    {o for _, m in self._dep_waiting.values() for o in m}
                )
            statuses: Dict[str, str] = {}
            unseen = [o for o in missing_all if not self.store.contains(o)]
            for o in missing_all:
                if o not in unseen:
                    statuses[o] = "local"
            if unseen:
                try:
                    replies = self.head.call(
                        "WaitObjectBatch",
                        {"object_ids": unseen, "timeout": 0.25},
                        timeout=15.0,
                    )
                except RpcError:
                    time.sleep(0.2)
                    continue
                for oid, rep in zip(unseen, replies):
                    st = rep["status"]
                    statuses[oid] = st
                    if st in ("inline", "error"):
                        # fetchable from the head without blocking
                        self._dep_ready_ids.add(oid)
                    elif st == "located":
                        self._prefetch(oid, rep["locations"])
            ready: List[LeaseRequest] = []
            with self._dep_cv:
                for tid in list(self._dep_waiting):
                    spec, missing = self._dep_waiting[tid]
                    missing.difference_update(
                        o
                        for o in list(missing)
                        if statuses.get(o) in ("local", "inline", "error")
                        or self.store.contains(o)
                        or o in self._dep_ready_ids
                    )
                    if not missing:
                        del self._dep_waiting[tid]
                        ready.append(spec)
            for spec in ready:
                self._admit_ready(spec)

    def _prefetch(self, oid: str, locations) -> None:
        """Background pull of a sealed remote object into the local store
        (pull_manager.h:40 analog), deduped while in flight."""
        with self._lock:
            if oid in self._pulls_in_flight:
                return
            self._pulls_in_flight.add(oid)

        def pull() -> None:
            try:
                for nid, addr in locations:
                    if nid == self.node_id or self.store.contains(oid):
                        return
                    # socket plane first (striped, resumable, lands
                    # straight in the arena); chunked RPC on any miss
                    try:
                        size = self._fetch_peer_to_store(
                            nid, oid, "task_args"
                        )
                    except KeyError:
                        continue
                    if size is not None:
                        self._report_to_head(
                            {
                                "node_id": self.node_id,
                                "seals": [
                                    SealInfo(
                                        object_id=oid,
                                        node_id=self.node_id,
                                        size=size,
                                    )
                                ],
                            }
                        )
                        return
                    try:
                        data = fetch_chunked(
                            self._peer(nid, addr), oid, purpose="task_args"
                        )
                    except (RpcError, KeyError, TimeoutError, ChunkFetchError):
                        continue
                    try:
                        self.store.put_bytes(oid, data)
                        self._report_to_head(
                            {
                                "node_id": self.node_id,
                                "seals": [
                                    SealInfo(
                                        object_id=oid,
                                        node_id=self.node_id,
                                        size=len(data),
                                    )
                                ],
                            }
                        )
                    except Exception:  # noqa: BLE001 - arena full
                        self._dep_ready_ids.add(oid)  # worker pulls inline
                    return
            finally:
                with self._lock:
                    self._pulls_in_flight.discard(oid)
                with self._dep_cv:
                    self._dep_cv.notify()

        self._exec_pool.submit(pull)

    def _admit_ready(self, spec: LeaseRequest) -> None:
        """Args are ready: NOW allocate resources + chips and queue for a
        worker; allocation failure spills back to the head (the resources
        went to leases that ran while this one waited)."""
        req = ResourceRequest.from_map(self.vocab, spec.resources)
        if spec.pg_reservation is not None:
            if not self._bundle_allocate(spec.pg_reservation, spec.resources):
                self._spillback(spec, "pg bundle busy after dep wait")
                return
            scalar_alloc = ("pg", spec.pg_reservation, dict(spec.resources))
        elif self.ledger.try_allocate(req):
            scalar_alloc = ("ledger", req)
        else:
            self._spillback(spec, "resources busy after dep wait")
            return
        assign = self.accel.allocate(spec.resources)
        if assign is None:
            self._release(scalar_alloc)
            self._spillback(spec, "chips busy after dep wait")
            return
        if _has_env(spec.runtime_env):
            self._exec_pool.submit(
                self._dispatch_pip_task, spec, scalar_alloc + (assign,)
            )
            return
        with self._task_cv:
            self._task_buf.append((spec, scalar_alloc + (assign,)))
            self._task_cv.notify()

    def _spillback(self, spec: LeaseRequest, reason: str) -> None:
        # requeue=True: pure resource contention must NOT burn the task's
        # retry budget (the grant path's "reject" has the same semantics)
        self._report_to_head(
            {
                "node_id": self.node_id,
                "available": self.ledger.avail_map(),
                "failed": [
                    {
                        "task_id": spec.task_id,
                        "reason": reason,
                        "retryable": True,
                        "requeue": True,
                    }
                ],
            }
        )

    PUSH_BATCH = 8

    def _task_drain_loop(self) -> None:
        """Single drainer: pairs queued plain tasks with idle workers in
        batches (worker_pool dispatch loop analog, batched)."""
        while not self._shutdown:
            with self._task_cv:
                while not self._task_buf and not self._shutdown:
                    self._task_cv.wait(timeout=0.5)
                if self._shutdown:
                    return
            handle = self._pop_idle_worker()
            with self._idle_cv:
                spare_workers = len(self._idle)
            with self._task_cv:
                # spread across idle workers first (process parallelism for
                # CPU-bound tasks); batch multiple per worker only when
                # tasks outnumber workers — the regime where the per-push
                # RPC amortization matters
                buffered = len(self._task_buf)
                per_worker = -(-buffered // (spare_workers + 1))  # ceil
                n = min(buffered, max(1, per_worker), self.PUSH_BATCH)
                items = [self._task_buf.popleft() for _ in range(n)]
            if handle is None:
                for spec, alloc in items:
                    self._release(alloc)
                    self._report_to_head(
                        {
                            "node_id": self.node_id,
                            "failed": [
                                {
                                    "task_id": spec.task_id,
                                    "reason": "no worker available",
                                    "retryable": True,
                                }
                            ],
                        }
                    )
                continue
            if not items:
                self._return_worker(handle)
                continue
            self._exec_pool.submit(self._run_batch_on_worker, items, handle)

    def _run_batch_on_worker(self, items, handle: _WorkerHandle) -> None:
        reqs = [
            self._push_req(spec, self._alloc_env(alloc))
            for spec, alloc in items
        ]
        now = time.monotonic()
        for spec, _ in items:
            if spec.kind == "task":
                handle.running[spec.task_id] = now
        try:
            with handle.lock:
                replies = handle.client.call(
                    "PushTaskBatch", reqs, timeout=None
                )
        except RpcError:
            for spec, _ in items:
                handle.running.pop(spec.task_id, None)
            for _, alloc in items:
                self._release(alloc)
            if not self._shutdown:
                self._on_worker_death(handle, [s for s, _ in items])
            return
        except BaseException:  # noqa: BLE001 - remote exception shipped back
            # a handler-level failure must not strand the leases with their
            # resources held and the worker never returned to the pool
            logger.exception("PushTaskBatch failed; requeueing %d", len(items))
            for spec, alloc in items:
                handle.running.pop(spec.task_id, None)
                self._release(alloc)
                self._spillback(spec, "worker push failed")
            self._return_worker(handle)
            return
        try:
            for (spec, alloc), reply in zip(items, replies):
                handle.running.pop(spec.task_id, None)
                self._finish_worker_reply(
                    spec, handle, alloc, reply, return_worker=False
                )
        finally:
            self._return_worker(handle)

    def _drain_async_methods(self, actor_id: str) -> None:
        """Single-flight batch pusher for one async actor's methods."""
        while True:
            with self._lock:
                buf = self._async_buf.get(actor_id)
                if not buf:
                    self._async_draining.discard(actor_id)
                    return
                specs = []
                while buf and len(specs) < 64:
                    specs.append(buf.popleft())
                worker_id = self._actor_workers.get(actor_id)
                handle = self._workers.get(worker_id) if worker_id else None
            if handle is None:
                self._report_to_head(
                    {
                        "node_id": self.node_id,
                        "failed": [
                            {
                                "task_id": s.task_id,
                                "reason": "actor worker is gone",
                                "retryable": False,
                            }
                            for s in specs
                        ],
                    }
                )
                continue
            try:
                replies = handle.client.call(
                    "PushTaskBatch",
                    [self._push_req(s) for s in specs],
                    timeout=None,
                )
            except RpcError:
                # clear the single-flight flag or the restarted actor's
                # methods would buffer forever with no drainer
                with self._lock:
                    self._async_draining.discard(actor_id)
                if not self._shutdown:
                    self._on_worker_death(handle, specs)
                return
            except BaseException:  # noqa: BLE001 - shipped remote exception
                logger.exception("async PushTaskBatch failed; requeueing")
                for s in specs:
                    self._spillback(s, "worker push failed")
                continue
            for s, reply in zip(specs, replies):
                if reply.get("status") == "async_pending":
                    with self._lock:
                        early = self._early_task_done.pop(s.task_id, None)
                        if early is None:
                            self._async_pending[s.task_id] = (s, handle)
                    if early is not None:
                        self._finish_worker_reply(s, handle, None, early)
                else:
                    self._finish_worker_reply(
                        s, handle, None, reply, return_worker=False
                    )

    def _drain_actor_fifo(self, actor_id: str) -> None:
        while True:
            with self._lock:
                fifo = self._actor_fifo.get(actor_id)
                if not fifo:
                    self._actor_draining.discard(actor_id)
                    return
                spec = fifo.pop(0)
                worker_id = self._actor_workers.get(actor_id)
                handle = self._workers.get(worker_id) if worker_id else None
            if handle is None:
                self._report_to_head(
                    {
                        "node_id": self.node_id,
                        "failed": [
                            {
                                "task_id": spec.task_id,
                                "reason": "actor worker is gone",
                                "retryable": False,
                            }
                        ],
                    }
                )
                continue
            self._run_on_worker(spec, handle, None)

    def _dispatch_to_worker(self, spec: LeaseRequest, alloc) -> None:
        handle = self._pop_idle_worker()
        if handle is None:
            self._release(alloc)
            self._report_to_head(
                {
                    "node_id": self.node_id,
                    "failed": [
                        {
                            "task_id": spec.task_id,
                            "reason": "no worker available",
                            "retryable": True,
                        }
                    ],
                }
            )
            return
        if spec.kind == "actor_creation":
            self._create_actor_on(spec, handle, alloc, tainted=bool(spec.runtime_env),
                                  backfill=True)
            return
        self._run_on_worker(spec, handle, alloc)

    def _create_actor_on(self, spec: LeaseRequest, handle: _WorkerHandle, alloc,
                         tainted: bool, backfill: bool) -> None:
        """Pin ``handle`` to the actor and push its creation. The worker's
        push lock is held from before the actor's methods can find the
        worker until the creation has been pushed: a method lease drained
        in between (the backfill can take a fork) waits for it instead of
        reaching the worker ahead of the instance (the reference releases
        the mapping first, and such a method fails with the worker's
        ``KeyError``; Queue C 13)."""
        with handle.lock:
            with self._lock:
                handle.actor_id = spec.actor_id
                if tainted:
                    # env persists for the actor's life: deny later reuse
                    handle.env_tainted = True
                self._actor_workers[spec.actor_id] = handle.worker_id
                # kept for head-restart re-registration (_node_info):
                # the head rebuilds ActorInfo/name bindings from this
                self._actor_meta[spec.actor_id] = dict(spec.actor_meta or {})
            if backfill:
                # an actor pins its worker for life; backfill the pool 1:1 so
                # the free pool never shrinks below num_workers (the reference
                # starts dedicated worker processes per actor on demand,
                # worker_pool.cc StartWorkerProcess) — the previous total-count
                # cap starved the Nth actor creation once N-1 actors held all
                # the workers. Workers still warming (prestarted or a peer
                # creation's backfill) count as free: the hole they will fill
                # is already covered.
                with self._idle_cv:
                    free = len(self._idle) + self._spawns_pending
                if free < self._num_workers:
                    self._spawn_worker()
            self._run_on_worker(spec, handle, alloc, serialize=False)

    def _dispatch_pip_task(self, spec: LeaseRequest, alloc) -> None:
        """Route a lease carrying a pip runtime env to a worker bound to
        that env (building it first if needed). Mirrors the reference's
        agent-side env creation before worker startup
        (_private/runtime_env/agent/main.py shape)."""
        # dispatch guard ref taken BEFORE ensure: the GC sweep must never
        # delete the env between its build and its worker's spawn. The
        # slice/key prologue sits INSIDE the failure path too: a malformed
        # runtime_env (e.g. pip+uv merged from job-level + task-level
        # envs) must release the allocation and report, not die silently
        # in the exec pool.
        guard_key = None
        try:
            env = env_slice(spec.runtime_env)
            kind = next(iter(env))
            guard_key = self._pip_mgr.key_of(env)
            self._pip_mgr.acquire(guard_key)
            key, env_dir = self._pip_mgr.ensure(env)
        except Exception as exc:  # noqa: BLE001 - build failure is final
            if guard_key is not None:
                self._pip_mgr.release(guard_key)
            self._release(alloc)
            self._report_to_head(
                {
                    "node_id": self.node_id,
                    "failed": [
                        {
                            "task_id": spec.task_id,
                            "reason": f"runtime_env build failed: {exc}",
                            "retryable": False,
                        }
                    ],
                }
            )
            return
        try:
            handle = self._pop_pip_worker(key, env_dir, kind=kind)
        except Exception:  # noqa: BLE001 - spawn failure (fork pressure)
            logger.exception("pip env worker spawn failed")
            handle = None
        finally:
            # the worker (if obtained) holds its own env ref now
            self._pip_mgr.release(guard_key)
        if handle is None:
            self._release(alloc)
            self._report_to_head(
                {
                    "node_id": self.node_id,
                    "failed": [
                        {
                            "task_id": spec.task_id,
                            "reason": "pip env worker unavailable",
                            "retryable": True,
                        }
                    ],
                }
            )
            return
        if spec.kind == "actor_creation":
            # env-bound worker: never reuse
            self._create_actor_on(spec, handle, alloc, tainted=True, backfill=False)
            return
        self._run_on_worker(spec, handle, alloc)

    def _pop_pip_worker(
        self, key: str, env_dir: str, kind: str = "pip", timeout: float = 120.0
    ) -> Optional[_WorkerHandle]:
        """Idle env-bound worker, or spawn one (torch import makes worker
        startup seconds-scale; the deadline covers it)."""
        deadline = time.monotonic() + timeout
        with self._idle_cv:
            lst = self._pip_idle.get(key)
            if lst:
                return self._workers[lst.pop()]
        # the worker's env ref lives exactly as long as its handle: taken
        # here, released once by _on_worker_death / the GC reaper (a
        # straggler that registers after our deadline keeps its ref until
        # the health loop or reaper collects it)
        self._pip_mgr.acquire(key)
        try:
            self._spawn_worker(pip_env=(key, env_dir, kind))
        except BaseException:
            self._pip_mgr.release(key)
            raise
        with self._idle_cv:
            while True:
                lst = self._pip_idle.get(key)
                if lst:
                    return self._workers[lst.pop()]
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._shutdown:
                    return None
                self._idle_cv.wait(timeout=min(remaining, 0.5))

    def _pip_gc_loop(self) -> None:
        """Reap env workers idle past the threshold, GC unreferenced env
        dirs (the reference's runtime-env GC on idle), and trim the PLAIN
        idle pool back to num_workers — prestart/backfill surplus from a
        churn burst must not hold extra worker processes forever."""
        from ray_tpu_torch.config import cfg

        while not self._shutdown:
            time.sleep(min(10.0, max(1.0, cfg.runtime_env_idle_gc_s / 3)))
            now = time.monotonic()
            victims: List[_WorkerHandle] = []
            with self._idle_cv:
                for key, lst in list(self._pip_idle.items()):
                    keep = []
                    for wid in lst:
                        h = self._workers.get(wid)
                        if h is None:
                            continue
                        if now - h.idle_since > cfg.runtime_env_idle_gc_s:
                            victims.append(h)
                        else:
                            keep.append(wid)
                    if keep:
                        self._pip_idle[key] = keep
                    else:
                        self._pip_idle.pop(key, None)
                # plain-pool trim: stalest first (pops take from the end,
                # so the front of the list has been idle longest)
                excess = len(self._idle) - self._num_workers
                if excess > 0:
                    for wid in list(self._idle):
                        if excess <= 0:
                            break
                        h = self._workers.get(wid)
                        if (
                            h is not None
                            and now - h.idle_since
                            > cfg.runtime_env_idle_gc_s
                        ):
                            self._idle.remove(wid)
                            self._workers.pop(wid, None)
                            victims.append(h)
                            excess -= 1
            pip_victims = 0
            for h in victims:
                if h.pip_key is not None:
                    with self._idle_cv:
                        first = (
                            self._workers.pop(h.worker_id, None) is not None
                        )
                    if first:  # may race a concurrent death observation
                        self._pip_mgr.release(h.pip_key)
                    pip_victims += 1
                try:
                    h.proc.terminate()
                except OSError:
                    pass
                self._close_worker_client(h)
            if victims:
                # the reaped processes' borrow counts die with them
                self._report_to_head(
                    {
                        "node_id": self.node_id,
                        "holders_gone": [h.worker_id for h in victims],
                    }
                )
            if pip_victims:
                self._pip_mgr.gc()

    def _push_req(self, spec: LeaseRequest, accel_env=None) -> dict:
        return {
            "task_id": spec.task_id,
            "kind": spec.kind,
            "actor_id": spec.actor_id,
            "payload": spec.payload,
            "return_ids": spec.return_ids,
            "arg_ids": spec.arg_ids,
            "name": spec.name,
            "runtime_env": spec.runtime_env,
            "actor_meta": spec.actor_meta,
            "accel_env": accel_env,
            "trace": spec.trace,
            "fn_blob": spec.fn_blob,
            "fn_id": spec.fn_id,
            "fn_cache": spec.fn_cache,
            "streaming": spec.streaming,
            "client_id": spec.client_id,
            "retry_exceptions": (
                spec.retry_exceptions and spec.attempt < spec.max_retries
            ),
        }

    @staticmethod
    def _alloc_env(alloc):
        """TPU_VISIBLE_CHIPS / CUDA_VISIBLE_DEVICES for a granted lease."""
        if alloc is None:
            return None
        assign = None
        if alloc[0] == "ledger" and len(alloc) > 2:
            assign = alloc[2]
        elif alloc[0] == "pg" and len(alloc) > 3:
            assign = alloc[3]
        if not assign:
            return None
        return NodeAcceleratorState.env_for(assign) or None

    def _run_on_worker(
        self, spec: LeaseRequest, handle: _WorkerHandle, alloc, serialize: bool = True
    ) -> None:
        import contextlib

        # async-actor methods skip the per-worker lock: the worker's event
        # loop multiplexes them (serialize=False from _h_execute_lease)
        guard = handle.lock if serialize else contextlib.nullcontext()
        if spec.kind == "task":
            handle.running[spec.task_id] = time.monotonic()
        try:
            with guard:  # per-worker ordering (actor sequential exec)
                reply = handle.client.call(
                    "PushTask",
                    self._push_req(spec, self._alloc_env(alloc)),
                    timeout=None,
                )
        except RpcError:
            handle.running.pop(spec.task_id, None)
            self._release(alloc)
            if not self._shutdown:
                self._on_worker_death(handle, [spec])
            return
        except BaseException:  # noqa: BLE001 - remote exception shipped back
            logger.exception("PushTask failed for %s; requeueing", spec.name)
            handle.running.pop(spec.task_id, None)
            self._release(alloc)
            self._spillback(spec, "worker push failed")
            if spec.kind == "task":
                self._return_worker(handle)
            return
        handle.running.pop(spec.task_id, None)
        if reply.get("status") == "async_pending":
            # the worker accepted the method onto its event loop and will
            # deliver the outcome via TaskDone — free this thread now.
            # A fast coroutine's TaskDone can BEAT this reply back to the
            # agent (two independent RPC paths); it parks in
            # _early_task_done and is consumed here.
            with self._lock:
                early = self._early_task_done.pop(spec.task_id, None)
                if early is None:
                    self._async_pending[spec.task_id] = (spec, handle)
            if early is not None:
                self._finish_worker_reply(spec, handle, None, early)
            return
        self._finish_worker_reply(spec, handle, alloc, reply)

    def _h_task_done(self, req: dict) -> None:
        """Completion callback for async-actor methods (worker → agent)."""
        with self._lock:
            entry = self._async_pending.pop(req["task_id"], None)
            if entry is None:
                # outran the worker's own PushTask reply: stash for the
                # dispatch thread (see _run_on_worker). Worker-death entries
                # land here too and are dropped with the handle.
                self._early_task_done[req["task_id"]] = req["reply"]
                return
        spec, handle = entry
        self._finish_worker_reply(spec, handle, None, req["reply"])

    def _finish_worker_reply(
        self,
        spec: LeaseRequest,
        handle: _WorkerHandle,
        alloc,
        reply: dict,
        return_worker: bool = True,
    ) -> None:
        status = reply.get("status")
        if spec.kind == "actor_creation" and status == "ok":
            # a live actor holds its lease resources for its lifetime
            # (GcsActorScheduler lease semantics); released on death/kill.
            with self._lock:
                self._actor_allocs[spec.actor_id] = alloc
                if reply.get("async_actor"):
                    self._async_actors.add(spec.actor_id)
        else:
            self._release(alloc)
        report: Dict[str, Any] = {
            "node_id": self.node_id,
            "available": self.ledger.avail_map(),
            "finished": [spec.task_id],
        }
        if reply.get("borrows"):
            report["borrows"] = [
                {"holder": handle.worker_id, "object_ids": reply["borrows"]}
            ]
        if status == "retry":
            report.pop("finished")
            report["failed"] = [
                {
                    "task_id": spec.task_id,
                    "reason": reply.get("error_repr", "task raised"),
                    "retryable": True,
                }
            ]
        else:
            report["seals"] = reply.get("seals", [])
            self._note_seals(report["seals"])
            if spec.kind == "actor_creation" and status == "ok":
                report["actors_alive"] = [
                    {
                        "actor_id": spec.actor_id,
                        "node_id": self.node_id,
                        "address": self.address,
                    }
                ]
            elif spec.kind == "actor_creation":
                report["actors_dead"] = [
                    {
                        "actor_id": spec.actor_id,
                        "reason": reply.get("error_repr", "init failed"),
                    }
                ]
        if (
            return_worker
            and spec.kind != "actor_method"
            and spec.kind != "actor_creation"
        ):
            self._return_worker(handle)
        self._report_to_head(report)

    def _release(self, alloc) -> None:
        if alloc is None:
            return
        if alloc[0] == "ledger":
            self.ledger.release(alloc[1])
            if len(alloc) > 2:
                self.accel.release(alloc[2])
        else:
            self._bundle_release(alloc[1], alloc[2])
            if len(alloc) > 3:
                self.accel.release(alloc[3])

    # ------------------------------------------------------------------
    # placement-group bundles (PlacementGroupResourceManager analog,
    # raylet/placement_group_resource_manager.cc)
    # ------------------------------------------------------------------
    def _h_prepare_bundles(self, req: dict) -> dict:
        pg_id, bundles = req["pg_id"], req["bundles"]
        agg: Dict[str, float] = {}
        for b in bundles.values():
            for k, v in b.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        r = ResourceRequest.from_map(self.vocab, agg)
        if not self.ledger.try_allocate(r):
            return {"ok": False}
        with self._lock:
            self._bundles[pg_id] = {
                "state": "prepared",
                "agg": agg,
                "bundles": {int(i): dict(b) for i, b in bundles.items()},
            }
        return {"ok": True}

    def _h_commit_bundles(self, req: dict) -> None:
        with self._lock:
            entry = self._bundles.get(req["pg_id"])
            if entry is not None:
                entry["state"] = "committed"

    def _h_rollback_bundles(self, req: dict) -> None:
        self._h_return_bundles(req)

    def _h_return_bundles(self, req: dict) -> None:
        with self._lock:
            entry = self._bundles.pop(req["pg_id"], None)
        if entry is not None:
            self.ledger.release(
                ResourceRequest.from_map(self.vocab, entry["agg"])
            )

    def _bundle_allocate(self, reservation, resources: Dict[str, float]) -> bool:
        pg_id, idx = reservation
        with self._lock:
            entry = self._bundles.get(pg_id)
            if entry is None:
                return False
            bundle = entry["bundles"].get(int(idx))
            if bundle is None:
                return False
            for k, v in resources.items():
                if bundle.get(k, 0.0) < v - _EPS:
                    return False
            for k, v in resources.items():
                bundle[k] = bundle.get(k, 0.0) - v
            return True

    def _bundle_release(self, reservation, resources: Dict[str, float]) -> None:
        pg_id, idx = reservation
        with self._lock:
            entry = self._bundles.get(pg_id)
            if entry is None:
                return
            bundle = entry["bundles"].get(int(idx))
            if bundle is None:
                return
            for k, v in resources.items():
                bundle[k] = bundle.get(k, 0.0) + v

    # ------------------------------------------------------------------
    # object plane
    # ------------------------------------------------------------------
    def _h_store_object(self, req: dict) -> None:
        self.store.put_bytes(req["object_id"], req["data"])

    def _h_fetch_object(self, req: dict) -> bytes:
        with self._push_adm(req.get("purpose", "task_args")):
            data = self.store.get_bytes(req["object_id"])
            OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "rpc"})
            return data

    def _h_fetch_object_batch(self, req: dict) -> List[bytes]:
        with self._push_adm(req.get("purpose", "task_args")):
            out = [self.store.get_bytes(oid) for oid in req["object_ids"]]
            OBJECT_TRANSFER_BYTES.inc(
                sum(len(d) for d in out), labels={"path": "rpc"}
            )
            return out

    def _h_fetch_object_meta(self, req: dict) -> dict:
        """Chunked-pull handshake: size without bytes (KeyError when the
        object left this node — the puller tries the next replica)."""
        return {"size": self.store.object_size(req["object_id"])}

    def _h_fetch_object_chunk(self, req: dict) -> bytes:
        """One window of an object (push_manager chunk analog). Each
        chunk passes admission separately so a multi-GB pull cannot park
        a transfer slot for its whole duration."""
        with self._push_adm(req.get("purpose", "task_args")):
            data = self.store.get_range(
                req["object_id"], int(req["offset"]), int(req["length"])
            )
            OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "rpc"})
            return data

    def _h_delete_objects(self, req: dict) -> None:
        logger.debug(
            "DeleteObjects: %d ids (%s...)",
            len(req["object_ids"]),
            ",".join(o[:8] for o in req["object_ids"][:4]),
        )
        for oid in req["object_ids"]:
            try:
                self.store.delete(oid)
            except Exception:  # noqa: BLE001
                pass

    def _h_worker_put(self, req: dict) -> None:
        """Worker fallback put when the shm arena is unavailable/full."""
        self.store.put_bytes(req["object_id"], req["data"])

    def _h_ref_update(self, req: dict) -> None:
        """Worker → head refcount relay (workers only talk to their agent;
        the head is the refcount authority)."""
        self.head.call("RefUpdate", req, timeout=10.0)

    def _note_seals(self, seals) -> None:
        """Workers seal big objects straight into the shared arena;
        register them in the spill LRU book."""
        for s in seals:
            if (
                not s.is_error
                and s.inline_value is None
                and s.node_id == self.node_id
            ):
                self.store.note_external(s.object_id, s.size)

    def _h_worker_sealed(self, req: dict) -> None:
        """Out-of-band seal from a worker (ray_tpu_torch.put inside a task,
        async-actor results, streaming-generator items). Worker registry
        deltas piggyback here (the seal channel IS the worker's metrics
        uplink): they queue pre-labeled and ride the agent's next
        metrics ship instead of triggering a head report of their own."""
        if req.get("metrics"):
            with self._metric_lock:
                self._worker_metric_relays.extend(req["metrics"])
        if not (
            req["seals"] or req.get("stream") or req.get("stream_done")
        ):
            return  # metrics-only push
        self._note_seals(req["seals"])
        report = {"node_id": self.node_id, "seals": req["seals"]}
        for k in ("stream", "stream_done"):
            if req.get(k):
                report[k] = req[k]
        self._report_to_head(report)

    def _h_stream_consumed(self, req: dict) -> dict:
        """Worker backpressure poll, relayed to the head's watermark."""
        return self.head.call("StreamConsumed", req, timeout=10.0)

    def _h_get_object_for_worker(self, req: dict) -> dict:
        """Local miss → pull from a remote node (PullManager analog,
        object_manager/pull_manager.h:40): locate via head, fetch chunked
        from the peer agent, cache into the local store."""
        oid = req["object_id"]
        if self.store.contains(oid):
            return self._local_reply(oid)
        # timeout=None means wait as long as the dependency takes (task-arg
        # waits are unbounded in the reference's LeaseDependencyManager).
        timeout = req.get("timeout")
        deadline = None if timeout is None else time.monotonic() + timeout
        while deadline is None or time.monotonic() < deadline:
            reply = self.head.call(
                "WaitObject",
                {"object_id": oid, "timeout": 2.0},
                timeout=15.0,
            )
            status = reply["status"]
            if status == "error":
                return {"status": "error", "error": reply["error"]}
            if status == "inline":
                return {"status": "inline", "data": reply["data"]}
            if status == "located":
                remaining = None
                if deadline is not None:
                    remaining = max(0.1, deadline - time.monotonic())
                out = self._pull_located(
                    oid,
                    reply["locations"],
                    remaining,
                    purpose=req.get("purpose", "task_args"),
                )
                if out is not None:
                    return out
        return {"status": "timeout"}

    def _pull_located(
        self,
        oid: str,
        locations,
        wait_s: Optional[float] = None,
        purpose: str = "task_args",
    ) -> Optional[dict]:
        """Admission-controlled peer pull: concurrent requests for the same
        object coalesce behind one leader fetch, and in-flight transfers
        are bounded class-aware (GET > WAIT > TASK_ARGS — an interactive
        get is never queued behind a storm of task-arg prefetches)."""
        with self._lock:
            ev = self._pull_waiters.get(oid)
            leader = ev is None
            if leader:
                ev = self._pull_waiters[oid] = threading.Event()
        if not leader:
            # followers honor the CALLER's deadline, not a fixed park
            ev.wait(timeout=120.0 if wait_s is None else min(wait_s, 120.0))
            if self.store.contains(oid):
                return self._local_reply(oid)
            return None  # leader failed; retry via the locate loop
        gone_nodes: List[str] = []
        try:
            with self._pull_adm(purpose):
                for nid, addr in locations:
                    if nid == self.node_id:
                        if self.store.contains(oid):
                            return self._local_reply(oid)
                        continue
                    deadline = (
                        None
                        if wait_s is None
                        else time.monotonic() + wait_s
                    )
                    # socket plane first: striped scatter-gather pull
                    # over the cached peer link, landing straight in the
                    # arena (zero per-transfer head RPCs)
                    try:
                        size = self._fetch_peer_to_store(
                            nid, oid, purpose, deadline
                        )
                    except KeyError:
                        gone_nodes.append(nid)
                        continue
                    if size is not None:
                        self._report_to_head(
                            {
                                "node_id": self.node_id,
                                "seals": [
                                    SealInfo(
                                        object_id=oid,
                                        node_id=self.node_id,
                                        size=size,
                                    )
                                ],
                            }
                        )
                        return self._local_reply(oid)
                    try:
                        # streamed, chunked, resumable pull: bounded
                        # in-flight windows; a dropped chunk re-requests
                        # alone instead of restarting the object. The
                        # relocate hook re-resolves the source between
                        # chunk retries, so a mid-transfer source death
                        # aborts to the locate loop instead of burning
                        # the whole retry budget against a dead peer.
                        data = fetch_chunked(
                            self._peer(nid, addr),
                            oid,
                            purpose=purpose,
                            deadline=deadline,
                            relocate=self._make_relocate(oid, nid, addr),
                        )
                    except KeyError:
                        # DEFINITE miss: the peer answered and does not
                        # hold the object (evicted, lost mid-spill, or a
                        # stale directory row). Report it so the head
                        # prunes the location — and reconstructs through
                        # lineage if that was the last copy. Transient
                        # failures below never trigger this: a timeout
                        # must not cost a re-execution.
                        gone_nodes.append(nid)
                        continue
                    except (RpcError, TimeoutError, ChunkFetchError):
                        # RpcError: transport blip; TimeoutError: its
                        # push admission saturated; ChunkFetchError: a
                        # chunk died past its retry budget — try the next
                        # copy, then the locate loop
                        continue
                    try:
                        self.store.put_bytes(oid, data)
                        # advertise the new copy (object directory update)
                        self._report_to_head(
                            {
                                "node_id": self.node_id,
                                "seals": [
                                    SealInfo(
                                        object_id=oid,
                                        node_id=self.node_id,
                                        size=len(data),
                                    )
                                ],
                            }
                        )
                        return self._local_reply(oid)
                    except Exception:  # noqa: BLE001 - arena full
                        return {"status": "inline", "data": data}
            return None
        finally:
            with self._lock:
                self._pull_waiters.pop(oid, None)
            ev.set()
            if gone_nodes:
                self._report_to_head(
                    {
                        "node_id": self.node_id,
                        "objects_missing": [
                            {"object_id": oid, "node_ids": gone_nodes}
                        ],
                    }
                )

    def _make_relocate(self, oid: str, nid: str, addr: str):
        """Relocate hook for :func:`fetch_chunked`: one head locate
        round-trip re-resolving where ``oid`` lives NOW. Returns the
        client for the current source (still listed), a replacement
        replica's client (the directory moved it), or None (gone
        everywhere — the pull aborts so the caller re-plans via its
        locate loop / lineage reconstruction)."""

        def _relocate():
            try:
                rep = self.head.call(
                    "WaitObject",
                    {"object_id": oid, "timeout": 0.2},
                    timeout=10.0,
                    epoch=self._head_epoch,
                )
            except Exception:  # noqa: BLE001 - head unreachable: no verdict
                return self._peer(nid, addr)  # keep retrying the source
            if rep.get("status") != "located":
                return None  # inline/error/pending: stop pulling bytes
            live = {n: a for n, a in rep["locations"]}
            if nid in live:
                return self._peer(nid, live[nid])
            for n2, a2 in rep["locations"]:
                if n2 != self.node_id:
                    return self._peer(n2, a2)
            return None

        return _relocate

    def _local_reply(self, oid: str) -> dict:
        """Workers read 'local' objects straight from the shm arena; a
        spilled object is restored into the arena first (restore path); if
        it can't fit back, or with the in-memory fallback store (no shared
        pages), ship the bytes inline."""
        if self.store_path and self.store.restore_to_arena(oid):
            return {"status": "local"}
        data = self.store.get_bytes(oid)
        OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "inline"})
        return {"status": "inline", "data": data}

    def _node_info(self) -> NodeInfo:
        with self._lock:
            hosted = [
                {"actor_id": aid, **self._actor_meta.get(aid, {})}
                for aid in self._actor_workers
            ]
            held_leases = list(self._task_leases)
        with self._report_cv:
            on_hand = list(self._tasks_on_hand)
        lister = getattr(self.store, "list_objects", None)
        return NodeInfo(
            node_id=self.node_id,
            address=self.address,
            resources=dict(self.resources),
            labels=self.labels,
            hosted_actors=hosted,
            # store inventory: a restarted head re-seeds its object
            # directory from this, so pre-restart refs keep resolving
            stored_objects=list(lister()) if lister is not None else [],
            # a restarted head reconciles these against its lease table
            # and releases any it no longer tracks (pinned-worker leak
            # guard across unpersisted head restarts)
            held_task_leases=held_leases,
            # tasks still running or queued here: a restarted head lets
            # them finish instead of re-driving them
            tasks_on_hand=on_hand,
            # cross-node data plane: advertised so the head can grant
            # peer links to this node (endpoint + token in the grant)
            data_endpoint=(
                self._data_server.endpoint
                if self._data_server is not None
                else ""
            ),
            net_token=(
                self.net_token if self._data_server is not None else ""
            ),
        )

    def _peer(self, node_id: str, address: str) -> RpcClient:
        with self._lock:
            client = self._peer_clients.get(node_id)
            if client is None or client.address != address:
                client = RpcClient(address)
                self._peer_clients[node_id] = client
            return client

    # ------------------------------------------------------------------
    # cross-node data plane (transport.py): socket-first peer pulls over
    # head-granted connection leases, chunked RPC as the fallback for
    # every failure class, RAY_TPU_NATIVE_NET=0 as the kill switch
    # ------------------------------------------------------------------
    def _grant_peer_link(self, node_id: str):
        """One head round-trip per (src, dst) pair — the ONLY control-
        plane involvement in the socket path; every later transfer to
        this peer reuses the cached grant head-free."""
        from .transport import PeerLink

        try:
            rep = self.head.call(
                "GrantPeerLink",
                {"src_node": self.node_id, "dst_node": node_id},
                timeout=10.0,
                epoch=self._head_epoch,
            )
        except (RpcError, RpcStaleEpochError):
            return None
        if not rep.get("granted"):
            return None
        return PeerLink(
            rep["link_id"],
            node_id,
            rep["endpoint"],
            rep["token"],
            rep.get("epoch"),
            src_node=self.node_id,
        )

    def _fetch_peer_to_store(
        self,
        nid: str,
        oid: str,
        purpose: str,
        deadline: Optional[float] = None,
    ) -> Optional[int]:
        """Socket pull of one object straight into the local store
        (striped, resumable, arena scatter-landing). Returns the size,
        or None when the socket plane cannot serve this transfer (link
        denied, handshake rejected, transport death past the stripe
        retry budget) — the caller falls back to chunked RPC. KeyError
        propagates: the peer answered and does not hold the object."""
        from .transport import LinkRejectedError, StripeFetchError

        if not cfg.native_net or nid == self.node_id:
            return None
        link = self._links.get(nid)
        if link is None:
            return None
        from .transport import fetch_to_store

        try:
            return fetch_to_store(
                link, oid, self.store, purpose=purpose, deadline=deadline
            )
        except KeyError:
            raise
        except LinkRejectedError as exc:
            # epoch re-fence or token rotation (peer agent restarted):
            # the cached grant is dead — drop it; the next transfer
            # re-grants through the head and picks up fresh credentials
            logger.info("peer link to %s rejected (%s); dropping", nid, exc)
            self._links.drop(nid, link.link_id)
            return None
        except (StripeFetchError, ConnectionError, TimeoutError, OSError):
            return None

    def _h_revoke_peer_link(self, req: dict) -> dict:
        """Head revoked a link we hold (its destination node died)."""
        return {
            "dropped": self._links.drop(
                req.get("node_id", ""), req.get("link_id")
            )
        }

    def _h_chaos_drop_peer_conn(self, req=None) -> dict:
        """Chaos fault: sever every live data socket this node is
        SERVING mid-transfer. Pullers' in-flight stripes fail and must
        resume (only the lost stripes re-fetch) — the invariant the
        chaos tier asserts."""
        if self._data_server is None:
            return {"dropped": 0, "reason": "no data server"}
        return {"dropped": self._data_server.chaos_drop()}

    def _link_maintenance(self) -> None:
        """Renew-while-hot + idle reclamation (report-loop cadence):
        recently-used link ids piggyback on the coalesced seal report;
        links idle past the TTL close their pooled connections and
        return the lease to the head."""
        hot = self._links.hot_links(cfg.peer_link_ttl_s)
        if hot:
            self._report_to_head(
                {"node_id": self.node_id, "peer_links": hot}
            )
        for link in self._links.sweep_idle(cfg.peer_link_idle_ttl_s):
            try:
                self.head.call(
                    "ReturnPeerLink",
                    {"link_id": link.link_id},
                    timeout=5.0,
                    epoch=self._head_epoch,
                )
            except (RpcError, RpcStaleEpochError):
                pass  # expiry sweep reclaims it server-side

    # ------------------------------------------------------------------
    # reporting (RaySyncer RESOURCE_VIEW analog). Reports are coalesced
    # opportunistically: an idle reporter sends immediately (no added
    # latency); under load, everything queued while the previous RPC was in
    # flight merges into ONE message — the RaySyncer batching that keeps
    # the head from drowning in per-task RPCs.
    # ------------------------------------------------------------------
    def _note_on_hand(self, spec: LeaseRequest) -> None:
        if spec.kind == "task":
            with self._report_cv:
                self._tasks_on_hand.add(spec.task_id)

    def _report_to_head(self, report: Dict[str, Any]) -> None:
        with self._report_cv:
            self._tasks_on_hand.difference_update(report.get("finished", ()))
            self._tasks_on_hand.difference_update(
                f["task_id"] for f in report.get("failed", ())
            )
            self._report_queue.append(report)
            self._report_cv.notify()

    @staticmethod
    def _merge_reports(reports: List[Dict[str, Any]]) -> Dict[str, Any]:
        merged: Dict[str, Any] = {}
        for r in reports:
            for k, v in r.items():
                if isinstance(v, list):
                    merged.setdefault(k, []).extend(v)
                else:
                    merged[k] = v  # node_id fixed; "available" latest wins
        return merged

    def _reporter_loop(self) -> None:
        while True:
            with self._report_cv:
                while not self._report_queue and not self._shutdown:
                    self._report_cv.wait(timeout=0.5)
                if self._shutdown and not self._report_queue:
                    return
                batch = self._report_queue
                self._report_queue = []
            report = self._merge_reports(batch)
            try:
                # retry budget rides a head restart (seal/stream/finished
                # entries are at-least-once; dropping them stranded
                # consumers — a seal that never lands means a get() that
                # never resolves)
                self.head.call(
                    "ReportSeals",
                    report,
                    timeout=10.0,
                    retries=8,
                    retry_interval=0.25,
                    epoch=self._head_epoch,
                )
            except RpcStaleEpochError:
                if self._shutdown:
                    return
                # the head restarted under us: our stamp predates its
                # rebuilt tables. Re-register (adopting the new epoch and
                # re-advertising actors/inventory/leases), THEN redeliver
                # — the report lands fenced-fresh or not at all.
                logger.warning(
                    "head epoch advanced; re-registering before redelivery"
                )
                self._re_register()
                with self._report_cv:
                    self._report_queue.insert(0, report)
            except RpcNotLeaderError as exc:
                if self._shutdown:
                    return
                # the head we know is fenced/standby: walk the candidate
                # list (its hint first) to the current leader, register
                # there, then redeliver. The rejection is one fast RTT
                # (handler-level, no transport retries), so pace the
                # loop while nobody is leading yet — same cadence as
                # the unreachable path below.
                found = self._failover_head(exc.leader_hint)
                with self._report_cv:
                    self._report_queue.insert(0, report)
                if not found:
                    time.sleep(0.5)
            except RpcError:
                if self._shutdown:
                    return
                # still unreachable after the in-call budget: requeue at
                # the FRONT so merge order is preserved, and let the
                # report loop's orphan timeout decide when to give up
                logger.warning("head unreachable; requeueing report")
                with self._report_cv:
                    self._report_queue.insert(0, report)
                time.sleep(0.5)

    def _ship_metrics(self) -> None:
        """Metrics federation tick (report-loop cadence, interval-gated):
        sync the dark-plane accumulators into this process's registry,
        collect its typed deltas, and send them — plus any relayed
        worker deltas — to the head on the coalesced report channel."""
        now = time.monotonic()
        if now - self._metrics_last_ship < cfg.metrics_interval_s:
            return
        self._metrics_last_ship = now
        from ray_tpu_torch.util.metrics import sync_gauge

        from .event_loop import publish_dark_plane

        publish_dark_plane()
        try:
            st = self.store.stats()
            sync_gauge(
                "arena_used_bytes",
                float(st.get("used", 0)),
                "Shm arena bytes in use on this node.",
            )
            sync_gauge(
                "arena_capacity_bytes",
                float(st.get("capacity", 0)),
                "Shm arena capacity on this node.",
            )
        except Exception:  # noqa: BLE001 - store stats are optional
            pass
        records = self._metric_exporter.collect()
        with self._metric_lock:
            relays = self._worker_metric_relays
            self._worker_metric_relays = []
        entries: List[Dict[str, Any]] = []
        if records:
            entries.append(
                {
                    "node": self.node_id,
                    "role": "agent",
                    "records": records,
                }
            )
        entries.extend(relays)
        if entries:
            self._report_to_head(
                {"node_id": self.node_id, "metrics": entries}
            )

    def _re_register(self) -> None:
        """Resync with a restarted head: RegisterNode is fence-exempt by
        design, re-attaches this node's actors/store inventory/held
        leases, and its reply carries the NEW cluster epoch."""
        try:
            reply = self.head.call(
                "RegisterNode", self._node_info(), timeout=10.0
            )
            self._head_epoch = reply.get("epoch")
        except RpcNotLeaderError as exc:
            # registered against a fenced/standby head: follow the
            # leadership hint / candidate walk, then register there
            if self._failover_head(exc.leader_hint):
                try:
                    reply = self.head.call(
                        "RegisterNode", self._node_info(), timeout=10.0
                    )
                    self._head_epoch = reply.get("epoch")
                except (RpcError, RpcNotLeaderError):
                    pass  # next report tick retries the walk
        except RpcError:
            pass  # next report tick (or its stale rejection) retries

    def _failover_head(self, hint: str = "") -> bool:
        """Walk the head-candidate list (rpc.resolve_leader) and swap
        this agent's head channel to the current leader. Returns True
        when the channel moved (or already points at the leader)."""
        from .rpc import resolve_leader

        addr = resolve_leader(self.head_address, hint)
        if addr is None:
            return False
        if addr == self.head_address:
            return True
        logger.warning(
            "head leadership moved %s -> %s; re-pointing",
            self.head_address,
            addr,
        )
        old = self.head
        self.head_address = addr
        self.head = RpcClient(addr)
        try:
            old.close()
        except Exception:  # noqa: BLE001
            pass
        return True

    # a spawned worker gets this long to come up and register before its
    # reservation is reclaimed and the process killed (cold spawns pay a
    # full interpreter + import; generous beats flapping)
    SPAWN_REGISTER_TIMEOUT_S = 120.0

    # an orphaned agent (its head gone for good, e.g. a crashed test
    # driver) must not linger holding ports/arena/spill space forever; a
    # restarting head recovers in seconds, so a long grace is safe
    @property
    def ORPHAN_TIMEOUT_S(self) -> float:  # noqa: N802 - historical name
        from ray_tpu_torch.config import cfg

        return cfg.orphan_timeout_s

    def _report_loop(self) -> None:
        version = 0
        last_head_contact = time.monotonic()
        last_link_tick = time.monotonic()
        while not self._shutdown:
            time.sleep(REPORT_PERIOD_S)
            version += 1
            # peer-link upkeep at ~TTL/2 cadence (renewals piggyback on
            # the coalesced seal report; idle links return their lease)
            if (
                time.monotonic() - last_link_tick
                > cfg.peer_link_ttl_s / 2.0
            ):
                last_link_tick = time.monotonic()
                try:
                    self._link_maintenance()
                except Exception:  # noqa: BLE001 - upkeep must not kill beats
                    logger.exception("peer-link maintenance failed")
            # respawn workers that died outside a push (including ones that
            # crashed at startup before ever registering). A spawn that
            # never registers within the timeout counts as dead too — a
            # wedged startup (e.g. accelerator transport hang) would
            # otherwise hold its _spawns_pending reservation forever and
            # suppress backfill/prestart for the rest of the agent's life.
            if self._zygote is not None:
                self._zygote.drain_exits()
            with self._lock:
                now = time.monotonic()
                dead = [
                    h
                    for h in self._workers.values()
                    if h.proc.poll() is not None
                    or (
                        h.spawn_pending
                        and h.spawned_at
                        and now - h.spawned_at > self.SPAWN_REGISTER_TIMEOUT_S
                    )
                ]
            for h in dead:
                self._on_worker_death(h, [])
            if cfg.metrics_federation:
                try:
                    self._ship_metrics()
                except Exception:  # noqa: BLE001 - never skip a beat
                    logger.debug("metrics ship failed", exc_info=True)
            try:
                reply = self.head.call(
                    "NodeReport",
                    NodeReport(
                        node_id=self.node_id,
                        available=self.ledger.avail_map(),
                        version=version,
                    ),
                    timeout=5.0,
                    epoch=self._head_epoch,
                )
                last_head_contact = time.monotonic()
                self._draining = bool(reply.get("draining"))
                if not reply.get("alive", True):
                    # a transient heartbeat gap (or a head restart) got us
                    # declared dead/unknown — rejoin with our live actors.
                    logger.warning("head declared us dead; re-registering")
                    self._re_register()
            except RpcStaleEpochError:
                # fenced out by a rebuilt head: re-registration IS the
                # resync protocol (and refreshes the epoch stamp)
                last_head_contact = time.monotonic()  # the head is alive
                logger.warning("stale cluster epoch; re-registering")
                self._re_register()
            except RpcNotLeaderError as exc:
                # the head we report to fenced itself (a standby
                # promoted elsewhere): walk to the leader + re-register
                last_head_contact = time.monotonic()
                logger.warning("head is not the leader; failing over")
                if self._failover_head(exc.leader_hint):
                    self._re_register()
            except RpcError:
                if (
                    time.monotonic() - last_head_contact
                    > self.ORPHAN_TIMEOUT_S
                ):
                    logger.warning(
                        "head unreachable for %.0fs; agent exiting",
                        self.ORPHAN_TIMEOUT_S,
                    )
                    threading.Thread(target=self.shutdown, daemon=True).start()
                    return
                continue
            except Exception:  # noqa: BLE001
                # One bad reply (e.g. a head-side handler bug re-raised over
                # RPC) must never kill the heartbeat thread permanently —
                # that would get this node declared dead with no rejoin.
                logger.exception("node report failed; retrying next tick")
                continue

    # ------------------------------------------------------------------
    # actor + lifecycle control
    # ------------------------------------------------------------------
    def _drop_actor_state(self, actor_id: str) -> None:
        """Forget all per-actor state. Caller holds self._lock."""
        self._actor_workers.pop(actor_id, None)
        self._actor_meta.pop(actor_id, None)
        self._async_actors.discard(actor_id)
        self._async_buf.pop(actor_id, None)
        self._release(self._actor_allocs.pop(actor_id, None))

    # ------------------------------------------------------------------
    # memory-pressure monitor (src/ray/common/pressure_memory_monitor.h
    # analog): /proc/meminfo is the source of truth; the victim is the
    # newest-dispatched plain task's worker — killing the process trips
    # the normal worker-death path, which requeues its lease retryably.
    # ------------------------------------------------------------------
    @staticmethod
    def _memory_usage_fraction() -> Optional[float]:
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    parts = line.split()
                    if parts[0] in ("MemTotal:", "MemAvailable:"):
                        info[parts[0][:-1]] = int(parts[1])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", 0)
            if total <= 0:
                return None
            return 1.0 - avail / total
        except OSError:
            return None

    def _pick_oom_victim(self):
        """Newest-task-first victim policy (the reference protects older
        work); actor workers are exempt — killing one loses state."""
        victim = None
        newest = -1.0
        with self._lock:
            for handle in self._workers.values():
                if handle.actor_id is not None:
                    continue
                # dispatch threads mutate .running without our lock:
                # snapshot the values to dodge mid-iteration resizes
                started_vals = list(dict(handle.running).values())
                if not started_vals:
                    continue
                started = max(started_vals)
                if started > newest:
                    newest = started
                    victim = handle
        return victim

    def _memory_monitor_loop(self) -> None:
        from ray_tpu_torch.config import cfg

        while not self._shutdown:
            time.sleep(cfg.memory_monitor_interval_s)
            try:
                self._memory_monitor_tick()
            except Exception:  # noqa: BLE001 - the monitor must survive
                logger.exception("memory monitor tick failed")

    def _memory_monitor_tick(self) -> None:
        from ray_tpu_torch.config import cfg

        frac = self._memory_usage_fraction()
        if frac is None or frac < cfg.memory_usage_threshold:
            return
        victim = self._pick_oom_victim()
        if victim is None:
            logger.warning(
                "memory pressure %.0f%% but no plain task to kill",
                frac * 100,
            )
            return
        self.metrics_oom_kills += 1
        logger.warning(
            "memory pressure %.0f%% >= %.0f%%: OOM-killing worker %s "
            "(newest task first, %d in flight)",
            frac * 100,
            cfg.memory_usage_threshold * 100,
            victim.worker_id[:8],
            len(victim.running),
        )
        try:
            victim.proc.kill()
        except OSError:
            pass
        # the blocked PushTask RPC fails -> _on_worker_death requeues

    def _h_cancel_lease(self, req: dict) -> dict:
        """Drop a not-yet-running lease (task batch buffer or dependency
        wait); its resources release. Running tasks are not preempted
        (non-force reference semantics)."""
        lid = req["task_id"]
        with self._task_cv:
            for item in list(self._task_buf):
                spec, alloc = item
                if spec.task_id == lid:
                    self._task_buf.remove(item)
                    self._release(alloc)
                    return {"cancelled": True}
        # dep-waiting entries are guarded by _dep_cv everywhere else; the
        # wrong lock here would race _dep_loop's iteration
        with self._dep_cv:
            entry = self._dep_waiting.pop(lid, None)
        if entry is not None:
            return {"cancelled": True}
        if req.get("force"):
            # force: kill the worker running it (plain tasks only; the
            # worker-death path reports the failure and the head, having
            # sealed the cancel, drops it instead of retrying)
            with self._lock:
                victim = next(
                    (
                        hdl
                        for hdl in self._workers.values()
                        if hdl.actor_id is None and lid in hdl.running
                    ),
                    None,
                )
            if victim is not None:
                try:
                    victim.proc.kill()
                except OSError:
                    pass
                return {"cancelled": True}
        return {"cancelled": False}

    def _h_actor_worker_address(self, req: dict) -> dict:
        """Direct actor calls: resolve the worker process hosting an actor
        so a caller can push method batches to it without head round trips
        (the reference's direct actor task submission,
        core_worker/task_submission/actor_task_submitter.h)."""
        with self._lock:
            worker_id = self._actor_workers.get(req["actor_id"])
            handle = self._workers.get(worker_id) if worker_id else None
            if handle is None or handle.client is None:
                raise RuntimeError(
                    f"actor {req['actor_id']} has no live worker on this node"
                )
            return {
                "address": handle.client.address,
                "async_actor": req["actor_id"] in self._async_actors,
            }

    # ------------------------------------------------------------------
    # task leases (worker_lease grants): pin a worker to an owner so it
    # can stream same-shape tasks caller->worker with no head hop. The
    # reference's raylet does the same per-task worker lease
    # (local_lease_manager.h); here the lease is long-lived and
    # multiplexed, and the head schedules GRANTS, not tasks.
    # ------------------------------------------------------------------
    def _activate_task_lease(self, spec: LeaseRequest, alloc) -> None:
        """Resources are allocated; now pin an idle worker and report the
        lease (worker address + chip env) to the head, which relays it to
        the waiting owner."""
        handle = self._pop_idle_worker(timeout=10.0)
        if handle is None or self._shutdown:
            if handle is not None:
                self._return_worker(handle)
            self._release(alloc)
            self._report_to_head(
                {
                    "node_id": self.node_id,
                    "available": self.ledger.avail_map(),
                    "task_leases": [
                        {
                            "lease_id": spec.task_id,
                            "ok": False,
                            "reason": "no idle worker",
                        }
                    ],
                }
            )
            return
        with self._lock:
            handle.lease_id = spec.task_id
            self._task_leases[spec.task_id] = {
                "worker_id": handle.worker_id,
                "alloc": alloc,
                "owner": spec.client_id,
                "granted_at": time.monotonic(),
            }
            self._lease_stats["granted"] += 1
        # the lease pins its worker like an actor: backfill 1:1 so the
        # free pool never shrinks below num_workers (warming spawns count)
        with self._idle_cv:
            free = len(self._idle) + self._spawns_pending
        if free < self._num_workers and not self._shutdown:
            try:
                self._spawn_worker()
            except Exception:  # noqa: BLE001 - report loop backfills later
                logger.exception("lease backfill spawn failed")
        self._report_to_head(
            {
                "node_id": self.node_id,
                "available": self.ledger.avail_map(),
                "task_leases": [
                    {
                        "lease_id": spec.task_id,
                        "ok": True,
                        "node_id": self.node_id,
                        "worker_id": handle.worker_id,
                        "worker_address": handle.client.address,
                        "accel_env": self._alloc_env(alloc),
                    }
                ],
            }
        )

    def _h_return_worker_lease(self, req: dict) -> dict:
        """Release a task lease (owner returned it on queue drain / idle
        TTL, or the head revoked it): free the shape allocation, tell the
        worker to drain + drop lease state, and return it to the idle
        pool."""
        lease_id = req["lease_id"]
        with self._lock:
            entry = self._task_leases.pop(lease_id, None)
            handle = (
                self._workers.get(entry["worker_id"]) if entry else None
            )
            if entry is not None:
                self._lease_stats["returned"] += 1
        if entry is None:
            return {"ok": False}
        self._release(entry["alloc"])
        if handle is not None and handle.lease_id == lease_id:
            handle.lease_id = None
            if handle.client is not None:
                try:
                    handle.client.call(
                        "LeaseRelease", {"lease_id": lease_id}, timeout=10.0
                    )
                except RpcError:
                    pass  # dying worker: the death path respawns it
            self._return_worker(handle)
        return {"ok": True}

    def _forward_to_actor_worker(self, method: str, req: dict) -> Any:
        """Relay a compiled-DAG program RPC to the worker process pinned to
        the actor (the driver only knows the agent's address)."""
        with self._lock:
            worker_id = self._actor_workers.get(req["actor_id"])
            handle = self._workers.get(worker_id) if worker_id else None
        if handle is None or handle.client is None:
            raise RuntimeError(
                f"actor {req['actor_id']} has no live worker on this node"
            )
        return handle.client.call(method, req, timeout=60.0)

    def _h_kill_actor(self, req: dict) -> None:
        aid = req["actor_id"]
        with self._lock:
            worker_id = self._actor_workers.get(aid)
            handle = self._workers.get(worker_id) if worker_id else None
            self._drop_actor_state(aid)
            # clean actor exit → scrub + reuse the worker instead of a
            # kill/respawn cycle (worker_pool.cc idle-worker reuse).
            # Denied across runtime envs: pip/conda workers run a
            # different interpreter/sys.path, and a persisted plain env
            # marked the process (env_tainted) — both die instead.
            reusable = (
                handle is not None
                and cfg.actor_worker_reuse
                and not self._shutdown
                and handle.pip_key is None
                and not handle.env_tainted
                and handle.client is not None
                and handle.proc.poll() is None
            )
            if handle is not None and not reusable:
                self._workers.pop(worker_id, None)
        if handle is None:
            return
        if reusable:
            try:
                reply = handle.client.call(
                    "ScrubActor", {"actor_id": aid}, timeout=30.0
                )
            except RpcError:
                reply = None
            if reply is not None and reply.get("ok"):
                with self._idle_cv:
                    handle.actor_id = None
                    self.pool_stats["reused"] += 1
                self._return_worker(handle)
                return
            if reply is not None:
                logger.info(
                    "worker %s not reusable (%s); re-forking",
                    handle.worker_id[:8],
                    reply.get("reason", "scrub failed"),
                )
            with self._lock:
                # may race a concurrent death observation — pop decides
                if self._workers.pop(handle.worker_id, None) is None:
                    return
        try:
            handle.proc.kill()
        except OSError:
            pass
        self._close_worker_client(handle)
        if not self._shutdown:
            self._spawn_worker()

    def _h_serve_stats(self, req: dict) -> dict:
        with self._lock:
            self._serve_stats[int(req["pid"])] = {
                "deployment": req.get("deployment", ""),
                "stats": req.get("stats") or {},
                "ts": time.monotonic(),
            }
        return {"ok": True}

    def _serve_debug_block(self) -> dict:
        """Aggregate fresh replica reports (caller holds self._lock):
        per-replica engine stats plus the node-wide prefix-cache hit
        rate — the DebugState ``serve`` block."""
        now = time.monotonic()
        replicas = []
        hits = misses = 0
        for pid, entry in list(self._serve_stats.items()):
            if now - entry["ts"] > 30.0:
                del self._serve_stats[pid]
                continue
            stats = entry["stats"]
            pc = stats.get("prefix_cache") or {}
            hits += int(pc.get("hits") or 0)
            misses += int(pc.get("misses") or 0)
            replicas.append(
                {"pid": pid, "deployment": entry["deployment"], **stats}
            )
        total = hits + misses
        return {
            "replicas": replicas,
            "prefix_cache_hits": hits,
            "prefix_cache_misses": misses,
            "prefix_cache_hit_rate": (
                round(hits / total, 4) if total else None
            ),
        }

    def _h_debug_state(self, req=None) -> dict:
        """Operator/debugging introspection (node_manager DebugString
        analog, node_manager.cc HandleGetNodeStats)."""
        from .event_loop import hotpath_state

        hotpath = hotpath_state()
        with self._lock:
            hits = self.pool_stats["hits"]
            misses = self.pool_stats["misses"]
            total = hits + misses
            return {
                # execution-plane hot path (this agent process's view:
                # wire counters, ring fills of co-resident channels)
                "hotpath": hotpath,
                "task_buf": [s.task_id for s, _ in self._task_buf],
                "dep_waiting": {
                    t: sorted(m) for t, (s, m) in self._dep_waiting.items()
                },
                "async_pending": sorted(self._async_pending),
                "idle_workers": list(self._idle),
                "num_workers": len(self._workers),
                # warm-pool effectiveness, alongside idle_workers: hit
                # rate of the idle pool plus spawn/reuse/prestart counts
                "pool": {
                    **self.pool_stats,
                    "hit_rate": round(hits / total, 4) if total else None,
                    "prestart_inflight": self._prestart_inflight,
                    "zygote_alive": bool(
                        self._zygote is not None and not self._zygote.broken
                    ),
                    "zygote_pid": (
                        self._zygote.proc.pid
                        if self._zygote is not None
                        else None
                    ),
                    # process-wide spawn latency (shared across co-located
                    # agents in tests; authoritative on a real node)
                    "spawn_ms_fork": WORKER_SPAWN_MS.summary(
                        {"path": "fork"}
                    ),
                    "spawn_ms_spawn": WORKER_SPAWN_MS.summary(
                        {"path": "spawn"}
                    ),
                },
                # task-lease dispatch plane: active leases (who holds
                # which worker) + grant/return/loss lifecycle counts.
                # Per-task inflight lives owner-side by design (the whole
                # point is that the hot path never touches this agent).
                "dispatch": {
                    "task_leases": [
                        {
                            "lease_id": lid,
                            "worker_id": e["worker_id"],
                            "owner": e["owner"],
                            "age_s": round(
                                time.monotonic() - e["granted_at"], 1
                            ),
                        }
                        for lid, e in self._task_leases.items()
                    ],
                    **self._lease_stats,
                },
                "available": self.ledger.avail_map(),
                "store": self.store.stats(),
                # zero-copy data-plane health: arena fill, chunked pulls
                # in flight, and bytes moved per path (process-wide —
                # co-located agents in tests share the counters)
                "object_plane": self._object_plane_state(),
                # serving plane: co-located replica engine stats + the
                # node-wide prefix-cache hit rate
                "serve": self._serve_debug_block(),
                "oom_kills": self.metrics_oom_kills,
                # instrumented_io_context analog: every handler counted+timed
                "rpc_handlers": HANDLER_STATS.snapshot(),
            }

    @staticmethod
    def _fetch_gate_state() -> dict:
        from .transport import FETCH_GATE

        return FETCH_GATE.snapshot()

    @staticmethod
    def _device_plane_block() -> dict:
        from ray_tpu_torch.cluster import device_plane

        return device_plane.debug_block()

    def _object_plane_state(self) -> dict:
        from ray_tpu_torch.native.spill import SHM_EVICTIONS

        st = self.store.stats()
        cap = st.get("capacity") or 0
        return {
            "arena_fill_pct": (
                round(100.0 * st.get("used", 0) / cap, 2) if cap else None
            ),
            "chunked_pulls_inflight": int(CHUNKED_PULLS_INFLIGHT.value()),
            "transfer_bytes": {
                path: int(OBJECT_TRANSFER_BYTES.value({"path": path}))
                for path in (
                    "shm",
                    "shm_copy",
                    "inline",
                    "rpc",
                    "socket",
                    "device",
                )
            },
            "transfer_chunk_ms": TRANSFER_CHUNK_MS.summary(),
            "transfer_stripe_ms": TRANSFER_STRIPE_MS.summary(),
            "shm_evictions": int(SHM_EVICTIONS.value()),
            "spilled_objects": st.get("spilled_objects", 0),
            # deleted-with-outstanding-pins entries still holding arena
            # space; nonzero after every reader released (or died and had
            # its pin log replayed) is a leak — the chaos soak asserts 0
            "arena_zombies": self.store.zombie_count(),
            # device-direct data plane: seal/land counters + whether the
            # plane is active in THIS process (workers land device-side;
            # the agent itself only ever stages host frames)
            "device": self._device_plane_block(),
            # cross-node data plane: this node's stripe server + its
            # cached peer links and the grant/reuse/revoke lifecycle
            # (process-wide counters, like every metric here)
            "net": {
                "enabled": bool(cfg.native_net),
                "endpoint": (
                    self._data_server.endpoint
                    if self._data_server is not None
                    else None
                ),
                "server": (
                    dict(self._data_server.stats)
                    if self._data_server is not None
                    else None
                ),
                "links": self._links.snapshot(),
                "peer_conn": {
                    "granted": int(PEER_CONN_GRANTED.value()),
                    "revoked": int(PEER_CONN_REVOKED.value()),
                    "reused": int(PEER_CONN_REUSED.value()),
                },
                # cross-fetch in-flight byte gate (shuffle reduce-side
                # arena backpressure): waits > 0 means concurrent pulls
                # actually queued behind the budget
                "fetch_gate": self._fetch_gate_state(),
            },
        }

    def _h_chaos_kill_zygote(self, req=None) -> dict:
        """Chaos fault: SIGKILL this node's fork-server. The next fork
        attempt marks the client broken and `_zygote_for_fork` restarts
        it (bounded); past the restart budget the agent cold-spawns
        forever — either way worker spawns keep succeeding, which is the
        invariant the chaos soak asserts."""
        z = self._zygote
        if z is None:
            return {"killed": False, "reason": "no zygote (cold-spawn mode)"}
        try:
            pid = z.proc.pid
            z.proc.kill()
        except OSError as exc:
            return {"killed": False, "reason": repr(exc)}
        return {"killed": True, "pid": pid}

    def _h_shutdown(self, req=None) -> None:
        threading.Thread(target=self.shutdown, daemon=True).start()

    def shutdown(self) -> None:
        self._shutdown = True
        with self._idle_cv:
            self._idle_cv.notify_all()
        with self._report_cv:
            self._report_cv.notify_all()
        with self._task_cv:
            self._task_cv.notify_all()
        with self._dep_cv:
            self._dep_cv.notify_all()
        for handle in list(self._workers.values()):
            try:
                handle.proc.terminate()
            except OSError:
                pass
        if self._zygote is not None:
            self._zygote.close()
        self._exec_pool.shutdown(wait=False, cancel_futures=True)
        # data plane down before the store: a mid-teardown stripe serve
        # must not race the arena unlink (teardown exactly-once — both
        # closes are idempotent)
        if self._data_server is not None:
            self._data_server.close()
        self._links.close()
        try:
            self.store.close(unlink=True)
        except Exception:  # noqa: BLE001
            pass
        self._server.stop()


def main() -> None:  # pragma: no cover - exercised via subprocess in tests
    import argparse
    import json

    parser = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    parser.add_argument("--head", required=True)
    parser.add_argument("--resources", default='{"CPU": 4}')
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--num-workers", type=int, default=None)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--store-capacity", type=int, default=1 << 28)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    # the first zygote forks off now, while this process has one thread:
    # it inherits the package and torch already imported
    preforked = prefork() if cfg.fork_server else None
    agent = NodeAgent(
        head_address=args.head,
        resources=json.loads(args.resources),
        labels=json.loads(args.labels),
        num_workers=args.num_workers,
        store_capacity=args.store_capacity,
        node_id=args.node_id,
        preforked=preforked,
    )
    print(f"ray_tpu_torch agent {agent.node_id} listening on {agent.address}", flush=True)
    try:
        while not agent._shutdown:
            time.sleep(0.5)
    except KeyboardInterrupt:
        agent.shutdown()


if __name__ == "__main__":
    main()
