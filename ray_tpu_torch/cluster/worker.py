"""Worker process: executes leases pushed by its node agent.

The analog of the reference's worker process embedding a CoreWorker
(Ray's src/ray/core_worker/): receives ``PushTask`` RPCs
(task_execution/task_receiver.h:43), resolves ObjectRef arguments
(DependencyResolver), runs user code, and seals results — small values
inline (max_direct_call_object_size, ray_config_def.h:218), large ones
into the node's shared-memory arena (plasma Put). Actor instances live
in-process for the worker's lifetime; pushes are serialized per worker,
giving actor-method ordering.

Kept import-light: torch and the rest of ray_tpu_torch load lazily (user
code triggers them), so a pool of workers forks in well under a second.

Port of ``ray_tpu/cluster/worker.py``, copied with its imports rewritten.
The reference's jax platform pin at startup is gone: torch has nothing
to pin, and a worker touches CUDA only inside a task body (never before
the zygote's fork).
"""
from __future__ import annotations

import argparse
import importlib
import logging
import os
import pickle
import sys
import threading
import time
import traceback
from collections import deque

_STREAM_END = object()  # generator-exhausted sentinel (values can be None)
from typing import Any, Dict, List, Optional

import cloudpickle

from . import serialization as wire
from .common import (
    DISPATCH_OVERHEAD_US,
    INLINE_OBJECT_MAX,
    SealInfo,
    dispatch_sampled,
)
from .object_plane import OBJECT_TRANSFER_BYTES, SHM_HITS, SHM_MISSES
from .rpc import RpcClient, RpcError, RpcServer

logger = logging.getLogger("ray_tpu_torch.cluster.worker")


async def _invoke_maybe_async(instance, method: str, args, kwargs, sems,
                              trace=None):
    """Run one actor method on the actor's event loop; awaits coroutine
    methods, runs sync methods inline (briefly blocking the loop — the
    reference's asyncio-actor semantics for def methods). ``sems`` maps
    concurrency-group name -> asyncio.Semaphore bounding in-flight starts.
    ``trace`` is installed around the call so nested submissions from the
    method inherit the caller's trace id (the coroutine runs in its own
    contextvars context, so per-task installation is race-free)."""
    import inspect

    fn = getattr(instance, method)
    opts = getattr(fn, "_ray_tpu_method_options", None) or {}
    group = opts.get("concurrency_group", "_default")
    sem = sems.get(group) or sems["_default"]
    async with sem:
        token = None
        if trace is not None:
            from ray_tpu_torch.util import tracing

            token = tracing.install(trace)
        try:
            out = fn(*args, **kwargs)
            from ray_tpu_torch.core.object_store import should_await

            if should_await(out):
                out = await out
            return out
        finally:
            if token is not None:
                from ray_tpu_torch.util import tracing

                tracing.uninstall(token)


def _flush_nested_deferred(ids) -> None:
    """A result carrying refs to objects OWNED by this process's nested
    client runtime (direct-call returns it received and never shared) must
    upload them to the head before the result leaves — the consumer may be
    on any node and resolves contained refs through the directory."""
    if not ids:
        return
    from ray_tpu_torch.core import runtime as core_runtime

    flush = getattr(core_runtime._runtime, "_flush_deferred_seals", None)
    if flush is not None:
        try:
            flush(ids)
        except Exception:  # noqa: BLE001 - best-effort
            logger.warning("nested deferred-seal flush failed", exc_info=True)


# the live Worker of this process (None in drivers/agents): node-local
# services that ride the worker's open arena handle — e.g. the serving
# plane's shared prefix cache — discover it here instead of re-mapping
# the arena per consumer
_CURRENT_WORKER: Optional["Worker"] = None


class Worker:
    def __init__(self, agent_address: str, worker_id: str, store_path: str):
        global _CURRENT_WORKER
        _CURRENT_WORKER = self
        self.worker_id = worker_id
        self.agent = RpcClient(agent_address)
        self.node_id = os.environ.get("RAY_TPU_NODE_ID", "")
        # distributed refcounting: this process reports releases through its
        # agent (which forwards to the head); the worker id is the holder id,
        # shared with any nested client runtime user code creates.
        from ray_tpu_torch.core import refcount

        refcount.set_holder_id(worker_id)
        self._flusher = refcount.RefFlusher(
            lambda inc, dec: self.agent.call(
                "RefUpdate",
                {"holder": worker_id, "increfs": inc, "decrefs": dec},
                timeout=10.0,
            ),
            holder=worker_id,
        )
        refcount.install_consumer(self._flusher)
        # one deserialized fn per fn_id (see _fn_from_blob)
        self._fn_cache: Dict[str, Any] = {}
        self._fn_cache_order: deque = deque()
        self._fn_load_lock = threading.RLock()
        # streaming-generator announcements, flushed with direct seals
        self._stream_reports: list = []
        self._stream_done_reports: list = []
        self.store = None
        if store_path:
            try:
                from ray_tpu_torch.native import NativeObjectStore

                self.store = NativeObjectStore(path=store_path, create=False)
                # crash-durable view-pin sidecar: if this worker is
                # SIGKILLed with zero-copy views outstanding, the agent
                # replays the log and releases the pins (zombie-pin
                # reclamation) instead of leaking arena space until the
                # next arena restart
                self.store.enable_pin_tracking()
            except Exception:  # noqa: BLE001
                logger.warning("worker could not open shm store %s", store_path)
        self._actors: Dict[str, Any] = {}
        self._actor_loops: Dict[str, Any] = {}  # actor_id -> (loop, sems)
        self._trace_tokens = threading.local()  # per-thread trace token
        # runtime-env gate: tasks sharing ONE env signature run
        # concurrently (refcounted application); a DIFFERENT env waits for
        # the current one to drain. Env-less tasks skip the gate entirely
        # — they can observe a concurrently-applied env (process-level
        # isolation needs a dedicated worker, which actors get; the
        # reference isolates via per-env worker processes the same way).
        self._env_cv = threading.Condition()
        self._env_sig: Optional[str] = None
        self._env_active = 0
        self._env_undo = lambda: None
        from concurrent.futures import ThreadPoolExecutor

        # seals + TaskDone callbacks for finished async-actor methods run
        # here, off the event loop (put_value can RPC to the agent)
        self._done_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="task-done"
        )
        # completion coalescer: everything finished while the previous
        # TaskDoneBatch RPC was in flight merges into one message
        self._done_q: deque = deque()
        self._done_cv = threading.Condition()
        threading.Thread(
            target=self._done_sender_loop, name="task-done-send", daemon=True
        ).start()
        # batched pushes execute CONCURRENTLY: two granted leases must both
        # make progress even if they block on each other (e.g. collective
        # rendezvous between tasks) — sequential batch execution would
        # deadlock them.
        self._batch_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="task-batch"
        )
        # asyncio loops being torn down by KillActor: batch task creation
        # must not slip new tasks past drain_and_stop's cancellation sweep
        self._stopping_loops: set = set()
        # compiled-DAG programs resident in this worker:
        # dag_id -> {"stop": Event, "threads": [...], "channels": [...]}
        self._dag_programs: Dict[str, dict] = {}
        # AOT-compiled pipeline stage programs (dag/pipeline.py):
        # pipe_id -> {"stop": Event, "threads": [(thread, channels)]}
        self._pipelines: Dict[str, dict] = {}
        # per-actor lock mediating DAG stage threads vs normal pushed
        # methods on the same instance (created when a DAG binds the actor)
        self._dag_actor_locks: Dict[str, threading.Lock] = {}
        # direct actor calls (actor_task_submitter analog): per-actor FIFO
        # executor threads for sync actors, result push-back to callers,
        # and seal reports to the agent for the head's object directory
        self._direct_fifo: Dict[str, deque] = {}
        self._direct_fifo_cv = threading.Condition()
        self._direct_fifo_threads: Dict[str, threading.Thread] = {}
        self._direct_out: Dict[str, list] = {}  # client_addr -> results
        self._direct_out_cv = threading.Condition()
        self._direct_clients: Dict[str, RpcClient] = {}
        self._direct_seals: list = []  # SealInfo batch for the agent
        self._direct_seal_cv = threading.Condition()
        # metrics federation: this worker's registry ships as
        # typed deltas on the seal channel (the agent relays them on its
        # next head report); created lazily on the first due tick so an
        # idle worker stays import-light
        self._metric_exporter = None
        self._metrics_last_ship = time.monotonic()
        threading.Thread(
            target=self._direct_sender_loop,
            name="direct-result-send",
            daemon=True,
        ).start()
        threading.Thread(
            target=self._direct_seal_loop,
            name="direct-seal-send",
            daemon=True,
        ).start()
        # leased-task execution (task leases: owner streams same-shape
        # tasks straight to this pinned worker): per-lease FIFO queue +
        # executor thread — ONE task runs at a time against the lease's
        # single resource allocation (multiplexing is pipelining depth,
        # not parallelism); results/seals ride the direct-call machinery
        self._lease_q: Dict[str, deque] = {}  # lease_id -> queued items
        self._lease_state: Dict[str, dict] = {}  # lease_id -> {released,undo}
        # released-lease tombstones: a stale owner batch arriving after
        # the FIFO drained must see "released" (and spill to the head),
        # never resurrect the lease on a worker already back in the pool
        self._lease_tombstones: set = set()
        self._lease_tombstone_order: deque = deque()
        self._lease_running: Dict[str, str] = {}  # lease_id -> ref executing
        self._lease_cv = threading.Condition()
        self._server = RpcServer(
            {
                "PushTask": self._h_push_task,
                "PushTaskBatch": self._h_push_task_batch,
                "KillActor": self._h_kill_actor,
                "ScrubActor": self._h_scrub_actor,
                "DagInstall": self._h_dag_install,
                "DagTeardown": self._h_dag_teardown,
                "PipelineInstall": self._h_pipeline_install,
                "PipelineTeardown": self._h_pipeline_teardown,
                "DirectPushBatch": self._h_direct_push_batch,
                "LeaseTaskBatch": self._h_lease_task_batch,
                "LeaseRecall": self._h_lease_recall,
                "LeaseRelease": self._h_lease_release,
                "LeaseKillRunning": self._h_lease_kill_running,
                "Ping": lambda r: "pong",
            },
            port=0,
            max_workers=8,
        )
        # pristine-state baseline for actor-worker reuse (ScrubActor):
        # everything user code adds past this point is what a scrub must
        # be able to undo — or the scrub is refused and the worker dies
        self._baseline_modules = frozenset(sys.modules)
        self._baseline_env = dict(os.environ)
        self._baseline_sys_path = list(sys.path)
        # strong refs to the Thread OBJECTS (idents recycle after a
        # thread exits; an object identity can't while we hold it)
        self._baseline_threads = frozenset(threading.enumerate())
        try:
            self._baseline_cwd = os.getcwd()
        except OSError:
            self._baseline_cwd = None
        self.agent.call(
            "RegisterWorker",
            {"worker_id": worker_id, "address": self._server.address},
            retries=20,
            retry_interval=0.1,
        )

    # ------------------------------------------------------------------
    # object plane helpers
    # ------------------------------------------------------------------
    def _loads_tracking(self, data: bytes) -> Any:
        from ray_tpu_torch.core.refcount import loads_tracking

        return loads_tracking(self._flusher, data)

    def _read_local(self, hex_id: str) -> Any:
        """Same-node read: a zero-copy READ-ONLY view mapped over the
        shared arena page (numpy payloads reconstruct as views — no
        bytes ever cross a socket). cfg.worker_shm_reads=0 falls back to
        the copying read for debugging / A-B perf comparison."""
        from ray_tpu_torch.config import cfg

        if cfg.worker_shm_reads:
            view = self.store.get_view(hex_id)
            OBJECT_TRANSFER_BYTES.inc(view.nbytes, labels={"path": "shm"})
            return self._loads_tracking(view)
        # distinct label so the A/B the flag exists for stays readable:
        # these bytes came from the arena but paid the copy
        data = self.store.get_bytes(hex_id)
        OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "shm_copy"})
        return self._loads_tracking(data)

    def get_object(
        self,
        hex_id: str,
        timeout: Optional[float] = None,
        purpose: str = "task_args",
    ) -> Any:
        if self.store is not None:
            try:
                value = self._read_local(hex_id)
                SHM_HITS.inc()
                return value
            except (KeyError, BlockingIOError):
                SHM_MISSES.inc()
        reply = self.agent.call(
            "GetObjectForWorker",
            {"object_id": hex_id, "timeout": timeout, "purpose": purpose},
            timeout=None,
        )
        status = reply["status"]
        if status == "local":
            if self.store is not None:
                try:
                    # no SHM_HITS here: this logical read already counted
                    # as a miss above (the agent restored/located it) —
                    # counting a hit too would skew the hit rate
                    return self._read_local(hex_id)
                except (KeyError, BlockingIOError):
                    pass  # spilled/evicted between reply and read: fall back
            # our shm read failed but the agent can serve the bytes
            data = self.agent.call(
                "FetchObject", {"object_id": hex_id}, timeout=120.0
            )
            OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "rpc"})
            return self._loads_tracking(data)
        if status == "inline":
            OBJECT_TRANSFER_BYTES.inc(
                len(reply["data"]), labels={"path": "inline"}
            )
            return self._loads_tracking(reply["data"])
        if status == "error":
            raise pickle.loads(reply["error"])
        raise TimeoutError(f"timed out fetching object {hex_id}")

    def put_value(self, object_id: str, value: Any) -> SealInfo:
        from ray_tpu_torch.core.refcount import collect_serialized

        # pickle-5 out-of-band: numpy buffers stay separate frames — a
        # large block is ONE gather-copy into the shared arena, never a
        # monolithic pickle byte string re-copied per hop
        with collect_serialized() as contained:
            parts, total = wire.dumps_parts(value)
        contained_ids = sorted(contained)
        _flush_nested_deferred(contained_ids)
        if total <= INLINE_OBJECT_MAX:
            data = wire.join_parts(parts)
            OBJECT_TRANSFER_BYTES.inc(len(data), labels={"path": "inline"})
            return SealInfo(
                object_id=object_id,
                node_id=self.node_id,
                size=len(data),
                inline_value=data,
                contained_ids=contained_ids,
            )
        stored = False
        if self.store is not None:
            try:
                self.store.put_frames(object_id, parts)
                OBJECT_TRANSFER_BYTES.inc(total, labels={"path": "shm"})
                stored = True
            except Exception:  # noqa: BLE001 - arena full
                pass
        if not stored:
            self.agent.call(
                "WorkerPut",
                {"object_id": object_id, "data": wire.join_parts(parts)},
                timeout=60.0,
            )
            OBJECT_TRANSFER_BYTES.inc(total, labels={"path": "rpc"})
        return SealInfo(
            object_id=object_id,
            node_id=self.node_id,
            size=total,
            contained_ids=contained_ids,
        )

    # ------------------------------------------------------------------
    # runtime envs (the per-lease slice of _private/runtime_env/).
    # Isolation contract: a PLAIN task's env is applied for exactly its
    # execution and then undone (env_vars restored, injected sys.path
    # entries removed), and tasks carrying a runtime_env serialize on one
    # lock so two different envs can never interleave on a shared worker.
    # An ACTOR CREATION keeps its env for the worker's life (the actor
    # owns the process, same as its chip assignment). Modules already
    # imported from a working_dir stay imported — process-level isolation
    # needs a dedicated worker, which actors get by construction.
    # ------------------------------------------------------------------
    def _env_enter(self, env: dict) -> None:
        """Join the env gate: same-signature tasks share one application
        (refcounted — co-scheduled tasks of one job, e.g. collective
        rendezvous peers, run CONCURRENTLY); a different signature waits
        for the current one to drain, so two envs never interleave."""
        import json

        sig = json.dumps(env, sort_keys=True, default=str)
        with self._env_cv:
            while self._env_active > 0 and self._env_sig != sig:
                self._env_cv.wait(timeout=1.0)
            if self._env_active == 0:
                self._env_sig = sig
                self._env_undo = self._apply_runtime_env(env)
            self._env_active += 1

    def _env_exit(self, persist: bool = False) -> None:
        with self._env_cv:
            self._env_active -= 1
            if self._env_active == 0:
                if not persist:
                    self._env_undo()
                # an actor owns its worker: a persisted env's undo is
                # simply discarded
                self._env_undo = lambda: None
                self._env_sig = None
            self._env_cv.notify_all()

    def _apply_runtime_env(self, env: Optional[dict]):
        """Apply ``env``; returns an undo() closure (no-op when env is
        empty). Called under the env gate (_env_enter)."""
        if not env:
            return lambda: None
        prev_vars: Dict[str, Optional[str]] = {}
        for k, v in (env.get("env_vars") or {}).items():
            prev_vars[k] = os.environ.get(k)
            os.environ[k] = str(v)
        added_paths: List[str] = []
        for key in [env.get("working_dir"), *(env.get("py_modules") or [])]:
            if key and key not in sys.path:
                sys.path.insert(0, key)
                added_paths.append(key)
        if added_paths:
            importlib.invalidate_caches()

        def undo() -> None:
            for k, old in prev_vars.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            for p in added_paths:
                try:
                    sys.path.remove(p)
                except ValueError:
                    pass
            if added_paths:
                importlib.invalidate_caches()

        return undo

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _run_streaming_task(self, req: dict, fn, args, kwargs) -> None:
        """Drive a ``num_returns="streaming"`` task (_raylet.pyx:246
        streaming-generator execution analog): each yield seals under
        stream_item_id(task_id, i) and is announced to the head through
        the async seal path; the executor pauses once it is
        cfg.streaming_window items ahead of the consumer's watermark
        (generator backpressure). ANY user-code exception — in the call
        itself or mid-iteration — seals an error item so the consumer's
        next ref raises, then ends the stream."""
        from ray_tpu_torch.cluster.common import stream_item_id
        from ray_tpu_torch.config import cfg

        window = max(1, int(cfg.streaming_window))
        tid = req["task_id"]
        idx = 0
        try:
            gen = fn(*args, **kwargs)
            if not hasattr(gen, "__next__"):
                gen = iter(gen)
        except BaseException as exc:  # noqa: BLE001 - errors are values
            self._end_stream(req, 0, exc)
            return
        consumed = 0
        while True:
            try:
                value = next(gen, _STREAM_END)
            except BaseException as exc:  # noqa: BLE001 - errors are values
                self._end_stream(req, idx, exc)
                return
            if value is _STREAM_END:
                self._end_stream(req, idx, None)
                return
            while idx - consumed >= window:
                try:
                    reply = self.agent.call(
                        "StreamConsumed",
                        {
                            "task_id": tid,
                            "after_consumed": consumed,
                            "timeout": 5.0,
                        },
                        timeout=20.0,
                    )
                except RpcError:
                    time.sleep(0.5)
                    continue
                consumed = reply["consumed"]
                if reply.get("abandoned"):
                    # consumer dropped the generator: stop producing
                    try:
                        gen.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._end_stream(req, idx, None)
                    return
            oid = stream_item_id(tid, idx)
            seal = self.put_value(oid, value)
            with self._direct_seal_cv:
                self._direct_seals.append(seal)
                self._stream_reports.append(
                    {"task_id": tid, "index": idx, "object_id": oid}
                )
                self._direct_seal_cv.notify()
            idx += 1

    def _end_stream(self, req: dict, count: int, exc) -> None:
        done: dict = {"task_id": req["task_id"], "count": count}
        if exc is not None:
            from ray_tpu_torch.core.object_store import TaskError

            tb = traceback.format_exc()
            err = TaskError(exc, req["name"], traceback_str=tb)
            err.__cause__ = exc
            try:
                done["error"] = cloudpickle.dumps(err)
            except Exception:  # noqa: BLE001 - unpicklable exception
                done["error"] = cloudpickle.dumps(
                    TaskError(
                        RuntimeError(repr(exc)),
                        req["name"],
                        traceback_str=tb,
                    )
                )
        with self._direct_seal_cv:
            self._stream_done_reports.append(done)
            self._direct_seal_cv.notify()

    def _fn_from_blob(self, fn_id: str, blob: bytes, cacheable) -> Any:
        """Deserialize a task function once per (worker, fn_id).

        Repeated submissions of the same function ship the same blob
        (client pickles once, _serialize_fn); unpickling it per execution
        was the executor-side half of that cost. Not cached when the
        client marked it uncacheable (closure over ObjectRefs: per-call
        deserialization keeps ref lifetimes per-execution). Small LRU —
        eviction drops the fn and any refs it holds.

        One blob loads at a time: a load imports the function's modules,
        and two threads importing a package and its submodule from either
        end raise ``_DeadlockError`` in one of them (the reference's
        worker loads concurrently; seen as a failed shuffle task).
        """
        if not cacheable or not fn_id:
            with self._fn_load_lock:
                return cloudpickle.loads(blob)
        cache = self._fn_cache
        fn = cache.get(fn_id)
        if fn is None:
            with self._fn_load_lock:
                fn = cloudpickle.loads(blob)
            cache[fn_id] = fn
            self._fn_cache_order.append(fn_id)
            if len(self._fn_cache_order) > 64:
                cache.pop(self._fn_cache_order.popleft(), None)
        return fn

    def _resolve(self, args: tuple, kwargs: dict):
        from ray_tpu_torch.core.object_store import ObjectRef

        def rv(x):
            return self.get_object(x.hex) if isinstance(x, ObjectRef) else x

        return tuple(rv(a) for a in args), {k: rv(v) for k, v in kwargs.items()}

    def _h_push_task(self, req: dict) -> dict:
        kind = req["kind"]
        self._set_context(req)
        accel_env = req.get("accel_env")
        prev_env: Dict[str, Optional[str]] = {}
        persist_env = False
        creation_ok = False
        runtime_env = req.get("runtime_env")
        if runtime_env:
            self._env_enter(runtime_env)
        try:
            if accel_env:
                # the granted lease's chip assignment: TPU_VISIBLE_CHIPS /
                # CUDA_VISIBLE_DEVICES (accelerators/tpu.py:38-56 analog).
                # A SUCCESSFUL actor creation keeps it for the pinned
                # worker's lifetime — the actor owns those chips. Every
                # other case (plain tasks, failed creations, methods with
                # their own demand) restores the prior values so a reused
                # worker — or the actor's own lifetime pin — is not
                # clobbered.
                prev_env = {k: os.environ.get(k) for k in accel_env}
                os.environ.update(accel_env)
            if kind == "actor_creation":
                cls, args, kwargs = wire.loads(req["payload"])
                args, kwargs = self._resolve(args, kwargs)
                from ray_tpu_torch.core.actor import _coroutine_method_names

                aid = req["actor_id"]
                if _coroutine_method_names(cls):
                    # asyncio actor: one event loop owns all its methods
                    from ray_tpu_torch.core.actor import (
                        DEFAULT_MAX_CONCURRENCY_ASYNC,
                    )

                    meta = req.get("actor_meta") or {}
                    mc = meta.get("max_concurrency")
                    # unset → asyncio default 1000; an explicit 1 serializes
                    mc = (
                        DEFAULT_MAX_CONCURRENCY_ASYNC
                        if mc is None
                        else max(1, int(mc))
                    )
                    groups = {"_default": mc}
                    groups.update(meta.get("concurrency_groups") or {})
                    self._actor_loops[aid] = self._start_actor_loop(aid, groups)
                self._actors[aid] = cls(*args, **kwargs)
                persist_env = bool(accel_env)  # actor now owns these chips
                creation_ok = True
                result_values: List[Any] = []
            elif kind == "actor_method":
                method, args, kwargs = wire.loads(req["payload"])
                args, kwargs = self._resolve(args, kwargs)
                aid = req["actor_id"]
                instance = self._actors[aid]
                entry = self._actor_loops.get(aid)
                if entry is not None and req.get("streaming"):
                    # async actors reply per-call through their event
                    # loop; the per-item stream plumbing is sync-only
                    self._end_stream(
                        req,
                        0,
                        TypeError(
                            "num_returns='streaming' is not supported on "
                            "async actors; use a sync actor or a task"
                        ),
                    )
                    result_values = []
                elif entry is not None:
                    # asyncio actor: schedule on the actor's loop and reply
                    # "async_pending" NOW — the outcome goes back to the
                    # agent via TaskDone when the coroutine finishes. No
                    # thread is held per in-flight method, so thousands can
                    # park on awaits (reference asyncio-actor semantics).
                    import asyncio

                    loop, sems = entry
                    fut = asyncio.run_coroutine_threadsafe(
                        _invoke_maybe_async(
                            instance, method, args, kwargs, sems,
                            trace=req.get("trace"),
                        ),
                        loop,
                    )
                    fut.add_done_callback(
                        lambda f, r=req: self._done_pool.submit(
                            self._finish_async_task, r, f
                        )
                    )
                    return {"status": "async_pending"}
                if req.get("streaming"):
                    # sync actors only (an async actor's loop replies
                    # async_pending above and never reaches here with
                    # streaming — guarded by the lease route)
                    self._run_streaming_task(
                        req, getattr(instance, method), args, kwargs
                    )
                    result_values = []
                else:
                    dag_lock = self._dag_actor_locks.get(aid)
                    if dag_lock is not None:
                        with dag_lock:
                            out = getattr(instance, method)(*args, **kwargs)
                    else:
                        out = getattr(instance, method)(*args, **kwargs)
                    result_values = self._split(out, req["return_ids"])
            else:
                fn_blob = req.get("fn_blob")
                if fn_blob is not None:
                    fn = self._fn_from_blob(
                        req.get("fn_id", ""), fn_blob, req.get("fn_cache")
                    )
                    args, kwargs = wire.loads(req["payload"])
                else:
                    fn, args, kwargs = wire.loads(req["payload"])
                args, kwargs = self._resolve(args, kwargs)
                if req.get("streaming"):
                    # owns ALL user-code exceptions (sealed as the final
                    # stream item) — a raise here would end the lease
                    # without a stream-done marker and hang the consumer
                    self._run_streaming_task(req, fn, args, kwargs)
                    result_values = []
                else:
                    out = fn(*args, **kwargs)
                    result_values = self._split(out, req["return_ids"])
        except BaseException as exc:  # noqa: BLE001 - errors are values
            return self._error_reply(req, exc)
        finally:
            if accel_env and not persist_env:
                for k, old in prev_env.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
            if runtime_env:
                self._env_exit(persist=creation_ok)
            self._clear_context()
        try:
            # sealing can fail too (store full + agent fallback unreachable):
            # that MUST become an error reply, not an exception escaping the
            # RPC handler — the agent would leak the lease's resources
            seals = [
                self.put_value(oid, v)
                for oid, v in zip(req["return_ids"], result_values)
            ]
            reply = {"status": "ok", "seals": seals}
            borrows = self._compute_borrows(req.get("arg_ids"))
            if borrows:
                reply["borrows"] = borrows
        except BaseException as exc:  # noqa: BLE001
            return self._error_reply(req, exc)
        if kind == "actor_creation" and req["actor_id"] in self._actor_loops:
            # tells the agent to skip per-actor FIFO serialization
            reply["async_actor"] = True
        return reply

    def _h_push_task_batch(self, reqs: List[dict]) -> List[dict]:
        if len(reqs) == 1:
            return [self._h_push_task(reqs[0])]
        futs = [self._batch_pool.submit(self._h_push_task, r) for r in reqs]
        return [f.result() for f in futs]

    def _compute_borrows(self, arg_ids) -> List[str]:
        """Arg refs this process still holds at task completion (stored in
        actor state or a live closure): reported in the completion reply so
        the head converts the lease's arg pin into a holder count before
        releasing it (borrower registration, reference_counter.h borrows)."""
        from ray_tpu_torch.core.refcount import TRACKER

        borrowed = [
            h
            for h in arg_ids or ()
            if TRACKER.count(h) > 0 and not self._flusher.is_registered(h)
        ]
        if borrowed:
            self._flusher.note_registered(borrowed)
        return borrowed

    def _start_actor_loop(self, actor_id: str, groups: Dict[str, int]):
        """Returns (loop, {group: semaphore}); semaphores bind to the loop."""
        import asyncio

        loop = asyncio.new_event_loop()
        ready = threading.Event()
        sems: Dict[str, Any] = {}

        def run() -> None:
            asyncio.set_event_loop(loop)
            for g, limit in groups.items():
                sems[g] = asyncio.Semaphore(max(1, int(limit)))
            ready.set()
            loop.run_forever()

        threading.Thread(
            target=run, name=f"actor-loop-{actor_id[:6]}", daemon=True
        ).start()
        ready.wait()
        return loop, sems

    def _error_reply(self, req: dict, exc: BaseException) -> dict:
        """Build the failure reply: errors are values (sealed TaskError)."""
        if req.get("retry_exceptions"):
            return {"status": "retry", "error_repr": repr(exc)}
        tb = traceback.format_exc()
        logger.debug("task %s failed:\n%s", req["name"], tb)
        from ray_tpu_torch.core.object_store import TaskError

        err = TaskError(exc, req["name"], traceback_str=tb)
        err.__cause__ = exc
        try:
            blob = cloudpickle.dumps(err)
        except Exception:  # noqa: BLE001 - unpicklable exception
            blob = cloudpickle.dumps(
                TaskError(RuntimeError(repr(exc)), req["name"], traceback_str=tb)
            )
        seals = [
            SealInfo(
                object_id=oid,
                node_id=self.node_id,
                is_error=True,
                error=blob,
            )
            for oid in req["return_ids"]
        ]
        return {"status": "error", "error_repr": repr(exc), "seals": seals}

    def _finish_async_task(self, req: dict, fut) -> None:
        """Runs in the done-pool when an async method's coroutine settles:
        seal results, then hand the outcome to the agent (TaskDone)."""
        try:
            try:
                out = fut.result()
                result_values = self._split(out, req["return_ids"])
                seals = [
                    self.put_value(oid, v)
                    for oid, v in zip(req["return_ids"], result_values)
                ]
                reply = {"status": "ok", "seals": seals}
                borrows = self._compute_borrows(req.get("arg_ids"))
                if borrows:
                    reply["borrows"] = borrows
            except BaseException as exc:  # noqa: BLE001 - errors are values
                reply = self._error_reply(req, exc)
            with self._done_cv:
                self._done_q.append(
                    {"task_id": req["task_id"], "reply": reply}
                )
                self._done_cv.notify()
        except Exception:  # noqa: BLE001
            logger.exception("async task completion failed")

    def _done_sender_loop(self) -> None:
        while True:
            with self._done_cv:
                while not self._done_q:
                    self._done_cv.wait(timeout=1.0)
                batch = list(self._done_q)
                self._done_q.clear()
            try:
                self.agent.call("TaskDoneBatch", batch, timeout=60.0)
            except RpcError:
                logger.warning(
                    "agent unreachable; dropping %d TaskDones", len(batch)
                )

    def _split(self, out: Any, return_ids: List[str]) -> List[Any]:
        if len(return_ids) <= 1:
            return [out] if return_ids else []
        values = tuple(out)
        if len(values) != len(return_ids):
            raise ValueError(
                f"task returned {len(values)} values, expected {len(return_ids)}"
            )
        return list(values)

    def _set_context(self, req: dict) -> None:
        try:
            from ray_tpu_torch.core.runtime import get_context
            from ray_tpu_torch.util import tracing

            ctx = get_context()
            ctx.node_id = self.node_id
            ctx.task_id = req["task_id"]
            ctx.actor_id = req.get("actor_id")
            # install the received trace context so nested submissions
            # from this task inherit the SAME trace id with this task as
            # their parent span (tracing_helper.py propagation). The token
            # is thread-local: batched pushes run _h_push_task on
            # concurrent pool threads, each with its own context.
            self._trace_tokens.token = tracing.install(req.get("trace"))
        except Exception:  # noqa: BLE001
            pass

    def _clear_context(self) -> None:
        try:
            from ray_tpu_torch.core.runtime import get_context
            from ray_tpu_torch.util import tracing

            ctx = get_context()
            ctx.node_id = None
            ctx.task_id = None
            ctx.actor_id = None
            token = getattr(self._trace_tokens, "token", None)
            if token is not None:
                self._trace_tokens.token = None
                tracing.uninstall(token)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # direct actor calls (reference: actor_task_submitter.cc caller->worker
    # submission + task_receiver.h execution, bypassing GCS/raylet).
    # The accept reply returns as soon as every item is QUEUED; results are
    # pushed back to the caller's callback server (coalesced), and seals
    # flow to the agent so the head's object directory stays authoritative
    # for non-owner consumers.
    # ------------------------------------------------------------------

    def _h_direct_push_batch(self, req: dict) -> List[Any]:
        """Accept a batch of direct method calls. Per item the reply entry
        is "accepted" / "unknown_actor" / {"done": result}: after queueing
        everything, the handler lingers a few ms so fast results ride the
        accept reply itself — one RPC round trip for the common case —
        while slow methods fall back to the pushed DirectResults path
        (bounded wait, so a parked method can never deadlock the wire)."""
        import concurrent.futures as cf

        client_addr = req["client_addr"]
        accepts: List[Any] = []
        waiters: List[Optional[cf.Future]] = []
        from ray_tpu_torch.config import cfg

        if cfg.direct_trace:
            for item in req["items"]:
                item["_t_accept"] = time.perf_counter()
        # batch event-loop handoff: scheduling N coroutines with ONE
        # call_soon_threadsafe instead of N run_coroutine_threadsafe calls
        # saves N-1 cross-thread wakeups per accepted batch
        loop_batches: Dict[int, list] = {}
        for item in req["items"]:
            aid = item["actor_id"]
            instance = self._actors.get(aid)
            if instance is None:
                accepts.append("unknown_actor")
                waiters.append(None)
                continue
            item["client_addr"] = client_addr
            item["_claim"] = threading.Lock()
            item["_claimed"] = False
            entry = self._actor_loops.get(aid)
            if entry is not None:
                prepared = self._direct_prepare_async(item, instance, entry)
                if prepared is None:
                    fut = None  # ref args: deferred resolve path
                else:
                    coro, fut = prepared
                    loop_batches.setdefault(id(entry[0]), [entry[0], []])[
                        1
                    ].append((coro, fut))
            else:
                fut = self._direct_fifo_enqueue(aid, item)
            accepts.append("accepted")
            waiters.append(fut)
        for loop, pairs in loop_batches.values():
            self._schedule_coro_batch(loop, pairs)
        live = [f for f in waiters if f is not None]
        if live:
            from ray_tpu_torch.config import cfg

            cf.wait(live, timeout=cfg.direct_inline_wait_s)
        for i, (item, fut) in enumerate(zip(req["items"], waiters)):
            if fut is None:
                continue  # deferred dispatch attaches its own callback
            if fut.done():
                with item["_claim"]:
                    if item["_claimed"]:
                        continue
                    item["_claimed"] = True
                try:
                    result, seal = self._build_direct_result(
                        item, fut.result()
                    )
                except BaseException as exc:  # noqa: BLE001
                    result, seal = self._build_direct_error(item, exc)
                if seal is not None:  # deferred: caller owns bookkeeping
                    with self._direct_seal_cv:
                        self._direct_seals.append(seal)
                        self._direct_seal_cv.notify()
                accepts[i] = {"done": result}
            else:
                # still running: results go via the pushed DirectResults
                # path once the method settles
                fut.add_done_callback(
                    lambda f, it=item: self._done_pool.submit(
                        self._direct_finish_future, it, f
                    )
                )
        return accepts

    def _direct_prepare_async(self, item: dict, instance, entry):
        """Returns (coroutine, future) for batch scheduling, or None when
        arg refs defer resolution to the done pool (which schedules and
        attaches its own completion callback)."""
        import asyncio

        from ray_tpu_torch.core.object_store import ObjectRef

        loop, sems = entry
        method, args, kwargs = wire.loads(item["payload"])

        has_refs = any(isinstance(a, ObjectRef) for a in args) or any(
            isinstance(v, ObjectRef) for v in kwargs.values()
        )
        if not has_refs:
            import concurrent.futures as cf

            coro = _invoke_maybe_async(
                instance, method, args, kwargs, sems,
                trace=item.get("trace"),
            )
            return coro, cf.Future()

        # arg fetches can block: resolve off the event loop AND off the
        # RPC handler thread (the accept reply must return promptly)
        def resolve_then_schedule() -> None:
            try:
                rargs, rkwargs = self._resolve(args, kwargs)
            except BaseException as exc:  # noqa: BLE001
                self._direct_finish_claimed_error(item, exc)
                return
            fut = asyncio.run_coroutine_threadsafe(
                _invoke_maybe_async(
                    instance, method, rargs, rkwargs, sems,
                    trace=item.get("trace"),
                ),
                loop,
            )
            fut.add_done_callback(
                lambda f, it=item: self._done_pool.submit(
                    self._direct_finish_future, it, f
                )
            )

        self._done_pool.submit(resolve_then_schedule)
        return None

    def _schedule_coro_batch(self, loop, pairs) -> None:
        """Create all of a batch's tasks on the loop in one hop, bridging
        each asyncio task to its concurrent Future."""

        def create_all() -> None:
            if id(loop) in self._stopping_loops:
                # KillActor is draining this loop: creating tasks now
                # would slip them past the cancellation sweep and leave
                # their futures unresolved forever
                import concurrent.futures as cf

                for coro, cfut in pairs:
                    coro.close()
                    if cfut.set_running_or_notify_cancel():
                        cfut.set_exception(
                            RuntimeError("actor is being killed")
                        )
                return
            for coro, cfut in pairs:
                task = loop.create_task(coro)

                def done(t, cfut=cfut):
                    if not cfut.set_running_or_notify_cancel():
                        return
                    exc = None if t.cancelled() else t.exception()
                    if t.cancelled():
                        import concurrent.futures as cf

                        cfut.set_exception(cf.CancelledError())
                    elif exc is not None:
                        cfut.set_exception(exc)
                    else:
                        cfut.set_result(t.result())

                task.add_done_callback(done)

        loop.call_soon_threadsafe(create_all)

    def _direct_finish_future(self, item: dict, fut) -> None:
        """Callback-path completion: only fires the result push if the
        accept handler didn't already claim this item inline."""
        with item["_claim"]:
            if item["_claimed"]:
                return
            item["_claimed"] = True
        try:
            try:
                result, seal = self._build_direct_result(item, fut.result())
            except BaseException as exc:  # noqa: BLE001
                result, seal = self._build_direct_error(item, exc)
            self._direct_emit(item["client_addr"], result, seal)
        except Exception:  # noqa: BLE001
            logger.exception("direct call completion failed")

    def _direct_finish_claimed_error(self, item: dict, exc: BaseException) -> None:
        with item["_claim"]:
            if item["_claimed"]:
                return
            item["_claimed"] = True
        result, seal = self._build_direct_error(item, exc)
        self._direct_emit(item["client_addr"], result, seal)

    def _direct_fifo_enqueue(self, actor_id: str, item: dict):
        """Sync actor: one FIFO thread per actor preserves per-caller method
        order (the sender ships batches in submission order). Returns a
        Future of the raw value, completed by the FIFO thread."""
        import concurrent.futures as cf

        fut: cf.Future = cf.Future()
        with self._direct_fifo_cv:
            self._direct_fifo.setdefault(actor_id, deque()).append(
                (item, fut)
            )
            if actor_id not in self._direct_fifo_threads:
                t = threading.Thread(
                    target=self._direct_fifo_loop,
                    args=(actor_id,),
                    name=f"direct-{actor_id[:6]}",
                    daemon=True,
                )
                self._direct_fifo_threads[actor_id] = t
                t.start()
            self._direct_fifo_cv.notify_all()
        return fut

    def _direct_fifo_loop(self, actor_id: str) -> None:
        q = self._direct_fifo[actor_id]
        lock = self._dag_actor_locks.setdefault(actor_id, threading.Lock())
        while True:
            with self._direct_fifo_cv:
                while not q:
                    self._direct_fifo_cv.wait(timeout=5.0)
                    if not q and actor_id not in self._actors:
                        self._direct_fifo_threads.pop(actor_id, None)
                        return
                item, fut = q.popleft()
            try:
                instance = self._actors[actor_id]
                method, args, kwargs = wire.loads(item["payload"])
                args, kwargs = self._resolve(args, kwargs)
                from ray_tpu_torch.util import tracing

                token = tracing.install(item.get("trace"))
                try:
                    with lock:
                        out = getattr(instance, method)(*args, **kwargs)
                finally:
                    tracing.uninstall(token)
                fut.set_result(out)
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

    def _register_direct_borrows(self, item: dict) -> None:
        """Arg refs this process still holds at completion (stored in actor
        state / a live closure) are registered with the head SYNCHRONOUSLY
        before the result is emitted — the caller releases its per-call arg
        pins once the result arrives, so the registration must already be
        on the books (lease-path analog: _compute_borrows + head pin
        conversion)."""
        from ray_tpu_torch.core.refcount import TRACKER

        borrowed = [
            h
            for h in item.get("arg_ids") or ()
            if TRACKER.count(h) > 0 and not self._flusher.is_registered(h)
        ]
        if borrowed:
            self._flusher.sync_incref(borrowed)

    def _build_direct_result(self, item: dict, value: Any):
        """(result_dict, seal): inline small values ride back to the caller
        with an inline seal for the head's directory; large values go to
        the store with a location seal."""
        from ray_tpu_torch.core.refcount import collect_serialized

        self._register_direct_borrows(item)
        oid = item["ref"]
        owner = item["client_id"]
        with collect_serialized() as contained:
            parts, total = wire.dumps_parts(value)
        contained_ids = sorted(contained)
        _flush_nested_deferred(contained_ids)
        data = wire.join_parts(parts) if total <= INLINE_OBJECT_MAX else b""
        if total <= INLINE_OBJECT_MAX:
            seal = SealInfo(
                object_id=oid,
                node_id=self.node_id,
                size=len(data),
                inline_value=data,
                contained_ids=contained_ids,
                owner=owner,
            )
            result = {"ref": oid, "status": "ok", "value": data}
            from ray_tpu_torch.config import cfg as _cfg

            if _cfg.direct_deferred_seals and not contained_ids:
                # ownership model: the caller (owner) keeps value + seal;
                # the head learns about this object only if the ref is
                # shared or evicted (reference: small direct-call returns
                # never touch the GCS). The sender loop re-materializes
                # this seal worker-side if the result push fails.
                # Results CONTAINING refs keep the seal path — the seal is
                # what pins the inner objects head-side, and no caller-side
                # registration could close that race window.
                result["deferred_seal"] = contained_ids
                result["owner"] = owner
                seal = None
            if "_t_accept" in item:
                result["_t_accept"] = item["_t_accept"]
                result["_t_emit"] = time.perf_counter()
            return result, seal
        stored = False
        if self.store is not None:
            try:
                self.store.put_frames(oid, parts)
                OBJECT_TRANSFER_BYTES.inc(total, labels={"path": "shm"})
                stored = True
            except Exception:  # noqa: BLE001 - arena full
                pass
        if not stored:
            self.agent.call(
                "WorkerPut",
                {"object_id": oid, "data": wire.join_parts(parts)},
                timeout=60.0,
            )
            OBJECT_TRANSFER_BYTES.inc(total, labels={"path": "rpc"})
        seal = SealInfo(
            object_id=oid,
            node_id=self.node_id,
            size=total,
            contained_ids=contained_ids,
            owner=owner,
        )
        return {"ref": oid, "status": "seal", "seal": seal}, seal

    def _build_direct_error(self, item: dict, exc: BaseException):
        from ray_tpu_torch.core.object_store import TaskError

        try:
            self._register_direct_borrows(item)
        except Exception:  # noqa: BLE001 - borrow RPC failure
            logger.warning("borrow registration failed", exc_info=True)
        tb = traceback.format_exc()
        err = TaskError(exc, item.get("name", "direct_call"), traceback_str=tb)
        err.__cause__ = exc
        try:
            blob = cloudpickle.dumps(err)
        except Exception:  # noqa: BLE001
            blob = cloudpickle.dumps(
                TaskError(
                    RuntimeError(repr(exc)),
                    item.get("name", "direct_call"),
                    traceback_str=tb,
                )
            )
        seal = SealInfo(
            object_id=item["ref"],
            node_id=self.node_id,
            is_error=True,
            error=blob,
            owner=item["client_id"],
        )
        return {"ref": item["ref"], "status": "error", "error": blob}, seal

    def _direct_emit(self, client_addr: str, result: dict, seal) -> None:
        with self._direct_out_cv:
            self._direct_out.setdefault(client_addr, []).append(result)
            self._direct_out_cv.notify()
        if seal is None:  # deferred: caller owns the bookkeeping
            return
        with self._direct_seal_cv:
            self._direct_seals.append(seal)
            self._direct_seal_cv.notify()

    def _direct_sender_loop(self) -> None:
        """Coalescing pusher: everything finished while the previous RPC
        was in flight merges into one DirectResults per caller. Seal
        reports ride a separate thread so the latency-critical result
        push never waits behind an agent round trip."""
        while True:
            with self._direct_out_cv:
                while not self._direct_out:
                    self._direct_out_cv.wait(timeout=1.0)
                out = self._direct_out
                self._direct_out = {}
            for addr, results in out.items():
                client = self._direct_clients.get(addr)
                if client is None:
                    client = self._direct_clients[addr] = RpcClient(addr)
                try:
                    client.call("DirectResults", results, timeout=30.0)
                except RpcError:
                    # caller is gone. Results with deferred seals were
                    # counting on the caller for head bookkeeping — seal
                    # them worker-side now so any other holder can still
                    # resolve through the directory.
                    fallback = [
                        SealInfo(
                            object_id=r["ref"],
                            node_id=self.node_id,
                            size=len(r["value"]),
                            inline_value=r["value"],
                            contained_ids=list(r["deferred_seal"] or ()),
                            owner=r.get("owner"),
                        )
                        for r in results
                        if r.get("status") == "ok"
                        and "deferred_seal" in r
                    ]
                    if fallback:
                        with self._direct_seal_cv:
                            self._direct_seals.extend(fallback)
                            self._direct_seal_cv.notify()
                    logger.warning(
                        "direct caller %s unreachable; dropping %d results",
                        addr,
                        len(results),
                    )

    def _metrics_due(self) -> bool:
        from ray_tpu_torch.config import cfg

        return bool(cfg.metrics_federation) and (
            time.monotonic() - self._metrics_last_ship
            >= cfg.metrics_interval_s
        )

    def _metrics_entries(self) -> list:
        """Metrics federation tick (interval-gated): sync the dark-plane
        accumulators into this process's registry and collect its typed
        deltas, pre-labeled with this worker's node/role so they ride
        the agent's next head report untouched."""
        from ray_tpu_torch.config import cfg

        if not cfg.metrics_federation:
            return []
        now = time.monotonic()
        if now - self._metrics_last_ship < cfg.metrics_interval_s:
            return []
        self._metrics_last_ship = now
        try:
            from ray_tpu_torch.cluster.event_loop import publish_dark_plane
            from ray_tpu_torch.util.metrics import DeltaExporter

            publish_dark_plane()
            if self._metric_exporter is None:
                self._metric_exporter = DeltaExporter()
            records = self._metric_exporter.collect()
        except Exception:  # noqa: BLE001 - metrics must not stall seals
            logger.debug("worker metrics collect failed", exc_info=True)
            return []
        if not records:
            return []
        # role carries a stable per-process discriminator: two workers
        # on one node must not collapse to the same series key (their
        # per-process gauges would overwrite each other; counters still
        # sum correctly across the per-worker series)
        return [
            {
                "node": self.node_id,
                "role": f"worker:{self.worker_id[:8]}",
                "records": records,
            }
        ]

    def _direct_seal_loop(self) -> None:
        while True:
            with self._direct_seal_cv:
                while not (
                    self._direct_seals
                    or self._stream_reports
                    or self._stream_done_reports
                ):
                    self._direct_seal_cv.wait(timeout=1.0)
                    # the seal channel doubles as the metrics uplink: a
                    # due tick breaks the wait even with nothing sealed
                    if self._metrics_due():
                        break
                seals = self._direct_seals
                self._direct_seals = []
                stream = self._stream_reports
                self._stream_reports = []
                stream_done = self._stream_done_reports
                self._stream_done_reports = []
            msg = {"seals": seals}
            if stream:
                msg["stream"] = stream
            if stream_done:
                msg["stream_done"] = stream_done
            metrics = self._metrics_entries()
            if metrics:
                msg["metrics"] = metrics
            if not (seals or stream or stream_done or metrics):
                continue
            while True:
                try:
                    self.agent.call("WorkerSealed", msg, timeout=30.0)
                    break
                except RpcError:
                    # a dropped seal would orphan the object in the head's
                    # directory (no location, no holder) — keep the batch
                    # and retry; if the agent is gone for good the parent
                    # watch (_exit_with_parent) exits this process
                    logger.warning(
                        "agent unreachable; retrying %d direct seals",
                        len(seals),
                    )
                    time.sleep(0.5)

    # ------------------------------------------------------------------
    # leased-task execution (task leases; reference: the raylet's worker
    # lease — one worker pinned to a submitter, tasks streamed to it with
    # no per-task scheduler hop, local_lease_manager.h). Tasks execute
    # STRICTLY one at a time per lease (the lease holds exactly one
    # task's resource allocation); queued items are recallable so the
    # owner can spill them back to head scheduling when the head of the
    # line blocks (rendezvous peers) or on explicit cancel. Results and
    # seals ride the direct-call result/seal machinery, so the head's
    # object directory stays authoritative exactly as for direct actor
    # calls (owner-held deferred seals included).
    # ------------------------------------------------------------------

    def _h_lease_task_batch(self, req: dict) -> List[str]:
        """Accept a window of leased tasks onto the lease's FIFO. The
        reply returns as soon as everything is queued; results push back
        to the caller's callback server. "released" tells a stale caller
        its lease is gone (it re-routes through the head)."""
        lease_id = req["lease_id"]
        client_addr = req["client_addr"]
        accel_env = req.get("accel_env")
        with self._lease_cv:
            if lease_id in self._lease_tombstones:
                return ["released"] * len(req["items"])
            st = self._lease_state.get(lease_id)
            if st is None:
                st = self._lease_state[lease_id] = {
                    "released": False,
                    "undo": None,
                }
                if accel_env:
                    # the lease owns this worker until released: its chip
                    # assignment applies for the lease lifetime (the
                    # actor-creation persistence semantics, scoped to the
                    # lease instead of the process)
                    prev = {k: os.environ.get(k) for k in accel_env}
                    os.environ.update(accel_env)

                    def undo(prev=prev) -> None:
                        for k, old in prev.items():
                            if old is None:
                                os.environ.pop(k, None)
                            else:
                                os.environ[k] = old

                    st["undo"] = undo
                self._lease_q[lease_id] = deque()
                threading.Thread(
                    target=self._lease_fifo_loop,
                    args=(lease_id,),
                    # "direct-" prefix: framework thread, scrub-allowed
                    name=f"direct-lease-{lease_id[:6]}",
                    daemon=True,
                ).start()
            elif st["released"]:
                return ["released"] * len(req["items"])
            q = self._lease_q[lease_id]
            for item in req["items"]:
                item["client_addr"] = client_addr
                q.append(item)
            self._lease_cv.notify_all()
        return ["accepted"] * len(req["items"])

    def _h_lease_recall(self, req: dict) -> dict:
        """Hand queued (not-yet-running) items back to the caller: with
        ``refs`` a targeted cancel, without it a stall spill — the owner
        re-routes the removed tasks through head scheduling. The running
        head-of-line task is never touched (non-force semantics)."""
        lease_id = req["lease_id"]
        only = req.get("refs")
        removed: List[str] = []
        with self._lease_cv:
            q = self._lease_q.get(lease_id)
            if q:
                keep: deque = deque()
                for item in q:
                    if only is None or item["ref"] in only:
                        removed.append(item["ref"])
                    else:
                        keep.append(item)
                self._lease_q[lease_id] = keep
                self._lease_cv.notify_all()
        return {"removed": removed}

    def _h_lease_release(self, req: dict) -> dict:
        """The agent reclaimed this lease's worker. Queued (not-yet-
        started) items are handed BACK to their owner as ``spill``
        results — it re-routes them through head scheduling — so the
        pooled worker only overlaps its next task with at most the one
        leased task already running; the FIFO thread exits (and undoes
        the lease env) once that finishes. A tombstone keeps stale
        owner batches from resurrecting the lease."""
        lease_id = req["lease_id"]
        drained: List[dict] = []
        with self._lease_cv:
            self._lease_tombstones.add(lease_id)
            self._lease_tombstone_order.append(lease_id)
            while len(self._lease_tombstone_order) > 1024:
                self._lease_tombstones.discard(
                    self._lease_tombstone_order.popleft()
                )
            st = self._lease_state.get(lease_id)
            if st is not None:
                st["released"] = True
                q = self._lease_q.get(lease_id)
                if q:
                    drained.extend(q)
                    q.clear()
                self._lease_cv.notify_all()
        for item in drained:
            self._direct_emit(
                item["client_addr"],
                {"ref": item["ref"], "status": "spill"},
                None,
            )
        return {"ok": True}

    def _lease_fifo_loop(self, lease_id: str) -> None:
        while True:
            item = None
            undo = None
            with self._lease_cv:
                while True:
                    st = self._lease_state.get(lease_id)
                    if st is None:
                        return
                    q = self._lease_q.get(lease_id)
                    if q:
                        item = q.popleft()
                        break
                    if st["released"]:
                        undo = st.get("undo")
                        self._lease_q.pop(lease_id, None)
                        self._lease_state.pop(lease_id, None)
                        break
                    self._lease_cv.wait(timeout=1.0)
            if item is None:
                if undo is not None:
                    undo()
                return
            self._lease_running[lease_id] = item["ref"]
            try:
                self._run_lease_item(item)
            finally:
                self._lease_running.pop(lease_id, None)

    def _h_lease_kill_running(self, req: dict) -> dict:
        """Force-cancel of the CURRENTLY EXECUTING leased task: the only
        preemption a thread-based executor has is killing the process —
        exactly what the head's force path does to a worker running a
        head-scheduled task. The agent's death path respawns the worker
        and reports the lease lost; the caller pre-seals the cancel."""
        if self._lease_running.get(req["lease_id"]) != req["ref"]:
            return {"ok": False}  # finished (or never started) meanwhile
        import threading as _threading

        _threading.Timer(0.1, lambda: os._exit(1)).start()
        return {"ok": True}

    def _run_lease_item(self, item: dict) -> None:
        """Execute one leased task and emit its result through the
        direct-call result path (seal bookkeeping identical to direct
        actor calls: inline values owner-held under deferred seals, big
        values sealed to the node store, errors sealed with owner)."""
        self._set_context(item)
        runtime_env = item.get("runtime_env")
        if runtime_env:
            self._env_enter(runtime_env)
        out = None
        failed: Optional[BaseException] = None
        sample = dispatch_sampled()
        t0 = time.perf_counter() if sample else 0.0
        try:
            fn = self._fn_from_blob(
                item.get("fn_id", ""), item["fn_blob"], item.get("fn_cache")
            )
            args, kwargs = wire.loads(item["payload"])
            args, kwargs = self._resolve(args, kwargs)
            out = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 - errors are values
            failed = exc
        finally:
            if sample:
                DISPATCH_OVERHEAD_US.observe(
                    (time.perf_counter() - t0) * 1e6, {"stage": "execute"}
                )
            if runtime_env:
                self._env_exit()
            self._clear_context()
        try:
            if failed is not None:
                result, seal = self._build_direct_error(item, failed)
            else:
                result, seal = self._build_direct_result(item, out)
        except BaseException as exc:  # noqa: BLE001 - sealing can fail too
            result, seal = self._build_direct_error(item, exc)
        self._direct_emit(item["client_addr"], result, seal)

    # ------------------------------------------------------------------
    # compiled-DAG programs (reference: compiled_dag_node.py actor-side
    # execution loops reading/writing channels instead of receiving tasks)
    # ------------------------------------------------------------------
    def _h_dag_install(self, req: dict) -> dict:
        from ray_tpu_torch.dag.channel import ShmChannel
        from ray_tpu_torch.dag.compiled import run_dag_stage

        actor_id = req["actor_id"]
        dag_id = req["dag_id"]
        instance = self._actors[actor_id]
        entry = self._actor_loops.get(actor_id)
        dag_lock = self._dag_actor_locks.setdefault(actor_id, threading.Lock())
        state = self._dag_programs.setdefault(
            dag_id, {"stop": threading.Event(), "threads": []}
        )
        for prog in req["programs"]:
            prog_channels: List[Any] = []
            in_channels: Dict[tuple, Any] = {}
            consts_args: List[Any] = []
            for i, (kind, v) in enumerate(prog["args"]):
                if kind == "chan":
                    ch = ShmChannel(v, capacity=prog["capacity"])
                    in_channels[("arg", i)] = ch
                    prog_channels.append(ch)
                    consts_args.append(None)
                else:
                    consts_args.append(cloudpickle.loads(v))
            consts_kwargs: Dict[str, Any] = {}
            for k, (kind, v) in prog["kwargs"].items():
                if kind == "chan":
                    ch = ShmChannel(v, capacity=prog["capacity"])
                    in_channels[("kw", k)] = ch
                    prog_channels.append(ch)
                    consts_kwargs[k] = None
                else:
                    consts_kwargs[k] = cloudpickle.loads(v)
            if prog.get("tick_path"):
                ch = ShmChannel(prog["tick_path"], capacity=prog["capacity"])
                in_channels[("tick",)] = ch
                prog_channels.append(ch)
            out_channels = []
            for p in prog["out_paths"]:
                ch = ShmChannel(p, capacity=prog["capacity"])
                out_channels.append(ch)
                prog_channels.append(ch)
            method = prog["method"]
            fn = getattr(instance, method)
            if entry is not None:
                import asyncio
                import inspect

                loop, _sems = entry

                def target(*a, _fn=fn, **kw):
                    from ray_tpu_torch.core.object_store import should_await

                    with dag_lock:
                        out = _fn(*a, **kw)
                    if should_await(out):
                        return asyncio.run_coroutine_threadsafe(
                            _awrap(out), loop
                        ).result()
                    return out

                async def _awrap(aw):
                    # run_coroutine_threadsafe needs a coroutine, not a
                    # bare awaitable
                    return await aw

            else:

                def target(*a, _fn=fn, **kw):
                    with dag_lock:
                        return _fn(*a, **kw)
            t = threading.Thread(
                target=run_dag_stage,
                args=(
                    target,
                    in_channels,
                    out_channels,
                    consts_args,
                    consts_kwargs,
                    state["stop"],
                    f"{actor_id[:8]}.{method}",
                ),
                name=f"dag-{dag_id[:8]}-{method}",
                daemon=True,
            )
            state["threads"].append((t, prog_channels))
            t.start()
        return {"status": "ok"}

    def _h_dag_teardown(self, req: dict) -> dict:
        state = self._dag_programs.pop(req["dag_id"], None)
        if state is not None:
            state["stop"].set()
            for t, channels in state["threads"]:
                t.join(timeout=2.0)
                if t.is_alive():
                    # a stage is still mid-method: closing (munmapping) its
                    # rings under it would segfault the whole worker — leave
                    # them mapped; the thread exits on its next stop-flag
                    # check and the mappings die with it
                    logger.warning(
                        "dag %s stage %s still running at teardown; "
                        "leaving its channels mapped",
                        req["dag_id"][:8],
                        t.name,
                    )
                    continue
                for ch in channels:
                    try:
                        ch.close()
                    except Exception:  # noqa: BLE001
                        pass
        return {"status": "ok"}

    def _h_pipeline_install(self, req: dict) -> dict:
        """Install AOT-compiled pipeline stages into this worker
        (dag/pipeline.py): per stage, open its pre-created in/out rings
        and start the bytes-level stage loop. Stage functions arrive as
        cloudpickle blobs ONCE at install; method stages bind the hosted
        actor instance under the per-actor DAG lock (compiled-DAG calls,
        pipeline calls, and normal pushed methods stay serialized)."""
        from ray_tpu_torch.dag.channel import ShmChannel
        from ray_tpu_torch.dag.pipeline import run_pipeline_stage

        actor_id = req["actor_id"]
        pipe_id = req["pipe_id"]
        instance = self._actors[actor_id]
        entry = self._actor_loops.get(actor_id)
        dag_lock = self._dag_actor_locks.setdefault(actor_id, threading.Lock())
        state = self._pipelines.setdefault(
            pipe_id, {"stop": threading.Event(), "threads": []}
        )
        for prog in req["programs"]:
            in_ch = ShmChannel(prog["in_path"], capacity=prog["capacity"])
            out_ch = ShmChannel(prog["out_path"], capacity=prog["capacity"])
            if prog.get("fn_blob") is not None:
                fn = cloudpickle.loads(prog["fn_blob"])

                def target(x, _fn=fn):
                    return _fn(x)

                name = getattr(fn, "__name__", "fn")
            else:
                method = prog["method"]
                bound = getattr(instance, method)
                if entry is not None:
                    import asyncio

                    loop, _sems = entry

                    async def _awrap(aw):
                        return await aw

                    def target(x, _fn=bound, _loop=loop):
                        from ray_tpu_torch.core.object_store import should_await

                        with dag_lock:
                            out = _fn(x)
                        if should_await(out):
                            return asyncio.run_coroutine_threadsafe(
                                _awrap(out), _loop
                            ).result()
                        return out

                else:

                    def target(x, _fn=bound):
                        with dag_lock:
                            return _fn(x)

                name = method
            t = threading.Thread(
                target=run_pipeline_stage,
                args=(
                    target,
                    in_ch,
                    out_ch,
                    state["stop"],
                    f"{actor_id[:8]}.{name}[{prog['stage']}]",
                ),
                name=f"pipe-{pipe_id[:8]}-s{prog['stage']}",
                daemon=True,
            )
            state["threads"].append((t, [in_ch, out_ch]))
            t.start()
        return {"status": "ok"}

    def _h_pipeline_teardown(self, req: dict) -> dict:
        state = self._pipelines.pop(req["pipe_id"], None)
        if state is not None:
            state["stop"].set()
            for t, channels in state["threads"]:
                t.join(timeout=2.0)
                if t.is_alive():
                    # mid-method stage: munmapping its rings under it
                    # would segfault the worker — leave them mapped, the
                    # thread exits on its next stop-flag check
                    logger.warning(
                        "pipeline %s stage %s still running at teardown; "
                        "leaving its channels mapped",
                        req["pipe_id"][:8],
                        t.name,
                    )
                    continue
                for ch in channels:
                    try:
                        ch.close()
                    except Exception:  # noqa: BLE001
                        pass
        return {"status": "ok"}

    def _h_kill_actor(self, req: dict) -> None:
        self._actors.pop(req["actor_id"], None)
        entry = self._actor_loops.pop(req["actor_id"], None)
        if entry is not None:
            loop, _ = entry
            self._stopping_loops.add(id(loop))

            def begin_shutdown() -> None:
                import asyncio

                async def drain_and_stop() -> None:
                    # cancel in-flight methods and WAIT for the cancellations
                    # to land: their futures resolve with CancelledError →
                    # TaskDone(error) → callers unblock, instead of freezing
                    # forever on a stopped loop. Repeat until quiescent:
                    # a queued create_all can add tasks after one sweep.
                    me = asyncio.current_task()
                    for _ in range(10):
                        tasks = [
                            t for t in asyncio.all_tasks() if t is not me
                        ]
                        if not tasks:
                            break
                        for t in tasks:
                            t.cancel()
                        await asyncio.gather(*tasks, return_exceptions=True)
                    loop.stop()

                loop.create_task(drain_and_stop())

            try:
                loop.call_soon_threadsafe(begin_shutdown)
            except RuntimeError:
                pass

    # C-extension packages whose re-import after a sys.modules purge is
    # undefined (numpy refuses outright); an actor that pulled one in past
    # the baseline makes this process unscrubbabe — refuse, and the agent
    # re-forks a pristine worker instead (ms-scale via the zygote).
    SCRUB_RISKY_ROOTS = frozenset(
        {"jax", "jaxlib", "numpy", "scipy", "pandas", "torch",
         "tensorflow", "grpc", "pyarrow"}
    )

    # threads the framework itself starts lazily after registration —
    # these exit on their own or serve the next actor; anything else
    # alive past the baseline refuses the scrub
    SCRUB_THREAD_OK = (
        "direct-",          # per-actor FIFO executors (self-exiting)
        "task-done",        # done-pool workers
        "task-batch",       # batch-pool workers
        "ThreadPoolExecutor",  # grpc server / stdlib pool workers
        "asyncio_",         # asyncio default-executor workers
    )
    # NOTE: "actor-loop-" is intentionally absent — those threads are
    # JOINED during the scrub, so a survivor (loop that refused to drain)
    # lands in the stray list and refuses the reuse.

    def _h_scrub_actor(self, req: dict) -> dict:
        """Reset this worker to its registration-time state after its
        actor exited cleanly, so the agent can return it to the idle pool
        (worker_pool.cc idle-worker reuse; the reference only reuses TASK
        workers — the scrub contract is what makes actor reuse sound
        here). Refuses (ok=False) whenever pristine state cannot be
        restored; the caller then kills + re-forks instead."""
        aid = req["actor_id"]
        self._h_kill_actor({"actor_id": aid})
        reasons = []
        if self._dag_programs:
            reasons.append("compiled-DAG programs still installed")
        if self._pipelines:
            reasons.append("compiled-pipeline programs still installed")
        if self._actors:
            reasons.append("other actors resident")
        # thread hygiene: the killed actor's event loop drains async
        # (KillActor cancels + stops it via call_soon_threadsafe) — wait
        # for those loop threads to actually exit, then refuse if any
        # OTHER non-framework thread born after registration survives:
        # a user daemon thread is live actor state no scrub can undo.
        for t in threading.enumerate():
            if (
                t not in self._baseline_threads
                and t.name.startswith("actor-loop-")
            ):
                t.join(timeout=5.0)
        stray = sorted(
            t.name
            for t in threading.enumerate()
            if t.is_alive()
            and t is not threading.current_thread()
            and t not in self._baseline_threads
            and not t.name.startswith(self.SCRUB_THREAD_OK)
        )
        if stray:
            reasons.append(f"non-framework threads alive: {','.join(stray[:3])}")
        # module-state reset, scoped to WHOLLY NEW package roots (user
        # code shipped/imported by the actor): those are dropped so the
        # next actor re-imports a fresh copy and mutated module globals
        # cannot leak across reuses. Lazily-loaded SUBmodules of packages
        # already present at registration (grpc/cloudpickle/asyncio
        # internals the framework touches on demand) and stdlib roots are
        # kept — purging them would break the live framework, and actor
        # code does not own their state.
        stdlib = getattr(sys, "stdlib_module_names", ())
        baseline_roots = {m.split(".", 1)[0] for m in self._baseline_modules}
        new_mods = [
            m for m in list(sys.modules) if m not in self._baseline_modules
        ]
        fresh_roots = (
            {m.split(".", 1)[0] for m in new_mods}
            - baseline_roots
            - set(stdlib)
        )
        risky = sorted(fresh_roots & self.SCRUB_RISKY_ROOTS)
        if risky:
            reasons.append(f"unreloadable modules imported: {','.join(risky)}")
        if reasons:
            return {"ok": False, "reason": "; ".join(reasons)}
        purge = [m for m in new_mods if m.split(".", 1)[0] in fresh_roots]
        for m in purge:
            sys.modules.pop(m, None)
        if purge:
            importlib.invalidate_caches()
        # sys.path restore: user code that inserted its own entries
        # (working-dir style) must not leak import resolution into the
        # next actor
        if sys.path != self._baseline_sys_path:
            sys.path[:] = self._baseline_sys_path
            importlib.invalidate_caches()
        # env + cwd restore (covers persisted actor accel env and any
        # os.environ writes by user code)
        for k in list(os.environ):
            if k not in self._baseline_env:
                del os.environ[k]
        for k, v in self._baseline_env.items():
            if os.environ.get(k) != v:
                os.environ[k] = v
        if self._baseline_cwd is not None:
            try:
                if os.getcwd() != self._baseline_cwd:
                    os.chdir(self._baseline_cwd)
            except OSError:
                return {"ok": False, "reason": "cwd unrestorable"}
        self._fn_cache.clear()
        self._fn_cache_order.clear()
        self._dag_actor_locks.pop(aid, None)
        with self._direct_fifo_cv:
            self._direct_fifo.pop(aid, None)
            self._direct_fifo_cv.notify_all()
        with self._env_cv:
            # a persisted actor runtime_env's discarded undo left the gate
            # signature dangling; reuse starts clean
            if self._env_active == 0:
                self._env_sig = None
                self._env_undo = lambda: None
        return {"ok": True}



def _exit_with_parent(parent: int) -> None:
    """Ends this process once the process that started it (agent or
    zygote) has died: an orphan is re-parented to init or to a subreaper,
    so test for a change of parent, not for pid 1; don't linger."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(0)


def run_worker(
    agent_address: str,
    worker_id: str,
    store_path: str,
    parent: Optional[int] = None,
) -> None:
    """Process entry shared by the cold spawn path (``main``) and the
    zygote fork path (``zygote._child_main``): diagnostics hooks, then the
    Worker loop. ``parent`` is the pid of the process that started this
    one (default: the parent now); the worker exits once it changes.
    Never returns."""
    if parent is None:
        parent = os.getppid()
    logging.basicConfig(level=logging.WARNING)
    # stuck-worker diagnosis: `kill -USR1 <pid>` dumps all thread stacks
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # the parent watch starts before the Worker registers with its agent:
    # the registration's retries would outlive a dead agent by ~20-30 s
    watch = threading.Thread(
        target=_exit_with_parent, args=(parent,), name="parent-watch", daemon=True
    )
    watch.start()
    worker = Worker(agent_address, worker_id, store_path)
    prof_dir = os.environ.get("RAY_TPU_PROFILE_WORKER")
    if prof_dir:
        # perf diagnosis: dump per-worker cProfile stats on SIGUSR2
        import cProfile
        import signal as _sig

        _pr = cProfile.Profile()
        _pr.enable()

        def _dump(_sig_no, _frm):
            _pr.dump_stats(
                os.path.join(prof_dir, f"worker-{worker_id}.prof")
            )

        _sig.signal(_sig.SIGUSR2, _dump)
    watch.join()  # serve until the parent dies


def seal_local_value(value: Any, owner: str = "") -> Optional[str]:
    """Arena-direct object seal from INSIDE a cluster worker: one
    pickle-5 gather into the node's shm arena (the ndarray seal
    path — numpy leaves scatter-write as out-of-band frames), the
    SealInfo rides the worker's existing direct-seal batch to the agent
    and from there to the head's object directory. ``owner`` (a driver
    client id) is registered as the holder, so the object fate-shares
    with that driver and stays alive until it frees the generation.

    Returns the new object's hex id, or None when not running inside a
    cluster worker (callers fall back to ``ray_tpu_torch.put``). Used by the
    elastic-training state plane to seal param/optimizer shards without
    a head RPC on the data path.
    """
    import dataclasses as _dc

    w = _CURRENT_WORKER
    if w is None or w.store is None:
        return None
    from ray_tpu_torch._ids import rand_hex

    hex_id = rand_hex(14)
    seal = w.put_value(hex_id, value)
    if owner:
        seal = _dc.replace(seal, owner=owner)
    with w._direct_seal_cv:
        w._direct_seals.append(seal)
        w._direct_seal_cv.notify_all()
    return hex_id


def fetch_into_local_arena(
    hex_id: str, timeout: float = 60.0, land: str = "device"
) -> Any:
    """Pull ``hex_id`` through THIS worker's agent so a copy lands in
    the local arena and the head directory gains a second location
    (buddy replication for elastic state shards; the pull itself rides
    the socket plane / chunked fallback like any located fetch).
    Returns the deserialized value. Raises when not inside a worker.

    ``land`` picks the device-frame landing mode for the deserialize:
    ``"device"`` (default) lands a frame sealed from a CUDA tensor back on
    this process's current CUDA device, one H2D copy from the arena view
    (a frame sealed from a CPU tensor lands as a CPU tensor); ``"host"``
    returns read-only host views (callers that only re-export, e.g. buddy
    replication without consumption)."""
    w = _CURRENT_WORKER
    if w is None:
        raise RuntimeError("fetch_into_local_arena: not inside a worker")
    from ray_tpu_torch.cluster.device_plane import landing

    with landing(land):
        return w.get_object(hex_id, timeout=timeout)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--agent", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--store", default="")
    args = parser.parse_args()
    pip_dir = os.environ.get("RAY_TPU_PIP_ENV_DIR")
    if pip_dir:
        # pip runtime env: the agent built this --target dir for the env
        # this worker serves; it shadows base site-packages (pip_env.py).
        # Cold-spawn only — env workers never fork from the zygote (its
        # sys.path/modules are already bound to base site-packages).
        sys.path.insert(0, pip_dir)
    run_worker(args.agent, args.worker_id, args.store)


if __name__ == "__main__":
    main()
