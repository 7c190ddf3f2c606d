"""AOT-compiled actor pipelines: the compiled-DAG fast path generalized
to the execution plane.

``compile_pipeline(actors, stages)`` freezes a linear pipeline of stage
functions (or actor-method names) over a pool of actors and pre-allocates
ONE shm ring pair per stage hop (``native/ring.cc``), pre-pinned and
reused across every execution. In the steady state a stage hop is one
futex-woken mmap write — no head RPC, no agent hop, no object-store
entry, and (unlike ``CompiledDAG``'s per-edge-per-call channels) no
per-call channel creation:

- **slot multiplexing**: every message carries a ``u32 slot | u8 tag``
  header, so MANY logical executions stream through one ring pair per
  hop concurrently (dynamic fan-out over a static topology — the ring is
  the multiplexer, not a per-call resource).
- **zero per-task Python on the wire path**: the driver's submit does
  one serialize + one ring write; the collector thread does one ring
  read + a dict pop + an event set per completion. Deserialization is
  deferred to ``PipelineRef.get()`` (the consumer's thread), so neither
  the collector nor the fused event loop runs per-item unpickling.
- **chaos-safe spillback**: if a stage worker dies (SIGKILL included),
  the pipeline breaks and every unresolved execution re-submits through
  the EAGER task path from its retained input frame — zero acked loss.
  Function stages respill as stateless tasks (safe even when the hosting
  actor is gone for good); method stages respill as normal actor calls
  (they need the actor restarted — the actor owns the state either way).

The reference shape is compiled_dag_node.py + shared_memory_channel.py
with core_worker's C++ submit loop underneath: once the pipeline is hot,
the per-task budget is syscall + memcpy time, not interpreter time.

Port of ``ray_tpu/dag/pipeline.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch.config import cfg
from ray_tpu_torch.core.object_store import GetTimeoutError, TaskError

from .channel import (
    ERR,
    OK,
    STOP,
    ChannelClosed,
    ChannelTimeout,
    LocalChannel,
    ShmChannel,
    ring_path,
)

logger = logging.getLogger("ray_tpu_torch.dag.pipeline")

#: slot-multiplexed message header: u32 logical-stream slot, u8 tag
MSG = struct.Struct("<IB")

# live pipelines (weak) for observability surfaces
_PIPELINES: "weakref.WeakSet" = weakref.WeakSet()

# dark-plane counters: the event loop bumps shm-resident
# int64 slots (native/counters.py) — one lock-free store per item,
# synced into the typed registry on the observability tick
from ray_tpu_torch.native import counters as _dark_counters  # noqa: E402

_C_SUBMITTED = _dark_counters._IDX["pipeline_items_submitted_total"]
_C_COMPLETED = _dark_counters._IDX["pipeline_items_completed_total"]
_C_RESPILLED = _dark_counters._IDX["pipeline_items_respilled_total"]


def pipeline_stats() -> List[dict]:
    return [p.stats() for p in list(_PIPELINES)]


def _put_msg(out_ch, payload: bytes, stop_flag: threading.Event) -> bool:
    """Ring put with teardown-aware retry. False = channel unusable."""
    while True:
        try:
            out_ch.put_bytes(payload, timeout=0.5)
            return True
        except ChannelTimeout:
            if stop_flag.is_set():
                return False
        except (ChannelClosed, OSError):
            return False


def run_pipeline_stage(
    target,
    in_ch,
    out_ch,
    stop_flag: threading.Event,
    name: str = "stage",
) -> None:
    """Worker-side stage loop (bytes level): read ``slot|tag|frame``,
    fire the target on OK frames, forward ERR/STOP markers untouched
    (failures surface at the driver in stream order, teardown drains in
    topological order — the compiled-DAG channel semantics)."""
    from ray_tpu_torch.cluster import serialization as wire

    while not stop_flag.is_set():
        try:
            data = in_ch.get_bytes(timeout=0.5)
        except ChannelTimeout:
            continue
        except (ChannelClosed, OSError):
            return
        slot, tag = MSG.unpack_from(data)
        if tag == STOP:
            _put_msg(out_ch, data, stop_flag)
            return
        if tag == ERR:
            if not _put_msg(out_ch, data, stop_flag):
                return
            continue
        try:
            value = wire.loads(memoryview(data)[MSG.size :])
            out = target(value)
            payload = MSG.pack(slot, OK) + wire.dumps(out)
        except BaseException as exc:  # noqa: BLE001
            import traceback

            try:
                payload = MSG.pack(slot, ERR) + wire.dumps(
                    TaskError(
                        exc,
                        name,
                        traceback_str=traceback.format_exc()[-4096:],
                    )
                )
            except Exception:  # noqa: BLE001 - unpicklable cause
                payload = MSG.pack(slot, ERR) + wire.dumps(
                    TaskError(RuntimeError(repr(exc)[:1024]), name)
                )
        try:
            ok = _put_msg(out_ch, payload, stop_flag)
        except ValueError:
            # result exceeds the ring capacity: this execution fails, the
            # pipeline survives — send a guaranteed-to-fit marker instead
            ok = _put_msg(
                out_ch,
                MSG.pack(slot, ERR)
                + wire.dumps(
                    TaskError(
                        RuntimeError(
                            f"result of {name} exceeds the pipeline ring "
                            "capacity; raise pipeline_buffer_bytes"
                        ),
                        name,
                    )
                ),
                stop_flag,
            )
        if not ok:
            return


class PipelineRef:
    """Handle to one pipeline execution's result.

    ``get()`` deserializes lazily in the CALLER's thread (the wire path
    never runs per-item unpickling) and transparently follows the eager
    spillback ref when the pipeline broke under this execution."""

    __slots__ = ("_entry",)

    def __init__(self, entry: dict):
        self._entry = entry

    def get(self, timeout: Optional[float] = None) -> Any:
        entry = self._entry
        deadline = None if timeout is None else time.monotonic() + timeout
        if not entry["ev"].wait(timeout):
            raise GetTimeoutError("pipeline execution timed out")
        eager = entry.get("eager")
        if eager is not None:
            import ray_tpu_torch

            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            return ray_tpu_torch.get(eager, timeout=remaining)
        if "err" in entry:
            raise entry["err"]
        if "val" in entry:
            return entry["val"]
        from ray_tpu_torch.cluster import serialization as wire

        data = entry["data"]
        value = wire.loads(memoryview(data)[MSG.size :])
        if entry["tag"] == ERR:
            raise value
        return value

    def __repr__(self) -> str:
        return f"PipelineRef(done={self._entry['ev'].is_set()})"


class CompiledPipeline:
    """A frozen stage chain over pre-pinned shm rings (see module doc)."""

    def __init__(
        self,
        actors: Sequence[Any],
        stages: Sequence[Any],
        *,
        buffer_size_bytes: Optional[int] = None,
        max_inflight: Optional[int] = None,
        name: Optional[str] = None,
    ):
        if not actors:
            raise ValueError("compile_pipeline needs at least one actor")
        if not stages:
            raise ValueError("compile_pipeline needs at least one stage")
        for st in stages:
            if not callable(st) and not isinstance(st, str):
                raise TypeError(
                    "stages must be callables or actor-method names"
                )
        self._actors = list(actors)
        self._stages = list(stages)
        self._buffer = int(buffer_size_bytes or cfg.pipeline_buffer_bytes)
        self._max_inflight = int(max_inflight or cfg.pipeline_max_inflight)
        self._stall_s = float(cfg.pipeline_stall_s)
        self._name = name or f"pipe-{uuid.uuid4().hex[:8]}"
        self._pipe_id = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        # the input ring is SPSC: rtpu_ring_write's reserve is single-
        # producer by design (and the GIL drops during the C call), so
        # concurrent submit()/teardown() writers must serialize here
        self._write_lock = threading.Lock()
        self._sem = threading.Semaphore(self._max_inflight)
        self._pending: Dict[int, dict] = {}
        self._next_slot = 0
        self._broken: Optional[str] = None
        self._torn_down = False
        self._stop = threading.Event()
        self._last_progress = time.monotonic()
        self._submitted = 0
        self._completed = 0
        self._respilled = 0
        self._eager_submitted = 0
        self._shm_paths: List[str] = []
        self._installed: List[tuple] = []  # (agent client, actor_id)
        self._stage_workers: List[tuple] = []  # (agent, actor_id, address)
        self._eager_fns: Dict[int, Any] = {}
        self._threads: List[threading.Thread] = []
        self._channels: List[Any] = []

        from ray_tpu_torch.cluster.client import RemoteActorHandle

        remote_flags = [
            isinstance(a, RemoteActorHandle) for a in self._actors
        ]
        if any(remote_flags) and not all(remote_flags):
            raise ValueError(
                "compile_pipeline: actors must be all-cluster or all-local"
            )
        self._remote = all(remote_flags)
        if self._remote:
            self._setup_remote()
        else:
            self._setup_local()
        collector = threading.Thread(
            target=self._collect_remote if self._remote else self._collect_local,
            name=f"pipe-{self._pipe_id[:6]}-collect",
            daemon=True,
        )
        self._threads.append(collector)
        collector.start()
        _PIPELINES.add(self)

    # -- setup ---------------------------------------------------------
    def _stage_actor(self, i: int):
        return self._actors[i % len(self._actors)]

    def _setup_remote(self) -> None:
        from ray_tpu_torch.cluster.client import _ship_module_by_value

        runtime = self._actors[0]._runtime
        n = len(self._stages)
        paths = [
            ring_path(f"pipe_{self._pipe_id}_{k}") for k in range(n + 1)
        ]
        self._shm_paths = list(paths)
        for p in paths:
            ShmChannel(p, capacity=self._buffer, create=True).close()
        # group stage programs per hosting actor: ONE install RPC per
        # actor covers all of its stages (AOT — nothing re-ships later)
        per_actor: Dict[str, List[dict]] = {}
        actor_handle: Dict[str, Any] = {}
        for i, st in enumerate(self._stages):
            handle = self._stage_actor(i)
            aid = handle._actor_id
            actor_handle[aid] = handle
            if callable(st):
                _ship_module_by_value(st)
                prog = {"stage": i, "fn_blob": cloudpickle.dumps(st)}
            else:
                prog = {"stage": i, "method": st}
            prog.update(
                in_path=paths[i],
                out_path=paths[i + 1],
                capacity=self._buffer,
            )
            per_actor.setdefault(aid, []).append(prog)
        for aid, programs in per_actor.items():
            handle = actor_handle[aid]
            info = runtime.wait_actor_alive(handle, timeout=60.0)
            agent = runtime._agent(info.node_id, info.address)
            agent.call(
                "PipelineInstall",
                {
                    "actor_id": aid,
                    "pipe_id": self._pipe_id,
                    "programs": programs,
                },
                timeout=60.0,
            )
            self._installed.append((agent, aid))
            # remember each stage worker's address: the stall probe
            # distinguishes a slow stage (same worker, keep waiting) from
            # a dead/restarted one (rings are gone — break + respill)
            reply = agent.call(
                "ActorWorkerAddress", {"actor_id": aid}, timeout=10.0
            )
            self._stage_workers.append((agent, aid, reply["address"]))
        self._in = ShmChannel(paths[0], capacity=self._buffer)
        self._out = ShmChannel(paths[-1], capacity=self._buffer)
        self._channels = [self._in, self._out]

    def _setup_local(self) -> None:
        n = len(self._stages)
        chans = [
            LocalChannel(capacity=self._max_inflight) for _ in range(n + 1)
        ]
        self._channels = chans
        self._in = chans[0]
        self._out = chans[-1]
        for i, st in enumerate(self._stages):
            target = self._local_target(i, st)
            t = threading.Thread(
                target=self._run_local_stage,
                args=(target, chans[i], chans[i + 1], f"stage{i}"),
                name=f"pipe-{self._pipe_id[:6]}-s{i}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _local_target(self, i: int, st):
        if callable(st):
            return st
        handle = self._stage_actor(i)
        state = handle._actor_state
        t0 = time.monotonic()
        while not state.alive and time.monotonic() - t0 < 30.0:
            time.sleep(0.005)
        if not state.alive:
            raise RuntimeError("actor did not become alive for pipeline")
        instance = state.instance
        lock = getattr(state, "dag_lock", None)
        if lock is None:
            lock = state.dag_lock = threading.Lock()
        method = st

        def target(x, _inst=instance, _lock=lock, _m=method):
            with _lock:
                return getattr(_inst, _m)(x)

        return target

    def _run_local_stage(self, target, in_ch, out_ch, name: str) -> None:
        while not self._stop.is_set():
            try:
                slot, (tag, value) = in_ch.get(timeout=0.5)
            except ChannelTimeout:
                continue
            if tag == STOP:
                out_ch.put(slot, (STOP, None))
                return
            if tag == ERR:
                out_ch.put(slot, (ERR, value))
                continue
            try:
                out = target(value)
                out_ch.put(slot, (OK, out))
            except BaseException as exc:  # noqa: BLE001
                import traceback

                out_ch.put(
                    slot,
                    (
                        ERR,
                        TaskError(
                            exc, name, traceback_str=traceback.format_exc()
                        ),
                    ),
                )

    # -- driver API ----------------------------------------------------
    def submit(self, value: Any) -> PipelineRef:
        """Admit one execution (backpressured at ``max_inflight``)."""
        if self._torn_down:
            raise RuntimeError("compiled pipeline has been torn down")
        if self._broken:
            return self._submit_eager(value)
        if self._remote:
            from ray_tpu_torch.cluster import serialization as wire

            frame = wire.dumps(value)
        else:
            frame = value
        self._sem.acquire()
        with self._lock:
            if self._broken or self._torn_down:
                self._sem.release()
                broken = True
            else:
                broken = False
                slot = self._next_slot & 0xFFFFFFFF
                self._next_slot += 1
                entry: dict = {"ev": threading.Event(), "frame": frame}
                self._pending[slot] = entry
                self._submitted += 1
                _dark_counters.block().add(_C_SUBMITTED)
        if broken:
            return self._submit_eager(value)
        if not self._remote:
            self._in.put(slot, (OK, value))
            return PipelineRef(entry)
        msg = MSG.pack(slot, OK) + frame
        while True:
            try:
                with self._write_lock:
                    self._in.put_bytes(msg, timeout=0.5)
                return PipelineRef(entry)
            except ChannelTimeout:
                if self._broken or self._torn_down or self._stop.is_set():
                    break
            except ValueError:
                # input larger than the ring: THIS execution goes eager,
                # the pipeline stays up
                break
            except (ChannelClosed, OSError):
                self._break("input ring closed")
                break
        self._resolve_eager(slot)
        return PipelineRef(entry)

    def map(self, values: Sequence[Any]) -> List[PipelineRef]:
        """Submit a window of executions; results stream back in order."""
        return [self.submit(v) for v in values]

    execute = submit  # CompiledDAG-compatible spelling

    # -- collectors ----------------------------------------------------
    def _collect_remote(self) -> None:
        while not self._stop.is_set():
            try:
                data = self._out.get_bytes(timeout=0.25)
            except ChannelTimeout:
                self._check_stall()
                continue
            except (ChannelClosed, OSError):
                if not self._stop.is_set():
                    self._break("result ring closed")
                return
            slot, tag = MSG.unpack_from(data)
            if tag == STOP:
                return
            self._last_progress = time.monotonic()
            with self._lock:
                entry = self._pending.pop(slot, None)
            if entry is None:
                continue  # already respilled by a break
            entry.pop("frame", None)  # free the retained input
            entry["tag"] = tag
            entry["data"] = data
            entry["ev"].set()
            self._sem.release()
            self._completed += 1
            _dark_counters.block().add(_C_COMPLETED)

    def _collect_local(self) -> None:
        while not self._stop.is_set():
            try:
                slot, (tag, value) = self._out.get(timeout=0.5)
            except ChannelTimeout:
                continue
            if tag == STOP:
                return
            with self._lock:
                entry = self._pending.pop(slot, None)
            if entry is None:
                continue
            entry.pop("frame", None)
            if tag == ERR:
                entry["err"] = value
            else:
                entry["val"] = value
            entry["ev"].set()
            self._sem.release()
            self._completed += 1
            _dark_counters.block().add(_C_COMPLETED)

    # -- failure handling ----------------------------------------------
    def _check_stall(self) -> None:
        with self._lock:
            owed = len(self._pending)
        if not owed or self._broken:
            return
        quiet = time.monotonic() - self._last_progress
        budget = self._stall_s * min(owed, 10)
        if quiet <= budget:
            return
        if self._probe_healthy():
            # every stage worker is the SAME live process we installed
            # into: the pipeline is slow, not dead — keep waiting
            self._last_progress = time.monotonic()
            return
        self._break("stage worker died or restarted")

    def _probe_healthy(self) -> bool:
        for agent, aid, addr in self._stage_workers:
            try:
                reply = agent.call(
                    "ActorWorkerAddress", {"actor_id": aid}, timeout=5.0
                )
            except Exception:  # noqa: BLE001 - agent/actor gone
                return False
            if reply.get("address") != addr:
                return False  # restarted: installed programs are gone
        return True

    def _break(self, reason: str) -> None:
        """Spill every unresolved execution back to the eager task path
        (zero acked loss: inputs were retained as frames)."""
        with self._lock:
            if self._broken is not None:
                return
            self._broken = reason
            slots = list(self._pending.keys())
        if slots:
            logger.warning(
                "pipeline %s broken (%s): respilling %d executions to the "
                "eager path",
                self._name,
                reason,
                len(slots),
            )
        for slot in slots:
            self._resolve_eager(slot)

    def _resolve_eager(self, slot: int) -> None:
        """Re-route ONE unresolved slot through the eager path. Pops the
        pending entry — whoever pops wins, so a racing ring completion
        can never double-resolve."""
        with self._lock:
            entry = self._pending.pop(slot, None)
        if entry is None:
            return
        frame = entry.pop("frame", None)
        try:
            if self._remote:
                from ray_tpu_torch.cluster import serialization as wire

                value = wire.loads(frame)
            else:
                value = frame
            ref = self._eager_chain(value)
            entry["eager"] = ref
        except BaseException as exc:  # noqa: BLE001
            entry["err"] = TaskError(exc, self._name)
        self._respilled += 1
        _dark_counters.block().add(_C_RESPILLED)
        entry["ev"].set()
        self._sem.release()

    def _submit_eager(self, value: Any) -> PipelineRef:
        entry: dict = {"ev": threading.Event()}
        try:
            entry["eager"] = self._eager_chain(value)
        except BaseException as exc:  # noqa: BLE001
            entry["err"] = TaskError(exc, self._name)
        entry["ev"].set()
        return PipelineRef(entry)

    def _eager_chain(self, value: Any):
        """Re-execute the stage chain through the normal execution plane:
        function stages as stateless tasks (safe regardless of actor
        fate), method stages as actor calls. Returns the tail ref (local
        mode: computes inline and returns the value via a resolved
        entry)."""
        if not self._remote:
            cur = value
            for i, st in enumerate(self._stages):
                target = st if callable(st) else self._local_target(i, st)
                cur = target(cur)
            # local mode has no ObjectRef plumbing here: resolve inline
            import ray_tpu_torch

            return ray_tpu_torch.put(cur)
        import ray_tpu_torch

        self._eager_submitted += 1
        cur: Any = value
        for i, st in enumerate(self._stages):
            if callable(st):
                f = self._eager_fns.get(i)
                if f is None:
                    f = ray_tpu_torch.remote(st).options(
                        num_cpus=0.25, max_retries=1
                    )
                    self._eager_fns[i] = f
                cur = f.remote(cur)
            else:
                cur = getattr(self._stage_actor(i), st).remote(cur)
        return cur

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            inflight = len(self._pending)
        out = {
            "name": self._name,
            "pipe_id": self._pipe_id,
            "stages": len(self._stages),
            "remote": self._remote,
            "inflight": inflight,
            "submitted": self._submitted,
            "completed": self._completed,
            "respilled": self._respilled,
            "eager_submitted": self._eager_submitted,
            "broken": self._broken,
        }
        if self._remote and not self._torn_down:
            try:
                out["in_ring_fill"] = round(
                    self._in.used() / max(1, self._in._cap), 4
                )
                out["out_ring_fill"] = round(
                    self._out.used() / max(1, self._out._cap), 4
                )
            except Exception:  # noqa: BLE001 - closing under us
                pass
        return out

    # -- teardown ------------------------------------------------------
    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        # drain: a STOP with slot 0 sweeps through every stage in order
        try:
            if self._remote:
                with self._write_lock:
                    self._in.put_bytes(MSG.pack(0, STOP), timeout=1.0)
                self._in.close_write()
            else:
                self._in.put(0, (STOP, None), timeout=1.0)
        except Exception:  # noqa: BLE001 - full/closed ring
            pass
        for agent, aid in self._installed:
            try:
                agent.call(
                    "PipelineTeardown",
                    {"actor_id": aid, "pipe_id": self._pipe_id},
                    timeout=10.0,
                )
            except Exception:  # noqa: BLE001
                pass
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3.0)
        # unresolved executions at teardown fail, not hang — and each
        # releases its admission slot, or a submitter parked in
        # _sem.acquire() would deadlock past teardown
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for entry in pending:
            entry.setdefault(
                "err", RuntimeError("pipeline torn down mid-execution")
            )
            entry.pop("frame", None)
            entry["ev"].set()
            self._sem.release()
        for ch in self._channels:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
        # unlink exactly-once (pop-as-you-go; the agent-start orphan
        # sweep covers SIGKILLed drivers)
        while self._shm_paths:
            p = self._shm_paths.pop()
            try:
                os.unlink(p)
            except OSError:
                pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass


def compile_pipeline(
    actors: Sequence[Any],
    stages: Sequence[Any],
    *,
    buffer_size_bytes: Optional[int] = None,
    max_inflight: Optional[int] = None,
    name: Optional[str] = None,
) -> CompiledPipeline:
    """Compile an actor pipeline ahead of time (see module docstring).

    ``actors``: the hosting pool — stage ``i`` runs in the worker of
    ``actors[i % len(actors)]``. ``stages``: callables (shipped by value
    at compile time, applied as ``fn(x)``) or actor-method name strings
    (applied as ``getattr(actor, name)(x)`` under the actor's DAG lock).
    """
    return CompiledPipeline(
        actors,
        stages,
        buffer_size_bytes=buffer_size_bytes,
        max_inflight=max_inflight,
        name=name,
    )
