"""Compiled DAG: a frozen task graph executed over pre-allocated channels.

The capability analog of the reference's accelerated DAG
(Ray's python/ray/dag/compiled_dag_node.py +
experimental/channel/shared_memory_channel.py): compile once, then drive
repeated executions through per-edge channels with NO per-call scheduler
round trip. Multiple inputs are admitted concurrently and pipeline across
stages — input k+1 enters stage 1 while input k is in stage 2.

Execution substrate by runtime:

- **Local runtime**: every MethodNode/FunctionNode gets a dedicated driver
  -process executor thread bound to the actor instance; edges are
  ``LocalChannel``s passing objects by reference, so CUDA tensors
  cross edges without leaving the card.
- **Cluster runtime**: MethodNode executors are *installed into the worker
  process hosting the actor* (agent ``DagInstall`` RPC); edges between
  cluster actors are native shm rings (ray_tpu_torch/native/ring.cc) — a method
  result reaches the next actor via one futex-woken mmap write, bypassing
  head, agent, and object store entirely. FunctionNodes and input/output
  fan-in/out run on the driver, bridging the same rings.

Error markers and STOP sentinels flow through the data edges themselves,
so failures surface in execution order and teardown drains in topological
order (the reference's channel-close semantics). A node whose args are all
constants still fires once per execution via a synthetic "tick" edge from
the input.

Port of ``ray_tpu/dag/compiled.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core.object_store import GetTimeoutError, TaskError

from .channel import (
    ERR,
    OK,
    STOP,
    ChannelClosed,
    ChannelTimeout,
    LocalChannel,
    ShmChannel,
    channel_dir,
)

from ray_tpu_torch.config import cfg

_DEFAULT_BUFFER = cfg.dag_buffer_bytes  # 4 MiB per edge ring by default
_DEFAULT_INFLIGHT = cfg.dag_max_inflight
_TICK = -1  # synthetic input index: driver writes None once per execute


class _Edge:
    __slots__ = ("idx", "producer", "consumer", "slot", "channel", "path")

    def __init__(self, idx: int, producer, consumer, slot):
        self.idx = idx
        self.producer = producer  # DAGNode id or "input"
        self.consumer = consumer  # DAGNode id or "driver"
        self.slot = slot  # ("arg", i) | ("kw", name) | ("out", k) | ("tick",)
        self.channel = None
        self.path: Optional[str] = None


def _collect(root):
    """Topological node list + output order from a bound DAG."""
    from .dag import DAGNode, FunctionNode, MethodNode, MultiOutputNode

    outputs = root.outputs if isinstance(root, MultiOutputNode) else [root]
    nodes: Dict[int, Any] = {}
    order: List[Any] = []

    def visit(n):
        if id(n) in nodes:
            return
        nodes[id(n)] = n
        if isinstance(n, (MethodNode, FunctionNode)):
            for a in n.args:
                if isinstance(a, DAGNode):
                    visit(a)
            for v in n.kwargs.values():
                if isinstance(v, DAGNode):
                    visit(v)
        elif isinstance(n, MultiOutputNode):
            raise ValueError("MultiOutputNode must be the DAG root")
        order.append(n)

    for o in outputs:
        visit(o)
    return outputs, nodes, order


def run_dag_stage(
    target,
    in_channels: Dict[tuple, Any],
    out_channels: List[Any],
    consts_args: list,
    consts_kwargs: dict,
    stop_flag: threading.Event,
    name: str = "dag_node",
) -> None:
    """The stage loop shared by driver-side and worker-side executors:
    read one tagged item per in-edge, fire the target, fan the result out.
    STOP propagates and exits; ERR markers skip compute and propagate. Every
    blocking channel operation re-checks stop_flag on a short timeout so
    teardown can always reclaim the thread (a producer parked forever on a
    full ring would otherwise outlive its channels)."""

    def put_checked(ch, tag, value) -> bool:
        converted = False
        while True:
            try:
                ch.put(tag, value, timeout=0.5)
                return True
            except ChannelTimeout:
                if stop_flag.is_set():
                    return False
            except (ChannelClosed, OSError):
                return False
            except Exception as exc:  # noqa: BLE001
                # Serialization failure — oversized for the ring capacity,
                # unpicklable result, codec error. This execution fails but
                # the stage loop must survive: degrade to an ERR marker
                # whose cause is a plain string (guaranteed to serialize,
                # truncated so it always fits the ring) and resend — once.
                # If even the safe marker won't go through, the channel is
                # unusable: give up rather than spin.
                if converted or stop_flag.is_set():
                    return False
                converted = True
                import traceback

                tag = ERR
                value = TaskError(
                    RuntimeError(
                        f"result of {name} could not be sent: "
                        + repr(exc)[:2048]
                    ),
                    name,
                    traceback_str=traceback.format_exc()[-2048:],
                )

    while not stop_flag.is_set():
        try:
            items: Dict[tuple, tuple] = {}
            stopped = False
            for slot, ch in in_channels.items():
                while True:
                    try:
                        items[slot] = ch.get(timeout=0.5)
                        break
                    except ChannelTimeout:
                        if stop_flag.is_set():
                            return
                    except ValueError as exc:
                        # corrupt frame: this execution fails, the
                        # pipeline survives
                        items[slot] = (
                            ERR,
                            TaskError(exc, name, traceback_str=str(exc)),
                        )
                        break
                if items[slot][0] == STOP:
                    stopped = True
                    break
            if stopped:
                for ch in out_channels:
                    put_checked(ch, STOP, None)
                return
            err = next((v for t, v in items.values() if t == ERR), None)
            if err is not None:
                for ch in out_channels:
                    if not put_checked(ch, ERR, err):
                        return
                continue
            args = [
                items[("arg", i)][1] if ("arg", i) in items else a
                for i, a in enumerate(consts_args)
            ]
            kwargs = {
                k: items[("kw", k)][1] if ("kw", k) in items else v
                for k, v in consts_kwargs.items()
            }
            try:
                out = target(*args, **kwargs)
                tag, payload = OK, out
            except BaseException as exc:  # noqa: BLE001
                import traceback

                tag = ERR
                payload = TaskError(
                    exc, name, traceback_str=traceback.format_exc()
                )
            for ch in out_channels:
                if not put_checked(ch, tag, payload):
                    return
        except (ChannelClosed, OSError):
            return


class CompiledDAGRef:
    """Handle to one execution's result (reference: CompiledDAGRef).

    ``get()`` blocks until this execution's outputs arrive (results are
    collected in execution order by a background collector, so out-of-order
    gets just wait). A ref whose execution errored re-raises the stage's
    exception, with the remote traceback attached."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._consumed = False

    def get(self, timeout: Optional[float] = None) -> Any:
        if self._consumed:
            raise ValueError("CompiledDAGRef results can only be read once")
        self._consumed = True
        return self._dag._read_result(self._idx, timeout)

    def __repr__(self) -> str:
        return f"CompiledDAGRef(execution={self._idx})"


class CompiledDAG:
    def __init__(
        self,
        root,
        *,
        buffer_size_bytes: int = _DEFAULT_BUFFER,
        max_inflight: int = _DEFAULT_INFLIGHT,
    ):
        from .dag import FunctionNode, InputNode, MethodNode

        self._root = root
        self._buffer = buffer_size_bytes
        self._dag_id = uuid.uuid4().hex[:12]
        self._outputs, self._nodes, self._order = _collect(root)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_submit = 0
        self._collected = 0  # rows fully gathered (execution order)
        self._results: Dict[int, list] = {}
        self._max_inflight = max_inflight
        self._inflight = threading.Semaphore(max_inflight)
        self._torn_down = False
        self._threads: List[threading.Thread] = []
        self._stop_flag = threading.Event()
        self._installed: List[tuple] = []  # (agent RpcClient, actor_id)
        self._shm_paths: List[str] = []

        # classify execution mode from the actor handles involved
        self._remote = False
        for n in self._order:
            if isinstance(n, MethodNode):
                try:
                    from ray_tpu_torch.cluster.client import RemoteActorHandle

                    if isinstance(n.handle, RemoteActorHandle):
                        self._remote = True
                        break
                except ImportError:  # pragma: no cover
                    break

        # ---- build edges ------------------------------------------------
        self._edges: List[_Edge] = []
        self._in_edges: Dict[int, Dict[tuple, _Edge]] = {}
        self._out_edges: Dict[Any, List[_Edge]] = {}
        self._input_edges: List[Tuple[int, _Edge]] = []  # (input index, edge)

        def add_edge(producer_key, consumer_key, slot) -> _Edge:
            e = _Edge(len(self._edges), producer_key, consumer_key, slot)
            self._edges.append(e)
            self._out_edges.setdefault(producer_key, []).append(e)
            if consumer_key != "driver":
                self._in_edges.setdefault(consumer_key, {})[slot] = e
            return e

        for n in self._order:
            if not isinstance(n, (MethodNode, FunctionNode)):
                continue
            for i, a in enumerate(n.args):
                if isinstance(a, InputNode):
                    e = add_edge("input", id(n), ("arg", i))
                    self._input_edges.append((a.index, e))
                elif hasattr(a, "_eval"):
                    add_edge(id(a), id(n), ("arg", i))
            for k, v in n.kwargs.items():
                if isinstance(v, InputNode):
                    e = add_edge("input", id(n), ("kw", k))
                    self._input_edges.append((v.index, e))
                elif hasattr(v, "_eval"):
                    add_edge(id(v), id(n), ("kw", k))
            if id(n) not in self._in_edges:
                # all-const node: synthetic tick so it fires once per execute
                e = add_edge("input", id(n), ("tick",))
                self._input_edges.append((_TICK, e))
        # output edges, in declared order
        self._output_edges: List[Optional[_Edge]] = []
        self._output_input_indexes: Dict[int, int] = {}  # out slot -> input idx
        for k, o in enumerate(self._outputs):
            if isinstance(o, InputNode):
                # degenerate passthrough output: short-circuit at the driver
                self._output_edges.append(None)
                self._output_input_indexes[k] = o.index
            else:
                self._output_edges.append(add_edge(id(o), "driver", ("out", k)))

        self._real_outputs = [e for e in self._output_edges if e is not None]
        self._required_args = 1 + max(
            [i for i, _ in self._input_edges if i != _TICK]
            + list(self._output_input_indexes.values())
            + [-1]
        )
        self._submit_lock = threading.Lock()
        self._broken: Optional[str] = None
        if self._remote:
            self._setup_remote()
        else:
            self._setup_local()
        if self._real_outputs:
            t = threading.Thread(
                target=self._collector_loop,
                name=f"dag-{self._dag_id}-collect",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------------------
    # local mode
    # ------------------------------------------------------------------
    def _setup_local(self) -> None:
        from .dag import FunctionNode, MethodNode

        for e in self._edges:
            e.channel = LocalChannel(capacity=self._max_inflight)
        for n in self._order:
            if isinstance(n, MethodNode):
                target = self._local_method_target(n)
                name = n.method
            elif isinstance(n, FunctionNode):
                target = n.fn._fn
                name = n.fn._fn.__name__
            else:
                continue
            self._start_stage_thread(n, target, name)

    def _start_stage_thread(self, n, target, name: str) -> None:
        in_chs = {
            slot: e.channel for slot, e in self._in_edges.get(id(n), {}).items()
        }
        out_chs = [e.channel for e in self._out_edges.get(id(n), [])]
        t = threading.Thread(
            target=run_dag_stage,
            args=(
                target,
                in_chs,
                out_chs,
                list(getattr(n, "args", ())),
                dict(getattr(n, "kwargs", {})),
                self._stop_flag,
                name,
            ),
            name=f"dag-{self._dag_id}-{name}",
            daemon=True,
        )
        self._threads.append(t)
        t.start()

    def _local_method_target(self, n):
        import asyncio
        import inspect
        import time

        state = n.handle._actor_state
        t0 = time.monotonic()
        while not state.alive and time.monotonic() - t0 < 30.0:
            time.sleep(0.005)
        if not state.alive:
            raise RuntimeError("actor did not become alive for compiled DAG")
        instance = state.instance
        method = n.method
        # compiled-DAG calls and normal .remote() calls on the same actor
        # are mediated by one per-actor lock (the reference pins the actor's
        # loop to the DAG; here both paths stay usable, serialized)
        lock = getattr(state, "dag_lock", None)
        if lock is None:
            lock = state.dag_lock = threading.Lock()
        loop = state._loop  # set for asyncio actors

        def target(*a, **kw):
            from ray_tpu_torch.core.object_store import should_await

            with lock:
                out = getattr(instance, method)(*a, **kw)
            if should_await(out):
                async def _awrap(aw=out):
                    return await aw

                if loop is not None:
                    return asyncio.run_coroutine_threadsafe(
                        _awrap(), loop
                    ).result()
                return asyncio.new_event_loop().run_until_complete(_awrap())
            return out

        return target

    # ------------------------------------------------------------------
    # cluster mode
    # ------------------------------------------------------------------
    def _setup_remote(self) -> None:
        from .dag import FunctionNode, MethodNode

        from .channel import ring_path

        for e in self._edges:
            # pid-stamped path: a SIGKILLed driver's rings are reaped by
            # the agent-start orphan sweep (sweep_orphan_rings)
            e.path = ring_path(f"{self._dag_id}_{e.idx}")
            self._shm_paths.append(e.path)
            ch = ShmChannel(e.path, capacity=self._buffer, create=True)
            ch.close()  # just materialize + size the ring file

        method_nodes = [n for n in self._order if isinstance(n, MethodNode)]
        driver_nodes = [n for n in self._order if isinstance(n, FunctionNode)]

        # install actor-side programs (grouped per actor: one RPC covers all
        # of an actor's nodes)
        runtime = method_nodes[0].handle._runtime
        per_actor: Dict[str, List[Any]] = {}
        for n in method_nodes:
            per_actor.setdefault(n.handle._actor_id, []).append(n)
        for actor_id, nodes in per_actor.items():
            handle = nodes[0].handle
            info = runtime.wait_actor_alive(handle, timeout=60.0)
            programs = []
            for n in nodes:
                in_edges = self._in_edges.get(id(n), {})
                arg_spec = []
                for i, a in enumerate(n.args):
                    if ("arg", i) in in_edges:
                        arg_spec.append(("chan", in_edges[("arg", i)].path))
                    else:
                        arg_spec.append(("const", cloudpickle.dumps(a)))
                kw_spec = {}
                for k, v in n.kwargs.items():
                    if ("kw", k) in in_edges:
                        kw_spec[k] = ("chan", in_edges[("kw", k)].path)
                    else:
                        kw_spec[k] = ("const", cloudpickle.dumps(v))
                tick = in_edges.get(("tick",))
                programs.append(
                    {
                        "node_id": str(id(n)),
                        "method": n.method,
                        "args": arg_spec,
                        "kwargs": kw_spec,
                        "tick_path": tick.path if tick is not None else None,
                        "out_paths": [
                            e.path for e in self._out_edges.get(id(n), [])
                        ],
                        "capacity": self._buffer,
                    }
                )
            agent = runtime._agent(info.node_id, info.address)
            agent.call(
                "DagInstall",
                {
                    "actor_id": actor_id,
                    "dag_id": self._dag_id,
                    "programs": programs,
                },
                timeout=60.0,
            )
            self._installed.append((agent, actor_id))

        # driver-run stages (FunctionNodes) bridge the rings locally
        for n in driver_nodes:
            for slot, e in self._in_edges.get(id(n), {}).items():
                e.channel = ShmChannel(e.path, capacity=self._buffer)
            for e in self._out_edges.get(id(n), []):
                if e.channel is None:
                    e.channel = ShmChannel(e.path, capacity=self._buffer)
            self._start_stage_thread(n, n.fn._fn, n.fn._fn.__name__)
        # driver ends: input writers + output readers
        for _, e in self._input_edges:
            if e.channel is None:
                e.channel = ShmChannel(e.path, capacity=self._buffer)
        for e in self._real_outputs:
            if e.channel is None:
                e.channel = ShmChannel(e.path, capacity=self._buffer)

    # ------------------------------------------------------------------
    # result collection
    # ------------------------------------------------------------------
    def _collector_loop(self) -> None:
        row_idx = 0
        while not self._stop_flag.is_set():
            row_vals: Dict[int, tuple] = {}
            for k, e in enumerate(self._output_edges):
                if e is None:
                    continue
                while True:
                    try:
                        item = e.channel.get(timeout=0.5)
                        break
                    except ChannelTimeout:
                        if self._stop_flag.is_set():
                            return
                    except (ChannelClosed, OSError):
                        return
                if item[0] == STOP:
                    return
                row_vals[k] = item
            with self._cv:
                row = self._results.setdefault(
                    row_idx, [None] * len(self._outputs)
                )
                for k, item in row_vals.items():
                    row[k] = item
                self._collected = row_idx + 1
                self._cv.notify_all()
            row_idx += 1
            self._inflight.release()

    # ------------------------------------------------------------------
    # driver API
    # ------------------------------------------------------------------
    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")
        if self._broken:
            raise RuntimeError(
                f"compiled DAG is broken after a failed execute: {self._broken}"
            )
        if len(args) < self._required_args:
            raise TypeError(
                f"DAG expects {self._required_args} input(s), got {len(args)}"
            )
        # validate + serialize everything BEFORE touching any channel: a
        # failure mid-fan-out would desynchronize every later execution.
        # One input fanning out to k edges serializes once, not k times.
        payloads: List[tuple] = []
        encoded: Dict[int, bytes] = {}
        for input_idx, e in self._input_edges:
            value = None if input_idx == _TICK else args[input_idx]
            if isinstance(e.channel, ShmChannel):
                data = encoded.get(input_idx)
                if data is None:
                    data = bytes([OK]) + cloudpickle.dumps(value)
                    encoded[input_idx] = data
                if len(data) + 4 > e.channel._cap:
                    raise ValueError(
                        f"input of {len(data)} bytes exceeds ring capacity "
                        f"{e.channel._cap}; pass a larger buffer_size_bytes "
                        f"to experimental_compile()"
                    )
                payloads.append((e, data, True))
            else:
                payloads.append((e, value, False))
        self._inflight.acquire()
        # one submitter at a time: concurrent fan-outs would interleave
        # execution rows across edges
        with self._submit_lock:
            with self._cv:
                idx = self._next_submit
                self._next_submit += 1
                if self._output_input_indexes:
                    row = self._results.setdefault(
                        idx, [None] * len(self._outputs)
                    )
                    for k, input_idx in self._output_input_indexes.items():
                        row[k] = (OK, args[input_idx])
                released = not self._real_outputs
                if released:
                    # every output is an input passthrough: done immediately
                    self._collected = idx + 1
                    self._cv.notify_all()
                    self._inflight.release()
            try:
                for e, p, is_bytes in payloads:
                    if is_bytes:
                        e.channel.put_bytes(p)
                    else:
                        e.channel.put(OK, p)
            except BaseException as exc:  # noqa: BLE001
                # channels are now desynchronized; poison the DAG rather
                # than silently mis-pairing every later execution
                self._broken = repr(exc)
                if not released:
                    self._inflight.release()
                raise
        return CompiledDAGRef(self, idx)

    def _read_result(self, idx: int, timeout: Optional[float]) -> Any:
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while idx >= self._collected:
                if self._torn_down:
                    raise RuntimeError("compiled DAG torn down mid-execution")
                wait = 0.5
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        raise GetTimeoutError(
                            f"compiled DAG execution {idx} timed out"
                        )
                self._cv.wait(timeout=wait)
            row = self._results.pop(idx)
        for item in row:
            if item[0] == ERR:
                raise item[1]
        values = [v for _, v in row]
        return values if len(self._outputs) > 1 else values[0]

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        # the SPSC rings allow ONE writer: take the submit lock so the STOP
        # writes cannot interleave with an in-flight execute() fan-out. But
        # never block teardown behind a stuck submitter (e.g. execute()
        # parked on a full ring whose stage died): on timeout, skip the
        # STOPs — close_write below wakes the parked writer (ChannelClosed)
        # and stops consumers, which is teardown enough.
        locked = self._submit_lock.acquire(timeout=2.0)
        try:
            if locked:
                for _, e in self._input_edges:
                    try:
                        if e.channel is not None:
                            e.channel.put(STOP, None, timeout=1.0)
                    except (ChannelTimeout, ChannelClosed, OSError, ValueError):
                        pass
            for _, e in self._input_edges:
                try:
                    if e.channel is not None:
                        e.channel.close_write()
                except Exception:  # noqa: BLE001
                    pass
        finally:
            if locked:
                self._submit_lock.release()
        for agent, actor_id in self._installed:
            try:
                agent.call(
                    "DagTeardown",
                    {"actor_id": actor_id, "dag_id": self._dag_id},
                    timeout=10.0,
                )
            except Exception:  # noqa: BLE001
                pass
        self._stop_flag.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=3.0)
        for e in self._edges:
            if e.channel is not None:
                try:
                    e.channel.close()
                except Exception:  # noqa: BLE001
                    pass
        # unlink exactly-once: teardown is idempotent (_torn_down) but the
        # paths are also popped as they go so no path is ever re-unlinked
        # (a same-named successor ring must not be clobbered)
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
