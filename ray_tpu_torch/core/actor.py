"""Actors: stateful workers with ordered method execution and restarts.

Port of ``ray_tpu/core/actor.py``, copied with its imports rewritten.


Analog of the reference's actor stack (GcsActorManager state machine +
ActorTaskSubmitter ordered queues + TaskReceiver concurrency groups,
/root/reference/src/ray/gcs/actor/, src/ray/core_worker/task_submission/
actor_task_submitter.cc, task_execution/concurrency_group_manager.h).
Creation is centrally scheduled through the same batched kernels as tasks.

Execution model (reference parity):

- **Sync actors**: per-concurrency-group FIFO queues drained by
  ``max_concurrency`` threads per group (default group = 1 thread → strict
  method ordering, like the reference's ordered execution queue).
- **Async actors** (any ``async def`` method): ALL methods multiplex on one
  asyncio event loop owned by the actor (the reference's fiber/asyncio
  mode, core_worker/task_execution/fiber.h); per-group
  ``asyncio.Semaphore``s bound in-flight starts, default 1000 like
  ray_constants DEFAULT_MAX_CONCURRENCY_ASYNC.
- ``concurrency_groups={"io": 2, ...}`` on the class plus
  ``@method(concurrency_group="io")`` route methods to dedicated
  groups so one group saturating can't starve another.

``max_restarts`` drives the restart state machine on node death.
"""
from __future__ import annotations

import asyncio
import inspect
import threading
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .object_store import ObjectRef, TaskError

DEFAULT_MAX_CONCURRENCY_ASYNC = 1000


def _coroutine_method_names(cls: type) -> set:
    names = set()
    for klass in cls.__mro__:
        for name, val in vars(klass).items():
            if inspect.iscoroutinefunction(val):
                names.add(name)
    return names


class ActorUnavailableError(Exception):
    pass


def method(**options):
    """Decorator carrying per-method options (num_returns, ...) — parity
    with ray.method (python/ray/actor.py)."""

    def wrap(fn):
        fn._ray_tpu_method_options = options
        return fn

    return wrap


class ActorState:
    """Server side of one actor instance."""

    def __init__(
        self,
        runtime,
        actor_id: str,
        cls: type,
        ctor_args: tuple,
        ctor_kwargs: dict,
        resources: Dict[str, float],
        *,
        name: Optional[str] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: Optional[int] = None,
        concurrency_groups: Optional[Dict[str, int]] = None,
    ):
        self.runtime = runtime
        self.actor_id = actor_id
        self.cls = cls
        self.ctor_args = ctor_args
        self.ctor_kwargs = ctor_kwargs
        self.resources = resources
        self.name = name
        self.max_restarts = max_restarts
        self.max_task_retries = max_task_retries
        self.is_async = bool(_coroutine_method_names(cls))
        if max_concurrency is None:
            # reference defaults: 1000 for asyncio actors, 1 for threaded
            # (an EXPLICIT max_concurrency=1 on an async actor is honored —
            # it serializes method execution)
            max_concurrency = (
                DEFAULT_MAX_CONCURRENCY_ASYNC if self.is_async else 1
            )
        self.max_concurrency = max_concurrency
        self.concurrency_groups = dict(concurrency_groups or {})
        self.restarts_used = 0
        self.node_id: Optional[str] = None
        self.instance: Any = None
        self.alive = False
        self.dead_forever = False
        self.death_cause: Optional[str] = None
        # sync mode: one FIFO per concurrency group; async mode: one event
        # loop + per-group semaphores. "_default" always exists.
        self._group_limits = {"_default": self.max_concurrency}
        self._group_limits.update(self.concurrency_groups)
        self._queues: Dict[str, deque] = {
            g: deque() for g in self._group_limits
        }
        self._cond = threading.Condition()
        self._threads: List[threading.Thread] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._semaphores: Dict[str, asyncio.Semaphore] = {}
        # async calls started but not yet sealed, keyed by id(call) — the
        # death path and the completion callback race to seal; whoever pops
        # the entry first does it
        self._inflight: Dict[int, dict] = {}
        self._held_req = None  # (node, ResourceRequest) while alive
        # set lazily when a compiled DAG binds this actor: serializes DAG
        # stage calls against normal .remote() method execution
        self.dag_lock: Optional[threading.Lock] = None

    # -- lifecycle ------------------------------------------------------
    def on_created(self, node_id: str, instance: Any, held_req) -> None:
        with self._cond:
            self.node_id = node_id
            self.instance = instance
            self.alive = True
            self._held_req = held_req
            if self.is_async:
                self._start_event_loop()
                # redeliver calls queued while dead/restarting
                for q in self._queues.values():
                    while q:
                        self._dispatch_async(q.popleft())
            else:
                self._threads = [
                    threading.Thread(
                        target=self._run_loop,
                        args=(group,),
                        name=f"actor-{self.actor_id[:6]}-{group}-{i}",
                        daemon=True,
                    )
                    for group, limit in self._group_limits.items()
                    for i in range(max(1, int(limit)))
                ]
                for t in self._threads:
                    t.start()
            self._cond.notify_all()

    def _start_event_loop(self) -> None:
        loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(loop)
            # semaphores must bind to this loop
            self._semaphores = {
                g: asyncio.Semaphore(max(1, int(limit)))
                for g, limit in self._group_limits.items()
            }
            ready.set()
            loop.run_forever()

        self._loop = loop
        self._loop_thread = threading.Thread(
            target=run, name=f"actor-{self.actor_id[:6]}-loop", daemon=True
        )
        self._loop_thread.start()
        ready.wait()

    def mark_died(self, restart: bool) -> None:
        dropped: List[dict] = []
        restarting = False
        with self._cond:
            was_alive = self.alive
            self.alive = False
            self.instance = None
            self._stop_event_loop()
            if restart and self.restarts_used < self.max_restarts:
                restarting = True
                self.restarts_used += 1
                # in-flight calls died with the instance: retry-eligible ones
                # requeue for redelivery after restart, the rest fail now
                # (reference: actor task retries, max_task_retries)
                for call in self._inflight.values():
                    if call["attempt"] < self.max_task_retries:
                        call["attempt"] += 1
                        self._queues[call["group"]].append(call)
                    else:
                        dropped.append(call)
                self._inflight.clear()
                self._cond.notify_all()
            else:
                self.dead_forever = True
                self.death_cause = "killed" if not restart else "node died"
                dropped = [c for q in self._queues.values() for c in q]
                for q in self._queues.values():
                    q.clear()
                dropped.extend(self._inflight.values())
                self._inflight.clear()
                self._cond.notify_all()
        if restarting and was_alive:
            self.runtime._resubmit_actor_creation(self)
        self._seal_dead(
            dropped,
            "restarted mid-call" if restarting else "is dead",
        )

    def _seal_dead(self, calls: List[dict], why: str) -> None:
        from .runtime import ActorDiedError

        for call in calls:
            err = ActorDiedError(f"actor {self.name or self.actor_id} {why}")
            if call.get("stream_tid"):
                # a queued streaming call dies with the actor: end the
                # stream with the error as its final item
                self.runtime._fail_stream(call["stream_tid"], err)
                continue
            for ref in call["returns"]:
                self.runtime.store.seal(ref, err, is_error=True)

    def _stop_event_loop(self) -> None:
        loop = self._loop
        if loop is not None:
            self._loop = None
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass

    def stop(self) -> None:
        self.mark_died(restart=False)

    # -- method invocation ---------------------------------------------
    def submit_method(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        returns: List[ObjectRef],
        stream_tid: Optional[str] = None,
    ) -> None:
        from .runtime import ActorDiedError

        with self._cond:
            if self.dead_forever:
                err = ActorDiedError(
                    f"actor {self.name or self.actor_id} is dead"
                )
                if stream_tid is not None:
                    self.runtime._fail_stream(stream_tid, err)
                for ref in returns:
                    self.runtime.store.seal(ref, err, is_error=True)
                return
            group = self._method_group(method_name)
            call = {
                "method": method_name,
                "args": args,
                "kwargs": kwargs,
                "returns": returns,
                "attempt": 0,
                "group": group,
                "stream_tid": stream_tid,
            }
            if self.is_async and self.alive:
                self._dispatch_async(call)
                return
            self._queues[group].append(call)
            self._cond.notify_all()

    def _method_group(self, method_name: str) -> str:
        fn = getattr(self.cls, method_name, None)
        opts = getattr(fn, "_ray_tpu_method_options", None) or {}
        group = opts.get("concurrency_group", "_default")
        return group if group in self._group_limits else "_default"

    def _run_loop(self, group: str) -> None:
        me = threading.current_thread()
        queue = self._queues[group]
        while True:
            with self._cond:
                while self.alive and not queue:
                    self._cond.wait(timeout=0.5)
                if not self.alive:
                    return
                if me not in self._threads:
                    return  # superseded by a restart generation
                call = queue.popleft()
                instance = self.instance
            self._execute_call(instance, call)

    # -- async execution (asyncio actor mode) ---------------------------
    def _dispatch_async(self, call: dict) -> None:
        """Schedule one method call on the actor's event loop. Caller holds
        self._cond. In-flight starts are bounded per concurrency group by a
        semaphore (reference: max_concurrency / max_concurrency_per_group)."""
        loop = self._loop
        instance = self.instance
        self._inflight[id(call)] = call

        async def run() -> None:
            async with self._semaphores[call["group"]]:
                await self._execute_call_async(instance, call)

        # cheaper than run_coroutine_threadsafe: no wrapping future — the
        # coroutine seals its own refs, nothing awaits the task handle
        loop.call_soon_threadsafe(loop.create_task, run())

    async def _execute_call_async(self, instance: Any, call: dict) -> None:
        from .runtime import get_context

        ctx = get_context()
        ctx.node_id = self.node_id
        ctx.actor_id = self.actor_id
        try:
            args, kwargs = self.runtime._resolve_args(call["args"], call["kwargs"])
            fn = getattr(instance, call["method"])
            result = fn(*args, **kwargs)
            from .object_store import should_await

            if should_await(result):
                result = await result
            self._seal_result(call, result)
        except BaseException as exc:  # noqa: BLE001
            self._seal_failure(call, exc)
        finally:
            ctx.node_id = None
            ctx.actor_id = None

    def _execute_call(self, instance: Any, call: dict) -> None:
        from .runtime import get_context

        ctx = get_context()
        ctx.node_id = self.node_id
        ctx.actor_id = self.actor_id
        try:
            if call.get("stream_tid"):
                # num_returns="streaming" method: the generator drives the
                # runtime's per-item stream machinery; ANY failure —
                # argument resolution included — seals as the final
                # stream item (no per-call retries: a resumed generator
                # cannot replay consumed yields). The dag_lock spans the
                # WHOLE drive: a generator function body runs lazily, so
                # locking only its creation would serialize nothing.
                tid = call["stream_tid"]
                import contextlib

                try:
                    args, kwargs = self.runtime._resolve_args(
                        call["args"], call["kwargs"]
                    )
                    fn = getattr(instance, call["method"])
                    guard = (
                        self.dag_lock
                        if self.dag_lock is not None
                        else contextlib.nullcontext()
                    )
                    with guard:
                        gen = fn(*args, **kwargs)
                        self.runtime.run_actor_stream(
                            tid, self.node_id, gen
                        )
                    self.runtime.metrics["tasks_finished"] += 1
                except BaseException as exc:  # noqa: BLE001
                    err = TaskError(
                        exc, f"{self.cls.__name__}.{call['method']}"
                    )
                    err.__cause__ = exc
                    self.runtime._fail_stream(tid, err)
                    self.runtime.metrics["tasks_failed"] += 1
                return
            args, kwargs = self.runtime._resolve_args(call["args"], call["kwargs"])
            fn = getattr(instance, call["method"])
            lock = self.dag_lock
            if lock is not None:
                with lock:
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            self._seal_result(call, result)
        except BaseException as exc:  # noqa: BLE001
            self._seal_failure(call, exc)
        finally:
            ctx.node_id = None
            ctx.actor_id = None

    def _take_ownership(self, call: dict) -> bool:
        """Async mode: completion and the death path race to seal the same
        refs; whoever pops the in-flight entry owns them."""
        if not self.is_async:
            return True
        with self._cond:
            return self._inflight.pop(id(call), None) is not None

    def _seal_result(self, call: dict, result: Any) -> None:
        if not self._take_ownership(call):
            return
        refs = call["returns"]
        values = [result] if len(refs) == 1 else tuple(result)
        node = self.runtime.nodes.get(self.node_id)
        for ref, value in zip(refs, values):
            if node is not None:
                node.objects.add(ref.hex)
            self.runtime.store.seal(ref, value)
        self.runtime.metrics["tasks_finished"] += 1

    def _seal_failure(self, call: dict, exc: BaseException) -> None:
        if not self._take_ownership(call):
            return
        if call["attempt"] < self.max_task_retries:
            requeued = False
            with self._cond:
                # a concurrent kill may have drained-and-sealed the queues
                # already; retrying onto a dead queue would strand the refs
                if not self.dead_forever:
                    call["attempt"] += 1
                    if self.is_async and self.alive and self._loop is not None:
                        self._dispatch_async(call)
                    else:
                        self._queues[call["group"]].appendleft(call)
                        self._cond.notify_all()
                    requeued = True
            if requeued:
                return
        err = TaskError(exc, f"{self.cls.__name__}.{call['method']}")
        err.__cause__ = exc
        for ref in call["returns"]:
            self.runtime.store.seal(ref, err, is_error=True)
        self.runtime.metrics["tasks_failed"] += 1


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, self._num_returns)

    def options(self, num_returns: Optional[int] = None, **_ignored):
        return ActorMethod(
            self._handle, self._name, num_returns or self._num_returns
        )


class ActorHandle:
    """Client-side handle (reference: python/ray/actor.py ActorHandle)."""

    def __init__(self, runtime, actor_id: str, cls: type):
        self._runtime = runtime
        self._actor_id = actor_id
        self._cls = cls
        # per-name ActorMethod memo: a.f.remote() in a hot loop resolves
        # the class attribute + options once instead of per call
        self._methods: Dict[str, ActorMethod] = {}

    @property
    def _actor_state(self) -> ActorState:
        return self._runtime._actors[self._actor_id]

    def __getattr__(self, name: str) -> ActorMethod:
        # dunders (except __call__, used by serve replicas) stay normal
        # attribute errors so pickling/copy protocols don't get hijacked
        if name.startswith("__") and name != "__call__":
            raise AttributeError(name)
        # __dict__ access (not attribute access): an instance materialized
        # without __init__ (copy/unpickle protocols) must not recurse here
        methods = self.__dict__.get("_methods")
        if methods is not None:
            cached = methods.get(name)
            if cached is not None:
                return cached
        fn = getattr(self._cls, name, None)
        if fn is None or not callable(fn):
            raise AttributeError(
                f"actor class {self._cls.__name__} has no method {name!r}"
            )
        opts = getattr(fn, "_ray_tpu_method_options", {})
        m = ActorMethod(self, name, opts.get("num_returns", 1))
        if methods is not None:
            methods[name] = m
        return m

    def _invoke(self, method_name, args, kwargs, num_returns):
        if num_returns == "streaming":
            from ..cluster.common import new_id
            from .object_store import ObjectRefGenerator

            state = self._actor_state
            target = getattr(state.cls, method_name, None)
            if (
                state.is_async
                or inspect.iscoroutinefunction(target)
                or inspect.isasyncgenfunction(target)
            ):
                raise TypeError(
                    "num_returns='streaming' is not supported on async "
                    "actors; use a sync actor or a task"
                )
            tid = new_id()
            # state exists from submission so an abandon arriving before
            # the executor starts sticks (runtime.register_stream)
            self._runtime.register_stream(tid)
            self._runtime.metrics["tasks_submitted"] += 1
            state.submit_method(
                method_name, args, kwargs, [], stream_tid=tid
            )
            return ObjectRefGenerator(tid, self._runtime)
        refs = [ObjectRef.new(owner=self._actor_id) for _ in range(num_returns)]
        for r in refs:
            self._runtime.store.create(r)
        self._runtime.metrics["tasks_submitted"] += 1
        self._actor_state.submit_method(method_name, args, kwargs, refs)
        return refs[0] if num_returns == 1 else refs

    def __repr__(self) -> str:
        return f"ActorHandle({self._cls.__name__}, {self._actor_id[:8]})"


def create_actor(
    runtime,
    cls: type,
    args: tuple,
    kwargs: dict,
    *,
    resources: Dict[str, float],
    name: Optional[str] = None,
    lifetime: Optional[str] = None,
    max_restarts: int = 0,
    max_task_retries: int = 0,
    max_concurrency: int = 1,
    concurrency_groups: Optional[Dict[str, int]] = None,
    scheduling_strategy=None,
) -> ActorHandle:
    """Create + centrally schedule an actor (GcsActorScheduler analog)."""
    if name is not None and name in runtime._named_actors:
        raise ValueError(f"actor name {name!r} already taken")
    actor_id = uuid.uuid4().hex[:16]
    state = ActorState(
        runtime,
        actor_id,
        cls,
        args,
        kwargs,
        resources,
        name=name,
        max_restarts=max_restarts,
        max_task_retries=max_task_retries,
        max_concurrency=max_concurrency,
        concurrency_groups=concurrency_groups,
    )
    runtime._actors[actor_id] = state
    if name is not None:
        runtime._named_actors[name] = actor_id
    runtime._submit_actor_creation(state, scheduling_strategy)
    return ActorHandle(runtime, actor_id, cls)
