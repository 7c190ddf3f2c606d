"""Public API: init/remote/get/put/wait — parity with the reference's

Port of ``ray_tpu/core/api.py``, with its imports rewritten. ``init()``
starts the local runtime and brings its scheduler device up at once, or
raises: ``cuda`` unless ``RAY_TPU_SCHED_PLATFORM=cpu``. ``init(address=...)``
(or ``cfg.head_address``) connects a ``RemoteRuntime`` to a cluster head,
whose rounds run on the head's device.

python surface (/root/reference/python/ray/_private/worker.py:1406,
remote_function.py:314, actor.py:1024)."""
from __future__ import annotations

import functools
import os
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from .object_store import (  # noqa: F401  (re-exported errors)
    GetTimeoutError,
    ObjectLostError,
    ObjectRef,
    OwnerDiedError,
    TaskError,
)
from .runtime import (
    ActorDiedError,  # noqa: F401
    NodeDiedError,  # noqa: F401
    Runtime,
    TaskSpec,
    get_context,
    get_runtime,
    runtime_initialized,
    set_runtime,
)
from . import actor as actor_mod


def init(
    num_nodes: int = 1,
    resources_per_node: Optional[Dict[str, float]] = None,
    *,
    address: Optional[str] = None,
    runtime_env: Optional[dict] = None,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    use_device_scheduler: Optional[bool] = None,
    ignore_reinit_error: bool = False,
):
    """Start the in-process cluster runtime, or connect to a live cluster.

    With ``address=None``: ``num_nodes`` simulated nodes in-process, each
    with ``resources_per_node`` — the single-process multi-node model
    (reference cluster_utils.Cluster, python/ray/cluster_utils.py:137).
    With ``address="host:port"``: connect this driver to a running
    multi-process cluster's head (the distributed runtime in
    ``cluster/``; the reference's ray.init(address=...) +
    Ray-Client mode). The scheduler runs the
    batched programs on the device selected by ``RAY_TPU_SCHED_PLATFORM``
    (default ``cuda``; ``cpu`` runs them on the host), brought up here: a
    missing or failing device raises — ``use_device_scheduler=False`` or
    ``RAY_TPU_DEVICE_SCHEDULER=0`` selects the NumPy golden model instead.
    """
    if runtime_initialized():
        if ignore_reinit_error:
            return get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    if address is None:
        from ..config import cfg

        address = cfg.head_address or None
    if address is not None:
        from ..cluster.client import RemoteRuntime

        remote_rt = RemoteRuntime(address, runtime_env=runtime_env)
        set_runtime(remote_rt)
        return remote_rt
    if resources_per_node is None:
        resources_per_node = {}
        if num_cpus is not None:
            resources_per_node["CPU"] = float(num_cpus)
        if num_tpus is not None:
            resources_per_node["TPU"] = float(num_tpus)
        if resources:
            resources_per_node.update(resources)
        if not resources_per_node:
            resources_per_node = {"CPU": 8.0, "memory": float(4 << 30)}
        resources_per_node.setdefault("CPU", 8.0)
        resources_per_node.setdefault("memory", float(4 << 30))
    rt = Runtime(
        num_nodes=num_nodes,
        resources_per_node=resources_per_node,
        use_device_scheduler=use_device_scheduler,
    )
    set_runtime(rt)
    return rt


def shutdown() -> None:
    if runtime_initialized():
        get_runtime().shutdown()
        set_runtime(None)


def is_initialized() -> bool:
    return runtime_initialized()


def put(value: Any) -> ObjectRef:
    return get_runtime().put_object(value)


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    rt = get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get_object(refs, timeout)
    refs = list(refs)
    batched = getattr(rt, "get_objects", None)
    if batched is not None and len(refs) > 1:
        return batched(refs, timeout)
    return [rt.get_object(r, timeout) for r in refs]


def wait(
    refs: List[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> tuple:
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns={num_returns} exceeds the number of refs ({len(refs)})"
        )
    if num_returns < 1:
        raise ValueError("num_returns must be >= 1")
    rt = get_runtime()
    return rt.store.wait_many(refs, num_returns, timeout)


def kill(actor_handle, *, no_restart: bool = True) -> None:
    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        rt.kill_actor(actor_handle, no_restart=no_restart)
        return
    state = actor_handle._actor_state
    state.mark_died(restart=not no_restart)
    if state._held_req is not None:
        node_id, req, assign = state._held_req
        node = rt.nodes.get(node_id)
        if node is not None and node.alive:
            if req is not None:  # None for PG actors: the bundle held it
                node.ledger.release(req)
                rt.view.update_available(node_id, node.ledger.avail_map())
            if assign and node.accel:
                node.accel.release(assign)
        state._held_req = None
    rt.notify_resources_changed()


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    """Best-effort cancel: tasks still queued are dropped (running tasks in
    the thread-pool model cannot be preempted, like non-force cancel in the
    reference)."""
    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        rt.cancel_object(ref, force=force)
        return
    with rt._cond:
        for q in (rt._pending, rt._infeasible, rt._dep_waiting):
            for spec in list(q):
                if ref.hex in spec.return_ids:
                    q.remove(spec)
                    err = TaskError(RuntimeError("task cancelled"), spec.name)
                    for rid in spec.return_ids:  # seal every sibling return
                        rt._seal_id(None, rid, err, True)


class RuntimeContext:
    """Per-task/actor execution context (ray.get_runtime_context parity,
    python/ray/runtime_context.py). Accelerator ids come from the granted
    lease's chip assignment — in cluster workers via the exported
    TPU_VISIBLE_CHIPS / CUDA_VISIBLE_DEVICES env vars."""

    def __init__(self, node_id, task_id, actor_id, accelerator_ids):
        self.node_id = node_id
        self.task_id = task_id
        self.actor_id = actor_id
        self._accelerator_ids = accelerator_ids

    def get_node_id(self):
        return self.node_id

    def get_task_id(self):
        return self.task_id

    def get_actor_id(self):
        return self.actor_id

    def get_accelerator_ids(self) -> Dict[str, List[str]]:
        return {k: [str(i) for i in v] for k, v in self._accelerator_ids.items()}


def get_runtime_context() -> RuntimeContext:
    from ..scheduler.instances import ACCELERATOR_ENV_VARS

    ctx = get_context()
    accel = dict(getattr(ctx, "accelerator_ids", None) or {})
    if not accel:
        # cluster worker: assignment arrives as exported env vars
        for name, var in ACCELERATOR_ENV_VARS.items():
            val = os.environ.get(var)
            if val:
                accel[name] = val.split(",")
    return RuntimeContext(ctx.node_id, ctx.task_id, ctx.actor_id, accel)


def nodes() -> List[Dict[str, Any]]:
    return get_runtime().nodes_info()


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace dump of task lifecycle events (ray.timeline parity,
    reference _private/state.py:1010)."""
    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        return rt.timeline(filename)
    return rt.events.dump_timeline(filename)


def cluster_resources() -> Dict[str, float]:
    return get_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return get_runtime().available_resources()


def get_actor(name: str):
    rt = get_runtime()
    if getattr(rt, "is_remote", False):
        return rt.get_actor(name)
    actor_id = rt._named_actors.get(name)
    if actor_id is None:
        raise ValueError(f"no actor named {name!r}")
    state = rt._actors[actor_id]
    return actor_mod.ActorHandle(rt, actor_id, state.cls)


def actor_exited(handle) -> bool:
    return handle._actor_state.dead_forever


# ---------------------------------------------------------------------------
# @remote
# ---------------------------------------------------------------------------


_OPTION_DEFAULTS = dict(
    num_cpus=None,
    num_gpus=None,
    num_tpus=None,
    memory=None,
    resources=None,
    num_returns=1,
    max_retries=3,
    retry_exceptions=False,
    scheduling_strategy=None,
    name=None,
    lifetime=None,
    max_restarts=0,
    max_task_retries=0,
    max_concurrency=None,
    concurrency_groups=None,
)


def _resource_map(opts: dict, is_actor: bool) -> Dict[str, float]:
    res: Dict[str, float] = {}
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    elif not is_actor:
        res["CPU"] = 1.0  # reference default: tasks need 1 CPU
    if opts.get("num_gpus") is not None:
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus") is not None:
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("memory") is not None:
        res["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        res[k] = float(v)
    return res


class RemoteFunction:
    def __init__(self, fn, options: dict):
        self._fn = fn
        self._options = options
        functools.update_wrapper(self, fn)

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        from .._ids import rand_hex

        rt = get_runtime()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        ctx = get_context()
        owner = ctx.task_id or "driver"
        refs = (
            []
            if streaming
            else [ObjectRef.new(owner=owner) for _ in range(num_returns)]
        )
        spec = TaskSpec(
            task_id=rand_hex(8),
            func=self._fn,
            args=args,
            kwargs=kwargs,
            returns=refs,
            resources=_resource_map(opts, is_actor=False),
            name=opts.get("name") or self._fn.__name__,
            strategy=opts.get("scheduling_strategy"),
            max_retries=opts.get("max_retries", 3),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            runtime_env=opts.get("runtime_env"),
            streaming=streaming,
        )
        rt.submit(spec)
        if streaming:
            from .object_store import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__} cannot be called directly; "
            "use .remote()"
        )


class ActorClass:
    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = options

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs):
        rt = get_runtime()
        opts = self._options
        # validate once here so both runtimes agree — a typo'd lifetime
        # must not silently mean "non-detached" on one backend
        if opts.get("lifetime") not in (None, "detached", "non_detached"):
            raise ValueError(
                "lifetime must be 'detached' or 'non_detached', "
                f"got {opts.get('lifetime')!r}"
            )
        if getattr(rt, "is_remote", False):
            v = opts.get("max_task_retries")
            if v not in (None, 0):
                import warnings

                warnings.warn(
                    f"max_task_retries={v} is not yet supported by the "
                    "distributed cluster backend; actor methods are not "
                    "automatically retried",
                    stacklevel=2,
                )
            return rt.create_actor(
                self._cls,
                args,
                kwargs,
                resources=_resource_map(opts, is_actor=True),
                name=opts.get("name"),
                lifetime=opts.get("lifetime"),
                max_restarts=opts.get("max_restarts", 0),
                max_concurrency=opts.get("max_concurrency"),
                concurrency_groups=opts.get("concurrency_groups"),
                scheduling_strategy=opts.get("scheduling_strategy"),
                runtime_env=opts.get("runtime_env"),
            )
        from ..cluster.pip_env import has_env

        if has_env(opts.get("runtime_env")):
            raise NotImplementedError(
                "pip/uv/conda runtime environments need per-env worker processes — "
                "run against a cluster (ray_tpu_torch.init(address=...) or "
                "Cluster()); the in-process runtime shares one interpreter"
            )
        return actor_mod.create_actor(
            rt,
            self._cls,
            args,
            kwargs,
            resources=_resource_map(opts, is_actor=True),
            name=opts.get("name"),
            lifetime=opts.get("lifetime"),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency"),
            concurrency_groups=opts.get("concurrency_groups"),
            scheduling_strategy=opts.get("scheduling_strategy"),
        )


def remote(*args, **options):
    """@remote decorator for functions and classes (reference:
    remote_function.py:314 / actor.py:1024)."""

    def decorate(obj):
        merged = dict(_OPTION_DEFAULTS)
        merged.update(options)
        if isinstance(obj, type):
            return ActorClass(obj, merged)
        return RemoteFunction(obj, merged)

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate
