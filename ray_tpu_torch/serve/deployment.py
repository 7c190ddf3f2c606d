"""Deployments, router, autoscaling controller, HTTP proxy.

Port of ``ray_tpu/serve/deployment.py`` (no JAX in it). The differences:

- ``start_http_proxy`` takes ``proxy.ServeProxy`` when aiohttp imports and
  the standard library's ``ThreadingHTTPServer`` otherwise;
- a request that names a model routes over every replica that can serve
  it without a swap (``_ReplicaSet._pick_replica``): one that holds it, and
  one that took no variant yet when the model is the base, ``models[0]``,
  which every replica starts on. In a deployment without ``models`` the
  name routes nothing. The reference keeps a named model to the replicas
  already marked with it, so a replica added under such traffic never got
  any of it.
"""
from __future__ import annotations

import json
import random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    max_ongoing_requests: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    # serving-plane contract flags: resumable_streams declares that
    # ``stream_to`` regenerates deterministically and honors
    # ``resume_from`` (the router may fail a stream over mid-flight);
    # stats_method names a replica method the router's reporter may
    # call for engine-level stats (e.g. prefix-cache hit rate); slo
    # attaches an SLOConfig-driven autoscaler instead of the legacy
    # ongoing-count tick
    resumable_streams: bool = False
    stats_method: Optional[str] = None
    slo: Optional[Any] = None
    # per-tenant WFQ weights, enforced CLUSTER-WIDE by the router
    # fleet's budget reconciliation (a weight-3 tenant drains ~3x a
    # weight-1 tenant even when their streams land on different routers)
    tenant_weights: Optional[Dict[str, float]] = None
    # disaggregated serving: the companion prefill deployment's
    # name — the router runs the prefill phase there and ships sealed KV
    # pages to this deployment's decode replicas; None = monolithic
    prefill_deployment: Optional[str] = None
    # model ids this deployment can multiplex (hot-swap targets), the
    # first the base every replica starts on; None means single-model,
    # any request "model" is accepted as-is
    models: Optional[List[str]] = None

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        d = Deployment(
            self.func_or_class,
            overrides.pop("name", self.name),
            self.num_replicas,
            dict(self.ray_actor_options),
            self.max_ongoing_requests,
            self.autoscaling_config,
            self.resumable_streams,
            self.stats_method,
            self.slo,
            dict(self.tenant_weights) if self.tenant_weights else None,
            self.prefill_deployment,
            list(self.models) if self.models else None,
        )
        for k, v in overrides.items():
            setattr(d, k, v)
        return d


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


def deployment(_func_or_class=None, *, name: Optional[str] = None, **opts):
    """@serve.deployment decorator (serve/api.py parity)."""

    def wrap(obj):
        dep_name = name or getattr(obj, "__name__", "deployment")
        if not isinstance(obj, type):
            fn = obj

            class _FuncDeployment:
                def __call__(self, *a, **kw):
                    return fn(*a, **kw)

            _FuncDeployment.__name__ = dep_name
            obj = _FuncDeployment
        d = Deployment(obj, dep_name)
        for k, v in opts.items():
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            setattr(d, k, v)
        return d

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


class NoPreferredReplica(RuntimeError):
    """Raised by strict-preference dispatch when no candidate replica
    satisfies the caller's predicate (e.g. same-host for shm streaming)."""


class NoReplicasForModel(RuntimeError):
    """Retryable per-*model* empty set: the deployment has live replicas
    but none can serve the requested model id (unknown model, or every
    swap candidate is draining). Distinct from the all-replicas-dead
    RuntimeError so per-model SLO signals don't cross-contaminate."""

    def __init__(self, deployment: str, model: str, reason: str):
        super().__init__(
            f"no replicas for model {model!r} in deployment "
            f"{deployment!r} ({reason})"
        )
        self.deployment = deployment
        self.model = model


@dataclass
class _Replica:
    actor: Any
    ongoing: int = 0
    draining: bool = False
    # which weights this replica currently holds (model multiplexing):
    # None until the first model-tagged request lands on it, and until
    # then it holds the base, the deployment's models[0]
    model: Optional[str] = None


class _ReplicaSet:
    """Replica fleet + p2c router state for one deployment."""

    def __init__(self, app: Application):
        self.app = app
        self.dep = app.deployment
        self.lock = threading.Lock()
        self.replicas: List[_Replica] = []
        self.total_requests = 0
        self._outstanding: List[tuple] = []  # (ref, _Replica)
        self._watch_cv = threading.Condition(self.lock)
        self._watcher: Optional[threading.Thread] = None
        self._closed = False
        self._build_actor_class()
        n0 = (
            self.dep.autoscaling_config.min_replicas
            if self.dep.autoscaling_config
            else self.dep.num_replicas
        )
        # desired active-replica count: autoscaling moves it; replica
        # DEATH does not (the set backfills toward it)
        self.target = n0
        self.backfills = 0
        for _ in range(n0):
            self._add_replica()

    def _build_actor_class(self):
        cls = self.dep.func_or_class
        opts = dict(self.dep.ray_actor_options)
        opts.setdefault("max_concurrency", 8)
        init_args = []
        for a in self.app.init_args:
            if isinstance(a, Application):
                a = run(a)  # nested deployment → handle (model composition)
            init_args.append(a)
        self._actor_cls = ray_tpu_torch.remote(**opts)(cls)
        self._init_args = tuple(init_args)

    def _add_replica(self):
        actor = self._actor_cls.remote(
            *self._init_args, **self.app.init_kwargs
        )
        with self.lock:
            self.replicas.append(_Replica(actor))

    def add_replica(self) -> None:
        """Scale up by one (autoscaler-facing): raises the desired count
        and creates the replica (the head scheduler places it)."""
        with self.lock:
            self.target += 1
        self._add_replica()

    def drain_one_replica(self) -> None:
        """Scale down by one with graceful drain (autoscaler-facing)."""
        with self.lock:
            self.target = max(1, self.target - 1)
        self._drain_one_replica()

    def note_replica_death(self, replica: "_Replica") -> None:
        """A replica's actor died (router dispatch/stream failure or the
        controller's liveness probe): drop it from routing immediately
        and backfill toward the desired count."""
        with self.lock:
            if replica not in self.replicas:
                return  # already reaped by a concurrent path
            self.replicas.remove(replica)
            need = (
                not replica.draining
                and not self._closed
                and len([r for r in self.replicas if not r.draining])
                < self.target
            )
        try:
            ray_tpu_torch.kill(replica.actor)  # idempotent corpse cleanup
        except Exception:  # noqa: BLE001
            pass
        if need:
            self.backfills += 1
            self._add_replica()

    def reap_dead_replicas(self) -> int:
        """Controller-driven liveness sweep: probe each replica's actor
        state and reap the dead ones (detection without traffic, so a
        SIGKILLed idle replica still backfills). Control-plane cadence —
        never on the request path."""
        from ray_tpu_torch.core.runtime import get_runtime

        try:
            rt = get_runtime()
        except Exception:  # noqa: BLE001
            return 0
        with self.lock:
            snapshot = list(self.replicas)
        reaped = 0
        for replica in snapshot:
            dead = False
            aid = getattr(replica.actor, "_actor_id", None)
            if aid is None:
                continue
            if getattr(rt, "is_remote", False):
                try:
                    info = rt._read(
                        "WaitActor", {"actor_id": aid, "timeout": 0.01}
                    )
                    dead = info.state == "DEAD"
                except Exception:  # noqa: BLE001 - head busy: skip sweep
                    continue
            else:
                state = rt._actors.get(aid)
                dead = state is not None and getattr(
                    state, "dead_forever", False
                )
            if dead:
                self.note_replica_death(replica)
                reaped += 1
        return reaped

    def _drain_one_replica(self):
        """Downscale with drain: stop routing to one idle replica and kill
        it; if none is idle, mark the emptiest as draining and kill it once
        its in-flight requests complete (the watcher does the final kill)."""
        with self.lock:
            active = [r for r in self.replicas if not r.draining]
            if len(active) <= 1:
                return
            idle = [r for r in active if r.ongoing == 0]
            victim = idle[0] if idle else min(active, key=lambda r: r.ongoing)
            victim.draining = True
            if victim.ongoing == 0:
                self.replicas.remove(victim)
                kill_now = True
            else:
                kill_now = False  # watcher kills at ongoing==0
        if kill_now:
            ray_tpu_torch.kill(victim.actor)

    # power-of-two-choices routing (pow_2_router.py:27)
    def _pick_replica(self, prefer=None, strict_prefer=False,
                      model: Optional[str] = None) -> _Replica:
        # caller holds self.lock
        cands = [r for r in self.replicas if not r.draining]
        if not cands:
            cands = list(self.replicas)
        if not cands:
            # reachable since note_replica_death removes replicas: the
            # window between removing the last corpse and its backfill
            # registering must surface as a clear, retryable error
            raise RuntimeError(
                f"no live replicas for deployment {self.dep.name!r} "
                "(death backfill in progress)"
            )
        if prefer is not None:
            # affinity (e.g. same-host pinning for shm streaming):
            # restrict to preferred replicas when any exist. strict means
            # the caller's transport REQUIRES the predicate (a same-host-
            # only shm writer must never reach a cross-host replica) —
            # raise instead of falling through so the caller can switch
            # transports.
            preferred = [r for r in cands if prefer(r)]
            if preferred:
                cands = preferred
            elif strict_prefer:
                raise NoPreferredReplica(self.dep.name)
        if model is not None and self.dep.models is not None:
            # model multiplexing: p2c compares queue depth only WITHIN a
            # model's replica set — depths across different weights are
            # not comparable (a hot 70B variant's 3 ≠ a LoRA's 3). A
            # replica that took no variant yet holds the base, so it is in
            # the base's set: else one added under base traffic (scale-up,
            # backfill) would never get any of it
            if model not in self.dep.models:
                raise NoReplicasForModel(
                    self.dep.name, model, "unknown model id"
                )
            base = model == self.dep.models[0]
            same = [r for r in cands if r.model == model
                    or (base and r.model is None and not r.draining)]
            if same:
                cands = same
            else:
                # cold model: swap on the least-loaded compatible
                # replica, preferring one that never took a variant.
                # Marked optimistically here (under self.lock) so a
                # concurrent second request for the same model routes to
                # this replica's queue instead of triggering a second
                # swap; the replica installs the weights on arrival.
                swappable = [r for r in cands if not r.draining]
                if not swappable:
                    raise NoReplicasForModel(
                        self.dep.name, model,
                        "all swap candidates draining",
                    )
                fresh = [r for r in swappable if r.model is None]
                victim = min(
                    fresh or swappable, key=lambda r: r.ongoing
                )
                victim.model = model
                return victim
        if len(cands) == 1:
            pick = cands[0]
        else:
            a, b = random.sample(cands, 2)
            pick = a if a.ongoing <= b.ongoing else b
        if model is not None and self.dep.models is not None:
            pick.model = model
        return pick

    def submit(self, method: str, args, kwargs, prefer=None,
               strict_prefer=False):
        ref, _ = self.submit_traced(
            method, args, kwargs, prefer, strict_prefer
        )
        return ref

    def submit_traced(self, method: str, args, kwargs, prefer=None,
                      strict_prefer=False, model: Optional[str] = None):
        """Like ``submit`` but also returns the chosen replica — the
        serving router needs it for failover bookkeeping and
        lease-channel accounting."""
        with self.lock:
            replica = self._pick_replica(prefer, strict_prefer, model)
            replica.ongoing += 1
            self.total_requests += 1
            actor = replica.actor
        try:
            ref = getattr(actor, method).remote(*args, **kwargs)
        except BaseException:
            with self.lock:
                replica.ongoing -= 1
            raise
        with self._watch_cv:
            self._outstanding.append((ref, replica))
            if self._watcher is None or not self._watcher.is_alive():
                self._watcher = threading.Thread(
                    target=self._watch_loop,
                    name=f"serve-watch-{self.dep.name}",
                    daemon=True,
                )
                self._watcher.start()
            self._watch_cv.notify()
        return ref, replica

    class _StreamRequest:
        """Iterator over a streaming replica call that releases the
        replica's ongoing count exactly once — on exhaustion, error,
        close, OR drop-before-first-next (a generator's ``finally`` never
        runs if its frame never starts, which leaked the count when a
        gRPC client cancelled before the first message)."""

        def __init__(self, rs, replica, gen):
            self._rs = rs
            self._replica = replica
            self._gen = gen
            self._done = False

        def _finish(self) -> None:
            if not self._done:
                self._done = True
                self._rs._stream_finished(self._replica)

        def __iter__(self):
            return self

        def __next__(self):
            if self._done:
                raise StopIteration
            try:
                return next(self._gen)
            except BaseException:
                self._finish()
                raise

        def close(self) -> None:
            self._finish()

        def __del__(self):
            self._finish()

    def submit_streaming(self, method: str, args, kwargs):
        """Route a server-streaming call to a replica as a
        num_returns="streaming" actor method; returns an iterator of
        item ObjectRefs. The replica's ongoing count holds until the
        stream is fully consumed (or dropped), then drains like any
        completed request. Cluster runtime only (the in-process runtime
        has no per-item actor-method streaming)."""
        with self.lock:
            replica = self._pick_replica(None, False)
            replica.ongoing += 1
            self.total_requests += 1
            actor = replica.actor
        try:
            gen = (
                getattr(actor, method)
                .options(num_returns="streaming")
                .remote(*args, **kwargs)
            )
        except BaseException:
            with self.lock:
                replica.ongoing -= 1
            raise

        return self._StreamRequest(self, replica, gen)

    def _stream_finished(self, replica) -> None:
        """Release one finished request's hold on ``replica`` (shared by
        the completion watcher and streaming requests): decrement the
        ongoing count and finish a draining replica once idle."""
        to_kill = None
        with self.lock:
            replica.ongoing -= 1
            if (
                replica.draining
                and replica.ongoing == 0
                and replica in self.replicas
            ):
                self.replicas.remove(replica)
                to_kill = replica
        if to_kill is not None:
            ray_tpu_torch.kill(to_kill.actor)

    def _watch_loop(self):
        """Single completion watcher: decrements in-flight counters when the
        request's result seals (never on a timeout), and finishes draining
        replicas."""
        while True:
            with self._watch_cv:
                while not self._outstanding and not self._closed:
                    self._watch_cv.wait(timeout=1.0)
                if self._closed:
                    return
                snapshot = list(self._outstanding)
            refs = [ref for ref, _ in snapshot]
            ready, _ = ray_tpu_torch.wait(
                refs, num_returns=1, timeout=0.2
            )
            if not ready:
                continue
            ready_set = {r.hex for r in ready}
            finished = []
            with self._watch_cv:
                still = []
                for ref, replica in self._outstanding:
                    if ref.hex in ready_set:
                        finished.append(replica)
                    else:
                        still.append((ref, replica))
                self._outstanding = still
            for replica in finished:
                # shared release path (streaming requests use it too):
                # decrement under self.lock, drain-remove-kill once idle
                self._stream_finished(replica)

    def autoscale_tick(self):
        cfg = self.dep.autoscaling_config
        if cfg is None:
            return
        with self.lock:
            active = [r for r in self.replicas if not r.draining]
            n = len(active)
            avg = sum(r.ongoing for r in active) / max(1, n)
        if avg > cfg.target_ongoing_requests and n < cfg.max_replicas:
            self.add_replica()
        elif avg < cfg.target_ongoing_requests / 2 and n > cfg.min_replicas:
            self.drain_one_replica()

    def close(self):
        with self._watch_cv:
            self._closed = True
            self._watch_cv.notify_all()

    @property
    def num_replicas(self) -> int:
        with self.lock:
            return len([r for r in self.replicas if not r.draining])


class DeploymentHandle:
    """Client handle (serve DeploymentHandle parity): handle.remote(...) or
    handle.method.remote(...)."""

    def __init__(self, rs: _ReplicaSet, method: str = "__call__"):
        self._rs = rs
        self._method = method

    def remote(self, *args, **kwargs):
        return self._rs.submit(self._method, args, kwargs)

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._rs, name)

    @property
    def num_replicas(self) -> int:
        return self._rs.num_replicas


_apps: Dict[str, _ReplicaSet] = {}
_routers: Dict[str, Any] = {}
_autoscalers: Dict[str, Any] = {}
_controller_thread: Optional[threading.Thread] = None
_controller_stop = threading.Event()
_http_server = None


def _controller_loop():
    """ServeController reconcile loop (controller.py:121 analog):
    legacy autoscale ticks plus a ~1s replica liveness sweep so dead
    replicas backfill even with no traffic hitting them."""
    ticks = 0
    while not _controller_stop.wait(0.25):
        ticks += 1
        for rs in list(_apps.values()):
            try:
                rs.autoscale_tick()
            except Exception:  # noqa: BLE001
                pass
            if ticks % 4 == 0:
                try:
                    rs.reap_dead_replicas()
                except Exception:  # noqa: BLE001
                    pass


def run(app: Application, *, name: Optional[str] = None) -> DeploymentHandle:
    global _controller_thread
    key = name or app.deployment.name
    if key in _apps:
        return DeploymentHandle(_apps[key])
    rs = _ReplicaSet(app)
    _apps[key] = rs
    # the ingress router fleet (horizontally scaled front door):
    # cfg.serve_routers ServeRouter replicas behind a consistent-hash
    # tenant assignment, sharded admission reconciled to the global
    # budget, token-exact cross-router stream failover. Duck-types the
    # single-router surface, so get_router() callers are unchanged;
    # with serve_routers=1 this IS the old layout plus a one-entry
    # assignment table.
    from .fleet import RouterFleet

    router = RouterFleet(rs)
    _routers[key] = router
    # deployments that declare a stats method (e.g. the LLM servers'
    # serve_stats: engine + prefix-cache counters) get it sampled into
    # the head report, so QueryState("serve") carries engine state too
    extra_stats_fn = None
    if app.deployment.stats_method:
        method = app.deployment.stats_method

        def extra_stats_fn(_rs=rs, _method=method):
            return ray_tpu_torch.get(_rs.submit(_method, (), {}), timeout=5.0)

    router.start_reporting(extra_stats_fn)
    if app.deployment.slo is not None:
        from .slo_autoscaler import SLOAutoscaler

        scaler = SLOAutoscaler(router, app.deployment.slo)
        scaler.start()
        _autoscalers[key] = scaler
    if _controller_thread is None or not _controller_thread.is_alive():
        _controller_stop.clear()
        _controller_thread = threading.Thread(
            target=_controller_loop, name="serve-controller", daemon=True
        )
        _controller_thread.start()
    return DeploymentHandle(rs)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(_apps[name])


def get_router(name: str):
    """The deployment's ingress :class:`~.fleet.RouterFleet` (admission
    + lease-routed dispatch + push-plane streaming + cross-router
    failover). Router-protocol compatible with the old single
    ServeRouter."""
    return _routers[name]


def shutdown() -> None:
    global _http_server, _grpc_server, _proto_grpc_server
    _controller_stop.set()
    for scaler in _autoscalers.values():
        scaler.stop()
    _autoscalers.clear()
    for router in _routers.values():
        router.close()
    _routers.clear()
    from .router import shutdown_sink

    shutdown_sink()
    for rs in _apps.values():
        rs.close()
        for replica in list(rs.replicas):
            try:
                ray_tpu_torch.kill(replica.actor)
            except Exception:  # noqa: BLE001
                pass
    _apps.clear()
    if _http_server is not None:
        _http_server.shutdown()
        _http_server = None
    if _grpc_server is not None:
        _grpc_server.shutdown()
        _grpc_server = None
    if _proto_grpc_server is not None:
        _proto_grpc_server.stop()
        _proto_grpc_server = None


_grpc_server = None
_grpc_lock = threading.Lock()


def start_grpc_ingress(port: int = 0) -> str:
    """gRPC front door (the reference proxies gRPC alongside HTTP,
    serve/_private/proxy.py gRPCProxy): any cluster RpcClient can call
    ServeCall / ServeStreamOpen / ServeStreamNext against the returned
    address. Returns "host:port". Idempotent for the same port; asking
    for a DIFFERENT specific port while one is live is an error rather
    than silently handing back the old address."""
    global _grpc_server
    from .grpc_ingress import GrpcIngress

    with _grpc_lock:
        if _grpc_server is None:
            _grpc_server = GrpcIngress(_apps, port=port)
        elif port and not _grpc_server.address.endswith(f":{port}"):
            raise RuntimeError(
                f"gRPC ingress already listening on {_grpc_server.address}; "
                f"cannot also bind port {port} (call serve.shutdown() first)"
            )
        return _grpc_server.address


_proto_grpc_server = None


def start_proto_grpc_ingress(
    registrations, port: int = 0
) -> str:
    """Protobuf-interop gRPC ingress (reference grpc_util.py gRPCProxy):
    ``registrations`` is a list of ``(add_<Service>Servicer_to_server,
    deployment_name)`` pairs using the user's GENERATED grpc code — any
    grpcio client with its own compiled stubs (no ray_tpu_torch installed)
    calls the deployment's methods; server-streaming methods stream via
    num_returns="streaming" replica calls. Returns "host:port"."""
    global _proto_grpc_server
    from .proto_ingress import ProtoGrpcIngress

    with _grpc_lock:
        if _proto_grpc_server is not None:
            raise RuntimeError(
                "proto gRPC ingress already running at "
                f"{_proto_grpc_server.address}; serve.shutdown() first"
            )
        _proto_grpc_server = ProtoGrpcIngress(
            _apps, list(registrations), port=port
        )
        return _proto_grpc_server.address


def start_http_proxy(port: int = 8000) -> int:
    """HTTP ingress (proxy.py analog): the async aiohttp proxy with SSE
    streaming (ray_tpu_torch/serve/proxy.py) when aiohttp is available; a
    minimal stdlib fallback otherwise."""
    global _http_server
    import importlib.util

    if importlib.util.find_spec("aiohttp") is not None:
        from .proxy import ServeProxy

        _http_server = ServeProxy(_apps, port=port)
        return _http_server.port
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            name = self.path.strip("/").split("/")[0]
            rs = _apps.get(name)
            if rs is None:
                self.send_response(404)
                self.end_headers()
                self.wfile.write(b'{"error": "no such deployment"}')
                return
            length = int(self.headers.get("Content-Length", 0))
            payload = (
                json.loads(self.rfile.read(length)) if length else None
            )
            try:
                ref = rs.submit("__call__", (payload,), {})
                result = ray_tpu_torch.get(ref, timeout=60)
                body = json.dumps({"result": result}).encode()
                self.send_response(200)
            except Exception as exc:  # noqa: BLE001
                body = json.dumps({"error": repr(exc)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    _http_server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(
        target=_http_server.serve_forever, name="serve-proxy", daemon=True
    ).start()
    return _http_server.server_address[1]
