"""gRPC plumbing for the distributed runtime.

The reference runs every control-plane boundary over gRPC with protoc-generated
services (Ray's src/ray/rpc/grpc_server.h, src/ray/protobuf/*.proto).
We keep gRPC as the wire (HTTP/2 framing, flow control, connection reuse) but
register *generic* unary handlers dispatched by method name with pickled
payloads — the framework's control messages are Python dataclasses, and a
dynamic schema keeps the RPC layer to one file instead of 36 .proto files.
Messages ride the pickle-5 out-of-band frame format (serialization.py):
numpy buffers inside any request/reply travel as raw frame segments and
deserialize as zero-copy views over the received message.

Every handler runs server-side in a thread pool; exceptions are pickled and
re-raised at the caller (the RetryableGrpcClient contract,
src/ray/rpc/retryable_grpc_client.h — retries here are explicit via
``RpcClient.call(retries=)``).

Port of ``ray_tpu/cluster/rpc.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import grpc

from . import serialization as wire

_MAX_MSG = 256 * 1024 * 1024


class RpcError(Exception):
    """Transport-level failure (peer dead/unreachable)."""


class PeerUnavailableError(RpcError):
    """The peer's circuit breaker is open: calls fail fast without
    touching the wire until a half-open probe succeeds."""


class RpcDeadlineError(RpcError):
    """The caller's overall deadline was exhausted across retries."""


class RpcStaleEpochError(Exception):
    """The caller stamped this RPC with a cluster epoch older than the
    receiver's: the sender joined a PREVIOUS head incarnation and its
    state (lease table rows, object locations, actor attachments) may
    have been rebuilt since. NOT an RpcError — handler-level exceptions
    re-raise at the caller immediately without consuming the retry
    budget, so stale traffic can never mutate the rebuilt tables by
    retrying its way in. The sender re-registers to adopt the new epoch
    (re-registration is the resync protocol) and only then resumes."""


class RpcNotLeaderError(RpcError):
    """The receiving head is not the cluster leader (a warm standby, or
    a deposed leader that fenced itself after observing a higher cluster
    epoch). Handler-level: re-raised at the caller immediately, never
    consuming the transport retry budget. Subclasses RpcError on
    purpose — the dozens of pre-existing ``except RpcError`` resilience
    paths (requeue, retry-later, spill) are exactly the right degraded
    behavior during a fenced window, while failover-aware callers catch
    this type FIRST and walk ``leader_hint`` / their head-candidate
    list to the real leader."""

    def __init__(self, msg: str, leader_hint: str = ""):
        super().__init__(msg)
        self.leader_hint = leader_hint

    def __reduce__(self):
        return (RpcNotLeaderError, (self.args[0], self.leader_hint))


class RpcUnknownMethodError(RpcError):
    """The peer has no handler registered for the requested method —
    dispatch-table drift (a caller invoking a kind the receiving side
    never registered), not a transport failure. Raised to the caller
    immediately, WITHOUT consuming the retry budget: gRPC's raw
    UNIMPLEMENTED used to read as a dead peer and burn every retry on a
    method that can never exist."""


class _Blackholed(Exception):
    """Injected partition: the peer is unreachable from this process.
    Handled exactly like a transport failure (retries, breaker)."""


class FencedPayload:
    """Wire envelope stamping a request with the sender's cluster epoch
    (``RpcClient.call(epoch=...)``). A server whose ``epoch`` is set (the
    head) rejects envelopes from an older epoch with
    :class:`RpcStaleEpochError` BEFORE the handler runs — stale traffic
    can never mutate rebuilt tables. Servers with no epoch (agents,
    workers) and methods in ``fence_exempt`` just unwrap."""

    __slots__ = ("epoch", "payload")

    def __init__(self, epoch: int, payload: Any):
        self.epoch = epoch
        self.payload = payload

    def __reduce__(self):
        return (FencedPayload, (self.epoch, self.payload))


class FaultInjection:
    """Runtime-mutable, process-local fault injection for chaos runs.

    The env-driven ``RAY_TPU_RPC_CHAOS`` knob (``_Chaos`` below) covers
    probabilistic per-method faults fixed at process start; this registry
    is the orchestrator-facing surface — per-PEER blackholes (partition)
    and delays (straggler ramps) that can be toggled mid-run. Injection
    happens inside ``RpcClient.call`` so the blackholed traffic exercises
    the real retry/breaker/recovery machinery."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blackholed: set = set()
        self._delays: Dict[str, float] = {}

    def blackhole(self, address: str) -> None:
        with self._lock:
            self._blackholed.add(address)

    def heal(self, address: str) -> None:
        with self._lock:
            self._blackholed.discard(address)
            self._delays.pop(address, None)

    def set_delay(self, address: str, seconds: float) -> None:
        with self._lock:
            if seconds <= 0:
                self._delays.pop(address, None)
            else:
                self._delays[address] = float(seconds)

    def clear(self) -> None:
        with self._lock:
            self._blackholed.clear()
            self._delays.clear()

    def check(self, address: str) -> float:
        """Returns the injected delay for ``address`` (0 if none); raises
        ``_Blackholed`` if the peer is partitioned away."""
        with self._lock:
            if address in self._blackholed:
                raise _Blackholed(f"chaos: peer {address} blackholed")
            return self._delays.get(address, 0.0)


FAULTS = FaultInjection()


class CircuitBreaker:
    """Per-peer circuit breaker (RetryableGrpcClient's
    server-unavailable-timeout analog, src/ray/rpc/retryable_grpc_client.h).

    Closed → transport failures spanning ``rpc_breaker_window_s`` with no
    intervening success → Open (calls fail fast, node-unreachable
    callbacks fire) → after ``rpc_breaker_cooldown_s`` one half-open
    probe is allowed; its success closes the circuit, its failure
    re-opens it. State is shared per peer address across every RpcClient
    in the process, so a wedged transport fails fast everywhere instead
    of stalling each caller for its full timeout."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, address: str):
        self.address = address
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self._first_failure: Optional[float] = None
        self._last_failure = 0.0
        self._fail_count = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        self.open_count = 0
        # id(owner) -> callback; fired (outside the lock) on each
        # closed->open transition. Owners unregister via remove_callback.
        self._callbacks: Dict[int, Callable[[], None]] = {}

    def add_callback(self, owner: Any, fn: Callable[[], None]) -> None:
        with self._lock:
            self._callbacks[id(owner)] = fn

    def remove_callback(self, owner: Any) -> None:
        with self._lock:
            self._callbacks.pop(id(owner), None)

    def allow(self) -> bool:
        """May an attempt touch the wire right now?"""
        now = time.monotonic()
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and now >= self._open_until:
                self.state = self.HALF_OPEN
                self._probe_in_flight = True
                return True
            if self.state == self.HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            was_open = self.state != self.CLOSED
            self.state = self.CLOSED
            self._first_failure = None
            self._fail_count = 0
            self._probe_in_flight = False
        if was_open:
            BREAKER_STATE.set(0, labels={"peer": self.address})

    def abort_probe(self) -> None:
        """A half-open probe attempt died without a transport verdict
        (e.g. serialization error): release the probe slot so the
        breaker can't wedge in HALF_OPEN forever."""
        with self._lock:
            if self.state == self.HALF_OPEN:
                self._probe_in_flight = False

    def on_failure(self) -> None:
        from ray_tpu_torch.config import cfg

        now = time.monotonic()
        opened = False
        fire: List[Callable[[], None]] = []
        with self._lock:
            if self.state == self.HALF_OPEN:
                # probe failed: straight back to open — and RE-fire the
                # callbacks. A persistently partitioned node can
                # re-register between cooldowns (its own reports still
                # flow); without re-firing, it would stay 'alive' forever
                # while every dispatch to it fails fast.
                self.state = self.OPEN
                self._probe_in_flight = False
                self._open_until = now + cfg.rpc_breaker_cooldown_s
                self.open_count += 1
                opened = True
                fire = list(self._callbacks.values())
            elif self.state == self.OPEN:
                return
            else:
                window = cfg.rpc_breaker_window_s
                # SLIDING window: a failure separated from the previous
                # one by more than the window starts a fresh streak —
                # sparse unrelated timeouts hours apart on a quiet peer
                # must never accumulate into a false open
                if (
                    self._first_failure is None
                    or now - self._last_failure > window
                ):
                    self._first_failure = now
                    self._last_failure = now
                    self._fail_count = 1
                    return
                self._last_failure = now
                self._fail_count += 1
                # open only when a CONTINUOUS failure streak both spans
                # the window and numbers at least the minimum
                if (
                    now - self._first_failure >= window
                    and self._fail_count >= cfg.rpc_breaker_min_failures
                ):
                    self.state = self.OPEN
                    self._open_until = now + cfg.rpc_breaker_cooldown_s
                    self.open_count += 1
                    opened = True
                    fire = list(self._callbacks.values())
        if opened:
            BREAKER_OPENS.inc(labels={"peer": self.address})
            BREAKER_STATE.set(1, labels={"peer": self.address})
            for fn in fire:
                try:
                    fn()
                except Exception:  # noqa: BLE001 - health path best-effort
                    import logging

                    logging.getLogger("ray_tpu_torch.cluster.rpc").exception(
                        "node-unreachable callback failed for %s",
                        self.address,
                    )


_BREAKERS: Dict[str, CircuitBreaker] = {}
# clients per address: breakers for ephemeral peers (worker processes get
# a fresh port per spawn — thousands over an agent's life under actor
# churn) are evicted when their last client closes, instead of growing
# the registry forever
_BREAKER_REFS: Dict[str, int] = {}
_BREAKERS_LOCK = threading.Lock()


def get_breaker(address: str) -> CircuitBreaker:
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(address)
        if br is None:
            br = _BREAKERS[address] = CircuitBreaker(address)
        _BREAKER_REFS[address] = _BREAKER_REFS.get(address, 0) + 1
        return br


def release_breaker(address: str) -> None:
    """Drop one client's hold on ``address``'s breaker; the registry entry
    is evicted with the last hold (its trip counters have already been
    exported through the BREAKER_* metrics)."""
    with _BREAKERS_LOCK:
        n = _BREAKER_REFS.get(address, 0) - 1
        if n <= 0:
            _BREAKER_REFS.pop(address, None)
            _BREAKERS.pop(address, None)
        else:
            _BREAKER_REFS[address] = n


def reset_breakers() -> None:
    """Reset all breaker STATE (tests / chaos teardown) in place: live
    clients hold direct references to their breakers, and stale imports
    of _BREAKERS must keep seeing the shared registry object. Entries
    still referenced by open clients stay registered (with their
    refcounts) — dropping them would split per-peer breaker state the
    moment a new client re-registered the address; only ref-less
    entries are evicted."""
    with _BREAKERS_LOCK:
        for addr, br in list(_BREAKERS.items()):
            with br._lock:
                br.state = br.CLOSED
                br._first_failure = None
                br._fail_count = 0
                br._probe_in_flight = False
            if _BREAKER_REFS.get(addr, 0) <= 0:
                _BREAKERS.pop(addr, None)
                _BREAKER_REFS.pop(addr, None)
_OPTIONS = [
    ("grpc.max_send_message_length", _MAX_MSG),
    ("grpc.max_receive_message_length", _MAX_MSG),
    ("grpc.so_reuseport", 0),
]


from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Gauge as _Gauge

RPC_RETRIES = _Counter(
    "rpc_client_retries_total",
    "RPC attempts retried after a transport-level failure.",
    label_names=("method",),
)
RPC_DEADLINE_EXCEEDED = _Counter(
    "rpc_client_deadline_exceeded_total",
    "RPC calls abandoned because the caller's overall deadline expired.",
    label_names=("method",),
)
BREAKER_OPENS = _Counter(
    "rpc_breaker_opens_total",
    "Circuit-breaker closed->open transitions per peer.",
    label_names=("peer",),
)
BREAKER_STATE = _Gauge(
    "rpc_breaker_open",
    "1 while the peer's circuit is open, 0 otherwise.",
    label_names=("peer",),
)


class _ChaosDrop(Exception):
    """Injected message drop — handled exactly like a transport failure
    (same retry budget), so chaos exercises the real recovery path."""


class _Chaos:
    """Message-level failure injection (rpc_chaos.h:24-41 analog).

    Configured by the RAY_TPU_RPC_CHAOS knob, e.g.
    ``ExecuteLeaseBatch:drop=0.1;PushTaskBatch:delay_ms=20`` — each listed
    method gets an independent drop probability (the call raises RpcError
    without ever reaching the peer — the retry/requeue machinery must
    recover) and/or an added delay. Parsed once per process."""

    def __init__(self) -> None:
        import random

        from ray_tpu_torch.config import cfg

        self.rules: Dict[str, Dict[str, float]] = {}
        self._rng = random.Random(0xC4A05)
        spec = cfg.rpc_chaos
        for part in spec.split(";"):
            part = part.strip()
            if not part or ":" not in part:
                continue
            method, params = part.split(":", 1)
            rule: Dict[str, float] = {}
            for kv in params.split(","):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    try:
                        rule[k.strip()] = float(v)
                    except ValueError:
                        pass
            if rule:
                self.rules[method.strip()] = rule

    def apply(self, method: str) -> None:
        rule = self.rules.get(method)
        if rule is None:
            return
        delay = rule.get("delay_ms", 0.0)
        if delay > 0:
            time.sleep(delay / 1e3)
        if self._rng.random() < rule.get("drop", 0.0):
            raise _ChaosDrop(f"chaos: dropped {method} before send")


_chaos: Optional[_Chaos] = None


def _get_chaos() -> _Chaos:
    global _chaos
    if _chaos is None:
        _chaos = _Chaos()
    return _chaos


class HandlerStats:
    """Per-handler timing (the reference's event-loop/handler stats,
    src/ray/common/asio/instrumented_io_context.h — every posted handler
    is counted and timed). One instance per process; servers share it."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._stats: Dict[str, list] = {}  # name -> [count, total_s, max_s]

    def record(self, name: str, elapsed: float) -> None:
        with self._lock:
            row = self._stats.get(name)
            if row is None:
                row = self._stats[name] = [0, 0.0, 0.0]
            row[0] += 1
            row[1] += elapsed
            if elapsed > row[2]:
                row[2] = elapsed

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "count": c,
                    "total_ms": round(t * 1e3, 3),
                    "mean_ms": round(t / c * 1e3, 3) if c else 0.0,
                    "max_ms": round(mx * 1e3, 3),
                }
                for name, (c, t, mx) in sorted(self._stats.items())
            }


HANDLER_STATS = HandlerStats()


class _GenericHandler(grpc.GenericRpcHandler):
    def __init__(
        self,
        handlers: Dict[str, Callable[[Any], Any]],
        server: "Optional[RpcServer]" = None,
    ):
        self._handlers = handlers
        self._rpc_server = server

    def _unfence(self, name: str, req: Any) -> Any:
        """Enforce epoch fencing on a stamped request. The epoch check is
        strictly-less-than: a sender from THIS incarnation passes; only
        provably-stale traffic — a peer that registered with a PREVIOUS
        head — is rejected, before its handler can touch any table. A
        stamp HIGHER than this server's epoch proves a newer head
        incarnation exists (the sender registered with it): an
        epoch-checking server self-fences via ``on_newer_epoch`` and
        redirects the sender — the deposed-leader half of split-brain
        prevention."""
        if not isinstance(req, FencedPayload):
            return req
        srv = self._rpc_server
        if (
            srv is not None
            and srv.epoch is not None
            and name not in srv.fence_exempt
        ):
            if req.epoch < srv.epoch:
                raise RpcStaleEpochError(
                    f"rpc {name} stamped with epoch {req.epoch} but the "
                    f"cluster epoch is {srv.epoch}; re-register to resync"
                )
            if req.epoch > srv.epoch and srv.on_newer_epoch is not None:
                try:
                    srv.on_newer_epoch(int(req.epoch))
                except Exception:  # noqa: BLE001 - fencing is best-effort here
                    pass
                raise RpcNotLeaderError(
                    f"rpc {name} stamped with epoch {req.epoch} > this "
                    f"head's {srv.epoch}: a newer head incarnation "
                    "exists; this one has fenced itself",
                    leader_hint=srv.not_leader_hint or "",
                )
        return req.payload

    def _refuse_if_not_leader(self, name: str) -> None:
        srv = self._rpc_server
        if (
            srv is not None
            and srv.refuse_non_leader
            and name not in srv.always_serve
        ):
            raise RpcNotLeaderError(
                f"rpc {name}: this head is not the cluster leader "
                f"(role={srv.role_hint})",
                leader_hint=srv.not_leader_hint or "",
            )

    def service(self, handler_call_details):
        name = handler_call_details.method.rsplit("/", 1)[-1]
        fn = self._handlers.get(name)
        if fn is None:
            # unknown method: reply with a typed handler-level error so the
            # caller fails fast with the method name instead of retrying a
            # raw UNIMPLEMENTED as if the peer were down
            def unknown(request_bytes, context, _name=name):
                return cloudpickle.dumps(
                    (
                        False,
                        RpcUnknownMethodError(
                            f"no handler registered for rpc method {_name!r}"
                        ),
                    )
                )

            return grpc.unary_unary_rpc_method_handler(
                unknown,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )

        def unary(request_bytes, context):
            t0 = time.perf_counter()
            try:
                self._refuse_if_not_leader(name)
                req = self._unfence(name, wire.loads(request_bytes))
                return wire.dumps((True, fn(req)))
            except BaseException as exc:  # noqa: BLE001 - shipped to caller
                try:
                    return cloudpickle.dumps((False, exc))
                except Exception:  # unpicklable exception
                    return cloudpickle.dumps((False, RuntimeError(repr(exc))))
            finally:
                HANDLER_STATS.record(name, time.perf_counter() - t0)

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )


class RpcServer:
    """One gRPC server hosting named unary handlers.

    ``handlers`` maps method name -> fn(request_obj) -> response_obj.
    """

    def __init__(
        self,
        handlers: Dict[str, Callable[[Any], Any]],
        host: str = "127.0.0.1",
        port: int = 0,
        max_workers: int = 32,
    ):
        # epoch fencing (set by the head after recovery): stamped requests
        # older than this are rejected with RpcStaleEpochError; methods in
        # fence_exempt (the resync protocol itself) always pass
        self.epoch: Optional[int] = None
        self.fence_exempt: set = set()
        # leadership fencing (replicated control plane): a fenced or
        # standby head sets refuse_non_leader and every method outside
        # always_serve (role probe + observability) raises
        # RpcNotLeaderError with the leader hint BEFORE its handler runs.
        # on_newer_epoch fires when a request stamped with a HIGHER epoch
        # arrives — proof a newer incarnation exists; the head routes it
        # into its step-down path.
        self.refuse_non_leader = False
        self.always_serve: set = {"Ping", "HeadRole", "QueryState"}
        self.not_leader_hint: Optional[str] = None
        self.role_hint = "leader"
        self.on_newer_epoch: Optional[Callable[[int], None]] = None
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_OPTIONS,
        )
        self._server.add_generic_rpc_handlers(
            (_GenericHandler(handlers, server=self),)
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise RpcError(f"could not bind RPC server on {host}:{port}")
        self.address = f"{host}:{self.port}"
        self._server.start()

    def stop(self, grace: float = 0.2) -> None:
        self._server.stop(grace)


class RpcClient:
    """Channel to one peer; ``call(method, payload)`` round-trips an object.

    The full RetryableGrpcClient analog (retryable_grpc_client.h):
    exponential backoff with decorrelated jitter under a cap, caller
    deadline propagation (``deadline_s`` bounds the WHOLE retry loop —
    attempts, injected delays, and backoff sleeps included), and a
    per-peer circuit breaker shared across every client to the same
    address. ``on_unreachable`` registers a callback fired when the
    breaker opens (the head routes it into its health path so a wedged
    transport is declared dead in seconds, not after every caller's
    timeout stacks up)."""

    def __init__(
        self,
        address: str,
        on_unreachable: Optional[Callable[[], None]] = None,
    ):
        self.address = address
        self._channel = grpc.insecure_channel(address, options=_OPTIONS)
        self._methods: Dict[str, Any] = {}
        self._closed = False
        self._breaker = get_breaker(address)
        if on_unreachable is not None:
            self._breaker.add_callback(self, on_unreachable)

    def _method(self, name: str):
        m = self._methods.get(name)
        if m is None:
            m = self._channel.unary_unary(
                f"/rtpu/{name}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            self._methods[name] = m
        return m

    def call(
        self,
        method: str,
        payload: Any = None,
        timeout: Optional[float] = 30.0,
        retries: int = 0,
        retry_interval: float = 0.1,
        deadline_s: Optional[float] = None,
        epoch: Optional[int] = None,
    ) -> Any:
        """Round-trip ``payload`` to handler ``method``.

        ``timeout`` is the per-attempt RPC deadline; ``deadline_s`` is the
        caller's OVERALL budget — no retry sequence (attempts + backoff)
        ever exceeds it, and per-attempt timeouts shrink to the remaining
        budget. Transport failures (gRPC errors, injected drops/partitions)
        consume the retry budget; handler exceptions re-raise immediately.
        ``epoch`` stamps the request with the sender's cluster epoch
        (epoch-fenced control plane): an epoch-checking receiver rejects
        stale stamps with a non-retryable RpcStaleEpochError."""
        import random

        from ray_tpu_torch.config import cfg

        if epoch is not None:
            payload = FencedPayload(int(epoch), payload)
        data = wire.dumps(payload)
        if len(data) > _MAX_MSG:
            # gRPC refuses it on the wire; no retry can help
            raise RpcError(
                f"rpc {method} to {self.address}: a {len(data)}-byte message "
                f"is past the {_MAX_MSG}-byte limit"
            )
        attempt = 0
        deadline = (
            None if deadline_s is None else time.monotonic() + deadline_s
        )
        # exponential backoff with decorrelated jitter: each sleep draws
        # uniform in [base, 3*prev], capped — retry bursts from many
        # callers desynchronize instead of hammering a recovering peer in
        # lockstep (the previous linear `interval * attempt` ramp kept
        # every waiter phase-aligned).
        backoff = retry_interval
        cap = max(retry_interval, cfg.rpc_backoff_cap_s)
        br = self._breaker

        def _out_of_time() -> bool:
            return deadline is not None and time.monotonic() >= deadline

        def _raise_deadline(cause: Optional[BaseException]) -> None:
            RPC_DEADLINE_EXCEEDED.inc(labels={"method": method})
            raise RpcDeadlineError(
                f"rpc {method} to {self.address} exceeded the caller "
                f"deadline of {deadline_s}s after {attempt + 1} attempt(s)"
            ) from cause

        while True:
            if _out_of_time():
                _raise_deadline(None)
            if not br.allow():
                # circuit open: fail fast without touching the wire. With
                # retries left we keep (bounded) patience — backoff sleeps
                # line the caller up with the half-open probe window.
                if attempt >= retries:
                    raise PeerUnavailableError(
                        f"rpc {method} to {self.address}: circuit open "
                        f"(peer unavailable)"
                    )
                attempt += 1
            else:
                try:
                    delay = FAULTS.check(self.address)
                    if delay > 0:
                        if deadline is not None:
                            delay = min(
                                delay, max(0.0, deadline - time.monotonic())
                            )
                        time.sleep(delay)
                    _get_chaos().apply(method)
                    att_timeout = timeout
                    if deadline is not None:
                        remaining = max(0.001, deadline - time.monotonic())
                        att_timeout = (
                            remaining
                            if timeout is None
                            else min(timeout, remaining)
                        )
                    try:
                        raw = self._method(method)(
                            data, timeout=att_timeout
                        )
                    except ValueError as exc:
                        # grpc raises bare ValueError ("Cannot invoke RPC
                        # on closed channel") when close() raced this
                        # call — a transport failure, not a caller bug:
                        # surface it as RpcError so retry loops that
                        # rebind their channel (head failover) recover
                        # instead of dying on an uncaught ValueError
                        raise RpcError(
                            f"rpc {method} to {self.address}: channel "
                            "closed under the call"
                        ) from exc
                    ok, value = wire.loads(raw)
                    br.on_success()
                    if not ok:
                        raise value
                    return value
                except (grpc.RpcError, _ChaosDrop, _Blackholed) as exc:
                    br.on_failure()
                    if attempt >= retries:
                        raise RpcError(
                            f"rpc {method} to {self.address} failed: "
                            f"{exc.code() if hasattr(exc, 'code') else exc}"
                        ) from exc
                    if _out_of_time():
                        _raise_deadline(exc)
                    attempt += 1
                    RPC_RETRIES.inc(labels={"method": method})
                except BaseException:
                    # no transport verdict (serialization error, interrupt):
                    # release a half-open probe slot instead of wedging the
                    # breaker, and surface the error unchanged
                    br.abort_probe()
                    raise
            backoff = min(
                cap,
                random.uniform(
                    retry_interval, max(retry_interval, 3.0 * backoff)
                ),
            )
            if deadline is not None:
                backoff = min(backoff, max(0.0, deadline - time.monotonic()))
            time.sleep(backoff)

    def close(self) -> None:
        if self._closed:  # idempotent: the breaker hold releases once
            return
        self._closed = True
        self._breaker.remove_callback(self)
        self._channel.close()
        release_breaker(self.address)


def head_candidates(primary: str, extra: str = "") -> List[str]:
    """The ordered head-address candidate list a peer walks when its
    head stops answering as leader: the configured primary, then every
    ``RAY_TPU_HEAD_STANDBYS`` entry (comma-separated). ``primary`` may
    itself be a comma list (clients accept one)."""
    from ray_tpu_torch.config import cfg

    out: List[str] = []
    for part in (primary or "").split(","):
        part = part.strip()
        if part and part not in out:
            out.append(part)
    for part in (extra or cfg.head_standbys or "").split(","):
        part = part.strip()
        if part and part not in out:
            out.append(part)
    return out


def resolve_leader(
    current_address: str, hint: str = "", extra: str = ""
) -> Optional[str]:
    """The ONE candidate-walk both agents and clients use on a
    NotLeader/unreachable head: leadership hint first, then the
    configured address(es) + RAY_TPU_HEAD_STANDBYS. Returns the
    leader's address (possibly ``current_address`` itself), or None
    while nobody leads (mid-failover — callers retry on their own
    cadence)."""
    cands = ([hint] if hint else []) + head_candidates(
        current_address, extra
    )
    found = probe_leader(cands, timeout=2.0)
    return found[0] if found is not None else None


def probe_leader(
    addresses, timeout: float = 2.0
) -> Optional[tuple]:
    """Walk head candidates asking ``HeadRole`` (fence-exempt on every
    head role) and return ``(address, info)`` of the first one answering
    as leader; standby/fenced replies contribute their ``leader_hint``
    as one extra hop. None when nobody is leading yet (mid-failover —
    callers retry on their own cadence)."""
    hints: List[str] = []
    seen: set = set()
    queue = list(addresses)
    while queue:
        addr = queue.pop(0)
        if not addr or addr in seen:
            continue
        seen.add(addr)
        client = RpcClient(addr)
        try:
            info = client.call("HeadRole", {}, timeout=timeout)
        except Exception:  # noqa: BLE001 - dead candidate, keep walking
            continue
        finally:
            client.close()
        if not isinstance(info, dict):
            continue
        if info.get("role") == "leader":
            return addr, info
        hint = info.get("leader_hint")
        if hint and hint not in seen:
            hints.append(hint)
        if not queue and hints:
            queue.extend(hints)
            hints = []
    return None
