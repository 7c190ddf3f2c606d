"""Lease-routed serving ingress: p2c routing, push-plane streaming.

Port of ``ray_tpu/serve/router.py`` (no JAX in it; over the port's
``cluster/rpc.py``, ``experimental/`` channels, ``util/metrics.py`` and
``config.py``). Its imports of ``.deployment`` and ``.proxy`` stay lazy,
as in the reference.

The request path the serving plane rides end to end:

- **Unary**: admission (:mod:`.admission`) → power-of-two-choices on
  live replica queue depth → the runtime's DIRECT actor channel
  (the push plane: caller→worker ``DirectPushBatch``, results pushed
  back to the caller's callback server) — a steady request stream makes
  **zero per-request head RPCs** once the per-replica channels are
  warm. The head path remains the automatic fallback (channel death,
  in-process runtime).
- **Streaming**: token deltas never poll. Same-host replicas write the
  shm ring Channel (zero-RPC); cross-host replicas get a
  :class:`PushWriter` that pushes delta batches straight to this
  process's :class:`StreamSink` RPC endpoint — worker→ingress, exactly
  like direct-call result pushes, deprecating the polling
  ``_StreamRelayActor`` (which remains only as the
  ``RAY_TPU_SERVE_PUSH_STREAMS=0`` fallback). Writer-side backpressure
  is depth-based (the push reply carries the buffered depth and the
  cancel flag, so an abandoned stream stops generating instead of
  running to completion).
- **Failover**: a replica SIGKILLed mid-stream fails the transport; if
  the deployment declared its streams resumable (deterministic
  regeneration — the LLM engines are per-request deterministic), the
  router re-dispatches to another replica with
  ``resume_from=<delivered count>`` so acked deltas are neither
  duplicated nor dropped, and reports the death so the replica set
  backfills.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

from .admission import AdmissionController, Overloaded, controller_from_cfg

_MS_BOUNDS = (1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000)

# every instrument is labeled by deployment: two deployments in one
# process must not contaminate each other's SLO signals or stats.
# serve_requests_total / TTFT / TPOT additionally carry a "model" label
# (multiplexed deployments must not cross-contaminate per-model SLO
# signals). DUAL-OBSERVE convention: the aggregate series (model="") is
# ALWAYS observed — existing readers that pass only {"deployment": d}
# match exactly that series — and a per-model series is observed in
# addition whenever the request carries a model id.
SERVE_REQUESTS = Counter(
    "serve_requests_total",
    "Serving-plane requests by final status code.",
    label_names=("code", "deployment", "model"),
)
SERVE_TTFT_MS = Histogram(
    "serve_ttft_ms",
    "Time to first streamed delta (ms).",
    boundaries=_MS_BOUNDS,
    label_names=("deployment", "model"),
)
SERVE_TPOT_MS = Histogram(
    "serve_tpot_ms",
    "Mean time per output delta after the first (ms), per stream.",
    boundaries=_MS_BOUNDS,
    label_names=("deployment", "model"),
)
SERVE_E2E_MS = Histogram(
    "serve_e2e_ms",
    "End-to-end request latency (ms).",
    boundaries=_MS_BOUNDS,
    label_names=("deployment",),
)
SERVE_LEASE_HITS = Counter(
    "serve_lease_hits_total",
    "Requests dispatched over a live direct (lease) channel.",
    label_names=("deployment",),
)
SERVE_LEASE_MISSES = Counter(
    "serve_lease_misses_total",
    "Requests dispatched before/without a direct channel (head path or "
    "in-process runtime).",
    label_names=("deployment",),
)
SERVE_FAILOVERS = Counter(
    "serve_stream_failovers_total",
    "Mid-stream replica failovers (resume_from re-dispatches).",
    label_names=("deployment",),
)
SERVE_STREAMS = Gauge(
    "serve_streams_active",
    "Token streams currently open at the router.",
    label_names=("deployment",),
)


class ChannelClosed(Exception):
    """Re-exported stream-end signal (kept import-light; the experimental
    Channel's ChannelClosed is a distinct class — readers here normalize
    both to this one)."""


class StreamRedirected(ChannelClosed):
    """Typed redirect: a push landed on a sink that no longer owns the
    stream's hash range (its router was deposed or replaced). The writer
    must stop generating — the fleet re-dispatches the stream on the
    sibling that inherited the range."""

    def __init__(self, msg: str, epoch: int = 0):
        super().__init__(msg)
        self.epoch = int(epoch)


class RouterKilled(RuntimeError):
    """The ingress ROUTER owning this stream died (chaos router_kill /
    abrupt teardown) — not a replica death. Replica-level failover must
    not fire; recovery is fleet-level: the sibling inheriting the
    tenant's hash range re-dispatches with ``resume_from`` taken from
    the replicated stream-lease table."""


def _request_cost(payload) -> int:
    """Approximate prefill cost of a request in tokens (prompt length):
    the admission controller aggregates it per tenant so the fleet's
    budget reconcile can export QUEUED PREFILL TOKENS — not just request
    counts — as scheduler demand pressure."""
    if isinstance(payload, dict):
        prompt = payload.get("prompt")
        if isinstance(prompt, (str, list)):
            return len(prompt)
    return 0


def _is_closed_exc(exc: BaseException) -> bool:
    from ray_tpu_torch.experimental import ChannelClosed as _CC

    return isinstance(exc, (ChannelClosed, _CC))


def _is_replica_death(exc: BaseException) -> bool:
    """Did this dispatch error mean the REPLICA is gone (failover + kill
    + backfill), or did a healthy replica merely raise (the request is
    bad — killing the replica would let one malformed request serially
    destroy the fleet)? TaskError wraps an exception the replica CODE
    raised, so the replica is alive by construction."""
    from ray_tpu_torch.core.object_store import (
        ObjectLostError,
        OwnerDiedError,
        TaskError,
    )
    from ray_tpu_torch.core.runtime import ActorDiedError, NodeDiedError

    if isinstance(exc, TaskError):
        return False
    if isinstance(
        exc, (ActorDiedError, NodeDiedError, ObjectLostError, OwnerDiedError)
    ):
        return True
    text = repr(exc).lower()
    return any(
        k in text for k in ("died", "dead", "unreachable", "lost", "killed")
    )


# ---------------------------------------------------------------------------
# push-plane stream transport (ingress-side sink + picklable writer)
# ---------------------------------------------------------------------------
class _SinkStream:
    """One stream's reassembly buffer at the ingress: batches arrive as
    ``(seq, items, closed)`` (actor-side ordering restored by sequence
    number), readers drain in order. Bounded: a writer that ignores the
    depth contract gets a BufferError back through the push RPC."""

    def __init__(self, max_buffer: int):
        self._stash: Dict[int, tuple] = {}
        self._next_seq = 0
        self._buf: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.cancelled = False
        self._error: Optional[BaseException] = None
        self._max = max_buffer

    def push(self, seq: int, items: list, closed: bool) -> dict:
        with self._cv:
            if self.cancelled:
                return {"depth": len(self._buf), "cancelled": True}
            if len(self._buf) > self._max and not closed:
                raise BufferError(
                    "serve stream sink overrun (consumer stalled and the "
                    "writer ignored backpressure)"
                )
            self._stash[seq] = (items, closed)
            while self._next_seq in self._stash:
                its, cl = self._stash.pop(self._next_seq)
                self._buf.extend(its)
                if cl:
                    self._closed = True
                self._next_seq += 1
            self._cv.notify_all()
            return {"depth": len(self._buf), "cancelled": False}

    def read(self, timeout: Optional[float] = None):
        with self._cv:
            if (
                not self._buf
                and not self._closed
                and not self.cancelled
                and self._error is None
            ):
                self._cv.wait(timeout=timeout if timeout is not None else 5.0)
            if self._buf:
                return self._buf.popleft()
            if self._error is not None:
                # transport failed under the reader (router killed):
                # surface it immediately — waiting out the read window
                # would eat the whole failover budget doing nothing
                raise self._error
            if self._closed or self.cancelled:
                # cancel counts as end-of-stream reader-side too: a
                # blocked reader must not wait out its window (and then
                # misread the cancel-induced replica error as a replica
                # DEATH worth failing over)
                raise ChannelClosed("stream ended")
            raise TimeoutError("no deltas in window")

    def cancel(self) -> None:
        with self._cv:
            self.cancelled = True
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Poison the stream: the next (or a blocked) read raises
        ``exc`` instead of draining the window. Buffered deltas stay
        readable — they were acked to the writer, and the failover
        resume point must count them."""
        with self._cv:
            self._error = exc
            self._cv.notify_all()


class StreamSink:
    """Per-ROUTER push endpoint for token deltas: replica workers RPC
    ``ServeStreamPush`` batches straight here — the streaming analog of
    the direct-call result push plane (no relay actor, no polling, no
    head involvement).

    Fate-shared with its owning router (``router_id``): closing the
    router stops the sink, and a DEPOSED router's sink answers every
    push with a typed redirect (``{"redirect": True}`` →
    :class:`StreamRedirected` writer-side) instead of silently accepting
    deltas for hash ranges it no longer owns."""

    def __init__(self, router_id: str = ""):
        from ray_tpu_torch.cluster.rpc import RpcServer

        self.router_id = router_id
        self._lock = threading.Lock()
        self._streams: Dict[str, _SinkStream] = {}
        self._deposed_epoch: Optional[int] = None
        self._server = RpcServer(
            {"ServeStreamPush": self._h_push, "Ping": lambda r: "pong"},
            port=0,
            max_workers=8,
        )
        self.address = self._server.address

    def open(self) -> Tuple[str, _SinkStream]:
        from ray_tpu_torch.config import cfg

        sid = uuid.uuid4().hex
        stream = _SinkStream(max_buffer=int(cfg.serve_stream_buffer))
        with self._lock:
            self._streams[sid] = stream
        return sid, stream

    def discard(self, sid: str) -> None:
        with self._lock:
            stream = self._streams.pop(sid, None)
        if stream is not None:
            stream.cancel()

    def _h_push(self, req: dict) -> dict:
        with self._lock:
            if self._deposed_epoch is not None:
                # this router lost its hash ranges: a stale replica
                # still pushing here gets a TYPED redirect, never a
                # silent accept into a buffer nobody reads
                return {
                    "redirect": True,
                    "epoch": self._deposed_epoch,
                    "depth": 0,
                    "cancelled": True,
                }
            stream = self._streams.get(req["stream_id"])
        if stream is None:
            # unknown/finished stream: tell the writer to stop generating
            return {"depth": 0, "cancelled": True}
        return stream.push(
            int(req["seq"]), list(req.get("items") or ()), bool(req.get("closed"))
        )

    def depose(self, epoch: int) -> None:
        """The router was replaced at assignment ``epoch``: reject every
        further push with a typed redirect and end the registered
        streams (their consumers re-dispatch through the new owner)."""
        with self._lock:
            self._deposed_epoch = int(epoch)
            streams, self._streams = list(self._streams.values()), {}
        for s in streams:
            s.fail(
                RouterKilled(
                    f"router {self.router_id or '?'} deposed at "
                    f"assignment epoch {epoch}"
                )
            )

    def chaos_kill(self) -> None:
        """Abrupt router death (chaos ``router_kill``): the RPC endpoint
        vanishes mid-push and every registered stream FAILS (not a clean
        close — a killed router's streams must not masquerade as
        complete). Writers see the sink unreachable and stop
        generating, exactly the SIGKILL shape."""
        with self._lock:
            streams, self._streams = list(self._streams.values()), {}
        try:
            self._server.stop()
        except Exception:  # noqa: BLE001 - already down
            pass
        rid = self.router_id or "?"
        for s in streams:
            s.fail(RouterKilled(f"router {rid} killed mid-stream"))

    def stop(self) -> None:
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            s.cancel()
        self._server.stop()


_sink_lock = threading.Lock()
_sink: Optional[StreamSink] = None


def stream_sink() -> StreamSink:
    """Back-compat process-wide sink. Routers own their sinks now
    (``ServeRouter._own_sink`` — fate-shared lifecycle); this singleton
    remains only for callers that predate the fleet."""
    global _sink
    with _sink_lock:
        if _sink is None:
            _sink = StreamSink()
        return _sink


def shutdown_sink() -> None:
    """Tear down the process's push endpoint (serve.shutdown path): the
    RpcServer, its worker threads, and any still-registered streams go
    away; the next stream lazily builds a fresh sink."""
    global _sink
    with _sink_lock:
        sink, _sink = _sink, None
    if sink is not None:
        sink.stop()


class PushWriter:
    """ChannelWriter-compatible handle shipped to a replica: ``write``
    pushes delta batches straight to the ingress StreamSink. The push
    reply's depth throttles the writer and its cancel flag aborts the
    stream (client-disconnect propagation: the replica's generator
    unwinds and the engine reclaims the slot).

    Writes micro-batch adaptively: a delta ships immediately when the
    stream is trickling (keeps TTFT/TPOT at token cadence), but deltas
    produced faster than ``FLUSH_S`` coalesce into one push RPC — a
    fast decode loop is not capped at one token per round trip."""

    THROTTLE_DEPTH = 2048
    FLUSH_S = 0.005
    MAX_BATCH = 64

    def __init__(self, address: str, stream_id: str):
        self._address = address
        self._sid = stream_id
        self._seq = 0
        self._client = None
        self._buf: list = []
        self._last_flush = 0.0

    def _push(self, items: list, closed: bool = False) -> None:
        from ray_tpu_torch.cluster.rpc import RpcClient, RpcError
        from ray_tpu_torch.experimental import ChannelClosed as _CC

        if self._client is None:
            self._client = RpcClient(self._address)
        try:
            reply = self._client.call(
                "ServeStreamPush",
                {
                    "stream_id": self._sid,
                    "seq": self._seq,
                    "items": items,
                    "closed": closed,
                },
                timeout=30.0,
            )
        except RpcError as exc:
            # ingress gone: stop generating (same contract as a closed ring)
            raise _CC(f"serve stream sink unreachable: {exc!r}") from exc
        self._seq += 1
        if reply.get("redirect"):
            raise StreamRedirected(
                "serve stream sink deposed (hash range moved)",
                epoch=int(reply.get("epoch") or 0),
            )
        if reply.get("cancelled") and not closed:
            raise _CC("consumer cancelled the stream")
        depth = int(reply.get("depth") or 0)
        while depth > self.THROTTLE_DEPTH and not closed:
            time.sleep(0.02)
            try:
                reply = self._client.call(
                    "ServeStreamPush",
                    {
                        "stream_id": self._sid,
                        "seq": self._seq,
                        "items": [],
                        "closed": False,
                    },
                    timeout=30.0,
                )
            except RpcError as exc:
                raise _CC(
                    f"serve stream sink unreachable: {exc!r}"
                ) from exc
            self._seq += 1
            if reply.get("redirect"):
                raise StreamRedirected(
                    "serve stream sink deposed (hash range moved)",
                    epoch=int(reply.get("epoch") or 0),
                )
            if reply.get("cancelled"):
                raise _CC("consumer cancelled the stream")
            depth = int(reply.get("depth") or 0)

    def write(self, value, timeout=None) -> None:
        self._buf.append(value)
        now = time.monotonic()
        if (
            now - self._last_flush >= self.FLUSH_S
            or len(self._buf) >= self.MAX_BATCH
        ):
            self._flush(now)

    def _flush(self, now: float) -> None:
        batch, self._buf = self._buf, []
        self._last_flush = now
        self._push(batch)

    def close_channel(self) -> None:
        try:
            batch, self._buf = self._buf, []
            self._push(batch, closed=True)
        except Exception:  # noqa: BLE001 - consumer already gone
            pass

    def close(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    def __reduce__(self):
        return (PushWriter, (self._address, self._sid))


# ---------------------------------------------------------------------------
# routed streams
# ---------------------------------------------------------------------------
class RoutedStream:
    """Consumer view of one routed token stream: ``read()`` yields
    deltas in order across transports AND across replica failovers;
    ``close()`` releases the admission slot and propagates cancellation
    to the producing replica. Raises :class:`ChannelClosed` at end of
    stream."""

    def __init__(
        self,
        router: "ServeRouter",
        payload,
        tenant: str,
        ticket,
        resume_base: int = 0,
    ):
        self._router = router
        self._payload = payload
        self._ticket = ticket
        self.tenant = tenant
        # deltas already delivered by a PREVIOUS router incarnation
        # (fleet failover): every dispatch resumes past base+delivered,
        # so a replica failover after a router failover still skips the
        # full acked prefix
        self.resume_base = int(resume_base)
        self.delivered = 0
        self.failovers = 0
        self._t0 = time.monotonic()
        self._t0_wall = time.time()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._finished = False
        self._reader = self._ref = self._replica = None
        self._cleanup = lambda cancelled=False: None
        self._labels = {"deployment": router._rs.dep.name}
        self.model = (
            payload.get("model") if isinstance(payload, dict) else None
        )
        # dual-observe: model-tagged requests additionally land on the
        # per-model series of the model-labeled instruments
        self._mlabels = (
            {**self._labels, "model": str(self.model)} if self.model else None
        )
        SERVE_STREAMS.inc(labels=self._labels)
        try:
            self._attach(router._dispatch_stream(payload, self.resume_base))
        except BaseException:
            self._finish("500")
            raise

    def _attach(self, dispatched) -> None:
        self._reader, self._ref, self._replica, self._cleanup = dispatched

    # -- consumption ----------------------------------------------------
    def read(self, timeout: Optional[float] = None):
        if self._finished:
            raise ChannelClosed("stream closed")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            window = 2.0
            if deadline is not None:
                window = min(window, max(0.05, deadline - time.monotonic()))
            try:
                value = self._reader.read(timeout=window)
            except BaseException as exc:  # noqa: BLE001
                if _is_closed_exc(exc):
                    self._finish("200")
                    raise ChannelClosed("stream ended") from None
                if isinstance(exc, TimeoutError):
                    outcome = self._probe()
                    if outcome is None:  # replica still running
                        if (
                            deadline is not None
                            and time.monotonic() >= deadline
                        ):
                            raise TimeoutError("no deltas in window")
                        continue
                    if outcome == "done":
                        return self._drain_tail()
                    # replica failed mid-stream
                    if self._try_failover(outcome):
                        continue
                    self._finish("500")
                    raise outcome
                # transport trouble (e.g. ring destroyed under us)
                if self._try_failover(exc):
                    continue
                self._finish("500")
                raise
            now = time.monotonic()
            if self._t_first is None:
                self._t_first = now
                ttft = (now - self._t0) * 1000.0
                SERVE_TTFT_MS.observe(ttft, labels=self._labels)
                if self._mlabels:
                    SERVE_TTFT_MS.observe(ttft, labels=self._mlabels)
            self._t_last = now
            self.delivered += 1
            return value

    def __iter__(self):
        while True:
            try:
                yield self.read()
            except ChannelClosed:
                return

    def _probe(self):
        """None = still running; "done" = method returned; an exception
        = the replica call failed (death, raise)."""
        try:
            ray_tpu_torch.get(self._ref, timeout=0.05)
            return "done"
        except ray_tpu_torch.GetTimeoutError:
            return None
        except BaseException as exc:  # noqa: BLE001
            return exc

    def _drain_tail(self):
        """The replica method returned: drain what it wrote between our
        timeout and the probe, then end the stream. A method that
        returned WITHOUT closing its channel is an error, not a clean
        end — a swallowed close would silently truncate the stream."""
        try:
            value = self._reader.read(timeout=0.5)
        except TimeoutError:
            self._finish("500")
            raise RuntimeError(
                "stream_to returned without close_channel() — stream "
                "truncated"
            ) from None
        except BaseException as exc:  # noqa: BLE001
            self._finish("200")
            raise ChannelClosed("stream ended") from (
                None if _is_closed_exc(exc) else exc
            )
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now
            ttft = (now - self._t0) * 1000.0
            SERVE_TTFT_MS.observe(ttft, labels=self._labels)
            if self._mlabels:
                SERVE_TTFT_MS.observe(ttft, labels=self._mlabels)
        self._t_last = now
        self.delivered += 1
        return value

    # -- failover -------------------------------------------------------
    def _try_failover(self, exc) -> bool:
        from ray_tpu_torch.config import cfg

        if self._finished:
            # consumer already closed (disconnect): the replica error we
            # observed is our own cancellation, not a death worth a
            # re-dispatch — a failover here would leak a sink stream
            # nobody reads and wedge a replica slot generating into it
            return False
        if isinstance(exc, RouterKilled):
            # the ROUTER died, not the replica: replica-level failover
            # would re-dispatch through the corpse. Surface the error —
            # the fleet re-dispatches on the sibling that inherited the
            # tenant's hash range.
            return False
        if isinstance(exc, BaseException) and not _is_replica_death(exc):
            return False  # application error from a healthy replica
        if not self._router.resumable:
            return False
        if self.failovers >= int(cfg.serve_stream_failover):
            return False
        self.failovers += 1
        SERVE_FAILOVERS.inc(labels=self._labels)
        try:
            self._cleanup(cancelled=False)
        except Exception:  # noqa: BLE001
            pass
        self._router._note_replica_failure(self._replica, exc)
        # resume_from = deltas ALREADY HANDED to the consumer (plus any
        # prefix a previous router incarnation delivered): the new
        # replica regenerates deterministically and skips exactly those,
        # so acked deltas are neither repeated nor lost
        self._attach(
            self._router._dispatch_stream(
                self._payload, self.resume_base + self.delivered
            )
        )
        return True

    # -- teardown -------------------------------------------------------
    def _finish(self, code: str) -> None:
        if self._finished:
            return
        self._finished = True
        try:
            # release the transport on EVERY terminal path (end-of-
            # stream included) — a consumer that never calls close()
            # must not leak ring files or sink entries
            self._cleanup(cancelled=False)
        except Exception:  # noqa: BLE001
            pass
        SERVE_STREAMS.dec(labels=self._labels)
        SERVE_REQUESTS.inc(labels={"code": code, **self._labels})
        if self._mlabels:
            SERVE_REQUESTS.inc(labels={"code": code, **self._mlabels})
        SERVE_E2E_MS.observe(
            (time.monotonic() - self._t0) * 1000.0, labels=self._labels
        )
        if (
            self._t_first is not None
            and self._t_last is not None
            and self.delivered > 1
        ):
            tpot = (
                (self._t_last - self._t_first)
                / (self.delivered - 1)
                * 1000.0
            )
            SERVE_TPOT_MS.observe(tpot, labels=self._labels)
            if self._mlabels:
                SERVE_TPOT_MS.observe(tpot, labels=self._mlabels)
        try:
            # request-lifecycle span: one slice per stream in
            # the Chrome-trace export, beside the task slices it caused
            from ray_tpu_torch.util.tracing import SPANS

            SPANS.record(
                "serve_stream",
                "serve",
                self._t0_wall,
                time.monotonic() - self._t0,
                pid=f"serve:{self._labels['deployment']}",
                code=code,
                delivered=self.delivered,
                failovers=self.failovers,
                ttft_ms=(
                    (self._t_first - self._t0) * 1000.0
                    if self._t_first is not None
                    else None
                ),
            )
        except Exception:  # noqa: BLE001 - observability only
            pass
        self._router._note_finished(code)
        self._ticket.done()

    def close(self) -> None:
        """Consumer done (or gone): cancel the transport so the replica
        stops generating, release the admission slot."""
        try:
            self._cleanup(cancelled=True)
        except Exception:  # noqa: BLE001
            pass
        self._finish("499")  # no-op if the stream already ended cleanly


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
class _UnaryRequest:
    def __init__(self, router, ref, ticket, t0, model=None):
        self._router = router
        self.ref = ref
        self._ticket = ticket
        self._t0 = t0
        self._t0_wall = time.time()
        self._done = False
        self._labels = {"deployment": router._rs.dep.name}
        self._mlabels = (
            {**self._labels, "model": str(model)} if model else None
        )

    def result(self, timeout: float = 60.0):
        try:
            value = ray_tpu_torch.get(self.ref, timeout=timeout)
        except ray_tpu_torch.GetTimeoutError:
            # the replica is STILL WORKING: best-effort cancel, and only
            # then release the admission slot — releasing while the work
            # runs would let admission overfill saturated replicas
            try:
                ray_tpu_torch.cancel(self.ref)
            except Exception:  # noqa: BLE001 - cancel is best-effort
                pass
            self._finish("504")
            raise
        except BaseException:
            self._finish("500")
            raise
        self._finish("200")
        return value

    def _finish(self, code: str) -> None:
        if not self._done:
            self._done = True
            SERVE_REQUESTS.inc(labels={"code": code, **self._labels})
            if self._mlabels:
                SERVE_REQUESTS.inc(labels={"code": code, **self._mlabels})
            SERVE_E2E_MS.observe(
                (time.monotonic() - self._t0) * 1000.0,
                labels=self._labels,
            )
            try:
                from ray_tpu_torch.util.tracing import SPANS

                SPANS.record(
                    "serve_unary",
                    "serve",
                    self._t0_wall,
                    time.monotonic() - self._t0,
                    pid=f"serve:{self._labels['deployment']}",
                    code=code,
                )
            except Exception:  # noqa: BLE001 - observability only
                pass
            self._router._note_finished(code)
            self._ticket.done()


class ServeRouter:
    """Per-deployment ingress router over a ``_ReplicaSet``."""

    def __init__(
        self,
        replica_set,
        admission: Optional[AdmissionController] = None,
        router_id: str = "r0",
    ):
        self._rs = replica_set
        self.router_id = router_id
        self.admission = admission or controller_from_cfg()
        self.resumable = bool(
            getattr(replica_set.dep, "resumable_streams", False)
        )
        self._labels = {"deployment": replica_set.dep.name}
        self._stats_lock = threading.Lock()
        self._codes: Dict[str, int] = {}
        # rolling TTFT window for the SLO autoscaler (ts, ttft snapshot
        # via histogram diffing is global; keep a local recent-read list)
        self._recent_ttft: deque = deque(maxlen=256)
        self._host_cache: dict = {}
        self._hosts = None
        self._closed = False
        self.killed = False
        # per-router push sink, built on first streaming dispatch and
        # fate-shared with this router (close/kill/depose) — a replaced
        # router's sink must never keep accepting pushes for streams
        # nobody reads
        self._sink: Optional[StreamSink] = None
        self._sink_lock = threading.Lock()
        self._reporter: Optional[threading.Thread] = None

    # -- unary ----------------------------------------------------------
    def submit(
        self, payload, tenant: str = "default", method: str = "__call__"
    ) -> _UnaryRequest:
        from .deployment import NoReplicasForModel

        model = (
            payload.get("model") if isinstance(payload, dict) else None
        )
        ticket = self.admission.admit(
            tenant, cost=_request_cost(payload)
        )
        t0 = time.monotonic()
        hit = None
        try:
            ref, replica = self._rs.submit_traced(
                method, (payload,), {}, model=model
            )
            hit = self._lease_hit(replica)
        except BaseException as exc:
            ticket.done()
            # per-model empty set is retryable (503), not a server error
            code = "503" if isinstance(exc, NoReplicasForModel) else "500"
            SERVE_REQUESTS.inc(labels={"code": code, **self._labels})
            if model:
                SERVE_REQUESTS.inc(
                    labels={
                        "code": code,
                        **self._labels,
                        "model": str(model),
                    }
                )
            self._note_finished(code)
            raise
        (SERVE_LEASE_HITS if hit else SERVE_LEASE_MISSES).inc(
            labels=self._labels
        )
        return _UnaryRequest(self, ref, ticket, t0, model=model)

    def call(
        self,
        payload,
        tenant: str = "default",
        timeout: float = 60.0,
        method: str = "__call__",
    ):
        return self.submit(payload, tenant, method).result(timeout)

    # -- streaming ------------------------------------------------------
    def stream(
        self, payload, tenant: str = "default", resume_base: int = 0
    ) -> RoutedStream:
        ticket = self.admission.admit(
            tenant, cost=_request_cost(payload)
        )
        try:
            return RoutedStream(
                self, payload, tenant, ticket, resume_base=resume_base
            )
        except Overloaded:
            raise
        except BaseException:
            ticket.done()
            raise

    def _dispatch_stream(self, payload, resume_from: int):
        """Pick transport + replica, dispatch ``stream_to``. Returns
        ``(reader, ref, replica, cleanup(cancelled=...))``."""
        from ray_tpu_torch.config import cfg

        model = (
            payload.get("model") if isinstance(payload, dict) else None
        )
        req = payload
        if resume_from:
            req = dict(payload or {})
            req["resume_from"] = int(resume_from)
        pref_ref = self._maybe_prefill(payload, resume_from, model)
        if pref_ref is not None:
            # ship the prefill result BY REFERENCE nested under a list:
            # only top-level ObjectRef args resolve at dispatch, so the
            # decode replica receives the ref itself and pulls the
            # sealed KV pages over the data plane (land="device") —
            # never through this router
            req = dict(req if resume_from else (payload or {}))
            req["handoff"] = [pref_ref]
        if cfg.serve_shm_streams:
            dispatched = self._try_shm_stream(req, model)
            if dispatched is not None:
                return dispatched
        if cfg.serve_push_streams:
            sink = self._own_sink()
            sid, stream = sink.open()
            writer = PushWriter(sink.address, sid)
            try:
                ref, replica = self._rs.submit_traced(
                    "stream_to", (writer, req), {}, model=model
                )
            except BaseException:
                sink.discard(sid)
                raise
            (
                SERVE_LEASE_HITS
                if self._lease_hit(replica)
                else SERVE_LEASE_MISSES
            ).inc(labels=self._labels)

            def cleanup(cancelled: bool = False, _sid=sid):
                sink.discard(_sid)

            return stream, ref, replica, cleanup
        # legacy polling relay fallback (cross-host, push plane disabled)
        from .proxy import start_stream

        ch, relay_actor, reader, ref = start_stream(
            self._rs, req, self._same_host_pred()
        )

        def cleanup(cancelled: bool = False):
            if relay_actor is not None:
                if cancelled:
                    try:
                        ray_tpu_torch.get(
                            relay_actor.cancel.remote(), timeout=5
                        )
                    except Exception:  # noqa: BLE001
                        pass
                try:
                    ray_tpu_torch.kill(relay_actor)
                except Exception:  # noqa: BLE001
                    pass
            if ch is not None:
                ch.destroy()

        return reader, ref, None, cleanup

    def _maybe_prefill(self, payload, resume_from: int, model):
        """Disaggregated split: when this deployment has a companion
        prefill fleet, run the prefill phase there and return the
        (unresolved) result ref — ``(manifest, k, v)`` with the KV pages
        sealed as device frames. Returns None when disaggregation does
        not apply: monolithic deployment, non-prompt payload, or a
        FAILOVER re-dispatch (``resume_from > 0`` re-prefills locally on
        the sibling — deterministic generation keeps it token-exact,
        and the dead prefill node is out of the path)."""
        pref_name = getattr(self._rs.dep, "prefill_deployment", None)
        if (
            not pref_name
            or resume_from
            or not isinstance(payload, dict)
            or "prompt" not in payload
        ):
            return None
        from .deployment import _apps

        pref_rs = _apps.get(pref_name)
        if pref_rs is None:
            return None
        try:
            ref, _replica = pref_rs.submit_traced(
                "prefill", (dict(payload),), {}, model=model
            )
            return ref
        except Exception:  # noqa: BLE001
            # prefill fleet unavailable (backfill window, dead node):
            # monolithic fallback — the decode replica prefills locally
            return None

    def _try_shm_stream(self, req, model=None):
        """Same-host shm ring (strictly pinned); None when no same-host
        replica exists."""
        from ray_tpu_torch.experimental import Channel

        from .deployment import NoPreferredReplica

        pred = self._same_host_pred()
        with self._rs.lock:
            cands = [r for r in self._rs.replicas if not r.draining] or list(
                self._rs.replicas
            )
        if not any(pred(r) for r in cands):
            return None
        ch = Channel(buffer_size_bytes=1 << 18)
        try:
            ref, replica = self._rs.submit_traced(
                "stream_to",
                (ch.writer, req),
                {},
                prefer=pred,
                strict_prefer=True,
                model=model,
            )
        except NoPreferredReplica:
            ch.destroy()
            return None
        except BaseException:
            ch.destroy()
            raise
        (
            SERVE_LEASE_HITS
            if self._lease_hit(replica)
            else SERVE_LEASE_MISSES
        ).inc(labels=self._labels)

        def cleanup(cancelled: bool = False):
            # destroying the ring flips its closed flag: the replica's
            # next write raises ChannelClosed and generation stops
            ch.destroy()

        return ch.reader, ref, replica, cleanup

    def _own_sink(self) -> StreamSink:
        """This router's push endpoint (lazy — unary-only deployments
        never pay for the RpcServer). Fate-shared: close()/chaos_kill()/
        depose() act on it, unlike the old process-wide singleton whose
        lifetime nobody owned."""
        with self._sink_lock:
            if self._sink is None:
                if self._closed:
                    raise RouterKilled(
                        f"router {self.router_id} is closed"
                    )
                self._sink = StreamSink(router_id=self.router_id)
            return self._sink

    def _same_host_pred(self):
        from .proxy import _local_hosts, same_host_predicate

        if self._hosts is None:
            self._hosts = _local_hosts()
        return same_host_predicate(self._host_cache, self._hosts)

    # -- bookkeeping ----------------------------------------------------
    def _lease_hit(self, replica) -> bool:
        """Did this dispatch ride a live direct channel (zero head RPCs)
        rather than warming one / falling back to the head path?"""
        if replica is None:
            return False
        try:
            from ray_tpu_torch.core.runtime import get_runtime

            rt = get_runtime()
            if not getattr(rt, "is_remote", False):
                return False
            aid = getattr(replica.actor, "_actor_id", None)
            chan = rt._direct_channels.get(aid) if aid else None
            return chan is not None and not getattr(chan, "_dead", False)
        except Exception:  # noqa: BLE001
            return False

    def _note_replica_failure(self, replica, exc) -> None:
        if replica is not None:
            self._rs.note_replica_death(replica)

    def _note_finished(self, code: str) -> None:
        with self._stats_lock:
            self._codes[code] = self._codes.get(code, 0) + 1

    def note_ttft_sample(self, ttft_ms: float) -> None:
        with self._stats_lock:
            self._recent_ttft.append((time.monotonic(), ttft_ms))

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        with self._stats_lock:
            codes = dict(self._codes)
        with self._rs.lock:
            replicas = [
                {
                    "actor_id": getattr(r.actor, "_actor_id", None),
                    "ongoing": r.ongoing,
                    "draining": r.draining,
                    "model": r.model,
                }
                for r in self._rs.replicas
            ]
        hits = SERVE_LEASE_HITS.value(self._labels)
        misses = SERVE_LEASE_MISSES.value(self._labels)
        return {
            "deployment": self._rs.dep.name,
            "router_id": self.router_id,
            "replicas": replicas,
            "codes": codes,
            "admission": self.admission.stats(),
            "lease_hits": hits,
            "lease_misses": misses,
            "lease_hit_rate": (
                round(hits / (hits + misses), 4) if hits + misses else None
            ),
            "ttft_ms": SERVE_TTFT_MS.summary(self._labels),
            "e2e_ms": SERVE_E2E_MS.summary(self._labels),
            "streams_active": SERVE_STREAMS.value(self._labels),
            "failovers": SERVE_FAILOVERS.value(self._labels),
            "resumable": self.resumable,
        }

    def start_reporting(self, extra_stats_fn=None) -> None:
        """Periodic serve-state report to the head (control-plane
        cadence; powers head QueryState("serve")). No-op off-cluster."""
        from ray_tpu_torch.config import cfg
        from ray_tpu_torch.core.runtime import get_runtime

        try:
            rt = get_runtime()
        except Exception:  # noqa: BLE001
            return
        if not getattr(rt, "is_remote", False) or self._reporter is not None:
            return

        def loop():
            while not self._closed:
                time.sleep(max(0.1, float(cfg.serve_report_period_s)))
                blob = self.stats()
                if extra_stats_fn is not None:
                    try:
                        blob["engine"] = extra_stats_fn()
                    except Exception:  # noqa: BLE001
                        pass
                try:
                    rt.head.call(
                        "ReportServeState",
                        {
                            "client_id": rt.client_id,
                            "deployment": self._rs.dep.name,
                            "state": blob,
                        },
                        timeout=5.0,
                    )
                except Exception:  # noqa: BLE001 - head mid-restart
                    pass

        self._reporter = threading.Thread(
            target=loop, name=f"serve-report-{self._rs.dep.name}", daemon=True
        )
        self._reporter.start()

    def close(self) -> None:
        """Graceful teardown; the sink fate-shares (satellite of the old
        leaked-singleton bug: a replaced router's sink kept accepting
        pushes forever)."""
        self._closed = True
        with self._sink_lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            sink.stop()

    def depose(self, epoch: int) -> None:
        """This router lost its hash ranges at assignment ``epoch``:
        further pushes get a typed redirect, registered streams end with
        :class:`RouterKilled` so their consumers re-dispatch through the
        new owner."""
        self._closed = True
        with self._sink_lock:
            sink = self._sink
        if sink is not None:
            sink.depose(epoch)

    def chaos_kill(self) -> None:
        """Abrupt death for chaos ``router_kill``: the push endpoint
        vanishes, in-flight streams FAIL (no clean close), admission
        state is lost with the process — the SIGKILL shape for an
        in-process router."""
        self.killed = True
        self._closed = True
        with self._sink_lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            sink.chaos_kill()
