"""Async HTTP ingress for Serve deployments.

Port of ``ray_tpu/serve/proxy.py`` (no JAX in it; aiohttp is imported
only where the proxy starts).

The analog of the reference's proxy tier
(Ray Serve's ``_private/proxy.py`` — an ASGI/aiohttp
server routing HTTP to replica handles): an aiohttp application that

- routes ``POST /<deployment>`` to the deployment's ``__call__`` through
  the same replica-set balancing as handle calls (blocking object-plane
  waits run in an executor so the event loop keeps multiplexing),
- streams ``POST /<deployment>/stream`` as Server-Sent Events: the
  replica writes values into a mutable-object Channel
  (ray_tpu_torch.experimental) via its ``stream_to(writer, payload)`` method
  and the proxy relays them as they arrive — token streaming for the
  LLM tier rides this end to end,
- serves ``GET /-/healthz`` and ``GET /-/routes`` for probes/discovery.

Runs on a dedicated thread with its own event loop; the stdlib fallback
in deployment.py remains for environments without aiohttp.
"""
from __future__ import annotations

import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import ray_tpu_torch


class _StreamRelayActor:
    """DEPRECATED polling bridge for cross-host streaming, kept only as
    the ``RAY_TPU_SERVE_PUSH_STREAMS=0`` fallback: the default cross-host
    transport is the router's :class:`~ray_tpu_torch.serve.router.StreamSink`
    push plane (replica pushes straight to the ingress process — no
    relay actor, no ``pop`` long-poll). Where the relay remains, its
    buffers are hard-bounded and ``cancel`` propagates client
    disconnects back to the writer so an abandoned stream stops
    generating instead of running to completion."""

    MAX_STASH = 1024  # out-of-order reassembly bound (seq -> batch)

    def __init__(self, max_buffer: int = 4096):
        from collections import deque

        self._stash: dict = {}  # seq -> (items, closed)
        self._next_seq = 0
        self._out = deque()
        self._closed = False
        self._cancelled = False
        self._max = max_buffer
        self._event = None  # created lazily on the actor's event loop

    def _ev(self):
        import asyncio

        if self._event is None:
            self._event = asyncio.Event()
        return self._event

    async def push(self, seq: int, items: list, closed: bool = False) -> int:
        """Returns the current queue depth, or -1 once the consumer
        cancelled (the writer must stop). Backpressure is writer-side
        (throttle on the returned depth) — parking here would hold the
        actor's concurrency slots and starve pop(). A writer that ignores
        the depth contract hits the hard bounds below: the push fails,
        the stream dies, memory stays bounded."""
        if self._cancelled:
            return -1
        if len(self._out) > 4 * self._max and not closed:
            raise BufferError(
                "stream relay buffer overrun (consumer stalled and the "
                "writer ignored backpressure)"
            )
        if len(self._stash) > self.MAX_STASH:
            raise BufferError(
                "stream relay reassembly overrun (sequence gap never "
                "filled while the writer kept pushing)"
            )
        self._stash[seq] = (items, closed)
        while self._next_seq in self._stash:
            its, cl = self._stash.pop(self._next_seq)
            self._out.extend(its)
            if cl:
                self._closed = True
            self._next_seq += 1
        self._ev().set()
        return len(self._out)

    async def cancel(self) -> None:
        """Client disconnected: drop buffered items and tell the writer
        (via the -1 push reply) to abandon generation."""
        self._cancelled = True
        self._closed = True
        self._out.clear()
        self._stash.clear()
        self._ev().set()

    async def depth(self) -> int:
        return -1 if self._cancelled else len(self._out)

    async def pop(self, max_items: int = 256, timeout: float = 5.0):
        """Returns (items, ended). ended only once the queue is drained."""
        import asyncio

        if not self._out and not self._closed:
            self._ev().clear()
            try:
                await asyncio.wait_for(self._ev().wait(), timeout)
            except asyncio.TimeoutError:
                pass
        items = []
        while self._out and len(items) < max_items:
            items.append(self._out.popleft())
        return items, self._closed and not self._out


class _RelayWriter:
    """ChannelWriter-compatible handle shipped to a cross-host replica:
    ``write``/``close_channel`` become actor pushes with a bounded
    in-flight window (ordering restored actor-side by sequence number)."""

    def __init__(self, actor):
        self._actor = actor
        self._seq = 0
        self._pending = []

    def write(self, value, timeout=None) -> None:
        import time as _time

        from ray_tpu_torch.experimental import ChannelClosed

        ref = self._actor.push.remote(self._seq, [value])
        self._seq += 1
        self._pending.append(ref)
        if len(self._pending) > 32:
            depth = ray_tpu_torch.get(self._pending.pop(0), timeout=30)
            if depth < 0:  # consumer cancelled: abandon generation
                raise ChannelClosed("consumer cancelled the stream")
            # a stalled consumer shows up as queue depth: throttle here
            # (writer-side) instead of parking inside the actor
            while depth > 4096:
                _time.sleep(0.05)
                depth = ray_tpu_torch.get(self._actor.depth.remote(), timeout=30)
                if depth < 0:
                    raise ChannelClosed("consumer cancelled the stream")

    def close_channel(self) -> None:
        refs = self._pending + [self._actor.push.remote(self._seq, [], True)]
        self._seq += 1
        self._pending = []
        for r in refs:
            try:
                ray_tpu_torch.get(r, timeout=30)
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        pass

    def __reduce__(self):
        return (_RelayWriter, (self._actor,))


class _RelayReader:
    """ChannelReader-compatible proxy-side view of a _StreamRelayActor."""

    def __init__(self, actor):
        from collections import deque

        self._actor = actor
        self._buf = deque()
        self._ended = False

    def read(self, timeout=None):
        from ray_tpu_torch.experimental import ChannelClosed

        if self._buf:
            return self._buf.popleft()
        if self._ended:
            raise ChannelClosed("stream ended")
        window = timeout if timeout is not None else 5.0
        items, ended = ray_tpu_torch.get(
            self._actor.pop.remote(256, window), timeout=window + 30
        )
        self._buf.extend(items)
        self._ended = ended
        if self._buf:
            return self._buf.popleft()
        if self._ended:
            raise ChannelClosed("stream ended")
        raise TimeoutError("no items in window")


def start_stream(rs, payload, same_host_pred):
    """Blocking transport selection + dispatch shared by the HTTP and gRPC
    ingresses. Returns (ch, relay_actor, reader, ref); on error every
    partially-created resource is cleaned up before the exception
    propagates. Same-host replicas get the shm ring (strictly pinned — a
    same-host-only writer must never reach a cross-host replica); with
    only cross-host replicas a relay actor bridges the tokens."""
    from ray_tpu_torch.experimental import Channel
    from ray_tpu_torch.serve.deployment import NoPreferredReplica

    with rs.lock:
        cands = [r for r in rs.replicas if not r.draining] or list(
            rs.replicas
        )
    if any(same_host_pred(r) for r in cands):
        ch = Channel(buffer_size_bytes=1 << 18)
        try:
            ref = rs.submit(
                "stream_to",
                (ch.writer, payload),
                {},
                prefer=same_host_pred,
                strict_prefer=True,
            )
            return ch, None, ch.reader, ref
        except NoPreferredReplica:
            ch.destroy()
        except BaseException:
            ch.destroy()
            raise
    relay_actor = ray_tpu_torch.remote(_StreamRelayActor).options(
        num_cpus=0.0, max_concurrency=16
    ).remote()
    try:
        ref = rs.submit(
            "stream_to", (_RelayWriter(relay_actor), payload), {}
        )
    except BaseException:
        try:
            ray_tpu_torch.kill(relay_actor)
        except Exception:  # noqa: BLE001
            pass
        raise
    return None, relay_actor, _RelayReader(relay_actor), ref


def same_host_predicate(hosts_cache: dict, local_hosts: Optional[set]):
    """Factory shared by ingresses: predicate over _Replica deciding
    same-host-ness, with per-actor results cached in ``hosts_cache``."""
    from ray_tpu_torch.core.runtime import get_runtime

    try:
        rt = get_runtime()
    except Exception:  # noqa: BLE001
        return lambda r: True
    if not getattr(rt, "is_remote", False):
        return lambda r: True
    local = local_hosts if local_hosts is not None else _local_hosts()

    def pred(replica) -> bool:
        aid = getattr(replica.actor, "_actor_id", None)
        if aid is None:
            return True
        if aid not in hosts_cache:
            _, addr = rt.actor_location(aid)
            host = addr.rsplit(":", 1)[0] if addr else None
            if host is None:
                return False  # unknown ⇒ not-local; relay path is safe
            hosts_cache[aid] = host in local
        return hosts_cache[aid]

    return pred


def _local_hosts() -> set:
    import socket

    hosts = {"127.0.0.1", "localhost", "::1"}
    try:
        hosts.add(socket.gethostname())
        hosts.add(socket.getfqdn())
        hosts.update(
            i[4][0] for i in socket.getaddrinfo(socket.gethostname(), None)
        )
    except OSError:
        pass
    return hosts


class ServeProxy:
    def __init__(self, apps: dict, port: int = 0):
        self._apps = apps
        self._port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._runner = None
        self._pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="proxy-wait"
        )
        self._started = threading.Event()
        self._hosts: Optional[set] = None  # lazy _local_hosts()
        self._host_cache: dict = {}  # actor id -> is-local (sticky)
        self.port: Optional[int] = None
        self._startup_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="serve-proxy", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=30) or self.port is None:
            raise RuntimeError(
                f"serve proxy failed to start: {self._startup_error!r}"
            )

    def _same_host_pred(self):
        """Replica same-host predicate with proxy-level caching (the head
        RPC happens once per replica, not once per request); callers run
        it on the worker pool, never the event loop."""
        if self._hosts is None:
            self._hosts = _local_hosts()
        return same_host_predicate(self._host_cache, self._hosts)

    def _start_stream(self, rs, payload):
        return start_stream(rs, payload, self._same_host_pred())

    # -- handlers -------------------------------------------------------
    async def _call(self, request):
        from aiohttp import web

        from .admission import Overloaded
        from .deployment import _routers

        name = request.match_info["deployment"]
        rs = self._apps.get(name)
        if rs is None:
            return web.json_response(
                {"error": "no such deployment"}, status=404
            )
        payload = None
        if request.can_read_body:
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                return web.json_response(
                    {"error": "body must be JSON"}, status=400
                )
        loop = asyncio.get_running_loop()
        tenant = request.headers.get("X-Serve-Tenant", "default")
        router = _routers.get(name)
        try:
            if router is not None:
                # admission + p2c + direct-channel dispatch + metrics
                req = await loop.run_in_executor(
                    self._pool, lambda: router.submit(payload, tenant)
                )
                result = await loop.run_in_executor(
                    self._pool, lambda: req.result(60)
                )
            else:
                ref = rs.submit("__call__", (payload,), {})
                result = await loop.run_in_executor(
                    self._pool, lambda: ray_tpu_torch.get(ref, timeout=60)
                )
            return web.json_response({"result": result})
        except Overloaded as exc:
            return web.json_response(
                {"error": str(exc), "reason": exc.reason},
                status=503,
                headers={"Retry-After": f"{exc.retry_after_s:.2f}"},
            )
        except Exception as exc:  # noqa: BLE001 - errors are responses
            return web.json_response({"error": repr(exc)}, status=500)

    async def _stream(self, request):
        from aiohttp import web

        from .admission import Overloaded
        from .deployment import _routers
        from .router import ChannelClosed as RoutedClosed

        name = request.match_info["deployment"]
        rs = self._apps.get(name)
        if rs is None:
            return web.json_response(
                {"error": "no such deployment"}, status=404
            )
        payload = None
        if request.can_read_body:
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                return web.json_response(
                    {"error": "body must be JSON"}, status=400
                )
        loop = asyncio.get_running_loop()
        tenant = request.headers.get("X-Serve-Tenant", "default")
        router = _routers.get(name)
        if router is None:
            return web.json_response(
                {"error": "deployment has no router"}, status=500
            )
        # admission BEFORE the SSE response exists: overload is a real
        # 503 with Retry-After, not an error event on an accepted stream
        try:
            stream = await loop.run_in_executor(
                self._pool, lambda: router.stream(payload, tenant)
            )
        except Overloaded as exc:
            return web.json_response(
                {"error": str(exc), "reason": exc.reason},
                status=503,
                headers={"Retry-After": f"{exc.retry_after_s:.2f}"},
            )
        except Exception as exc:  # noqa: BLE001
            return web.json_response({"error": repr(exc)}, status=500)
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue()
        _END, _ERR = object(), object()
        # bounded handoff: a stalled HTTP client must throttle the relay
        # thread, which stops draining the transport, which backpressures
        # the replica's writer — end-to-end instead of unbounded RSS
        credits = threading.Semaphore(64)
        dead = threading.Event()

        def relay() -> None:
            """Dedicated per-stream thread: RoutedStream.read handles
            transport waits, replica probing, and mid-stream failover;
            blocking reads never occupy the shared unary-call pool."""

            def emit(kind, value=None):
                while not credits.acquire(timeout=1.0):
                    if dead.is_set():
                        raise RoutedClosed("consumer gone")
                loop.call_soon_threadsafe(q.put_nowait, (kind, value))

            try:
                while True:
                    try:
                        value = stream.read(timeout=300.0)
                    except RoutedClosed:
                        emit(_END)
                        return
                    except BaseException as exc:  # noqa: BLE001
                        emit(_ERR, repr(exc))
                        return
                    emit("data", value)
            except BaseException as exc:  # noqa: BLE001
                if not dead.is_set():
                    emit(_ERR, repr(exc))

        try:
            threading.Thread(
                target=relay, name="sse-relay", daemon=True
            ).start()
            while True:
                kind, value = await q.get()
                credits.release()
                if kind is _END:
                    await resp.write(b"event: end\ndata: {}\n\n")
                    break
                if kind is _ERR:
                    await resp.write(
                        f"event: error\ndata: "
                        f"{json.dumps(value)}\n\n".encode()
                    )
                    break
                await resp.write(f"data: {json.dumps(value)}\n\n".encode())
        except Exception as exc:  # noqa: BLE001
            await resp.write(
                f"event: error\ndata: {json.dumps(repr(exc))}\n\n".encode()
            )
        finally:
            dead.set()
            # close() cancels the transport (sink discard / ring destroy
            # / relay cancel), so a disconnected client's replica stops
            # generating instead of running to completion
            stream.close()
        await resp.write_eof()
        return resp

    async def _healthz(self, request):
        from aiohttp import web

        return web.json_response(
            {
                "status": "ok",
                "deployments": {
                    name: len(rs.replicas)
                    for name, rs in self._apps.items()
                },
            }
        )

    async def _routes(self, request):
        from aiohttp import web

        return web.json_response(sorted(self._apps))

    # -- lifecycle ------------------------------------------------------
    def _run(self) -> None:
        try:
            from aiohttp import web
        except BaseException as exc:  # noqa: BLE001 - surfaced to __init__
            self._startup_error = exc
            self._started.set()
            return

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        app = web.Application()
        app.router.add_get("/-/healthz", self._healthz)
        app.router.add_get("/-/routes", self._routes)
        app.router.add_post("/{deployment}/stream", self._stream)
        app.router.add_post("/{deployment}", self._call)

        async def start():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", self._port)
            await site.start()
            self._runner = runner
            self.port = site._server.sockets[0].getsockname()[1]
            self._started.set()

        try:
            loop.run_until_complete(start())
        except BaseException as exc:  # noqa: BLE001 - bind failure etc.
            self._startup_error = exc
            self._started.set()
            return
        loop.run_forever()

    def shutdown(self) -> None:
        loop = self._loop
        if loop is None:
            return

        async def stop():
            if self._runner is not None:
                await self._runner.cleanup()
            loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(stop(), loop)
            self._thread.join(timeout=5)
        except RuntimeError:
            pass
        self._pool.shutdown(wait=False)
