"""gRPC ingress for Serve deployments.

Port of ``ray_tpu/serve/grpc_ingress.py`` (no JAX in it; over the
port's ``cluster/rpc.py``).

The reference's proxy tier serves BOTH HTTP and gRPC
(Ray Serve's ``_private/proxy.py`` gRPCProxy +
grpc_util.py): gRPC clients reach deployments without the HTTP hop.
Here the ingress rides the framework's generic gRPC layer
(cluster/rpc.py — HTTP/2 wire, name-dispatched handlers), so no .proto
files are needed and any RpcClient is a serve client:

- ``ServeCall {deployment, payload}`` → unary call through the same
  p2c-balanced replica set as handle calls and the HTTP proxy.
- ``ServeStreamOpen {deployment, payload}`` → ``stream_id``; the replica
  runs ``stream_to(writer, payload)`` over the shared transport selection
  (same-host shm ring, cross-host relay actor — serve/proxy.py
  start_stream). ``ServeStreamNext {stream_id, max_items, timeout}``
  drains tokens in order; ``ServeStreamClose`` releases the transport.
  Poll-based streaming keeps the generic unary wire; each Next call is a
  long-poll so tokens flow at RPC latency, not poll cadence.
- ``ServeRoutes`` → deployment names (discovery/probes).
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, Optional

import ray_tpu_torch

from .proxy import _local_hosts, same_host_predicate, start_stream


class _Stream:
    __slots__ = ("ch", "relay", "reader", "ref", "ended", "error", "lock")

    def __init__(self, ch, relay, reader, ref):
        self.ch = ch
        self.relay = relay
        self.reader = reader
        self.ref = ref
        self.ended = False
        self.error = None  # replica exception, re-raised to the client
        self.lock = threading.Lock()  # Next calls for one stream serialize

    def close(self) -> None:
        if self.ch is not None:
            self.ch.destroy()
        if self.relay is not None:
            try:
                ray_tpu_torch.kill(self.relay)
            except Exception:  # noqa: BLE001
                pass


class GrpcIngress:
    """gRPC front door over the live deployment map."""

    STREAM_IDLE_REAP_S = 300.0

    def __init__(self, apps: Dict[str, Any], port: int = 0):
        from ray_tpu_torch.cluster.rpc import RpcServer

        self._apps = apps
        self._streams: Dict[str, tuple] = {}  # id -> (_Stream, last_used)
        self._lock = threading.Lock()
        self._host_cache: dict = {}
        self._hosts = None
        self._server = RpcServer(
            {
                "ServeCall": self._h_call,
                "ServeRoutes": lambda r: sorted(self._apps),
                "ServeStreamOpen": self._h_open,
                "ServeStreamNext": self._h_next,
                "ServeStreamClose": self._h_close,
            },
            port=port,
        )
        self.port = self._server.port
        self.address = self._server.address

    # ------------------------------------------------------------------
    def _rs(self, name: str):
        rs = self._apps.get(name)
        if rs is None:
            raise KeyError(f"no such deployment: {name!r}")
        return rs

    def _h_call(self, req: dict) -> Any:
        rs = self._rs(req["deployment"])
        ref = rs.submit("__call__", (req.get("payload"),), {})
        return ray_tpu_torch.get(ref, timeout=req.get("timeout") or 60.0)

    def _h_open(self, req: dict) -> str:
        rs = self._rs(req["deployment"])
        if self._hosts is None:
            self._hosts = _local_hosts()
        pred = same_host_predicate(self._host_cache, self._hosts)
        ch, relay, reader, ref = start_stream(rs, req.get("payload"), pred)
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            reaped = self._pop_idle_locked()
            self._streams[sid] = (
                _Stream(ch, relay, reader, ref),
                time.monotonic(),
            )
        for stale in reaped:  # blocking closes happen OUTSIDE the lock
            stale.close()
        return sid

    def _h_next(self, req: dict) -> dict:
        from ray_tpu_torch.experimental import ChannelClosed

        sid = req["stream_id"]
        with self._lock:
            entry = self._streams.get(sid)
            if entry is None:
                raise KeyError(f"unknown stream {sid!r}")
            stream = entry[0]
            self._streams[sid] = (stream, time.monotonic())
            reaped = self._pop_idle_locked()
        for stale in reaped:  # a server that stops seeing Opens must
            stale.close()  # still reap vanished clients (r4 advisor)
        max_items = int(req.get("max_items") or 64)
        window = float(req.get("timeout") or 5.0)
        items = []
        deadline = time.monotonic() + window
        with stream.lock:
            if stream.error is not None:
                raise stream.error
            if stream.ended:
                return {"items": [], "ended": True}
            while len(items) < max_items:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and items:
                    break
                try:
                    items.append(
                        stream.reader.read(timeout=max(0.05, remaining))
                    )
                except ChannelClosed:
                    stream.ended = True
                    break
                except TimeoutError:
                    # stalled: did the replica method finish (or die)?
                    from ray_tpu_torch import GetTimeoutError

                    try:
                        ray_tpu_torch.get(stream.ref, timeout=0.05)
                    except GetTimeoutError:
                        break  # still running; client polls again
                    except BaseException as exc:  # noqa: BLE001
                        # replica raised: surface it now and on every
                        # later Next (matching the HTTP relay's _ERR)
                        stream.ended = True
                        stream.error = exc
                        raise
                    # method returned: drain the tail written between
                    # our timeout and the probe (proxy.py relay() race)
                    try:
                        while len(items) < max_items:
                            items.append(stream.reader.read(timeout=0.5))
                        # batch filled with buffer possibly non-empty:
                        # leave ended False so the next poll drains it
                    except (ChannelClosed, TimeoutError):
                        stream.ended = True
                    break
        return {"items": items, "ended": stream.ended}

    def _h_close(self, req: dict) -> None:
        with self._lock:
            entry = self._streams.pop(req["stream_id"], None)
            reaped = self._pop_idle_locked()
        if entry is not None:
            entry[0].close()
        for stale in reaped:
            stale.close()

    def _pop_idle_locked(self) -> list:
        """Collect abandoned streams (client vanished without Close) so
        relay actors / rings don't leak. Caller holds self._lock; the
        returned streams are closed by the caller AFTER releasing it
        (close() does head RPCs)."""
        now = time.monotonic()
        out = []
        for sid, (stream, last) in list(self._streams.items()):
            if now - last > self.STREAM_IDLE_REAP_S:
                self._streams.pop(sid, None)
                out.append(stream)
        return out

    def shutdown(self) -> None:
        with self._lock:
            streams = [s for s, _ in self._streams.values()]
            self._streams.clear()
        for s in streams:
            s.close()
        self._server.stop()
