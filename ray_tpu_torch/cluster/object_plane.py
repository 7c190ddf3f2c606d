"""Object-plane instruments + the chunked peer-pull client.

One home for the data-path metrics every process family shares
(``object_transfer_bytes_total{path=shm|inline|rpc}``, shm hit/miss
counters, chunk latency) and for ``fetch_chunked`` — the streamed,
resumable replacement for the single-shot ``FetchObject`` reply
(object_manager chunked pushes, push_manager.h:28-36: bounded in-flight
chunks, per-chunk retry, so one dropped chunk re-sends itself instead of
the whole object, and a big broadcast never holds one giant buffer per
receiver in flight).

Port of ``ray_tpu/cluster/object_plane.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Gauge as _Gauge
from ray_tpu_torch.util.metrics import Histogram as _Histogram

OBJECT_TRANSFER_BYTES = _Counter(
    "object_transfer_bytes_total",
    "Object payload bytes moved, by path: shm (zero-copy arena view), "
    "inline (control-message inline value), rpc (pickled fetch / chunked "
    "peer pull), socket (direct peer-leased data socket, scatter-gather "
    "C plane).",
    label_names=("path",),
)
PEER_CONN_GRANTED = _Counter(
    "peer_conn_granted_total",
    "Peer data-link leases granted by the head (one per (src, dst) pair "
    "until revoked/returned; steady-state transfers reuse the grant).",
)
PEER_CONN_REVOKED = _Counter(
    "peer_conn_revoked_total",
    "Peer data-link leases revoked (node death, renewal expiry) or "
    "returned on idle TTL.",
)
PEER_CONN_REUSED = _Counter(
    "peer_conn_reused_total",
    "Transfers served from an already-granted cached peer link (zero "
    "head RPCs).",
)
TRANSFER_STRIPE_MS = _Histogram(
    "transfer_stripe_ms",
    "Per-stripe round-trip latency of socket peer transfers (request "
    "sent to last payload byte landed).",
    boundaries=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
)
SHM_HITS = _Counter(
    "shm_store_hits_total",
    "Object reads served as zero-copy views over the local shm arena.",
)
SHM_MISSES = _Counter(
    "shm_store_misses_total",
    "Object reads that missed the local arena and fell back to an RPC.",
)
TRANSFER_CHUNK_MS = _Histogram(
    "transfer_chunk_ms",
    "Per-chunk round-trip latency of chunked peer object pulls.",
    boundaries=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
)
CHUNKED_PULLS_INFLIGHT = _Gauge(
    "chunked_pulls_inflight",
    "Chunked peer pulls currently in progress in this process.",
)


class ChunkFetchError(Exception):
    """A chunk could not be fetched within its retry budget (the caller
    falls over to the next replica / the locate loop)."""


def fetch_chunked(
    client,
    object_id: str,
    purpose: str = "task_args",
    size: Optional[int] = None,
    deadline: Optional[float] = None,
    relocate=None,
) -> "bytes | bytearray":
    """Pull one object from a peer agent, chunked and resumable.

    Small objects (<= cfg.transfer_chunk_bytes) take the single-shot
    ``FetchObject`` path. Larger ones stream ``FetchObjectChunk`` windows
    with at most cfg.transfer_max_inflight_chunks concurrent requests;
    each chunk retries independently (transport retries + one re-request)
    before the whole pull is abandoned with :class:`ChunkFetchError`.

    ``relocate`` (optional, ``() -> client | None``) is consulted between
    chunk retry attempts after a TRANSPORT failure: it re-resolves the
    object's location and returns the client to continue from (the same
    peer, or a replica the directory moved to). ``None`` means the source
    is gone everywhere it was known — the pull aborts IMMEDIATELY with
    :class:`ChunkFetchError` so the caller re-plans through its locate
    loop instead of burning the whole per-chunk retry budget against a
    dead peer.

    Raises ``KeyError`` when the peer no longer holds the object.
    """
    from ray_tpu_torch.config import cfg

    def _remaining(cap: float) -> float:
        """Per-attempt RPC budget bounded by the caller's deadline."""
        if deadline is None:
            return cap
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("chunked pull deadline")
        return min(cap, left)

    chunk_bytes = max(64 * 1024, int(cfg.transfer_chunk_bytes))
    if size is None:
        size = client.call(
            "FetchObjectMeta",
            {"object_id": object_id},
            timeout=_remaining(15.0),
        )["size"]
    if size <= chunk_bytes:
        # transfer bytes are counted once per wire crossing, at the
        # SERVING agent's handler — counting here too would double every
        # peer transfer in aggregated views
        t0 = time.perf_counter()
        data = client.call(
            "FetchObject",
            {"object_id": object_id, "purpose": purpose},
            timeout=_remaining(60.0),
        )
        TRANSFER_CHUNK_MS.observe((time.perf_counter() - t0) * 1e3)
        return data

    offsets = list(range(0, size, chunk_bytes))
    buf = bytearray(size)
    max_inflight = max(1, int(cfg.transfer_max_inflight_chunks))
    sem = threading.Semaphore(max_inflight)
    failed: list = []
    fail_lock = threading.Lock()
    # current source peer, shared across chunk threads: a mid-transfer
    # relocation swaps the client for EVERY remaining chunk at once
    peer = [client]

    def _relocate_peer() -> None:
        """One thread re-resolves the source after a transport failure;
        a gone-everywhere verdict aborts the pull (caller re-plans)."""
        if relocate is None:
            return
        with fail_lock:
            cur = peer[0]
        try:
            fresh = relocate()
        except Exception:  # noqa: BLE001 - locate failed: keep retrying
            return
        if fresh is None:
            raise ChunkFetchError(
                f"source of {object_id} is gone (re-resolve found no "
                "live replica); caller must re-plan"
            )
        if fresh is not cur:
            with fail_lock:
                peer[0] = fresh

    def _one(off: int) -> None:
        want = min(chunk_bytes, size - off)
        try:
            # per-chunk resume: transport retries inside call(), plus one
            # full re-request here — a chaos-dropped chunk re-sends alone.
            # every attempt's timeout shrinks to the caller's remaining
            # deadline (a 2s-budget pull must not park for 3 x 60s)
            for attempt in (0, 1, 2):
                t0 = time.perf_counter()
                with fail_lock:
                    cur = peer[0]
                try:
                    part = cur.call(
                        "FetchObjectChunk",
                        {
                            "object_id": object_id,
                            "offset": off,
                            "length": want,
                            "purpose": purpose,
                        },
                        timeout=_remaining(60.0),
                        retries=1,
                    )
                except (KeyError, TimeoutError):
                    raise
                except Exception:  # noqa: BLE001 - dropped/slow chunk
                    if attempt == 2:
                        raise
                    # re-resolve the location BEFORE the retry: a dead
                    # source must not eat the remaining budget too
                    _relocate_peer()
                    continue
                TRANSFER_CHUNK_MS.observe((time.perf_counter() - t0) * 1e3)
                if len(part) != want:
                    raise ChunkFetchError(
                        f"chunk {off} of {object_id}: got {len(part)} "
                        f"bytes, wanted {want}"
                    )
                buf[off : off + want] = part
                return
        except BaseException as exc:  # noqa: BLE001 - surfaced by leader
            with fail_lock:
                failed.append(exc)
        finally:
            sem.release()

    CHUNKED_PULLS_INFLIGHT.inc()
    try:
        threads = []
        for off in offsets:
            with fail_lock:
                if failed:
                    break
            if deadline is not None and time.monotonic() >= deadline:
                failed.append(TimeoutError("chunked pull deadline"))
                break
            # a bounded slot wait: every in-flight chunk's RPC timeout is
            # deadline-capped, so a slot frees within the budget or the
            # pull is over anyway
            if deadline is None:
                sem.acquire()
            elif not sem.acquire(
                timeout=max(0.05, deadline - time.monotonic())
            ):
                failed.append(TimeoutError("chunked pull deadline"))
                break
            t = threading.Thread(
                target=_one, args=(off,), name="chunk-pull", daemon=True
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if failed:
            exc = failed[0]
            if isinstance(exc, KeyError):
                raise exc
            raise ChunkFetchError(
                f"chunked pull of {object_id} failed: {exc!r}"
            ) from exc
        # (bytes counted once at the serving agent's chunk handler)
        # hand back the assembled buffer itself: a bytes() of it would
        # double peak memory per pull, and every consumer (store puts,
        # inline replies, pickle loads) takes any bytes-like
        return buf
    finally:
        CHUNKED_PULLS_INFLIGHT.dec()
