"""Cross-node zero-copy transport: peer-leased worker<->worker data
sockets with C scatter-gather striping.

The same-node fast paths (shm arena views, ring pairs, the C wire plane)
stop at the node boundary; cross-node objects used to ride
agent-forwarded gRPC with per-chunk Python (~30x off the same-node shm
read). This module is the object_manager analog
(src/ray/object_manager/object_manager.h — direct node<->node object
transfer with the control plane OFF the data path):

- :class:`DataPlaneServer` runs beside each agent's RPC server and
  serves object stripes over raw TCP. Sends are scatter-gather straight
  from arena views (``native/net.cc`` ``sendmsg``; zero joins/copies
  send-side); the handshake is token-authenticated and epoch-fenced
  (stale-epoch senders rejected on the data path, mirroring
  FencedPayload on the control plane).
- :class:`PeerLink` is the owner-side half of a HEAD-GRANTED connection
  lease (GrantPeerLink — the task-lease pattern applied to transport):
  the head hands out ``endpoint + auth token`` once per (src, dst) pair,
  then steady-state transfers make ZERO head RPCs. Links cache pooled
  connections, renew while hot (piggybacked on agent reports), and are
  reclaimed on idle TTL / revoked on node death.
- :func:`fetch_to_store` / :func:`fetch_bytes` pull one object over a
  link: transfers larger than one stripe split across N parallel
  connections with per-stripe offsets; a severed connection re-fetches
  ONLY its lost stripes (resume, not restart), and in-flight bytes are
  capped for backpressure into the receiving arena. Payload lands via
  ``begin_put`` scatter-writes into the receiving arena (put_frames
  split into allocate / land / seal).

The chunked-RPC path (``object_plane.fetch_chunked``) stays as the
fallback for every failure class here, and ``RAY_TPU_NATIVE_NET=0``
kills the whole plane.

Port of ``ray_tpu/cluster/transport.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import hmac
import logging
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.native.net import (
    NetClosedError,
    NetListener,
    NetSocket,
    NetTimeoutError,
    write_endpoint_file,
)

from .object_plane import (
    OBJECT_TRANSFER_BYTES,
    PEER_CONN_REUSED,
    TRANSFER_STRIPE_MS,
)

logger = logging.getLogger("ray_tpu_torch.cluster.transport")

# handshake: magic | u16 version | u64 sender_epoch | u16 token_len |
#            u16 node_len | token | node_id
HELLO_MAGIC = b"RTN1"
_HELLO = struct.Struct("<4sHQHH")
_VERSION = 1
# handshake verdicts
HS_OK = 0
HS_BAD_TOKEN = 1
HS_STALE_EPOCH = 2
HS_MALFORMED = 3

# request: u8 op | u8 purpose | u16 oid_len | u64 offset | u64 length
_REQ = struct.Struct("<BBHQQ")
OP_FETCH = 1
_PURPOSES = ("get", "wait", "task_args")

# response: u8 status | u64 total_size | u64 payload_len
_RESP = struct.Struct("<BQQ")
ST_OK = 0
ST_MISSING = 1
ST_ERROR = 2


class LinkRejectedError(ConnectionError):
    """The serving agent refused the data-path handshake; the cached
    link is dead (drop it, fall back, re-grant on next use)."""

    def __init__(self, code: int, endpoint: str):
        self.code = code
        super().__init__(
            f"data-path handshake to {endpoint} rejected "
            f"({'bad token' if code == HS_BAD_TOKEN else 'stale epoch' if code == HS_STALE_EPOCH else code})"
        )


class StripeFetchError(ConnectionError):
    """A stripe could not be fetched within its retry budget — the
    caller falls back to the chunked-RPC path / its locate loop."""


def _stripe_cfg() -> Tuple[int, int, int]:
    """(stripe_bytes, max_conns, inflight_cap_bytes) from config."""
    from ray_tpu_torch.config import cfg

    stripe = max(1 << 20, int(cfg.net_stripe_bytes))
    conns = max(1, int(cfg.net_stripe_conns))
    cap = max(stripe, int(cfg.net_inflight_cap_bytes))
    return stripe, conns, cap


class _FetchGate:
    """Process-wide in-flight byte budget across ALL concurrent socket
    fetches (cfg.net_fetch_inflight_cap_bytes) — the shuffle reduce
    side's arena backpressure: a task resolving many non-resident
    partitions at once parks its later pulls until earlier ones land
    (and, under arena pressure, until the spill path has drained the
    coldest residents), instead of staging an unbounded byte wave.

    Per-transfer stripe fan-out is separately capped by
    ``net_inflight_cap_bytes``; this gate composes across transfers.
    Advisory by construction: a transfer larger than the whole cap
    proceeds alone, and a waiter past its bounded deadline proceeds
    with the timeout counter bumped — backpressure must never become a
    deadlock. The park is additionally capped at ``MAX_PARK_S``: the
    acquire happens after the size handshake, when the SERVING side is
    already mid-send holding its admission slot (and its idle-close
    clock is ticking), so a parked fetch must release that remote
    pressure quickly rather than pin it for a whole caller deadline."""

    #: hard ceiling on one park (see class docstring) — well under the
    #: server's idle-close window so a park never severs the connection
    MAX_PARK_S = 15.0

    def __init__(self):
        self._cv = threading.Condition()
        self._inflight = 0
        self.waits = 0
        self.timeouts = 0

    def acquire(self, nbytes: int, timeout_s: float = MAX_PARK_S) -> int:
        from ray_tpu_torch.config import cfg

        cap = int(cfg.net_fetch_inflight_cap_bytes)
        if cap <= 0 or nbytes <= 0:
            return 0
        timeout_s = min(timeout_s, self.MAX_PARK_S)
        deadline = time.monotonic() + max(0.05, timeout_s)
        with self._cv:
            waited = False
            while self._inflight > 0 and self._inflight + nbytes > cap:
                if not waited:
                    waited = True
                    self.waits += 1
                left = deadline - time.monotonic()
                if left <= 0:
                    self.timeouts += 1
                    break
                self._cv.wait(timeout=min(left, 1.0))
            self._inflight += nbytes
        return nbytes

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "inflight_bytes": self._inflight,
                "waits": self.waits,
                "timeouts": self.timeouts,
            }


FETCH_GATE = _FetchGate()


# ---------------------------------------------------------------------------
# serving side
# ---------------------------------------------------------------------------


class DataPlaneServer:
    """Per-agent stripe server over raw TCP.

    One accept thread, one thread per live connection (connections are
    few by construction: peers x stripe conns, pooled and idle-reaped on
    the client side). Every payload send passes the agent's classed push
    admission, so socket transfers respect the same GET > WAIT >
    TASK_ARGS ordering as the RPC plane."""

    IDLE_CLOSE_S = 120.0  # server-side backstop on dead-silent conns

    def __init__(
        self,
        store,
        node_id: str,
        token: str,
        epoch_fn: Callable[[], Optional[int]],
        admission=None,
        host: str = "127.0.0.1",
    ):
        self.store = store
        self.node_id = node_id
        self._token = token.encode()
        self._epoch_fn = epoch_fn
        self._admission = admission
        self._listener = NetListener(host=host, port=0)
        self.endpoint = self._listener.address
        self._closed = False
        self._conns: Dict[int, NetSocket] = {}  # id(conn) -> conn (chaos)
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "connections_accepted": 0,
            "handshakes_rejected_token": 0,
            "handshakes_rejected_epoch": 0,
            "stripes_served": 0,
            "bytes_sent": 0,
            "chaos_drops": 0,
        }
        # pid-stamped endpoint sidecar (swept at agent start when its
        # owner pid died — hygiene parity with arenas/rings)
        self._ep_file = write_endpoint_file(node_id, self.endpoint)
        threading.Thread(
            target=self._accept_loop,
            name=f"net-accept-{node_id[:6]}",
            daemon=True,
        ).start()

    # -- lifecycle -----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept(timeout_s=1.0)
            except OSError:
                if self._closed:
                    return
                time.sleep(0.2)
                continue
            if conn is None:
                continue
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns[id(conn)] = conn
                self.stats["connections_accepted"] += 1
            threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name=f"net-serve-{self.node_id[:6]}",
                daemon=True,
            ).start()

    def _drop_conn(self, conn: NetSocket) -> None:
        with self._lock:
            self._conns.pop(id(conn), None)
        conn.close()

    def chaos_drop(self) -> int:
        """Sever every live data connection (peer_conn_drop fault): the
        senders' in-flight stripes fail and must resume, not restart. Each
        connection is shut down, not closed: its serving thread wakes and
        closes it, so its fd number is not reused under that thread."""
        with self._lock:
            victims = list(self._conns.values())
            self._conns.clear()
            self.stats["chaos_drops"] += len(victims)
        for c in victims:
            c.shutdown()
        return len(victims)

    def close(self) -> None:
        """Exactly-once teardown (idempotent like every close here)."""
        if self._closed:
            return
        self._closed = True
        self._listener.close()
        with self._lock:
            victims = list(self._conns.values())
            self._conns.clear()
        for c in victims:
            c.shutdown()  # each serving thread closes its own connection
        try:
            import os

            os.unlink(self._ep_file)
        except OSError:
            pass

    # -- protocol ------------------------------------------------------
    def _handshake(self, conn: NetSocket) -> bool:
        conn.set_timeout(10.0)
        try:
            hdr = conn.recv_exact(_HELLO.size)
            magic, version, epoch, tlen, nlen = _HELLO.unpack(hdr)
            if magic != HELLO_MAGIC or version != _VERSION:
                conn.send_vec([bytes([HS_MALFORMED])])
                return False
            token = conn.recv_exact(tlen)
            conn.recv_exact(nlen)  # sender node id (logging only)
            if not hmac.compare_digest(token, self._token):
                self.stats["handshakes_rejected_token"] += 1
                conn.send_vec([bytes([HS_BAD_TOKEN])])
                return False
            # epoch fence, FencedPayload semantics: only provably-stale
            # senders (stamped, and older than OUR adopted epoch) are
            # rejected; unstamped (0) passes — the sender re-registers
            # with the head and re-grants to resync
            ours = self._epoch_fn() or 0
            if epoch and ours and epoch < ours:
                self.stats["handshakes_rejected_epoch"] += 1
                conn.send_vec([bytes([HS_STALE_EPOCH])])
                return False
            conn.send_vec([bytes([HS_OK])])
            return True
        except (ConnectionError, TimeoutError, OSError):
            return False

    def _serve_conn(self, conn: NetSocket) -> None:
        try:
            if not self._handshake(conn):
                return
            conn.set_timeout(self.IDLE_CLOSE_S)
            while not self._closed:
                try:
                    req = conn.recv_exact(_REQ.size)
                except (NetTimeoutError, NetClosedError):
                    return  # idle backstop / client went away
                op, purpose_code, oid_len, offset, length = _REQ.unpack(req)
                oid = conn.recv_exact(oid_len).decode()
                if op != OP_FETCH:
                    return
                self._serve_stripe(
                    conn,
                    oid,
                    offset,
                    length,
                    _PURPOSES[purpose_code]
                    if purpose_code < len(_PURPOSES)
                    else "task_args",
                )
        except (ConnectionError, TimeoutError, OSError):
            pass  # severed mid-anything: the client resumes its stripes
        except Exception:  # noqa: BLE001 - serving must never kill the loop
            logger.exception("data-plane serve loop failed")
        finally:
            self._drop_conn(conn)

    def _serve_stripe(
        self, conn: NetSocket, oid: str, offset: int, length: int, purpose: str
    ) -> None:
        adm = self._admission(purpose) if self._admission is not None else None
        entered = False
        try:
            if adm is not None:
                adm.__enter__()
                entered = True
            try:
                total = self.store.object_size(oid)
            except KeyError:
                conn.send_vec([_RESP.pack(ST_MISSING, 0, 0)])
                return
            if offset >= total:
                conn.send_vec([_RESP.pack(ST_OK, total, 0)])
                return
            n = min(length, total - offset)
            sent = self._send_payload(conn, oid, offset, n, total)
            if sent:
                self.stats["stripes_served"] += 1
                self.stats["bytes_sent"] += n
                OBJECT_TRANSFER_BYTES.inc(n, labels={"path": "socket"})
        except KeyError:
            conn.send_vec([_RESP.pack(ST_MISSING, 0, 0)])
        except (ConnectionError, TimeoutError, OSError):
            raise
        except Exception:  # noqa: BLE001 - store-side failure
            logger.exception("stripe serve failed for %s", oid)
            try:
                conn.send_vec([_RESP.pack(ST_ERROR, 0, 0)])
            except (ConnectionError, TimeoutError, OSError):
                pass
        finally:
            # only a slot actually TAKEN is returned: __enter__ raising
            # (admission timeout) must not decrement the shared in-flight
            # count and silently widen the push cap
            if entered:
                adm.__exit__(None, None, None)

    def _send_payload(
        self, conn: NetSocket, oid: str, offset: int, n: int, total: int
    ) -> bool:
        """Header + payload in ONE gather send. Arena residents go out as
        a pinned read-only VIEW slice (zero copies between the shared
        pages and the socket); spilled / fallback-store objects pay one
        get_range copy."""
        hdr = _RESP.pack(ST_OK, total, n)
        inner = getattr(self.store, "inner", None)
        view = None
        if inner is not None and hasattr(inner, "get_view"):
            try:
                view = inner.get_view(oid)
            except (KeyError, BlockingIOError, OSError):
                view = None
        try:
            if view is not None and view.nbytes == total:
                conn.send_vec([hdr, view[offset : offset + n]])
                return True
        finally:
            # the slice sent synchronously; releasing the view pin now is
            # safe (sendmsg copied into the kernel before returning)
            del view
        data = self.store.get_range(oid, offset, n)
        if len(data) != n:
            conn.send_vec([_RESP.pack(ST_ERROR, 0, 0)])
            return False
        conn.send_vec([hdr, data])
        return True


# ---------------------------------------------------------------------------
# requesting side
# ---------------------------------------------------------------------------


class PeerLink:
    """Owner-side half of one head-granted peer connection lease.

    Pools established+handshaked connections per (src, dst) pair;
    ``borrow``/``give_back`` keep hot transfers dial-free, ``discard``
    drops a severed connection (the stripe that was riding it resumes on
    a fresh dial). ``last_used`` drives idle-TTL reclamation and the
    renew-while-hot piggyback."""

    def __init__(
        self,
        link_id: str,
        node_id: str,
        endpoint: str,
        token: str,
        epoch: Optional[int],
        src_node: str = "",
    ):
        self.link_id = link_id
        self.node_id = node_id
        self.endpoint = endpoint
        self.token = token
        self.epoch = epoch
        self.src_node = src_node
        self.last_used = time.monotonic()
        self._idle: List[NetSocket] = []
        self._lock = threading.Lock()
        self._closed = False
        self.transfers = 0

    def _dial(self, timeout_s: float = 10.0) -> NetSocket:
        host, port = self.endpoint.rsplit(":", 1)
        conn = NetSocket.connect(host, int(port), timeout_s=timeout_s)
        try:
            token = self.token.encode()
            src = self.src_node.encode()
            conn.send_vec(
                [
                    _HELLO.pack(
                        HELLO_MAGIC,
                        _VERSION,
                        int(self.epoch or 0),
                        len(token),
                        len(src),
                    ),
                    token,
                    src,
                ]
            )
            conn.set_timeout(timeout_s)
            verdict = conn.recv_exact(1)[0]
            if verdict != HS_OK:
                raise LinkRejectedError(verdict, self.endpoint)
            return conn
        except BaseException:
            conn.close()
            raise

    def borrow(self, timeout_s: float = 10.0) -> NetSocket:
        with self._lock:
            if self._closed:
                raise StripeFetchError(f"link to {self.node_id} is closed")
            if self._idle:
                return self._idle.pop()
        return self._dial(timeout_s)

    def give_back(self, conn: NetSocket) -> None:
        with self._lock:
            if not self._closed and not conn.closed and len(self._idle) < 8:
                self._idle.append(conn)
                return
        conn.close()

    def discard(self, conn: NetSocket) -> None:
        conn.close()

    def flush_idle(self) -> None:
        """Close every pooled connection. Called when one proves stale
        (a sever / server idle-reap usually killed the WHOLE pool): the
        next borrow dials fresh instead of popping more corpses."""
        with self._lock:
            victims = self._idle
            self._idle = []
        for c in victims:
            c.close()

    def touch(self) -> None:
        self.last_used = time.monotonic()
        self.transfers += 1

    def idle_for(self) -> float:
        return time.monotonic() - self.last_used

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            victims = self._idle
            self._idle = []
        for c in victims:
            c.close()


def _request(
    conn: NetSocket,
    oid: bytes,
    offset: int,
    length: int,
    purpose_code: int,
    timeout_s: float,
) -> Tuple[int, int]:
    """One stripe request/response header round-trip. Returns
    (total_size, payload_len); payload bytes are still on the wire for
    the caller to scatter-land."""
    conn.set_timeout(timeout_s)
    conn.send_vec(
        [_REQ.pack(OP_FETCH, purpose_code, len(oid), offset, length), oid]
    )
    status, total, plen = _RESP.unpack(conn.recv_exact(_RESP.size))
    if status == ST_MISSING:
        raise KeyError(oid.decode())
    if status != ST_OK:
        raise StripeFetchError(f"peer error serving {oid.decode()}")
    return total, plen


def _record_fetch_span(
    object_id: str, t_wall: float, total: int, stripes: int
) -> None:
    """Socket-plane trace span for one completed fetch:
    merged into the Chrome-trace export beside task slices."""
    try:
        from ray_tpu_torch.util.tracing import SPANS

        SPANS.record(
            "socket_fetch",
            "transport",
            t_wall,
            time.time() - t_wall,
            object_id=object_id[:16],
            bytes=int(total),
            stripes=int(stripes),
        )
    except Exception:  # noqa: BLE001 - observability only
        pass


def _fetch(
    link: PeerLink,
    object_id: str,
    purpose: str,
    alloc: Callable[[int], memoryview],
    deadline: Optional[float] = None,
    on_stripe: Optional[Callable[[int, int], None]] = None,
) -> int:
    """Striped pull of one object over ``link`` into ``alloc(total)``.

    The first request doubles as the size handshake (no separate meta
    RPC): its reply carries total_size, the destination is allocated,
    and the first stripe lands straight into it. Remaining stripes fan
    out over up to net_stripe_conns parallel connections; each failed
    stripe resumes ALONE on a fresh connection (bounded retries), and a
    byte-capped semaphore backpressures the fan-out into the arena.

    ``on_stripe(off, n)`` fires after each stripe has FULLY landed in
    the destination (never for a partial recv — a severed stripe
    re-fetches before it is ever reported), so consumers like the
    device landing zone can overlap H2D with the remaining recv. It is
    called from the stripe worker threads and must be thread-safe.

    Raises KeyError (peer answered: object gone), LinkRejectedError
    (handshake refused: drop the cached link) or StripeFetchError
    (transport death past the retry budget) — every caller falls back
    to the chunked-RPC path on the latter two.
    """
    stripe_bytes, max_conns, cap_bytes = _stripe_cfg()
    purpose_code = (
        _PURPOSES.index(purpose) if purpose in _PURPOSES else 2
    )
    oid = object_id.encode()

    def _budget(cap: float = 60.0) -> float:
        if deadline is None:
            return cap
        left = deadline - time.monotonic()
        if left <= 0:
            raise StripeFetchError("stripe pull deadline")
        return min(cap, left)

    t0 = time.perf_counter()
    t_wall = time.time()
    # the probe tolerates ONE stale pooled connection (severed while
    # idle, or reaped by the server's idle backstop): retry on a fresh
    # dial before degrading the whole transfer to the RPC fallback.
    # alloc runs AT MOST ONCE (a staged arena entry must not double-
    # create on the retry) — the dest survives the reattempt.
    dest: Optional[memoryview] = None
    for probe_attempt in (0, 1):
        conn = link.borrow(timeout_s=_budget(10.0))
        try:
            total, plen = _request(
                conn, oid, 0, stripe_bytes, purpose_code, _budget()
            )
            if dest is None:
                dest = alloc(total)
            if plen:
                conn.recv_exact_into(dest[:plen])
                if on_stripe is not None:
                    on_stripe(0, plen)
            break
        except KeyError:
            link.give_back(conn)  # healthy connection, definite miss
            raise
        except (ConnectionError, TimeoutError, OSError) as exc:
            link.discard(conn)
            if probe_attempt or isinstance(exc, LinkRejectedError):
                raise
            # one stale pooled conn usually means the WHOLE pool is
            # stale (sever / idle-reap kills them together): flush it so
            # the retry — and the next transfers — dial fresh
            link.flush_idle()
        except BaseException:
            link.discard(conn)
            raise
    TRANSFER_STRIPE_MS.observe((time.perf_counter() - t0) * 1e3)
    link.touch()
    if plen >= total:
        link.give_back(conn)
        _record_fetch_span(object_id, t_wall, total, 1)
        return total

    # remaining stripes across parallel connections, resumable per stripe
    stripes = [
        (off, min(stripe_bytes, total - off))
        for off in range(plen, total, stripe_bytes)
    ]
    sem = threading.Semaphore(max(1, cap_bytes // stripe_bytes))
    q: List[Tuple[int, int]] = list(reversed(stripes))
    q_lock = threading.Lock()
    failures: List[BaseException] = []

    def _worker(seed_conn: Optional[NetSocket]) -> None:
        my_conn = seed_conn
        try:
            while True:
                with q_lock:
                    if failures or not q:
                        return
                    off, n = q.pop()
                if deadline is not None and time.monotonic() >= deadline:
                    raise StripeFetchError("stripe pull deadline")
                if not sem.acquire(timeout=max(0.05, _budget(120.0))):
                    raise StripeFetchError("stripe backpressure deadline")
                try:
                    my_conn = self_heal_fetch(off, n, my_conn)
                finally:
                    sem.release()
        except BaseException as exc:  # noqa: BLE001 - leader surfaces it
            with q_lock:
                failures.append(exc)
        finally:
            if my_conn is not None:
                link.give_back(my_conn)

    def self_heal_fetch(
        off: int, n: int, my_conn: Optional[NetSocket]
    ) -> Optional[NetSocket]:
        """One stripe with resume: a severed connection re-dials and
        re-requests ONLY this stripe (the landed bytes before the cut
        are overwritten in place — no duplicate-byte window)."""
        last: Optional[BaseException] = None
        for attempt in range(5):
            if attempt:
                # a chaos sever storm kills redials too: a short jittered
                # pause lets the window pass instead of burning the whole
                # budget inside one repeated cut
                time.sleep(0.02 * attempt)
            ts = time.perf_counter()
            try:
                if my_conn is None:
                    my_conn = link.borrow(timeout_s=_budget(10.0))
                _, got = _request(
                    my_conn, oid, off, n, purpose_code, _budget()
                )
                if got != n:
                    raise StripeFetchError(
                        f"stripe {off}: got {got} bytes, wanted {n}"
                    )
                my_conn.recv_exact_into(dest[off : off + n])
                if on_stripe is not None:
                    on_stripe(off, n)
                TRANSFER_STRIPE_MS.observe((time.perf_counter() - ts) * 1e3)
                return my_conn
            except (KeyError, LinkRejectedError):
                if my_conn is not None:
                    link.discard(my_conn)
                raise
            except (ConnectionError, TimeoutError, OSError) as exc:
                # severed / timed out mid-stripe: drop the connection and
                # resume THIS stripe on a fresh dial
                if my_conn is not None:
                    link.discard(my_conn)
                    my_conn = None
                last = exc
                try:
                    from ray_tpu_torch.native import counters as _dark

                    _dark.add("net_stripe_retries_total")
                except Exception:  # noqa: BLE001 - counting is optional
                    pass
        raise StripeFetchError(
            f"stripe {off} of {object_id} failed after retries"
        ) from last

    n_workers = min(max_conns, len(stripes))
    threads = []
    for i in range(n_workers):
        # the probe connection seeds worker 0 (already dialed + hot)
        t = threading.Thread(
            target=_worker,
            args=(conn if i == 0 else None,),
            name="net-stripe",
            daemon=True,
        )
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if failures:
        exc = failures[0]
        if isinstance(exc, (KeyError, LinkRejectedError)):
            raise exc
        raise StripeFetchError(
            f"striped pull of {object_id} failed: {exc!r}"
        ) from exc
    link.touch()
    _record_fetch_span(object_id, t_wall, total, 1 + len(stripes))
    return total


def _wants_landing_zone(land: Optional[str]) -> bool:
    """``land='device'`` asks for H2D/recv overlap AND the backend has a
    real H2D hop to hide (see device_plane.landing_zone_worthwhile)."""
    if land != "device":
        return False
    from ray_tpu_torch.cluster import device_plane

    return device_plane.landing_zone_worthwhile()


def _maybe_landing_zone(land: Optional[str], dest: memoryview):
    """A DeviceLandingZone over ``dest`` when :func:`_wants_landing_zone`;
    None otherwise."""
    if not _wants_landing_zone(land):
        return None
    from ray_tpu_torch.cluster import device_plane

    return device_plane.DeviceLandingZone(dest)


def fetch_bytes(
    link: PeerLink,
    object_id: str,
    purpose: str = "task_args",
    deadline: Optional[float] = None,
    land: Optional[str] = None,
) -> Any:
    """Pull one object over the link into host memory (driver-side /
    arena-less callers): a ``bytearray``, or on a card with a landing
    zone a pinned ``uint8`` ndarray. ``land='device'`` additionally
    streams landed stripes to the device in flight (device landing zone);
    under an explicit ``landing("device")`` scope the device frames of
    the deserialize that follows then land from that copy — a no-op
    without a CUDA card, where no H2D hop exists."""
    out: List[object] = []
    gated = [0]
    zone: List[object] = [None]

    def alloc(total: int) -> memoryview:
        gated[0] = FETCH_GATE.acquire(
            total,
            _FetchGate.MAX_PARK_S
            if deadline is None
            else max(0.05, deadline - time.monotonic()),
        )
        buf, pinned = None, None
        if _wants_landing_zone(land):
            from ray_tpu_torch.cluster import device_plane

            if device_plane.on_card():
                # a zone on the card: the stripes land in pinned memory,
                # so its copies are DMAs that take no CPU from the recv
                buf, pinned = device_plane.pinned_landing_buffer(total)
            else:
                buf = bytearray(total)
            zone[0] = device_plane.DeviceLandingZone(
                memoryview(buf), pinned=pinned
            )
        else:
            buf = bytearray(total)
        out.append(buf)
        return memoryview(buf)

    def on_stripe(off: int, n: int) -> None:
        z = zone[0]
        if z is not None:
            z.note_stripe(off, n)

    try:
        _fetch(link, object_id, purpose, alloc, deadline, on_stripe)
        if zone[0] is not None:
            zone[0].finish()
            from ray_tpu_torch.cluster import device_plane

            # the deserialize that follows lands its frames from the
            # zone's device copy, not with a second H2D from ``out[0]``
            device_plane.keep_landed(out[0], zone[0].device_buffer)
    except BaseException:
        if zone[0] is not None:
            zone[0].abort()
        raise
    finally:
        FETCH_GATE.release(gated[0])
    return out[0]


def fetch_to_store(
    link: PeerLink,
    object_id: str,
    store,
    purpose: str = "task_args",
    deadline: Optional[float] = None,
    land: Optional[str] = None,
) -> int:
    """Pull one object over the link and land it in the local store.

    Zero-copy landing: stripes scatter-write into an UNSEALED arena
    entry (``store.begin_put``) and the object seals only after the last
    stripe — readers can never observe a half-landed object, and an
    aborted transfer frees its staged pages. When the arena cannot host
    the object even after eviction, stripes land in host memory and the
    joined bytes take ``put_bytes`` (which owns the spill fallback).

    ``land='device'`` wraps the staged entry in a device landing zone:
    completed stripes of the contiguous prefix are copied to the card in
    flight. The object is read later from the arena, so that copy is
    dropped at the end (the runtime's own pulls never ask for it; the
    socket get of ``fetch_bytes`` is where a zone's copy is used). An
    abort frees BOTH sides — partial device buffers (zone.abort) and
    staged arena pages (abort_put) — and per-stripe resume is
    unaffected because the zone only ever consumes fully-landed
    disjoint stripes. Returns the object's size."""
    state: Dict[str, object] = {}
    gated = [0]
    zone: List[object] = [None]

    def alloc(total: int) -> memoryview:
        # cross-fetch byte gate BEFORE staging arena pages: concurrent
        # partition pulls queue here while earlier ones land/spill
        gated[0] = FETCH_GATE.acquire(
            total,
            _FetchGate.MAX_PARK_S
            if deadline is None
            else max(0.05, deadline - time.monotonic()),
        )
        staged = None
        beginner = getattr(store, "begin_put", None)
        if beginner is not None:
            try:
                staged = beginner(object_id, total)
            except KeyError:
                # already stored locally (raced another pull): land into
                # throwaway host memory; commit becomes a no-op
                state["dup"] = True
                staged = None
            except Exception:  # noqa: BLE001 - arena unavailable
                staged = None
        if staged is None:
            buf = bytearray(total)
            state["buf"] = buf
            staged = memoryview(buf)
        else:
            state["staged"] = True
        zone[0] = _maybe_landing_zone(land, staged)
        return staged

    def on_stripe(off: int, n: int) -> None:
        z = zone[0]
        if z is not None:
            z.note_stripe(off, n)

    try:
        total = _fetch(link, object_id, purpose, alloc, deadline, on_stripe)
        if zone[0] is not None:
            zone[0].finish()
    except BaseException:
        if zone[0] is not None:
            zone[0].abort()
        if state.get("staged"):
            store.abort_put(object_id)
        raise
    finally:
        FETCH_GATE.release(gated[0])
    if state.get("dup"):
        return total
    if state.get("staged"):
        store.commit_put(object_id)
    else:
        store.put_bytes(object_id, bytes(state["buf"]))
    return total


# ---------------------------------------------------------------------------
# link cache (per requesting process)
# ---------------------------------------------------------------------------


class PeerLinkCache:
    """Granted links by destination node, with idle-TTL reclamation.

    ``get`` returns a cached link (bumping ``peer_conn_reused_total`` —
    the zero-head-RPC steady state) or grants through the provided
    ``grant_fn`` once. ``sweep_idle`` closes and returns links whose
    last transfer is older than the idle TTL; ``hot_links`` lists ids to
    renew on the next piggybacked report."""

    def __init__(self, grant_fn: Callable[[str], Optional[PeerLink]]):
        self._grant = grant_fn
        self._links: Dict[str, PeerLink] = {}
        self._lock = threading.Lock()

    def get(self, node_id: str) -> Optional[PeerLink]:
        with self._lock:
            link = self._links.get(node_id)
        if link is not None:
            PEER_CONN_REUSED.inc()
            return link
        link = self._grant(node_id)
        if link is None:
            return None
        with self._lock:
            cur = self._links.setdefault(node_id, link)
        if cur is not link:
            link.close()
        return cur

    def drop(self, node_id: str, link_id: Optional[str] = None) -> bool:
        """Invalidate a cached link (revocation, handshake rejection,
        node death). ``link_id`` guards against dropping a REPLACEMENT
        grant that raced in."""
        with self._lock:
            link = self._links.get(node_id)
            if link is None or (
                link_id is not None and link.link_id != link_id
            ):
                return False
            del self._links[node_id]
        link.close()
        return True

    def hot_links(self, horizon_s: float) -> List[str]:
        with self._lock:
            return [
                l.link_id
                for l in self._links.values()
                if l.idle_for() <= horizon_s
            ]

    def sweep_idle(self, idle_ttl_s: float) -> List[PeerLink]:
        with self._lock:
            victims = [
                (nid, l)
                for nid, l in self._links.items()
                if l.idle_for() > idle_ttl_s
            ]
            for nid, _ in victims:
                del self._links[nid]
        for _, l in victims:
            l.close()
        return [l for _, l in victims]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "link_id": l.link_id,
                    "node_id": nid,
                    "endpoint": l.endpoint,
                    "idle_s": round(l.idle_for(), 1),
                    "transfers": l.transfers,
                }
                for nid, l in self._links.items()
            ]

    def close(self) -> None:
        with self._lock:
            victims = list(self._links.values())
            self._links.clear()
        for l in victims:
            l.close()
