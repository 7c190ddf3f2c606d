"""ctypes binding for the C scatter-gather socket plane (net.cc).

One :class:`NetSocket` abstraction over two implementations selected per
construction (``cfg.native_net`` is read live, so tests and the
``RAY_TPU_NATIVE_NET=0`` kill switch flip paths without re-importing):

- **native**: raw fds driven by ``net.cc`` — ``sendmsg`` gather-sends an
  iovec of frame parts (header + arena views, zero joins/copies) and
  ``recv`` loops land bytes straight at arena addresses.
- **python**: the reference-semantics fallback on the stdlib ``socket``
  module (``sendmsg`` / ``recv_into`` keep it scatter/gather too, just
  with per-call interpreter overhead).

Both speak the identical wire bytes — transport.py's parity tests pin
the two byte-for-byte. Also home to the pid-stamped endpoint artifact
helpers (``write_endpoint_file`` / ``sweep_orphan_endpoints``): a
SIGKILLed agent never unlinks its endpoint sidecar, so the next agent on
the host sweeps dead-pid files exactly like ``sweep_orphan_stores``.

Port of ``ray_tpu/native/net.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import ctypes
import errno as _errno
import json
import os
import socket
import tempfile
from typing import List, Optional, Sequence, Tuple


class NetClosedError(ConnectionError):
    """The peer closed (or reset) the data socket mid-operation."""


class NetTimeoutError(TimeoutError):
    """A data-socket operation exceeded its I/O deadline."""


def _load_native():
    from .build import build_native

    lib = ctypes.CDLL(build_native("net"))
    lib.rtpu_net_listen.restype = ctypes.c_int
    lib.rtpu_net_listen.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rtpu_net_local_port.restype = ctypes.c_int
    lib.rtpu_net_local_port.argtypes = [ctypes.c_int]
    lib.rtpu_net_accept.restype = ctypes.c_int
    lib.rtpu_net_accept.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rtpu_net_connect.restype = ctypes.c_int
    lib.rtpu_net_connect.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.rtpu_net_set_timeout.restype = ctypes.c_int
    lib.rtpu_net_set_timeout.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rtpu_net_send_vec.restype = ctypes.c_int64
    lib.rtpu_net_send_vec.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32,
    ]
    lib.rtpu_net_recv_exact.restype = ctypes.c_int64
    lib.rtpu_net_recv_exact.argtypes = [
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_uint64,
    ]
    lib.rtpu_net_close.restype = ctypes.c_int
    lib.rtpu_net_close.argtypes = [ctypes.c_int]
    return lib


_NATIVE = None
_NATIVE_TRIED = False


def native_lib():
    """The compiled net.cc library, or None (toolchain missing). Loaded
    once per process; the per-connection path choice stays live through
    ``native_net_enabled``."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            _NATIVE = _load_native()
        except Exception:  # noqa: BLE001 - toolchain missing: Python path
            _NATIVE = None
        if _NATIVE is not None:
            try:
                # dark-plane counters: register this process's shm slot
                # page so tx/rx bytes count inside the C syscall loop
                from . import counters as _dark_counters

                _dark_counters.register_with_net(_NATIVE)
            except Exception:  # noqa: BLE001 - counting is optional
                pass
    return _NATIVE


def native_net_enabled() -> bool:
    """Kill switch (RAY_TPU_NATIVE_NET, read live) AND toolchain check."""
    try:
        from ray_tpu_torch.config import cfg

        if not cfg.native_net:
            return False
    except Exception:  # noqa: BLE001 - config unavailable (bootstrap)
        if os.environ.get("RAY_TPU_NATIVE_NET", "1").lower() in (
            "0",
            "false",
            "no",
        ):
            return False
    return native_lib() is not None


def _buf_addr(mv) -> Tuple[int, object]:
    """(address, keepalive) for any contiguous buffer, read-only or not
    (ctypes from_buffer refuses read-only views; numpy's zero-copy
    frombuffer hands back the pointer either way — the wire.py idiom)."""
    import numpy as np

    mv = mv if isinstance(mv, memoryview) else memoryview(mv)
    if mv.nbytes == 0:
        return 0, None
    arr = np.frombuffer(mv, dtype=np.uint8)
    return int(arr.ctypes.data), arr


def _raise_net(rc: int, what: str) -> None:
    if rc == -_errno.EAGAIN:
        raise NetTimeoutError(f"{what} timed out")
    if rc in (-_errno.ECONNRESET, 0):
        raise NetClosedError(f"peer closed during {what}")
    raise ConnectionError(f"{what} failed: {os.strerror(-rc) if rc < 0 else rc}")


class NetSocket:
    """One data-plane connection; native fd or Python socket underneath.

    Exactly-once close: every teardown path funnels through
    :meth:`close`, which is idempotent (chaos severs and normal returns
    can race on the same connection)."""

    __slots__ = ("_fd", "_sock", "_closed", "native")

    def __init__(self, fd: Optional[int] = None, sock=None):
        self._fd = fd
        self._sock = sock
        self._closed = False
        self.native = fd is not None

    # -- constructors --------------------------------------------------
    @classmethod
    def connect(
        cls, host: str, port: int, timeout_s: float = 10.0
    ) -> "NetSocket":
        if native_net_enabled():
            lib = native_lib()
            fd = lib.rtpu_net_connect(
                host.encode(), int(port), int(timeout_s * 1000)
            )
            if fd < 0:
                raise ConnectionError(
                    f"connect {host}:{port} failed: {os.strerror(-fd)}"
                )
            return cls(fd=fd)
        sock = socket.create_connection((host, port), timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock=sock)

    # -- I/O -----------------------------------------------------------
    def set_timeout(self, timeout_s: Optional[float]) -> None:
        if self._fd is not None:
            native_lib().rtpu_net_set_timeout(
                self._fd, 0 if timeout_s is None else int(timeout_s * 1000)
            )
        else:
            self._sock.settimeout(timeout_s)

    def send_vec(self, parts: Sequence) -> int:
        """Gather-send every part (bytes / memoryviews) — ONE syscall
        round per kernel window, no user-space join."""
        if self._fd is not None:
            n = len(parts)
            ptrs = (ctypes.c_void_p * n)()
            lens = (ctypes.c_uint64 * n)()
            keep: List[object] = []
            total = 0
            for i, p in enumerate(parts):
                addr, ka = _buf_addr(p)
                ptrs[i] = addr
                nb = p.nbytes if isinstance(p, memoryview) else len(p)
                lens[i] = nb
                total += nb
                keep.append(ka)
            rc = native_lib().rtpu_net_send_vec(self._fd, ptrs, lens, n)
            if rc != total:
                _raise_net(int(rc), "send")
            return total
        try:
            total = sum(
                p.nbytes if isinstance(p, memoryview) else len(p)
                for p in parts
            )
            sent = self._sock.sendmsg(
                [p if isinstance(p, (bytes, memoryview)) else bytes(p) for p in parts]
            )
            # sendmsg may send partially; drain the remainder linearly
            if sent < total:
                joined = b"".join(
                    bytes(p) if isinstance(p, memoryview) else p
                    for p in parts
                )
                self._sock.sendall(joined[sent:])
            from . import counters as _dark_counters

            _dark_counters.add("net_py_tx_bytes_total", total)
            return total
        except socket.timeout as exc:
            raise NetTimeoutError("send timed out") from exc
        except (BrokenPipeError, ConnectionError) as exc:
            raise NetClosedError(f"peer closed during send: {exc}") from exc

    def recv_exact_into(self, mv: memoryview) -> None:
        """Land exactly len(mv) bytes at mv (an arena slice or bytearray
        view) — the scatter-write receiving half."""
        if mv.nbytes == 0:
            return
        if self._fd is not None:
            addr, keep = _buf_addr(mv)
            rc = native_lib().rtpu_net_recv_exact(self._fd, addr, mv.nbytes)
            del keep
            if rc != mv.nbytes:
                _raise_net(int(rc), "recv")
            return
        got = 0
        try:
            while got < mv.nbytes:
                r = self._sock.recv_into(mv[got:], mv.nbytes - got)
                if r == 0:
                    raise NetClosedError("peer closed during recv")
                got += r
            from . import counters as _dark_counters

            _dark_counters.add("net_py_rx_bytes_total", got)
        except socket.timeout as exc:
            raise NetTimeoutError("recv timed out") from exc
        except ConnectionError as exc:
            if isinstance(exc, NetClosedError):
                raise
            raise NetClosedError(f"peer closed during recv: {exc}") from exc

    def recv_exact(self, n: int) -> bytes:
        buf = bytearray(n)
        self.recv_exact_into(memoryview(buf))
        return bytes(buf)

    def shutdown(self) -> None:
        """Ends both directions of the connection and keeps the fd: a thread
        blocked on it wakes with EOF and closes it, and until then no new
        connection can take the fd's number and have its bytes read by that
        thread (what ``close`` from another thread allows)."""
        if self._closed:
            return
        try:
            if self._fd is not None:
                dup = socket.fromfd(self._fd, socket.AF_INET, socket.SOCK_STREAM)
                try:
                    dup.shutdown(socket.SHUT_RDWR)
                finally:
                    dup.close()
            elif self._sock is not None:
                self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already closed or never connected

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fd is not None:
            try:
                native_lib().rtpu_net_close(self._fd)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
        elif self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class NetListener:
    """Listening socket (native when available — the accept path is not
    hot, but keeping one implementation per connection family means the
    accepted fd and the I/O calls agree)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self._closed = False
        if native_net_enabled():
            lib = native_lib()
            fd = lib.rtpu_net_listen(host.encode(), port)
            if fd < 0:
                raise OSError(f"net listen failed: {os.strerror(-fd)}")
            self._fd: Optional[int] = fd
            self._sock = None
            self.port = int(lib.rtpu_net_local_port(fd))
        else:
            self._fd = None
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(64)
            self.port = self._sock.getsockname()[1]
        self.address = f"{host}:{self.port}"

    def accept(self, timeout_s: float = 1.0) -> Optional[NetSocket]:
        """One accepted connection, or None on timeout (the accept loop
        polls so shutdown is prompt)."""
        if self._fd is not None:
            fd = native_lib().rtpu_net_accept(self._fd, int(timeout_s * 1000))
            if fd == -_errno.EAGAIN:
                return None
            if fd < 0:
                if self._closed:
                    return None
                raise OSError(f"accept failed: {os.strerror(-fd)}")
            return NetSocket(fd=fd)
        self._sock.settimeout(timeout_s)
        try:
            conn, _ = self._sock.accept()
        except socket.timeout:
            return None
        except OSError:
            if self._closed:
                return None
            raise
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return NetSocket(sock=conn)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fd is not None:
            try:
                native_lib().rtpu_net_close(self._fd)
            except Exception:  # noqa: BLE001
                pass
        elif self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# pid-stamped endpoint artifacts (hygiene parity with arenas/rings)
# ---------------------------------------------------------------------------


def endpoint_file_path(node_id: str, pid: Optional[int] = None) -> str:
    return os.path.join(
        tempfile.gettempdir(),
        f"ray_tpu_torch_net_{node_id}_{pid or os.getpid()}.ep",
    )


def write_endpoint_file(node_id: str, endpoint: str) -> str:
    """Drop the data-plane endpoint sidecar (operator discovery + orphan
    accounting; the auth token NEVER lands on disk)."""
    path = endpoint_file_path(node_id)
    try:
        with open(path, "w") as f:
            json.dump(
                {"node_id": node_id, "endpoint": endpoint, "pid": os.getpid()},
                f,
            )
    except OSError:
        pass
    return path


def sweep_orphan_endpoints(tmpdir: Optional[str] = None) -> List[str]:
    """Remove ``ray_tpu_torch_net_*.ep`` sidecars whose owning pid is dead (a
    SIGKILLed agent never unlinks its own). Run at agent start beside
    ``sweep_orphan_stores`` / ``sweep_orphan_rings``."""
    import re

    from .shm_store import _pid_alive

    tmpdir = tmpdir or tempfile.gettempdir()
    removed: List[str] = []
    try:
        names = os.listdir(tmpdir)
    except OSError:
        return removed
    pat = re.compile(r"^ray_tpu_torch_net_.*_(\d+)\.ep$")
    for name in names:
        m = pat.match(name)
        if not m:
            continue
        pid = int(m.group(1))
        if pid <= 0 or _pid_alive(pid):
            continue
        path = os.path.join(tmpdir, name)
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    return removed
