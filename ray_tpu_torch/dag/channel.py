"""Compiled-DAG channels: the per-edge transport under CompiledDAG.

Two implementations behind one interface:

- ``LocalChannel`` — in-process bounded queue passing Python objects **by
  reference**: a CUDA tensor crossing a local edge never leaves the
  card (its ``data_ptr()`` is unchanged) (the in-process seed of RDT — the reference moves device tensors
  via NCCL channels, python/ray/experimental/rdt/; on one host we simply
  hand over the buffer).
- ``ShmChannel`` — cross-process SPSC ring over a file-backed mmap with a
  native C++ core (futex blocking, release/acquire publication; see
  ray_tpu_torch/native/ring.cc). The analog of the reference's
  shared_memory_channel.py, without a per-message object-store round trip:
  messages are length-prefixed blobs in the ring itself.

Wire format (ShmChannel): cloudpickle payloads tagged OK/ERR/STOP. Error
markers flow through the same edges as data so a failure at stage k
surfaces at the driver in order, and STOP tears the pipeline down in
topological order.

Port of ``ray_tpu/dag/channel.py``, copied with its imports rewritten.
The port's rings live under ``ray_tpu_torch_dag/`` (the reference's under
``ray_tpu_dag/``), so neither package's orphan sweep takes the other's;
the ring format is the same, so either package reads the other's ring
given its path.
"""
from __future__ import annotations

import ctypes
import os
import pickle
import threading
from collections import deque
from typing import Any, Optional, Tuple

import cloudpickle

OK = 0
ERR = 1
STOP = 2
TENSOR = 3  # raw device/host tensor via the RDT codec (no pickle)


class ChannelClosed(Exception):
    pass


class ChannelTimeout(Exception):
    pass


class LocalChannel:
    """Bounded in-process SPSC queue; items pass by reference."""

    def __init__(self, capacity: int = 16):
        self._q: deque = deque()
        self._cap = capacity
        self._cv = threading.Condition()

    def put(self, tag: int, value: Any, timeout: Optional[float] = None) -> None:
        with self._cv:
            while len(self._q) >= self._cap:
                if not self._cv.wait(timeout=timeout):
                    raise ChannelTimeout("channel full")
            self._q.append((tag, value))
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None) -> Tuple[int, Any]:
        with self._cv:
            while not self._q:
                if not self._cv.wait(timeout=timeout):
                    raise ChannelTimeout("channel empty")
            item = self._q.popleft()
            self._cv.notify_all()
            return item

    def close_write(self) -> None:
        pass

    def close(self) -> None:
        pass

    def unlink(self) -> None:
        pass


_ring_lib = None
_ring_lock = threading.Lock()


def _lib():
    global _ring_lib
    with _ring_lock:
        if _ring_lib is None:
            from ray_tpu_torch.native.build import build_native

            lib = ctypes.CDLL(build_native("ring"))
            lib.rtpu_ring_open.restype = ctypes.c_void_p
            lib.rtpu_ring_open.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_int,
            ]
            lib.rtpu_ring_write.restype = ctypes.c_int
            lib.rtpu_ring_write.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_double,
            ]
            lib.rtpu_ring_next_size.restype = ctypes.c_int64
            lib.rtpu_ring_next_size.argtypes = [ctypes.c_void_p, ctypes.c_double]
            lib.rtpu_ring_read.restype = ctypes.c_int64
            lib.rtpu_ring_read.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_double,
            ]
            lib.rtpu_ring_close_write.argtypes = [ctypes.c_void_p]
            lib.rtpu_ring_capacity.restype = ctypes.c_uint64
            lib.rtpu_ring_capacity.argtypes = [ctypes.c_void_p]
            lib.rtpu_ring_used.restype = ctypes.c_uint64
            lib.rtpu_ring_used.argtypes = [ctypes.c_void_p]
            lib.rtpu_ring_close.argtypes = [ctypes.c_void_p]
            _ring_lib = lib
        return _ring_lib


def channel_dir() -> str:
    """The ring files' directory, under the process's temporary directory
    (``TMPDIR``) as the shm arena's files are: processes of one cluster
    inherit it, and a process with another ``TMPDIR`` neither sees nor
    sweeps these rings."""
    import tempfile

    d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_dag")
    os.makedirs(d, exist_ok=True)
    return d


def ring_path(name: str, pid: Optional[int] = None) -> str:
    """Canonical ring-file path: the CREATOR's pid rides in the filename
    (``<name>.p<pid>.ring``) so :func:`sweep_orphan_rings` can reap files
    whose owner died without the unlink (SIGKILL mid-pipeline) — the same
    hygiene the shm arena got from ``sweep_orphan_stores``."""
    return os.path.join(
        channel_dir(), f"{name}.p{pid if pid is not None else os.getpid()}.ring"
    )


def sweep_orphan_rings(directory: Optional[str] = None) -> list:
    """Unlink ring files left behind by SIGKILLed producers/consumers.

    A ``*.p<pid>.ring`` file is an orphan when its creator pid is dead;
    legacy un-stamped ``*.ring`` files are reaped only once stale (>1h
    mtime — they may belong to a live compiled DAG from an old build).
    Run at agent start alongside ``sweep_orphan_stores``. Returns the
    paths removed."""
    import re
    import time as _time

    directory = directory or channel_dir()
    removed = []
    pat = re.compile(r"\.p(\d+)\.ring$")
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    now = _time.time()
    for name in names:
        if not name.endswith(".ring"):
            continue
        path = os.path.join(directory, name)
        m = pat.search(name)
        if m:
            pid = int(m.group(1))
            if pid > 0 and _pid_alive(pid):
                continue
        else:
            try:
                if now - os.path.getmtime(path) < 3600:
                    continue
            except OSError:
                continue
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def _pid_alive(pid: int) -> bool:
    from ray_tpu_torch.native.shm_store import _pid_alive as alive

    return alive(pid)


# observability: every open ShmChannel registers here (weakly) so debug
# surfaces can report ring fill levels without holding channels alive
import weakref

_OPEN_CHANNELS: "weakref.WeakSet" = weakref.WeakSet()


def ring_stats() -> list:
    """Fill levels of this process's open rings (racy snapshot)."""
    out = []
    for ch in list(_OPEN_CHANNELS):
        try:
            used = ch.used()
        except Exception:  # noqa: BLE001 - closed under us
            continue
        out.append(
            {
                "path": ch.path,
                "capacity": ch._cap,
                "used": used,
                "fill": round(used / ch._cap, 4) if ch._cap else 0.0,
            }
        )
    return out


class ShmChannel:
    """One SPSC edge over shared memory. Same-host only (like the
    reference's shared-memory channel); cross-host DAG edges are routed by
    the installer, not this class."""

    def __init__(self, path: str, capacity: int = 1 << 22, create: bool = False):
        self.path = path
        self._lib = _lib()
        self._h = self._lib.rtpu_ring_open(
            path.encode(), capacity, 1 if create else 0
        )
        if not self._h:
            raise OSError(f"failed to open ring channel at {path}")
        self._cap = self._lib.rtpu_ring_capacity(self._h)
        self._closed = False
        # serializes used() against close(): rtpu_ring_close munmaps the
        # header, so an observability read racing teardown would fault
        self._state_lock = threading.Lock()
        _OPEN_CHANNELS.add(self)

    def put(self, tag: int, value: Any, timeout: Optional[float] = None) -> None:
        if tag == OK:
            # tensors skip pickle: raw dtype/shape + buffer bytes (rdt
            # codec; one D2H copy here for a CUDA tensor, H2D on the reader)
            from ray_tpu_torch.rdt import encode_tensor

            t = encode_tensor(value)
            if t is not None:
                self.put_bytes(bytes([TENSOR]) + t, timeout)
                return
        payload = bytes([tag]) + (
            cloudpickle.dumps(value) if tag != STOP else b""
        )
        self.put_bytes(payload, timeout)

    def put_bytes(self, payload: bytes, timeout: Optional[float] = None) -> None:
        rc = self._lib.rtpu_ring_write(
            self._h, payload, len(payload), -1.0 if timeout is None else timeout
        )
        if rc == -1:
            raise ChannelTimeout(f"write timed out on {self.path}")
        if rc == -3:
            raise ChannelClosed(self.path)
        if rc == -2:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds ring capacity "
                f"{self._cap}; pass a larger buffer_size_bytes to "
                f"experimental_compile()"
            )

    def get(self, timeout: Optional[float] = None) -> Tuple[int, Any]:
        data = self.get_bytes(timeout)
        tag = data[0]
        if tag == STOP:
            return STOP, None
        if tag == TENSOR:
            from ray_tpu_torch.rdt import decode_tensor

            ok, value = decode_tensor(data[1:])
            if not ok:
                # NOT ChannelClosed: that reads as clean shutdown to stage
                # loops; corruption must surface as a stage error
                raise ValueError(
                    f"corrupt tensor frame on {self.path} "
                    f"({len(data)} bytes)"
                )
            return OK, value
        return tag, pickle.loads(data[1:])

    def get_bytes(self, timeout: Optional[float] = None) -> bytes:
        t = -1.0 if timeout is None else timeout
        size = self._lib.rtpu_ring_next_size(self._h, t)
        if size == -1:
            raise ChannelTimeout(f"read timed out on {self.path}")
        if size == -3:
            raise ChannelClosed(self.path)
        buf = ctypes.create_string_buffer(size)
        got = self._lib.rtpu_ring_read(self._h, buf, size, t)
        if got == -1:
            raise ChannelTimeout(f"read timed out on {self.path}")
        if got == -3:
            raise ChannelClosed(self.path)
        return buf.raw[:got]

    def used(self) -> int:
        """Unread bytes currently buffered (observability only)."""
        with self._state_lock:
            if not self._h:
                return 0
            return self._lib.rtpu_ring_used(self._h)

    def close_write(self) -> None:
        if self._h:
            self._lib.rtpu_ring_close_write(self._h)

    def close(self) -> None:
        with self._state_lock:
            if not self._h or self._closed:
                return
            self._closed = True
            h, self._h = self._h, None
        _OPEN_CHANNELS.discard(self)
        self._lib.rtpu_ring_close(h)

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
