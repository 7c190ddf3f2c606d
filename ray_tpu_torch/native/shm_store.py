"""ctypes binding for the C++ shared-memory object store.

Port of ``ray_tpu/native/shm_store.py``, copied. Its arena and spill names
carry the port's prefix, so both packages' stores can live in one process.


Zero-copy path: ``put_numpy``/``put_frames`` write into the mmap arena;
``get_numpy``/``get_view`` return VIEWS over the same shared pages — any
process that opens the same store file sees the bytes without a copy (the
plasma fd-passing model, by shared file instead of fd fling).

View lifetime: ``get_view`` pins the object (shared-memory refcount, so
the pin is visible across processes); a ``delete`` that lands while views
are outstanding defers the arena free until the last view's finalizer
releases the pin (zombie entries, object_store.cc) — a mapped numpy view
can never observe its pages being reused.
"""
from __future__ import annotations

import ctypes
import json
import os
import tempfile
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .build import build_native

_ID_LEN = 28


def pin_log_path(arena_path: str, pid: int) -> str:
    return f"{arena_path}.pins.{pid}"


class PinLog:
    """Append-only, crash-durable sidecar recording one process's
    outstanding ``get_view`` pins as ``P <id> <offset>`` / ``R <id>
    <offset>`` lines.

    The shared-memory refcount lives in the arena header, so a reader
    that dies (SIGKILL) leaks its pins — the arena can't know. The log
    lets the AGENT net out the dead reader's outstanding pins and
    release them (id, offset)-precise. Ordering is chosen so a crash in
    any window can only leak (bounded, reclaimed at the next arena
    restart), never double-release: the pin record lands AFTER the pin
    is taken, and the release record lands BEFORE the refcount drops —
    replay therefore never releases a share the process still held."""

    def __init__(self, path: str):
        self.path = path
        # O_APPEND: each record is one short write, atomic per POSIX
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)

    def pin(self, oid: bytes, offset: int) -> None:
        try:
            os.write(self._fd, b"P %s %d\n" % (oid, offset))
        except OSError:
            pass  # best-effort: a full disk must not fail reads

    def release(self, oid: bytes, offset: int) -> None:
        try:
            os.write(self._fd, b"R %s %d\n" % (oid, offset))
        except OSError:
            pass

    def close(self) -> None:
        # the file itself is NOT unlinked here: even a clean exit can
        # leave un-finalized views, and the agent's death replay is what
        # nets the log out and removes it
        try:
            os.close(self._fd)
        except OSError:
            pass


def read_outstanding_pins(path: str):
    """Net a pin log down to its outstanding ``(id, offset) -> count``
    entries. Tolerates a torn trailing record (crash mid-write)."""
    from collections import Counter

    out: "Counter" = Counter()
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out
    for line in data.split(b"\n"):
        parts = line.split()
        if len(parts) != 3 or parts[0] not in (b"P", b"R"):
            continue
        try:
            key = (bytes(parts[1]), int(parts[2]))
        except ValueError:
            continue
        out[key] += 1 if parts[0] == b"P" else -1
    return out


class NativeObjectStore:
    def __init__(
        self,
        path: Optional[str] = None,
        capacity: int = 1 << 28,  # 256 MiB default arena
        table_slots: int = 1 << 14,
        create: bool = True,
    ):
        lib = ctypes.CDLL(build_native("objstore"))
        lib.rtpu_store_open.restype = ctypes.c_void_p
        lib.rtpu_store_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.rtpu_store_create.restype = ctypes.c_int64
        lib.rtpu_store_create.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        for fn in ("rtpu_store_seal", "rtpu_store_release", "rtpu_store_delete"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_store_release_at.restype = ctypes.c_int
        lib.rtpu_store_release_at.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        lib.rtpu_store_get.restype = ctypes.c_int
        lib.rtpu_store_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtpu_store_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rtpu_store_base.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_zombie_count.restype = ctypes.c_uint64
        lib.rtpu_store_zombie_count.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self.path = path or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_store_{os.getpid()}.shm"
        )
        self._owns_file = path is None
        self._unlinked = False
        self._h = lib.rtpu_store_open(
            self.path.encode(), capacity, table_slots, 1 if create else 0
        )
        if not self._h:
            raise OSError(f"failed to open native store at {self.path}")
        # per-pid crash-safe registry of outstanding view pins (see
        # PinLog): enabled by long-lived readers (workers) so the agent
        # can release a SIGKILLed reader's pins release_at-precise
        # instead of leaking arena zombies until restart
        self._pin_log: Optional[PinLog] = None

    def enable_pin_tracking(self) -> None:
        """Track this process's ``get_view`` pins in a crash-durable
        per-pid sidecar (``<arena>.pins.<pid>``). The agent replays the
        sidecar when this process dies and releases every outstanding
        pin, so a SIGKILLed reader no longer leaks zombie entries."""
        if self._pin_log is None:
            self._pin_log = PinLog(pin_log_path(self.path, os.getpid()))

    # -- raw bytes ------------------------------------------------------
    def _norm_id(self, object_id: str) -> bytes:
        b = object_id.encode()
        if len(b) != _ID_LEN:
            # non-canonical ids get a collision-safe digest form
            import hashlib

            b = hashlib.sha256(b).hexdigest()[:_ID_LEN].encode()
        return b

    def put_bytes(self, object_id: str, data: bytes) -> None:
        self.put_frames(object_id, [data])

    def put_frames(self, object_id: str, frames: Sequence) -> int:
        """Scatter-write ``frames`` (bytes / memoryviews) as one object —
        the out-of-band wire format streams straight into shared memory
        with a single gather copy. Returns the object's total size."""
        sizes = [
            f.nbytes if isinstance(f, memoryview) else len(f) for f in frames
        ]
        total = sum(sizes)
        oid = self._norm_id(object_id)
        off = self._lib.rtpu_store_create(self._h, oid, total)
        if off == -2:
            raise KeyError(f"object {object_id} already in store")
        if off < 0:
            raise MemoryError(f"native store allocation failed ({off})")
        base = self._lib.rtpu_store_base(self._h)
        dest = memoryview(
            (ctypes.c_char * total).from_address(
                ctypes.addressof(base.contents) + off
            )
        ).cast("B")
        pos = 0
        for f, n in zip(frames, sizes):
            if n == 0:
                continue
            src = f if isinstance(f, memoryview) else memoryview(f)
            dest[pos : pos + n] = src.cast("B")
            pos += n
        self._lib.rtpu_store_seal(self._h, oid)
        return total

    # -- staged puts (cross-node receive path) --------------------------
    def begin_put(self, object_id: str, total: int) -> memoryview:
        """Allocate an UNSEALED arena entry and hand back a writable view
        over its pages — the cross-node receive path scatter-writes
        stripes straight into shared memory (put_frames split into
        allocate / land / seal so the landing can happen from socket
        recv loops). Finish with :meth:`commit_put` (seal) or
        :meth:`abort_put` (free); readers cannot observe the entry until
        the commit."""
        oid = self._norm_id(object_id)
        off = self._lib.rtpu_store_create(self._h, oid, total)
        if off == -2:
            raise KeyError(f"object {object_id} already in store")
        if off < 0:
            raise MemoryError(f"native store allocation failed ({off})")
        base = self._lib.rtpu_store_base(self._h)
        return memoryview(
            (ctypes.c_char * total).from_address(
                ctypes.addressof(base.contents) + off
            )
        ).cast("B")

    def commit_put(self, object_id: str) -> None:
        self._lib.rtpu_store_seal(self._h, self._norm_id(object_id))

    def abort_put(self, object_id: str) -> None:
        """Free a staged entry whose transfer failed. Deletes the
        UNSEALED entry directly (delete tombstones any entry whose only
        share is the creator's) — the half-landed bytes are never
        observable: get refuses unsealed entries, and no seal ever
        happens on this path."""
        try:
            self._lib.rtpu_store_delete(self._h, self._norm_id(object_id))
        except Exception:  # noqa: BLE001 - best-effort reclamation
            pass

    def get_buffer(self, object_id: str) -> Tuple[int, int]:
        oid = self._norm_id(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_store_get(
            self._h, oid, ctypes.byref(off), ctypes.byref(size)
        )
        if rc == -1:
            raise KeyError(object_id)
        if rc == -2:
            raise BlockingIOError(f"object {object_id} not sealed yet")
        if rc != 0:
            raise OSError(f"store get failed ({rc})")
        return off.value, size.value

    def get_bytes(self, object_id: str) -> bytes:
        # every release in this class goes through release_at: an id-only
        # release cannot find an entry that went zombie under our pin (a
        # concurrent delete/spill) and could decrement a same-id
        # SUCCESSOR's creator share instead — (id, offset) is precise
        off, size = self.get_buffer(object_id)
        base = self._lib.rtpu_store_base(self._h)
        out = ctypes.string_at(ctypes.addressof(base.contents) + off, size)
        self._lib.rtpu_store_release_at(self._h, self._norm_id(object_id), off)
        return out

    def get_range(self, object_id: str, offset: int, length: int) -> bytes:
        """One chunk of an object (peer transfer slicing) — copies only
        the requested window."""
        off, size = self.get_buffer(object_id)
        try:
            if offset >= size:
                return b""
            n = min(length, size - offset)
            base = self._lib.rtpu_store_base(self._h)
            return ctypes.string_at(
                ctypes.addressof(base.contents) + off + offset, n
            )
        finally:
            self._lib.rtpu_store_release_at(
                self._h, self._norm_id(object_id), off
            )

    def get_view(self, object_id: str) -> memoryview:
        """Read-only zero-copy view over the object's shared pages.

        The object stays pinned (shared refcount) until every view/array
        derived from the returned memoryview is garbage-collected; a
        concurrent delete defers the arena free until then."""
        oid = self._norm_id(object_id)
        off, size = self.get_buffer(object_id)  # pins
        if self._pin_log is not None:
            # recorded AFTER the pin exists: a crash between the two can
            # only leak this one pin, never replay-release a live share
            self._pin_log.pin(oid, off)
        base = self._lib.rtpu_store_base(self._h)
        raw = (ctypes.c_uint8 * size).from_address(
            ctypes.addressof(base.contents) + off
        )
        # finalizer releases the pin when the LAST derived view dies (the
        # memoryview chain keeps `raw` alive); release_at is (id, offset)-
        # precise so a same-id reput can never absorb this release
        weakref.finalize(raw, self._release_pin, oid, off)
        return memoryview(raw).toreadonly()

    def _release_pin(self, oid: bytes, off: int) -> None:
        if self._h:
            if self._pin_log is not None:
                # logged BEFORE the refcount drops: a crash in between
                # leaks (reclaimed next restart) instead of letting the
                # agent's replay double-release a freed entry
                self._pin_log.release(oid, off)
            try:
                self._lib.rtpu_store_release_at(self._h, oid, off)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def release_dead_pins(self, pid: int) -> int:
        """Replay a dead reader's pin log and release every pin it still
        held ((id, offset)-precise — exactly what its finalizers would
        have done). Returns the number of pins released; removes the
        log. The agent calls this from its worker-death path so a
        SIGKILLed reader's zombies are reclaimed immediately instead of
        at the next arena restart."""
        path = pin_log_path(self.path, pid)
        outstanding = read_outstanding_pins(path)
        released = 0
        for (oid, off), n in outstanding.items():
            for _ in range(max(0, n)):
                if self._lib.rtpu_store_release_at(self._h, oid, off) == 0:
                    released += 1
        try:
            os.unlink(path)
        except OSError:
            pass
        return released

    def zombie_count(self) -> int:
        """Entries deleted while readers still pinned them and not yet
        reclaimed. Nonzero after every reader released (or died and had
        its pin log replayed) means a leak; the chaos soak asserts 0."""
        return int(self._lib.rtpu_store_zombie_count(self._h))

    # -- zero-copy numpy ------------------------------------------------
    def put_numpy(self, object_id: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        header = json.dumps(
            {"dtype": arr.dtype.str, "shape": list(arr.shape)}
        ).encode()
        self.put_frames(
            object_id,
            [len(header).to_bytes(4, "little"), header, memoryview(arr).cast("B")],
        )

    def get_numpy(self, object_id: str) -> np.ndarray:
        """Returns a read-only view over the shared pages (no copy)."""
        mv = self.get_view(object_id)
        hlen = int.from_bytes(mv[:4], "little")
        meta = json.loads(bytes(mv[4 : 4 + hlen]))
        arr = np.frombuffer(
            mv, dtype=np.dtype(meta["dtype"]), offset=4 + hlen
        ).reshape(meta["shape"])
        return arr

    def object_size(self, object_id: str) -> int:
        off, size = self.get_buffer(object_id)
        self._lib.rtpu_store_release_at(self._h, self._norm_id(object_id), off)
        return size

    def delete(self, object_id: str) -> None:
        self._lib.rtpu_store_delete(self._h, self._norm_id(object_id))

    def contains(self, object_id: str) -> bool:
        try:
            off, _ = self.get_buffer(object_id)
            self._lib.rtpu_store_release_at(
                self._h, self._norm_id(object_id), off
            )
            return True
        except (KeyError, BlockingIOError):
            return False

    def stats(self) -> dict:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        num = ctypes.c_uint64()
        self._lib.rtpu_store_stats(
            self._h, ctypes.byref(cap), ctypes.byref(used), ctypes.byref(num)
        )
        return {
            "capacity": cap.value,
            "used": used.value,
            "num_objects": num.value,
        }

    def close(self, unlink: bool = False) -> None:
        if self._pin_log is not None:
            self._pin_log.close()
            self._pin_log = None
        if self._h:
            self._lib.rtpu_store_close(self._h)
            self._h = None
        # unlink exactly once: close(unlink=True) + __del__ used to race
        # a second unlink, and a path-sharing reader (worker) closing its
        # mapping must never take the agent's arena file with it
        if (unlink or self._owns_file) and not self._unlinked:
            self._unlinked = True
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def sweep_orphan_stores(tmpdir: Optional[str] = None) -> List[str]:
    """Remove ``ray_tpu_torch_store_*.shm`` arenas / ``ray_tpu_torch_spill_*`` dirs
    left by killed agents (chaos kills skip the unlink path). A file is
    an orphan when the pid embedded in its name is no longer alive; run
    at agent start so /tmp does not accrete a dead agent's arena per
    kill. Returns the paths removed."""
    import re
    import shutil

    tmpdir = tmpdir or tempfile.gettempdir()
    removed: List[str] = []
    try:
        names = os.listdir(tmpdir)
    except OSError:
        return removed
    pat = re.compile(r"^ray_tpu_torch_(store|spill)_.*?(\d+)(\.shm)?$")
    for name in names:
        m = pat.match(name)
        if not m:
            continue
        pid = int(m.group(2))
        if pid <= 0 or _pid_alive(pid):
            continue
        path = os.path.join(tmpdir, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True
