"""Pluggable head-state persistence: snapshot store + write-ahead log.

Analog of the reference's GCS storage layer
(Ray's src/ray/gcs/store_client/ — pluggable Redis/in-memory
backends) plus write-ahead durability for registrations that land between
snapshot ticks: every durable mutation (KV write, actor registration) is
appended to the WAL immediately; a snapshot supersedes and truncates it.
Recovery = load snapshot, then replay the WAL.

``FilePersistence`` is the built-in backend (length-prefixed pickled
records; atomic snapshot swap). Anything implementing the same four
methods can be passed to ``HeadServer(persist_backend=...)`` — e.g. a
Redis- or cloud-bucket-backed store.

Port of ``ray_tpu/cluster/persistence.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
from typing import Any, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.cluster.persistence")


class FilePersistence:
    """Snapshot at ``path``, WAL at ``path + '.wal'``."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.wal_path = path + ".wal"
        self.fsync = fsync
        self._lock = threading.Lock()
        self._wal_f = None

    # -- snapshot ------------------------------------------------------
    def load(self) -> Optional[dict]:
        try:
            with open(self.path, "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 - corrupt snapshot: start fresh
            logger.exception("could not load snapshot; starting fresh")
            return None

    def save_snapshot(self, snap: dict) -> None:
        """Atomic snapshot swap; the WAL it supersedes is truncated."""
        with self._lock:
            tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(snap, f)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._truncate_wal_locked()

    # -- write-ahead log -----------------------------------------------
    def wal_append(self, record: Tuple[Any, ...]) -> None:
        with self._lock:
            if self._wal_f is None:
                self._wal_f = open(self.wal_path, "ab")
            blob = pickle.dumps(record)
            self._wal_f.write(struct.pack("<I", len(blob)) + blob)
            self._wal_f.flush()
            if self.fsync:
                os.fsync(self._wal_f.fileno())

    def wal_replay(self) -> List[Tuple[Any, ...]]:
        out: List[Tuple[Any, ...]] = []
        try:
            with open(self.wal_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return out
        off = 0
        while off + 4 <= len(data):
            (n,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + n > len(data):
                break  # torn tail write: ignore the partial record
            try:
                out.append(pickle.loads(data[off : off + n]))
            except Exception:  # noqa: BLE001 - skip corrupt record
                logger.warning("skipping corrupt WAL record at offset %d", off)
            off += n
        return out

    def _truncate_wal_locked(self) -> None:
        if self._wal_f is not None:
            try:
                self._wal_f.close()
            except OSError:
                pass
            self._wal_f = None
        try:
            os.unlink(self.wal_path)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                try:
                    self._wal_f.close()
                except OSError:
                    pass
                self._wal_f = None


class MemPersistence:
    """In-memory backend (tests, standbys with no disk): same four-method
    contract as :class:`FilePersistence`, zero I/O."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._snap: Optional[dict] = None
        self._wal: List[Tuple[Any, ...]] = []

    def load(self) -> Optional[dict]:
        with self._lock:
            return self._snap

    def save_snapshot(self, snap: dict) -> None:
        with self._lock:
            self._snap = snap
            self._wal.clear()

    def wal_append(self, record: Tuple[Any, ...]) -> None:
        with self._lock:
            self._wal.append(record)

    def wal_replay(self) -> List[Tuple[Any, ...]]:
        with self._lock:
            return list(self._wal)

    def close(self) -> None:
        pass


class HandoffPersistence:
    """Promotion handoff: a warm standby's continuously-replayed tables
    become the FIRST load of the promoted head — no disk read, no WAL
    scan (the whole point of WAL shipping: promotion is an epoch bump +
    listener bind, not a replay-from-disk). Every subsequent write
    (snapshots, WAL appends) delegates to the real backend so the
    promoted head persists normally from its first dirty tick."""

    def __init__(self, inner: Any, snapshot: dict):
        self._inner = inner
        self._handoff = snapshot

    def load(self) -> Optional[dict]:
        # NOT consumed on read: promotion retries its listener bind
        # (TIME_WAIT on the dead leader's port) by constructing a fresh
        # HeadServer against this same backend, and each attempt loads
        # AGAIN — a one-shot load would hand the retry empty tables
        return self._handoff

    def wal_replay(self) -> List[Tuple[Any, ...]]:
        # the standby already merged every shipped record into the
        # handoff snapshot; the on-disk WAL (if any) predates it
        return []

    def save_snapshot(self, snap: dict) -> None:
        self._inner.save_snapshot(snap)

    def wal_append(self, record: Tuple[Any, ...]) -> None:
        self._inner.wal_append(record)

    def close(self) -> None:
        self._inner.close()
