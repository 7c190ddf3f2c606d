"""Disk-spilling wrapper around a node's object store.

Analog of the reference's plasma eviction + LocalObjectManager spill/restore
(Ray's src/ray/object_manager/plasma/eviction_policy.h,
src/ray/raylet/local_object_manager.h:139-152), collapsed into one layer:

- ``put_bytes`` NEVER hard-errors on a full arena: it spills
  least-recently-used sealed objects to disk until the new object fits, and
  if the object is bigger than what can be freed, the object itself goes to
  disk (create-request backpressure becomes "succeed via disk" instead of
  the reference's queue-and-wait — same liveness, simpler protocol).
- ``get_bytes`` restores from disk transparently (and re-caches into the
  arena when it fits), so readers never observe the spill.
- The distributed GC's DeleteObjects reaches both tiers.

Workers write directly into the shared-memory arena from their own
processes; the agent registers those seals via ``note_external`` so the LRU
book covers them too (it can read any arena object for spilling).

Port of ``ray_tpu/native/spill.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import shutil
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util.metrics import Counter as _Counter

SHM_EVICTIONS = _Counter(
    "shm_store_evictions_total",
    "Arena residents spilled to disk to make room (LRU eviction).",
)


class SpillingStore:
    def __init__(
        self,
        inner,
        spill_dir: str,
        capacity: Optional[int] = None,
        headroom_frac: float = 0.1,
        backend=None,
    ):
        from .spill_storage import FileSystemBackend

        self.inner = inner
        self.spill_dir = spill_dir
        # pluggable external storage (external_storage.py analog):
        # node-local files by default; memory:// / s3:// via
        # cfg.spill_storage_uri at the agent. Only a backend WE created
        # (the per-node default) is destroyed at close: a user-configured
        # shared target (file:// on NFS, an s3 prefix) holds other nodes'
        # objects.
        self._owns_backend = backend is None
        self.backend = backend or FileSystemBackend(spill_dir)
        stats = getattr(inner, "stats", None)
        self.capacity = capacity or (stats()["capacity"] if stats else 1 << 28)
        self._headroom = int(self.capacity * headroom_frac)
        self._lock = threading.RLock()
        # LRU book of arena-resident objects: oid -> size (insertion order =
        # recency; move_to_end on access)
        self._resident: "OrderedDict[str, int]" = OrderedDict()
        self._spilled: Dict[str, int] = {}  # oid -> size on disk
        self._spilling: set = set()  # victims with a disk write in flight
        self.metrics = {"spilled_objects": 0, "spilled_bytes": 0, "restored": 0}

    # -- paths ---------------------------------------------------------
    def _write_spill_file(self, oid: str, data: bytes) -> None:
        self.backend.put(oid, data)

    @property
    def store_path(self) -> str:  # workers map the inner arena
        return getattr(self.inner, "path", "")

    def release_dead_pins(self, pid: int) -> int:
        """Replay a dead reader's view-pin log against the inner arena
        (zombie-pin reclamation); 0 with the in-memory fallback store."""
        fn = getattr(self.inner, "release_dead_pins", None)
        return int(fn(pid)) if fn is not None else 0

    def zombie_count(self) -> int:
        fn = getattr(self.inner, "zombie_count", None)
        return int(fn()) if fn is not None else 0

    # -- bookkeeping ---------------------------------------------------
    def note_external(self, oid: str, size: int) -> None:
        """A worker sealed this object straight into the shared arena."""
        with self._lock:
            if oid not in self._spilled and self.inner.contains(oid):
                self._resident[oid] = size
                self._resident.move_to_end(oid)

    def _touch(self, oid: str) -> None:
        with self._lock:
            if oid in self._resident:
                self._resident.move_to_end(oid)

    # -- spill machinery ----------------------------------------------
    def _make_room(self, need: int) -> None:
        """Spill LRU residents until ``need`` + headroom fits. Disk writes
        happen OUTSIDE the lock — contains/get/fetch traffic must not queue
        behind file I/O (a full arena would otherwise serialize the whole
        node's object plane on the disk)."""
        stats = getattr(self.inner, "stats", None)
        if stats is None:
            return
        target_free = need + self._headroom
        while True:
            with self._lock:
                s = stats()
                if s["capacity"] - s["used"] >= target_free:
                    return
                # concurrent _make_room callers must not race on one
                # victim: the loser's cleanup would delete the winner's
                # freshly written spill file
                oid = next(
                    (o for o in self._resident if o not in self._spilling),
                    None,
                )
                if oid is None:
                    return
                self._spilling.add(oid)
                try:
                    data = self.inner.get_bytes(oid)
                except Exception:  # noqa: BLE001 - raced a delete
                    self._resident.pop(oid, None)
                    self._spilling.discard(oid)
                    continue
            self._write_spill_file(oid, data)
            with self._lock:
                self._spilling.discard(oid)
                if oid not in self._resident:
                    # deleted (GC) while writing — unless it was spilled by
                    # a competing path, the file must go too
                    if oid not in self._spilled:
                        self.backend.delete(oid)
                    continue
                try:
                    self.inner.delete(oid)
                except Exception:  # noqa: BLE001
                    pass
                size = self._resident.pop(oid, len(data))
                self._spilled[oid] = size
                self.metrics["spilled_objects"] += 1
                self.metrics["spilled_bytes"] += size
                SHM_EVICTIONS.inc()

    # -- store interface ----------------------------------------------
    def put_bytes(self, oid: str, data: bytes) -> None:
        with self._lock:
            # duplicate put of an immutable object (task retried after its
            # first execution's reply was lost): already stored, either tier
            if self.inner.contains(oid) or oid in self._spilled:
                return
        for attempt in range(2):
            with self._lock:
                try:
                    self.inner.put_bytes(oid, data)
                    self._resident[oid] = len(data)
                    self._resident.move_to_end(oid)
                    return
                except Exception:  # noqa: BLE001 - arena full (or dup key)
                    if self.inner.contains(oid):
                        return  # duplicate put: already stored
            if attempt == 0:
                self._make_room(len(data))
        # last resort: the new object itself lives on disk
        self._write_spill_file(oid, data)
        with self._lock:
            self._spilled[oid] = len(data)
            self.metrics["spilled_objects"] += 1
            self.metrics["spilled_bytes"] += len(data)

    def put_frames(self, oid: str, frames: Sequence) -> None:
        """Scatter-put of the out-of-band wire frames: writes straight
        into the arena when it fits — including after an LRU spill pass
        when it is full (the zero-copy seal path must not degrade to a
        monolithic join exactly under memory pressure). Only an object
        that cannot fit even after eviction takes the joined put_bytes
        route (which owns the spill-to-disk fallback)."""
        putf = getattr(self.inner, "put_frames", None)
        if putf is not None:
            total = sum(
                f.nbytes if isinstance(f, memoryview) else len(f)
                for f in frames
            )
            for attempt in range(2):
                with self._lock:
                    if self.inner.contains(oid) or oid in self._spilled:
                        return
                    try:
                        putf(oid, frames)
                        self._resident[oid] = total
                        self._resident.move_to_end(oid)
                        return
                    except MemoryError:
                        pass
                    except KeyError:
                        return  # duplicate put: already stored
                if attempt == 0:
                    self._make_room(total)
        data = b"".join(
            bytes(f) if isinstance(f, memoryview) else f for f in frames
        )
        self.put_bytes(oid, data)

    # -- staged puts (cross-node receive path) -------------------------
    def begin_put(self, oid: str, total: int) -> Optional[memoryview]:
        """Stage an arena entry for a cross-node transfer to scatter
        stripes into (spilling LRU residents to make room first).
        Returns None when the arena cannot host it even after eviction
        (or the inner store has no staged-put support) — the receiver
        then lands into host memory and takes the put_bytes route, which
        owns the spill-to-disk fallback."""
        beginner = getattr(self.inner, "begin_put", None)
        if beginner is None:
            return None
        for attempt in range(2):
            with self._lock:
                if self.inner.contains(oid) or oid in self._spilled:
                    raise KeyError(f"object {oid} already in store")
                try:
                    return beginner(oid, total)
                except MemoryError:
                    pass
                except KeyError:
                    # the entry exists but is NOT sealed (contains() was
                    # false): a CONCURRENT transfer is staging the same
                    # object right now. That is not a duplicate — the
                    # other pull may still abort — so land in host
                    # memory instead; the final put_bytes is dup-safe
                    # whichever transfer seals first.
                    return None
            if attempt == 0:
                self._make_room(total)
        return None

    def commit_put(self, oid: str) -> None:
        with self._lock:
            self.inner.commit_put(oid)
            size = getattr(self.inner, "object_size", lambda _o: 0)(oid)
            self._resident[oid] = size
            self._resident.move_to_end(oid)

    def abort_put(self, oid: str) -> None:
        with self._lock:
            aborter = getattr(self.inner, "abort_put", None)
            if aborter is not None:
                aborter(oid)

    def get_range(self, oid: str, offset: int, length: int) -> bytes:
        """One window of an object (chunked peer transfers): arena
        residents slice in place. A spilled object is RESTORED to the
        arena first so a 256-chunk pull reads the backend once, not 256
        times; only when it cannot fit back does each chunk slice a full
        backend read (bounded by the chunk count, and the transfer is
        already in degraded-capacity territory)."""
        ranger = getattr(self.inner, "get_range", None)
        if ranger is not None:
            with self._lock:
                if self.inner.contains(oid):
                    self._touch(oid)
                    return ranger(oid, offset, length)
            if self.restore_to_arena(oid):
                with self._lock:
                    if self.inner.contains(oid):
                        self._touch(oid)
                        return ranger(oid, offset, length)
        data = self.get_bytes(oid)
        return data[offset : offset + length]

    def get_bytes(self, oid: str) -> bytes:
        with self._lock:
            if self.inner.contains(oid):
                self._touch(oid)
                return self.inner.get_bytes(oid)
            spilled = oid in self._spilled
        if not spilled:
            spilled = self.backend.exists(oid)  # network probe: no lock
        if spilled:
            try:
                data = self.backend.get(oid)  # outside the lock
            except KeyError:
                # a concurrent restore_to_arena moved it back to shm
                with self._lock:
                    if self.inner.contains(oid):
                        self._touch(oid)
                        return self.inner.get_bytes(oid)
                raise KeyError(oid) from None
            with self._lock:
                self.metrics["restored"] += 1
            return data
        raise KeyError(oid)

    def restore_to_arena(self, oid: str) -> bool:
        """Bring a spilled object back into shared memory so workers can
        map it (restore path, local_object_manager.h:152)."""
        with self._lock:
            if self.inner.contains(oid):
                self._touch(oid)  # a reader is coming: keep it hot
                return True
            known_spilled = oid in self._spilled
        # backend download OUTSIDE the lock: a remote restore can be a
        # multi-MB network read and must not stall every put/get/contains
        if not known_spilled and not self.backend.exists(oid):
            return False
        try:
            data = self.backend.get(oid)
        except KeyError:
            return False
        self._make_room(len(data))
        with self._lock:
            if self.inner.contains(oid):
                self._touch(oid)
                return True  # raced another restore
            try:
                self.inner.put_bytes(oid, data)
            except Exception:  # noqa: BLE001
                return False
            self._resident[oid] = len(data)
            self._resident.move_to_end(oid)
            self._spilled.pop(oid, None)
            self.metrics["restored"] += 1
        self.backend.delete(oid)
        return True

    def object_size(self, oid: str) -> int:
        """Byte size of a stored object (KeyError when absent) — the
        chunked-fetch handshake sizes the pull without shipping bytes."""
        with self._lock:
            n = self._resident.get(oid)
            if n is None:
                n = self._spilled.get(oid)
            if n is not None:
                return n
            sizer = getattr(self.inner, "object_size", None)
            if sizer is not None and self.inner.contains(oid):
                return sizer(oid)
        return len(self.get_bytes(oid))

    def contains(self, oid: str) -> bool:
        with self._lock:
            if self.inner.contains(oid) or oid in self._spilled:
                return True
        # backend probe OUTSIDE the lock: with a remote backend this is a
        # network round-trip and must not serialize the object plane
        return self.backend.exists(oid)

    def delete(self, oid: str) -> None:
        with self._lock:
            self._resident.pop(oid, None)
            self._spilled.pop(oid, None)
            try:
                self.inner.delete(oid)
            except Exception:  # noqa: BLE001
                pass
        self.backend.delete(oid)  # network call: outside the lock

    def list_objects(self) -> List[Tuple[str, int]]:
        """(oid, size) inventory of everything this node holds — arena
        residents plus spilled entries. The agent advertises this on
        (re-)registration so a restarted head can re-seed its object
        directory."""
        with self._lock:
            out = list(self._resident.items())
            out.extend(self._spilled.items())
        return out

    def stats(self) -> dict:
        base = getattr(self.inner, "stats", None)
        out = dict(base() if base else {})
        with self._lock:
            out.update(self.metrics)
            out["resident_objects"] = len(self._resident)
            out["spilled_resident"] = len(self._spilled)
        return out

    def close(self, unlink: bool = False) -> None:
        try:
            self.inner.close(unlink=unlink)
        except Exception:  # noqa: BLE001
            pass
        if unlink:
            if self._owns_backend:
                destroy = getattr(self.backend, "destroy", None)
                if destroy is not None:
                    destroy()
            shutil.rmtree(self.spill_dir, ignore_errors=True)
