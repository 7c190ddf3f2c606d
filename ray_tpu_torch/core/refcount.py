"""Distributed reference counting — the ownership layer of the object plane.

Port of ``ray_tpu/core/refcount.py``, copied with its imports rewritten.
``loads_tracking`` (the remote path's borrow-registering deserializer) is
left out until ``cluster/serialization.py`` is ported.


Analog of the reference's ReferenceCounter
(/root/reference/src/ray/core_worker/reference_counter.h:44), redesigned for
this framework's centralized-head architecture instead of the reference's
per-owner ownership graph:

- Every process counts live ``ObjectRef`` *instances* per object id: incref
  on construction/deserialization, decref on ``__del__`` (the same hook the
  reference's Python ObjectRef uses to call RemoveLocalReference).
- A 1→0 transition enqueues the id; a per-process consumer (the in-process
  runtime's GC thread, or a cluster client/worker's ``RefFlusher``) drains
  the queue and either frees locally or reports the release to the head.
- The head is the single refcount authority (it already owns the object
  directory): it tracks per-process holds, in-flight lease pins, and
  contained-object pins, and frees shm copies + directory entries when all
  reach zero. The reference distributes this over owner workers with borrow
  protocols (WaitForRefRemoved); centralizing it removes that protocol
  entirely — a deliberate redesign, not a simplification of semantics:
  borrowers, nested refs, and lineage release all behave the same.

Serialization hooks: while a payload is being pickled, every ObjectRef
serialized into it is collected (the task-arg set the head must pin); while
bytes are unpickled, every ObjectRef constructed is collected (the borrow
set a getter must register). This mirrors the reference's serialization
context (python/ray/_private/serialization.py contained-ObjectRef capture).
"""
from __future__ import annotations

import threading
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Set

# ---------------------------------------------------------------------------
# per-process instance counting
# ---------------------------------------------------------------------------


class RefTracker:
    """Counts live ObjectRef instances per object id in this process."""

    def __init__(self) -> None:
        # RLock: decref fires from __del__, which the GC can run inside an
        # allocation that happens while incref holds the lock.
        self._lock = threading.RLock()
        self._counts: Dict[str, int] = {}
        self._zeros: deque = deque()
        self.zero_event = threading.Event()
        from ..config import cfg

        self._debug = cfg.refcount_debug
        self._hist: Dict[str, list] = {}

    def _note(self, hex_id: str, op: str, count: int) -> None:
        import traceback

        frames = [
            f"{f.name}:{f.lineno}"
            for f in traceback.extract_stack(limit=8)[:-3]
        ]
        self._hist.setdefault(hex_id, []).append((op, count, frames))

    def history(self, hex_id: str) -> list:
        with self._lock:
            return list(self._hist.get(hex_id, ()))

    def incref(self, hex_id: str) -> None:
        with self._lock:
            self._counts[hex_id] = self._counts.get(hex_id, 0) + 1
            if self._debug:
                self._note(hex_id, "incref", self._counts[hex_id])

    def decref(self, hex_id: str) -> None:
        with self._lock:
            c = self._counts.get(hex_id, 0) - 1
            if self._debug:
                self._note(hex_id, "decref", c)
            if c > 0:
                self._counts[hex_id] = c
                return
            self._counts.pop(hex_id, None)
            self._zeros.append(hex_id)
        # debounced wake: set() on an Event takes its condition lock even
        # when already set — under a release storm that is thousands of
        # redundant lock round-trips on the hot __del__ path
        if not self.zero_event.is_set():
            self.zero_event.set()

    def count(self, hex_id: str) -> int:
        with self._lock:
            return self._counts.get(hex_id, 0)

    def all_zero(self, hex_ids) -> List[str]:
        """Subset of ``hex_ids`` with count 0, under ONE lock acquisition
        (the flusher's re-check; per-id count() calls serialize against
        the incref/decref hot path)."""
        with self._lock:
            return [h for h in hex_ids if self._counts.get(h, 0) == 0]

    def drain_zeros(self) -> List[str]:
        """Ids whose count hit zero since the last drain and is STILL zero
        (a re-incref in between cancels the release)."""
        out: List[str] = []
        with self._lock:
            self.zero_event.clear()
            seen: Set[str] = set()
            while self._zeros:
                h = self._zeros.popleft()
                if h in seen or self._counts.get(h, 0) > 0:
                    continue
                seen.add(h)
                out.append(h)
        return out

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._counts)


TRACKER = RefTracker()

# ---------------------------------------------------------------------------
# serialization / deserialization collection contexts (thread-local)
# ---------------------------------------------------------------------------

_ctx = threading.local()


def note_serialized(hex_id: str) -> None:
    s = getattr(_ctx, "ser", None)
    if s is not None:
        s.add(hex_id)


def note_deserialized(hex_id: str) -> None:
    s = getattr(_ctx, "deser", None)
    if s is not None:
        s.add(hex_id)


@contextmanager
def collect_serialized():
    """Collect the ids of every ObjectRef pickled inside the block — the
    arg set a lease submission must ask the head to pin."""
    prev = getattr(_ctx, "ser", None)
    out: Set[str] = set()
    _ctx.ser = out
    try:
        yield out
    finally:
        _ctx.ser = prev


@contextmanager
def collect_deserialized():
    """Collect the ids of every ObjectRef constructed by unpickling inside
    the block — the borrow set a getter must register with the head."""
    prev = getattr(_ctx, "deser", None)
    out: Set[str] = set()
    _ctx.deser = out
    try:
        yield out
    finally:
        _ctx.deser = prev


# ---------------------------------------------------------------------------
# per-process holder identity + release consumer
# ---------------------------------------------------------------------------

_holder_id: Optional[str] = None
_holder_lock = threading.Lock()


def get_holder_id() -> str:
    """Stable id naming this process in the head's holder table."""
    global _holder_id
    with _holder_lock:
        if _holder_id is None:
            _holder_id = f"proc-{uuid.uuid4().hex[:12]}"
        return _holder_id


def set_holder_id(holder: str) -> None:
    global _holder_id
    with _holder_lock:
        _holder_id = holder


_consumer = None
_consumer_lock = threading.Lock()


def install_consumer(consumer, replace: bool = True):
    """Install the process-wide zero-event consumer. A worker process
    installs its flusher before any nested client runtime exists; the nested
    runtime must reuse it (``replace=False`` returns the incumbent)."""
    global _consumer
    with _consumer_lock:
        if _consumer is not None and not replace:
            return _consumer
        old, _consumer = _consumer, consumer
        if old is not None and old is not consumer:
            try:
                old.stop()
            except Exception:  # noqa: BLE001
                pass
        return consumer


def current_consumer():
    return _consumer


def clear_consumer(consumer=None) -> None:
    global _consumer
    with _consumer_lock:
        if consumer is None or _consumer is consumer:
            _consumer = None


class RefFlusher:
    """Cluster-client release reporter.

    Batches 1→0 releases to the head (debounced), and sends borrow
    registrations synchronously *in order* with releases — one send lock
    serializes the wire so a stale release can never overtake a re-borrow
    (the ordering problem the reference solves with per-owner sequence
    numbers in the borrower protocol).
    """

    FLUSH_INTERVAL_S = 0.02

    def __init__(self, send: Callable[[List[str], List[str]], None], holder: str):
        self._send = send  # send(increfs, decrefs)
        self.holder = holder
        self._send_lock = threading.Lock()
        # ids this process has registered at the head (via submit/put/borrow);
        # only these owe the head a release.
        self._held_at_head: Set[str] = set()
        # releases that failed to send (transport blip): retried next flush
        self._owed: Set[str] = set()
        self._held_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ref-flusher", daemon=True
        )
        self._thread.start()

    def note_registered(self, hex_ids) -> None:
        """Ids the head already counts for us (lease returns, puts, borrow
        reports carried in task replies)."""
        with self._held_lock:
            self._held_at_head.update(hex_ids)

    def note_registered_live(self, hex_ids) -> None:
        """Like note_registered, but safe for registrations that land
        AFTER submission (e.g. at direct-call result time): an id whose
        local count already hit zero — the caller dropped the ref before
        the head-side registration existed, so its zero event was drained
        unregistered — immediately owes the head a release."""
        fire = False
        with self._held_lock:
            for h in hex_ids:
                if TRACKER.count(h) == 0:
                    self._owed.add(h)
                    fire = True
                else:
                    self._held_at_head.add(h)
        if fire:
            TRACKER.zero_event.set()

    def is_registered(self, hex_id: str) -> bool:
        with self._held_lock:
            return hex_id in self._held_at_head

    def sync_incref(self, hex_ids) -> None:
        """Register borrows NOW (while the outer object's pin still holds) —
        called by get() paths after deserializing a value containing refs."""
        fresh = []
        with self._held_lock:
            for h in hex_ids:
                if h not in self._held_at_head:
                    self._held_at_head.add(h)
                    fresh.append(h)
        if not fresh:
            return
        with self._send_lock:
            self._send(fresh, [])

    def flush(self) -> None:
        zeros = TRACKER.drain_zeros()
        with self._held_lock:
            # the zero re-check MUST happen under _held_lock: sync_incref
            # (a re-borrow) holds it while deciding an id is already
            # registered — a snapshot taken before would race it and
            # release a ref the borrower still holds
            still_zero = set(TRACKER.all_zero(zeros))
            for h in zeros:
                if h in self._held_at_head and h in still_zero:
                    self._held_at_head.discard(h)
                    self._owed.add(h)
            # a re-borrow between flushes cancels the owed release
            rel = [h for h in self._owed if h not in self._held_at_head]
            self._owed.clear()
        if not rel:
            return
        import logging

        logging.getLogger("ray_tpu_torch.refcount").debug(
            "flush releases %d ids", len(rel)
        )
        with self._send_lock:
            try:
                self._send([], rel)
            except Exception:  # noqa: BLE001 - transport blip: still owed
                with self._held_lock:
                    self._owed.update(
                        h for h in rel if h not in self._held_at_head
                    )
                TRACKER.zero_event.set()  # retry on the next flush tick

    def _loop(self) -> None:
        while not self._stop.is_set():
            TRACKER.zero_event.wait(timeout=1.0)
            if self._stop.is_set():
                return
            self._stop.wait(self.FLUSH_INTERVAL_S)  # debounce window
            self.flush()

    def stop(self, release_all: bool = False) -> None:
        self._stop.set()
        TRACKER.zero_event.set()  # unblock the loop
        if release_all:
            import logging
            import traceback

            with self._held_lock:
                rel = list(self._held_at_head | self._owed)
                self._held_at_head.clear()
                self._owed.clear()
            logging.getLogger("ray_tpu_torch.refcount").debug(
                "flusher release_all: %d ids", len(rel)
            )
            if rel:
                # BOUNDED acquire: a flush thread wedged mid-send on a dead
                # head (enqueue ack-wait) holds _send_lock forever — exit
                # must not block on it. Undelivered releases are covered by
                # the head's disconnect reap of this holder's rows.
                if not self._send_lock.acquire(timeout=5.0):
                    logging.getLogger("ray_tpu_torch.refcount").debug(
                        "flusher release_all skipped: send lock wedged"
                    )
                    return
                try:
                    self._send([], rel)
                except Exception:  # noqa: BLE001
                    pass
                finally:
                    self._send_lock.release()


class FreedLRU:
    """Bounded tombstone set guarding against a late seal resurrecting a
    freed object's directory entry (the reference keeps freed-object
    tombstones in the reference counter for the same race)."""

    def __init__(self, cap: int = 1 << 16):
        self._cap = cap
        self._set: Set[str] = set()
        self._order: deque = deque()
        self._lock = threading.Lock()

    def add(self, hex_id: str) -> None:
        with self._lock:
            if hex_id in self._set:
                return
            self._set.add(hex_id)
            self._order.append(hex_id)
            while len(self._order) > self._cap:
                self._set.discard(self._order.popleft())

    def __contains__(self, hex_id: str) -> bool:
        with self._lock:
            return hex_id in self._set

    def discard(self, hex_id: str) -> None:
        with self._lock:
            self._set.discard(hex_id)
