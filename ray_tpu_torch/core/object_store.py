"""In-memory object plane: ObjectRef + owner-tracked store.

Port of ``ray_tpu/core/object_store.py``, copied with its imports rewritten.
Large numpy arrays go to the native arena as read-only zero-copy views;
everything else, torch tensors included, stays in-process.


Single-process analog of the reference's object plane (plasma +
CoreWorkerMemoryStore, /root/reference/src/ray/core_worker/store_provider/):
objects are immutable once sealed; readers block until sealed; task errors
are stored as first-class values and re-raised on get (RayTaskError
semantics, python/ray/exceptions.py). Ownership/refcounting is tracked per
object so lineage-based recovery can be layered on (reference_counter.h:44).
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import refcount


class TaskError(Exception):
    """Wraps an exception raised in a remote task (RayTaskError analog);
    carries the remote traceback text like the reference
    (python/ray/exceptions.py RayTaskError.__str__)."""

    def __init__(
        self,
        cause: BaseException,
        task_desc: str = "",
        traceback_str: str = "",
    ):
        msg = f"task {task_desc} failed: {cause!r}"
        if traceback_str:
            msg += f"\n\nremote traceback:\n{traceback_str}"
        super().__init__(msg)
        self.cause = cause
        self.task_desc = task_desc
        self.traceback_str = traceback_str


class ObjectLostError(Exception):
    pass


class OwnerDiedError(Exception):
    """The process that owned this object (submitted its creating task or
    held its only record) died before the object could be produced.
    Objects fate-share with their owner — the reference's OwnerDiedError
    (python/ray/exceptions.py): dependents raise this typed error instead
    of hanging on an object that will never seal."""


class GetTimeoutError(TimeoutError):
    pass


class _RefWaiter:
    """One daemon thread multiplexing every pending .future()/__await__
    resolution. A thread-per-ref (or bounded-pool) design head-of-line
    blocks: N concurrently awaited unresolved refs starve every later
    await, including refs whose objects are already sealed (the reference
    resolves event-driven via _to_future, object_ref.pxi). Here the single
    waiter asks the runtime's wait primitive for ANY ready ref, resolves
    those (get_object returns promptly once sealed), and completes their
    futures — unresolved refs cost a slot in a dict, not a thread."""

    _MAX_RESOLVERS = 4

    def __init__(self) -> None:
        self._cv = threading.Condition()
        # hex -> (ref, [futures]); many futures may await one ref
        self._pending: Dict[str, tuple] = {}
        self._generation = 0  # bumped per submit: shrinks the poll window
        # READY refs resolve on up to _MAX_RESOLVERS DAEMON threads: one
        # slow large cross-node fetch must not head-of-line block
        # completion of every other already-sealed awaited ref (r4
        # advisor); only the wait_many multiplexing stays on the single
        # thread. Plain daemon threads, not a ThreadPoolExecutor — its
        # atexit join would hold interpreter shutdown for a fetch in
        # flight (up to the 5s get timeout).
        self._resolving: set = set()  # hexes being fetched right now
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ref-await"
        )
        self._thread.start()

    def submit(self, ref: "ObjectRef"):
        from concurrent.futures import Future

        fut: Future = Future()
        with self._cv:
            self._pending.setdefault(ref.hex, (ref, []))[1].append(fut)
            self._generation += 1
            self._cv.notify()
        return fut

    def _loop(self) -> None:
        import time

        window = 0.2
        last_gen = -1
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                # refs mid-fetch in the resolve pool stay OUT of the wait
                # set: wait_many reports a sealed ref ready instantly, so
                # including one being slow-fetched turns this loop into a
                # zero-delay spin (head RPC storm in cluster mode)
                refs = [
                    r
                    for h, (r, _) in self._pending.items()
                    if h not in self._resolving
                ]
                gen = self._generation
            if not refs:
                time.sleep(0.05)  # everything pending is mid-fetch
                continue
            # adaptive window: freshly submitted refs get a short wait (a
            # just-sealed object resolves fast); an unchanged pending set
            # backs the window off so one long-running awaited task does
            # not turn into a 5 Hz head poll in cluster mode
            window = 0.2 if gen != last_gen else min(2.0, window * 2)
            last_gen = gen
            rt = None
            try:
                from .runtime import get_runtime

                rt = get_runtime()
                ready, _ = rt.store.wait_many(refs, 1, window)
            except Exception:  # noqa: BLE001 - runtime mid-swap/teardown
                ready = []
                time.sleep(0.05)
            slots_full = False
            for r in ready:
                with self._cv:
                    if r.hex in self._resolving:
                        continue  # already owned by a resolver
                    if len(self._resolving) >= self._MAX_RESOLVERS:
                        slots_full = True
                        continue
                    self._resolving.add(r.hex)
                threading.Thread(
                    target=self._resolve_one,
                    args=(rt, r),
                    daemon=True,
                    name="ref-resolve",
                ).start()
            if slots_full:
                # a sealed ref is waiting on a slot: wait_many would
                # return it instantly, so pause instead of re-polling in
                # a zero-delay spin until a resolver frees up
                time.sleep(0.05)

    def _resolve_one(self, rt, r: "ObjectRef") -> None:
        try:
            try:
                value, is_err = rt.get_object(r, 5.0), False
            except GetTimeoutError:
                # sealed but the fetch is slow (large cross-node object):
                # leave it pending and retry next round rather than
                # surfacing a timeout the caller never asked for
                return
            except BaseException as exc:  # noqa: BLE001
                value, is_err = exc, True
            with self._cv:
                entry = self._pending.pop(r.hex, None)
            for fut in entry[1] if entry else ():
                try:
                    if is_err:
                        fut.set_exception(value)
                    else:
                        fut.set_result(value)
                except Exception:  # noqa: BLE001 - future cancelled
                    pass
        finally:
            with self._cv:
                self._resolving.discard(r.hex)


_RESOLVER = None
_RESOLVER_LOCK = threading.Lock()


def _resolver() -> _RefWaiter:
    global _RESOLVER
    with _RESOLVER_LOCK:
        if _RESOLVER is None:
            _RESOLVER = _RefWaiter()
        return _RESOLVER


def should_await(value) -> bool:
    """True for awaitables an executor should transparently await on a
    user function's behalf. ObjectRef is awaitable but EXEMPT: returning
    a ref hands the ref to the caller (reference semantics) — resolving
    it here would change the return shape and block the executor."""
    import inspect

    return inspect.isawaitable(value) and not isinstance(value, ObjectRef)


@dataclass(frozen=True)
class ObjectRef:
    """A future-like handle to a task output or put object.

    28-hex ids like the reference's ObjectID (src/ray/common/id.h). Every
    instance participates in distributed reference counting: construction
    (including unpickling) increfs the process tracker, ``__del__`` decrefs
    — the CPython-side hook the reference uses for RemoveLocalReference
    (python/ray/includes/object_ref.pxi). Internal bookkeeping that must
    not pin an object uses ``ObjectRef.weak``.
    """

    hex: str
    owner: str = ""  # owning "worker"/task id — lineage anchor

    def __post_init__(self) -> None:
        refcount.TRACKER.incref(self.hex)
        object.__setattr__(self, "_counted", True)
        refcount.note_deserialized(self.hex)

    def __del__(self) -> None:
        if getattr(self, "_counted", False):
            try:
                refcount.TRACKER.decref(self.hex)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def __reduce__(self):
        refcount.note_serialized(self.hex)
        return (ObjectRef, (self.hex, self.owner))

    def __await__(self):
        """``await ref`` resolves the object without blocking the event
        loop (reference: awaitable ObjectRefs, object_ref.pxi _to_future —
        asyncio actors await refs inside methods). NOTE: executors that
        auto-await user return values must exempt ObjectRef — a method
        RETURNING a ref means "hand the ref over", not "resolve it"
        (see should_await)."""
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def future(self):
        """concurrent.futures.Future view of this ref (ray parity);
        resolved event-driven by the shared multiplexing waiter — any
        number of unresolved refs can be awaited concurrently without
        head-of-line blocking."""
        return _resolver().submit(self)

    @staticmethod
    def new(owner: str = "") -> "ObjectRef":
        # buffered urandom (``_ids``): collision-proof at 14 random
        # bytes with no syscall per id; this sits on the per-call hot
        # path of every task/actor submission
        from .._ids import rand_hex

        return ObjectRef(rand_hex(14), owner)

    @staticmethod
    def weak(hex_id: str, owner: str = "") -> "ObjectRef":
        """An uncounted handle for runtime-internal plumbing (lineage
        clones, seal paths) that must not keep the object alive."""
        self = object.__new__(ObjectRef)
        object.__setattr__(self, "hex", hex_id)
        object.__setattr__(self, "owner", owner)
        object.__setattr__(self, "_counted", False)
        return self

    def __repr__(self) -> str:
        return f"ObjectRef({self.hex})"

    def __hash__(self) -> int:
        return hash(self.hex)


@dataclass
class _Entry:
    event: threading.Event = field(default_factory=threading.Event)
    value: Any = None
    is_error: bool = False
    creating_task: Optional[str] = None  # lineage: task id that creates this
    # user dropped every handle before the creating task sealed: free the
    # value the moment the seal lands instead of storing it
    unreferenced: bool = False


NATIVE_THRESHOLD_BYTES = 64 * 1024


class _NativeHandle:
    __slots__ = ("hex",)

    def __init__(self, hex_id: str):
        self.hex = hex_id


class ObjectStore:
    """Process-wide store; thread-safe.

    Large numpy arrays are spilled into the native shared-memory arena
    (``native/``, the plasma analog) and read back as zero-copy views;
    small/other objects stay in-process (the CoreWorkerMemoryStore split at
    max_direct_call_object_size, ray_config_def.h:218).
    """

    def __init__(self, native=None) -> None:
        self._lock = threading.Lock()
        self._objects: Dict[str, _Entry] = {}
        self._native = native

    def _maybe_nativize(self, hex_id: str, value: Any):
        import numpy as np

        if (
            self._native is not None
            and isinstance(value, np.ndarray)
            and value.nbytes >= NATIVE_THRESHOLD_BYTES
        ):
            try:
                self._native.put_numpy(hex_id, value)
                return _NativeHandle(hex_id)
            except (MemoryError, KeyError, OSError):
                return value
        return value

    def _denativize(self, value: Any) -> Any:
        if isinstance(value, _NativeHandle):
            return self._native.get_numpy(value.hex)
        return value

    def create(self, ref: ObjectRef, creating_task: Optional[str] = None) -> None:
        self.create_id(ref.hex, creating_task)

    def create_id(self, hex_id: str, creating_task: Optional[str] = None) -> None:
        with self._lock:
            if hex_id not in self._objects:
                self._objects[hex_id] = _Entry(creating_task=creating_task)

    def seal(self, ref: ObjectRef, value: Any, is_error: bool = False) -> bool:
        return self.seal_id(ref.hex, value, is_error)

    def seal_id(self, hex_id: str, value: Any, is_error: bool = False) -> bool:
        """Seal and return True if every handle was already dropped (the
        caller should free the object + its lineage immediately)."""
        if not is_error:
            value = self._maybe_nativize(hex_id, value)
        with self._lock:
            entry = self._objects.setdefault(hex_id, _Entry())
            entry.value = value
            entry.is_error = is_error
            entry.event.set()
            return entry.unreferenced

    def contains(self, ref: ObjectRef) -> bool:
        with self._lock:
            e = self._objects.get(ref.hex)
            return e is not None and e.event.is_set()

    def get(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        with self._lock:
            entry = self._objects.setdefault(ref.hex, _Entry())
        if not entry.event.wait(timeout):
            raise GetTimeoutError(f"get() timed out waiting for {ref}")
        if entry.is_error:
            if isinstance(entry.value, BaseException):
                raise entry.value
            raise TaskError(RuntimeError(str(entry.value)))
        return self._denativize(entry.value)

    def wait_many(
        self,
        refs: List[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
    ) -> tuple[List[ObjectRef], List[ObjectRef]]:
        """ray.wait semantics: (ready, not_ready), preserving input order."""
        deadline = None if timeout is None else (timeout + _now())
        ready: List[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            progressed = False
            still: List[ObjectRef] = []
            for r in pending:
                if self.contains(r):
                    ready.append(r)
                    progressed = True
                    if len(ready) >= num_returns:
                        still.extend(pending[pending.index(r) + 1 :])
                        break
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and _now() >= deadline:
                break
            if not progressed:
                remaining = None if deadline is None else max(0.0, deadline - _now())
                self._wait_any(pending, remaining)
        return ready, pending

    def _wait_any(self, refs: List[ObjectRef], timeout: Optional[float]) -> None:
        if not refs:
            return
        with self._lock:
            events = [self._objects.setdefault(r.hex, _Entry()).event for r in refs]
        step = 0.005
        waited = 0.0
        while True:
            for e in events:
                if e.is_set():
                    return
            if timeout is not None and waited >= timeout:
                return
            events[0].wait(step)
            waited += step
            step = min(step * 2, 0.1)

    def free(self, refs: List[ObjectRef]) -> None:
        for r in refs:
            self.free_id(r.hex)

    def free_id(self, hex_id: str) -> bool:
        """Drop a sealed entry (idempotent). An unsealed entry is flagged so
        the eventual seal frees it. Returns True if an entry was removed."""
        with self._lock:
            e = self._objects.get(hex_id)
            if e is None:
                return False
            if not e.event.is_set():
                e.unreferenced = True
                return False
            del self._objects[hex_id]
        if isinstance(e.value, _NativeHandle):
            try:
                self._native.delete(e.value.hex)
            except Exception:  # noqa: BLE001
                pass
        return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            sealed = sum(1 for e in self._objects.values() if e.event.is_set())
            return {"num_objects": len(self._objects), "num_sealed": sealed}


def _now() -> float:
    import time

    return time.monotonic()


class ObjectRefGenerator:
    """Iterator over the incrementally-produced returns of a
    ``num_returns="streaming"`` task (object_ref_generator.py /
    _raylet.pyx:246 analog).

    Each ``__next__`` blocks until the executor has sealed the next item,
    then returns its ``ObjectRef`` — normal object-plane semantics apply
    (``get``, ``wait``, passing to other tasks, GC on
    drop, recovery through the deterministic item ids on executor
    retry). A task exception surfaces as a final ref whose ``get()``
    raises (reference semantics); iteration then stops. The runtime is
    duck-typed: both the in-process runtime and the cluster client
    implement ``stream_next(task_id, index, timeout)``.
    """

    def __init__(self, task_id: str, runtime):
        self._task_id = task_id
        self._rt = runtime
        self._index = 0
        self._exhausted = False

    @property
    def task_id(self) -> str:
        return self._task_id

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> "ObjectRef":
        # iterator protocol: once exhausted, keep raising StopIteration —
        # the runtime drops the drained stream state on the None return,
        # so asking it again would block on a stream that no longer exists
        if self._exhausted:
            raise StopIteration
        ref = self._rt.stream_next(self._task_id, self._index, None)
        if ref is None:
            self._exhausted = True
            raise StopIteration
        self._index += 1
        return ref

    def next_ref(self, timeout: Optional[float] = None) -> "ObjectRef":
        """``__next__`` with a timeout (raises GetTimeoutError)."""
        if self._exhausted:
            raise StopIteration
        ref = self._rt.stream_next(self._task_id, self._index, timeout)
        if ref is None:
            self._exhausted = True
            raise StopIteration
        self._index += 1
        return ref

    def __del__(self):
        # consumer dropped the generator mid-stream: tell the runtime so
        # the executor's backpressure window opens (it would otherwise
        # wedge forever waiting for a watermark that can't move) and the
        # stream state becomes GC-eligible. Best-effort: interpreter
        # teardown may have already dismantled the runtime.
        if self._exhausted:
            return
        try:
            self._rt.stream_abandon(self._task_id)
        except Exception:  # noqa: BLE001
            pass

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ObjectRefGenerator({self._task_id}, at={self._index})"
