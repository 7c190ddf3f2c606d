"""Driver-side client runtime for a distributed ray_tpu_torch cluster.

``ray_tpu_torch.init(address="host:port")`` swaps the in-process Runtime for a
``RemoteRuntime`` — the same duck-typed surface the public API calls
(submit / put_object / get_object / wait / actors / PGs), but every
operation is an RPC to the head or a node agent. This is the moral
equivalent of the reference driver's CoreWorker connecting to the GCS
and raylets (Ray's python/ray/_private/worker.py:1406), and it
doubles as the Ray-Client analog (util/client/) since a driver can be
anywhere with connectivity to the cluster.

Port of ``ray_tpu/cluster/client.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import pickle
import sys
import threading
import time
import logging
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

logger = logging.getLogger("ray_tpu_torch.cluster.client")

from ray_tpu_torch.core.object_store import GetTimeoutError, ObjectRef
from ray_tpu_torch.core.runtime import TaskSpec

from . import serialization as wire
from .common import INLINE_OBJECT_MAX, LeaseRequest, new_id
from .rpc import (
    RpcClient,
    RpcDeadlineError,
    RpcError,
    RpcNotLeaderError,
    RpcServer,
    RpcStaleEpochError,
)

from ray_tpu_torch.util.metrics import Counter as _Counter

# lease-cached direct dispatch (owner-side): cache effectiveness + the
# spillbacks that route leased work back through head scheduling
LEASE_CACHE_HITS = _Counter(
    "task_lease_cache_hits_total",
    "Task submissions streamed straight to a cached worker lease.",
)
LEASE_CACHE_MISSES = _Counter(
    "task_lease_cache_misses_total",
    "Task submissions that took the per-task head path (no usable lease).",
)
LEASE_SPILLBACKS = _Counter(
    "task_lease_spillbacks_total",
    "Leased tasks re-routed to head scheduling (lease loss, stall "
    "recall, or worker rejection).",
)

from .common import DISPATCH_OVERHEAD_US, dispatch_sampled as _sampled

_BY_VALUE_REGISTERED: set = set()

# precomputed frame for argless submissions (see RemoteRuntime.submit)
_EMPTY_ARGS_PAYLOAD: bytes = wire.dumps(((), {}))


def _ship_module_by_value(obj: Any) -> None:
    """User code living outside site-packages (driver scripts, test files)
    isn't importable on workers — pickle its module by value (the reference
    ships the function definition in the task spec the same way)."""
    try:
        mod = inspect.getmodule(obj)
        if mod is None:
            return
        name = getattr(mod, "__name__", "")
        if name in _BY_VALUE_REGISTERED or name == "__main__":
            if name == "__main__":
                return  # cloudpickle already serializes __main__ by value
            return
        f = getattr(mod, "__file__", None)
        if not f:
            return
        if (
            "site-packages" in f
            or "/ray_tpu_torch/" in f
            or f.startswith(sys.prefix)
            or f.startswith(getattr(sys, "base_prefix", sys.prefix))
        ):
            return
        cloudpickle.register_pickle_by_value(mod)
        _BY_VALUE_REGISTERED.add(name)
    except Exception:  # noqa: BLE001 - best-effort
        pass


class _RemoteStore:
    """ray.wait support against the head's object directory."""

    def __init__(self, runtime: "RemoteRuntime"):
        self._rt = runtime

    def wait_many(
        self,
        refs: List[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """One multiplexed server-side long-poll per window: the head
        blocks until num_returns ids resolve (WaitObjectBatch num_returns),
        so readiness propagates at RPC latency without client sleep
        loops."""
        from ray_tpu_torch.config import cfg

        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        t_start = time.monotonic()
        while pending and len(ready) < num_returns:
            # direct-call results resolve locally without a head round trip
            if self._rt._push_enabled:
                still: List[ObjectRef] = []
                for r in pending:
                    if (
                        len(ready) < num_returns
                        and r.hex in self._rt._direct_results
                    ):
                        ready.append(r)
                    else:
                        still.append(r)
                pending = still
                if not pending or len(ready) >= num_returns:
                    break
                # every remaining ref is a direct call whose result will
                # arrive by push: park on the push channel's condition
                # variable instead of a head long-poll — a WaitObjectBatch
                # RPC would sit blind for its whole window while pushes
                # land locally. After the fallback grace (push may have
                # been lost) the head path takes over.
                if (
                    all(h.hex in self._rt._direct_pending for h in pending)
                    and time.monotonic() - t_start
                    < self._rt._direct_wait_fallback_s
                ):
                    wait_s = 0.2
                    if deadline is not None:
                        wait_s = min(
                            wait_s, max(0.0, deadline - time.monotonic())
                        )
                    with self._rt._direct_cv:
                        if not any(
                            h.hex in self._rt._direct_results
                            for h in pending
                        ):
                            self._rt._direct_cv.wait(timeout=wait_s)
                    if (
                        deadline is not None
                        and time.monotonic() >= deadline
                    ):
                        break
                    continue
            window = 5.0
            if deadline is not None:
                window = min(window, max(0.0, deadline - time.monotonic()))
            replies = self._rt.head.call(
                "WaitObjectBatch",
                {
                    "object_ids": [r.hex for r in pending],
                    "timeout": window,
                    "num_returns": max(1, num_returns - len(ready)),
                },
                timeout=window + 15.0,
            )
            still = []
            for r, rep in zip(pending, replies):
                if len(ready) < num_returns and rep["status"] != "pending":
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if deadline is not None and time.monotonic() >= deadline:
                break
        return ready, pending


class RemotePlacementGroup:
    """Driver-side PG handle for cluster mode (util/placement_group.py
    analog); picklable — it carries only ids/specs."""

    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def wait(self, timeout_seconds: float = 30) -> bool:
        from ray_tpu_torch.core.runtime import get_runtime

        try:
            get_runtime().wait_placement_group(self.id, timeout=timeout_seconds)
            return True
        except TimeoutError:
            return False

    def __repr__(self) -> str:
        return f"RemotePlacementGroup({self.id[:8]}, {self.strategy})"


class _DirectActorChannel:
    """Caller-side direct submission channel to one actor's worker process
    (reference: ActorTaskSubmitter's per-actor ordered send queue,
    core_worker/task_submission/actor_task_submitter.h:79). Methods are
    coalesced into DirectPushBatch RPCs straight to the worker; results
    come back via the runtime's callback server. The head never sees the
    hot path — it only receives coalesced seal reports for the object
    directory. On any transport failure the channel drains its queue back
    through the head-scheduled lease path (which owns restart semantics);
    a batch that died mid-flight may re-execute (at-least-once, like the
    reference's actor task retries).

    Scheduling: this channel is a SOURCE on the runtime's fused event
    loop — ``step`` forms whole windows and offloads the blocking RPC to
    the shared sender pool (at most one action in flight per channel, so
    per-actor ordering is preserved); there is no per-channel thread.
    Worker resolution (a rare multi-RPC dance that can legitimately
    block for a minute on a pending actor) runs on its own short-lived
    thread so it can never starve the sender pool."""

    MAX_BATCH = 256

    def __init__(self, runtime: "RemoteRuntime", actor_id: str):
        self._rt = runtime
        self.actor_id = actor_id
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._dead = False
        self._busy = False  # an action is in flight on the sender pool
        self._accepted: Dict[str, dict] = {}  # ref hex -> item (unresolved)
        self._worker: Optional[RpcClient] = None
        self._last_progress = time.monotonic()
        self._loop = runtime._hotloop
        if not self._loop.register(self):
            # loop stopped (shutdown race): this channel can never be
            # scheduled — born dead, every submit falls back to the head
            self._dead = True
            return
        threading.Thread(
            target=self._run_resolve,
            name=f"direct-resolve-{actor_id[:6]}",
            daemon=True,
        ).start()

    def submit(self, item: dict) -> None:
        with self._cv:
            if not self._dead:
                self._q.append(item)
                accepted = True
            else:
                accepted = False
        if accepted:
            self._loop.wake(self)
            return
        # fallback OUTSIDE self._cv: _fallback_submit takes the runtime's
        # _direct_cv, and result delivery holds _direct_cv while calling
        # on_result — nesting here would be an AB-BA deadlock
        self._rt._fallback_submit(item)

    def submit_many(self, items: List[dict]) -> None:
        """Window submission: one lock pass + ONE loop wake for a whole
        batch of calls (the Data executor dispatches per-actor block
        windows through here — per-item notify overhead was a measurable
        slice of the 50k-block submit path)."""
        with self._cv:
            if not self._dead:
                self._q.extend(items)
                accepted = True
            else:
                accepted = False
        if accepted:
            self._loop.wake(self)
            return
        for item in items:
            self._rt._fallback_submit(item)

    def on_result(self, ref_hex: str) -> None:
        # single GIL-atomic pop; deliberately lock-free (callers hold the
        # runtime's _direct_cv — see submit() ordering note)
        self._accepted.pop(ref_hex, None)
        self._last_progress = time.monotonic()

    def _resolve_worker(self) -> Optional[RpcClient]:
        handle = RemoteActorHandle(self._rt, self.actor_id, object)
        info = self._rt.wait_actor_alive(handle, timeout=60.0)
        agent = self._rt._agent(info.node_id, info.address)
        reply = agent.call(
            "ActorWorkerAddress", {"actor_id": self.actor_id}, timeout=10.0
        )
        return RpcClient(reply["address"])

    def _run_resolve(self) -> None:
        try:
            worker = self._resolve_worker()
        except BaseException as exc:  # noqa: BLE001
            logger.info(
                "direct channel to %s unavailable (%r); using head path",
                self.actor_id[:8],
                exc,
            )
            self._fail_over()
            return
        with self._cv:
            self._worker = worker
        self._loop.wake(self)

    def step(self, now: float) -> Optional[float]:
        """Fused-loop callback: drain the queue into one window, or probe
        a silent worker that owes results. Non-blocking by contract."""
        batch: List[dict] = []
        action = None
        with self._cv:
            if self._dead:
                return None
            if self._busy or self._worker is None:
                return None  # completion/resolve wakes us
            if self._q:
                while self._q and len(batch) < self.MAX_BATCH:
                    batch.append(self._q.popleft())
                for it in batch:
                    self._accepted[it["ref"]] = it
                action = "send"
                self._busy = True
            elif self._accepted and now - self._last_progress >= 2.0:
                # watchdog: accepted-but-unresolved items + silent worker
                # means the worker may have died mid-call
                action = "probe"
                self._busy = True
            owed = bool(self._accepted)
        if action == "send":
            self._loop.note_batch(len(batch))
            if not self._loop.offload(self, self._run_send, batch):
                # pool gone (shutdown): hand the window back to the
                # queue front so nothing is stranded as accepted-but-
                # never-sent
                with self._cv:
                    for it in reversed(batch):
                        self._accepted.pop(it["ref"], None)
                        self._q.appendleft(it)
                    self._busy = False
            return None
        if action == "probe":
            if not self._loop.offload(self, self._run_probe):
                with self._cv:
                    self._busy = False
            return None
        return now + 2.0 if owed else None

    def _run_send(self, batch: List[dict]) -> None:
        try:
            # strip client-local fields (e.g. the live arg refs kept
            # to pin args until completion) from the wire items
            wire = [
                {k: v for k, v in it.items() if not k.startswith("_")}
                for it in batch
            ]
            accepts = self._worker.call(
                "DirectPushBatch",
                {
                    "client_addr": self._rt._callback_address(),
                    "items": wire,
                },
                timeout=60.0,
            )
            done = []
            for it, status in zip(batch, accepts):
                if isinstance(status, dict):
                    # fast path: the result rode the accept reply
                    done.append(status["done"])
                elif status != "accepted":
                    with self._cv:
                        self._accepted.pop(it["ref"], None)
                    self._rt._fallback_submit(it)
            if done:
                self._rt._process_direct_results(done)
        except RpcError:
            self._fail_over(batch)
            return
        finally:
            with self._cv:
                self._busy = False

    def _run_probe(self) -> None:
        try:
            self._worker.call("Ping", timeout=5.0)
            self._last_progress = time.monotonic()
        except RpcError:
            self._fail_over()
        finally:
            with self._cv:
                self._busy = False

    def _fail_over(self, batch: Optional[list] = None) -> None:
        """Worker unreachable: everything unresolved re-routes through the
        head, which knows whether the actor is restarting or dead."""
        with self._cv:
            self._dead = True
            items = list(self._accepted.values())
            self._accepted.clear()
            queued = list(self._q)
            self._q.clear()
        self._loop.unregister(self)
        seen = set()
        for it in (batch or []) + items + queued:
            if it["ref"] not in seen:
                seen.add(it["ref"])
                self._rt._fallback_submit(it)
        self._rt._drop_direct_channel(self.actor_id, self)

    def stop(self) -> None:
        with self._cv:
            self._dead = True
        self._loop.unregister(self)


class _TaskLeaseChannel:
    """One cached worker lease + its direct submission pipe (task
    leases). The head granted this owner a pinned worker for one task
    shape; same-shape tasks stream here in ``LeaseTaskBatch`` windows
    with no head hop — the reference raylet's worker lease
    (local_lease_manager.h), held long enough to amortize placement
    across a whole stream. Execution is strictly sequential worker-side
    (the lease holds ONE task's resources); ``max_inflight`` is pipeline
    depth. Results arrive on the runtime's direct-results callback
    exactly like direct actor calls.

    Liveness by construction: a head-of-line task that blocks (e.g. a
    rendezvous peer waiting on its siblings) stops the flow of results;
    after ``task_lease_stall_s`` the channel RECALLS the worker's queued
    items and spills them — plus its local queue — back to head
    scheduling, so followers run elsewhere instead of deadlocking behind
    it. Any transport failure spills everything unresolved the same way
    (chaos-safe: worker death, node death, breaker-open all land here)."""

    MAX_BATCH = 128

    def __init__(
        self,
        runtime: "RemoteRuntime",
        manager: "_TaskLeaseManager",
        shape_key: tuple,
        grant: dict,
    ):
        self._rt = runtime
        self._mgr = manager
        self.shape_key = shape_key
        self.lease_id = grant["lease_id"]
        self.key = f"lease:{self.lease_id}"  # _direct_channels registry key
        self.node_id = grant.get("node_id")
        self.max_inflight = max(1, int(grant.get("max_inflight") or 32))
        self.ttl = max(0.5, float(grant.get("ttl_s") or 5.0))
        self.accel_env = grant.get("accel_env")
        self._stall_s = manager.stall_s
        self._worker = RpcClient(grant["worker_address"])
        self._q: deque = deque()
        self._inflight: Dict[str, dict] = {}  # ref hex -> item
        self._cv = threading.Condition()
        self.dead = False
        self._stalled = False
        self._busy = False  # an action is in flight on the sender pool
        now = time.monotonic()
        self._last_activity = now
        self._last_send = now
        self._last_result = now
        self._last_probe = now
        self._last_renew = now
        with runtime._lock:
            runtime._direct_channels[self.key] = self
        self._loop = runtime._hotloop
        if not self._loop.register(self):
            # loop stopped (shutdown race): born dead — submits spill to
            # head scheduling, the manager prunes dead channels
            self.dead = True

    # lock-free reads (GIL-atomic lens): the manager's pick runs per
    # submission and must not serialize on the channel lock
    def depth(self) -> int:
        return len(self._q) + len(self._inflight)

    def accepting(self) -> bool:
        return not self.dead and not self._stalled

    def submit(self, item: dict) -> None:
        with self._cv:
            if not self.dead:
                self._q.append(item)
                self._last_activity = time.monotonic()
                accepted = True
            else:
                accepted = False
        if accepted:
            self._loop.wake(self)
            return
        # spill OUTSIDE self._cv (lock order: runtime._direct_cv may be
        # taken inside _lease_spill; result delivery holds _direct_cv
        # while calling on_result, which takes self._cv)
        self._rt._lease_spill(item)

    def on_result(self, ref_hex: str) -> None:
        # called under the runtime's _direct_cv; self._cv nests inside it
        # everywhere (never the reverse)
        with self._cv:
            self._inflight.pop(ref_hex, None)
            now = time.monotonic()
            self._last_result = now
            self._last_activity = now
            self._stalled = False  # results flow again
            self._cv.notify()
        # a freed pipeline slot may unblock the next window
        self._loop.wake(self)

    def take_inflight(self, ref_hex: str) -> Optional[dict]:
        """Pop one in-flight item (worker handed it back never-started);
        the caller re-routes it. Frees the pipeline slot like a result."""
        with self._cv:
            item = self._inflight.pop(ref_hex, None)
            if item is not None:
                self._cv.notify()
        if item is not None:
            self._loop.wake(self)
        return item

    def cancel(self, ref_hex: str) -> bool:
        """Best-effort cancel of a not-yet-running leased task: local
        queue first, then a targeted recall of the worker's queue."""
        with self._cv:
            for it in self._q:
                if it["ref"] == ref_hex:
                    self._q.remove(it)
                    return True
            owed = ref_hex in self._inflight
        if not owed or self.dead:
            return False
        try:
            reply = self._worker.call(
                "LeaseRecall",
                {"lease_id": self.lease_id, "refs": [ref_hex]},
                timeout=10.0,
            )
        except RpcError:
            return False
        if ref_hex in (reply.get("removed") or ()):
            with self._cv:
                self._inflight.pop(ref_hex, None)
                self._cv.notify()
            return True
        return False

    def kill_running(self, ref_hex: str) -> bool:
        """Force-cancel the currently executing leased task by killing
        its worker (head-path force semantics). The worker's death trips
        the normal fail-over; the caller pre-seals the cancel so the
        death spill skips this ref."""
        if self.dead or ref_hex not in self._inflight:
            return False
        try:
            reply = self._worker.call(
                "LeaseKillRunning",
                {"lease_id": self.lease_id, "ref": ref_hex},
                timeout=10.0,
            )
        except RpcError:
            return False
        return bool(reply.get("ok"))

    def step(self, now: float) -> Optional[float]:
        """Fused-loop callback: inspect state, pick ONE action (send a
        whole window / retire / recall / probe / renew), and offload its
        blocking RPC to the sender pool. At most one action in flight per
        channel — the per-lease ordering the worker FIFO expects."""
        action = None
        batch: List[dict] = []
        with self._cv:
            if self.dead:
                return None
            if not self._busy:
                window = self.max_inflight - len(self._inflight)
                if self._q and window > 0 and not self._stalled:
                    action = "send"
                elif not self._q and not self._inflight:
                    if now - self._last_activity > self.ttl:
                        self.dead = True
                        action = "retire"
                elif self._inflight:
                    quiet = now - max(self._last_result, self._last_send)
                    # stall budget scales with the outstanding window
                    # (~stall_s of sequential execution per owed
                    # task, capped): a deep pipeline draining slowly
                    # on a loaded host is NOT a wedge — a flat
                    # threshold spilled flowing work in cascades —
                    # while a blocked head-of-line with a few
                    # followers (rendezvous peers) still recalls in
                    # a few seconds
                    budget = min(
                        self._stall_s * max(1, len(self._inflight)),
                        10.0 * self._stall_s,
                    )
                    if quiet > budget and (
                        len(self._inflight) > 1 or self._q
                    ):
                        action = "recall"
                    elif quiet > 5.0 and now - self._last_probe > 5.0:
                        action = "probe"
                if action is None and self._renew_due(now):
                    action = "renew"
                if action == "send":
                    n = min(
                        self.MAX_BATCH,
                        self.max_inflight - len(self._inflight),
                    )
                    while self._q and len(batch) < n:
                        it = self._q.popleft()
                        self._inflight[it["ref"]] = it
                        batch.append(it)
                    self._last_send = time.monotonic()
                if action is not None:
                    self._busy = True
        if action is not None:
            if batch:
                self._loop.note_batch(len(batch))
            if not self._loop.offload(self, self._run_action, action, batch):
                # sender pool gone (runtime shutdown): put the popped
                # window back at the FRONT of the queue (a stranded
                # in-flight set would hang its callers' gets), clear the
                # busy flag, and for a retire finish the bookkeeping
                # inline (no RPC involved)
                with self._cv:
                    for it in reversed(batch):
                        self._inflight.pop(it["ref"], None)
                        self._q.appendleft(it)
                    self._busy = False
                if action == "retire":
                    self._teardown(spill=False)
                    return None
        # the 0.25s tick the per-channel thread used to poll at — now one
        # timer entry on the shared loop instead of a parked thread each
        return now + 0.25

    def _run_action(self, action: str, batch: List[dict]) -> None:
        rt = self._rt
        try:
            if action == "retire":
                self._teardown(spill=False)
                return
            if action == "send":
                req = {
                    "lease_id": self.lease_id,
                    "client_addr": rt._callback_address(),
                    "items": [
                        {
                            k: v
                            for k, v in it.items()
                            if not k.startswith("_")
                        }
                        for it in batch
                    ],
                }
                if self.accel_env:
                    req["accel_env"] = self.accel_env
                t0 = time.perf_counter()
                accepts = self._worker.call(
                    "LeaseTaskBatch", req, timeout=60.0
                )
                # one observe per WINDOW: the per-item share of the send
                DISPATCH_OVERHEAD_US.observe(
                    (time.perf_counter() - t0) * 1e6 / max(1, len(batch)),
                    {"stage": "wire"},
                )
                rejected = []
                released = False
                with self._cv:
                    for it, status in zip(batch, accepts):
                        if status != "accepted":
                            self._inflight.pop(it["ref"], None)
                            rejected.append(it)
                            released = released or status == "released"
                for it in rejected:
                    rt._lease_spill(it)
                if released:
                    # "released" is lease-level, not per-item: the
                    # worker-side lease is gone for good — a channel
                    # left alive would absorb every future same-shape
                    # task into a worker-RPC-then-spill loop
                    self._drain_then_fail()
                    return
            elif action == "recall":
                # head-of-line wedged: pull queued work back and let
                # the head place it on other workers; the running
                # task keeps its slot until it completes
                reply = self._worker.call(
                    "LeaseRecall", {"lease_id": self.lease_id},
                    timeout=10.0,
                )
                recalled: List[dict] = []
                with self._cv:
                    for ref in reply.get("removed") or ():
                        it = self._inflight.pop(ref, None)
                        if it is not None:
                            recalled.append(it)
                    recalled.extend(self._q)
                    self._q.clear()
                    self._stalled = True  # until a result arrives
                for it in recalled:
                    rt._lease_spill(it)
            elif action == "probe":
                # small retry budget: a loaded-but-alive worker must
                # not fail the whole lease over one slow ping (a
                # spurious fail_over ERRORS max_retries=0 tasks)
                self._worker.call("Ping", timeout=5.0, retries=2)
                self._last_probe = time.monotonic()
            if action in ("send", "recall", "renew"):
                self._maybe_renew()
        except RpcError:
            if batch:
                # the batch whose SEND failed was (almost certainly)
                # never delivered: respill it as never-started —
                # at-least-once for mid-flight batches, the
                # _DirectActorChannel convention. Only items a
                # PREVIOUS batch delivered can be mid-execution;
                # _fail_over labels those may-have-run.
                with self._cv:
                    for it in batch:
                        self._inflight.pop(it["ref"], None)
                for it in batch:
                    rt._lease_spill(it)
            self._fail_over()
            return
        finally:
            with self._cv:
                self._busy = False

    def _renew_due(self, now: float) -> bool:
        return (
            bool(self._q or self._inflight)
            and now - self._last_renew >= self.ttl / 2.0
        )

    def _maybe_renew(self) -> None:
        now = time.monotonic()
        if now - self._last_renew >= self.ttl / 2.0:
            self._last_renew = now
            self._rt._sender.enqueue(
                "lease_renew",
                {
                    "lease_ids": [self.lease_id],
                    "client_id": self._rt.client_id,
                },
            )

    def on_killed(self) -> None:
        """We deliberately killed the leased worker (force-cancel of its
        running task). The FIFO is sequential, so nothing else was
        executing: every other unresolved item is never-started by
        construction and respills; the pre-sealed victim is skipped by
        the spill idempotence guard."""
        with self._cv:
            if self.dead:
                return
            self.dead = True
            items = list(self._inflight.values())
            self._inflight.clear()
            queued = list(self._q)
            self._q.clear()
        seen = set()
        for it in items + queued:
            if it["ref"] not in seen:
                seen.add(it["ref"])
                self._rt._lease_spill(it)
        self._teardown(spill=False)

    def _drain_then_fail(self) -> None:
        """The lease was released under us but the WORKER is alive: it
        is pushing 'spill' results for the items it never started and
        the running item's real result. Those pushes — not our local
        guess — decide never-started vs may-have-run, so wait for the
        in-flight set to drain before failing over whatever never
        arrived (a lost push, rare). Racing _fail_over immediately used
        to mislabel ~a whole window of never-started max_retries=0
        tasks as may-have-run and permanently fail them."""
        with self._cv:
            self.dead = True
            deadline = time.monotonic() + 5.0
            while self._inflight and time.monotonic() < deadline:
                self._cv.wait(timeout=0.25)
        self._fail_over()

    def _fail_over(self) -> None:
        """Worker unreachable: everything unresolved re-routes through
        head scheduling, and the lease is returned so a still-alive
        worker behind a transient partition is unpinned."""
        with self._cv:
            self.dead = True
            items = list(self._inflight.values())
            self._inflight.clear()
            queued = list(self._q)
            self._q.clear()
        seen = set()
        for it in items:
            if it["ref"] not in seen:
                seen.add(it["ref"])
                # in-flight at failure: the worker MAY have started it
                self._rt._lease_spill(it, may_have_run=True)
        for it in queued:
            if it["ref"] not in seen:
                seen.add(it["ref"])
                self._rt._lease_spill(it)
        self._teardown(spill=False)

    def _teardown(self, spill: bool) -> None:
        if spill:
            self._fail_over()
            return
        self._loop.unregister(self)
        self._mgr._drop_channel(self.shape_key, self)
        self._rt._drop_direct_channel(self.key, self)
        try:
            self._rt._sender.enqueue(
                "lease_return",
                {"lease_id": self.lease_id, "node_id": self.node_id},
            )
        except Exception:  # noqa: BLE001 - sender already stopped
            pass
        try:
            self._worker.close()
        except Exception:  # noqa: BLE001
            pass

    def stop(self) -> None:
        """Shutdown path: spill nothing (the runtime is going away), but
        hand the lease back so the worker returns to its pool."""
        with self._cv:
            if self.dead:
                return
            self.dead = True
            self._cv.notify_all()
        self._teardown(spill=False)

    def __repr__(self) -> str:  # debug surfaces
        return (
            f"_TaskLeaseChannel({self.lease_id[:8]}, depth={self.depth()})"
        )


class _TaskLeaseManager:
    """Owner-side lease cache keyed by task shape (fn hash x resource
    demand x runtime-env signature). A shape turns hot on its second
    submission (one-off tasks never pin workers); the cache then grows
    one lease at a time — up to ``task_lease_max_per_shape`` — while its
    queues run deeper than one pipeline window. Tasks that find no
    accepting lease take the per-task head path (a miss, never a
    stall)."""

    WARMUP = 2  # misses before the first grant request for a shape

    def __init__(self, runtime: "RemoteRuntime"):
        from ray_tpu_torch.config import cfg

        self._rt = runtime
        self._lock = threading.Lock()
        self._shapes: Dict[tuple, dict] = {}
        self._stopped = False
        self.max_inflight = max(1, int(cfg.task_lease_max_inflight))
        self.max_per_shape = max(1, int(cfg.task_lease_max_per_shape))
        self.stall_s = float(cfg.task_lease_stall_s)
        # local queueing beyond this overflows to the head path instead —
        # a memory/latency bound, not a throughput lever: queued items
        # cost one dict entry each, lease loss spills them, and the stall
        # recall pulls them off a wedged worker, so the bound can sit
        # well above the pipeline window (a submit burst should ride the
        # leases it warmed, not fall off them)
        self.queue_cap = 16 * self.max_inflight

    def submit(self, item: dict, shape_key: tuple) -> bool:
        """True = streamed to a cached lease (caller is done); False =
        no usable lease (caller takes the head path)."""
        rt = self._rt
        with self._lock:
            if self._stopped:
                return False
            ent = self._shapes.get(shape_key)
            if ent is None:
                if len(self._shapes) > 512:
                    # cold-shape pruning: drivers minting closures in a
                    # loop get a fresh fn_id (and shape entry) each time —
                    # entries with no lease and no grant in flight are
                    # just counters and can go
                    now = time.monotonic()
                    for k in list(self._shapes):
                        e = self._shapes[k]
                        if (
                            not e["channels"]
                            and not e["granting"]
                            and now > e["cooldown_until"]
                        ):
                            del self._shapes[k]
                ent = self._shapes[shape_key] = {
                    "channels": [],
                    "granting": 0,
                    "cooldown_until": 0.0,
                    "misses": 0,
                    "resources": dict(item["_resources"]),
                    "fn_id": item["fn_id"],
                }
            chans = [c for c in ent["channels"] if not c.dead]
            if len(chans) != len(ent["channels"]):
                ent["channels"] = chans
            chan = None
            for c in chans:
                if c.accepting() and c.depth() < self.queue_cap:
                    if chan is None or c.depth() < chan.depth():
                        chan = c
            if chan is None:
                ent["misses"] += 1
                if ent["misses"] >= self.WARMUP or chans:
                    self._maybe_grant_locked(ent, shape_key)
            elif (
                chan.depth() >= self.max_inflight
                and len(chans) + ent["granting"] < self.max_per_shape
            ):
                # one full pipeline window queued: grow while we stream
                self._maybe_grant_locked(ent, shape_key)
        if chan is None:
            rt.metrics["lease_cache_misses"] += 1
            LEASE_CACHE_MISSES.inc()
            return False
        rt.metrics["lease_cache_hits"] += 1
        LEASE_CACHE_HITS.inc()
        # pin args + register the pending ref BEFORE the channel sees the
        # item (same contract as direct actor calls: the result handler
        # releases these)
        from ray_tpu_torch.core.refcount import TRACKER

        ids = item["arg_ids"]
        with rt._direct_cv:
            for h in ids:
                TRACKER.incref(h)
            rt._direct_pending[item["ref"]] = chan.key
            if ids:
                rt._direct_arg_pins[item["ref"]] = ids
        chan.submit(item)
        return True

    def _maybe_grant_locked(self, ent: dict, shape_key: tuple) -> None:
        """Caller holds self._lock."""
        if self._stopped:
            return
        if len(ent["channels"]) + ent["granting"] >= self.max_per_shape:
            return
        if time.monotonic() < ent["cooldown_until"]:
            return
        ent["granting"] += 1
        threading.Thread(
            target=self._grant,
            args=(shape_key, dict(ent["resources"]), ent["fn_id"]),
            name="lease-grant",
            daemon=True,
        ).start()

    def _grant(self, shape_key: tuple, resources: dict, fn_id: str) -> None:
        reply = None
        try:
            reply = self._rt.head.call(
                "GrantTaskLease",
                {
                    "resources": resources,
                    "fn_id": fn_id,
                    "client_id": self._rt.client_id,
                    "timeout": 10.0,
                },
                timeout=40.0,
                epoch=self._rt._cluster_epoch,
            )
        except RpcStaleEpochError:
            # fenced by a rebuilt head: resync (fresh hello) and let the
            # cooldown retry the grant with the new epoch
            try:
                self._rt._hello()
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001 - head unreachable: cooldown
            pass
        dangling = None  # granted after the runtime stopped: hand it back
        with self._lock:
            ent = self._shapes.get(shape_key)
            if ent is not None:
                ent["granting"] -= 1
            if self._stopped and reply and reply.get("granted"):
                dangling = reply
                reply = None
            if ent is None:
                pass
            elif reply and reply.get("granted"):
                chan = _TaskLeaseChannel(self._rt, self, shape_key, reply)
                ent["channels"].append(chan)
            else:
                ent["cooldown_until"] = time.monotonic() + 2.0
        if dangling is not None:
            try:
                self._rt._sender.enqueue(
                    "lease_return",
                    {
                        "lease_id": dangling["lease_id"],
                        "node_id": dangling.get("node_id"),
                    },
                )
            except Exception:  # noqa: BLE001 - sender stopped too
                pass

    def _drop_channel(self, shape_key: tuple, chan) -> None:
        with self._lock:
            ent = self._shapes.get(shape_key)
            if ent is not None and chan in ent["channels"]:
                ent["channels"].remove(chan)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True


class _ResultSink:
    """DirectResults delivery fused onto the runtime's event loop.

    RPC handler threads enqueue whole windows here and return
    immediately; the loop's ``step`` drains EVERY queued window in one
    pass and offloads the merged batch to the sender pool — one wake per
    window burst instead of one lock hop per push (the third thread
    family the fused loop absorbs, next to lease windows and direct
    pushes). Processing is offloaded, never run on the loop thread:
    ``_process_direct_results`` can owe a blocking head RPC (owner-held
    upload on eviction), and the loop's contract is non-blocking steps.
    At most one processing action is in flight, so batches stay FIFO
    (a worker's pushes must not reorder)."""

    def __init__(self, rt: "RemoteRuntime"):
        from concurrent.futures import ThreadPoolExecutor

        self._rt = rt
        self._batches: deque = deque()
        self._busy = False
        self._lock = threading.Lock()
        # DEDICATED delivery thread: result processing must never queue
        # behind 60s-blocking sends on the shared sender pool — during a
        # mass lease-revoke storm a starved drain would let
        # _drain_then_fail time out and mislabel never-started
        # max_retries=0 windows as may-have-run
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hotpath-results"
        )
        rt._hotloop.register(self)

    def push(self, results: List[dict]) -> None:
        self._batches.append(results)
        if self._rt._hotloop.wake(self):
            return
        # loop stopped (shutdown): drain inline so late pushes still land
        self._drain_inline()

    def _drain_inline(self) -> None:
        while True:
            with self._lock:
                if self._busy or not self._batches:
                    return
                batches: List[list] = []
                while self._batches:
                    batches.append(self._batches.popleft())
                self._busy = True
            self._run(batches)

    def step(self, now: float) -> None:
        with self._lock:
            if self._busy or not self._batches:
                return None
            batches: List[list] = []
            while self._batches:
                batches.append(self._batches.popleft())
            self._busy = True
        try:
            self._exec.submit(self._run_and_rewake, batches)
        except RuntimeError:  # executor closed (shutdown): inline
            self._run(batches)
        return None

    def _run_and_rewake(self, batches: List[list]) -> None:
        self._run(batches)
        # windows pushed while we were processing re-enter via the loop
        self._rt._hotloop.wake(self)

    def close(self) -> None:
        self._exec.shutdown(wait=False)

    def _run(self, batches: List[list]) -> None:
        try:
            merged: List[dict] = []
            for b in batches:
                merged.extend(b)
            if merged:
                self._rt._hotloop.note_batch(len(merged))
                self._rt._process_direct_results(merged)
        finally:
            with self._lock:
                self._busy = False
        # a push that raced in while we were busy AND the loop died has
        # nobody left to wake us: sweep it up before returning
        if self._batches and not self._rt._hotloop.alive():
            self._drain_inline()


class RemoteActorHandle:
    def __init__(self, runtime: "RemoteRuntime", actor_id: str, cls: type):
        self._runtime = runtime
        self._actor_id = actor_id
        self._cls = cls

    def __getattr__(self, name: str):
        # "__call__" is a legitimate remote method (serve deployments
        # dispatch it); every other underscore name stays an attribute
        # error so pickling/introspection behave
        if name.startswith("_") and name != "__call__":
            raise AttributeError(name)
        return _RemoteMethod(self._runtime, self._actor_id, name)

    def __reduce__(self):
        return (_rebuild_actor_handle, (self._actor_id, self._cls))


def _rebuild_actor_handle(actor_id: str, cls: type):
    from ray_tpu_torch.core.runtime import get_runtime

    return RemoteActorHandle(get_runtime(), actor_id, cls)


class _RemoteMethod:
    def __init__(
        self,
        runtime: "RemoteRuntime",
        actor_id: str,
        method: str,
        num_returns=1,
    ):
        self._runtime = runtime
        self._actor_id = actor_id
        self._method = method
        self._num_returns = num_returns

    def options(self, num_returns=None, **_ignored) -> "_RemoteMethod":
        return _RemoteMethod(
            self._runtime,
            self._actor_id,
            self._method,
            num_returns or self._num_returns,
        )

    def remote(self, *args, **kwargs):
        if self._num_returns == "streaming":
            return self._runtime.submit_actor_method_streaming(
                self._actor_id, self._method, args, kwargs
            )
        return self._runtime.submit_actor_method(
            self._actor_id, self._method, args, kwargs
        )


class _PipelinedSender:
    """Client→head submission pipeline (the reference's task-submission
    pipelining, core_worker/task_submission/normal_task_submitter.h): lease
    submissions and refcount updates ride ONE ordered queue, coalesced into
    ``ClientBatch`` RPCs. An idle sender ships immediately (no added
    latency); under load everything queued while the previous RPC was in
    flight merges into one message. Ordering between a submission that
    registers return-id holders and a later release of those ids is
    preserved by construction."""

    MAX_BATCH = 512

    def __init__(self, client: RpcClient, epoch_fn=None, on_stale=None):
        self._client = client
        # epoch-fenced control plane: epoch_fn supplies the stamp for
        # every ClientBatch; on_stale runs the owner-side resync (a fresh
        # ClientHello) when a rebuilt head rejects our stamp
        self._epoch_fn = epoch_fn
        self._on_stale = on_stale
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._enqueued = 0
        self._acked = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="lease-pipeline", daemon=True
        )
        self._thread.start()

    def enqueue(
        self,
        kind: str,
        payload: Any,
        wait: bool = False,
        wait_timeout: Optional[float] = None,
    ) -> None:
        """Queue one control item. ``wait=True`` blocks until the head has
        processed it; ``wait_timeout`` bounds that wait — on expiry an
        RpcError raises (the item STAYS queued and delivers when the head
        returns; only this caller's synchronous view gives up)."""
        with self._cv:
            if self._stop:
                return
            self._q.append((kind, payload))
            self._enqueued += 1
            ticket = self._enqueued
            self._cv.notify_all()
        if wait:
            deadline = (
                None
                if wait_timeout is None
                else time.monotonic() + wait_timeout
            )
            with self._cv:
                while self._acked < ticket and not self._stop:
                    if (
                        deadline is not None
                        and time.monotonic() >= deadline
                    ):
                        raise RpcError(
                            f"head unreachable: {kind} not acknowledged "
                            f"within {wait_timeout}s (still queued)"
                        )
                    self._cv.wait(timeout=0.5)

    def enqueue_many(self, kind: str, payloads: List[Any]) -> None:
        """Queue a window of same-kind control items under one lock pass
        (ordered with everything else on the pipeline)."""
        with self._cv:
            if self._stop:
                return
            for p in payloads:
                self._q.append((kind, p))
            self._enqueued += len(payloads)
            self._cv.notify_all()

    def rebind(self, client: RpcClient) -> None:
        """Swap the underlying channel (head failover): the loop reads
        ``self._client`` per attempt, so queued items redeliver to the
        new leader in order."""
        with self._cv:
            self._client = client
            self._cv.notify_all()

    def try_enqueue_once(self, kind: str, payload: Any, prev_ticket: int) -> int:
        """Queue one item unless the previous such item is still
        undelivered (heartbeats must not pile up behind a head outage).
        Returns the new ticket, or ``prev_ticket`` when skipped."""
        with self._cv:
            if self._stop or prev_ticket > self._acked:
                return prev_ticket
            self._q.append((kind, payload))
            self._enqueued += 1
            self._cv.notify_all()
            return self._enqueued

    def _loop(self) -> None:
        import logging

        log = logging.getLogger("ray_tpu_torch.cluster.client")
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.5)
                if not self._q:
                    if self._stop:
                        return
                    continue
                n = min(len(self._q), self.MAX_BATCH)
                batch = [self._q.popleft() for _ in range(n)]
            delivered = False
            attempts = 0
            while not delivered:
                try:
                    attempts += 1
                    if attempts == 2 or attempts % 60 == 0:
                        log.warning(
                            "ClientBatch re-send #%d (%d items)",
                            attempts,
                            len(batch),
                        )
                    self._client.call(
                        "ClientBatch",
                        batch,
                        timeout=60.0,
                        retries=8,
                        retry_interval=0.25,
                        epoch=(
                            self._epoch_fn() if self._epoch_fn else None
                        ),
                    )
                    delivered = True
                except (RpcStaleEpochError, RpcNotLeaderError):
                    # the head restarted (stale epoch) or fenced itself
                    # behind a promoted standby (not leader): run the
                    # owner resync — a fresh ClientHello adopts the new
                    # epoch and, on failover, rebinds this sender to the
                    # new leader — then redeliver this same batch; order
                    # preserved, nothing dropped
                    import sys

                    if sys.is_finalizing():
                        return
                    log.warning(
                        "head epoch advanced; re-helloing before re-send"
                    )
                    if self._on_stale is not None:
                        try:
                            self._on_stale()
                        except Exception:  # noqa: BLE001 - retried below
                            pass
                    with self._cv:
                        if self._stop:
                            return
                        self._cv.wait(timeout=0.2)
                except (RpcError, RuntimeError):
                    # a dropped lease would strand its caller's get()
                    # forever and a dropped release leaks the object —
                    # keep the batch and retry until the head comes back
                    # (or this runtime shuts down). RuntimeError: the
                    # channel's executor closed under us (shutdown race) —
                    # same stop checks apply, never an unhandled thread
                    # exception.
                    import sys

                    if sys.is_finalizing():
                        return  # interpreter exit: nobody to deliver for
                    if attempts <= 2 or attempts % 60 == 0:
                        log.warning(
                            "head unreachable; retrying %d control items",
                            len(batch),
                        )
                    # event-driven pause (the long-poll pattern the rest
                    # of the client uses, e.g. wait_many): park on the
                    # queue's condition variable so a stop() — or new
                    # work signalling the head may be back — wakes the
                    # retry immediately instead of sleeping blind.
                    with self._cv:
                        if self._stop:
                            return
                        self._cv.wait(timeout=0.5)
            with self._cv:
                self._acked += len(batch)
                self._cv.notify_all()

    def drain(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        with self._cv:
            target = self._enqueued
            while self._acked < target and time.monotonic() < deadline:
                self._cv.wait(timeout=0.2)

    def stop(self) -> None:
        self.drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        # join BEFORE the caller closes the rpc channel: an in-flight send
        # racing the channel's executor shutdown was the
        # cannot-schedule-new-futures stray-thread exception the full
        # suite used to end with
        self._thread.join(timeout=5.0)


class RemoteRuntime:
    """Duck-typed Runtime whose backend is a live cluster."""

    is_remote = True

    def __init__(self, address: str, runtime_env: Optional[dict] = None):
        # ``address`` may be a comma list (primary + warm standbys); the
        # candidate walk also folds in RAY_TPU_HEAD_STANDBYS. With more
        # than one candidate, connect to whichever currently leads.
        from .rpc import head_candidates, probe_leader

        self._head_candidates = head_candidates(address)
        if len(self._head_candidates) > 1:
            found = probe_leader(self._head_candidates, timeout=2.0)
            if found is not None:
                address = found[0]
            else:
                address = self._head_candidates[0]
        self.address = address
        self.head = RpcClient(address)
        self.head.call("Ping", timeout=10.0, retries=20, retry_interval=0.25)
        self.runtime_env = runtime_env
        self._agents: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()
        self.store = _RemoteStore(self)
        self.metrics: Dict[str, int] = {}
        # distributed refcounting: this process's holder identity + release
        # reporter. Inside a cluster worker the worker's flusher (which
        # routes via its agent) is already installed and is reused.
        from ray_tpu_torch.core import refcount

        self.client_id = refcount.get_holder_id()
        # peer-leased data links for big-object pulls (transport.py),
        # lazily built on the first located fetch
        self._peer_links = None
        # direct actor calls: per-actor submission channels straight to the
        # hosting worker; results arrive on a lazily-started callback
        # server. RAY_TPU_DIRECT_ACTOR_CALLS=0 forces everything through
        # the head-scheduled lease path.
        from ray_tpu_torch.config import cfg

        self._direct_enabled = cfg.direct_actor_calls
        # hot-path cfg snapshot: these flags are read per submission /
        # per awaited ref, and cfg reads consult os.environ live. Set the
        # env before connect() to change them for a runtime.
        self._trace_autostart = cfg.trace_tasks
        self._direct_wait_fallback_s = cfg.direct_wait_fallback_s
        # lease-cached direct task dispatch (RAY_TPU_TASK_LEASES=0 kills
        # it: every task rides the per-task head path). Leased-task
        # results arrive on the same push channel as direct actor calls,
        # so the result-cache paths check the union flag.
        self._lease_enabled = cfg.task_leases
        self._push_enabled = self._direct_enabled or self._lease_enabled
        # the fused submit/result event loop: lease channels, direct
        # actor channels, and result delivery are all sources on this ONE
        # loop (its thread starts lazily on first registration)
        from .event_loop import FusedEventLoop

        self._hotloop = FusedEventLoop(
            name="hotpath", senders=int(cfg.hotpath_senders)
        )
        self._result_sink = _ResultSink(self)
        self._lease_mgr = (
            _TaskLeaseManager(self) if self._lease_enabled else None
        )
        # shape-key env signature for the runtime-level env, computed
        # once (per-task envs are rare; the runtime env applies to every
        # submission and must not be re-serialized per task)
        import json as _json

        self._base_env_sig = (
            _json.dumps(self.runtime_env, sort_keys=True, default=str)
            if self.runtime_env
            else None
        )
        self.metrics.update(
            lease_cache_hits=0,
            lease_cache_misses=0,
            lease_spillbacks=0,
            lineage_resubmits=0,
        )
        # owner-side lineage (ownership-model reconstruction): leased
        # direct-dispatch tasks never register a spec with the head, so
        # the owner retains each task's submit item keyed by return ref
        # and resubmits through head scheduling when the head seals the
        # object lost-without-lineage. Byte-bounded LRU — an evicted
        # object's loss is permanent.
        from collections import OrderedDict as _OrderedDict

        self._lineage_lock = threading.Lock()
        self._lineage: "_OrderedDict[str, dict]" = _OrderedDict()
        self._lineage_bytes = 0
        # one cloudpickle of each task function per function OBJECT (weak:
        # dead lambdas drop their blobs); see _serialize_fn
        import weakref

        self._fn_blobs: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        self._direct_channels: Dict[str, _DirectActorChannel] = {}
        self._direct_results: Dict[str, tuple] = {}  # hex -> (kind, payload)
        # FIFO bound on the local result cache: fire-and-forget callers
        # never get() their refs, and every result also reached the head's
        # directory — evicted entries just resolve through the head
        self._direct_results_order: deque = deque()
        self._direct_results_cap = cfg.direct_results_cap
        self._direct_pending: Dict[str, str] = {}  # hex -> actor_id
        # streaming generators: task_id -> (base_index, [item ids], done)
        self._stream_cache: Dict[str, tuple] = {}
        self._direct_arg_pins: Dict[str, List[str]] = {}  # hex -> arg ids
        # owner-held results (cfg.direct_deferred_seals): hex -> contained
        # ids; the head learns about these objects only on share/evict
        self._deferred_seals: Dict[str, List[str]] = {}
        # refs shared into another submission BEFORE their direct result
        # arrived: the arrival handler uploads these instead of deferring
        self._shared_pending: set = set()
        self._direct_cv = threading.Condition()
        self._callback_server: Optional[RpcServer] = None
        # --- owner session + epoch-fenced control plane -----------------
        # a DRIVER process (one installing its own flusher below) holds a
        # session lease with the head: it heartbeats on the pipelined
        # ClientBatch, and a crashed driver is reaped (actors killed,
        # leases revoked, unproduced objects failed with OwnerDiedError).
        # Worker-embedded runtimes reuse the worker's identity and fate-
        # share through the agent's worker-death reports instead.
        self._stop_event = threading.Event()
        self._shutdown_done = False
        self._beat_ticket = 0
        self._cluster_epoch: Optional[int] = None
        self._owner_ttl_s = float(cfg.owner_lease_ttl_s)
        self._owner_session = bool(cfg.owner_liveness) and not isinstance(
            refcount.current_consumer(), refcount.RefFlusher
        )
        self._hello()
        # dedicated channel for the pipeline: its traffic during a head
        # outage must not push the main channel into gRPC reconnect backoff
        self._pipe_chan = RpcClient(address)
        self._sender = _PipelinedSender(
            self._pipe_chan,
            epoch_fn=lambda: self._cluster_epoch,
            on_stale=self._hello,
        )
        incumbent = refcount.current_consumer()
        if isinstance(incumbent, refcount.RefFlusher):
            self._flusher = incumbent
            self._owns_flusher = False
        else:
            # _ref_wait_timeout bounds the synchronous ack wait on ref
            # updates: None (wait out the head) in steady state; shutdown
            # sets it so the exit path can NEVER hang on a wedged
            # pipeline (the item stays queued either way, and the head's
            # disconnect reap drops our holder rows regardless)
            self._ref_wait_timeout: Optional[float] = None
            self._flusher = refcount.RefFlusher(
                lambda inc, dec: self._sender.enqueue(
                    "ref",
                    {"holder": self.client_id, "increfs": inc, "decrefs": dec},
                    wait=True,
                    wait_timeout=self._ref_wait_timeout,
                ),
                holder=self.client_id,
            )
            refcount.install_consumer(self._flusher)
            self._owns_flusher = True
        if self._owner_session:
            threading.Thread(
                target=self._owner_beat_loop, name="owner-beat", daemon=True
            ).start()
        # best-effort bounded shutdown at interpreter exit: a driver that
        # never calls shutdown()/exits a with-block still sends its
        # DisconnectClient instead of falling through to crash detection
        import atexit
        import weakref

        ref = weakref.ref(self)

        def _exit_hook(_ref=ref):
            rt = _ref()
            if rt is not None:
                try:
                    rt.shutdown()
                except Exception:  # noqa: BLE001 - exit path
                    pass

        self._atexit_hook = _exit_hook
        atexit.register(_exit_hook)

    def __enter__(self) -> "RemoteRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _hello(self) -> None:
        """ClientHello handshake: adopt the cluster epoch this runtime
        stamps its control stream with, and (driver processes) register
        the owner session lease. Re-run whenever a rebuilt head rejects
        our stamp as stale — re-hello IS the owner resync protocol. A
        NotLeader reply (the head fenced itself after a standby
        promoted elsewhere) walks the candidate list to the leader and
        re-hellos there."""
        try:
            reply = self.head.call(
                "ClientHello",
                {"client_id": self.client_id, "session": self._owner_session},
                timeout=10.0,
                retries=3,
                retry_interval=0.2,
            )
        except RpcNotLeaderError as exc:
            if not self._failover_head(exc.leader_hint):
                return
            try:
                reply = self.head.call(
                    "ClientHello",
                    {
                        "client_id": self.client_id,
                        "session": self._owner_session,
                    },
                    timeout=10.0,
                    retries=3,
                    retry_interval=0.2,
                )
            except Exception:  # noqa: BLE001 - next resync retries
                return
        except Exception:  # noqa: BLE001 - unstamped traffic still flows
            return
        self._cluster_epoch = reply.get("epoch")
        ttl = reply.get("owner_ttl_s")
        if ttl:
            self._owner_ttl_s = float(ttl)
        if not reply.get("owner_liveness", True):
            self._owner_session = False

    def _failover_head(self, hint: str = "") -> bool:
        """Walk the head-candidate list (rpc.resolve_leader) to the
        current leader; swap the control channels there. The pipelined
        sender rebinds in place — queued control items redeliver to the
        new leader in order, nothing dropped."""
        from .rpc import resolve_leader

        addr = resolve_leader(
            self.address, hint, ",".join(self._head_candidates)
        )
        if addr is None:
            return False
        if addr == self.address:
            return True
        import logging

        logging.getLogger("ray_tpu_torch.cluster.client").warning(
            "head leadership moved %s -> %s; re-pointing", self.address, addr
        )
        old_head, old_pipe = self.head, getattr(self, "_pipe_chan", None)
        self.address = addr
        self.head = RpcClient(addr)
        if old_pipe is not None:
            self._pipe_chan = RpcClient(addr)
            self._sender.rebind(self._pipe_chan)
        for chan in (old_head, old_pipe):
            if chan is not None:
                try:
                    chan.close()
                except Exception:  # noqa: BLE001
                    pass
        return True

    def _owner_beat_loop(self) -> None:
        """Heartbeat the owner session at half the lease TTL, riding the
        ordered ClientBatch pipeline. At most one beat is ever queued: a
        head outage must not pile beats behind the retry loop (delivery
        of anything on the pipeline proves liveness just as well)."""
        period = max(0.25, self._owner_ttl_s / 2.0)
        while not self._stop_event.wait(period):
            sender = self._sender
            self._beat_ticket = sender.try_enqueue_once(
                "owner_beat",
                {"client_id": self.client_id},
                self._beat_ticket,
            )

    def _read(
        self,
        method: str,
        payload: Any = None,
        timeout: float = 30.0,
        deadline_s: Optional[float] = None,
    ):
        """Idempotent head reads retry through transport blips — a client
        rides through a head restart the way the reference's GCS client
        does (gcs_rpc_client.h retry budgets). ``deadline_s`` propagates a
        caller's overall budget: the retry loop never outlives it."""
        return self.head.call(
            method,
            payload,
            timeout=timeout,
            retries=8,
            retry_interval=0.25,
            deadline_s=deadline_s,
        )

    # ------------------------------------------------------------------
    # tasks
    # ------------------------------------------------------------------
    def _serialize_fn(self, fn) -> tuple:
        """Pickle a task function once per function object.

        Returns ``(blob, fn_id, fn_arg_ids, cacheable)``. Cached only when
        serialization collected zero ObjectRefs — a closure over a ref
        keeps per-call (de)serialization so ref lifetimes stay
        per-execution. Matches the reference's one-time function export
        (function_manager) vs. our previous per-call re-pickle: closure
        CELL mutations after first submission are not re-shipped, same as
        the reference."""
        from ray_tpu_torch.core.refcount import collect_serialized

        try:
            ent = self._fn_blobs.get(fn)
        except TypeError:
            ent = None  # unhashable/unweakrefable callable
        if ent is not None:
            return ent
        _ship_module_by_value(fn)
        with collect_serialized() as ids:
            blob = cloudpickle.dumps(fn)
        fn_id = hashlib.blake2b(blob, digest_size=8).hexdigest()
        ent = (blob, fn_id, frozenset(ids), not ids)
        if not ids:
            try:
                self._fn_blobs[fn] = ent
            except TypeError:
                pass
        return ent

    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        from ray_tpu_torch.core.refcount import collect_serialized

        fn_blob, fn_id, fn_arg_ids, fn_cacheable = self._serialize_fn(
            spec.func
        )
        sample = _sampled()
        if spec.args or spec.kwargs:
            t0 = time.perf_counter() if sample else 0.0
            with collect_serialized() as arg_ids:
                payload = wire.dumps((spec.args, spec.kwargs))
            if sample:
                DISPATCH_OVERHEAD_US.observe(
                    (time.perf_counter() - t0) * 1e6, {"stage": "serialize"}
                )
        else:
            # hot-path constant: argless tasks (control probes, noop-style
            # fan-out) share ONE precomputed payload — no per-call pickle,
            # no ref-collection context
            payload = _EMPTY_ARGS_PAYLOAD
            arg_ids = set()
        if fn_arg_ids:
            arg_ids |= fn_arg_ids
        deps = [a.hex for a in spec.args if isinstance(a, ObjectRef)]
        deps += [
            v.hex for v in spec.kwargs.values() if isinstance(v, ObjectRef)
        ]
        self._flush_deferred_seals(arg_ids)
        from ray_tpu_torch.util import tracing

        trace = spec.trace or tracing.child_context(
            spec.task_id, self._trace_autostart
        )
        merged_env = (
            {**(self.runtime_env or {}), **spec.runtime_env}
            if spec.runtime_env
            else self.runtime_env
        )
        if self._lease_mgr is not None and self._leasable(spec, merged_env):
            item = {
                "task_id": spec.task_id,
                "ref": spec.returns[0].hex,
                "payload": payload,
                "arg_ids": sorted(arg_ids),
                "name": spec.name,
                "client_id": self.client_id,
                "trace": trace,
                "fn_blob": fn_blob,
                "fn_id": fn_id,
                "fn_cache": fn_cacheable,
                "runtime_env": merged_env,
                # client-local fields (stripped from the wire): enough to
                # rebuild a head-path LeaseRequest on spillback
                "_resources": dict(spec.resources),
                "_max_retries": spec.max_retries,
            }
            if spec.runtime_env:
                import json

                env_sig = json.dumps(
                    merged_env, sort_keys=True, default=str
                )
            else:
                env_sig = self._base_env_sig
            shape_key = (
                fn_id,
                tuple(sorted(spec.resources.items())),
                env_sig,
            )
            t0 = time.perf_counter() if sample else 0.0
            streamed = self._lease_mgr.submit(item, shape_key)
            if sample:
                DISPATCH_OVERHEAD_US.observe(
                    (time.perf_counter() - t0) * 1e6, {"stage": "enqueue"}
                )
            if streamed:
                # the head never sees this task's spec — WE are its
                # lineage (resubmitted on loss via _maybe_resubmit_lost).
                # max_retries=0 items never resubmit, so retaining their
                # lineage is pure per-task overhead: skip it.
                if spec.max_retries > 0:
                    self._note_lineage(item)
                return spec.returns
        lease = LeaseRequest(
            task_id=spec.task_id,
            name=spec.name,
            payload=payload,
            return_ids=[r.hex for r in spec.returns],
            resources=spec.resources,
            kind="task",
            max_retries=spec.max_retries,
            retry_exceptions=spec.retry_exceptions,
            strategy=spec.strategy,
            runtime_env=merged_env,
            arg_ids=sorted(arg_ids),
            deps=deps,
            client_id=self.client_id,
            trace=trace,
            fn_blob=fn_blob,
            fn_id=fn_id,
            fn_cache=fn_cacheable,
            streaming=bool(getattr(spec, "streaming", False)),
        )
        self._sender.enqueue("lease", lease)
        self._flusher.note_registered(lease.return_ids)
        return spec.returns

    @staticmethod
    def _leasable(spec: TaskSpec, merged_env: Optional[dict]) -> bool:
        """A task qualifies for lease-cached direct dispatch when nothing
        about it needs head-side routing or bookkeeping: no placement
        constraint, no top-level ObjectRef args (dependency-aware
        dispatch is the agent's job), a single return, no streaming, no
        exception-retry budget (worker/node-death retries are covered by
        spillback), and no pip/uv/conda env (those need dedicated
        interpreter workers)."""
        if spec.strategy is not None or getattr(spec, "streaming", False):
            return False
        if len(spec.returns) != 1 or spec.retry_exceptions:
            return False
        if any(isinstance(a, ObjectRef) for a in spec.args) or any(
            isinstance(v, ObjectRef) for v in spec.kwargs.values()
        ):
            return False
        if merged_env:
            from .pip_env import has_env

            if has_env(merged_env):
                return False
        return True

    def stream_next(
        self, task_id: str, index: int, timeout: Optional[float]
    ) -> Optional[ObjectRef]:
        """Long-poll the head for item ``index`` of a streaming-generator
        task (ObjectRefGenerator backend). None = stream ended before it.
        The ``after`` watermark doubles as the consumption ack that frees
        the executor's backpressure window."""
        cached = self._stream_cache.get(task_id)
        if cached is not None:
            base, ids, done = cached
            k = index - base
            if 0 <= k < len(ids):
                return ObjectRef(ids[k], owner=self.client_id)
            if done and k >= len(ids):
                self._stream_cache.pop(task_id, None)
                return None
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            wait_s = 2.0
            if deadline is not None:
                wait_s = min(wait_s, deadline - time.monotonic())
                if wait_s <= 0:
                    raise GetTimeoutError(
                        f"stream {task_id} item {index} not ready"
                    )
            reply = self._read(
                "WaitStream",
                {
                    "task_id": task_id,
                    "after": index,
                    "timeout": wait_s,
                    "holder": self.client_id,
                },
                timeout=wait_s + 15.0,
            )
            items = reply.get("items") or []
            done = bool(reply.get("done"))
            if items:
                # one long-poll returns every ready item; serve the rest
                # of the burst from this cache instead of an RPC per item.
                # Bounded: abandoned generators clear their entry via
                # stream_abandon; the cap catches pathological churn.
                if len(self._stream_cache) > 256:
                    self._stream_cache.pop(
                        next(iter(self._stream_cache)), None
                    )
                self._stream_cache[task_id] = (index, items, done)
                return ObjectRef(items[0], owner=self.client_id)
            if done:
                self._stream_cache.pop(task_id, None)
                return None

    def stream_abandon(self, task_id: str) -> None:
        """Best-effort consumer-drop notice (ObjectRefGenerator.__del__)."""
        self._stream_cache.pop(task_id, None)
        try:
            self.head.call("StreamAbandon", {"task_id": task_id}, timeout=5.0)
        except RpcError:
            pass

    def submit_actor_method(
        self, actor_id: str, method: str, args: tuple, kwargs: dict
    ) -> ObjectRef:
        # a batch of one: submit_actor_method_batch owns the single
        # implementation of item/lease construction and arg pinning
        return self.submit_actor_method_batch(
            actor_id, method, [(args, kwargs)]
        )[0]

    def submit_actor_method_batch(
        self, actor_id: str, method: str, calls: List[tuple]
    ) -> List[ObjectRef]:
        """Submit a WINDOW of calls to one actor in one pass: one
        pin/bookkeeping lock acquisition and one channel (or pipeline)
        wakeup for the whole batch — the ordered batch path given to
        actor creations/kills, extended to actor-task submission. The
        Data executor's actor pools dispatch per-actor block windows
        through this instead of per-block ``submit_actor_method``.

        ``calls`` is a sequence of ``(args, kwargs)``; returns one
        ObjectRef per call, in order.
        """
        from ray_tpu_torch.core.refcount import TRACKER, collect_serialized

        from ray_tpu_torch.util import tracing

        refs: List[ObjectRef] = []
        prepared: List[tuple] = []  # (ref, ids, item) | (ref, lease)
        for args, kwargs in calls:
            ref = ObjectRef.new(owner=actor_id)
            with collect_serialized() as arg_ids:
                payload = wire.dumps((method, args, kwargs))
            if arg_ids:
                self._flush_deferred_seals(arg_ids)
            ids = sorted(arg_ids)
            tid = new_id()
            refs.append(ref)
            if self._direct_enabled:
                item = {
                    "task_id": tid,
                    "actor_id": actor_id,
                    "ref": ref.hex,
                    "payload": payload,
                    "client_id": self.client_id,
                    "name": f"{actor_id[:8]}.{method}",
                    "arg_ids": ids,
                    "trace": tracing.child_context(
                        tid, self._trace_autostart
                    ),
                }
                prepared.append((ref, ids, item))
            else:
                prepared.append(
                    (
                        ref,
                        LeaseRequest(
                            task_id=tid,
                            name=f"{actor_id[:8]}.{method}",
                            payload=payload,
                            return_ids=[ref.hex],
                            resources={},
                            kind="actor_method",
                            actor_id=actor_id,
                            max_retries=0,
                            arg_ids=ids,
                            client_id=self.client_id,
                        ),
                    )
                )
        if not self._direct_enabled:
            self._flusher.note_registered([r.hex for r in refs])
            self._sender.enqueue_many(
                "lease", [lease for _, lease in prepared]
            )
            return refs
        # pin every arg (incl. refs nested in containers) until the
        # result lands: the worker registers its borrows synchronously
        # before replying, so our later release can never free an object
        # the actor still holds (the lease path gets this from head-side
        # arg pins; the direct path pins at the caller). Pinning happens
        # HERE, after every call in the window serialized successfully —
        # an incref taken per-call inside the prepare loop would leak for
        # calls 0..k-1 when call k's wire.dumps raises (nothing was
        # registered yet, so nothing would ever release them).
        with self._direct_cv:
            for ref, ids, _ in prepared:
                for h in ids:
                    TRACKER.incref(h)
                self._direct_pending[ref.hex] = actor_id
                if ids:
                    self._direct_arg_pins[ref.hex] = ids
        chan = self._direct_channels.get(actor_id)
        if chan is None:
            with self._lock:
                chan = self._direct_channels.get(actor_id)
                if chan is None:
                    chan = _DirectActorChannel(self, actor_id)
                    self._direct_channels[actor_id] = chan
        chan.submit_many([item for _, _, item in prepared])
        return refs

    def _submit_actor_lease(
        self,
        *,
        task_id: str,
        actor_id: str,
        name: str,
        payload: bytes,
        return_id: Optional[str],
        arg_ids: List[str],
        streaming: bool = False,
    ) -> None:
        lease = LeaseRequest(
            task_id=task_id,
            name=name,
            payload=payload,
            return_ids=[return_id] if return_id else [],
            resources={},
            kind="actor_method",
            actor_id=actor_id,
            max_retries=0,
            arg_ids=arg_ids,
            client_id=self.client_id,
            streaming=streaming,
        )
        self._sender.enqueue("lease", lease)

    def submit_actor_method_streaming(
        self, actor_id: str, method: str, args: tuple, kwargs: dict
    ):
        """num_returns="streaming" actor method: always the head-scheduled
        lease path (the direct channel replies once per call; a stream
        needs the per-item seal plumbing), yielding an
        ObjectRefGenerator like a streaming task."""
        from ray_tpu_torch.core.object_store import ObjectRefGenerator
        from ray_tpu_torch.core.refcount import collect_serialized

        with collect_serialized() as arg_ids:
            payload = wire.dumps((method, args, kwargs))
        if arg_ids:
            self._flush_deferred_seals(arg_ids)
        tid = new_id()
        self._submit_actor_lease(
            task_id=tid,
            actor_id=actor_id,
            name=f"{actor_id[:8]}.{method}",
            payload=payload,
            return_id=None,
            arg_ids=sorted(arg_ids),
            streaming=True,
        )
        return ObjectRefGenerator(tid, self)

    # ---- direct-call plumbing ----------------------------------------
    def _callback_address(self) -> str:
        with self._lock:
            if self._callback_server is None:
                self._callback_server = RpcServer(
                    {
                        "DirectResults": self._h_direct_results,
                        "Ping": lambda r: "pong",
                    },
                    port=0,
                    max_workers=4,
                )
            return self._callback_server.address

    def _h_direct_results(self, results: List[dict]) -> None:
        """DirectResults RPC handler: enqueue the window for the fused
        loop's result sink and return — the push RPC never waits on
        local processing, and bursts from many workers merge into one
        batch-at-once delivery pass."""
        self._result_sink.push(results)

    def _process_direct_results(self, results: List[dict]) -> None:
        from ray_tpu_torch.core.refcount import TRACKER

        t_start = time.perf_counter()
        unpin: List[str] = []
        uploads: List[tuple] = []  # evicted owner-held objects → head
        register: List[str] = []  # head-sealed results: holder is on books
        spills: List[str] = []  # leased tasks handed back never-started
        with self._direct_cv:
            for r in results:
                h = r["ref"]
                if r.get("status") == "spill":
                    # lease released under a queued task: the worker
                    # never started it — re-route through the head
                    # (outside this lock; the channel still holds it)
                    spills.append(h)
                    continue
                if "deferred_seal" not in r:
                    # the worker sealed this one to the head (error, big
                    # value, ref-containing result, or deferred seals
                    # off): the seal registered us as holder, so a local
                    # release is owed — and any share-while-pending flag
                    # is moot (the head knows the object)
                    register.append(h)
                    self._shared_pending.discard(h)
                if r["status"] == "ok":
                    self._direct_results[h] = ("val", r["value"])
                    if "deferred_seal" in r:
                        contained = list(r["deferred_seal"] or ())
                        if h in self._shared_pending:
                            # the ref was already shared into another
                            # submission while the call ran: a consumer
                            # somewhere is dep-waiting on the head —
                            # upload now, don't defer
                            self._shared_pending.discard(h)
                            uploads.append((h, r["value"], contained))
                        else:
                            # ownership model: we (the caller) hold the
                            # only record of this object; the head learns
                            # about it on share or eviction
                            self._deferred_seals[h] = contained
                elif r["status"] == "error":
                    self._direct_results[h] = ("err", r["error"])
                else:
                    self._direct_results[h] = ("seal", r["seal"])
                self._direct_results_order.append(h)
                # lazy deque hygiene: drop heads already consumed by get()
                # (so the deque tracks the dict), then evict over cap
                while self._direct_results_order:
                    head = self._direct_results_order[0]
                    if head not in self._direct_results:
                        self._deferred_seals.pop(head, None)
                        self._direct_results_order.popleft()
                    elif len(self._direct_results) > self._direct_results_cap:
                        ev = self._direct_results_order.popleft()
                        entry = self._direct_results.pop(ev, None)
                        contained = self._deferred_seals.pop(ev, None)
                        if (
                            contained is not None
                            and entry is not None
                            and entry[0] == "val"
                            and TRACKER.count(ev) > 0
                        ):
                            # evicting an owner-held object someone still
                            # references: persist it to the head first
                            uploads.append((ev, entry[1], contained))
                    else:
                        break
                # a live never-consumed entry at the front blocks the lazy
                # sweep: periodically compact the deque against the dict
                if len(self._direct_results_order) > 2 * self._direct_results_cap:
                    self._direct_results_order = deque(
                        x
                        for x in self._direct_results_order
                        if x in self._direct_results
                    )
                aid = self._direct_pending.pop(h, None)
                if aid is not None:
                    chan = self._direct_channels.get(aid)
                    if chan is not None:
                        chan.on_result(h)
                unpin.extend(self._direct_arg_pins.pop(h, ()))
            self._direct_cv.notify_all()
        for h in spills:
            key = self._direct_pending.get(h)
            chan = (
                self._direct_channels.get(key)
                if isinstance(key, str) and key.startswith("lease:")
                else None
            )
            item = chan.take_inflight(h) if chan is not None else None
            if item is not None:
                self._lease_spill(item)
        if register:
            self._flusher.note_registered_live(register)
        for ev, data, contained in uploads:
            if not self._upload_owned(ev, data, contained):
                # we are the ONLY copy: losing the record would strand the
                # ref forever — re-cache (over cap; a later sweep retries)
                with self._direct_cv:
                    if ev not in self._direct_results:
                        self._direct_results[ev] = ("val", data)
                        self._direct_results_order.append(ev)
                    self._deferred_seals.setdefault(ev, contained)
        # release the per-call arg pins (the worker's borrow registrations
        # are on the books before its result reaches us)
        for h in unpin:
            TRACKER.decref(h)
        # one observe per merged delivery batch: the per-item share
        DISPATCH_OVERHEAD_US.observe(
            (time.perf_counter() - t_start) * 1e6 / max(1, len(results)),
            {"stage": "result"},
        )

    def _upload_owned(self, h: str, data: bytes, contained: List[str]) -> bool:
        """Persist an owner-held direct-call result into the head's object
        table (holder = this client) — called when the ref is shared into
        another submission or evicted from the local cache while still
        referenced. After this the normal head-directory lifecycle owns
        the object. Returns False (and logs) if the head stayed
        unreachable through the retry budget — the caller must keep its
        record so a later share can try again."""
        try:
            self.head.call(
                "PutObject",
                {
                    "object_id": h,
                    "data": data,
                    "holder": self.client_id,
                    "contained_ids": sorted(contained),
                },
                retries=8,
                retry_interval=0.25,
            )
            self._flusher.note_registered_live([h])
            return True
        except Exception:  # noqa: BLE001 - head gone; value stays local
            logger.warning("owner-held object upload failed", exc_info=True)
            return False

    def _flush_deferred_seals(self, ids) -> None:
        """Before a submission whose payload references owner-held objects
        leaves this process, upload those objects so any other node can
        resolve them through the head directory."""
        if not self._deferred_seals and not self._direct_pending:
            return
        todo = []
        with self._direct_cv:
            for h in ids:
                contained = self._deferred_seals.pop(h, None)
                if contained is None:
                    if h in self._direct_pending:
                        # result not here yet: flag so the arrival
                        # handler uploads instead of deferring (the
                        # consumer will dep-wait on the head directory)
                        self._shared_pending.add(h)
                    continue
                entry = self._direct_results.get(h)
                if entry is not None and entry[0] == "val":
                    todo.append((h, entry[1], contained))
        for h, data, contained in todo:
            if not self._upload_owned(h, data, contained):
                # keep the record: the dependent submission will dep-wait,
                # and the next share (or eviction) retries the upload.
                # Also restore the VALUE: a concurrent cap-eviction sweep
                # may have dropped it while the marker was popped (the
                # sweep skips its own upload when it sees no marker) —
                # without this the only copy of the object is lost
                with self._direct_cv:
                    self._deferred_seals.setdefault(h, contained)
                    if h not in self._direct_results:
                        self._direct_results[h] = ("val", data)
                        self._direct_results_order.append(h)

    def _fallback_submit(self, item: dict) -> None:
        """Route a direct-call item through the head-scheduled path (actor
        restarting, worker gone, or no direct route)."""
        from ray_tpu_torch.core.refcount import TRACKER

        with self._direct_cv:
            self._direct_pending.pop(item["ref"], None)
            self._shared_pending.discard(item["ref"])
            unpin = self._direct_arg_pins.pop(item["ref"], ())
            self._direct_cv.notify_all()
        self._submit_actor_lease(
            task_id=item["task_id"],
            actor_id=item["actor_id"],
            name=item["name"],
            payload=item["payload"],
            return_id=item["ref"],
            arg_ids=item["arg_ids"],
        )
        # the lease registers us as the return's holder head-side — the
        # local release is owed from now on (zero-safe: the caller may
        # have dropped the ref already)
        self._flusher.note_registered_live([item["ref"]])
        # the lease (queued before this release can flush) pins the args
        # head-side for the task's lifetime
        for h in unpin:
            TRACKER.decref(h)

    def _note_lineage(self, item: dict) -> None:
        """Retain a leased task's submit item as owner-side lineage (the
        reference keeps lineage at the owner, not the GCS): if every copy
        of its return object later dies, `_maybe_resubmit_lost` rebuilds
        it by resubmitting this item through head scheduling. Bounded by
        `owner_lineage_cap_mb` (LRU by submission order)."""
        from ray_tpu_torch.config import cfg

        cap = int(cfg.owner_lineage_cap_mb) << 20
        size = len(item.get("payload") or b"") + len(
            item.get("fn_blob") or b""
        )
        if size > cap:
            return
        with self._lineage_lock:
            old = self._lineage.pop(item["ref"], None)
            if old is not None:
                self._lineage_bytes -= old["_lineage_bytes"]
            item["_lineage_bytes"] = size
            item["_recon_attempts"] = 0
            self._lineage[item["ref"]] = item
            self._lineage_bytes += size
            while self._lineage_bytes > cap and self._lineage:
                _, evicted = self._lineage.popitem(last=False)
                self._lineage_bytes -= evicted["_lineage_bytes"]

    def _maybe_resubmit_lost(self, ref_hex: str, exc: BaseException) -> bool:
        """Owner-side lineage reconstruction: the head sealed this object
        ObjectLostError (typically "no re-executable lineage" — leased
        direct-dispatch tasks never registered a spec head-side). If we
        still hold the task's lineage and its retry budget isn't spent,
        resubmit it through per-task head scheduling — SYNCHRONOUSLY, so
        the head has already cleared the stale error entry when the
        caller's wait loop polls again (no stale-error re-read burning
        attempts). Returns True when the caller should keep waiting.

        `max_retries=0` items never resubmit (at-most-once preserved);
        `OwnerDiedError` is deliberately excluded — OUR owner is us, and
        a foreign owner's death is a fate-sharing verdict, not a loss."""
        from ray_tpu_torch.core.object_store import ObjectLostError

        if not isinstance(exc, ObjectLostError):
            return False
        with self._lineage_lock:
            item = self._lineage.get(ref_hex)
            if item is None:
                return False
            if item["_recon_attempts"] >= int(item.get("_max_retries", 0)):
                return False
            item["_recon_attempts"] += 1
            attempt = item["_recon_attempts"]
        lease = LeaseRequest(
            task_id=item["task_id"],
            name=item["name"],
            payload=item["payload"],
            return_ids=[item["ref"]],
            resources=dict(item["_resources"]),
            kind="task",
            max_retries=item["_max_retries"],
            arg_ids=item["arg_ids"],
            deps=[],
            client_id=self.client_id,
            trace=item.get("trace"),
            fn_blob=item["fn_blob"],
            fn_id=item["fn_id"],
            fn_cache=item["fn_cache"],
            runtime_env=item.get("runtime_env"),
        )
        lease.attempt = attempt  # joint budget with head-side retries
        log = logging.getLogger(__name__)
        try:
            self.head.call(
                "SubmitLease",
                lease,
                timeout=30.0,
                retries=3,
                retry_interval=0.25,
            )
        except Exception:  # noqa: BLE001 - loss stands; caller raises
            with self._lineage_lock:
                if ref_hex in self._lineage:
                    self._lineage[ref_hex]["_recon_attempts"] -= 1
            return False
        self.metrics["lineage_resubmits"] += 1
        log.info(
            "resubmitting lost leased-task object %s through head "
            "scheduling (owner-side lineage, attempt %d/%d)",
            ref_hex[:8],
            attempt,
            item["_max_retries"],
        )
        return True

    def _lease_spill(self, item: dict, may_have_run: bool = False) -> None:
        """Route a leased task back through per-task head scheduling
        (lease loss, stall recall, worker rejection) — the direct-path
        analog of ``_fallback_submit``. Idempotent per ref: a result that
        raced in (or an earlier spill) already cleared the pending entry,
        and re-submitting then would just re-execute for nothing.

        ``may_have_run``: the item was in flight when its lease died, so
        the worker may have (partially) executed it. A task with no
        retry budget then FAILS instead of re-running — the head path's
        worker-death semantics for max_retries=0 (at-most-once held)."""
        from ray_tpu_torch.core.refcount import TRACKER

        with self._direct_cv:
            if item["ref"] not in self._direct_pending:
                return  # already resolved or already spilled
            self._direct_pending.pop(item["ref"], None)
            self._shared_pending.discard(item["ref"])
            unpin = self._direct_arg_pins.pop(item["ref"], ())
            fail = may_have_run and int(item.get("_max_retries", 0)) <= 0
            if fail:
                self._direct_results[item["ref"]] = (
                    "err",
                    pickle.dumps(
                        RuntimeError(
                            f"worker died running {item['name']} "
                            "(max_retries=0: not re-executed)"
                        )
                    ),
                )
                self._direct_results_order.append(item["ref"])
            self._direct_cv.notify_all()
        if fail:
            for h in unpin:
                TRACKER.decref(h)
            return
        lease = LeaseRequest(
            task_id=item["task_id"],
            name=item["name"],
            payload=item["payload"],
            return_ids=[item["ref"]],
            resources=dict(item["_resources"]),
            kind="task",
            max_retries=item["_max_retries"],
            arg_ids=item["arg_ids"],
            deps=[],
            client_id=self.client_id,
            trace=item.get("trace"),
            fn_blob=item["fn_blob"],
            fn_id=item["fn_id"],
            fn_cache=item["fn_cache"],
            runtime_env=item.get("runtime_env"),
        )
        self._sender.enqueue("lease", lease)
        self.metrics["lease_spillbacks"] += 1
        LEASE_SPILLBACKS.inc()
        # the lease registers us as the return's holder head-side — the
        # local release is owed from now on; the queued lease re-pins the
        # args head-side before this unpin can flush
        self._flusher.note_registered_live([item["ref"]])
        for h in unpin:
            TRACKER.decref(h)

    def _direct_note_head_resolved(self, h: str) -> None:
        """A direct-call ref resolved through the head directory while its
        push was still pending: the push was lost (worker-side transient
        RPC failure — the seal reached the head anyway). Drop the pending
        entry and release its arg pins so later gets of this ref go
        straight to the head instead of stalling direct_wait_fallback_s,
        and the entry doesn't leak for the session. Safe: the seal landing
        at the head proves the worker finished with the args."""
        if h not in self._direct_pending:
            return
        from ray_tpu_torch.core.refcount import TRACKER

        with self._direct_cv:
            self._direct_pending.pop(h, None)
            unpin = self._direct_arg_pins.pop(h, ())
            self._direct_cv.notify_all()
        for p in unpin:
            TRACKER.decref(p)

    def _drop_direct_channel(self, actor_id: str, chan) -> None:
        with self._lock:
            if self._direct_channels.get(actor_id) is chan:
                del self._direct_channels[actor_id]

    def _wait_direct(
        self, h: str, deadline: Optional[float]
    ) -> Optional[tuple]:
        """Wait for a direct-call result. Returns the (kind, payload) tuple,
        or None if the ref fell back to the head path (or the push is
        taking long enough that the head directory is the better bet)."""
        # a direct result push can be lost (transient caller-side RPC
        # failure); the seal still reaches the head, so after this long a
        # getter stops trusting the push channel and resolves there
        give_up = time.monotonic() + self._direct_wait_fallback_s
        with self._direct_cv:
            while True:
                if h in self._direct_results:
                    return self._direct_results[h]
                if h not in self._direct_pending:
                    return None
                now = time.monotonic()
                if now >= give_up:
                    return None  # head WaitObject takes over (seal landed)
                wait = min(0.5, give_up - now)
                if deadline is not None:
                    wait = min(wait, deadline - now)
                    if wait <= 0:
                        raise GetTimeoutError(
                            f"get() timed out waiting for {h}"
                        )
                self._direct_cv.wait(timeout=wait)

    def _consume_direct(self, h: str, entry: tuple) -> Tuple[bool, Any]:
        """(resolved, value); raises for error results. Successfully
        consumed entries are dropped — later gets resolve through the head
        directory, which received the same seal."""
        kind, payload = entry
        if kind == "err":
            with self._direct_cv:
                self._direct_results.pop(h, None)
            raise pickle.loads(payload)
        if kind == "val":
            value = self._loads_tracking(payload)
            with self._direct_cv:
                if h not in self._deferred_seals:
                    # owner-held entries stay cached (we are the only
                    # record of the object until share/evict uploads it);
                    # head-sealed entries drop — later gets use the head
                    self._direct_results.pop(h, None)
            return True, value
        # sealed to the actor's node store: fetch from that agent directly
        seal = payload
        with self._lock:
            client = self._agents.get(seal.node_id)
        if client is not None:
            try:
                data = self._socket_fetch(seal.node_id, h)
                if data is None:
                    data = client.call(
                        "FetchObject",
                        {"object_id": h, "purpose": "get"},
                        timeout=120.0,
                    )
                value = self._loads_tracking(data)
                with self._direct_cv:
                    self._direct_results.pop(h, None)
                return True, value
            except (RpcError, KeyError, TimeoutError):
                pass
        return False, None  # fall back to the head-located fetch

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        resources: Dict[str, float],
        name: Optional[str] = None,
        lifetime: Optional[str] = None,
        max_restarts: int = 0,
        max_concurrency: Optional[int] = None,
        concurrency_groups: Optional[Dict[str, int]] = None,
        scheduling_strategy: Any = None,
        runtime_env: Optional[dict] = None,
        **_ignored,
    ) -> RemoteActorHandle:
        from ray_tpu_torch.core.refcount import collect_serialized

        if lifetime not in (None, "detached", "non_detached"):
            raise ValueError(
                f"lifetime must be 'detached' or 'non_detached', "
                f"got {lifetime!r}"
            )

        _ship_module_by_value(cls)
        actor_id = new_id()
        with collect_serialized() as arg_ids:
            payload = wire.dumps((cls, args, kwargs))
        self._flush_deferred_seals(arg_ids)
        lease = LeaseRequest(
            task_id=new_id(),
            name=f"{cls.__name__}.__init__",
            payload=payload,
            return_ids=[],
            resources=resources,
            kind="actor_creation",
            actor_id=actor_id,
            max_retries=0,
            strategy=scheduling_strategy,
            runtime_env=(
                {**(self.runtime_env or {}), **runtime_env}
                if runtime_env
                else self.runtime_env
            ),
            arg_ids=sorted(arg_ids),
            client_id=self.client_id,
        )
        req = {
            "spec": lease,
            "name": name,
            "class_name": cls.__name__,
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
            "lifetime": lifetime,
        }
        if name is None:
            # control-plane fast path: unnamed creations ride the ordered
            # client pipeline (one ClientBatch can carry many creations),
            # so a churn loop never serializes on per-creation replies
            # from a loaded head. The actor id is client-minted, so the
            # handle is valid immediately; WaitActor tolerates the
            # message still being in flight.
            self._sender.enqueue("create_actor", req)
        else:
            # named creation stays synchronous: the name-taken error must
            # surface to this caller, not vanish into the pipeline
            self.head.call("CreateActor", req)
        return RemoteActorHandle(self, actor_id, cls)

    def get_actor(self, name: str) -> RemoteActorHandle:
        info = self._read("GetActor", {"name": name})
        return RemoteActorHandle(self, info.actor_id, object)

    def kill_actor(self, handle: RemoteActorHandle, no_restart: bool = True) -> None:
        # rides the same ordered pipeline as creations so a create→kill
        # pair can never arrive reversed; wait=True keeps the
        # "processed by the head when this returns" semantics, and the
        # bounded wait keeps the pre-pipeline contract that a kill
        # against an unreachable head RAISES instead of hanging forever
        self._sender.enqueue(
            "kill_actor",
            {"actor_id": handle._actor_id, "no_restart": no_restart},
            wait=True,
            wait_timeout=30.0,
        )

    def actor_location(self, actor_id: str):
        """(node_id, agent_address) of an actor, or (None, None) while it
        is pending placement. Used for locality-aware dispatch (e.g. the
        serve proxy pinning shm-streaming calls to same-host replicas)."""
        try:
            info = self._read(
                "WaitActor", {"actor_id": actor_id, "timeout": 0.01}
            )
        except Exception:  # noqa: BLE001
            return None, None
        return info.node_id, info.address

    def wait_actor_alive(self, handle: RemoteActorHandle, timeout: float = 30.0):
        """Event-driven: each round is a server-side long-poll (WaitActor),
        so state changes propagate at RPC latency with no sleep loop."""
        deadline = time.monotonic() + timeout
        while True:
            window = min(5.0, max(0.1, deadline - time.monotonic()))
            try:
                info = self._read(
                    "WaitActor",
                    {"actor_id": handle._actor_id, "timeout": window},
                    timeout=window + 15.0,
                )
            except ValueError:
                # creations ride the pipelined client batch: this poll can
                # legitimately beat the creation message to the head (or
                # span a head restart that hasn't replayed it yet) — keep
                # waiting out OUR deadline before declaring it unknown
                if time.monotonic() >= deadline:
                    raise
                continue
            if info.state == "ALIVE":
                return info
            if info.state == "DEAD":
                raise RuntimeError(f"actor {handle._actor_id} died during creation")
            if time.monotonic() >= deadline:
                raise TimeoutError("actor did not become alive in time")

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def put_object(self, value: Any) -> ObjectRef:
        from ray_tpu_torch.core.refcount import collect_serialized

        ref = ObjectRef.new(owner="driver")
        with collect_serialized() as contained:
            data = wire.dumps(value)
        self._flush_deferred_seals(contained)
        self.head.call(
            "PutObject",
            {
                "object_id": ref.hex,
                "data": data,
                "holder": self.client_id,
                "contained_ids": sorted(contained),
            },
        )
        self._flusher.note_registered([ref.hex])
        return ref

    def _loads_tracking(self, data: bytes) -> Any:
        from ray_tpu_torch.core.refcount import loads_tracking

        return loads_tracking(self._flusher, data)

    def object_locations(self, refs: List[ObjectRef]) -> Dict[str, List[str]]:
        """hex -> node ids currently holding the object (best-effort,
        non-blocking; the head's object directory)."""
        try:
            return self._read(
                "LocateObjects", {"object_ids": [r.hex for r in refs]}
            )
        except Exception:  # noqa: BLE001
            return {}

    def object_sizes(self, refs: List[ObjectRef]) -> Dict[str, int]:
        """hex -> sealed byte size (0 = unknown); head object directory."""
        try:
            return self._read(
                "ObjectSizes", {"object_ids": [r.hex for r in refs]}
            )
        except Exception:  # noqa: BLE001
            return {}

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        h = ref.hex
        if self._push_enabled and (
            h in self._direct_pending or h in self._direct_results
        ):
            entry = self._wait_direct(h, deadline)
            if entry is not None:
                resolved, value = self._consume_direct(h, entry)
                if resolved:
                    return value
        while True:
            # a deferred (owner-held) result can land locally while we're
            # polling a head that will never hear of the object
            if self._push_enabled:
                with self._direct_cv:
                    entry = self._direct_results.get(h)
                if entry is not None:
                    resolved, value = self._consume_direct(h, entry)
                    if resolved:
                        return value
            poll = 2.0
            budget = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
                poll = min(poll, remaining)
                # head-retry loop bounded by the caller's FULL remaining
                # get() budget (+grace for one in-flight reply) — capping
                # at the poll slice would abort a 60s get() 3s into a 5s
                # head restart
                budget = remaining + 1.0
            try:
                reply = self._read(
                    "WaitObject",
                    {"object_id": ref.hex, "timeout": poll},
                    deadline_s=budget,
                )
            except RpcDeadlineError:
                raise GetTimeoutError(
                    f"get() timed out waiting for {ref} (head unreachable)"
                ) from None
            status = reply["status"]
            if status in ("inline", "error", "located"):
                self._direct_note_head_resolved(h)
            if status == "inline":
                return self._loads_tracking(reply["data"])
            if status == "error":
                exc = pickle.loads(reply["error"])
                if self._maybe_resubmit_lost(h, exc):
                    continue  # owner-side lineage rebuild in flight
                raise exc
            if status == "located":
                gone: List[str] = []
                for nid, addr in reply["locations"]:
                    try:
                        # peer-leased socket first (striped scatter-gather
                        # pull, zero per-transfer head RPCs after the one
                        # grant); chunked RPC on any transport miss
                        data = self._socket_fetch(nid, ref.hex)
                        if data is None:
                            data = self._agent(nid, addr).call(
                                "FetchObject",
                                {"object_id": ref.hex, "purpose": "get"},
                                timeout=120.0,
                            )
                    except KeyError:
                        # definite miss: the node answered without the
                        # object (evicted / lost mid-spill / stale row)
                        gone.append(nid)
                        continue
                    except (RpcError, TimeoutError):
                        continue
                    # deserialize OUTSIDE the try: a KeyError raised by
                    # the payload's own unpickling must surface, not
                    # prune a live location and re-execute the task
                    return self._loads_tracking(data)
                if gone:
                    # the head prunes those locations and, if that was the
                    # last copy, rebuilds through lineage — without this a
                    # stale directory row loops the get forever. Epoch-
                    # stamped: a pre-restart client's stale rows must not
                    # prune the rebuilt head's directory
                    try:
                        self.head.call(
                            "ObjectMissing",
                            {"object_id": ref.hex, "node_ids": gone},
                            timeout=10.0,
                            epoch=self._cluster_epoch,
                        )
                    except Exception:  # noqa: BLE001 - next poll retries
                        pass
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(f"get() timed out waiting for {ref}")

    def get_objects(
        self, refs: List[ObjectRef], timeout: Optional[float] = None
    ) -> List[Any]:
        """Batched list-get: one WaitObjectBatch RPC resolves many refs, and
        co-located payloads ride one FetchObjectBatch per node (the
        reference's batched plasma Get, core_worker Get(batch))."""
        deadline = None if timeout is None else time.monotonic() + timeout
        results: Dict[str, tuple] = {}  # hex -> ("val", v) | ("err", exc)
        order = [r.hex for r in refs]
        if self._push_enabled:
            for h in dict.fromkeys(order):
                if h in self._direct_pending or h in self._direct_results:
                    try:
                        entry = self._wait_direct(h, deadline)
                        if entry is not None:
                            ok, value = self._consume_direct(h, entry)
                            if ok:
                                results[h] = ("val", value)
                    except GetTimeoutError:
                        raise
                    except BaseException as exc:  # noqa: BLE001
                        results[h] = ("err", exc)
        while True:
            unresolved = list(dict.fromkeys(h for h in order if h not in results))
            if not unresolved:
                break
            if self._push_enabled:
                # late-arriving owner-held results resolve locally; the
                # head may never hear of those objects
                for h in unresolved:
                    entry = self._direct_results.get(h)
                    if entry is not None:
                        try:
                            ok, value = self._consume_direct(h, entry)
                            if ok:
                                results[h] = ("val", value)
                        except BaseException as exc:  # noqa: BLE001
                            results[h] = ("err", exc)
                unresolved = [h for h in unresolved if h not in results]
                if not unresolved:
                    break
            poll = 2.0
            budget = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
                poll = min(poll, remaining)
                budget = remaining + 1.0
            try:
                replies = self._read(
                    "WaitObjectBatch",
                    {"object_ids": unresolved, "timeout": poll},
                    timeout=poll + 30.0,
                    deadline_s=budget,
                )
            except RpcDeadlineError:
                missing = [h for h in order if h not in results]
                raise GetTimeoutError(
                    f"get() timed out waiting for {len(missing)} objects "
                    "(head unreachable)"
                ) from None
            located: Dict[tuple, List[str]] = {}
            for h, rep in zip(unresolved, replies):
                status = rep["status"]
                if status in ("inline", "error", "located"):
                    self._direct_note_head_resolved(h)
                if status == "inline":
                    results[h] = ("val", self._loads_tracking(rep["data"]))
                elif status == "error":
                    err = pickle.loads(rep["error"])
                    if not self._maybe_resubmit_lost(h, err):
                        results[h] = ("err", err)
                    # else: left unresolved — the next poll parks on the
                    # owner-side lineage rebuild
                elif status == "located":
                    located.setdefault(tuple(rep["locations"][0]), []).append(h)
            for (nid, addr), hs in located.items():
                try:
                    datas = self._agent(nid, addr).call(
                        "FetchObjectBatch",
                        {"object_ids": hs, "purpose": "get"},
                        timeout=120.0,
                    )
                    for h, d in zip(hs, datas):
                        results[h] = ("val", self._loads_tracking(d))
                except (RpcError, KeyError, TimeoutError):
                    # stale location/partial store: per-ref fallback path
                    for h in hs:
                        try:
                            remaining = None
                            if deadline is not None:
                                remaining = max(0.0, deadline - time.monotonic())
                            results[h] = (
                                "val",
                                self.get_object(ObjectRef(h), remaining),
                            )
                        except BaseException as exc:  # noqa: BLE001
                            results[h] = ("err", exc)
            if deadline is not None and time.monotonic() >= deadline:
                missing = [h for h in order if h not in results]
                if missing:
                    raise GetTimeoutError(
                        f"get() timed out waiting for {len(missing)} objects"
                    )
        out = []
        for h in order:
            kind, v = results[h]
            if kind == "err":
                raise v
            out.append(v)
        return out

    def cancel_object(self, ref: ObjectRef, force: bool = False) -> bool:
        h = ref.hex
        if self._lease_mgr is not None:
            key = self._direct_pending.get(h)
            chan = (
                self._direct_channels.get(key)
                if isinstance(key, str) and key.startswith("lease:")
                else None
            )
            cancelled = chan is not None and chan.cancel(h)
            killed = False
            if not cancelled and chan is not None and force:
                # running on the leased worker: force semantics = kill
                # the worker (the head's force path for its own tasks);
                # pre-sealing below makes the death spill skip this ref
                cancelled = killed = chan.kill_running(h)
            if cancelled:
                # sealed locally: the head never knew this task existed
                from ray_tpu_torch.core.refcount import TRACKER

                unpin = ()
                with self._direct_cv:
                    if h in self._direct_pending:
                        self._direct_pending.pop(h, None)
                        self._shared_pending.discard(h)
                        unpin = self._direct_arg_pins.pop(h, ())
                        self._direct_results[h] = (
                            "err",
                            pickle.dumps(RuntimeError("task cancelled")),
                        )
                        self._direct_results_order.append(h)
                        self._direct_cv.notify_all()
                for p in unpin:
                    TRACKER.decref(p)
                if killed:
                    # retire the channel NOW (its worker is dying): the
                    # other unresolved items respill as never-started
                    # instead of racing the death into may-have-run
                    chan.on_killed()
                return True
        reply = self.head.call(
            "CancelLease", {"object_id": h, "force": force}
        )
        return bool(reply.get("cancelled"))

    def free_objects(self, refs: List[ObjectRef]) -> None:
        self.head.call("FreeObjects", {"object_ids": [r.hex for r in refs]})

    def _agent(self, node_id: str, address: str) -> RpcClient:
        with self._lock:
            client = self._agents.get(node_id)
            if client is None or client.address != address:
                client = RpcClient(address)
                self._agents[node_id] = client
            return client

    # ------------------------------------------------------------------
    # cross-node data plane (transport.py): drivers pull big results
    # over the same peer-leased sockets agents use — one GrantPeerLink
    # per (driver, node) pair, then every fetch is head-free
    # ------------------------------------------------------------------
    def _link_cache(self):
        with self._lock:
            if self._peer_links is None:
                from .transport import PeerLinkCache

                self._peer_links = PeerLinkCache(self._grant_peer_link)
                # renew-while-hot + idle reclamation, the driver-side
                # mirror of the agent's _link_maintenance (without it,
                # every driver link expires 'revoked' at the head ~3xTTL
                # in and pooled sockets linger until process exit)
                threading.Thread(
                    target=self._link_maintenance_loop,
                    name="client-peer-links",
                    daemon=True,
                ).start()
            return self._peer_links

    def _link_maintenance_loop(self) -> None:
        from ray_tpu_torch.config import cfg

        while not self._stop_event.wait(
            max(1.0, cfg.peer_link_ttl_s / 2.0)
        ):
            cache = self._peer_links
            if cache is None:
                continue
            try:
                hot = cache.hot_links(cfg.peer_link_ttl_s)
                if hot:
                    self.head.call(
                        "RenewPeerLinks",
                        {"link_ids": hot},
                        timeout=5.0,
                        epoch=self._cluster_epoch,
                    )
                for link in cache.sweep_idle(cfg.peer_link_idle_ttl_s):
                    try:
                        self.head.call(
                            "ReturnPeerLink",
                            {"link_id": link.link_id},
                            timeout=5.0,
                            epoch=self._cluster_epoch,
                        )
                    except Exception:  # noqa: BLE001 - sweep reclaims
                        pass
            except Exception:  # noqa: BLE001 - upkeep never kills the loop
                if self._stop_event.is_set():
                    return

    def _grant_peer_link(self, node_id: str):
        from .transport import PeerLink

        try:
            rep = self.head.call(
                "GrantPeerLink",
                {"src_node": self.client_id, "dst_node": node_id},
                timeout=10.0,
                epoch=self._cluster_epoch,
            )
        except Exception:  # noqa: BLE001 - head busy: RPC path still works
            return None
        if not rep.get("granted"):
            return None
        return PeerLink(
            rep["link_id"],
            node_id,
            rep["endpoint"],
            rep["token"],
            rep.get("epoch"),
            src_node=self.client_id,
        )

    def _socket_fetch(
        self, nid: str, h: str, land: "Optional[str]" = None
    ) -> "Optional[memoryview]":
        """Socket pull of one object from a node's data server. None =
        plane unavailable for this transfer (caller uses the FetchObject
        RPC); KeyError propagates (definite miss — the caller prunes the
        location). Returns a READ-ONLY view: numpy payloads deserialize
        as immutable views exactly like the RPC path's bytes reply.

        ``land`` defaults to None: a generic get must not stage its raw
        RTP5 byte stream in HBM (headers, pickle opcodes, and non-tensor
        payloads would transiently consume device memory equal to the
        whole object). Tensor-heavy consumers opt in by passing
        ``land='device'`` or by fetching under an explicit
        ``device_plane.landing("device")`` scope (rdt pulls, elastic
        ``fetch_sealed``) — landed stripes then stream device-side in
        flight so device frames deserialize against warm pages."""
        from ray_tpu_torch.config import cfg

        if not cfg.native_net:
            return None
        from .device_plane import landing_requested
        from .transport import LinkRejectedError, StripeFetchError
        from .transport import fetch_bytes as _fetch_bytes

        if land is None and landing_requested():
            land = "device"
        link = self._link_cache().get(nid)
        if link is None:
            return None
        try:
            return memoryview(
                _fetch_bytes(link, h, purpose="get", land=land)
            ).toreadonly()
        except KeyError:
            raise
        except LinkRejectedError:
            self._peer_links.drop(nid, link.link_id)
            return None
        except (StripeFetchError, ConnectionError, TimeoutError, OSError):
            return None

    # ------------------------------------------------------------------
    # placement groups
    # ------------------------------------------------------------------
    def create_placement_group(
        self,
        bundles: List[Dict[str, float]],
        strategy: str = "PACK",
        avoid_nodes: Optional[List[str]] = None,
    ) -> str:
        reply = self.head.call(
            "CreatePlacementGroup",
            {
                "bundles": bundles,
                "strategy": strategy,
                "avoid_nodes": list(avoid_nodes or ()),
            },
        )
        return reply["pg_id"]

    # ------------------------------------------------------------------
    # elastic-training gang membership (train/elastic.py)
    # ------------------------------------------------------------------
    def gang_register(
        self,
        gang_id: str,
        members: Dict[int, str],
        min_size: int = 1,
        epoch_floor: int = 0,
        want_world: int = 0,
        resources_per_rank: Optional[Dict[str, float]] = None,
        grow: bool = False,
    ) -> int:
        # re-registration is the designed recovery path (monotone epoch
        # + epoch_floor), so retrying through a head blip/failover is
        # safe — and a zero-retry register right after placement would
        # abort fit() on a transient, leaking the just-placed gang
        reply = self.head.call(
            "GangRegister",
            {
                "gang_id": gang_id,
                "owner": self.client_id,
                "members": {str(r): n for r, n in members.items()},
                "min_size": min_size,
                "epoch_floor": epoch_floor,
                # elasticity plane: the driver's grow-back want
                # and per-rank shape feed the unified demand matrix
                "want_world": int(want_world),
                "resources_per_rank": dict(resources_per_rank or {}),
                "grow": bool(grow),
            },
            retries=8,
            retry_interval=0.25,
        )
        return int(reply["epoch"])

    def gang_hint(self, gang_id: str) -> dict:
        """Poll the elasticity controller's sustainable-world verdict
        for one gang (``{"world_hint": int|None, "epoch": int}``)."""
        return self._read("GangHint", {"gang_id": gang_id})

    def gang_sync(
        self, gang_id: str, epoch: int, timeout: float = 0.0
    ) -> dict:
        return self._read(
            "GangSync",
            {"gang_id": gang_id, "epoch": epoch, "timeout": timeout},
            timeout=timeout + 15.0,
        )

    def gang_fence(self, gang_id: str, reason: str = "fence") -> int:
        reply = self.head.call(
            "GangFence", {"gang_id": gang_id, "reason": reason}
        )
        return int(reply["epoch"])

    def gang_unregister(self, gang_id: str) -> None:
        self.head.call("GangUnregister", {"gang_id": gang_id})

    def free_objects(self, hex_ids: List[str]) -> None:
        """Force-free object-plane entries this process knows are dead
        (elastic state generations past their retention window)."""
        if not hex_ids:
            return
        self.head.call("FreeObjects", {"object_ids": list(hex_ids)})

    def wait_placement_group(self, pg_id: str, timeout: float = 30.0) -> List[str]:
        deadline = time.monotonic() + timeout
        while True:
            window = min(5.0, max(0.1, deadline - time.monotonic()))
            reply = self._read(
                "WaitPlacementGroup",
                {"pg_id": pg_id, "timeout": window},
                timeout=window + 15.0,
            )
            if reply["ready"]:
                return reply["node_per_bundle"]
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"placement group {pg_id} not ready in {timeout}s"
                )

    def remove_placement_group(self, pg_id: str) -> None:
        self.head.call("RemovePlacementGroup", {"pg_id": pg_id})

    # ------------------------------------------------------------------
    # kv + introspection
    # ------------------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self.head.call("KvPut", {"key": key, "value": value})

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._read("KvGet", {"key": key})

    def kv_del(self, key: str) -> None:
        self.head.call("KvDel", {"key": key})

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self._read("KvKeys", {"prefix": prefix})

    def nodes_info(self) -> List[Dict[str, Any]]:
        return self._read("ClusterInfo")["nodes"]

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Autoscaler demand feed (queued/infeasible leases + PG bundles)."""
        return self._read("PendingDemands")

    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes_info():
            if not n["Alive"]:
                continue
            for k, v in n["Resources"].items():
                out[k] = out.get(k, 0.0) + v
        return out

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes_info():
            if not n["Alive"]:
                continue
            for k, v in n["Available"].items():
                out[k] = out.get(k, 0.0) + v
        return out

    def query_state(self, kind: str = "summary") -> Any:
        return self._read("QueryState", {"kind": kind})

    def timeline(self, filename: Optional[str] = None) -> List[dict]:
        """Chrome-trace of head-observed lease lifecycle events."""
        spans = self._read("Timeline", timeout=60.0)
        if filename:
            import json

            with open(filename, "w") as f:
                json.dump(spans, f)
        return spans

    def shutdown(self) -> None:
        from ray_tpu_torch.core import refcount

        # idempotent: the atexit hook, __exit__, and explicit shutdown()
        # may all fire; only the first runs the teardown
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self._stop_event.set()
        import atexit

        try:
            atexit.unregister(self._atexit_hook)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
        if self._lease_mgr is not None:
            self._lease_mgr.stop()  # no new grants/channels from here on
        for chan in list(self._direct_channels.values()):
            chan.stop()  # lease channels also enqueue their lease_return
        self._direct_channels.clear()
        self._hotloop.stop()
        self._result_sink.close()
        if self._callback_server is not None:
            self._callback_server.stop()
            self._callback_server = None
        if self._owns_flusher:
            # release every id this driver still counts so the cluster can
            # free driver-owned objects (job-exit cleanup analog). BOUNDED:
            # a wedged pipeline must not hang process exit — undelivered
            # releases are covered by the head's disconnect reap dropping
            # this client's holder rows
            self._ref_wait_timeout = 10.0
            self._flusher.stop(release_all=True)
            refcount.clear_consumer(self._flusher)
        self._sender.stop()
        try:
            # clean driver exit: the head reaps this client's non-detached
            # actors (detached ones survive — reference job-exit
            # semantics). Best-effort: a crashed driver skips this and
            # its actors linger until killed explicitly.
            self.head.call(
                "DisconnectClient", {"client_id": self.client_id}, timeout=5.0
            )
        except Exception:  # noqa: BLE001 - best-effort: call() re-raises
            pass  # server-side exceptions verbatim (not just RpcError)
        self._pipe_chan.close()
        self.head.close()
        with self._lock:
            for client in self._agents.values():
                client.close()
            self._agents.clear()
            if self._peer_links is not None:
                self._peer_links.close()
                self._peer_links = None


def connect(address: str, runtime_env: Optional[dict] = None) -> RemoteRuntime:
    return RemoteRuntime(address, runtime_env=runtime_env)
