"""Cross-process collective groups: the DCN host-collective backend.

The reference's host collectives are NCCL/Gloo process groups
(Ray's python/ray/util/collective/collective_group/). The
*data-plane* collectives run inside the device program (NCCL for the
port: ``ray_tpu_torch.parallel``); what remains is a host-level rendezvous across worker processes/hosts — here built on a named
rendezvous actor reachable from every process in the cluster (DCN traffic
rides the same gRPC object plane as everything else).

The rendezvous actor is an *asyncio* actor: every rank makes ONE
``collect`` call that parks on an asyncio.Event until the group is
complete, then returns all contributions — push-based wakeup, no client
polling (pubsub/publisher.h analog for the collective plane; the previous
contribute+poll protocol burned a 100 Hz loop per rank). Op ids come from
per-op monotonic counters, which are consistent across ranks because
collective calls are SPMD-ordered (the same assumption NCCL makes).

Port of ``ray_tpu/collective/distributed.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import asyncio
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch

_REDUCE_OPS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "product": lambda xs: np.prod(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
}


class CollectiveGroupActor:
    """Rendezvous state for one group (runs as a named asyncio actor);
    all methods multiplex on the actor's event loop, so Events are safe."""

    def __init__(self, world_size: int):
        self.world = world_size
        self.slots: Dict[str, Dict[int, Any]] = {}
        self.events: Dict[str, asyncio.Event] = {}
        self.remaining: Dict[str, set] = {}
        self.mailbox: Dict[tuple, Any] = {}
        self.mail_events: Dict[tuple, asyncio.Event] = {}

    async def world_size(self) -> int:
        return self.world

    async def collect(
        self, op_id: str, rank: int, value: Any, timeout: float = 120.0
    ):
        """Contribute and await the full group in one round trip. Returns
        None on rendezvous timeout (an explicit sentinel — NOT an
        exception, so callers never have to pattern-match error text); the
        timed-out rank withdraws its contribution so a retry starts
        clean and nothing leaks in the actor."""
        s = self.slots.setdefault(op_id, {})
        s[rank] = value
        ev = self.events.setdefault(op_id, asyncio.Event())
        if len(s) == self.world:
            ev.set()
        else:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                # the timer can fire in the same loop tick the last rank
                # sets the event: withdrawing then would KeyError innocent
                # ranks mid-gather — re-check before treating it as a miss
                if not ev.is_set():
                    s.pop(rank, None)
                    if not s:
                        self.slots.pop(op_id, None)
                        self.events.pop(op_id, None)
                        self.remaining.pop(op_id, None)
                    return None
        out = [s[r] for r in range(self.world)]
        rem = self.remaining.setdefault(op_id, set(range(self.world)))
        rem.discard(rank)
        if not rem:
            del self.slots[op_id]
            del self.events[op_id]
            del self.remaining[op_id]
        return out

    # point-to-point: the receiver parks on an Event until the sender posts
    async def put(self, key: tuple, value: Any) -> None:
        self.mailbox[key] = value
        ev = self.mail_events.pop(key, None)
        if ev is not None:
            ev.set()

    async def take(self, key: tuple, timeout: float = 30.0) -> tuple:
        if key not in self.mailbox:
            ev = self.mail_events.setdefault(key, asyncio.Event())
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                self.mail_events.pop(key, None)
                return (False, None)
        if key in self.mailbox:
            return (True, self.mailbox.pop(key))
        return (False, None)


class DistributedGroup:
    """Per-process view of one collective group."""

    def __init__(self, handle, world_size: int, rank: int, name: str):
        self.handle = handle
        self.world = world_size
        self.rank = rank
        self.name = name
        self._counters: Dict[str, int] = {}

    def _op_id(self, op: str) -> str:
        n = self._counters.get(op, 0)
        self._counters[op] = n + 1
        return f"{op}:{n}"

    def _rendezvous(self, op: str, value: Any, timeout: float = 120.0) -> List[Any]:
        op_id = self._op_id(op)
        out = ray_tpu_torch.get(
            self.handle.collect.remote(op_id, self.rank, value, timeout),
            timeout=timeout + 30,
        )
        if out is None:
            raise TimeoutError(
                f"collective {op_id} in group {self.name!r} timed out "
                f"({self.world} ranks expected)"
            )
        return out

    # ------------------------------------------------------------------
    def allreduce(self, tensor, op: str = "sum"):
        values = self._rendezvous("allreduce", np.asarray(tensor))
        return _REDUCE_OPS[op](values)

    def allgather(self, tensor) -> List[np.ndarray]:
        return [np.asarray(v) for v in self._rendezvous("allgather", np.asarray(tensor))]

    def broadcast(self, tensor, src_rank: int = 0):
        values = self._rendezvous("broadcast", np.asarray(tensor))
        return np.asarray(values[src_rank])

    def reducescatter(self, tensor, op: str = "sum"):
        values = self._rendezvous("reducescatter", np.asarray(tensor))
        reduced = _REDUCE_OPS[op](values)
        return np.array_split(reduced, self.world)[self.rank]

    def barrier(self) -> None:
        self._rendezvous("barrier", None)

    def send(self, tensor, dst_rank: int) -> None:
        n = self._counters.get(f"p2p:{self.rank}->{dst_rank}", 0)
        self._counters[f"p2p:{self.rank}->{dst_rank}"] = n + 1
        ray_tpu_torch.get(
            self.handle.put.remote(
                (self.rank, dst_rank, n), np.asarray(tensor)
            ),
            timeout=30,
        )

    def recv(self, src_rank: int, timeout: float = 30.0):
        counter_key = f"p2p:{src_rank}->{self.rank}"
        key_n = self._counters.get(counter_key, 0)
        ok, value = ray_tpu_torch.get(
            self.handle.take.remote((src_rank, self.rank, key_n), timeout),
            timeout=timeout + 30,
        )
        if ok:
            # advance only on success so a timed-out recv can be retried
            # without skipping the in-flight message
            self._counters[counter_key] = key_n + 1
            return value
        raise TimeoutError(f"recv from rank {src_rank} timed out")


def create_distributed_group(
    world_size: int, rank: int, group_name: str
) -> DistributedGroup:
    """Join (creating if first) the named rendezvous actor for this group."""
    actor_name = f"_collective:{group_name}"
    Actor = ray_tpu_torch.remote(CollectiveGroupActor)
    try:
        handle = ray_tpu_torch.get_actor(actor_name)
    except ValueError:
        try:
            handle = Actor.options(name=actor_name).remote(world_size)
        except ValueError:  # lost the creation race
            handle = ray_tpu_torch.get_actor(actor_name)
    existing = ray_tpu_torch.get(handle.world_size.remote(), timeout=60)
    if existing != world_size:
        raise ValueError(
            f"collective group {group_name!r} already exists with "
            f"world_size={existing} (requested {world_size}); destroy it "
            "first or use a distinct group_name per job"
        )
    return DistributedGroup(handle, world_size, rank, group_name)


def destroy_distributed_group(group: DistributedGroup) -> None:
    """Tear down the rendezvous actor so the name can be reused."""
    try:
        ray_tpu_torch.kill(group.handle)
    except Exception:  # noqa: BLE001 - already gone
        pass
