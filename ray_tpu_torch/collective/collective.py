"""Host-backend collective groups (rendezvous over shared memory).

Port of ``ray_tpu/collective/collective.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

_REDUCE_OPS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "product": lambda xs: np.prod(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
}


@dataclass
class _Group:
    name: str
    world_size: int
    barrier: threading.Barrier
    lock: threading.Lock = field(default_factory=threading.Lock)
    slots: List[Any] = field(default_factory=list)
    result: Any = None
    generation: int = 0
    p2p: Dict[tuple, Any] = field(default_factory=dict)
    p2p_cv: threading.Condition = field(default_factory=threading.Condition)


_groups: Dict[str, _Group] = {}
_groups_lock = threading.Lock()
# rank registry keyed by (group, caller identity): for actor methods the
# identity is the actor id — stable across the actor's worker threads
# (max_concurrency > 1) and restarts; plain threads fall back to thread id.
_ranks: Dict[tuple, int] = {}
_ranks_lock = threading.Lock()
# distributed (cross-process) groups, keyed like _ranks
_dist_groups: Dict[tuple, Any] = {}


def _caller_key() -> Any:
    try:
        from ray_tpu_torch.core.runtime import get_context

        actor_id = get_context().actor_id
        if actor_id:
            return ("actor", actor_id)
    except Exception:  # noqa: BLE001 - outside the runtime
        pass
    return ("thread", threading.get_ident())


def _runtime_is_remote() -> bool:
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        return bool(getattr(get_runtime(), "is_remote", False))
    except Exception:  # noqa: BLE001 - runtime not initialized
        return False


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
) -> None:
    """Per-rank group registration (collective.py:146 parity).

    backend="host" rendezvouses in-process (single-process runtime);
    backend="distributed" — or any backend when running against a live
    multi-process cluster — rendezvouses through a named actor reachable
    over DCN (collective/distributed.py)."""
    if backend == "distributed" or _runtime_is_remote():
        from .distributed import create_distributed_group

        group = create_distributed_group(world_size, rank, group_name)
        with _ranks_lock:
            _dist_groups[(group_name, _caller_key())] = group
        return
    with _groups_lock:
        if group_name not in _groups:
            _groups[group_name] = _Group(
                name=group_name,
                world_size=world_size,
                barrier=threading.Barrier(world_size),
            )
        g = _groups[group_name]
        if g.world_size != world_size:
            raise ValueError(
                f"group {group_name} already exists with world_size "
                f"{g.world_size}"
            )
    with _ranks_lock:
        _ranks[(group_name, _caller_key())] = rank


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = "host",
    group_name: str = "default",
) -> None:
    """Driver-side declaration (collective.py:186): initializes the group on
    every actor via a remote call to ray_tpu_torch.collective.init_collective_group.
    """
    import ray_tpu_torch

    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(
            actor._init_collective.remote(world_size, rank, backend, group_name)
        )
    ray_tpu_torch.get(refs)


def _dist_group(group_name: str):
    with _ranks_lock:
        return _dist_groups.get((group_name, _caller_key()))


def _group_and_rank(group_name: str):
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(f"collective group {group_name!r} not initialized")
    with _ranks_lock:
        rank = _ranks.get((group_name, _caller_key()))
    if rank is None:
        raise RuntimeError(
            f"caller has no rank in group {group_name!r} "
            "(init_collective_group not called from this actor/thread)"
        )
    return g, rank


def get_rank(group_name: str = "default") -> int:
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.rank
    return _group_and_rank(group_name)[1]


def get_collective_group_size(group_name: str = "default") -> int:
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.world
    return _group_and_rank(group_name)[0].world_size


def barrier(group_name: str = "default") -> None:
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.barrier()
    g, _ = _group_and_rank(group_name)
    g.barrier.wait()


def _all_to_driver(g: _Group, rank: int, value: Any) -> List[Any]:
    """Gather all ranks' values; everyone sees the full list."""
    with g.lock:
        if len(g.slots) != g.world_size:
            g.slots = [None] * g.world_size
        g.slots[rank] = value
    g.barrier.wait()
    gathered = list(g.slots)
    g.barrier.wait()  # all have copied before reset
    if rank == 0:
        with g.lock:
            g.slots = []
    g.barrier.wait()  # reset visible to all before the next collective
    return gathered


def allreduce(tensor, op: str = "sum", group_name: str = "default"):
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.allreduce(tensor, op)
    g, rank = _group_and_rank(group_name)
    gathered = _all_to_driver(g, rank, np.asarray(tensor))
    return _REDUCE_OPS[op](np.stack(gathered))


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.allgather(tensor)
    g, rank = _group_and_rank(group_name)
    return [np.asarray(x) for x in _all_to_driver(g, rank, np.asarray(tensor))]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.broadcast(tensor, src_rank)
    g, rank = _group_and_rank(group_name)
    gathered = _all_to_driver(g, rank, np.asarray(tensor))
    return gathered[src_rank]


def reducescatter(tensor, op: str = "sum", group_name: str = "default"):
    """Each rank gets its 1/world_size shard of the reduction."""
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.reducescatter(tensor, op)
    g, rank = _group_and_rank(group_name)
    gathered = _all_to_driver(g, rank, np.asarray(tensor))
    reduced = _REDUCE_OPS[op](np.stack(gathered))
    return np.array_split(reduced, g.world_size)[rank]


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.send(tensor, dst_rank)
    g, rank = _group_and_rank(group_name)
    with g.p2p_cv:
        g.p2p.setdefault((rank, dst_rank), []).append(np.asarray(tensor))
        g.p2p_cv.notify_all()


def recv(src_rank: int, group_name: str = "default", timeout: float = 30.0):
    """Messages are delivered in send order (FIFO per (src, dst) pair)."""
    dg = _dist_group(group_name)
    if dg is not None:
        return dg.recv(src_rank, timeout)
    g, rank = _group_and_rank(group_name)
    key = (src_rank, rank)
    with g.p2p_cv:
        ok = g.p2p_cv.wait_for(lambda: g.p2p.get(key), timeout)
        if not ok:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        queue = g.p2p[key]
        value = queue.pop(0)
        if not queue:
            del g.p2p[key]
        return value


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        _groups.pop(group_name, None)
    doomed = []
    with _ranks_lock:
        for key in [k for k in _dist_groups if k[0] == group_name]:
            doomed.append(_dist_groups.pop(key))
    if doomed:
        from .distributed import destroy_distributed_group

        destroy_distributed_group(doomed[0])


def collective_actor_mixin(cls):
    """Class decorator adding the _init_collective method used by
    create_collective_group."""

    def _init_collective(self, world_size, rank, backend, group_name):
        init_collective_group(world_size, rank, backend, group_name)
        return rank

    cls._init_collective = _init_collective
    return cls
