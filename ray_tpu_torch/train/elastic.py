"""Elastic SPMD training: checkpoint-free recovery, mesh reshape, and
resume from object-plane state lineage.

Port of ``ray_tpu/train/elastic.py``, the same protocol over the port's
runtime, cluster and device plane. Where the reference holds ``jax.Array``
leaves, the port holds ``torch.Tensor`` leaves (on a CUDA card or the
CPU): a seal keeps them device-resident when the device plane is on
(each seals as a device frame), cuts sharded leaves on their device at
``np.array_split``'s boundaries, and a regather joins device-landed
shards with ``torch.cat`` on their device. A partition spec is the
port's plain tuple of axis names (``models/transformer.py``'s
``param_specs``), and a shard function is ``local_shard`` onto the rank's
mesh device. Trees flatten with ``pytree`` in JAX's leaf order and paths.

The legacy ``TorchTrainer`` answers every failure with a whole-gang
restart from the latest *disk* checkpoint. This module makes the
training plane elastic instead:

- **Gang-epoch membership.** The head owns a gang table (rank ->
  node); its health/strike machinery bumps the gang epoch the moment a
  member's node is declared dead (``GangRegister``/``GangSync``/
  ``GangFence``). Every collective the ranks run is fenced by that
  epoch at the gang's rendezvous hub — a straggler from a dead epoch is
  rejected exactly like a stale control RPC at the cluster fence.
- **Object-plane state, not disk.** Each rank periodically seals its
  param/optimizer state into the shm object plane as pickle-5 frames
  (arena-direct via the worker seal path; numpy leaves never re-copy
  through a monolithic pickle), and seals its EXACT boundary state when
  an epoch breaks. A buddy rank pulls each periodic seal over the
  socket plane so the directory holds two arena copies — one node death
  can never lose a shard. Dataset blocks feeding the loop are task
  outputs and reconstruct through the normal lineage machinery.
- **Mesh reshape.** On a membership change the driver re-plans the
  dp/pp/tp topology over the surviving capacity (placement rides the
  ordinary PG/kernel path, with soft ``avoid_nodes`` anti-affinity for
  recently-dead hosts), spawns the new generation, and each rank
  regathers its state shards from the sealed objects — then *grows* the
  mesh back when the autoscaler restores capacity.
- **Reshape-invariant arithmetic.** Collectives reduce over a FIXED
  grid of *virtual shards* (``ElasticConfig.virtual_shards``), summed
  in shard order regardless of how many ranks currently own them, so a
  dp shrink/grow preserves the numerics of the unreshaped run — with
  exactly-representable data, bit-for-bit (test-pinned).

Declarative parameter sharding follows the partition-rule/pjit exemplar
shape: ``match_partition_rules`` maps regex rules over named leaf paths
to specs (tuples of axis names) and ``make_shard_and_gather_fns`` turns
the spec tree into per-leaf device shard/gather callables over the rank's
local mesh.
"""
from __future__ import annotations

import logging
import re
import threading
import time
import operator
import uuid
from dataclasses import dataclass, field
from functools import reduce as _reduce
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.config import cfg
from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Histogram as _Histogram
from ray_tpu_torch.util.tracing import SPANS

from . import pytree
from .checkpoint import Checkpoint
from .session import TrainContext, _set_context
from .trainer import Result, RunConfig, ScalingConfig

logger = logging.getLogger(__name__)

ELASTIC_RESHAPES = _Counter(
    "elastic_reshapes_total",
    "Elastic gang generation changes, by direction (shrink = fewer "
    "ranks than the previous generation, grow = more, flat = same "
    "world re-placed, e.g. after a hub death).",
    label_names=("direction",),
)
ELASTIC_SEAL_BYTES = _Counter(
    "elastic_state_sealed_bytes_total",
    "Bytes of param/optimizer state sealed into the object plane by "
    "elastic ranks (periodic + break-time seals).",
)
ELASTIC_SEAL_MS = _Histogram(
    "elastic_seal_ms",
    "Wall time of one rank state seal (flatten + arena-direct write).",
)
ELASTIC_DISK_RESTORES = _Counter(
    "elastic_disk_restores_total",
    "Times an elastic restore had to fall back to a DISK checkpoint "
    "because no object-plane seal set covered the state (the chaos "
    "acceptance gate asserts this stays zero).",
)


# a rank parked at the hub longer than this asks the head for its gang's
# epoch before waiting on
HEAD_CHECK_S = 1.0


# the reason a rank gives when a call to its gang's hub failed
HUB_UNREACHABLE = "hub unreachable"
# how long a voluntary reshape (a grow or a cede: no rank died) waits for
# the torn-down generation's leases to reach the head's view of capacity
RESHAPE_SETTLE_S = 5.0


class GangEpochRevoked(RuntimeError):
    """This rank's gang epoch was fenced: a member died, the owner
    requested a resize, or the rendezvous hub vanished. The rank seals
    its boundary state and returns to the driver for reshape."""


class ElasticStateIncomplete(RuntimeError):
    """No available seal set covers the full state pytree."""


# ---------------------------------------------------------------------------
# declarative parameter sharding (partition-rule / pjit exemplar shape)
# ---------------------------------------------------------------------------


def tree_paths_and_leaves(tree: Any) -> Tuple[List[str], List[Any], Any]:
    """Flatten ``tree`` into ('/'-joined named paths, leaves, treedef)."""
    flat, treedef = pytree.flatten_with_path(tree)
    paths = [pytree.path_str(kp) for kp, _ in flat]
    return paths, [leaf for _, leaf in flat], treedef


def is_spec(x: Any) -> bool:
    """A partition spec: a plain tuple of axis names (or None), one per
    leading dimension; ``()`` replicates."""
    return type(x) is tuple and all(a is None or isinstance(a, str) for a in x)


def _shape(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return np.shape(leaf)


def match_partition_rules(rules: Sequence[Tuple[str, Any]], params: Any):
    """Return a tree of specs according to regex ``rules`` over
    '/'-joined leaf paths. Scalars never partition; a leaf no rule
    matches raises (a silent replicate hides typos in the rule table)."""
    paths, leaves, treedef = tree_paths_and_leaves(params)
    specs = []
    for path, leaf in zip(paths, leaves):
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            specs.append(())
            continue
        for rule, ps in rules:
            if re.search(rule, path) is not None:
                specs.append(tuple(ps))
                break
        else:
            raise ValueError(f"partition rule not found for param: {path}")
    return pytree.unflatten(treedef, specs)


def _shard_leaf(x: Any, spec: Tuple[Optional[str], ...], mesh: Any):
    from ray_tpu_torch.parallel.mesh import local_shard

    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return local_shard(mesh, t.to(mesh.device), *spec)


def make_shard_and_gather_fns(partition_specs: Any, mesh: Any):
    """(shard_fns, gather_fns) trees from a spec tree over ``mesh``: shard
    places a host leaf onto the mesh's device as this rank's block under
    its spec (``local_shard``), gather pulls a leaf back to a host tensor.
    A spec is a tuple, so it must be pinned as a LEAF or tree_map would
    recurse into the spec itself (``()`` would vanish as an empty node)."""

    def make_shard(spec):
        def shard(x):
            return _shard_leaf(x, spec, mesh)

        return shard

    def make_gather(_spec):
        def gather(x):
            if isinstance(x, torch.Tensor):
                return x.detach().cpu()
            return torch.from_numpy(np.asarray(x))

        return gather

    shard_fns = pytree.tree_map(make_shard, partition_specs, is_leaf=is_spec)
    gather_fns = pytree.tree_map(make_gather, partition_specs, is_leaf=is_spec)
    return shard_fns, gather_fns


def apply_shard_rules(state: Any, rules: Sequence[Tuple[str, Any]], mesh: Any):
    """Place ``state`` onto ``mesh`` per declarative partition rules:
    flatten once, zip leaves with their matched specs (structure-safe
    via flatten_up_to), shard each onto the mesh's device."""
    _, leaves, treedef = tree_paths_and_leaves(state)
    specs = match_partition_rules(rules, state)
    spec_leaves = treedef.flatten_up_to(specs)
    placed = [_shard_leaf(x, s, mesh) for x, s in zip(leaves, spec_leaves)]
    return pytree.unflatten(treedef, placed)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass
class ElasticConfig:
    """Elastic gang shape + state-plane policy.

    The elastic axis is dp ACROSS ranks; ``pp``/``tp`` describe each
    rank's in-process device mesh (``MeshConfig(dp=world/pp/tp...)``
    degenerates to 1 device under tests). World sizes are multiples of
    ``pp * tp``; the gang shrinks to the largest feasible multiple and
    grows back toward ``max_workers`` when capacity returns."""

    min_workers: int = 1
    max_workers: int = 1
    pp: int = 1
    tp: int = 1
    # fixed virtual-shard grid for reshape-invariant collectives; None
    # -> max_workers
    virtual_shards: Optional[int] = None
    # every N steps each rank seals state into the object plane; None ->
    # cfg.elastic_seal_interval_steps
    seal_interval_steps: Optional[int] = None
    # regexes over '/'-joined state paths sealed dp-SHARDED (ZeRO-style:
    # each rank seals only its virtual slices; regather concatenates)
    elastic_shard_rules: Tuple[str, ...] = ()
    # device-level sharding rules per the partition-rule exemplar,
    # applied to restored state over the rank's local mesh
    shard_rules: Tuple[Tuple[str, Any], ...] = ()
    grow: bool = True
    placement_strategy: str = "SPREAD"
    resources_per_worker: Optional[Dict[str, float]] = None
    # how many past seal generations stay alive in the object plane
    keep_generations: int = 2
    # bounded drain after a fence before stragglers are killed
    fence_drain_s: float = 30.0
    # give up if no generation has been placeable for this long
    place_deadline_s: float = 300.0

    def world_for(self, ranks_available: int) -> int:
        cell = max(1, self.pp * self.tp)
        world = (min(ranks_available, self.max_workers) // cell) * cell
        return max(world, 0)


# ---------------------------------------------------------------------------
# gang rendezvous hub (epoch-fenced collective rendezvous + seal registry)
# ---------------------------------------------------------------------------


class _GangHubActor:
    """Asyncio rendezvous for one gang. Every op is stamped with the
    sender's gang epoch; a mismatch returns a ``revoked`` sentinel
    instead of data (stale stragglers rejected like stale control
    RPCs). ``set_epoch`` wakes every parked waiter so survivors break
    out of a dead generation's collective immediately instead of
    waiting out the rendezvous timeout. Doubles as the gang's seal
    registry: ranks note their periodic seal ids here and the driver
    polls the registry into its restore cache."""

    def __init__(self, gang_id: str, epoch: int, world: int):
        import asyncio

        self.gang_id = gang_id
        self.epoch = int(epoch)
        self.world = int(world)
        self.slots: Dict[str, Dict[int, Any]] = {}
        self.events: Dict[str, Any] = {}
        self.remaining: Dict[str, set] = {}
        # rank -> recent [{"step","hex","vidx"}, ...]. A short history,
        # not just the latest: ranks seal asynchronously, so at a fault
        # boundary the newest entries straddle two waves — the driver
        # needs the previous wave too or no single step has coverage.
        self.seals: Dict[int, List[dict]] = {}
        self.seal_history = 4
        # allreduce_shards: op id -> the reduced answer, and the ranks yet
        # to take it
        self.sums: Dict[str, dict] = {}
        self.sum_remaining: Dict[str, set] = {}
        self._asyncio = asyncio

    async def configure(self, epoch: int, world: int) -> int:
        """Driver arms the next generation: bump epoch, reset world and
        rendezvous state, fail every parked waiter of the old epoch."""
        self.epoch = int(epoch)
        self.world = int(world)
        self.slots.clear()
        self.remaining.clear()
        self.sums.clear()
        self.sum_remaining.clear()
        for ev in self.events.values():
            ev.set()
        self.events.clear()
        return self.epoch

    async def set_epoch(self, epoch: int) -> int:
        if int(epoch) > self.epoch:
            self.epoch = int(epoch)
            for ev in self.events.values():
                ev.set()
        return self.epoch

    async def collect(
        self,
        op_id: str,
        epoch: int,
        rank: int,
        value: Any,
        timeout: float = 60.0,
    ):
        if int(epoch) != self.epoch:
            return {"revoked": self.epoch}
        s = self.slots.setdefault(op_id, {})
        s[rank] = value
        ev = self.events.setdefault(op_id, self._asyncio.Event())
        if len(s) == self.world:
            ev.set()
        else:
            try:
                await self._asyncio.wait_for(ev.wait(), timeout)
            except self._asyncio.TimeoutError:
                if not ev.is_set():
                    s.pop(rank, None)
                    if not s:
                        self.slots.pop(op_id, None)
                        self.events.pop(op_id, None)
                        self.remaining.pop(op_id, None)
                    return None
        if int(epoch) != self.epoch:
            # fenced while parked: contributions of the dead epoch are
            # garbage now — never hand out a partial gather
            return {"revoked": self.epoch}
        out = [s[r] for r in range(self.world)]
        rem = self.remaining.setdefault(op_id, set(range(self.world)))
        rem.discard(rank)
        if not rem:
            self.slots.pop(op_id, None)
            self.events.pop(op_id, None)
            self.remaining.pop(op_id, None)
        return out

    async def collect_sum(
        self,
        op_id: str,
        epoch: int,
        rank: int,
        partials: Dict[int, Any],
        timeout: float = 60.0,
    ):
        """``collect`` of every rank's ``{virtual_shard: pytree}``
        partials, answered with ``{"shards": [...], "sum": tree}``: the
        tree-sum over the shards in ascending order, computed once here,
        on the same host values in the same order as a rank would fold
        them, so each rank takes one sum instead of every rank's
        partials."""
        out = await self.collect(op_id, epoch, rank, partials, timeout)
        if out is None or isinstance(out, dict):  # timed out, or revoked
            return out
        res = self.sums.get(op_id)
        if res is None:
            merged: Dict[int, Any] = {}
            for d in out:
                merged.update(d)
            shards = sorted(merged)
            res = self.sums[op_id] = {
                "shards": shards,
                "sum": pytree.tree_map(
                    lambda *xs: _reduce(operator.add, xs),
                    *[merged[v] for v in shards],
                ),
            }
        rem = self.sum_remaining.setdefault(op_id, set(range(self.world)))
        rem.discard(rank)
        if not rem:
            self.sums.pop(op_id, None)
            self.sum_remaining.pop(op_id, None)
        return res

    async def note_seal(
        self, rank: int, step: int, hex_id: str, vidx: List[int], epoch: int
    ) -> None:
        if int(epoch) == self.epoch:
            entries = self.seals.setdefault(int(rank), [])
            entries.append(
                {
                    "step": int(step),
                    "hex": hex_id,
                    "vidx": list(vidx),
                    "epoch": int(epoch),
                }
            )
            del entries[: -self.seal_history]

    async def seal_registry(self) -> Dict[int, List[dict]]:
        return {r: list(es) for r, es in self.seals.items()}


class GangContext:
    """Per-rank view of the gang: epoch-fenced collectives over the
    fixed virtual-shard grid. Any hub transport failure (dead hub
    actor, dead node) is surfaced as ``GangEpochRevoked`` — the caller
    seals its boundary state and hands control back for reshape."""

    def __init__(
        self,
        hub,
        gang_id: str,
        rank: int,
        world: int,
        epoch: int,
        virtual_shards: int,
        timeout_s: Optional[float] = None,
    ):
        self.hub = hub
        self.gang_id = gang_id
        self.rank = int(rank)
        self.world = int(world)
        self.epoch = int(epoch)
        self.virtual_shards = int(virtual_shards)
        self.timeout_s = float(
            cfg.elastic_hub_timeout_s if timeout_s is None else timeout_s
        )
        self._counters: Dict[str, int] = {}

    # -- virtual shards -------------------------------------------------
    def owned_shards(self, step: Optional[int] = None) -> List[int]:
        """Virtual shards this rank owns. Ownership is a pure function
        of (shard, world) so it is stable within a generation and
        repartitions automatically on reshape."""
        return [
            v for v in range(self.virtual_shards) if v % self.world == self.rank
        ]

    # -- fenced rendezvous ---------------------------------------------
    def _op_id(self, op: str) -> str:
        n = self._counters.get(op, 0)
        self._counters[op] = n + 1
        return f"{op}:{n}"

    def _head_fenced(self) -> bool:
        """Whether the head's gang table is past this rank's epoch. In a
        cluster the head is the epoch authority: it bumps the epoch the
        moment a member's node is declared dead, while the hub hears of
        it only from the driver — and not at all when the hub lived on
        the dead node, whose in-flight calls then never return."""
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        if not getattr(rt, "is_remote", False):
            return False
        try:
            reply = rt.gang_sync(self.gang_id, self.epoch, timeout=0.0)
        except Exception:  # noqa: BLE001 - head blip: keep waiting on the hub
            return False
        return int(reply.get("epoch", 0)) > self.epoch

    def _rendezvous(self, op: str, value: Any, method: str = "collect") -> Any:
        op_id = self._op_id(op)
        try:
            ref = getattr(self.hub, method).remote(
                op_id, self.epoch, self.rank, value, self.timeout_s
            )
            # wait in slices; between slices the head's epoch decides
            # whether the op is already revoked (the reference waits on
            # the hub alone, which wedges a rank whose hub died with its
            # node until the call times out)
            deadline = time.monotonic() + self.timeout_s + 30.0
            while True:
                try:
                    out = ray_tpu_torch.get(ref, timeout=HEAD_CHECK_S)
                    break
                except ray_tpu_torch.GetTimeoutError:
                    if time.monotonic() >= deadline:
                        raise
                if self._head_fenced():
                    raise GangEpochRevoked(
                        f"gang {self.gang_id} op {op_id}: epoch {self.epoch} "
                        "fenced at the head"
                    )
        except GangEpochRevoked:
            raise
        except Exception as exc:  # noqa: BLE001 - hub/node death
            raise GangEpochRevoked(
                f"gang {self.gang_id} op {op_id}: {HUB_UNREACHABLE} ({exc!r})"
            ) from exc
        if out is None:
            raise GangEpochRevoked(
                f"gang {self.gang_id} op {op_id}: rendezvous timed out "
                f"({self.world} ranks expected)"
            )
        if isinstance(out, dict) and "revoked" in out:
            raise GangEpochRevoked(
                f"gang {self.gang_id} op {op_id}: epoch {self.epoch} fenced "
                f"(hub at {out['revoked']})"
            )
        return out

    def allgather(self, value: Any) -> List[Any]:
        return self._rendezvous("allgather", value)

    def barrier(self) -> None:
        self._rendezvous("barrier", None)

    def allreduce_shards(self, partials: Dict[int, Any]) -> Any:
        """Reduce per-virtual-shard pytree partials across the gang.

        Every rank contributes ``{virtual_shard: pytree}`` for the
        shards it owns; every rank receives the tree-sum over ALL
        shards, accumulated in ascending shard order — the summation
        tree is a function of the virtual grid, not of the current
        world size, which is what makes a dp shrink/grow numerically
        invisible. ``operator.add`` is ``np.add`` for numpy leaves and
        ``torch.add`` for tensors. The hub folds once and hands every rank
        the sum (``_GangHubActor.collect_sum``)."""
        out = self._rendezvous("allreduce_shards", partials, method="collect_sum")
        if len(out["shards"]) != self.virtual_shards:
            raise GangEpochRevoked(
                f"gang {self.gang_id}: shard coverage "
                f"{out['shards']} != {self.virtual_shards} virtual shards"
            )
        return out["sum"]


# ---------------------------------------------------------------------------
# state sealing / regather (the object-plane checkpoint-free recovery plane)
# ---------------------------------------------------------------------------

# local-mode fallback: put() refs must outlive the sealing call
_LOCAL_SEAL_REFS: Dict[str, Any] = {}


def _matches_any(path: str, rules: Sequence[str]) -> bool:
    return any(re.search(r, path) is not None for r in rules)


def _host_leaves(leaves: List[Any]) -> List[Any]:
    """Device leaves as host TENSORS (not numpy: numpy has no bf16)."""
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            leaf = leaf.detach().cpu()
        out.append(leaf)
    return out


def _seal_leaves_device() -> bool:
    """Whether seal_rank_state may keep tensor leaves device-resident: the
    device plane then seals each as a device frame (zero-copy export on
    the CPU, chunked D2H pump from a card) instead of the _host_leaves
    bounce."""
    from ray_tpu_torch.cluster import device_plane

    return device_plane.device_plane_enabled()


def _split_sizes(n: int, parts: int) -> List[int]:
    """np.array_split's split sizes, computed without materializing the
    array host-side — the device path MUST cut the exact same
    boundaries as the host path or regather would frankenstein shards
    from mixed-format seal waves."""
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


def seal_rank_state(
    state: Any,
    step: int,
    rank: int,
    world: int,
    virtual_shards: int,
    elastic_shard_rules: Sequence[str] = (),
    owner: str = "",
) -> Tuple[str, List[int]]:
    """Seal this rank's slice of ``state`` at ``step`` into the object
    plane. Returns (hex id, owned virtual-shard indices).

    Leaves whose path matches an elastic shard rule are sealed
    dp-sharded: split into the fixed virtual grid along axis 0, only
    this rank's shards included (ZeRO-style seal — W seals jointly
    cover the leaf exactly once). Everything else is sealed in full by
    every rank (replication comes free and any single survivor can
    restore it)."""
    import cloudpickle

    t0 = time.perf_counter()
    paths, leaves, treedef = tree_paths_and_leaves(state)
    # device plane on: tensor leaves stay device-resident and seal as
    # device frames — no host bounce, no host copy of the payload
    # (shard slices cut on device along the SAME np.array_split
    # boundaries, so mixed host/device seal waves regather identically)
    device_seal = _seal_leaves_device()
    if not device_seal:
        leaves = _host_leaves(leaves)
    owned = [v for v in range(virtual_shards) if v % world == rank]
    full: Dict[int, Any] = {}
    sharded: Dict[int, Dict[int, Any]] = {}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        if isinstance(leaf, np.ndarray) or hasattr(leaf, "shape"):
            arr = leaf
        else:
            arr = np.asarray(leaf)
        shardable = (
            _matches_any(path, elastic_shard_rules)
            and getattr(arr, "ndim", 0) >= 1
            and arr.shape[0] >= virtual_shards
        )
        if shardable:
            if isinstance(arr, torch.Tensor):
                # device-side cuts (host-side after the bounce): each
                # slice is its own frame; a host slice is cloned so the
                # plane-off pickler never writes the whole storage
                sizes = _split_sizes(arr.shape[0], virtual_shards)
                offs = [0]
                for s in sizes:
                    offs.append(offs[-1] + s)
                sharded[i] = {
                    v: (
                        arr[offs[v] : offs[v + 1]]
                        if device_seal
                        else arr[offs[v] : offs[v + 1]].clone()
                    )
                    for v in owned
                }
            else:
                host = (
                    arr
                    if isinstance(arr, np.ndarray)
                    else np.asarray(arr)
                )
                slices = np.array_split(host, virtual_shards, axis=0)
                sharded[i] = {
                    v: np.ascontiguousarray(slices[v]) for v in owned
                }
        else:
            full[i] = leaf
    payload = {
        "step": int(step),
        "rank": int(rank),
        "world": int(world),
        "vshards": int(virtual_shards),
        "paths": paths,
        "treedef": cloudpickle.dumps(treedef),
        "full": full,
        "sharded": sharded,
    }
    from ray_tpu_torch.cluster import worker as worker_mod

    hex_id = worker_mod.seal_local_value(payload, owner=owner)
    if hex_id is None:
        # not inside a cluster worker (local/in-process runtime): plain
        # put; pin the ref so the object outlives this frame
        ref = ray_tpu_torch.put(payload)
        _LOCAL_SEAL_REFS[ref.hex] = ref
        hex_id = ref.hex
    nbytes = sum(
        getattr(x, "nbytes", 0)
        if hasattr(x, "nbytes")
        else getattr(np.asarray(x), "nbytes", 0)
        for x in full.values()
    ) + sum(
        s.nbytes for d in sharded.values() for s in d.values()
    )
    ELASTIC_SEAL_BYTES.inc(nbytes)
    ELASTIC_SEAL_MS.observe((time.perf_counter() - t0) * 1e3)
    return hex_id, owned


def fetch_sealed(
    hex_id: str, timeout: float = 60.0, land: str = "device"
) -> Any:
    """Fetch one sealed state payload: inside a worker the pull lands
    in the local arena (second directory location = replication);
    driver-side it rides the client's located-get (socket plane).
    ``land="device"`` (default) lands device-frame leaves back as
    tensors on the device they were sealed from (one H2D copy straight
    from the arena view for a CUDA leaf) — the regather then
    concatenates on device; ``land="host"`` keeps host views (pure
    replication pulls)."""
    from ray_tpu_torch.cluster import worker as worker_mod

    if getattr(worker_mod, "_CURRENT_WORKER", None) is not None:
        return worker_mod.fetch_into_local_arena(
            hex_id, timeout=timeout, land=land
        )
    from ray_tpu_torch.cluster.device_plane import landing
    from ray_tpu_torch.core.object_store import ObjectRef

    with landing(land):
        return ray_tpu_torch.get(ObjectRef.weak(hex_id), timeout=timeout)


def regather_state(payloads: List[dict]) -> Tuple[Any, int]:
    """Rebuild the full state pytree from sealed payloads (any order,
    any mix of old ranks). Returns (state, step). All payloads must
    come from one seal wave (same step); sharded leaves need full virtual
    coverage across the payload set."""
    import cloudpickle

    if not payloads:
        raise ElasticStateIncomplete("no sealed payloads to regather")
    steps = {int(p["step"]) for p in payloads}
    if len(steps) != 1:
        raise ElasticStateIncomplete(
            f"mixed-step seal set {sorted(steps)}; refuse to frankenstein"
        )
    ref0 = payloads[0]
    vshards = int(ref0["vshards"])
    n_leaves = len(ref0["paths"])
    treedef = cloudpickle.loads(ref0["treedef"])
    leaves: List[Any] = [None] * n_leaves
    for i in range(n_leaves):
        for p in payloads:
            if i in p["full"]:
                leaves[i] = p["full"][i]
                break
        if leaves[i] is not None:
            continue
        pieces: Dict[int, Any] = {}
        for p in payloads:
            pieces.update(p["sharded"].get(i, {}))
        if len(pieces) != vshards:
            raise ElasticStateIncomplete(
                f"leaf {ref0['paths'][i]}: virtual shards "
                f"{sorted(pieces)} of {vshards} available"
            )
        ordered = [pieces[v] for v in range(vshards)]
        if any(isinstance(x, torch.Tensor) for x in ordered):
            # device-landed shards: concatenate ON DEVICE — the only
            # host hop the device plane leaves in the regather is gone.
            # Bit-exact: cat moves raw buffers.
            dev = next(x.device for x in ordered if isinstance(x, torch.Tensor))
            leaves[i] = torch.cat(
                [torch.as_tensor(x, device=dev) for x in ordered], dim=0
            )
        else:
            leaves[i] = np.concatenate(ordered, axis=0)
    return pytree.unflatten(treedef, leaves), int(ref0["step"])


# ---------------------------------------------------------------------------
# rank actor (one elastic worker; rank/world assigned per generation)
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
class _ElasticRank:
    def __init__(self, gang_id: str, experiment_name: str, trial_dir: str):
        self.gang_id = gang_id
        self.experiment_name = experiment_name
        self.trial_dir = trial_dir

    def ping(self) -> bool:
        return True

    def run_generation(self, payload: dict) -> dict:
        """Run the managed step loop for one gang generation.

        Returns ``{"status": "done"|"reshape", "step", "seal"
        {"hex","vidx","step"}, "reports", "world", "rank"}``. Exits with
        "reshape" (after sealing the exact boundary state) the moment a
        collective reports the epoch fenced; the driver regathers and
        re-launches."""
        from concurrent.futures import ThreadPoolExecutor

        rank = int(payload["rank"])
        world = int(payload["world"])
        epoch = int(payload["epoch"])
        vshards = int(payload["virtual_shards"])
        total_steps = int(payload["total_steps"])
        seal_every = int(payload["seal_interval_steps"])
        owner = payload.get("owner", "")
        shard_rules = tuple(payload.get("elastic_shard_rules", ()))
        config = dict(payload.get("config") or {})
        gang = GangContext(
            payload["hub"],
            self.gang_id,
            rank,
            world,
            epoch,
            vshards,
        )
        ctx = TrainContext(
            world_rank=rank,
            world_size=world,
            local_rank=rank,
            experiment_name=self.experiment_name,
            trial_dir=self.trial_dir,
            gang=gang,
        )
        ctx._reports = []
        _set_context(ctx)
        seal_meta: Optional[dict] = None
        boundary_step: Optional[int] = None
        boundary_state: Any = None
        # buddy replication runs OFF the step loop: a pull against a
        # node that just died blocks until its fetch timeout, and a rank
        # wedged there can't reach the collective where the epoch fence
        # would release it — the whole gang would sit out the fetch
        # budget before reshaping
        buddy_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"elastic-buddy-r{rank}"
        )
        buddy_inflight: List[Any] = []

        def _buddy_pull(hex_id: str) -> None:
            if buddy_inflight and not buddy_inflight[0].done():
                return  # previous pull still running: skip, best-effort
            buddy_inflight.clear()
            buddy_inflight.append(
                buddy_pool.submit(
                    lambda: fetch_sealed(hex_id, timeout=30.0)
                )
            )

        def _seal(state, step) -> dict:
            hex_id, vidx = seal_rank_state(
                state,
                step,
                rank,
                world,
                vshards,
                elastic_shard_rules=shard_rules,
                owner=owner,
            )
            return {
                "hex": hex_id,
                "vidx": vidx,
                "step": int(step),
                "epoch": epoch,
            }

        try:
            import cloudpickle

            # fns ship BY VALUE (pipeline-install idiom): a driver-side
            # closure or test-module fn must not require the worker to
            # import the driver's module
            init_fn = cloudpickle.loads(payload["init_fn"])
            step_fn = cloudpickle.loads(payload["step_fn"])
            resume = payload.get("resume")
            if resume:
                payloads = [
                    fetch_sealed(h) for h in resume["seals"]
                ]
                state, step = regather_state(payloads)
                if step != int(resume["step"]):
                    raise ElasticStateIncomplete(
                        f"seal step {step} != resume step {resume['step']}"
                    )
            else:
                state = init_fn(config)
                step = 0
            if payload.get("shard_rules"):
                # device-level placement per the partition-rule exemplar
                from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

                mesh = build_mesh(MeshConfig())  # rank-local mesh
                state = apply_shard_rules(
                    state, payload["shard_rules"], mesh
                )
            boundary_step, boundary_state = step, state
            while step < total_steps:
                state, metrics = step_fn(state, step, gang, config)
                step += 1
                boundary_step, boundary_state = step, state
                with ctx._lock:
                    ctx._reports.append(
                        {"metrics": dict(metrics or {}), "checkpoint": None}
                    )
                if metrics and metrics.get("stop"):
                    # cooperative early finish (continuous-learning
                    # loops have no fixed horizon): the step fn asked to
                    # stop. The decision MUST be identical across ranks
                    # for this step (derive it from per-step-idempotent
                    # shared state), so the whole gang breaks together
                    # and every rank returns "done" at the same step.
                    break
                if (
                    seal_every
                    and step % seal_every == 0
                    and step < total_steps
                ):
                    seal_meta = _seal(state, step)
                    # buddy replication: every rank pulls its left
                    # neighbour's fresh seal into the LOCAL arena, so
                    # each seal gains a second directory location on
                    # (usually) another node before the next fault window
                    peers = gang.allgather(seal_meta)
                    if world > 1 and cfg.elastic_buddy_replicate:
                        buddy = peers[(rank - 1) % world]
                        _buddy_pull(buddy["hex"])
                    try:
                        gang.hub.note_seal.remote(
                            rank,
                            seal_meta["step"],
                            seal_meta["hex"],
                            seal_meta["vidx"],
                            epoch,
                        )
                    except Exception:  # noqa: BLE001 - registry is advisory
                        pass
            final = _seal(state, step)
            return {
                "status": "done",
                "step": step,
                "seal": final,
                "periodic": seal_meta,
                "reports": ctx._reports,
                "rank": rank,
                "world": world,
            }
        except GangEpochRevoked as exc:
            if boundary_state is None:
                # revoked before the first boundary existed (restore-time
                # fence): nothing to seal, the driver re-plans from the
                # same resume set
                raise
            logger.info(
                "gang %s rank %d: epoch %d revoked at step %d (%s)",
                self.gang_id,
                rank,
                epoch,
                boundary_step,
                exc,
            )
            broke = _seal(boundary_state, boundary_step)
            return {
                "status": "reshape",
                "reason": str(exc),
                "step": boundary_step,
                "seal": broke,
                "periodic": seal_meta,
                "reports": ctx._reports,
                "rank": rank,
                "world": world,
            }
        finally:
            buddy_pool.shutdown(wait=False, cancel_futures=True)
            _set_context(None)


# ---------------------------------------------------------------------------
# driver: elastic worker group + trainer
# ---------------------------------------------------------------------------



@dataclass
class _Generation:
    index: int
    world: int
    epoch: int
    pg: Any
    nodes: List[str]
    actors: List[Any]
    refs: List[Any]
    seal_hexes: List[str] = field(default_factory=list)
    # ranks whose node the head declared dead during the generation
    dead_ranks: List[int] = field(default_factory=list)


class ElasticTrainer:
    """Driver for elastic gangs: places a generation through the
    PG/kernel path, registers membership with the head, watches the
    gang epoch, and on any membership change reshapes the mesh to the
    surviving topology, regathers state from the object plane, and
    resumes at the exact boundary step — growing back when capacity
    returns.

    ``init_fn(config) -> state`` builds the step-0 state pytree;
    ``step_fn(state, step, gang, config) -> (state, metrics)`` advances
    one step, using ``gang.allreduce_shards`` /
    ``gang.owned_shards()`` for reshape-invariant data parallelism.
    A truthy ``metrics["stop"]`` requests a cooperative early finish
    (the continuous-learning case — no fixed horizon): every rank of
    the generation must compute the same value for the same step (use
    per-step-idempotent shared state, e.g. the RL trajectory feed's
    ``stop_for_step``), and the gang seals + returns done there."""

    def __init__(
        self,
        init_fn: Callable[[Dict[str, Any]], Any],
        step_fn: Callable[..., Tuple[Any, Dict[str, Any]]],
        *,
        total_steps: int,
        elastic_config: ElasticConfig,
        train_loop_config: Optional[Dict[str, Any]] = None,
        run_config: Optional[RunConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
    ):
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.total_steps = int(total_steps)
        self.elastic = elastic_config
        self.config = dict(train_loop_config or {})
        self.run_config = run_config or RunConfig()
        self.scaling = scaling_config or ScalingConfig(
            num_workers=elastic_config.max_workers
        )
        self.gang_id = f"gang-{uuid.uuid4().hex[:10]}"
        self._lock = threading.Lock()
        self._resize_request: Optional[int] = None
        self._target_world = self.elastic.world_for(
            self.elastic.max_workers
        )
        self._hub = None
        # the node the hub was placed on (None on the local runtime)
        self._hub_node: Optional[str] = None
        self._epoch = 0
        self._generation = 0
        self._progress_step = 0
        # (rank, step, epoch) -> seal entry: accumulated across registry
        # polls so complete waves survive even when ranks seal
        # asynchronously; epoch in the key keeps a replayed step from
        # mixing shards of two generations into one "wave"
        self._seal_cache: Dict[Tuple[int, int, int], dict] = {}
        # node_id -> monotonic time we OBSERVED it die; placements avoid
        # these until the head's own health verdict has certainly landed
        # (a grow right after a kill must not re-place onto the corpse)
        self._recent_dead: Dict[str, float] = {}
        self._old_generations: List[List[str]] = []
        # seals the CURRENT generation resumes from: exempt from the
        # retention window until a newer restore (or completion)
        # supersedes them
        self._resume_hexes: set = set()
        self.disk_restores = 0
        self.reshape_log: List[dict] = []

    # -- public control surface ----------------------------------------
    def request_resize(self, world: int) -> None:
        """Ask the running gang to reshape to ``world`` ranks at its
        next step boundary (fences the epoch; survivors seal + the
        driver re-plans). Thread-safe; callable mid-``fit``."""
        with self._lock:
            self._resize_request = int(world)

    def progress(self) -> dict:
        with self._lock:
            return {
                "step": self._progress_step,
                "generation": self._generation,
                "epoch": self._epoch,
                "world": self._target_world,
            }

    # -- capacity -------------------------------------------------------
    def _worker_res(self) -> Dict[str, float]:
        res = dict(self.elastic.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.scaling.use_tpu:
            res.setdefault("TPU", 1.0)
        return res

    def _placeable_ranks(self, exclude_nodes: Sequence[str] = ()) -> int:
        """Advisory capacity probe (the PG itself rechecks): how many
        worker bundles the currently-advertised free capacity holds.
        Under a STRICT_SPREAD gang the unit is spread-feasible NODES,
        not aggregate CPUs — one big surviving node must read as
        capacity for ONE rank, so the gang shrinks to the surviving
        topology instead of parking on an infeasible aggregate.
        ``exclude_nodes`` lets the grow probe discount nodes already
        hosting ranks (a strict-spread gang can't grow onto its own
        hosts; counting them made every world-1 generation flap)."""
        res = self._worker_res()
        excl = set(exclude_nodes)
        try:
            if self.elastic.placement_strategy == "STRICT_SPREAD":
                hosts = 0
                for n in ray_tpu_torch.nodes():
                    if not n.get("Alive") or n.get("NodeID") in excl:
                        continue
                    avail = n.get("Available") or n.get("Resources") or {}
                    if all(
                        avail.get(k, 0.0) >= v
                        for k, v in res.items()
                        if v > 0
                    ):
                        hosts += 1
                return hosts
            avail = ray_tpu_torch.available_resources()
        except Exception:  # noqa: BLE001
            return 0
        counts = [
            int(avail.get(k, 0.0) // v) for k, v in res.items() if v > 0
        ]
        return min(counts) if counts else 0

    # -- generation lifecycle ------------------------------------------
    def _is_remote(self) -> bool:
        from ray_tpu_torch.core.runtime import get_runtime

        return bool(getattr(get_runtime(), "is_remote", False))

    def _runtime(self):
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime()

    def _avoid_now(self) -> List[str]:
        horizon = max(30.0, 2.0 * float(cfg.health_timeout_s))
        now = time.monotonic()
        self._recent_dead = {
            n: t for n, t in self._recent_dead.items() if now - t < horizon
        }
        return sorted(self._recent_dead)

    def _place(self, world: int, avoid: List[str]):
        from ray_tpu_torch.core.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        res = self._worker_res()
        pg = ray_tpu_torch.placement_group(
            [dict(res)] * world,
            strategy=self.elastic.placement_strategy,
            avoid_nodes=avoid,
        )
        if not pg.wait(timeout_seconds=float(cfg.elastic_place_wait_s)):
            try:
                ray_tpu_torch.remove_placement_group(pg)
            except Exception:  # noqa: BLE001
                pass
            raise TimeoutError(
                f"elastic gang: PG for {world} x {res} not schedulable"
            )
        if self._is_remote():
            nodes = self._runtime().wait_placement_group(pg.id, timeout=30)
        else:
            nodes = [b.node_id or "" for b in pg._state.bundles]
        name = self.run_config.name or self.gang_id
        trial_dir = ""
        actors = [
            _ElasticRank.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=i
                ),
                resources={},
            ).remote(self.gang_id, name, trial_dir)
            for i in range(world)
        ]
        return pg, nodes, actors

    def _register(self, nodes: List[str]) -> int:
        members = {r: n for r, n in enumerate(nodes)}
        if self._is_remote():
            self._epoch = self._runtime().gang_register(
                self.gang_id,
                members,
                min_size=self.elastic.min_workers,
                epoch_floor=self._epoch,
                # elasticity plane: declare the grow-back want
                # and per-rank shape so the unified controller can put
                # this gang's deficit into its demand matrix
                want_world=self.elastic.world_for(
                    self.elastic.max_workers
                ),
                resources_per_rank=self._worker_res(),
                grow=bool(self.elastic.grow),
            )
        else:
            self._epoch += 1
        return self._epoch

    def _ensure_hub(self, epoch: int, world: int, near: Optional[str]):
        """The gang's hub, configured for ``epoch``: the old one while it
        answers and its node was not seen dead, else a new one, placed on
        ``near`` (a node of the new generation) where the runtime can: the
        head places an actor on a dead node until its health verdict lands,
        and a hub there would take the generation's calls down with it."""
        from ray_tpu_torch.core.scheduling_strategies import NodeAffinitySchedulingStrategy

        Hub = ray_tpu_torch.remote(_GangHubActor)
        if self._hub is not None and self._hub_node in self._avoid_now():
            self._kill_quiet(self._hub)
            self._hub = None
        if self._hub is not None:
            try:
                ray_tpu_torch.get(
                    self._hub.configure.remote(epoch, world), timeout=15
                )
                return self._hub
            except Exception:  # noqa: BLE001 - hub died with its node
                self._hub = None
        locate = getattr(self._runtime(), "actor_location", None)
        if near and locate is not None:
            Hub = Hub.options(scheduling_strategy=NodeAffinitySchedulingStrategy(near, soft=True))
        self._hub = Hub.remote(self.gang_id, epoch, world)
        ray_tpu_torch.get(self._hub.configure.remote(epoch, world), timeout=60)
        self._hub_node = locate(self._hub._actor_id)[0] if locate else None
        return self._hub

    def _fence(self, reason: str) -> None:
        if self._is_remote():
            try:
                # monotone guard: a failed-over head that lost the
                # (ephemeral) gang table answers 0 — never let that
                # regress the driver epoch, or (rank, step, epoch) seal
                # keys could collide across a failover boundary
                self._epoch = max(
                    self._epoch + 1,
                    self._runtime().gang_fence(
                        self.gang_id, reason=reason
                    ),
                )
            except Exception:  # noqa: BLE001 - head blip; hub fence still lands
                self._epoch += 1
        else:
            self._epoch += 1
        if self._hub is not None:
            try:
                self._hub.set_epoch.remote(self._epoch)
            except Exception:  # noqa: BLE001
                pass

    # -- watch loop -----------------------------------------------------
    def _watch(self, gen: _Generation) -> Tuple[Dict[int, dict], Dict[int, BaseException]]:
        results: Dict[int, dict] = {}
        errors: Dict[int, BaseException] = {}
        ref_rank = {r.hex: i for i, r in enumerate(gen.refs)}
        pending = list(gen.refs)
        fenced_at: Optional[float] = None
        last_grow_probe = 0.0
        killed_dead: set = set()
        # head epoch watcher: ONE long-poll rides the head's GangSync
        # cond-wait (returns at RPC latency after any bump) instead of
        # hammering the head with zero-timeout polls every loop pass
        sync_box: Dict[str, Any] = {}
        sync_stop = threading.Event()

        def _sync_loop() -> None:
            seen_epoch = gen.epoch
            dead: set = set()
            while not sync_stop.is_set():
                try:
                    reply = self._runtime().gang_sync(
                        self.gang_id,
                        seen_epoch,
                        timeout=float(cfg.gang_sync_max_wait_s),
                    )
                except Exception:  # noqa: BLE001 - head blip
                    sync_stop.wait(0.5)
                    continue
                if reply.get("epoch", 0) > seen_epoch:
                    # keep polling past the first bump: a SECOND node
                    # death during the drain window bumps again and
                    # names more dead ranks — without a live watcher
                    # those corpses would sit out the whole
                    # fence_drain_s budget. Dead ranks accumulate so a
                    # bump the watch loop hasn't consumed yet is never
                    # overwritten away.
                    seen_epoch = reply["epoch"]
                    dead.update(int(r) for r in reply.get("dead_ranks", ()))
                    sync_box["reply"] = dict(
                        reply, dead_ranks=sorted(dead)
                    )
                    continue
                if not reply.get("epoch"):
                    # unknown gang (head failed over and lost the
                    # ephemeral table): replies come back instantly, so
                    # pace the loop instead of hammering the recovering
                    # head; the next generation re-registers
                    sync_stop.wait(2.0)

        if self._is_remote():
            threading.Thread(
                target=_sync_loop, daemon=True, name="gang-sync"
            ).start()
        while pending:
            done, pending = ray_tpu_torch.wait(
                pending, num_returns=len(pending), timeout=0.5
            )
            for ref in done:
                rank = ref_rank[ref.hex]
                try:
                    results[rank] = ray_tpu_torch.get(ref, timeout=30)
                    logger.debug(
                        "gang %s: rank %d returned %s at step %s %s",
                        self.gang_id,
                        rank,
                        results[rank].get("status"),
                        results[rank].get("step"),
                        results[rank].get("reason", ""),
                    )
                except Exception as exc:  # noqa: BLE001 - rank died
                    logger.debug(
                        "gang %s: rank %d ref failed: %r",
                        self.gang_id,
                        rank,
                        exc,
                    )
                    errors[rank] = exc
            broke = bool(errors) or any(
                r.get("status") == "reshape" for r in results.values()
            )
            # head is the epoch authority: mirror bumps into the hub so
            # survivors break at their next collective
            if self._is_remote():
                try:
                    reply = sync_box.get("reply")
                    if (
                        reply is not None
                        and reply["epoch"] > gen.epoch
                        and self._hub is not None
                    ):
                        self._epoch = max(self._epoch, reply["epoch"])
                        self._hub.set_epoch.remote(reply["epoch"])
                        if fenced_at is None:
                            logger.debug(
                                "gang %s: head epoch %d > %d "
                                "(dead ranks %s); hub fenced",
                                self.gang_id,
                                reply["epoch"],
                                gen.epoch,
                                reply.get("dead_ranks"),
                            )
                        fenced_at = fenced_at or time.monotonic()
                        # the head named the dead ranks: kill their
                        # actors NOW so the pending run_generation refs
                        # fail fast (a SIGKILLed node's in-flight direct
                        # call otherwise sits out the whole drain budget
                        # waiting for a result push that can never come)
                        for r in reply.get("dead_ranks", ()):  # noqa: B007
                            r = int(r)
                            if (
                                r < len(gen.actors)
                                and r not in killed_dead
                                and r not in results
                                and r not in errors
                            ):
                                killed_dead.add(r)
                                self._kill_quiet(gen.actors[r])
                except Exception:  # noqa: BLE001 - head blip
                    pass
            # seal-registry cache for restore (survives hub death)
            if self._hub is not None and pending:
                try:
                    reg = ray_tpu_torch.get(
                        self._hub.seal_registry.remote(), timeout=10
                    )
                    dropped: List[str] = []
                    with self._lock:
                        for r, entries in reg.items():
                            for e in entries:
                                self._seal_cache[
                                    (
                                        int(r),
                                        int(e["step"]),
                                        int(e.get("epoch", -1)),
                                    )
                                ] = e
                        if self._seal_cache:
                            self._progress_step = max(
                                self._progress_step,
                                max(
                                    s for _, s, _ in self._seal_cache
                                ),
                            )
                            # bounded: keep the newest few steps only;
                            # waves falling off the window retire, so a
                            # long run's periodic seals don't pin the
                            # arenas forever
                            keep = set(
                                sorted(
                                    {s for _, s, _ in self._seal_cache},
                                    reverse=True,
                                )[:8]
                            )
                            dropped = [
                                v["hex"]
                                for k, v in self._seal_cache.items()
                                if k[1] not in keep
                            ]
                            self._seal_cache = {
                                k: v
                                for k, v in self._seal_cache.items()
                                if k[1] in keep
                            }
                    if dropped:
                        self._retire_seals(dropped)
                except Exception:  # noqa: BLE001
                    pass
            # resize requests + grow-back probe fence the gang
            with self._lock:
                resize = self._resize_request
            if resize is not None and not broke and fenced_at is None:
                self._target_world = self.elastic.world_for(resize)
                self._fence("resize")
                fenced_at = time.monotonic()
                with self._lock:
                    self._resize_request = None
            now = time.monotonic()
            if (
                cfg.elastic_controller
                and self._is_remote()
                and not broke
                and fenced_at is None
                and now - last_grow_probe >= float(cfg.elastic_grow_poll_s)
            ):
                # unified elasticity plane: the controller's
                # solver verdict replaces the local capacity probe —
                # grow when it says more ranks are placeable, CEDE when
                # serve pressure outbid this gang for its nodes (a
                # graceful reshape to the hinted world: seals + refit,
                # no attempts burned, no disk restore). hint=None means
                # no verdict yet: fall through to the legacy probe so
                # the gang never stalls on a cold controller.
                last_grow_probe = now
                hint = None
                try:
                    reply = self._runtime().gang_hint(self.gang_id)
                    hint = reply.get("world_hint")
                except Exception:  # noqa: BLE001 - head blip
                    hint = None
                if hint is not None:
                    hinted = self.elastic.world_for(
                        max(int(hint), self.elastic.min_workers)
                    )
                    if hinted > gen.world and self.elastic.grow:
                        self._target_world = hinted
                        self._fence("grow")
                        fenced_at = time.monotonic()
                    elif hinted < gen.world:
                        self._target_world = hinted
                        self._fence("cede")
                        fenced_at = time.monotonic()
                else:
                    last_grow_probe = 0.0  # legacy probe may run now
            if (
                self.elastic.grow
                and not broke
                and fenced_at is None
                and gen.world < self.elastic.world_for(self.elastic.max_workers)
                and now - last_grow_probe >= float(cfg.elastic_grow_poll_s)
            ):
                last_grow_probe = now
                grown = self.elastic.world_for(
                    gen.world
                    + self._placeable_ranks(
                        exclude_nodes=list(gen.nodes) + self._avoid_now()
                    )
                )
                if grown > gen.world:
                    self._target_world = grown
                    self._fence("grow")
                    fenced_at = time.monotonic()
            if broke and fenced_at is None:
                # rank-level break the head can't see (actor kill /
                # rendezvous timeout): fence so survivors stop waiting
                # on the corpse
                self._fence("break")
                fenced_at = time.monotonic()
            if (
                fenced_at is not None
                and pending
                and time.monotonic() - fenced_at
                > float(self.elastic.fence_drain_s)
            ):
                # a straggler wedged in user code past the drain budget:
                # kill it; its ref resolves to ActorDied next pass
                for ref in pending:
                    try:
                        ray_tpu_torch.kill(gen.actors[ref_rank[ref.hex]])
                    except Exception:  # noqa: BLE001
                        pass
                fenced_at = time.monotonic()  # one more drain window
        sync_stop.set()
        if self._is_remote():
            # the head's verdict on this generation's nodes as of now: a
            # rank on a node it declared dead may still have answered
            try:
                reply = self._runtime().gang_sync(self.gang_id, gen.epoch, timeout=0.0)
                if int(reply.get("epoch", 0)) > gen.epoch:
                    gen.dead_ranks = [int(r) for r in reply.get("dead_ranks", ())]
            except Exception:  # noqa: BLE001 - head blip: the errors still name the dead
                pass
        return results, errors

    # -- restore selection ---------------------------------------------
    def _coverage_ok(self, entries: List[dict]) -> bool:
        """Do these seals jointly cover the virtual grid? (metadata
        only; sharded leaves need every vidx, replicated need any)"""
        vshards = self.elastic.virtual_shards or self.elastic.max_workers
        if not entries:
            return False
        if not self.elastic.elastic_shard_rules:
            return True
        covered = set()
        for e in entries:
            covered.update(e.get("vidx") or ())
        return covered >= set(range(vshards))

    def _live_hexes(self, hexes: List[str]) -> List[str]:
        """Filter to seals with a copy left: one in an arena on a node not
        seen dead, or a value small enough for the head to hold inline.
        The directory keeps answering a lost seal's size (the reference
        counts that as live, and re-picks a wave whose only copy died
        with its node forever), and keeps a dead node's location until
        the head's own verdict lands."""
        if not self._is_remote():
            return [h for h in hexes if h in _LOCAL_SEAL_REFS]
        from ray_tpu_torch.core.object_store import ObjectRef

        sizes = self._runtime().object_sizes(
            [ObjectRef.weak(h) for h in hexes]
        )
        locs = self._runtime().object_locations(
            [ObjectRef.weak(h) for h in hexes]
        )
        dead = set(self._recent_dead)
        inline_max = int(cfg.inline_object_max)

        def live(h: str) -> bool:
            # a seal small enough to be held inline lives at the head, and
            # its sealing node stays in its locations after that node dies
            # (Queue C 18): its size decides before its locations do
            if 0 < sizes.get(h, 0) <= inline_max:
                return True
            return any(n not in dead for n in locs.get(h, ()))

        return [h for h in hexes if live(h)]

    def _pick_restore(
        self,
        results: Dict[int, dict],
    ) -> Tuple[Optional[dict], List[str]]:
        """Choose the freshest consistent seal set. Preference order:
        break-time boundary seals (exact step) -> last periodic seal
        wave (object plane) -> disk checkpoint (counted; the chaos gate
        asserts it never happens)."""
        by_step: Dict[int, List[dict]] = {}
        for r in results.values():
            if r.get("seal"):
                by_step.setdefault(int(r["step"]), []).append(r["seal"])
        for step in sorted(by_step, reverse=True):
            entries = by_step[step]
            hexes = self._live_hexes([e["hex"] for e in entries])
            entries = [e for e in entries if e["hex"] in hexes]
            if entries and self._coverage_ok(entries):
                return (
                    {"step": step, "seals": self._restore_hexes(entries)},
                    [e["hex"] for e in entries],
                )
        # periodic wave: driver-side registry cache (+ what survivors
        # reported); all seals of a wave share one (step, epoch) — a
        # replayed step number from a LATER generation must never mix
        # with the pre-replay generation's shards
        with self._lock:
            cache = list(self._seal_cache.values())
        for r in results.values():
            if r.get("periodic"):
                cache.append(r["periodic"])
        waves: Dict[Tuple[int, int], Dict[str, dict]] = {}
        for e in cache:
            key = (int(e["step"]), int(e.get("epoch", -1)))
            waves.setdefault(key, {})[e["hex"]] = e
        for step, _epoch in sorted(waves, reverse=True):
            entries = list(waves[(step, _epoch)].values())
            hexes = self._live_hexes([e["hex"] for e in entries])
            entries = [e for e in entries if e["hex"] in hexes]
            if entries and self._coverage_ok(entries):
                return (
                    {"step": step, "seals": self._restore_hexes(entries)},
                    [e["hex"] for e in entries],
                )
        return None, []

    def _restore_hexes(self, entries: List[dict]) -> List[str]:
        # fully-replicated state: one seal restores everything; sharded
        # state needs the whole set
        if not self.elastic.elastic_shard_rules:
            return [entries[0]["hex"]]
        return [e["hex"] for e in entries]

    # -- cleanup --------------------------------------------------------
    def _teardown_generation(self, actors: List[Any], pg: Any) -> None:
        from .trainer import kill_actors_bounded

        kill_actors_bounded(actors, 10.0)
        try:
            ray_tpu_torch.remove_placement_group(pg)
        except Exception:  # noqa: BLE001 - head blip; expiry sweep covers
            pass

    @staticmethod
    def _kill_quiet(actor) -> None:
        try:
            ray_tpu_torch.kill(actor)
        except Exception:  # noqa: BLE001
            pass

    def _retire_seals(self, hexes: List[str]) -> None:
        """Keep ``keep_generations`` seal waves; free older ones.

        Two guards keep the retention window from eating the only
        restorable state: a re-picked wave (consecutive failed
        generations restoring from the same seals) MOVES to the newest
        slot instead of duplicating until it marches itself off the
        window, and a wave the current generation is actively resuming
        from (``_resume_hexes``) is never freed, however old."""
        if hexes:
            wave = list(hexes)
            self._old_generations = [
                w for w in self._old_generations if set(w) != set(wave)
            ]
            self._old_generations.append(wave)
        keep = max(1, int(self.elastic.keep_generations))
        idx = 0
        while len(self._old_generations) - idx > keep:
            if self._resume_hexes & set(self._old_generations[idx]):
                idx += 1
                continue
            dead = self._old_generations.pop(idx)
            if self._is_remote():
                try:
                    self._runtime().free_objects(dead)
                except Exception:  # noqa: BLE001
                    pass
            else:
                for h in dead:
                    _LOCAL_SEAL_REFS.pop(h, None)

    def _disk_restore(self) -> Tuple[Optional[dict], List[str]]:
        """Last resort: object plane has no coverage (e.g. every seal
        holder died simultaneously). Counted — the chaos acceptance
        gate asserts this stays at zero. The checkpoint's state is
        re-sealed as an ordinary full payload so the rank-side restore
        path stays uniform."""
        import os

        name = self.run_config.name or self.gang_id
        storage = self.run_config.storage_path
        if not storage:
            return None, []
        trial_dir = os.path.join(storage, name)
        from .trainer import TorchTrainer

        path = TorchTrainer._latest_checkpoint_path(trial_dir)
        if path is None:
            return None, []
        ELASTIC_DISK_RESTORES.inc()
        self.disk_restores += 1
        blob = Checkpoint(path).load_state()
        step = int(blob.get("elastic_step", 0))
        vshards = self.elastic.virtual_shards or self.elastic.max_workers
        hex_id, _ = seal_rank_state(
            blob["state"], step, 0, 1, vshards, elastic_shard_rules=()
        )
        return {"step": step, "seals": [hex_id]}, [hex_id]

    # -- the main loop --------------------------------------------------
    def fit(self) -> Result:
        import cloudpickle

        owner = ""
        if self._is_remote():
            owner = getattr(self._runtime(), "client_id", "")
        vshards = self.elastic.virtual_shards or self.elastic.max_workers
        seal_every = (
            self.elastic.seal_interval_steps
            if self.elastic.seal_interval_steps is not None
            else int(cfg.elastic_seal_interval_steps)
        )
        resume: Optional[dict] = None
        all_reports: List[Dict[str, Any]] = []
        backoff = 0.2
        place_start: Optional[float] = None
        error: Optional[BaseException] = None
        final_state_seal: List[str] = []
        while True:
            world = self._target_world
            if world < max(1, self.elastic.min_workers):
                raise RuntimeError(
                    f"elastic gang below min_workers "
                    f"({world} < {self.elastic.min_workers})"
                )
            t_place = time.monotonic()
            t_place_wall = time.time()
            try:
                pg, nodes, actors = self._place(world, self._avoid_now())
            except TimeoutError:
                # unschedulable right now (mid-backfill): shrink toward
                # what fits, or park with backoff up to the deadline
                if place_start is None:
                    place_start = time.monotonic()
                elif (
                    time.monotonic() - place_start
                    > float(self.elastic.place_deadline_s)
                ):
                    error = RuntimeError(
                        f"elastic gang unplaceable for "
                        f"{self.elastic.place_deadline_s}s at world={world}"
                    )
                    break
                placeable = self.elastic.world_for(
                    self._placeable_ranks(exclude_nodes=self._avoid_now())
                )
                if placeable >= max(1, self.elastic.min_workers):
                    self._target_world = placeable
                else:
                    time.sleep(backoff)
                    backoff = min(5.0, backoff * 1.7)
                continue
            backoff = 0.2
            place_start = None
            # reshape-phase span: one slice per placement in
            # the Chrome-trace export, beside the generation slices
            SPANS.record(
                "elastic_place",
                "elastic",
                t_place_wall,
                time.monotonic() - t_place,
                pid=f"gang:{self.gang_id[:8]}",
                world=world,
                generation=self._generation,
            )
            try:
                epoch = self._register(nodes)
                hub = self._ensure_hub(epoch, world, nodes[0] if nodes else None)
                start_step = resume["step"] if resume else 0
                payload_base = {
                    "world": world,
                    "epoch": epoch,
                    "virtual_shards": vshards,
                    "total_steps": self.total_steps,
                    "seal_interval_steps": seal_every,
                    "owner": owner,
                    "elastic_shard_rules": list(
                        self.elastic.elastic_shard_rules
                    ),
                    "shard_rules": list(self.elastic.shard_rules),
                    "config": self.config,
                    "hub": hub,
                    "init_fn": cloudpickle.dumps(self.init_fn),
                    "step_fn": cloudpickle.dumps(self.step_fn),
                    "resume": resume,
                }
                refs = [
                    a.run_generation.remote(dict(payload_base, rank=r))
                    for r, a in enumerate(actors)
                ]
                gen = _Generation(
                    index=self._generation,
                    world=world,
                    epoch=epoch,
                    pg=pg,
                    nodes=nodes,
                    actors=actors,
                    refs=refs,
                )
                logger.info(
                    "gang %s gen %d: world=%d epoch=%d nodes=%s start=%d",
                    self.gang_id,
                    gen.index,
                    world,
                    epoch,
                    nodes,
                    start_step,
                )
                t_watch = time.monotonic()
                t_watch_wall = time.time()
                results, errors = self._watch(gen)
            except BaseException:
                # a failure between placement and drain (head blip
                # mid-register, hub spawn death, transport error on
                # submit) must not leak the bundle reservation or the
                # world's actors: a caller that catches and re-runs
                # fit() would find the capacity still consumed and the
                # gang unplaceable
                self._teardown_generation(actors, pg)
                raise
            t_drain = time.monotonic()
            self._teardown_generation(gen.actors, gen.pg)
            SPANS.record(
                "elastic_generation",
                "elastic",
                t_watch_wall,
                t_drain - t_watch,
                pid=f"gang:{self.gang_id[:8]}",
                generation=gen.index,
                world=world,
                epoch=gen.epoch,
            )
            logger.info(
                "gang %s gen %d: drained in %.2fs, teardown %.2fs "
                "(%d results, %d errors)",
                self.gang_id,
                gen.index,
                t_drain - t_watch,
                time.monotonic() - t_drain,
                len(results),
                len(errors),
            )
            done = [
                r for r in results.values() if r.get("status") == "done"
            ]
            # rank 0's reports are authoritative, but when rank 0 died
            # with its node (or broke a step earlier than a peer) a
            # survivor's are the next best thing — a hole in the metric
            # stream is worse than a neighbour's view of the same
            # shared-state step. Ranks skew at most one collective, so
            # take the longest stream, rank 0 winning ties.
            rep_src = min(
                results.items(),
                key=lambda kv: (-len(kv[1].get("reports") or ()), kv[0]),
                default=(None, None),
            )[1]
            if rep_src and rep_src.get("reports"):
                all_reports.extend(rep_src["reports"])
            with self._lock:
                self._progress_step = max(
                    self._progress_step,
                    max(
                        (int(r["step"]) for r in results.values()),
                        default=self._progress_step,
                    ),
                )
            if len(done) == world and not errors:
                final_wave = sorted(
                    (r["rank"], r["seal"]["hex"]) for r in done
                )
                final_state_seal = [h for _, h in final_wave]
                self._resume_hexes = set()
                self._retire_seals(list(final_state_seal))
                break
            # ---- reshape path ----
            t_reshape = time.monotonic()
            t_reshape_wall = time.time()
            # a rank the head named dead may still have answered: its
            # node's agent is gone, but a worker can outlive it for a
            # while, and the seals it made there are out of reach
            dead_nodes = sorted(
                {
                    nodes[r]
                    for r in set(errors) | set(gen.dead_ranks)
                    if r < len(nodes) and nodes[r]
                }
            )
            for n in dead_nodes:
                self._recent_dead[n] = time.monotonic()
            if self._hub_node and any(
                HUB_UNREACHABLE in str(r.get("reason", ""))
                for r in results.values()
            ):
                # the hub died: count its node as dead until the head's
                # verdict lands. Killing a node is not atomic, so a rank
                # beside the hub can still answer "reshape" (its hub
                # unreachable) before its own process goes; with no
                # error to name the node, the restore trusted seals held
                # only there and the next placement counted it live
                self._recent_dead[self._hub_node] = time.monotonic()
            resume, used_hexes = self._pick_restore(results)
            if resume is None:
                resume, used_hexes = self._disk_restore()
            if resume is None:
                error = RuntimeError(
                    f"gang {self.gang_id}: no restorable state "
                    f"(errors={ {r: repr(e) for r, e in errors.items()} })"
                )
                break
            self._resume_hexes = set(used_hexes)
            # the restore point can sit BELOW steps already reported
            # (e.g. a dead rank's boundary shards only exist in an older
            # periodic wave): those steps replay, so drop their reports
            # — exactly one report per step survives (all_reports[i] is
            # step i's report)
            del all_reports[int(resume["step"]):]
            # the old generation is torn down, so advertised free
            # capacity IS the whole surviving topology: reshape to what
            # fits now (the watch loop grows back toward max_workers
            # once the autoscaler restores capacity). Nodes we OBSERVED
            # die are excluded explicitly — survivors usually break
            # faster than the head's health verdict lands, and counting
            # the corpse would call this reshape "flat" and park the
            # next placement against a dead agent
            target = self.elastic.world_for(
                max(self._target_world, self.elastic.min_workers)
            )
            cap = self.elastic.world_for(
                self._placeable_ranks(exclude_nodes=self._avoid_now())
            )
            if not dead_nodes:
                # no rank died: the nodes the old generation held read as
                # busy until their agents report the returned leases, and
                # a grow decided on that view re-forms at the old world on
                # the new node alone ("flat"; the reference decides at once)
                settle = time.monotonic() + RESHAPE_SETTLE_S
                while 0 < cap < target and time.monotonic() < settle:
                    time.sleep(0.2)
                    cap = self.elastic.world_for(
                        self._placeable_ranks(exclude_nodes=self._avoid_now())
                    )
            next_world = target
            if 0 < cap < target:
                next_world = max(
                    cap,
                    self.elastic.world_for(max(1, self.elastic.min_workers)),
                )
            if next_world < 1:
                next_world = self.elastic.world_for(
                    max(1, self.elastic.min_workers)
                )
            direction = (
                "grow"
                if next_world > world
                else ("shrink" if next_world < world else "flat")
            )
            self._target_world = next_world
            ELASTIC_RESHAPES.inc(labels={"direction": direction})
            SPANS.record(
                "elastic_reshape",
                "elastic",
                t_reshape_wall,
                time.monotonic() - t_reshape,
                pid=f"gang:{self.gang_id[:8]}",
                direction=direction,
                from_world=world,
                to_world=next_world,
                resume_step=int(resume["step"]),
                dead_nodes=len(dead_nodes),
            )
            self.reshape_log.append(
                {
                    "generation": gen.index,
                    "epoch": gen.epoch,
                    "from_world": world,
                    "to_world": next_world,
                    "resume_step": resume["step"],
                    "direction": direction,
                    "dead_nodes": dead_nodes,
                }
            )
            logger.info(
                "gang %s: reshape %s %d -> %d, resume at step %d",
                self.gang_id,
                direction,
                world,
                next_world,
                resume["step"],
            )
            self._retire_seals(used_hexes)
            self._generation += 1
        # ---- final result ----
        if self._hub is not None:
            self._kill_quiet(self._hub)
            self._hub = None
        if self._is_remote():
            try:
                self._runtime().gang_unregister(self.gang_id)
            except Exception:  # noqa: BLE001
                pass
        metrics = dict(all_reports[-1]["metrics"]) if all_reports else {}
        metrics["elastic"] = {
            "generations": self._generation + 1,
            "reshapes": list(self.reshape_log),
            "disk_restores": self.disk_restores,
            "final_world": self._target_world,
        }
        checkpoint = None
        path = ""
        if error is None and self.run_config.storage_path:
            import os

            name = self.run_config.name or self.gang_id
            trial_dir = os.path.join(self.run_config.storage_path, name)
            os.makedirs(trial_dir, exist_ok=True)
            hexes = (
                final_state_seal
                if self.elastic.elastic_shard_rules
                else final_state_seal[:1]
            )
            state, step = regather_state(
                [fetch_sealed(h) for h in hexes]
            )
            checkpoint = Checkpoint.from_state(
                {"state": state, "elastic_step": step},
                os.path.join(trial_dir, f"checkpoint_{step:06d}"),
            )
            path = trial_dir
        return Result(
            metrics=metrics,
            checkpoint=checkpoint,
            path=path,
            error=error,
            metrics_history=[r["metrics"] for r in all_reports],
        )

    def final_state(self) -> Any:
        """Driver-side regather of the last sealed state (object-plane
        fetch over the socket plane; no disk involved)."""
        if not self._old_generations:
            raise RuntimeError("no sealed state (fit() not finished?)")
        hexes = self._old_generations[-1]
        payloads = [fetch_sealed(h) for h in hexes]
        state, _ = regather_state(payloads)
        return state
