"""Owner-sharded control-plane tables.

The head's object directory and task/peer-link lease tables used to be
monolithic dicts. :class:`ShardedTable` splits one table into N fixed
shards behind a thin routing layer: every key routes to exactly one
shard by a stable hash (ids are minted per owner, so key-hash sharding
partitions the table by owner-affinity without needing the owner in the
key). Two properties fall out of the fixed routing:

- **Horizontal scaling seam** — lookups touch one shard; per-shard
  iteration (``shard_items``) lets future work move shards off-process
  without changing a single call site (the table keeps the full dict
  protocol).
- **Conflict-free WAL replay** — a WAL record that mutates key K only
  ever touches ``shard_of(K)``, so records routed to different shards
  commute: a standby replaying a shipped WAL stream can apply shard
  groups independently (``group_records_by_shard``) and still converge
  to the exact monolithic-replay state (asserted by
  tests/test_head_failover.py routing-equivalence tests).

The head's global lock still serializes mutations today; sharding here
is structural (routing + partitioning), not a locking change.

Port of ``ray_tpu/cluster/shards.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


def shard_of(key: str, num_shards: int) -> int:
    """The ONE routing function: stable across processes and restarts
    (crc32, not Python hash — PYTHONHASHSEED must not re-route a key),
    so the leader, its standbys, and every replay agree on placement."""
    if num_shards <= 1:
        return 0
    if isinstance(key, str):
        key = key.encode()
    return zlib.crc32(key) % num_shards


class ShardedTable:
    """Dict-compatible table split across fixed hash-routed shards."""

    __slots__ = ("_shards", "num_shards")

    def __init__(self, num_shards: int = 8):
        self.num_shards = max(1, int(num_shards))
        self._shards: List[dict] = [{} for _ in range(self.num_shards)]

    # -- routing layer --------------------------------------------------
    def shard_index(self, key: str) -> int:
        return shard_of(key, self.num_shards)

    def shard_for(self, key: str) -> dict:
        return self._shards[shard_of(key, self.num_shards)]

    def shard_items(self, index: int):
        return self._shards[index].items()

    def shard_sizes(self) -> List[int]:
        return [len(s) for s in self._shards]

    # -- dict protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self.shard_for(key)[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.shard_for(key)[key] = value

    def __delitem__(self, key: str) -> None:
        del self.shard_for(key)[key]

    def __contains__(self, key: str) -> bool:
        return key in self.shard_for(key)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def __bool__(self) -> bool:
        return any(self._shards)

    def __iter__(self) -> Iterator[str]:
        for s in self._shards:
            yield from s

    def get(self, key: str, default: Any = None) -> Any:
        return self.shard_for(key).get(key, default)

    def pop(self, key: str, *default) -> Any:
        return self.shard_for(key).pop(key, *default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        return self.shard_for(key).setdefault(key, default)

    def keys(self):
        for s in self._shards:
            yield from s.keys()

    def values(self):
        for s in self._shards:
            yield from s.values()

    def items(self):
        for s in self._shards:
            yield from s.items()

    def clear(self) -> None:
        for s in self._shards:
            s.clear()

    def update(self, other) -> None:
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v

    def as_dict(self) -> dict:
        return {k: v for k, v in self.items()}

    def __eq__(self, other) -> bool:
        if isinstance(other, ShardedTable):
            return self.as_dict() == other.as_dict()
        if isinstance(other, dict):
            return self.as_dict() == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ShardedTable(shards={self.num_shards}, "
            f"sizes={self.shard_sizes()})"
        )


def group_records_by_shard(
    records,
    key_of: Callable[[Tuple[Any, ...]], Optional[str]],
    num_shards: int,
) -> Tuple[Dict[int, list], list]:
    """Partition a WAL record stream for conflict-free replay: records
    whose mutated key routes to different shards commute, so they group
    into independently-applicable per-shard lists (intra-shard order
    preserved — that is the order that matters). Records ``key_of``
    cannot route (cross-table or unknown kinds) land in the ordered
    residue and must apply sequentially."""
    groups: Dict[int, list] = {}
    residue: list = []
    for rec in records:
        key = key_of(rec)
        if key is None:
            residue.append(rec)
        else:
            groups.setdefault(shard_of(key, num_shards), []).append(rec)
    return groups, residue
