"""State API: programmatic cluster introspection.

Parity with ray.util.state (Ray's python/ray/util/state/api.py):
list_tasks / list_actors / list_objects / list_nodes / list_placement_groups
returning plain dicts, plus summaries. Backed by the runtime's live
structures and the task event buffer (the reference aggregates GCS + raylet
state the same way in dashboard/state_aggregator.py).

Port of ``ray_tpu/util/state.py``, copied with its imports rewritten.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.runtime import get_runtime


def list_tasks(
    *, filters: Optional[List[tuple]] = None, limit: int = 1000
) -> List[Dict[str, Any]]:
    rt = get_runtime()
    out = []
    for task_id, latest in rt.events.task_states().items():
        row = {
            "task_id": task_id,
            "name": latest.name,
            "state": latest.state,
            "node_id": latest.node_id,
        }
        if _match(row, filters):
            out.append(row)
        if len(out) >= limit:
            break
    return out


def list_actors(
    *, filters: Optional[List[tuple]] = None, limit: int = 1000
) -> List[Dict[str, Any]]:
    rt = get_runtime()
    out = []
    for actor_id, st in rt._actors.items():
        row = {
            "actor_id": actor_id,
            "class_name": st.cls.__name__,
            "name": st.name or "",
            "state": (
                "DEAD"
                if st.dead_forever
                else ("ALIVE" if st.alive else "RESTARTING")
            ),
            "node_id": st.node_id or "",
            "num_restarts": st.restarts_used,
        }
        if _match(row, filters):
            out.append(row)
        if len(out) >= limit:
            break
    return out


def _ref_count(hex_id: str) -> int:
    from ray_tpu_torch.core.refcount import TRACKER

    return TRACKER.count(hex_id)


def list_objects(
    *, filters: Optional[List[tuple]] = None, limit: int = 1000
) -> List[Dict[str, Any]]:
    rt = get_runtime()
    out = []
    with rt.store._lock:
        items = list(rt.store._objects.items())
    for hex_id, entry in items[:limit]:
        row = {
            "object_id": hex_id,
            "sealed": entry.event.is_set(),
            "is_error": entry.is_error,
            "reference_count": _ref_count(hex_id),
        }
        if _match(row, filters):
            out.append(row)
    return out


def list_nodes(**kwargs) -> List[Dict[str, Any]]:
    import ray_tpu_torch

    return ray_tpu_torch.nodes()


def list_placement_groups(**kwargs) -> List[Dict[str, Any]]:
    import ray_tpu_torch

    return list(ray_tpu_torch.placement_group_table().values())


def summarize_tasks() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for row in list_tasks(limit=10**9):
        counts[row["state"]] = counts.get(row["state"], 0) + 1
    return counts


def _match(row: dict, filters: Optional[List[tuple]]) -> bool:
    if not filters:
        return True
    for key, op, value in filters:
        have = row.get(key)
        if op == "=" and have != value:
            return False
        if op == "!=" and have == value:
            return False
    return True
