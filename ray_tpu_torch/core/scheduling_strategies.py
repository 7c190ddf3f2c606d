"""Scheduling strategies — API parity with the reference

Port of ``ray_tpu/core/scheduling_strategies.py``, copied.

(/root/reference/python/ray/util/scheduling_strategies.py:17,43,164)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"  # noqa: F821
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Optional[dict] = None
    soft: Optional[dict] = None
