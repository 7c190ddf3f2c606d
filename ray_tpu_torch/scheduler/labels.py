"""Node-label selector matching, shared by both runtimes.

Port of ``ray_tpu/scheduler/labels.py``, copied.

Analog of the reference's label-selector semantics
(Ray's src/ray/common/scheduling/label_selector.h,
node_label_scheduling_policy.cc): a selector value may be a string
(equality), a list/tuple/set (in), or None (key exists). ICI-slice
affinity is expressed as labels (e.g. {"slice": "s0"}, util/tpu.py:226-265).
"""
from __future__ import annotations

from typing import Dict, Optional


def match_labels(labels: Dict[str, str], selector: Optional[dict]) -> bool:
    for k, v in (selector or {}).items():
        if v is None:
            if k not in labels:
                return False
        elif isinstance(v, (list, tuple, set)):
            if labels.get(k) not in {str(x) for x in v}:
                return False
        elif labels.get(k) != str(v):
            return False
    return True
