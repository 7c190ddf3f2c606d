"""Per-node accelerator instance assignment (chip index bookkeeping).

Port of ``ray_tpu/scheduler/instances.py``, copied.

Analog of the reference's ResourceInstanceSet + TPU accelerator manager
(Ray's src/ray/common/scheduling/resource_instance_set.h,
python/ray/_private/accelerators/tpu.py:38-56): the scheduler's scalar
ledger answers "how many chips are free"; this answers "WHICH chips" so a
granted lease can pin `TPU_VISIBLE_CHIPS` (or `CUDA_VISIBLE_DEVICES`) and
two co-located actors never touch the same silicon.

Semantics (reference parity, resource_instance_set.cc TryAllocate):
- a demand >= 1 must be an integer and takes that many WHOLE free chips;
- a fractional demand (< 1) packs onto a single chip, sharing it with
  other fractional holders (highest-utilization chip that still fits, so
  fractions consolidate instead of fragmenting every chip).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_EPS = 1e-9

# resource name -> env var the worker exports for a granted lease
ACCELERATOR_ENV_VARS = {
    "TPU": "TPU_VISIBLE_CHIPS",
    "GPU": "CUDA_VISIBLE_DEVICES",
}


class AcceleratorInstanceSet:
    """Index-level free list for one accelerator resource on one node."""

    def __init__(self, num_instances: int):
        self.num_instances = int(num_instances)
        # fraction of each chip currently allocated (0.0 = free)
        self._used: List[float] = [0.0] * self.num_instances
        self._lock = threading.Lock()

    def allocate(self, amount: float) -> Optional[List[Tuple[int, float]]]:
        """Returns [(chip_index, fraction)] or None if it doesn't fit."""
        with self._lock:
            if amount >= 1.0 - _EPS:
                n = round(amount)
                if abs(amount - n) > _EPS:
                    return None  # >1 demands must be integers (reference rule)
                free = [i for i, u in enumerate(self._used) if u <= _EPS]
                if len(free) < n:
                    return None
                chosen = free[:n]
                for i in chosen:
                    self._used[i] = 1.0
                return [(i, 1.0) for i in chosen]
            # fractional: pack onto the most-utilized chip that still fits
            best = -1
            for i, u in enumerate(self._used):
                if u + amount <= 1.0 + _EPS and (
                    best < 0 or u > self._used[best]
                ):
                    best = i
            if best < 0:
                return None
            self._used[best] += amount
            return [(best, amount)]

    def release(self, assignment: List[Tuple[int, float]]) -> None:
        with self._lock:
            for i, frac in assignment:
                self._used[i] = max(0.0, self._used[i] - frac)

    def snapshot(self) -> List[float]:
        with self._lock:
            return list(self._used)


class NodeAcceleratorState:
    """All accelerator instance sets for one node + env-var rendering."""

    def __init__(self, resources: Dict[str, float]):
        self.sets: Dict[str, AcceleratorInstanceSet] = {}
        for name in ACCELERATOR_ENV_VARS:
            n = int(resources.get(name, 0))
            if n > 0:
                self.sets[name] = AcceleratorInstanceSet(n)

    def allocate(
        self, demands: Dict[str, float]
    ) -> Optional[Dict[str, List[Tuple[int, float]]]]:
        """Atomically assign chip indices for every accelerator demand in
        the lease; None if any doesn't fit (caller keeps the scalar grant —
        a scalar-feasible integer demand always fits, fragmentation can
        only reject fractional shares)."""
        taken: Dict[str, List[Tuple[int, float]]] = {}
        for name, amount in demands.items():
            s = self.sets.get(name)
            if s is None or amount <= _EPS:
                continue
            got = s.allocate(amount)
            if got is None:
                for n2, a2 in taken.items():
                    self.sets[n2].release(a2)
                return None
            taken[name] = got
        return taken

    def release(self, assignment: Dict[str, List[Tuple[int, float]]]) -> None:
        for name, a in (assignment or {}).items():
            s = self.sets.get(name)
            if s is not None:
                s.release(a)

    @staticmethod
    def env_for(assignment: Dict[str, List[Tuple[int, float]]]) -> Dict[str, str]:
        """Render `TPU_VISIBLE_CHIPS` / `CUDA_VISIBLE_DEVICES` for a lease
        (python/ray/_private/accelerators/tpu.py set_current_process_visible
        analog)."""
        env: Dict[str, str] = {}
        for name, a in (assignment or {}).items():
            var = ACCELERATOR_ENV_VARS.get(name)
            if var and a:
                env[var] = ",".join(str(i) for i, _ in a)
        return env
