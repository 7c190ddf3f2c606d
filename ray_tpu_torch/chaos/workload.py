"""The workload chaos runs against.

Deterministic, verifiable traffic: plain tasks produce payloads larger
than ``inline_object_max`` (so their only copies live in node stores and
faults genuinely threaten them), a named restartable actor absorbs
method calls, and every acked result's expected bytes are recomputable
client-side. "Acked" means a ``get()`` returned the value at least once
— the invariant the orchestrator enforces is that an acked object is
NEVER lost afterwards (lineage rebuilds dropped copies).

Port of ``ray_tpu/chaos/workload.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.chaos.workload")

# generous lineage budget: a soak injects dozens of faults and one object
# may be rebuilt several times — exhausting retries mid-soak would turn a
# liveness check into a false loss signal
TASK_MAX_RETRIES = 50


def expected_payload(i: int, nbytes: int) -> bytes:
    """Deterministic payload: re-executions (lineage rebuilds) re-seal
    byte-identical values under the same object id. Single definition —
    the remote task and the client-side verifier must never drift."""
    return bytes([i % 251]) * nbytes


def _produce(i: int, nbytes: int) -> bytes:
    return expected_payload(i, nbytes)


class ChaosCounter:
    """Restartable actor: state resets on restart by design — chaos
    asserts liveness (ALIVE + responsive within the restart budget), not
    state carry-over."""

    def __init__(self) -> None:
        self.n = 0

    def incr(self) -> int:
        self.n += 1
        return self.n

    def ping(self) -> str:
        return "pong"


class ChaosWorkload:
    def __init__(
        self,
        rt,
        payload_bytes: int = 200_000,
        num_actors: int = 1,
        actor_max_restarts: int = 100,
    ):
        import ray_tpu_torch

        self.rt = rt
        self.payload_bytes = int(payload_bytes)
        self._task = ray_tpu_torch.remote(_produce)
        self._next_i = 0
        # hex -> (ref, task index); acked refs were returned by get() once
        self.acked: Dict[str, Tuple[object, int]] = {}
        self.pending: List[Tuple[object, int]] = []
        self.failed_pending: List[Tuple[str, str]] = []  # (hex, reason)
        self.actors: List[object] = []
        self.actor_ids: List[str] = []
        Actor = ray_tpu_torch.remote(ChaosCounter)
        for k in range(num_actors):
            h = Actor.options(
                name=f"chaos-counter-{k}", max_restarts=actor_max_restarts
            ).remote()
            self.actors.append(h)
            self.actor_ids.append(h._actor_id)
        self.objects_acked = 0
        self.objects_reverified = 0

    # -- traffic -------------------------------------------------------
    def step(self, n_tasks: int = 4) -> None:
        """Submit a batch of producer tasks (results stay pending until
        ``ack``) and poke every actor."""
        for _ in range(n_tasks):
            i = self._next_i
            self._next_i += 1
            ref = self._task.options(
                max_retries=TASK_MAX_RETRIES
            ).remote(i, self.payload_bytes)
            self.pending.append((ref, i))
        for h in self.actors:
            # fire-and-forget liveness traffic; convergence checks do the
            # asserted calls
            h.incr.remote()

    def ack(self, timeout: float = 60.0) -> int:
        """Resolve pending results. Successes become acked; a failure is
        only legal as an exhausted-retry/dead-actor error (recorded, and
        judged by the invariant checker)."""
        import ray_tpu_torch

        still: List[Tuple[object, int]] = []
        n_acked = 0
        deadline = time.monotonic() + timeout
        for ref, i in self.pending:
            budget = max(0.5, deadline - time.monotonic())
            try:
                value = ray_tpu_torch.get(ref, timeout=budget)
            except Exception as exc:  # noqa: BLE001 - judged by invariants
                msg = str(exc)
                if _is_timeout(exc):
                    still.append((ref, i))
                else:
                    self.failed_pending.append((ref.hex, msg))
                continue
            if value != expected_payload(i, self.payload_bytes):
                raise AssertionError(
                    f"task {i} returned corrupted payload "
                    f"({len(value)} bytes)"
                )
            self.acked[ref.hex] = (ref, i)
            self.objects_acked += 1
            n_acked += 1
        self.pending = still
        return n_acked

    # -- invariant probes ---------------------------------------------
    def verify_acked(
        self, sample: int = 8, timeout: float = 60.0
    ) -> List[str]:
        """Re-get the most recent ``sample`` acked objects; returns a list
        of failure descriptions (empty = invariant holds)."""
        import ray_tpu_torch

        failures: List[str] = []
        recent = list(self.acked.values())[-sample:]
        for ref, i in recent:
            try:
                value = ray_tpu_torch.get(ref, timeout=timeout)
            except Exception as exc:  # noqa: BLE001
                failures.append(f"acked object {ref.hex[:8]} lost: {exc!r}")
                continue
            if value != expected_payload(i, self.payload_bytes):
                failures.append(
                    f"acked object {ref.hex[:8]} corrupted "
                    f"({len(value)} bytes)"
                )
            else:
                self.objects_reverified += 1
        return failures

    def verify_ref(self, hex_id: str, timeout: float = 60.0) -> Optional[str]:
        """Re-get ONE acked object by hex; returns a failure description
        or None. The object-drop fault verifies its specific victim with
        this (the sampled sweep may not include it)."""
        import ray_tpu_torch

        entry = self.acked.get(hex_id)
        if entry is None:
            return f"object {hex_id[:8]} is not acked"
        ref, i = entry
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except Exception as exc:  # noqa: BLE001
            return f"dropped object {hex_id[:8]} not rebuilt: {exc!r}"
        if value != expected_payload(i, self.payload_bytes):
            return f"dropped object {hex_id[:8]} rebuilt corrupted"
        self.objects_reverified += 1
        return None

    def sample_acked_ref(self, rng) -> Optional[object]:
        """A random acked ref (the object-drop fault's victim pool)."""
        if not self.acked:
            return None
        key = rng.choice(sorted(self.acked))
        return self.acked[key][0]


def _is_timeout(exc: BaseException) -> bool:
    from ray_tpu_torch.core.object_store import GetTimeoutError

    return isinstance(exc, GetTimeoutError)
