"""Serve pressure → scheduler demand rows (disaggregated serving).

Port of ``ray_tpu/scheduler/serve_demand.py``, copied with its imports
rewritten.

The router fleet's budget reconcile exports per-tenant SERVE pressure —
queued prefill tokens and parked request counts from every admission
shard — and this module converts it into the demand-row form the
existing multi-objective autoscaler kernel (:mod:`.binpack`) consumes.
Capacity then follows serve pressure, not just CPU/TPU counts: a
deployment whose tenants queue prefill tokens faster than its replicas
drain them shows up as unfulfilled demand rows, exactly like a pending
task backlog does, and the resulting ``capacity_hint`` rides the budget
reply back to the fleet where the SLO autoscaler treats it as an
upscale signal.

Synergy-style resource-sensitive shaping (arxiv 2110.06073): demand is
expressed in REPLICA-equivalents — ``tokens_per_replica`` queued prefill
tokens or ``queue_per_replica`` parked requests justify one more
replica-shaped row — with the per-term weighting left to the kernel's
demand sort (complex-first, heavy-first).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def pressure_rollup(reports: Dict[str, dict]) -> Dict[str, dict]:
    """Merge per-router pressure reports into one per-tenant view.
    ``reports`` maps router_id → report row whose ``pressure`` entry is
    ``{tenant: {"waiting": n, "waiting_tokens": t}}`` (shards see
    disjoint tenants by construction of the hash ring, but a mid-
    reconcile handoff can briefly double-report — summing is the
    conservative choice)."""
    out: Dict[str, dict] = {}
    for rep in reports.values():
        for tenant, row in (rep.get("pressure") or {}).items():
            agg = out.setdefault(
                tenant, {"waiting": 0, "waiting_tokens": 0}
            )
            agg["waiting"] += int(row.get("waiting") or 0)
            agg["waiting_tokens"] += int(row.get("waiting_tokens") or 0)
    return out


def pressure_to_demand_rows(
    pressure: Dict[str, dict],
    *,
    tokens_per_replica: float = 4096.0,
    queue_per_replica: float = 8.0,
    cpu_per_replica: float = 1.0,
    max_rows: int = 64,
    width: int = 1,
    cpu_col: int = 0,
) -> Tuple[np.ndarray, List[str]]:
    """Per-tenant serve pressure → dense demand rows ``f32[B, width]``
    (``cpu_per_replica`` CPU-equivalents in column ``cpu_col``, zeros
    elsewhere) plus the tenant each row belongs to. The default
    ``width=1`` keeps the single-axis form for ``capacity_plan``;
    the unified elasticity controller passes the full resource width so
    serve rows solve in the same matrix as gang and task shapes. A
    tenant contributes ``ceil(max(tokens/T, waiting/Q))`` replica-shaped
    rows, capped so one flooding tenant cannot blow up the kernel batch
    (the WFQ weights already bound its actual share)."""
    rows: List[np.ndarray] = []
    owners: List[str] = []
    width = max(1, int(width))
    cpu_col = min(max(0, int(cpu_col)), width - 1)
    shape = np.zeros(width, dtype=np.float32)
    shape[cpu_col] = cpu_per_replica
    for tenant in sorted(pressure):
        row = pressure[tenant]
        tokens = float(row.get("waiting_tokens") or 0)
        waiting = float(row.get("waiting") or 0)
        need = max(
            tokens / max(tokens_per_replica, 1.0),
            waiting / max(queue_per_replica, 1.0),
        )
        n = int(np.ceil(need))
        for _ in range(min(n, max_rows - len(rows))):
            rows.append(shape)
            owners.append(tenant)
        if len(rows) >= max_rows:
            break
    if not rows:
        return np.zeros((0, width), dtype=np.float32), owners
    demands = np.stack(rows).astype(np.float32)
    return demands, owners


def capacity_plan(
    avail_cpu_rows: List[float],
    pressure: Dict[str, dict],
    *,
    tokens_per_replica: float = 4096.0,
    queue_per_replica: float = 8.0,
    cpu_per_replica: float = 1.0,
    max_rows: int = 64,
    device=None,
) -> Optional[dict]:
    """Feed serve demand through the autoscaler's first-fit kernel
    against the cluster's residual CPU rows. Returns the capacity hint
    ``{"replicas_wanted", "replicas_placeable", "unfulfilled",
    "by_tenant"}`` or None when there is no pressure (so callers can
    skip the device work entirely on the idle path)."""
    demands, owners = pressure_to_demand_rows(
        pressure,
        tokens_per_replica=tokens_per_replica,
        queue_per_replica=queue_per_replica,
        cpu_per_replica=cpu_per_replica,
        max_rows=max_rows,
    )
    if demands.shape[0] == 0:
        return None
    avail = np.asarray(
        [[max(0.0, float(c))] for c in avail_cpu_rows], dtype=np.float32
    )
    if avail.shape[0] == 0:
        return {
            "replicas_wanted": int(demands.shape[0]),
            "replicas_placeable": 0,
            "unfulfilled": int(demands.shape[0]),
            "by_tenant": {
                t: owners.count(t) for t in dict.fromkeys(owners)
            },
        }
    from .binpack import bin_pack_residual, sort_demands

    order = sort_demands(demands)
    result = bin_pack_residual(avail, demands[order], device=device)
    node = result.node.cpu().numpy()
    placed = int((node >= 0).sum())
    by_tenant: Dict[str, int] = {}
    for i, slot in zip(order, node):
        if slot >= 0:
            t = owners[int(i)]
            by_tenant[t] = by_tenant.get(t, 0) + 1
    return {
        "replicas_wanted": int(demands.shape[0]),
        "replicas_placeable": placed,
        "unfulfilled": int(demands.shape[0]) - placed,
        "by_tenant": by_tenant,
    }
