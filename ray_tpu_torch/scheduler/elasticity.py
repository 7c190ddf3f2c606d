"""Unified elasticity plane: one on-device demand solve per tick.

Port of ``ray_tpu/scheduler/elasticity.py``, copied with its imports
rewritten.

Three control loops used to size the same cluster
without seeing each other: the autoscaler packed queued task shapes
(:mod:`.binpack`), the serve SLO autoscaler scaled replicas off router
metrics (serve/slo_autoscaler.py), and every elastic gang's driver
polled free capacity for grow-back (train/elastic.py). A mixed fleet
thrashed — serve upscales raced gang grow-backs for the same nodes and
the autoscaler provisioned blind to both.

This module folds all three demand classes into ONE weighted f32 demand
matrix — grounded in Gavel's heterogeneity-aware scheduling (arxiv
2008.09213: one allocation problem over all jobs, policies as weights)
and Tesserae's scalable placement (arxiv 2508.04953: solve placement as
a single batched program, not per-entity loops) — and runs ONE batched
``solve_pack_counts`` solve on the scheduler device per tick against the
current node rows plus simulated-provisionable rows. The solve's output
drives three coordinated actuations:

- **provision / retire** — hypothetical node columns that received
  demand become real ``cluster_utils.add_node`` calls through the
  attached provider; solver-idle nodes past the idle window are drained
  and retired through the agent lifecycle.
- **serve capacity hints** — per-deployment solver verdicts replace the
  one-shot ``capacity_plan`` hint in the budget reply (same dict
  shape, now consistent with what gangs and tasks were granted).
- **drain-ahead migration** — low-priority leased work on a node
  selected for retirement is migrated off via the preemption
  machinery (queued → requeue, running retryable → kill-and-requeue
  with no attempt burned) BEFORE the drain deadline, instead of dying
  with the node.

Demand classes and priority. Each class carries a weight knob
(``elastic_w_serve`` / ``elastic_w_gang`` / ``elastic_w_task``); rows
are ordered weight-descending before the solve and the kernel's exact
waterfall extraction admits them in order, so a higher-weighted class
holds first claim on every node's capacity. With the default weights
serve pressure outranks gang grow-back, which outranks queued batch
work — which is exactly the diurnal mixed-fleet story: the gang absorbs
the serve trough (gang rows place once serve rows stop consuming
capacity) and cedes the peak (gang rows lose the waterfall to serve
rows; the per-gang ``world_hint`` shrinks and the driver resizes).

Fallback matrix (COMPONENTS.md "Elasticity plane"):

- solver raises → exact first-fit ``bin_pack_residual`` on the same
  matrix (flagged in the tick stats);
- no provider attached → hint actuations only (external drains still
  migrate through ``Cluster.drain_node``);
- ``RAY_TPU_ELASTIC_CONTROLLER=0`` (default) → this module is inert and
  the three legacy loops run untouched, bit-for-bit.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.config import cfg
from ray_tpu_torch.util.metrics import Counter as _MetricCounter
from ray_tpu_torch.util.metrics import Gauge as _MetricGauge

logger = logging.getLogger(__name__)

# demand classes, by descending default priority
CLASS_SERVE = 0
CLASS_GANG = 1
CLASS_TASK = 2
CLASS_NAMES = {CLASS_SERVE: "serve", CLASS_GANG: "gang", CLASS_TASK: "task"}

ELASTIC_TICKS = _MetricCounter(
    "elastic_controller_ticks_total",
    "Unified elasticity controller ticks, by solve path.",
    label_names=("path",),
)
ELASTIC_TICK_MS = _MetricGauge(
    "elastic_controller_tick_ms",
    "Wall-clock of the last elasticity tick (assemble + solve + plan).",
)
ELASTIC_ACTUATIONS = _MetricCounter(
    "elastic_controller_actuations_total",
    "Elasticity actuations emitted, by kind.",
    label_names=("kind",),
)
ELASTIC_DEMAND_ROWS = _MetricGauge(
    "elastic_demand_rows",
    "Demand rows in the last unified solve, by class.",
    label_names=("cls",),
)


# ---------------------------------------------------------------------------
# parked-demand dedupe
# ---------------------------------------------------------------------------
def dedupe_task_shapes(
    parked: Dict[tuple, int],
    deferred: Dict[tuple, int],
    ring_keys: Sequence[tuple] = (),
) -> Dict[tuple, int]:
    """Merge parked and deferred task demand by shape key.

    A shape that is both ring-parked and sitting in a dispatched-but-
    unread pipelined round (``_deferred_rounds``) is the SAME logical
    backlog seen from two bookkeeping tables — the ring slot pins the
    shape on device while its specs ride the retry pipeline. Summing the
    two sources counted that backlog twice and inflated the solver's
    provision target. For ring-resident shapes the merged demand is
    ``max(parked, deferred)``; shapes the ring does not pin are genuinely
    disjoint queues and still sum.
    """
    ring = set(ring_keys)
    out: Dict[tuple, int] = {}
    for key in set(parked) | set(deferred):
        p = int(parked.get(key, 0))
        d = int(deferred.get(key, 0))
        out[key] = max(p, d) if key in ring else p + d
    return {k: v for k, v in out.items() if v > 0}


# ---------------------------------------------------------------------------
# demand matrix
# ---------------------------------------------------------------------------
@dataclass
class GangWant:
    """One gang's grow-back demand as the head's gang table reports it."""

    gang_id: str
    current: int                 # live members
    want: int                    # target world (driver's max, grow on)
    min_size: int
    row: np.ndarray              # f32[R] resources per rank
    # node_id -> rank count, for crediting current usage back pre-solve
    members_by_node: Dict[str, int] = field(default_factory=dict)

    @property
    def deficit(self) -> int:
        return max(0, int(self.want) - int(self.current))


@dataclass
class ElasticSnapshot:
    """Everything one tick reads, decoupled from the head so the sim
    harness can synthesize 10k-node snapshots without a cluster."""

    width: int                                     # resource axis R
    avail: np.ndarray                              # f32[N,R] residual
    totals: np.ndarray                             # f32[N,R]
    alive: np.ndarray                              # bool[N]
    node_ids: List[str]
    serve_pressure: Dict[str, Dict[str, dict]]     # dep -> tenant -> row
    gang_wants: List[GangWant] = field(default_factory=list)
    task_shapes: Dict[tuple, int] = field(default_factory=dict)
    # node_id -> active lease count (drain-ahead needs to know who still
    # hosts work); absent entries mean idle
    lease_load: Dict[str, int] = field(default_factory=dict)


@dataclass
class DemandMatrix:
    shapes: np.ndarray           # f32[U,R], priority-ordered
    counts: np.ndarray           # f32[U]
    classes: np.ndarray          # int32[U]
    weights: np.ndarray          # f32[U]
    owners: List[tuple]          # per row: ("serve", dep, tenant) |
    #                              ("gang", gang_id) | ("task", shape_key)

    @property
    def rows(self) -> int:
        return int(self.shapes.shape[0])

    def class_counts(self) -> Dict[str, int]:
        out = {name: 0 for name in CLASS_NAMES.values()}
        for c, n in zip(self.classes, self.counts):
            out[CLASS_NAMES[int(c)]] += int(n)
        return out


def class_weights() -> Dict[int, float]:
    return {
        CLASS_SERVE: float(cfg.elastic_w_serve),
        CLASS_GANG: float(cfg.elastic_w_gang),
        CLASS_TASK: float(cfg.elastic_w_task),
    }


def _task_key_row(key: tuple, width: int) -> Optional[np.ndarray]:
    """Dense row for a ``_shape_key_of`` tuple under the head vocabulary
    column order (CPU=0...). Keys name resources by string; the caller
    passes a packer when it has a vocab — this fallback only handles the
    already-dense form used by tests/sim."""
    row = np.zeros(width, dtype=np.float32)
    for name, qty in key:
        if isinstance(name, int):
            col = name
        else:
            return None
        if col >= width:
            return None
        row[col] = float(qty)
    return row


def assemble_demand(
    snap: ElasticSnapshot,
    *,
    weights: Optional[Dict[int, float]] = None,
    pack_key: Optional[Callable[[tuple], Optional[np.ndarray]]] = None,
    max_serve_rows: int = 64,
) -> DemandMatrix:
    """Fold the three demand classes into one priority-ordered matrix.

    Within a class, rows keep the kernel's complex-first/heavy-first
    demand order (``sort_demands``); across classes the configured
    weights order them, so the solve's waterfall extraction hands
    capacity to the highest-weighted class first.
    """
    from ray_tpu_torch.scheduler.serve_demand import pressure_to_demand_rows

    w = weights or class_weights()
    width = snap.width
    shapes: List[np.ndarray] = []
    counts: List[float] = []
    classes: List[int] = []
    owners: List[tuple] = []

    # serve: per-deployment pressure -> replica-shaped rows
    for dep in sorted(snap.serve_pressure):
        rows, tenants = pressure_to_demand_rows(
            snap.serve_pressure[dep],
            max_rows=max_serve_rows,
            width=width,
        )
        # one matrix row per (dep, tenant) shape with a count, not one
        # per replica: the solver consumes (shape, count) pairs
        per_tenant: Dict[str, int] = {}
        for t in tenants:
            per_tenant[t] = per_tenant.get(t, 0) + 1
        for tenant in sorted(per_tenant):
            shapes.append(rows[tenants.index(tenant)])
            counts.append(float(per_tenant[tenant]))
            classes.append(CLASS_SERVE)
            owners.append(("serve", dep, tenant))

    # gang rows carry the FULL want, not the deficit: the solve
    # re-decides every seat each tick (current usage is credited back
    # onto the members' avail rows by credit_gang_usage), so a serve
    # peak outbidding the gang shrinks its verdict BELOW the live world
    # — that is the cede signal the driver fences on
    for gw in snap.gang_wants:
        if gw.want <= 0 or gw.row is None:
            continue
        row = np.zeros(width, dtype=np.float32)
        src = np.asarray(gw.row, dtype=np.float32)
        row[: min(width, src.shape[0])] = src[:width]
        shapes.append(row)
        counts.append(float(gw.want))
        classes.append(CLASS_GANG)
        owners.append(("gang", gw.gang_id))

    # queued/parked/deferred task shapes (already shape-key deduped)
    for key in sorted(snap.task_shapes, key=repr):
        n = snap.task_shapes[key]
        if n <= 0:
            continue
        row = pack_key(key) if pack_key is not None else _task_key_row(key, width)
        if row is None or not (row > 0).any():
            continue
        shapes.append(np.asarray(row[:width], dtype=np.float32))
        counts.append(float(n))
        classes.append(CLASS_TASK)
        owners.append(("task", key))

    if not shapes:
        return DemandMatrix(
            shapes=np.zeros((0, width), dtype=np.float32),
            counts=np.zeros((0,), dtype=np.float32),
            classes=np.zeros((0,), dtype=np.int32),
            weights=np.zeros((0,), dtype=np.float32),
            owners=[],
        )

    mat = np.stack(shapes).astype(np.float32)
    cnt = np.asarray(counts, dtype=np.float32)
    cls = np.asarray(classes, dtype=np.int32)
    wts = np.asarray([w[int(c)] for c in cls], dtype=np.float32)
    # priority order: class weight desc, then complex-first/heavy-first
    # (the binpack demand sort), stable on input order
    complexity = (mat > 0).sum(axis=1)
    heft = mat.sum(axis=1)
    order = np.lexsort(
        (np.arange(len(cnt)), -heft, -complexity, -wts)
    )
    return DemandMatrix(
        shapes=mat[order],
        counts=cnt[order],
        classes=cls[order],
        weights=wts[order],
        owners=[owners[int(i)] for i in order],
    )


def credit_gang_usage(
    avail: np.ndarray,
    node_ids: Sequence[str],
    gang_wants: Sequence[GangWant],
) -> np.ndarray:
    """Copy of ``avail`` with each gang's CURRENT per-rank usage credited
    back onto its members' rows. The demand matrix carries the gang's
    full want (every seat re-decided per tick); without the credit the
    live ranks' own footprint would be double-counted against them and a
    fully-placed gang would read as unplaceable."""
    out = np.asarray(avail, dtype=np.float32).copy()
    if not gang_wants or not out.size:
        return out
    index = {nid: i for i, nid in enumerate(node_ids)}
    for gw in gang_wants:
        if gw.row is None:
            continue
        row = np.asarray(gw.row, dtype=np.float32)[: out.shape[1]]
        for nid, cnt in (gw.members_by_node or {}).items():
            i = index.get(nid)
            if i is not None:
                out[i, : row.shape[0]] += row * float(cnt)
    return out


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------
@dataclass
class SolvedDemand:
    placed: np.ndarray       # f32[U] — total placed per row (real + hypo)
    per_node: np.ndarray     # f32[U, N+H]
    n_real: int
    n_hypo: int
    path: str                # "solve" | "first_fit"

    def placed_real(self, u: int) -> float:
        return float(self.per_node[u, : self.n_real].sum())

    def placed_hypo(self, u: int) -> float:
        return float(self.per_node[u, self.n_real:].sum())


def solve_demand(
    avail: np.ndarray,
    matrix: DemandMatrix,
    *,
    hypo_rows: Optional[np.ndarray] = None,
    iters: Optional[int] = None,
    device=None,
) -> SolvedDemand:
    """One batched device solve of the unified matrix against the real
    node rows plus ``hypo_rows`` simulated-provisionable rows. The
    shape/node axes are bucket-padded (device.py ``elastic_pack_solve``)
    so tick latency stays one cached XLA program across demand churn.
    Falls back to the exact first-fit kernel when the solve raises."""
    n_real = int(avail.shape[0])
    hypo = (
        np.zeros((0, avail.shape[1]), dtype=np.float32)
        if hypo_rows is None
        else np.asarray(hypo_rows, dtype=np.float32)
    )
    n_hypo = int(hypo.shape[0])
    stacked = np.concatenate([avail.astype(np.float32), hypo], axis=0)
    if matrix.rows == 0 or stacked.shape[0] == 0:
        return SolvedDemand(
            placed=np.zeros((matrix.rows,), dtype=np.float32),
            per_node=np.zeros((matrix.rows, stacked.shape[0]), np.float32),
            n_real=n_real,
            n_hypo=n_hypo,
            path="empty",
        )
    it = int(iters if iters is not None else cfg.autoscaler_solve_iters)
    try:
        from ray_tpu_torch.scheduler.device import elastic_pack_solve

        placed, per_node = elastic_pack_solve(
            stacked, matrix.shapes, matrix.counts, iters=it, device=device
        )
        ELASTIC_TICKS.inc(labels={"path": "solve"})
        return SolvedDemand(placed, per_node, n_real, n_hypo, "solve")
    except Exception:  # noqa: BLE001 - fall back to the exact kernel
        logger.exception("elastic solve failed; first-fit fallback")
    from ray_tpu_torch.scheduler.binpack import bin_pack_residual

    # expand (shape, count) -> per-demand rows, first-fit in priority order
    reps = matrix.counts.astype(np.int64)
    demands = np.repeat(matrix.shapes, reps, axis=0)
    result = bin_pack_residual(stacked, demands, device=device)
    node = result.node.cpu().numpy()
    per_node = np.zeros((matrix.rows, stacked.shape[0]), np.float32)
    placed = np.zeros((matrix.rows,), np.float32)
    starts = np.concatenate([[0], np.cumsum(reps)])
    for u in range(matrix.rows):
        rows = node[starts[u]: starts[u + 1]]
        for r in rows:
            if r >= 0:
                per_node[u, int(r)] += 1.0
                placed[u] += 1.0
    ELASTIC_TICKS.inc(labels={"path": "first_fit"})
    return SolvedDemand(placed, per_node, n_real, n_hypo, "first_fit")


# ---------------------------------------------------------------------------
# actuation plan
# ---------------------------------------------------------------------------
@dataclass
class ElasticPlan:
    provision: int                          # nodes to create this tick
    retire: List[str]                       # node_ids to drain + retire
    migrate: List[str]                      # retiring nodes still hosting work
    serve_hints: Dict[str, dict]            # deployment -> capacity hint
    world_hints: Dict[str, int]             # gang_id -> sustainable world
    unfulfilled: Dict[str, int] = field(default_factory=dict)  # per class
    path: str = "solve"
    tick_ms: float = 0.0
    demand_rows: int = 0

    def summary(self) -> dict:
        return {
            "provision": self.provision,
            "retire": list(self.retire),
            "migrate": list(self.migrate),
            "serve_hints": {
                d: dict(h) for d, h in self.serve_hints.items()
            },
            "world_hints": dict(self.world_hints),
            "unfulfilled": dict(self.unfulfilled),
            "path": self.path,
            "tick_ms": round(self.tick_ms, 3),
            "demand_rows": self.demand_rows,
        }


def build_plan(
    snap: ElasticSnapshot,
    matrix: DemandMatrix,
    solved: SolvedDemand,
    *,
    idle_since: Optional[Dict[str, float]] = None,
    now: Optional[float] = None,
    min_nodes: Optional[int] = None,
    idle_retire_s: Optional[float] = None,
    retire_max: Optional[int] = None,
    provision_max: Optional[int] = None,
    device=None,
) -> ElasticPlan:
    """Map one solve to the three actuations. Pure — unit-testable from a
    fixed solve, no cluster required."""
    min_nodes = int(min_nodes if min_nodes is not None else cfg.elastic_min_nodes)
    idle_retire_s = float(
        idle_retire_s if idle_retire_s is not None else cfg.elastic_idle_retire_s
    )
    retire_max = int(retire_max if retire_max is not None else cfg.elastic_retire_max)
    provision_max = int(
        provision_max if provision_max is not None else cfg.elastic_provision_max
    )
    now = time.monotonic() if now is None else now

    serve_hints: Dict[str, dict] = {}
    world_hints: Dict[str, int] = {}
    unfulfilled = {name: 0 for name in CLASS_NAMES.values()}
    hypo_used = 0
    for u, owner in enumerate(matrix.owners):
        want = float(matrix.counts[u])
        real = solved.placed_real(u)
        hypo = solved.placed_hypo(u)
        missing = int(round(max(0.0, want - real - hypo)))
        unfulfilled[CLASS_NAMES[int(matrix.classes[u])]] += missing
        if owner[0] == "serve":
            _, dep, tenant = owner
            hint = serve_hints.setdefault(
                dep,
                {
                    "replicas_wanted": 0,
                    "replicas_placeable": 0,
                    "unfulfilled": 0,
                    "by_tenant": {},
                    "source": "elastic_controller",
                },
            )
            hint["replicas_wanted"] += int(round(want))
            hint["replicas_placeable"] += int(round(real))
            hint["unfulfilled"] += int(round(max(0.0, want - real)))
            if real > 0:
                hint["by_tenant"][tenant] = (
                    hint["by_tenant"].get(tenant, 0) + int(round(real))
                )
        elif owner[0] == "gang":
            gid = owner[1]
            world_hints[gid] = world_hints.get(gid, 0) + int(round(real))

    # gang hints ARE the solver's real-fleet verdict, floored at
    # min_size: every seat was re-decided against credited-back avail,
    # so placed < current means a higher class outbid the gang (cede)
    # and placed > current means grow-back capacity exists
    for gw in snap.gang_wants:
        placed = world_hints.get(gw.gang_id)
        if placed is None and gw.want <= 0:
            continue
        world_hints[gw.gang_id] = max(int(gw.min_size), int(placed or 0))

    # provision: hypothetical columns that received any demand
    if solved.n_hypo:
        hypo_cols = solved.per_node[:, solved.n_real:]
        hypo_used = int((hypo_cols.sum(axis=0) > 0).sum())
    provision = min(hypo_used, provision_max)

    # retire: alive nodes the solve left empty AND the view shows idle
    # (nothing running: avail == totals) past the idle window
    retire: List[str] = []
    migrate: List[str] = []
    if retire_max > 0 and snap.avail.shape[0]:
        col_demand = (
            solved.per_node[:, : solved.n_real].sum(axis=0)
            if matrix.rows
            else np.zeros(solved.n_real)
        )
        # best-retire-first ordering (hybrid.retire_scores_impl): fully
        # idle before partially idle, small before big, solver-demanded
        # nodes effectively never
        from ray_tpu_torch.scheduler.hybrid import retire_order

        order = retire_order(snap.totals, snap.avail, col_demand, device=device)
        alive_rows = [int(i) for i in order if snap.alive[int(i)]]
        n_alive = len(alive_rows)
        idle_since = idle_since if idle_since is not None else {}
        total_missing = sum(unfulfilled.values())
        total_avail = np.zeros(snap.avail.shape[1], dtype=np.float64)
        for j in alive_rows:
            total_avail += np.maximum(snap.avail[j], 0.0)
        retired_avail = np.zeros_like(total_avail)
        for i in alive_rows:
            if len(retire) >= retire_max or n_alive - len(retire) <= min_nodes:
                break
            if matrix.rows and col_demand[i] > 0:
                continue
            nid = snap.node_ids[i]
            leases = snap.lease_load.get(nid, 0)
            busy = leases > 0 or not np.allclose(
                snap.avail[i], snap.totals[i], atol=1e-3
            )
            if not busy:
                # pure shrink-to-fit: requires the idle window
                since = idle_since.get(nid)
                if since is None or now - since < idle_retire_s:
                    continue
            else:
                # drain-ahead consolidation: a node still hosting leases
                # can retire when every demand row was fully placed
                # without it, the solver landed nothing new on it, and
                # its running work fits elementwise in the rest of the
                # live fleet's residual — migration then moves the
                # leases off before the drain deadline instead of the
                # kill path losing them. Busy-without-leases (actors,
                # serve replicas) has nothing migrate_node_leases can
                # move, so it never consolidation-retires.
                if total_missing > 0 or leases <= 0:
                    continue
                used = np.maximum(snap.totals[i] - snap.avail[i], 0.0)
                rest = (
                    total_avail
                    - retired_avail
                    - np.maximum(snap.avail[i], 0.0)
                )
                if not (rest + 1e-3 >= used).all():
                    continue
            retire.append(nid)
            retired_avail += np.maximum(snap.avail[i], 0.0)
        # drain-ahead: retiring nodes that still host leases get their
        # work migrated before the drain deadline
        migrate = [n for n in retire if snap.lease_load.get(n, 0) > 0]
    return ElasticPlan(
        provision=provision,
        retire=retire,
        migrate=migrate,
        serve_hints=serve_hints,
        world_hints=world_hints,
        unfulfilled=unfulfilled,
        path=solved.path,
    )


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------
def _shape_key_of(spec) -> tuple:
    """Memoized resource-shape identity of a spec: the key the head's
    dense-row cache, fair-batch classes and device ring index by (a copy of
    ``ray_tpu/cluster/head.py::_shape_key_of``; the head is not ported)."""
    key = getattr(spec, "_shape_key", None)
    if key is None:
        key = tuple(sorted(spec.resources.items()))
        spec._shape_key = key
    return key


class ElasticityController:
    """Head-resident tick loop: snapshot → one device solve → actuate.

    ``head`` is a :class:`~ray_tpu.cluster.head.HeadServer`. ``provider``
    (optional, attachable later) supplies the real agent lifecycle:

    - ``create_node() -> Optional[str]``
    - ``drain_node(node_id, deadline_s) -> bool`` (graceful; falls back
      to ``terminate_node``)
    - ``terminate_node(node_id) -> bool``
    - ``node_template() -> Dict[str, float]`` resources of one
      provisionable node (shapes the hypothetical solve rows)
    """

    def __init__(self, head, provider=None):
        self.head = head
        self.provider = provider
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # RLock: state() reads the plan and the tick percentiles under one
        # acquisition
        self._lock = threading.RLock()
        self._idle_since: Dict[str, float] = {}
        self._tick_ms: List[float] = []
        self.ticks = 0
        self.last_plan: Optional[ElasticPlan] = None
        self._draining: Dict[str, float] = {}  # node_id -> deadline

    # -- lifecycle ------------------------------------------------------
    def attach_provider(self, provider) -> None:
        with self._lock:
            self.provider = provider

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(max(0.05, float(cfg.elastic_tick_s))):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - controller must not die
                    logger.exception("elasticity tick failed")

        self._thread = threading.Thread(
            target=loop, name="head-elasticity", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- snapshot -------------------------------------------------------
    def snapshot(self) -> ElasticSnapshot:
        """Assemble the unified demand view from the head's tables. Holds
        the head lock only for the cheap copies."""
        head = self.head
        with head._lock:
            totals0, avail0, alive0 = head.view.active_arrays()
            totals = totals0.copy()
            avail = avail0.copy()
            alive = alive0.copy()
            node_ids = [head.view.node_id(i) for i in range(len(alive))]
            serve_pressure = {
                dep: {r: dict(rep) for r, rep in reports.items()}
                for dep, reports in head._serve_budget.items()
            }
        width = int(totals.shape[1]) if totals.size else max(
            1, head.view.totals.shape[1]
        )
        with head._cond:
            gang_wants = []
            for gid, g in head._gangs.items():
                want = int(g.get("want_world") or 0)
                if want <= 0 or not g.get("grow", False):
                    continue
                res = g.get("resources_per_rank") or {"CPU": 1.0}
                row = head.vocab.pack(res).astype(np.float32)[:width]
                if row.shape[0] < width:
                    row = np.pad(row, (0, width - row.shape[0]))
                by_node: Dict[str, int] = {}
                for nid in g["members"].values():
                    by_node[nid] = by_node.get(nid, 0) + 1
                gang_wants.append(
                    GangWant(
                        gang_id=gid,
                        current=len(g["members"]),
                        want=want,
                        min_size=int(g.get("min_size", 1)),
                        row=row,
                        members_by_node=by_node,
                    )
                )
            parked: Dict[tuple, int] = {}

            seen: set = set()
            for q in (
                head._pending,
                head._infeasible,
                head._scheduling_batch,
            ):
                for s in q:
                    if not s.resources or id(s) in seen:
                        continue
                    seen.add(id(s))
                    k = _shape_key_of(s)
                    parked[k] = parked.get(k, 0) + 1
            deferred: Dict[tuple, int] = {}
            for specs in head._deferred_rounds.values():
                for s in specs:
                    if not s.resources or id(s) in seen:
                        continue
                    seen.add(id(s))
                    k = _shape_key_of(s)
                    deferred[k] = deferred.get(k, 0) + 1
            device_state = head.device_state
            ring_keys = (
                list(device_state.ring_keys())
                if device_state is not None
                else []
            )
            lease_load: Dict[str, int] = {}
            for e in head._task_leases.values():
                if e.get("state") == "active" and e.get("node_id"):
                    nid = e["node_id"]
                    lease_load[nid] = lease_load.get(nid, 0) + 1
            for _, (spec, nid) in head._in_flight.items():
                if nid:
                    lease_load[nid] = lease_load.get(nid, 0) + 1
        task_shapes = dedupe_task_shapes(parked, deferred, ring_keys)
        return ElasticSnapshot(
            width=width,
            avail=avail,
            totals=totals,
            alive=alive,
            node_ids=node_ids,
            serve_pressure={
                dep: self._rollup(reports)
                for dep, reports in serve_pressure.items()
            },
            gang_wants=gang_wants,
            task_shapes=task_shapes,
            lease_load=lease_load,
        )

    @staticmethod
    def _rollup(reports: Dict[str, dict]) -> Dict[str, dict]:
        from ray_tpu_torch.scheduler.serve_demand import pressure_rollup

        return pressure_rollup(reports)

    def _pack_key(self, key: tuple) -> Optional[np.ndarray]:
        width = self.head.view.totals.shape[1]
        try:
            row = self.head.vocab.pack(dict(key)).astype(np.float32)
        except Exception:  # noqa: BLE001 - unknown resource name
            return None
        if row.shape[0] < width:
            row = np.pad(row, (0, width - row.shape[0]))
        return row[:width]

    def _hypo_rows(self, width: int) -> np.ndarray:
        k = max(0, int(cfg.elastic_provision_max))
        if k == 0:
            return np.zeros((0, width), dtype=np.float32)
        template: Dict[str, float]
        if self.provider is not None and hasattr(self.provider, "node_template"):
            template = dict(self.provider.node_template() or {})
        else:
            template = {"CPU": float(cfg.elastic_node_cpus)}
        row = self.head.vocab.pack(template).astype(np.float32)
        if row.shape[0] < width:
            row = np.pad(row, (0, width - row.shape[0]))
        return np.tile(row[:width], (k, 1))

    # -- one tick -------------------------------------------------------
    def tick(self) -> dict:
        t0 = time.perf_counter()
        snap = self.snapshot()
        live = snap.alive.astype(bool)
        avail = np.where(live[:, None], snap.avail, 0.0).astype(np.float32)
        avail = credit_gang_usage(avail, snap.node_ids, snap.gang_wants)
        # track idle windows for retirement (busy nodes reset the clock)
        now = time.monotonic()
        for i, nid in enumerate(snap.node_ids):
            idle = (
                bool(live[i])
                and snap.lease_load.get(nid, 0) == 0
                and np.allclose(snap.avail[i], snap.totals[i], atol=1e-3)
            )
            if idle:
                self._idle_since.setdefault(nid, now)
            else:
                self._idle_since.pop(nid, None)
        matrix = assemble_demand(snap, pack_key=self._pack_key)
        for name, n in matrix.class_counts().items():
            ELASTIC_DEMAND_ROWS.set(n, labels={"cls": name})
        solved = solve_demand(
            avail, matrix, hypo_rows=self._hypo_rows(snap.width)
        )
        plan = build_plan(
            snap,
            matrix,
            solved,
            idle_since=self._idle_since,
            now=now,
        )
        plan.tick_ms = (time.perf_counter() - t0) * 1000.0
        plan.demand_rows = matrix.rows
        ELASTIC_TICK_MS.set(plan.tick_ms)
        with self._lock:
            self.ticks += 1
            self.last_plan = plan
            self._tick_ms.append(plan.tick_ms)
            if len(self._tick_ms) > 512:
                del self._tick_ms[:-512]
        self.actuate(plan, snap)
        return plan.summary()

    # -- actuation ------------------------------------------------------
    def actuate(self, plan: ElasticPlan, snap: ElasticSnapshot) -> None:
        head = self.head
        # (b) solver-backed serve capacity hints: land them where the
        # budget reply reads (the budget reply's seam), replacing the one-shot plan
        if plan.serve_hints:
            with head._lock:
                for dep, hint in plan.serve_hints.items():
                    head._serve_capacity_hints[dep] = {
                        "hint": dict(hint),
                        "ts": time.monotonic(),
                    }
            ELASTIC_ACTUATIONS.inc(labels={"kind": "serve_hint"})
        # gang world hints ride the gang table; drivers poll via GangHint
        if plan.world_hints:
            with head._cond:
                for gid, world in plan.world_hints.items():
                    g = head._gangs.get(gid)
                    if g is not None:
                        g["world_hint"] = int(world)
                head._cond.notify_all()
            ELASTIC_ACTUATIONS.inc(labels={"kind": "gang_hint"})
        # (a) provision through the real agent lifecycle
        provider = self.provider
        if plan.provision > 0 and provider is not None:
            for _ in range(plan.provision):
                try:
                    nid = provider.create_node()
                except Exception:  # noqa: BLE001
                    logger.exception("elastic provision failed")
                    break
                if nid:
                    ELASTIC_ACTUATIONS.inc(labels={"kind": "provision"})
        # (c) retire with drain-ahead migration. Without a provider there
        # is no terminate path, so beginning a drain would just churn
        # begin/finish every tick — fallback matrix: hint actuations only
        # (external drains still migrate via Cluster.drain_node).
        if provider is None:
            return
        for nid in plan.retire:
            deadline = time.monotonic() + float(cfg.elastic_drain_deadline_s)
            first = nid not in self._draining
            self._draining.setdefault(nid, deadline)
            if first:
                try:
                    head.begin_node_drain(nid)
                except Exception:  # noqa: BLE001
                    logger.exception("begin drain failed for %s", nid)
                if nid in plan.migrate:
                    try:
                        head.migrate_node_leases(nid)
                        ELASTIC_ACTUATIONS.inc(labels={"kind": "migrate"})
                    except Exception:  # noqa: BLE001
                        logger.exception("drain-ahead migrate failed")
        # complete drains whose node emptied (or deadline passed)
        for nid in list(self._draining):
            if nid not in plan.retire and snap.lease_load.get(nid, 0):
                # demand returned before the kill: cancel the drain
                self._draining.pop(nid, None)
                try:
                    head.finish_node_drain(nid, retire=False)
                except Exception:  # noqa: BLE001
                    pass
                continue
            drained = snap.lease_load.get(nid, 0) == 0
            expired = time.monotonic() >= self._draining[nid]
            if not (drained or expired):
                continue
            self._draining.pop(nid, None)
            ok = False
            if provider is not None:
                try:
                    ok = bool(provider.terminate_node(nid))
                except Exception:  # noqa: BLE001
                    logger.exception("elastic retire failed for %s", nid)
            try:
                head.finish_node_drain(nid, retire=ok)
            except Exception:  # noqa: BLE001
                pass
            if ok:
                ELASTIC_ACTUATIONS.inc(labels={"kind": "retire"})

    # -- observability --------------------------------------------------
    def tick_percentiles(self) -> Dict[str, float]:
        with self._lock:
            ms = sorted(self._tick_ms)
        if not ms:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {
            "p50_ms": ms[len(ms) // 2],
            "p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
        }

    def state(self) -> dict:
        with self._lock:
            plan = self.last_plan.summary() if self.last_plan else None
            return {
                "ticks": self.ticks,
                "tick": self.tick_percentiles(),
                "draining": {
                    n: round(d - time.monotonic(), 2)
                    for n, d in self._draining.items()
                },
                "last_plan": plan,
                "provider": type(self.provider).__name__
                if self.provider is not None
                else None,
            }
