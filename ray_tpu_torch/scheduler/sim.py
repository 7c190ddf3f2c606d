"""Simulated-scale scheduler harness: 10k nodes, up to 1M pending demands.

Drives the REAL head scheduling path — ``HeadServer`` with its scheduler
thread, fair batch popping, kernel rounds (pipelined or synchronous),
capacity-capped unparking, and the device-resident mirror — against a
synthetic topology with no agents and no RPC: nodes are injected straight
into the cluster view, and ``_send_grants`` is replaced by a local sink
that tallies delivered placements (the network boundary is exactly where
a simulated cluster stops being real, so that is the seam).

This is how the 10k-node × 1M-pending-task scale target is measured reproducibly on any host: delivered placements/s
end-to-end through ``head._schedule_batch``, plus the round-latency
percentiles over the run's window. ``bench.py``'s ``sim_sched`` tier runs
it in both pipeline modes and publishes the ratio; tests run it small and
assert zero placement divergence between the modes on identical streams.

Health checking is inert by construction: a node that never appears in
``head._last_report`` reads as gap 0 (the agent-report liveness contract
starts at first report), so the synthetic nodes stay alive without a
reporter thread.

Port of ``ray_tpu/scheduler/sim.py``, copied with its imports rewritten.
The head it drives is the port's ``HeadServer``, whose rounds, ring
rounds and elasticity solves run on the scheduler device: ``cuda`` unless
``RAY_TPU_SCHED_PLATFORM=cpu``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util.metrics import percentile_from_buckets


#: the skewed stream's large shape: starvation-prone next to the
#: fractional-CPU mixture — a node must hold 16 contiguous free CPU
LARGE_SHAPE: Dict[str, float] = {"CPU": 16.0, "memory": 64.0}

#: heterogeneous node mix (fraction, type name, resources, throughput
#: factors): CPU-dense and highmem types next to the std baseline, with
#: Gavel-style relative throughput factors the het term consumes
NODE_MIX = (
    (0.6, "std", {"CPU": 64.0, "memory": 256.0}, None),
    (0.2, "dense", {"CPU": 128.0, "memory": 512.0},
     {"CPU": 1.25, "memory": 1.1}),
    (0.2, "highmem", {"CPU": 32.0, "memory": 1024.0},
     {"memory": 1.2, "CPU": 0.8}),
)


def build_demand_maps(
    num_demands: int,
    seed: int = 0,
    large_frac: float = 0.0,
    cpu_scale: float = 1.0,
) -> List[Dict[str, float]]:
    """The bench workload's CPU/memory mixture (bench.py build_demands),
    minus the TPU slice — the fill-once sim asserts full delivery, so
    every shape must be cluster-placeable. ``large_frac`` > 0 skews the
    stream with LARGE_SHAPE requests (doubled over the final fifth of
    the stream, so the tail arrives against an already-fragmented
    cluster); ``cpu_scale`` scales the small shapes up so a churn run
    (``hold_s``) can over-subscribe aggregate capacity — the
    fairness/fragmentation measurement workload."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(3, num_demands, p=[0.70, 0.15, 0.15])
    s = float(cpu_scale)
    shapes = (
        {"CPU": 0.25 * s},
        {"CPU": 0.5 * s, "memory": 1.0 * s},
        {"CPU": 1.0 * s},
    )
    out = [dict(shapes[k]) for k in kind]
    if large_frac > 0:
        tail_start = int(num_demands * 0.8)
        p = rng.random(num_demands)
        for i in range(num_demands):
            frac = large_frac * (2.0 if i >= tail_start else 1.0)
            if p[i] < frac:
                out[i] = dict(LARGE_SHAPE)
    return out


def run_sim(
    num_nodes: int = 10_000,
    num_demands: int = 1_000_000,
    *,
    pipeline: bool = True,
    seed: int = 0,
    cpu_per_node: float = 64.0,
    memory_per_node: float = 256.0,
    collect_assignments: bool = False,
    timeout_s: float = 900.0,
    heterogeneous: bool = False,
    large_frac: float = 0.0,
    cpu_scale: float = 1.0,
    hold_rounds: int = 0,
) -> dict:
    """One sim run; returns delivered placements/s + round percentiles.

    ``pipeline`` toggles RAY_TPU_SCHED_PIPELINE for the run (restored
    after), selecting pipelined vs synchronous rounds through the exact
    production code path. All demands are enqueued under the head lock
    BEFORE the scheduler thread can pop, so two runs with the same seed
    see identical batch streams — the basis of the divergence check.

    ``heterogeneous`` builds the NODE_MIX topology (three node types
    with registered throughput factors) instead of a homogeneous fleet;
    ``large_frac`` skews the demand stream with LARGE_SHAPE requests and
    turns on the fairness/fragmentation measurements: per-large-spec
    wait in scheduling rounds past its queue-position arrival estimate
    (spec i's batch is popped at round ~i/sched_max_batch — a spec
    placed the round it is first scored waits ~0; parked specs
    accumulate), and a sampled stranded-capacity percentage — the share
    of the cluster's free CPU sitting on nodes that can no longer host
    LARGE_SHAPE.

    ``hold_rounds`` > 0 models task COMPLETIONS: every granted spec
    returns its capacity to the view once the round clock has advanced
    ``hold_rounds`` past its grant (a completer thread applies the
    returns like agent reports, dirty rows and all; round-based holds
    keep the return schedule comparable across modes on the same
    stream). This turns the fill-once sim into a steady-state churn
    benchmark where total demand may EXCEED cluster capacity — the
    regime where packing quality and starvation handling actually show
    up, since a fill-once run strands fragmented capacity permanently
    and measures only arrival order.
    """
    from ray_tpu_torch.cluster.common import LeaseRequest, NodeInfo
    from ray_tpu_torch.cluster.head import SCHED_ROUND_MS, HeadServer
    from ray_tpu_torch.scheduler.resources import CPU

    env_before = os.environ.get("RAY_TPU_SCHED_PIPELINE")
    os.environ["RAY_TPU_SCHED_PIPELINE"] = "1" if pipeline else "0"
    head = None
    completer: Optional[threading.Thread] = None
    completer_stop = threading.Event()
    try:
        head = HeadServer(dashboard_port=None)
        delivered = 0
        assignments: Dict[str, str] = {}
        done = threading.Event()
        sink_lock = threading.Lock()
        large_grant_round: Dict[str, int] = {}
        large_ids: set = set()
        frag_samples: List[float] = []
        large_cpu = float(LARGE_SHAPE["CPU"])
        last_frag_round = -1
        # churn model: (due round, node row, summed demand row)
        pending_returns: deque = deque()

        def _round_clock() -> int:
            """Kernel rounds + ring retry rounds: parked work granted via
            the on-device ring advances this clock too."""
            ds = head.device_state
            return head.metrics["sched_rounds"] + (
                ds.stats["ring_rounds"] if ds is not None else 0
            )

        def _sample_frag() -> None:
            with head._lock:
                totals, avail, alive = head.view.active_arrays()
                free = avail[alive, CPU]
                cap = totals[alive, CPU]
            total_cpu = float(cap.sum())
            if total_cpu <= 0:
                return
            stranded = float(free[(free < large_cpu) & (free > 0)].sum())
            frag_samples.append(100.0 * stranded / total_cpu)

        def grant_sink(grants: Dict[str, List[LeaseRequest]]) -> None:
            nonlocal delivered, last_frag_round
            n = sum(len(v) for v in grants.values())
            rounds_now = _round_clock()
            with sink_lock:
                if collect_assignments:
                    for nid, specs in grants.items():
                        for s in specs:
                            assignments[s.task_id] = nid
                if large_ids:
                    for specs in grants.values():
                        for s in specs:
                            if s.task_id in large_ids:
                                large_grant_round[s.task_id] = rounds_now
                if large_frac > 0 and rounds_now != last_frag_round:
                    last_frag_round = rounds_now
                    _sample_frag()
                if hold_rounds > 0:
                    due = rounds_now + hold_rounds
                    width = head.view.totals.shape[1]
                    for nid, specs in grants.items():
                        row = head.view.row_of(nid)
                        d = np.zeros(width, dtype=np.float32)
                        for s in specs:
                            d[:] += head.vocab.pack(s.resources)[:width]
                        pending_returns.append((due, row, d))
                delivered += n
                if delivered >= num_demands:
                    done.set()

        head._send_grants = grant_sink

        def _completer() -> None:
            """Return held capacity like agent reports would: under the
            head lock, dirty rows marked, change counter bumped (which is
            what re-arms the parked-work retry path). Round-based due
            times: the ring retry rounds advance the clock even when the
            cluster is saturated, so returns always drain."""
            while not completer_stop.wait(0.02):
                clock = _round_clock()
                batch: List[tuple] = []
                with sink_lock:
                    while pending_returns and pending_returns[0][0] <= clock:
                        batch.append(pending_returns.popleft())
                if not batch:
                    continue
                with head._cond:
                    for _, row, d in batch:
                        head.view.add(row, d)
                    head._cond.notify_all()

        if hold_rounds > 0:
            completer = threading.Thread(
                target=_completer, name="sim-completer", daemon=True
            )
            completer.start()

        with head._cond:
            if heterogeneous:
                for _, tname, _, thr in NODE_MIX:
                    head.view.register_node_type(tname, thr)
                bounds = np.cumsum([m[0] for m in NODE_MIX])
                mix_rng = np.random.default_rng(seed + 1)
                picks = mix_rng.random(num_nodes)
                for i in range(num_nodes):
                    mi = int(np.searchsorted(bounds, picks[i]))
                    mi = min(mi, len(NODE_MIX) - 1)
                    _, tname, res, _ = NODE_MIX[mi]
                    nid = f"simnode-{i}"
                    head.nodes[nid] = NodeInfo(
                        node_id=nid, address="", resources=dict(res)
                    )
                    head.view.add_node(
                        nid, head.nodes[nid].resources, node_type=tname
                    )
            else:
                for i in range(num_nodes):
                    nid = f"simnode-{i}"
                    head.nodes[nid] = NodeInfo(
                        node_id=nid,
                        address="",
                        resources={
                            "CPU": cpu_per_node,
                            "memory": memory_per_node,
                        },
                    )
                    head.view.add_node(nid, head.nodes[nid].resources)

        demand_maps = build_demand_maps(
            num_demands, seed, large_frac, cpu_scale
        )
        specs = [
            LeaseRequest(
                task_id=f"sim-{i}",
                name="sim",
                payload=b"",
                return_ids=[],
                resources=res,
                max_retries=0,
            )
            for i, res in enumerate(demand_maps)
        ]
        large_arrival: Dict[str, int] = {}
        if large_frac > 0:
            from ray_tpu_torch.config import cfg as _cfg

            max_batch = max(1, int(_cfg.sched_max_batch))
            for i, (s, res) in enumerate(zip(specs, demand_maps)):
                if res.get("CPU", 0.0) >= large_cpu:
                    large_ids.add(s.task_id)
                    # queue-position arrival estimate: the stream pops
                    # FIFO in MAX_BATCH rounds while the queue is deep
                    large_arrival[s.task_id] = i // max_batch

        round_buckets0 = SCHED_ROUND_MS.buckets_snapshot()
        t0 = time.perf_counter()
        with head._cond:
            head._pending.extend(specs)
            head._cond.notify_all()
        completed = done.wait(timeout=timeout_s)
        elapsed = time.perf_counter() - t0
        round_buckets1 = SCHED_ROUND_MS.buckets_snapshot()
        delta = [b1 - b0 for b0, b1 in zip(round_buckets0, round_buckets1)]

        ds = head.device_state
        out = {
            "pipeline": pipeline,
            "num_nodes": num_nodes,
            "num_demands": num_demands,
            "delivered": delivered,
            "completed": completed,
            "elapsed_s": round(elapsed, 3),
            "placements_per_s": round(delivered / elapsed, 1)
            if elapsed > 0
            else 0.0,
            "sched_round_p50_ms": round(
                percentile_from_buckets(
                    SCHED_ROUND_MS.boundaries, delta, 0.50
                ),
                3,
            ),
            "sched_round_p99_ms": round(
                percentile_from_buckets(
                    SCHED_ROUND_MS.boundaries, delta, 0.99
                ),
                3,
            ),
            "sched_rounds": int(sum(delta)),
            "device_stats": dict(ds.stats) if ds is not None else None,
            "pipeline_stats": (
                head._pipeline.stats() if head._pipeline is not None else None
            ),
            "ring_occupancy": ds.ring_occupancy() if ds is not None else 0,
        }
        if large_frac > 0:
            _sample_frag()  # final state, even if sampling never hit
            final_rounds = _round_clock()
            waits = [
                max(
                    0,
                    large_grant_round.get(t, final_rounds)
                    - large_arrival[t],
                )
                for t in large_ids
            ]
            out.update(
                {
                    "num_large": len(large_ids),
                    "large_delivered": len(large_grant_round),
                    "p50_wait_rounds_large": (
                        float(np.percentile(waits, 50)) if waits else 0.0
                    ),
                    "p99_wait_rounds_large": (
                        float(np.percentile(waits, 99)) if waits else 0.0
                    ),
                    # steady-state stranding: mean over the run's second
                    # half (the first half is mostly-empty cluster)
                    "fragmentation_pct": round(
                        float(
                            np.mean(
                                frag_samples[len(frag_samples) // 2:]
                            )
                        )
                        if frag_samples
                        else 0.0,
                        2,
                    ),
                    "fragmentation_pct_final": round(
                        frag_samples[-1] if frag_samples else 0.0, 2
                    ),
                    "preempt_nominations": head.metrics[
                        "preempt_nominations"
                    ],
                    "preemptions": head.metrics["preemptions"],
                }
            )
        if collect_assignments:
            out["assignments"] = assignments
        return out
    finally:
        completer_stop.set()
        if completer is not None:
            completer.join(timeout=2.0)
        if head is not None:
            head.shutdown(stop_agents=False)
        if env_before is None:
            os.environ.pop("RAY_TPU_SCHED_PIPELINE", None)
        else:
            os.environ["RAY_TPU_SCHED_PIPELINE"] = env_before


def run_sim_pair(
    num_nodes: int, num_demands: int, *, seed: int = 0, **kw
) -> dict:
    """Pipelined + synchronous runs over the SAME demand stream on the
    same host: the speedup ratio and the divergence count (both modes
    must place every spec, on identical nodes per spec when the stream
    is deterministic). This is the bench tier's workhorse.

    A throwaway warmup run at the same node geometry pays the first-use
    costs first (the device's context, allocator growth, the prewarm
    rounds) — without it the sync run (which goes first) pays them and
    the comparison flatters the pipeline."""
    from ray_tpu_torch.config import cfg

    warm_demands = min(num_demands, 3 * int(cfg.sched_max_batch))
    run_sim(num_nodes, warm_demands, pipeline=False, seed=seed, **kw)
    sync = run_sim(
        num_nodes, num_demands, pipeline=False, seed=seed,
        collect_assignments=True, **kw
    )
    piped = run_sim(
        num_nodes, num_demands, pipeline=True, seed=seed,
        collect_assignments=True, **kw
    )
    a_sync = sync.pop("assignments")
    a_piped = piped.pop("assignments")
    divergent = sum(
        1
        for tid, nid in a_sync.items()
        if a_piped.get(tid) != nid
    ) + sum(1 for tid in a_piped if tid not in a_sync)
    speedup = (
        piped["placements_per_s"] / sync["placements_per_s"]
        if sync["placements_per_s"]
        else 0.0
    )
    return {
        "sync": sync,
        "pipelined": piped,
        "placement_divergence": divergent,
        "pipeline_speedup": round(speedup, 2),
    }


def run_elasticity_sim(
    num_nodes: int = 10_000,
    *,
    ticks: int = 50,
    serve_tenants: int = 32,
    gangs: int = 8,
    task_shapes: int = 1000,
    seed: int = 0,
    cpu_per_node: float = 64.0,
    memory_per_node: float = 256.0,
) -> dict:
    """Controller-tick latency at sim scale: a real
    HeadServer with ``num_nodes`` synthetic nodes, serve pressure across
    ``serve_tenants`` tenants, ``gangs`` under-world gangs with declared
    wants, and ``task_shapes`` parked lease specs — then ``ticks``
    unified controller ticks, each one snapshot + ONE batched device
    solve + plan (actuation runs dry: no provider, retirement disabled).
    Returns assembly/solve tick percentiles — the number that replaces
    three Python control loops' worth of per-entity scanning."""
    from ray_tpu_torch.cluster.common import LeaseRequest, NodeInfo
    from ray_tpu_torch.cluster.head import HeadServer

    rng = np.random.default_rng(seed)
    saved = {
        k: os.environ.get(k)
        for k in (
            "RAY_TPU_ELASTIC_RETIRE_MAX",
            "RAY_TPU_ELASTIC_CONTROLLER",
        )
    }
    os.environ["RAY_TPU_ELASTIC_RETIRE_MAX"] = "0"
    # construct with the controller ticking OFF: the sim drives tick()
    # by hand so every tick is measured, none raced
    os.environ["RAY_TPU_ELASTIC_CONTROLLER"] = "0"
    head = None
    try:
        head = HeadServer(dashboard_port=None)
        head._send_grants = lambda grants: None
        with head._cond:
            for i in range(num_nodes):
                nid = f"simnode-{i}"
                head.nodes[nid] = NodeInfo(
                    node_id=nid,
                    address="",
                    resources={
                        "CPU": cpu_per_node,
                        "memory": memory_per_node,
                    },
                )
                head.view.add_node(nid, head.nodes[nid].resources)
            # serve pressure: one deployment, per-tenant waiting queues
            head._serve_budget["simdep"] = {
                "router-0": {
                    "usage": {},
                    "waiting": {},
                    "weights": {},
                    "pressure": {
                        f"tenant-{t}": {
                            "waiting": int(rng.integers(1, 64)),
                            "waiting_tokens": int(
                                rng.integers(256, 65536)
                            ),
                        }
                        for t in range(serve_tenants)
                    },
                    "ts": time.monotonic(),
                }
            }
            # gangs below their want: grow-back demand rows
            for g in range(gangs):
                world = int(rng.integers(1, 4))
                head._gangs[f"simgang-{g}"] = {
                    "epoch": 1,
                    "owner": "sim",
                    "members": {
                        r: f"simnode-{(g * 7 + r) % num_nodes}"
                        for r in range(world)
                    },
                    "min_size": 1,
                    "dead_ranks": [],
                    "updated": time.monotonic(),
                    "want_world": world + int(rng.integers(1, 5)),
                    "resources_per_rank": {"CPU": 4.0},
                    "grow": True,
                    "world_hint": None,
                }
            # parked task demand: shapes sized ABOVE per-node capacity so
            # the head's own scheduler loop keeps them infeasible across
            # every tick (feasible ones would drain into the grant sink)
            # — exactly the parked demand that drives provisioning
            for i in range(task_shapes):
                head._infeasible.append(
                    LeaseRequest(
                        task_id=f"simtask-{i}",
                        name="sim",
                        payload=b"",
                        return_ids=[],
                        resources={
                            "CPU": cpu_per_node
                            + 1.0
                            + float(rng.integers(0, 64)),
                            "memory": memory_per_node
                            + float(rng.integers(0, 256)),
                        },
                        max_retries=0,
                    )
                )
        ctrl = head._elasticity
        # untimed warmup ticks run the padded solve once per bucket (and
        # any neighbor bucket the head's own infeasible-retry churn lands in)
        for _ in range(3):
            ctrl.tick()
        with ctrl._lock:
            ctrl._tick_ms.clear()
        t0 = time.perf_counter()
        for _ in range(ticks):
            ctrl.tick()
        elapsed = time.perf_counter() - t0
        pct = ctrl.tick_percentiles()
        last = ctrl.last_plan
        return {
            "num_nodes": num_nodes,
            "ticks": ticks,
            "elapsed_s": round(elapsed, 3),
            "ticks_per_s": round(ticks / elapsed, 2) if elapsed else 0.0,
            "tick_p50_ms": round(pct["p50_ms"], 3),
            "tick_p99_ms": round(pct["p99_ms"], 3),
            "demand_rows": last.demand_rows if last else 0,
            "solve_path": last.path if last else "none",
            "serve_hints": len(last.serve_hints) if last else 0,
            "world_hints": len(last.world_hints) if last else 0,
        }
    finally:
        if head is not None:
            head.shutdown(stop_agents=False)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_WEIGHT_ENV = (
    ("RAY_TPU_SCHED_W_UTIL", "util"),
    ("RAY_TPU_SCHED_W_HET", "het"),
    ("RAY_TPU_SCHED_W_FRAG", "frag"),
    ("RAY_TPU_SCHED_W_STARVE", "starve"),
)


def _with_weights(weights: Tuple[float, float, float, float], fn):
    """Run ``fn`` with the multi-objective weight knobs pinned via env
    (cfg reads env live; each round reads the weights from cfg)."""
    saved = {k: os.environ.get(k) for k, _ in _WEIGHT_ENV}
    try:
        for (k, _), v in zip(_WEIGHT_ENV, weights):
            os.environ[k] = repr(float(v))
        return fn()
    finally:
        for k, _ in _WEIGHT_ENV:
            if saved[k] is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = saved[k]


def run_sim_weights_pair(
    num_nodes: int,
    num_demands: int,
    *,
    seed: int = 0,
    weights: Tuple[float, float, float, float] = (1.0, 0.5, 1.0, 1.0),
    large_frac: float = 0.015,
    cpu_scale: float = 1.5,
    hold_rounds: Optional[int] = None,
    starve_rounds: int = 8,
    **kw,
) -> dict:
    """Single-objective (1,0,0,0) vs multi-objective run over the SAME
    seeded heterogeneous topology and skewed CHURN stream (demand
    over-subscribes aggregate capacity; granted work returns its
    capacity after ``hold_rounds`` — the steady-state regime where packing
    quality decides how long large shapes wait): the
    fairness/fragmentation measurement the acceptance criterion pins —
    multi-objective must hold ≥0.8× the single-objective placements/s
    while measurably reducing stranded capacity and large-shape p99
    wait. Both runs report their numbers; the deltas are computed here.

    ``starve_rounds`` is pinned low for the pair (the sim's rounds are
    ms-scale, so production's default would never age a shape into the
    starving regime inside the run). ``hold_rounds`` defaults to holding
    the cluster NEAR-FULL through the run: grants per round are capped
    at sched_max_batch, so a hold shorter than
    capacity_tasks/sched_max_batch rounds lets returns outpace the
    backlog and the contention regime never arrives (observed at 10k
    nodes: a flat 12-round hold left the fleet 94% idle)."""
    if hold_rounds is None:
        from ray_tpu_torch.config import cfg as _cfg

        avg_cpu_node = sum(f * res["CPU"] for f, _, res, _ in NODE_MIX)
        # probability-weighted small-shape mean CPU (build_demand_maps:
        # 0.70*0.25 + 0.15*0.5 + 0.15*1.0 = 0.4)
        avg_demand_cpu = 0.4 * cpu_scale * (1.0 - large_frac) + (
            LARGE_SHAPE["CPU"] * large_frac * 1.2  # tail doubling
        )
        capacity_tasks = num_nodes * avg_cpu_node / max(avg_demand_cpu, 1e-6)
        hold_rounds = max(
            8, int(1.25 * capacity_tasks / max(1, int(_cfg.sched_max_batch)))
        )
    saved_sr = os.environ.get("RAY_TPU_SCHED_STARVE_ROUNDS")
    os.environ["RAY_TPU_SCHED_STARVE_ROUNDS"] = str(int(starve_rounds))
    try:
        common = dict(
            seed=seed,
            heterogeneous=True,
            large_frac=large_frac,
            cpu_scale=cpu_scale,
            hold_rounds=hold_rounds,
            **kw,
        )
        warm_demands = min(num_demands, 6000)

        def _one(w):
            return _with_weights(
                w,
                lambda: (
                    run_sim(
                        num_nodes, warm_demands, pipeline=True, **common
                    ),  # warmup at this weight set
                    run_sim(num_nodes, num_demands, pipeline=True, **common),
                )[1],
            )

        single = _one((1.0, 0.0, 0.0, 0.0))
        multi = _one(weights)
    finally:
        if saved_sr is None:
            os.environ.pop("RAY_TPU_SCHED_STARVE_ROUNDS", None)
        else:
            os.environ["RAY_TPU_SCHED_STARVE_ROUNDS"] = saved_sr
    ratio = (
        multi["placements_per_s"] / single["placements_per_s"]
        if single["placements_per_s"]
        else 0.0
    )
    return {
        "single": single,
        "multi": multi,
        "weights": tuple(weights),
        "hold_rounds": hold_rounds,
        "multi_vs_single_throughput": round(ratio, 3),
        "frag_pct_single": single.get("fragmentation_pct", 0.0),
        "frag_pct_multi": multi.get("fragmentation_pct", 0.0),
        "p99_wait_rounds_large_single": single.get(
            "p99_wait_rounds_large", 0.0
        ),
        "p99_wait_rounds_large_multi": multi.get(
            "p99_wait_rounds_large", 0.0
        ),
        "preempt_nominations": multi.get("preempt_nominations", 0),
        "preemptions": multi.get("preemptions", 0),
    }
