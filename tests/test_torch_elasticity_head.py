"""The unified elasticity controller on the port's ``HeadServer``.

Mirror of the head-only cases of ``tests/test_elasticity.py``
(``test_controller_tick_lands_hints_on_head``,
``test_head_drain_zeroes_avail_and_finish_restores`` and the slow
``test_mixed_fleet_trough_absorb_peak_cede``, slow here as there), the same
assertions. The controller's solve runs on the head's scheduler device,
here the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``). One case more holds the
controller's plan against the JAX package's head on the same tables.
"""
import importlib
import time

import pytest


@pytest.fixture(autouse=True)
def _sched_on_cpu(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


# ---------------------------------------------------------------------------
# controller against a live head (hints land, QueryState exposes state)
# ---------------------------------------------------------------------------
def test_controller_tick_lands_hints_on_head(monkeypatch):
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "0")
    from ray_tpu_torch.cluster.common import NodeInfo
    from ray_tpu_torch.cluster.head import HeadServer

    head = HeadServer(dashboard_port=None)
    try:
        with head._cond:
            for i in range(2):
                nid = f"n{i}"
                head.nodes[nid] = NodeInfo(
                    node_id=nid, address="", resources={"CPU": 8.0}
                )
                head.view.add_node(nid, head.nodes[nid].resources)
            head._serve_budget["dep"] = {
                "r0": {
                    "pressure": {
                        "t0": {"waiting": 16, "waiting_tokens": 0}
                    },
                    "ts": time.monotonic(),
                }
            }
            head._gangs["g0"] = {
                "epoch": 1,
                "owner": "test",
                "members": {0: "n0"},
                "min_size": 1,
                "dead_ranks": [],
                "updated": time.monotonic(),
                "want_world": 3,
                "resources_per_rank": {"CPU": 2.0},
                "grow": True,
                "world_hint": None,
            }
        ctrl = head._elasticity
        summary = ctrl.tick()
        assert summary["path"] in ("solve", "first_fit")
        # serve hint landed where the budget reply reads
        hint = head._serve_capacity_hints["dep"]["hint"]
        assert hint["source"] == "elastic_controller"
        assert hint["replicas_wanted"] == 2
        # gang world hint landed in the table (16 CPU fleet: all 3 fit)
        assert head._gangs["g0"]["world_hint"] == 3
        # observability: QueryState exposes the controller state
        state = head._h_query_state({"kind": "elasticity"})
        assert state["ticks"] == 1
        assert state["enabled"] is False
        assert state["last_plan"]["path"] == summary["path"]
    finally:
        head.shutdown(stop_agents=False)


def test_head_drain_zeroes_avail_and_finish_restores(monkeypatch):
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "0")
    from ray_tpu_torch.cluster.common import NodeInfo, NodeReport
    from ray_tpu_torch.cluster.head import HeadServer

    head = HeadServer(dashboard_port=None)
    try:
        with head._cond:
            head.nodes["n0"] = NodeInfo(
                node_id="n0", address="", resources={"CPU": 4.0}
            )
            head.view.add_node("n0", head.nodes["n0"].resources)
        assert head.begin_node_drain("n0", deadline_s=30.0)
        _, avail, _ = head.view.active_arrays()
        assert float(avail.sum()) == 0.0
        # heartbeats while draining stay clamped to zero and tell the
        # agent to stop warming its pool
        reply = head._h_node_report(
            NodeReport(node_id="n0", available={"CPU": 4.0}, version=1)
        )
        assert reply["draining"] is True
        _, avail, _ = head.view.active_arrays()
        assert float(avail.sum()) == 0.0
        assert head.node_drained("n0")
        # cancel: the node returns to service, next report restores avail
        head.finish_node_drain("n0", retire=False)
        reply = head._h_node_report(
            NodeReport(node_id="n0", available={"CPU": 4.0}, version=2)
        )
        assert reply["draining"] is False
        _, avail, _ = head.view.active_arrays()
        assert float(avail.sum()) == pytest.approx(4.0)
    finally:
        head.shutdown(stop_agents=False)


# ---------------------------------------------------------------------------
# slow: mixed-fleet trough-absorb / peak-cede on a synthetic 2-node head
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_mixed_fleet_trough_absorb_peak_cede(monkeypatch):
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "0")
    monkeypatch.setenv("RAY_TPU_ELASTIC_RETIRE_MAX", "0")
    from ray_tpu_torch.cluster.common import NodeInfo
    from ray_tpu_torch.cluster.head import HeadServer

    head = HeadServer(dashboard_port=None)
    try:
        with head._cond:
            for i in range(2):
                nid = f"n{i}"
                head.nodes[nid] = NodeInfo(
                    node_id=nid, address="", resources={"CPU": 8.0}
                )
                head.view.add_node(nid, head.nodes[nid].resources)
            head._gangs["gang"] = {
                "epoch": 1,
                "owner": "trainer",
                "members": {0: "n0", 1: "n0"},
                "min_size": 1,
                "dead_ranks": [],
                "updated": time.monotonic(),
                "want_world": 6,
                "resources_per_rank": {"CPU": 2.0},
                "grow": True,
                "world_hint": None,
            }

        def set_pressure(waiting):
            with head._lock:
                head._serve_budget["dep"] = {
                    "r0": {
                        "pressure": {
                            "t0": {
                                "waiting": waiting,
                                "waiting_tokens": 0,
                            }
                        },
                        "ts": time.monotonic(),
                    }
                }

        ctrl = head._elasticity
        # trough: 2 serve replicas leave 14 CPU -> the gang absorbs it
        set_pressure(16)  # 16/8 = 2 replicas
        ctrl.tick()
        trough_hint = head._gangs["gang"]["world_hint"]
        assert trough_hint == 6, ctrl.last_plan.summary()
        # peak: 14 replicas of 1 CPU outbid the gang (weight order) on
        # the 16-CPU fleet -> the gang cedes to what is left
        set_pressure(14 * 8)
        ctrl.tick()
        peak_plan = ctrl.last_plan.summary()
        peak_hint = head._gangs["gang"]["world_hint"]
        assert peak_hint < trough_hint, peak_plan
        assert peak_hint >= 1
        # serve held its claim while the gang ceded
        serve = peak_plan["serve_hints"]["dep"]
        assert serve["replicas_placeable"] >= 12, peak_plan
        # overflow demand asked for new capacity (hypothetical columns)
        assert peak_plan["provision"] >= 1, peak_plan
        # trough again: the gang takes the capacity back — no disk
        # restore is even possible here (no trainer state): grow-back is
        # purely the solver verdict rising, which the training job applies via
        # seals + refit (test_elastic_train covers the zero-restore fit)
        set_pressure(16)
        ctrl.tick()
        assert head._gangs["gang"]["world_hint"] == trough_hint
        # tick latency is recorded for the p99 export
        pct = ctrl.tick_percentiles()
        assert pct["p99_ms"] > 0.0
    finally:
        head.shutdown(stop_agents=False)


def _loaded_head(pkg, nodes=6, gangs=2, tasks=12):
    """A head with nodes, serve pressure, under-world gangs and parked
    task shapes too large for any node (so they stay parked)."""
    common = importlib.import_module(f"{pkg}.cluster.common")
    head = importlib.import_module(f"{pkg}.cluster.head").HeadServer(dashboard_port=None)
    with head._cond:
        for i in range(nodes):
            nid = f"n{i}"
            head.nodes[nid] = common.NodeInfo(
                node_id=nid, address="", resources={"CPU": 8.0 + 4 * (i % 3)}
            )
            head.view.add_node(nid, head.nodes[nid].resources)
        head._serve_budget["dep"] = {
            "r0": {
                "pressure": {
                    f"t{k}": {"waiting": 8 * (k + 1), "waiting_tokens": 0}
                    for k in range(3)
                },
                "ts": time.monotonic(),
            }
        }
        for g in range(gangs):
            head._gangs[f"g{g}"] = {
                "epoch": 1,
                "owner": "test",
                "members": {0: f"n{g}"},
                "min_size": 1,
                "dead_ranks": [],
                "updated": time.monotonic(),
                "want_world": 3 + g,
                "resources_per_rank": {"CPU": 2.0},
                "grow": True,
                "world_hint": None,
            }
        for t in range(tasks):
            head._infeasible.append(common.LeaseRequest(
                task_id=f"t{t}", name="sim", payload=b"", return_ids=[],
                resources={"CPU": 20.0 + t % 4}, max_retries=0,
            ))
    return head


def test_controller_plan_matches_the_jax_head(monkeypatch):
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "0")
    # hypothetical nodes big enough for the parked shapes: they provision
    monkeypatch.setenv("RAY_TPU_ELASTIC_NODE_CPUS", "32")
    plans = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        head = _loaded_head(pkg)
        try:
            head._elasticity.tick()
            summary = head._elasticity.last_plan.summary()
            summary.pop("tick_ms", None)
            plans[pkg] = (summary, {g: head._gangs[g]["world_hint"] for g in head._gangs})
        finally:
            head.shutdown(stop_agents=False)
    assert plans["ray_tpu_torch"] == plans["ray_tpu"]
    summary, hints = plans["ray_tpu_torch"]
    assert summary["path"] == "solve" and summary["provision"] >= 1
    assert all(h >= 1 for h in hints.values())
