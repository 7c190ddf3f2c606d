"""The elasticity plane and the serve capacity plan on the port
(``scheduler/elasticity.py``, ``scheduler/serve_demand.py``, copied host
code over the ported programs): the scenarios of ``tests/test_elasticity.py``
go through the reference and the port on the CPU, and the demand matrix,
the solve and the actuation plan agree."""
import dataclasses

import numpy as np
import pytest

from ray_tpu.scheduler import elasticity as JE
from ray_tpu.scheduler import serve_demand as JS
from ray_tpu_torch.scheduler import elasticity as TE
from ray_tpu_torch.scheduler import serve_demand as TS

PRESSURE = {"tenant-a": {"waiting": 16, "waiting_tokens": 0}}


def _snap(mod, width=2, nodes=2, cpu=8.0, gangs=(), **kw):
    avail = np.zeros((nodes, width), dtype=np.float32)
    avail[:, 0] = cpu
    for row, value in kw.pop("avail_cpu", {}).items():
        avail[row, 0] = value
    wants = []
    for gid, current, want, gcpu, min_size in gangs:
        row = np.zeros(width, dtype=np.float32)
        row[0] = gcpu
        wants.append(mod.GangWant(gang_id=gid, current=current, want=want, min_size=min_size,
                                  row=row, members_by_node={}))
    totals = np.zeros_like(avail)
    totals[:, 0] = cpu
    return mod.ElasticSnapshot(
        width=width, avail=avail, totals=totals, alive=np.ones(nodes, dtype=bool),
        node_ids=[f"n{i}" for i in range(nodes)], serve_pressure=kw.pop("serve_pressure", {}),
        gang_wants=wants, task_shapes=kw.pop("task_shapes", {}),
        lease_load=kw.pop("lease_load", {}))


SCENARIOS = {
    "serve-gang-task": dict(serve_pressure={"dep": PRESSURE}, gangs=[("g0", 1, 3, 2.0, 1)],
                            task_shapes={((0, 4.0),): 5}),
    "overflow-to-hypo": dict(nodes=1, cpu=4.0, serve_pressure={"dep": PRESSURE},
                             gangs=[("g0", 1, 2, 2.0, 1)]),
    "idle-fleet": dict(nodes=3),
    "consolidate": dict(nodes=2, lease_load={"n1": 2}, avail_cpu={1: 4.0}),
    "unplaceable-task": dict(nodes=2, lease_load={"n1": 2}, avail_cpu={1: 4.0},
                             task_shapes={((0, 64.0),): 1}),
    "provision-capped": dict(nodes=1, cpu=0.0, gangs=[("g0", 0, 8, 2.0, 1)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_assemble_solve_and_plan_match_the_reference(name):
    outs = []
    for mod, kw in ((JE, {}), (TE, {"device": "cpu"})):
        snap = _snap(mod, **SCENARIOS[name])
        matrix = mod.assemble_demand(snap)
        hypo = np.zeros((2, 2), dtype=np.float32)
        hypo[:, 0] = 2.0
        solved = mod.solve_demand(snap.avail, matrix, hypo_rows=hypo, iters=24, **kw)
        plan = mod.build_plan(snap, matrix, solved, idle_since={n: 0.0 for n in snap.node_ids},
                              now=1000.0, min_nodes=1, idle_retire_s=30.0, retire_max=2,
                              provision_max=3, **kw)
        outs.append((matrix, solved, plan))
    (jm, js, jp), (tm, ts, tp) = outs
    for f in ("shapes", "counts", "classes", "weights"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f))
    assert jm.owners == tm.owners
    assert js.path == ts.path
    np.testing.assert_array_equal(js.placed, ts.placed)
    np.testing.assert_array_equal(js.per_node, ts.per_node)
    jd, td = dataclasses.asdict(jp), dataclasses.asdict(tp)
    jd.pop("tick_ms"), td.pop("tick_ms")
    assert jd == td


def test_dedupe_and_credit_match_the_reference():
    key, other = (("CPU", 2.0),), (("CPU", 4.0),)
    args = dict(parked={key: 5, other: 3}, deferred={key: 2, other: 4}, ring_keys=[key])
    assert TE.dedupe_task_shapes(**args) == JE.dedupe_task_shapes(**args) == {key: 5, other: 7}
    credited = []
    for mod in (JE, TE):
        snap = _snap(mod, nodes=2, cpu=1.0, gangs=[("g0", 2, 4, 2.0, 1)])
        snap.gang_wants[0].members_by_node.update({"n0": 1, "n1": 1})
        credited.append(mod.credit_gang_usage(snap.avail, snap.node_ids, snap.gang_wants))
    np.testing.assert_array_equal(credited[0], credited[1])
    assert credited[1][:, 0].tolist() == [3.0, 3.0]


@pytest.mark.parametrize("cpu_rows", [[4.0, 0.5], [], [8.0, 8.0, 8.0]])
def test_capacity_plan_matches_the_reference(cpu_rows):
    pressure = {"dep-a": {"t1": {"waiting": 40, "waiting_tokens": 9000}},
                "dep-b": {"t2": {"waiting": 3, "waiting_tokens": 0}}}
    for p in (pressure, {}):
        want = JS.capacity_plan(cpu_rows, JS.pressure_rollup(p))
        got = TS.capacity_plan(cpu_rows, TS.pressure_rollup(p), device="cpu")
        assert want == got


def test_busy_node_stays_while_demand_overflows_to_new_nodes():
    """Queue C 11: parked demand that fills the idle node and spills onto
    hypothetical nodes must not let the controller consolidation-retire
    the busy node in the same plan. The reference counts the spilled
    demand as placed and retires it, so the next tick provisions its
    replacement (the retire-then-reprovision that gave the cluster test a
    third node under load); the port provisions and keeps it."""
    plans = []
    for mod, kw in ((JE, {}), (TE, {"device": "cpu"})):
        snap = _snap(mod, nodes=2, cpu=2.0, lease_load={"n0": 2}, avail_cpu={0: 0.0},
                     task_shapes={((0, 1.0),): 5})
        matrix = mod.assemble_demand(snap)
        hypo = np.zeros((2, 2), dtype=np.float32)
        hypo[:, 0] = 2.0
        solved = mod.solve_demand(snap.avail, matrix, hypo_rows=hypo, iters=24, **kw)
        plans.append(mod.build_plan(snap, matrix, solved, idle_since={n: 0.0 for n in snap.node_ids},
                                    now=1000.0, min_nodes=1, idle_retire_s=30.0, retire_max=2,
                                    provision_max=3, **kw))
    ref, port = plans
    assert ref.provision == port.provision == 2
    assert ref.retire == ["n0"]  # the reference's churn
    assert port.retire == [] and port.migrate == []


def _mixed_fleet_peak(mod, parked):
    """The mixed fleet's controller snapshot at its peak on the card: two
    agents of 4 CPUs and a GPU (the two replicas on a quarter GPU each),
    the 2-rank gang of 1 CPU a rank SPREAD over them, ``parked`` requests
    in the router's waiting room."""
    totals = np.array([[4.0, 1.0], [4.0, 1.0]], dtype=np.float32)
    avail = np.array([[3.0, 0.75], [3.0, 0.75]], dtype=np.float32)
    gang = mod.GangWant(gang_id="gang", current=2, want=2, min_size=1,
                        row=np.array([1.0, 0.0], dtype=np.float32),
                        members_by_node={"n0": 1, "n1": 1})
    return mod.ElasticSnapshot(
        width=2, avail=avail, totals=totals, alive=np.ones(2, dtype=bool),
        node_ids=["n0", "n1"],
        serve_pressure={"mix-llm": {"default": {"waiting": parked, "waiting_tokens": 0}}},
        gang_wants=[gang])


def _plan(mod, snap):
    avail = mod.credit_gang_usage(snap.avail, snap.node_ids, snap.gang_wants)
    matrix = mod.assemble_demand(snap)
    kw = {"device": "cpu"} if mod is TE else {}
    solved = mod.solve_demand(avail, matrix, **kw)
    return mod.build_plan(snap, matrix, solved, retire_max=0, provision_max=0, **kw)


@pytest.mark.parametrize("parked, hint", [(0, 2), (16, 2), (74, 1), (124, 1)])
def test_parked_serve_demand_outbids_the_gang(parked, hint):
    """Queue C 24-25: on the card the mixed fleet's peak parked 124
    requests and the controller still hinted world 2. Not the controller:
    on that snapshot it cedes, the port as the reference (a serve row a
    queue of 8 outbids the gang's seats once they no longer fit beside
    it); the ticks came too late (the waiting room's polling starved the
    client process, Queue C 25)."""
    got = _plan(TE, _mixed_fleet_peak(TE, parked))
    want = _plan(JE, _mixed_fleet_peak(JE, parked))
    assert got.world_hints == want.world_hints == {"gang": hint}
    assert got.serve_hints == want.serve_hints
    assert got.unfulfilled == want.unfulfilled
