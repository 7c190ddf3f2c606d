"""Model-aware routing, the serve-pressure capacity loop and the fleet's
capacity-hint latch on the port: the routing and fleet cases of
``tests/test_disagg.py`` (picking a replica by model, pressure rolled up
into demand rows and a capacity plan, admission's pressure by tenant, the
local coordinator's budget hint, the SLO autoscaler held by a capacity
hint) and of ``tests/test_elasticity.py`` (the hint latch), with
``ray_tpu`` read as ``ray_tpu_torch``. The capacity plan runs on the host
(``device="cpu"``), where the reference runs its jnp program on the
default device. ``tests/test_torch_disagg.py`` holds the engine cases.
"""
import threading
import time
from types import SimpleNamespace

import pytest


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the local coordinator's capacity plan runs on the scheduler's
    # device, cuda unless this says the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# ---------------------------------------------------------------------------
# model-aware routing
# ---------------------------------------------------------------------------
def _bare_replica_set(models, n=2):
    from ray_tpu_torch.serve.deployment import _Replica, _ReplicaSet

    rs = _ReplicaSet.__new__(_ReplicaSet)
    rs.dep = SimpleNamespace(name="dep", models=models)
    rs.lock = threading.Lock()
    rs.replicas = [_Replica(actor=None) for _ in range(n)]
    return rs


def test_pick_replica_unknown_model_raises():
    from ray_tpu_torch.serve import NoReplicasForModel

    rs = _bare_replica_set(models=["m0", "m1"])
    with pytest.raises(NoReplicasForModel) as ei:
        rs._pick_replica(model="nope")
    assert ei.value.deployment == "dep"
    assert ei.value.model == "nope"


def test_pick_replica_cold_model_marks_victim():
    rs = _bare_replica_set(models=["m0", "m1"], n=3)
    rs.replicas[0].model = "m0"
    rs.replicas[0].ongoing = 0
    rs.replicas[1].ongoing = 5
    rs.replicas[2].ongoing = 1
    # cold model prefers a never-swapped replica (model=None), least
    # loaded, and marks it so a concurrent same-model pick routes there
    r = rs._pick_replica(model="m1")
    assert r is rs.replicas[2]
    assert r.model == "m1"
    # same model now routes within its replica set, not a new victim
    assert rs._pick_replica(model="m1") is rs.replicas[2]


def test_pick_replica_all_draining_raises():
    from ray_tpu_torch.serve import NoReplicasForModel

    rs = _bare_replica_set(models=["m0"], n=2)
    for r in rs.replicas:
        r.draining = True
    with pytest.raises(NoReplicasForModel):
        rs._pick_replica(model="m0")


def _spread(pkg, models, n, model, calls=40):
    """Requests per replica over ``calls`` picks naming ``model``, one
    replica of ``n`` marked with the base first, each pick left ongoing."""
    import importlib

    dep = importlib.import_module(f"{pkg}.serve.deployment")
    rs = dep._ReplicaSet.__new__(dep._ReplicaSet)
    rs.dep = SimpleNamespace(name="dep", models=models)
    rs.lock = threading.Lock()
    rs.replicas = [dep._Replica(actor=None, model=(models or [model])[0])]
    rs.replicas += [dep._Replica(actor=None) for _ in range(n - 1)]  # as add_replica leaves them
    for _ in range(calls):
        rs._pick_replica(model=model).ongoing += 1
    return [r.ongoing for r in rs.replicas], [r.model for r in rs.replicas]


@pytest.mark.parametrize("models", [["m0", "m1"], None], ids=["variants", "single_model"])
def test_replica_added_under_named_model_traffic_takes_it(models):
    # Queue C 10: the base's traffic ("m0" with variants; any name in a
    # deployment without models) reaches a replica that add_replica left
    # unmarked; the reference keeps it to the replica marked first
    got, marks = _spread("ray_tpu_torch", models, 2, "m0")
    assert sum(got) == 40 and min(got) >= 15, got
    if models:
        assert marks == ["m0", "m0"]
    ref, _ = _spread("ray_tpu", models, 2, "m0")
    assert ref == [40, 0]


def test_replica_added_under_variant_traffic_stays_off_it():
    # a variant's traffic stays with its holder: an unmarked replica holds
    # the base, and would have to swap
    got, marks = _spread("ray_tpu_torch", ["m0", "m1"], 2, "m1")
    assert got == [0, 40] and marks == ["m0", "m1"]  # cold: one swap, on the fresh one
    # the base is models[0], whatever its name
    got, marks = _spread("ray_tpu_torch", ["m1", "m0"], 3, "m1")
    assert sum(got) == 40 and min(got) >= 8 and marks == ["m1"] * 3, got


# ---------------------------------------------------------------------------
# serve pressure -> demand rows -> capacity plan
# ---------------------------------------------------------------------------
def test_pressure_rollup_merges_routers():
    from ray_tpu_torch.scheduler.serve_demand import pressure_rollup

    reports = {
        "r1": {"pressure": {"a": {"waiting": 2, "waiting_tokens": 100}}},
        "r2": {
            "pressure": {
                "a": {"waiting": 1, "waiting_tokens": 50},
                "b": {"waiting": 3, "waiting_tokens": 900},
            }
        },
        "r3": {},  # router with no pressure entry
    }
    got = pressure_rollup(reports)
    assert got == {
        "a": {"waiting": 3, "waiting_tokens": 150},
        "b": {"waiting": 3, "waiting_tokens": 900},
    }


def test_pressure_to_demand_rows_replica_equivalents():
    from ray_tpu_torch.scheduler.serve_demand import pressure_to_demand_rows

    demands, owners = pressure_to_demand_rows(
        {
            # 9000 tokens / 4096 per replica -> ceil = 3 rows
            "a": {"waiting": 1, "waiting_tokens": 9000},
            # 9 waiting / 8 per replica -> ceil = 2 rows
            "b": {"waiting": 9, "waiting_tokens": 10},
        },
        tokens_per_replica=4096.0,
        queue_per_replica=8.0,
    )
    assert demands.shape == (5, 1)
    assert owners == ["a", "a", "a", "b", "b"]
    # cap: one flooding tenant cannot blow up the kernel batch
    demands, owners = pressure_to_demand_rows(
        {"flood": {"waiting": 10_000, "waiting_tokens": 0}}, max_rows=16
    )
    assert demands.shape == (16, 1)


def test_capacity_plan_places_through_binpack():
    from ray_tpu_torch.scheduler.serve_demand import capacity_plan

    assert capacity_plan([4.0], {}, device="cpu") is None  # no pressure: idle path
    plan = capacity_plan(
        [2.0, 1.0],
        {
            "a": {"waiting": 0, "waiting_tokens": 9000},  # 3 rows
            "b": {"waiting": 9, "waiting_tokens": 0},  # 2 rows
        },
        device="cpu",
    )
    assert plan["replicas_wanted"] == 5
    assert plan["replicas_placeable"] == 3  # 3 CPUs of residual room
    assert plan["unfulfilled"] == 2
    assert sum(plan["by_tenant"].values()) == 3
    # no capacity at all: everything unfulfilled, nothing placed
    starved = capacity_plan(
        [], {"a": {"waiting": 9, "waiting_tokens": 0}}, device="cpu"
    )
    assert starved["replicas_placeable"] == 0
    assert starved["unfulfilled"] == starved["replicas_wanted"]


def test_admission_exports_pressure_by_tenant():
    from ray_tpu_torch.serve.admission import AdmissionController

    ctl = AdmissionController(max_inflight=1, wait_timeout_s=5.0)
    first = ctl.admit("a", cost=3)
    parked = threading.Event()
    done: dict = {}

    def blocked():
        parked.set()
        done["ticket"] = ctl.admit("b", cost=17)

    t = threading.Thread(target=blocked)
    t.start()
    parked.wait(timeout=5)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        p = ctl.pressure_by_tenant()
        if p:
            break
        time.sleep(0.01)
    assert p == {"b": {"waiting": 1, "waiting_tokens": 17}}
    first.done()
    t.join(timeout=10)
    assert not t.is_alive()
    done["ticket"].done()
    assert ctl.pressure_by_tenant() == {}


def test_local_fleet_budget_carries_capacity_hint():
    from ray_tpu_torch.serve.fleet import _LocalFleetCoordinator

    coord = _LocalFleetCoordinator()
    epoch = coord.join("dep", "r1")["epoch"]
    reply = coord.budget(
        "dep", "r1", epoch,
        usage={"a": 4},
        waiting={"a": 2},
        weights={},
        pressure={"a": {"waiting": 20, "waiting_tokens": 50_000}},
    )
    hint = reply.get("capacity_hint")
    assert hint is not None
    assert hint["replicas_wanted"] >= 3  # 50k tokens of queued prefill
    assert hint["replicas_wanted"] == (
        hint["replicas_placeable"] + hint["unfulfilled"]
    )
    # no pressure -> no hint (the idle path skips the kernel)
    reply = coord.budget(
        "dep", "r1", epoch, usage={}, waiting={}, weights={}, pressure={}
    )
    assert reply.get("capacity_hint") is None


def test_slo_autoscaler_capacity_block():
    """A fresh zero-placeable capacity hint holds an upscale the SLO
    signals would otherwise fire; headroom releases it."""
    from ray_tpu_torch.serve.slo_autoscaler import SLOAutoscaler, SLOConfig

    hint = {"replicas_placeable": 0}
    added = []
    router = SimpleNamespace(
        _rs=SimpleNamespace(
            dep=SimpleNamespace(name="dep"),
            num_replicas=1,
            add_replica=lambda: added.append(1),
        ),
        capacity_hint=lambda: hint,
    )
    clock = [0.0]
    scaler = SLOAutoscaler(
        router,
        SLOConfig(max_replicas=4, upscale_delay_s=1.0),
        metrics_fn=lambda: {
            "inflight": 100, "replicas": 1, "ttft_p50_ms": 0.0,
        },
        clock=lambda: clock[0],
    )
    assert scaler.tick() == "hold"  # arms the over-window
    clock[0] = 2.0
    assert scaler.tick() == "hold-capacity"
    assert not added and scaler.capacity_blocks == 1
    hint = None  # stale/absent hint must never block
    router.capacity_hint = lambda: hint
    clock[0] = 4.0
    assert scaler.tick() == "up"
    assert added == [1]


# ---------------------------------------------------------------------------
# the capacity-hint latch clears on drain evidence
# ---------------------------------------------------------------------------
def _fleet_shell():
    """A RouterFleet shell with just the latch state (the latch logic
    only touches _lock/_capacity_hint/_capacity_hint_ts/routers)."""
    import threading

    from ray_tpu_torch.serve.fleet import RouterFleet

    fleet = object.__new__(RouterFleet)
    fleet._lock = threading.Lock()
    fleet._capacity_hint = {"replicas_placeable": 0, "unfulfilled": 3}
    fleet._capacity_hint_ts = time.monotonic()
    fleet.routers = {}
    return fleet


def test_capacity_hint_latch_clears_on_present_none_reply():
    fleet = _fleet_shell()
    reply = {"rate": 1.0, "capacity_hint": None}
    # the reconcile branch under test: hint key present but None
    if reply.get("capacity_hint") is not None:
        pytest.fail("unexpected")
    elif fleet._capacity_hint is not None and (
        "capacity_hint" in reply or fleet._hint_drained(reply)
    ):
        with fleet._lock:
            fleet._capacity_hint = None
            fleet._capacity_hint_ts = 0.0
    assert fleet.capacity_hint() is None


def test_capacity_hint_latch_clears_when_pressure_drained():
    class _Adm:
        def __init__(self, pressure):
            self._p = pressure

        def pressure_by_tenant(self):
            return self._p

    class _Router:
        def __init__(self, pressure):
            self.admission = _Adm(pressure)

    fleet = _fleet_shell()
    # legacy coordinator reply without the hint key: parked demand still
    # present -> latch holds
    fleet.routers = {"r0": _Router({"t": {"waiting": 2, "waiting_tokens": 0}})}
    assert not fleet._hint_drained({})
    assert fleet.capacity_hint() is not None
    # all routers drained -> latch clears without waiting for the timer
    fleet.routers = {"r0": _Router({"t": {"waiting": 0, "waiting_tokens": 0}})}
    assert fleet._hint_drained({})


def test_local_coordinator_budget_reply_always_carries_hint_key():
    from ray_tpu_torch.serve.fleet import _LocalFleetCoordinator

    coord = _LocalFleetCoordinator()
    coord.join("dep", "r0")
    reply = coord.budget("dep", "r0", 1, {}, {}, {}, pressure={})
    assert "capacity_hint" in reply  # None IS the drained signal
