"""The port's local runtime held against the JAX package's, on the CPU.

Each case builds one runtime of each package from the same ``add_node``
sequence (node resources from a numpy seed) and compares what they place:
the dense view, one scheduling round through ``device_state.schedule``,
placement-group bundles through ``try_schedule``, and the values of a fixed
workload. The JAX side runs its scheduler programs on host XLA, as its own
tests do; the port runs its torch programs on the CPU
(``RAY_TPU_SCHED_PLATFORM=cpu``, which both packages read). Node ids are
uuid4s, so placements are compared by node row (the order nodes were
added). Placements are integers and must be equal; the view arrays are
equal bit for bit.

Round-level parity holds from a fresh runtime only: the device state's
seed starts at 0 and advances once a round. Each runtime is private to its
case (no ``init``), except in the workload case, which runs one package's
``init`` after the other's ``shutdown``: an ObjectRef of one package never
reaches the other.
"""
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import placement_group as JPG
from ray_tpu.core import runtime as JR
from ray_tpu.scheduler import ResourceRequest as JRequest
from ray_tpu_torch.core import placement_group as TPG
from ray_tpu_torch.core import runtime as TR
from ray_tpu_torch.scheduler import ResourceRequest as TRequest


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    monkeypatch.setenv("RAY_TPU_SCHED_PREWARM", "0")


def _node_resources(seed, n):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        res = {"CPU": float(rng.integers(2, 17)), "memory": float(rng.integers(1, 33))}
        if rng.random() < 0.3:
            res["GPU"] = float(rng.integers(1, 5))
        if i % 4 == 3:
            res["CPU"] = float(np.round(rng.uniform(1, 8) * 4) / 4)
        nodes.append(res)
    return nodes


@pytest.fixture(params=[0, 1, 2])
def pair(request):
    """(JAX runtime, port runtime, node ids of each in add order)."""
    nodes = _node_resources(request.param, 12)
    pair = []
    for mod in (JR, TR):
        rt = mod.Runtime(num_nodes=0)
        ids = [rt.add_node(res, labels={"i": str(i)}) for i, res in enumerate(nodes)]
        pair.append((rt, ids))
    yield pair, request.param
    for rt, _ in pair:
        rt.shutdown()


def test_view_arrays_equal(pair):
    ((jrt, _), (trt, _)), _ = pair
    for a, b in zip(jrt.view.active_arrays(), trt.view.active_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert jrt.device_state is not None and trt.device_state.device.type == "cpu"


def _demands(rt, request_cls, seed, b):
    rng = np.random.default_rng(100 + seed)
    r = rt.view.totals.shape[1]
    rows = []
    for _ in range(b):
        res = {"CPU": float(rng.choice([0.25, 0.5, 1.0, 2.0, 4.0]))}
        if rng.random() < 0.2:
            res["GPU"] = 1.0
        if rng.random() < 0.5:
            res["memory"] = float(rng.integers(1, 4))
        rows.append(request_cls.from_map(rt.vocab, res).dense(r))
    return np.stack(rows).astype(np.float32)


def test_one_round_places_on_equal_rows(pair):
    ((jrt, _), (trt, _)), seed = pair
    placed = []
    for rt, req in ((jrt, JRequest), (trt, TRequest)):
        demands = _demands(rt, req, seed, 96)
        state = rt.device_state
        with rt._lock:
            state.sync(rt.view)
        placed.append(np.asarray(state.schedule(demands)))
    np.testing.assert_array_equal(placed[0], placed[1])
    assert (placed[0] >= 0).any() and (placed[0] < 0).any()


@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_SPREAD"])
def test_bundles_land_on_equal_rows(pair, strategy):
    ((jrt, jids), (trt, tids)), seed = pair
    rng = np.random.default_rng(200 + seed)
    groups = [[{"CPU": float(rng.choice([0.5, 1.0, 2.0])), "memory": 1.0}
               for _ in range(int(rng.integers(2, 6)))] for _ in range(3)]
    rows = []
    for rt, ids, mod in ((jrt, jids, JPG), (trt, tids, TPG)):
        got = []
        for bundles in groups:
            state = mod.PlacementGroupState(rt, bundles, strategy)
            ok = state.try_schedule()
            got.append((ok, [ids.index(b.node_id) if ok else -1 for b in state.bundles]))
        rows.append(got)
    assert rows[0] == rows[1]
    assert any(ok for ok, _ in rows[0])
    for a, b in zip(jrt.view.active_arrays(), trt.view.active_arrays()):
        np.testing.assert_array_equal(a, b)


def _workload(api):
    """Tasks, a chain of ObjectRef args, an actor, a placement group and a
    streaming generator; returns every value."""
    from importlib import import_module

    strategies = import_module(api.__name__ + ".core.scheduling_strategies")

    @api.remote(num_returns=2)
    def split(x):
        return x, x * 3

    @api.remote
    def add(a, b):
        return a + b

    @api.remote
    def square(x):
        return np.float32(x) ** 2

    @api.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def bump(self, k):
            self.n += k
            return self.n

    def count(n):
        for i in range(n):
            yield i * i

    out = {}
    a, b = split.remote(7)
    out["split"] = api.get([a, b], timeout=60)
    ref = api.put(1)
    for i in range(20):
        ref = add.remote(ref, i)
    out["chain"] = api.get(ref, timeout=60)
    out["squares"] = api.get([square.remote(i) for i in range(16)], timeout=60)
    c = Counter.remote(10)
    out["actor"] = api.get([c.bump.remote(k) for k in range(8)], timeout=60)
    pg = api.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert api.get(pg.ready(), timeout=60) is True
    in_pg = add.options(scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=1)).remote(2, 3)
    out["pg"] = api.get(in_pg, timeout=60)
    gen = api.remote(count).options(num_returns="streaming", num_cpus=0.5).remote(6)
    out["stream"] = [api.get(r, timeout=60) for r in gen]
    return out


def test_workload_values_equal():
    values = []
    for api in (ray_tpu, ray_tpu_torch):
        api.init(num_nodes=3, resources_per_node={"CPU": 4, "memory": 8.0})
        try:
            values.append(_workload(api))
        finally:
            api.shutdown()
    assert values[0] == values[1]
    assert values[1]["chain"] == 1 + sum(range(20))
    assert values[1]["stream"] == [i * i for i in range(6)]
