"""Mirror of ``tests/test_native_ledger.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Native C++ fixed-point ledger vs the pure-Python golden model (reference: FixedPoint/LocalResourceManager semantics, src/ray/common/scheduling/fixed_point.h, local_resource_manager.h).
"""
import numpy as np
import pytest

from ray_tpu_torch.scheduler.resources import (
    NodeResourceLedger,
    ResourceRequest,
    ResourceVocab,
)


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield

native_ledger = pytest.importorskip("ray_tpu_torch.native.native_ledger")


@pytest.fixture()
def pair():
    va, vb = ResourceVocab(), ResourceVocab()
    total = {"CPU": 8.0, "memory": 1024.0, "TPU": 4.0}
    return (
        native_ledger.NativeNodeResourceLedger(va, total),
        NodeResourceLedger(vb, total),
        va,
        vb,
    )


def test_parity_random_ops(pair):
    nat, py, va, vb = pair
    rng = np.random.default_rng(0)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.4:
            rn, rp = held.pop(rng.integers(len(held)))
            nat.release(rn)
            py.release(rp)
            continue
        demand = {
            "CPU": float(rng.choice([0.25, 0.5, 1.0, 2.0])),
            "memory": float(rng.choice([0.0, 16.0, 64.0])),
            "TPU": float(rng.choice([0.0, 0.0, 1.0])),
        }
        rn = ResourceRequest.from_map(va, demand)
        rp = ResourceRequest.from_map(vb, demand)
        got_n = nat.try_allocate(rn)
        got_p = py.try_allocate(rp)
        assert got_n == got_p
        if got_n:
            held.append((rn, rp))
        assert nat.avail_map() == py.avail_map()
    for rn, rp in held:
        nat.release(rn)
        py.release(rp)
    assert nat.avail_map() == nat.total_map() == py.total_map()


def test_fractional_exactness(pair):
    nat, _, va, _ = pair
    req = ResourceRequest.from_map(va, {"CPU": 0.0001})
    for _ in range(10_000):  # 1.0 CPU total in 1/10000 steps
        assert nat.try_allocate(req)
    assert abs(nat.avail_map()["CPU"] - 7.0) < 1e-9


def test_grant_or_reject_atomic(pair):
    nat, _, va, _ = pair
    # request feasible on CPU but infeasible on TPU: must not partially deduct
    req = ResourceRequest.from_map(va, {"CPU": 1.0, "TPU": 100.0})
    assert not nat.try_allocate(req)
    assert nat.avail_map()["CPU"] == 8.0


def test_vocab_growth(pair):
    nat, _, va, _ = pair
    custom = {f"custom/{i}": 1.0 for i in range(20)}  # force capacity double
    nat.add_capacity(custom)
    req = ResourceRequest.from_map(va, {"custom/19": 1.0})
    assert nat.try_allocate(req)
    assert not nat.try_allocate(req)
    nat.release(req)
    assert nat.avail_map()["custom/19"] == 1.0
