"""Mirror of ``tests/test_chip_assignment.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Intra-node accelerator (chip index) assignment.
"""
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.scheduler.instances import AcceleratorInstanceSet, NodeAcceleratorState


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# ---------------------------------------------------------------------------
# unit: the instance set itself
# ---------------------------------------------------------------------------


def test_instance_set_whole_chips_disjoint():
    s = AcceleratorInstanceSet(4)
    a = s.allocate(2.0)
    b = s.allocate(2.0)
    assert {i for i, _ in a}.isdisjoint({i for i, _ in b})
    assert s.allocate(1.0) is None  # full
    s.release(a)
    assert s.allocate(2.0) is not None


def test_instance_set_fractions_pack_one_chip():
    s = AcceleratorInstanceSet(2)
    a = s.allocate(0.5)
    b = s.allocate(0.5)
    assert a[0][0] == b[0][0]  # same chip
    c = s.allocate(1.0)  # the other chip is still whole
    assert c is not None and c[0][0] != a[0][0]


def test_instance_set_rejects_noninteger_multichip():
    s = AcceleratorInstanceSet(4)
    assert s.allocate(1.5) is None


def test_env_rendering():
    st = NodeAcceleratorState({"TPU": 4})
    assign = st.allocate({"TPU": 2.0})
    env = NodeAcceleratorState.env_for(assign)
    assert sorted(env["TPU_VISIBLE_CHIPS"].split(",")) == ["0", "1"]


# ---------------------------------------------------------------------------
# in-process runtime
# ---------------------------------------------------------------------------


def test_inprocess_tasks_get_disjoint_chips():
    rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "TPU": 4})
    try:
        import threading

        gate = threading.Barrier(2, timeout=30)

        @ray_tpu_torch.remote(num_tpus=2, num_cpus=1)
        def chips():
            ids = ray_tpu_torch.get_runtime_context().get_accelerator_ids()["TPU"]
            gate.wait()  # hold both tasks concurrently
            return ids

        a, b = ray_tpu_torch.get([chips.remote(), chips.remote()], timeout=60)
        assert len(a) == 2 and len(b) == 2
        assert set(a).isdisjoint(set(b))
    finally:
        ray_tpu_torch.shutdown()


def test_inprocess_fractional_shares_chip():
    rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "TPU": 2})
    try:
        import threading

        gate = threading.Barrier(2, timeout=30)

        @ray_tpu_torch.remote(resources={"TPU": 0.5}, num_cpus=1)
        def chip():
            ids = ray_tpu_torch.get_runtime_context().get_accelerator_ids()["TPU"]
            gate.wait()
            return ids

        a, b = ray_tpu_torch.get([chip.remote(), chip.remote()], timeout=60)
        assert a == b and len(a) == 1  # both share the one chip
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# multi-process cluster: env var asserted inside the actor's worker process
# ---------------------------------------------------------------------------


class _ChipActor:
    def visible(self):
        import os

        return os.environ.get("TPU_VISIBLE_CHIPS")


def test_cluster_actors_disjoint_chips_and_fractional_share():
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 8.0, "TPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    try:
        Actor = ray_tpu_torch.remote(_ChipActor)
        a = Actor.options(num_tpus=2, num_cpus=0).remote()
        b = Actor.options(num_tpus=2, num_cpus=0).remote()
        va = ray_tpu_torch.get(a.visible.remote(), timeout=60)
        vb = ray_tpu_torch.get(b.visible.remote(), timeout=60)
        sa, sb = set(va.split(",")), set(vb.split(","))
        assert len(sa) == 2 and len(sb) == 2
        assert sa.isdisjoint(sb), (va, vb)
        # free two chips; fractional pair shares ONE of them
        client.kill_actor(a, no_restart=True)
        f1 = Actor.options(resources={"TPU": 0.5}, num_cpus=0).remote()
        f2 = Actor.options(resources={"TPU": 0.5}, num_cpus=0).remote()
        v1 = ray_tpu_torch.get(f1.visible.remote(), timeout=60)
        v2 = ray_tpu_torch.get(f2.visible.remote(), timeout=60)
        assert v1 == v2 and len(v1.split(",")) == 1, (v1, v2)
        assert v1 not in vb.split(",")  # not one of b's chips
        # with b (2 chips) + the shared fractional chip held, a further
        # 2-whole-chip actor cannot fit: chips are a hard resource
        c2 = Actor.options(num_tpus=2, num_cpus=0).remote()
        with pytest.raises(Exception):
            ray_tpu_torch.get(c2.visible.remote(), timeout=3)
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()
