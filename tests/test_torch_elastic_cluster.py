"""Elastic scaling of a REAL multi-process cluster: the autoscaler +
LocalNodeProvider + InstanceManager launch actual agent subprocesses for
pending demand and terminate them when idle (the reference's
local/fake_multi_node provider + v2 instance manager, end to end).

Mirror of ``tests/test_elastic_cluster.py`` on the port (``ray_tpu_torch``),
the same cases and assertions, with one case more: the head's elasticity
controller scales a cluster up and down through
``Cluster.attach_elasticity_provider``. The head's scheduler and the
autoscaler's packing run on the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``, which
the agents inherit). Every wait has a deadline, every ``get`` a timeout.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    InstanceManager,
    LocalNodeProvider,
    NodeTypeConfig,
)
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def test_elastic_scale_up_and_down(tmp_path):
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()  # head only, ZERO nodes
    client = c.client()
    set_runtime(client)
    provider = InstanceManager(
        LocalNodeProvider(c.address, num_workers=2), launch_timeout_s=60
    )
    scaler = Autoscaler(
        client,
        [NodeTypeConfig("cpu4", {"CPU": 4.0}, min_workers=0, max_workers=3)],
        provider=provider,
        idle_timeout_s=3.0,
    )
    try:
        # demand with no nodes: tasks park as pending/infeasible
        f = ray_tpu_torch.remote(lambda x: x + 1).options(num_cpus=1.0, max_retries=0)
        refs = [f.remote(i) for i in range(8)]
        time.sleep(1.0)
        assert client.pending_resource_demands(), "demand should be visible"

        decision = scaler.tick()  # plans + launches real agents
        assert sum(decision.launch.values()) >= 1

        # the tasks complete on the elastic nodes
        assert ray_tpu_torch.get(refs, timeout=120) == [i + 1 for i in range(8)]

        # instance manager observed the nodes registering
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            provider.reconcile()
            if provider.summary().get("RUNNING", 0) >= 1:
                break
            time.sleep(0.5)
        assert provider.summary().get("RUNNING", 0) >= 1

        # idle long enough -> scale back down
        deadline = time.monotonic() + 60
        terminated = False
        while time.monotonic() < deadline:
            d = scaler.tick()
            if d.terminate:
                terminated = True
                break
            time.sleep(1.0)
        assert terminated, "idle nodes should be terminated"
    finally:
        set_runtime(None)
        client.shutdown()
        provider.shutdown()
        c.shutdown()


def test_reconciler_converges_on_flaky_cloud():
    """v2 InstanceManager vs an unreliable, eventually-consistent cloud
    (batching_node_provider shape): 25% of creates are silently lost,
    provisioning is async (0.2-1.5s), terminations are delayed, and the
    API rate-limits bursts — the reconciler must still converge to the
    requested capacity with real agent subprocesses registering."""
    from ray_tpu_torch.autoscaler import MockCloudProvider
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()  # head only
    client = c.client()
    set_runtime(client)
    cloud = MockCloudProvider(
        c.address,
        num_workers=1,
        create_failure_rate=0.25,
        create_delay_s=(0.2, 1.5),
        terminate_delay_s=0.5,
        seed=42,
    )
    # a launch is lost after 20 s, not the reference's 6: an agent takes
    # ~3 s to register on an idle host (the reference's as much), and past
    # 6 s on a host that runs the test suite's other files beside it, where
    # 6 s declared every launch lost before it could register
    im = InstanceManager(cloud, launch_timeout_s=20.0, max_retries=4)
    cfg = NodeTypeConfig("cpu2", {"CPU": 2.0}, min_workers=0, max_workers=6)
    try:
        for _ in range(3):
            im.create_node(cfg)
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            im.reconcile()
            if im.summary().get("RUNNING", 0) >= 3:
                break
            time.sleep(0.5)
        summary = im.summary()
        assert summary.get("RUNNING", 0) >= 3, (summary, cloud.lost)
        # the cluster really has >= 3 alive agents (not just records)
        alive = cloud.non_terminated_nodes()
        assert len(alive) >= 3
        # the run must have actually exercised the flaky path
        assert cloud.created >= 3

        # delayed termination: reconcile flips RUNNING -> TERMINATED once
        # membership catches up
        victim = alive[0]["NodeID"]
        im.terminate_node(victim)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            im.reconcile()
            ids = {n["NodeID"] for n in cloud.non_terminated_nodes()}
            if victim not in ids:
                break
            time.sleep(0.5)
        assert victim not in {
            n["NodeID"] for n in cloud.non_terminated_nodes()
        }
    finally:
        set_runtime(None)
        client.shutdown()
        im.shutdown()
        c.shutdown()


def test_elasticity_controller_scales_through_the_cluster_provider(monkeypatch):
    """The head-resident controller owns the fleet: parked demand on a
    head with no nodes provisions real agents through
    ``attach_elasticity_provider``, the tasks complete there, and the
    idle nodes drain and retire."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.scheduler.elasticity import ELASTIC_TICKS

    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "1")
    monkeypatch.setenv("RAY_TPU_ELASTIC_TICK_S", "0.2")
    monkeypatch.setenv("RAY_TPU_ELASTIC_IDLE_RETIRE_S", "1.0")
    monkeypatch.setenv("RAY_TPU_ELASTIC_MIN_NODES", "0")
    solves0 = ELASTIC_TICKS.value({"path": "solve"})
    fallbacks0 = ELASTIC_TICKS.value({"path": "first_fit"})
    c = Cluster()  # head only, ZERO nodes
    client = c.client()
    set_runtime(client)
    ctrl = c.head._elasticity
    try:
        provider = c.attach_elasticity_provider(
            resources={"CPU": 2.0}, num_workers=1, max_nodes=2
        )
        assert provider.node_template() == {"CPU": 2.0}
        f = ray_tpu_torch.remote(lambda x: x * 3).options(num_cpus=1.0, max_retries=0)
        refs = [f.remote(i) for i in range(6)]
        assert ray_tpu_torch.get(refs, timeout=120) == [3 * i for i in range(6)]
        assert 1 <= len(provider.created) <= 2
        assert ELASTIC_TICKS.value({"path": "solve"}) > solves0
        assert ELASTIC_TICKS.value({"path": "first_fit"}) == fallbacks0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not provider.terminated:
            time.sleep(0.2)
        assert provider.terminated, "idle nodes should retire"
        assert set(provider.terminated) <= set(provider.created)
    finally:
        # the controller provisions from its own thread: stop it before
        # the cluster tears its agents down
        ctrl.stop()
        if ctrl._thread is not None:
            ctrl._thread.join(timeout=10)
        set_runtime(None)
        client.shutdown()
        c.shutdown()
