"""Mirror of ``tests/test_spread_labels.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Distinct SPREAD policy + node-label selectors.
"""
import collections

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.scheduling_strategies import NodeLabelSchedulingStrategy


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _node_of():
    from ray_tpu_torch.core.runtime import get_context

    return get_context().node_id


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------


def test_inprocess_spread_round_robins():
    rt = ray_tpu_torch.init(num_nodes=4, resources_per_node={"CPU": 8})
    try:
        f = ray_tpu_torch.remote(_node_of).options(
            scheduling_strategy="SPREAD", num_cpus=0.5
        )
        seen = collections.Counter(
            ray_tpu_torch.get([f.remote() for _ in range(16)], timeout=60)
        )
        # 16 tasks over 4 nodes round-robin → exactly 4 each
        assert len(seen) == 4, seen
        assert all(v == 4 for v in seen.values()), seen
    finally:
        ray_tpu_torch.shutdown()


def test_inprocess_default_is_not_spread():
    """DEFAULT (hybrid) packs below the threshold — it must NOT round-robin
    like SPREAD (round-2 verdict: SPREAD was silently DEFAULT; now they
    must differ observably)."""
    rt = ray_tpu_torch.init(num_nodes=4, resources_per_node={"CPU": 8})
    try:
        f = ray_tpu_torch.remote(_node_of).options(num_cpus=0.5)
        seen = collections.Counter(
            ray_tpu_torch.get([f.remote() for _ in range(16)], timeout=60)
        )
        # hybrid packs: distribution is NOT a perfect 4/4/4/4 round-robin
        assert not all(v == 4 for v in seen.values()) or len(seen) < 4, seen
    finally:
        ray_tpu_torch.shutdown()


def test_inprocess_label_selector_places_on_labeled_node():
    rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        tagged = rt.add_node({"CPU": 4}, labels={"accel": "tpu-v5e", "zone": "a"})
        f = ray_tpu_torch.remote(_node_of).options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard={"accel": "tpu-v5e"}
            ),
            num_cpus=0.5,
        )
        out = ray_tpu_torch.get([f.remote() for _ in range(6)], timeout=60)
        assert set(out) == {tagged}, out
        # "in" selector
        g = ray_tpu_torch.remote(_node_of).options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard={"zone": ["a", "b"]}
            ),
            num_cpus=0.5,
        )
        assert ray_tpu_torch.get(g.remote(), timeout=30) == tagged
        # unsatisfiable hard selector parks (does not run elsewhere)
        h = ray_tpu_torch.remote(_node_of).options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard={"accel": "gpu"}
            ),
            num_cpus=0.5,
        )
        ref = h.remote()
        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=1.5)
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------


def _cluster_node_id():
    import os

    return os.environ.get("RAY_TPU_NODE_ID")


def test_cluster_spread_and_labels():
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, labels={"slice": "s0"}, num_workers=2)
    c.add_node({"CPU": 4.0}, labels={"slice": "s1"}, num_workers=2)
    client = c.client()
    set_runtime(client)
    try:
        f = ray_tpu_torch.remote(_cluster_node_id).options(
            scheduling_strategy="SPREAD", num_cpus=0.5
        )
        seen = collections.Counter(
            ray_tpu_torch.get([f.remote() for _ in range(8)], timeout=120)
        )
        assert len(seen) == 2 and all(v == 4 for v in seen.values()), seen

        # ICI-slice affinity as a label selector
        g = ray_tpu_torch.remote(_cluster_node_id).options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard={"slice": "s1"}
            ),
            num_cpus=0.5,
        )
        out = set(ray_tpu_torch.get([g.remote() for _ in range(4)], timeout=120))
        assert len(out) == 1, out
        nodes = {n["NodeID"]: n for n in client.nodes_info()}
        assert nodes[out.pop()]["Labels"] == {"slice": "s1"}
    finally:
        set_runtime(None)
        client.shutdown()
        c.shutdown()


def test_random_strategy_places_feasibly():
    """RANDOM policy (random_scheduling_policy.cc analog): places on a
    uniformly chosen FEASIBLE node; distribution covers several nodes."""
    rt = ray_tpu_torch.init(num_nodes=4, resources_per_node={"CPU": 8})
    try:
        f = ray_tpu_torch.remote(_node_of).options(
            scheduling_strategy="RANDOM", num_cpus=0.1
        )
        seen = collections.Counter(
            ray_tpu_torch.get([f.remote() for _ in range(30)], timeout=120)
        )
        assert len(seen) >= 2  # randomness spreads across nodes
        assert sum(seen.values()) == 30
    finally:
        ray_tpu_torch.shutdown()
