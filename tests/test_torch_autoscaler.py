"""The port's autoscaler (``ray_tpu_torch.autoscaler``) on the CPU.

Mirrors the in-process autoscaler cases of ``tests/test_libraries.py``,
the four cases of ``tests/test_gce_provider.py`` (a fake TPU REST API is
injected: nothing reaches the network) and
``tests/test_elasticity.py::test_legacy_autoscaler_tick_noops_under_controller``
on the port; then holds ``DeltaBinPacker.pack_or_solve`` and
``Autoscaler.plan()`` against the JAX package on the same node rows and
demands (16, 64 and 256 nodes; 32 demands take the first-fit scan, 2,000
the projected-gradient solve): row indices and decisions must be equal.
The packing runs on the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``).
"""
import importlib
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.autoscaler.gce import GceTpuNodeProvider
from ray_tpu_torch.autoscaler.providers import CloudAPIError, InstanceManager

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu_scheduler(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")


@pytest.fixture()
def rt():
    runtime = ray_tpu_torch.init(
        num_nodes=2,
        resources_per_node={"CPU": 8, "memory": float(1 << 30)},
    )
    yield runtime
    ray_tpu_torch.shutdown()


# -- the in-process runtime (tests/test_libraries.py) ------------------------


def test_autoscaler_launches_for_infeasible_demand(rt):
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig

    @ray_tpu_torch.remote(num_cpus=32)
    def big():
        return "done"

    ref = big.remote()
    time.sleep(0.3)  # let it park as infeasible

    asc = Autoscaler(
        rt,
        [
            NodeTypeConfig("small", {"CPU": 8, "memory": 1e9}, 0, 4),
            NodeTypeConfig("big", {"CPU": 64, "memory": 4e9}, 0, 2),
        ],
        idle_timeout_s=60,
    )
    assert asc.device == rt.sched_device
    decision = asc.tick()
    assert decision.launch.get("big", 0) >= 1
    assert ray_tpu_torch.get(ref, timeout=15) == "done"


def test_autoscaler_respects_min_workers_and_idle_termination(rt):
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig

    asc = Autoscaler(
        rt,
        [NodeTypeConfig("w", {"CPU": 4, "memory": 1e9}, 2, 4)],
        idle_timeout_s=0.0,
    )
    d1 = asc.tick()
    assert d1.launch.get("w") == 2
    time.sleep(0.05)
    d2 = asc.plan()  # both new nodes idle; min_workers=2 keeps them
    assert len(d2.terminate) == 0


# -- the legacy loop defers to the head's controller (tests/test_elasticity.py)


def test_legacy_autoscaler_tick_noops_under_controller(monkeypatch):
    from ray_tpu_torch.autoscaler.autoscaler import (
        Autoscaler,
        NodeTypeConfig,
        ScalingDecision,
    )

    calls = []

    class _Provider:
        def create_node(self, t):
            calls.append(("create", t.name))

        def terminate_node(self, nid):
            calls.append(("terminate", nid))

        def non_terminated_nodes(self):
            return []

    class _Runtime:
        vocab = None

        def pending_resource_demands(self):
            calls.append(("demands",))
            return [{"CPU": 1.0}] * 4

    scaler = Autoscaler(
        _Runtime(),
        [NodeTypeConfig(name="t", resources={"CPU": 1.0}, min_workers=2)],
        provider=_Provider(),
    )
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "1")
    decision = scaler.tick()
    assert isinstance(decision, ScalingDecision)
    assert decision.launch == {} and decision.terminate == []
    assert calls == []  # provider and runtime never consulted
    # controller off -> the legacy loop is restored, bit for bit
    monkeypatch.setenv("RAY_TPU_ELASTIC_CONTROLLER", "0")
    decision = scaler.tick()
    # min_workers fill (2) + demand-driven launches run again
    assert decision.launch.get("t", 0) >= 2
    assert ("demands",) in calls and ("create", "t") in calls


def test_autoscaler_without_a_runtime_device_packs_on_the_platform(monkeypatch):
    from ray_tpu_torch.autoscaler import Autoscaler

    class _Runtime:
        vocab = None

    assert Autoscaler(_Runtime(), []).device.type == "cpu"
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cuda")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        Autoscaler(_Runtime(), [])


# -- pack_or_solve and plan() against the JAX package -----------------------


_TYPES = (
    ("small", {"CPU": 8.0, "memory": 32.0}),
    ("big", {"CPU": 64.0, "memory": 256.0}),
    ("gpu", {"CPU": 16.0, "memory": 64.0, "GPU": 4.0}),
    ("xl", {"CPU": 128.0, "memory": 512.0, "GPU": 8.0}),
)
_SHAPES = (
    {"CPU": 0.5},
    {"CPU": 1.0, "memory": 2.0},
    {"CPU": 2.0},
    {"CPU": 1.0, "GPU": 1.0},
    {"CPU": 4.0, "memory": 8.0},
)
# no node of the fleet holds these: only the "xl" type does
_HUGE = ({"CPU": 80.0}, {"CPU": 96.0, "memory": 300.0}, {"CPU": 2.0, "GPU": 6.0})


def _fleet(n, seed):
    """``n`` provider rows: a third of them GPU nodes, availability at
    1/4-CPU steps, an eighth of them idle."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        kind = ("small", "big", "gpu")[i % 3]
        res = dict(dict(_TYPES)[kind])
        avail = {k: (v if i % 8 == 0 else float(np.floor(v * rng.uniform(0.2, 1.0) * 4) / 4))
                 for k, v in res.items()}
        rows.append({
            "NodeID": f"node-{i:04d}",
            "Alive": True,
            "Labels": {"ray_tpu.io/node-type": kind},
            "Resources": res,
            "Available": avail,
        })
    return rows


# small enough that even 16 nodes hold 2,000 of them: the launch loop's
# per-demand first-fit and scorer then see little beyond _HUGE
_SMALL = ({"CPU": 0.0625}, {"CPU": 0.125, "memory": 0.25}, {"CPU": 0.0625, "memory": 1.0})


def _demands(b, seed, shapes=_SHAPES):
    rng = np.random.default_rng(seed + 7)
    out = [dict(shapes[k]) for k in rng.integers(0, len(shapes), b - len(_HUGE))]
    return out + [dict(h) for h in _HUGE]


class _Provider:
    def __init__(self, rows):
        self.rows = rows

    def non_terminated_nodes(self):
        return [dict(r) for r in self.rows]


class _Runtime:
    vocab = None

    def __init__(self, demands):
        self.demands = demands

    def pending_resource_demands(self):
        return [dict(d) for d in self.demands]


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.autoscaler.autoscaler"),
            importlib.import_module(f"{pkg}.scheduler.binpack"),
            importlib.import_module(f"{pkg}.scheduler"))


@pytest.mark.parametrize("b", [32, 2000])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_pack_or_solve_matches_jax(n, b):
    rows_info, demands = _fleet(n, n), _demands(b, n)
    got = {}
    for pkg in PKGS:
        _, bp, sched = _mods(pkg)
        vocab = sched.ResourceVocab()
        width = vocab.capacity
        rows = np.stack([vocab.pack(r["Available"])[:width] for r in rows_info]).astype(np.float32)
        dmat = np.stack([vocab.pack(d)[:width] for d in demands]).astype(np.float32)
        dmat = dmat[bp.sort_demands(dmat)]
        ids = [r["NodeID"] for r in rows_info]
        packer = bp.DeltaBinPacker(device="cpu") if pkg == "ray_tpu_torch" else bp.DeltaBinPacker()
        runs0 = bp.SOLVER_RUNS.value()
        falls0 = bp.SOLVER_FALLBACKS.value()
        got[pkg] = np.asarray(packer.pack_or_solve(ids, rows, dmat))
        assert bp.SOLVER_RUNS.value() - runs0 == (1 if b >= 64 else 0), pkg
        assert bp.SOLVER_FALLBACKS.value() == falls0, pkg
        used = np.zeros_like(rows)
        for i, node in enumerate(got[pkg]):
            if node >= 0:
                used[node] += dmat[i]
        assert (used <= rows + 1e-3).all()
    np.testing.assert_array_equal(got["ray_tpu_torch"], got["ray_tpu"])
    assert (got["ray_tpu_torch"] >= 0).sum() > 0
    assert (got["ray_tpu_torch"] < 0).sum() >= len(_HUGE)  # no node holds those


@pytest.mark.parametrize("b", [32, 2000])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_autoscaler_plan_matches_jax(n, b):
    rows_info, demands = _fleet(n, n + 1), _demands(b, n + 1, _SMALL)
    # the fleet's types are at their max: the launch loop scores every
    # type each step and may add up to three "xl" nodes
    fleet = [r["Labels"]["ray_tpu.io/node-type"] for r in rows_info]
    decisions = {}
    for pkg in PKGS:
        asc_mod, bp, _ = _mods(pkg)
        types = [asc_mod.NodeTypeConfig(name, dict(res), 0, fleet.count(name) or 3)
                 for name, res in _TYPES]
        asc = asc_mod.Autoscaler(_Runtime(demands), types, provider=_Provider(rows_info),
                                 idle_timeout_s=3600.0)
        runs0 = bp.SOLVER_RUNS.value()
        d = asc.plan()
        assert bp.SOLVER_RUNS.value() - runs0 == (1 if b >= 64 else 0), pkg
        decisions[pkg] = (dict(d.launch), list(d.terminate))
    assert decisions["ray_tpu_torch"] == decisions["ray_tpu"]
    assert decisions["ray_tpu_torch"][0].get("xl", 0) >= 1  # the huge shapes launch


# -- the GCE TPU-VM provider over a fake API (tests/test_gce_provider.py) ----


class FakeTpuApi:
    """Simulates tpu.googleapis.com v2: async node creation through
    long-running operations, list/delete, and a togglable rate limit."""

    def __init__(self, create_latency_s: float = 0.0):
        self.lock = threading.Lock()
        self.nodes = {}  # node_id -> node resource
        self.ops = {}  # op name -> {"done": bool, "node_id": str}
        self.calls = []
        self.rate_limited = False
        self.create_latency_s = create_latency_s
        self._op_counter = 0

    def __call__(self, method, url, body):
        path = url.split("/v2/")[1]
        with self.lock:
            self.calls.append((method, path, body))
            if self.rate_limited:
                return 429, {"error": {"status": "RESOURCE_EXHAUSTED"}}
            if method == "POST" and "/nodes?nodeId=" in path:
                node_id = path.split("nodeId=")[1]
                self._op_counter += 1
                op_name = f"projects/p/locations/z/operations/op-{self._op_counter}"
                self.ops[op_name] = {"done": False, "node_id": node_id}
                t = threading.Timer(
                    self.create_latency_s, self._materialize, (op_name, body)
                )
                t.daemon = True
                t.start()
                return 200, {"name": op_name, "done": False}
            if method == "GET" and "/operations/" in path:
                op = self.ops.get(path)
                return (200, dict(op)) if op else (404, {})
            if method == "GET" and path.endswith("/nodes"):
                return 200, {"nodes": list(self.nodes.values())}
            if method == "DELETE":
                node_id = path.rsplit("/", 1)[-1]
                self.nodes.pop(node_id, None)
                return 200, {"name": "delete-op", "done": True}
        return 404, {}

    def _materialize(self, op_name, body):
        with self.lock:
            op = self.ops[op_name]
            node_id = op["node_id"]
            self.nodes[node_id] = {
                "name": f"projects/p/locations/z/nodes/{node_id}",
                "state": "READY",
                "acceleratorType": body["acceleratorType"],
                "labels": body.get("labels", {}),
            }
            op["done"] = True


def _provider(api, **kw):
    return GceTpuNodeProvider(
        "p",
        "z",
        head_address="head:1234",
        transport=api,
        poll_interval_s=0.05,
        **kw,
    )


def test_create_list_terminate_roundtrip():
    api = FakeTpuApi()
    p = _provider(api)
    nt = NodeTypeConfig(name="v5e8", resources={"TPU": 8.0, "CPU": 16.0})
    node_id = p.create_node(nt)
    assert node_id.startswith("tpu-v5e8-")
    # request shape: accelerator derived from the TPU count, head addr
    # + slice label ride along
    method, path, body = api.calls[0]
    assert (method, body["acceleratorType"]) == ("POST", "v5litepod-8")
    assert body["metadata"]["ray-tpu-head-address"] == "head:1234"
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not p.non_terminated_nodes():
        time.sleep(0.02)
    rows = p.non_terminated_nodes()
    assert [r["NodeID"] for r in rows] == [node_id]
    assert rows[0]["type"] == "v5e8"
    assert rows[0]["slice"] == node_id  # ICI-domain locality label
    p.terminate_node(node_id)
    assert p.non_terminated_nodes() == []
    p.shutdown()


def test_rate_limit_maps_to_cloud_api_error():
    api = FakeTpuApi()
    api.rate_limited = True
    p = _provider(api)
    with pytest.raises(CloudAPIError, match="rate limited"):
        p.create_node(NodeTypeConfig(name="t", resources={"TPU": 8.0}))
    p.shutdown()


def test_non_tpu_node_type_rejected():
    p = _provider(FakeTpuApi())
    with pytest.raises(ValueError, match="no TPU resource"):
        p.create_node(NodeTypeConfig(name="cpuonly", resources={"CPU": 4.0}))
    p.shutdown()


def test_instance_manager_reconciles_lost_gce_launch():
    """The v2 reconciler retries launches the cloud lost — same
    machinery proven with MockCloudProvider, now over the GCE REST
    surface (a create whose operation never completes and whose node
    never lists)."""
    api = FakeTpuApi(create_latency_s=0.05)

    class LossyApi:
        def __init__(self, inner):
            self.inner = inner
            self.drop_first_create = True

        def __call__(self, method, url, body):
            if (
                method == "POST"
                and "nodeId=" in url
                and self.drop_first_create
            ):
                self.drop_first_create = False
                # accepted, op never completes, node never materializes
                return 200, {
                    "name": "projects/p/locations/z/operations/lost",
                    "done": False,
                }
            return self.inner(method, url, body)

    p = _provider(LossyApi(api))
    mgr = InstanceManager(p, launch_timeout_s=0.3, max_retries=2)
    nt = NodeTypeConfig(name="v5e8", resources={"TPU": 8.0})
    mgr.create_node(nt)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        mgr.reconcile()
        if any(i.state == "RUNNING" for i in mgr.instances.values()):
            break
        time.sleep(0.05)
    states = sorted(i.state for i in mgr.instances.values())
    assert "RUNNING" in states, states  # the retry materialized
    assert len(api.nodes) == 1
    p.shutdown()
