"""The port's data-plane hygiene on the CPU: blocks stay ObjectRefs end to
end, and jobs survive dropped RPCs.

Mirrors ``tests/test_data_plane.py`` on ``ray_tpu_torch`` with the same
assertions: shuffle input never funnels through the driver (refs in, refs
out), ``union``/``split``/``materialize`` keep refs, a job survives 10% of
its dispatch RPCs or of its direct actor-call RPCs being dropped, and an
interactive ``get`` is served ahead of a storm of task-argument pulls.
The cluster cases run in a subprocess that imports only the port.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata

REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture()
def rt(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_executed_blocks_are_refs(rt):
    ds = rdata.range(1000, override_num_blocks=8).map(lambda x: x + 1)
    blocks = ds._executed_blocks()
    assert all(isinstance(b, ray_tpu_torch.ObjectRef) for b in blocks)
    assert sum(len(ray_tpu_torch.get(b)) for b in blocks) == 1000


def test_union_and_split_keep_refs(rt):
    a = rdata.range(100, override_num_blocks=4).map(lambda x: x * 2)
    b = rdata.range(100, override_num_blocks=4).map(lambda x: x * 3)
    u = a.union(b)
    assert u.num_blocks() == 8
    assert all(isinstance(blk, ray_tpu_torch.ObjectRef) for blk in u._input_blocks)
    assert u.count() == 200
    parts = u.split(4)
    assert len(parts) == 4
    for p in parts:
        assert all(isinstance(blk, ray_tpu_torch.ObjectRef) for blk in p._input_blocks)
    assert sum(p.count() for p in parts) == 200


def test_materialize_stays_in_store(rt):
    ds = rdata.range(500, override_num_blocks=5).map(lambda x: x * x)
    m = ds.materialize()
    assert all(isinstance(b, ray_tpu_torch.ObjectRef) for b in m._input_blocks)
    assert m.count() == 500
    assert sorted(m.take_all())[:3] == [0, 1, 4]


def test_shuffle_pipeline_refs_end_to_end(rt):
    ds = (
        rdata.range(400, override_num_blocks=8)
        .map(lambda x: {"k": x % 10, "v": x})
        .random_shuffle(seed=7)
    )
    counts = {r["k"]: r["count"] for r in ds.groupby("k").count().take_all()}
    assert counts == {i: 40 for i in range(10)}


def _run_script(tmp_path, name: str, script: str, env_extra: dict, timeout: float):
    path = tmp_path / name
    path.write_text(script)
    env = dict(os.environ, RAY_TPU_SCHED_PLATFORM="cpu", **env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                          timeout=timeout, env=env)


_CHAOS_SCRIPT = r"""
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime

c = Cluster()
c.add_node({"CPU": 8.0}, num_workers=3)
client = c.client()
set_runtime(client)
try:
    def sq(x):
        return x * x

    f = ray_tpu_torch.remote(sq).options(num_cpus=0.25, max_retries=10)
    refs = [f.remote(i) for i in range(200)]
    out = ray_tpu_torch.get(refs, timeout=240)
    assert out == [i * i for i in range(200)], "wrong results under chaos"
    print("CHAOS_OK")
finally:
    set_runtime(None)
    client.shutdown()
    c.shutdown()
"""


def test_job_survives_dropped_dispatch_rpcs(tmp_path):
    """10% of ExecuteLeaseBatch (head->agent dispatch) and TaskDoneBatch
    (worker->agent completion) RPCs dropped before send: the retry and
    requeue machinery still completes all 200 tasks with correct results."""
    out = _run_script(tmp_path, "chaos_job.py", _CHAOS_SCRIPT, {
        "RAY_TPU_RPC_CHAOS": "ExecuteLeaseBatch:drop=0.1;TaskDoneBatch:drop=0.1"}, 300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CHAOS_OK" in out.stdout


_DIRECT_CHAOS_SCRIPT = r"""
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime

c = Cluster()
c.add_node({"CPU": 8.0}, num_workers=3)
client = c.client()
set_runtime(client)
try:
    @ray_tpu_torch.remote(num_cpus=0.25)
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    @ray_tpu_torch.remote(num_cpus=0.25)
    class AsyncEcho:
        async def ping(self, v):
            return v

    a = Acc.remote()
    outs = ray_tpu_torch.get([a.add.remote(1) for _ in range(100)], timeout=240)
    # at-least-once under chaos: monotone, and >= 100 adds at the end
    assert outs[-1] >= 100, outs[-1]
    assert all(o >= 1 for o in outs)
    e = AsyncEcho.remote()
    vals = ray_tpu_torch.get([e.ping.remote(i) for i in range(200)], timeout=240)
    assert vals == list(range(200)), "async results must be exact"
    print("DIRECT_CHAOS_OK")
finally:
    set_runtime(None)
    client.shutdown()
    c.shutdown()
"""


def test_direct_path_survives_chaos(tmp_path):
    """10% drops on the direct actor-call wire (DirectPushBatch pushes and
    DirectResults callbacks): the channel's fallback to the head path
    delivers every result."""
    out = _run_script(tmp_path, "direct_chaos.py", _DIRECT_CHAOS_SCRIPT, {
        "RAY_TPU_RPC_CHAOS": "DirectPushBatch:drop=0.1;DirectResults:drop=0.1"}, 300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "DIRECT_CHAOS_OK" in out.stdout


_QOS_SCRIPT = r"""
import time
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime
from ray_tpu_torch.core.scheduling_strategies import NodeAffinitySchedulingStrategy

c = Cluster()
c.add_node({"CPU": 4.0}, num_workers=1)   # node A: holds the big objects
c.add_node({"CPU": 4.0}, num_workers=2)   # node B: runs the arg-storm tasks
client = c.client()
set_runtime(client)
try:
    node_b = sorted(n["NodeID"] for n in ray_tpu_torch.nodes())[1]
    big = [ray_tpu_torch.put(np.zeros(12 << 20, np.uint8)) for _ in range(7)]
    probe = ray_tpu_torch.put(np.ones(12 << 20, np.uint8))

    @ray_tpu_torch.remote(num_cpus=1.0)
    def consume(x):
        return int(x[0])

    tasks = [consume.options(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b)).remote(r)
             for r in big[:6]]
    time.sleep(0.3)  # let the storm hit the serving agent's slots
    t0 = time.perf_counter()
    val = ray_tpu_torch.get(probe, timeout=60)
    get_s = time.perf_counter() - t0
    assert val[0] == 1
    assert ray_tpu_torch.get(tasks, timeout=180) == [0] * 6
    print(f"QOS get_s={get_s:.2f}")
    assert get_s < 10.0, f"interactive get starved: {get_s:.1f}s"
    print("QOS_OK")
finally:
    set_runtime(None)
    client.shutdown()
    c.shutdown()
"""


def test_interactive_get_preempts_task_arg_storm(tmp_path):
    """With one outbound transfer slot on the serving agent and a storm of
    task-argument pulls queued, an interactive driver get is admitted ahead
    of the task-argument class instead of queueing behind the backlog."""
    out = _run_script(tmp_path, "qos.py", _QOS_SCRIPT, {
        "RAY_TPU_MAX_CONCURRENT_PUSHES": "1", "RAY_TPU_MAX_CONCURRENT_PULLS": "2"}, 400)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "QOS_OK" in out.stdout
