"""The port's dashboard (served from the standard library's
``ThreadingHTTPServer``) and state API, and their parity with the JAX
package's.

Mirrors the four dashboard cases of ``tests/test_jobs_dashboard.py`` and
``tests/test_observability.py``'s ``test_state_api`` on ``ray_tpu_torch``,
with the same assertions. Parity:

- the same small workload (two nodes, tasks, one actor, one placement
  group, one job submitted through the REST API) on a reference cluster
  (aiohttp) and a port cluster: every JSON route gives the same status
  and the same key sets, the node, actor, placement-group and job counts
  are equal, and unknown paths, unknown jobs and wrong methods get the
  same status codes;
- the same workload on each package's local runtime: ``list_*`` and
  ``summarize_tasks()`` give equal rows once ids are masked.
"""
import importlib
import json
import sys
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.util import state as rstate


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime and head bring their scheduler up on cuda and
    # raise without it; here the programs run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def cluster(_sched_on_cpu):
    c = Cluster(dashboard=True)
    c.add_node({"CPU": 2.0}, num_workers=2)
    yield c
    c.shutdown()


def _http_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _status(url, method="GET", data=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def test_dashboard_node_debug_and_rpc_stats(cluster):
    port = cluster.head.dashboard.port
    base = f"http://127.0.0.1:{port}"
    nodes = _http_json(f"{base}/api/nodes")
    nid = nodes[0]["NodeID"]
    debug = _http_json(f"{base}/api/nodes/{nid}/debug")
    assert "available" in debug and "store" in debug
    assert "rpc_handlers" in debug and "oom_kills" in debug
    stats = _http_json(f"{base}/api/rpc_stats")
    assert isinstance(stats, dict)  # head-side handler timings


def test_dashboard_endpoints(cluster):
    port = cluster.head.dashboard.port
    base = f"http://127.0.0.1:{port}"
    nodes = _http_json(f"{base}/api/nodes")
    assert len(nodes) == 1 and nodes[0]["Alive"]
    status = _http_json(f"{base}/api/cluster_status")
    assert "metrics" in status
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    # the scrape is the head's FEDERATED registry: typed families, every
    # sample namespaced by node/role, parser-valid end to end
    from ray_tpu_torch.util.metrics import validate_exposition

    fams = validate_exposition(text)
    assert fams["ray_tpu_nodes_alive"]["kind"] == "gauge"
    (_, labels, value), = fams["ray_tpu_nodes_alive"]["samples"]
    assert value == 1 and dict(labels)["node"] == "head"
    assert fams["ray_tpu_leases_submitted"]["kind"] == "counter"


def _write_script(tmp_path, body) -> str:
    path = tmp_path / "entry.py"
    path.write_text(body)
    return str(path)


def _submit_and_wait(base, entrypoint):
    req = urllib.request.Request(
        f"{base}/api/jobs",
        data=json.dumps({"entrypoint": entrypoint}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        job_id = json.loads(r.read())["job_id"]
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        info = _http_json(f"{base}/api/jobs/{job_id}")
        if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.2)
    return job_id, info


def test_dashboard_job_rest(cluster, tmp_path):
    port = cluster.head.dashboard.port
    base = f"http://127.0.0.1:{port}"
    script = _write_script(tmp_path, 'print("from-rest")')
    job_id, info = _submit_and_wait(base, f"{sys.executable} {script}")
    assert info["status"] == "SUCCEEDED"
    with urllib.request.urlopen(f"{base}/api/jobs/{job_id}/logs", timeout=10) as r:
        assert "from-rest" in r.read().decode()


def test_dashboard_ui_page(cluster):
    """The self-contained web UI (dashboard/client analog): /ui serves a
    page whose tables poll the JSON APIs, and those APIs return the
    field names the page reads."""
    port = cluster.head.dashboard.port
    html = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/ui", timeout=10
    ).read().decode()
    for table_id in ("nodes", "actors", "pgs", "jobs", "rpc"):
        assert f'<table id="{table_id}">' in html
    # field-name contract between the page's JS and the APIs
    nodes = _http_json(f"http://127.0.0.1:{port}/api/nodes")
    assert nodes and {"NodeID", "Alive", "Address", "Resources"} <= set(
        nodes[0]
    )
    rpc = _http_json(f"http://127.0.0.1:{port}/api/rpc_stats")
    assert isinstance(rpc, dict)


def test_head_dashboard_starts_and_stops(_sched_on_cpu):
    """``HeadServer(dashboard_port=0)`` serves at once and ``shutdown``
    stops the server thread; both CLIs default to the reference's 8265."""
    from ray_tpu_torch.cluster.head import HeadServer

    head = HeadServer(port=0, dashboard_port=0, use_device_scheduler=False)
    try:
        port = head.dashboard.port
        assert _http_json(f"http://127.0.0.1:{port}/api/nodes") == []
    finally:
        head.shutdown()
    assert not head.dashboard._thread.is_alive()
    import ray_tpu_torch.__main__ as cli
    import ray_tpu_torch.cluster.head as head_mod

    for src in (cli, head_mod):
        text = importlib.util.find_spec(src.__name__).loader.get_source(src.__name__)
        assert 'add_argument("--dashboard-port", type=int, default=8265)' in text


# ---------------------------------------------------------------------------
# tests/test_observability.py: the state API on the port's runtime
# ---------------------------------------------------------------------------


@pytest.fixture()
def rt(_sched_on_cpu):
    rt = ray_tpu_torch.init(num_nodes=2, resources_per_node={"CPU": 4, "memory": 1e9})
    yield rt
    ray_tpu_torch.shutdown()


def test_state_api(rt):
    @ray_tpu_torch.remote
    def quick():
        return 1

    @ray_tpu_torch.remote
    class Svc:
        def ping(self):
            return "pong"

    ray_tpu_torch.get([quick.remote() for _ in range(2)])
    svc = Svc.options(name="state-svc").remote()
    ray_tpu_torch.get(svc.ping.remote())

    tasks = rstate.list_tasks(filters=[("state", "=", "FINISHED")])
    assert any(t["name"] == "quick" for t in tasks)
    actors = rstate.list_actors()
    assert any(
        a["class_name"] == "Svc" and a["state"] == "ALIVE" for a in actors
    )
    objs = rstate.list_objects()
    assert any(o["sealed"] for o in objs)
    assert len(rstate.list_nodes()) == 2
    summary = rstate.summarize_tasks()
    assert summary.get("FINISHED", 0) >= 3


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _square(x):
    return x * x


class _Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


JSON_ROUTES = (
    "/api/cluster_status",
    "/api/nodes",
    "/api/rpc_stats",
    "/api/actors",
    "/api/objects",
    "/api/placement_groups",
    "/api/jobs",
)


def _key_sets(value):
    """The key structure of a JSON body: a dict's keys, or the union of
    the keys of a list's dict rows."""
    if isinstance(value, dict):
        return ("dict", frozenset(value))
    if isinstance(value, list):
        keys = set()
        for row in value:
            if isinstance(row, dict):
                keys |= set(row)
        return ("list", frozenset(keys))
    return (type(value).__name__, None)


def _cluster_snapshot(pkg, tmp_path):
    """Run the workload on a two-node cluster of ``pkg`` and read every
    route of its dashboard."""
    api = importlib.import_module(pkg)
    cl = importlib.import_module(f"{pkg}.cluster")
    runtime_mod = importlib.import_module(f"{pkg}.core.runtime")
    c = cl.Cluster(dashboard=True, use_device_scheduler=False)
    c.add_node({"CPU": 2.0}, num_workers=1)
    c.add_node({"CPU": 2.0}, num_workers=1)
    client = c.client()
    runtime_mod.set_runtime(client)
    out = {}
    try:
        f = api.remote(_square).options(num_cpus=0.25, max_retries=0)
        assert api.get([f.remote(i) for i in range(6)], timeout=60) == [
            i * i for i in range(6)
        ]
        a = api.remote(_Counter).options(num_cpus=0.25).remote()
        assert api.get(a.add.remote(5), timeout=60) == 5
        pg = api.placement_group([{"CPU": 0.5}], strategy="PACK")
        assert pg.wait(timeout_seconds=60)
        base = f"http://127.0.0.1:{c.head.dashboard.port}"
        script = tmp_path / f"job_{pkg}.py"
        script.write_text('print("parity-job")')
        job_id, info = _submit_and_wait(base, f"{sys.executable} {script}")
        out["job_status"] = info["status"]
        for route in JSON_ROUTES:
            out[route] = (_status(base + route), _http_json(base + route))
        nid = out["/api/nodes"][1][0]["NodeID"]
        route = f"/api/nodes/{nid}/debug"
        out["debug"] = (_status(base + route), _http_json(base + route))
        out["status_codes"] = {
            "ui": _status(f"{base}/ui"),
            "index": _status(f"{base}/"),
            "metrics": _status(f"{base}/metrics"),
            "logs": _status(f"{base}/api/jobs/{job_id}/logs"),
            "unknown job": _status(f"{base}/api/jobs/nope"),
            "unknown job logs": _status(f"{base}/api/jobs/nope/logs"),
            "unknown path": _status(f"{base}/api/nothing"),
            "wrong method": _status(f"{base}/api/nodes", method="POST", data=b"{}"),
            "unknown node": _http_json(f"{base}/api/nodes/nope/debug").keys(),
        }
    finally:
        runtime_mod.set_runtime(None)
        client.shutdown()
        c.shutdown()
    return out


def test_dashboard_routes_equal_to_the_reference(tmp_path):
    want = _cluster_snapshot("ray_tpu", tmp_path)
    got = _cluster_snapshot("ray_tpu_torch", tmp_path)
    assert got["job_status"] == want["job_status"] == "SUCCEEDED"
    assert got["status_codes"] == want["status_codes"]
    for route in JSON_ROUTES + ("debug",):
        (gs, gbody), (ws, wbody) = got[route], want[route]
        assert gs == ws == 200, route
        if route == "/api/rpc_stats":
            # keyed by handler name, which depends on the RPCs the run made;
            # each handler's stats have the same fields
            shared = set(gbody) & set(wbody)
            assert shared, route
            for name in shared:
                assert set(gbody[name]) == set(wbody[name]), name
            continue
        assert _key_sets(gbody) == _key_sets(wbody), route
    for route in ("/api/nodes", "/api/actors", "/api/placement_groups", "/api/jobs"):
        assert len(got[route][1]) == len(want[route][1]), route
    assert len(got["/api/nodes"][1]) == 2
    # the cluster status's own sections
    for key in ("metrics", "leases"):
        assert _key_sets(got["/api/cluster_status"][1][key]) == _key_sets(
            want["/api/cluster_status"][1][key]
        ), key


def _mask(rows, id_keys, node_ids):
    """Rows with their id fields, and every node id anywhere in them (a
    bundle's placement), replaced by placeholders; sorted."""

    def sub(v):
        if isinstance(v, dict):
            return {k: sub(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [sub(x) for x in v]
        return "<node>" if isinstance(v, str) and v in node_ids else v

    masked = []
    for row in rows:
        r = sub(dict(row))
        for k in id_keys:
            if k in r:
                r[k] = "<id>"
        masked.append(json.dumps(r, sort_keys=True, default=str))
    return sorted(masked)


def _state_rows(pkg):
    api = importlib.import_module(pkg)
    st = importlib.import_module(f"{pkg}.util.state")
    api.init(num_nodes=2, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        f = api.remote(_square)
        assert api.get([f.remote(i) for i in range(5)], timeout=60) == [
            i * i for i in range(5)
        ]
        a = api.remote(_Counter).options(name="parity-counter").remote()
        assert api.get(a.add.remote(3), timeout=60) == 3
        pg = api.placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="SPREAD")
        api.get(pg.ready(), timeout=60)
        ref = api.put(list(range(10)))
        assert api.get(ref, timeout=60) == list(range(10))
        ids = ("task_id", "node_id", "actor_id", "object_id", "NodeID",
               "NodeManagerAddress", "placement_group_id", "Address")
        nodes = st.list_nodes()
        node_ids = {n["NodeID"] for n in nodes}
        return {
            "tasks": _mask(st.list_tasks(), ids, node_ids),
            "finished": _mask(
                st.list_tasks(filters=[("state", "=", "FINISHED")]), ids, node_ids
            ),
            "actors": _mask(st.list_actors(), ids, node_ids),
            "objects": _mask(st.list_objects(), ids, node_ids),
            "nodes": _mask(nodes, ids, node_ids),
            "pgs": _mask(st.list_placement_groups(), ids, node_ids),
            "summary": st.summarize_tasks(),
        }
    finally:
        api.shutdown()


def test_state_api_rows_equal_to_the_reference():
    want = _state_rows("ray_tpu")
    got = _state_rows("ray_tpu_torch")
    for key in want:
        assert got[key] == want[key], key
