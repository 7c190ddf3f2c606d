"""Mirror of ``tests/test_flight_recorder.py`` on the port, with ``ray_tpu``
read as ``ray_tpu_torch`` and the scheduler's rounds on the host.

Flight recorder: typed exposition strictness, metrics federation, scheduler decision attribution, and crash bundles.
"""
import json
import os
import socket
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import metrics as rm


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# ---------------------------------------------------------------------------
# exposition strictness (satellites: label escaping, histogram rendering,
# percentile edge cases, strict parser)
# ---------------------------------------------------------------------------


def test_label_values_escaped_roundtrip():
    c = rm.Counter("fr_escape_total", "probe", ["path"])
    nasty = 'a"b\\c\nd'
    c.inc(labels={"path": nasty})
    text = rm.prometheus_text()
    # escaped per the text-format spec: \\ then \" then \n
    assert 'path="a\\"b\\\\c\\nd"' in text
    fams = rm.validate_exposition(text)
    samples = fams["fr_escape_total"]["samples"]
    # the strict parser recovers the ORIGINAL value
    assert any(dict(labels)["path"] == nasty for _, labels, _ in samples)


def test_label_value_with_braces_parses():
    # '{' and '}' are LEGAL unescaped inside a quoted label value; the
    # strict parser must not cut the label block at the inner '}'
    c = rm.Counter("fr_brace_total", "probe", ["deployment"])
    c.inc(labels={"deployment": "gen{v2}"})
    fams = rm.validate_exposition(rm.prometheus_text())
    samples = fams["fr_brace_total"]["samples"]
    assert any(
        dict(labels)["deployment"] == "gen{v2}" for _, labels, _ in samples
    )


def test_counter_block_failure_degrades_to_noop(monkeypatch):
    """An unwritable tempdir must not crash data-plane hot paths that
    bump dark counters — counting degrades to a silent no-op."""
    from ray_tpu_torch.native import counters

    def boom(self, path=None):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(counters.CounterBlock, "__init__", boom)
    monkeypatch.setattr(counters, "_block", None)
    try:
        b = counters.block()
        assert isinstance(b, counters._NullBlock)
        counters.add("net_stripe_retries_total")  # no-op, no raise
        assert counters.block().snapshot()[
            "net_stripe_retries_total"
        ] == 0
        assert not counters.register_with_wire(object())  # no page
    finally:
        monkeypatch.setattr(counters, "_block", None)


def test_counter_block_zeroes_recycled_pid_page(tmp_path):
    from ray_tpu_torch.native import counters

    path = str(tmp_path / "ray_tpu_counters.p999999.cnt")
    stale = counters.CounterBlock(path=path)
    stale.add(0, 123)
    stale.close(unlink=False)  # SIGKILL analog: page left behind
    fresh = counters.CounterBlock(path=path)
    try:
        assert fresh.get(0) == 0  # recycled pid does not inherit totals
    finally:
        fresh.close()


def test_help_line_escaped():
    rm.Counter("fr_help_total", "line one\nline two")
    text = rm.prometheus_text()
    assert "# HELP fr_help_total line one\\nline two" in text
    rm.validate_exposition(text)


def test_histogram_exposition_cumulative_and_consistent():
    h = rm.Histogram("fr_hist_ms", "probe", boundaries=[1.0, 10.0, 100.0])
    for v in (0.5, 5.0, 50.0, 500.0, 5.0):
        h.observe(v)
    fams = rm.validate_exposition(rm.prometheus_text())
    info = fams["fr_hist_ms"]
    assert info["kind"] == "histogram"
    by_name = {}
    for name, labels, value in info["samples"]:
        by_name.setdefault(name, []).append((dict(labels), value))
    buckets = by_name["fr_hist_ms_bucket"]
    vals = [v for _, v in buckets]
    # cumulative, monotone, +Inf last and equal to _count
    assert vals == sorted(vals)
    assert buckets[-1][0]["le"] == "+Inf"
    assert vals[-1] == by_name["fr_hist_ms_count"][0][1] == 5
    assert by_name["fr_hist_ms_sum"][0][1] == pytest.approx(560.5)
    # per-bucket cumulative counts: 1 <=1.0, 3 <=10.0, 4 <=100.0, 5 +Inf
    assert vals == [1, 3, 4, 5]


def test_percentile_from_buckets_edges():
    bounds = [1.0, 10.0, 100.0]
    # no observations
    assert rm.percentile_from_buckets(bounds, [0, 0, 0, 0], 0.5) == 0.0
    assert rm.percentile_from_buckets(bounds, [], 0.9) == 0.0
    # all mass in a single bucket: interpolates inside it
    p = rm.percentile_from_buckets(bounds, [0, 4, 0, 0], 0.5)
    assert 1.0 <= p <= 10.0
    # all mass in the +Inf bucket: reports the top finite bound
    assert rm.percentile_from_buckets(bounds, [0, 0, 0, 7], 0.99) == 100.0


@pytest.mark.parametrize(
    "body",
    [
        "fr_bad_total 1\n",  # sample without TYPE
        "# TYPE fr_bad_total counter\n# TYPE fr_bad_total counter\nfr_bad_total 1\n",
        "# TYPE fr_bad_total counter\nfr_bad_total 1",  # no trailing \n
        "# TYPE fr_bad_total counter\nfr_bad_total 1\nfr_bad_total 1\n",
        '# TYPE fr_bad_total counter\nfr_bad_total{p="x\\qy"} 1\n',  # bad escape
        "# TYPE fr_bad_total counter\nfr_bad_total one\n",  # non-float
        # histogram: buckets not cumulative
        "# TYPE fr_h histogram\n"
        'fr_h_bucket{le="1"} 3\nfr_h_bucket{le="+Inf"} 2\n'
        "fr_h_sum 1\nfr_h_count 2\n",
        # histogram: +Inf bucket != count
        "# TYPE fr_h histogram\n"
        'fr_h_bucket{le="1"} 1\nfr_h_bucket{le="+Inf"} 2\n'
        "fr_h_sum 1\nfr_h_count 3\n",
        # interleaved families
        "# TYPE fr_a counter\nfr_a 1\n# TYPE fr_b counter\nfr_b 1\nfr_a 2\n",
    ],
)
def test_validator_rejects_malformed(body):
    with pytest.raises(ValueError):
        rm.validate_exposition(body)


def test_validator_accepts_own_output():
    rm.Counter("fr_ok_total", "c").inc(3)
    rm.Gauge("fr_ok_gauge", "g", ["node"]).set(1.5, {"node": "n1"})
    rm.Histogram("fr_ok_ms", "h", boundaries=[1, 5]).observe(2)
    rm.validate_exposition(rm.prometheus_text())


# ---------------------------------------------------------------------------
# federation: typed deltas → head-side merge (satellite: two-node test)
# ---------------------------------------------------------------------------


def test_delta_exporter_ships_typed_deltas():
    c = rm.Counter("fr_delta_total", "probe")
    h = rm.Histogram("fr_delta_ms", "probe", boundaries=[1.0, 10.0])
    exp = rm.DeltaExporter()
    c.inc(5)
    h.observe(0.5)
    recs = {r["name"]: r for r in exp.collect()}
    assert recs["fr_delta_total"]["kind"] == "counter"
    assert recs["fr_delta_total"]["values"] == [[[], 5.0]]
    row = recs["fr_delta_ms"]["rows"][0]
    assert row[1] == [1, 0, 0] and row[3] == 1  # per-bucket + +Inf deltas
    # second collect: only the new increments ship
    c.inc(2)
    recs2 = {r["name"]: r for r in exp.collect()}
    assert recs2["fr_delta_total"]["values"] == [[[], 2.0]]
    assert "fr_delta_ms" not in recs2  # idle histogram ships nothing


def test_federated_registry_merges_two_nodes():
    fed = rm.FederatedRegistry()
    counter = {
        "name": "fr_fed_total", "kind": "counter", "help": "probe",
        "labels": [], "values": [[[], 3.0]],
    }
    hist = {
        "name": "fr_fed_ms", "kind": "histogram", "help": "probe",
        "labels": [], "boundaries": [1.0, 10.0],
        "rows": [[[], [1, 1, 0], 6.0, 2]],
    }
    fed.apply("node-a", "worker", [counter, hist])
    fed.apply("node-a", "worker", [counter])  # delta accumulates
    fed.apply("node-b", "agent", [dict(counter, values=[[[], 7.0]])])
    fams = rm.validate_exposition(fed.text())
    got = {
        (dict(labels)["node"], dict(labels)["role"]): v
        for _, labels, v in fams["fr_fed_total"]["samples"]
    }
    assert got == {("node-a", "worker"): 6.0, ("node-b", "agent"): 7.0}
    hs = fams["fr_fed_ms"]["samples"]
    assert any(
        name == "fr_fed_ms_count" and dict(labels)["node"] == "node-a"
        and v == 2
        for name, labels, v in hs
    )


def test_federated_registry_gauge_replaces_and_keeps_own_node_label():
    fed = rm.FederatedRegistry()
    gauge = {
        "name": "fr_fed_gauge", "kind": "gauge", "help": "",
        "labels": ["node"], "values": [[["self"], 1.0]],
    }
    fed.apply("node-a", "agent", [gauge])
    fed.apply("node-a", "agent", [dict(gauge, values=[[["self"], 9.0]])])
    fams = rm.validate_exposition(fed.text())
    (_, labels, v), = fams["fr_fed_gauge"]["samples"]
    # no duplicate "node" label name; role still appended; gauge replaced
    assert dict(labels) == {"node": "self", "role": "agent"}
    assert v == 9.0


# ---------------------------------------------------------------------------
# metrics server shutdown handle (satellite)
# ---------------------------------------------------------------------------


def test_metrics_server_close_releases_port_and_thread():
    rm.Gauge("fr_srv_gauge").set(1)
    srv = rm.start_metrics_server(port=0)
    port = int(srv)  # int-compatible handle (backward compat)
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10
    ) as resp:
        assert "fr_srv_gauge" in resp.read().decode()
    srv.close()
    assert srv._thread is None  # joined, not leaked
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=0.5)
    srv.close()  # idempotent
    # context-manager sugar
    with rm.start_metrics_server(port=0) as srv2:
        pass
    assert srv2._server is None


# ---------------------------------------------------------------------------
# crash bundles
# ---------------------------------------------------------------------------


def test_crash_bundle_contents_and_throttle(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_CRASH_BUNDLE_DIR", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_CRASH_BUNDLE_MIN_INTERVAL_S", "30")
    from ray_tpu_torch.core.events import TaskEventBuffer
    from ray_tpu_torch.util import flight_recorder
    from ray_tpu_torch.util.tracing import SPANS

    monkeypatch.setattr(flight_recorder, "_run_dir", None)
    monkeypatch.setattr(flight_recorder, "_last_dump", 0.0)
    ev = TaskEventBuffer()
    ev.record("t1", "work", "RUNNING", "node-a")
    ev.record("t1", "work", "FINISHED", "node-a")
    SPANS.record("fr_test_span", "test", time.time(), 0.01, pid="p")
    rm.Counter("fr_bundle_total", "probe").inc()

    path = flight_recorder.dump_bundle(
        "unit fault!", events=ev, state={"k": "v"},
        extra_meta={"epoch": 3},
    )
    assert path is not None
    names = sorted(os.listdir(path))
    assert names == [
        "events.json", "meta.json", "metrics.prom", "state.json",
        "trace.json",
    ]
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    assert meta["reason"] == "unit fault!" and meta["epoch"] == 3
    events = json.loads(open(os.path.join(path, "events.json")).read())
    assert {e["state"] for e in events} == {"RUNNING", "FINISHED"}
    trace = json.loads(open(os.path.join(path, "trace.json")).read())
    assert any(s.get("name") == "fr_test_span" for s in trace)
    body = open(os.path.join(path, "metrics.prom")).read()
    fams = rm.validate_exposition(body)
    assert "fr_bundle_total" in fams
    assert json.loads(open(os.path.join(path, "state.json")).read()) == {
        "k": "v"
    }
    # storm throttle: a second dump inside the interval is dropped...
    assert flight_recorder.dump_bundle("again", events=ev) is None
    # ...unless forced (explicit operator dump)
    assert flight_recorder.dump_bundle("forced", events=ev, force=True)


def test_crash_bundle_rotation(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_CRASH_BUNDLE_DIR", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_CRASH_BUNDLE_KEEP", "2")
    monkeypatch.setenv("RAY_TPU_CRASH_BUNDLE_MIN_INTERVAL_S", "0")
    from ray_tpu_torch.util import flight_recorder

    monkeypatch.setattr(flight_recorder, "_run_dir", None)
    monkeypatch.setattr(flight_recorder, "_last_dump", 0.0)
    for i in range(4):
        assert flight_recorder.dump_bundle(f"r{i}")
    run = flight_recorder.run_dir()
    bundles = sorted(d for d in os.listdir(run) if d.startswith("bundle-"))
    assert len(bundles) == 2
    assert bundles[-1].endswith("r3")


# ---------------------------------------------------------------------------
# live two-node run: federation end-to-end, HTTP scrape validity,
# scheduler decision attribution (tier-1 CI satellite)
# ---------------------------------------------------------------------------


def _bump_worker_counter():
    from ray_tpu_torch.util import metrics as worker_rm

    with worker_rm._registry_lock:
        m = worker_rm._registry.get("fr_worker_probe_total")
    if m is None:
        m = worker_rm.Counter(
            "fr_worker_probe_total", "worker-side federation probe"
        )
    m.inc()
    return os.environ.get("RAY_TPU_NODE_ID", "")


def test_live_scrape_federation_and_explain(monkeypatch):
    monkeypatch.setenv("RAY_TPU_METRICS_INTERVAL_S", "0.2")
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=1)
    c.add_node({"CPU": 2.0}, num_workers=1)
    client = c.client()
    set_runtime(client)
    srv = None
    try:
        f = ray_tpu_torch.remote(_bump_worker_counter).options(
            num_cpus=0.5, max_retries=0
        )
        nodes = {
            n
            for n in ray_tpu_torch.get(
                [f.remote() for _ in range(8)], timeout=120
            )
            if n
        }
        assert nodes  # ran on real worker processes

        # worker registry deltas relay through the agents to the head;
        # poll the federated body until one lands
        deadline = time.monotonic() + 30
        samples = []
        while time.monotonic() < deadline:
            body = client.head.call(
                "QueryState", {"kind": "metrics_text"}
            )
            fams = rm.validate_exposition(body)  # strict: any bad line fails
            samples = fams.get("fr_worker_probe_total", {}).get(
                "samples", []
            )
            if sum(v for _, _, v in samples) >= 8.0:
                break
            time.sleep(0.25)
        # role carries a per-process discriminator (worker:<id8>) so
        # same-node workers never collapse to one series
        assert all(
            dict(labels)["role"].startswith("worker:")
            for _, labels, _ in samples
        )
        seen_nodes = {dict(labels)["node"] for _, labels, _ in samples}
        assert seen_nodes & nodes  # correct node label
        # deltas accumulate exactly across all worker series
        assert sum(v for _, _, v in samples) == 8.0

        # the same body over a REAL http scrape, revalidated end to end
        srv = rm.start_metrics_server(
            port=0, render=c.head.metrics_text
        )
        with urllib.request.urlopen(
            f"http://127.0.0.1:{int(srv)}/metrics", timeout=10
        ) as resp:
            http_fams = rm.validate_exposition(resp.read().decode())
        # typed exposition: at least one histogram family with buckets,
        # and the head's own registry merged under node="head"
        assert any(
            info["kind"] == "histogram" and info["samples"]
            for info in http_fams.values()
        )
        assert any(
            dict(labels).get("node") == "head"
            for info in http_fams.values()
            for _, labels, _ in info["samples"]
        )

        # scheduler decision attribution: some kernel-scheduled task has
        # its five per-term cost contributions on record
        from ray_tpu_torch.scheduler.hybrid import TERM_NAMES

        explained = None
        for task_id, e in c.head.events.task_states().items():
            if e.state != "FINISHED":
                continue
            explained = client.head.call(
                "QueryState",
                {"kind": "explain_placement", "task_id": task_id},
            )
            if explained:
                break
        assert explained, "no scheduled task has an explanation"
        assert set(explained["terms"]) == set(TERM_NAMES)
        assert explained["node"]
        assert explained["source"] in ("kernel", "host")
        # the SCHEDULED instant event carries the same breakdown into
        # the Chrome-trace export
        spans = c.head.events.dump_timeline()
        assert any(
            s.get("ph") == "i" and s.get("args", {}).get("sched_terms")
            for s in spans
        )
    finally:
        if srv is not None:
            srv.close()
        set_runtime(None)
        client.shutdown()
        c.shutdown()
