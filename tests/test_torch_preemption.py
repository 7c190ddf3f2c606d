"""Preemption as a scheduler action, on the port.

Mirror of ``tests/test_preemption.py``: a starving shape (parked past
``sched_starve_rounds`` retry rounds with no capacity anywhere) makes the
round or ring program nominate a node, and the head kills and requeues
victims there through ``_pick_preemption_victims`` and ``_preempt_on_node``
(``ray_tpu_torch/cluster/head.py``). Running retryable tasks are killed and
requeued without spending an attempt; running ``max_retries=0`` work is
never a victim; a preemption storm with a node kill loses no acked object.

The fast case runs the same in-flight table through the JAX package's
``HeadServer._pick_preemption_victims`` and the port's. The three cluster
cases are the reference's, marked slow as there (real-time sleeps); their
port clusters schedule on the CPU (``RAY_TPU_SCHED_PLATFORM=cpu``). The
last cases hold ``chip_smoke.preemption_verdicts``, which judges the same
three scenarios on the card, against a clean run and a run with each fault.
"""
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime


def _wait_for(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


def _sleeper(path, seconds):
    # one line per EXECUTION: the at-most-once assertions count these
    with open(path, "a") as f:
        f.write(f"{os.getpid()} {time.time()}\n")
        f.flush()
    time.sleep(seconds)
    return "slept"


def _noop():
    return "ok"


def _runs(path):
    try:
        with open(path) as f:
            return len(f.readlines())
    except FileNotFoundError:
        return 0


@pytest.fixture()
def preempt_env(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_STARVE_ROUNDS", "2")
    monkeypatch.setenv("RAY_TPU_SCHED_PREEMPT_COOLDOWN_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SCHED_PREEMPT", "1")
    # the port's heads bring their scheduler up on cuda and raise
    # without it; here the programs run on the host (agents and workers
    # inherit the environment)
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    yield


def _victims(head_cls, spec_cls):
    """(lease victims, [(task id, may force)]) of one head of ``head_cls``
    over the reference's in-flight table: a 2-CPU shape starving on n0."""
    head = head_cls(dashboard_port=None)
    try:
        def spec_of(tid, cpu, max_retries):
            return spec_cls(task_id=tid, name=tid, payload=b"", return_ids=[],
                            resources={"CPU": cpu}, max_retries=max_retries)

        with head._cond:
            head._in_flight["small_retry"] = (spec_of("small_retry", 1.0, 3), "n0")
            head._in_flight["small_once"] = (spec_of("small_once", 1.0, 0), "n0")
            head._in_flight["peer"] = (spec_of("peer", 2.0, 3), "n0")
            head._in_flight["elsewhere"] = (spec_of("elsewhere", 0.5, 3), "n1")
        need = np.zeros(16, dtype=np.float32)
        need[0] = 2.0  # the starving shape wants 2 CPU
        leases, tasks = head._pick_preemption_victims("n0", need)
        return leases, [(s.task_id, f) for s, f in tasks]
    finally:
        head.shutdown(stop_agents=False)


def test_victims_must_be_strictly_cheaper(preempt_env):
    """Anti-livelock rule: a starving shape never preempts peers of its
    own (or larger) footprint; least work lost first; at-most-once work is
    cancel-only. The port picks the reference's victims with the
    reference's force flags from the same table."""
    from ray_tpu.cluster.common import LeaseRequest as JLeaseRequest
    from ray_tpu.cluster.head import HeadServer as JHeadServer
    from ray_tpu_torch.cluster.common import LeaseRequest
    from ray_tpu_torch.cluster.head import HeadServer

    got = _victims(HeadServer, LeaseRequest)
    want = _victims(JHeadServer, JLeaseRequest)
    assert got == want
    leases, tasks = got
    assert leases == []
    ids = [tid for tid, _ in tasks]
    # the 2-CPU peer and the other-node spec are never victims
    assert "peer" not in ids and "elsewhere" not in ids
    assert set(ids) == {"small_retry", "small_once"}
    force = dict(tasks)
    assert force["small_retry"] is True   # retryable: may kill running
    assert force["small_once"] is False   # at-most-once: cancel-only


@pytest.mark.slow
def test_starving_shape_preempts_running_retryable(preempt_env, tmp_path):
    """Two retryable sleepers pin the only node; a 2-CPU shape starves,
    the program nominates, the head force-kills the sleepers, the big
    task runs, and the victims re-run afterwards without spending a
    retry attempt."""
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=3)
    rt = c.client()
    set_runtime(rt)
    try:
        sleep_fn = ray_tpu_torch.remote(_sleeper).options(num_cpus=1.0, max_retries=3)
        paths = [str(tmp_path / f"victim{i}") for i in range(2)]
        victims = [sleep_fn.remote(p, 10.0) for p in paths]
        _wait_for(lambda: all(_runs(p) >= 1 for p in paths), msg="sleepers running")
        big = ray_tpu_torch.remote(_noop).options(num_cpus=2.0, max_retries=0)
        t0 = time.monotonic()
        ref = big.remote()
        assert ray_tpu_torch.get(ref, timeout=60) == "ok"
        # it ran by PREEMPTION, not by outliving the sleepers
        assert time.monotonic() - t0 < 9.0
        assert c.head.metrics["preemptions"] >= 1
        assert c.head.metrics["preempt_nominations"] >= 1
        # the victims re-run (attempt-free requeue) and still complete
        assert ray_tpu_torch.get(victims, timeout=60) == ["slept", "slept"]
        assert all(_runs(p) >= 2 for p in paths)
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


@pytest.mark.slow
def test_running_at_most_once_tasks_never_preempted(preempt_env, tmp_path):
    """max_retries=0 sleepers hold the node: the starving shape must not
    kill them; it waits until they finish, and each runs exactly once."""
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=3)
    rt = c.client()
    set_runtime(rt)
    try:
        once_fn = ray_tpu_torch.remote(_sleeper).options(num_cpus=1.0, max_retries=0)
        paths = [str(tmp_path / f"amo{i}") for i in range(2)]
        victims = [once_fn.remote(p, 8.0) for p in paths]
        _wait_for(lambda: all(_runs(p) >= 1 for p in paths), msg="sleepers running")
        big = ray_tpu_torch.remote(_noop).options(num_cpus=2.0, max_retries=0)
        ref = big.remote()
        assert ray_tpu_torch.get(ref, timeout=60) == "ok"
        assert ray_tpu_torch.get(victims, timeout=30) == ["slept", "slept"]
        assert [_runs(p) for p in paths] == [1, 1]
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


@pytest.mark.slow
def test_preemption_storm_with_node_kill_chaos(preempt_env, tmp_path):
    """A preemption storm and a node kill: every retryable and starving
    task returns its value (zero acked loss), and no max_retries=0 task
    that started runs twice."""
    from ray_tpu_torch.cluster import Cluster

    c = Cluster()
    c.add_node({"CPU": 2.0}, num_workers=3)
    n1 = c.add_node({"CPU": 2.0}, num_workers=3)
    rt = c.client()
    set_runtime(rt)
    try:
        retry_fn = ray_tpu_torch.remote(_sleeper).options(num_cpus=1.0, max_retries=5)
        once_fn = ray_tpu_torch.remote(_sleeper).options(num_cpus=1.0, max_retries=0)
        retry_paths = [str(tmp_path / f"r{i}") for i in range(3)]
        once_paths = [str(tmp_path / f"o{i}") for i in range(3)]
        retry_refs = [retry_fn.remote(p, 6.0) for p in retry_paths]
        once_refs = [once_fn.remote(p, 6.0) for p in once_paths]
        # two starving shapes keep nomination pressure on both nodes
        big = ray_tpu_torch.remote(_noop).options(num_cpus=2.0, max_retries=1)
        big_refs = [big.remote() for _ in range(2)]
        time.sleep(2.0)  # let the storm arm (starve_rounds=2, ~1 Hz)
        c.kill_node(n1)

        results = {}
        for name, refs in (("big", big_refs), ("once", once_refs), ("retry", retry_refs)):
            for i, r in enumerate(refs):
                try:
                    results[f"{name}{i}"] = ray_tpu_torch.get(r, timeout=240)
                except Exception as exc:  # noqa: BLE001 - typed loss is OK
                    results[f"{name}{i}"] = exc
        for i in range(3):
            assert results[f"retry{i}"] == "slept", results
        for i in range(2):
            assert results[f"big{i}"] == "ok", results
        for p in once_paths:
            assert _runs(p) <= 1, (p, _runs(p))
        for i in range(3):
            assert results[f"once{i}"] == "slept" or isinstance(results[f"once{i}"], Exception)
        assert c.head.metrics["preempt_nominations"] >= 1
    finally:
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# chip_smoke.preemption_verdicts on synthetic runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke`` exits at import without a card: imported with
    ``torch.cuda.is_available`` stubbed; nothing here touches a card."""
    import importlib
    import sys
    from pathlib import Path

    import torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.syspath_prepend(str(Path(__file__).resolve().parents[1]))
        sys.modules.pop("chip_smoke", None)
        module = importlib.import_module("chip_smoke")
    yield module
    sys.modules.pop("chip_smoke", None)


def _clean_runs(**over):
    """A run of the three scenarios as the CPU rehearsal of the phase saw it."""
    runs = {
        "retryable": dict(nominations=6, preemptions=5, sleep_s=10.0, big="ok", big_s=2.5,
                          victims=["slept", "slept"], runs=[2, 2]),
        "at-most-once": dict(nominations=25, preemptions=0, sleep_s=8.0, big="ok", big_s=7.97,
                             victims=["slept", "slept"], runs=[1, 1], after_s=0.02),
        "storm": dict(nominations=51, preemptions=3, big=["ok", "ok"],
                      retry=["slept"] * 3, lost=0, once_runs=[1, 1, 1], unresolved=0),
    }
    for key, fields in over.items():
        runs[key] = {**runs[key], **fields}
    return dict(runs=runs, rounds=112, unequal=[], errors=[])


def test_preemption_verdicts_pass_a_clean_run(smoke):
    assert smoke.preemption_verdicts(**_clean_runs()) == []


@pytest.mark.parametrize("run, words", [
    (_clean_runs(retryable=dict(nominations=0)), "(a) retryable: no preemption nomination"),
    (_clean_runs(storm=dict(nominations=0)), "(c) storm: no preemption nomination"),
    (_clean_runs(retryable=dict(preemptions=0)), "(a) retryable: no preemption executed"),
    (_clean_runs(retryable=dict(big_s=10.4)), "not before the sleepers' natural end"),
    (_clean_runs(retryable=dict(runs=[1, 2])), "not requeued and complete"),
    (_clean_runs(**{"at-most-once": dict(preemptions=1, runs=[2, 1])}),
     "a max_retries=0 task was killed"),
    (_clean_runs(**{"at-most-once": dict(after_s=-3.0)}), "before the sleepers' natural end"),
    (_clean_runs(storm=dict(lost=1)), "1 acked objects lost"),
    (_clean_runs(storm=dict(once_runs=[1, 2, 1])), "ran more than once"),
    (_clean_runs(storm=dict(unresolved=1)), "never resolved"),
    (dict(_clean_runs(), unequal=["head round 7 of 112"]), "unequal on the CPU replay"),
    (dict(_clean_runs(), rounds=0), "no head or ring round"),
    (dict(_clean_runs(), errors=["scheduler round failed; requeueing"]), "ERROR records"),
], ids=["no nomination", "no nomination in the storm", "no preemption", "outlived",
        "victims not requeued", "an at-most-once kill", "big before at-most-once",
        "a lost object", "an at-most-once rerun", "unresolved", "a round unequal on replay",
        "no rounds", "an ERROR record"])
def test_preemption_verdicts_name_each_fault(smoke, run, words):
    failures = smoke.preemption_verdicts(**run)
    assert any(words in f for f in failures), failures


def test_preemption_verdicts_name_a_missing_scenario(smoke):
    run = _clean_runs()
    del run["runs"]["storm"]
    assert smoke.preemption_verdicts(**run) == ["(c) storm: did not run"]
