"""Owner sessions on the port: ``tests/test_owner_failure.py`` with
``ray_tpu`` read as ``ray_tpu_torch`` and the scheduler's rounds on the
host. A SIGKILLed owner (a real driver in its own process,
``python -m ray_tpu_torch.chaos.owner_proc``) is reaped through missed
heartbeats: its actors killed, its leases revoked and its unproduced
object failed with ``OwnerDiedError``. A clean shutdown reaps the owner's
actors through DisconnectClient, never through the crash path.
"""
import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import OwnerDiedError
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.object_store import ObjectRef
from ray_tpu_torch.core.runtime import set_runtime


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host (agents and workers
    # inherit the environment)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture
def _a_fresh_driver():
    """This process as a driver that runs no client yet. A client an
    earlier test in the same process never shut down leaves its RefFlusher
    installed as the process's consumer; a new client takes that for a
    worker's and runs no owner session, so nothing here would register."""
    from ray_tpu_torch.core import refcount

    refcount.clear_consumer()
    yield


def test_clean_disconnect_skips_crash_detection(tmp_path, monkeypatch, _a_fresh_driver):
    """A clean shutdown (context-manager exit) sends DisconnectClient:
    actors are reaped right away through the disconnect path — never via
    the (slower) missed-heartbeat crash path — and the session is gone
    the moment shutdown returns."""
    monkeypatch.setenv("RAY_TPU_OWNER_LEASE_TTL_S", "30.0")  # crash path idle
    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 2.0}, num_workers=2)
    head = c.head

    class Ephemeral:
        def ping(self):
            return "pong"

    try:
        with c.client() as rt:
            set_runtime(rt)
            cid = rt.client_id
            Actor = ray_tpu_torch.remote(Ephemeral)
            h = Actor.remote()
            assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
            with head._lock:
                assert cid in head._owner_sessions
            set_runtime(None)
        # __exit__ ran shutdown(): session deregistered synchronously, and
        # the non-detached actor is reaped without waiting out any TTL
        with head._lock:
            assert cid not in head._owner_sessions
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            with head._lock:
                live = [
                    a.actor_id
                    for a in head._actors.values()
                    if a.owner_client == cid and a.state != "DEAD"
                ]
            if not live:
                break
            time.sleep(0.1)
        assert not live, f"clean disconnect leaked actors: {live}"
    finally:
        set_runtime(None)
        c.shutdown()


def _start_owner(address: str, info_file: str, actors: int) -> subprocess.Popen:
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch.chaos.owner_proc",
            "--head",
            address,
            "--info-file",
            info_file,
            "--actors",
            str(actors),
            "--hang-task",
        ]
    )


def _wait_info(proc: subprocess.Popen, info_file: str, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, "owner process died during setup"
        if os.path.exists(info_file):
            with open(info_file) as f:
                return json.load(f)
        time.sleep(0.2)
    raise AssertionError("owner process never reported ready")


def test_owner_sigkill_reaps_actors_leases_and_fails_objects(
    tmp_path, monkeypatch, _a_fresh_driver
):
    # tight liveness: detection ~ ttl x threshold (plus the health loop's
    # poll), so the reap lands in a few seconds instead of ~30
    monkeypatch.setenv("RAY_TPU_OWNER_LEASE_TTL_S", "1.0")
    monkeypatch.setenv("RAY_TPU_OWNER_MISS_THRESHOLD", "2")
    monkeypatch.setenv("RAY_TPU_HEALTH_TIMEOUT_S", "4.0")
    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 4.0}, num_workers=3)
    rt = c.client()
    set_runtime(rt)
    proc = None
    try:
        info_file = str(tmp_path / "owner.json")
        proc = _start_owner(c.address, info_file, actors=2)
        info = _wait_info(proc, info_file, timeout=120.0)
        cid = info["client_id"]
        head = c.head
        with head._lock:
            assert cid in head._owner_sessions, "owner session not registered"
        assert info["hang_ref"], "owner never parked its unproduced object"

        # mid-wave SIGKILL: no clean disconnect path runs
        proc.kill()
        proc.wait(timeout=10)
        t_kill = time.monotonic()

        # the full reap lands within (a slack multiple of) one liveness
        # window: ttl 1 x threshold 2 + the poll << 30 s
        live_actors, leases, session = ["?"], ["?"], True
        deadline = t_kill + 30.0
        while time.monotonic() < deadline:
            with head._lock:
                live_actors = [
                    a.actor_id
                    for a in head._actors.values()
                    if a.owner_client == cid and a.state != "DEAD"
                ]
                leases = [
                    lid
                    for lid, e in head._task_leases.items()
                    if e.get("client_id") == cid
                ]
                session = cid in head._owner_sessions
            if not live_actors and not leases and not session:
                break
            time.sleep(0.2)
        assert not live_actors, f"leaked live actors after owner death: {live_actors}"
        assert not leases, f"leaked worker leases after owner death: {leases}"
        assert not session, "owner session never declared dead"
        # every one of the owner's actors is DEAD, not merely detached
        with head._lock:
            states = [
                a.state
                for a in head._actors.values()
                if a.owner_client == cid
            ]
        assert states and all(s == "DEAD" for s in states)

        # dependents see the typed error instead of hanging: the owner's
        # parked max_retries=0 task can never produce its object
        with pytest.raises(OwnerDiedError):
            ray_tpu_torch.get(ObjectRef(info["hang_ref"]), timeout=30)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        set_runtime(None)
        rt.shutdown()
        c.shutdown()
