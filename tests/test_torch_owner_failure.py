"""Owner sessions on the port: the clean-disconnect case of
``tests/test_owner_failure.py``, with ``ray_tpu`` read as
``ray_tpu_torch`` and the scheduler's rounds on the host. A clean
shutdown reaps the owner's actors through DisconnectClient, never through
the missed-heartbeat crash path. The reference's SIGKILL case runs its
owner as the chaos package's ``owner_proc``, which the port does not have
yet.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster import Cluster
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
