"""The RPC layer: retries, deadlines, circuit breaker, and the static
dispatch-table check.

RetryableGrpcClient analog (reference contract:
src/ray/rpc/retryable_grpc_client.h — exponential backoff between retries,
a server-unavailable timeout after which the client gives up and fires a
callback, and caller deadlines that bound the whole retry sequence). The
dispatch-table check: every RPC method name invoked via
``RpcClient.call("Name", ...)`` in the cluster runtime has a handler
registered on SOME server's dispatch table (head, agent, worker, or the
client's callback server), found syntactically from every dict literal
whose string keys include "Ping".

Mirror of ``tests/test_rpc_retry.py`` and ``tests/test_rpc_tables.py`` on
the port (``ray_tpu_torch``), the same cases and assertions.
"""
import ast
import os
import time

import pytest

from ray_tpu_torch.cluster.rpc import (
    FAULTS,
    PeerUnavailableError,
    RpcClient,
    RpcDeadlineError,
    RpcError,
    RpcServer,
    get_breaker,
    reset_breakers,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.clear()
    reset_breakers()
    yield
    FAULTS.clear()
    reset_breakers()


def _dead_address() -> str:
    """An address with nothing listening (bind, grab the port, close)."""
    srv = RpcServer({"Echo": lambda r: r})
    addr = srv.address
    srv.stop()
    return addr


def test_roundtrip_and_server_exception():
    srv = RpcServer({"Echo": lambda r: r, "Boom": lambda r: 1 / 0})
    c = RpcClient(srv.address)
    try:
        assert c.call("Echo", {"x": 1}) == {"x": 1}
        with pytest.raises(ZeroDivisionError):
            c.call("Boom")
    finally:
        c.close()
        srv.stop()


def test_retry_sequence_respects_caller_deadline():
    """No retry sequence exceeds the caller's overall timeout: a huge
    retry budget against a dead peer must stop at deadline_s."""
    c = RpcClient(_dead_address())
    t0 = time.monotonic()
    with pytest.raises(RpcDeadlineError):
        c.call(
            "Echo",
            1,
            timeout=30.0,
            retries=10_000,
            retry_interval=0.02,
            deadline_s=0.6,
        )
    elapsed = time.monotonic() - t0
    assert elapsed < 2.0, f"retry loop overran the 0.6s deadline: {elapsed}"
    c.close()


def test_deadline_error_is_an_rpc_error():
    """Existing except-RpcError recovery paths must catch deadline
    exhaustion too."""
    assert issubclass(RpcDeadlineError, RpcError)
    assert issubclass(PeerUnavailableError, RpcError)


def test_backoff_sleeps_are_capped(monkeypatch):
    """Backoff grows but never exceeds the configured cap."""
    monkeypatch.setenv("RAY_TPU_RPC_BACKOFF_CAP_S", "0.05")
    sleeps = []
    real_sleep = time.sleep
    monkeypatch.setattr(
        time, "sleep", lambda s: (sleeps.append(s), real_sleep(min(s, 0.01)))
    )
    c = RpcClient(_dead_address())
    with pytest.raises(RpcError):
        c.call("Echo", 1, timeout=0.2, retries=6, retry_interval=0.01)
    c.close()
    assert len(sleeps) == 6
    assert all(s <= 0.05 + 1e-9 for s in sleeps), sleeps
    assert all(s >= 0.01 - 1e-9 for s in sleeps), sleeps


def test_breaker_opens_within_window_under_blackholed_peer(monkeypatch):
    """A blackholed peer's circuit opens once failures span the
    configured server-unavailable window, then calls fail fast."""
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_WINDOW_S", "0.3")
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_COOLDOWN_S", "5.0")
    srv = RpcServer({"Echo": lambda r: r})
    fired = []
    c = RpcClient(srv.address, on_unreachable=lambda: fired.append(1))
    FAULTS.blackhole(srv.address)
    br = get_breaker(srv.address)
    t0 = time.monotonic()
    while br.state != br.OPEN:
        with pytest.raises(RpcError):
            c.call("Echo", 1, retries=0)
        time.sleep(0.03)
        assert time.monotonic() - t0 < 3.0, "breaker never opened"
    opened_after = time.monotonic() - t0
    assert 0.25 <= opened_after < 2.0, opened_after
    assert fired, "node-unreachable callback did not fire"
    # open circuit: fail fast, no wire, no per-attempt timeout burned
    t1 = time.monotonic()
    with pytest.raises(PeerUnavailableError):
        c.call("Echo", 1, timeout=30.0)
    assert time.monotonic() - t1 < 0.05
    c.close()
    srv.stop()


def test_breaker_half_open_probe_recovers(monkeypatch):
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_WINDOW_S", "0.2")
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_COOLDOWN_S", "0.2")
    srv = RpcServer({"Echo": lambda r: r})
    c = RpcClient(srv.address)
    FAULTS.blackhole(srv.address)
    br = get_breaker(srv.address)
    deadline = time.monotonic() + 3.0
    while br.state != br.OPEN and time.monotonic() < deadline:
        with pytest.raises(RpcError):
            c.call("Echo", 1, retries=0)
        time.sleep(0.03)
    assert br.state == br.OPEN
    # heal the partition: a patient retry loop rides the half-open probe
    # back to a closed circuit
    FAULTS.heal(srv.address)
    assert c.call("Echo", 7, retries=10, retry_interval=0.1) == 7
    assert br.state == br.CLOSED
    c.close()
    srv.stop()


def test_straggler_delay_injection():
    srv = RpcServer({"Echo": lambda r: r})
    c = RpcClient(srv.address)
    FAULTS.set_delay(srv.address, 0.15)
    t0 = time.monotonic()
    assert c.call("Echo", 1) == 1
    assert time.monotonic() - t0 >= 0.14
    FAULTS.heal(srv.address)
    t1 = time.monotonic()
    assert c.call("Echo", 2) == 2
    assert time.monotonic() - t1 < 0.1
    c.close()
    srv.stop()


def test_breaker_shared_across_clients_to_same_peer(monkeypatch):
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_WINDOW_S", "0.2")
    monkeypatch.setenv("RAY_TPU_RPC_BREAKER_COOLDOWN_S", "30.0")
    srv = RpcServer({"Echo": lambda r: r})
    c1 = RpcClient(srv.address)
    c2 = RpcClient(srv.address)
    FAULTS.blackhole(srv.address)
    br = get_breaker(srv.address)
    deadline = time.monotonic() + 3.0
    while br.state != br.OPEN and time.monotonic() < deadline:
        with pytest.raises(RpcError):
            c1.call("Echo", 1, retries=0)
        time.sleep(0.03)
    assert br.state == br.OPEN
    # the OTHER client to the same peer fails fast too: breaker state is
    # per peer, not per channel
    with pytest.raises(PeerUnavailableError):
        c2.call("Echo", 1, timeout=30.0)
    c1.close()
    c2.close()
    srv.stop()


# ---------------------------------------------------------------------------
# static dispatch tables
# ---------------------------------------------------------------------------


CLUSTER_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ray_tpu_torch",
    "cluster",
)

# methods invoked through indirection the AST scan can't see, or served
# by processes outside ray_tpu_torch/cluster (keep this list SHORT and justified)
ALLOWED_UNREGISTERED: set = set()


def _cluster_sources():
    for name in sorted(os.listdir(CLUSTER_DIR)):
        if name.endswith(".py"):
            path = os.path.join(CLUSTER_DIR, name)
            with open(path) as f:
                yield name, ast.parse(f.read(), filename=path)


def _registered_handlers() -> dict:
    """method name -> [files registering it], from every handler-table
    dict literal (identified by its mandatory "Ping" key)."""
    registered: dict = {}
    for name, tree in _cluster_sources():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Dict):
                continue
            keys = [
                k.value
                for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            ]
            if "Ping" not in keys:
                continue
            for k in keys:
                registered.setdefault(k, []).append(name)
    return registered


def _called_methods() -> dict:
    """method name -> [files calling it], from every `<x>.call("Name")`
    site."""
    calls: dict = {}
    for name, tree in _cluster_sources():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            # direct form: <client>.call("Name", ...)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "call"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                calls.setdefault(node.args[0].value, []).append(name)
                continue
            # indirected form: _best_effort(client.call, "Name", ...) /
            # pool.submit(..., client.call, "Name", ...)
            for i, arg in enumerate(node.args[:-1]):
                if (
                    isinstance(arg, ast.Attribute)
                    and arg.attr == "call"
                    and isinstance(node.args[i + 1], ast.Constant)
                    and isinstance(node.args[i + 1].value, str)
                ):
                    calls.setdefault(
                        node.args[i + 1].value, []
                    ).append(name)
    return calls


def test_every_invoked_rpc_kind_has_a_handler():
    registered = _registered_handlers()
    assert "Ping" in registered and len(registered) > 20, (
        "handler-table discovery broke (dict-with-Ping heuristic): "
        f"{sorted(registered)}"
    )
    calls = _called_methods()
    assert len(calls) > 15, f"call-site discovery broke: {sorted(calls)}"
    missing = {
        m: files
        for m, files in calls.items()
        if m not in registered and m not in ALLOWED_UNREGISTERED
    }
    assert not missing, (
        "RPC kinds invoked with no registered handler anywhere "
        f"(dispatch-table drift): {missing}"
    )


def test_lease_plane_kinds_are_wired_both_ends():
    """The task-lease RPC kinds this subsystem depends on exist on both
    sides of the wire (belt-and-braces over the generic check)."""
    registered = _registered_handlers()
    calls = _called_methods()
    for kind in (
        "GrantTaskLease",
        "ReturnWorkerLease",
        "LeaseTaskBatch",
        "LeaseRecall",
        "LeaseRelease",
        "DirectResults",
    ):
        assert kind in registered, f"{kind} has no registered handler"
        assert kind in calls, f"{kind} is registered but never invoked"
