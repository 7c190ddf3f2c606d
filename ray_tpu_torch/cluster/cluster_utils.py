"""Multi-process cluster harness for tests and local clusters.

The analog of the reference's ``ray.cluster_utils.Cluster``
(Ray's python/ray/cluster_utils.py:137): the head runs in-process
(so tests can reach its metrics/state directly), and every ``add_node``
launches a REAL node-agent subprocess with its own resource spec, worker
subprocesses, and shared-memory store — multi-node scheduling, object
transfer, and failure handling are exercised across genuine process
boundaries on one machine.

Port of ``ray_tpu/cluster/cluster_utils.py``, copied with its imports
rewritten.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .client import RemoteRuntime
from .head import HeadServer
from .rpc import RpcClient, RpcError


class Cluster:
    def __init__(
        self,
        use_device_scheduler: Optional[bool] = None,
        dashboard: bool = False,
        persist_path: Optional[str] = None,
    ):
        self._dashboard = dashboard
        self._persist_path = persist_path
        self._use_device_scheduler = use_device_scheduler
        self.head = HeadServer(
            use_device_scheduler=use_device_scheduler,
            dashboard_port=0 if dashboard else None,
            persist_path=persist_path,
        )
        self.address = self.head.address
        self._agents: Dict[str, subprocess.Popen] = {}
        self._counter = 0
        # warm-standby head (start_standby/promote/kill_head): failover
        # harness for tests and chaos plans
        self.standby = None
        self._dead_heads: List[HeadServer] = []

    def restart_head(self) -> None:
        """Kill and restart only the head on the same port (GCS fault
        tolerance: agents and their actors keep running, re-register, and
        persisted state reloads)."""
        port = int(self.address.rsplit(":", 1)[1])
        self.head.shutdown(stop_agents=False)
        time.sleep(0.3)
        self.head = HeadServer(
            port=port,
            use_device_scheduler=self._use_device_scheduler,
            dashboard_port=0 if self._dashboard else None,
            persist_path=self._persist_path,
        )
        assert self.head.address == self.address

    # ------------------------------------------------------------------
    # replicated control plane (standby.py): warm-standby failover
    # ------------------------------------------------------------------
    def start_standby(self, auto_promote: bool = True):
        """Start (or replace) a warm standby tailing this cluster's
        leader. With ``auto_promote`` it detects leader death via the
        strike-based watch loop and promotes itself onto the leader's
        port; ``cluster.head`` swaps to the promoted instance."""
        from .standby import StandbyHead

        if self.standby is not None:
            self.standby.shutdown()
        self.standby = StandbyHead(
            self.address,
            persist_path=self._persist_path,
            auto_promote=auto_promote,
            use_device_scheduler=self._use_device_scheduler,
        )
        self.standby.on_promoted = self._adopt_head
        return self.standby

    def _adopt_head(self, head: HeadServer) -> None:
        self.head = head

    def kill_head(self) -> None:
        """SIGKILL-equivalent for the in-process leader: the RPC
        listener drops mid-flight, no final snapshot is flushed, no
        agent is told anything — and the persistence dir stays intact
        for the standby. (The head runs in-process so tests can reach
        its tables; an os.kill would take the test with it.)"""
        head = self.head
        head._shutdown = True
        with head._cond:
            head._cond.notify_all()
        head._repl.stop()
        head._server.stop(grace=0)
        if head._pipeline is not None:
            try:
                head._pipeline.stop()
            except Exception:  # noqa: BLE001 - corpse hygiene only
                pass
        head._dispatch_pool.shutdown(wait=False, cancel_futures=True)
        try:
            head.jobs.shutdown()
        except Exception:  # noqa: BLE001
            pass
        # close channels so the corpse's breaker callbacks never fire
        # into dead state (in-process analog of the kernel reaping fds)
        with head._lock:
            clients = list(head._clients.values())
        for client in clients:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass
        self._dead_heads.append(head)

    def promote(self, timeout: float = 30.0) -> HeadServer:
        """Promote the standby (or wait out its in-flight
        auto-promotion) and adopt the new head."""
        if self.standby is None:
            raise RuntimeError("no standby started (start_standby first)")
        if self.standby.promoted is None and not self.standby.auto_promote:
            self.standby.promote()
        head = self.standby.wait_promoted(timeout=timeout)
        if head is None:
            raise TimeoutError(
                f"standby did not promote within {timeout}s"
            )
        self.head = head
        return head

    def add_node(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        num_workers: int = 2,
        wait: bool = True,
        store_capacity: int = 1 << 28,
    ) -> str:
        resources = dict(resources or {"CPU": 4.0})
        resources.setdefault("memory", float(4 << 30))
        resources.setdefault("object_store_memory", float(1 << 30))
        self._counter += 1
        node_id = f"node{self._counter:03d}" + "0" * 9
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch.cluster.agent",
                "--head",
                self.address,
                "--resources",
                json.dumps(resources),
                "--labels",
                json.dumps(labels or {}),
                "--num-workers",
                str(num_workers),
                "--node-id",
                node_id,
                "--store-capacity",
                str(store_capacity),
            ],
        )
        self._agents[node_id] = proc
        if wait:
            self.wait_for_nodes(len(self._agents))
        return node_id

    def wait_for_nodes(self, count: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = sum(1 for n in self.head.nodes.values() if n.alive)
            if alive >= count:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"cluster did not reach {count} live nodes in {timeout}s"
        )

    def kill_node(self, node_id: str) -> None:
        """Hard-kill an agent process (RayletKiller chaos analog,
        _private/test_utils.py:1408). The head's health checks notice."""
        proc = self._agents.get(node_id)
        if proc is not None:
            proc.kill()
            proc.wait(timeout=10)
            # drop the corpse so add_node's wait target counts only
            # launched-and-living agents (killing every replica of an
            # object then adding a recovery node must not wait forever
            # for the dead ones to come back)
            self._agents.pop(node_id, None)

    def drain_node(
        self, node_id: str, deadline_s: Optional[float] = None
    ) -> bool:
        """Graceful retirement (drain-ahead): mark the node
        draining at the head (zero advertised capacity, drain-ahead
        migration moves its leased work), then terminate the agent
        process once drained or at the deadline. Returns False for
        unknown nodes."""
        from ray_tpu_torch.config import cfg

        if node_id not in self._agents:
            return False
        if deadline_s is None:
            deadline_s = float(cfg.elastic_drain_deadline_s)
        if not self.head.begin_node_drain(node_id, deadline_s=deadline_s):
            return False
        try:
            self.head.migrate_node_leases(node_id)
        except Exception:  # noqa: BLE001 - best-effort ahead of the kill
            pass
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if self.head.node_drained(node_id):
                break
            time.sleep(0.05)
        proc = self._agents.pop(node_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
        self.head.finish_node_drain(node_id, retire=True)
        return True

    def attach_elasticity_provider(
        self,
        resources: Optional[Dict[str, float]] = None,
        num_workers: int = 1,
        max_nodes: int = 8,
    ) -> "ClusterProvider":
        """Wire this harness in as the elasticity controller's agent
        lifecycle: provisions become real ``add_node`` subprocesses,
        retirements real drains. Returns the provider."""
        provider = ClusterProvider(
            self,
            resources=resources,
            num_workers=num_workers,
            max_nodes=max_nodes,
        )
        self.head._elasticity.attach_provider(provider)
        return provider

    # ------------------------------------------------------------------
    # chaos fault surface (ray_tpu_torch.chaos rides these)
    # ------------------------------------------------------------------
    def agent_address(self, node_id: str) -> Optional[str]:
        info = self.head.nodes.get(node_id)
        return info.address if info is not None else None

    def partition_node(self, node_id: str) -> bool:
        """Blackhole the control plane's path TO this node (one-way
        partition): every head->agent RPC fails at transport level, the
        per-peer circuit breaker opens within its window, and the
        node-unreachable callback feeds the health path. The agent itself
        keeps running — on heal it re-registers and rejoins."""
        from .rpc import FAULTS

        addr = self.agent_address(node_id)
        if addr is None:
            return False
        FAULTS.blackhole(addr)
        return True

    def heal_node(self, node_id: str) -> bool:
        from .rpc import FAULTS

        addr = self.agent_address(node_id)
        if addr is None:
            return False
        FAULTS.heal(addr)
        return True

    def set_node_delay(self, node_id: str, seconds: float) -> bool:
        """Straggler injection: every head->agent RPC to this node waits
        ``seconds`` before hitting the wire (delay ramps come from the
        chaos plan calling this repeatedly)."""
        from .rpc import FAULTS

        addr = self.agent_address(node_id)
        if addr is None:
            return False
        FAULTS.set_delay(addr, seconds)
        return True

    def heal_all(self) -> None:
        from .rpc import FAULTS

        FAULTS.clear()

    def client(self) -> RemoteRuntime:
        return RemoteRuntime(self.address)

    def shutdown(self) -> None:
        # standby first: its watch loop must not misread the leader's
        # clean shutdown as a death and promote into the teardown
        if self.standby is not None:
            self.standby.shutdown()
            self.standby = None
        self.head.shutdown()
        for proc in self._agents.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 5
        for proc in self._agents.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
        self._agents.clear()


class ClusterProvider:
    """The elasticity controller's node lifecycle against a local
    :class:`Cluster` — the in-process analog of a cloud provider's
    instance API. ``create_node`` launches a real agent subprocess;
    ``drain_node``/``terminate_node`` retire one. ``max_nodes`` bounds
    runaway provisioning the way a cloud quota would."""

    def __init__(
        self,
        cluster: Cluster,
        resources: Optional[Dict[str, float]] = None,
        num_workers: int = 1,
        max_nodes: int = 8,
    ):
        self.cluster = cluster
        self.resources = dict(resources or {"CPU": 2.0})
        self.num_workers = num_workers
        self.max_nodes = max_nodes
        self.created: List[str] = []
        self.terminated: List[str] = []

    def node_template(self) -> Dict[str, float]:
        return dict(self.resources)

    def create_node(self) -> Optional[str]:
        if len(self.cluster._agents) >= self.max_nodes:
            return None
        node_id = self.cluster.add_node(
            resources=dict(self.resources),
            num_workers=self.num_workers,
            wait=False,
        )
        self.created.append(node_id)
        return node_id

    def drain_node(self, node_id: str, deadline_s: float) -> bool:
        ok = self.cluster.drain_node(node_id, deadline_s=deadline_s)
        if ok:
            self.terminated.append(node_id)
        return ok

    def terminate_node(self, node_id: str) -> bool:
        if node_id not in self.cluster._agents:
            return False
        self.cluster.kill_node(node_id)
        self.terminated.append(node_id)
        return True
