"""Node providers + the v2 instance-manager reconciler.

Reference analogs: the provider zoo under Ray's
python/ray/autoscaler/ (aws/gcp/.../local/fake_multi_node
node_provider.py) and the v2 InstanceManager
(autoscaler/v2/instance_manager/) that reconciles desired instances
against what the cloud actually delivered.

``LocalNodeProvider`` is the real-process provider: create_node spawns an
actual ``ray_tpu_torch.cluster.agent`` subprocess that registers with a live
head — the local/fake_multi_node pattern, except the nodes are fully
functional agents with worker pools and object stores. Cloud SDK
providers implement the same three methods against their APIs.

``InstanceManager`` wraps any provider with declarative instance records:
a launch is REQUESTED until the node appears in the head's membership,
RUNNING afterwards; launches that never materialize within the timeout
are retried (the v2 reconciler loop collapsed to its core).

Port of ``ray_tpu/autoscaler/providers.py``, copied with its imports
rewritten: the agents it spawns are ``-m ray_tpu_torch.cluster.agent``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .autoscaler import NODE_TYPE_LABEL, NodeTypeConfig


class LocalNodeProvider:
    """Real agent subprocesses against a live head."""

    def __init__(self, head_address: str, num_workers: int = 2):
        self.head_address = head_address
        self.num_workers = num_workers
        self._procs: Dict[str, subprocess.Popen] = {}
        self._head = None
        self._lock = threading.Lock()

    def _head_client(self):
        if self._head is None:
            from ray_tpu_torch.cluster.rpc import RpcClient

            self._head = RpcClient(self.head_address)
        return self._head

    def create_node(
        self, node_type: NodeTypeConfig, node_id: Optional[str] = None
    ) -> str:
        from ray_tpu_torch.cluster.common import new_id

        node_id = node_id or new_id()
        resources = dict(node_type.resources)
        resources.setdefault("memory", float(4 << 30))
        resources.setdefault("object_store_memory", float(1 << 30))
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch.cluster.agent",
                "--head",
                self.head_address,
                "--resources",
                json.dumps(resources),
                "--labels",
                json.dumps({NODE_TYPE_LABEL: node_type.name}),
                "--num-workers",
                str(self.num_workers),
                "--node-id",
                node_id,
            ],
        )
        with self._lock:
            self._procs[node_id] = proc
        return node_id

    def terminate_node(self, node_id: str) -> None:
        # graceful: tell the agent to shut down (releases arena/ports);
        # the process handle is the backstop
        try:
            for n in self.non_terminated_nodes():
                if n["NodeID"] == node_id:
                    from ray_tpu_torch.cluster.rpc import RpcClient

                    cli = RpcClient(n["Address"])
                    try:
                        cli.call("Shutdown", timeout=5.0)
                    finally:
                        cli.close()
                    break
        except Exception:  # noqa: BLE001 - hard kill below
            pass
        with self._lock:
            proc = self._procs.pop(node_id, None)
        if proc is not None:
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                    proc.wait(timeout=2)  # reap: no zombie accumulation
                except Exception:  # noqa: BLE001
                    pass

    def non_terminated_nodes(self) -> List[dict]:
        reply = self._head_client().call("ClusterInfo", timeout=15.0)
        return [n for n in reply["nodes"] if n["Alive"]]

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            try:
                p.terminate()
                p.wait(timeout=2)
            except Exception:  # noqa: BLE001
                pass
        if self._head is not None:
            self._head.close()
            self._head = None


class CloudAPIError(RuntimeError):
    """Transient cloud-API rejection (rate limit, capacity)."""


class MockCloudProvider:
    """Flaky asynchronous cloud in front of LocalNodeProvider — the
    test double the reference shapes with batching_node_provider.py: a
    provider whose API is eventually-consistent and unreliable, driving
    REAL agent subprocesses underneath so the reconciler is proven
    against genuine registration/membership dynamics.

    - ``create_node`` returns a cloud-assigned node id immediately; the
      instance materializes later on a background thread after a random
      provisioning delay — or, with ``create_failure_rate`` probability,
      NEVER (request accepted, instance silently lost: the classic cloud
      failure the v2 reconciler's launch timeout + retry exists for).
    - ``terminate_node`` is also async (delayed on a background thread).
    - a token-bucket rate limit rejects API bursts with CloudAPIError.
    """

    def __init__(
        self,
        head_address: str,
        *,
        num_workers: int = 1,
        create_delay_s: tuple = (0.2, 1.5),
        create_failure_rate: float = 0.2,
        terminate_delay_s: float = 0.5,
        max_requests_per_s: float = 20.0,
        seed: int = 0,
    ):
        import random

        self._local = LocalNodeProvider(head_address, num_workers)
        self._rng = random.Random(seed)
        self._delay = create_delay_s
        self._fail = create_failure_rate
        self._term_delay = terminate_delay_s
        self._rate = max_requests_per_s
        self._tokens = max_requests_per_s
        self._t_last = time.monotonic()
        self._lock = threading.Lock()
        self.created = 0
        self.lost = 0

    def _take_token(self) -> None:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self._rate, self._tokens + (now - self._t_last) * self._rate
            )
            self._t_last = now
            if self._tokens < 1.0:
                raise CloudAPIError("RequestLimitExceeded")
            self._tokens -= 1.0

    def create_node(self, node_type: NodeTypeConfig) -> str:
        from ray_tpu_torch.cluster.common import new_id

        self._take_token()
        node_id = new_id()  # cloud id exists before the instance does
        with self._lock:
            self.created += 1
            fail = self._rng.random() < self._fail
            delay = self._rng.uniform(*self._delay)
            if fail:
                self.lost += 1

        def materialize():
            time.sleep(delay)
            if fail:
                return  # silently lost launch
            try:
                self._local.create_node(node_type, node_id=node_id)
            except Exception:  # noqa: BLE001 - treat as lost
                pass

        threading.Thread(target=materialize, daemon=True).start()
        return node_id

    def terminate_node(self, node_id: str) -> None:
        self._take_token()

        def do_terminate():
            time.sleep(self._term_delay)
            try:
                self._local.terminate_node(node_id)
            except Exception:  # noqa: BLE001 - already gone
                pass

        threading.Thread(target=do_terminate, daemon=True).start()

    def non_terminated_nodes(self) -> List[dict]:
        return self._local.non_terminated_nodes()

    def shutdown(self) -> None:
        self._local.shutdown()


@dataclass
class _Instance:
    instance_id: str
    node_type: str
    state: str  # REQUESTED | RUNNING | TERMINATED
    node_id: Optional[str] = None
    requested_at: float = field(default_factory=time.monotonic)
    retries: int = 0


class InstanceManager:
    """Declarative reconcile over a provider (v2 instance_manager core):
    tracks every launch from REQUESTED to RUNNING, retries launches the
    provider lost, and exposes the same provider interface so the
    Autoscaler composes with it transparently."""

    def __init__(
        self,
        provider,
        *,
        launch_timeout_s: float = 60.0,
        max_retries: int = 2,
    ):
        self.provider = provider
        self.launch_timeout_s = launch_timeout_s
        self.max_retries = max_retries
        self.instances: Dict[str, _Instance] = {}
        self._counter = 0
        self._lock = threading.Lock()
        self._types: Dict[str, NodeTypeConfig] = {}

    # -- provider interface (delegated + recorded) ----------------------
    def create_node(self, node_type: NodeTypeConfig) -> str:
        node_id = self.provider.create_node(node_type)
        with self._lock:
            self._counter += 1
            iid = f"inst-{self._counter}"
            self._types[node_type.name] = node_type
            self.instances[iid] = _Instance(
                instance_id=iid,
                node_type=node_type.name,
                state="REQUESTED",
                node_id=node_id,
            )
        return node_id

    def terminate_node(self, node_id: str) -> None:
        self.provider.terminate_node(node_id)
        with self._lock:
            for inst in self.instances.values():
                if inst.node_id == node_id:
                    inst.state = "TERMINATED"

    def non_terminated_nodes(self) -> List[dict]:
        return self.provider.non_terminated_nodes()

    # -- reconcile ------------------------------------------------------
    def reconcile(self) -> None:
        """REQUESTED instances whose node registered become RUNNING;
        launches that never materialized within the timeout are retried
        (up to max_retries) or marked TERMINATED."""
        alive = {n["NodeID"] for n in self.provider.non_terminated_nodes()}
        now = time.monotonic()
        relaunch: List[_Instance] = []
        reap: List[str] = []
        with self._lock:
            for inst in self.instances.values():
                if inst.state == "REQUESTED":
                    if inst.node_id in alive:
                        inst.state = "RUNNING"
                    elif now - inst.requested_at > self.launch_timeout_s:
                        inst.state = "TERMINATED"
                        if inst.retries < self.max_retries:
                            relaunch.append(inst)
                        elif inst.node_id is not None:
                            # retries exhausted: still reap the straggling
                            # process or it registers later as an untracked
                            # node (relaunch reaps its own below)
                            reap.append(inst.node_id)
                elif inst.state == "RUNNING" and inst.node_id not in alive:
                    # node died underneath us; record it (the autoscaler's
                    # demand loop decides whether replacement is needed)
                    inst.state = "TERMINATED"
        for node_id in reap:
            try:
                self.provider.terminate_node(node_id)
            except Exception:  # noqa: BLE001 - already gone
                pass
        for inst in relaunch:
            cfg = self._types.get(inst.node_type)
            if cfg is None:
                continue
            # reap the original launch FIRST: a slow-spawning agent that
            # registers after its replacement would over-provision the
            # cluster past max_workers
            if inst.node_id is not None:
                try:
                    self.provider.terminate_node(inst.node_id)
                except Exception:  # noqa: BLE001 - already gone
                    pass
            try:
                node_id = self.provider.create_node(cfg)
            except Exception:  # noqa: BLE001 - API rejection (rate limit)
                # cloud-API failure: record a REQUESTED launch with no
                # node so a later tick retries — but still burn a retry,
                # or a PERSISTENTLY failing API (bad credentials) would
                # relaunch forever and report phantom pending capacity
                node_id = None
            with self._lock:
                self._counter += 1
                iid = f"inst-{self._counter}"
                self.instances[iid] = _Instance(
                    instance_id=iid,
                    node_type=cfg.name,
                    state="REQUESTED",
                    node_id=node_id,
                    retries=inst.retries + 1,
                )

    def pending_launches(self) -> Dict[str, int]:
        """REQUESTED instances per node type — capacity the autoscaler
        must count as already on its way (or every tick re-launches the
        same demand until the first agents register)."""
        with self._lock:
            out: Dict[str, int] = {}
            for inst in self.instances.values():
                if inst.state == "REQUESTED":
                    out[inst.node_type] = out.get(inst.node_type, 0) + 1
            return out

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for inst in self.instances.values():
                out[inst.state] = out.get(inst.state, 0) + 1
            return out

    def shutdown(self) -> None:
        if hasattr(self.provider, "shutdown"):
            self.provider.shutdown()
