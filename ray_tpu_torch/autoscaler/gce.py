"""GCE TPU-VM node provider (cloud-API-backed, transport-injected).

Capability analog of the reference's cloud providers + batching
abstraction (Ray's python/ray/autoscaler/_private/gcp/ and
batching_node_provider.py): the autoscaler's InstanceManager drives a
REAL cloud API — here the TPU VM REST surface
(tpu.googleapis.com/v2/projects/{p}/locations/{z}/nodes) — instead of
local subprocesses.

Design for testability-without-cloud (this image has zero egress): every
HTTP call goes through an injected ``transport(method, url, body) ->
(status, json)``. The default transport authenticates via the GCE
metadata server and uses urllib — usable on a real TPU-VM head node —
while tests inject a fake that proves the request shapes, async
operation handling, rate-limit mapping, and reconciler integration.

TPU-pod mapping: an accelerator type like ``v5e-16`` provisions one
SLICE; the provider labels the node with its slice name so the
scheduler's ICI-domain locality (PG STRICT_PACK ≙ same slice — the
reference approximates this via util/tpu.py:226-265) sees cloud slices
as first-class locality groups.

Port of ``ray_tpu/autoscaler/gce.py``, copied with its imports rewritten.
Nothing here reaches the network unless the caller leaves ``transport``
unset on a GCP VM.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .autoscaler import NodeTypeConfig
from .providers import CloudAPIError

SLICE_LABEL = "ray_tpu.io/slice"


def metadata_token_transport(timeout_s: float = 10.0) -> Callable:
    """Default transport: OAuth token from the GCE metadata server +
    urllib. Only works ON a GCP VM with a TPU-scoped service account."""
    import urllib.request

    def _token() -> str:
        req = urllib.request.Request(
            "http://metadata.google.internal/computeMetadata/v1/instance/"
            "service-accounts/default/token",
            headers={"Metadata-Flavor": "Google"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read())["access_token"]

    def transport(method: str, url: str, body: Optional[dict]) -> Tuple[int, dict]:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url,
            data=data,
            method=method,
            headers={
                "Authorization": f"Bearer {_token()}",
                "Content-Type": "application/json",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                payload = r.read()
                return r.status, json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:  # structured cloud errors
            try:
                return e.code, json.loads(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {}

    return transport


class GceTpuNodeProvider:
    """TPU-VM nodes via the Cloud TPU REST API.

    ``create_node`` issues the create and returns the cloud node id
    immediately (reference NodeProvider contract: creation is async and
    eventually consistent); a background thread polls the returned
    long-running operation. ``non_terminated_nodes`` lists live nodes —
    the InstanceManager's reconciler (providers.py) resolves requested-
    but-never-materialized launches against it exactly as with the mock
    provider, which is the point of sharing that machinery."""

    API = "https://tpu.googleapis.com/v2"

    def __init__(
        self,
        project: str,
        zone: str,
        *,
        runtime_version: str = "tpu-ubuntu2204-base",
        head_address: str = "",
        startup_script: Optional[str] = None,
        transport: Optional[Callable] = None,
        poll_interval_s: float = 5.0,
        network: Optional[str] = None,
    ):
        self.project = project
        self.zone = zone
        self.runtime_version = runtime_version
        self.head_address = head_address
        self.startup_script = startup_script
        self.poll_interval_s = poll_interval_s
        self.network = network
        self._transport = transport or metadata_token_transport()
        self._lock = threading.Lock()
        self._ops: Dict[str, str] = {}  # node_id -> operation name
        self._shutdown = False

    # ------------------------------------------------------------------
    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    def _call(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        status, payload = self._transport(
            method, f"{self.API}/{path}", body
        )
        if status == 429 or status == 403 and "rate" in str(payload).lower():
            raise CloudAPIError(f"rate limited: {payload}")
        if status >= 400:
            raise CloudAPIError(f"TPU API {method} {path} -> {status}: {payload}")
        return payload

    @staticmethod
    def _accelerator_of(node_type: NodeTypeConfig) -> str:
        """The slice shape: an explicit ``accelerator_type`` label-style
        key in resources metadata is not expressible, so the convention
        is TPU count -> v5e slice ("TPU": 8 -> "v5litepod-8")."""
        chips = int(node_type.resources.get("TPU", 0) or 0)
        if chips <= 0:
            raise ValueError(
                f"node type {node_type.name!r} has no TPU resource; "
                "GceTpuNodeProvider provisions TPU-VM slices"
            )
        return f"v5litepod-{chips}"

    def create_node(self, node_type: NodeTypeConfig) -> str:
        from ray_tpu_torch.cluster.common import new_id

        node_id = f"tpu-{node_type.name}-{new_id()[:8]}"
        body = {
            "acceleratorType": self._accelerator_of(node_type),
            "runtimeVersion": self.runtime_version,
            "labels": {
                "ray-tpu-node-type": node_type.name,
                SLICE_LABEL.replace("/", "-").replace(".", "-"): node_id,
            },
            "metadata": {
                "ray-tpu-head-address": self.head_address,
                **(
                    {"startup-script": self.startup_script}
                    if self.startup_script
                    else {}
                ),
            },
        }
        if self.network:
            body["networkConfig"] = {"network": self.network}
        op = self._call(
            "POST", f"{self._parent()}/nodes?nodeId={node_id}", body
        )
        with self._lock:
            self._ops[node_id] = op.get("name", "")
        threading.Thread(
            target=self._poll_operation,
            args=(node_id, op.get("name", "")),
            daemon=True,
            name=f"gce-op-{node_id[:12]}",
        ).start()
        return node_id

    def _poll_operation(self, node_id: str, op_name: str) -> None:
        """Long-running-operation poll: done+error → the launch is lost
        (the reconciler's launch timeout re-requests it); done+ok → the
        VM's startup script joins the head on its own."""
        while op_name and not self._shutdown:
            time.sleep(self.poll_interval_s)
            try:
                op = self._call("GET", op_name)
            except CloudAPIError:
                continue  # transient; keep polling
            if op.get("done"):
                with self._lock:
                    self._ops.pop(node_id, None)
                return

    def terminate_node(self, node_id: str) -> None:
        self._call("DELETE", f"{self._parent()}/nodes/{node_id}")

    def non_terminated_nodes(self) -> List[dict]:
        payload = self._call("GET", f"{self._parent()}/nodes")
        out = []
        for node in payload.get("nodes", ()):
            state = node.get("state", "")
            if state in ("DELETING", "TERMINATED", "PREEMPTED"):
                continue
            name = node.get("name", "").rsplit("/", 1)[-1]
            out.append(
                {
                    # "NodeID" matches the other providers' row shape —
                    # the InstanceManager reconciler keys on it
                    "NodeID": name,
                    "Alive": True,
                    "type": node.get("labels", {}).get(
                        "ray-tpu-node-type", ""
                    ),
                    "state": state,
                    "slice": name,
                }
            )
        return out

    def shutdown(self) -> None:
        self._shutdown = True
