"""Distributed multi-process runtime: head (GCS analog), node agents
(raylet analog), worker subprocesses, and the driver client — over gRPC.

Lazy exports keep worker-subprocess startup light (head/agent pull in the
scheduler programs; workers only need rpc + common).

Port of ``ray_tpu/cluster/``: the head (whose rounds run on the scheduler
device, ``cuda`` unless ``RAY_TPU_SCHED_PLATFORM=cpu``), the warm standby,
agents, workers, zygote, client, wire format, RPC, transport, object plane
with its device frames for CUDA tensors, WAL, jobs and the dashboard.
"""
from typing import Any

_EXPORTS = {
    "RemoteRuntime": ("ray_tpu_torch.cluster.client", "RemoteRuntime"),
    "connect": ("ray_tpu_torch.cluster.client", "connect"),
    "Cluster": ("ray_tpu_torch.cluster.cluster_utils", "Cluster"),
    "HeadServer": ("ray_tpu_torch.cluster.head", "HeadServer"),
    "NodeAgent": ("ray_tpu_torch.cluster.agent", "NodeAgent"),
    "LeaseRequest": ("ray_tpu_torch.cluster.common", "LeaseRequest"),
    "NodeInfo": ("ray_tpu_torch.cluster.common", "NodeInfo"),
    "JobSubmissionClient": ("ray_tpu_torch.cluster.jobs", "JobSubmissionClient"),
    "RpcClient": ("ray_tpu_torch.cluster.rpc", "RpcClient"),
    "RpcServer": ("ray_tpu_torch.cluster.rpc", "RpcServer"),
    "RpcError": ("ray_tpu_torch.cluster.rpc", "RpcError"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
