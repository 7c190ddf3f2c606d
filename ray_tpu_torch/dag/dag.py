"""DAG nodes, binding, execution.

Port of ``ray_tpu/dag/dag.py``, copied with its imports rewritten.
"""
from __future__ import annotations

from typing import Any, Dict, List

import ray_tpu_torch
from ray_tpu_torch.core.actor import ActorHandle, ActorMethod


class DAGNode:
    def execute(self, *args):
        """Run the whole upstream graph for one input."""
        cache: Dict[int, Any] = {}
        return self._eval(args, cache)

    def experimental_compile(self, **kwargs) -> "CompiledDAG":
        """Freeze the topology into a channel-driven pipeline executor
        (see ray_tpu_torch/dag/compiled.py). ``execute`` on the compiled object
        returns a CompiledDAGRef; multiple in-flight executions pipeline
        across stages."""
        from .compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def _eval(self, inputs, cache):  # pragma: no cover - abstract
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for execute()'s argument(s); context-manager API parity
    with ray.dag.InputNode."""

    def __init__(self, index: int = 0):
        self.index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _eval(self, inputs, cache):
        return inputs[self.index]


class MethodNode(DAGNode):
    def __init__(self, handle: ActorHandle, method: str, args, kwargs):
        self.handle = handle
        self.method = method
        self.args = args
        self.kwargs = kwargs

    def _eval(self, inputs, cache):
        key = id(self)
        if key in cache:
            return cache[key]
        args = [
            a._eval(inputs, cache) if isinstance(a, DAGNode) else a
            for a in self.args
        ]
        kwargs = {
            k: v._eval(inputs, cache) if isinstance(v, DAGNode) else v
            for k, v in self.kwargs.items()
        }
        ref = getattr(self.handle, self.method).remote(*args, **kwargs)
        out = ray_tpu_torch.get(ref)
        cache[key] = out
        return out


class FunctionNode(DAGNode):
    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs

    def _eval(self, inputs, cache):
        key = id(self)
        if key in cache:
            return cache[key]
        args = [
            a._eval(inputs, cache) if isinstance(a, DAGNode) else a
            for a in self.args
        ]
        kwargs = {
            k: v._eval(inputs, cache) if isinstance(v, DAGNode) else v
            for k, v in self.kwargs.items()
        }
        ref = self.fn.remote(*args, **kwargs)
        out = ray_tpu_torch.get(ref)
        cache[key] = out
        return out


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        self.outputs = outputs

    def _eval(self, inputs, cache):
        return [o._eval(inputs, cache) for o in self.outputs]


def _bind_method(self: ActorMethod, *args, **kwargs) -> MethodNode:
    return MethodNode(self._handle, self._name, args, kwargs)


def _bind_function(self, *args, **kwargs) -> FunctionNode:
    return FunctionNode(self, args, kwargs)


# graft .bind onto the method/function descriptors (parity with the
# reference's DAGNode bind API on actor methods and remote functions)
ActorMethod.bind = _bind_method
from ray_tpu_torch.core.api import RemoteFunction  # noqa: E402

RemoteFunction.bind = _bind_function


def _bind_remote_method(self, *args, **kwargs) -> MethodNode:
    # cluster-mode actor methods (RemoteActorHandle._RemoteMethod) bind to
    # the same MethodNode; CompiledDAG detects the remote handle and routes
    # execution through worker-installed shm-channel programs
    handle = RemoteActorHandle(self._runtime, self._actor_id, object)
    return MethodNode(handle, self._method, args, kwargs)


try:  # cluster client needs grpc; pure-local DAG use must not require it
    from ray_tpu_torch.cluster.client import (  # noqa: E402
        RemoteActorHandle,
        _RemoteMethod,
    )

    _RemoteMethod.bind = _bind_remote_method
except ImportError:  # pragma: no cover - grpc-less environment
    RemoteActorHandle = None
