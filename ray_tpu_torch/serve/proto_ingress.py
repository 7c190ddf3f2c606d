"""Protobuf-interop gRPC ingress for Serve deployments.

Port of ``ray_tpu/serve/proto_ingress.py`` (no JAX in it; grpcio is
imported lazily, where the ingress starts).

Capability analog of the reference's gRPC proxy serving USER-DEFINED
protobuf services (Ray Serve's ``_private/proxy.py``
gRPCProxy + grpc_util.py): users register their generated
``add_<Service>Servicer_to_server`` functions; the ingress implements
each servicer with a dynamic dispatcher that routes decoded request
messages to a deployment and returns its response messages — so any
grpcio client (Python, Go, ...) with its own compiled stubs calls
deployments directly, no ray_tpu_torch on the client.

Routing: one registration binds one generated ``add_fn`` to one
deployment. A servicer method named ``Method`` dispatches to the
deployment's ``Method`` (or its snake_case form). Generated code picks
the handler TYPE from the .proto: unary methods return the replica's
response message; server-streaming methods route through
``num_returns="streaming"`` actor-method calls (streaming generators),
yielding each message as the replica seals it.
"""
from __future__ import annotations

import inspect
import re
from typing import Any, Callable, Dict, List, Tuple

import ray_tpu_torch


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


class _DynamicServicer:
    """Stands in for the user's Servicer subclass: generated add_fns
    fetch method callables by attribute at registration time."""

    def __init__(self, route: Callable[[str, Any, Any], Any]):
        self._route = route

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        route = self._route

        def method(request, context):
            return route(method_name, request, context)

        method.__name__ = method_name
        return method


class ProtoGrpcIngress:
    """A plain grpcio server over the live deployment map."""

    CALL_TIMEOUT_S = 120.0

    def __init__(
        self,
        apps: Dict[str, Any],
        registrations: List[Tuple[Callable, str]],
        port: int = 0,
    ):
        import grpc
        from concurrent.futures import ThreadPoolExecutor

        self._apps = apps
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=16, thread_name_prefix="proto-grpc")
        )
        for add_fn, deployment in registrations:
            add_fn(_DynamicServicer(self._router(deployment)), self._server)
        self.port = self._server.add_insecure_port(f"0.0.0.0:{port}")
        if self.port == 0:
            raise RuntimeError(f"could not bind gRPC ingress port {port}")
        self._server.start()
        self.address = f"127.0.0.1:{self.port}"

    def _router(self, deployment: str) -> Callable:
        def route(method: str, request, context):
            import grpc

            rs = self._apps.get(deployment)
            if rs is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no such deployment: {deployment!r}",
                )
            user_cls = rs.dep.func_or_class
            target = getattr(user_cls, method, None)
            if target is None:
                target = getattr(user_cls, _snake(method), None)
            if target is None or not callable(target):
                context.abort(
                    grpc.StatusCode.UNIMPLEMENTED,
                    f"deployment {deployment!r} has no method "
                    f"{method!r} / {_snake(method)!r}",
                )
            name = target.__name__
            if inspect.isgeneratorfunction(target):
                # server-streaming: the replica yields response messages
                # through a streaming generator; each seals as its own
                # object and flows to the client as it lands
                gen = rs.submit_streaming(name, (request,), {})

                def iterate():
                    for ref in gen:
                        yield ray_tpu_torch.get(ref, timeout=self.CALL_TIMEOUT_S)

                return iterate()
            ref = rs.submit(name, (request,), {})
            return ray_tpu_torch.get(ref, timeout=self.CALL_TIMEOUT_S)

        return route

    def stop(self) -> None:
        self._server.stop(grace=1.0).wait()
