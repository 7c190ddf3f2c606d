"""ray_tpu_torch.serve — model serving: deployments = replica actor fleets.

Port of ``ray_tpu/serve/`` with the same surface as its ``__init__.py``:
``@deployment`` wraps a class or function; ``serve.run()`` materializes
replica actors behind a router that picks replicas power-of-two-choices
style; a controller loop autoscales replica counts toward
``target_ongoing_requests``, or the SLO autoscaler on TTFT and queue
depth; a router fleet shards one deployment's ingress; HTTP (aiohttp, or
the standard library's server without it), the cluster's own gRPC and
user protobuf services map requests onto handles.
"""
from .admission import (  # noqa: F401
    AdmissionController,
    Overloaded,
)
from .deployment import (  # noqa: F401
    Application,
    Deployment,
    DeploymentHandle,
    NoReplicasForModel,
    deployment,
    get_deployment_handle,
    get_router,
    run,
    shutdown,
    start_grpc_ingress,
    start_http_proxy,
    start_proto_grpc_ingress,
)
from .fleet import (  # noqa: F401
    FleetStream,
    HashRing,
    RouterDeposedError,
    RouterFleet,
)
from .router import (  # noqa: F401
    RoutedStream,
    RouterKilled,
    ServeRouter,
    StreamRedirected,
)
from .slo_autoscaler import SLOAutoscaler, SLOConfig  # noqa: F401
