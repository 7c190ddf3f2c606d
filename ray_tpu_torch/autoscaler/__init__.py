"""ray_tpu_torch.autoscaler — demand-driven cluster scaling on the binpack
programs (port of ``ray_tpu/autoscaler/``, copied with its imports
rewritten; the packing runs on the scheduler device)."""
from .autoscaler import Autoscaler, NodeTypeConfig, SimNodeProvider  # noqa: F401
from .providers import (  # noqa: F401
    CloudAPIError,
    InstanceManager,
    LocalNodeProvider,
    MockCloudProvider,
)
