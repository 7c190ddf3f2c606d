"""Serving (port of ``ray_tpu/serve/``): so far the admission control
and the shared prefix cache that the LLM engines use. Deployments, the
router, the fleet and the ingresses wait for a later slice."""
from .admission import AdmissionController, Overloaded  # noqa: F401
