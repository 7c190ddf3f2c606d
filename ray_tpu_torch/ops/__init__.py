"""Model ops and kernels (port of ``ray_tpu/ops/``)."""
