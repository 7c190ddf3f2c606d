"""Utilities: metrics and tracing (port of ``ray_tpu/util/``)."""
