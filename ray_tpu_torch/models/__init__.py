"""Models (port of ``ray_tpu/models/``)."""
