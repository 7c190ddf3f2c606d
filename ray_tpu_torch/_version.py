"""Port of ``ray_tpu/_version.py``."""
__version__ = "0.1.0"
