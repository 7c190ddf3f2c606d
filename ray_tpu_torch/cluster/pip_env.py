"""Isolated pip/uv/conda runtime environments.

Port of ``ray_tpu/cluster/pip_env.py``: only ``has_env`` (``:45``), which
the local runtime calls to refuse an isolated environment, since those
need worker processes. The environment builders wait for the cluster
runtime's agents.
"""
from __future__ import annotations

ENV_KINDS = ("pip", "uv", "conda")


def has_env(runtime_env) -> bool:
    """True when a runtime_env needs an isolated-env-bound worker."""
    return bool(runtime_env) and any(
        runtime_env.get(k) is not None for k in ENV_KINDS
    )
