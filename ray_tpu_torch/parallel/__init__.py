"""Parallelism on ``torch.distributed``: the mesh, its collectives and the
launcher (port of ``ray_tpu/parallel/``)."""
from .mesh import (  # noqa: F401
    AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    local_mesh,
    local_shard,
)
from .launch import launch  # noqa: F401
