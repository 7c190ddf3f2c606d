"""Device mesh over ``torch.distributed``: ranks, axes and one group per axis.

Port of ``ray_tpu/parallel/mesh.py``. The JAX package builds a named
``jax.sharding.Mesh`` over its devices and runs one program over all of
them; the port runs one process per rank (``parallel/launch.py``), each
calling the same program on its own shard, and the mesh tells each rank
where it sits and which process group to use for each axis. The canonical
axes are the reference's:

- ``dp`` — data parallel (batch)
- ``pp`` — pipeline parallel (layer stages, ``ops/pipeline.py``)
- ``tp`` — tensor parallel (heads and hidden, Megatron-style)
- ``sp`` — sequence parallel (``ops/ring_attention.py``, ``ops/ulysses.py``)

Expert parallelism (``models/moe.py``) shards the experts over ``tp``.

Ranks map to coordinates in C order over ``(dp, pp, tp, sp)``, as
``np.array(devices).reshape(dp, pp, tp, sp)`` lays out JAX's devices. An
axis of size 1 has no group: every collective over it is the identity, so
a mesh of size 1 (``local_mesh``) needs no ``torch.distributed`` at all.
On CUDA the groups are NCCL's, one rank per card; on the CPU they are
gloo's. Neither falls back to the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

AXES = ("dp", "pp", "tp", "sp")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.sp

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.pp, self.tp, self.sp)

    @staticmethod
    def auto(n_devices: int) -> "MeshConfig":
        """Factor n into a balanced (dp, pp, tp) mesh, largest factors to dp
        (the reference's heuristic for dry runs and tests)."""
        dims = [1, 1, 1]  # dp, pp, tp
        for f in sorted(_prime_factors(n_devices), reverse=True):
            dims[dims.index(min(dims))] *= f
        dp, pp, tp = sorted(dims, reverse=True)
        return MeshConfig(dp=dp, pp=pp, tp=tp, sp=1)


def _prime_factors(n: int) -> list:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def rank_coords(config: MeshConfig, rank: int) -> Dict[str, int]:
    """The rank's index on each axis (C order over ``AXES``)."""
    return {a: int(i) for a, i in zip(AXES, np.unravel_index(rank, config.shape))}


def axis_groups(config: MeshConfig, axis: str) -> List[List[int]]:
    """Every group of ranks along ``axis`` (the ranks that differ only in
    that coordinate), each in axis order, the groups in a fixed order."""
    grid = np.arange(config.size).reshape(config.shape)
    n = config.shape[AXES.index(axis)]
    return np.moveaxis(grid, AXES.index(axis), -1).reshape(-1, n).tolist()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: its coordinates, its device, and a
    process group for each axis of size above 1."""
    config: MeshConfig
    rank: int
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(AXES, self.config.shape))

    def size(self, axis: str) -> int:
        return self.config.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return rank_coords(self.config, self.rank)[axis]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in axis order."""
        return next(g for g in axis_groups(self.config, axis) if self.rank in g)


def build_mesh(config: MeshConfig, device: DeviceLike = None) -> Mesh:
    """This rank's mesh. ``device=None`` is CUDA with NCCL, one rank per
    card (the current card, which ``launch`` sets to the rank); ``"cpu"``
    is gloo. A mesh of size above 1 needs the default process group that
    ``launch`` sets up, with the backend of its device and as many ranks as
    the mesh; it raises otherwise, as JAX's raises "mesh needs N devices"."""
    device = resolve_device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() < config.size:
            raise ValueError(f"mesh needs {config.size} devices, have "
                             f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", torch.cuda.current_device())
    if config.size == 1:
        return Mesh(config, 0, device)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {config.size} ranks needs torch.distributed: run the "
                           "program under ray_tpu_torch.parallel.launch")
    world, backend = dist.get_world_size(), dist.get_backend()
    if world != config.size:
        raise ValueError(f"mesh needs {config.size} ranks, the process group has {world}")
    if backend != BACKENDS.get(device.type):
        raise ValueError(f"a mesh on {device.type} runs on {BACKENDS.get(device.type)}, "
                         f"the process group is {backend}")
    rank = dist.get_rank()
    groups = {}
    for axis in AXES:
        if config.shape[AXES.index(axis)] == 1:
            continue
        for ranks in axis_groups(config, axis):  # every rank creates every group
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(config, rank, device, groups)


def local_mesh(device: DeviceLike = None) -> Mesh:
    """Single-device mesh (every axis size 1): the degenerate configuration
    every model must also run under."""
    return build_mesh(MeshConfig(), device)


def local_shard(mesh: Mesh, x: torch.Tensor, *spec: Optional[str]) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (one axis
    name or None per leading dimension, as a ``PartitionSpec``): the
    counterpart of ``sharding``, which hands JAX the same layout. A view."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not divide "
                             f"over {axis}={n}")
        chunk = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * chunk, chunk)
    return x
