"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``.

Ports ``ray_tpu/`` module for module (each module's docstring names the
file it ports). The package imports ``torch`` and ``numpy`` only: never
``jax`` and never ``ray_tpu``. Its kernels are hand-written CUDA C++ for
Hopper (``csrc/*.cu``, built at first use by ``_cuda.py``); every kernel
wrapper keeps a plain PyTorch version beside it, which runs for tensors
on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than carry on on the CPU. The local
runtime (``init`` → ``remote`` → ``get``; port of ``ray_tpu/__init__.py``'s
public names) schedules on ``cuda`` unless ``RAY_TPU_SCHED_PLATFORM=cpu``.
"""
from ._version import __version__  # noqa: F401
from ._device import resolve_device

from .core.api import (  # noqa: F401
    GetTimeoutError,
    ObjectLostError,
    ObjectRef,
    OwnerDiedError,
    TaskError,
    actor_exited,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from .core.placement_group import (  # noqa: F401
    placement_group,
    placement_group_table,
    remove_placement_group,
)

# method decorator for actor method options
from .core.actor import method  # noqa: F401

__all__ = ["resolve_device"]
