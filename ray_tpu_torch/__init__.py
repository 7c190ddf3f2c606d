"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``.

Ports ``ray_tpu/`` module for module (each module's docstring names the
file it ports). The package imports ``torch`` and ``numpy`` only: never
``jax`` and never ``ray_tpu``. Its kernels are hand-written CUDA C++ for
Hopper (``csrc/*.cu``, built at first use by ``_cuda.py``); every kernel
wrapper keeps a plain PyTorch version beside it, which runs for tensors
on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than carry on on the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
