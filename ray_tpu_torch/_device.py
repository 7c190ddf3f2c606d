"""Device resolution for the port's entry points.

``device=None`` means the GPU: the port is written for CUDA and does not
quietly fall back to the CPU. The CPU runs only when a caller asks for it
(the parity tests do), and then every kernel wrapper takes its plain
PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
