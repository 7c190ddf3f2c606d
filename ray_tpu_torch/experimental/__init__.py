"""ray_tpu_torch.experimental — channels (mutable objects) and pre-GA surfaces.

Port of ``ray_tpu/experimental/__init__.py``.
"""
from .channel import (  # noqa: F401
    Channel,
    ChannelClosed,
    ChannelReader,
    ChannelWriter,
)
