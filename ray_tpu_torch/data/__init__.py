"""ray_tpu_torch.data — streaming datasets over object-store blocks.

Port of ``ray_tpu/data/__init__.py``, with the same exports. Analog of Ray
Data (Ray's python/ray/data/): a Dataset is a lazy
logical plan over blocks; consumption runs a streaming executor that maps
blocks through the operator chain as parallel tasks with bounded in-flight
work (backpressure), blocks flowing through the object store as ObjectRefs
(streaming_executor.py:77 shape, collapsed to a fused operator chain).
"""
from .dataset import (  # noqa: F401
    Dataset,
    GroupedData,
    from_items,
    from_numpy,
    from_numpy_blocks,
    range_,
)
from .execution import ActorPoolStrategy, actors  # noqa: F401
from .io import (  # noqa: F401
    from_numpy,
    from_pandas,
    read_csv,
    read_json,
    read_parquet,
    to_pandas,
    write_csv,
    write_parquet,
)

range = range_  # ray_tpu_torch.data.range(n) parity with ray.data.range
