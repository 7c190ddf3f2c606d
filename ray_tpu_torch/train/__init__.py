"""ray_tpu_torch.train — distributed training orchestration.

Port of ``ray_tpu/train/__init__.py``, with ``TorchTrainer`` (Ray's name)
in place of ``JaxTrainer``.

Analog of Ray Train v2 (Ray's python/ray/train/v2/): a controller
creates a placement-group-gang of worker actors, wires rank/world-size
context, runs the user train loop on every worker, and restarts the group
from the latest checkpoint on failure. The compute inside the loop is
the user's torch code (over ray_tpu_torch.parallel's mesh where it wants
one) — workers here are the *control* plane, the reference trainer split
(train/v2/torch/torch_trainer.py).
"""
from .checkpoint import Checkpoint  # noqa: F401
from .session import (  # noqa: F401
    DataIterator,
    get_context,
    get_dataset_shard,
    report,
)
from .trainer import (  # noqa: F401
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
from .elastic import (  # noqa: F401
    ElasticConfig,
    ElasticTrainer,
    GangContext,
    GangEpochRevoked,
    make_shard_and_gather_fns,
    match_partition_rules,
)
