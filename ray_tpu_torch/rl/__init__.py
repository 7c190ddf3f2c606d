"""Online-RL continuous-learning loop: rollout → train → publish, with
every trajectory stamped by its weights epoch and every publish fenced by
the two-phase (seal → commit) head WAL protocol.

Port of ``ray_tpu/rl/__init__.py``: the same names."""
from .loop import (  # noqa: F401
    OnlineRLLoop,
    RLLoopConfig,
    RolloutWorker,
    elastic_rl_init,
    elastic_rl_step,
    make_prompt,
    model_config_from_dict,
    model_config_to_dict,
)
from .publish import LocalEpochLedger, WeightsPublisher  # noqa: F401
from .trajectory import (  # noqa: F401
    Trajectory,
    TrajectoryFeed,
    decode_block,
    encode_block,
)
