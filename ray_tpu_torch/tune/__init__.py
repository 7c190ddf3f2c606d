"""ray_tpu_torch.tune — hyperparameter search over trial actors.

Port of ``ray_tpu/tune/__init__.py``.

Analog of Ray Tune (Ray's python/ray/tune/): a Tuner runs N trials
(each an actor holding the user function), samples configs from a search
space, and drives trial schedulers (ASHA successive halving, PBT
exploit/explore) off the metrics stream reported by tune.report().
"""
from .search import (  # noqa: F401
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .tuner import (  # noqa: F401
    ASHAScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    ResultGrid,
    TuneConfig,
    Tuner,
    report,
)
