"""The batched cluster scheduler as torch programs (port of
``ray_tpu/scheduler/``).

Cluster state is dense tensors on the scheduler device (``cuda`` unless
the caller passes ``cpu``) and every policy is a batched program:

- resources.py — vocabulary interning, exact fixed-point ledger, dense
  ClusterView.
- hybrid.py    — batched HybridSchedulingPolicy (fidelity, throughput and
  shape-grouped waterfall modes; parked-demand ring; slot estimation).
- bundles.py   — placement-group PACK/SPREAD/STRICT_* bin-packing.
- binpack.py   — autoscaler first-fit residual, projected-gradient solve,
  node-type utilization scorer.
- device.py    — DeviceSchedulerState: resident arrays, delta sync,
  pipelined rounds; pipeline.py and unpark.py around it.
- sim.py       — the simulated-scale harness that drives the real head.
"""
from .resources import (  # noqa: F401
    CPU,
    GPU,
    MEMORY,
    OBJECT_STORE_MEMORY,
    TPU,
    ClusterView,
    NodeResourceLedger,
    ResourceRequest,
    ResourceVocab,
)
from .hybrid import (  # noqa: F401
    HybridConfig,
    ScoreWeights,
    hybrid_schedule_batch,
    hybrid_schedule_reference,
    hybrid_schedule_rounds,
    hybrid_schedule_shapes_multi,
)
from .bundles import schedule_bundles, sort_bundles  # noqa: F401
from .binpack import (  # noqa: F401
    DeltaBinPacker,
    bin_pack_residual,
    pick_best_node_type,
    solve_pack_counts,
    sort_demands,
    utilization_scores,
)
from .device import DeviceSchedulerState, PendingRound  # noqa: F401
from .pipeline import SchedulerPipeline  # noqa: F401
from .elasticity import (  # noqa: F401
    DemandMatrix,
    ElasticPlan,
    ElasticSnapshot,
    ElasticityController,
    GangWant,
    assemble_demand,
    build_plan,
    credit_gang_usage,
    dedupe_task_shapes,
    solve_demand,
)
