"""ray_tpu_torch.dag — lazy task/actor DAGs with a compiled fast path.

Analog of the reference's compiled/accelerated DAGs (Ray's python/
ray/dag/compiled_dag_node.py): ``.bind()`` builds a lazy graph over actor
methods and functions; ``experimental_compile()`` freezes the topology so
repeated ``execute()`` calls skip scheduling and dispatch straight through
the actors' queues (the channel-based bypass, in-process form). For
device-level graphs the idiomatic TPU answer is already jit/pjit — one XLA
program IS the compiled DAG — so this module covers the *actor orchestration*
layer only.

Port of ``ray_tpu/dag/__init__.py``. Device-level graphs are torch's own
business (one ``torch.compile``d or CUDA-graphed program); this package,
like the reference's, orchestrates actors.
"""
from .dag import InputNode, MultiOutputNode  # noqa: F401
from .pipeline import CompiledPipeline, PipelineRef, compile_pipeline  # noqa: F401
