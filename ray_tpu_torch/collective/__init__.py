"""ray_tpu_torch.collective — collective communication API.

API parity with the reference's ray.util.collective
(Ray's python/ray/util/collective/collective.py:146-660): actor/task
ranks rendezvous through a host-level group backend (the Gloo analog) —
allreduce/broadcast/allgather/reducescatter/send/recv with barrier
semantics identical to the reference API.

Port of ``ray_tpu/collective/``, copied with its imports rewritten: the
host-level groups. The reference's in-program plane is XLA collectives
inside jit; the port's is ``ray_tpu_torch.parallel``: one process per rank
(``parallel.launch``), a mesh with a ``torch.distributed`` group per axis
(``parallel.mesh``; NCCL on the card, gloo on the CPU) and differentiable
collectives over it (``parallel.collectives``).
"""
from .collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
