"""Switch-style Mixture-of-Experts, with expert parallelism over ``tp``.

Port of ``ray_tpu/models/moe.py``: top-1 routing with capacity dropping
(Switch Transformer) in the GShard dense-einsum formulation (one-hot
dispatch and combine tensors, static shapes). Expert weight stacks carry a
leading E axis, sharded over the mesh's ``tp`` axis (``moe_specs``); the
router is replicated.

On a mesh, each ``tp`` rank runs its own experts on the tokens, which are
the same on every ``tp`` rank, and the combine is a ``psum`` over ``tp``.
The routing is the reference's over the batch it sees: in JAX ``dp`` is an
automatic axis, so the capacity ``int(capacity_factor * n / e)`` and the
positions inside each expert are taken over the global batch, rows in
order across the ``dp`` ranks. So with ``batch_axis="dp"`` the port counts
n over ``dp`` and offsets each rank's positions by the tokens the lower
``dp`` ranks sent to each expert (one ``all_gather`` of E counts); a token
is then dropped exactly where the reference drops it.

Points held to the reference: the capacity is ``int(capacity_factor * n /
e)`` (at least 1); the position inside an expert is an f32 ``cumsum`` of
the one-hot, exact below 2^24 tokens; ``argmax`` keeps the first index on a
tie (torch's rule as XLA's); the four einsums are ``torch.einsum`` (the
reference runs them through XLA, with no Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import copy_to, gather, psum
from ..parallel.mesh import Mesh


def init_moe(n_experts: int, d_model: int, d_ff: int, n_layers: int,
             generator: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Router and expert stacks, drawn from ``generator`` in the order
    router, w_gate, w_up, w_down (normal, scaled by 1/sqrt(fan-in))."""

    def init(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=dtype)

    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": init(n_layers, d_model, n_experts, scale=s_in),
        "w_gate": init(n_layers, n_experts, d_model, d_ff, scale=s_in),
        "w_up": init(n_layers, n_experts, d_model, d_ff, scale=s_in),
        "w_down": init(n_layers, n_experts, d_ff, d_model, scale=s_ff),
    }


def moe_specs(lp: Optional[str]) -> Dict[str, Tuple[Optional[str], ...]]:
    """Experts sharded over tp (the expert-parallel axis); router
    replicated. ``lp`` shards the layer axis (``"pp"`` when pipelined)."""
    return {
        "router": (lp, None, None),
        "w_gate": (lp, "tp", None, None),
        "w_up": (lp, "tp", None, None),
        "w_down": (lp, "tp", None, None),
    }


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, capacity_factor: float = 1.25,
              mesh: Optional[Mesh] = None, batch_axis: Optional[str] = None) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D], one layer's ``p`` (router [D, E], experts
    [E, D, F] and [E, F, D]; on a mesh, this ``tp`` rank's E/tp experts).
    ``batch_axis`` names the mesh axis that x's batch is sharded over when
    the routing is taken over the whole batch."""
    b, t, d = x.shape
    e = p["router"].shape[-1]
    n_ranks = mesh.size(batch_axis) if mesh is not None and batch_axis else 1
    n = b * t
    cap = max(1, int(capacity_factor * (n * n_ranks) / e))
    xf = x.reshape(n, d)

    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)             # [N, E]
    gate = probs.amax(dim=-1)                         # [N]
    expert = torch.argmax(probs, dim=-1)              # [N]
    onehot = F.one_hot(expert, e).float()             # [N, E]
    pos = torch.cumsum(onehot, dim=0)
    if n_ranks > 1:  # the tokens lower batch ranks sent to each expert come first
        counts = gather(pos[-1:], mesh, batch_axis, 0)  # [ranks, E]
        pos = pos + counts[:mesh.index(batch_axis)].sum(dim=0)
    pos = pos * onehot - 1.0                          # position within expert
    keep = (pos >= 0) & (pos < cap)
    pos_clipped = pos.clamp(0, cap - 1).long()
    # dispatch[n, e, c]: the GShard dense dispatch tensor
    dispatch = (onehot * keep)[:, :, None] * F.one_hot(pos_clipped, cap).float()
    if mesh is not None and mesh.size("tp") > 1:
        local = p["w_gate"].shape[0]
        dispatch = dispatch.narrow(1, mesh.index("tp") * local, local)
        xf, gate = copy_to(xf, mesh, "tp"), copy_to(gate, mesh, "tp")
    combine = dispatch * gate[:, None, None]

    xin = torch.einsum("nec,nd->ecd", dispatch, xf.float()).to(x.dtype)
    g = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", xin, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", g * u, p["w_down"])
    out = torch.einsum("nec,ecd->nd", combine, y.float())
    if mesh is not None:
        out = psum(out, mesh, "tp")
    return out.to(x.dtype).reshape(b, t, d)
