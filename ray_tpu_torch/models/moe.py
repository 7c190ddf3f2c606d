"""Switch-style Mixture-of-Experts on one device.

Port of ``init_moe`` and ``moe_apply`` from ``ray_tpu/models/moe.py``:
top-1 routing with capacity dropping (Switch Transformer) in the GShard
dense-einsum formulation (one-hot dispatch and combine tensors, static
shapes). Expert weight stacks carry a leading E axis. The expert-parallel
sharding over ``tp`` (``moe_specs``) waits for the parallelism slice.

Points held to the reference: the capacity is ``int(capacity_factor * n /
e)`` (at least 1); the position inside an expert is an f32 ``cumsum`` of
the one-hot, exact below 2^24 tokens; ``argmax`` keeps the first index on a
tie (torch's rule as XLA's); the four einsums are ``torch.einsum`` (the
reference runs them through XLA, with no Pallas kernel).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


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


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D], one layer's ``p`` (router [D, E], experts
    [E, D, F] and [E, F, D])."""
    b, t, d = x.shape
    n = b * t
    e = p["router"].shape[-1]
    cap = max(1, int(capacity_factor * n / e))
    xf = x.reshape(n, d)

    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)             # [N, E]
    gate = probs.amax(dim=-1)                         # [N]
    expert = torch.argmax(probs, dim=-1)              # [N]
    onehot = F.one_hot(expert, e).float()             # [N, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # position within expert
    keep = (pos >= 0) & (pos < cap)
    pos_clipped = pos.clamp(0, cap - 1).long()
    # dispatch[n, e, c]: the GShard dense dispatch tensor
    dispatch = (onehot * keep)[:, :, None] * F.one_hot(pos_clipped, cap).float()
    combine = dispatch * gate[:, None, None]

    xin = torch.einsum("nec,nd->ecd", dispatch, xf.float()).to(x.dtype)
    g = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", xin, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", g * u, p["w_down"])
    out = torch.einsum("nec,ecd->nd", combine, y.float())
    return out.to(x.dtype).reshape(b, t, d)
