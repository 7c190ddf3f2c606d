"""Ulysses attention: all-to-all sequence parallelism over the ``sp`` axis.

Port of ``ray_tpu/ops/ulysses.py`` (DeepSpeed-Ulysses). With the sequence
sharded over ``sp``, a tiled all-to-all swaps the shard dimension from
sequence to heads, each rank attends over the full sequence for its slice
of heads (dense, in f32, as the reference's ``jnp.einsum``), and a second
all-to-all swaps back. K/V heads fewer than a multiple of ``sp`` are
repeated up to ``lcm(Hkv, sp)`` so the head swap has something to split;
the GQA grouping is kept.

q: [B, T_local, H, D], k/v: [B, T_local, Hkv, D] per rank; H must divide
by the axis size.
"""
from __future__ import annotations

import math

import torch

from ..parallel.collectives import all_to_all
from ..parallel.mesh import Mesh


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                      axis: str = "sp", *, causal: bool = True) -> torch.Tensor:
    sp = mesh.size(axis)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if h % sp != 0:
        raise ValueError(f"n_heads={h} must divide by sp={sp} for Ulysses")
    if hkv % sp != 0:
        reps = math.lcm(hkv, sp) // hkv  # smallest expansion divisible by sp
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    # [B, T_local, H, D] -> [B, T_full, H/sp, D]
    qg, kg, vg = (all_to_all(x, mesh, axis, split_dim=2, concat_dim=1) for x in (q, k, v))
    t_full, hq, hk = qg.shape[1], qg.shape[2], kg.shape[2]
    qh = qg.reshape(b, t_full, hk, hq // hk, d)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=q.device))
    s = torch.einsum("bthgd,bshd->bhgts", qh.float(), kg.float()) * scale
    if causal:
        pos = torch.arange(t_full, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, vg.float())
    o = o.reshape(b, t_full, hq, d).to(q.dtype)
    return all_to_all(o, mesh, axis, split_dim=1, concat_dim=2)  # back to [B, T_local, H, D]
